// Chronos-2 T5 attention backward (B4b), fp32, head_dim 64: route 7, 3xTF32
// on Hopper's warpgroup products (wgmma) fed by TMA, taken by
// chronos_attention_bwd (chronos_attention_bwd.cu) when make_plan gives route
// 7 (chronos_tf32w_takes, chronos_attention_tf32_hopper.cu). The arithmetic,
// tiles and transposed operands are chronos_tf32_hopper.cuh's; the forward's
// half is chronos_attention_tf32_hopper.cu.
//
// Replaces, where the rule sends them here, in fp32:
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// The function is chronos_attention.cu's (its header): W = softmax(L)
// recomputed in fp32, dV = W^T G, dW = G V^T, dL = W o (dW - r) with r =
// rowsum(dW o W), dQ = dL K, dK = dL^T Q, dbias[h] = dL summed over the batch;
// nothing saved beyond qkv, seg and the bias.
//
// Design: route 5's blocks (attention_bwd_tf32_hopper.cu) with two consumer
// warpgroups and W and dL through a scratch, on the caller's stream, no
// atomics (two launches give bit-equal dqkv and dbias). A block is two
// consumer warpgroups of 64 rows and a producer warpgroup, whose first warp
// loads by TMA and whose other three warps convert (lo twins, transposes), so
// the consumers only multiply. Per chunk of batch rows (chunk_rows):
//   1. stats: a block per 128 query rows of one (batch row, head) walks every
//      32-key tile: S = Q K^T and dW = G V^T (two products), the bias and the
//      segment mask read from L2 in the accumulator layout ahead of the
//      products, an online max m, sum s and t = sum exp(l - m) dW per row, so
//      r = t / s; writes (m, 1/s, r) to the head of the scratch (3 floats a
//      row, rows past S as zeros).
//   2. dq: the same walk: S, dW, W = exp(l - m) / s, dL = W (dW - r), dQ += dL K
//      (three products), and W and dL of every tile pair to the scratch (0 on
//      rows past S).
//   3. dkdv: a block per 128 keys walks every 32-row query tile: dV += W^T G
//      and dK += dL^T Q (two products), W^T and dL^T read from the scratch in
//      the accumulator layout (each warp load four whole 32-byte sectors) and
//      split in registers; only Q^T and G^T go through shared memory.
//   4. dbias, only when the bias trains: dL summed over the batch rows in
//      order, the chunks' sums carried.
// Seven products a tile pair, as route 5's. Why the scratch: a first build
// without one (route 3's kernels: the dK/dV kernel recomputing S^T = K Q^T and
// dW^T = V G^T, a fourth kernel recomputing S and dW for dbias a batch row at
// a time) read slower than route 5 on an H100 (PERF.md): a product with both
// operands in shared memory (A B^T, N = 32 keys) costs far more than one with
// A in registers (P X), so the scratch, which leaves the dK/dV kernel only the
// second kind, wins. The scratch is W and dL of one chunk
// (598 MB at 16 x 577 x 12, where route 5 wrote 1.3 GB), bounded at any batch.
//
// What bounds it on an H100: at the least five products a tile pair (Q K^T,
// G V^T, dV, dQ, dK) at 495 / 3 TFLOP/s (chip_smoke.py's bound_ms; 0.248 ms
// at 16 x 577 x 12). The kernels' own limits: the A B^T products with both
// operands in shared memory (four of the seven), the scratch's bytes (W and dL
// written and read once: 1.2 GB at 16 x 577 x 12, 0.36 ms at 3.35 TB/s, mostly
// under the products), the bias reads from L2 in the two row kernels.

#include "chronos_tf32_hopper.cuh"

#include <algorithm>

namespace {

using namespace mtt::hopper;
using namespace mtt::tf32c;

// A block: kConsumers consumer warpgroups of 64 rows (query rows in the row
// kernels, keys in the dK/dV kernel) and a producer warpgroup, whose first warp
// loads by TMA and whose other three convert. With two consumer warpgroups
// the launch bound holds a thread to 168 registers; setmaxnreg moves the
// producer's to the consumers (2 x 224 + 56 = 504 = 3 x 168), as the forward.
constexpr int kConsumers = 2;
constexpr int kConverters = 3;
constexpr int kBwdThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRes * kConsumers;
constexpr int kConsumerRegsB = 224;
constexpr int kProducerRegsB = 56;
// Shared memory of the row kernels: per consumer, Q and G (64 rows, as TMA
// wrote them), each followed by its lo twin; stages of K and V (32 rows, as
// TMA wrote them) and their lo twins, released once every consumer's S and dW
// are done; in dq, a ring of K^T hi and lo, released once every consumer's
// dQ product is; the mbarriers res_full, res_lo, k_full[stages],
// c_full[stages], empty[stages], t_empty[tslots].
constexpr int kRes4 = 4 * tile_bytes<kRes>();  // one consumer's resident tiles
constexpr int kRowsRes = kConsumers * kRes4;
constexpr int kRowStage = 4 * tile_bytes<kStr>();
constexpr int kTSlot = 2 * kTBytes;
__host__ __device__ constexpr int rows_stages(bool dq) { return dq ? 2 : 3; }
__host__ __device__ constexpr int rows_tslots(bool dq) { return dq ? 2 : 0; }
__host__ __device__ constexpr int rows_bars(bool dq) {
  return kRowsRes + rows_stages(dq) * kRowStage + rows_tslots(dq) * kTSlot;
}
// Shared memory of the dkdv kernel: stages of Q and G (32 rows, as TMA wrote
// them), released once the converters have transposed them; slots of Q^T and
// G^T hi and lo, released once every consumer's dV and dK products are; the
// mbarriers k_full[stages], empty[stages], t_full[slots], t_empty[slots].
constexpr int kDkdvStages = 3;
constexpr int kDkdvSlots = 3;
constexpr int kDkdvStage = 2 * tile_bytes<kStr>();
constexpr int kDkdvSlot = 4 * kTBytes;
constexpr int kDkdvBars = kDkdvStages * kDkdvStage + kDkdvSlots * kDkdvSlot;
constexpr int kSmemDkdv = kAlign + kDkdvBars + 8 * 2 * (kDkdvStages + kDkdvSlots);
constexpr int smem_bytes(int bars_at, int stages, int tslots) {
  return kAlign + bars_at + 8 * (2 + 3 * stages + tslots);
}

// The row kernels' barriers, set up by the first thread, then the block's barrier.
struct Pipe {
  uint8_t* smem;
  uint64_t *res_full, *res_lo, *k_full, *c_full, *empty, *t_empty;
};
__device__ __forceinline__ Pipe setup(uint8_t* raw, int bars_at, int stages, int tslots) {
  Pipe p;
  p.smem = align_smem(raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(p.smem + bars_at);
  p.res_full = bars;
  p.res_lo = bars + 1;
  p.k_full = bars + 2;
  p.c_full = p.k_full + stages;
  p.empty = p.c_full + stages;
  p.t_empty = p.empty + stages;
  if (threadIdx.x == 0) {
    mbar_init(p.res_full, 1);
    mbar_init(p.res_lo, kConverters);
    for (int i = 0; i < stages; ++i) {
      mbar_init(p.k_full + i, 1);
      mbar_init(p.c_full + i, kConverters);
      mbar_init(p.empty + i, kConsumers * kWarpsPerGroup);
    }
    for (int i = 0; i < tslots; ++i) mbar_init(p.t_empty + i, kConsumers * kWarpsPerGroup);
    mbar_fence_init();
  }
  __syncthreads();
  return p;
}

// The dq kernel's W and dL scratch: two planes (W, then dL) of one chunk of
// batch rows, each per (batch row, head) its (64-row, 32-key) tile pairs in
// order, each 64 x 32 floats row-major (a thread's pairs of adjacent keys one
// 8-byte store; rows past S hold zeros, set so, and keys past S too, masked to
// -inf). Floats a batch row of a plane:
__host__ __device__ inline long long wd_row_floats(int S, int H) {
  return (long long)H * ((S + kRes - 1) / kRes) * ((S + kStr - 1) / kStr) * kRes * kStr;
}
// Element (query i, key j) of head h, batch row b, in a plane.
__device__ __forceinline__ long long wd_at(int b, int h, int i, int j, int S, int H) {
  const int nq = (S + kRes - 1) / kRes, nk = (S + kStr - 1) / kStr;
  return ((((long long)b * H + h) * nq + i / kRes) * nk + j / kStr) * kRes * kStr + (i % kRes) * kStr + j % kStr;
}

// Kernels 1 (DQ false: the statistics) and 2 (DQ true: dQ). A block:
// kBlockRows query rows of one (batch row, head), walking every key tile; a
// consumer whose rows all lie past S computes nothing but keeps the ring's
// count.
template <bool DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
    chronos_bwd_rows_tf32w_kernel(const __grid_constant__ QkvMaps maps,
                                  const __grid_constant__ Maps gm, const int* __restrict__ seg,
                                  const float* __restrict__ bias, float* __restrict__ stats,
                                  float* __restrict__ dqkv, float* __restrict__ wd, int S, int H,
                                  int Sp, long long wd_plane) {
  constexpr int kStages = rows_stages(DQ), kTSlots = rows_tslots(DQ);
  constexpr int kQ = 0, kQlo = tile_bytes<kRes>(), kG = 2 * tile_bytes<kRes>(), kGlo = 3 * tile_bytes<kRes>();
  constexpr int kK = 0, kV = tile_bytes<kStr>(), kKlo = 2 * tile_bytes<kStr>(), kVlo = 3 * tile_bytes<kStr>();
  constexpr int kTOffset = kRowsRes + kStages * kRowStage;  // the K^T slots (dq)
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw, rows_bars(DQ), kStages, kTSlots);
  uint8_t* smem = pipe.smem;
  const int q0 = (int)blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkt = (S + kStr - 1) / kStr;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / 128;
  const int tiles = min(kConsumers, (S - q0 + kRes - 1) / kRes);  // resident tiles that start before S
  const long long plane = (long long)gridDim.z * H * Sp;
  const long long srow = ((long long)b * H + h) * Sp;

  if (wg == kConsumers) {
    regs_dec<kProducerRegsB>();
    if (threadIdx.x < kConsumers * 128 + 32) {  // TMA
      if (lane == 0) {
        mbar_expect_tx(pipe.res_full, 2 * tiles * tile_bytes<kRes>());
        for (int c = 0; c < tiles; ++c) {
          load_tile<kRes>(smem + c * kRes4 + kQ, &maps.q.res, pipe.res_full, h, q0 + c * kRes, b);
          load_tile<kRes>(smem + c * kRes4 + kG, &gm.res, pipe.res_full, h, q0 + c * kRes, b);
        }
        for (int j = 0; j < nkt; ++j) {
          const int st = j % kStages;
          uint8_t* stage = smem + kRowsRes + st * kRowStage;
          mbar_wait(pipe.empty + st, ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(pipe.k_full + st, 2 * tile_bytes<kStr>());
          load_tile<kStr>(stage + kK, &maps.k.str, pipe.k_full + st, h, j * kStr, b);
          load_tile<kStr>(stage + kV, &maps.v.str, pipe.k_full + st, h, j * kStr, b);
        }
      }
      return;
    }
    const int ct = threadIdx.x - kConsumers * 128 - 32;
    const int nt = 32 * kConverters;
    mbar_wait(pipe.res_full, 0);
    for (int c = 0; c < tiles; ++c) {
      convert_lo<tile_bytes<kRes>()>(smem + c * kRes4 + kQlo, smem + c * kRes4 + kQ, ct, nt);
      convert_lo<tile_bytes<kRes>()>(smem + c * kRes4 + kGlo, smem + c * kRes4 + kG, ct, nt);
    }
    converted(pipe.res_lo, lane);
    for (int j = 0; j < nkt; ++j) {
      const int st = j % kStages;
      uint8_t* stage = smem + kRowsRes + st * kRowStage;
      mbar_wait(pipe.k_full + st, (j / kStages) & 1);
      convert_lo<tile_bytes<kStr>()>(stage + kKlo, stage + kK, ct, nt);
      convert_lo<tile_bytes<kStr>()>(stage + kVlo, stage + kV, ct, nt);
      if constexpr (DQ) {
        const int ts = j % kTSlots;
        uint8_t* slot = smem + kTOffset + ts * kTSlot;
        mbar_wait(pipe.t_empty + ts, ((j / kTSlots) & 1) ^ 1);
        convert_t(slot, slot + kTBytes, stage + kK, ct, nt);
      }
      converted(pipe.c_full + st, lane);
    }
    return;
  }

  regs_inc<kConsumerRegsB>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const uint32_t res = base + wg * kRes4;
  const int wq0 = q0 + wg * kRes;
  const bool mine = wq0 < S;
  const int rows[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  int sr[2];
  row_segments(sr, seg_b, rows, S);

  // DQ: the statistics of this thread's rows (zeros past S). Stats: running m, s, t.
  float m[2], s[2], tr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (DQ) {
      m[r] = mine ? stats[srow + rows[r]] : 0.f;  // a warpgroup's rows lie below Sp
      s[r] = mine ? stats[plane + srow + rows[r]] : 0.f;
      tr[r] = mine ? stats[2 * plane + srow + rows[r]] : 0.f;
    } else {
      m[r] = -FLT_MAX;
      s[r] = 0.f;
      tr[r] = 0.f;
    }
  }
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (mine) {
    mbar_wait(pipe.res_full, 0);
    mbar_wait(pipe.res_lo, 0);
  }

  for (int j = 0; j < nkt; ++j) {
    const int st = j % kStages;
    const uint32_t stage = base + kRowsRes + st * kRowStage;
    const int k0 = j * kStr;
    mbar_wait(pipe.k_full + st, (j / kStages) & 1);
    mbar_wait(pipe.c_full + st, (j / kStages) & 1);
    if (mine) {
      float sc[4][4], dw[4][4];
      wgmma_fence();
      issue_abt3(sc, res + kQ, res + kQlo, stage + kK, stage + kKlo);
      issue_abt3(dw, res + kG, res + kGlo, stage + kV, stage + kVlo);
      wgmma_commit();
      BiasTile bt;  // read, and the mask folded in, while the products run
      load_bias(bt, bias_h, seg_b, rows, k0, S, t);
      fold_mask(bt, sr, k0, S, t);
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dw);
      if (lane == 0) mbar_arrive(pipe.empty + st);  // K and V read: the stage is free
      add_bias(sc, bt);
      if constexpr (DQ) {
        // W = exp(l - m) / s in place of S, dL = W (dW - r) in place of dW, the
        // A operand of dQ += dL K; both 0 on rows past S, which the dK/dV kernel
        // reads in the last query tile: their logits are the last row's bias
        // (clamped reads, q zero-filled) and their statistics zeros, so
        // exp(l - 0) would overflow past l = 88 and 0 x inf give NaN.
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float w = mtt::fast_exp(sc[c][e] - m[r]) * s[r];
            sc[c][e] = rows[r] < S ? w : 0.f;
            dw[c][e] = rows[r] < S ? w * (dw[c][e] - tr[r]) : 0.f;
          }
        uint32_t hi[4][4], lo[4][4];
        acc_frags(dw, hi, lo);
        const int ts = j % kTSlots;
        const uint32_t slot = base + kTOffset + ts * kTSlot;
        wgmma_fence();
        issue_pb3(acc, hi, lo, slot, slot + kTBytes);
        wgmma_commit();
        // W and dL to the scratch while the products run.
        float* tile = wd + wd_at(b, h, wq0, k0, S, H);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* p = tile + (16 * warp + g + 8 * r) * kStr + 2 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            *reinterpret_cast<float2*>(p + 8 * c) = make_float2(sc[c][2 * r], sc[c][2 * r + 1]);
            *reinterpret_cast<float2*>(p + wd_plane + 8 * c) = make_float2(dw[c][2 * r], dw[c][2 * r + 1]);
          }
        }
        wgmma_wait();
        fence_regs(acc);
        fence_regs(hi);
        fence_regs(lo);
        if (lane == 0) mbar_arrive(pipe.t_empty + ts);
      } else {
        // Online m, s and t over the quad that holds each row (s, t: this thread's share).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) mx = fmaxf(mx, fmaxf(sc[c][2 * r], sc[c][2 * r + 1]));
          const float nm = fmaxf(m[r], quad_max(mx));
          const float scale = mtt::fast_exp(m[r] - nm);
          m[r] = nm;
          float ps = 0.f, pt = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = mtt::fast_exp(sc[c][2 * r + e] - nm);
              ps += x;
              pt = fmaf(x, dw[c][2 * r + e], pt);
            }
          s[r] = s[r] * scale + ps;
          tr[r] = tr[r] * scale + pt;
        }
      }
    } else if (lane == 0) {
      mbar_arrive(pipe.empty + st);
      if constexpr (DQ) mbar_arrive(pipe.t_empty + j % kTSlots);
    }
  }
  if (!mine) return;

  if constexpr (DQ) {
    const long long ld = 3LL * H * kD;
    const float one[2] = {1.f, 1.f};
    store_f32(dqkv + (long long)b * S * ld + (long long)h * kD, ld, acc, rows[0], one, S, t);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ss = quad_sum(s[r]);
      const float tt = quad_sum(tr[r]);
      if (t == 0) {  // rows[r] < wq0 + 64 <= Sp
        const bool in = rows[r] < S;
        stats[srow + rows[r]] = in ? m[r] : 0.f;
        stats[plane + srow + rows[r]] = in ? 1.f / ss : 0.f;
        stats[2 * plane + srow + rows[r]] = in ? tt / ss : 0.f;
      }
    }
  }
}

// Kernel 3: dK and dV from the dq kernel's W and dL. A block: kBlockRows keys
// of one (batch row, head), walking every 32-row query tile: per tile the
// producer's TMA warp loads Q and G, its converting warps write Q^T and G^T as
// hi and lo into a slot; each consumer thread reads its W^T and dL^T entries
// (the accumulator layout of its 64 keys x 32 queries) from the scratch,
// splits them in registers, and takes dV += W^T G and dK += dL^T Q.
__global__ void __launch_bounds__(kBwdThreads, 1)
    chronos_bwd_dkdv_tf32w_kernel(const __grid_constant__ QkvMaps maps,
                                  const __grid_constant__ Maps gm, const float* __restrict__ wd,
                                  float* __restrict__ dqkv, int S, int H, long long wd_plane) {
  constexpr int kQ = 0, kG = tile_bytes<kStr>();  // offsets in a stage
  constexpr int kQThi = 0, kQTlo = kTBytes, kGThi = 2 * kTBytes, kGTlo = 3 * kTBytes;  // in a slot
  constexpr int kSlots = kDkdvStages * kDkdvStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + kDkdvBars);
  uint64_t* empty = k_full + kDkdvStages;
  uint64_t* t_full = empty + kDkdvStages;
  uint64_t* t_empty = t_full + kDkdvSlots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDkdvStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(empty + i, kConverters);
    }
    for (int i = 0; i < kDkdvSlots; ++i) {
      mbar_init(t_full + i, kConverters);
      mbar_init(t_empty + i, kConsumers * kWarpsPerGroup);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int k0 = (int)blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nqt = (S + kStr - 1) / kStr;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    regs_dec<kProducerRegsB>();
    if (threadIdx.x < kConsumers * 128 + 32) {  // TMA
      if (lane == 0) {
        for (int j = 0; j < nqt; ++j) {
          const int st = j % kDkdvStages;
          uint8_t* stage = smem + st * kDkdvStage;
          mbar_wait(empty + st, ((j / kDkdvStages) & 1) ^ 1);
          mbar_expect_tx(k_full + st, 2 * tile_bytes<kStr>());
          load_tile<kStr>(stage + kQ, &maps.q.str, k_full + st, h, j * kStr, b);
          load_tile<kStr>(stage + kG, &gm.str, k_full + st, h, j * kStr, b);
        }
      }
      return;
    }
    const int ct = threadIdx.x - kConsumers * 128 - 32;
    constexpr int nt = 32 * kConverters;
    for (int j = 0; j < nqt; ++j) {
      const int st = j % kDkdvStages, ts = j % kDkdvSlots;
      uint8_t* stage = smem + st * kDkdvStage;
      uint8_t* slot = smem + kSlots + ts * kDkdvSlot;
      mbar_wait(k_full + st, (j / kDkdvStages) & 1);
      mbar_wait(t_empty + ts, ((j / kDkdvSlots) & 1) ^ 1);
      convert_t4(slot + kQThi, slot + kQTlo, stage + kQ, ct, nt);
      convert_t4(slot + kGThi, slot + kGTlo, stage + kG, ct, nt);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(t_full + ts);
        mbar_arrive(empty + st);
      }
    }
    return;
  }

  regs_inc<kConsumerRegsB>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const int kw0 = k0 + wg * kRes;
  const bool mine = kw0 < S;
  // This thread's keys, clamped into the scratch's last key tile (keys past S
  // are never stored).
  const int nk32 = (S + kStr - 1) / kStr * kStr;
  const int keys[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
  const int kc[2] = {min(keys[0], nk32 - 1), min(keys[1], nk32 - 1)};

  float adv[8][4], adk[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    const int ts = j % kDkdvSlots;
    const uint32_t slot = base + kSlots + ts * kDkdvSlot;
    if (!mine) {
      mbar_wait(t_full + ts, (j / kDkdvSlots) & 1);
      if (lane == 0) mbar_arrive(t_empty + ts);
      continue;
    }
    // W^T and dL^T of this thread's entries: (key keys[r], query w0 + 8 c + 2 t + e)
    // at [c][2 r + e], read while the converters work.
    const int w0 = j * kStr;
    float wt[4][4], dlt[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long at = wd_at(b, h, w0 + 8 * c + 2 * t + (e & 1), kc[e >> 1], S, H);
        wt[c][e] = __ldg(wd + at);
        dlt[c][e] = __ldg(wd + wd_plane + at);
      }
    mbar_wait(t_full + ts, (j / kDkdvSlots) & 1);
    // dV's products, then dK's, each group waited for before the next one's
    // fragments are formed (fewer live registers).
    {
      uint32_t hi[4][4], lo[4][4];
      acc_frags(wt, hi, lo);
      wgmma_fence();
      issue_pb3(adv, hi, lo, slot + kGThi, slot + kGTlo);
      wgmma_commit();
      wgmma_wait();
      fence_regs(adv);
      fence_regs(hi);
      fence_regs(lo);
    }
    {
      uint32_t hi[4][4], lo[4][4];
      acc_frags(dlt, hi, lo);
      wgmma_fence();
      issue_pb3(adk, hi, lo, slot + kQThi, slot + kQTlo);
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      fence_regs(hi);
      fence_regs(lo);
    }
    if (lane == 0) mbar_arrive(t_empty + ts);
  }
  if (!mine) return;

  const long long hd = (long long)H * kD;
  float* ob = dqkv + (long long)b * S * 3 * hd + (long long)h * kD;
  const float one[2] = {1.f, 1.f};
  store_f32(ob + hd, 3 * hd, adk, keys[0], one, S, t);
  store_f32(ob + 2 * hd, 3 * hd, adv, keys[0], one, S, t);
}

// Kernel 4, only when the bias trains: dbias[h][i][j] = the dq kernel's dL
// (`dl`, the scratch's second plane) summed over the batch, in order: this
// chunk's B rows added to the sum of the chunks before it (`carry`).
__global__ void __launch_bounds__(256)
    chronos_bwd_dbias_sum_tf32w_kernel(const float* __restrict__ dl, float* __restrict__ dbias,
                                       int B, int S, int H, bool carry) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)H * S * S) return;
  const int h = (int)(e / ((long long)S * S));
  const int i = (int)(e / S - (long long)h * S);
  const int j = (int)(e - ((long long)h * S + i) * S);
  const float* p = dl + wd_at(0, h, i, j, S, H);
  const long long step = wd_row_floats(S, H);
  float acc = carry ? dbias[e] : 0.f;
  for (int b = 0; b < B; ++b) acc += p[b * step];
  dbias[e] = acc;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = check_split(kernel, kConsumers, kConsumerRegsB, 1, kProducerRegsB);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

constexpr int kSmemStats = smem_bytes(rows_bars(false), rows_stages(false), 0);
constexpr int kSmemDq = smem_bytes(rows_bars(true), rows_stages(true), rows_tslots(true));
static_assert(kSmemStats <= 232448 && kSmemDq <= 232448 && kSmemDkdv <= 232448,
              "a block's shared memory on an H100");

// The length from which make_plan gives an fp32 backward at head_dim 64 route 7
// (chronos_tf32w_takes, chronos_attention_tf32_hopper.cu, which gives the
// [gate] chronos fp32 wgmma readings that set it).
constexpr int kBwdFrom = 385;

// The backward runs in chunks of batch rows whose W and dL scratch (2
// wd_row_floats a row) fits kScratchFloats (1 GiB; 37 MB a row at 577 tokens
// and 12 heads, so Chronos-2's 16 x 577 x 12 is one chunk of 598 MB), at least
// one row a chunk, the chunks as even as their count allows: the transient
// memory of a call stays bounded at any batch and no shape leaves the route.
constexpr long long kScratchFloats = 1LL << 28;

int chunk_rows(int B, int S, int H) {
  const long long fit = std::max(1LL, kScratchFloats / (2 * wd_row_floats(S, H)));
  const int most = (int)std::min<long long>(B, fit);
  const int chunks = (B + most - 1) / most;
  return (B + chunks - 1) / chunks;
}

}  // namespace

extern "C" int chronos_tf32w_bwd_from() { return kBwdFrom; }

// Batch rows a chunk of the backward, and the floats of scratch it needs at
// (B, S, H): the row statistics of the whole batch (3 B H Sp, Sp = S rounded
// up to 64), then W and dL of one chunk.
extern "C" int chronos_tf32w_chunk_rows(int B, int S, int H) { return chunk_rows(B, S, H); }
extern "C" long long chronos_tf32w_scratch(int B, int S, int H) {
  return 3LL * B * H * ((S + kRes - 1) / kRes * kRes) + 2 * chunk_rows(B, S, H) * wd_row_floats(S, H);
}

// Dynamic shared memory a block takes (bytes), for reports: kernel 1 (the
// statistics), 2 (dq) or 3 (dkdv).
extern "C" int chronos_tf32w_bwd_smem(int kernel) {
  return kernel == 1 ? kSmemStats : kernel == 2 ? kSmemDq : kSmemDkdv;
}

// qkv (B, S, 3*H*64), g (B, S, H*64) and dqkv (B, S, 3*H*64) fp32,
// contiguous, qkv and g 16-byte aligned, dqkv 8-byte aligned; seg (B, S)
// int32; bias (H, S, S) fp32; scratch: chronos_tf32w_scratch(B, S, H) floats,
// 16-byte aligned; dbias: null, or the (H, S, S) fp32 bias gradient, written
// whole. Launches on `stream`.
extern "C" int chronos_tf32w_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                                 void* dqkv, void* dbias, void* scratch, int B, int S, int H,
                                 void* stream) {
  if (!aligned16(qkv) || !aligned16(g) || !aligned16(scratch) || (reinterpret_cast<uintptr_t>(dqkv) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  auto* rows_stats = chronos_bwd_rows_tf32w_kernel<false>;
  auto* rows_dq = chronos_bwd_rows_tf32w_kernel<true>;
  auto* dkdv = chronos_bwd_dkdv_tf32w_kernel;
  cudaError_t err;
  if ((err = prepare(rows_stats, kSmemStats)) != cudaSuccess ||
      (err = prepare(rows_dq, kSmemDq)) != cudaSuccess || (err = prepare(dkdv, kSmemDkdv)) != cudaSuccess)
    return (int)err;
  const int Sp = (S + kRes - 1) / kRes * kRes;
  const long long hd = (long long)H * kD;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bs = static_cast<const float*>(bias);
  float* sc = static_cast<float*>(scratch);
  float* wd = sc + 3LL * B * H * Sp;
  const int rows = chunk_rows(B, S, H);
  const long long plane = rows * wd_row_floats(S, H);  // the dL plane's offset
  for (int b0 = 0; b0 < B; b0 += rows) {
    // The chunk's rows as a batch of their own: its tensors from row b0 on.
    const int nb = std::min(rows, B - b0);
    const long long t0 = (long long)b0 * S;
    QkvMaps maps;
    Maps gm;
    err = encode_qkv(&maps, static_cast<const float*>(qkv) + t0 * 3 * hd, nb, S, H);
    if (err == cudaSuccess) err = encode_f32_64(&gm, static_cast<const float*>(g) + t0 * hd, nb, S, H, hd);
    if (err != cudaSuccess) return (int)err;
    const int* sg = static_cast<const int*>(seg) + t0;
    float* out = static_cast<float*>(dqkv) + t0 * 3 * hd;
    const dim3 grid((S + kBlockRows - 1) / kBlockRows, H, nb);
    rows_stats<<<grid, kBwdThreads, kSmemStats, st>>>(maps, gm, sg, bs, sc, nullptr, nullptr, S, H, Sp, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rows_dq<<<grid, kBwdThreads, kSmemDq, st>>>(maps, gm, sg, bs, sc, out, wd, S, H, Sp, plane);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dkdv<<<grid, kBwdThreads, kSmemDkdv, st>>>(maps, gm, wd, out, S, H, plane);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (dbias == nullptr) continue;
    const long long n = (long long)H * S * S;
    chronos_bwd_dbias_sum_tf32w_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        wd + plane, static_cast<float*>(dbias), nb, S, H, b0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
