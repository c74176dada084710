// Causal + key-padding attention backward (B1b, B2b, B3b), fp32, head_dim 80:
// route 5, 3xTF32 on Hopper's warpgroup products (wgmma) fed by TMA, taken by
// attention_bwd (attention_bwd.cu) where tf32w_bwd_takes and tf32w_bwd_layout
// below hold, ahead of route 4 (3xTF32 mma.sync, attention_bwd_tf32.cu). The
// arithmetic, tiles and transposed operands are attention_tf32_hopper.cuh's;
// the forward's half is attention_fwd_tf32_hopper.cu.
//
// Replaces, where the rule sends them here, in fp32:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel (B1b)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_bwd_kernel (B2b)
// and the backward of the library flash kernel behind flash_causal_attention
// (B3b): W = softmax(mask(Q K^T)) recomputed in fp32, dV = W^T G, dW = G V^T,
// dL = W o (dW - r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, the mask
// attention_bwd.cu's.
//
// Design: the bf16 wgmma route's three kernels (attention_bwd_hopper.cu), on
// the caller's stream, no atomics (two launches give bit-equal dq, dk and
// dv). A block is one consumer warpgroup and a producer warpgroup, whose
// first warp loads by TMA the block's resident tiles and keeps the walked
// 32-row tiles in flight through a ring of stages, and whose other three
// warps convert (attention_tf32_hopper.cuh): the resident tiles' lo twins
// once, each walked tile's lo twins and transposes (K^T into a ring of its
// own, Q^T and G^T into one slot), so that the consumers only multiply:
//   1. stats: a block per 64 query rows of one (batch row, head) walks the
//      key tiles of the skip rule (mtt::key_tiles): S = Q K^T and dW = G V^T
//      (two products), an online max m, sum s and t = sum exp(l - m) dW per
//      row, so r = t / s; writes (m, 1/s, r) to a (3, B*H, S rounded up to
//      64) fp32 scratch (rows past S as zeros).
//   2. dq: the same walk: S, dW, dL = exp(l - m) / s (dW - r), dQ += dL K
//      (three products).
//   3. dkdv: a block per 64 keys walks the query tiles that meet them
//      (mtt::query_tiles, the mirror walk): S^T = K Q^T, dW^T = V G^T, then
//      W^T and dL^T from the tile's statistics, dV += W^T G and dK += dL^T Q
//      (four products, dV's and dK's in turn). Above the diagonal (only
//      query tiles holding a row with no valid key reach there) the
//      statistics give W = exp(finfo.min - finfo.min) / s = 1 / S, the
//      uniform weights.
// Nine products a tile pair in three walks against route 4's seven, and no
// W and dL scratch by the triangle: route 4 writes and reads W and dL of
// every tile pair on or below the diagonal (302 MB at 16 x 512 x 16), this
// route's scratch is 3 floats a row, so it has no length cap (route 4's
// backward stops at 16,320 tokens). Every product is 3xTF32 on wgmma: A B^T
// with A and B from shared memory as TMA wrote them, with their lo twins;
// P X with P's hi and lo from the registers and X^T from shared memory. Why
// not fewer products: a dQ partial from the dK/dV walk needs dL with the
// queries as rows (the A operand of dL K), where that walk holds dL^T, and
// dQ^T = K^T dL^T has M = 80, no multiple of 64; so dQ takes a walk of its
// own.
//
// What bounds it on an H100: at the least five products a tile pair (Q K^T,
// G V^T, dV, dQ, dK) at 495 / 3 TFLOP/s (chip_smoke.py's bound_ms). The
// kernels' own limits: nine products; one consumer warpgroup a block and one
// block an SM (the resident tiles and their twins, and the walked tiles'
// stages, twins and transposes fill the shared memory), so the tensor cores
// wait while it takes the softmax; the conversion, most of it kernel 3's two
// transposes a tile, which the consumers wait for at 16 x 512 (PERF.md); A
// B^T reading both operands from shared memory.

#include "attention_tf32_hopper.cuh"

#include <math.h>

namespace {

using namespace mtt::hopper;
using namespace mtt::tf32w;

// A block: one consumer warpgroup and a producer warpgroup, its first warp
// loading by TMA and the other three converting. Two warpgroups a block and no setmaxnreg: with a third warpgroup (or
// part of one) the compiler held every thread to 168 registers and spilled,
// so the blocks stay small enough to give the consumers what they hold
// (kernel 3: the lo of K's fragments and both accumulators).
constexpr int kRowConverters = 3;
constexpr int kRowThreads = 128 + 32 * (1 + kRowConverters);
constexpr int kConverters = 3;
constexpr int kDkdvThreads = 128 + 32 * (1 + kConverters);
constexpr int kStatBytes = 3 * kStr * 4;
// Shared memory of the row kernels: Q and G (64 rows, as TMA wrote them), each
// followed by its lo twin; stages of K and V (32 rows, as TMA wrote them) and
// their lo twins, released once S and dW are done; in dq, a ring of K^T hi
// and lo, released once dQ's product is, so a stage goes back to the
// producers before that product runs;
// the mbarriers res_full, res_lo, k_full[stages], c_full[stages],
// empty[stages], t_empty[kTSlots].
constexpr int kRowsRes = 4 * tile_bytes<kRes>();
constexpr int kRowStage = 4 * tile_bytes<kStr>();
constexpr int kTSlot = 2 * kTBytes;
__host__ __device__ constexpr int rows_stages(bool dq) { return dq ? 2 : 3; }
__host__ __device__ constexpr int rows_tslots(bool dq) { return dq ? 3 : 0; }
__host__ __device__ constexpr int rows_bars(bool dq) {
  return kRowsRes + rows_stages(dq) * kRowStage + rows_tslots(dq) * kTSlot;
}
// Shared memory of the dkdv kernel: K and V (64 rows, as TMA wrote them), each
// followed by its lo twin; stages of Q and G (32 rows, as TMA wrote them),
// their lo twins and the rows' three statistics, released once S^T and dW^T
// are done and the transposes made; one slot of Q^T and G^T hi and lo,
// released once dV's and dK's products are; the mbarriers (those of the row
// kernels, with one transposed slot and its t_full).
constexpr int kDkdvStages = 2;
constexpr int kDkdvRes = 4 * tile_bytes<kRes>();
constexpr int kDkdvStage = 4 * tile_bytes<kStr>() + 1024;  // the statistics, rounded to the swizzle's 1024
constexpr int kDkdvT = kDkdvRes + kDkdvStages * kDkdvStage;
constexpr int kDkdvBars = kDkdvT + 4 * kTBytes;
constexpr int smem_bytes(int bars_at, int stages, int tslots) {
  return kAlign + bars_at + 8 * (3 + 3 * stages + tslots);
}

// The pipeline's barriers, set up by the first thread, then the block's barrier.
struct Pipe {
  uint8_t* smem;
  uint64_t *res_full, *res_lo, *t_full, *k_full, *c_full, *empty, *t_empty;
};
__device__ __forceinline__ Pipe setup(uint8_t* raw, int bars_at, int stages, int tslots,
                                      int consumer_warps, int converters, int empty_count) {
  Pipe p;
  p.smem = align_smem(raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(p.smem + bars_at);
  p.res_full = bars;
  p.res_lo = bars + 1;
  p.t_full = bars + 2;
  p.k_full = bars + 3;
  p.c_full = p.k_full + stages;
  p.empty = p.c_full + stages;
  p.t_empty = p.empty + stages;
  if (threadIdx.x == 0) {
    mbar_init(p.res_full, 1);
    mbar_init(p.res_lo, converters);
    mbar_init(p.t_full, converters);
    for (int i = 0; i < stages; ++i) {
      mbar_init(p.k_full + i, 1);
      mbar_init(p.c_full + i, converters);
      mbar_init(p.empty + i, empty_count);
    }
    for (int i = 0; i < tslots; ++i) mbar_init(p.t_empty + i, consumer_warps);
    mbar_fence_init();
  }
  __syncthreads();
  return p;
}

// A converting warp's end of a step: its writes fenced for wgmma, then its arrive.
__device__ __forceinline__ void converted(uint64_t* bar, int lane) {
  fence_async_smem();
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Kernels 1 (DQ false: the statistics) and 2 (DQ true: dQ). A block: 64 query
// rows of one (batch row, head), walking the key tiles of the skip rule; the
// longest walks first.
template <bool DQ>
__global__ void __launch_bounds__(kRowThreads, 1)
    attention_bwd_rows_tf32w_kernel(const __grid_constant__ F32Maps qm,
                                    const __grid_constant__ F32Maps gm,
                                    const __grid_constant__ F32Maps km,
                                    const __grid_constant__ F32Maps vm,
                                    const uint8_t* __restrict__ valid, float* __restrict__ stats,
                                    float* __restrict__ dq, int S, int H, int Sp, long long ld_out) {
  constexpr int kStages = rows_stages(DQ), kStage = kRowStage, kTSlots = rows_tslots(DQ);
  constexpr int kQ = 0, kQlo = tile_bytes<kRes>(), kG = 2 * tile_bytes<kRes>(), kGlo = 3 * tile_bytes<kRes>();
  constexpr int kK = 0, kV = tile_bytes<kStr>(), kKlo = 2 * tile_bytes<kStr>(), kVlo = 3 * tile_bytes<kStr>();
  constexpr int kTOffset = kRowsRes + kStages * kStage;  // the K^T slots (dq)
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw, rows_bars(DQ), kStages, kTSlots, kWarpsPerGroup, kRowConverters,
                          kWarpsPerGroup);
  uint8_t* smem = pipe.smem;
  const int nq = (S + kRes - 1) / kRes;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qlast = min(q0 + kRes, S) - 1;
  const uint8_t* vb = valid + (long long)b * S;
  const int lane = threadIdx.x & 31;
  int kt0, nkt;
  mtt::key_tiles(q0, qlast, warp_first_valid(vb, qlast + 1), S, kStr, &kt0, &nkt);
  const long long plane = (long long)gridDim.z * H * Sp;
  const long long srow = ((long long)b * H + h) * Sp;

  if (threadIdx.x >= 128) {
    if (threadIdx.x < 160) {  // TMA
      if (lane == 0) {
        mbar_expect_tx(pipe.res_full, 2 * tile_bytes<kRes>());
        load_f32_tile<kRes>(smem + kQ, qm, pipe.res_full, h, q0, b);
        load_f32_tile<kRes>(smem + kG, gm, pipe.res_full, h, q0, b);
        for (int j = 0; j < nkt; ++j) {
          const int st = j % kStages;
          uint8_t* stage = smem + kRowsRes + st * kStage;
          mbar_wait(pipe.empty + st, ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(pipe.k_full + st, 2 * tile_bytes<kStr>());
          load_f32_tile<kStr>(stage + kK, km, pipe.k_full + st, h, (kt0 + j) * kStr, b);
          load_f32_tile<kStr>(stage + kV, vm, pipe.k_full + st, h, (kt0 + j) * kStr, b);
        }
      }
      return;
    }
    const int ct = threadIdx.x - 160;
    const int nt = 32 * kRowConverters;
    mbar_wait(pipe.res_full, 0);
    convert_lo<tile_bytes<kRes>()>(smem + kQlo, smem + kQ, ct, nt);
    convert_lo<tile_bytes<kRes>()>(smem + kGlo, smem + kG, ct, nt);
    converted(pipe.res_lo, lane);
    for (int j = 0; j < nkt; ++j) {
      const int st = j % kStages;
      uint8_t* stage = smem + kRowsRes + st * kStage;
      mbar_wait(pipe.k_full + st, (j / kStages) & 1);
      convert_lo<tile_bytes<kStr>()>(stage + kKlo, stage + kK, ct, nt);
      convert_lo<tile_bytes<kStr>()>(stage + kVlo, stage + kV, ct, nt);
      if constexpr (DQ) {
        const int ts = j % kTSlots;
        uint8_t* slot = smem + kTOffset + ts * kTSlot;
        mbar_wait(pipe.t_empty + ts, ((j / kTSlots) & 1) ^ 1);
        convert_t4(slot, slot + kTBytes, stage + kK, ct, nt);
      }
      converted(pipe.c_full + st, lane);
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  // DQ: the statistics of this thread's rows (zeros past S). Stats: running m, s, t.
  float m[2], s[2], tr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (DQ) {
      m[r] = stats[srow + rows[r]];
      s[r] = stats[plane + srow + rows[r]];
      tr[r] = stats[2 * plane + srow + rows[r]];
    } else {
      m[r] = -FLT_MAX;
      s[r] = 0.f;
      tr[r] = 0.f;
    }
  }
  float acc[10][4];
#pragma unroll
  for (int j = 0; j < 10; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  mbar_wait(pipe.res_full, 0);
  mbar_wait(pipe.res_lo, 0);

  for (int j = 0; j < nkt; ++j) {
    const int st = j % kStages;
    const uint32_t stage = base + kRowsRes + st * kStage;
    mbar_wait(pipe.k_full + st, (j / kStages) & 1);
    mbar_wait(pipe.c_full + st, (j / kStages) & 1);
    const int k0 = (kt0 + j) * kStr;
    float sc[4][4], dw[4][4];
    wgmma_fence();
    issue_abt3(sc, base + kQ, base + kQlo, stage + kK, stage + kKlo);
    issue_abt3(dw, base + kG, base + kGlo, stage + kV, stage + kVlo);
    wgmma_commit();
    // The key-valid reads and the warp's vote run while the products do.
    const bool unmasked = unmasked32(vb, k0, q0 + 16 * warp, S, lane);
    const uint32_t bits = key_bits(vb, k0, S, t);
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dw);
    if (lane == 0) mbar_arrive(pipe.empty + st);  // K and V read: the stage is free
    if (!unmasked) mask32(sc, bits, k0, rows, S, t);
    if constexpr (DQ) {
      // dL = W (dW - r) in place of dW, the A operand of dQ += dL K.
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          dw[c][e] = mtt::fast_exp(sc[c][e] - m[r]) * s[r] * (dw[c][e] - tr[r]);
        }
      uint32_t hi[4][4], lo[4][4];
      acc_frags(dw, hi, lo);
      const int ts = j % kTSlots;
      const uint32_t slot = base + kTOffset + ts * kTSlot;
      wgmma_fence();
      issue_pb3(acc, hi, lo, slot, slot + kTBytes);
      wgmma_commit();
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
  }

  if constexpr (DQ) {
    const float one[2] = {1.f, 1.f};
    store_f32(dq + (long long)b * S * ld_out + (long long)h * kD, ld_out, acc, rows[0], one, S, t);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ss = quad_sum(s[r]);
      const float tt = quad_sum(tr[r]);
      if (t == 0) {  // rows[r] < q0 + 64 <= Sp
        const bool in = rows[r] < S;
        stats[srow + rows[r]] = in ? m[r] : 0.f;
        stats[plane + srow + rows[r]] = in ? 1.f / ss : 0.f;
        stats[2 * plane + srow + rows[r]] = in ? tt / ss : 0.f;
      }
    }
  }
}

// Kernel 3: dK and dV. A block: 64 keys of one (batch row, head), walking the
// query tiles that meet them; the first key tiles, which meet the most rows,
// first.
__global__ void __launch_bounds__(kDkdvThreads, 1)
    attention_bwd_dkdv_tf32w_kernel(const __grid_constant__ F32Maps km,
                                    const __grid_constant__ F32Maps vm,
                                    const __grid_constant__ F32Maps qm,
                                    const __grid_constant__ F32Maps gm,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ stats, float* __restrict__ dk,
                                    float* __restrict__ dv, int S, int H, int Sp, long long ld_out) {
  constexpr int kK = 0, kKlo = tile_bytes<kRes>(), kV = 2 * tile_bytes<kRes>(), kVlo = 3 * tile_bytes<kRes>();
  constexpr int kQ = 0, kG = tile_bytes<kStr>(), kQlo = 2 * tile_bytes<kStr>(), kGlo = 3 * tile_bytes<kStr>();
  constexpr int kSts = 4 * tile_bytes<kStr>();  // offsets in a stage
  constexpr int kQThi = kDkdvT, kQTlo = kQThi + kTBytes, kGThi = kQTlo + kTBytes, kGTlo = kGThi + kTBytes;
  extern __shared__ uint8_t smem_raw[];
  // A stage is free once the consumers' S^T and dW^T and the converters' transposes are done.
  const Pipe pipe = setup(smem_raw, kDkdvBars, kDkdvStages, 1, kWarpsPerGroup, kConverters,
                          kWarpsPerGroup + kConverters);
  uint8_t* smem = pipe.smem;
  const int k0 = (int)blockIdx.x * kRes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint8_t* vb = valid + (long long)b * S;
  const int lane = threadIdx.x & 31;
  const mtt::QueryWalk walk =
      mtt::query_tiles(k0, min(k0 + kRes, S) - 1, warp_first_valid(vb, S), S, kStr);
  const long long plane = (long long)gridDim.z * H * Sp;
  const long long srow = ((long long)b * H + h) * Sp;

  if (threadIdx.x >= 128) {
    if (threadIdx.x < 160) {  // TMA
      if (lane == 0) {
        mbar_expect_tx(pipe.res_full, 2 * tile_bytes<kRes>());
        load_f32_tile<kRes>(smem + kK, km, pipe.res_full, h, k0, b);
        load_f32_tile<kRes>(smem + kV, vm, pipe.res_full, h, k0, b);
        for (int j = 0; j < walk.count; ++j) {
          const int st = j % kDkdvStages;
          uint8_t* stage = smem + kDkdvRes + st * kDkdvStage;
          const int w0 = walk.tile(j) * kStr;
          mbar_wait(pipe.empty + st, ((j / kDkdvStages) & 1) ^ 1);
          mbar_expect_tx(pipe.k_full + st, 2 * tile_bytes<kStr>() + kStatBytes);
          load_f32_tile<kStr>(stage + kQ, qm, pipe.k_full + st, h, w0, b);
          load_f32_tile<kStr>(stage + kG, gm, pipe.k_full + st, h, w0, b);
          for (int c = 0; c < 3; ++c)
            bulk_load(stage + kSts + c * kStr * 4, stats + c * plane + srow + w0, kStr * 4, pipe.k_full + st);
        }
      }
      return;
    }
    const int ct = threadIdx.x - 160;
    constexpr int nt = 32 * kConverters;
    mbar_wait(pipe.res_full, 0);
    convert_lo<tile_bytes<kRes>()>(smem + kKlo, smem + kK, ct, nt);
    convert_lo<tile_bytes<kRes>()>(smem + kVlo, smem + kV, ct, nt);
    converted(pipe.res_lo, lane);
    // Per tile: the lo twins of Q and G, then the transposes, once the
    // consumers' dV and dK products of the tile before are done. (Making the
    // twins a tile ahead of the transposes, or in the consumer warpgroup while
    // it waits for them, read slower on an H100.)
    for (int j = 0; j < walk.count; ++j) {
      const int st = j % kDkdvStages;
      uint8_t* stage = smem + kDkdvRes + st * kDkdvStage;
      mbar_wait(pipe.k_full + st, (j / kDkdvStages) & 1);
      convert_lo<tile_bytes<kStr>()>(stage + kQlo, stage + kQ, ct, nt);
      convert_lo<tile_bytes<kStr>()>(stage + kGlo, stage + kG, ct, nt);
      converted(pipe.c_full + st, lane);
      mbar_wait(pipe.t_empty, (j & 1) ^ 1);
      convert_t4(smem + kQThi, smem + kQTlo, stage + kQ, ct, nt);
      convert_t4(smem + kGThi, smem + kGTlo, stage + kG, ct, nt);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(pipe.t_full);
        mbar_arrive(pipe.empty + st);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  bool key_on[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_on[r] = keys[r] < S && vb[keys[r]] != 0;

  float adv[10][4], adk[10][4];
#pragma unroll
  for (int j = 0; j < 10; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;
  mbar_wait(pipe.res_full, 0);
  mbar_wait(pipe.res_lo, 0);

  for (int j = 0; j < walk.count; ++j) {
    const int st = j % kDkdvStages;
    const uint32_t stage = base + kDkdvRes + st * kDkdvStage;
    mbar_wait(pipe.k_full + st, (j / kDkdvStages) & 1);
    mbar_wait(pipe.c_full + st, (j / kDkdvStages) & 1);
    const int q0 = walk.tile(j) * kStr;
    // Transposed tiles: rows = this warpgroup's keys, columns = the tile's queries.
    float sc[4][4], dw[4][4];
    wgmma_fence();
    issue_abt3(sc, base + kK, base + kKlo, stage + kQ, stage + kQlo);
    issue_abt3(dw, base + kV, base + kVlo, stage + kG, stage + kGlo);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dw);
    const float* sts = reinterpret_cast<const float*>(smem + kDkdvRes + st * kDkdvStage + kSts);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * c + 2 * t + (e & 1);  // query within the tile
        const int r = e >> 1;
        const float l = (keys[r] > q0 + q || !key_on[r]) ? -FLT_MAX : sc[c][e];
        const float x = mtt::fast_exp(l - sts[q]) * sts[kStr + q];
        sc[c][e] = x;
        dw[c][e] = x * (dw[c][e] - sts[2 * kStr + q]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(pipe.empty + st);  // Q, G, their twins and the statistics read
    mbar_wait(pipe.t_full, j & 1);
    // dV's products, then dK's, each group waited for before the next one's
    // fragments are formed: with both groups' fragments live at once the
    // compiler serialised the products (ptxas C7512).
    {
      uint32_t hi[4][4], lo[4][4];
      acc_frags(sc, hi, lo);
      wgmma_fence();
      issue_pb3(adv, hi, lo, base + kGThi, base + kGTlo);
      wgmma_commit();
      wgmma_wait();
      fence_regs(adv);
      fence_regs(hi);
      fence_regs(lo);
    }
    {
      uint32_t hi[4][4], lo[4][4];
      acc_frags(dw, hi, lo);
      wgmma_fence();
      issue_pb3(adk, hi, lo, base + kQThi, base + kQTlo);
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      fence_regs(hi);
      fence_regs(lo);
    }
    if (lane == 0) mbar_arrive(pipe.t_empty);
  }

  const long long off = (long long)b * S * ld_out + (long long)h * kD;
  const float one[2] = {1.f, 1.f};
  store_f32(dk + off, ld_out, adk, keys[0], one, S, t);
  store_f32(dv + off, ld_out, adv, keys[0], one, S, t);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

constexpr int kSmemStats = smem_bytes(rows_bars(false), rows_stages(false), 0);
constexpr int kSmemDq = smem_bytes(rows_bars(true), rows_stages(true), rows_tslots(true));
constexpr int kSmemDkdv = smem_bytes(kDkdvBars, kDkdvStages, 1);
static_assert(kSmemStats <= 232448 && kSmemDq <= 232448 && kSmemDkdv <= 232448,
              "a block's shared memory on an H100");

}  // namespace

// Whether attention_bwd gives an fp32 call at (S, D) this route: head_dim 80
// from kBwdFrom tokens, the border chip_smoke.py's [gate] causal fp32 lines
// measure against route 4 (16 heads, B = 8,192 / S): route 5 the faster by
// 5% or more at every measured S from 128 to 2,100 (1.1-1.5x), route 4 at
// 16-64 (PERF.md). Below it route 4 keeps fp32. No upper border: the scratch
// is 3 floats a row. Route override (attention_set_route): 3 (CUDA cores)
// and 4 (tf32 mma.sync) never, 5 from any S.
constexpr int kBwdFrom = 128;
extern "C" int mtt_attention_route_override();

extern "C" int tf32w_bwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  if (D != kD || force == 3 || force == 4) return 0;
  return force == 5 || S >= kBwdFrom;
}

extern "C" int tf32w_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                const void* dq, const void* dk, const void* dv, long long ld_in,
                                long long ld_g, long long ld_out) {
  return tma_rows(q, ld_in) && tma_rows(k, ld_in) && tma_rows(v, ld_in) && tma_rows(g, ld_g) &&
         store_rows_ok(dq, ld_out) && store_rows_ok(dk, ld_out) && store_rows_ok(dv, ld_out);
}

// cfg as attention_bwd_config's: {route 5, threads, query rows per block of
// the row kernels, keys per block of the dkdv kernel, heads per block, padded
// head_dim, output columns per block, 0}.
extern "C" void tf32w_bwd_config(int* cfg) {
  const int c[8] = {5, kRowThreads, kRes, kRes, 1, kD, kD, 0};
  for (int i = 0; i < 8; ++i) cfg[i] = c[i];
}

// Dynamic shared memory a block takes (bytes), for reports: kernel 1 (the
// statistics), 2 (dq) or 3 (dkdv).
extern "C" int tf32w_bwd_smem(int kernel) {
  return kernel == 1 ? kSmemStats : kernel == 2 ? kSmemDq : kSmemDkdv;
}

// stats: 3 * B * H * Sp floats, Sp = S rounded up to 64, 16-byte aligned.
extern "C" int tf32w_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                   const void* g, void* dq, void* dk, void* dv, void* stats, int B,
                                   int S, int H, long long ld_in, long long ld_g, long long ld_out,
                                   void* stream) {
  if ((reinterpret_cast<uintptr_t>(stats) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  F32Maps q64, g64, k32, v32, k64, v64, q32, g32;
  cudaError_t err = encode_f32(&q64, q, B, S, H, ld_in, kRes);
  if (err == cudaSuccess) err = encode_f32(&g64, g, B, S, H, ld_g, kRes);
  if (err == cudaSuccess) err = encode_f32(&k32, k, B, S, H, ld_in, kStr);
  if (err == cudaSuccess) err = encode_f32(&v32, v, B, S, H, ld_in, kStr);
  if (err == cudaSuccess) err = encode_f32(&k64, k, B, S, H, ld_in, kRes);
  if (err == cudaSuccess) err = encode_f32(&v64, v, B, S, H, ld_in, kRes);
  if (err == cudaSuccess) err = encode_f32(&q32, q, B, S, H, ld_in, kStr);
  if (err == cudaSuccess) err = encode_f32(&g32, g, B, S, H, ld_g, kStr);
  if (err != cudaSuccess) return (int)err;
  auto* rows_stats = attention_bwd_rows_tf32w_kernel<false>;
  auto* rows_dq = attention_bwd_rows_tf32w_kernel<true>;
  auto* dkdv = attention_bwd_dkdv_tf32w_kernel;
  if ((err = prepare(rows_stats, kSmemStats)) != cudaSuccess ||
      (err = prepare(rows_dq, kSmemDq)) != cudaSuccess ||
      (err = prepare(dkdv, kSmemDkdv)) != cudaSuccess)
    return (int)err;
  const int Sp = (S + kRes - 1) / kRes * kRes;
  const dim3 grid((S + kRes - 1) / kRes, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vmask = static_cast<const uint8_t*>(valid);
  float* sc = static_cast<float*>(stats);
  rows_stats<<<grid, kRowThreads, kSmemStats, st>>>(q64, g64, k32, v32, vmask, sc, nullptr, S, H, Sp,
                                                 ld_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rows_dq<<<grid, kRowThreads, kSmemDq, st>>>(q64, g64, k32, v32, vmask, sc, static_cast<float*>(dq), S,
                                           H, Sp, ld_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv<<<grid, kDkdvThreads, kSmemDkdv, st>>>(k64, v64, q32, g32, vmask, sc, static_cast<float*>(dk),
                                          static_cast<float*>(dv), S, H, Sp, ld_out);
  return (int)cudaGetLastError();
}
