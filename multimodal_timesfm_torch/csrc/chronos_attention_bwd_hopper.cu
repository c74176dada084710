// Chronos-2 T5 attention backward (B4b), bf16, head_dim 64: the wgmma/TMA
// route for Hopper (sm_90a), taken by chronos_attention_bwd
// (chronos_attention_bwd.cu) when make_plan gives route 3
// (chronos_hopper_takes in chronos_attention_hopper.cu).
//
// Replaces, where the rule sends them here, the Pallas TPU kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// The function is chronos_attention.cu's (its header): W = softmax(L)
// recomputed in fp32 and not rounded, dV = W^T G, dW = G V^T, dL = W o (dW -
// r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, dbias[h] = dL summed
// over the batch, each output cast once; nothing saved beyond qkv, seg and
// the bias.
//
// Design, after the causal route's backward (attention_bwd_hopper.cu):
// kernels on the caller's stream, one exponential per logit each, no atomics
// (two launches give bit-equal dqkv and dbias):
//   1. stats: each work item of 128 query rows walks the key tiles once: S =
//      Q K^T and dW = G V^T (two products), an online max m, sum s and t =
//      sum exp(l - m) dW per row, so r = t / s; writes (m, 1/s, r) to a (3,
//      B*H, S rounded up to 64) fp32 scratch (rows past S as zeros).
//   2. dq: the same walk: S, dW, dL = exp(l - m) / s (dW - r), dQ += dL K
//      (three products, the last as a hi + lo pair of bf16 operands: each row
//      of dL sums to 0, so dQ is a difference of terms).
//   3. dkdv: each work item of 128 keys walks the query tiles: S^T = K Q^T,
//      dW^T = V G^T, then dV += W^T G and dK += dL^T Q, each of W^T and dL^T
//      as a hi + lo pair of bf16 operands, from registers (W as one bf16
//      value left dV outside BWD_TOL where its terms cancel: a cotangent
//      centred over a segment's rows, dV keeping only W's spread); Q, G and
//      the tile's statistics through the TMA ring.
//   4. dbias, only when the bias trains: each work item is a (128 query rows,
//      64 keys, head) block of dbias and a group of batch rows, and loops over
//      them in batch order, recomputing S and dW (two products) and dL from
//      kernel 1's statistics, and summing dL in registers; it writes its
//      block once. One group (dbias written whole) where the blocks alone
//      fill the card twice over (16 x 577: 600 blocks); else the batch is cut
//      into groups until they do (64 x 97: 24 blocks, 11 groups), and
//      chronos_attention_bwd sums the groups' (H, S, S) partials in group
//      order. No plane per batch row (the mma.sync tiled route wrote B of
//      them, 256 MB at 16 x 577, and read them back), and each bias entry is
//      read once per block and group, not once per batch row.
// Why r from its own pass (1) and not rowsum(G o O) from the forward's bf16
// output, and why dL as hi + lo: attention_bwd_hopper.cu's header;
// tests/test_torch_port_chronos_hopper.py holds both choices for this kernel.
//
// Blocks are persistent, one per SM, in two consumer warpgroups of 64 rows
// and one producer warpgroup (setmaxnreg moves its registers to the
// consumers), items taken in the zigzag order of hopper_common.cuh. The
// producer's first thread loads each item's resident tiles (kernels 1-3)
// into one of two buffers and keeps the walked tiles in flight through a ring
// of kStages stages (full / empty mbarriers) across items. Each consumer
// thread reads its 32 bias entries of a tile pair from L2 ahead of the
// tile's products (kernels 1-3; kernel 4 once per item), as the forward does.
//
// What bounds it on an H100: at 16 x 577 x 12 heads the least time is 0.0414
// ms of operations (the five products once); the kernels' own limits are the
// serial chain of each tile (products, exponentials, products) with two
// warpgroups an SM to fill each other's gaps, and the nine products and
// three passes over the tile pairs in all (against five and one in the
// least), eleven and four with dbias.

#include "chronos_hopper.cuh"

namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::chronos_hopper;

constexpr int kStages = 3;
// Shared memory of kernels 1-3: two buffers of resident tiles (Q and G, or K
// and V: two 64-row tiles per consumer in each), kStages x two walked tiles,
// kStages x 3 x 64 statistics (kernel 3), then the mbarriers: res_full[2],
// res_empty[2], full[kStages], empty[kStages].
constexpr int kResident = 2 * kConsumers * kTile64;
constexpr int kRingOffset = 2 * kResident;
constexpr int kStageBytes = 2 * kTile64;
constexpr int kStatBytes = 3 * kRows * 4;
constexpr int kStatOffset = kRingOffset + kStages * kStageBytes;
constexpr int kBarOffset = kStatOffset + kStages * kStatBytes;
constexpr int kSmem = kAlign + kBarOffset + 8 * (4 + 2 * kStages);
// Kernel 4: kDbStages x (Q, G of each consumer, K, V), then full[], empty[].
constexpr int kDbStages = 3;
constexpr int kDbStageBytes = (2 * kConsumers + 2) * kTile64;
constexpr int kDbBarOffset = kDbStages * kDbStageBytes;
constexpr int kDbSmem = kAlign + kDbBarOffset + 8 * 2 * kDbStages;

// The pipeline's shared memory and barriers, set up by every thread.
struct Pipe {
  uint8_t* smem;
  uint64_t *res_full, *res_empty, *full, *empty;
};
__device__ __forceinline__ Pipe setup(uint8_t* raw, int bar_offset, int stages, bool resident) {
  Pipe p;
  p.smem = align_smem(raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(p.smem + bar_offset);
  p.res_full = bars;
  p.res_empty = bars + 2;
  p.full = resident ? bars + 4 : bars;
  p.empty = p.full + stages;
  if (threadIdx.x == 0) {
    if (resident)
      for (int i = 0; i < 2; ++i) {
        mbar_init(p.res_full + i, 1);
        mbar_init(p.res_empty + i, kConsumers * kWarpsPerGroup);
      }
    for (int i = 0; i < stages; ++i) {
      mbar_init(p.full + i, 1);
      mbar_init(p.empty + i, kConsumers * kWarpsPerGroup);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return p;
}

// Load work item n's resident tiles into buffer n % 2 once the consumers
// released it: rows [r0, r0 + 128) of two operands, each 64-row tile only if
// it starts before S. Tile c of operand a at buffer + (2 c + a) kTile64.
__device__ __forceinline__ void load_resident(const Pipe& p, int n, const CUtensorMap* a,
                                              const CUtensorMap* b, int h, int r0, int batch,
                                              int S) {
  const int rb = n & 1;
  mbar_wait(p.res_empty + rb, ((n >> 1) & 1) ^ 1);
  uint8_t* buf = p.smem + rb * kResident;
  const int tiles = min(kConsumers, (S - r0 + kRows - 1) / kRows);
  mbar_expect_tx(p.res_full + rb, 2 * tiles * kTile64);
  for (int c = 0; c < tiles; ++c) {
    load_tile64(buf + (2 * c) * kTile64, a, p.res_full + rb, h, r0 + c * kRows, batch);
    load_tile64(buf + (2 * c + 1) * kTile64, b, p.res_full + rb, h, r0 + c * kRows, batch);
  }
}

// Kernels 1 (DQ false: the statistics) and 2 (DQ true: dQ). Work item: 128
// query rows of one (batch row, head), walking every key tile.
template <bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
    chronos_bwd_rows_kernel(const __grid_constant__ QkvMaps maps,
                            const __grid_constant__ CUtensorMap gm, const int* __restrict__ seg,
                            const float* __restrict__ bias, float* __restrict__ stats,
                            bf16* __restrict__ dq, int B, int S, int H, int Sp, int pair_out) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw, kBarOffset, kStages, true);
  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int nkt = (S + kRows - 1) / kRows;
  const int items = nq * B * H;
  const long long plane = (long long)B * H * Sp;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nq, false);
      load_resident(pipe, n, &maps.q, &gm, w.h, w.tile * kBlockRows, w.b, S);
      for (int j = 0; j < nkt; ++j, ++it) {
        const int st = it % kStages;
        mbar_wait(pipe.empty + st, ((it / kStages) & 1) ^ 1);
        uint8_t* stage = pipe.smem + kRingOffset + st * kStageBytes;
        mbar_expect_tx(pipe.full + st, kStageBytes);
        load_tile64(stage, &maps.k, pipe.full + st, w.h, j * kRows, w.b);
        load_tile64(stage + kTile64, &maps.v, pipe.full + st, w.h, j * kRows, w.b);
      }
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x % 128) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(pipe.smem);
  const long long ld = 3LL * H * kDim64;
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nq, false);
    const int wq0 = w.tile * kBlockRows + wg * kRows;
    const bool mine = wq0 < S;
    const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const long long bh = (long long)w.b * H + w.h;
    const int* seg_b = seg + (long long)w.b * S;
    const float* bias_h = bias + (long long)w.h * S * S;
    int sr[2];
    row_segments(sr, seg_b, rows, S);

    // DQ: the statistics of this thread's rows (zeros past S); else running m, s, t.
    float m[2], s[2], tr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (DQ) {
        m[r] = mine ? stats[bh * Sp + rows[r]] : 0.f;  // the warpgroup's rows lie below Sp
        s[r] = mine ? stats[plane + bh * Sp + rows[r]] : 0.f;
        tr[r] = mine ? stats[2 * plane + bh * Sp + rows[r]] : 0.f;
      } else {
        m[r] = -FLT_MAX;
        s[r] = 0.f;
        tr[r] = 0.f;
      }
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int rb = n & 1;
    mbar_wait(pipe.res_full + rb, (n >> 1) & 1);
    const uint32_t res = base + rb * kResident;
    const uint64_t qa = kmajor64(res + (2 * wg) * kTile64);
    const uint64_t ga = kmajor64(res + (2 * wg + 1) * kTile64);

    for (int j = 0; j < nkt; ++j, ++it) {
      const int st = it % kStages;
      if (mine) {
        BiasTile bt;
        load_bias<false>(bt, bias_h, seg_b, rows, j * kRows, S, t);  // overlaps the products
        mbar_wait(pipe.full + st, (it / kStages) & 1);
        const uint32_t stage = base + kRingOffset + st * kStageBytes;
        float sc[8][4], dw[8][4];
        wgmma_fence();
        issue_abt64(sc, qa, kmajor64(stage));
        issue_abt64(dw, ga, kmajor64(stage + kTile64));
        wgmma_commit();
        fold_mask<false>(bt, sr, rows, j * kRows, S, t);  // while the products run
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dw);
        add_bias(sc, bt);
        if constexpr (DQ) {
          // dL = W (dW - r) in place of dW, the A operand of dQ += dL K (hi + lo).
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              dw[c][e] = mtt::fast_exp(sc[c][e] - m[r]) * s[r] * (dw[c][e] - tr[r]);
            }
          uint32_t hi[4][4], lo[4][4];
          tile_frags<true>(dw, hi, lo);
          const uint64_t kb = mnmajor64(stage);
          wgmma_fence();
          issue_pb64(acc, hi, kb);
          issue_pb64(acc, lo, kb);
          wgmma_commit();
          wgmma_wait();
          fence_regs(acc);
          fence_regs(hi);
          fence_regs(lo);
        } else {
          // Online m, s and t over the quad that holds each row (s, t: this thread's share).
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(sc[c][2 * r], sc[c][2 * r + 1]));
            const float nm = fmaxf(m[r], quad_max(mx));
            const float scale = mtt::fast_exp(m[r] - nm);
            m[r] = nm;
            float ps = 0.f, pt = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c)
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
      } else {
        mbar_wait(pipe.full + st, (it / kStages) & 1);
      }
      if (lane == 0) mbar_arrive(pipe.empty + st);
    }
    if (lane == 0) mbar_arrive(pipe.res_empty + rb);
    if (!mine) continue;

    if constexpr (DQ) {
      mtt::store_rows<8>(dq + (long long)w.b * S * ld + (long long)w.h * kDim64, ld, acc, rows[0], 0,
                         S, kDim64, pair_out, lane);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float ss = quad_sum(s[r]);
        const float tt = quad_sum(tr[r]);
        const int row = rows[r];
        if (t == 0 && row < Sp) {
          const bool in = row < S;
          stats[bh * Sp + row] = in ? m[r] : 0.f;
          stats[plane + bh * Sp + row] = in ? 1.f / ss : 0.f;
          stats[2 * plane + bh * Sp + row] = in ? tt / ss : 0.f;
        }
      }
    }
  }
}

// Kernel 3: dK and dV. Work item: 128 keys of one (batch row, head), walking
// every query tile.
__global__ void __launch_bounds__(kThreads, 1)
    chronos_bwd_dkdv_wgmma_kernel(const __grid_constant__ QkvMaps maps,
                                  const __grid_constant__ CUtensorMap gm,
                                  const int* __restrict__ seg, const float* __restrict__ bias,
                                  const float* __restrict__ stats, bf16* __restrict__ dqkv, int B,
                                  int S, int H, int Sp, int pair_out) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw, kBarOffset, kStages, true);
  const int nk = (S + kBlockRows - 1) / kBlockRows;
  const int nqt = (S + kRows - 1) / kRows;
  const int items = nk * B * H;
  const long long plane = (long long)B * H * Sp;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nk, false);
      load_resident(pipe, n, &maps.k, &maps.v, w.h, w.tile * kBlockRows, w.b, S);
      const long long bh = (long long)w.b * H + w.h;
      for (int j = 0; j < nqt; ++j, ++it) {
        const int st = it % kStages;
        mbar_wait(pipe.empty + st, ((it / kStages) & 1) ^ 1);
        uint8_t* stage = pipe.smem + kRingOffset + st * kStageBytes;
        float* sts = reinterpret_cast<float*>(pipe.smem + kStatOffset + st * kStatBytes);
        mbar_expect_tx(pipe.full + st, kStageBytes + kStatBytes);
        const int q0 = j * kRows;
        load_tile64(stage, &maps.q, pipe.full + st, w.h, q0, w.b);
        load_tile64(stage + kTile64, &gm, pipe.full + st, w.h, q0, w.b);
        for (int c = 0; c < 3; ++c)
          bulk_load(sts + c * kRows, stats + c * plane + bh * Sp + q0, kRows * 4, pipe.full + st);
      }
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x % 128) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(pipe.smem);
  const long long hd = (long long)H * kDim64;
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nk, false);
    const int kw0 = w.tile * kBlockRows + wg * kRows;
    const bool mine = kw0 < S;
    const int keys[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    const int* seg_b = seg + (long long)w.b * S;
    const float* bias_h = bias + (long long)w.h * S * S;
    int sr[2];
    row_segments(sr, seg_b, keys, S);

    float adv[8][4], adk[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;

    const int rb = n & 1;
    mbar_wait(pipe.res_full + rb, (n >> 1) & 1);
    const uint32_t res = base + rb * kResident;
    const uint64_t ka = kmajor64(res + (2 * wg) * kTile64);
    const uint64_t va = kmajor64(res + (2 * wg + 1) * kTile64);

    for (int j = 0; j < nqt; ++j, ++it) {
      const int st = it % kStages;
      if (mine) {
        // Transposed tiles: rows = this warpgroup's keys, columns = the tile's queries.
        BiasTile bt;
        load_bias<true>(bt, bias_h, seg_b, keys, j * kRows, S, t);  // overlaps the products
        mbar_wait(pipe.full + st, (it / kStages) & 1);
        const uint32_t stage = base + kRingOffset + st * kStageBytes;
        const float* sts = reinterpret_cast<const float*>(pipe.smem + kStatOffset + st * kStatBytes);
        float sc[8][4], dw[8][4];
        wgmma_fence();
        issue_abt64(sc, ka, kmajor64(stage));
        issue_abt64(dw, va, kmajor64(stage + kTile64));
        wgmma_commit();
        fold_mask<true>(bt, sr, keys, j * kRows, S, t);  // while the products run
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dw);
        add_bias(sc, bt);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 8 * c + 2 * t + (e & 1);  // query within the tile
            const float x = mtt::fast_exp(sc[c][e] - sts[q]) * sts[kRows + q];
            sc[c][e] = x;
            dw[c][e] = x * (dw[c][e] - sts[2 * kRows + q]);
          }
        // dV's products are issued before dL^T is split, so W^T and dL^T are not
        // both held in fp32 beside their fragments (fewer live registers).
        uint32_t whi[4][4], wlo[4][4], hi[4][4], lo[4][4];
        tile_frags<true>(sc, whi, wlo);
        wgmma_fence();
        const uint64_t gb = mnmajor64(stage + kTile64);
        issue_pb64(adv, whi, gb);
        issue_pb64(adv, wlo, gb);
        tile_frags<true>(dw, hi, lo);
        wgmma_fence();
        const uint64_t qb = mnmajor64(stage);
        issue_pb64(adk, hi, qb);
        issue_pb64(adk, lo, qb);
        wgmma_commit();
        wgmma_wait();
        fence_regs(adv);
        fence_regs(adk);
        fence_regs(whi);
        fence_regs(wlo);
        fence_regs(hi);
        fence_regs(lo);
      } else {
        mbar_wait(pipe.full + st, (it / kStages) & 1);
      }
      if (lane == 0) mbar_arrive(pipe.empty + st);
    }
    if (lane == 0) mbar_arrive(pipe.res_empty + rb);

    if (mine) {
      bf16* ob = dqkv + (long long)w.b * S * 3 * hd + (long long)w.h * kDim64;
      mtt::store_rows<8>(ob + hd, 3 * hd, adk, keys[0], 0, S, kDim64, pair_out, lane);
      mtt::store_rows<8>(ob + 2 * hd, 3 * hd, adv, keys[0], 0, S, kDim64, pair_out, lane);
    }
  }
}

// Kernel 4: dbias. Work item: rows [q0, q0 + 128) x keys [k0, k0 + 64) of
// head h's dbias, summed over the batch rows of group `grp` in order; the
// last query tiles (short at S = 64 k + 1) last in each group.
struct DbItem {
  int grp, qt, kt, h;
};
__device__ __forceinline__ DbItem dbias_item(int i, int nq, int nkt, int H) {
  DbItem w;
  w.h = i % H;
  int rest = i / H;
  w.kt = rest % nkt;
  rest /= nkt;
  w.qt = rest % nq;
  w.grp = rest / nq;
  return w;
}

__global__ void __launch_bounds__(kThreads, 1)
    chronos_bwd_dbias_wgmma_kernel(const __grid_constant__ QkvMaps maps,
                                   const __grid_constant__ CUtensorMap gm,
                                   const int* __restrict__ seg, const float* __restrict__ bias,
                                   const float* __restrict__ stats, float* __restrict__ dbias,
                                   int B, int S, int H, int Sp, int groups) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw, kDbBarOffset, kDbStages, false);
  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int nkt = (S + kRows - 1) / kRows;
  const int items = groups * nq * nkt * H;
  const int per = (B + groups - 1) / groups;  // batch rows of a group
  const long long plane = (long long)B * H * Sp;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const DbItem w = dbias_item(i, nq, nkt, H);
      const int qt = w.qt, kt = w.kt, h = w.h;
      const int q0 = qt * kBlockRows;
      const int tiles = min(kConsumers, (S - q0 + kRows - 1) / kRows);
      for (int b = w.grp * per; b < min(B, (w.grp + 1) * per); ++b, ++it) {
        const int st = it % kDbStages;
        mbar_wait(pipe.empty + st, ((it / kDbStages) & 1) ^ 1);
        uint8_t* stage = pipe.smem + st * kDbStageBytes;
        mbar_expect_tx(pipe.full + st, (2 * tiles + 2) * kTile64);
        for (int c = 0; c < tiles; ++c) {
          load_tile64(stage + (2 * c) * kTile64, &maps.q, pipe.full + st, h, q0 + c * kRows, b);
          load_tile64(stage + (2 * c + 1) * kTile64, &gm, pipe.full + st, h, q0 + c * kRows, b);
        }
        uint8_t* kv = stage + 2 * kConsumers * kTile64;
        load_tile64(kv, &maps.k, pipe.full + st, h, kt * kRows, b);
        load_tile64(kv + kTile64, &maps.v, pipe.full + st, h, kt * kRows, b);
      }
    }
    return;
  }

  consumer_regs();
  const int warp = (threadIdx.x % 128) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(pipe.smem);
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const DbItem w = dbias_item(i, nq, nkt, H);
    const int qt = w.qt, kt = w.kt, h = w.h;
    const int wq0 = qt * kBlockRows + wg * kRows;
    const int k0 = kt * kRows;
    const bool mine = wq0 < S;
    const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const int crow[2] = {min(rows[0], S - 1), min(rows[1], S - 1)};
    const float* bias_h = bias + (long long)h * S * S;

    // The item's bias entries, read once for all batch rows (zero past S).
    float bb[8][4], db[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * c + 2 * t + (e & 1);
        bb[c][e] = mine && key < S ? __ldg(bias_h + (long long)crow[e >> 1] * S + key) : 0.f;
        db[c][e] = 0.f;
      }

    for (int b = w.grp * per; b < min(B, (w.grp + 1) * per); ++b, ++it) {
      const int st = it % kDbStages;
      if (mine) {
        // This batch row's statistics and segment ids, read ahead of the products.
        const long long bh = (long long)b * H + h;
        const int* seg_b = seg + (long long)b * S;
        float m[2], s[2], r[2];
        int sq[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          m[rr] = __ldg(stats + bh * Sp + rows[rr]);
          s[rr] = __ldg(stats + plane + bh * Sp + rows[rr]);
          r[rr] = __ldg(stats + 2 * plane + bh * Sp + rows[rr]);
          sq[rr] = __ldg(seg_b + crow[rr]);
        }
        int sk[8][2];
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * c + 2 * t + e;
            sk[c][e] = key < S ? __ldg(seg_b + key) : 0;
          }
        mbar_wait(pipe.full + st, (it / kDbStages) & 1);
        const uint32_t stage = base + st * kDbStageBytes;
        const uint32_t kv = stage + 2 * kConsumers * kTile64;
        float sc[8][4], dw[8][4];
        wgmma_fence();
        issue_abt64(sc, kmajor64(stage + (2 * wg) * kTile64), kmajor64(kv));
        issue_abt64(dw, kmajor64(stage + (2 * wg + 1) * kTile64), kmajor64(kv + kTile64));
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dw);
        // dL = W (dW - r), summed in batch order; a key past S or of another
        // segment has W = 0 exactly (a row past S reads zero statistics).
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int key = k0 + 8 * c + 2 * t + (e & 1);
            const float l = key >= S                ? -INFINITY
                            : sk[c][e & 1] != sq[rr] ? -FLT_MAX
                                                     : sc[c][e] + bb[c][e];
            db[c][e] += mtt::fast_exp(l - m[rr]) * s[rr] * (dw[c][e] - r[rr]);
          }
      } else {
        mbar_wait(pipe.full + st, (it / kDbStages) & 1);
      }
      if (lane == 0) mbar_arrive(pipe.empty + st);
    }
    if (!mine) continue;
    float* out = dbias + ((long long)w.grp * H + h) * S * S;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int key = k0 + 8 * c + 2 * t + (e & 1);
        if (row < S && key < S) out[(long long)row * S + key] = db[c][e];
      }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  const cudaError_t err = check_regs(kernel, kThreads);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// The batch groups of the dbias kernel (the (H, S, S) partials
// chronos_attention_bwd sums; 1: dbias written whole): the fewest that give
// at least two work items an SM.
extern "C" int chronos_hopper_dbias_groups(int B, int S, int H) {
  const int blocks = (S + kBlockRows - 1) / kBlockRows * ((S + kRows - 1) / kRows) * H;
  const int want = 2 * persistent_blocks(1 << 30);
  return blocks >= want ? 1 : min(B, (want + blocks - 1) / blocks);
}

// qkv (B, S, 3*H*64), g (B, S, H*64) and dqkv (B, S, 3*H*64) bf16,
// contiguous, qkv and g 16-byte aligned; seg (B, S) int32; bias (H, S, S)
// fp32; dbias: null, or `groups` (H, S, S) fp32 planes, each the sum of dL
// over its group of batch rows (chronos_hopper_dbias_groups); stats
// 3 * B * H * Sp floats of scratch, Sp = S rounded up to 64. Launches on
// `stream`.
extern "C" int chronos_hopper_bwd(const void* qkv, const void* seg, const void* bias,
                                  const void* g, void* dqkv, void* dbias, void* stats, int groups,
                                  int B, int S, int H, void* stream) {
  if (!aligned16(qkv) || !aligned16(g)) return (int)cudaErrorMisalignedAddress;
  QkvMaps maps;
  CUtensorMap gm;
  cudaError_t err = encode_qkv(&maps, qkv, B, S, H);
  if (err == cudaSuccess) err = encode_operand64(&gm, g, B, S, H, (long long)H * kDim64);
  if (err != cudaSuccess) return (int)err;
  auto* rows_stats = chronos_bwd_rows_kernel<false>;
  auto* rows_dq = chronos_bwd_rows_kernel<true>;
  auto* dkdv = chronos_bwd_dkdv_wgmma_kernel;
  auto* dbk = chronos_bwd_dbias_wgmma_kernel;
  if ((err = prepare(rows_stats, kSmem)) != cudaSuccess ||
      (err = prepare(rows_dq, kSmem)) != cudaSuccess || (err = prepare(dkdv, kSmem)) != cudaSuccess ||
      (err = prepare(dbk, kDbSmem)) != cudaSuccess)
    return (int)err;
  const int Sp = (S + kRows - 1) / kRows * kRows;
  const int pair_out = (reinterpret_cast<uintptr_t>(dqkv) & 3) == 0;
  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int blocks = persistent_blocks(nq * B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  float* sc = static_cast<float*>(stats);
  bf16* out = static_cast<bf16*>(dqkv);
  rows_stats<<<blocks, kThreads, kSmem, st>>>(maps, gm, sg, bs, sc, nullptr, B, S, H, Sp, pair_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rows_dq<<<blocks, kThreads, kSmem, st>>>(maps, gm, sg, bs, sc, out, B, S, H, Sp, pair_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv<<<blocks, kThreads, kSmem, st>>>(maps, gm, sg, bs, sc, out, B, S, H, Sp, pair_out);
  if ((err = cudaGetLastError()) != cudaSuccess || dbias == nullptr) return (int)err;
  const int db_items = groups * nq * ((S + kRows - 1) / kRows) * H;
  dbk<<<persistent_blocks(db_items), kThreads, kDbSmem, st>>>(
      maps, gm, sg, bs, sc, static_cast<float*>(dbias), B, S, H, Sp, groups);
  return (int)cudaGetLastError();
}
