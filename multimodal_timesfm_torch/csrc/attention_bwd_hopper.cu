// Causal + key-padding attention backward, bf16, head_dim 80: the wgmma/TMA
// route for Hopper (sm_90a), taken by attention_bwd (attention_bwd.cu) by the
// rule of hopper_bwd_takes below.
//
// Replaces, where the rule sends them here (from 128 tokens), the backward
// Pallas TPU kernels
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel (B1b)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_bwd_kernel
//       (fused_causal_attention's VJP, B2b)
// and the backward of the library flash kernel behind
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention (B3b).
// The function is the mma.sync route's (attention_bwd.cu's header): W =
// softmax(mask(Q K^T)) recomputed in fp32 and not rounded, dV = W^T G, dW =
// G V^T, dL = W o (dW - r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q,
// accumulated in fp32, each output cast once; no residual beyond q, k, v and
// the mask.
//
// Design: three kernels on the caller's stream, each one exponential per
// logit and at most five products per tile pair, no atomics (two launches
// give bit-equal gradients):
//   1. stats: each work item of 128 query rows walks its key tiles once: S = Q K^T
//      and dW = G V^T (two products), an online max m, sum s and t = sum
//      exp(l - m) dW per row, so r = t / s; writes (m, 1/s, r) to a (3, B*H,
//      S rounded up to 64) fp32 scratch (rows past S as zeros).
//   2. dq: the same walk: S, dW, dL = exp(l - m) / s (dW - r), dQ += dL K
//      (three products, the last as a hi + lo pair of bf16 operands).
//   3. dkdv: each work item of 128 keys walks the query tiles (the mirror walk of
//      the skip rule): S^T = K Q^T, dW^T = V G^T, then dV += W^T G and
//      dK += dL^T Q with W^T and dL^T from registers (four products, each of
//      W^T and dL^T as a hi + lo pair of bf16 operands: six issued), Q, G and
//      the tile's statistics through the TMA ring. W as one bf16 value left dV
//      outside BWD_TOL where its terms cancel (a cotangent centred over the
//      keys: dV keeps only W's spread).
// Why r from its own pass (1) and not FlashAttention's r = rowsum(G o O)
// from the forward's output: O comes back rounded to bf16 (and computed from
// rounded weights), and that rounding of r moves dQ = sum W (dW - r) K by
// |dr| |K|, which does not cancel where dQ's terms do (K with a large common
// part): tests/test_torch_port_attention_hopper.py builds that case, where
// rowsum(G o O) leaves dQ outside BWD_TOL and the exact r stays inside. Why a
// separate dq kernel and not dQ partials summed in a fixed order under a
// semaphore: no scratch of (key tiles x S x 80) fp32 and no serialisation
// between the blocks of one query tile, at one more product (G V^T) and one
// more pass over K and V. Only this layout was built, so the two were not
// timed against each other.
//
// Blocks are persistent, one per SM, in two consumer warpgroups of 64 rows
// and one producer warpgroup (setmaxnreg moves its registers to the
// consumers). Work items are 128 query rows (kernels 1-2) or 128 keys
// (kernel 3) of one (batch row, head), heaviest first, taken in the zigzag
// order of hopper_common.cuh. The producer's first thread loads each item's
// resident tiles into one of two buffers, so the next item's arrive while
// this one computes, and keeps the walked 64-row tiles in flight through a
// ring of kStages stages (full / empty mbarriers) across items. The products
// are wgmma (hopper_common.cuh): A B^T from shared memory, P B with P from
// registers; head_dim 80 as a 128-byte-swizzled block of 64 columns and a
// 32-byte-swizzled block of 16. Each warpgroup computes only the tile pairs
// its own 64 rows need under the skip rule.
//
// What bounds it on an H100: at B2b 16 x 512 the least time is 0.0438 ms of
// bytes and at B3b 2 x 2,100 0.0391 ms of operations; the kernels' own limits
// are the serial chain of each tile (products, exponentials, products) with
// two warpgroups an SM to fill each other's gaps, and the nine products and
// three passes over the tile pairs in all (against five products and one
// pass in the least).

#include "hopper_common.cuh"

#include <math.h>

namespace {

using mtt::bf16;
using namespace mtt::hopper;

constexpr int kStages = 3;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRows * kConsumers;
// Shared memory of every kernel: two buffers of resident tiles (Q and G, or
// K and V: two 64-row tiles per consumer in each, so the next work item's
// load while this one computes), kStages x two walked tiles, kStages x 3 x 64
// statistics (kernel 3), then the mbarriers: res_full[2], res_empty[2],
// full[kStages], empty[kStages].
constexpr int kResident = 2 * kConsumers * kTile;
constexpr int kRingOffset = 2 * kResident;
constexpr int kStageBytes = 2 * kTile;
constexpr int kStatBytes = 3 * kRows * 4;
constexpr int kStatOffset = kRingOffset + kStages * kStageBytes;
constexpr int kBarOffset = kStatOffset + kStages * kStatBytes;
constexpr int kSmem = kAlign + kBarOffset + 8 * (4 + 2 * kStages);

// The pipeline's shared memory and barriers, set up by every thread.
struct Pipe {
  uint8_t* smem;
  uint64_t *res_full, *res_empty, *full, *empty;
};
__device__ __forceinline__ Pipe setup(uint8_t* raw) {
  Pipe p;
  p.smem = align_smem(raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(p.smem + kBarOffset);
  p.res_full = bars;
  p.res_empty = bars + 2;
  p.full = bars + 4;
  p.empty = bars + 4 + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(p.res_full + i, 1);
      mbar_init(p.res_empty + i, kConsumers * kWarpsPerGroup);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(p.full + i, 1);
      mbar_init(p.empty + i, kConsumers * kWarpsPerGroup);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return p;
}

// Load work item n's resident tiles into buffer n % 2 once the consumers
// released it: rows [r0, r0 + 128) of two operands, each 64-row tile only
// if it starts before S. Tile c of operand a at buffer + (2 c + a) kTile.
__device__ __forceinline__ void load_resident(const Pipe& p, int n, const OperandMaps& a,
                                              const OperandMaps& b, int h, int r0, int batch,
                                              int S) {
  const int rb = n & 1;
  mbar_wait(p.res_empty + rb, ((n >> 1) & 1) ^ 1);
  uint8_t* buf = p.smem + rb * kResident;
  const int tiles = min(kConsumers, (S - r0 + kRows - 1) / kRows);
  mbar_expect_tx(p.res_full + rb, 2 * tiles * kTile);
  for (int c = 0; c < tiles; ++c) {
    load_tile(buf + (2 * c) * kTile, a, p.res_full + rb, h, r0 + c * kRows, batch);
    load_tile(buf + (2 * c + 1) * kTile, b, p.res_full + rb, h, r0 + c * kRows, batch);
  }
}

// Kernels 1 (DQ false: the statistics) and 2 (DQ true: dQ). Work item: 128
// query rows of one (batch row, head), walking the key tiles of the skip
// rule; the longest walks first.
template <bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_rows_kernel(const __grid_constant__ OperandMaps qm,
                              const __grid_constant__ OperandMaps km,
                              const __grid_constant__ OperandMaps vm,
                              const __grid_constant__ OperandMaps gm,
                              const uint8_t* __restrict__ valid, float* __restrict__ stats,
                              bf16* __restrict__ dq, int B, int S, int H, int Sp,
                              long long ld_out, int pair_out) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw);
  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int items = nq * B * H;
  const long long plane = (long long)B * H * Sp;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nq, true);
      const int q0 = w.tile * kBlockRows;
      const int qlast = min(q0 + kBlockRows, S) - 1;
      int kt0, nkt;
      mtt::key_tiles(q0, qlast, warp_first_valid(valid + (long long)w.b * S, qlast + 1), S, kRows,
                     &kt0, &nkt);
      if (lane == 0) {
        load_resident(pipe, n, qm, gm, w.h, q0, w.b, S);
        for (int j = 0; j < nkt; ++j, ++it) {
          const int st = it % kStages;
          mbar_wait(pipe.empty + st, ((it / kStages) & 1) ^ 1);
          uint8_t* stage = pipe.smem + kRingOffset + st * kStageBytes;
          mbar_expect_tx(pipe.full + st, kStageBytes);
          const int k0 = (kt0 + j) * kRows;
          load_tile(stage, km, pipe.full + st, w.h, k0, w.b);
          load_tile(stage + kTile, vm, pipe.full + st, w.h, k0, w.b);
        }
      }
      __syncwarp();
    }
    return;
  }

  consumer_regs();
  const int ct = threadIdx.x % 128;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(pipe.smem);
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nq, true);
    const int q0 = w.tile * kBlockRows;
    const int qlast = min(q0 + kBlockRows, S) - 1;
    const uint8_t* vb = valid + (long long)w.b * S;
    const int f = warp_first_valid(vb, qlast + 1);
    int kt0, nkt;
    mtt::key_tiles(q0, qlast, f, S, kRows, &kt0, &nkt);
    const int wq0 = q0 + wg * kRows;
    int wkt0 = 0, wnkt = 0;
    if (wq0 < S) mtt::key_tiles(wq0, min(wq0 + kRows, S) - 1, f, S, kRows, &wkt0, &wnkt);
    const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const long long bh = (long long)w.b * H + w.h;

    // DQ: the statistics of this thread's rows (zeros past S). Stats: running m, s, t.
    float m[2], s[2], tr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (DQ) {
        const bool in = wq0 < S;  // the whole warpgroup's rows lie below Sp
        m[r] = in ? stats[bh * Sp + rows[r]] : 0.f;
        s[r] = in ? stats[plane + bh * Sp + rows[r]] : 0.f;
        tr[r] = in ? stats[2 * plane + bh * Sp + rows[r]] : 0.f;
      } else {
        m[r] = -FLT_MAX;
        s[r] = 0.f;
        tr[r] = 0.f;
      }
    }
    float acc[10][4];
#pragma unroll
    for (int j = 0; j < 10; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    const int rb = n & 1;
    mbar_wait(pipe.res_full + rb, (n >> 1) & 1);
    const uint32_t res = base + rb * kResident;
    const KMajor qa(res + (2 * wg) * kTile, 0);
    const KMajor ga(res + (2 * wg + 1) * kTile, 0);

    for (int j = 0; j < nkt; ++j, ++it) {
      const int st = it % kStages;
      mbar_wait(pipe.full + st, (it / kStages) & 1);
      const int kt = kt0 + j;
      if (kt >= wkt0 && kt < wkt0 + wnkt) {
        const uint32_t stage = base + kRingOffset + st * kStageBytes;
        const int k0 = kt * kRows;
        const bool unmasked = warp_unmasked(vb, k0, wq0 + warp * 16, S, lane);  // overlaps the products
        float sc[8][4], dw[8][4];
        wgmma_fence();
        issue_abt(sc, qa, KMajor(stage, 0));
        issue_abt(dw, ga, KMajor(stage + kTile, 0));
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dw);
        if (!unmasked) mask_tile(sc, vb, k0, rows, S, t);
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
          const MNMajor kb(stage);
          wgmma_fence();
          issue_pb(acc, hi, kb);
          issue_pb(acc, lo, kb);
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
      }
      if (lane == 0) mbar_arrive(pipe.empty + st);
    }
    if (lane == 0) mbar_arrive(pipe.res_empty + rb);

    if constexpr (DQ) {
      if (wq0 < S)
        mtt::store_rows<10>(dq + (long long)w.b * S * ld_out + (long long)w.h * kDim, ld_out, acc,
                            rows[0], 0, S, kDim, pair_out, lane);
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
// the query tiles; the first key tiles, which meet the most rows, first.
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ OperandMaps qm,
                                    const __grid_constant__ OperandMaps km,
                                    const __grid_constant__ OperandMaps vm,
                                    const __grid_constant__ OperandMaps gm,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ stats, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int B, int S, int H, int Sp,
                                    long long ld_out, int pair_out) {
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe = setup(smem_raw);
  const int nk = (S + kBlockRows - 1) / kBlockRows;
  const int items = nk * B * H;
  const long long plane = (long long)B * H * Sp;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;

  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    int it = 0;
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nk, false);
      const int k0 = w.tile * kBlockRows;
      const mtt::QueryWalk walk = mtt::query_tiles(
          k0, min(k0 + kBlockRows, S) - 1, warp_first_valid(valid + (long long)w.b * S, S), S, kRows);
      if (lane == 0) {
        load_resident(pipe, n, km, vm, w.h, k0, w.b, S);
        const long long bh = (long long)w.b * H + w.h;
        for (int j = 0; j < walk.count; ++j, ++it) {
          const int st = it % kStages;
          mbar_wait(pipe.empty + st, ((it / kStages) & 1) ^ 1);
          uint8_t* stage = pipe.smem + kRingOffset + st * kStageBytes;
          float* sts = reinterpret_cast<float*>(pipe.smem + kStatOffset + st * kStatBytes);
          mbar_expect_tx(pipe.full + st, kStageBytes + kStatBytes);
          const int q0 = walk.tile(j) * kRows;
          load_tile(stage, qm, pipe.full + st, w.h, q0, w.b);
          load_tile(stage + kTile, gm, pipe.full + st, w.h, q0, w.b);
          for (int c = 0; c < 3; ++c)
            bulk_load(sts + c * kRows, stats + c * plane + bh * Sp + q0, kRows * 4, pipe.full + st);
        }
      }
      __syncwarp();
    }
    return;
  }

  consumer_regs();
  const int ct = threadIdx.x % 128;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(pipe.smem);
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nk, false);
    const int k0 = w.tile * kBlockRows;
    const uint8_t* vb = valid + (long long)w.b * S;
    const int f = warp_first_valid(vb, S);
    const mtt::QueryWalk walk = mtt::query_tiles(k0, min(k0 + kBlockRows, S) - 1, f, S, kRows);
    const int kw0 = k0 + wg * kRows;
    mtt::QueryWalk mine{0, 0, 0};
    if (kw0 < S) mine = mtt::query_tiles(kw0, min(kw0 + kRows, S) - 1, f, S, kRows);
    const int keys[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    bool key_on[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key_on[r] = keys[r] < S && vb[keys[r]] != 0;

    float adv[10][4], adk[10][4];
#pragma unroll
    for (int j = 0; j < 10; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adv[j][e] = adk[j][e] = 0.f;

    const int rb = n & 1;
    mbar_wait(pipe.res_full + rb, (n >> 1) & 1);
    const uint32_t res = base + rb * kResident;
    const KMajor ka(res + (2 * wg) * kTile, 0);
    const KMajor va(res + (2 * wg + 1) * kTile, 0);

    for (int j = 0; j < walk.count; ++j, ++it) {
      const int st = it % kStages;
      mbar_wait(pipe.full + st, (it / kStages) & 1);
      const int qt = walk.tile(j);
      if (qt < mine.a || (mine.count > mine.a && qt >= mine.b)) {
        const uint32_t stage = base + kRingOffset + st * kStageBytes;
        const float* sts = reinterpret_cast<const float*>(pipe.smem + kStatOffset + st * kStatBytes);
        const int q0 = qt * kRows;
        // Transposed tiles: rows = this warpgroup's keys, columns = the tile's queries.
        float sc[8][4], dw[8][4];
        wgmma_fence();
        issue_abt(sc, ka, KMajor(stage, 0));
        issue_abt(dw, va, KMajor(stage + kTile, 0));
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dw);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 8 * c + 2 * t + (e & 1);  // query within the tile
            const int r = e >> 1;
            const float l = (keys[r] > q0 + q || !key_on[r]) ? -FLT_MAX : sc[c][e];
            const float x = mtt::fast_exp(l - sts[q]) * sts[kRows + q];
            sc[c][e] = x;
            dw[c][e] = x * (dw[c][e] - sts[2 * kRows + q]);
          }
        // dV's products are issued before dL^T is split, so W^T and dL^T are not
        // both held in fp32 beside their fragments (fewer live registers).
        uint32_t whi[4][4], wlo[4][4], hi[4][4], lo[4][4];
        tile_frags<true>(sc, whi, wlo);
        wgmma_fence();
        const MNMajor gb(stage + kTile);
        issue_pb(adv, whi, gb);
        issue_pb(adv, wlo, gb);
        tile_frags<true>(dw, hi, lo);
        wgmma_fence();
        const MNMajor qb(stage);
        issue_pb(adk, hi, qb);
        issue_pb(adk, lo, qb);
        wgmma_commit();
        wgmma_wait();
        fence_regs(adv);
        fence_regs(adk);
        fence_regs(whi);
        fence_regs(wlo);
        fence_regs(hi);
        fence_regs(lo);
      }
      if (lane == 0) mbar_arrive(pipe.empty + st);
    }
    if (lane == 0) mbar_arrive(pipe.res_empty + rb);

    if (kw0 < S) {
      const long long off = (long long)w.b * S * ld_out + (long long)w.h * kDim;
      mtt::store_rows<10>(dk + off, ld_out, adk, keys[0], 0, S, kDim, pair_out, lane);
      mtt::store_rows<10>(dv + off, ld_out, adv, keys[0], 0, S, kDim, pair_out, lane);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  const cudaError_t err = check_regs(kernel, kThreads);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
}

}  // namespace

// Whether attention_bwd takes this route for (S, D) and this layout: bf16,
// head_dim 80, S >= kBwdFrom (the measured border with the mma.sync route,
// chip_smoke.py's [gate] lines), and q, k, v and g readable by TMA. Route
// override (attention_set_route): 1 never, 2 from any S.
constexpr int kBwdFrom = 128;
extern "C" int mtt_attention_route_override();

extern "C" int hopper_bwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  if (force == 1 || D != kDim) return 0;
  return force == 2 || S >= kBwdFrom;
}

extern "C" int hopper_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                 long long ld_in, long long ld_g) {
  return tma_layout(q, ld_in, kDim) && tma_layout(k, ld_in, kDim) && tma_layout(v, ld_in, kDim) &&
         tma_layout(g, ld_g, kDim);
}

// cfg as attention_bwd_config's: {route 2, threads, query rows per block of
// the row kernels, keys per block of the dkdv kernel, heads per block, padded
// head_dim, output columns per block, dL as hi + lo}.
extern "C" void hopper_bwd_config(int* cfg) {
  const int c[8] = {2, kThreads, kBlockRows, kBlockRows, 1, kDim, kDim, 1};
  for (int i = 0; i < 8; ++i) cfg[i] = c[i];
}

// stats: 3 * B * H * Sp floats, Sp = S rounded up to 64.
extern "C" int hopper_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* valid, const void* g, void* dq, void* dk,
                                    void* dv, void* stats, int B, int S, int H, long long ld_in,
                                    long long ld_g, long long ld_out, void* stream) {
  OperandMaps qm, km, vm, gm;
  cudaError_t err = encode_operand(&qm, q, B, S, H, ld_in);
  if (err == cudaSuccess) err = encode_operand(&km, k, B, S, H, ld_in);
  if (err == cudaSuccess) err = encode_operand(&vm, v, B, S, H, ld_in);
  if (err == cudaSuccess) err = encode_operand(&gm, g, B, S, H, ld_g);
  if (err != cudaSuccess) return (int)err;
  auto* rows_stats = attention_bwd_rows_kernel<false>;
  auto* rows_dq = attention_bwd_rows_kernel<true>;
  auto* dkdv = attention_bwd_dkdv_wgmma_kernel;
  if ((err = prepare(rows_stats)) != cudaSuccess || (err = prepare(rows_dq)) != cudaSuccess ||
      (err = prepare(dkdv)) != cudaSuccess)
    return (int)err;
  const int Sp = (S + kRows - 1) / kRows * kRows;
  const auto aligned4 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; };
  const int pair_out = ld_out % 2 == 0 && aligned4(dq) && aligned4(dk) && aligned4(dv);
  const int blocks = persistent_blocks((S + kBlockRows - 1) / kBlockRows * B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* vmask = static_cast<const uint8_t*>(valid);
  float* sc = static_cast<float*>(stats);
  rows_stats<<<blocks, kThreads, kSmem, st>>>(qm, km, vm, gm, vmask, sc, nullptr, B, S, H, Sp,
                                              ld_out, pair_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rows_dq<<<blocks, kThreads, kSmem, st>>>(qm, km, vm, gm, vmask, sc, static_cast<bf16*>(dq), B, S,
                                           H, Sp, ld_out, pair_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv<<<blocks, kThreads, kSmem, st>>>(qm, km, vm, gm, vmask, sc, static_cast<bf16*>(dk),
                                        static_cast<bf16*>(dv), B, S, H, Sp, ld_out, pair_out);
  return (int)cudaGetLastError();
}
