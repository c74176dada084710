// Causal + key-padding attention backward for Hopper (sm_90a).
//
// Replaces the backward halves of two Pallas TPU kernels of the JAX package:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel
//       (fused_qkv_causal_attention's VJP, 8 <= S < 256 patch tokens; B1b)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_bwd_kernel
//       (fused_causal_attention's VJP, 256 <= S <= 1024 patch tokens; B2b)
// and the backward of the library flash kernel behind
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention
//       (S > 2048; B3b, the port's flash_causal_attention_bwd).
// All recompute, per (batch, head), from the saved q, k, v and key mask:
//   W  = softmax(mask(Q K^T))          fp32, NOT rounded to the compute dtype
//   dV = W^T G,   dW = G V^T,   dL = W o (dW - rowsum(dW o W)),
//   dQ = dL K,    dK = dL^T Q,
// accumulating in fp32 and casting each output once. The mask is the forward
// kernel's (csrc/attention_fwd.cu): a causal-future or padded key gets the
// logit finfo(float32).min, a key past S no term; a query row with no valid
// key therefore has uniform weights over all S keys. No residual beyond what
// JAX saves (q, k, v, mask) comes from the forward: the row statistics are
// recomputed here (saving the forward's row max and sum would spare nothing,
// since r below needs the same pass over the keys) and kept in a (3, B, H, S)
// fp32 scratch that lives for one call, with 64-bit offsets.
//
// Where q, k, v, g and the outputs sit: element (b, s, h, d) of q is
// q[(b * S + s) * ld_in + h * D + d], likewise k and v; g has row stride ld_g;
// dq, dk and dv share row stride ld_out. The fused-qkv entry point passes
// base pointers 0, H*D and 2*H*D columns into the (B, S, 3*H*D) qkv with
// ld_in = 3*H*D, and the same offsets into one (B, S, 3*H*D) dqkv with
// ld_out = 3*H*D, so dq|dk|dv land where JAX's _bwd_kernel writes them; the
// whole-sequence entry point passes (B, S, H, D) tensors.
//
// bf16 at head_dim 80 from S = 128 (the border chip_smoke.py's [gate] lines
// measure), with q, k, v and g readable by TMA, takes the wgmma/TMA route of
// attention_bwd_hopper.cu (three kernels, the statistics in a pass of their
// own); fp32 at head_dim 80 takes the 3xTF32 route of attention_bwd_tf32.cu
// (below). The routes here, for every other shape (bf16 mma.sync) and for
// fp32, take the shape of FlashAttention-2's backward without its dQ atomics: two
// kernels on the caller's stream, no atomics, the same result from launch
// to launch.
//   1. dq: one block per query tile. Pass 1 walks the key tiles once,
//      keeping per row an online max m, sum s = sum exp(l - m) and
//      t = sum exp(l - m) dW, so r = rowsum(dW o W) = t / s; it writes
//      (m, s or 1/s, r) to the scratch. Pass 2 walks them again:
//      W = exp(l - m) / s, dL = W (dW - r), dQ += dL K.
//   2. dkdv: one block per key tile, after kernel 1. It walks the query
//      tiles: W and dL from the scratch's row statistics, dV += W^T G and
//      dK += dL^T Q.
// Both visit only the tile pairs the skip rule of attention_common.cuh keeps
// (kernel 2 the mirror walk over query tiles), and both load the tiles they
// walk with cp.async into a two-stage ring while the current one computes.
//
// bf16 route, on the tensor cores: 128 threads, 4 warps of 16 rows, the
// tiles of the forward's bf16 route (bf16 in shared memory, D padded to DP,
// rows DP + 8 apart; 16 * QW rows with 4 / QW heads per block for small S;
// NKO * 16 output columns per block for DP > 80). mma.sync m16n8k16 with
// ldmatrix fragments. Kernel 1 computes S = Q K^T and dW = G V^T (B
// operands K and V non-transposed), kernel 2 the transposed tiles
// S^T = K Q^T and dW^T = V G^T, so that W^T and dL^T sit in the
// accumulator registers in the A layout of dV += W^T G and dK += dL^T Q
// (G and Q through ldmatrix.trans), as dL does for dQ += dL K in kernel 1.
// W and dL are fp32, and each goes in as a hi + lo pair of bf16 values,
// two mmas, about 2^-17 relative. dL: each row sums to exactly 0, so dQ and
// dK are differences of terms, and a single bf16 rounding of dL (2^-9) left
// them up to 0.25 from the plain version where they cancel (B1b, 256 x 16
// tokens; BWD_TOL allows 0.01 + 0.01 |plain|). W: where a cotangent is
// centred over the keys, dV = W^T G keeps only W's spread, and one bf16
// rounding of W left dV outside BWD_TOL (the Chronos kernels at 512 x 80
// tokens in 16 segments of 5).
// The exponentials run on the SFU (mtt::fast_exp, about 2^-22 relative), and
// a tile that no mask touches skips the mask (mtt::tile_unmasked).
//
// fp32 route, on the CUDA cores (keeps the fp32 tolerance): 256 threads,
// TB = 16 TM rows (64; 32 for head_dim > 96 or S <= 32; 16 for S <= 16), a
// TM x TM micro-tile per thread,
// shared rows padded to D + 1 floats, 4-byte cp.async into the ring; W and
// dL go through shared memory for the products with V, K and Q. At head_dim
// 80 fp32 takes a 3xTF32 tensor-core route instead wherever q, k, v and g
// are read 16 bytes at a time and dq, dk, dv written 8: route 5
// (attention_bwd_tf32_hopper.cu, wgmma fed by TMA) from its border at every
// length, route 4 (attention_bwd_tf32.cu, mma.sync) below it. What stays
// here is every other head_dim, the layouts those routes cannot read, and
// the override "cuda cores".
//
// What bounds it on an H100: at the main-path shapes the bytes moved set
// the least time in bf16 (chip_smoke.py prints the bound), but kernel 1
// takes five products per tile pair and kernel 2 four (eight with the W
// and dL pairs), on mma.sync at about half the card's bf16 rate, with three
// exponentials per logit on the SFU, and every block re-reads its tiles from
// L2. The fp32 route here is bound by the CUDA cores' 67 TFLOP/s, 2.5x
// below the 3xTF32 route's 165.

#include "attention_common.cuh"

#include <math.h>

#include <algorithm>

namespace {

using mtt::bf16;
using mtt::mma_abt;
using mtt::mma_nk;
using mtt::mma_nko;
using mtt::mma_pv;
using mtt::store_rows;

constexpr bool kSplitDl = true;  // dL as a hi + lo pair of bf16 operands (header note)

constexpr int kMaxDim = 256;

// ---------------------------------------------------------------- fp32 route

constexpr int kThreadsF32 = 256;

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two (TB, dp) tiles.
template <int TM>
__device__ __forceinline__ void micro_dot(const float* A, const float* B, int D, int dp, int tx,
                                          int ty, float acc[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[TM], b[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * dp + d];
#pragma unroll
    for (int j = 0; j < TM; ++j) b[j] = B[(tx + 16 * j) * dp + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The forward's mask on a micro-tile of logits: rows q0 + ty + 16 i, keys
// k0 + tx + 16 j, key-valid flags Vm of the key tile. Keys past the sequence
// end get -inf (no term); causal-future and padded keys get
// finfo(float32).min (a term that vanishes unless the whole row is masked).
template <int TM>
__device__ __forceinline__ void mask_logits(float l[TM][TM], const int* Vm, int q0, int k0, int S,
                                            int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      if (col >= S) {
        l[i][j] = -INFINITY;
      } else if (col > row || !Vm[c]) {
        l[i][j] = -FLT_MAX;
      }
    }
  }
}

// Reductions over the 16 lanes that share a micro-tile row (tx = lane & 15).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Kernel 1 (fp32): row statistics (m, s, r) and dQ for one query tile.
template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const uint8_t* __restrict__ valid,
                                const float* __restrict__ g, float* __restrict__ dq,
                                float* __restrict__ stats, int S, int H, int D, long long ld_in,
                                long long ld_g, long long ld_out) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;               // TB x dp
  float* Gs = Qs + TB * dp;       // TB x dp
  float* Ks = Gs + TB * dp;       // 2 x TB x dp
  float* Vs = Ks + 2 * TB * dp;   // 2 x TB x dp
  float* Ps = Vs + 2 * TB * dp;   // TB x (TB + 1): dL tile
  int* Vm = reinterpret_cast<int*>(Ps + TB * (TB + 1));  // 2 x TB key-valid flags
  int* red = Vm + 2 * TB;

  const int nq = (S + TB - 1) / TB;
  const int q0 = (nq - 1 - (int)blockIdx.x) * TB;  // the longest key walks first
  const int qlast = min(q0 + TB, S) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * S * ld_in + (long long)h * D;
  const float* kb = k + in_off;
  const float* vb = v + in_off;
  const uint8_t* valid_b = valid + (long long)b * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  int kt0, nkt;
  mtt::key_tiles(q0, qlast, mtt::first_valid(valid_b, qlast + 1, red), S, TB, &kt0, &nkt);
  const int items = 2 * nkt;  // the key tiles, twice
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * TB;
    mtt::load_tile_f32<TB, kThreadsF32>(Ks + buf * TB * dp, kb, k0, S, D, dp, ld_in);
    mtt::load_tile_f32<TB, kThreadsF32>(Vs + buf * TB * dp, vb, k0, S, D, dp, ld_in);
    if (tid < TB) Vm[buf * TB + tid] = k0 + tid < S ? (int)valid_b[k0 + tid] : 0;
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Qs, q + in_off, q0, S, D, dp, ld_in);
  mtt::load_tile_f32<TB, kThreadsF32>(Gs, g + (long long)b * S * ld_g + (long long)h * D, q0, S, D,
                                      dp, ld_g);
  prefetch(0);

  float m[TM], s[TM], t[TM], r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
    t[i] = 0.f;
    r[i] = 0.f;
  }
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;  // B * H * S
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * TB;
    const float* Kt = Ks + buf * TB * dp;
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Kt, D, dp, tx, ty, l);
    mask_logits<TM>(l, Vm + buf * TB, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs + buf * TB * dp, D, dp, tx, ty, dw);
    if (it < nkt) {
      // Pass 1: online row max m, sum s of exp(l - m), and t = sum exp(l - m) dW.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float tmax = l[i][0];
#pragma unroll
        for (int j = 1; j < TM; ++j) tmax = fmaxf(tmax, l[i][j]);
        const float nm = fmaxf(m[i], row_max16(tmax));
        float ps = 0.f, pt = 0.f;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const float e = expf(l[i][j] - nm);
          ps += e;
          pt = fmaf(e, dw[i][j], pt);
        }
        const float scale = expf(m[i] - nm);
        s[i] = s[i] * scale + row_sum16(ps);
        t[i] = t[i] * scale + row_sum16(pt);
        m[i] = nm;
      }
      if (it + 1 == nkt) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          r[i] = t[i] / s[i];
          const int row = q0 + ty + 16 * i;
          if (tx == 0 && row < S) {
            stats[bh * S + row] = m[i];
            stats[plane + bh * S + row] = s[i];
            stats[2 * plane + bh * S + row] = r[i];
          }
        }
      }
      continue;
    }
    // Pass 2: dL = W (dW - r) through shared memory, dQ += dL K.
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float w = expf(l[i][j] - m[i]) / s[i];
        Ps[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = w * (dw[i][j] - r[i]);
      }
    __syncthreads();
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float kv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? Kt[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float p = Ps[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(p, kv[c], acc[i][c]);
      }
    }
  }

  float* ob = dq + (long long)b * S * ld_out + (long long)h * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * ld_out + d] = acc[i][c];
    }
  }
}

// Kernel 2 (fp32): dK and dV for one key tile, from kernel 1's statistics.
template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const uint8_t* __restrict__ valid,
                                  const float* __restrict__ g, float* __restrict__ dk,
                                  float* __restrict__ dv, const float* __restrict__ stats, int S,
                                  int H, int D, long long ld_in, long long ld_g, long long ld_out) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Ks = smem;                // TB x dp
  float* Vs = Ks + TB * dp;        // TB x dp
  float* Qs = Vs + TB * dp;        // 2 x TB x dp
  float* Gs = Qs + 2 * TB * dp;    // 2 x TB x dp
  float* Ws = Gs + 2 * TB * dp;    // TB x (TB + 1): W tile, rows = queries
  float* Ps = Ws + TB * (TB + 1);  // TB x (TB + 1): dL tile
  float* St = Ps + TB * (TB + 1);  // 2 x 3 x TB: row max, sum, term
  int* Vm = reinterpret_cast<int*>(St + 6 * TB);  // TB key-valid flags
  int* red = Vm + TB;

  const int k0 = blockIdx.x * TB;
  const int klast = min(k0 + TB, S) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * S * ld_in + (long long)h * D;
  const float* qb = q + in_off;
  const float* gb = g + (long long)b * S * ld_g + (long long)h * D;
  const uint8_t* valid_b = valid + (long long)b * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;

  const mtt::QueryWalk walk =
      mtt::query_tiles(k0, klast, mtt::first_valid(valid_b, S, red), S, TB);
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int q0 = walk.tile(it) * TB;
    mtt::load_tile_f32<TB, kThreadsF32>(Qs + buf * TB * dp, qb, q0, S, D, dp, ld_in);
    mtt::load_tile_f32<TB, kThreadsF32>(Gs + buf * TB * dp, gb, q0, S, D, dp, ld_g);
    if (tid < TB) {
      const int row = q0 + tid;
      const bool in = row < S;
      float* st = St + buf * 3 * TB;
      st[tid] = in ? stats[bh * S + row] : 0.f;
      st[TB + tid] = in ? stats[plane + bh * S + row] : 1.f;
      st[2 * TB + tid] = in ? stats[2 * plane + bh * S + row] : 0.f;
    }
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Ks, k + in_off, k0, S, D, dp, ld_in);
  mtt::load_tile_f32<TB, kThreadsF32>(Vs, v + in_off, k0, S, D, dp, ld_in);
  if (tid < TB) Vm[tid] = k0 + tid < S ? (int)valid_b[k0 + tid] : 0;
  if (walk.count > 0) prefetch(0);

  float akv[RPW][NDS], adk[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      akv[i][c] = 0.f;
      adk[i][c] = 0.f;
    }

  for (int it = 0; it < walk.count; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < walk.count) prefetch(it + 1);
    const int buf = it & 1;
    const int q0 = walk.tile(it) * TB;
    const float* Qt = Qs + buf * TB * dp;
    const float* Gt = Gs + buf * TB * dp;
    const float* Sm = St + buf * 3 * TB;
    const float* Ss = Sm + TB;
    const float* Sr = Ss + TB;
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qt, Ks, D, dp, tx, ty, l);
    mask_logits<TM>(l, Vm, q0, k0, S, tx, ty);
    micro_dot<TM>(Gt, Vs, D, dp, tx, ty, dw);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ri = ty + 16 * i;
      const bool in = q0 + ri < S;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float w = in ? expf(l[i][j] - Sm[ri]) / Ss[ri] : 0.f;
        Ws[ri * (TB + 1) + tx + 16 * j] = w;
        Ps[ri * (TB + 1) + tx + 16 * j] = w * (dw[i][j] - Sr[ri]);
      }
    }
    __syncthreads();
    const int qn = min(TB, S - q0);
    for (int i = 0; i < qn; ++i) {
      float gv[NDS], qv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        gv[c] = d < D ? Gt[i * dp + d] : 0.f;
        qv[c] = d < D ? Qt[i * dp + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < RPW; ++a) {
        const int key = warp + 8 * a;
        const float w = Ws[i * (TB + 1) + key];
        const float p = Ps[i * (TB + 1) + key];
#pragma unroll
        for (int c = 0; c < NDS; ++c) {
          akv[a][c] = fmaf(w, gv[c], akv[a][c]);
          adk[a][c] = fmaf(p, qv[c], adk[a][c]);
        }
      }
    }
  }

  const long long out_off = (long long)b * S * ld_out + (long long)h * D;
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    const int key = k0 + warp + 8 * a;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[out_off + (long long)key * ld_out + d] = adk[a][c];
        dv[out_off + (long long)key * ld_out + d] = akv[a][c];
      }
    }
  }
}

template <int TM, int NDS>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const uint8_t* valid,
                       const float* g, float* dq, float* dk, float* dv, float* stats, int B, int S,
                       int H, int D, long long ld_in, long long ld_g, long long ld_out,
                       cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  const size_t tiles = sizeof(float) * 6 * (size_t)TB * dp;
  const size_t ints = sizeof(int) * (2 * TB + kThreadsF32 / 32);
  const size_t smem_dq = tiles + sizeof(float) * TB * (TB + 1) + ints;
  const size_t smem_dkdv = tiles + sizeof(float) * (2 * TB * (TB + 1) + 6 * TB) + ints;
  const dim3 grid((S + TB - 1) / TB, H, B);

  auto dq_kernel = attention_bwd_dq_f32_kernel<TM, NDS>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreadsF32, smem_dq, stream>>>(q, k, v, valid, g, dq, stats, S, H, D, ld_in,
                                                    ld_g, ld_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv_kernel = attention_bwd_dkdv_f32_kernel<TM, NDS>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreadsF32, smem_dkdv, stream>>>(q, k, v, valid, g, dk, dv, stats, S, H, D,
                                                        ld_in, ld_g, ld_out);
  return cudaGetLastError();
}

// fp32 tiles: TB = 16 TM rows, fitted to small S (TM = 1 for S <= 16, 2 for
// S <= 32), else 64 up to head_dim 96 and 32 above (six (TB, D + 1) fp32
// tiles and the W and dL tiles fit in shared memory at D = 256).
int f32_tm(int S, int D) {
  if (S <= 16) return 1;
  if (S <= 32 || D > 96) return 2;
  return 4;
}

template <int TM>
cudaError_t launch_f32_nds(const float* q, const float* k, const float* v, const uint8_t* valid,
                           const float* g, float* dq, float* dk, float* dv, float* stats, int B,
                           int S, int H, int D, long long ld_in, long long ld_g, long long ld_out,
                           cudaStream_t stream) {
  const int nds = (D + 31) / 32;
#define MTT_LAUNCH(NDS)                                                                          \
  return launch_f32<TM, NDS>(q, k, v, valid, g, dq, dk, dv, stats, B, S, H, D, ld_in, ld_g,      \
                             ld_out, stream)
  if (nds == 1) MTT_LAUNCH(1);
  if (nds == 2) MTT_LAUNCH(2);
  if (nds == 3) MTT_LAUNCH(3);
  if constexpr (TM < 4) {
    if (nds == 4) MTT_LAUNCH(4);
    MTT_LAUNCH(8);
  }
#undef MTT_LAUNCH
  return cudaErrorInvalidValue;  // TM = 4 only up to head_dim 96
}

cudaError_t dispatch_f32(const float* q, const float* k, const float* v, const uint8_t* valid,
                         const float* g, float* dq, float* dk, float* dv, float* stats, int B,
                         int S, int H, int D, long long ld_in, long long ld_g, long long ld_out,
                         cudaStream_t stream) {
#define MTT_ARGS q, k, v, valid, g, dq, dk, dv, stats, B, S, H, D, ld_in, ld_g, ld_out, stream
  const int tm = f32_tm(S, D);
  if (tm == 1) return launch_f32_nds<1>(MTT_ARGS);
  if (tm == 2) return launch_f32_nds<2>(MTT_ARGS);
  return launch_f32_nds<4>(MTT_ARGS);
#undef MTT_ARGS
}

// ---------------------------------------------------------------- bf16 route

constexpr int kThreadsMma = 128;

// Kernel 1 (bf16): row statistics (m, 1/s, r) and dQ for one query tile.
template <int NK, int NKO, int QW>
__global__ void __launch_bounds__(kThreadsMma)
    attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
                                const bf16* __restrict__ g, bf16* __restrict__ dq,
                                float* __restrict__ stats, int S, int H, int D, long long ld_in,
                                long long ld_g, long long ld_out, int vec_in, int vec_g,
                                int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int HPB = 4 / QW;
  constexpr int BQ = 16 * QW;
  constexpr int BK = 16 * QW;
  constexpr int NT = BK / 8;
  constexpr int NO = 2 * NKO;
  constexpr int SPLIT = NK / NKO;
  constexpr int KV = HPB * BK * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // HPB x BQ x LDS
  bf16* Gs = Qs + HPB * BQ * LDS;                // HPB x BQ x LDS
  bf16* Ks = Gs + HPB * BQ * LDS;                // 2 x HPB x BK x LDS
  bf16* Vs = Ks + 2 * KV;                        // 2 x HPB x BK x LDS
  uint8_t* Vm = reinterpret_cast<uint8_t*>(Vs + 2 * KV);  // 2 x BK
  int* red = reinterpret_cast<int*>(Vm + 2 * BK);

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x / SPLIT) * BQ;
  const int col0 = ((int)blockIdx.x % SPLIT) * NKO * 16;
  const int qlast = min(q0 + BQ, S) - 1;
  const int h0 = blockIdx.y * HPB;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hs = warp / QW;
  const int wr = (warp % QW) * 16;
  const long long in_off = (long long)b * S * ld_in + (long long)h0 * D;
  const uint8_t* valid_b = valid + (long long)b * S;

  int kt0, nkt;
  mtt::key_tiles(q0, qlast, mtt::first_valid(valid_b, qlast + 1, red), S, BK, &kt0, &nkt);
  const int items = 2 * nkt;
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * BK;
    mtt::load_tile_bf16<HPB, BK, DP, LDS, kThreadsMma>(Ks + buf * KV, BK * LDS, k + in_off, ld_in,
                                                       D, h0, H, k0, S, vec_in);
    mtt::load_tile_bf16<HPB, BK, DP, LDS, kThreadsMma>(Vs + buf * KV, BK * LDS, v + in_off, ld_in,
                                                       D, h0, H, k0, S, vec_in);
    if ((int)threadIdx.x < BK)
      Vm[buf * BK + threadIdx.x] = k0 + (int)threadIdx.x < S ? valid_b[k0 + threadIdx.x] : 0;
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<HPB, BQ, DP, LDS, kThreadsMma>(Qs, BQ * LDS, q + in_off, ld_in, D, h0, H,
                                                     q0, S, vec_in);
  mtt::load_tile_bf16<HPB, BQ, DP, LDS, kThreadsMma>(
      Gs, BQ * LDS, g + (long long)b * S * ld_g + (long long)h0 * D, ld_g, D, h0, H, q0, S, vec_g);
  prefetch(0);

  const int gq = lane >> 2;
  const int t = lane & 3;
  const int rows[2] = {q0 + wr + gq, q0 + wr + gq + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};
  float tt[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float r[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const bf16* Qw = Qs + hs * BQ * LDS + wr * LDS;
  const bf16* Gw = Gs + hs * BQ * LDS + wr * LDS;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * BK;
    const uint8_t* vm = Vm + buf * BK;
    const bf16* Kw = Ks + buf * KV + hs * BK * LDS;
    float sc[NT][4], dw[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qw, Kw, lane);
    mma_abt<NK, NT, LDS>(dw, Gw, Vs + buf * KV + hs * BK * LDS, lane);
    if (!mtt::tile_unmasked<BK>(vm, k0, q0 + wr, S, lane)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int col = k0 + c;
          if (col >= S) {
            sc[n][e] = -INFINITY;
          } else if (col > rows[e >> 1] || !vm[c]) {
            sc[n][e] = -FLT_MAX;
          }
        }
    }
    if (it < nkt) {
      // Pass 1: online m, s and t over the quad that holds a row.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * rr], sc[n][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float nm = fmaxf(m[rr], mx);
        float ps = 0.f, pt = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = mtt::fast_exp(sc[n][2 * rr + e] - nm);
            ps += x;
            pt = fmaf(x, dw[n][2 * rr + e], pt);
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        pt += __shfl_xor_sync(0xffffffffu, pt, 1);
        pt += __shfl_xor_sync(0xffffffffu, pt, 2);
        const float scale = mtt::fast_exp(m[rr] - nm);
        s[rr] = s[rr] * scale + ps;
        tt[rr] = tt[rr] * scale + pt;
        m[rr] = nm;
      }
      if (it + 1 == nkt) {
        const long long bh = (long long)b * H + h0 + hs;
        const long long plane = (long long)gridDim.z * H * S;  // B * H * S
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          inv[rr] = 1.f / s[rr];
          r[rr] = tt[rr] / s[rr];
          if (col0 == 0 && t == 0 && rows[rr] < S && h0 + hs < H) {
            stats[bh * S + rows[rr]] = m[rr];
            stats[plane + bh * S + rows[rr]] = inv[rr];
            stats[2 * plane + bh * S + rows[rr]] = r[rr];
          }
        }
      }
      continue;
    }
    // Pass 2: dL = W (dW - r) in registers, the A operand of dQ += dL K.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        sc[n][e] = mtt::fast_exp(sc[n][e] - m[rr]) * inv[rr] * (dw[n][e] - r[rr]);
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      mma_pv<NO, LDS, kSplitDl>(o, sc[2 * kk], sc[2 * kk + 1], Kw + kk * 16 * LDS, col0,
                                        lane);
  }

  if (h0 + hs >= H) return;
  store_rows<NO>(dq + (long long)b * S * ld_out + (long long)(h0 + hs) * D, ld_out, o, rows[0],
                 col0, S, D, pair_out, lane);
}

// Kernel 2 (bf16): dK and dV for one key tile, from kernel 1's statistics.
template <int NK, int NKO, int QW>
__global__ void __launch_bounds__(kThreadsMma)
    attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
                                  const bf16* __restrict__ g, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, const float* __restrict__ stats, int S,
                                  int H, int D, long long ld_in, long long ld_g, long long ld_out,
                                  int vec_in, int vec_g, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int HPB = 4 / QW;
  constexpr int BQ = 16 * QW;  // queries per tile of the walk
  constexpr int BK = 16 * QW;  // keys per head and block
  constexpr int NO = 2 * NKO;
  constexpr int SPLIT = NK / NKO;
  constexpr int QG = HPB * BQ * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // HPB x BK x LDS
  bf16* Vs = Ks + HPB * BK * LDS;                // HPB x BK x LDS
  bf16* Qs = Vs + HPB * BK * LDS;                // 2 x HPB x BQ x LDS
  bf16* Gs = Qs + 2 * QG;                        // 2 x HPB x BQ x LDS
  float* St = reinterpret_cast<float*>(Gs + 2 * QG);  // 2 x HPB x 3 x BQ: m, 1/s, r
  uint8_t* Vm = reinterpret_cast<uint8_t*>(St + 6 * HPB * BQ);  // BK
  int* red = reinterpret_cast<int*>(Vm + BK);

  const int k0 = ((int)blockIdx.x / SPLIT) * BK;  // early key tiles meet the most rows
  const int col0 = ((int)blockIdx.x % SPLIT) * NKO * 16;
  const int klast = min(k0 + BK, S) - 1;
  const int h0 = blockIdx.y * HPB;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hs = warp / QW;
  const int wr = (warp % QW) * 16;
  const long long in_off = (long long)b * S * ld_in + (long long)h0 * D;
  const bf16* gb = g + (long long)b * S * ld_g + (long long)h0 * D;
  const uint8_t* valid_b = valid + (long long)b * S;
  const long long plane = (long long)gridDim.z * H * S;

  const mtt::QueryWalk walk =
      mtt::query_tiles(k0, klast, mtt::first_valid(valid_b, S, red), S, BQ);
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int q0 = walk.tile(it) * BQ;
    mtt::load_tile_bf16<HPB, BQ, DP, LDS, kThreadsMma>(Qs + buf * QG, BQ * LDS, q + in_off, ld_in,
                                                       D, h0, H, q0, S, vec_in);
    mtt::load_tile_bf16<HPB, BQ, DP, LDS, kThreadsMma>(Gs + buf * QG, BQ * LDS, gb, ld_g, D, h0, H,
                                                       q0, S, vec_g);
    for (int i = threadIdx.x; i < HPB * BQ; i += kThreadsMma) {
      const int slot = i / BQ;
      const int rr = i - slot * BQ;
      const int row = q0 + rr;
      const bool in = row < S && h0 + slot < H;
      const long long at = ((long long)b * H + h0 + slot) * S + row;
      float* st = St + (buf * HPB + slot) * 3 * BQ;
      st[rr] = in ? stats[at] : 0.f;
      st[BQ + rr] = in ? stats[plane + at] : 0.f;
      st[2 * BQ + rr] = in ? stats[2 * plane + at] : 0.f;
    }
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<HPB, BK, DP, LDS, kThreadsMma>(Ks, BK * LDS, k + in_off, ld_in, D, h0, H, k0,
                                                     S, vec_in);
  mtt::load_tile_bf16<HPB, BK, DP, LDS, kThreadsMma>(Vs, BK * LDS, v + in_off, ld_in, D, h0, H, k0,
                                                     S, vec_in);
  if ((int)threadIdx.x < BK)
    Vm[threadIdx.x] = k0 + (int)threadIdx.x < S ? valid_b[k0 + threadIdx.x] : 0;
  if (walk.count > 0) prefetch(0);

  const int gq = lane >> 2;
  const int t = lane & 3;
  const int keys[2] = {k0 + wr + gq, k0 + wr + gq + 8};
  bool key_on[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) key_on[rr] = false;
  float akv[NO][4], adk[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) akv[n][e] = adk[n][e] = 0.f;
  const bf16* Kw = Ks + hs * BK * LDS + wr * LDS;
  const bf16* Vw = Vs + hs * BK * LDS + wr * LDS;

  for (int it = 0; it < walk.count; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) key_on[rr] = keys[rr] < S && Vm[keys[rr] - k0] != 0;
    }
    if (it + 1 < walk.count) prefetch(it + 1);
    const int buf = it & 1;
    const int q0 = walk.tile(it) * BQ;
    const bf16* Qt = Qs + buf * QG + hs * BQ * LDS;
    const bf16* Gt = Gs + buf * QG + hs * BQ * LDS;
    const float* st = St + (buf * HPB + hs) * 3 * BQ;
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      // Transposed 16 x 16 tiles: rows = this warp's keys, columns = queries.
      float sc[2][4], dw[2][4];
      mma_abt<NK, 2, LDS>(sc, Kw, Qt + kc * 16 * LDS, lane);
      mma_abt<NK, 2, LDS>(dw, Vw, Gt + kc * 16 * LDS, lane);
      float w[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = kc * 16 + n * 8 + 2 * t + (e & 1);  // query within the tile
          const int row = q0 + ci;
          const int key = keys[e >> 1];
          float x = 0.f;
          if (row < S && key < S) {
            const float l = (key > row || !key_on[e >> 1]) ? -FLT_MAX : sc[n][e];
            x = mtt::fast_exp(l - st[ci]) * st[BQ + ci];
          }
          w[n][e] = x;
          sc[n][e] = x * (dw[n][e] - st[2 * BQ + ci]);
        }
      mma_pv<NO, LDS, true>(akv, w[0], w[1], Gt + kc * 16 * LDS, col0, lane);
      mma_pv<NO, LDS, kSplitDl>(adk, sc[0], sc[1], Qt + kc * 16 * LDS, col0, lane);
    }
  }

  if (h0 + hs >= H) return;
  const long long out_off = (long long)b * S * ld_out + (long long)(h0 + hs) * D;
  store_rows<NO>(dk + out_off, ld_out, adk, keys[0], col0, S, D, pair_out, lane);
  store_rows<NO>(dv + out_off, ld_out, akv, keys[0], col0, S, D, pair_out, lane);
}

template <int NK, int NKO, int QW>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, const uint8_t* valid,
                       const bf16* g, bf16* dq, bf16* dk, bf16* dv, float* stats, int B, int S,
                       int H, int D, long long ld_in, long long ld_g, long long ld_out, int vec_in,
                       int vec_g, int pair_out, cudaStream_t stream) {
  constexpr int LDS = 16 * NK + 8;
  constexpr int HPB = 4 / QW;
  constexpr int BQ = 16 * QW;
  const size_t tiles = sizeof(bf16) * (size_t)6 * HPB * BQ * LDS;
  const size_t smem_dq = tiles + 2 * BQ + sizeof(int) * (kThreadsMma / 32);
  const size_t smem_dkdv =
      tiles + sizeof(float) * 6 * HPB * BQ + BQ + sizeof(int) * (kThreadsMma / 32);
  const int tiles_s = (S + BQ - 1) / BQ * (NK / NKO);
  const dim3 grid(tiles_s, (H + HPB - 1) / HPB, B);

  auto dq_kernel = attention_bwd_dq_mma_kernel<NK, NKO, QW>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreadsMma, smem_dq, stream>>>(q, k, v, valid, g, dq, stats, S, H, D, ld_in,
                                                    ld_g, ld_out, vec_in, vec_g, pair_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv_kernel = attention_bwd_dkdv_mma_kernel<NK, NKO, QW>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreadsMma, smem_dkdv, stream>>>(q, k, v, valid, g, dk, dv, stats, S, H, D,
                                                        ld_in, ld_g, ld_out, vec_in, vec_g,
                                                        pair_out);
  return cudaGetLastError();
}

// The forward's bf16 tile rules (attention_fwd.cu): NK k-steps of 16 from
// head_dim and NKO output k-steps per block (attention_common.cuh), 16 QW rows
// per head.
int mma_qw(int S, int nk) {
  if (nk > 5 || S > 32) return 4;
  return S <= 16 ? 1 : 2;
}

template <int NK>
cudaError_t launch_mma_qw(int qw, const bf16* q, const bf16* k, const bf16* v,
                          const uint8_t* valid, const bf16* g, bf16* dq, bf16* dk, bf16* dv,
                          float* stats, int B, int S, int H, int D, long long ld_in, long long ld_g,
                          long long ld_out, int vec_in, int vec_g, int pair_out,
                          cudaStream_t stream) {
  constexpr int NKO = NK <= 5 ? NK : 4;
#define MTT_ARGS \
  q, k, v, valid, g, dq, dk, dv, stats, B, S, H, D, ld_in, ld_g, ld_out, vec_in, vec_g, pair_out, stream
  if constexpr (NK <= 5) {
    if (qw == 1) return launch_mma<NK, NKO, 1>(MTT_ARGS);
    if (qw == 2) return launch_mma<NK, NKO, 2>(MTT_ARGS);
  }
  return launch_mma<NK, NKO, 4>(MTT_ARGS);
#undef MTT_ARGS
}

cudaError_t dispatch_mma(const bf16* q, const bf16* k, const bf16* v, const uint8_t* valid,
                         const bf16* g, bf16* dq, bf16* dk, bf16* dv, float* stats, int B, int S,
                         int H, int D, long long ld_in, long long ld_g, long long ld_out,
                         cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_in = D % 8 == 0 && ld_in % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const int vec_g = D % 8 == 0 && ld_g % 8 == 0 && aligned(g);
  const auto aligned4 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; };
  const int pair_out =
      D % 2 == 0 && ld_out % 2 == 0 && aligned4(dq) && aligned4(dk) && aligned4(dv);
  const int nk = mma_nk(D);
  const int qw = mma_qw(S, nk);
#define MTT_LAUNCH(NK)                                                                          \
  return launch_mma_qw<NK>(qw, q, k, v, valid, g, dq, dk, dv, stats, B, S, H, D, ld_in, ld_g,   \
                           ld_out, vec_in, vec_g, pair_out, stream)
  if (nk == 1) MTT_LAUNCH(1);
  if (nk == 2) MTT_LAUNCH(2);
  if (nk == 4) MTT_LAUNCH(4);
  if (nk == 5) MTT_LAUNCH(5);
  if (nk == 8) MTT_LAUNCH(8);
  MTT_LAUNCH(16);
#undef MTT_LAUNCH
}

}  // namespace

// The fp32 3xTF32 route (attention_bwd_tf32.cu).
extern "C" int tf32_bwd_takes(int S, int D);
extern "C" int tf32_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                               const void* dq, const void* dk, const void* dv, long long ld_in,
                               long long ld_g, long long ld_out);
extern "C" long long tf32_bwd_scratch(int B, int S, int H);
extern "C" void tf32_bwd_config(int S, int* cfg);
extern "C" int tf32_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                  const void* g, void* dq, void* dk, void* dv, void* scratch,
                                  int B, int S, int H, long long ld_in, long long ld_g,
                                  long long ld_out, void* stream);

// The fp32 3xTF32 wgmma/TMA route (attention_bwd_tf32_hopper.cu).
extern "C" int tf32w_bwd_takes(int S, int D);
extern "C" int tf32w_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                const void* dq, const void* dk, const void* dv, long long ld_in,
                                long long ld_g, long long ld_out);
extern "C" void tf32w_bwd_config(int* cfg);
extern "C" int tf32w_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                   const void* g, void* dq, void* dk, void* dv, void* stats, int B,
                                   int S, int H, long long ld_in, long long ld_g, long long ld_out,
                                   void* stream);

// The bf16 one-pass persistent route for short S (attention_bwd_short_hopper.cu).
extern "C" int short_bwd_takes(int S, int D);
extern "C" int short_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                const void* dq, const void* dk, const void* dv, long long ld_in,
                                long long ld_g, long long ld_out);
extern "C" void short_bwd_config(int S, int* cfg);
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                   const void* g, void* dq, void* dk, void* dv, int B, int S, int H,
                                   long long ld_in, long long ld_g, long long ld_out,
                                   void* stream);

// The bf16 wgmma/TMA route (attention_bwd_hopper.cu).
extern "C" int hopper_bwd_takes(int S, int D);
extern "C" int hopper_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                 long long ld_in, long long ld_g);
extern "C" void hopper_bwd_config(int* cfg);
extern "C" int hopper_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                    const void* g, void* dq, void* dk, void* dv, void* stats,
                                    int B, int S, int H, long long ld_in, long long ld_g,
                                    long long ld_out, void* stream);

// Floats of scratch attention_bwd needs for these operands: 0 on the bf16
// one-pass persistent route (short_bwd_takes(S, D) and its layout rule: q, k,
// v, g, dq, dk and dv rows and bases 16-byte aligned); on the fp32 3xTF32
// mma.sync route (tf32_bwd_takes(S, D) and its layout rule, where the wgmma
// route's rule does not hold) one chunk's W and dL tiles and row statistics
// (tf32_bwd_scratch); otherwise (the fp32 3xTF32 wgmma route among them) the
// row statistics, 3 B H Sp floats, Sp = S rounded up to 64. -1 for a dtype it
// does not take.
// Past kGridRows batch rows, the most any chunk of attention_bwd's needs.
extern "C" long long attention_bwd_scratch(const void* q, const void* k, const void* v,
                                           const void* g, const void* dq, const void* dk,
                                           const void* dv, int dtype, int B, int S, int H, int D,
                                           long long ld_in, long long ld_g, long long ld_out) {
  if (dtype == 1 && short_bwd_takes(S, D) &&
      short_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return 0;
  if (dtype != 0 && dtype != 1) return -1;
  const int rows = mtt::grid_chunk_rows(B);
  const int last = B - (B - 1) / rows * rows;
  const bool tf32w = dtype == 0 && tf32w_bwd_takes(S, D) &&
                     tf32w_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out);
  if (dtype == 0 && !tf32w && tf32_bwd_takes(S, D) &&
      tf32_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return std::max(tf32_bwd_scratch(rows, S, H), tf32_bwd_scratch(last, S, H));
  return 3LL * B * H * ((S + 63) / 64 * 64);
}

// dtype: 0 = float32, 1 = bfloat16. valid: (B, S) bytes, nonzero = valid key.
// stats: attention_bwd_scratch(...) floats of scratch, 16-byte aligned, or
// null where that is 0 (refused otherwise). Returns the CUDA error of the
// launches (0 on success); launches on `stream` and does not synchronize.
// bf16 takes the one-pass persistent route where short_bwd_takes(S, D) and
// its layout rule hold, then the wgmma/TMA route where hopper_bwd_takes(S, D)
// and its layout rule (q, k, v and g rows and bases 16-byte aligned) hold,
// and the mma.sync route otherwise; fp32 the 3xTF32 wgmma/TMA route where
// tf32w_bwd_takes(S, D) and its layout rule hold, then the 3xTF32 mma.sync
// route where tf32_bwd_takes(S, D) and its layout rule hold, and the
// CUDA-core route otherwise. A batch of more than kGridRows rows runs as
// chunks of rows (mtt::grid_chunk_rows), each a call of its own on `stream`,
// in order, reusing `stats` (attention_bwd_scratch sizes the largest chunk's).
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                             const void* g, void* dq, void* dk, void* dv, void* stats, int dtype,
                             int B, int S, int H, int D, long long ld_in, long long ld_g,
                             long long ld_out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > mtt::kGridRows) {
    const int rows = mtt::grid_chunk_rows(B);
    const long long elt = dtype == 0 ? 4 : 2;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const long long row = (long long)b0 * S * elt;
      const long long in = row * ld_in, gi = row * ld_g, to = row * ld_out;
      const int err = attention_bwd(
          mtt::byte_at(q, in), mtt::byte_at(k, in), mtt::byte_at(v, in),
          mtt::byte_at(valid, (long long)b0 * S), mtt::byte_at(g, gi), mtt::byte_at(dq, to),
          mtt::byte_at(dk, to), mtt::byte_at(dv, to), stats, dtype, std::min(rows, B - b0), S, H, D,
          ld_in, ld_g, ld_out, stream);
      if (err != 0) return err;
    }
    return 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(stats);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  if (dtype == 1 && short_bwd_takes(S, D) &&
      short_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return short_attention_bwd(q, k, v, valid, g, dq, dk, dv, B, S, H, ld_in, ld_g, ld_out, stream);
  if (sc == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && tf32w_bwd_takes(S, D) &&
      tf32w_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return tf32w_attention_bwd(q, k, v, valid, g, dq, dk, dv, stats, B, S, H, ld_in, ld_g, ld_out,
                               stream);
  if (dtype == 0 && tf32_bwd_takes(S, D) &&
      tf32_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return tf32_attention_bwd(q, k, v, valid, g, dq, dk, dv, stats, B, S, H, ld_in, ld_g, ld_out,
                              stream);
  if (dtype == 0)
    return (int)dispatch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), vm, static_cast<const float*>(g),
                             static_cast<float*>(dq), static_cast<float*>(dk),
                             static_cast<float*>(dv), sc, B, S, H, D, ld_in, ld_g, ld_out, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (hopper_bwd_takes(S, D) && hopper_bwd_layout(q, k, v, g, ld_in, ld_g))
    return hopper_attention_bwd(q, k, v, valid, g, dq, dk, dv, stats, B, S, H, ld_in, ld_g, ld_out,
                                stream);
  return (int)dispatch_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), vm, static_cast<const bf16*>(g),
                           static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           sc, B, S, H, D, ld_in, ld_g, ld_out, st);
}

// The route and tiles attention_bwd takes for (dtype, S, D) with a layout
// every route reads, for reports: cfg = {route (0: fp32 CUDA cores, 1: bf16
// mma.sync m16n8k16, 2: bf16 wgmma + TMA, 3: bf16 mma.sync one-pass fed by TMA,
// persistent, 4: fp32 3xTF32 mma.sync m16n8k8, 5: fp32 3xTF32 wgmma m64nNk8
// fed by TMA), threads, query rows per head and
// block of the dq kernel, keys per head and block of the dkdv kernel, heads
// per block, padded head_dim, output columns per block, dL as a hi + lo pair
// (1) or one bf16 operand (0)}. Returns 0, or cudaErrorInvalidValue.
extern "C" int attention_bwd_config(int dtype, int S, int D, int* cfg) {
  if (S <= 0 || D <= 0 || D > kMaxDim) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && tf32w_bwd_takes(S, D)) {
    tf32w_bwd_config(cfg);
    return 0;
  }
  if (dtype == 0 && tf32_bwd_takes(S, D)) {
    tf32_bwd_config(S, cfg);
    return 0;
  }
  if (dtype == 0) {
    const int tb = 16 * f32_tm(S, D);
    const int c[8] = {0, kThreadsF32, tb, tb, 1, D, D, 0};
    for (int i = 0; i < 8; ++i) cfg[i] = c[i];
    return 0;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (short_bwd_takes(S, D)) {
    short_bwd_config(S, cfg);
    return 0;
  }
  if (hopper_bwd_takes(S, D)) {
    hopper_bwd_config(cfg);
    return 0;
  }
  const int nk = mma_nk(D);
  const int qw = mma_qw(S, nk);
  const int c[8] = {1, kThreadsMma, 16 * qw, 16 * qw, 4 / qw, 16 * nk, 16 * mma_nko(nk),
                    kSplitDl ? 1 : 0};
  for (int i = 0; i < 8; ++i) cfg[i] = c[i];
  return 0;
}
