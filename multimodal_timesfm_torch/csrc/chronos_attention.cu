// Bidirectional T5 attention with a relative-position bias and segment
// masking, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's Chronos-2 encoder:
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel (B4f)
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// (fused_chronos_attention and its custom VJP). Per (batch, head):
//   L = Q K^T + bias[h]           q NOT scaled (T5), bias (H, S, S) fp32
//   L[i][j] = finfo(float32).min  where seg[b][i] != seg[b][j]
//   W = softmax(L) in fp32        every token keeps at least its own key
//   O = round(W) V                W rounded to the compute dtype, fp32 sum
// and, backward, from the same qkv, seg and bias (nothing else is saved):
//   dV = W^T G,  dW = G V^T,  dL = W o (dW - rowsum(dW o W)),
//   dQ = dL K,   dK = dL^T Q,  dbias[h] = sum over the batch of dL,
// with the unrounded fp32 W, each output cast once. q, k and v are read in
// place from the (B, S, 3*H*D) projection (column blocks q|k|v, head h at
// column h*D of each block, row stride 3*H*D); the output is (B, S, H*D) and
// dqkv (B, S, 3*H*D) in the same layout, so nothing is split, copied or
// transposed on the host.
//
// Design, simple first, after csrc/attention_fwd.cu and attention_bwd.cu.
// The TPU kernel holds a whole row tile of (rows, rows) logits per head in
// VMEM; here one block of 256 threads takes a (query tile, head, batch) and
// walks the keys in shared-memory tiles, so no (S, S) tile is ever held
// (S = 577 at context 8192). Forward: pass 1 keeps an online row max and
// sum, pass 2 forms W, rounds it and accumulates W V (64-row tiles). The
// backward is three kernels on the caller's stream, none with atomics:
//   1. dq, per (query tile, head, batch): an online max m, sum s and
//      t = sum exp(l - m) dW over the keys, so r = rowsum(dW o W) = t / s;
//      (m, s, r) go to a (3, B, H, S) fp32 scratch; a second walk forms
//      dL = W (dW - r) and dQ = dL K. When the bias needs a gradient, the
//      same walk also writes dL to a (B, H, S, S) fp32 scratch.
//   2. dkdv, per (key tile, head, batch): walks the query tiles with the
//      row statistics; dV += W^T G, dK += dL^T Q.
//   3. dbias, only when the bias needs a gradient: one thread per (h, i, j)
//      sums the B partial dL values in batch order.
// The TPU sums dbias into an output block that its sequential grid
// revisits; CUDA blocks run concurrently and in no order, so the sum over
// the batch is a separate pass. Per-batch partials were chosen over a
// kernel that recomputes dL for every batch row inside a (head, tile, tile)
// block because kernel 1 already has dL in registers: the partials cost one
// write and one read of B*H*S*S fp32 values (28 MB at the baseline
// fine-tune's B = 128, S = 67, about 17 us at 3.35 TB/s), where a recompute
// would repeat kernel 1's products on the CUDA cores. Both reductions run in
// a fixed order, so two launches give bit-equal dbias. Multimodal training
// freezes the bias and launches neither the partial writes nor kernel 3.
// Tiles are TB = 16 * TM rows in the backward: 64 (TM = 4) up to head_dim
// 128, 32 (TM = 2) above, so four (TB, D + 1) fp32 tiles fit in shared
// memory at D = 256. Each thread owns a TM x TM micro-tile of the logit tile
// (rows ty + 16 i, keys tx + 16 j) and, for the products with the (TB, D)
// tiles, TB / 8 rows x ceil(D / 32) columns. Shared rows are padded to
// D + 1 floats. S and D are runtime values (S any length, D up to 256).
//
// What bounds it on an H100: every multiply-add runs on the fp32 CUDA cores
// (67 TFLOP/s) fed by scalar shared-memory loads, and the bias is read once
// per (batch, head) from device memory (through L2, where the H*S*S*4 bytes
// fit: 16 MB at S = 577). At Chronos-2's shapes (H = 12, D = 64, S = 67 to
// 577) the least time of the work is set by the bytes in bf16 and by the
// fp32 rate in fp32 (chip_smoke.py prints both); this kernel is far from
// either. mma/wgmma tiles, TMA loads and keeping the bias tile in shared
// memory across the batch are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 256;
constexpr int kFwdTile = 64;  // forward: query rows per block and keys per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dst[r * dp + d] = src[r * ld + d] for TB rows; rows at or past `rows_left`
// are zero.
template <int TB, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows_left, int D, int dp,
                                          long long ld) {
  for (int i = threadIdx.x; i < TB * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * dp + d] = r < rows_left ? to_f32(src[(long long)r * ld + d]) : 0.f;
  }
}

// dst[r] = seg[r0 + r] for TB rows; rows past S get 0 (they are never read
// as keys: their logits are -inf; as queries they are never written).
template <int TB>
__device__ __forceinline__ void load_seg(int* dst, const int* seg_b, int r0, int S) {
  if ((int)threadIdx.x < TB) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = r < S ? seg_b[r] : 0;
  }
}

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

// Bias and segment mask on a micro-tile of Q K^T: rows q0 + ty + 16 i (query
// segments Sq), keys k0 + tx + 16 j (key segments Sk). A key past the
// sequence end gets -inf (no term); a key of another segment gets
// finfo(float32).min; an allowed pair gets its bias added. Rows past S are
// left as they are (never written, and zero-weighted in the backward).
template <int TM>
__device__ __forceinline__ void bias_and_mask(float l[TM][TM], const int* Sq, const int* Sk,
                                              const float* bias_h, int q0, int k0, int S, int tx,
                                              int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ri = ty + 16 * i;
    const int row = q0 + ri;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      if (col >= S) {
        l[i][j] = -INFINITY;
      } else if (row < S) {
        l[i][j] = Sq[ri] == Sk[c] ? l[i][j] + bias_h[(long long)row * S + col] : -FLT_MAX;
      }
    }
  }
}

// Reductions over the 16 lanes that share a micro-tile row (tx = lane & 15).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// B4f: forward, one block per (64-row query tile, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int NDS>
__global__ void __launch_bounds__(kThreads)
    chronos_fwd_kernel(const T* __restrict__ qkv, const int* __restrict__ seg,
                       const float* __restrict__ bias, T* __restrict__ out, int S, int H, int D) {
  constexpr int TB = kFwdTile;
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;                // TB x dp
  float* Ks = Qs + TB * dp;        // TB x dp
  float* Vs = Ks + TB * dp;        // TB x dp
  float* Ws = Vs + TB * dp;        // TB x (TB + 1): rounded weights
  int* Sq = reinterpret_cast<int*>(Ws + TB * (TB + 1));  // TB query segments
  int* Sk = Sq + TB;                                      // TB key segments

  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const T* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const T* kb = qb + hd;
  const T* vb = qb + 2 * hd;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile<TB>(Qs, qb + (long long)q0 * ld, S - q0, D, dp, ld);
  load_seg<TB>(Sq, seg_b, q0, S);

  // Pass 1: running row max and sum of exp, in fp32.
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += TB) {
    __syncthreads();
    load_tile<TB>(Ks, kb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_seg<TB>(Sk, seg_b, k0, S);
    __syncthreads();
    float l[4][4];
    micro_dot<4>(Qs, Ks, D, dp, tx, ty, l);
    bias_and_mask<4>(l, Sq, Sk, bias_h, q0, k0, S, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float tmax = row_max(fmaxf(fmaxf(l[i][0], l[i][1]), fmaxf(l[i][2], l[i][3])));
      const float nm = fmaxf(m[i], tmax);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps += expf(l[i][j] - nm);
      s[i] = s[i] * expf(m[i] - nm) + row_sum(ps);
      m[i] = nm;
    }
  }

  // Pass 2: normalized weights, rounded to the compute dtype, times V.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[8][NDS];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += TB) {
    __syncthreads();
    load_tile<TB>(Ks, kb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_tile<TB>(Vs, vb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_seg<TB>(Sk, seg_b, k0, S);
    __syncthreads();
    float l[4][4];
    micro_dot<4>(Qs, Ks, D, dp, tx, ty, l);
    bias_and_mask<4>(l, Sq, Sk, bias_h, q0, k0, S, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = expf(l[i][j] - m[i]) / s[i];
        Ws[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = to_f32(from_f32<T>(w));
      }
    __syncthreads();
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = Ws[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
      }
    }
  }

  T* ob = out + (long long)b * S * hd + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * hd + d] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// B4b kernel 1: row statistics, dQ and (optionally) the per-batch dL
// ---------------------------------------------------------------------------

template <typename T, int TM, int NDS>
__global__ void __launch_bounds__(kThreads)
    chronos_bwd_dq_kernel(const T* __restrict__ qkv, const int* __restrict__ seg,
                          const float* __restrict__ bias, const T* __restrict__ g,
                          T* __restrict__ dqkv, float* __restrict__ stats,
                          float* __restrict__ partials, int S, int H, int D) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;               // TB x dp
  float* Gs = Qs + TB * dp;       // TB x dp
  float* Ks = Gs + TB * dp;       // TB x dp
  float* Vs = Ks + TB * dp;       // TB x dp
  float* Ps = Vs + TB * dp;       // TB x (TB + 1): dL tile
  int* Sq = reinterpret_cast<int*>(Ps + TB * (TB + 1));  // TB query segments
  int* Sk = Sq + TB;                                      // TB key segments

  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const T* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const T* kb = qb + hd;
  const T* vb = qb + 2 * hd;
  const T* gb = g + (long long)b * S * hd + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const long long bh = (long long)b * H + h;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile<TB>(Qs, qb + (long long)q0 * ld, S - q0, D, dp, ld);
  load_tile<TB>(Gs, gb + (long long)q0 * hd, S - q0, D, dp, hd);
  load_seg<TB>(Sq, seg_b, q0, S);

  // Pass 1: online row max m, sum s of exp(l - m), and t = sum exp(l - m) dW.
  float m[TM], s[TM], t[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
    t[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += TB) {
    __syncthreads();
    load_tile<TB>(Ks, kb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_tile<TB>(Vs, vb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_seg<TB>(Sk, seg_b, k0, S);
    __syncthreads();
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Ks, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq, Sk, bias_h, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs, D, dp, tx, ty, dw);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = l[i][0];
#pragma unroll
      for (int j = 1; j < TM; ++j) tmax = fmaxf(tmax, l[i][j]);
      const float nm = fmaxf(m[i], row_max(tmax));
      float ps = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float e = expf(l[i][j] - nm);
        ps += e;
        pt = fmaf(e, dw[i][j], pt);
      }
      const float scale = expf(m[i] - nm);
      s[i] = s[i] * scale + row_sum(ps);
      t[i] = t[i] * scale + row_sum(pt);
      m[i] = nm;
    }
  }
  float r[TM];
  const long long plane = (long long)gridDim.z * H * S;  // B * H * S
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

  // Pass 2: dL = W (dW - r) through shared memory (and to the partials),
  // dQ += dL K.
  float* part_bh = partials == nullptr ? nullptr : partials + bh * S * S;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += TB) {
    __syncthreads();
    load_tile<TB>(Ks, kb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_tile<TB>(Vs, vb + (long long)k0 * ld, S - k0, D, dp, ld);
    load_seg<TB>(Sk, seg_b, k0, S);
    __syncthreads();
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Ks, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq, Sk, bias_h, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs, D, dp, tx, ty, dw);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float w = expf(l[i][j] - m[i]) / s[i];
        const float dl = w * (dw[i][j] - r[i]);
        Ps[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = dl;
        const int col = k0 + tx + 16 * j;
        if (part_bh != nullptr && row < S && col < S) part_bh[(long long)row * S + col] = dl;
      }
    }
    __syncthreads();
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float kv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? Ks[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float p = Ps[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(p, kv[c], acc[i][c]);
      }
    }
  }

  T* ob = dqkv + (long long)b * S * ld + (long long)h * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * ld + d] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// B4b kernel 2: dK and dV for one (key tile, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int TM, int NDS>
__global__ void __launch_bounds__(kThreads)
    chronos_bwd_dkdv_kernel(const T* __restrict__ qkv, const int* __restrict__ seg,
                            const float* __restrict__ bias, const T* __restrict__ g,
                            T* __restrict__ dqkv, const float* __restrict__ stats, int S, int H,
                            int D) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Ks = smem;               // TB x dp
  float* Vs = Ks + TB * dp;       // TB x dp
  float* Qs = Vs + TB * dp;       // TB x dp
  float* Gs = Qs + TB * dp;       // TB x dp
  float* Ws = Gs + TB * dp;       // TB x (TB + 1): W tile, rows = queries
  float* Ps = Ws + TB * (TB + 1); // TB x (TB + 1): dL tile
  float* Sm = Ps + TB * (TB + 1); // TB row maxima
  float* Ss = Sm + TB;            // TB row sums
  float* Sr = Ss + TB;            // TB row terms
  int* Sq = reinterpret_cast<int*>(Sr + TB);  // TB query segments
  int* Sk = Sq + TB;                           // TB key segments

  const int k0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const T* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const T* gb = g + (long long)b * S * hd + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;

  load_tile<TB>(Ks, qb + hd + (long long)k0 * ld, S - k0, D, dp, ld);
  load_tile<TB>(Vs, qb + 2 * hd + (long long)k0 * ld, S - k0, D, dp, ld);
  load_seg<TB>(Sk, seg_b, k0, S);

  float akv[RPW][NDS], adk[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      akv[i][c] = 0.f;
      adk[i][c] = 0.f;
    }

  for (int q0 = 0; q0 < S; q0 += TB) {
    __syncthreads();
    load_tile<TB>(Qs, qb + (long long)q0 * ld, S - q0, D, dp, ld);
    load_tile<TB>(Gs, gb + (long long)q0 * hd, S - q0, D, dp, hd);
    load_seg<TB>(Sq, seg_b, q0, S);
    if (tid < TB) {
      const int row = q0 + tid;
      const bool in = row < S;
      Sm[tid] = in ? stats[bh * S + row] : 0.f;
      Ss[tid] = in ? stats[plane + bh * S + row] : 1.f;
      Sr[tid] = in ? stats[2 * plane + bh * S + row] : 0.f;
    }
    __syncthreads();
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Ks, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq, Sk, bias_h, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs, D, dp, tx, ty, dw);
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
        gv[c] = d < D ? Gs[i * dp + d] : 0.f;
        qv[c] = d < D ? Qs[i * dp + d] : 0.f;
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

  T* ob = dqkv + (long long)b * S * ld + (long long)h * D;
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    const int key = k0 + warp + 8 * a;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        ob[hd + (long long)key * ld + d] = from_f32<T>(adk[a][c]);
        ob[2 * hd + (long long)key * ld + d] = from_f32<T>(akv[a][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B4b kernel 3: dbias[e] = sum over b, in order, of partials[b][e]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    chronos_bwd_dbias_kernel(const float* __restrict__ partials, float* __restrict__ dbias, int B,
                             long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += partials[(long long)b * n + e];
  dbias[e] = acc;
}

template <typename T, int NDS>
cudaError_t launch_fwd(const void* qkv, const void* seg, const void* bias, void* out, int B, int S,
                       int H, int D, cudaStream_t stream) {
  constexpr int TB = kFwdTile;
  const int dp = D + 1;
  const size_t smem = sizeof(float) * ((size_t)3 * TB * dp + (size_t)TB * (TB + 1)) +
                      sizeof(int) * 2 * TB;
  auto kernel = chronos_fwd_kernel<T, NDS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TB - 1) / TB, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<const int*>(seg),
                                           static_cast<const float*>(bias), static_cast<T*>(out),
                                           S, H, D);
  return cudaGetLastError();
}

template <typename T, int TM, int NDS>
cudaError_t launch_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                       void* dqkv, float* dbias, float* stats, float* partials, int B, int S,
                       int H, int D, cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  const size_t tiles = sizeof(float) * 4 * (size_t)TB * dp;
  const size_t smem_dq = tiles + sizeof(float) * TB * (TB + 1) + sizeof(int) * 2 * TB;
  const size_t smem_dkdv =
      tiles + sizeof(float) * (2 * TB * (TB + 1) + 3 * TB) + sizeof(int) * 2 * TB;
  const dim3 grid((S + TB - 1) / TB, H, B);
  const T* q = static_cast<const T*>(qkv);
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  const T* gg = static_cast<const T*>(g);
  T* dq = static_cast<T*>(dqkv);

  auto dq_kernel = chronos_bwd_dq_kernel<T, TM, NDS>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(q, sg, bs, gg, dq, stats,
                                                 dbias == nullptr ? nullptr : partials, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv_kernel = chronos_bwd_dkdv_kernel<T, TM, NDS>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(q, sg, bs, gg, dq, stats, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return err;

  const long long n = (long long)H * S * S;
  chronos_bwd_dbias_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partials, dbias, B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* qkv, const void* seg, const void* bias, void* out, int B,
                         int S, int H, int D, cudaStream_t stream) {
  // Output columns per lane: ceil(D / 32), rounded up to an instantiated count.
  const int nds = (D + 31) / 32;
  if (nds == 1) return launch_fwd<T, 1>(qkv, seg, bias, out, B, S, H, D, stream);
  if (nds == 2) return launch_fwd<T, 2>(qkv, seg, bias, out, B, S, H, D, stream);
  if (nds == 3) return launch_fwd<T, 3>(qkv, seg, bias, out, B, S, H, D, stream);
  if (nds == 4) return launch_fwd<T, 4>(qkv, seg, bias, out, B, S, H, D, stream);
  return launch_fwd<T, 8>(qkv, seg, bias, out, B, S, H, D, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                         void* dqkv, float* dbias, float* stats, float* partials, int B, int S,
                         int H, int D, cudaStream_t stream) {
  // 64-row tiles up to D = 128, 32-row tiles above (see the header).
  const int nds = (D + 31) / 32;
#define MTT_LAUNCH(TM, NDS)                                                                    \
  return launch_bwd<T, TM, NDS>(qkv, seg, bias, g, dqkv, dbias, stats, partials, B, S, H, D, \
                                stream)
  if (nds == 1) MTT_LAUNCH(4, 1);
  if (nds == 2) MTT_LAUNCH(4, 2);
  if (nds == 3) MTT_LAUNCH(4, 3);
  if (nds == 4) MTT_LAUNCH(4, 4);
  MTT_LAUNCH(2, 8);
#undef MTT_LAUNCH
}

bool bad_shape(int B, int S, int H, int D) {
  return B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || B > 65535 || H > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv (B, S, 3*H*D) and out (B, S, H*D)
// contiguous in that dtype; seg (B, S) int32; bias (H, S, S) fp32. Returns
// the CUDA error of the launch (0 on success); launches on `stream` and does
// not synchronize.
extern "C" int chronos_attention_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                     int dtype, int B, int S, int H, int D, void* stream) {
  if (bad_shape(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_fwd<float>(qkv, seg, bias, out, B, S, H, D, st);
  if (dtype == 1) return (int)dispatch_fwd<__nv_bfloat16>(qkv, seg, bias, out, B, S, H, D, st);
  return (int)cudaErrorInvalidValue;
}

// g (B, S, H*D) and dqkv (B, S, 3*H*D) contiguous in qkv's dtype, dqkv
// written whole; stats: 3*B*H*S floats of scratch. dbias (H, S, S) fp32 and
// partials (B*H*S*S floats of scratch) are both null or both given: with
// them, dbias is written whole. Returns the CUDA error of the launches.
extern "C" int chronos_attention_bwd(const void* qkv, const void* seg, const void* bias,
                                     const void* g, void* dqkv, void* dbias, void* stats,
                                     void* partials, int dtype, int B, int S, int H, int D,
                                     void* stream) {
  if (bad_shape(B, S, H, D) || (dbias == nullptr) != (partials == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  float* sc = static_cast<float*>(stats);
  float* pt = static_cast<float*>(partials);
  if (dtype == 0)
    return (int)dispatch_bwd<float>(qkv, seg, bias, g, dqkv, db, sc, pt, B, S, H, D, st);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(qkv, seg, bias, g, dqkv, db, sc, pt, B, S, H, D, st);
  return (int)cudaErrorInvalidValue;
}
