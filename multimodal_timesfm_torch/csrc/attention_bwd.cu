// Causal + key-padding attention backward for Hopper (sm_90a).
//
// Replaces the backward halves of two Pallas TPU kernels of the JAX package:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel
//       (fused_qkv_causal_attention's VJP, 8 <= S < 256 patch tokens)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_bwd_kernel
//       (fused_causal_attention's VJP, 256 <= S <= 1024 patch tokens)
// Both recompute, per (batch, head), from the saved q, k, v and key mask:
//   W  = softmax(mask(Q K^T))          fp32, NOT rounded to the compute dtype
//   dV = W^T G,   dW = G V^T,   dL = W o (dW - rowsum(dW o W)),
//   dQ = dL K,    dK = dL^T Q,
// accumulating in fp32 and casting each output once. The mask is the forward
// kernel's (csrc/attention_fwd.cu): a causal-future or padded key gets the
// logit finfo(float32).min, a key past S no term; a query row with no valid
// key therefore has uniform weights over all S keys. No residual beyond what
// JAX saves (q, k, v, mask) comes from the forward: the row max, row sum and
// the row term r_i = rowsum(dW o W)_i = g_i . (sum_j W_ij v_j) are recomputed
// here and kept in a (3, B, H, S) fp32 scratch that lives for one call.
//
// Where q, k, v, g and the outputs sit: element (b, s, h, d) of q is
// q[(b * S + s) * ld_in + h * D + d], likewise k and v; g has row stride ld_g;
// dq, dk and dv share row stride ld_out. The fused-qkv entry point passes
// base pointers 0, H*D and 2*H*D columns into the (B, S, 3*H*D) qkv with
// ld_in = 3*H*D, and the same offsets into one (B, S, 3*H*D) dqkv with
// ld_out = 3*H*D, so dq|dk|dv land where JAX's _bwd_kernel writes them; the
// whole-sequence entry point passes (B, S, H, D) tensors.
//
// Design, simple first. The TPU program holds a whole (S, S) slab per
// (batch, head); at S = 1024 that is 4 MiB, far beyond 227 KB of shared
// memory, and dK, dV sum over query rows while dQ sums over keys. So two
// kernels, both launched on the caller's stream, with no atomics (the
// gradients are the same from run to run):
//   1. dq: one block per (query tile, head, batch). Pass 1 walks the key
//      tiles once, keeping per row an online max m, sum s = sum exp(l - m)
//      and t = sum exp(l - m) dW, so r = t / s; it writes (m, s, r) to the
//      scratch. Pass 2 walks the key tiles again: W = exp(l - m) / s,
//      dL = W (dW - r) into shared memory, dQ += dL K.
//   2. dkdv: one block per (key tile, head, batch), after kernel 1 on the
//      same stream. It walks the query tiles: W and dL from the scratch's
//      row statistics, then dV += W^T G and dK += dL^T Q.
// Tiles are TB = 16 * TM rows: 64 (TM = 4) for head_dim <= 128, 32 (TM = 2)
// above, so four (TB, D + 1) fp32 tiles fit in shared memory at D = 256.
// 256 threads; each owns a TM x TM micro-tile of the (TB, TB) logit tile
// (rows ty + 16 i, columns tx + 16 j) and, for the products with the (TB, D)
// tiles, TB / 8 rows x ceil(D / 32) columns. Shared rows are padded to D + 1
// floats, as in the forward. head_dim is a runtime value up to 256 (80 on the
// main path).
//
// What bounds it on an H100: every multiply-add runs on the fp32 CUDA cores
// (67 TFLOP/s) fed by scalar shared-memory loads; QK^T and G V^T are computed
// twice in kernel 1 and once more in kernel 2, and causal tiles above the
// diagonal are computed and masked, not skipped (a query row with no valid
// key needs every key). At the main-path shapes the least time of the work
// is set by the bytes moved in bf16 and by the fp32 rate in fp32
// (chip_smoke.py prints both); this kernel is far from either. mma/wgmma
// tiles, TMA loads and skipping masked tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 256;

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

__device__ __forceinline__ void load_valid(int* Vm, const uint8_t* valid_b, int k0, int S, int TB) {
  if ((int)threadIdx.x < TB) {
    const int col = k0 + threadIdx.x;
    Vm[threadIdx.x] = col < S ? (int)valid_b[col] : 0;
  }
}

// Kernel 1: row statistics and dQ for one (query tile, head, batch).
template <typename T, int TM, int NDS>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ valid,
                            const T* __restrict__ g, T* __restrict__ dq,
                            float* __restrict__ stats, int S, int H, int D, long long ld_in,
                            long long ld_g, long long ld_out) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;               // TB x dp
  float* Gs = Qs + TB * dp;       // TB x dp
  float* Ks = Gs + TB * dp;       // TB x dp
  float* Vs = Ks + TB * dp;       // TB x dp
  float* Ps = Vs + TB * dp;       // TB x (TB + 1): dL tile
  int* Vm = reinterpret_cast<int*>(Ps + TB * (TB + 1));  // TB key-valid flags

  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * S * ld_in + (long long)h * D;
  const T* kb = k + in_off;
  const T* vb = v + in_off;
  const uint8_t* valid_b = valid + (long long)b * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile<TB>(Qs, q + in_off + (long long)q0 * ld_in, S - q0, D, dp, ld_in);
  load_tile<TB>(Gs, g + (long long)b * S * ld_g + (long long)h * D + (long long)q0 * ld_g, S - q0,
                D, dp, ld_g);

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
    load_tile<TB>(Ks, kb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    load_tile<TB>(Vs, vb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    load_valid(Vm, valid_b, k0, S, TB);
    __syncthreads();
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Ks, D, dp, tx, ty, l);
    mask_logits<TM>(l, Vm, q0, k0, S, tx, ty);
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
  const long long bh = (long long)b * H + h;
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

  // Pass 2: dL = W (dW - r) through shared memory, dQ += dL K.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += TB) {
    __syncthreads();
    load_tile<TB>(Ks, kb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    load_tile<TB>(Vs, vb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    load_valid(Vm, valid_b, k0, S, TB);
    __syncthreads();
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Ks, D, dp, tx, ty, l);
    mask_logits<TM>(l, Vm, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs, D, dp, tx, ty, dw);
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

  T* ob = dq + (long long)b * S * ld_out + (long long)h * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * ld_out + d] = from_f32<T>(acc[i][c]);
    }
  }
}

// Kernel 2: dK and dV for one (key tile, head, batch), from kernel 1's row
// statistics.
template <typename T, int TM, int NDS>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const uint8_t* __restrict__ valid,
                              const T* __restrict__ g, T* __restrict__ dk, T* __restrict__ dv,
                              const float* __restrict__ stats, int S, int H, int D,
                              long long ld_in, long long ld_g, long long ld_out) {
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
  int* Vm = reinterpret_cast<int*>(Sr + TB);  // TB key-valid flags

  const int k0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * S * ld_in + (long long)h * D;
  const T* qb = q + in_off;
  const T* gb = g + (long long)b * S * ld_g + (long long)h * D;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;

  load_tile<TB>(Ks, k + in_off + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
  load_tile<TB>(Vs, v + in_off + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
  load_valid(Vm, valid + (long long)b * S, k0, S, TB);

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
    load_tile<TB>(Qs, qb + (long long)q0 * ld_in, S - q0, D, dp, ld_in);
    load_tile<TB>(Gs, gb + (long long)q0 * ld_g, S - q0, D, dp, ld_g);
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
    mask_logits<TM>(l, Vm, q0, k0, S, tx, ty);
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

  const long long out_off = (long long)b * S * ld_out + (long long)h * D;
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    const int key = k0 + warp + 8 * a;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[out_off + (long long)key * ld_out + d] = from_f32<T>(adk[a][c]);
        dv[out_off + (long long)key * ld_out + d] = from_f32<T>(akv[a][c]);
      }
    }
  }
}

template <typename T, int TM, int NDS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, const void* g,
                   void* dq, void* dk, void* dv, float* stats, int B, int S, int H, int D,
                   long long ld_in, long long ld_g, long long ld_out, cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  const size_t tiles = sizeof(float) * 4 * (size_t)TB * dp;
  const size_t smem_dq = tiles + sizeof(float) * TB * (TB + 1) + sizeof(int) * TB;
  const size_t smem_dkdv = tiles + sizeof(float) * (2 * TB * (TB + 1) + 3 * TB) + sizeof(int) * TB;
  const dim3 grid((S + TB - 1) / TB, H, B);

  auto dq_kernel = attention_bwd_dq_kernel<T, TM, NDS>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(g), static_cast<T*>(dq), stats, S,
      H, D, ld_in, ld_g, ld_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv_kernel = attention_bwd_dkdv_kernel<T, TM, NDS>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(g), static_cast<T*>(dk),
      static_cast<T*>(dv), stats, S, H, D, ld_in, ld_g, ld_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* valid, const void* g,
                     void* dq, void* dk, void* dv, float* stats, int B, int S, int H, int D,
                     long long ld_in, long long ld_g, long long ld_out, cudaStream_t stream) {
  // Output columns per lane: ceil(D / 32), rounded up to an instantiated
  // count; 64-row tiles up to D = 128, 32-row tiles above.
  const int nds = (D + 31) / 32;
#define MTT_LAUNCH(TM, NDS)                                                                     \
  return launch<T, TM, NDS>(q, k, v, valid, g, dq, dk, dv, stats, B, S, H, D, ld_in, ld_g, ld_out, \
                            stream)
  if (nds == 1) MTT_LAUNCH(4, 1);
  if (nds == 2) MTT_LAUNCH(4, 2);
  if (nds == 3) MTT_LAUNCH(4, 3);
  if (nds == 4) MTT_LAUNCH(4, 4);
  MTT_LAUNCH(2, 8);
#undef MTT_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. valid: (B, S) bytes, nonzero = valid key.
// stats: 3 * B * H * S floats of scratch. Returns the CUDA error of the
// launches (0 on success); launches on `stream` and does not synchronize.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                             const void* g, void* dq, void* dk, void* dv, void* stats, int dtype,
                             int B, int S, int H, int D, long long ld_in, long long ld_g,
                             long long ld_out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, valid, g, dq, dk, dv, sc, B, S, H, D, ld_in, ld_g, ld_out,
                                st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, valid, g, dq, dk, dv, sc, B, S, H, D, ld_in, ld_g,
                                        ld_out, st);
  return (int)cudaErrorInvalidValue;
}
