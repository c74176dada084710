// Causal + key-padding attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel
//       (fused_qkv_causal_attention, 8 <= S < 256 patch tokens)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_fwd_kernel
//       (fused_causal_attention, 256 <= S <= 1024 patch tokens)
// and the forward of the library flash kernel that
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention
// wraps for S > 2048 (B3, the port's flash_causal_attention). All compute, per (batch, head), softmax(mask(Q K^T)) V with q pre-scaled:
//   mask = (col <= row) & valid[col]; a masked logit is finfo(float32).min
//   (never -inf, so a query row with no valid key gets uniform weights over
//   all S keys, as in the JAX plain path); logits and softmax in fp32; the
//   weights are rounded to the compute dtype before the PV product (JAX's
//   w.astype(v.dtype)); PV accumulates in fp32; the output is written once
//   in the compute dtype.
// The two entry points differ only in where q, k and v sit in memory. Element
// (b, s, h, d) of q is q[(b * S + s) * ld_in + h * D + d], and likewise for k
// and v from their own base pointers; the output row stride is ld_out. For
// the fused-qkv layout (B, S, 3*H*D) the bases are offset by 0, H*D and 2*H*D
// columns and ld_in = 3*H*D; for (B, S, H, D) tensors ld_in = H*D.
//
// Design, simple first. One block of 256 threads per (tile of 64 query rows,
// head, batch). Keys are visited in tiles of 64 rows held in shared memory,
// twice: pass 1 keeps a running row max and sum of exp(l - max), pass 2
// recomputes the logits, forms exp(l - max) / sum, rounds it and accumulates
// W V. The (S, S) logits never leave the block and are never held whole: at
// S = 1024 they would be 4 MiB per (batch, head), at S = 2100 17 MiB. Offsets
// into q, k, v, out and the mask are 64-bit, so any S the card's memory
// holds is addressed; JAX's padding of S to a multiple of 128 is a TPU tile
// rule and is not needed here. Each thread owns a 4 x 4
// micro-tile of the 64 x 64 logit tile (rows ty + 16 i, keys tx + 16 j) and,
// for W V, 8 query rows x ceil(D / 32) output columns. Shared rows are padded
// to D + 1 floats so the K reads of the 16 key columns fall in distinct banks.
// head_dim is a runtime value up to 256 (80 on the main path, 5 x 16); no
// load assumes a power of two.
//
// What bounds it on an H100: every multiply-add runs on the fp32 CUDA cores
// (67 TFLOP/s), fed by scalar shared-memory loads (8 loads for 16 FMAs in the
// logit loop), so at best about half that rate; causal tiles above the
// diagonal are computed and masked, not skipped. At the main-path shapes the
// least time of the work itself is set by the bytes moved in bf16 and by the
// fp32 rate in fp32 (chip_smoke.py prints both bounds); this kernel is far
// from either. wgmma tiles, TMA loads and skipping fully-masked causal tiles
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kThreads = 256;
constexpr int kMaxDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dst[r * dp + d] = src[r * ld + d] for 64 rows; rows at or past `rows_left`
// are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows_left, int D, int dp,
                                          long long ld) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * dp + d] = r < rows_left ? to_f32(src[(long long)r * ld + d]) : 0.f;
  }
}

// Masked logits of this thread's micro-tile: rows q0 + ty + 16 i, keys
// k0 + tx + 16 j. Keys past the sequence end get -inf (no term at all);
// causal-future and padded keys get finfo(float32).min (a term that
// vanishes unless the whole row is masked).
__device__ __forceinline__ void tile_logits(const float* Qs, const float* Ks, const int* Vm, int D,
                                            int dp, int q0, int k0, int S, int tx, int ty,
                                            float l[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) l[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * dp + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * dp + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) l[i][j] = fmaf(qv[i], kv[j], l[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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

template <typename T, int NDS>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ valid,
                         T* __restrict__ out, int S, int D, long long ld_in, long long ld_out) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;                  // kBQ x dp
  float* Ks = Qs + kBQ * dp;         // kBK x dp
  float* Vs = Ks + kBK * dp;         // kBK x dp
  float* Ws = Vs + kBK * dp;         // kBQ x (kBK + 1)
  int* Vm = reinterpret_cast<int*>(Ws + kBQ * (kBK + 1));  // kBK key-valid flags

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * S * ld_in + (long long)h * D;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;
  const uint8_t* valid_b = valid + (long long)b * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile(Qs, qb + (long long)q0 * ld_in, S - q0, D, dp, ld_in);

  // Pass 1: running row max and sum of exp, in fp32.
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_tile(Ks, kb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    if (tid < kBK) Vm[tid] = (k0 + tid < S) ? (int)valid_b[k0 + tid] : 0;
    __syncthreads();
    float l[4][4];
    tile_logits(Qs, Ks, Vm, D, dp, q0, k0, S, tx, ty, l);
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

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();
    load_tile(Ks, kb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    load_tile(Vs, vb + (long long)k0 * ld_in, S - k0, D, dp, ld_in);
    if (tid < kBK) Vm[tid] = (k0 + tid < S) ? (int)valid_b[k0 + tid] : 0;
    __syncthreads();
    float l[4][4];
    tile_logits(Qs, Ks, Vm, D, dp, q0, k0, S, tx, ty, l);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = expf(l[i][j] - m[i]) / s[i];
        Ws[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = to_f32(from_f32<T>(w));
      }
    __syncthreads();
    const int kn = min(kBK, S - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = Ws[(warp + 8 * i) * (kBK + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
      }
    }
  }

  T* ob = out + (long long)b * S * ld_out + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * ld_out + d] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int NDS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                   int B, int S, int H, int D, long long ld_in, long long ld_out,
                   cudaStream_t stream) {
  const int dp = D + 1;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * dp + (size_t)kBQ * (kBK + 1)) +
                      sizeof(int) * kBK;
  auto kernel = attention_fwd_kernel<T, NDS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), S, D, ld_in, ld_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* valid, void* out,
                     int B, int S, int H, int D, long long ld_in, long long ld_out,
                     cudaStream_t stream) {
  // Output columns per lane: ceil(D / 32), rounded up to an instantiated count.
  const int nds = (D + 31) / 32;
  if (nds == 1) return launch<T, 1>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (nds == 2) return launch<T, 2>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (nds == 3) return launch<T, 3>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (nds == 4) return launch<T, 4>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  return launch<T, 8>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. valid: (B, S) bytes, nonzero = valid key.
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronize.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int dtype, int B, int S, int H, int D, long long ld_in,
                             long long ld_out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, st);
  return (int)cudaErrorInvalidValue;
}
