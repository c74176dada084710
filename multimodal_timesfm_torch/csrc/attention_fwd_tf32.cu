// Causal + key-padding attention forward (B1f, B2f, B3f), fp32, head_dim 80:
// the 3xTF32 tensor-core route for Hopper (sm_90a), taken by attention_fwd
// (attention_fwd.cu) where tf32_fwd_takes and tf32_fwd_layout below hold; the
// backward's half is attention_bwd_tf32.cu, the shared pieces
// attention_tf32.cuh and tf32_common.cuh.
//
// Replaces, where the rule sends them here, in fp32 (TimesFM's default
// compute dtype, TimesFMConfig.compute_dtype):
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel (B1f)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_fwd_kernel (B2f)
// and the forward of the library flash kernel behind
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention (B3f).
// The function and the mask are attention_fwd.cu's (its header): mask =
// (col <= row) & valid[col], a masked logit finfo(float32).min (a row with
// no valid key gets uniform weights over all S keys), a key past S no term;
// in fp32 JAX's w.astype(v.dtype) is the identity.
//
// Arithmetic: Chronos's 3xTF32 route's (chronos_attention_tf32.cu's header):
// Q K^T and W V on mma.sync m16n8k8 with TF32 operands and fp32
// accumulators, each operand split in the kernel into hi = tf32(x) and lo =
// tf32(x - hi), each product taken as lo hi + hi lo + hi hi (about 2^-21 of
// each term, against 2^-11 for one TF32 product, which misses the fp32
// tolerance: tests/test_torch_port_causal_tf32.py); the softmax and the mask
// in fp32, the exponentials the SFU's (mtt::fast_exp).
//
// Design. One block per (query tile, head, batch row), the longest key walk
// first; each warp owns 16 query rows. Up to kOneTileTo = 80 tokens one tile
// of S padded to 16 holds every query and key (B1 at 16 tokens: one warp; at
// 64: four); past that 64-row query and key tiles, K and V through a
// two-slot ring of 16-byte cp.async copies. The block walks only the key
// tiles the skip rule keeps (mtt::key_tiles, attention_common.cuh: none
// above the diagonal and none wholly left of the first valid key, unless the
// query tile holds a row with no valid key, which walks all), in one pass
// with an online softmax (running max m and sum l, the output rescaled when
// m grows, divided by l at the end): with W kept in fp32, the two passes of
// the CUDA-core route (attention_fwd.cu) buy nothing. A masked key before
// the row's first valid key adds exp(0) = 1 while the running max is still
// finfo.min and is wiped (scaled by exp(finfo.min - m) = 0) once a valid key
// raises it, so rows with a valid key get exact zeros there and rows with
// none the uniform weights. Q's fragments come from shared memory at every
// tile, by ldmatrix (in registers they cost the Chronos route occupancy);
// W's A fragment comes straight from the logits' accumulators (acc_to_a,
// load_bp: the keys of a k-step in the accumulator's order). Rows of 84
// floats put every fragment load on 32 distinct banks (tf32_common.cuh). A
// key tile that no mask touches for a warp's rows skips the mask
// (mtt::tile_unmasked).
//
// What bounds it on an H100: the 3xTF32 products at a third of the TF32
// tensor rate, 495 / 3 = 165 TFLOP/s (chip_smoke.py's bound_ms for the
// route's rows); mma.sync reaches part of it, and each product pays its
// operands' split and shared loads; two blocks an SM at 64-row tiles (107.5
// KB of shared memory each). Route 5 (attention_fwd_tf32_hopper.cu) stages
// V^T for wgmma, which takes TF32 only K-major, and takes the lengths from
// its border on.

#include "attention_tf32.cuh"

namespace {

using namespace mtt::tf32;
using namespace mtt::tf32::causal;

template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const uint8_t* __restrict__ valid,
                              float* __restrict__ out, int S, long long ld_in, long long ld_out) {
  constexpr int NT = KT / 8;  // n-tiles of a warp's logit row
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  extern __shared__ __align__(16) float smem[];
  const int nqt = (S + KT - 1) / KT;
  const int stages = nqt > 1 ? 2 : 1;
  float* Qs = smem;                                                    // TILE
  float* ring = Qs + TILE;                                             // stages x (K, V) tiles
  uint8_t* Vm = reinterpret_cast<uint8_t*>(ring + 2 * stages * TILE);  // stages x KT key flags
  int* red = reinterpret_cast<int*>(Vm + 2 * KT);                      // one int per warp

  const int q0 = (nqt - 1 - (int)blockIdx.x) * KT;  // the longest key walk first
  const int qlast = min(q0 + KT, S) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long off = (long long)b * S * ld_in + (long long)h * kD;
  const float* kb = k + off;
  const float* vb = v + off;
  const uint8_t* valid_b = valid + (long long)b * S;
  int kt0, nkt;
  mtt::key_tiles(q0, qlast, mtt::first_valid(valid_b, qlast + 1, red), S, KT, &kt0, &nkt);
  auto prefetch = [&](int it) {
    const int slot = it & (stages - 1);
    const int k0 = (kt0 + it) * KT;
    load_tile<kD, kLd, KT, NTHREADS>(ring + 2 * slot * TILE, kb, ld_in, k0, S);
    load_tile<kD, kLd, KT, NTHREADS>(ring + (2 * slot + 1) * TILE, vb, ld_in, k0, S);
    load_valid(Vm + slot * KT, valid_b, k0, S, KT);
    mtt::cp_async_commit();
  };
  load_tile<kD, kLd, KT, NTHREADS>(Qs, q + off, ld_in, q0, S);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < nkt; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < nkt) prefetch(it + 1);
    const int slot = it & (stages - 1);
    const float* Ks = ring + 2 * slot * TILE;
    const float* Vs = Ks + TILE;
    const uint8_t* vm = Vm + slot * KT;
    const int k0 = (kt0 + it) * KT;
    float sc[NT][4];
    xyt<kD, kLd, NT>(sc, Qs, wr, Ks, lane);
    if (!mtt::tile_unmasked<KT>(vm, k0, q0 + wr, S, lane)) causal_mask<NT>(sc, rows, vm, k0, S, lane);
    // Online softmax: the running max over the quad that holds a row; the
    // output and this lane's part of the sum rescaled when it grows.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      const float nm = fmaxf(m[r], row_max4(mx));
      const float scale = mtt::fast_exp(m[r] - nm);
      l[r] *= scale;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][2 * r] *= scale;
        o[n][2 * r + 1] *= scale;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = mtt::fast_exp(sc[n][2 * r + e] - nm);
          sc[n][2 * r + e] = p;
          l[r] += p;
        }
      m[r] = nm;
    }
    py<kD, kLd, NT>(o, sc, Vs, lane);
  }
  const float inv[2] = {1.f / row_sum4(l[0]), 1.f / row_sum4(l[1])};
  store_tile<kD>(out + (long long)b * S * ld_out + (long long)h * kD, ld_out, o, q0 + wr, inv, S,
                 lane);
}

template <int KT>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const uint8_t* valid,
                       float* out, int B, int S, int H, long long ld_in, long long ld_out,
                       cudaStream_t stream) {
  const int stages = S > KT ? 2 : 1;
  const size_t smem = sizeof(float) * (size_t)(1 + 2 * stages) * KT * kLd + 2 * KT +
                      sizeof(int) * (size_t)(2 * KT / 32);
  auto kernel = attention_fwd_tf32_kernel<KT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + KT - 1) / KT, H, B);
  kernel<<<grid, 2 * KT, smem, stream>>>(q, k, v, valid, out, S, ld_in, ld_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtt_attention_route_override();

// Whether attention_fwd gives an fp32 call at head_dim D this route, where
// route 5 (3xTF32 wgmma, attention_fwd_tf32_hopper.cu, checked first) does
// not take it: head_dim 80 below route 5's border, unless the route override
// (attention_set_route) 3 keeps fp32 on the CUDA cores. Against the CUDA
// cores this route was the faster by 3.0-4.0x forward and 2.1-3.5x backward
// at every measured length, S = 16-2,100 (PERF.md); below 16 tokens it
// runs the same 16-row tile as at 16.
extern "C" int tf32_fwd_takes(int D) { return D == kD && mtt_attention_route_override() != 3; }

// The layout this route reads and writes: q, k and v rows and bases 16-byte
// aligned (16-byte cp.async), out's 8-byte aligned (8-byte stores).
extern "C" int tf32_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                               long long ld_in, long long ld_out) {
  return rows16(q, ld_in) && rows16(k, ld_in) && rows16(v, ld_in) && rows8(out, ld_out);
}

// cfg as attention_fwd_config's: {route 4, threads, query rows per block,
// keys per tile, heads per block, padded head_dim, output columns per block}.
extern "C" void tf32_fwd_config(int S, int* cfg) {
  const int kt = tile_rows(S);
  const int c[7] = {4, 2 * kt, kt, kt, 1, kD, kD};
  for (int i = 0; i < 7; ++i) cfg[i] = c[i];
}

// q, k, v: (B, S, H, 80) fp32 views with row stride ld_in; out: row stride
// ld_out; valid: (B, S) bytes. The layout rule is tf32_fwd_layout's (the
// caller's check). Launches on `stream`.
extern "C" int tf32_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                  void* out, int B, int S, int H, long long ld_in,
                                  long long ld_out, void* stream) {
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* vm = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define MTT_LAUNCH(KT) return (int)launch_fwd<KT>(qq, kk, vv, vm, o, B, S, H, ld_in, ld_out, st)
  switch (tile_rows(S)) {
    case 16: MTT_LAUNCH(16);
    case 32: MTT_LAUNCH(32);
    case 48: MTT_LAUNCH(48);
    case 64: MTT_LAUNCH(64);
    default: MTT_LAUNCH(80);
  }
#undef MTT_LAUNCH
}
