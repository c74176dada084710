// Chronos-2 T5 attention forward (B4f), fp32, head_dim 64: the 3xTF32
// tensor-core route for Hopper (sm_90a), taken by chronos_attention_fwd
// (chronos_attention.cu) when make_plan gives route 5 (chronos_tf32_takes
// below); the backward's half is chronos_attention_bwd_tf32.cu, the shared
// pieces chronos_tf32.cuh and tf32_common.cuh.
//
// Replaces, where the rule sends them here, the Pallas TPU kernels
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel (B4f)
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// in fp32, Chronos-2's default compute dtype. The function is
// chronos_attention.cu's (its header); in fp32 JAX's w.astype(vs.dtype) is
// the identity.
//
// Arithmetic (3xTF32). Every product (Q K^T and W V here; G V^T, dQ = dL K,
// dV = W^T G and dK = dL^T Q in the backward) runs on mma.sync m16n8k8 with
// TF32 operands and fp32 accumulators. Each fp32 operand x is split in the
// kernel's body into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding, done in two
// integer instructions: tf32_common.cuh) and x - hi exact, and each product
// is taken as lo hi + hi lo + hi hi, the small terms first, into one
// accumulator: about 2^-21 of each term's magnitude, against 2^-11 for one
// TF32 product, which misses the fp32 tolerances
// (tests/test_torch_port_chronos_tf32.py holds both against JAX). The
// softmax, the bias, the segment mask at finfo(float32).min and r =
// rowsum(dW o W) stay fp32 on the CUDA cores; the exponentials are the SFU's
// ex2 of x log2(e) (fast_exp, about 2^-22 relative plus |x| 2^-24), as the
// bf16 routes take them.
//
// Forward design. One block per (query tile, head, batch row); each warp owns
// 16 query rows. Up to kOneTileTo = 80 tokens one tile of S padded to 16
// holds every query and every key (S = 67: 5 warps, 80 rows, one walk); past
// that 64-row query and key tiles, K and V through a two-slot ring of 16-byte
// cp.async copies. The key walk is one pass with an online softmax (running
// max m and sum l, the output rescaled when m grows, divided by l at the
// end): in fp32 no rounding of W sits between the softmax and W V, so the
// two-pass order of the bf16 tiled route buys nothing here. Q K^T reads both
// operands by ldmatrix (each fp32 as two b16 values; Q from shared memory at
// every tile: holding Q's split fragments in registers took 64 of them and
// left one block an SM at 80 tokens). W V takes W's A fragment straight from
// the logits' accumulators: m16n8k8's A wants (row g, columns t and t + 4)
// where the accumulator holds (g, 2t and 2t + 1), so the k-step takes its
// keys in that order and reads V's rows in the same order (acc_to_a,
// load_bp) - no shuffle and no trip through shared memory. Rows padded to
// 68 floats put every fragment load on 32 distinct banks (8 t + g for V's
// rows 2t and 2t + 1; ldmatrix's 16-byte rows 272 bytes apart). Each lane
// reads its bias entries from L2 in the accumulator's layout (bias_mask), as
// the bf16 routes do (chronos_attention.cu's header on why).
//
// What bounds it on an H100: the 3xTF32 products run at a third of the TF32
// tensor rate, 495 / 3 = 165 TFLOP/s (2.5x the CUDA cores' 67); at 16 x 577 x
// 12 the two products take 0.099 ms at that rate, the bytes 0.03 ms.
// mma.sync reaches only part of the tensor rate on Hopper (wgmma gives the
// rest, but takes TF32 only K-major from shared memory: W V would need V^T
// staged), and each mma.sync of three costs its operands' split (four ALU
// instructions a value) and shared loads; two blocks an SM (registers and
// the ring) leave the products' latency partly exposed.

#include "chronos_tf32.cuh"

namespace {

using namespace mtt::tf32;

template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    chronos_fwd_tf32_kernel(const float* __restrict__ qkv, const int* __restrict__ seg,
                            const float* __restrict__ bias, float* __restrict__ out, int S, int H) {
  constexpr int NT = KT / 8;  // n-tiles of a warp's logit row
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  extern __shared__ __align__(16) float smem[];
  const int nkt = (S + KT - 1) / KT;
  const int stages = nkt > 1 ? 2 : 1;
  float* Qs = smem;                                          // TILE
  float* ring = Qs + TILE;                                   // stages x (K, V) tiles
  int* Sq = reinterpret_cast<int*>(ring + 2 * stages * TILE);  // KT query segments
  int* Sk = Sq + KT;                                         // stages x KT key segments

  const int q0 = blockIdx.x * KT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * kD;
  const long long ld = 3 * hd;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * kD;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  auto prefetch = [&](int it) {
    const int slot = it & (stages - 1);
    load_tile<kD, kLd, KT, NTHREADS>(ring + 2 * slot * TILE, qb + hd, ld, it * KT, S);
    load_tile<kD, kLd, KT, NTHREADS>(ring + (2 * slot + 1) * TILE, qb + 2 * hd, ld, it * KT, S);
    load_seg(Sk + slot * KT, seg_b, it * KT, S, KT);
    mtt::cp_async_commit();
  };
  load_tile<kD, kLd, KT, NTHREADS>(Qs, qb, ld, q0, S);
  load_seg(Sq, seg_b, q0, S, KT);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int sq[2];

  for (int it = 0; it < nkt; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < nkt) prefetch(it + 1);
    if (it == 0) {
      sq[0] = Sq[wr + (lane >> 2)];
      sq[1] = Sq[wr + (lane >> 2) + 8];
    }
    const int slot = it & (stages - 1);
    const float* Ks = ring + 2 * slot * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = it * KT;
    float sc[NT][4];
    xyt<kD, kLd, NT>(sc, Qs, wr, Ks, lane);
    const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S + k0,
                                  bias_h + (long long)min(rows[1], S - 1) * S + k0};
    bias_mask<NT, false>(sc, brow, sq, Sk + slot * KT, k0, S, lane);
    // Online softmax: the running max over the quad that holds a row; the
    // output and this lane's part of the sum rescaled when it grows.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      const float nm = fmaxf(m[r], quad_max(mx));
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
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  store_tile<kD>(out + (long long)b * S * hd + (long long)h * kD, hd, o, q0 + wr, inv, S, lane);
}

template <int KT>
cudaError_t launch_fwd(const float* qkv, const int* seg, const float* bias, float* out, int B,
                       int S, int H, cudaStream_t stream) {
  const int stages = S > KT ? 2 : 1;
  const size_t smem = sizeof(float) * (size_t)(1 + 2 * stages) * KT * kLd +
                      sizeof(int) * (size_t)(1 + stages) * KT;
  auto kernel = chronos_fwd_tf32_kernel<KT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + KT - 1) / KT, H, B);
  kernel<<<grid, 2 * KT, smem, stream>>>(qkv, seg, bias, out, S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtt_chronos_route_override();

// Whether make_plan (chronos_common.cuh) gives an fp32 call at head_dim D
// this route: head_dim 64 at every S that route 6 leaves, unless the route
// override (chronos_set_route) 4 forces the CUDA-core route. No border in S:
// chip_smoke.py's fp32 [gate] lines (this route against the CUDA-core route
// at B = 9,232 / S and 12 heads) found this route the faster by 1.7-4.6x at
// every measured length, S = 16-577, forward and backward with and without
// dbias; below 16 tokens it runs the same 16-row tile as at 16. The layout
// rule (qkv and g 16-byte aligned, which ops/_kernels.py ensures) is the
// caller's: an unaligned call is refused.
extern "C" int chronos_tf32_takes(int D) { return D == kD && mtt_chronos_route_override() != 4; }

// qkv (B, S, 3*H*64) and out (B, S, H*64) fp32, contiguous, qkv 16-byte
// aligned, out 8-byte aligned; seg (B, S) int32; bias (H, S, S) fp32.
// Launches on `stream`.
extern "C" int chronos_tf32_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                int B, int S, int H, void* stream) {
  if (!aligned16(qkv) || (reinterpret_cast<uintptr_t>(out) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* q = static_cast<const float*>(qkv);
  const auto* sg = static_cast<const int*>(seg);
  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tile_rows(S)) {
    case 16: return (int)launch_fwd<16>(q, sg, bs, o, B, S, H, st);
    case 32: return (int)launch_fwd<32>(q, sg, bs, o, B, S, H, st);
    case 48: return (int)launch_fwd<48>(q, sg, bs, o, B, S, H, st);
    case 64: return (int)launch_fwd<64>(q, sg, bs, o, B, S, H, st);
    default: return (int)launch_fwd<80>(q, sg, bs, o, B, S, H, st);
  }
}
