// Causal + key-padding attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel
//       (fused_qkv_causal_attention, 8 <= S < 256 patch tokens; B1f)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_fwd_kernel
//       (fused_causal_attention, 256 <= S <= 1024 patch tokens; B2f)
// and the forward of the library flash kernel that
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention
// wraps for S > 2048 (B3f, the port's flash_causal_attention). All compute,
// per (batch, head), softmax(mask(Q K^T)) V with q pre-scaled:
//   mask = (col <= row) & valid[col]; a masked logit is finfo(float32).min
//   (never -inf, so a query row with no valid key gets uniform weights over
//   all S keys, as in the JAX plain path); logits and softmax in fp32; the
//   weights are rounded to the compute dtype before the PV product (JAX's
//   w.astype(v.dtype)); PV accumulates in fp32; the output is written once
//   in the compute dtype.
// The entry points differ only in where q, k and v sit in memory. Element
// (b, s, h, d) of q is q[(b * S + s) * ld_in + h * D + d], and likewise for k
// and v from their own base pointers; the output row stride is ld_out. For
// the fused-qkv layout (B, S, 3*H*D) the bases are offset by 0, H*D and 2*H*D
// columns and ld_in = 3*H*D; for (B, S, H, D) tensors ld_in = H*D. Offsets
// are 64-bit; any S the card's memory holds is addressed, head_dim 1..256.
//
// Routes. bf16 at head_dim 80 up to S = kShortFwdTo (64, the border
// chip_smoke.py's [gate] B1f persistent lines measure), with q, k, v and out
// rows and bases 16-byte aligned, takes the one-pass persistent route of
// attention_fwd_short_hopper.cu: the whole key row in one tile, so the row
// max and sum are exact before any exponential and the normalised weights
// are rounded as here. From S = kFwdFrom (65), with q, k, v readable by TMA,
// bf16 takes the wgmma/TMA route of attention_fwd_hopper.cu: one pass with
// an online softmax, which
// rounds the unnormalised weights exp(l - m_running) to bf16 where JAX
// rounds the normalised ones (2^-9 relative per weight either way; its
// header and tests/test_torch_port_attention_hopper.py); fp32 at head_dim 80
// takes a 3xTF32 route (below). The two routes
// here, for every other shape (bf16 mma.sync) and for fp32, take two passes
// over the key tiles: pass 1 keeps a running row max m and sum s of
// exp(l - m), pass 2 recomputes the logits, forms W = exp(l - m) / s,
// rounds it to the compute dtype as JAX does and accumulates W V. They and
// the wgmma route visit only the key tiles the skip rule of
// attention_common.cuh keeps (tiles above the causal diagonal and fully
// padded left tiles are not loaded; a query tile holding a row with no valid
// key walks them all); the two here load the next key (and value) tile with
// cp.async into a two-stage ring while the current one computes.
//
// bf16 route, on the tensor cores. 128 threads, 4 warps; each warp owns 16
// query rows. mma.sync m16n8k16 (bf16 in, fp32 accumulate) with fragments
// from ldmatrix: S = Q K^T per 64-key tile; in pass 2 W is rounded to bf16
// in the accumulator registers and fed straight back as the A operand of
// W V (ldmatrix.trans for V), never through shared memory. Tiles stay bf16
// in shared memory, D padded with zeros to DP, a multiple of 16 (80 = 5 x 16;
// 20 -> 32, 40 -> 64, 256), rows DP + 8 elements apart so the eight row
// addresses of an ldmatrix fall in distinct banks. Small S (B1: 16 or 32
// tokens) fits the tile to S: 16 * QW rows of queries and keys per head with
// 4 / QW heads in one block (QW = 1, 2 or 4), so a 16-token row does not pay
// for a 64-row tile. For DP > 80 a block writes NKO * 16 of the output
// columns, to keep the accumulators in registers (D = 256: four blocks per
// query tile, each recomputing pass 1). The exponentials run on the SFU
// (mtt::fast_exp: ex2.approx, about 2^-22 relative, against the plain
// version's exp; W is then rounded to bf16, 2^-9), and a key tile that no
// mask touches for a warp's rows (every key valid, below the diagonal)
// skips the mask (mtt::tile_unmasked).
//
// fp32 route, on the CUDA cores, so that it keeps the fp32 tolerance (plain
// TF32 rounds to 2^-11): 256 threads, TB = 16 TM query rows per block (64;
// 32 for head_dim > 96 or S <= 32; 16 for S <= 16), each thread a TM x TM
// micro-tile of the logit tile, shared rows padded to D + 1 floats, 4-byte
// cp.async into the ring. At head_dim 80, TimesFM's, fp32 takes a 3xTF32
// tensor-core route instead wherever q, k and v are read 16 bytes at a time
// (rows and bases 16-byte aligned, out's 8-byte): route 5
// (attention_fwd_tf32_hopper.cu, wgmma fed by TMA) from the border its [gate]
// lines set, route 4 (attention_fwd_tf32.cu, mma.sync) below it. What stays
// here is every other head_dim (those routes are built for 80 only), the
// layouts they cannot read, and the route override "cuda cores".
//
// What bounds it on an H100: at the main-path shapes the work is small
// against the bytes (chip_smoke.py prints both bounds), but each block
// re-reads its key tiles from L2, and the bf16 route here runs mma.sync,
// which reaches about half of the card's bf16 rate (the wgmma route fits a
// 160-byte row by splitting it into 64- and 16-column blocks). The
// exponentials (two per logit) run on the SFU. The fp32 route here is bound
// by the CUDA cores' 67 TFLOP/s, 2.5x below the 3xTF32 route's 165.

#include "attention_common.cuh"

#include <math.h>

#include <algorithm>

namespace {

using mtt::bf16;
using mtt::mma_abt;
using mtt::mma_nk;
using mtt::mma_nko;

constexpr int kMaxDim = 256;

// ---------------------------------------------------------------- fp32 route

constexpr int kThreadsF32 = 256;

// Masked logits of this thread's micro-tile (rows q0 + ty + 16 i, keys
// k0 + tx + 16 j) from two (TB, dp) tiles. Keys past the sequence end get
// -inf (no term at all); causal-future and padded keys get finfo(float32).min
// (a term that vanishes unless the whole row is masked).
template <int TM>
__device__ __forceinline__ void tile_logits(const float* Qs, const float* Ks, const int* Vm, int D,
                                            int dp, int q0, int k0, int S, int tx, int ty,
                                            float l[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) l[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[TM], kv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) qv[i] = Qs[(ty + 16 * i) * dp + d];
#pragma unroll
    for (int j = 0; j < TM; ++j) kv[j] = Ks[(tx + 16 * j) * dp + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) l[i][j] = fmaf(qv[i], kv[j], l[i][j]);
  }
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

template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ valid,
                             float* __restrict__ out, int S, int D, long long ld_in,
                             long long ld_out) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  const int ts = TB * max(dp, TB + 1);  // a K or V slot; in pass 2 K's slot then holds W
  float* Qs = smem;                 // TB x dp
  float* Ks = Qs + TB * dp;         // 2 slots: K tiles, then the W tile, TB x (TB + 1)
  float* Vs = Ks + 2 * ts;          // 2 slots: V tiles
  int* Vm = reinterpret_cast<int*>(Vs + 2 * ts);  // 2 x TB key-valid flags
  int* red = Vm + 2 * TB;                                // one int per warp

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
  const int items = 2 * nkt;  // pass 1: K tiles; pass 2: K and V tiles
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * TB;
    mtt::load_tile_f32<TB, kThreadsF32>(Ks + buf * ts, kb, k0, S, D, dp, ld_in);
    if (it >= nkt) mtt::load_tile_f32<TB, kThreadsF32>(Vs + buf * ts, vb, k0, S, D, dp, ld_in);
    if (tid < TB) Vm[buf * TB + tid] = k0 + tid < S ? (int)valid_b[k0 + tid] : 0;
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Qs, q + in_off, q0, S, D, dp, ld_in);
  prefetch(0);

  float m[TM], s[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
  }
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
    float* Kt = Ks + buf * ts;
    float l[TM][TM];
    tile_logits<TM>(Qs, Kt, Vm + buf * TB, D, dp, q0, k0, S, tx, ty, l);
    if (it < nkt) {
      // Pass 1: running row max and sum of exp, in fp32.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float tmax = l[i][0];
#pragma unroll
        for (int j = 1; j < TM; ++j) tmax = fmaxf(tmax, l[i][j]);
        const float nm = fmaxf(m[i], row_max16(tmax));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < TM; ++j) ps += expf(l[i][j] - nm);
        s[i] = s[i] * expf(m[i] - nm) + row_sum16(ps);
        m[i] = nm;
      }
      continue;
    }
    // Pass 2: normalized weights (fp32: rounding is the identity), written over
    // the K tile once every thread has its logits, times V.
    __syncthreads();
    float* Ws = Kt;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        Ws[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = expf(l[i][j] - m[i]) / s[i];
    __syncthreads();
    const float* Vt = Vs + buf * ts;
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vt[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float w = Ws[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
      }
    }
  }

  float* ob = out + (long long)b * S * ld_out + (long long)h * D;
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

template <int TM, int NDS>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* valid, void* out,
                       int B, int S, int H, int D, long long ld_in, long long ld_out,
                       cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  const size_t smem = sizeof(float) * ((size_t)TB * dp + (size_t)4 * TB * std::max(dp, TB + 1)) +
                      sizeof(int) * (2 * TB + kThreadsF32 / 32);
  auto kernel = attention_fwd_f32_kernel<TM, NDS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TB - 1) / TB, H, B);
  kernel<<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), S, D, ld_in, ld_out);
  return cudaGetLastError();
}

// fp32 tiles: TB = 16 TM rows, fitted to small S (TM = 1 for S <= 16, 2 for
// S <= 32), else 64 up to head_dim 96 and 32 above (so five (TB, D + 1) fp32
// tiles fit in shared memory at D = 256); output columns per lane
// ceil(D / 32), rounded up to an instantiated count.
int f32_tm(int S, int D) {
  if (S <= 16) return 1;
  if (S <= 32 || D > 96) return 2;
  return 4;
}

template <int TM>
cudaError_t launch_f32_nds(const void* q, const void* k, const void* v, const void* valid,
                           void* out, int B, int S, int H, int D, long long ld_in,
                           long long ld_out, cudaStream_t stream) {
  const int nds = (D + 31) / 32;
  if (nds == 1) return launch_f32<TM, 1>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (nds == 2) return launch_f32<TM, 2>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (nds == 3) return launch_f32<TM, 3>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if constexpr (TM < 4) {
    if (nds == 4) return launch_f32<TM, 4>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
    return launch_f32<TM, 8>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  }
  return cudaErrorInvalidValue;  // TM = 4 only up to head_dim 96
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* valid,
                         void* out, int B, int S, int H, int D, long long ld_in, long long ld_out,
                         cudaStream_t stream) {
  const int tm = f32_tm(S, D);
  if (tm == 1) return launch_f32_nds<1>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  if (tm == 2) return launch_f32_nds<2>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
  return launch_f32_nds<4>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, stream);
}

// ---------------------------------------------------------------- bf16 route

constexpr int kThreadsMma = 128;

template <int NK, int NKO, int QW>
__global__ void __launch_bounds__(kThreadsMma)
    attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const uint8_t* __restrict__ valid,
                             bf16* __restrict__ out, int S, int H, int D, long long ld_in,
                             long long ld_out, int vec_in, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int HPB = 4 / QW;     // heads per block
  constexpr int BQ = 16 * QW;     // query rows per head
  constexpr int BK = 16 * QW;     // keys per tile
  constexpr int NT = BK / 8;      // n-tiles of the logit tile
  constexpr int NO = 2 * NKO;     // n-tiles of this block's output columns
  constexpr int SPLIT = NK / NKO; // blocks per query tile
  constexpr int KV = HPB * BK * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // HPB x BQ x LDS
  bf16* Ks = Qs + HPB * BQ * LDS;                // 2 x HPB x BK x LDS
  bf16* Vs = Ks + 2 * KV;                        // 2 x HPB x BK x LDS
  uint8_t* Vm = reinterpret_cast<uint8_t*>(Vs + 2 * KV);  // 2 x BK
  int* red = reinterpret_cast<int*>(Vm + 2 * BK);         // one int per warp

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x / SPLIT) * BQ;  // the longest key walks first
  const int col0 = ((int)blockIdx.x % SPLIT) * NKO * 16;   // this block's output columns
  const int qlast = min(q0 + BQ, S) - 1;
  const int h0 = blockIdx.y * HPB;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hs = warp / QW;          // this warp's head slot
  const int wr = (warp % QW) * 16;   // its first row in the query tile
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
    if (it >= nkt)
      mtt::load_tile_bf16<HPB, BK, DP, LDS, kThreadsMma>(Vs + buf * KV, BK * LDS, v + in_off,
                                                         ld_in, D, h0, H, k0, S, vec_in);
    if ((int)threadIdx.x < BK)
      Vm[buf * BK + threadIdx.x] = k0 + (int)threadIdx.x < S ? valid_b[k0 + threadIdx.x] : 0;
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<HPB, BQ, DP, LDS, kThreadsMma>(Qs, BQ * LDS, q + in_off, ld_in, D, h0, H,
                                                     q0, S, vec_in);
  prefetch(0);

  const int g = lane >> 2;
  const int t = lane & 3;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const bf16* Qw = Qs + hs * BQ * LDS + wr * LDS;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = (kt0 + (it < nkt ? it : it - nkt)) * BK;
    const uint8_t* vm = Vm + buf * BK;
    float sc[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qw, Ks + buf * KV + hs * BK * LDS, lane);
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
      // Pass 1: running row max and sum of exp over the quad that holds a row.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float nm = fmaxf(m[r], mx);
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ps += mtt::fast_exp(sc[n][2 * r] - nm) + mtt::fast_exp(sc[n][2 * r + 1] - nm);
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        s[r] = s[r] * mtt::fast_exp(m[r] - nm) + ps;
        m[r] = nm;
      }
      if (it + 1 == nkt) {
        inv[0] = 1.f / s[0];
        inv[1] = 1.f / s[1];
      }
      continue;
    }
    // Pass 2: W rounded to bf16 in registers is the A operand of W V.
    const bf16* Vw = Vs + buf * KV + hs * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // n-tiles 2 kk (keys 0..7) and 2 kk + 1 (8..15)
        const float* p = sc[2 * kk + h];
        a[2 * h] = mtt::pack_bf16(mtt::fast_exp(p[0] - m[0]) * inv[0],
                                  mtt::fast_exp(p[1] - m[0]) * inv[0]);
        a[2 * h + 1] = mtt::pack_bf16(mtt::fast_exp(p[2] - m[1]) * inv[1],
                                      mtt::fast_exp(p[3] - m[1]) * inv[1]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        mtt::ldsm_x4_t(bb, Vw + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + col0 +
                               n * 8 + (lane >> 4) * 8);
        mtt::mma_bf16(o[n], a, bb);
        mtt::mma_bf16(o[n + 1], a, bb + 2);
      }
    }
  }

  if (h0 + hs >= H) return;
  bf16* ob = out + (long long)b * S * ld_out + (long long)(h0 + hs) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = col0 + n * 8 + 2 * t;
      if (rows[r] >= S || d >= D) continue;
      bf16* p = ob + (long long)rows[r] * ld_out + d;
      if (pair_out) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        p[0] = __float2bfloat16_rn(o[n][2 * r]);
        if (d + 1 < D) p[1] = __float2bfloat16_rn(o[n][2 * r + 1]);
      }
    }
}

template <int NK, int NKO, int QW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* valid, void* out,
                       int B, int S, int H, int D, long long ld_in, long long ld_out, int vec_in,
                       int pair_out, cudaStream_t stream) {
  constexpr int LDS = 16 * NK + 8;
  constexpr int HPB = 4 / QW;
  constexpr int BQ = 16 * QW;
  const size_t smem = sizeof(bf16) * (size_t)5 * HPB * BQ * LDS + 2 * BQ +
                      sizeof(int) * (kThreadsMma / 32);
  auto kernel = attention_fwd_mma_kernel<NK, NKO, QW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ * (NK / NKO), (H + HPB - 1) / HPB, B);
  kernel<<<grid, kThreadsMma, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), S, H, D, ld_in, ld_out, vec_in,
      pair_out);
  return cudaGetLastError();
}

// bf16 query rows per head: 16 QW.
int mma_qw(int S, int nk) {
  if (nk > 5 || S > 32) return 4;
  return S <= 16 ? 1 : 2;
}

template <int NK>
cudaError_t launch_mma_qw(int qw, const void* q, const void* k, const void* v, const void* valid,
                          void* out, int B, int S, int H, int D, long long ld_in, long long ld_out,
                          int vec_in, int pair_out, cudaStream_t stream) {
  constexpr int NKO = NK <= 5 ? NK : 4;
  if constexpr (NK <= 5) {
    if (qw == 1)
      return launch_mma<NK, NKO, 1>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, vec_in,
                                    pair_out, stream);
    if (qw == 2)
      return launch_mma<NK, NKO, 2>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, vec_in,
                                    pair_out, stream);
  }
  return launch_mma<NK, NKO, 4>(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, vec_in, pair_out,
                                stream);
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, const void* valid, void* out,
                         int B, int S, int H, int D, long long ld_in, long long ld_out,
                         cudaStream_t stream) {
  // 16-byte cp.async needs every row of q, k and v to start 16-byte aligned.
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_in = D % 8 == 0 && ld_in % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const int pair_out = D % 2 == 0 && ld_out % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int nk = mma_nk(D);
  const int qw = mma_qw(S, nk);
#define MTT_LAUNCH(NK) \
  return launch_mma_qw<NK>(qw, q, k, v, valid, out, B, S, H, D, ld_in, ld_out, vec_in, pair_out, stream)
  if (nk == 1) MTT_LAUNCH(1);
  if (nk == 2) MTT_LAUNCH(2);
  if (nk == 4) MTT_LAUNCH(4);
  if (nk == 5) MTT_LAUNCH(5);
  if (nk == 8) MTT_LAUNCH(8);
  MTT_LAUNCH(16);
#undef MTT_LAUNCH
}

}  // namespace

// The fp32 3xTF32 route (attention_fwd_tf32.cu).
extern "C" int tf32_fwd_takes(int D);
extern "C" int tf32_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                               long long ld_in, long long ld_out);
extern "C" void tf32_fwd_config(int S, int* cfg);
extern "C" int tf32_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                  void* out, int B, int S, int H, long long ld_in,
                                  long long ld_out, void* stream);

// The fp32 3xTF32 wgmma/TMA route (attention_fwd_tf32_hopper.cu).
extern "C" int tf32w_fwd_takes(int S, int D);
extern "C" int tf32w_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                                long long ld_in, long long ld_out);
extern "C" void tf32w_fwd_config(int* cfg);
extern "C" int tf32w_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int B, int S, int H, long long ld_in, long long ld_out,
                                   void* stream);

// The bf16 one-pass persistent route for short S (attention_fwd_short_hopper.cu).
extern "C" int short_fwd_takes(int S, int D);
extern "C" int short_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                                long long ld_in, long long ld_out);
extern "C" void short_fwd_config(int S, int* cfg);
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int B, int S, int H, long long ld_in,
                                   long long ld_out, void* stream);

// The bf16 wgmma/TMA route (attention_fwd_hopper.cu).
extern "C" int hopper_fwd_takes(int S, int D);
extern "C" int hopper_fwd_layout(const void* q, const void* k, const void* v, long long ld_in);
extern "C" void hopper_fwd_config(int* cfg);
extern "C" int hopper_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                    void* out, int B, int S, int H, long long ld_in,
                                    long long ld_out, void* stream);

namespace {
int route_override = 0;
}  // namespace

// For measuring the borders between the routes (chip_smoke.py's [gate]
// lines): 0 = the dispatch rule, 1 = bf16 on mma.sync only, 2 = bf16 on wgmma
// at every S its layout rule allows, 3 = fp32 on the CUDA cores only, 4 =
// fp32 never on the 3xTF32 wgmma route (3xTF32 mma.sync by its rule), 5 =
// fp32 on the 3xTF32 wgmma route at every S its layout rule allows (3-5: bf16
// by the rule). Applies to attention_fwd and attention_bwd alike.
extern "C" int attention_set_route(int route) {
  if (route < 0 || route > 5) return (int)cudaErrorInvalidValue;
  route_override = route;
  return 0;
}
extern "C" int mtt_attention_route_override() { return route_override; }

// dtype: 0 = float32, 1 = bfloat16. valid: (B, S) bytes, nonzero = valid key.
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronize. bf16 takes the one-pass persistent route where
// short_fwd_takes(S, D) and its layout rule (q, k, v and out rows and bases
// 16-byte aligned) hold, then the wgmma/TMA route where
// hopper_fwd_takes(S, D) and its layout rule (q, k, v rows and bases 16-byte
// aligned) hold, and the mma.sync route otherwise; fp32 the 3xTF32 wgmma/TMA
// route where tf32w_fwd_takes(S, D) and its layout rule (q, k, v rows and
// bases 16-byte aligned, out's 8-byte) hold, then the 3xTF32 mma.sync route
// where tf32_fwd_takes(D) and the same layout rule hold, and the CUDA-core
// route otherwise. A batch of more than kGridRows rows runs as chunks of rows
// (mtt::grid_chunk_rows), each a call of its own on `stream`, in order.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int dtype, int B, int S, int H, int D, long long ld_in,
                             long long ld_out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > mtt::kGridRows) {
    const int rows = mtt::grid_chunk_rows(B);
    const long long elt = dtype == 0 ? 4 : 2;
    for (int b0 = 0; b0 < B; b0 += rows) {
      const long long in = (long long)b0 * S * ld_in * elt, to = (long long)b0 * S * ld_out * elt;
      const int err = attention_fwd(mtt::byte_at(q, in), mtt::byte_at(k, in), mtt::byte_at(v, in),
                                    mtt::byte_at(valid, (long long)b0 * S), mtt::byte_at(out, to),
                                    dtype, std::min(rows, B - b0), S, H, D, ld_in, ld_out, stream);
      if (err != 0) return err;
    }
    return 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tf32w_fwd_takes(S, D) && tf32w_fwd_layout(q, k, v, out, ld_in, ld_out))
      return tf32w_attention_fwd(q, k, v, valid, out, B, S, H, ld_in, ld_out, stream);
    if (tf32_fwd_takes(D) && tf32_fwd_layout(q, k, v, out, ld_in, ld_out))
      return tf32_attention_fwd(q, k, v, valid, out, B, S, H, ld_in, ld_out, stream);
    return (int)dispatch_f32(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (short_fwd_takes(S, D) && short_fwd_layout(q, k, v, out, ld_in, ld_out))
    return short_attention_fwd(q, k, v, valid, out, B, S, H, ld_in, ld_out, stream);
  if (hopper_fwd_takes(S, D) && hopper_fwd_layout(q, k, v, ld_in))
    return hopper_attention_fwd(q, k, v, valid, out, B, S, H, ld_in, ld_out, stream);
  return (int)dispatch_mma(q, k, v, valid, out, B, S, H, D, ld_in, ld_out, st);
}

// The route and tiles attention_fwd takes for (dtype, S, D) with a layout
// every route reads, for reports: cfg = {route (0: fp32 CUDA cores, 1: bf16
// mma.sync m16n8k16, 2: bf16 wgmma + TMA, 3: bf16 mma.sync one-pass fed by
// TMA, persistent, 4: fp32 3xTF32 mma.sync m16n8k8, 5: fp32 3xTF32 wgmma
// m64nNk8 fed by TMA),
// threads, query rows per head and
// block, keys per tile, heads per block, padded head_dim, output columns per
// block}. Returns 0, or cudaErrorInvalidValue.
extern "C" int attention_fwd_config(int dtype, int S, int D, int* cfg) {
  if (S <= 0 || D <= 0 || D > kMaxDim) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && tf32w_fwd_takes(S, D)) {
    tf32w_fwd_config(cfg);
    return 0;
  }
  if (dtype == 0 && tf32_fwd_takes(D)) {
    tf32_fwd_config(S, cfg);
    return 0;
  }
  if (dtype == 0) {
    const int tb = 16 * f32_tm(S, D);
    const int c[7] = {0, kThreadsF32, tb, tb, 1, D, D};
    for (int i = 0; i < 7; ++i) cfg[i] = c[i];
    return 0;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (short_fwd_takes(S, D)) {
    short_fwd_config(S, cfg);
    return 0;
  }
  if (hopper_fwd_takes(S, D)) {
    hopper_fwd_config(cfg);
    return 0;
  }
  const int nk = mma_nk(D);
  const int qw = mma_qw(S, nk);
  const int c[7] = {1, kThreadsMma, 16 * qw, 16 * qw, 4 / qw, 16 * nk, 16 * mma_nko(nk)};
  for (int i = 0; i < 7; ++i) cfg[i] = c[i];
  return 0;
}
