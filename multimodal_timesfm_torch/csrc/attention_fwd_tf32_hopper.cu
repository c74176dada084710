// Causal + key-padding attention forward (B1f, B2f, B3f), fp32, head_dim 80:
// route 5, 3xTF32 on Hopper's warpgroup products (wgmma) fed by TMA, taken by
// attention_fwd (attention_fwd.cu) where tf32w_fwd_takes and tf32w_fwd_layout
// below hold, ahead of route 4 (3xTF32 mma.sync, attention_fwd_tf32.cu). The
// backward's half is attention_bwd_tf32_hopper.cu, the shared pieces
// attention_tf32_hopper.cuh (its header: the split, the tiles, the
// transposed operands) and hopper_common.cuh.
//
// Replaces, where the rule sends them here, in fp32 (TimesFM's default
// compute dtype):
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel (B1f)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_fwd_kernel (B2f)
// and the forward of the library flash kernel behind
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention (B3f).
// The function and the mask are attention_fwd.cu's: mask = (col <= row) &
// valid[col], a masked logit finfo(float32).min (a row with no valid key
// gets uniform weights over all S keys), a key past S no term; the softmax in
// fp32, the exponentials the SFU's.
//
// Design. One block per (128-row query tile, head, batch row), the longest
// key walk first: two consumer warpgroups of 64 query rows (16 a warp) and a
// producer warpgroup. The producer's first warp keeps TMA loads in flight:
// the block's Q tiles once, then for each 32-key tile of the walk
// (mtt::key_tiles, the skip rule for the block's 128 rows) K into a stage of
// a ring of kStages and V into a ring of kRawV raw slots. Its other three
// warps convert (attention_tf32_hopper.cuh): Q's lo twin once, then per key
// tile K's lo twin and V^T as hi and lo, into the tile's stage, and release
// V's raw slot. So the consumers only multiply: S = Q K^T (wgmma m64n32k8, A
// and B from shared memory: Q and K as TMA wrote them, with their lo twins),
// the mask, the online softmax (running max m and sum s, the output rescaled
// when m grows, divided by s at the end) and O += P V (wgmma m64n80k8, P's hi
// and lo from the registers, V^T from the stage). Each warpgroup computes
// only the key tiles its own 64 rows need. A masked key before a row's first
// valid key adds exp(0) = 1 while m is still finfo.min and is wiped once a
// valid key raises m, so rows with a valid key get exact zeros there and
// rows with none the uniform weights. 226 KB of shared memory, one block an
// SM: the two consumer warpgroups fill each other's gaps.
//
// What bounds it on an H100: the 3xTF32 products at a third of the TF32
// tensor rate, 495 / 3 = 165 TFLOP/s (chip_smoke.py's bound_ms), at the
// long rows (B2f 8 x 512, B3f 2 x 2,100), the bytes at the short ones. The
// kernel's own limits: Q K^T reading both operands from shared memory (A
// and B, 3 KB a k-step of 16 cycles at the full rate per warpgroup, more than
// the 128 bytes a cycle shared memory gives), the conversion pass beside it
// (about 30 KB written a key tile), and the serial chain of a warpgroup's
// tile (products, softmax, products).

#include "attention_tf32_hopper.cuh"

#include <math.h>

namespace {

using namespace mtt::hopper;
using namespace mtt::tf32w;

constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRes * kConsumers;   // query rows of a block
constexpr int kConverters = 3;                  // the producer's converting warps
// Registers a thread after setmaxnreg: 2 x 224 + 56 = 504 = 3 x 168, the
// launch bound's. With 168 each, or with the converting warps on convert_t4's
// 16-byte transposes, the compiler serialised the consumers' products (ptxas
// C7511: too few registers for the wgmma pipeline).
constexpr int kConsumerRegsF = 224;
constexpr int kProducerRegsF = 56;
constexpr int kStages = 3;
constexpr int kRawV = 2;
// Shared memory: the block's Q tiles (as TMA wrote them) and their lo twins;
// kRawV raw V tiles; kStages stages of K (as TMA wrote it), K's lo twin, V^T
// hi and lo; the mbarriers q_full, q_lo, k_full[kStages], v_full[kRawV],
// v_free[kRawV], c_full[kStages], empty[kStages].
constexpr int kQ = 0;
constexpr int kQlo = kQ + kConsumers * tile_bytes<kRes>();
constexpr int kRawOffset = kQlo + kConsumers * tile_bytes<kRes>();
constexpr int kStageOffset = kRawOffset + kRawV * tile_bytes<kStr>();
constexpr int kKlo = tile_bytes<kStr>();  // offsets in a stage
constexpr int kVThi = kKlo + tile_bytes<kStr>();
constexpr int kVTlo = kVThi + kTBytes;
constexpr int kStage = kVTlo + kTBytes;
constexpr int kBars = kStageOffset + kStages * kStage;
constexpr int kSmem = kAlign + kBars + 8 * (2 + 3 * kStages + 2 * kRawV);

__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_tf32w_kernel(const __grid_constant__ F32Maps qm, const __grid_constant__ F32Maps km,
                               const __grid_constant__ F32Maps vm, const uint8_t* __restrict__ valid,
                               float* __restrict__ out, int S, long long ld_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* q_full = bars;
  uint64_t* q_lo = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* c_full = k_full + kStages;
  uint64_t* empty = c_full + kStages;
  uint64_t* v_full = empty + kStages;
  uint64_t* v_free = v_full + kRawV;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_lo, kConverters);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(c_full + i, kConverters);
      mbar_init(empty + i, kConsumers * kWarpsPerGroup);
    }
    for (int i = 0; i < kRawV; ++i) {
      mbar_init(v_full + i, 1);
      mbar_init(v_free + i, kConverters);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBlockRows;  // the longest key walk first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qlast = min(q0 + kBlockRows, S) - 1;
  const uint8_t* vb = valid + (long long)b * S;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / 128;
  const int f = warp_first_valid(vb, qlast + 1);
  int kt0, nkt;
  mtt::key_tiles(q0, qlast, f, S, kStr, &kt0, &nkt);
  const int qtiles = min(kConsumers, (S - q0 + kRes - 1) / kRes);  // Q tiles that start before S

  if (wg == kConsumers) {
    regs_dec<kProducerRegsF>();
    const int pw = (threadIdx.x / 32) % 4;  // the producer's warp
    if (pw == 0) {                          // TMA
      if (lane == 0) {
        mbar_expect_tx(q_full, qtiles * tile_bytes<kRes>());
        for (int c = 0; c < qtiles; ++c)
          load_f32_tile<kRes>(smem + kQ + c * tile_bytes<kRes>(), qm, q_full, h, q0 + c * kRes, b);
        for (int j = 0; j < nkt; ++j) {
          const int st = j % kStages, r = j % kRawV;
          const int k0 = (kt0 + j) * kStr;
          mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full + st, tile_bytes<kStr>());
          load_f32_tile<kStr>(smem + kStageOffset + st * kStage, km, k_full + st, h, k0, b);
          mbar_wait(v_free + r, ((j / kRawV) & 1) ^ 1);
          mbar_expect_tx(v_full + r, tile_bytes<kStr>());
          load_f32_tile<kStr>(smem + kRawOffset + r * tile_bytes<kStr>(), vm, v_full + r, h, k0, b);
        }
      }
      return;
    }
    // Conversion: Q's lo twin, then each key tile's K lo and V^T.
    const int ct = threadIdx.x - kConsumers * 128 - 32;
    const int nt = 32 * kConverters;
    mbar_wait(q_full, 0);
    for (int c = 0; c < qtiles; ++c)
      convert_lo<tile_bytes<kRes>()>(smem + kQlo + c * tile_bytes<kRes>(), smem + kQ + c * tile_bytes<kRes>(),
                                     ct, nt);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_lo);
    for (int j = 0; j < nkt; ++j) {
      const int st = j % kStages, r = j % kRawV;
      uint8_t* stage = smem + kStageOffset + st * kStage;
      mbar_wait(k_full + st, (j / kStages) & 1);
      convert_lo<tile_bytes<kStr>()>(stage + kKlo, stage, ct, nt);
      mbar_wait(v_full + r, (j / kRawV) & 1);
      convert_t(stage + kVThi, stage + kVTlo, smem + kRawOffset + r * tile_bytes<kStr>(), ct, nt);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(v_free + r);
        mbar_arrive(c_full + st);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [wq0, wq0 + 64).
  regs_inc<kConsumerRegsF>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const int wq0 = q0 + wg * kRes;
  int wkt0 = 0, wnkt = 0;
  if (wq0 < S) mtt::key_tiles(wq0, min(wq0 + kRes, S) - 1, f, S, kStr, &wkt0, &wnkt);
  const int rows[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
  const uint32_t qa = base + kQ + wg * tile_bytes<kRes>();
  const uint32_t qa_lo = base + kQlo + wg * tile_bytes<kRes>();

  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[10][4];
#pragma unroll
  for (int j = 0; j < 10; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  mbar_wait(q_full, 0);
  mbar_wait(q_lo, 0);

  for (int j = 0; j < nkt; ++j) {
    const int st = j % kStages;
    const int kt = kt0 + j;
    mbar_wait(k_full + st, (j / kStages) & 1);
    mbar_wait(c_full + st, (j / kStages) & 1);
    if (kt >= wkt0 && kt < wkt0 + wnkt) {
      const uint32_t stage = base + kStageOffset + st * kStage;
      const int k0 = kt * kStr;
      float sc[4][4];
      wgmma_fence();
      issue_abt3(sc, qa, qa_lo, stage, stage + kKlo);
      wgmma_commit();
      // The key-valid reads and the warp's vote run while the product does.
      const bool unmasked = unmasked32(vb, k0, wq0 + 16 * warp, S, lane);
      const uint32_t bits = key_bits(vb, k0, S, t);
      wgmma_wait();
      fence_regs(sc);
      if (!unmasked) mask32(sc, bits, k0, rows, S, t);

      // Online softmax over the quad that holds each row; P in place of S.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) mx = fmaxf(mx, fmaxf(sc[c][2 * r], sc[c][2 * r + 1]));
        const float nm = fmaxf(m[r], quad_max(mx));
        const float scale = mtt::fast_exp(m[r] - nm);
        m[r] = nm;
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[c][2 * r] = mtt::fast_exp(sc[c][2 * r] - nm);
          sc[c][2 * r + 1] = mtt::fast_exp(sc[c][2 * r + 1] - nm);
          ps += sc[c][2 * r] + sc[c][2 * r + 1];
        }
        s[r] = s[r] * scale + ps;
        if (scale != 1.f) {
#pragma unroll
          for (int c = 0; c < 10; ++c) {
            o[c][2 * r] *= scale;
            o[c][2 * r + 1] *= scale;
          }
        }
      }
      uint32_t phi[4][4], plo[4][4];
      acc_frags(sc, phi, plo);
      wgmma_fence();
      issue_pb3(o, phi, plo, stage + kVThi, stage + kVTlo);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
    }
    if (lane == 0) mbar_arrive(empty + st);
  }

  if (wq0 < S) {
    const float inv[2] = {1.f / quad_sum(s[0]), 1.f / quad_sum(s[1])};
    store_f32(out + (long long)b * S * ld_out + (long long)h * kD, ld_out, o, rows[0], inv, S, t);
  }
}

}  // namespace

// Whether attention_fwd gives an fp32 call at (S, D) this route: head_dim 80
// from kFwdFrom tokens, the border chip_smoke.py's [gate] causal fp32 lines
// measure against route 4 (16 heads, B = 8,192 / S): route 5 the faster by
// 5% or more at every measured S from 128 to 2,100 (1.2-1.4x), route 4 at
// 16-64 (PERF.md). Below it route 4 keeps fp32. Route override
// (attention_set_route): 3 (CUDA cores) and 4 (tf32 mma.sync) never, 5 from
// any S.
constexpr int kFwdFrom = 128;
extern "C" int mtt_attention_route_override();

extern "C" int tf32w_fwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  if (D != kD || force == 3 || force == 4) return 0;
  return force == 5 || S >= kFwdFrom;
}

extern "C" int tf32w_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                                long long ld_in, long long ld_out) {
  return tma_rows(q, ld_in) && tma_rows(k, ld_in) && tma_rows(v, ld_in) && store_rows_ok(out, ld_out);
}

// cfg as attention_fwd_config's: {route 5, threads, query rows per block,
// keys per tile, heads per block, padded head_dim, output columns per block}.
extern "C" void tf32w_fwd_config(int* cfg) {
  const int c[7] = {5, kThreads, kBlockRows, kStr, 1, kD, kD};
  for (int i = 0; i < 7; ++i) cfg[i] = c[i];
}

// Dynamic shared memory a block of the kernel takes (bytes), for reports.
extern "C" int tf32w_fwd_smem() { return kSmem; }

// q, k, v: (B, S, H, 80) fp32 views with row stride ld_in; out: row stride
// ld_out; valid: (B, S) bytes. The layout rule is tf32w_fwd_layout's (the
// caller's check). Launches on `stream`.
extern "C" int tf32w_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int B, int S, int H, long long ld_in, long long ld_out,
                                   void* stream) {
  F32Maps qm, km, vm;
  cudaError_t err = encode_f32(&qm, q, B, S, H, ld_in, kRes);
  if (err == cudaSuccess) err = encode_f32(&km, k, B, S, H, ld_in, kStr);
  if (err == cudaSuccess) err = encode_f32(&vm, v, B, S, H, ld_in, kStr);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t regs =
      check_split(attention_fwd_tf32w_kernel, kConsumers, kConsumerRegsF, 1, kProducerRegsF);
  if (regs != cudaSuccess) return (int)regs;
  err = cudaFuncSetAttribute(attention_fwd_tf32w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_fwd_tf32w_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, H, B);
  attention_fwd_tf32w_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const uint8_t*>(valid), static_cast<float*>(out), S, ld_out);
  return (int)cudaGetLastError();
}
