// Chronos-2 T5 attention forward (B4f), fp32, head_dim 64: route 7, 3xTF32
// on Hopper's warpgroup products (wgmma) fed by TMA, taken by
// chronos_attention_fwd (chronos_attention.cu) when make_plan
// (chronos_common.cuh) gives route 7: after route 6 (the persistent route for
// short sequences) and before route 5 (3xTF32 mma.sync), by the rule of
// chronos_tf32w_takes below. The backward's half is
// chronos_attention_bwd_tf32_hopper.cu, the shared pieces chronos_tf32_hopper.cuh
// (its header: the tiles at head_dim 64, the transposes) and, through it,
// attention_tf32_hopper.cuh (the split into TF32 hi and lo, the order of the
// three products) and hopper_common.cuh.
//
// Replaces, where the rule sends them here, in fp32 (Chronos-2's default
// compute dtype):
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel (B4f)
// The function is chronos_attention.cu's (its header): per (batch, head) L =
// Q K^T + bias[h] (q unscaled, bias (H, S, S) fp32), finfo(float32).min
// across segments, W = softmax(L) in fp32, O = W V; q, k and v read in place
// from the (B, S, 3*H*64) projection.
//
// Design: route 5 of the causal kernels (attention_fwd_tf32_hopper.cu) at
// head_dim 64, with route 3's bias reads (chronos_attention_hopper.cu). One
// block per (128-row query tile, head, batch row): two consumer warpgroups
// of 64 query rows (16 a warp) and a producer warpgroup. The producer's first
// warp keeps TMA loads in flight: the block's Q tiles once, then for each
// 32-key tile K into a stage of a ring of kStages and V into a ring of kRawV
// raw slots. Its other three warps convert: Q's lo twin once, then per key
// tile K's lo twin and V^T as hi and lo into the tile's stage, and release V's
// raw slot. So the consumers only multiply: S = Q K^T (wgmma m64n32k8, A and B
// from shared memory, with their lo twins), the bias and the segment mask
// (each thread's 16 entries of the tile read from L2 in the accumulator
// layout before the waits and the product, every address clamped, the mask
// folded in while it runs: the bias rows are 4 S bytes apart, no multiple of
// 16, so TMA cannot load them), the online softmax (running max m and sum s,
// the output rescaled at every tile, divided by s at the end) and O += P V (wgmma
// m64n64k8, P's hi and lo from the registers, V^T from the stage). A key of
// another segment before a row's first own key adds exp(0) = 1 while m is
// still finfo.min and is wiped once an own key raises m (every token keeps
// at least its own key).
//
// Why not route 3's persistent blocks: their gain is that the next work
// item's Q tiles load while this one computes, which needs a second Q buffer:
// Q and its lo twin are 64 KB for two warpgroups, and with them twice the
// ring below leaves no room (228 KB an SM). One block an SM, so a block's
// start (its Q tiles and their twins) is not hidden behind another block.
//
// Shared memory (kSmem, 209 KB): Q (two 64-row tiles, 32 KB) and its lo twin
// (32 KB); kRawV = 2 raw V tiles of 32 rows (16 KB); kStages = 4 stages of K
// (as TMA wrote it), K's lo twin, V^T hi and V^T lo (8 KB each: 32 KB a
// stage); the mbarriers.
//
// What bounds it on an H100: the 3xTF32 products at a third of the TF32
// tensor rate, 495 / 3 = 165 TFLOP/s (chip_smoke.py's bound_ms; 0.099 ms at
// 16 x 577 x 12). The kernel's own limits: Q K^T reading both operands from
// shared memory, the bias reads from L2 (255 MB a launch at 16 x 577, as route
// 3's), the conversion pass beside the products (24 KB written a key tile),
// and the serial chain of a warpgroup's tile (products, softmax, products).
// 577 = 18 x 32 + 1: the last key tile holds one key. A first build that
// rescaled the output only when the row maximum grew (a branch around 32
// multiplies) left ptxas serialising the products (C7511: registers for the
// wgmma pipeline short at the launch bound's 168) and ran markedly slower;
// rescaling at every tile (x 1 is exact) removed it, as did reading the bias
// after the product's issue, which ran a little slower than this order
// (chip_smoke.py's [build] ptxas lines report any such warning).

#include "chronos_tf32_hopper.cuh"

namespace {

using namespace mtt::hopper;
using namespace mtt::tf32c;

constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRes * kConsumers;   // query rows of a block
constexpr int kConverters = 3;                  // the producer's converting warps
// Registers a thread after setmaxnreg: 2 x 224 + 56 = 504 = 3 x 168, the
// launch bound's (route 5's split).
constexpr int kConsumerRegsF = 224;
constexpr int kProducerRegsF = 56;
constexpr int kStages = 4;
constexpr int kRawV = 2;
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
static_assert(kSmem <= 232448, "a block's shared memory on an H100");

__global__ void __launch_bounds__(kThreads, 1)
    chronos_fwd_tf32w_kernel(const __grid_constant__ QkvMaps maps, const int* __restrict__ seg,
                             const float* __restrict__ bias, float* __restrict__ out, int S,
                             long long ld_out) {
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

  const int q0 = (int)blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nkt = (S + kStr - 1) / kStr;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / 128;
  const int qtiles = min(kConsumers, (S - q0 + kRes - 1) / kRes);  // Q tiles that start before S

  if (wg == kConsumers) {
    regs_dec<kProducerRegsF>();
    const int pw = (threadIdx.x / 32) % 4;  // the producer's warp
    if (pw == 0) {                          // TMA
      if (lane == 0) {
        mbar_expect_tx(q_full, qtiles * tile_bytes<kRes>());
        for (int c = 0; c < qtiles; ++c)
          load_tile<kRes>(smem + kQ + c * tile_bytes<kRes>(), &maps.q.res, q_full, h, q0 + c * kRes, b);
        for (int j = 0; j < nkt; ++j) {
          const int st = j % kStages, r = j % kRawV;
          mbar_wait(empty + st, ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full + st, tile_bytes<kStr>());
          load_tile<kStr>(smem + kStageOffset + st * kStage, &maps.k.str, k_full + st, h, j * kStr, b);
          mbar_wait(v_free + r, ((j / kRawV) & 1) ^ 1);
          mbar_expect_tx(v_full + r, tile_bytes<kStr>());
          load_tile<kStr>(smem + kRawOffset + r * tile_bytes<kStr>(), &maps.v.str, v_full + r, h, j * kStr, b);
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
    converted(q_lo, lane);
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

  // Consumer warpgroup wg: query rows [wq0, wq0 + 64); a warpgroup whose rows
  // all lie past S computes nothing but keeps the ring's count.
  regs_inc<kConsumerRegsF>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t base = smem_u32(smem);
  const int wq0 = q0 + wg * kRes;
  const bool mine = wq0 < S;
  const int rows[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  int sr[2];
  row_segments(sr, seg_b, rows, S);
  const uint32_t qa = base + kQ + wg * tile_bytes<kRes>();
  const uint32_t qa_lo = base + kQlo + wg * tile_bytes<kRes>();

  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  if (mine) {
    mbar_wait(q_full, 0);
    mbar_wait(q_lo, 0);
  }

  for (int j = 0; j < nkt; ++j) {
    const int st = j % kStages;
    const int k0 = j * kStr;
    BiasTile bt;
    if (mine) load_bias(bt, bias_h, seg_b, rows, k0, S, t);  // overlaps the waits and the product
    mbar_wait(k_full + st, (j / kStages) & 1);
    mbar_wait(c_full + st, (j / kStages) & 1);
    if (mine) {
      const uint32_t stage = base + kStageOffset + st * kStage;
      float sc[4][4];
      wgmma_fence();
      issue_abt3(sc, qa, qa_lo, stage, stage + kKlo);
      wgmma_commit();
      fold_mask(bt, sr, k0, S, t);  // while the products run
      wgmma_wait();
      fence_regs(sc);
      add_bias(sc, bt);

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
        // At every tile (x 1 is exact): a branch here left ptxas serialising
        // the products (C7511).
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          o[c][2 * r] *= scale;
          o[c][2 * r + 1] *= scale;
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

  if (mine) {
    const float inv[2] = {1.f / quad_sum(s[0]), 1.f / quad_sum(s[1])};
    store_f32(out + (long long)b * S * ld_out + (long long)h * kD, ld_out, o, rows[0], inv, S, t);
  }
}

}  // namespace

// Whether make_plan (chronos_common.cuh) gives an fp32 call at (S, D) this
// route, forward (backward = 0) or backward: head_dim 64 from the borders
// kFwdFrom / kBwdFrom, which chip_smoke.py's [gate] chronos fp32 wgmma lines
// measure against route 5 (3xTF32 mma.sync) and route 6 (the persistent
// route) at 12 heads, B = 9,232 / S (PERF.md): the least S from which route
// 7 is the faster by 5% at every measured length. Forward: route 6 the
// faster at 81 and 97, the three within 5% at 113 and 128, route 7 from 160.
// Backward: route 7 the faster at 81, 160, 193 and from 385, within 5% of
// route 5 at 97 and 256 and slower at 113 and 128. make_plan asks route 6
// first, so route 7 takes what route 6 leaves from these lengths; route 5
// keeps fp32 at head_dim 64 below them (no main path runs those lengths: a
// border lower than the readings allow would take route 7 where it is not
// the faster). Layout plays no part: routes 5, 6 and 7 all need a 16-byte
// aligned qkv, which the ops' contiguous tensors give. No upper border: the
// backward's scratch is bounded by its chunks. Route override
// (chronos_set_route): 4 (CUDA cores) and 5 (tf32 mma.sync) never, 7 (tf32
// wgmma) at every S.
constexpr int kFwdFrom = 160;
extern "C" int mtt_chronos_route_override();
extern "C" int chronos_tf32w_bwd_from();

extern "C" int chronos_tf32w_takes(int backward, int S, int D) {
  const int force = mtt_chronos_route_override();
  if (D != kD || force == 4 || force == 5) return 0;
  return force == 7 || S >= (backward ? chronos_tf32w_bwd_from() : kFwdFrom);
}

// Dynamic shared memory a block of the kernel takes (bytes), for reports.
extern "C" int chronos_tf32w_fwd_smem() { return kSmem; }

// qkv (B, S, 3*H*64) and out (B, S, H*64) fp32, contiguous, qkv 16-byte
// aligned, out 8-byte aligned; seg (B, S) int32; bias (H, S, S) fp32.
// Launches on `stream`.
extern "C" int chronos_tf32w_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                 int B, int S, int H, void* stream) {
  if (!aligned16(qkv) || (reinterpret_cast<uintptr_t>(out) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  QkvMaps maps;
  cudaError_t err = encode_qkv(&maps, qkv, B, S, H);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t regs =
      check_split(chronos_fwd_tf32w_kernel, kConsumers, kConsumerRegsF, 1, kProducerRegsF);
  if (regs != cudaSuccess) return (int)regs;
  err = cudaFuncSetAttribute(chronos_fwd_tf32w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chronos_fwd_tf32w_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, H, B);
  chronos_fwd_tf32w_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const int*>(seg), static_cast<const float*>(bias), static_cast<float*>(out), S,
      (long long)H * kD);
  return (int)cudaGetLastError();
}
