// Chronos-2 T5 attention forward (B4f), fp32, head_dim 64, short sequences:
// the persistent 3xTF32 route fed by TMA for Hopper (sm_90a), plan route 6,
// taken by chronos_attention_fwd (chronos_attention.cu) where
// chronos_short_tf32_fwd_takes below says so, ahead of route 5
// (chronos_attention_tf32.cu).
//
// Replaces, in fp32 where the rule sends them here (kShortFwdFrom <= S <=
// kShortFwdTo), the
// Pallas TPU kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel :120 (B4f,
//       fused_chronos_attention, pallas_call :261)
// The function is chronos_attention.cu's (its header): per (batch row, head)
// L = Q K^T + bias[h] with q unscaled, finfo(float32).min across segments,
// W = softmax(L) in fp32, O = W V; in fp32 JAX's w.astype(vs.dtype) is the
// identity. Both products are 3xTF32 (lo hi + hi lo + hi hi, the split
// chronos_tf32_short.cuh's), the softmax fp32 on the CUDA cores.
//
// What bounds it on an H100: at Chronos-2's fine-tune (128 x 67 tokens x 12
// heads x 64) the bytes, 105.6 MB (q, k and v read and the output written
// once, the bias and the ids once): 0.0315 ms at 3.35 TB/s; the two products,
// 7.5 GFLOP as 3xTF32 on the 80-row tiles, about 0.015 ms at 495 / 3
// TFLOP/s. Route 5 before it ran one block per (80-row tile, head, batch
// row), each loading its Q, K and V by per-thread cp.async before any
// product.
//
// Design (chronos_tf32_short.cuh, hopper_short.cuh): route 4's forward
// (chronos_attention_short_hopper.cu) in fp32. One kernel, persistent blocks
// sized to the card, each owning one head and a contiguous range of batch
// rows; a producer warp keeps the next rows' q, k and v tiles (two 32-column
// TMA boxes each, read in place from the fused projection) and segment ids in
// flight through a ring of 2-6 stages, as many as fit. Up to S = 80 two
// consumer groups of SP / 16 warps take alternate rows of the range, from 81
// one. Per row the group first writes k's and v's lo twins (in the stage,
// after v, up to S = 80; from 81 in one buffer a block, where two stages leave
// room for it: S = 81-112; at 113-128 each warp splits what it reads). Then a
// warp takes its 16 query rows against every key: the logits start from the
// bias, read in the accumulator layout from L1 before the stage's wait (a
// block keeps one head), S = bias + Q K^T, the segment mask, the exact row
// max and sum with the whole row in registers, W = exp(l - m) / s, O = W V
// with W's A fragments taken straight from the accumulators (acc_to_a), at S
// = 65-72 and 97-104 over the keys up to the last valid 8. The output goes
// from the accumulators to device memory, 8 bytes a lane (whole 32-byte
// sectors). No atomics: two launches give bit-equal outputs.
//
// Shared memory: one stage of q, k and v is 3 SP x 256 bytes (61,440 at SP =
// 80, 98,304 at 128), with the twins 5 SP x 256. The head's bias stays in
// L1, not in a shared strip as route 4 holds it: at SP = 128 a strip (69,632
// bytes) would leave room for one stage. Up to 80 tokens two groups of warps
// leave a thread 168 registers (one instantiation spills 4 bytes).
//
// Measured and dropped (B4f 128 x 67 x 12, held ms, one H100 80GB HBM3 at 700
// W, route 5 0.080-0.082 in each call): each warp splitting k and v as it
// read them 0.084 (tf32_common's rounded split) and 0.078 (the truncation
// split); three stages without twins against two with them: slower (0.078
// against 0.069); one consumer group up to 80 tokens 0.109 (against 0.084 for
// two, at that design); the per-lane address tables took 0.080 to 0.063.
// Batched issue of each k-step's products: within 3%.
//
// mma.sync m16n8k8 fed by TMA, not wgmma: the reasons of the backward's
// (chronos_attention_bwd_short_tf32.cu).

#include "chronos_tf32_short.cuh"

#include <math.h>

namespace {

using namespace mtt::tf32_short;

constexpr int kOperands = 3;    // q, k, v
constexpr int kStagesMax = 6;   // stages of the TMA ring, at most (as many as fit)
// Consumer groups of a block: two up to S = 80 (NQ <= 5), one from 81, as
// route 4's forward.
constexpr int groups_of(int nq) { return nq <= 5 ? 2 : 1; }
// The lengths the rule gives this route: where chip_smoke.py's [gate] chronos
// fp32 persistent lines measured it the faster by 5% (S = 32-97, H100 80GB
// HBM3 at 700 W: 0.0433 / 0.0465 / 0.0505 / 0.0685 / 0.0661 / 0.0876 held ms
// against route 5's 0.0503 / 0.0665 / 0.0643 / 0.0872 / 0.0804 / 0.1234);
// at S = 16 route 5 was the faster (0.0446 against 0.0500: its short blocks
// beat a block's per-row overhead at 16-row tiles), at 113 and 128 the two
// within 3% (0.1072 / 0.1026 against 0.1105 / 0.1013). kBuiltTo: the longest
// S it is built for, where the route override 6 puts it.
constexpr int kShortFwdFrom = 17;
constexpr int kShortFwdTo = 112;
constexpr int kBuiltTo = 128;

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of the tiles = keys of a logit row
  static constexpr int NT = SP / 8;
  static constexpr int G = groups_of(NQ);  // consumer groups
  static constexpr int GW = NQ;            // warps of a consumer group
  static constexpr int NC = 32 * G * GW;   // consumer threads
  static constexpr int THREADS = NC + 32;
  static constexpr int TILE = SP * kTileRow;  // a multiple of 1024
  // The lo twins of a row's k and v tiles, which its group writes once so that
  // its warps read B operands unsplit: up to S = 80 in each stage, after v;
  // from 81, where one group takes every row, in one buffer a block after the
  // ring where two stages leave room for it (S = 81-112).
  static constexpr bool STAGE_TWINS = G == 2;
  static constexpr int STAGE = (kOperands + (STAGE_TWINS ? 2 : 0)) * TILE;
  // Beside the ring: the alignment slack, each stage's segment ids, the
  // barriers (of up to kStagesMax stages, or of two).
  static constexpr int UPTO = kAlign + kStagesMax * SP * 4 + 16 * kStagesMax;
  static constexpr int TWO = kAlign + 2 * SP * 4 + 16 * 2;
  static constexpr bool BLOCK_TWINS = G == 1 && TWO + 2 * TILE + 2 * STAGE <= kSmemLimit;
  static constexpr int FIXED = BLOCK_TWINS ? TWO + 2 * TILE : UPTO;
  static constexpr int STAGES = BLOCK_TWINS ? 2 : stages_fit(FIXED, STAGE, kStagesMax);
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring does not fit");
};

// NTK: the 8-key blocks of a logit row computed, ceil(S / 8): 2 NQ, or 2 NQ
// - 1 where the last block lies past S.
template <int NQ, int NTK>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    chronos_fwd_short_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm,
                                  const int* __restrict__ seg, const float* __restrict__ bias,
                                  float* __restrict__ out, int B, int S, int H, int P) {
  using C = Cfg<NQ>;
  static_assert(NTK == C::NT || NTK == C::NT - 1, "NTK is ceil(S / 8)");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  const uint32_t twins = ring + C::STAGES * C::STAGE;  // the block's twins, where it has them
  int* segs = reinterpret_cast<int*>(smem + C::STAGES * C::STAGE + (C::BLOCK_TWINS ? 2 * C::TILE : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + C::STAGES * C::SP);
  uint64_t* empty = full + C::STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x / P;
  const int part = blockIdx.x - h * P;
  const int b0 = (int)((long long)part * B / P);
  const int nb = (int)((long long)(part + 1) * B / P) - b0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, C::GW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::G * C::GW) {
    const CUtensorMap* const maps[kOperands] = {&qm, &km, &vm};
    produce<kOperands, C::SP, C::STAGES, C::STAGE>(maps, smem, segs, full, empty, seg, S, h, b0, nb, lane);
    return;
  }

  // Consumers: group grp takes the range's rows grp, grp + G, ...; warp w of
  // the group owns query rows r0..r0+15.
  const int grp = warp / C::GW;
  const int r0 = 16 * (warp - grp * C::GW);
  const int t = lane & 3;
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  const Lanes z(lane);
  const float* const bias_h = bias + (long long)h * S * S + 2 * t;
  const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S,
                                bias_h + (long long)min(rows[1], S - 1) * S};
  const long long hd = (long long)H * kD;
  float* const out_h = out + (long long)h * kD;

  for (int j = grp; j < nb; j += C::G) {
    const int st = j % C::STAGES;
    const uint32_t sb = ring + st * C::STAGE;
    // k's and v's lo twins: after v in the stage, or the block's buffer.
    const uint32_t kv = C::STAGE_TWINS ? sb + 3 * C::TILE : C::BLOCK_TWINS ? twins : 0;
    const Tile32 Qt(sb, C::SP), Kt(sb + C::TILE, C::SP, kv ? kv - (sb + C::TILE) : 0),
        Vt(sb + 2 * C::TILE, C::SP, kv ? kv + C::TILE - (sb + 2 * C::TILE) : 0);
    float sc[NTK][4];
    bias_start(sc, brow, S, t);
    wait_row<C::STAGES, C::G>(full, empty, j);
    if constexpr (C::STAGE_TWINS || C::BLOCK_TWINS) {
      // The block's buffer is free once every warp read the previous row's.
      if constexpr (C::BLOCK_TWINS) named_sync(1, C::NC);
      write_lo(sb + C::TILE, kv, 2 * C::TILE, threadIdx.x - grp * 32 * C::GW, 32 * C::GW);
      named_sync(1 + grp, 32 * C::GW);
    }
    constexpr bool TW = C::STAGE_TWINS || C::BLOCK_TWINS;
    xyt<NTK, TW>(sc, Qt, r0, Kt, z);
    segment_mask(sc, segs + st * C::SP, rows, S, t);
    softmax_row(sc, 0);
    softmax_row(sc, 1);
    float acc[kD / 8][4];
    zero(acc);
    py<NTK, TW>(acc, sc, Vt, z);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);  // the warp's last read of the stage
    store_rows(out_h + (long long)(b0 + j) * S * hd, hd, acc, r0, S, lane);
  }
}

template <int NQ, int NTK>
cudaError_t launch(const CUtensorMap (&maps)[kOperands], const int* seg, const float* bias,
                   float* out, int B, int S, int H, int P, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = chronos_fwd_short_tf32_kernel<NQ, NTK>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<H * P, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], seg, bias, out, B, S,
                                                  H, P);
  return cudaGetLastError();
}

// Blocks an SM holds at once of the NQ instantiation, or 0 on an error.
template <int NQ>
int blocks_per_sm() {
  using C = Cfg<NQ>;
  auto* kernel = chronos_fwd_short_tf32_kernel<NQ, 2 * NQ>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM) !=
      cudaSuccess)
    return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::THREADS, C::SMEM) ==
                 cudaSuccess
             ? n
             : 0;
}

int per_sm(int nq) {
  switch (nq) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    case 5: return blocks_per_sm<5>();
    case 6: return blocks_per_sm<6>();
    case 7: return blocks_per_sm<7>();
    default: return blocks_per_sm<8>();
  }
}

}  // namespace

extern "C" int mtt_chronos_route_override();

// Whether make_plan (chronos_common.cuh) gives an fp32 forward at (S, D) this
// route: head_dim 64 and kShortFwdFrom <= S <= kShortFwdTo; under the route
// override (chronos_set_route) 6 at every S it is built for, never under 4
// (the CUDA cores), 5 (route 5) or 7 (route 7).
extern "C" int chronos_short_tf32_fwd_takes(int S, int D) {
  const int force = mtt_chronos_route_override();
  if (D != kD || S < 1 || S > kBuiltTo || force == 4 || force == 5 || force == 7) return 0;
  return force == 6 || (S >= kShortFwdFrom && S <= kShortFwdTo);
}

extern "C" int chronos_short_tf32_fwd_threads(int S) {
  const int nq = (S + 15) / 16;
  return 32 * (groups_of(nq) * nq + 1);
}

// Blocks a head: as many as fill the card once, at most B.
extern "C" int chronos_short_tf32_fwd_groups(int B, int S, int H) {
  static int cached[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int nq = (S + 15) / 16;
  if (nq < 1 || nq > 8) return 1;
  if (cached[nq] == 0) cached[nq] = per_sm(nq);
  const int blocks = persistent_blocks(1 << 30) * (cached[nq] > 0 ? cached[nq] : 1);
  const int p = blocks / H;
  return p < 1 ? 1 : p > B ? B : p;
}

// qkv (B, S, 3*H*64) and out (B, S, H*64) fp32, contiguous, qkv 16-byte
// aligned, out 8-byte aligned (refused otherwise); seg (B, S) int32; bias (H,
// S, S) fp32. Launches on `stream`.
extern "C" int chronos_short_tf32_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                      int B, int S, int H, void* stream) {
  if (S < 1 || S > kBuiltTo) return (int)cudaErrorInvalidValue;
  if (!aligned16(qkv) || (reinterpret_cast<uintptr_t>(out) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const long long hd = (long long)H * kD;
  const auto* base = static_cast<const float*>(qkv);
  CUtensorMap maps[kOperands];
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err = encode_f32_rows(&maps[o], base + o * hd, B, S, (int)hd, 3 * hd, 16 * nq);
    if (err != cudaSuccess) return (int)err;
  }
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  const int P = chronos_short_tf32_fwd_groups(B, S, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool odd = (S + 7) / 8 < 2 * nq;  // the last 8-key block lies past S
  cudaError_t err;
  switch (nq) {
    case 1: err = launch<1, 2>(maps, sg, bs, o, B, S, H, P, st); break;
    case 2: err = launch<2, 4>(maps, sg, bs, o, B, S, H, P, st); break;
    case 3: err = launch<3, 6>(maps, sg, bs, o, B, S, H, P, st); break;
    case 4: err = launch<4, 8>(maps, sg, bs, o, B, S, H, P, st); break;
    case 5:
      err = odd ? launch<5, 9>(maps, sg, bs, o, B, S, H, P, st)
                : launch<5, 10>(maps, sg, bs, o, B, S, H, P, st);
      break;
    case 6: err = launch<6, 12>(maps, sg, bs, o, B, S, H, P, st); break;
    case 7:
      err = odd ? launch<7, 13>(maps, sg, bs, o, B, S, H, P, st)
                : launch<7, 14>(maps, sg, bs, o, B, S, H, P, st);
      break;
    default: err = launch<8, 16>(maps, sg, bs, o, B, S, H, P, st);
  }
  return (int)err;
}
