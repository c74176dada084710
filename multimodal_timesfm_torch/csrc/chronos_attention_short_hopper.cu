// Chronos-2 T5 attention forward (B4f), bf16, head_dim 64, short sequences:
// the one-pass persistent route for Hopper (sm_90a), taken by
// chronos_attention_fwd (chronos_attention.cu) when make_plan gives route 4
// forward (chronos_short_fwd_takes below).
//
// Replaces, where the rule sends them here (S <= kShortFwdTo = 128), the Pallas TPU
// kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel :120 (B4f,
//       fused_chronos_attention, pallas_call :261)
// The function is chronos_attention.cu's (its header): per (batch row, head)
// L = Q K^T + bias[h] with q unscaled, finfo(float32).min across segments,
// W = softmax(L) in fp32, O = bf16(W) V summed in fp32 and cast once. The
// normalised W is rounded, as JAX rounds it (w.astype(vs.dtype),
// chronos_attention.py:138), never an unnormalised weight.
//
// What bounds it on an H100: at Chronos-2's fine-tune (128 x 67 tokens x 12
// heads x 64) the bytes, 52.9 MB (q, k and v read and the output written
// once, the bias and the ids once): 0.0158 ms at 3.35 TB/s. The products are
// about 2.5 GFLOP on the 80-row tiles (Q K^T and W V of 80 x 80 x 64 a batch
// row and head), a few microseconds on mma.sync. The one-pass mma.sync route
// before it (chronos_attention.cu, route 1) ran blocks of one head and G = B H
// / 512 batch rows (3 at 12 heads, 1 at 6), each loading the head's bias
// strip and then its first row's tiles by per-thread cp.async before any
// product, through a ring of two slots: that start was exposed every 3 rows
// at 12 heads and on every row at 6 (0.0345 and 0.0225 ms against bounds of
// 0.0158 and 0.0079, chip_smoke.py --kernel-times, H100 80GB HBM3 at 700 W).
//
// Design (hopper_short.cuh): one kernel, persistent blocks sized to the card,
// each owning one head and a contiguous range of batch rows (P = SMs x
// blocks an SM / H blocks a head: 11 at 12 heads, about 12 rows a block; 22
// at 6 heads), so a block pays its start once and then streams rows. A
// producer warp keeps the next rows' q, k and v tiles (one TMA box each: SP =
// S rounded up to 16 rows by 64 columns under the 128-byte swizzle, read in
// place from the fused projection; rows past S come as zeros) and segment ids
// in flight through a ring of 3-6 stages, as many as fit (full and empty
// mbarriers; the ids read a row ahead). Up to S
// = 80 two consumer groups of SP / 16 warps take alternate rows of the range;
// from 81 one group does (two groups' 13-17 warps leave 96-128 registers a
// thread, and spilled). Per row
// a warp takes its 16 query rows against every key: S = bias + Q K^T on
// mma.sync m16n8k16 (ldmatrix with the swizzle undone), the segment mask, the
// exact row max and sum with the whole row in registers, W = exp(l - m) / s
// rounded to bf16 in the registers as the A fragment of W V (V by
// ldmatrix.trans), at S = 65-72 and 97-104 over the keys up to the last valid
// 8 (72, 104), not the whole tile. The output is rounded once into the
// warp's own 16 rows of the Q tile, which only this warp reads, then written
// to device memory as whole rows, 16 bytes a lane: no barrier inside a group,
// each warp arrives on the stage's `empty` itself. No atomics: two launches
// give bit-equal outputs.
//
// The bias. Its (S, S) fp32 rows are 4 S bytes apart (268 at S = 67), so TMA
// cannot load them. The block's consumers copy the head's strip into shared
// memory once, by 4-byte cp.async while the first rows' tiles arrive, rows SP
// + 8 floats apart (conflict-free 8-byte reads in the accumulator layout),
// and each row starts its logits from it, two columns a load. Measured
// against each thread reading its entries in the accumulator layout from L1
// per row, as B4b's route does (a build of this file with both, held device
// ms in turns, strip then L1, on one H100 80GB HBM3 at 700 W): 128 x 67 x 12
// 0.0274, 0.0257 against 0.0274, 0.0259; 128 x 67 x 6 0.0118, 0.0124 against
// 0.0126, 0.0125; 9,232 tokens at S = 16 / 64 / 96 / 113 / 128: 0.0221 /
// 0.0237 / 0.0272 / 0.0385 / 0.0387 against 0.0241 / 0.0267 / 0.0318 /
// 0.0554 / 0.0574 (means of two). The strip is as fast or faster at every
// length, and the reads from L1 were dropped. A third consumer group up to S
// = 80 (16 warps, 128 registers) read 0.0255 against 0.0267 at 128 x 67 x 12,
// but spilled at S = 73-80 and, with three groups on a ring of 4 stages,
// let a group take a stage whose earlier row another group had not yet
// received (a launch at 577 x 16 x 12 failed; hopper_short.cuh's wait_row
// now refuses such a ring at compile time): dropped.
//
// What holds it back: its consumers, not its loads. A build whose consumers
// only wait for each stage and release it (no products, no output) read
// 0.0101-0.0104 ms at 128 x 67 x 12 against 0.0232-0.0233 for the kernel
// (the same call, held device ms, H100 80GB HBM3 at 700 W; back-to-back
// launches find q, k and v in L2, so that floor lies under the bytes'
// bound). A row's chain per warp (products, the quad reductions of the
// softmax, products, the copy out) runs on 10-11 warps an SM (155 registers
// a thread: one block), too few to hide its latencies. Reading the segment
// ids a row ahead and a ring of 6 stages instead of 4 (3 rows a group in
// flight) took 128 x 67 x 12 from 0.0255-0.0272 to 0.0232-0.0233 ms; with one
// group (S = 96-128) the same build read 2-5% slower (0.0237 against 0.0226
// at 64 x 97), and was kept for one design at every length.
//
// mma.sync with two consumer groups, not wgmma over 64-row tiles: at S = 67
// wgmma takes two 64-row tiles a side (128 rows of which 67 are valid), and
// the work is bound by its bytes, not by its products (the reason of B4b's
// route, chronos_attention_bwd_short_hopper.cu).

#include "hopper_short.cuh"

#include <math.h>


namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::hopper_short;

constexpr int kD = 64;        // head_dim of this route
constexpr int kNK = 4;        // k-steps of 16 over head_dim
constexpr int kNO = 8;        // 8-column blocks of an output row
constexpr int kOperands = 3;  // q, k, v
constexpr int kStagesMax = 6;  // stages of the TMA ring, at most (as many as fit)
// Consumer groups of a block: two up to S = 80 (NQ <= 5), one from 81, where
// two groups' registers (13 or more warps: 128 a thread) spill.
constexpr int groups_of(int nq) { return nq <= 5 ? 2 : 1; }
// The longest S this route is built for and the rule gives it: it is the
// faster by more than 5% at every length measured up to it, against the
// one-pass route up to 96 tokens and the wgmma route from 97
// (chip_smoke.py's B4f persistent [gate] lines), so the wgmma route's kFwdFrom
// is the next length.
constexpr int kShortFwdTo = 128;

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of the tiles = keys of a logit row
  static constexpr int NT = SP / 8;
  static constexpr int G = groups_of(NQ);  // consumer groups
  static constexpr int GW = NQ;       // warps of a consumer group
  static constexpr int NC = 32 * G * GW;  // consumer threads
  static constexpr int THREADS = NC + 32;
  static constexpr int TILE = SP * 2 * kD;  // a multiple of 1024
  static constexpr int STAGE = kOperands * TILE;
  static constexpr int LDB = SP + 8;  // bias strip row stride (floats): conflict-free pairs
  static constexpr int STRIP = SP * LDB * 4;
  // Beside the ring: the alignment slack, the bias strip, each stage's
  // segment ids, the barriers.
  static constexpr int FIXED = kAlign + STRIP + kStagesMax * SP * 4 + 16 * kStagesMax;
  static constexpr int STAGES = ring_stages(FIXED, STAGE, kStagesMax);
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= kMinStages, "the ring does not fit");
};

// NTK: the 8-key blocks of a logit row computed, ceil(S / 8): 2 NQ, or 2 NQ
// - 1 where the last block lies past S.
template <int NQ, int NTK>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    chronos_fwd_short_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm, const int* __restrict__ seg,
                             const float* __restrict__ bias, bf16* __restrict__ out, int B, int S,
                             int H, int P) {
  using C = Cfg<NQ>;
  static_assert(NTK == C::NT || NTK == C::NT - 1, "NTK is ceil(S / 8)");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  float* strip = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);
  int* segs = reinterpret_cast<int*>(smem + C::STAGES * C::STAGE + C::STRIP);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + C::STAGES * C::SP);
  uint64_t* empty = full + C::STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x / P;
  const int part = blockIdx.x - h * P;
  const int b0 = (int)((long long)part * B / P);
  const int nb = (int)((long long)(part + 1) * B / P) - b0;
  const float* const bias_h = bias + (long long)h * S * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, C::GW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::G * C::GW) {
    // Producer: batch row b0 + j into stage j % STAGES, lane o loading operand
    // o, then the row's segment ids (past S: the last one's; such keys and
    // rows are masked or never stored), read a row ahead into registers so
    // that no load's latency lies between a stage's release and its `full`.
    constexpr int IDS = (C::SP + 31) / 32;
    int ids[IDS];
    auto read_ids = [&](int b) {
      const int* src = seg + (long long)b * S;
#pragma unroll
      for (int i = 0; i < IDS; ++i) ids[i] = __ldg(src + min(lane + 32 * i, S - 1));
    };
    if (nb > 0) read_ids(b0);
    for (int j = 0; j < nb; ++j) {
      const int st = j % C::STAGES;
      mbar_wait(empty + st, ((j / C::STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + st, C::STAGE);
      __syncwarp();
      if (lane < kOperands) {
        const CUtensorMap* m = lane == 0 ? &qm : lane == 1 ? &km : &vm;
        tma_load(smem + st * C::STAGE + lane * C::TILE, m, full + st, h * kD, 0, b0 + j);
      }
#pragma unroll
      for (int i = 0; i < IDS; ++i)
        if (lane + 32 * i < C::SP) segs[st * C::SP + lane + 32 * i] = ids[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(full + st);
      if (j + 1 < nb) read_ids(b0 + j + 1);
    }
    return;
  }

  // Consumers: group grp takes the range's rows grp, grp + G, ...; warp wi
  // owns query rows r0..r0+15.
  const int grp = warp / C::GW;
  const int r0 = 16 * (warp - grp * C::GW);
  const int t = lane & 3;
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  // The head's bias strip, copied once by 4-byte cp.async (its rows are not
  // 16-byte aligned) while the first rows' tiles arrive. The thread's two rows
  // from its first column, 2 t (a row past S reads row S - 1: such rows are
  // never stored); columns past S hold whatever the padding holds: the mask
  // gives those keys -inf.
  for (int i = threadIdx.x; i < S * S; i += C::NC) {
    const int r = i / S;
    mtt::cp_async4(strip + r * C::LDB + (i - r * S), bias_h + i, true);
  }
  mtt::cp_async_commit();
  const float* const brow[2] = {strip + min(rows[0], S - 1) * C::LDB + 2 * t,
                                strip + min(rows[1], S - 1) * C::LDB + 2 * t};
  mtt::cp_async_wait_all();
  named_sync(1, C::NC);
  const long long hd = (long long)H * kD;
  bf16* const out_h = out + (long long)h * kD;
  constexpr float kZero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int j = grp; j < nb; j += C::G) {
    const int st = j % C::STAGES;
    const uint32_t sb = ring + st * C::STAGE;
    const Tile<kD> Qt(sb, C::SP), Kt(sb + C::TILE, C::SP), Vt(sb + 2 * C::TILE, C::SP);
    // The logits start from the bias, read before the stage's wait.
    float sc[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 b = *reinterpret_cast<const float2*>(brow[r] + n * 8);
        sc[n][2 * r] = b.x;
        sc[n][2 * r + 1] = b.y;
      }
    wait_row<C::STAGES, C::G>(full, empty, j);
    abt<kNK, NTK>(sc, Qt, r0, Kt, lane);
    segment_mask(sc, segs + st * C::SP, rows, S, t);
    softmax_row(sc, 0);
    softmax_row(sc, 1);
    // O = bf16(W) V: W's 16-key blocks packed as A fragments first (past NTK
    // blocks: zeros), so that the fp32 W is not live beside the accumulators.
    constexpr int KS = (NTK + 1) / 2;
    uint32_t wa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t unused[4];
      mtt::a_frags<false>(sc[2 * kk], 2 * kk + 1 < NTK ? sc[2 * kk + 1] : kZero, wa[kk], unused);
    }
    float acc[kNO][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) pb<kNO, false>(acc, wa[kk], wa[kk], Vt, kk * 16, lane);
    __syncwarp();  // the warp's reads of its Q rows done before O takes their place
    put<kNO>(Qt, r0, acc, lane);
    __syncwarp();
    copy_rows<kD>(Qt, r0, out_h + (long long)(b0 + j) * S * hd, hd, S, lane);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
}

template <int NQ, int NTK>
cudaError_t launch(const CUtensorMap (&maps)[kOperands], const int* seg, const float* bias,
                   bf16* out, int B, int S, int H, int P, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = chronos_fwd_short_kernel<NQ, NTK>;
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
  auto* kernel = chronos_fwd_short_kernel<NQ, 2 * NQ>;
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

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int mtt_chronos_route_override();

// Whether make_plan gives a bf16 forward at (S, D) this route: head_dim 64 and
// S <= kShortFwdTo; never under the route override (chronos_set_route) 1
// (mma.sync) or 3 (wgmma).
extern "C" int chronos_short_fwd_takes(int S, int D) {
  const int force = mtt_chronos_route_override();
  return D == kD && S >= 1 && S <= kShortFwdTo && force != 1 && force != 3;
}

extern "C" int chronos_short_fwd_threads(int S) {
  const int nq = (S + 15) / 16;
  return 32 * (groups_of(nq) * nq + 1);
}

// Blocks a head: as many as fill the card once, at most B.
extern "C" int chronos_short_fwd_groups(int B, int S, int H) {
  static int cached[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int nq = (S + 15) / 16;
  if (nq < 1 || nq > 8) return 1;
  if (cached[nq] == 0) cached[nq] = per_sm(nq);
  const int blocks = persistent_blocks(1 << 30) * (cached[nq] > 0 ? cached[nq] : 1);
  const int p = blocks / H;
  return p < 1 ? 1 : p > B ? B : p;
}

// qkv (B, S, 3*H*64) and out (B, S, H*64) bf16, contiguous and 16-byte
// aligned (refused otherwise); seg (B, S) int32; bias (H, S, S) fp32.
// Launches on `stream`.
extern "C" int chronos_short_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                 int B, int S, int H, void* stream) {
  if (S < 1 || S > kShortFwdTo) return (int)cudaErrorInvalidValue;
  if (!aligned(qkv) || !aligned(out)) return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const long long hd = (long long)H * kD;
  const auto* base = static_cast<const bf16*>(qkv);
  CUtensorMap maps[kOperands];
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err = encode_rows(&maps[o], base + o * hd, B, S, (int)hd, 3 * hd, kD,
                                        16 * nq, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
  }
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const int P = chronos_short_fwd_groups(B, S, H);
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
