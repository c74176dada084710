// Chronos-2 T5 attention backward (B4b), bf16, head_dim 64, short sequences:
// the one-pass persistent route for Hopper (sm_90a), taken by
// chronos_attention_bwd (chronos_attention_bwd.cu) when make_plan gives route 4
// (chronos_short_takes below).
//
// Replaces, where the rule sends them here (S <= kShortTo), the Pallas TPU
// kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel :144 (B4b,
//       fused_chronos_attention's VJP, pallas_call :307)
// The function is chronos_attention.cu's (its header): W = softmax(L)
// recomputed in fp32 and not rounded, dV = W^T G, dW = G V^T, dL = W o (dW -
// r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, dbias[h] = dL summed
// over the batch, each output cast once; nothing saved beyond qkv, seg and
// the bias.
//
// What bounds it on an H100: at Chronos-2's fine-tune (128 x 67 tokens x 12
// heads x 64) the bytes, 92.3 MB (qkv and g read once, dqkv written once, the
// bias and the ids once): 0.0276 ms at 3.35 TB/s, and 0.0290 ms with dbias
// written; the products are about 8.8 GFLOP (7 of 80 x 80 x 64 a batch row
// and head: about 9 us at the bf16 peak, several times that on mma.sync), so
// here the tensor cores matter too. The one-pass mma.sync route before it ran
// one block of 5 warps an SM (163 KB of shared memory), exposed each block's
// start every B H / 512 batch rows (the bias strip, loaded 4 or 8 bytes at a
// time, then the first row's tiles), and wrote one (H, S, S) dbias partial per
// group of those rows (9.3 MB each way at 12 heads).
//
// Design (hopper_short.cuh): one kernel, persistent blocks, each owning one
// head and a contiguous range of batch rows (P = SMs x blocks an SM / H
// blocks a head: 11 at 12 heads, 22 at 6). Each thread reads its elements of
// the head's (S, S) fp32 bias in its accumulator layout as the logits'
// starting value, before the stage's wait: from L2 once, then from L1, where
// the head's rows stay (a block keeps one head; 18 KB at S = 67). Two consumer groups of NQ = SP / 16 warps (SP = S rounded up to
// 16: 5 warps each at S = 67) take alternate batch rows of the range, so two
// rows' products run on an SM at once (10 warps against the old route's 5),
// while a producer warp keeps the next rows' q, k, v and g tiles (one TMA box
// each, 128-byte swizzle, read in place from the fused projection) and
// segment ids in flight through a ring of 3 stages (4 below S = 65). Per batch
// row, phase A (a warp's 16 query rows against every key; at S = 65-72 the
// 72 keys up to the last valid one, not 80): S = bias + Q K^T, the segment
// mask, dW = G V^T, W, r and dL in fp32 registers, W and dL (each a hi + lo
// bf16 pair) to the group's staging, dQ = dL K; phase B (the warp's 16 keys):
// dV = W^T G, then dK = dL^T Q. W as one bf16 value left dV outside BWD_TOL
// where its terms cancel (512 x 80 tokens in 16 segments of 5), so dV takes
// the pair too. Each warp adds its rows of dL into dbias in
// registers over its group's rows, in batch order; at the end group 1 hands
// its sums to group 0 through shared memory, which adds them (group 0's +
// group 1's) and writes the block's one (S, S) partial: P (H, S, S) partials
// in all (2.4 MB at 12 heads, one per block instead of one per 3 batch rows),
// summed in order by chronos_bwd_dbias_kernel (none when P = 1). No atomics:
// two launches give bit-equal dqkv and dbias, and dqkv does not depend on
// whether dbias is asked for.
//
// mma.sync with a second consumer group, not wgmma over 64-row tiles: at S =
// 67 wgmma takes two 64-row tiles a side (128 rows of which 67 are valid),
// about 2.6x this route's products on 80-row tiles, and its register
// accumulators for a full key row (two 64 x 64 tiles of logits and two of dW)
// leave no room for a second warpgroup's rows beside them; it was not built.
// The ring and two groups' W and dL staging fill 227 KB at S = 80 (three
// stages, staging rows unpadded), so the route stops there (S = 81-96 stay on
// the one-pass mma.sync route, whose 163 KB hold them); no room is left for
// the head's bias strip, hence the reads from L1. Eleven warps a block leave a
// thread 168 registers (three warps an SM sub-partition): with dbias its 36
// accumulators still spill 36-52 bytes, and with them it runs at more than
// twice its bound. The bias loads read through row pointers made opaque to
// the compiler in each row: with plain ones it hoisted them out of the row
// loop into held registers and spilled 96-196 bytes without dbias.
// Measured and dropped (B4b 128 x 67 x 12, one H100): dbias summed in device
// memory (L2) by each group, read, added and written back per row, instead of
// in registers: slower (0.0745 against 0.0700 ms); the lane index made opaque
// to the compiler per row (so that addresses are recomputed, not held): it
// kept the early builds from spilling, and once the rest fitted it cost 3%;
// the query tiles' loop of phase B unrolled: 1-2% slower.

#include "hopper_short.cuh"

#include <math.h>

namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::hopper_short;

constexpr int kD = 64;     // head_dim of this route
constexpr int kNK = 4;     // k-steps of 16 over head_dim
constexpr int kNO = 8;     // 8-column blocks of an output row
constexpr int kOperands = 4;  // q, k, v, g
// The longest S this route takes: the longest it is built for, and the border
// it is measured faster up to (chip_smoke.py's B4b persistent [gate] lines).
constexpr int kShortTo = 80;

// Shared memory beside the ring at SP rows with W and dL rows `ldw` apart:
// the alignment slack, two groups' staging, each stage's segment ids, the
// barriers.
constexpr int fixed_bytes(int sp, int ldw) {
  return kAlign + kGroups * 4 * sp * ldw * 2 + kMaxStages * sp * 4 + 16 * kMaxStages +
         8 * kGroups;
}

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of the tiles = keys of a logit row
  static constexpr int NT = SP / 8;
  static constexpr int GW = NQ;       // warps of a consumer group
  static constexpr int NC = 32 * kGroups * GW;  // consumer threads
  static constexpr int THREADS = NC + 32;
  static constexpr int TILE = SP * 2 * kD;  // a multiple of 1024
  static constexpr int STAGE = kOperands * TILE;
  // W and dL staging: rows SP + 8 apart where the ring still takes 3 stages,
  // else SP (S = 80).
  static constexpr int LDW = ring_stages(fixed_bytes(SP, SP + 8), STAGE) ? SP + 8 : SP;
  static constexpr int STAGING = 4 * SP * LDW * 2;  // W and dL, hi and lo: bytes of a group
  static constexpr int STAGES = ring_stages(fixed_bytes(SP, LDW), STAGE);
  static constexpr int SMEM = fixed_bytes(SP, LDW) + STAGES * STAGE;
  static_assert(STAGES >= kMinStages, "the ring does not fit");
  static_assert(SP * SP * 4 <= STAGE, "the dbias hand-over does not fit a stage");
};

// NTK: the 8-key blocks of a logit row computed, ceil(S / 8): 2 NQ, or 2 NQ
// - 1 where the last block lies past S (S = 65-72: S = 67 computes 72 keys,
// not 80).
template <int NQ, int NTK, bool DBIAS>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    chronos_bwd_short_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm,
                             const __grid_constant__ CUtensorMap gm, const int* __restrict__ seg,
                             const float* __restrict__ bias, bf16* __restrict__ dqkv,
                             float* __restrict__ dbias, int B, int S, int H, int P) {
  using C = Cfg<NQ>;
  static_assert(NTK == C::NT || NTK == C::NT - 1, "NTK is ceil(S / 8)");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  bf16* staging = reinterpret_cast<bf16*>(smem + C::STAGES * C::STAGE);
  int* segs = reinterpret_cast<int*>(smem + C::STAGES * C::STAGE + kGroups * C::STAGING);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + C::STAGES * C::SP);
  uint64_t* empty = full + C::STAGES;
  uint64_t* freed = empty + C::STAGES;  // a group's W and dL staging read by all its warps
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
    for (int g = 0; g < kGroups; ++g) mbar_init(freed + g, C::GW);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kGroups * C::GW) {
    // Producer: batch row b0 + j into stage j % STAGES, lane o loading operand
    // o, then the row's segment ids (past S: the last one's; such keys and rows
    // are masked or never stored).
    for (int j = 0; j < nb; ++j) {
      const int st = j % C::STAGES;
      mbar_wait(empty + st, ((j / C::STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(full + st, C::STAGE);
      __syncwarp();
      if (lane < kOperands) {
        const CUtensorMap* m = lane == 0 ? &qm : lane == 1 ? &km : lane == 2 ? &vm : &gm;
        tma_load(smem + st * C::STAGE + lane * C::TILE, m, full + st, h * kD, 0, b0 + j);
      }
      const int* src = seg + (long long)(b0 + j) * S;
      for (int c = lane; c < C::SP; c += 32) segs[st * C::SP + c] = __ldg(src + min(c, S - 1));
      __syncwarp();
      if (lane == 0) mbar_arrive(full + st);
    }
    return;
  }

  // Consumers: group grp takes the range's rows grp, grp + 2, ...; warp wi
  // owns query rows (phase A) and keys (phase B) r0..r0+15.
  const int grp = warp / C::GW;
  const int r0 = 16 * (warp - grp * C::GW);
  const int t = lane & 3;
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  // The thread's two rows of the head's (S, S) bias from its first column, 2 t
  // (a row past S reads row S - 1: such rows are never stored).
  const float* const bias_h = bias + (long long)h * S * S + 2 * t;
  const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S,
                                bias_h + (long long)min(rows[1], S - 1) * S};
  bf16* wh = staging + grp * (C::STAGING / 2);
  bf16* wl = wh + C::SP * C::LDW;
  bf16* dh = wl + C::SP * C::LDW;
  bf16* dl = dh + C::SP * C::LDW;
  const long long hd = (long long)H * kD;
  const long long ld = 3 * hd;
  float db[DBIAS ? NTK : 1][4];
#pragma unroll
  for (int n = 0; n < (DBIAS ? NTK : 1); ++n) db[n][0] = db[n][1] = db[n][2] = db[n][3] = 0.f;

  for (int j = grp; j < nb; j += kGroups) {
    const int st = j % C::STAGES;
    const int b = b0 + j;
    const int* sg = segs + st * C::SP;
    const uint32_t sb = ring + st * C::STAGE;
    const Tile<kD> Qt(sb, C::SP), Kt(sb + C::TILE, C::SP), Vt(sb + 2 * C::TILE, C::SP),
        Gt(sb + 3 * C::TILE, C::SP);
    // Phase A. The logits start from the bias, read before the stage's wait
    // (from L1, where the head's rows stay: a block keeps one head).
    float acc[kNO][4];
    {
      // The row pointers opaque to the compiler in each row, so that the loads
      // stay here and are not hoisted out of the loop into held registers.
      const float* bp[2] = {brow[0], brow[1]};
      asm volatile("" : "+l"(bp[0]), "+l"(bp[1]));
      float sc[NTK][4], dw[NTK][4];
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = n * 8 + 2 * t + (e & 1) < S ? __ldg(bp[e >> 1] + n * 8 + (e & 1)) : 0.f;
      zero(dw);
      wait_row<C::STAGES, kGroups>(full, empty, j);
      abt<kNK, NTK>(sc, Qt, r0, Kt, lane);
      abt<kNK, NTK>(dw, Gt, r0, Vt, lane);
      segment_mask(sc, sg, rows, S, t);
      // The staging is free once every warp of the group read the previous row's.
      if (j >= kGroups) mbar_wait(freed + grp, ((j - grp) / kGroups - 1) & 1);
      softmax_dl<NTK, C::LDW>(sc, dw, rows, wh, wl, dh, dl, lane);
      if constexpr (DBIAS) {
#pragma unroll
        for (int n = 0; n < NTK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) db[n][e] += sc[n][e];
      }
      dq_rows<NTK, kNO>(acc, sc, Kt, lane);
    }
    named_sync(1 + grp, 32 * C::GW);  // the group's W and dL staged; its K and V read
    bf16* out = dqkv + (long long)b * S * ld + (long long)h * kD;
    put<kNO>(Vt, r0, acc, lane);
    __syncwarp();
    copy_rows<kD>(Vt, r0, out, ld, S, lane);
    // Phase B: dV, then dK.
    float dkv[kNO][4];
    keys_pb<NQ, kNO, C::LDW>(dkv, wh, wl, Gt, r0, lane);
    __syncwarp();  // dQ's rows copied out before dV takes their place
    put<kNO>(Vt, r0, dkv, lane);
    __syncwarp();
    copy_rows<kD>(Vt, r0, out + 2 * hd, ld, S, lane);
    keys_pb<NQ, kNO, C::LDW>(dkv, dh, dl, Qt, r0, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(freed + grp);  // this warp's last read of the staging
    put<kNO>(Kt, r0, dkv, lane);
    __syncwarp();
    copy_rows<kD>(Kt, r0, out + hd, ld, S, lane);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  if constexpr (DBIAS) {
    // The block's partial: group 0's sums (rows 0, 2, ... of the range) plus
    // group 1's (rows 1, 3, ...), handed over in the first stage, idle now.
    float* hand = reinterpret_cast<float*>(smem);
    named_sync(3, C::NC);
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hand[rows[e >> 1] * C::SP + n * 8 + 2 * t + (e & 1)] = db[n][e];
    }
    named_sync(3, C::NC);
    if (grp == 0) {
      float* plane = dbias + ((long long)part * H + h) * S * S;
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rows[e >> 1];
          const int col = n * 8 + 2 * t + (e & 1);
          if (row < S && col < S)
            plane[(long long)row * S + col] = db[n][e] + hand[row * C::SP + col];
        }
    }
  }
}

template <int NQ, int NTK, bool DBIAS>
cudaError_t launch(const CUtensorMap (&maps)[kOperands], const int* seg, const float* bias,
                   bf16* dqkv, float* dbias, int B, int S, int H, int P, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = chronos_bwd_short_kernel<NQ, NTK, DBIAS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<H * P, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], seg, bias,
                                                  dqkv, dbias, B, S, H, P);
  return cudaGetLastError();
}

template <int NQ, int NTK>
cudaError_t launch_db(bool db, const CUtensorMap (&maps)[kOperands], const int* seg,
                      const float* bias, bf16* dqkv, float* dbias, int B, int S, int H, int P,
                      cudaStream_t stream) {
  return db ? launch<NQ, NTK, true>(maps, seg, bias, dqkv, dbias, B, S, H, P, stream)
            : launch<NQ, NTK, false>(maps, seg, bias, dqkv, dbias, B, S, H, P, stream);
}

// Blocks an SM holds at once of the NQ instantiation (with dbias, the larger
// of the two), or 0 on an error.
template <int NQ>
int blocks_per_sm() {
  using C = Cfg<NQ>;
  auto* kernel = chronos_bwd_short_kernel<NQ, 2 * NQ, true>;
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
    default: return blocks_per_sm<5>();
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int mtt_chronos_route_override();

// Whether make_plan gives a bf16 backward at (S, D) this route: head_dim 64,
// S <= kShortTo; never under the route override (chronos_set_route) 1
// (mma.sync) or 3 (wgmma).
extern "C" int chronos_short_takes(int S, int D) {
  const int force = mtt_chronos_route_override();
  return D == kD && S >= 1 && S <= kShortTo && force != 1 && force != 3;
}

extern "C" int chronos_short_threads(int S) { return 32 * (kGroups * ((S + 15) / 16) + 1); }

// Blocks a head (the dbias partials, one a block): as many as fill the card
// once, at most B.
extern "C" int chronos_short_groups(int B, int S, int H) {
  static int cached[6] = {0, 0, 0, 0, 0, 0};
  const int nq = (S + 15) / 16;
  if (nq < 1 || nq > 5) return 1;
  if (cached[nq] == 0) cached[nq] = per_sm(nq);
  const int blocks = persistent_blocks(1 << 30) * (cached[nq] > 0 ? cached[nq] : 1);
  const int p = blocks / H;
  return p < 1 ? 1 : p > B ? B : p;
}

// qkv (B, S, 3*H*64), g (B, S, H*64) and dqkv (B, S, 3*H*64) bf16, contiguous
// and 16-byte aligned (refused otherwise); seg (B, S) int32; bias (H, S, S)
// fp32; dbias: null, or `groups` (= chronos_short_groups) (H, S, S) fp32
// planes, each the sum of dL over one block's range of batch rows (plane 0 is
// dbias itself when groups = 1). Launches on `stream`.
extern "C" int chronos_short_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                                 void* dqkv, void* dbias, int groups, int B, int S, int H,
                                 void* stream) {
  if (S < 1 || S > kShortTo || groups < 1) return (int)cudaErrorInvalidValue;
  if (!aligned(qkv) || !aligned(g) || !aligned(dqkv)) return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const long long hd = (long long)H * kD;
  const auto* base = static_cast<const bf16*>(qkv);
  CUtensorMap maps[kOperands];
  const void* bases[kOperands] = {base, base + hd, base + 2 * hd, g};
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err = encode_rows(&maps[o], bases[o], B, S, (int)hd, o == 3 ? hd : 3 * hd,
                                        kD, 16 * nq, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
  }
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  bf16* out = static_cast<bf16*>(dqkv);
  float* db = static_cast<float*>(dbias);
  const bool with = db != nullptr;
  const int P = groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nq) {
    case 1: err = launch_db<1, 2>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 2: err = launch_db<2, 4>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 3: err = launch_db<3, 6>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 4: err = launch_db<4, 8>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    default:
      err = S <= 72 ? launch_db<5, 9>(with, maps, sg, bs, out, db, B, S, H, P, st)
                    : launch_db<5, 10>(with, maps, sg, bs, out, db, B, S, H, P, st);
  }
  return (int)err;
}
