// Causal + key-padding attention forward, bf16, head_dim 80, short
// sequences: the one-pass persistent route for Hopper (sm_90a), taken by
// attention_fwd (attention_fwd.cu) ahead of its other routes by the rule of
// short_fwd_takes below.
//
// Replaces, where the rule sends them here (S <= kShortFwdTo), the Pallas TPU
// kernel
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel :111 (B1f,
//       fused_qkv_causal_attention, pallas_call :233)
// and, at the same lengths, the whole-sequence entry point's forward
// (ops/attention.py _attn_fwd_kernel, B2f, where the dispatch sends a short
// S there). The function is attention_fwd.cu's (its header): per (batch
// row, head) L = Q K^T in fp32 with q pre-scaled, mask = (col <= row) &
// valid[col], a masked logit at finfo(float32).min (a query row with no valid
// key gets uniform weights over all S keys), keys past S no term, W = exp(l -
// m) / s with the exact row max and sum, the normalised W rounded to bf16 as
// JAX rounds it (w.astype(v.dtype)), O = bf16(W) V summed in fp32 and cast
// once.
//
// What bounds it on an H100: at B1f's shapes the bytes. At 64 x 16 tokens x
// 16 heads x 80 (TimesFM serving at context 512) qkv is read once (7.86 MB)
// and the output written once (2.62 MB): 0.0031 ms at 3.35 TB/s; at 256 x 16
// (the c512 fine-tune's forward) 0.0125 ms, and at 64 x 64 (serving at
// context 2048) 0.0125 ms. The products are about 0.1-0.5 GFLOP, under a
// microsecond on mma.sync. The mma.sync route before it (attention_fwd.cu)
// took two passes over the key tiles (the row statistics, then Q K^T again
// and W V), loaded by per-thread cp.async into a ring of two
// slots, and ran one short-lived block per (query tile, 4 / QW heads, batch
// row): at 16 tokens a head's keys are one 16-row tile, so the first pass was
// pure overhead and each block's start, its loads before any product, was
// exposed.
//
// Design (hopper_short.cuh): one kernel of persistent blocks sized to the
// card (as many as an SM's shared memory holds: 4 at SP = 16, 2 at 32, 1 at
// 48 and 64). A
// work item is one head of one batch row, all SP = S rounded up to 16 rows,
// one warp per 16 query rows; two consumer groups take alternate items of the
// block. A producer warp (produce_heads, shared with B1b) keeps the next
// items' tiles in flight through a ring of up to 6 stages (as many as fit: 6
// at every SP), each head's q, k and v
// as two TMA boxes (64 columns under the 128-byte
// swizzle, 16 under the 32-byte one) read in place from the fused (B, S,
// 3*H*80) projection or from split (B, S, H, 80) tensors, rows past S as
// zeros; the item's key-valid bytes go into the stage as the side input, read
// a row ahead into the producer's registers. Per item a warp takes its 16
// query rows against the whole key row: L = Q K^T on mma.sync m16n8k16
// (ldmatrix with the swizzle undone), the causal and key-valid mask, the exact
// row max and sum in registers (no online rescaling, no second pass), W =
// exp(l - m) / s rounded to bf16 in the registers as the A operand of W V (V
// by ldmatrix.trans); nothing is staged. The output is rounded once into the
// warp's own 16 rows of the Q tile, which only this warp reads, and written
// to device memory as whole rows, 16 bytes a lane. No atomics: two launches
// give bit-equal outputs.
//
// The work item: one head of one batch row. Its measured alternative was
// B1b's HPI heads of one batch row (HPI = 4, 2, 1 and 1 at SP = 16, 32, 48
// and 64; B4f's one head and a range of batch rows a block has no per-head
// side input to share here, so it reduces to one head an item). At 16 tokens
// one head an item gives 3-warp blocks of a 9 KB stage, four an SM; HPI = 4
// gave 9-warp blocks, one an SM, whose producer issued 24 boxes an item.
// Measured in turns in two calls on one H100 80GB HBM3 at 700 W (held device
// ms, chip_smoke.py --kernel-times against a library built with HPI heads an
// item), the two were within the spread of two identical builds: one head
// an item read 0.92x and 1.02x HPI heads' time at 64 x 16 x 16 (0.0051 /
// 0.0055 against 0.0056 / 0.0058 ms; 0.0074 / 0.0054 against 0.0064 /
// 0.0062), 0.99x and 1.03x at 256 x 16, while at 64 x 64, where both builds
// were the same code (HPI = 1), the readings differed by 1% and 5%. One head
// an item was kept: its blocks hold no idle head slots when H is not a
// multiple of HPI, and it is the simpler kernel.
//
// Measured against the routes the rule gave these lengths before it, in
// turns (chip_smoke.py --kernel-times --root, held device ms, one H100 80GB
// HBM3 at 700 W): 64 x 16 x 16 0.0053 / 0.0056 against mma.sync's 0.0095 /
// 0.0097 (bound 0.0031: at 1,024 items on 528 blocks each block's first load
// and chain are exposed); 256 x 16 0.0155 / 0.0151 against 0.0254 / 0.0268
// (bound 0.0125, 0.8 of it); 64 x 64 0.0164 / 0.0164 against the wgmma
// route's 0.0275 / 0.0275 (bound 0.0125).
//
// mma.sync and not wgmma: at 16 tokens a head's tile is 16 rows and wgmma
// takes 64 (B1b's reason); the products are a small part of the call.
// A warp computes its rows against every key of the tile, the causal future
// included: a row with no valid key needs them (uniform weights over all S
// keys), and the products are not what bounds the call.

#include "hopper_short.cuh"

#include <math.h>

namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::hopper_short;

constexpr int kD = 80;         // head_dim of this route
constexpr int kNK = 5;         // k-steps of 16 over head_dim
constexpr int kNO = 10;        // 8-column blocks of an output row
constexpr int kOperands = 3;   // q, k, v
constexpr int kStagesMax = 6;  // stages of the TMA ring, at most (as many as fit)
// The longest S this route is built for and the rule gives it: it is the
// faster by more than 5% at every length measured up to it (chip_smoke.py's
// [gate] B1f persistent lines: 16 heads, B = 8,192 / S, against the mma.sync
// route at S = 8-64 and the wgmma route at 64), so the wgmma route's kFwdFrom
// is the next length.
constexpr int kShortFwdTo = 64;

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of a head's tiles = keys of a logit row
  static constexpr int NT = SP / 8;   // 8-key blocks of a logit row
  static constexpr int GW = NQ;       // warps of a consumer group
  static constexpr int THREADS = 32 * (kGroups * GW + 1);
  static constexpr int TILE = (SP * 2 * kD + kAlign - 1) / kAlign * kAlign;  // a head's tile
  static constexpr int STAGE = kOperands * TILE;
  // Beside the ring: the alignment slack, each stage's key-valid bytes, the barriers.
  static constexpr int FIXED = kAlign + kStagesMax * SP + 16 * kStagesMax;
  static constexpr int STAGES = ring_stages(FIXED, STAGE, kStagesMax);
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= kMinStages, "the ring does not fit");
};

template <int NQ>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    attention_fwd_short_kernel(const __grid_constant__ OperandMaps qm,
                               const __grid_constant__ OperandMaps km,
                               const __grid_constant__ OperandMaps vm,
                               const uint8_t* __restrict__ valid, bf16* __restrict__ out, int B,
                               int S, int H, long long ld_out) {
  using C = Cfg<NQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  uint8_t* vms = smem + C::STAGES * C::STAGE;  // STAGES x SP key-valid bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(vms + kStagesMax * C::SP);
  uint64_t* empty = full + C::STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, C::GW);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int items = B * H;  // item i: head i % H of batch row i / H

  if (warp == kGroups * C::GW) {
    const auto maps = [&](int op) -> const OperandMaps& { return op == 0 ? qm : op == 1 ? km : vm; };
    produce_heads<kOperands, 1, C::SP, C::TILE, C::STAGE, C::STAGES, true>(
        maps, smem, vms, full, empty, valid, S, H, items, lane);
    return;
  }

  // Consumers: group grp takes the block's items grp, grp + 2, ...; warp wi of
  // the group owns query rows r0..r0+15.
  const int grp = warp / C::GW;
  const int r0 = 16 * (warp - grp * C::GW);
  const int t = lane & 3;
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  int j = grp;
  for (int i = blockIdx.x + grp * gridDim.x; i < items; i += kGroups * gridDim.x, j += kGroups) {
    const int st = j % C::STAGES;
    const int b = i / H;
    const int h = i - b * H;
    wait_row<C::STAGES, kGroups>(full, empty, j);
    const uint8_t* vk = vms + st * C::SP;
    const uint32_t sb = ring + st * C::STAGE;
    const Tile<kD> Qt(sb, C::SP);
    const Tile<kD> Kt(sb + C::TILE, C::SP);
    const Tile<kD> Vt(sb + 2 * C::TILE, C::SP);
    float sc[C::NT][4];
    zero(sc);
    abt<kNK, C::NT>(sc, Qt, r0, Kt, lane);
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int c = n * 8 + 2 * t;
      const uint16_t pair = *reinterpret_cast<const uint16_t*>(vk + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c + (e & 1);
        if (col >= S) {
          sc[n][e] = -INFINITY;
        } else if (col > rows[e >> 1] || !((pair >> (8 * (e & 1))) & 0xff)) {
          sc[n][e] = -FLT_MAX;
        }
      }
    }
    softmax_row(sc, 0);
    softmax_row(sc, 1);
    // O = bf16(W) V: W's 16-key blocks packed as A fragments first, so that
    // the fp32 W is not live beside the accumulators.
    constexpr int KS = C::NT / 2;
    uint32_t wa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t unused[4];
      mtt::a_frags<false>(sc[2 * kk], sc[2 * kk + 1], wa[kk], unused);
    }
    float acc[kNO][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) pb<kNO, false>(acc, wa[kk], wa[kk], Vt, kk * 16, lane);
    __syncwarp();  // the warp's reads of its Q rows done before O takes their place
    put<kNO>(Qt, r0, acc, lane);
    __syncwarp();
    copy_rows<kD>(Qt, r0, out + (long long)b * S * ld_out + (long long)h * kD, ld_out, S, lane);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
}

template <int NQ>
cudaError_t launch(const OperandMaps (&maps)[kOperands], const uint8_t* valid, bf16* out, int B,
                   int S, int H, long long ld_out, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = attention_fwd_short_kernel<NQ>;
  int blocks = 0;
  const cudaError_t err =
      grid_size(kernel, C::THREADS, C::SMEM, B * H, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], valid, out, B, S, H,
                                                   ld_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mtt_attention_route_override();

// Whether attention_fwd takes this route for (S, D): bf16 (the caller's
// check), head_dim 80, S <= kShortFwdTo; never under the route override
// (attention_set_route) 1 (mma.sync) or 2 (wgmma); by the rule under 3 (an
// fp32 override).
extern "C" int short_fwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  return D == kD && S >= 1 && S <= kShortFwdTo && force != 1 && force != 2;
}

// The layout this route reads and writes: q, k and v by TMA (rows and bases
// 16-byte aligned), out in whole 16-byte chunks (the same).
extern "C" int short_fwd_layout(const void* q, const void* k, const void* v, const void* out,
                                long long ld_in, long long ld_out) {
  return tma_layout(q, ld_in, kD) && tma_layout(k, ld_in, kD) && tma_layout(v, ld_in, kD) &&
         tma_layout(out, ld_out, kD);
}

// cfg as attention_fwd_config's: {route 3, threads, query rows of a head per
// work item (every row), keys per tile (every key), heads per work item,
// padded head_dim, output columns per block}.
extern "C" void short_fwd_config(int S, int* cfg) {
  const int nq = (S + 15) / 16;
  const int c[7] = {3, 32 * (kGroups * nq + 1), 16 * nq, 16 * nq, 1, kD, kD};
  for (int i = 0; i < 7; ++i) cfg[i] = c[i];
}

// As attention_fwd's arguments at bf16 and head_dim 80: q, k, v (B, S, H, 80)
// views with row stride ld_in, out with ld_out, all 16-byte aligned (refused
// otherwise), 1 <= S <= kShortFwdTo. Launches on `stream`.
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int B, int S, int H, long long ld_in,
                                   long long ld_out, void* stream) {
  if (B <= 0 || H <= 0 || S < 1 || S > kShortFwdTo) return (int)cudaErrorInvalidValue;
  if (!short_fwd_layout(q, k, v, out, ld_in, ld_out)) return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const int rows = 16 * nq;
  OperandMaps maps[kOperands];
  const void* bases[kOperands] = {q, k, v};
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err = encode_head_maps(&maps[o], bases[o], B, S, H, ld_in, rows);
    if (err != cudaSuccess) return (int)err;
  }
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 1: return (int)launch<1>(maps, vm, o, B, S, H, ld_out, st);
    case 2: return (int)launch<2>(maps, vm, o, B, S, H, ld_out, st);
    case 3: return (int)launch<3>(maps, vm, o, B, S, H, ld_out, st);
    default: return (int)launch<4>(maps, vm, o, B, S, H, ld_out, st);
  }
}
