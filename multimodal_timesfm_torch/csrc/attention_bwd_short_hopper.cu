// Causal + key-padding attention backward, bf16, head_dim 80, short
// sequences: the one-pass persistent route for Hopper (sm_90a), taken by
// attention_bwd (attention_bwd.cu) ahead of its other routes by the rule of
// short_bwd_takes below.
//
// Replaces, where the rule sends them here (S <= kShortTo), the Pallas TPU
// kernel
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel :141 (B1b,
//       fused_qkv_causal_attention's VJP, through _bwd :292)
// and, at the same lengths, the whole-sequence entry point's backward
// (ops/attention.py _attn_bwd_kernel, B2b at the gate lengths). The function
// is the mma.sync route's (attention_bwd.cu's header): W = softmax(mask(Q
// K^T)) recomputed in fp32 and not rounded, dV = W^T G, dW = G V^T, dL = W o
// (dW - r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, accumulated in
// fp32, each output cast once. The mask is attention_common.cuh's: a
// causal-future or padded key gets finfo(float32).min, a key past S no term,
// and a query row with no valid key has uniform weights over all S keys.
//
// What bounds it on an H100: at B1b's main-path shape (256 x 16 tokens x 16
// heads x 80) the bytes, 73.4 MB (qkv and g read once, dqkv written once):
// 0.0219 ms at 3.35 TB/s; the products are about 1.2 GFLOP (about 1 us at the
// bf16 peak). The mma.sync route before it (two kernels) read q, k, v and g
// twice, K and V a third time, sent the row statistics through a device
// scratch, paid two launch ramps, overlapped nothing inside a block of one
// item, and stored 4-byte pairs.
//
// Design (hopper_short.cuh): one kernel. A work item is HPI heads of one
// batch row, all SP = S rounded up to 16 rows (HPI = 4, 2, 1 and 1 at SP = 16,
// 32, 48 and 64), one warp per 16 query rows of a head; the whole key row is
// one tile, so the row max and sum are exact before any exponential and no
// statistics leave the block. Phase A (a warp's 16 query rows against every
// key): S = Q K^T and dW = G V^T, the mask, W, r and dL in fp32 registers, W
// and dL (each a hi + lo bf16 pair) to the group's staging, dQ = dL K from
// registers. Phase B (the same warp's 16 keys against every query row): dV =
// W^T G and dK = dL^T Q from the staging's transposes. W as one bf16 value
// left dV outside BWD_TOL where its terms cancel (rows of few keys, as at 8
// tokens: tests/test_torch_port_short_backward.py), so dV takes the pair too. Every byte of qkv
// and g is read once, by TMA, straight from the fused (B, S, 3*H*80)
// projection (two boxes a head: 64 columns under the 128-byte swizzle, 16
// under the 32-byte one); dqkv is written once, as whole rows. Blocks are
// persistent: two consumer groups take alternate items and a producer warp
// keeps the next items' loads in flight through a ring of 4 stages (3 at
// 49-64 tokens). No
// atomics: two launches give bit-equal gradients.
//
// mma.sync and not wgmma: at 16 tokens a head's tile is 16 rows and wgmma
// takes 64; the products are about 1 us of the call in all. Nine warps a
// block leave a thread 168 registers (three warps an SM sub-partition); the
// lane index is made opaque to the compiler at each item, so that the
// swizzled addresses derived from it are recomputed rather than held across
// items (held, they spilled at 32 and 64 tokens).
//
// Measured (chip_smoke.py --kernel-times --root, one H100 80GB HBM3 at 700 W):
// 0.031 ms at 256 x 16 x 16 against the mma.sync route's 0.081, about 2.4
// TB/s; at 8 tokens (0.072 ms at 1,024 x 8) it is bound by its 4,096 work
// items of half-empty tiles, one after another in each group, not by bytes.
// Built up to 64 tokens: at 80 the ring's three stages and two groups'
// staging do not fit a block's shared memory; those lengths keep the other
// routes.

#include "hopper_short.cuh"

#include <math.h>

namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::hopper_short;

constexpr int kD = 80;     // head_dim of this route
constexpr int kNK = 5;     // k-steps of 16 over head_dim
constexpr int kNO = 10;    // 8-column blocks of an output row
constexpr int kOperands = 4;  // q, k, v, g
// The longest S this route takes: the longest it is built for, and the measured
// border (chip_smoke.py's [gate] lines: at B = 8,192 / S and 16 heads this
// route is the faster by more than 5% against the mma.sync route from S = 8 to
// 64, and against the wgmma route at 64).
constexpr int kShortTo = 64;

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of a head's tiles
  static constexpr int NT = SP / 8;   // 8-key blocks of a logit row
  static constexpr int HPI = NQ == 1 ? 4 : NQ == 2 ? 2 : 1;  // heads of a work item
  static constexpr int GW = NQ * HPI;                        // warps of a consumer group
  static constexpr int THREADS = 32 * (kGroups * GW + 1);
  static constexpr int TILE = (SP * 2 * kD + kAlign - 1) / kAlign * kAlign;  // a head's tile
  static constexpr int STAGE = kOperands * HPI * TILE;
  static constexpr int LDW = SP + 8;                        // staging row stride (bf16)
  static constexpr int STAGING = 4 * HPI * SP * LDW * 2;    // W and dL, hi and lo, of a group
  // Alignment slack, two groups' staging, the key-valid bytes of each stage, the barriers.
  static constexpr int FIXED =
      kAlign + kGroups * STAGING + kMaxStages * SP + 16 * kMaxStages + 8 * kGroups;
  static constexpr int STAGES = ring_stages(FIXED, STAGE);
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= kMinStages, "the ring does not fit");
};

template <int NQ>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    attention_bwd_short_kernel(const __grid_constant__ OperandMaps qm,
                               const __grid_constant__ OperandMaps km,
                               const __grid_constant__ OperandMaps vm,
                               const __grid_constant__ OperandMaps gm,
                               const uint8_t* __restrict__ valid, bf16* __restrict__ dq,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int H,
                               long long ld_out) {
  using C = Cfg<NQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  bf16* staging = reinterpret_cast<bf16*>(smem + C::STAGES * C::STAGE);
  uint8_t* vms = smem + C::STAGES * C::STAGE + kGroups * C::STAGING;  // STAGES x SP key-valid bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(vms + C::STAGES * C::SP);
  uint64_t* empty = full + C::STAGES;
  uint64_t* freed = empty + C::STAGES;  // a group's W and dL staging read by all its warps
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, C::GW);
    }
    for (int g = 0; g < kGroups; ++g) mbar_init(freed + g, C::GW);
    mbar_fence_init();
  }
  __syncthreads();
  const int hg = (H + C::HPI - 1) / C::HPI;  // work items a batch row
  const int items = B * hg;

  if (warp == kGroups * C::GW) {
    const auto maps = [&](int op) -> const OperandMaps& {
      return op == 0 ? qm : op == 1 ? km : op == 2 ? vm : gm;
    };
    produce_heads<kOperands, C::HPI, C::SP, C::TILE, C::STAGE, C::STAGES, false>(
        maps, smem, vms, full, empty, valid, S, H, items, lane);
    return;
  }

  // Consumers: group grp takes the block's items grp, grp + 2, ...; warp wi of
  // the group owns head slot hs, query rows (phase A) and keys (phase B)
  // r0..r0+15.
  const int grp = warp / C::GW;
  const int wi = warp - grp * C::GW;
  const int hs = wi / NQ;
  const int r0 = 16 * (wi - hs * NQ);
  bf16* wh = staging + grp * (C::STAGING / 2) + hs * C::SP * C::LDW;
  bf16* wl = wh + C::HPI * C::SP * C::LDW;
  bf16* dh = wl + C::HPI * C::SP * C::LDW;
  bf16* dl = dh + C::HPI * C::SP * C::LDW;
  int j = grp;
  for (int i = blockIdx.x + grp * gridDim.x; i < items; i += kGroups * gridDim.x, j += kGroups) {
    // The lane index, opaque to the compiler in each item, so that the
    // addresses derived from it are recomputed here and not held in registers
    // across items.
    int ln = lane;
    asm volatile("" : "+r"(ln));
    const int t = ln & 3;
    const int rows[2] = {r0 + (ln >> 2), r0 + (ln >> 2) + 8};
    const int st = j % C::STAGES;
    const int b = i / hg;
    const int h = (i - b * hg) * C::HPI + hs;
    const bool on = h < H;
    wait_row<C::STAGES, kGroups>(full, empty, j);
    const uint8_t* vk = vms + st * C::SP;
    const uint32_t sb = ring + st * C::STAGE;
    const Tile<kD> Qt(sb + (0 * C::HPI + hs) * C::TILE, C::SP);
    const Tile<kD> Kt(sb + (1 * C::HPI + hs) * C::TILE, C::SP);
    const Tile<kD> Vt(sb + (2 * C::HPI + hs) * C::TILE, C::SP);
    const Tile<kD> Gt(sb + (3 * C::HPI + hs) * C::TILE, C::SP);
    float acc[kNO][4];
    if (on) {
      // Phase A.
      float sc[C::NT][4], dw[C::NT][4];
      zero(sc);
      zero(dw);
      abt<kNK, C::NT>(sc, Qt, r0, Kt, ln);
      abt<kNK, C::NT>(dw, Gt, r0, Vt, ln);
#pragma unroll
      for (int n = 0; n < C::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          if (c >= S) {
            sc[n][e] = -INFINITY;
          } else if (c > rows[e >> 1] || !vk[c]) {
            sc[n][e] = -FLT_MAX;
          }
        }
      // The staging is free once every warp of the group read the previous item's.
      if (j >= kGroups) mbar_wait(freed + grp, ((j - grp) / kGroups - 1) & 1);
      softmax_dl<C::NT, C::LDW>(sc, dw, rows, wh, wl, dh, dl, ln);
      dq_rows<C::NT, kNO>(acc, sc, Kt, ln);
    }
    named_sync(1 + grp, 32 * C::GW);  // the group's W and dL staged; its K and V read
    if (on) {
      const long long head = (long long)b * S * ld_out + (long long)h * kD;
      put<kNO>(Vt, r0, acc, ln);
      __syncwarp();
      copy_rows<kD>(Vt, r0, dq + head, ld_out, S, ln);
      // Phase B: dV, then dK.
      float dkv[kNO][4];
      keys_pb<NQ, kNO, C::LDW>(dkv, wh, wl, Gt, r0, ln);
      __syncwarp();  // dQ's rows copied out before dV takes their place
      put<kNO>(Vt, r0, dkv, ln);
      __syncwarp();
      copy_rows<kD>(Vt, r0, dv + head, ld_out, S, ln);
      keys_pb<NQ, kNO, C::LDW>(dkv, dh, dl, Qt, r0, ln);
      __syncwarp();
      if (lane == 0) mbar_arrive(freed + grp);  // this warp's last read of the staging
      put<kNO>(Kt, r0, dkv, ln);
      __syncwarp();
      copy_rows<kD>(Kt, r0, dk + head, ld_out, S, ln);
    } else if (lane == 0) {
      mbar_arrive(freed + grp);
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
}

template <int NQ>
cudaError_t launch(const OperandMaps (&maps)[kOperands], const uint8_t* valid, bf16* dq, bf16* dk,
                   bf16* dv, int B, int S, int H, long long ld_out, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = attention_bwd_short_kernel<NQ>;
  int blocks = 0;
  const cudaError_t err =
      grid_size(kernel, C::THREADS, C::SMEM, B * ((H + C::HPI - 1) / C::HPI), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], valid, dq,
                                                   dk, dv, B, S, H, ld_out);
  return cudaGetLastError();
}

}  // namespace

// Whether attention_bwd takes this route for (S, D): bf16 (the caller's
// check), head_dim 80, S <= kShortTo; never under the route override
// (attention_set_route) 1 (mma.sync) or 2 (wgmma); by the rule under 3 (an
// fp32 override).
extern "C" int mtt_attention_route_override();

extern "C" int short_bwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  return D == kD && S >= 1 && S <= kShortTo && force != 1 && force != 2;
}

// The layout this route reads and writes: q, k, v and g by TMA (rows and
// bases 16-byte aligned), dq, dk and dv in whole 16-byte chunks (the same).
extern "C" int short_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                                const void* dq, const void* dk, const void* dv, long long ld_in,
                                long long ld_g, long long ld_out) {
  return tma_layout(q, ld_in, kD) && tma_layout(k, ld_in, kD) && tma_layout(v, ld_in, kD) &&
         tma_layout(g, ld_g, kD) && tma_layout(dq, ld_out, kD) && tma_layout(dk, ld_out, kD) &&
         tma_layout(dv, ld_out, kD);
}

// cfg as attention_bwd_config's: {route 3, threads, query rows of a head per
// work item (every row), keys per tile (every key), heads per work item,
// padded head_dim, output columns per block, dL as hi + lo}.
extern "C" void short_bwd_config(int S, int* cfg) {
  const int nq = (S + 15) / 16;
  const int hpi = nq == 1 ? 4 : nq == 2 ? 2 : 1;
  const int c[8] = {3, 32 * (kGroups * nq * hpi + 1), 16 * nq, 16 * nq, hpi, kD, kD, 1};
  for (int i = 0; i < 8; ++i) cfg[i] = c[i];
}

// As attention_bwd's arguments, without the statistics scratch: q, k, v
// (B, S, H, 80) views with row stride ld_in, g with ld_g, dq, dk, dv with
// ld_out, all bf16 and 16-byte aligned (refused otherwise). Launches on
// `stream`.
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                   const void* g, void* dq, void* dk, void* dv, int B, int S, int H,
                                   long long ld_in, long long ld_g, long long ld_out,
                                   void* stream) {
  if (S < 1 || S > kShortTo) return (int)cudaErrorInvalidValue;
  if (!short_bwd_layout(q, k, v, g, dq, dk, dv, ld_in, ld_g, ld_out))
    return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const int rows = 16 * nq;
  OperandMaps maps[kOperands];
  const void* bases[kOperands] = {q, k, v, g};
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err = encode_head_maps(&maps[o], bases[o], B, S, H, o == 3 ? ld_g : ld_in, rows);
    if (err != cudaSuccess) return (int)err;
  }
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  bf16 *dqp = static_cast<bf16*>(dq), *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 1: return (int)launch<1>(maps, vm, dqp, dkp, dvp, B, S, H, ld_out, st);
    case 2: return (int)launch<2>(maps, vm, dqp, dkp, dvp, B, S, H, ld_out, st);
    case 3: return (int)launch<3>(maps, vm, dqp, dkp, dvp, B, S, H, ld_out, st);
    default: return (int)launch<4>(maps, vm, dqp, dkp, dvp, B, S, H, ld_out, st);
  }
}
