// Causal + key-padding attention forward, bf16, head_dim 80: the wgmma/TMA
// route for Hopper (sm_90a), taken by attention_fwd (attention_fwd.cu) by the
// rule of hopper_fwd_takes below.
//
// Replaces, where the rule sends them here (from 65 tokens), the Pallas TPU
// kernels
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _fwd_kernel
//       (fused_qkv_causal_attention, B1f, read in place from the fused qkv)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_fwd_kernel
//       (fused_causal_attention, B2f)
// and the forward of the library flash kernel that
//   multimodal_timesfm_tpu/ops/attention.py      flash_causal_attention
// wraps past 2,048 tokens (B3f). The function is the mma.sync route's
// (attention_fwd.cu's header): softmax(mask(Q K^T)) V per (batch, head), q
// pre-scaled, a masked logit at finfo(float32).min so a query row with no
// valid key gets uniform weights over all S keys, logits and softmax in fp32,
// products accumulated in fp32, the output written once in bf16.
//
// Design (FlashAttention-3's shape). One pass with an online softmax: per
// row a running max m and sum s; each key tile's P = exp(l - m) is rounded to
// bf16 as the A operand of P V, the accumulator is rescaled when m moves,
// and the output divided by s once at the end. Where this rounds differs from
// JAX: JAX rounds the normalised weights W = exp(l - m_final) / s to bf16,
// this route the unnormalised P = exp(l - m_running) (2^-9 relative per
// weight either way; tests/test_torch_port_attention_hopper.py holds that
// order against JAX on the CPU, chip_smoke.py the kernel against the plain
// version on the card). Blocks are persistent, one per SM: a block takes
// work items of 128 query rows of one (batch, head) in the zigzag order of
// hopper_common.cuh, the longest key walks first. Two consumer warpgroups of 64 rows, and one producer
// warpgroup whose first thread keeps TMA loads of the 64-key K and V tiles
// in flight through a ring of kStages stages (full / empty mbarriers) across
// items, and loads each item's Q tile into one of two buffers, so the next
// item's tiles arrive while this one computes; setmaxnreg moves the
// producer's registers to the consumers. Per key tile a consumer warpgroup
// runs S = Q K^T (wgmma, both operands from shared memory, K-major) and
// O += P V (wgmma, P from registers cast in place, V MN-major). head_dim 80 is a 160-byte row: each tile is a
// 128-byte-swizzled block of 64 columns and a 32-byte-swizzled block of 16
// (hopper_common.cuh), so Q K^T takes four k-steps and one, and P V runs
// N = 64 and N = 16. The key tiles follow the skip rule of
// attention_common.cuh for the block's 128 rows, and each warpgroup computes
// only those its own 64 rows need; the longest query tiles go first; a key
// tile that no mask touches for a warp's rows skips the mask.
//
// What bounds it on an H100: at the main-path shapes (B2f 8 x 512, B3f 2 x
// 2,100, 16 x 80 heads) the least time is 0.0125 ms of bytes and 0.0156 ms of
// operations; the kernel's own limits are the exponentials on the SFU (one
// per logit) and the serial chain of a warpgroup's tile (Q K^T, softmax,
// P V); the two consumer warpgroups of an SM fill each other's gaps (a
// version that kept P V in flight across the next tile's Q K^T was no
// faster, and held more registers).

#include "hopper_common.cuh"

#include <math.h>

namespace {

using mtt::bf16;
using namespace mtt::hopper;

constexpr int kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRows * kConsumers;  // query rows of a work item
// Shared memory: two Q buffers (a 64-row tile per consumer in each, so the
// next work item's Q loads while this one computes), kStages x (K, V), then
// the mbarriers: q_full[2], q_empty[2], full[kStages], empty[kStages].
constexpr int kQBytes = kConsumers * kTile;
constexpr int kStageBytes = 2 * kTile;
constexpr int kRingOffset = 2 * kQBytes;
constexpr int kBarOffset = kRingOffset + kStages * kStageBytes;
constexpr int kSmem = kAlign + kBarOffset + 8 * (4 + 2 * kStages);

__global__ void __launch_bounds__(kThreads, 1)
    attention_fwd_wgmma_kernel(const __grid_constant__ OperandMaps qm,
                               const __grid_constant__ OperandMaps km,
                               const __grid_constant__ OperandMaps vm,
                               const uint8_t* __restrict__ valid, bf16* __restrict__ out, int B,
                               int S, int H, long long ld_out, int pair_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, kConsumers * kWarpsPerGroup);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers * kWarpsPerGroup);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Work item: 128 query rows of one (batch row, head), the longest key walks first.
  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int items = nq * B * H;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == kConsumers) {
    // Producer: its first warp finds each item's key tiles, its first thread loads them.
    producer_regs();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    int it = 0;  // the ring's tile count, across items
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nq, true);
      const int q0 = w.tile * kBlockRows;
      const int qlast = min(q0 + kBlockRows, S) - 1;
      int kt0, nkt;
      mtt::key_tiles(q0, qlast, warp_first_valid(valid + (long long)w.b * S, qlast + 1), S, kRows,
                     &kt0, &nkt);
      if (lane == 0) {
        const int rb = n & 1;
        mbar_wait(q_empty + rb, ((n >> 1) & 1) ^ 1);
        // Only 64-row tiles that start before S; one wholly past S stays unread.
        const int nload = min(kConsumers, (S - q0 + kRows - 1) / kRows);
        mbar_expect_tx(q_full + rb, nload * kTile);
        for (int c = 0; c < nload; ++c)
          load_tile(smem + rb * kQBytes + c * kTile, qm, q_full + rb, w.h, q0 + c * kRows, w.b);
        for (int j = 0; j < nkt; ++j, ++it) {
          const int st = it % kStages;
          mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
          uint8_t* stage = smem + kRingOffset + st * kStageBytes;
          mbar_expect_tx(full + st, kStageBytes);
          const int k0 = (kt0 + j) * kRows;
          load_tile(stage, km, full + st, w.h, k0, w.b);
          load_tile(stage + kTile, vm, full + st, w.h, k0, w.b);
        }
      }
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroup wg: query rows [wq0, wq0 + 64) of each item.
  consumer_regs();
  const int ct = threadIdx.x % 128;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nq, true);
    const int q0 = w.tile * kBlockRows;
    const int qlast = min(q0 + kBlockRows, S) - 1;
    const uint8_t* vb = valid + (long long)w.b * S;
    const int f = warp_first_valid(vb, qlast + 1);
    int kt0, nkt;
    mtt::key_tiles(q0, qlast, f, S, kRows, &kt0, &nkt);
    const int wq0 = q0 + wg * kRows;
    int wkt0 = 0, wnkt = 0;
    if (wq0 < S) mtt::key_tiles(wq0, min(wq0 + kRows, S) - 1, f, S, kRows, &wkt0, &wnkt);
    const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};

    float m[2] = {-FLT_MAX, -FLT_MAX};
    float s[2] = {0.f, 0.f};  // this thread's share of the row sums
    float o[10][4];
#pragma unroll
    for (int j = 0; j < 10; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    const int rb = n & 1;
    mbar_wait(q_full + rb, (n >> 1) & 1);
    const KMajor qa(smem_u32(smem) + rb * kQBytes + wg * kTile, 0);

    for (int j = 0; j < nkt; ++j, ++it) {
      const int st = it % kStages;
      mbar_wait(full + st, (it / kStages) & 1);
      const int kt = kt0 + j;
      if (kt >= wkt0 && kt < wkt0 + wnkt) {
        const uint32_t stage = smem_u32(smem) + kRingOffset + st * kStageBytes;
        const int k0 = kt * kRows;
        const bool unmasked = warp_unmasked(vb, k0, wq0 + warp * 16, S, lane);  // overlaps the product
        float sc[8][4];
        wgmma_fence();
        issue_abt(sc, qa, KMajor(stage, 0));
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        if (!unmasked) mask_tile(sc, vb, k0, rows, S, t);

        // Online softmax over the quad that holds each row; P in place of S.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(sc[c][2 * r], sc[c][2 * r + 1]));
          const float nm = fmaxf(m[r], quad_max(mx));
          const float scale = mtt::fast_exp(m[r] - nm);
          m[r] = nm;
          float ps = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
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
        uint32_t p[4][4], unused[4][4];
        tile_frags<false>(sc, p, unused);
        wgmma_fence();
        issue_pb(o, p, MNMajor(stage + kTile));
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
        fence_regs(p);
      }
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (lane == 0) mbar_arrive(q_empty + rb);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(s[r]);
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      o[c][0] *= inv[0];
      o[c][1] *= inv[0];
      o[c][2] *= inv[1];
      o[c][3] *= inv[1];
    }
    mtt::store_rows<10>(out + (long long)w.b * S * ld_out + (long long)w.h * kDim, ld_out, o,
                        rows[0], 0, S, kDim, pair_out, lane);
  }
}

}  // namespace

// Whether attention_fwd takes this route for (S, D) and this layout: bf16,
// head_dim 80, S >= kFwdFrom, and q, k, v readable by TMA (rows and bases
// 16-byte aligned). kFwdFrom is the length after the persistent route's
// kShortFwdTo (attention_fwd_short_hopper.cu, which attention_fwd checks
// first), the border chip_smoke.py's [gate] B1f persistent lines measure.
// Route override (attention_set_route): 1 never, 2 from any S.
constexpr int kFwdFrom = 65;
extern "C" int mtt_attention_route_override();

extern "C" int hopper_fwd_takes(int S, int D) {
  const int force = mtt_attention_route_override();
  if (force == 1 || D != kDim) return 0;
  return force == 2 || S >= kFwdFrom;
}

extern "C" int hopper_fwd_layout(const void* q, const void* k, const void* v, long long ld_in) {
  return tma_layout(q, ld_in, kDim) && tma_layout(k, ld_in, kDim) && tma_layout(v, ld_in, kDim);
}

// cfg as attention_fwd_config's: {route 2, threads, query rows per block,
// keys per tile, heads per block, padded head_dim, output columns per block}.
extern "C" void hopper_fwd_config(int* cfg) {
  const int c[7] = {2, kThreads, kBlockRows, kRows, 1, kDim, kDim};
  for (int i = 0; i < 7; ++i) cfg[i] = c[i];
}

extern "C" int hopper_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int S, int H,
                                    long long ld_in, long long ld_out, void* stream) {
  OperandMaps qm, km, vm;
  cudaError_t err = encode_operand(&qm, q, B, S, H, ld_in);
  if (err == cudaSuccess) err = encode_operand(&km, k, B, S, H, ld_in);
  if (err == cudaSuccess) err = encode_operand(&vm, v, B, S, H, ld_in);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t regs = check_regs(attention_fwd_wgmma_kernel, kThreads);
  if (regs != cudaSuccess) return (int)regs;
  err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return (int)err;
  const int pair_out = ld_out % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int items = (S + kBlockRows - 1) / kBlockRows * B * H;
  attention_fwd_wgmma_kernel<<<persistent_blocks(items), kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const uint8_t*>(valid), static_cast<bf16*>(out), B, S, H, ld_out,
      pair_out);
  return (int)cudaGetLastError();
}
