// Chronos-2 T5 attention forward (B4f), bf16, head_dim 64: the wgmma/TMA
// route for Hopper (sm_90a). chronos_attention.cu's make_plan (through
// chronos_common.cuh) gives it route 3 by the rule of chronos_hopper_takes
// below; its backward is chronos_attention_bwd_hopper.cu.
//
// Replaces, where the rule sends them here, the Pallas TPU kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel (B4f)
// The function is chronos_attention.cu's (its header): per (batch, head)
// L = Q K^T + bias[h] (q unscaled, bias (H, S, S) fp32), finfo(float32).min
// across segments, W = softmax(L) in fp32, O = W V accumulated in fp32 and
// cast once; q, k and v read in place from the (B, S, 3*H*64) projection.
//
// Design. One pass with an online softmax (FlashAttention-3's shape, as the
// causal route attention_fwd_hopper.cu): per row a running max m and sum s;
// each key tile's P = exp(l - m) is rounded to bf16 as the A operand of P V,
// the accumulator is rescaled when m moves, and the output divided by s once
// at the end. JAX rounds the normalised W = exp(l - m_final) / s instead;
// this route the unnormalised P (2^-9 relative per weight either way):
// tests/test_torch_port_chronos_hopper.py holds that order against JAX's
// kernel on the CPU, chip_smoke.py the kernel against the plain version on
// the card. Why one pass and not two passes over K and V held in shared
// memory per (batch row, head) (the order JAX rounds in): the one pass does
// half the products (Q K^T once, not twice), half the exponentials and half
// the reads of the bias, which sets the route's L2 traffic; the two-pass
// variant was not built, so the two were not timed against each other.
//
// Blocks are persistent, one per SM: a block takes work items of 128 query
// rows of one (batch row, head) in the zigzag order of hopper_common.cuh, the
// short last query tile of every (batch row, head) last. Two consumer
// warpgroups of 64 rows, and one producer warpgroup whose first thread keeps
// TMA loads of the 64-key K and V tiles in flight through a ring of kStages
// stages (full / empty mbarriers) across items, and loads each item's Q tiles
// into one of two buffers, so the next item's arrive while this one computes;
// setmaxnreg moves the producer's registers to the consumers. head_dim 64 is
// one 128-byte swizzle row, so each tile is one TMA box and one descriptor:
// S = Q K^T in four k-steps, O += P V at N = 64. Rows and keys past S come in
// as zeros (the maps are (B, S, H*64) boxes); keys past S add no term (-inf).
//
// The bias. Its rows are 4 S bytes apart (2,308 at S = 577), not a multiple
// of 16, so TMA cannot load it, and staging it through shared memory lost
// (chronos_attention.cu's header). Each consumer thread reads its 32 entries
// of a key tile (and the keys' segment ids) from L2 before the tile's
// product, every address clamped into the block so that no load waits on
// another (a first version that read the bias only where the segment ids
// allowed it made each read wait on an id's, and ran four times slower),
// folds the mask into them while the product runs, and adds them after it.
// Staging each batch row's segment ids in shared memory once per work item
// gained too little to keep.
// Each entry is read once per batch row (the mma.sync tiled route read it
// twice, once per pass). Work items of two batch rows applying each read to
// both were no faster at 577 tokens, and slower at 193 and 97.
//
// What bounds it on an H100: at 16 x 577 x 12 heads the least time is 0.0217
// ms of bytes (q, k, v, out and the bias once); the products need 0.0166 ms
// at the bf16 peak. The kernel's own limits are the bias reads (each warp
// load in the accumulator layout touches 8 L1 lines, one per row; 255 MB a
// launch at 16 x 577; a build without them ran markedly faster), one
// exponential per logit on the SFU, and the serial chain of a warpgroup's
// tile (Q K^T, softmax, P V); the two consumer warpgroups of an SM fill each
// other's gaps.
// 577 = 9 x 64 + 1: the last key tile and the last query tile hold one row
// each.

#include "chronos_hopper.cuh"

namespace {

using mtt::bf16;
using namespace mtt::hopper;
using namespace mtt::chronos_hopper;

constexpr int kStages = 4;
// Shared memory: two Q buffers (a 64-row tile per consumer in each),
// kStages x (K, V), then the mbarriers: q_full[2], q_empty[2], full[kStages],
// empty[kStages].
constexpr int kQBytes = kConsumers * kTile64;
constexpr int kStageBytes = 2 * kTile64;
constexpr int kRingOffset = 2 * kQBytes;
constexpr int kBarOffset = kRingOffset + kStages * kStageBytes;
constexpr int kSmem = kAlign + kBarOffset + 8 * (4 + 2 * kStages);

__global__ void __launch_bounds__(kThreads, 1)
    chronos_fwd_wgmma_kernel(const __grid_constant__ QkvMaps maps, const int* __restrict__ seg,
                             const float* __restrict__ bias, bf16* __restrict__ out, int B, int S,
                             int H, int pair_out) {
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

  const int nq = (S + kBlockRows - 1) / kBlockRows;
  const int nkt = (S + kRows - 1) / kRows;
  const int items = nq * B * H;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == kConsumers) {
    producer_regs();
    if (threadIdx.x != kConsumers * 128) return;
    int it = 0;  // the ring's tile count, across items
    for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
      const int i = item_index(n, gridDim.x);
      if (i >= items) continue;  // only the last round is short
      const Item w = item_at(i, B, H, nq, false);
      const int q0 = w.tile * kBlockRows;
      const int rb = n & 1;
      mbar_wait(q_empty + rb, ((n >> 1) & 1) ^ 1);
      // Only 64-row tiles that start before S; one wholly past S stays unread.
      const int nload = min(kConsumers, (S - q0 + kRows - 1) / kRows);
      mbar_expect_tx(q_full + rb, nload * kTile64);
      for (int c = 0; c < nload; ++c)
        load_tile64(smem + rb * kQBytes + c * kTile64, &maps.q, q_full + rb, w.h, q0 + c * kRows,
                    w.b);
      for (int j = 0; j < nkt; ++j, ++it) {
        const int st = it % kStages;
        mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        uint8_t* stage = smem + kRingOffset + st * kStageBytes;
        mbar_expect_tx(full + st, kStageBytes);
        load_tile64(stage, &maps.k, full + st, w.h, j * kRows, w.b);
        load_tile64(stage + kTile64, &maps.v, full + st, w.h, j * kRows, w.b);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [wq0, wq0 + 64) of each item.
  consumer_regs();
  const int warp = (threadIdx.x % 128) >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long hd = (long long)H * kDim64;
  int it = 0;
  for (int n = 0; n * (int)gridDim.x < items; ++n) {  // n: this block's round
    const int i = item_index(n, gridDim.x);
    if (i >= items) continue;  // only the last round is short
    const Item w = item_at(i, B, H, nq, false);
    const int wq0 = w.tile * kBlockRows + wg * kRows;
    const bool mine = wq0 < S;  // a tile wholly past S computes nothing
    const int rows[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    const int* seg_b = seg + (long long)w.b * S;
    const float* bias_h = bias + (long long)w.h * S * S;
    int sr[2];
    row_segments(sr, seg_b, rows, S);

    float m[2] = {-FLT_MAX, -FLT_MAX};
    float s[2] = {0.f, 0.f};  // this thread's share of the row sums
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    const int rb = n & 1;
    mbar_wait(q_full + rb, (n >> 1) & 1);
    const uint64_t qa = kmajor64(smem_u32(smem) + rb * kQBytes + wg * kTile64);

    for (int j = 0; j < nkt; ++j, ++it) {
      const int st = it % kStages;
      if (mine) {
        BiasTile bt;
        load_bias<false>(bt, bias_h, seg_b, rows, j * kRows, S, t);  // overlaps the wait and product
        mbar_wait(full + st, (it / kStages) & 1);
        const uint32_t stage = smem_u32(smem) + kRingOffset + st * kStageBytes;
        float sc[8][4];
        wgmma_fence();
        issue_abt64(sc, qa, kmajor64(stage));
        wgmma_commit();
        fold_mask<false>(bt, sr, rows, j * kRows, S, t);  // while the products run
        wgmma_wait();
        fence_regs(sc);
        add_bias(sc, bt);

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
            for (int c = 0; c < 8; ++c) {
              o[c][2 * r] *= scale;
              o[c][2 * r + 1] *= scale;
            }
          }
        }
        uint32_t p[4][4], unused[4][4];
        tile_frags<false>(sc, p, unused);
        wgmma_fence();
        issue_pb64(o, p, mnmajor64(stage + kTile64));
        wgmma_commit();
        wgmma_wait();
        fence_regs(o);
        fence_regs(p);
      } else {
        mbar_wait(full + st, (it / kStages) & 1);
      }
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (lane == 0) mbar_arrive(q_empty + rb);
    if (!mine) continue;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(s[r]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[c][0] *= inv[0];
      o[c][1] *= inv[0];
      o[c][2] *= inv[1];
      o[c][3] *= inv[1];
    }
    mtt::store_rows<8>(out + (long long)w.b * S * hd + (long long)w.h * kDim64, hd, o, rows[0], 0, S,
                       kDim64, pair_out, lane);
  }
}

int route_override = 0;

}  // namespace

// Route override for measuring the borders (chronos_set_route; chip_smoke.py's
// [gate] lines), numbered as the plan's routes (make_plan, chronos_common.cuh)
// where it forces one: 0 the rules, 1 bf16 never on this route or a
// persistent one (the mma.sync routes 1 and 2 by their own limits), 3 bf16 on
// this route at every S (head_dim 64) and never on a persistent one, 4 fp32
// never on a tensor-core route (route 0, the CUDA cores, at every head_dim;
// 4 is the bf16 persistent route's number, which has no override of its own,
// as the causal family's "cuda cores" takes its bf16 persistent route's), 5
// fp32 on route 5 (chronos_attention_tf32.cu) at every S, never on route 6 or
// 7, 6
// fp32 on route 6 (chronos_attention_short_tf32.cu,
// chronos_attention_bwd_short_tf32.cu) at every S it is built for, the rule's
// route 7 or 5 past that, 7 fp32 on route 7 (chronos_attention_tf32_hopper.cu,
// chronos_attention_bwd_tf32_hopper.cu) at every S, never on route 6. 4-7
// leave bf16 to the rule, 1 and 3 fp32. Process-wide.
extern "C" int chronos_set_route(int route) {
  if (route < 0 || route > 7 || route == 2) return (int)cudaErrorInvalidValue;
  route_override = route;
  return 0;
}
extern "C" int mtt_chronos_route_override() { return route_override; }

// Whether make_plan (chronos_common.cuh) gives a bf16 call at (S, D) this route:
// head_dim 64 and S from the measured borders, kFwdFrom forward, kBwdFrom
// backward. Backward: with the mma.sync routes (chip_smoke.py's Chronos [gate]
// lines: at B = 9,232 / S and 12 heads this route is the faster by more than
// 5% from S = 97, the one-pass route at S = 64 and 80). Forward: with the
// persistent route (chronos_attention_short_hopper.cu), the faster up to its
// last built length, 128 (its [gate] lines), so from 129. The
// layout rule (qkv and g 16-byte aligned, which every tensor PyTorch's
// allocator gives is; ops/_kernels.py copies one that is not) is the
// caller's: an unaligned call is refused.
constexpr int kFwdFrom = 129;
constexpr int kBwdFrom = 97;

extern "C" int chronos_hopper_takes(int backward, int S, int D) {
  if (route_override == 1 || D != kDim64) return 0;
  return route_override == 3 || S >= (backward ? kBwdFrom : kFwdFrom);
}

// qkv (B, S, 3*H*64) and out (B, S, H*64) bf16, contiguous, qkv 16-byte
// aligned; seg (B, S) int32; bias (H, S, S) fp32. Launches on `stream`.
extern "C" int chronos_hopper_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                  int B, int S, int H, void* stream) {
  if (!aligned16(qkv)) return (int)cudaErrorMisalignedAddress;
  QkvMaps maps;
  cudaError_t err = encode_qkv(&maps, qkv, B, S, H);
  if (err != cudaSuccess) return (int)err;
  static const cudaError_t regs = check_regs(chronos_fwd_wgmma_kernel, kThreads);
  if (regs != cudaSuccess) return (int)regs;
  err = cudaFuncSetAttribute(chronos_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return (int)err;
  const int pair_out = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int items = (S + kBlockRows - 1) / kBlockRows * B * H;
  chronos_fwd_wgmma_kernel<<<persistent_blocks(items), kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<const int*>(seg), static_cast<const float*>(bias), static_cast<bf16*>(out),
      B, S, H, pair_out);
  return (int)cudaGetLastError();
}
