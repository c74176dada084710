// Pieces shared by the Chronos-2 attention kernels' wgmma/TMA route
// (chronos_attention_hopper.cu: B4f; chronos_attention_bwd_hopper.cu: B4b):
// the block layout, the bias and segment mask of a 64 x 64 logit tile read
// ahead of its product, and the TMA maps of the fused (B, S, 3*H*64) qkv. The
// design is in the header note of chronos_attention_hopper.cu.

#pragma once

#include "hopper_common.cuh"

#include <math.h>

namespace mtt {
namespace chronos_hopper {

using namespace mtt::hopper;

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockRows = kRows * kConsumers;  // rows of a work item

// The bias and segment ids of a thread's entries of a 64 x 64 logit tile,
// read from device memory (L2) ahead of the product they are applied to:
// rows rows[r] of the (S, S) bias of one head, keys k0 + 8 j + 2 t + e (entry
// [j][2 r + e], the wgmma accumulator layout). Every address is clamped into
// the (S, S) block and no load waits on another, so the 48 loads of a tile
// are in flight together; fold_mask masks what lies past S. With TRANSPOSED
// the tile's rows are keys and its columns queries: entry [j][2 r + e] is the
// pair (query k0 + 8 j + 2 t + e, key rows[r]), read at bias[query][key].
struct BiasTile {
  float b[8][4];
  int seg[8][2];  // segment ids of the tile's columns
};
template <bool TRANSPOSED>
__device__ __forceinline__ void load_bias(BiasTile& bt, const float* __restrict__ bias_h,
                                          const int* __restrict__ seg_b, const int (&rows)[2],
                                          int k0, int S, int t) {
  long long rofs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rofs[r] = min(rows[r], S - 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = min(k0 + 8 * j + 2 * t + e, S - 1);
      bt.seg[j][e] = __ldg(seg_b + col);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bt.b[j][2 * r + e] = TRANSPOSED ? __ldg(bias_h + (long long)col * S + rofs[r])
                                        : __ldg(bias_h + rofs[r] * S + col);
    }
}

// Fold the mask into a loaded tile, while the tile's product runs: where the
// pair may attend the bias stays; where the segments differ it becomes
// finfo(float32).min, which absorbs any finite logit exactly (l + min = min
// for |l| below 2^103); a column at or past S (and, with TRANSPOSED, a row
// (key) at or past S: a zero weight; such rows are never stored) gets -inf.
// Then l = Q K^T + bias is one add (add_bias).
template <bool TRANSPOSED>
__device__ __forceinline__ void fold_mask(BiasTile& bt, const int (&sr)[2], const int (&rows)[2],
                                          int k0, int S, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool out = k0 + 8 * j + 2 * t + (e & 1) >= S || (TRANSPOSED && rows[r] >= S);
      const float x = bt.seg[j][e & 1] != sr[r] ? -FLT_MAX : bt.b[j][e];
      bt.b[j][e] = out ? -INFINITY : x;
    }
}
__device__ __forceinline__ void add_bias(float (&sc)[8][4], const BiasTile& bt) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] += bt.b[j][e];
}

// The segment ids of a thread's two rows (rows past S read row S - 1).
__device__ __forceinline__ void row_segments(int (&sr)[2], const int* __restrict__ seg_b,
                                             const int (&rows)[2], int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) sr[r] = __ldg(seg_b + min(rows[r], S - 1));
}

// The three maps of q, k and v, read in place from the (B, S, 3*H*64) qkv.
struct QkvMaps {
  CUtensorMap q, k, v;
};
inline cudaError_t encode_qkv(QkvMaps* m, const void* qkv, int B, int S, int H) {
  const long long hd = (long long)H * kDim64;
  const auto* base = static_cast<const bf16*>(qkv);
  cudaError_t err = encode_operand64(&m->q, base, B, S, H, 3 * hd);
  if (err == cudaSuccess) err = encode_operand64(&m->k, base + hd, B, S, H, 3 * hd);
  if (err == cudaSuccess) err = encode_operand64(&m->v, base + 2 * hd, B, S, H, 3 * hd);
  return err;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace chronos_hopper
}  // namespace mtt
