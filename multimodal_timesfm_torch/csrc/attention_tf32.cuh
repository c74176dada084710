// Pieces of the fp32 tensor-core route (3xTF32 on mma.sync m16n8k8) of the
// causal attention kernels at head_dim 80 (attention_fwd_tf32.cu,
// attention_bwd_tf32.cu): the head_dim, the shared-row stride, the tile rule,
// the layout rule and the causal + key-padding mask on a warp's accumulator
// tile. The products, loaders and stores are tf32_common.cuh's templates,
// shared with the Chronos route. The design is in the header note of
// attention_fwd_tf32.cu.

#pragma once

#include "tf32_common.cuh"

namespace mtt::tf32::causal {

constexpr int kD = 80;          // the head_dim the route is built for (TimesFM's 16 x 80 heads)
constexpr int kLd = kD + 4;     // row stride of a shared tile (floats), 4 mod 8: every fragment
                                // load meets 32 distinct banks (tf32_common.cuh's note)
constexpr int kTile = 64;       // query and key rows a tile past kOneTileTo tokens
constexpr int kOneTileTo = 80;  // up to here one tile of S padded to 16 holds the whole row

// Query and key rows of a tile at S: S padded to 16 up to kOneTileTo, else kTile.
__host__ __device__ __forceinline__ int tile_rows(int S) {
  return S <= kOneTileTo ? (S + 15) / 16 * 16 : kTile;
}

// The layout rule of an operand read by 16-byte cp.async: its base 16-byte
// aligned and its row stride a multiple of 4 floats, so that every row starts
// 16-byte aligned.
inline bool rows16(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
}

// The layout rule of an output written 8 bytes a lane (store_tile): its base
// 8-byte aligned and its row stride even.
inline bool rows8(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0 && ld % 2 == 0;
}

// The causal and key-padding mask on a warp's accumulator tile of logits:
// rows rows[0] (g) and rows[1] (g + 8), keys k0 + c, c = 8 n + 2 t + (e & 1),
// key-valid flags vm[c]. A key at or past S gets -inf (no term); a key after
// the row or not valid gets finfo(float32).min (attention_fwd.cu's header).
template <int NT>
__device__ __forceinline__ void causal_mask(float sc[NT][4], const int rows[2], const uint8_t* vm,
                                            int k0, int S, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = n * 8 + 2 * t + (e & 1);
      const int col = k0 + c;
      if (col >= S) {
        sc[n][e] = -INFINITY;
      } else if (col > rows[e >> 1] || !vm[c]) {
        sc[n][e] = -FLT_MAX;
      }
    }
}

// vm[r] = valid_b[k0 + r] for r < n (0 past S), by plain loads and stores of
// the threads below n; the caller's barrier orders them.
__device__ __forceinline__ void load_valid(uint8_t* vm, const uint8_t* valid_b, int k0, int S,
                                           int n) {
  const int r = threadIdx.x;
  if (r < n) vm[r] = k0 + r < S ? valid_b[k0 + r] : 0;
}

}  // namespace mtt::tf32::causal
