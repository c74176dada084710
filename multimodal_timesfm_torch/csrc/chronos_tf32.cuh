// Pieces of the fp32 tensor-core route of the Chronos-2 attention kernels
// (chronos_attention_tf32.cu, chronos_attention_bwd_tf32.cu) at head_dim 64:
// the head_dim, the shared-row stride and the tile rule. The 3xTF32 split and
// products, the fragment loaders, the warp tile products and the tile loader
// are tf32_common.cuh's templates, which the causal route shares. The design
// is in the header note of chronos_attention_tf32.cu.

#pragma once

#include "chronos_common.cuh"
#include "tf32_common.cuh"

namespace mtt::tf32 {

constexpr int kD = 64;          // the head_dim the route is built for
constexpr int kLd = kD + 4;     // row stride of a shared tile (floats): every fragment load
                                // meets 32 distinct banks (tf32_common.cuh's note)
constexpr int kTile = 64;       // query and key rows a tile past kOneTileTo tokens
constexpr int kOneTileTo = 80;  // up to here one tile of S padded to 16 holds the whole row

// Query and key rows of a tile at S: S padded to 16 up to kOneTileTo, else kTile.
__host__ __device__ __forceinline__ int tile_rows(int S) {
  return S <= kOneTileTo ? (S + 15) / 16 * 16 : kTile;
}

}  // namespace mtt::tf32
