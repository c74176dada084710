// Pieces of route 7 of the Chronos-2 kernels, fp32 at head_dim 64 on Hopper's
// warpgroup products (chronos_attention_tf32_hopper.cu: B4f;
// chronos_attention_bwd_tf32_hopper.cu: B4b): the tiles' layouts in shared
// memory at head_dim 64, the transposes, the 3xTF32 products, the bias and
// segment mask of a 64 x 32 logit tile, and the tensor maps of the fused
// (B, S, 3*H*64) qkv. The split into TF32 hi and lo (lo_bits, convert_lo),
// the A fragments of an accumulator (acc_frags) and the proxy fence are route
// 5's (attention_tf32_hopper.cuh, whose header note gives the arithmetic); the
// wgmma forms and the TMA loads are hopper_common.cuh's.
//
// Tiles. A row of 64 fp32 values is 256 bytes, two 128-byte swizzle rows, so
// TMA writes an R x 64 tile (R = 64 resident rows, 32 streamed) as two
// blocks, columns 0-31 and 32-63 (R x 128 bytes each, 128-byte swizzle, one
// box each): the K-major layout wgmma reads, k-steps 0-3 in the first block
// and 4-7 in the second (eight k-steps of 8 over the head_dim; no third block
// as at head_dim 80). A lo twin has the same layout.
//
// The transposed operands. In P X (W V in the forward; dL K, W^T G, dL^T Q in
// the backward) the k dimension is X's rows, and wgmma takes TF32 B only
// K-major, so the converting warps write X^T (64 rows of 32 columns: one
// 128-byte-swizzled block of 64 x 128 bytes) as hi and lo, each group of 8
// positions holding X's rows in the order 0, 2, 4, 6, 1, 3, 5, 7: the order in
// which an accumulator's thread holds a k-step's columns (2t as k = t, 2t + 1
// as k = t + 4), so P's accumulator is W V's A fragment without a shuffle.

#pragma once

#include "attention_tf32_hopper.cuh"

#include <math.h>

namespace mtt::tf32c {

using hopper::kSwizzle128;
using hopper::make_desc;
using tf32w::acc_frags;
using tf32w::convert_lo;
using tf32w::fence_async_smem;
using tf32w::lo_bits;

constexpr int kD = 64;    // the head_dim the route is built for (Chronos-2's 12 x 64 heads)
constexpr int kRes = 64;  // rows of a resident tile: one warpgroup's query rows or keys
constexpr int kStr = 32;  // rows of a streamed tile: the keys or queries a step walks
template <int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * kD * 4;
}
constexpr int kTBytes = kD * kStr * 4;  // X^T of a streamed tile: 64 rows x 32 columns

// Byte offset of element (r, c) of an R-row tile as TMA writes it.
template <int R>
__device__ __forceinline__ uint32_t nat_off(int r, int c) {
  const int cc = c & 31;
  return (c >> 5) * R * 128 + r * 128 + ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2));
}

// Descriptor of k-step kk (0-7) of an R-row tile at shared address `tile`:
// 8-row groups 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024, kSwizzle128);
}

// Descriptor of k-step kk (0-3) of an X^T tile at shared address `tile`.
__device__ __forceinline__ uint64_t t_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024, kSwizzle128);
}

// X^T as hi and lo (kTBytes each) from a streamed tile X (kStr rows), by `nt`
// threads (tid the caller's index among them): chunk j (16 bytes) of row n of
// X^T holds rows 8 (j / 2) + (j % 2) + 2 e, e = 0..3, of X. A step reads those
// four values of X and writes the chunk; lanes take consecutive n. Few
// registers: the forward's converting warps run on 56 (with convert_t4's
// blocks there ptxas serialised the consumers' products, C7511).
__device__ __forceinline__ void convert_t(uint8_t* hi, uint8_t* lo, const uint8_t* src, int tid,
                                          int nt) {
#pragma unroll 1
  for (int i = tid; i < kD * 8; i += nt) {
    const int n = i % kD;
    const int j = i / kD;
    const int k0 = 8 * (j >> 1) + (j & 1);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = *reinterpret_cast<const float*>(src + nat_off<kStr>(k0 + 2 * e, n));
    const uint32_t off = n * 128 + ((j ^ (n & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(lo_bits(v[0]), lo_bits(v[1]), lo_bits(v[2]), lo_bits(v[3]));
  }
}

// convert_t by 4 x 4 blocks, for the backward's converting warps: a step reads
// the four rows 8 (j / 2) + (j % 2) + 2 e of X at four consecutive columns n0..
// n0 + 3 (one 16-byte load each) and writes chunk j of rows n0..n0 + 3 of X^T;
// lanes take consecutive j, so a quarter-warp's stores meet 8 distinct 16-byte
// bank groups; a quarter of convert_t's loads.
__device__ __forceinline__ void convert_t4(uint8_t* hi, uint8_t* lo, const uint8_t* src, int tid,
                                           int nt) {
#pragma unroll 1
  for (int i = tid; i < kD * 2; i += nt) {
    const int j = i & 7;
    const int n0 = (i >> 3) * 4;
    const int k0 = 8 * (j >> 1) + (j & 1);
    float4 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = *reinterpret_cast<const float4*>(src + nat_off<kStr>(k0 + 2 * e, n0));
    const float v[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x},
                           {x[0].y, x[1].y, x[2].y, x[3].y},
                           {x[0].z, x[1].z, x[2].z, x[3].z},
                           {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + c;
      const uint32_t off = n * 128 + ((j ^ (n & 7)) << 4);
      *reinterpret_cast<float4*>(hi + off) = make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(lo_bits(v[c][0]), lo_bits(v[c][1]), lo_bits(v[c][2]), lo_bits(v[c][3]));
    }
  }
}

#define MTT_C4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x 64) += A B over one k-step of 8: A in registers (per warp the A
// fragment of mma.sync m16n8k8), B K-major from shared memory.
__device__ __forceinline__ void wgmma_tf32_rs64(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MTT_C4(d, 0), MTT_C4(d, 1), MTT_C4(d, 2), MTT_C4(d, 3), MTT_C4(d, 4), MTT_C4(d, 5),
        MTT_C4(d, 6), MTT_C4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MTT_C4

// Issue acc (64 x 32) = A B^T over the 64 columns in 3xTF32: A a 64-row tile
// at shared address a_hi (its lo twin at a_lo), B a 32-row tile at b_hi
// (b_lo); per k-step lo hi, hi lo, hi hi. The caller fences, commits and waits.
__device__ __forceinline__ void issue_abt3(float (&acc)[4][4], uint32_t a_hi, uint32_t a_lo,
                                           uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    const uint64_t ah = nat_desc<kRes>(a_hi, kk);
    const uint64_t bh = nat_desc<kStr>(b_hi, kk);
    hopper::wgmma_tf32_ss32(acc, nat_desc<kRes>(a_lo, kk), bh, kk > 0);
    hopper::wgmma_tf32_ss32(acc, ah, nat_desc<kStr>(b_lo, kk), 1);
    hopper::wgmma_tf32_ss32(acc, ah, bh, 1);
  }
}

// Issue out (64 x 64) += P X over X's 32 rows in 3xTF32: P as acc_frags' hi
// and lo, X^T at t_hi (t_lo); per k-step lo hi, hi lo, hi hi. The caller
// fences, commits and waits.
__device__ __forceinline__ void issue_pb3(float (&out)[8][4], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t t_hi,
                                          uint32_t t_lo) {
#pragma unroll
  for (int kk = 0; kk < kStr / 8; ++kk) {
    const uint64_t th = t_desc(t_hi, kk);
    wgmma_tf32_rs64(out, lo[kk], th);
    wgmma_tf32_rs64(out, hi[kk], t_desc(t_lo, kk));
    wgmma_tf32_rs64(out, hi[kk], th);
  }
}

// The bias and segment ids of a thread's entries of a 64 x 32 logit tile, read
// from device memory (L2) ahead of the product they are applied to: rows
// rows[r] of the (S, S) bias of one head, keys k0 + 8 j + 2 t + e (entry
// [j][2 r + e], the wgmma accumulator layout). Every address is clamped into
// the (S, S) block and no load waits on another (route 3's reads,
// chronos_hopper.cuh).
struct BiasTile {
  float b[4][4];
  int seg[4][2];  // segment ids of the tile's columns
};
__device__ __forceinline__ void load_bias(BiasTile& bt, const float* __restrict__ bias_h,
                                          const int* __restrict__ seg_b, const int (&rows)[2], int k0,
                                          int S, int t) {
  long long rofs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rofs[r] = min(rows[r], S - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = min(k0 + 8 * j + 2 * t + e, S - 1);
      bt.seg[j][e] = __ldg(seg_b + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) bt.b[j][2 * r + e] = __ldg(bias_h + rofs[r] * S + col);
    }
}

// Fold the mask into a loaded tile while the tile's product runs: the bias
// stays where the pair may attend; across segments finfo(float32).min, which
// absorbs any finite logit exactly (l + min = min for |l| below 2^103); a
// column at or past S -inf (no term). Then l = Q K^T + bias is one add.
__device__ __forceinline__ void fold_mask(BiasTile& bt, const int (&sr)[2], int k0, int S, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool out = k0 + 8 * j + 2 * t + (e & 1) >= S;
      const float x = bt.seg[j][e & 1] != sr[e >> 1] ? -FLT_MAX : bt.b[j][e];
      bt.b[j][e] = out ? -INFINITY : x;
    }
}
__device__ __forceinline__ void add_bias(float (&sc)[4][4], const BiasTile& bt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] += bt.b[j][e];
}

// The segment ids of a thread's two rows (rows past S read row S - 1).
__device__ __forceinline__ void row_segments(int (&sr)[2], const int* __restrict__ seg_b,
                                             const int (&rows)[2], int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) sr[r] = __ldg(seg_b + min(rows[r], S - 1));
}

// Rows row_a and row_a + 8 of a warp's 16 x 64 accumulator tile, scaled by
// inv[0] and inv[1], to dst (row stride ld, even; dst 8-byte aligned), 8
// bytes a lane; rows past S skipped.
__device__ __forceinline__ void store_f32(float* dst, long long ld, const float (&o)[8][4],
                                          int row_a, const float (&inv)[2], int S, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* p = dst + (long long)row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) = make_float2(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

// The maps of one fp32 operand of the fused (B, S, 3*H*64) qkv, or of the (B,
// S, H*64) cotangent, for tiles of kRes and of kStr rows: boxes of 32 columns
// (128 bytes, 128-byte swizzle; taken twice, at columns 0 and 32 of a head);
// rows past S read as zeros (the maps are (B, S, H*64) boxes, so a tile never
// reaches into the next batch row).
struct Maps {
  CUtensorMap res, str;
};
inline cudaError_t encode_f32_64(Maps* m, const float* base, int B, int S, int H, long long ld) {
  const hopper::EncodeTiled encode = hopper::encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * kD, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(ld) * 4 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUtensorMap* maps[2] = {&m->res, &m->str};
  const int rows[2] = {kRes, kStr};
  for (int i = 0; i < 2; ++i) {
    const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows[i]), 1};
    const CUresult r = encode(maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                              dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// q, k and v of the fused qkv (row stride 3*H*64), each with its two maps.
struct QkvMaps {
  Maps q, k, v;
};
inline cudaError_t encode_qkv(QkvMaps* m, const void* qkv, int B, int S, int H) {
  const long long hd = (long long)H * kD;
  const auto* base = static_cast<const float*>(qkv);
  cudaError_t err = encode_f32_64(&m->q, base, B, S, H, 3 * hd);
  if (err == cudaSuccess) err = encode_f32_64(&m->k, base + hd, B, S, H, 3 * hd);
  if (err == cudaSuccess) err = encode_f32_64(&m->v, base + 2 * hd, B, S, H, 3 * hd);
  return err;
}

// Rows [row, row + R) of head `head`, batch row `batch`, of an fp32 operand
// into an R-row tile at `dst` (its two blocks), through `map` (R rows a box).
template <int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int row, int batch) {
  hopper::tma_load(dst, map, bar, head * kD, row, batch);
  hopper::tma_load(dst + R * 128, map, bar, head * kD + 32, row, batch);
}

// A converting warp's end of a step: its writes fenced for wgmma, then its arrive.
__device__ __forceinline__ void converted(uint64_t* bar, int lane) {
  fence_async_smem();
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace mtt::tf32c
