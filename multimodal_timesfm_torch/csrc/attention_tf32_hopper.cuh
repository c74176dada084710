// Pieces of route 5 of the causal kernels, fp32 at head_dim 80 on Hopper's
// warpgroup products (attention_fwd_tf32_hopper.cu, attention_bwd_tf32_hopper.cu):
// the tiles' layouts in shared memory, the conversion pass that splits an
// operand into TF32 hi and lo, the descriptors and the 3xTF32 products. The
// wgmma instruction forms and the tensor maps are hopper_common.cuh's.
//
// The split. The tensor cores read the 19 high bits of a 32-bit TF32
// operand, so an fp32 value x stored as it is reads as hi = trunc(x) (x with
// its 13 low bits cleared), and the pass stores lo = x - trunc(x) (exact in
// fp32) with half a TF32 ulp added to its bits, so that the truncating read
// rounds it to nearest: x = hi + lo + e, |e| <= 2^-21 |x|. Every operand is
// split this way, in shared memory (the TMA tile is hi, its lo a twin tile)
// and in registers (A fragments of P, W or dL: hi is the value's own bits).
// Each product is lo hi + hi lo + hi hi per k-step of 8, in that order, into
// one fp32 accumulator (tests/test_torch_tf32_model.py models it).
//
// Tiles. TMA writes an R x 80 fp32 tile (R = 64 resident rows, 32 streamed)
// as three blocks: columns 0-31 and 32-63 (R x 128 bytes each, 128-byte
// swizzle) and 64-79 (R x 64 bytes, 64-byte swizzle). That is the K-major
// layout wgmma reads, so such a tile is the A or B operand of A B^T (Q K^T,
// G V^T and their mirrors) as it arrives: k-steps 0-3 and 4-7 in the first
// two blocks (32 bytes apart), 8-9 in the third. Its lo twin has the same
// layout, written 16 bytes at a time at the same offsets.
//
// The transposed operands. In P X (W V, dL K, W^T G, dL^T Q) the k dimension
// is X's rows, and wgmma takes TF32 B only K-major, so the pass writes X^T
// (80 rows, 32 columns: one 128-byte-swizzled block of 80 x 128 bytes) as hi
// and lo. P comes from an accumulator, whose thread holds columns 2t and 2t
// + 1 of each 8 (g = lane / 4, t = lane % 4); read as the A fragment of a
// k-step (columns t and t + 4 of the 8) it takes k = t as column 2t and k =
// t + 4 as column 2t + 1. So X^T stores, within each group of 8 positions,
// the rows in the order 0, 2, 4, 6, 1, 3, 5, 7: no lane needs another lane's
// values, and the k-step's 8 products are the same ones in another order.

#pragma once

#include "hopper_common.cuh"

namespace mtt::tf32w {

using hopper::kSwizzle128;
using hopper::kSwizzle64;
using hopper::make_desc;

constexpr int kD = 80;    // the head_dim the route is built for (TimesFM's 16 x 80 heads)
constexpr int kRes = 64;  // rows of a resident tile: one warpgroup's query rows or keys
constexpr int kStr = 32;  // rows of a streamed tile: the keys or queries a step walks
template <int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * kD * 4;
}
constexpr int kTBytes = kD * kStr * 4;  // X^T of a streamed tile: 80 rows x 32 columns

// Byte offset of element (r, c) of an R-row tile as TMA writes it.
template <int R>
__device__ __forceinline__ uint32_t nat_off(int r, int c) {
  if (c < 64) {
    const int cc = c & 31;
    return (c >> 5) * R * 128 + r * 128 + ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2));
  }
  const int cc = c - 64;
  return 2 * R * 128 + r * 64 + ((((cc >> 2) ^ ((r >> 1) & 3)) << 4) | ((cc & 3) << 2));
}

// Descriptor of k-step kk (0-9) of an R-row tile at shared address `tile`:
// 8-row groups 1024 bytes apart in the 128-byte blocks, 512 in the 64-byte one.
template <int R>
__device__ __forceinline__ uint64_t nat_desc(uint32_t tile, int kk) {
  if (kk < 8) return make_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024, kSwizzle128);
  return make_desc(tile + 2 * R * 128 + (kk - 8) * 32, 16, 512, kSwizzle64);
}

// Descriptor of k-step kk (0-3) of an X^T tile at shared address `tile`.
__device__ __forceinline__ uint64_t t_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, 1024, kSwizzle128);
}

// lo of x (the header note): the bits of x - trunc(x) plus half a TF32 ulp.
__device__ __forceinline__ uint32_t lo_bits(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __float_as_uint(x - hi) + 0x1000u;
}

// The lo twin of a tile of BYTES bytes, by `nt` threads (tid the caller's
// index among them), 16 bytes at a time at the same offsets.
template <int BYTES>
__device__ __forceinline__ void convert_lo(uint8_t* dst, const uint8_t* src, int tid, int nt) {
#pragma unroll 2
  for (int i = tid; i < BYTES / 16; i += nt) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(lo_bits(x.x), lo_bits(x.y), lo_bits(x.z), lo_bits(x.w));
  }
}

// X^T as hi and lo (kTBytes each) from a streamed tile X (kStr rows), by `nt`
// threads: chunk j (16 bytes) of row n of X^T holds rows 8 (j / 2) + (j % 2)
// + 2 e, e = 0..3, of X (the header note). A step reads those four values of
// X and writes the chunk; lanes take consecutive n, so they read distinct
// banks of one row of X and a quarter-warp's stores meet 8 distinct 16-byte
// bank groups. Few registers: the forward's converting warps run on 56.
__device__ __forceinline__ void convert_t(uint8_t* hi, uint8_t* lo, const uint8_t* src, int tid,
                                          int nt) {
#pragma unroll 1
  for (int i = tid; i < kD * 8; i += nt) {
    const int n = i % kD;
    const int j = i / kD;
    const int k0 = 8 * (j >> 1) + (j & 1);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = *reinterpret_cast<const float*>(src + nat_off<kStr>(k0 + 2 * e, n));
    const uint32_t off = n * 128 + ((j ^ (n & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(lo + off) =
        make_uint4(lo_bits(v[0]), lo_bits(v[1]), lo_bits(v[2]), lo_bits(v[3]));
  }
}

// convert_t by 4 x 4 blocks: a step reads the four rows of X at four
// consecutive columns n0..n0 + 3 (one 16-byte load each) and writes chunk j of
// rows n0..n0 + 3 of X^T; lanes take consecutive j, so a quarter-warp's stores
// meet 8 distinct 16-byte bank groups. A quarter of convert_t's loads, for
// the backward's converting warps, which transpose two tiles a step.
__device__ __forceinline__ void convert_t4(uint8_t* hi, uint8_t* lo, const uint8_t* src, int tid,
                                           int nt) {
#pragma unroll 1
  for (int i = tid; i < kD * 2; i += nt) {
    const int j = i & 7;
    const int n0 = (i >> 3) * 4;
    const int k0 = 8 * (j >> 1) + (j & 1);
    float4 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = *reinterpret_cast<const float4*>(src + nat_off<kStr>(k0 + 2 * e, n0));
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

// Writes of the generic proxy (the conversion pass) made visible to wgmma,
// which reads shared memory through the async proxy; the writer's mbarrier
// arrive follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A fragments, hi and lo, of a 64 x 32 accumulator tile for P X (k-step kk:
// columns 8 kk + 2t as k = t, 8 kk + 2t + 1 as k = t + 4).
__device__ __forceinline__ void acc_frags(const float (&x)[4][4], uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float a[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[kk][e] = __float_as_uint(a[e]);
      lo[kk][e] = lo_bits(a[e]);
    }
  }
}

// Issue acc (64 x 32) = A B^T over the 80 columns in 3xTF32: A a 64-row tile
// at shared address a_hi (its lo twin at a_lo), B a 32-row tile at b_hi
// (b_lo). The caller fences, commits and waits.
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

// Issue out (64 x 80) += P X over X's 32 rows in 3xTF32: P as acc_frags' hi
// and lo, X^T at t_hi (t_lo). The caller fences, commits and waits.
__device__ __forceinline__ void issue_pb3(float (&out)[10][4], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], uint32_t t_hi,
                                          uint32_t t_lo) {
#pragma unroll
  for (int kk = 0; kk < kStr / 8; ++kk) {
    const uint64_t th = t_desc(t_hi, kk);
    hopper::wgmma_tf32_rs80(out, lo[kk], th);
    hopper::wgmma_tf32_rs80(out, hi[kk], t_desc(t_lo, kk));
    hopper::wgmma_tf32_rs80(out, hi[kk], th);
  }
}

// Rows [row0, row0 + 16) of a 64 x R tile: whether every key of [k0, k0 +
// kStr) lies before S, is valid and at or before row0 (no mask to apply).
// Called by all 32 lanes of the warp.
__device__ __forceinline__ bool unmasked32(const uint8_t* vb, int k0, int row0, int S,
                                              int lane) {
  const bool inside = k0 + kStr <= S && k0 + kStr - 1 <= row0;
  return __all_sync(0xffffffffu, inside && vb[k0 + lane] != 0);
}

// The key-valid bits of this thread's 8 columns of a 32-key tile (bit 2 j + e
// for key k0 + 8 j + 2 t + e; keys past S clear), loaded while the tile's
// product runs.
__device__ __forceinline__ uint32_t key_bits(const uint8_t* vb, int k0, int S, int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t + e;
      if (col < S && vb[col] != 0) bits |= 1u << (2 * j + e);
    }
  return bits;
}

// The forward's and the row kernels' mask on a 64 x 32 logit tile (rows
// rows[0], rows[1] of this thread, keys k0 + 8 j + 2 t + e, their key_bits):
// a key past S -inf (no term), a causal-future or padded key finfo(float32).min.
__device__ __forceinline__ void mask32(float (&sc)[4][4], uint32_t bits, int k0,
                                       const int (&rows)[2], int S, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t + e;
      const bool on = (bits >> (2 * j + e)) & 1u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = sc[j][2 * r + e];
        if (col >= S) {
          x = -INFINITY;
        } else if (col > rows[r] || !on) {
          x = -FLT_MAX;
        }
      }
    }
}

// Rows row_a and row_a + 8 of a warp's 16 x 80 accumulator tile, scaled by
// inv[0] and inv[1], to dst (row stride ld, even; dst 8-byte aligned), 8
// bytes a lane; rows past S skipped.
__device__ __forceinline__ void store_f32(float* dst, long long ld, const float (&o)[10][4],
                                           int row_a, const float (&inv)[2], int S, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    float* p = dst + (long long)row * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < 10; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) = make_float2(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

// The layout rule of the route: q, k, v (and g) read by TMA, their bases
// 16-byte aligned and their row strides a multiple of 4 floats (16 bytes);
// the outputs written 8 bytes a lane, their bases 8-byte aligned and their
// row strides even.
inline bool tma_rows(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
}
inline bool store_rows_ok(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0 && ld % 2 == 0;
}

}  // namespace mtt::tf32w

namespace mtt::hopper {

// Rows [row, row + R) of head `head`, batch row `batch`, of an fp32 operand
// into an R-row tile at `dst` (the three blocks of attention_tf32_hopper.cuh).
template <int R>
__device__ __forceinline__ void load_f32_tile(uint8_t* dst, const F32Maps& m, uint64_t* bar,
                                              int head, int row, int batch) {
  tma_load(dst, &m.c32, bar, head * kDim, row, batch);
  tma_load(dst + R * 128, &m.c32, bar, head * kDim + 32, row, batch);
  tma_load(dst + 2 * R * 128, &m.c16, bar, head * kDim + 64, row, batch);
}

}  // namespace mtt::hopper
