// Pieces shared by route 6 of the Chronos-2 attention kernels, the persistent
// 3xTF32 route for short sequences on Hopper (sm_90a): the forward
// (chronos_attention_short_tf32.cu, B4f) and the backward
// (chronos_attention_bwd_short_tf32.cu, B4b), fp32 at head_dim 64. It is
// route 4's shape (hopper_short.cuh: persistent blocks, each one head and a
// contiguous range of batch rows, a producer warp keeping each row's tiles in
// flight by TMA through a ring of full and empty mbarriers, the segment ids
// copied into the stage, a warp's 16 query rows against every key in one
// pass) with fp32 tiles and 3xTF32 products on mma.sync m16n8k8 (lo hi + hi
// lo + hi hi into one fp32 accumulator, tf32_common.cuh's mma3).
//
// The split is route 5's of the causal kernels (attention_tf32_hopper.cuh):
// hi is an fp32 value as it lies, of which the tensor cores read the 19 high
// bits (trunc(x)), lo = tf32(x - trunc(x)); three instructions a value. Where
// many warps read one tile as a B operand (k and v in every kernel, g and q in
// the backward's phase B), the block writes the tile's lo twin once into
// shared memory, in the tile's own layout, and its warps read hi and lo with
// no arithmetic: splitting in every warp cost a third of the kernels' time.
//
// Tiles. An fp32 operand tile is SP rows (S rounded up to 16) of one head's
// 64 columns, as two TMA boxes of 32 columns: columns 0-31, then 32-63, each
// SP x 128 bytes under the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)), read in place from the fused (B, S, 3*H*64) projection
// (or the (B, S, H*64) cotangent); rows past S come as zeros (the maps are
// (B, S, H*64) boxes of one batch row). Every tile starts 1024-byte aligned,
// where the swizzle's pattern repeats, so it follows the row index.
//
// Fragments (tf32_common.cuh's layouts). The A operand of X Y^T and the B
// operand of X Y^T come by ldmatrix, which reads each fp32 as two b16 values:
// eight rows of one 16-byte column chunk, which the swizzle puts in eight
// different bank groups. The B operand of P Y (acc_to_a's order: rows 2t and
// 2t + 1, column g of the quad's) comes by scalar loads: rows 2t of four
// lanes' quads differ in their low bits, so chunk ^ row spreads the 32 lanes
// over 32 banks. The A operand of P^T Y reads a staging tile of the backward
// (tf32_common's load_at: rows LDW = 4 mod 8 floats apart, 32 banks). Each
// load's address is a tile base, one of 16 per-lane values (Lanes) and a
// constant: with the swizzle computed in every load, the kernels held dozens
// of hoisted addresses, spilled 20-200 bytes and ran 1.2-1.3x slower (B4f
// 128 x 67 x 12 0.0802 -> 0.0627 held ms, B4b 0.1981 -> 0.1743, one H100
// 80GB HBM3 at 700 W).

#pragma once

#include "hopper_short.cuh"
#include "tf32_common.cuh"

namespace mtt {
namespace tf32_short {

using namespace mtt::hopper;
using namespace mtt::hopper_short;
using mtt::tf32::FragA;
using mtt::tf32::FragB;
using mtt::tf32::mma3;

constexpr int kD = 64;          // head_dim of the route
constexpr int kBox = 32;        // columns of a TMA box (128 bytes)
constexpr int kTileRow = 4 * kD;  // bytes of a tile row

// The split of an fp32 operand x (route 5's, attention_tf32_hopper.cuh): hi is
// x as it lies, of which the tensor cores read the 19 high bits, trunc(x);
// lo = tf32(x - trunc(x)) (x - trunc(x) is exact; the + 0x1000 is the
// rounding's carry, the tensor cores truncate the rest). Three integer or
// float instructions a value, against four for tf32_common's rounded hi.
__device__ __forceinline__ uint32_t lo_of(uint32_t x) {
  return __float_as_uint(__uint_as_float(x) - __uint_as_float(x & 0xffffe000u)) + 0x1000u;
}
__device__ __forceinline__ void split_trunc(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x;
  lo = lo_of(x);
}

// The A operand of P Y from an accumulator tile p (tf32_common's acc_to_a).
__device__ __forceinline__ void acc_to_a_trunc(FragA& f, const float p[4]) {
  split_trunc(__float_as_uint(p[0]), f.hi[0], f.lo[0]);
  split_trunc(__float_as_uint(p[2]), f.hi[1], f.lo[1]);
  split_trunc(__float_as_uint(p[1]), f.hi[2], f.lo[2]);
  split_trunc(__float_as_uint(p[3]), f.hi[3], f.lo[3]);
}

// The A operand of P^T Y from a staging tile T = P (tf32_common's load_at).
template <int LD>
__device__ __forceinline__ void load_at_trunc(FragA& f, const float* T, int k0, int m0, int lane) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(T) + (k0 + 2 * (lane & 3)) * LD + m0 + (lane >> 2);
  split_trunc(p[0], f.hi[0], f.lo[0]);
  split_trunc(p[8], f.hi[1], f.lo[1]);
  split_trunc(p[LD], f.hi[2], f.lo[2]);
  split_trunc(p[LD + 8], f.hi[3], f.lo[3]);
}

// An SP-row fp32 tile at shared address `base` (the layout of the header
// note). A tile's lo twin (lo_of of every value, the same layout) lies `lo`
// bytes on, or there is none (each warp splits what it reads).
struct Tile32 {
  uint32_t base;
  int rows;
  uint32_t lo;
  __device__ __forceinline__ Tile32(uint32_t b, int sp, uint32_t twin = 0) : base(b), rows(sp), lo(twin) {}
};

__device__ __forceinline__ uint32_t ld_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The lo twin of `bytes` bytes of tiles at shared address `src` into `dst`
// (same layout), 16 bytes a step, by thread i of n.
__device__ __forceinline__ void write_lo(uint32_t src, uint32_t dst, int bytes, int i, int n) {
  for (int o = 16 * i; o < bytes; o += 16 * n) {
    uint4 v = ld_shared16(src + o);
    v.x = lo_of(v.x);
    v.y = lo_of(v.y);
    v.z = lo_of(v.z);
    v.w = lo_of(v.w);
    st_shared16(dst + o, v);
  }
}

// The per-lane parts of the fragment loads' addresses on Tile32's layout (a
// fragment's rows start at multiples of 8, so row % 8 is the lane's own, and
// a k-step's or an n-tile's column chunk only varies in its bits 1-2 with q =
// its index % 4): each load is then a tile base, one of these and a constant.
struct Lanes {
  uint32_t a[4];     // load_a: row (i & 1) 8 + lane % 8, chunk (2q + (i >> 1)) ^ lane % 8
  uint32_t b[4];     // load_bt2: row (i >> 1) 8 + lane % 8, chunk (2q + (i & 1)) ^ lane % 8
  uint32_t p[2][4];  // load_bp: row 2t + dr, column g: chunk (2q + g / 4) ^ (2t + dr)
  __device__ __forceinline__ explicit Lanes(int lane) {
    const int i = lane >> 3, l7 = lane & 7, t = lane & 3, g = lane >> 2;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = ((i & 1) * 8 + l7) * 128 + ((((2 * q + (i >> 1)) ^ l7) & 7) << 4);
      b[q] = ((i >> 1) * 8 + l7) * 128 + ((((2 * q + (i & 1)) ^ l7) & 7) << 4);
#pragma unroll
      for (int dr = 0; dr < 2; ++dr)
        p[dr][q] = (2 * t + dr) * 128 + ((((2 * q + (g >> 2)) ^ (2 * t + dr)) & 7) << 4) + (g & 3) * 4;
    }
  }
};

// A fragment of rows [r0, r0 + 16) x columns [8 s, 8 s + 8) of a tile
// (tf32_common's load_a on the swizzled layout).
__device__ __forceinline__ void load_a(FragA& f, const Tile32& T, int r0, int s, const Lanes& z) {
  uint32_t r[4];
  ldsm(r, T.base + (s >> 2) * T.rows * 128 + r0 * 128 + z.a[s & 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) split_trunc(r[j], f.hi[j], f.lo[j]);
}

// B fragments of X Y^T for n-tiles n and n + 1 at k-step s: B[k][m] = Y[8 n +
// m][8 s + k] (tf32_common's load_bt2 on the swizzled layout); lo from Y's
// twin with TW.
template <bool TW>
__device__ __forceinline__ void load_bt2(FragB& f0, FragB& f1, const Tile32& Y, int n, int s,
                                         const Lanes& z) {
  uint32_t h[4], l[4];
  const uint32_t a = Y.base + (s >> 2) * Y.rows * 128 + n * 8 * 128 + z.b[s & 3];
  ldsm(h, a);
  if constexpr (TW) {
    ldsm(l, a + Y.lo);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) l[j] = lo_of(h[j]);
  }
  f0.hi[0] = h[0], f0.lo[0] = l[0], f0.hi[1] = h[1], f0.lo[1] = l[1];
  f1.hi[0] = h[2], f1.lo[0] = l[2], f1.hi[1] = h[3], f1.lo[1] = l[3];
}

// B fragment of P Y for acc_to_a's order, rows k0.. and n-tile n: B[k][m] =
// Y[k0 + 2t (+1)][8 n + g]; lo from Y's twin with TW.
template <bool TW>
__device__ __forceinline__ void load_bp(FragB& f, const Tile32& Y, int k0, int n, const Lanes& z) {
  const uint32_t a = Y.base + (n >> 2) * Y.rows * 128 + k0 * 128;
  const uint32_t a0 = a + z.p[0][n & 3], a1 = a + z.p[1][n & 3];
  f.hi[0] = ld_u32(a0);
  f.hi[1] = ld_u32(a1);
  if constexpr (TW) {
    f.lo[0] = ld_u32(a0 + Y.lo);
    f.lo[1] = ld_u32(a1 + Y.lo);
  } else {
    f.lo[0] = lo_of(f.hi[0]);
    f.lo[1] = lo_of(f.hi[1]);
  }
}

// acc (16 x 8 NT) += X Y^T for one warp: rows [r0, r0 + 16) of tile X against
// rows 8 n0..8 (n0 + NT) - 1 of tile Y, over the 64 columns (8 k-steps of 8).
// An odd NT reads Y's rows up to 8 (n0 + NT) + 7 (the tile holds them) and
// drops the last 8.
template <int NT, bool TW>
__device__ __forceinline__ void xyt(float (&acc)[NT][4], const Tile32& X, int r0, const Tile32& Y,
                                    const Lanes& z, int n0 = 0) {
#pragma unroll
  for (int s = 0; s < kD / 8; ++s) {
    FragA a;
    load_a(a, X, r0, s, z);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      FragB b0, b1;
      load_bt2<TW>(b0, b1, Y, n0 + n, s, z);
      mma3(acc[n], a, b0);
      if (n + 1 < NT) mma3(acc[n + 1], a, b1);
    }
  }
}

// One k-step of 8 rows of Y (from k0) of o (16 x 8 NO) += A Y, Y's columns
// from 8 n0 (n0 a multiple of 4 when NO = 4).
template <bool TW, int NO>
__device__ __forceinline__ void step_py(float (&o)[NO][4], const FragA& a, const Tile32& Y, int k0,
                                        const Lanes& z, int n0 = 0) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    FragB b;
    load_bp<TW>(b, Y, k0, n0 + n, z);
    mma3(o[n], a, b);
  }
}

// o (16 x 64) += P Y for one warp: P as NK accumulator tiles (16 rows x 8 NK
// columns, in registers), Y rows 0..8 NK - 1 of a tile.
template <int NK, bool TW>
__device__ __forceinline__ void py(float (&o)[kD / 8][4], const float (&p)[NK][4], const Tile32& Y,
                                   const Lanes& z) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    FragA a;
    acc_to_a_trunc(a, p[kk]);
    step_py<TW, kD / 8>(o, a, Y, 8 * kk, z);
  }
}

// The two products of phase B for one warp, each over the first 8 NK rows of
// its tiles: dv (16 x 8 NO) = P^T Y and dk = D^T X, columns [m0, m0 + 16) of
// the staging tiles P and D (row stride LDW floats), the columns of Y and X
// from 8 n0; Y's lo from its twin with TW, X's split as read. Rows past 8 NK
// lie past S, where Y and X are zero. The loop is not unrolled (code size;
// route 4's note on the same loop).
template <int NK, int LDW, bool TW, int NO>
__device__ __forceinline__ void ptys(float (&dv)[NO][4], float (&dk)[NO][4], const float* P,
                                     const float* D, int m0, const Tile32& Y, const Tile32& X,
                                     const Lanes& z, int lane, int n0) {
  zero(dv);
  zero(dk);
#pragma unroll 1
  for (int kk = 0; kk < NK; ++kk) {
    FragA a, b;
    load_at_trunc<LDW>(a, P, 8 * kk, m0, lane);
    load_at_trunc<LDW>(b, D, 8 * kk, m0, lane);
    step_py<TW, NO>(dv, a, Y, 8 * kk, z, n0);
    step_py<false, NO>(dk, b, X, 8 * kk, z, n0);
  }
}

// o (16 x 8 NO) = P Y for one warp: rows [r0, r0 + 16) of a staging tile P
// (row stride LD floats) against rows 0..8 NK - 1 of tile Y, Y's columns from
// 8 n0. P's A fragment is read in acc_to_a's order (k = t as column 2t, k = t
// + 4 as 2t + 1, one 8-byte load a row), the order load_bp reads Y's rows in.
template <int NK, int LD, bool TW, int NO>
__device__ __forceinline__ void staged_py(float (&o)[NO][4], const float* P, int r0, const Tile32& Y,
                                          const Lanes& z, int lane, int n0) {
  zero(o);
  const float* p = P + (r0 + (lane >> 2)) * LD + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(p + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LD + 8 * kk);
    FragA a;
    split_trunc(__float_as_uint(x0.x), a.hi[0], a.lo[0]);
    split_trunc(__float_as_uint(x1.x), a.hi[1], a.lo[1]);
    split_trunc(__float_as_uint(x0.y), a.hi[2], a.lo[2]);
    split_trunc(__float_as_uint(x1.y), a.hi[3], a.lo[3]);
    step_py<TW, NO>(o, a, Y, 8 * kk, z, n0);
  }
}

// Rows r0 + g and r0 + g + 8 (those before S) of a warp's 16 x 8 NO
// accumulator tile to dst + row * ld, 8 bytes a lane.
template <int NO>
__device__ __forceinline__ void store_rows(float* dst, long long ld, const float (&o)[NO][4], int r0,
                                           int S, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    float* p = dst + (long long)row * ld + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// The logits of a warp's two rows (the thread's `rows`, clamped to S - 1:
// such rows are never stored) start from the head's (S, S) fp32 bias, read
// in the accumulator layout from L2, then L1 (a block keeps one head), zero
// past S. The row pointers are made opaque to the compiler in each row, so
// that the loads stay here and are not hoisted out of the row loop into held
// registers (route 4's finding).
template <int NT>
__device__ __forceinline__ void bias_start(float (&sc)[NT][4], const float* const (&brow)[2], int S,
                                           int t, int k0 = 0) {
  const float* bp[2] = {brow[0] + k0, brow[1] + k0};
  asm volatile("" : "+l"(bp[0]), "+l"(bp[1]));
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[n][e] = k0 + n * 8 + 2 * t + (e & 1) < S ? __ldg(bp[e >> 1] + n * 8 + (e & 1)) : 0.f;
}

// hopper_short's segment_mask on a warp's tile of logits against keys k0..:
// a key past S gets -inf, a key of another segment finfo(float32).min.
template <int NT>
__device__ __forceinline__ void segment_mask_at(float (&sc)[NT][4], const int* sg, const int (&rows)[2],
                                                int S, int t, int k0) {
  const int sq[2] = {sg[rows[0]], sg[rows[1]]};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = k0 + n * 8 + 2 * t;
    const int2 sk = *reinterpret_cast<const int2*>(sg + c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float& x0 = sc[n][2 * r];
      float& x1 = sc[n][2 * r + 1];
      x0 = c >= S ? -INFINITY : sq[r] != sk.x ? -FLT_MAX : x0;
      x1 = c + 1 >= S ? -INFINITY : sq[r] != sk.y ? -FLT_MAX : x1;
    }
  }
}

// The producer warp: batch row b0 + j into stage j % STAGES of the ring at
// `smem` (STAGE bytes apart), lane l < 2 OPS loading box l & 1 of operand
// l >> 1 (`maps[op]`, head h), then the row's segment ids (past S: the last
// one's; such keys and rows are masked or never stored) into segs + stage *
// SP, read a row ahead into registers so that no load's latency lies between
// a stage's release and its `full`, then the second arrival on `full`.
template <int OPS, int SP, int STAGES, int STAGE>
__device__ __forceinline__ void produce(const CUtensorMap* const (&maps)[OPS], uint8_t* smem,
                                        int* segs, uint64_t* full, uint64_t* empty,
                                        const int* __restrict__ seg, int S, int h, int b0, int nb,
                                        int lane) {
  constexpr int TILE = SP * kTileRow;
  constexpr int IDS = (SP + 31) / 32;
  int ids[IDS];
  auto read_ids = [&](int b) {
    const int* src = seg + (long long)b * S;
#pragma unroll
    for (int i = 0; i < IDS; ++i) ids[i] = __ldg(src + min(lane + 32 * i, S - 1));
  };
  if (nb > 0) read_ids(b0);
  for (int j = 0; j < nb; ++j) {
    const int st = j % STAGES;
    mbar_wait(empty + st, ((j / STAGES) & 1) ^ 1);
    if (lane == 0) mbar_expect_tx(full + st, OPS * TILE);
    __syncwarp();
    if (lane < 2 * OPS) {
      const int op = lane >> 1, box = lane & 1;
      tma_load(smem + st * STAGE + op * TILE + box * SP * 128, maps[op], full + st,
               h * kD + box * kBox, 0, b0 + j);
    }
#pragma unroll
    for (int i = 0; i < IDS; ++i)
      if (lane + 32 * i < SP) segs[st * SP + lane + 32 * i] = ids[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(full + st);
    if (j + 1 < nb) read_ids(b0 + j + 1);
  }
}

// The map of one (B, S, H*64) fp32 operand at `base` with row stride `ld`
// (floats): boxes of `rows` rows of one batch row by 32 columns, 128-byte
// swizzle; rows past S read as zeros.
inline cudaError_t encode_f32_rows(CUtensorMap* m, const void* base, int B, int S, int width,
                                   long long ld, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(ld) * 4 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(rows), 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Stages of a ring of `stage` bytes beside `fixed` bytes, at most `most`; 0
// when fewer than two fit (the configuration is not built).
constexpr int stages_fit(int fixed, int stage, int most) {
  return (kSmemLimit - fixed) / stage >= most ? most
         : (kSmemLimit - fixed) / stage >= 2  ? (kSmemLimit - fixed) / stage
                                               : 0;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace tf32_short
}  // namespace mtt
