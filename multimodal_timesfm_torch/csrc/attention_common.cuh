// Pieces shared by the attention kernels on Hopper (sm_90a): the causal ones
// (attention_fwd.cu, attention_bwd.cu) and, through chronos_common.cuh, the
// Chronos ones: cp.async copies, ldmatrix, mma.sync on bf16 and the warp tile
// products built on it, the first valid key of a batch row, and the tile
// loaders.
//
// Skip rule (both kernels, both routes). Let f be the first valid key of a
// batch row (S when there is none). A query row i >= f sees key f, so its
// row max is finite and every masked key's term expf(-FLT_MAX - m) is
// exactly 0; a row i < f sees no valid key and gets uniform weights over all
// S keys. So the pair (query tile [q0, qlast], key tile [k0, klast]) adds a
// nonzero term only if q0 < f (the tile holds a row with no valid key) or
// the key tile overlaps [f, qlast]. Every pair outside that rule adds exact
// zeros, so skipping it changes only the order of summation, never a value.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace mtt {

using bf16 = __nv_bfloat16;

// The most batch rows one launch takes: several routes lay the batch on the
// CUDA grid's y or z dimension, which stops at 65,535. The entry points
// (attention_fwd, attention_bwd, chronos_attention_fwd, chronos_attention_bwd)
// run a larger batch as chunks of batch rows, in order on the caller's
// stream, each a call of its own (rows are independent; the Chronos dbias
// adds the chunks' sums in order). JAX's grids are one-dimensional over the
// batch and have no such limit.
constexpr int kGridRows = 65535;

// Rows a chunk of a B-row batch: as few chunks as keep each within
// kGridRows, as even as their count allows (the last may hold fewer).
inline int grid_chunk_rows(int B) {
  const int chunks = (B + kGridRows - 1) / kGridRows;
  return (B + chunks - 1) / chunks;
}

// `p` moved on by `bytes` (a chunk's first batch row).
inline const void* byte_at(const void* p, long long bytes) {
  return p == nullptr ? p : static_cast<const char*>(p) + bytes;
}
inline void* byte_at(void* p, long long bytes) {
  return p == nullptr ? p : static_cast<char*>(p) + bytes;
}

// 16-byte (cg) or 4-byte (ca) asynchronous copy global -> shared; with
// pred false nothing is read and the destination is zero-filled (`src` must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i. `_t` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a b: m16n8k16, bf16 operands, fp32 accumulators. Fragments (g =
// lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); c0, c1 (g,
// 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to about 2^-17 relative: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// sc = A B^T for one warp: A is 16 rows of a (rows, LDS) bf16 tile, B the
// NT * 8 rows of another; NK k-steps of 16 columns.
template <int NK, int NT, int LDS>
__device__ __forceinline__ void mma_abt(float sc[NT][4], const bf16* A, const bf16* B, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t a[4];
    mtt::ldsm_x4(a, A + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bb[4];
      mtt::ldsm_x4(bb, B + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                           ((lane >> 3) & 1) * 8);
      mtt::mma_bf16(sc[n], a, bb);
      mtt::mma_bf16(sc[n + 1], a, bb + 2);
    }
  }
}

// A fragments of a 16 x 16 block from two accumulator n-tiles p0 (columns
// 0..7) and p1 (8..15): one bf16 rounding, or with SPLIT a hi + lo pair.
template <bool SPLIT>
__device__ __forceinline__ void a_frags(const float p0[4], const float p1[4], uint32_t hi[4],
                                        uint32_t lo[4]) {
  if constexpr (SPLIT) {
    mtt::split_bf16(p0[0], p0[1], hi[0], lo[0]);
    mtt::split_bf16(p0[2], p0[3], hi[1], lo[1]);
    mtt::split_bf16(p1[0], p1[1], hi[2], lo[2]);
    mtt::split_bf16(p1[2], p1[3], hi[3], lo[3]);
  } else {
    hi[0] = mtt::pack_bf16(p0[0], p0[1]);
    hi[1] = mtt::pack_bf16(p0[2], p0[3]);
    hi[2] = mtt::pack_bf16(p1[0], p1[1]);
    hi[3] = mtt::pack_bf16(p1[2], p1[3]);
  }
}

// acc (16 x NO * 8) += A (16 x 16: hi, and lo when SPLIT) times rows 0..15 of
// a (rows, LDS) bf16 tile B from column col0 (ldmatrix.trans).
template <int NO, int LDS, bool SPLIT>
__device__ __forceinline__ void mma_a_tile(float acc[NO][4], const uint32_t hi[4],
                                           const uint32_t lo[4], const bf16* B, int col0,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    uint32_t bb[4];
    mtt::ldsm_x4_t(bb, B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + col0 + n * 8 +
                           (lane >> 4) * 8);
    mtt::mma_bf16(acc[n], hi, bb);
    mtt::mma_bf16(acc[n + 1], hi, bb + 2);
    if constexpr (SPLIT) {
      mtt::mma_bf16(acc[n], lo, bb);
      mtt::mma_bf16(acc[n + 1], lo, bb + 2);
    }
  }
}

// acc += P B for P in registers (accumulator pair p0, p1 = keys 0..15).
template <int NO, int LDS, bool SPLIT>
__device__ __forceinline__ void mma_pv(float acc[NO][4], const float p0[4], const float p1[4],
                                       const bf16* B, int col0, int lane) {
  uint32_t hi[4], lo[4];
  a_frags<SPLIT>(p0, p1, hi, lo);
  mma_a_tile<NO, LDS, SPLIT>(acc, hi, lo, B, col0, lane);
}

// Store a warp's 16 x NO * 8 accumulator tile: rows row_a, row_a + 8 of a
// head's (S, ld) output, columns col0...
template <int NO>
__device__ __forceinline__ void store_rows(bf16* ob, long long ld, const float acc[NO][4],
                                           int row_a, int col0, int S, int D, int pair_out,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      const int d = col0 + n * 8 + 2 * t;
      if (row >= S || d >= D) continue;
      bf16* p = ob + (long long)row * ld + d;
      if (pair_out) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      } else {
        p[0] = __float2bfloat16_rn(acc[n][2 * r]);
        if (d + 1 < D) p[1] = __float2bfloat16_rn(acc[n][2 * r + 1]);
      }
    }
}

// bf16 tiles: k-steps of 16 from head_dim, rounded up to an instantiated count
// (NK), and the output k-steps one block writes (NKO: all up to 80 columns, 64
// above, so the accumulators stay in registers).
inline int mma_nk(int D) {
  const int nk = (D + 15) / 16;
  if (nk <= 2) return nk;
  if (nk <= 5) return nk <= 4 ? 4 : 5;
  return nk <= 8 ? 8 : 16;
}
inline int mma_nko(int nk) { return nk <= 5 ? nk : 4; }

// exp(x) on the SFU, the bf16 routes' exponential: ex2.approx of x log2(e),
// about 2^-22 relative plus the rounding of the product (|x| 2^-24); exp(0) = 1
// and exp(-inf) = exp(-FLT_MAX - m) = 0 exactly, as the skip rule needs.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Whether every logit of a warp's 16 query rows (from row0) against the key
// tile [k0, k0 + BK) is unmasked: every key valid, before S and at or before
// row0. Such a tile needs no mask. Called by all 32 lanes.
template <int BK>
__device__ __forceinline__ bool tile_unmasked(const uint8_t* vm, int k0, int row0, int S, int lane) {
  bool ok = true;
#pragma unroll
  for (int c = lane; c < BK; c += 32) ok = ok && vm[c] != 0;
  return __all_sync(0xffffffffu, ok) && k0 + BK <= S && k0 + BK - 1 <= row0;
}

// The smallest s in [0, limit) with valid_b[s] != 0, or `limit` when there
// is none; every thread of the block gets it. `red` holds one int per warp.
// Called by every thread; contains two __syncthreads.
__device__ __forceinline__ int first_valid(const uint8_t* valid_b, int limit, int* red) {
  int f = limit;
  for (int i = threadIdx.x; i < limit; i += blockDim.x) {
    if (valid_b[i]) {
      f = i;
      break;
    }
  }
  f = __reduce_min_sync(0xffffffffu, f);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = f;
  __syncthreads();
  int m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = min(m, red[w]);
  __syncthreads();
  return m;
}

// Key tiles a query tile [q0, qlast] visits under the skip rule: [*first,
// *first + *count). f is the first valid key, or anything > qlast when no
// key up to qlast is valid.
__device__ __forceinline__ void key_tiles(int q0, int qlast, int f, int S, int BK, int* first,
                                          int* count) {
  if (q0 < f) {
    *first = 0;
    *count = (S + BK - 1) / BK;
  } else {
    *first = f / BK;
    *count = qlast / BK - *first + 1;
  }
}

// Query tiles a key tile [k0, klast] meets under the same rule, in order:
// tile i of the walk is i < a ? i : b + (i - a), for i < count. f is the
// first valid key of the whole row (S when there is none).
struct QueryWalk {
  int a, b, count;
  __device__ __forceinline__ int tile(int i) const { return i < a ? i : b + (i - a); }
};
__device__ __forceinline__ QueryWalk query_tiles(int k0, int klast, int f, int S, int BQ) {
  const int nq = (S + BQ - 1) / BQ;
  QueryWalk w;
  w.a = min((f + BQ - 1) / BQ, nq);  // tiles holding a row < f
  w.b = max(w.a, k0 / BQ);           // first tile reaching row k0
  w.count = w.a + (klast >= f ? nq - w.b : 0);
  return w;
}

// Load rows [row0, row0 + ROWS) of HPB consecutive heads (h0 + slot) of one
// (S, ld) operand into shared memory: slot s, row r, column c at
// dst[s * slot_stride + r * LDS + c], c < DP. Columns past D, rows past S and
// heads past H are zero. `src` points at element (b, 0, h0, 0). With `vec`
// (D % 8 == 0 and every row 16-byte aligned) the rows go by 16-byte cp.async;
// otherwise by guarded 2-byte loads and 16-byte shared stores (head dims
// such as 20, whose rows are not 16-byte aligned).
template <int HPB, int ROWS, int DP, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int slot_stride, const bf16* src,
                                               long long ld, int D, int h0, int H, int row0,
                                               int S, bool vec) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < HPB * ROWS * CH; i += NTHREADS) {
    const int s = i / (ROWS * CH);
    const int rem = i - s * ROWS * CH;
    const int r = rem / CH;
    const int c = (rem - r * CH) * 8;
    bf16* d = dst + s * slot_stride + r * LDS + c;
    const int row = row0 + r;
    const bool in = row < S && h0 + s < H;
    const bf16* p = src + (long long)row * ld + (long long)s * D + c;
    if (vec) {
      const bool take = in && c < D;
      cp_async16(d, take ? p : src, take);
    } else {
      alignas(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] = (in && c + e < D) ? p[e] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// fp32 rows [row0, row0 + TB) of one head into dst[r * dp + d], d < D, by
// 4-byte cp.async; rows past S are zero. `src` points at (b, 0, h, 0).
template <int TB, int NTHREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int S,
                                              int D, int dp, long long ld) {
  for (int i = threadIdx.x; i < TB * D; i += NTHREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const bool in = row0 + r < S;
    cp_async4(dst + r * dp + d, in ? src + (long long)(row0 + r) * ld + d : src, in);
  }
}

}  // namespace mtt
