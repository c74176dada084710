// Pieces shared by the fp32 tensor-core routes (3xTF32 on mma.sync m16n8k8)
// of the Chronos-2 kernels (chronos_attention_tf32.cu,
// chronos_attention_bwd_tf32.cu, through chronos_tf32.cuh, at head_dim 64)
// and of the causal kernels (attention_fwd_tf32.cu, attention_bwd_tf32.cu,
// through attention_tf32.cuh, at head_dim 80): the split and the products,
// the fragment loaders, the warp tile products and the tile loader and
// store, each a template over the head_dim D and the row stride LD (floats)
// of the shared tiles. The arithmetic is in the header note of
// chronos_attention_tf32.cu.
//
// Banks. Every fragment load below meets 32 distinct banks when LD = 4 mod
// 8: ldmatrix's eight 16-byte rows, LD floats apart, start at banks 4 r (2 j
// + 1) mod 32 for LD = 8 j + 4 (r = 0..7, all distinct); the scalar loads of
// load_bp and load_at read (row 2 t, column g), banks 8 t (2 j + 1) + g mod
// 32 (one bank per lane); a scalar B fragment of X Y^T would read (row g,
// column t), banks 4 g (2 j + 1) + t. LD = D + 4 holds both at D = 64 (68)
// and at D = 80 (84); tests/test_torch_port_causal_tf32.py counts the banks.

#pragma once

#include "attention_common.cuh"

namespace mtt::tf32 {

// cvt.rna.tf32.f32 for a finite x, in two integer instructions: half a TF32
// ulp added to the magnitude's bits carries into the kept bits exactly when
// rounding to nearest with ties away from zero rounds up; the 13 low bits are
// then cleared. (nvcc expands the cvt itself into a longer sequence that also
// handles inf and NaN: about three times the instructions of the whole split,
// measured in the forward's SASS, where no operand is inf or NaN.)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e with |e| <= 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in fp32). lo feeds only the tensor cores, which read
// the 19 high bits of a TF32 operand, so its 13 low bits are left as the
// rounding's carry put them.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// A fragment (16 x 8) and B fragment (8 x 8) of m16n8k8, each as a hi + lo
// pair. With g = lane / 4, t = lane % 4: a0 (row g, col t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// accumulator c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: lo hi + hi lo + hi hi, the small terms first, into one
// fp32 accumulator (lo lo, about 2^-22 of the product, is left out).
__device__ __forceinline__ void mma3(float c[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a row-major
// shared tile T (row stride LD), by one ldmatrix.x4 that reads each fp32 as
// two b16 values: matrix i is rows r0 + 8 (i & 1).., columns c0 + 4 (i >> 1)..
// (the eight 16-byte rows of a matrix meet distinct banks: the header note).
// ldmatrix's .trans moves b16 values, not fp32 ones, so the transposed
// operands (load_bp, load_at) are read by scalar loads.
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* T, int r0, int c0, int lane) {
  uint32_t r[4];
  const int i = lane >> 3;
  mtt::ldsm_x4(r, T + (r0 + (i & 1) * 8 + (lane & 7)) * LD + c0 + (i >> 1) * 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) split(__uint_as_float(r[j]), f.hi[j], f.lo[j]);
}

// B fragments of X Y^T for n-tiles n0 / 8 and n0 / 8 + 1, B[k][n] = Y[n0 +
// n][k0 + k], Y a row-major shared tile, by one ldmatrix.x4: matrix i is rows
// n0 + 8 (i >> 1).., columns k0 + 4 (i & 1)..
template <int LD>
__device__ __forceinline__ void load_bt2(FragB& f0, FragB& f1, const float* Y, int n0, int k0,
                                         int lane) {
  uint32_t r[4];
  const int i = lane >> 3;
  mtt::ldsm_x4(r, Y + (n0 + (i >> 1) * 8 + (lane & 7)) * LD + k0 + (i & 1) * 4);
  split(__uint_as_float(r[0]), f0.hi[0], f0.lo[0]);
  split(__uint_as_float(r[1]), f0.hi[1], f0.lo[1]);
  split(__uint_as_float(r[2]), f1.hi[0], f1.lo[0]);
  split(__uint_as_float(r[3]), f1.hi[1], f1.lo[1]);
}

// The A operand of P Y straight from an accumulator tile p (16 rows x 8
// columns k0..k0 + 7 of P): the k-step's columns taken in the order the
// accumulator holds them, k = t as column 2t and k = t + 4 as column 2t + 1,
// so no lane needs another lane's values. load_bp reads Y's rows in the same
// order. (The terms of a k-step are summed in another order; nothing else
// changes.)
__device__ __forceinline__ void acc_to_a(FragA& f, const float p[4]) {
  split(p[0], f.hi[0], f.lo[0]);
  split(p[2], f.hi[1], f.lo[1]);
  split(p[1], f.hi[2], f.lo[2]);
  split(p[3], f.hi[3], f.lo[3]);
}

// B fragment of P Y for acc_to_a's order: B[k][n] = Y[k0 + 2t (+1)][n0 + g].
template <int LD>
__device__ __forceinline__ void load_bp(FragB& f, const float* Y, int k0, int n0, int lane) {
  const float* p = Y + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[LD], f.hi[1], f.lo[1]);
}

// The A operand of P^T Y from a shared tile T = P (rows k0.. of P, row stride
// LD = 4 mod 8), in load_bp's order: A[m][k] = P[k0 + 2t (+1)][m0 + g (+8)],
// k = t as row 2t and k = t + 4 as row 2t + 1 (banks 8t + g).
template <int LD>
__device__ __forceinline__ void load_at(FragA& f, const float* T, int k0, int m0, int lane) {
  const float* p = T + (k0 + 2 * (lane & 3)) * LD + m0 + (lane >> 2);
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[LD], f.hi[2], f.lo[2]);
  split(p[LD + 8], f.hi[3], f.lo[3]);
}

// acc = X Y^T for one warp: rows [r0, r0 + 16) of X against the 8 NT rows of
// Y (both row stride LD), over the head_dim (D / 8 k-steps).
template <int D, int LD, int NT>
__device__ __forceinline__ void xyt(float acc[NT][4], const float* X, int r0, const float* Y,
                                    int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    FragA a;
    load_a<LD>(a, X, r0, 8 * s, lane);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      FragB b0, b1;
      load_bt2<LD>(b0, b1, Y, 8 * n, 8 * s, lane);
      mma3(acc[n], a, b0);
      mma3(acc[n + 1], a, b1);
    }
  }
}

// o += P Y for one warp: P as NT accumulator tiles (16 rows x 8 NT columns),
// Y the 8 NT rows x D columns of a shared tile (row stride LD).
template <int D, int LD, int NT>
__device__ __forceinline__ void py(float o[D / 8][4], const float p[NT][4], const float* Y,
                                   int lane) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    FragA a;
    acc_to_a(a, p[kk]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB b;
      load_bp<LD>(b, Y, 8 * kk, 8 * n, lane);
      mma3(o[n], a, b);
    }
  }
}

// o += P^T Y for one warp: columns [m0, m0 + 16) of P (a shared tile of KT
// rows, row stride LDP) against the KT rows x D columns of Y (row stride LD).
template <int D, int LD, int KT, int LDP>
__device__ __forceinline__ void pty(float o[D / 8][4], const float* P, int m0, const float* Y,
                                    int lane) {
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    FragA a;
    load_at<LDP>(a, P, 8 * kk, m0, lane);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB b;
      load_bp<LD>(b, Y, 8 * kk, 8 * n, lane);
      mma3(o[n], a, b);
    }
  }
}

// Rows [row0, row0 + ROWS) of one head's fp32 operand (row stride ld, `src`
// at (b, 0, h, 0)) into dst (row stride LD) by 16-byte cp.async; rows past S
// zero. Every row starts 16-byte aligned (D a multiple of 4, a 16-byte
// aligned base and ld a multiple of 4: the caller's rule).
template <int D, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld, int row0,
                                          int S) {
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4);
    const int c = (i - r * (D / 4)) * 4;
    const bool in = row0 + r < S;
    mtt::cp_async16(dst + r * LD + c, in ? src + (long long)(row0 + r) * ld + c : src, in);
  }
}

// Rows [row0, row0 + 16) of a warp's accumulator tiles o (16 x D, scaled by
// inv[r] on rows g and g + 8) to dst rows, row stride ld (even; dst 8-byte
// aligned); rows past S skipped.
template <int D>
__device__ __forceinline__ void store_tile(float* dst, long long ld, const float o[D / 8][4],
                                           int row0, const float inv[2], int S, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    float* p = dst + (long long)row * ld + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) = make_float2(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

// Row max and sum over the quad of lanes that holds a row of an accumulator
// tile (lane % 4 = 0..3).
__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mtt::tf32
