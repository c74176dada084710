// Pieces shared by the Chronos-2 attention kernels (chronos_attention.cu,
// chronos_attention_bwd.cu; the 3xTF32 route, through chronos_tf32.cuh,
// takes the plan, the bias mask, the segment loader and the quad
// reductions): the launch plan of each route, the bias and segment mask on a
// tile of logits, the bias-tile and segment loaders, and the fp32 micro-tile
// helpers; the bf16 warp tile products come from attention_common.cuh. The
// design is in the header note of chronos_attention.cu.

#pragma once

#include "attention_common.cuh"

#include <math.h>

#include <algorithm>

// Whether route 3 takes a bf16 call (chronos_attention_hopper.cu), and its
// backward's dbias partials (chronos_attention_bwd_hopper.cu).
extern "C" int chronos_hopper_takes(int backward, int S, int D);
extern "C" int chronos_hopper_dbias_groups(int B, int S, int H);
// Whether route 4 takes a bf16 backward (chronos_attention_bwd_short_hopper.cu),
// its block's threads, and its dbias partials (blocks along the batch); and
// the same for the forward (chronos_attention_short_hopper.cu: its blocks a
// head).
extern "C" int chronos_short_takes(int S, int D);
extern "C" int chronos_short_threads(int S);
extern "C" int chronos_short_groups(int B, int S, int H);
extern "C" int chronos_short_fwd_takes(int S, int D);
extern "C" int chronos_short_fwd_threads(int S);
extern "C" int chronos_short_fwd_groups(int B, int S, int H);
// Whether route 5 takes an fp32 call (chronos_attention_tf32.cu).
extern "C" int chronos_tf32_takes(int D);
// Whether route 6 takes an fp32 backward (chronos_attention_bwd_short_tf32.cu),
// its block's threads and its dbias partials (blocks a head); and the same for
// the forward (chronos_attention_short_tf32.cu).
extern "C" int chronos_short_tf32_takes(int S, int D);
extern "C" int chronos_short_tf32_threads(int S);
extern "C" int chronos_short_tf32_groups(int B, int S, int H);
extern "C" int chronos_short_tf32_fwd_takes(int S, int D);
extern "C" int chronos_short_tf32_fwd_threads(int S);
extern "C" int chronos_short_tf32_fwd_groups(int B, int S, int H);
// Whether route 7 takes an fp32 call (chronos_attention_tf32_hopper.cu), and
// the batch rows of its backward's chunks (chronos_attention_bwd_tf32_hopper.cu).
extern "C" int chronos_tf32w_takes(int backward, int S, int D);
extern "C" int chronos_tf32w_chunk_rows(int B, int S, int H);

namespace {

using mtt::bf16;
using mtt::mma_abt;
using mtt::mma_a_tile;
using mtt::mma_nk;
using mtt::mma_nko;
using mtt::mma_pv;
using mtt::store_rows;

constexpr int kMaxDim = 256;
constexpr int kThreadsF32 = 256;  // fp32 route: a 16 x 16 grid of micro-tiles
constexpr int kThreadsMma = 128;  // bf16 tiled route: 4 warps x 16 query rows
constexpr int kOnePassFwdRows = 128;  // bf16 one-pass forward up to S = 128 (padded)
constexpr int kOnePassBwdRows = 96;   // bf16 one-pass backward up to S = 96 (padded)
constexpr int kMaxGroup = 8;          // batch rows per block of the one-pass routes

// ------------------------------------------------------------------ plans

// Routes: 0 = fp32 on the CUDA cores, 1 = bf16 mma.sync one-pass (the whole
// key row of a warp's 16 query rows in registers, several batch rows per
// block, the bias strip in shared memory once per block), 2 = bf16 mma.sync
// tiled (64-row query and key tiles, two passes, one batch row per block),
// 3 = bf16 wgmma + TMA at head_dim 64 (chronos_attention_hopper.cu,
// chronos_attention_bwd_hopper.cu: persistent warp-specialised blocks, 128
// rows a work item, one pass forward, dbias summed over the batch in the
// kernel, in groups only where its blocks are too few), taken where
// chronos_hopper_takes says so (the measured border) before the other two,
// 4 = the bf16 mma.sync one-pass route fed by TMA at head_dim 64, for short
// sequences (persistent blocks, each one head and a range of batch rows):
// the backward's (chronos_attention_bwd_short_hopper.cu: the head's bias read
// from L1, one dbias partial a block) where chronos_short_takes says so, the
// forward's (chronos_attention_short_hopper.cu) where chronos_short_fwd_takes
// says so, each before the others, 5 = fp32 3xTF32 on mma.sync m16n8k8 at
// head_dim 64 (chronos_attention_tf32.cu, chronos_attention_bwd_tf32.cu: one
// tile of S padded to 16 up to 80 tokens, else 64-row tiles; forward one pass,
// backward, for each chunk of batch rows, a dq kernel that writes W and dL to
// a scratch, a dkdv kernel that reads them, and a dbias kernel that sums dL
// over the batch), taken at head_dim 64 at every S (chronos_tf32_takes)
// before route 0, 6 = fp32 3xTF32 on mma.sync m16n8k8 fed by TMA at head_dim
// 64, for short sequences: route 4's persistent blocks in fp32 (the
// backward's, chronos_attention_bwd_short_tf32.cu, W and dL in shared memory,
// one dbias partial a block, where chronos_short_tf32_takes says so; the
// forward's, chronos_attention_short_tf32.cu, where
// chronos_short_tf32_fwd_takes says so), each before route 7, 7 = fp32
// 3xTF32 on wgmma fed by TMA at head_dim 64 (chronos_attention_tf32_hopper.cu,
// chronos_attention_bwd_tf32_hopper.cu: route 5 of the causal kernels at head
// dim 64, 128 query rows a forward block in two consumer warpgroups, 32-key
// tiles; backward, per chunk of batch rows a statistics kernel and a dq kernel
// of 128 query rows a block, the second writing W and dL to a scratch, a dK/dV
// kernel reading them, and with dbias dL summed over the batch in order),
// where chronos_tf32w_takes says so (from its measured borders), after route 6
// and before route 5. A batch of more than kGridRows rows runs in chunks
// (attention_common.cuh); the plan is a chunk's.
struct Plan {
  int route;
  int threads;  // per block
  int rows;     // query rows per block
  int keys;     // keys per tile
  int passes;   // walks over the keys (1 when the whole row is one tile)
  int group;    // batch rows per block
  int groups;   // blocks along the batch = dbias partial planes
  int dp;       // head_dim as padded in shared memory
  int cols;     // output columns per block
  int split_dl; // dL as a hi + lo bf16 pair (backward, bf16 routes)
};

// Batch rows per block of the one-pass routes: enough blocks to fill the
// card several times over (B H / 512 of them), at most kMaxGroup.
inline int batch_group(int B, int H) { return std::min(kMaxGroup, std::max(1, B * H / 512)); }

// fp32 tiles: TB = 16 TM rows fitted to S (one tile up to S = 80 at head_dim
// <= 64), else 64 rows up to head_dim 128 (96 in the backward) and 32 above,
// so the tiles fit in shared memory.
inline int f32_tm(int S, int D, bool backward) {
  if (S <= 16) return 1;
  if (S <= 32 || D > (backward ? 96 : 128)) return 2;
  if (S <= 64) return 4;
  if (S <= 80 && D <= 64) return 5;
  return 4;
}

inline Plan make_plan(bool backward, int dtype, int B, int S, int H, int D) {
  Plan p{};
  if (dtype == 0 && backward && chronos_short_tf32_takes(S, D)) {
    const int sp = (S + 15) / 16 * 16;
    const int groups = chronos_short_tf32_groups(B, S, H);
    p = {6, chronos_short_tf32_threads(S), sp, sp, 1, (B + groups - 1) / groups, groups, 64, 64, 0};
    return p;
  }
  if (dtype == 0 && !backward && chronos_short_tf32_fwd_takes(S, D)) {
    const int sp = (S + 15) / 16 * 16;
    const int groups = chronos_short_tf32_fwd_groups(B, S, H);
    p = {6, chronos_short_tf32_fwd_threads(S), sp, sp, 1, (B + groups - 1) / groups, groups, 64, 64, 0};
    return p;
  }
  if (dtype == 0 && chronos_tf32w_takes(backward ? 1 : 0, S, D)) {
    // rows: query rows a block (keys a block in the dK/dV kernel), two consumer
    // warpgroups of 64 and a producer warpgroup each way; passes: the
    // backward's three walks (statistics, dQ, dK and dV); group: batch rows a
    // chunk of the backward's W and dL scratch; dbias written whole.
    const int chunk = backward ? chronos_tf32w_chunk_rows(B, S, H) : 1;
    p = {7, 384, 128, 32, backward ? 3 : 1, chunk, 1, 64, 64, 0};
    return p;
  }
  if (dtype == 0 && chronos_tf32_takes(D)) {
    // rows: query (and key) rows a tile; passes: the dq kernel's walks over
    // the keys; one block a batch row, no dbias partials.
    const int tile = S <= 80 ? (S + 15) / 16 * 16 : 64;
    const int passes = backward && S > tile ? 2 : 1;
    p = {5, 2 * tile, tile, tile, passes, 1, 1, 64, 64, 0};
    return p;
  }
  if (dtype == 0) {
    const int tb = 16 * f32_tm(S, D, backward);
    p = {0, kThreadsF32, tb, tb, S <= tb ? 1 : 2, 1, B, D, D, 0};
    return p;
  }
  if (backward && chronos_short_takes(S, D)) {
    const int sp = (S + 15) / 16 * 16;
    const int groups = chronos_short_groups(B, S, H);
    p = {4, chronos_short_threads(S), sp, sp, 1, (B + groups - 1) / groups, groups, 64, 64, 1};
    return p;
  }
  if (!backward && chronos_short_fwd_takes(S, D)) {
    const int sp = (S + 15) / 16 * 16;
    const int groups = chronos_short_fwd_groups(B, S, H);
    p = {4, chronos_short_fwd_threads(S), sp, sp, 1, (B + groups - 1) / groups, groups, 64, 64, 0};
    return p;
  }
  if (chronos_hopper_takes(backward ? 1 : 0, S, D)) {
    // passes: the forward's one walk over the keys; the backward's three
    // (statistics and dQ over the keys, dK and dV over the queries); groups:
    // the backward's dbias partials.
    const int groups = backward ? chronos_hopper_dbias_groups(B, S, H) : 1;
    p = {3, 384, 128, 64, backward ? 3 : 1, (B + groups - 1) / groups, groups, 64, 64, backward ? 1 : 0};
    return p;
  }
  const int nk = mma_nk(D);
  const int sp = (S + 15) / 16 * 16;
  const int limit = backward ? kOnePassBwdRows : kOnePassFwdRows;
  if (sp <= limit && nk <= 4) {
    const int g = batch_group(B, H);
    p = {1, 2 * sp, sp, sp, 1, g, (B + g - 1) / g, 16 * nk, 16 * nk, backward ? 1 : 0};
    return p;
  }
  p = {2, kThreadsMma, 64, 64, 2, 1, B, 16 * nk, 16 * mma_nko(nk), backward ? 1 : 0};
  return p;
}

inline bool bad_shape(int B, int S, int H, int D) {
  return B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > kMaxDim || H > 65535;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
inline bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

// ------------------------------------------------------------ bf16 pieces

// A fragments of the transpose of a 16 x 16 block of a (rows, LDW) bf16
// tile T held row-major at T[r0.., c0..]: A[m][k] = T[r0 + k][c0 + m].
template <int LDW>
__device__ __forceinline__ void ldsm_at(uint32_t a[4], const bf16* T, int r0, int c0, int lane) {
  mtt::ldsm_x4_t(a, T + (r0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDW + c0 +
                        ((lane >> 3) & 1) * 8);
}

// Bias and segment mask on a warp's accumulator tile of logits: rows rows[0]
// and rows[1] (segment ids sq[0], sq[1]), keys k0 + c, c = 8 n + 2 t + (e & 1),
// with segment ids Sk[c]. A key at or past S gets -inf (no term); a key of
// another segment gets finfo(float32).min; an allowed pair gets its bias,
// read at bias_rows[r][c]. With PAIR (bias rows in a shared-memory tile,
// zero past S, an even row stride) the two columns of a lane come in one
// 8-byte load; without it (bias rows in device memory) only keys before S
// are read.
template <int NT, bool PAIR = true>
__device__ __forceinline__ void bias_mask(float sc[NT][4], const float* const bias_rows[2],
                                          const int sq[2], const int* Sk, int k0, int S,
                                          int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    const int key = k0 + c;
    const int2 sk = *reinterpret_cast<const int2*>(Sk + c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 b;
      if constexpr (PAIR) {
        b = *reinterpret_cast<const float2*>(bias_rows[r] + c);
      } else {
        b.x = key < S ? bias_rows[r][c] : 0.f;
        b.y = key + 1 < S ? bias_rows[r][c + 1] : 0.f;
      }
      float& x0 = sc[n][2 * r];
      float& x1 = sc[n][2 * r + 1];
      x0 = key >= S ? -INFINITY : sq[r] != sk.x ? -FLT_MAX : x0 + b.x;
      x1 = key + 1 >= S ? -INFINITY : sq[r] != sk.y ? -FLT_MAX : x1 + b.y;
    }
  }
}

// Row max and sum over the quad of lanes that holds a row of an accumulator
// tile (lane % 4 = 0..3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --------------------------------------------------------- fp32 pieces

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two (TB, dp) tiles.
template <int TM>
__device__ __forceinline__ void micro_dot(const float* A, const float* B, int D, int dp, int tx,
                                          int ty, float acc[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[TM], b[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * dp + d];
#pragma unroll
    for (int j = 0; j < TM; ++j) b[j] = B[(tx + 16 * j) * dp + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Bias and segment mask on a micro-tile of Q K^T: rows q0 + ty + 16 i (query
// segments Sq), keys k0 + tx + 16 j (key segments Sk). A key past the
// sequence end gets -inf (no term); a key of another segment gets
// finfo(float32).min; an allowed pair gets its bias added. Rows past S are
// left as they are (never written, and zero-weighted in the backward).
template <int TM>
__device__ __forceinline__ void bias_and_mask(float l[TM][TM], const int* Sq, const int* Sk,
                                              const float* bias_h, int q0, int k0, int S, int tx,
                                              int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ri = ty + 16 * i;
    const int row = q0 + ri;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      if (col >= S) {
        l[i][j] = -INFINITY;
      } else if (row < S) {
        l[i][j] = Sq[ri] == Sk[c] ? l[i][j] + bias_h[(long long)row * S + col] : -FLT_MAX;
      }
    }
  }
}

// Reductions over the 16 lanes that share a micro-tile row (tx = lane & 15).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A (ROWS, COLS) block of the (S, S) fp32 bias of one head, rows row0.., columns
// col0.., into dst[r * LD + c] by 4-byte cp.async (rows of the bias are not
// 16-byte aligned for odd S); entries past S are zero.
template <int ROWS, int COLS, int LD, int NTHREADS>
__device__ __forceinline__ void load_bias_tile(float* dst, const float* bias_h, int row0, int col0,
                                               int S) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += NTHREADS) {
    const int r = i / COLS;
    const int c = i - r * COLS;
    const bool in = row0 + r < S && col0 + c < S;
    mtt::cp_async4(dst + r * LD + c, in ? bias_h + (long long)(row0 + r) * S + col0 + c : bias_h,
                   in);
  }
}

// dst[r] = seg_b[r0 + r] for r < n by 4-byte cp.async, in the caller's commit
// group; past S: 0 (such keys are never read: their logits are -inf; such
// query rows are never written).
__device__ __forceinline__ void load_seg(int* dst, const int* seg_b, int r0, int S, int n) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const bool in = r0 + r < S;
    mtt::cp_async4(dst + r, in ? seg_b + r0 + r : seg_b, in);
  }
}

// Two blocks fit on an SM (228 KB, 1 KB reserved per block) up to this much
// dynamic shared memory each.
constexpr size_t kTwoBlockSmem = 113 * 1024;

}  // namespace
