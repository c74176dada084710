// Pieces shared by the persistent one-pass kernels for short sequences on
// Hopper (sm_90a): the causal forward and backward (attention_fwd_short_hopper.cu,
// B1f, and attention_bwd_short_hopper.cu, B1b, head_dim 80, which share
// produce_heads and encode_head_maps), the Chronos-2 backward
// (chronos_attention_bwd_short_hopper.cu, B4b, head_dim 64) and the Chronos-2
// forward (chronos_attention_short_hopper.cu, B4f, head_dim 64). Each keeps a whole key row in one tile of SP = S rounded
// up to 16 rows, so one kernel computes a work item's outputs in one pass
// (the backwards dQ, dK and dV; the forward O), on mma.sync m16n8k16 fed from
// tiles that TMA lands in shared memory.
//
// Tiles. An operand tile is SP rows of one head as TMA writes it: columns
// 0-63 as SP x 128 bytes under the 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8)), and, at head_dim 80, columns 64-79 as SP x 32 bytes
// under the 32-byte swizzle (chunk c ^ ((r / 4) % 2)) right after them. Every
// tile starts 1024-byte aligned, where the 128-byte pattern repeats, so the
// pattern follows the row index and ldmatrix reads eight rows of a column
// chunk from eight different bank groups. The maps are (B, S, H*D) boxes of
// SP rows of one batch row: rows past S come as zeros, never the next batch
// row's.
//
// Blocks. Persistent, sized to the card: kGroups consumer groups of warps,
// each taking every other work item of the block (the forward: one group from
// 81 tokens), and one producer warp whose lanes issue the TMA loads of the
// next items into a ring of 3-4 stages (the forwards: up to 6) (full
// and empty mbarriers; each consumer warp arrives on `empty` itself once its
// last read of the stage is done). The producer also copies the item's small
// per-key side input (key-valid bytes or segment ids) into the stage with
// plain loads, after its TMA loads are issued, and arrives on `full` a second
// time once they are written (kFullArrivals), so the consumers never wait on
// a load of their own (the forwards read them a row ahead into registers, so
// that no load lies between a stage's release and its `full`). In the
// backwards each group has its own W and dL
// staging: a named barrier of its own after phase A (W and dL written, K and
// V read), and an mbarrier on which each warp arrives after its last read of
// the staging, so that a warp starts its next item's products before the
// group is done. The forwards stage nothing: a warp's W stays in its
// registers as the A operand of W V.
//
// Outputs. A warp's 16 x D accumulator tile is rounded to bf16 into the slot
// of an operand tile its head no longer reads (backward: dQ into V's after
// the group's barrier; then dV into V's and dK into K's, one after the other;
// forwards: O into the warp's own 16 rows of Q's), then copied to device
// memory as whole rows, 16 bytes a lane.

#pragma once

#include "hopper_common.cuh"

namespace mtt {
namespace hopper_short {

using namespace mtt::hopper;

constexpr int kGroups = 2;          // consumer groups of a block
constexpr int kMaxStages = 4;       // stages of the TMA ring, at most
constexpr int kMinStages = 3;       // and at least
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have on sm_90
// Arrivals that complete a stage's `full` phase: the producer's expect_tx (with
// the TMA bytes) and its arrival once the side input is written.
constexpr int kFullArrivals = 2;

// Stages that fit beside `fixed` bytes, at most `most` (0 when fewer than
// kMinStages fit: the configuration is not built).
constexpr int ring_stages(int fixed, int stage, int most = kMaxStages) {
  return (kSmemLimit - fixed) / stage >= most        ? most
         : (kSmemLimit - fixed) / stage >= kMinStages ? (kSmemLimit - fixed) / stage
                                                       : 0;
}

// A consumer group's wait for its row j of the ring: row j takes stage j %
// STAGES, and G groups take the rows in turn. `full`'s wait reads a parity,
// so it cannot tell the phase of row j from that of row j - 2 STAGES: where a
// stage serves more than one group (STAGES % G != 0: 3 stages, 2 groups),
// row j - STAGES there is another group's, and if its load were still open
// the wait for row j would pass at once. So the group first waits for that
// row's release on `empty` (which also means its load is done): in order
// anyway, since the producer needs the same release before it loads row j.
// Rows j - 2 STAGES and j belong to one group (2 STAGES % G == 0), so
// neither barrier is two phases away.
template <int STAGES, int G>
__device__ __forceinline__ void wait_row(uint64_t* full, uint64_t* empty, int j) {
  static_assert((2 * STAGES) % G == 0, "rows j - 2 STAGES and j in one group");
  const int st = j % STAGES;
  if constexpr (STAGES % G != 0) {
    if (j >= STAGES) mbar_wait(empty + st, (j / STAGES - 1) & 1);
  }
  mbar_wait(full + st, (j / STAGES) & 1);
}

// The producer warp of a route at head_dim 80 whose work item is HPI heads of
// one batch row (ceil(H / HPI) items a batch row, `items` in all): the
// block's items blockIdx.x, blockIdx.x + gridDim.x, ... into stage j % STAGES
// of the ring at `smem` (STAGE bytes a stage), operand op of head slot hh at
// (op * HPI + hh) * TILE, lane l loading box l & 1 (64 columns, then 16, at
// SP * 128 bytes) of head (l >> 1) % nh of operand (l >> 1) / nh (`map(op)`
// its maps); then the batch row's SP key-valid bytes (0 past S) into vms +
// stage * SP, and the second arrival on `full`. AHEAD reads those bytes an
// item ahead into registers, so that no load's latency lies between a
// stage's release and its `full`.
template <int OPS, int HPI, int SP, int TILE, int STAGE, int STAGES, bool AHEAD, typename Maps>
__device__ __forceinline__ void produce_heads(const Maps& map, uint8_t* smem, uint8_t* vms,
                                              uint64_t* full, uint64_t* empty,
                                              const uint8_t* __restrict__ valid, int S, int H,
                                              int items, int lane) {
  const int hg = (H + HPI - 1) / HPI;
  constexpr int VB = (SP + 31) / 32;
  uint8_t vk[VB];
  auto read_valid = [&](int i) {
    const uint8_t* src = valid + (long long)(i / hg) * S;
#pragma unroll
    for (int r = 0; r < VB; ++r) {
      const int c = lane + 32 * r;
      vk[r] = c < S ? __ldg(src + c) : 0;
    }
  };
  if (AHEAD && (int)blockIdx.x < items) read_valid(blockIdx.x);
  int j = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++j) {
    const int st = j % STAGES;
    mbar_wait(empty + st, ((j / STAGES) & 1) ^ 1);
    const int b = i / hg;
    const int h0 = (i - b * hg) * HPI;
    const int nh = min(HPI, H - h0);
    if (lane == 0) mbar_expect_tx(full + st, OPS * nh * SP * 2 * kDim);
    __syncwarp();
    if (lane < 2 * OPS * nh) {
      const int box = lane & 1;
      const int hh = (lane >> 1) % nh;
      const int op = (lane >> 1) / nh;
      const OperandMaps& m = map(op);
      uint8_t* dst = smem + st * STAGE + (op * HPI + hh) * TILE + box * SP * 128;
      tma_load(dst, box ? &m.c16 : &m.c64, full + st, (h0 + hh) * kDim + box * 64, 0, b);
    }
    if constexpr (AHEAD) {
#pragma unroll
      for (int r = 0; r < VB; ++r)
        if (lane + 32 * r < SP) vms[st * SP + lane + 32 * r] = vk[r];
    } else {
      const uint8_t* vb = valid + (long long)b * S;
      for (int c = lane; c < SP; c += 32) vms[st * SP + c] = c < S ? __ldg(vb + c) : 0;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(full + st);
    if (AHEAD && i + (int)gridDim.x < items) read_valid(i + gridDim.x);
  }
}

// ldmatrix (x4, and transposed) from a shared-memory address.
__device__ __forceinline__ void ldsm(uint32_t r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
// Order this thread's generic writes to shared memory before later TMA
// writes to the same bytes (the stage's next load).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1-15; 0 is __syncthreads') over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The shared-memory address of the 16-byte chunk holding columns c..c+7 (c a
// multiple of 8) of row r of a head's operand tile (header note).
template <int D>
struct Tile {
  uint32_t c64, c16;
  __device__ __forceinline__ Tile(uint32_t base, int rows) : c64(base), c16(base + rows * 128) {}
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    if (D == 64 || c < 64) return c64 + r * 128 + ((((c >> 3) ^ r) & 7) << 4);
    return c16 + r * 32 + (((((c - 64) >> 3) ^ (r >> 2)) & 1) << 4);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// sc (16 x NT * 8) += A B^T for one warp: A rows a0..a0+15 of one tile, B rows
// 0..NT*8-1 of another, NK k-steps of 16 columns. An odd NT reads rows up to
// NT*8+7 (the tile holds them) and drops the last 8.
template <int NK, int NT, int D>
__device__ __forceinline__ void abt(float (&sc)[NT][4], const Tile<D>& A, int a0, const Tile<D>& B,
                                    int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t a[4];
    ldsm(a, A.at(a0 + (lane & 7) + ((lane >> 3) & 1) * 8, kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bb[4];
      ldsm(bb, B.at(n * 8 + (lane & 7) + (lane >> 4) * 8, kk * 16 + ((lane >> 3) & 1) * 8));
      mtt::mma_bf16(sc[n], a, bb);
      if (n + 1 < NT) mtt::mma_bf16(sc[n + 1], a, bb + 2);
    }
  }
}

// acc (16 x NO * 8) += A (16 x 16 in registers: hi, and lo when SPLIT) times
// rows row0..row0+15 of a tile (ldmatrix.trans).
template <int NO, bool SPLIT, int D>
__device__ __forceinline__ void pb(float (&acc)[NO][4], const uint32_t hi[4], const uint32_t lo[4],
                                   const Tile<D>& B, int row0, int lane) {
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    uint32_t bb[4];
    ldsm_t(bb, B.at(row0 + (lane & 7) + ((lane >> 3) & 1) * 8, n * 8 + (lane >> 4) * 8));
    mtt::mma_bf16(acc[n], hi, bb);
    mtt::mma_bf16(acc[n + 1], hi, bb + 2);
    if constexpr (SPLIT) {
      mtt::mma_bf16(acc[n], lo, bb);
      mtt::mma_bf16(acc[n + 1], lo, bb + 2);
    }
  }
}

// A warp's accumulator tile, rounded to bf16, into rows r0..r0+15 of a tile.
template <int NO, int D>
__device__ __forceinline__ void put(const Tile<D>& T, int r0, const float (&acc)[NO][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st_shared(T.at(r0 + g + 8 * r, n * 8) + 4 * t, mtt::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]));
}

// Rows r0..r0+15 of a tile (those before S) to out + row * ld, 16 bytes a
// lane: out points at row 0, column 0 of the head, 16-byte aligned, ld a
// multiple of 8. Call after a __syncwarp that follows the warp's put.
template <int D>
__device__ __forceinline__ void copy_rows(const Tile<D>& T, int r0, bf16* out, long long ld, int S,
                                          int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int q = lane; q < 16 * CH; q += 32) {
    const int i = q / CH;
    const int ch = q - i * CH;
    if (r0 + i < S)
      *reinterpret_cast<uint4*>(out + (long long)(r0 + i) * ld + ch * 8) = ld_shared16(T.at(r0 + i, ch * 8));
  }
}

// The Chronos segment mask on a warp's tile of logits against every key (the
// stage's segment ids `sg`; the thread's rows `rows`): a key past S gets
// -inf (no term), a key of another segment finfo(float32).min, an allowed
// pair keeps its logit.
template <int NT>
__device__ __forceinline__ void segment_mask(float (&sc)[NT][4], const int* sg,
                                             const int (&rows)[2], int S, int t) {
  const int sq[2] = {sg[rows[0]], sg[rows[1]]};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
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

// W = exp(l - m) / s in place on the thread's row r (elements 2 r, 2 r + 1)
// of a warp's tile of masked logits against every key, with the exact row
// max m and sum s: the whole row is here, so no online rescaling.
template <int NT>
__device__ __forceinline__ void softmax_row(float (&sc)[NT][4], int r) {
  float mx = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
  mx = quad_max(mx);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = mtt::fast_exp(sc[n][2 * r + e] - mx);
      sc[n][2 * r + e] = x;
      s += x;
    }
  const float inv = 1.f / quad_sum(s);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) sc[n][2 * r + e] *= inv;
}

// Phase A's softmax on a warp's 16 rows of masked logits `sc` against every
// key, with dW in `dw`: W (softmax_row), r = rowsum(dW o W), dL = W (dW - r),
// all fp32. W goes to `wh` and `wl`, dL to `dh` and `dl`, each as a hi + lo
// pair of bf16 values (rows `rows`, row stride LDW), and dL stays in `sc`.
template <int NT, int LDW>
__device__ __forceinline__ void softmax_dl(float (&sc)[NT][4], const float (&dw)[NT][4],
                                           const int (&rows)[2], bf16* wh, bf16* wl, bf16* dh,
                                           bf16* dl, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    softmax_row(sc, r);
    float rr = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) rr = fmaf(sc[n][2 * r + e], dw[n][2 * r + e], rr);
    rr = quad_sum(rr);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int at = rows[r] * LDW + n * 8 + 2 * t;
      const float w0 = sc[n][2 * r], w1 = sc[n][2 * r + 1];
      uint32_t hi, lo;
      mtt::split_bf16(w0, w1, hi, lo);
      *reinterpret_cast<uint32_t*>(wh + at) = hi;
      *reinterpret_cast<uint32_t*>(wl + at) = lo;
      const float d0 = w0 * (dw[n][2 * r] - rr);
      const float d1 = w1 * (dw[n][2 * r + 1] - rr);
      sc[n][2 * r] = d0;
      sc[n][2 * r + 1] = d1;
      mtt::split_bf16(d0, d1, hi, lo);
      *reinterpret_cast<uint32_t*>(dh + at) = hi;
      *reinterpret_cast<uint32_t*>(dl + at) = lo;
    }
  }
}

// A fragments of the transpose of a 16 x 16 block of a (rows, LDW) bf16
// staging tile T: A[m][k] = T[r0 + k][c0 + m].
template <int LDW>
__device__ __forceinline__ void ldsm_at(uint32_t a[4], const bf16* T, int r0, int c0, int lane) {
  mtt::ldsm_x4_t(a, T + (r0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDW + c0 + ((lane >> 3) & 1) * 8);
}

// Phase B for a warp's 16 keys k0..k0+15 against the head's SP = 16 NQ query
// rows: acc = T^T B, T a (rows, LDW) staging tile given as a hi + lo pair (W for
// dV = W^T G, dL for dK = dL^T Q), its transposes read by ldmatrix.trans. The
// query tiles' loop is not unrolled: unrolled, it measured 1-2% slower (B4b at
// 128 x 67).
template <int NQ, int NO, int LDW, int D>
__device__ __forceinline__ void keys_pb(float (&acc)[NO][4], const bf16* th, const bf16* tl,
                                        const Tile<D>& B, int k0, int lane) {
  zero(acc);
#pragma unroll 1
  for (int kq = 0; kq < NQ; ++kq) {
    uint32_t hi[4], lo[4];
    ldsm_at<LDW>(hi, th, kq * 16, k0, lane);
    ldsm_at<LDW>(lo, tl, kq * 16, k0, lane);
    pb<NO, true>(acc, hi, lo, B, kq * 16, lane);
  }
}

// dQ = dL K for a warp's 16 rows, dL (in registers) as a hi + lo pair; with
// an odd NT the keys past NT*8 count as zeros.
template <int NT, int NO, int D>
__device__ __forceinline__ void dq_rows(float (&acc)[NO][4], const float (&dlr)[NT][4],
                                        const Tile<D>& K, int lane) {
  constexpr float kZero[4] = {0.f, 0.f, 0.f, 0.f};
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
    uint32_t hi[4], lo[4];
    mtt::a_frags<true>(dlr[2 * kk], 2 * kk + 1 < NT ? dlr[2 * kk + 1] : kZero, hi, lo);
    pb<NO, true>(acc, hi, lo, K, kk * 16, lane);
  }
}

// One (B, S, H*D) bf16 operand at `base` (element (b, s, col) at base[(b * S +
// s) * ld + col]), boxes of `rows` rows by `cols` columns of one batch row,
// under `swizzle`; rows past S read as zeros.
inline cudaError_t encode_rows(CUtensorMap* m, const void* base, int B, int S, int width,
                               long long ld, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The two maps of one (B, S, H, 80) bf16 operand at `base` with row stride
// `ld`, as the routes at head_dim 80 read a head: boxes of `rows` rows of one
// batch row by 64 columns (128-byte swizzle) and by 16 (32-byte).
inline cudaError_t encode_head_maps(OperandMaps* m, const void* base, int B, int S, int H,
                                    long long ld, int rows) {
  const cudaError_t err =
      encode_rows(&m->c64, base, B, S, H * kDim, ld, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
  return err != cudaSuccess
             ? err
             : encode_rows(&m->c16, base, B, S, H * kDim, ld, 16, rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

// Blocks of a persistent launch of `kernel` (its dynamic shared memory set):
// as many as the card holds at once, at most `items`.
template <typename Kernel>
inline cudaError_t grid_size(Kernel kernel, int threads, int smem, int items, int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long all = (long long)persistent_blocks(1 << 30) * per_sm;
  *blocks = (int)(all < items ? all : items);
  return cudaSuccess;
}

}  // namespace hopper_short
}  // namespace mtt
