// Hopper-only pieces of the wgmma routes of the causal attention kernels
// (attention_fwd_hopper.cu, attention_bwd_hopper.cu, head_dim 80) and of the
// Chronos-2 ones (chronos_attention_hopper.cu, chronos_attention_bwd_hopper.cu,
// head_dim 64, the kDim64 pieces below), and of the fp32 route 5 of the
// causal kernels (the TF32 instruction forms and fp32 tensor maps below;
// attention_tf32_hopper.cuh holds the rest): mbarriers, TMA tile
// loads through tensor maps, shared-memory matrix descriptors and the
// warpgroup products (wgmma.mma_async) the kernels are built from, all as
// inline PTX for sm_90a, plus the host side: the tensor maps, encoded with
// the driver's cuTensorMapEncodeTiled reached through the runtime
// (cudaGetDriverEntryPoint), so the library links no -lcuda.
//
// Operand tiles. Every operand of these kernels is a run of rows of one
// head of a (B, S, H, 80) bf16 view whose rows share one stride (q, k, v, g;
// the fused-qkv layout too). A row of 80 values is 160 bytes, more than the
// 128-byte swizzle holds, so a tile of R rows lives in shared memory as two
// blocks, each loaded by its own TMA box: columns 0-63 (R x 128 bytes, 128-byte
// swizzle) and columns 64-79 (R x 32 bytes, 32-byte swizzle). Nothing is read
// past a head's 80 columns (in the fused-qkv layout those are the next head's).
// Rows past S come in as zeros (the maps are (B, S, H*80) boxes, so a tile
// never reaches into the next batch row).
//
// The two products every kernel uses, per warpgroup of 64 rows:
//   acc(64 x 64)  = A B^T over the 80 columns: A (64 rows) and B (64 rows),
//                   both row-major in their tiles (K-major to wgmma): four
//                   k-steps of 16 in the 128-byte block, one in the 32-byte one;
//   out(64 x 80) += P B over 64 rows of B: P in registers (the A fragment,
//                   as mma.sync's), B row-major (MN-major to wgmma): N = 64 in
//                   the 128-byte block and N = 16 in the 32-byte one, four
//                   k-steps of 16 rows each.
// Accumulator layout (m64nNk16, per warpgroup thread; w = warp in the group,
// g = lane / 4, t = lane % 4): d[j][0..1] at row 16 w + g, columns 8 j + 2 t
// and + 1; d[j][2..3] at row 16 w + g + 8; the same as mma.sync's m16n8 tile
// for each 8-column block j, so mtt::a_frags and mtt::store_rows apply.

#pragma once

#include "attention_common.cuh"

#include <cuda.h>  // CUtensorMap and its enums (types only)

namespace mtt {
namespace hopper {

constexpr int kDim = 80;        // the head_dim this route is built for
constexpr int kRows = 64;       // rows of a tile and of a warpgroup's slice
constexpr int kBlock64 = kRows * 128;  // bytes of a tile's 128-byte-swizzled block
constexpr int kBlock16 = kRows * 32;   // bytes of its 32-byte-swizzled block
constexpr int kTile = kBlock64 + kBlock16;  // one 64 x 80 bf16 tile

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `bar` with this parity to complete. A wait of more
// than about 2^34 cycles (some 10 s) is a broken pipeline, not a slow one:
// it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// One TMA box of a 3-D map (columns, rows, batch) into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(batch)
      : "memory");
}
// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The pair of maps of one operand: columns 0-63 and 64-79 of each head.
struct OperandMaps {
  CUtensorMap c64;
  CUtensorMap c16;
};

// Rows [row, row + 64) of head `head`, batch row `batch`, into a tile at
// `dst` (kTile bytes: the 128-byte block, then the 32-byte block).
__device__ __forceinline__ void load_tile(uint8_t* dst, const OperandMaps& m, uint64_t* bar,
                                          int head, int row, int batch) {
  tma_load(dst, &m.c64, bar, head * kDim, row, batch);
  tma_load(dst + kBlock64, &m.c16, bar, head * kDim + 64, row, batch);
}

// Register counts of the warp-specialised blocks (setmaxnreg): the producer
// warpgroup gives up registers to the two consumer warpgroups. 24 + 2 x 240
// = 504 = 512 - 8: the 168 a thread the launch bound gives, moved. Without it
// the dK/dV kernel spills in 168 registers and runs markedly slower.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// The same moves with the counts of another split (the fp32 route's forward,
// whose producer warpgroup converts and keeps more registers).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Every consumer warp arrives on a barrier that releases a buffer (the ring's
// empty[] and the resident buffers'), after its own last read of it: a
// warpgroup that skips a tile issues no wgmma, so nothing else keeps its four
// warps together, and a release by one warp for all four let a lagging warp
// miss a phase and wait for ever.
constexpr int kWarpsPerGroup = 4;

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128-byte, 3: 32-byte).
constexpr uint32_t kSwizzle128 = 1;
constexpr uint32_t kSwizzle32 = 3;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// Descriptors of a tile at shared address `tile` (kTile bytes), 64 rows from
// row `row0` of it, as the K-major operand of A B^T: the 128-byte block
// (8-row groups 1024 bytes apart; a k-step of 16 columns is 32 bytes on)
// and the 32-byte block (groups 256 bytes apart, one k-step).
struct KMajor {
  uint64_t c64, c16;
  __device__ __forceinline__ KMajor(uint32_t tile, int row0)
      : c64(make_desc(tile + row0 * 128, 16, 1024, kSwizzle128)),
        c16(make_desc(tile + kBlock64 + row0 * 32, 16, 256, kSwizzle32)) {}
};
// The same tile (64 rows from row 0) as the MN-major B of P B: a k-step is 16
// rows, 2048 bytes on in the 128-byte block and 512 in the 32-byte one;
// 8-row groups 1024 and 256 bytes apart.
struct MNMajor {
  uint64_t c64, c16;
  __device__ __forceinline__ explicit MNMajor(uint32_t tile)
      : c64(make_desc(tile, 8192, 1024, kSwizzle128)),
        c16(make_desc(tile + kBlock64, 2048, 256, kSwizzle32)) {}
};
// A descriptor advanced by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or reuses of wgmma operand registers
// across the asynchronous product (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

#define MTT_D4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x 64) = (accumulate ? d : 0) + A B^T over one k-step; A, B from
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MTT_D4(d, 0), MTT_D4(d, 1), MTT_D4(d, 2), MTT_D4(d, 3), MTT_D4(d, 4), MTT_D4(d, 5),
        MTT_D4(d, 6), MTT_D4(d, 7)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d[0..7] (64 x 64) += A B over one k-step: A in registers, B MN-major.
__device__ __forceinline__ void wgmma_rs64(float (&d)[10][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MTT_D4(d, 0), MTT_D4(d, 1), MTT_D4(d, 2), MTT_D4(d, 3), MTT_D4(d, 4), MTT_D4(d, 5),
        MTT_D4(d, 6), MTT_D4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d[8..9] (64 x 16) += A B over one k-step: A in registers, B MN-major.
__device__ __forceinline__ void wgmma_rs16(float (&d)[10][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : MTT_D4(d, 8), MTT_D4(d, 9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A B over one k-step: A in registers, B MN-major (head_dim 64).
__device__ __forceinline__ void wgmma_rs64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MTT_D4(d, 0), MTT_D4(d, 1), MTT_D4(d, 2), MTT_D4(d, 3), MTT_D4(d, 4), MTT_D4(d, 5),
        MTT_D4(d, 6), MTT_D4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- TF32 operands (the fp32 route of the causal kernels at head_dim 80,
// attention_fwd_tf32_hopper.cu, attention_bwd_tf32_hopper.cu): wgmma takes
// TF32 only K-major (no transpose flags), a k-step is 8 values (32 bytes),
// and the tensor cores read the 19 high bits of each 32-bit operand.
constexpr uint32_t kSwizzle64 = 2;  // the descriptor's 64-byte swizzle

// d (64 x 32) = (accumulate ? d : 0) + A B^T over one k-step of 8: A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[4][4], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : MTT_D4(d, 0), MTT_D4(d, 1), MTT_D4(d, 2), MTT_D4(d, 3)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 80) += A B over one k-step of 8: A in registers (per warp the A
// fragment of mma.sync m16n8k8), B K-major from shared memory.
__device__ __forceinline__ void wgmma_tf32_rs80(float (&d)[10][4], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : MTT_D4(d, 0), MTT_D4(d, 1), MTT_D4(d, 2), MTT_D4(d, 3), MTT_D4(d, 4), MTT_D4(d, 5),
        MTT_D4(d, 6), MTT_D4(d, 7), MTT_D4(d, 8), MTT_D4(d, 9)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef MTT_D4

// ---- head_dim 64 (the Chronos-2 route, chronos_attention_hopper.cu): a row
// of 64 bf16 values is exactly one 128-byte swizzle row, so a 64 x 64 tile is
// one TMA box of kTile64 bytes and one descriptor; A B^T takes four k-steps
// and P B runs N = 64.
constexpr int kDim64 = 64;
constexpr int kTile64 = kBlock64;

// Rows [row, row + 64) of head `head`, batch row `batch`, of a (B, S, H*64)
// map into a tile at `dst`.
__device__ __forceinline__ void load_tile64(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                            int head, int row, int batch) {
  tma_load(dst, m, bar, head * kDim64, row, batch);
}
// A 64-row tile at shared address `tile` as the K-major operand of A B^T, and
// as the MN-major B of P B (a k-step of 16 rows is 2048 bytes on).
__device__ __forceinline__ uint64_t kmajor64(uint32_t tile) {
  return make_desc(tile, 16, 1024, kSwizzle128);
}
__device__ __forceinline__ uint64_t mnmajor64(uint32_t tile) {
  return make_desc(tile, 8192, 1024, kSwizzle128);
}
// Issue acc = A B^T over 64 columns (four k-steps) and out += P B over 64
// rows of B; the caller fences, commits and waits.
__device__ __forceinline__ void issue_abt64(float (&acc)[8][4], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss64(acc, desc_add(a, kk * 32), desc_add(b, kk * 32), kk);
}
__device__ __forceinline__ void issue_pb64(float (&out)[8][4], const uint32_t (&p)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs64(out, p[kk], desc_add(b, kk * 2048));
}

// Issue acc = A B^T over the 80 columns (five k-steps); the caller fences,
// commits and waits.
__device__ __forceinline__ void issue_abt(float (&acc)[8][4], const KMajor& a, const KMajor& b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss64(acc, desc_add(a.c64, kk * 32), desc_add(b.c64, kk * 32), kk);
  wgmma_ss64(acc, a.c16, b.c16, 1);
}
// Issue out += P B over 64 rows of B (four k-steps of 16 rows; p[kk] the A
// fragment of rows 16 kk..16 kk + 15); the caller fences, commits and waits.
__device__ __forceinline__ void issue_pb(float (&out)[10][4], const uint32_t (&p)[4][4],
                                         const MNMajor& b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs64(out, p[kk], desc_add(b.c64, kk * 2048));
    wgmma_rs16(out, p[kk], desc_add(b.c16, kk * 512));
  }
}

// A fragments (hi, and lo when SPLIT) of a 64 x 64 accumulator tile for P B.
template <bool SPLIT>
__device__ __forceinline__ void tile_frags(const float (&x)[8][4], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mtt::a_frags<SPLIT>(x[2 * kk], x[2 * kk + 1], hi[kk], lo[kk]);
}

// Largest and sum over the quad of lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forward's mask on a 64 x 64 logit tile (rows `rows[0]`, `rows[1]` of
// this thread, keys k0 + 8 j + 2 t + e): keys past S get -inf (no term),
// causal-future and padded keys finfo(float32).min. `vb` is the batch row's
// key-valid bytes. The caller skips it where warp_unmasked holds.
__device__ __forceinline__ void mask_tile(float (&sc)[8][4], const uint8_t* vb, int k0,
                                          const int (&rows)[2], int S, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t + e;
      const bool in = col < S;
      const bool on = in && vb[col] != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = sc[j][2 * r + e];
        if (!in) {
          x = -INFINITY;
        } else if (col > rows[r] || !on) {
          x = -FLT_MAX;
        }
      }
    }
}

// Whether a warp's 16 rows (from row0) see every key of [k0, k0 + 64)
// unmasked: all keys before S, valid, and at or before row0. Called by all
// 32 lanes of the warp.
__device__ __forceinline__ bool warp_unmasked(const uint8_t* vb, int k0, int row0, int S,
                                              int lane) {
  const bool inside = k0 + kRows <= S && k0 + kRows - 1 <= row0;
  const bool ok = inside && vb[k0 + lane] != 0 && vb[k0 + 32 + lane] != 0;
  return __all_sync(0xffffffffu, ok);
}

// The first valid key in [0, limit) of a batch row's key-valid bytes `vb`
// (`limit` when there is none), for every lane of the calling warp.
__device__ __forceinline__ int warp_first_valid(const uint8_t* vb, int limit) {
  int f = limit;
  for (int i = threadIdx.x & 31; i < limit; i += 32) {
    if (vb[i]) {
      f = i;
      break;
    }
  }
  return __reduce_min_sync(0xffffffffu, f);
}

// Persistent blocks. Work items are tiles x B x H, the tile index slowest and
// the heaviest tile first (`reverse`: the last tile is the heaviest, as for
// query tiles under the causal mask; otherwise the first, as for key tiles).
// Block c of G takes item c in round 0, 2G - 1 - c in round 1, 2G + c in
// round 2, ...: the zigzag gives each block a heavy and a light item in turn,
// where taking c, c + G, c + 2G, ... gives the first blocks the heaviest item
// of every round (B3f: 544 items of 2 to 34 key tiles on 132 blocks, block 0
// with 90 key tiles against block 100's 64).
__device__ __forceinline__ int item_index(int round, int G) {
  return (round & 1) ? (round + 1) * G - 1 - (int)blockIdx.x : round * G + (int)blockIdx.x;
}
struct Item {
  int tile, b, h;
};
__device__ __forceinline__ Item item_at(int i, int B, int H, int tiles, bool reverse) {
  const int per = B * H;
  const int t = i / per;
  const int bh = i - t * per;
  return {reverse ? tiles - 1 - t : t, bh / H, bh % H};
}

}  // namespace hopper
}  // namespace mtt

// ------------------------------------------------------------------ host

namespace mtt {
namespace hopper {

// cuTensorMapEncodeTiled, taken from the driver through the runtime once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The two maps of one (B, S, H, 80) bf16 operand at `base` (element (b, s,
// h, d) at base[(b * S + s) * ld + h * 80 + d]): boxes of 64 rows by 64 or 16
// columns of one batch row; rows past S read as zeros.
inline cudaError_t encode_operand(OperandMaps* m, const void* base, int B, int S, int H,
                                  long long ld) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * kDim, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint32_t box64[3] = {64, kRows, 1};
  const cuuint32_t box16[3] = {16, kRows, 1};
  CUresult r = encode(&m->c64, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                      strides, box64, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  r = encode(&m->c16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box16, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of one (B, S, H, 64) bf16 operand at `base`, as encode_operand's:
// boxes of 64 rows by the 64 columns of one head, 128-byte swizzle.
inline cudaError_t encode_operand64(CUtensorMap* m, const void* base, int B, int S, int H,
                                    long long ld) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * kDim64, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint32_t box[3] = {64, kRows, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The two maps of one (B, S, H, 80) fp32 operand at `base` (element (b, s,
// h, d) at base[(b * S + s) * ld + h * 80 + d]) for tiles of `rows` rows:
// boxes of 32 columns (128 bytes, 128-byte swizzle; taken twice, at columns 0
// and 32 of a head) and of 16 columns (64 bytes, 64-byte swizzle); rows past
// S read as zeros.
struct F32Maps {
  CUtensorMap c32;
  CUtensorMap c16;
};
inline cudaError_t encode_f32(F32Maps* m, const void* base, int B, int S, int H, long long ld,
                              int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * kDim, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(ld) * 4 * static_cast<cuuint64_t>(S)};
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint32_t box32[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t box16[3] = {16, static_cast<cuuint32_t>(rows), 1};
  CUresult r = encode(&m->c32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                      strides, box32, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  r = encode(&m->c16, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
             box16, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether a (B, S, H, D) operand with row stride `ld` at `p` can be read by
// TMA as this route reads it: head_dim 80, rows and base 16-byte aligned.
inline bool tma_layout(const void* p, long long ld, int D) {
  return D == kDim && ld % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The launch's register file must hold the setmaxnreg split: a kernel
// compiled to fewer registers than its bound would leave the consumers'
// increase waiting for ever, so such a launch is refused instead.
template <typename Kernel>
inline cudaError_t check_regs(Kernel kernel, int threads) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * threads < kProducerRegs * 128 + (threads / 128 - 1) * kConsumerRegs * 128)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The same check for a split of `consumers` warpgroups at `consumer_regs`
// and `producers` at `producer_regs` registers a thread.
template <typename Kernel>
inline cudaError_t check_split(Kernel kernel, int consumers, int consumer_regs, int producers,
                               int producer_regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * 128 * (consumers + producers) <
      128 * (consumers * consumer_regs + producers * producer_regs))
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Blocks of a persistent launch: one per SM (a block holds an SM's
// registers), fewer when there are fewer work items.
inline int persistent_blocks(int items) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return items < sms ? items : sms;
}

// Dynamic shared memory is aligned here to the 1024 bytes the 128-byte
// swizzle repeats over.
constexpr int kAlign = 1024;
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

}  // namespace hopper
}  // namespace mtt
