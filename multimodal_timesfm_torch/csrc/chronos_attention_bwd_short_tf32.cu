// Chronos-2 T5 attention backward (B4b), fp32, head_dim 64, short sequences:
// the persistent 3xTF32 route fed by TMA for Hopper (sm_90a), plan route 6,
// taken by chronos_attention_bwd (chronos_attention_bwd.cu) where
// chronos_short_tf32_takes below says so, ahead of route 5
// (chronos_attention_bwd_tf32.cu).
//
// Replaces, in fp32 where the rule sends them here (S <= kShortTo), the
// Pallas TPU kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel :144 (B4b,
//       fused_chronos_attention's VJP, pallas_call :307)
// The function is route 5's (chronos_attention_bwd_tf32.cu:7-12): W =
// softmax(L) recomputed in fp32, dV = W^T G, dW = G V^T, dL = W o (dW - r)
// with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, dbias[h] = dL summed over
// the batch; nothing saved beyond qkv, seg and the bias. Every product is
// 3xTF32 (lo hi + hi lo + hi hi, the split chronos_tf32_short.cuh's), the
// softmax, r and dL fp32 on the CUDA cores.
//
// What bounds it on an H100: at Chronos-2's fine-tune (128 x 67 tokens x 12
// heads x 64) the bytes, 184.6 MB (qkv and g read once, dqkv written once,
// the bias and the ids): 0.0551 ms at 3.35 TB/s; the five products, 18.9
// GFLOP as 3xTF32 on the 80-row tiles, take 0.038 ms at 495 / 3 TFLOP/s.
// Route 5 before it ran one short-lived block per (80-row tile, head, batch
// row), each loading its bias strip and its tiles by per-thread cp.async
// before any product, and wrote W and dL to a device-memory scratch (78.6 MB
// at 128 x 67 x 12, written once and read twice: 0.047 ms of traffic alone).
//
// Design (chronos_tf32_short.cuh, hopper_short.cuh): one kernel, persistent
// blocks sized to the card, each owning one head and a contiguous range of
// batch rows (P = SMs x blocks an SM / H blocks a head: 11 at 12 heads). A
// producer warp keeps the next rows' q, k, v and g tiles (two 32-column TMA
// boxes each, read in place) and segment ids in flight through a ring of 2-4
// stages. One consumer group of 2 NQ warps (SP = 16 NQ, S rounded up to 16)
// takes every row of the range, two warps a 16-row block: per batch row,
//   1. the group writes k's and v's lo twins into the block's buffer;
//   2. warp (block, half) takes its 16 query rows against its half of the keys:
//      the logits start from the bias (read from L1 before the stage's wait),
//      S = bias + Q K^T, the segment mask at finfo(float32).min, dW = G V^T;
//      the halves exchange their row maxima, then their sums of e = exp(l -
//      m) and of e dW, through shared memory (a fixed order: half 0's, then
//      half 1's); W = e (1 / s), r = (sum e dW) / s, dL = W (dW - r), fp32;
//      W and dL to the buffer's staging (over the twins), g's lo twin over
//      the stage's v;
//   3. dQ = dL K for the warp's rows and its half of the output columns, dL
//      read from the staging;
//   4. phase B: dV = W^T G and dK = dL^T Q for the warp's 16 keys and its
//      half of the columns, in one loop over the query rows before 8 ceil(S
//      / 8), W^T and dL^T from the staging.
// Four barriers of the group a row. There is no W or dL scratch in device
// memory. Each warp adds its rows and keys of dL into dbias in registers over
// the block's rows, in batch order, and writes its part of the block's one
// (S, S) partial; the P partials are summed in order by
// chronos_bwd_dbias_kernel (none when P = 1). No atomics: two launches give
// bit-equal dqkv and dbias, and dqkv does not depend on whether dbias is
// asked for. The outputs go from the accumulators to device memory, 8 bytes
// a lane (whole 32-byte sectors).
//
// Shared memory: one stage of q, k, v and g is 4 SP x 256 bytes (81,920 at SP
// = 80) and the buffer 2 SP (SP + 4) x 4 bytes (53,760), so at SP = 64-80 the
// ring holds two stages (220 KB of 227 in all), four up to 48: route 4's
// bf16 layout (three stages, two groups of warps on alternate rows, each with
// its own staging) does not fit in fp32, hence one group on each row, split
// by keys. Eleven warps a block (S = 65-80), one block an SM, leave a thread
// 184 registers; the dbias instantiations spill 4 bytes.
//
// Measured and dropped (B4b 128 x 67 x 12 without / with dbias, held ms, one
// H100 80GB HBM3 at 700 W, route 5 0.215 / 0.240 in each call): one warp a
// 16-row block (five warps, W and dL staged, each warp splitting every
// operand it read) 0.222 / 0.236; the same with tf32_common's rounded split
// 1-3% slower than the truncation split; k's and v's twins 0.209 / 0.216;
// g's and q's twins for phase B too, no gain there (g's is kept: it costs no
// barrier in the design above; q's would); the per-lane address tables
// (chronos_tf32_short.cuh) 0.174 / 0.185; two warps a block, as above, 0.163
// / 0.169; phase B's two products in one loop over 8 ceil(S / 8) query rows
// 0.156 / 0.161. Issuing each k-step's lo hi, hi lo and hi hi products in
// three sweeps over the n-tiles (the products of a mma3 are dependent) moved
// nothing (within 2%). A build with no split at all (wrong results, timing
// only) read 0.164 and one with one TF32 product a pair 0.119, at the first
// design: the tensor cores' mma.sync rate and the barriers' latency hold it.
//
// mma.sync m16n8k8 fed by TMA, not wgmma: at S = 67 wgmma pads the query rows
// to 128 (1.6x the products with N = 80 keys), takes TF32 only K-major from
// shared memory (W V and the P^T Y products would need transposes staged, as
// route 5 of the causal kernels does with its converting warps), and the
// products at the 3xTF32 rate take 0.038 ms against the 0.0551 ms byte bound.

#include "chronos_tf32_short.cuh"

#include <math.h>

namespace {

using namespace mtt::tf32_short;

constexpr int kOperands = 4;  // q, k, v, g
constexpr int kMaxStagesB = 4;
// The longest S this route takes: the longest it is built for, and the border
// it is measured faster up to (chip_smoke.py's [gate] chronos fp32 persistent
// lines: the faster by 14-53% at every S = 16-80 measured, without and with
// dbias, H100 80GB HBM3 at 700 W).
constexpr int kShortTo = 80;

template <int NQ>
struct Cfg {
  static constexpr int SP = 16 * NQ;  // rows of the tiles = keys of a logit row
  static constexpr int NT = SP / 8;
  static constexpr int GW = 2 * NQ;   // warps of the consumer group: two a 16-row block
  static constexpr int NC = 32 * GW;  // consumer threads
  static constexpr int THREADS = NC + 32;
  static constexpr int TILE = SP * kTileRow;  // a multiple of 1024
  static constexpr int STAGE = kOperands * TILE;
  static constexpr int LDW = SP + 4;  // staging rows: 4 mod 8 floats apart (load_at's banks)
  // The block's buffer beside the ring, reused within a row: k's and v's lo
  // twins (S = bias + Q K^T and dW = G V^T), then dL's and W's staging.
  static constexpr int PLANE = SP * LDW * 4;  // W's or dL's staging
  static constexpr int STAGING = 2 * PLANE > 2 * TILE ? 2 * PLANE : 2 * TILE;
  static constexpr int SWAP = 3 * 2 * SP * 4;  // the halves' row maxima and sums
  // Beside the ring: the alignment slack, the buffer, the halves' exchange,
  // each stage's segment ids, the barriers.
  static constexpr int FIXED = kAlign + STAGING + SWAP + kMaxStagesB * SP * 4 + 16 * kMaxStagesB + 8;
  static constexpr int STAGES = stages_fit(FIXED, STAGE, kMaxStagesB);
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring does not fit");
};

// NTK: the 8-key blocks of a logit row dQ takes, ceil(S / 8): 2 NQ, or 2 NQ -
// 1 where the last block lies past S.
template <int NQ, int NTK, bool DBIAS>
__global__ void __launch_bounds__(Cfg<NQ>::THREADS, 1)
    chronos_bwd_short_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm,
                                  const __grid_constant__ CUtensorMap gm,
                                  const int* __restrict__ seg, const float* __restrict__ bias,
                                  float* __restrict__ dqkv, float* __restrict__ dbias, int B,
                                  int S, int H, int P) {
  using C = Cfg<NQ>;
  static_assert(NTK == C::NT || NTK == C::NT - 1, "NTK is ceil(S / 8)");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  const uint32_t twins = ring + C::STAGES * C::STAGE;  // k's lo twin, then v's
  float* dst = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);  // dL's staging
  float* wst = dst + C::SP * C::LDW;                                  // W's
  float* swap = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE + C::STAGING);
  int* segs = reinterpret_cast<int*>(swap + 3 * 2 * C::SP);
  uint64_t* full = reinterpret_cast<uint64_t*>(segs + C::STAGES * C::SP);
  uint64_t* empty = full + C::STAGES;
  uint64_t* freed = empty + C::STAGES;  // the buffer read by every warp of the group
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x / P;
  const int part = blockIdx.x - h * P;
  const int b0 = (int)((long long)part * B / P);
  const int nb = (int)((long long)(part + 1) * B / P) - b0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, kFullArrivals);
      mbar_init(empty + s, C::GW);
    }
    mbar_init(freed, C::GW);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::GW) {
    const CUtensorMap* const maps[kOperands] = {&qm, &km, &vm, &gm};
    produce<kOperands, C::SP, C::STAGES, C::STAGE>(maps, smem, segs, full, empty, seg, S, h, b0, nb, lane);
    return;
  }

  // Consumers: warp w takes the 16-row block r0 = 16 (w % NQ) and half kh = w /
  // NQ: the keys [8 NQ kh, 8 NQ (kh + 1)) of its query rows (S, dW, W, dL) and
  // the output columns [32 kh, 32 kh + 32) of its rows' dQ and of its keys' dK
  // and dV.
  const int kh = warp / NQ;
  const int r0 = 16 * (warp - kh * NQ);
  const int kb = 8 * NQ * kh;
  const int t = lane & 3;
  const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  const Lanes z(lane);
  const float* const bias_h = bias + (long long)h * S * S + 2 * t;
  const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S,
                                bias_h + (long long)min(rows[1], S - 1) * S};
  const long long hd = (long long)H * kD;
  const long long ld = 3 * hd;
  float* const mx = swap;              // [2][SP]: each half's row maxima
  float2* const sm = reinterpret_cast<float2*>(swap + 2 * C::SP);  // [2][SP]: sums of e and of e dW
  float db[DBIAS ? NQ : 1][4];
  zero(db);

  for (int j = 0; j < nb; ++j) {
    const int st = j % C::STAGES;
    const int* sg = segs + st * C::SP;
    const uint32_t sb = ring + st * C::STAGE;
    const Tile32 Qt(sb, C::SP), Kt(sb + C::TILE, C::SP, twins - (sb + C::TILE)),
        Vt(sb + 2 * C::TILE, C::SP, twins + C::TILE - (sb + 2 * C::TILE)), Gt(sb + 3 * C::TILE, C::SP);
    float* out = dqkv + (long long)(b0 + j) * S * ld + (long long)h * kD + 32 * kh;
    {
      // Phase A on the warp's half of the keys.
      float sc[NQ][4], dw[NQ][4];
      bias_start(sc, brow, S, t, kb);
      zero(dw);
      // The buffer is free once every warp read the previous row's staging.
      if (j >= 1) mbar_wait(freed, (j - 1) & 1);
      wait_row<C::STAGES, 1>(full, empty, j);
      write_lo(sb + C::TILE, twins, 2 * C::TILE, threadIdx.x, C::NC);
      named_sync(1, C::NC);  // k's and v's twins written
      xyt<NQ, true>(sc, Qt, r0, Kt, z, NQ * kh);
      xyt<NQ, true>(dw, Gt, r0, Vt, z, NQ * kh);
      segment_mask_at(sc, sg, rows, S, t, kb);
      float m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = -INFINITY;
#pragma unroll
        for (int n = 0; n < NQ; ++n) x = fmaxf(x, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        m[r] = quad_max(x);
        if (t == 0) mx[kh * C::SP + rows[r]] = m[r];
      }
      // The halves' maxima in; every warp's products done, so the twins and the
      // stage's v are free: g's lo twin takes v's slot.
      named_sync(1, C::NC);
      write_lo(sb + 3 * C::TILE, sb + 2 * C::TILE, C::TILE, threadIdx.x, C::NC);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(mx[rows[r]], mx[C::SP + rows[r]]);
        float se = 0.f, sd = 0.f;
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = mtt::fast_exp(sc[n][2 * r + e] - m[r]);
            sc[n][2 * r + e] = x;
            se += x;
            sd = fmaf(x, dw[n][2 * r + e], sd);
          }
        se = quad_sum(se);
        sd = quad_sum(sd);
        if (t == 0) sm[kh * C::SP + rows[r]] = make_float2(se, sd);
      }
      named_sync(1, C::NC);  // the halves' sums in
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 a = sm[rows[r]], b = sm[C::SP + rows[r]];
        const float inv = 1.f / (a.x + b.x);
        const float rr = (a.y + b.y) * inv;
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int at = rows[r] * C::LDW + kb + n * 8 + 2 * t;
          const float w0 = sc[n][2 * r] * inv, w1 = sc[n][2 * r + 1] * inv;
          const float d0 = w0 * (dw[n][2 * r] - rr), d1 = w1 * (dw[n][2 * r + 1] - rr);
          *reinterpret_cast<float2*>(wst + at) = make_float2(w0, w1);
          *reinterpret_cast<float2*>(dst + at) = make_float2(d0, d1);
          sc[n][2 * r] = d0;
          sc[n][2 * r + 1] = d1;
        }
      }
      if constexpr (DBIAS) {
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) db[n][e] += sc[n][e];
      }
    }
    named_sync(1, C::NC);  // W and dL staged, g's twin written, by every warp
    float acc[4][4];
    // dQ = dL K for the warp's rows and columns, dL from the staging.
    staged_py<NTK, C::LDW, false, 4>(acc, dst, r0, Kt, z, lane, 4 * kh);
    store_rows(out, ld, acc, r0, S, lane);
    // Phase B: dV = W^T G and dK = dL^T Q, for the warp's 16 keys r0.. and its
    // columns, over the query rows before 8 NTK.
    const Tile32 Gb(sb + 3 * C::TILE, C::SP, 0u - C::TILE);  // g's twin in v's slot
    float dk[4][4];
    ptys<NTK, C::LDW, true, 4>(acc, dk, wst, dst, r0, Gb, Qt, z, lane, 4 * kh);
    fence_async_shared();  // g's twin written to the stage before its next TMA load
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(freed);       // this warp's last read of the buffer
      mbar_arrive(empty + st);  // and of the stage
    }
    store_rows(out + 2 * hd, ld, acc, r0, S, lane);
    store_rows(out + hd, ld, dk, r0, S, lane);
  }

  if constexpr (DBIAS) {
    float* plane = dbias + ((long long)part * H + h) * S * S;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = kb + n * 8 + 2 * t + (e & 1);
        if (row < S && col < S) plane[(long long)row * S + col] = db[n][e];
      }
  }
}

template <int NQ, int NTK, bool DBIAS>
cudaError_t launch(const CUtensorMap (&maps)[kOperands], const int* seg, const float* bias,
                   float* dqkv, float* dbias, int B, int S, int H, int P, cudaStream_t stream) {
  using C = Cfg<NQ>;
  auto* kernel = chronos_bwd_short_tf32_kernel<NQ, NTK, DBIAS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<H * P, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3], seg, bias,
                                                  dqkv, dbias, B, S, H, P);
  return cudaGetLastError();
}

template <int NQ, int NTK>
cudaError_t launch_db(bool db, const CUtensorMap (&maps)[kOperands], const int* seg,
                      const float* bias, float* dqkv, float* dbias, int B, int S, int H, int P,
                      cudaStream_t stream) {
  return db ? launch<NQ, NTK, true>(maps, seg, bias, dqkv, dbias, B, S, H, P, stream)
            : launch<NQ, NTK, false>(maps, seg, bias, dqkv, dbias, B, S, H, P, stream);
}

// Blocks an SM holds at once of the NQ instantiation (with dbias), or 0 on
// an error.
template <int NQ>
int blocks_per_sm() {
  using C = Cfg<NQ>;
  auto* kernel = chronos_bwd_short_tf32_kernel<NQ, 2 * NQ, true>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM) !=
      cudaSuccess)
    return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::THREADS, C::SMEM) ==
                 cudaSuccess
             ? n
             : 0;
}

int per_sm(int nq) {
  switch (nq) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    default: return blocks_per_sm<5>();
  }
}

}  // namespace

extern "C" int mtt_chronos_route_override();

// Whether make_plan (chronos_common.cuh) gives an fp32 backward at (S, D)
// this route: head_dim 64 and S <= kShortTo; under the route override
// (chronos_set_route) 6 at every S it is built for, never under 4 (the CUDA
// cores), 5 (route 5) or 7 (route 7).
extern "C" int chronos_short_tf32_takes(int S, int D) {
  const int force = mtt_chronos_route_override();
  return D == kD && S >= 1 && S <= kShortTo && force != 4 && force != 5 && force != 7;
}

extern "C" int chronos_short_tf32_threads(int S) { return 32 * (2 * ((S + 15) / 16) + 1); }

// Blocks a head (the dbias partials, one a block): as many as fill the card
// once, at most B.
extern "C" int chronos_short_tf32_groups(int B, int S, int H) {
  static int cached[6] = {0, 0, 0, 0, 0, 0};
  const int nq = (S + 15) / 16;
  if (nq < 1 || nq > 5) return 1;
  if (cached[nq] == 0) cached[nq] = per_sm(nq);
  const int blocks = persistent_blocks(1 << 30) * (cached[nq] > 0 ? cached[nq] : 1);
  const int p = blocks / H;
  return p < 1 ? 1 : p > B ? B : p;
}

// qkv (B, S, 3*H*64), g (B, S, H*64) and dqkv (B, S, 3*H*64) fp32,
// contiguous, qkv and g 16-byte aligned, dqkv 8-byte aligned (refused
// otherwise); seg (B, S) int32; bias (H, S, S) fp32; dbias: null, or
// `groups` (= chronos_short_tf32_groups) (H, S, S) fp32 planes, each the sum
// of dL over one block's range of batch rows (plane 0 is dbias itself when
// groups = 1). Launches on `stream`.
extern "C" int chronos_short_tf32_bwd(const void* qkv, const void* seg, const void* bias,
                                      const void* g, void* dqkv, void* dbias, int groups, int B,
                                      int S, int H, void* stream) {
  if (S < 1 || S > kShortTo || groups < 1) return (int)cudaErrorInvalidValue;
  if (!aligned16(qkv) || !aligned16(g) || (reinterpret_cast<uintptr_t>(dqkv) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int nq = (S + 15) / 16;
  const long long hd = (long long)H * kD;
  const auto* base = static_cast<const float*>(qkv);
  CUtensorMap maps[kOperands];
  const void* bases[kOperands] = {base, base + hd, base + 2 * hd, g};
  for (int o = 0; o < kOperands; ++o) {
    const cudaError_t err =
        encode_f32_rows(&maps[o], bases[o], B, S, (int)hd, o == 3 ? hd : 3 * hd, 16 * nq);
    if (err != cudaSuccess) return (int)err;
  }
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  float* out = static_cast<float*>(dqkv);
  float* db = static_cast<float*>(dbias);
  const bool with = db != nullptr;
  const int P = groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool odd = (S + 7) / 8 < 2 * nq;  // the last 8-key block lies past S
  cudaError_t err;
  switch (nq) {
    case 1: err = launch_db<1, 2>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 2: err = launch_db<2, 4>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 3: err = launch_db<3, 6>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    case 4: err = launch_db<4, 8>(with, maps, sg, bs, out, db, B, S, H, P, st); break;
    default:
      err = odd ? launch_db<5, 9>(with, maps, sg, bs, out, db, B, S, H, P, st)
                : launch_db<5, 10>(with, maps, sg, bs, out, db, B, S, H, P, st);
  }
  return (int)err;
}
