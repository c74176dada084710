// Chronos-2 T5 attention backward (B4b), fp32, head_dim 64: the 3xTF32
// tensor-core route for Hopper (sm_90a), taken by chronos_attention_bwd
// (chronos_attention_bwd.cu) when make_plan gives route 5
// (chronos_tf32_takes in chronos_attention_tf32.cu, whose header gives the
// arithmetic and the forward's design; shared pieces in chronos_tf32.cuh and tf32_common.cuh).
//
// Replaces, where the rule sends them here, the Pallas TPU kernel
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// in fp32: W = softmax(L) recomputed in fp32, dV = W^T G, dW = G V^T, dL =
// W o (dW - r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, dbias[h] =
// dL summed over the batch; nothing saved by the forward beyond qkv, seg and
// the bias.
//
// Design: three kernels on the caller's stream for each chunk of batch rows
// (chunk_rows: as many as keep the scratch within 1 GiB), tiles as the
// forward's (one tile of S padded to 16 up to 80 tokens, else 64 rows), every
// product 3xTF32 on mma.sync m16n8k8, no atomics (two launches give bit-equal
// dqkv and dbias):
//   1. dq: one block per (query tile, head, batch row), a warp per 16 query
//      rows, Q and G resident, K and V through a two-slot cp.async ring. Pass
//      1 walks the keys for S = Q K^T and dW = G V^T, an online max m, sum s
//      and t = sum exp(l - m) dW per row, so r = t / s; pass 2 walks them
//      again for W = exp(l - m) (1 / s), dL = W (dW - r) and dQ += dL K, and
//      writes each tile pair's W and dL to a scratch of (chunk rows, H) x
//      tile pairs (rows past S as zeros). With one tile the two passes are one walk.
//   2. dkdv: one block per (key tile, head, batch row), a warp per 16 keys:
//      per query tile, dV += W^T G and dK += dL^T Q, W^T and dL^T read as A
//      operands from kernel 1's tiles in shared memory, Q and G as B
//      operands. Two products a tile pair, no exponentials, no bias.
//   3. dbias, only when the bias trains: each element the sum of kernel 1's
//      dL over the chunk's rows, in batch order, added to the chunks' before.
// Why W and dL go through memory: recomputing them for dK and dV (S^T = K
// Q^T and dW^T = V G^T again, the bias gathered transposed, the
// exponentials) cost four products a tile pair against two, and dbias
// recomputed them once more for every batch group (PERF.md's findings have
// the measured kernels of both designs). The two fp32 tensors (B H tile pairs
// of KT^2 each: 629 MB at 16 x 577 x 12, one chunk) are
// written once and read once. The
// forward's output is not saved, so r = rowsum(G o O) is not to be had, and
// the statistics pass stays.
//
// What bounds it on an H100: at 16 x 577 x 12 the five products of the least
// work take 0.248 ms at the 3xTF32 rate (495 / 3 TFLOP/s); the route runs
// seven (pass 1's two, pass 2's three, kernel 2's two) at mma.sync's share of
// that rate, plus each operand's split, and moves the scratch (1.3 GB
// written and read at 16 x 577, 0.38 ms at 3.35 TB/s).

#include "chronos_tf32.cuh"

namespace {

using namespace mtt::tf32;

// Row stride of a W or dL tile in shared memory: at least KT, 4 mod 32 (load_at's banks).
__host__ __device__ constexpr int ldw(int KT) { return (KT - 4 + 31) / 32 * 32 + 4; }

// Kernel 1: row statistics, W and dL to the scratch, and dQ, for one query tile.
template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    chronos_bwd_dq_tf32_kernel(const float* __restrict__ qkv, const int* __restrict__ seg,
                               const float* __restrict__ bias, const float* __restrict__ g,
                               float* __restrict__ dqkv, float* __restrict__ wd, int S, int H) {
  constexpr int NT = KT / 8;
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  extern __shared__ __align__(16) float smem[];
  const int nkt = (S + KT - 1) / KT;
  const bool one = nkt == 1;
  const int items = one ? 1 : 2 * nkt;
  const int stages = one ? 1 : 2;
  float* Qs = smem;                                            // TILE
  float* Gs = Qs + TILE;                                       // TILE
  float* ring = Gs + TILE;                                     // stages x (K, V) tiles
  int* Sq = reinterpret_cast<int*>(ring + 2 * stages * TILE);  // KT query segments
  int* Sk = Sq + KT;                                           // stages x KT key segments

  const int qt = blockIdx.x;
  const int q0 = qt * KT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * kD;
  const long long ld = 3 * hd;
  const long long bh = (long long)b * H + h;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * kD;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  // W of tile pair (qt, kt) is the KT x KT tile (bh nt + qt) nt + kt of wd;
  // dL the same tile one plane of B H nt nt tiles further.
  float* w_out = wd + (bh * nkt + qt) * nkt * KT * KT;
  const long long dl_plane = (long long)gridDim.z * H * nkt * nkt * KT * KT;
  auto tile_of = [&](int it) { return (it < nkt ? it : it - nkt) * KT; };
  auto prefetch = [&](int it) {
    const int slot = it & (stages - 1);
    const int k0 = tile_of(it);
    load_tile<kD, kLd, KT, NTHREADS>(ring + 2 * slot * TILE, qb + hd, ld, k0, S);
    load_tile<kD, kLd, KT, NTHREADS>(ring + (2 * slot + 1) * TILE, qb + 2 * hd, ld, k0, S);
    load_seg(Sk + slot * KT, seg_b, k0, S, KT);
    mtt::cp_async_commit();
  };
  load_tile<kD, kLd, KT, NTHREADS>(Qs, qb, ld, q0, S);
  load_tile<kD, kLd, KT, NTHREADS>(Gs, g + (long long)b * S * hd + (long long)h * kD, hd, q0, S);
  load_seg(Sq, seg_b, q0, S, KT);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  const float* const brow0[2] = {bias_h + (long long)min(rows[0], S - 1) * S,
                                 bias_h + (long long)min(rows[1], S - 1) * S};
  float m[2] = {-FLT_MAX, -FLT_MAX}, s[2] = {0.f, 0.f}, t[2] = {0.f, 0.f}, rr[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  int sq[2];

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    if (it == 0) {
      sq[0] = Sq[wr + (lane >> 2)];
      sq[1] = Sq[wr + (lane >> 2) + 8];
    }
    const int slot = it & (stages - 1);
    const float* Ks = ring + 2 * slot * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = tile_of(it);
    float sc[NT][4], dw[NT][4];
    xyt<kD, kLd, NT>(sc, Qs, wr, Ks, lane);
    xyt<kD, kLd, NT>(dw, Gs, wr, Vs, lane);
    const float* const brow[2] = {brow0[0] + k0, brow0[1] + k0};
    bias_mask<NT, false>(sc, brow, sq, Sk + slot * KT, k0, S, lane);
    if (one || it < nkt) {
      // Pass 1: online row max m, this lane's part of s = sum exp(l - m) and
      // of t = sum exp(l - m) dW (the rescaling is the same on the quad).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -FLT_MAX;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        const float nm = fmaxf(m[r], quad_max(mx));
        const float scale = mtt::fast_exp(m[r] - nm);
        float ps = 0.f, pt = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = mtt::fast_exp(sc[n][2 * r + e] - nm);
            ps += x;
            pt = fmaf(x, dw[n][2 * r + e], pt);
          }
        s[r] = s[r] * scale + ps;
        t[r] = t[r] * scale + pt;
        m[r] = nm;
      }
      if (one || it + 1 == nkt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[r] = quad_sum(s[r]);
          rr[r] = quad_sum(t[r]) / s[r];
          inv[r] = 1.f / s[r];
        }
      }
      if (!one) continue;
    }
    // Pass 2: W = exp(l - m) (1 / s) and dL = W (dW - r) to the scratch (0 on
    // rows past S), then dQ += dL K.
    float* wt = w_out + (long long)(k0 / KT) * KT * KT + (wr + (lane >> 2)) * KT + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < S;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float2 w, dl;
        w.x = in ? mtt::fast_exp(sc[n][2 * r] - m[r]) * inv[r] : 0.f;
        w.y = in ? mtt::fast_exp(sc[n][2 * r + 1] - m[r]) * inv[r] : 0.f;
        dl.x = w.x * (dw[n][2 * r] - rr[r]);
        dl.y = w.y * (dw[n][2 * r + 1] - rr[r]);
        sc[n][2 * r] = dl.x;
        sc[n][2 * r + 1] = dl.y;
        float* p = wt + 8 * r * KT + 8 * n;
        *reinterpret_cast<float2*>(p) = w;
        *reinterpret_cast<float2*>(p + dl_plane) = dl;
      }
    }
    py<kD, kLd, NT>(dq, sc, Ks, lane);
  }
  const float one_[2] = {1.f, 1.f};
  store_tile<kD>(dqkv + (long long)b * S * ld + (long long)h * kD, ld, dq, q0 + wr, one_, S, lane);
}

// Kernel 2: dK and dV for one key tile, from kernel 1's W and dL tiles.
template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    chronos_bwd_dkdv_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                                 const float* __restrict__ wd, float* __restrict__ dqkv, int S,
                                 int H) {
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  constexpr int LDW = ldw(KT);
  constexpr int WTILE = KT * LDW;
  extern __shared__ __align__(16) float smem[];
  const int nqt = (S + KT - 1) / KT;
  float* Qt = smem;        // TILE
  float* Gt = Qt + TILE;   // TILE
  float* Wt = Gt + TILE;   // WTILE: W of the tile pair, rows queries
  float* Dt = Wt + WTILE;  // WTILE: dL

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * kD;
  const long long ld = 3 * hd;
  const long long bh = (long long)b * H + h;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * kD;
  const float* gb = g + (long long)b * S * hd + (long long)h * kD;
  const long long dl_plane = (long long)gridDim.z * H * nqt * nqt * KT * KT;
  auto load = [&](int it) {
    load_tile<kD, kLd, KT, NTHREADS>(Qt, qb, ld, it * KT, S);
    load_tile<kD, kLd, KT, NTHREADS>(Gt, gb, hd, it * KT, S);
    const float* src = wd + ((bh * nqt + it) * nqt + kt) * KT * KT;
    for (int i = threadIdx.x; i < KT * KT / 4; i += NTHREADS) {
      const int r = i / (KT / 4);
      const int c = (i - r * (KT / 4)) * 4;
      mtt::cp_async16(Wt + r * LDW + c, src + r * KT + c, true);
      mtt::cp_async16(Dt + r * LDW + c, src + dl_plane + r * KT + c, true);
    }
    mtt::cp_async_commit();
  };
  load(0);

  const int lane = threadIdx.x & 31;
  const int wk = (threadIdx.x >> 5) * 16;
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  for (int it = 0; it < nqt; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    pty<kD, kLd, KT, LDW>(dv, Wt, wk, Gt, lane);
    pty<kD, kLd, KT, LDW>(dk, Dt, wk, Qt, lane);
    if (it + 1 < nqt) {  // one slot: refill it once every warp is done with it
      __syncthreads();
      load(it + 1);
    }
  }
  const float one_[2] = {1.f, 1.f};
  float* ob = dqkv + (long long)b * S * ld + (long long)h * kD;
  store_tile<kD>(ob + hd, ld, dk, kt * KT + wk, one_, S, lane);
  store_tile<kD>(ob + 2 * hd, ld, dv, kt * KT + wk, one_, S, lane);
}

// Kernel 3: dbias[h][i][j] = sum over the batch, in order, of kernel 1's dL:
// this chunk's B rows added to the sum of the chunks before it (`carry`).
__global__ void __launch_bounds__(256)
    chronos_bwd_dbias_tf32_kernel(const float* __restrict__ dl, float* __restrict__ dbias, int B,
                                  int S, int H, int KT, bool carry) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)H * S * S) return;
  const int h = (int)(e / ((long long)S * S));
  const int i = (int)(e / S - (long long)h * S);
  const int j = (int)(e - ((long long)h * S + i) * S);
  const int nt = (S + KT - 1) / KT;
  const long long tile = (long long)KT * KT;
  const float* p = dl + ((long long)h * nt + i / KT) * nt * tile + (j / KT) * tile +
                   (i % KT) * KT + j % KT;
  const long long step = (long long)H * nt * nt * tile;  // one batch row
  float acc = carry ? dbias[e] : 0.f;
  for (int b = 0; b < B; ++b) acc += p[b * step];
  dbias[e] = acc;
}

template <typename K>
cudaError_t allow(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// W and dL of one batch row (floats): H tile pairs of KT^2 each, twice.
long long row_floats(int S, int H) {
  const long long KT = tile_rows(S);
  const long long nt = (S + KT - 1) / KT;
  return 2LL * H * nt * nt * KT * KT;
}

// The backward runs in chunks of batch rows whose W and dL fit kScratchFloats
// (1 GiB; 39 MB a row at 577 tokens and 12 heads, 4 GiB past 100 rows), at
// least one row a chunk, the chunks as even as their count allows: the
// transient memory of a call stays bounded at any batch and no shape leaves
// the route. Chunks cost waves: 256 MiB (16 x 577 x 12 in three chunks of
// 6 rows, a partial wave each) took B4b 1.65 -> 1.84 ms (PERF.md), so the
// budget keeps Chronos-2's main-path shapes (16 x 577 x 12: 629 MB) whole.
constexpr long long kScratchFloats = 1LL << 28;

int chunk_rows(int B, int S, int H) {
  const long long fit = std::max(1LL, kScratchFloats / row_floats(S, H));
  const int most = (int)std::min<long long>(B, fit);
  const int chunks = (B + most - 1) / most;
  return (B + chunks - 1) / chunks;
}

template <int KT>
cudaError_t launch_bwd(const float* qkv, const int* seg, const float* bias, const float* g,
                       float* dqkv, float* dbias, float* scratch, int B, int S, int H,
                       cudaStream_t stream) {
  const int nt = (S + KT - 1) / KT;
  const int stages = nt > 1 ? 2 : 1;
  const size_t smem_dq = sizeof(float) * (size_t)(2 + 2 * stages) * KT * kLd +
                         sizeof(int) * (size_t)(1 + stages) * KT;
  const size_t smem_dkdv = sizeof(float) * (size_t)2 * KT * (kLd + ldw(KT));
  cudaError_t err;
  if ((err = allow(chronos_bwd_dq_tf32_kernel<KT>, smem_dq)) != cudaSuccess) return err;
  if ((err = allow(chronos_bwd_dkdv_tf32_kernel<KT>, smem_dkdv)) != cudaSuccess) return err;
  const long long ld = 3LL * H * kD, hd = (long long)H * kD;
  const int rows = chunk_rows(B, S, H);
  for (int b0 = 0; b0 < B; b0 += rows) {
    // The chunk's rows as a batch of their own: its tensors from row b0 on.
    const int nb = std::min(rows, B - b0);
    const long long t0 = (long long)b0 * S;
    const float* q = qkv + t0 * ld;
    const float* gc = g + t0 * hd;
    float* dq = dqkv + t0 * ld;
    const dim3 grid(nt, H, nb);
    chronos_bwd_dq_tf32_kernel<KT><<<grid, 2 * KT, smem_dq, stream>>>(q, seg + t0, bias, gc, dq,
                                                                      scratch, S, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chronos_bwd_dkdv_tf32_kernel<KT><<<grid, 2 * KT, smem_dkdv, stream>>>(q, gc, scratch, dq, S, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (dbias == nullptr) continue;
    const long long n = (long long)H * S * S;
    chronos_bwd_dbias_tf32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        scratch + nb * row_floats(S, H) / 2, dbias, nb, S, H, KT, b0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of scratch the route's backward needs at (B, S, H): W and dL of one
// chunk of batch rows.
extern "C" long long chronos_tf32_scratch(int B, int S, int H) {
  return chunk_rows(B, S, H) * row_floats(S, H);
}

// qkv (B, S, 3*H*64), g (B, S, H*64) and dqkv (B, S, 3*H*64) fp32,
// contiguous, qkv and g 16-byte aligned, dqkv 8-byte aligned; seg (B, S)
// int32; bias (H, S, S) fp32; scratch: chronos_tf32_scratch(B, S, H) floats,
// 16-byte aligned; dbias: null, or the (H, S, S) fp32 bias gradient, written
// whole. Launches on `stream`.
extern "C" int chronos_tf32_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                                void* dqkv, void* dbias, void* scratch, int B, int S, int H,
                                void* stream) {
  if (!aligned16(qkv) || !aligned16(g) || !aligned16(scratch) ||
      (reinterpret_cast<uintptr_t>(dqkv) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* q = static_cast<const float*>(qkv);
  const auto* sg = static_cast<const int*>(seg);
  const auto* bs = static_cast<const float*>(bias);
  const auto* gg = static_cast<const float*>(g);
  auto* dq = static_cast<float*>(dqkv);
  auto* db = static_cast<float*>(dbias);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
#define MTT_LAUNCH(KT) return (int)launch_bwd<KT>(q, sg, bs, gg, dq, db, sc, B, S, H, st)
  switch (tile_rows(S)) {
    case 16: MTT_LAUNCH(16);
    case 32: MTT_LAUNCH(32);
    case 48: MTT_LAUNCH(48);
    case 64: MTT_LAUNCH(64);
    default: MTT_LAUNCH(80);
  }
#undef MTT_LAUNCH
}
