// Causal + key-padding attention backward (B1b, B2b, B3b), fp32, head_dim 80:
// the 3xTF32 tensor-core route for Hopper (sm_90a), taken by attention_bwd
// (attention_bwd.cu) where tf32_bwd_takes and tf32_bwd_layout below hold
// (attention_fwd_tf32.cu's header gives the arithmetic and the forward's
// design; shared pieces in attention_tf32.cuh and tf32_common.cuh).
//
// Replaces, where the rule sends them here, in fp32:
//   multimodal_timesfm_tpu/ops/qkv_attention.py  _bwd_kernel (B1b)
//   multimodal_timesfm_tpu/ops/attention.py      _attn_bwd_kernel (B2b)
// and the backward of the library flash kernel behind flash_causal_attention
// (B3b): W = softmax(mask(Q K^T)) recomputed in fp32 (JAX keeps W in fp32:
// qkv_attention.py:175, attention.py:205), dV = W^T G, dW = G V^T, dL = W o
// (dW - r) with r = rowsum(dW o W), dQ = dL K, dK = dL^T Q, the mask
// attention_bwd.cu's.
//
// Design: two kernels on the caller's stream for each chunk of work items
// (batch row, head), every product 3xTF32 on mma.sync m16n8k8, tiles as the
// forward's (one tile of S padded to 16 up to 80 tokens, else 64 rows), no
// atomics (two launches give bit-equal dq, dk and dv):
//   1. dq: one block per (work item, query tile), the longest key walk
//      first; a warp per 16 query rows, Q and G resident, K through a
//      two-slot cp.async ring and V through one slot refilled once dW = G
//      V^T has read it (two 64-row slots of each would take 129 KB of shared
//      memory: one block an SM). It walks the key tiles the skip rule keeps
//      (mtt::key_tiles) twice: pass 1 for S = Q K^T, dW and an online max m,
//      sum s and t = sum exp(l - m) dW per row, so r = t / s; pass 2 for W =
//      exp(l - m) (1 / s), dL = W (dW - r) and dQ += dL K. A walk of one
//      tile is one pass. It writes W and dL of each tile pair on or below the
//      diagonal to the scratch, and each row's r and w0 = exp(finfo.min - m)
//      (1 / s): the weight of every key after the row, 1 / S for a row with
//      no valid key and 0 for any other.
//   2. dkdv: one block per (work item, key tile), a warp per 16 keys, V of
//      the key tile resident; it walks the query tiles that meet the key
//      tile (mtt::query_tiles, the mirror of kernel 1's walk). On or below
//      the diagonal: dV += W^T G and dK += dL^T Q, W^T and dL^T read as A
//      operands from kernel 1's tiles in shared memory. Above it (only a
//      query tile holding a row with no valid key reaches there): W is w0
//      at every key, so the pair is recomputed from the rows' w0 and r: dW^T
//      = V G^T, dL^T = w0 (dW^T - r), then dV += W^T G and dK += dL^T Q from
//      the registers (three products where the stored pairs take two).
//
// The scratch. The host sizes it before the mask is read (no synchronisation,
// so a call can sit in a CUDA graph), and the pairs a work item walks depend
// on the mask: from the causal triangle, nt (nt + 1) / 2 tile pairs for nt
// tiles, up to all nt^2 when a batch row has no valid key (every query tile
// then walks every key tile). So the scratch is indexed by the triangle:
// pair (qt, kt <= qt) of item j at tile j T + qt (qt + 1) / 2 + kt, T = nt
// (nt + 1) / 2 tiles of KT^2 floats for W and as many for dL, then the rows'
// w0 and r (2 S floats an item). It holds every pair the walk visits on or
// below the diagonal (pairs left of a row's first valid key are never
// written nor read); the pairs above it are recomputed (above). About half of
// B H S^2 8 bytes: 302 MB at 16 x 512 x 16, 588 MB at 2 x 2,100 x 16.
//
// Chunks. The work items run in chunks whose scratch fits kScratchFloats (1
// GiB), the chunks as even as their count allows, so the transient memory of
// a call stays bounded at any batch. One work item's triangle passes the
// budget past S = 16,320 (kScratchFloats / item_floats); there the rule
// (tf32_bwd_takes) leaves fp32 to the other routes (route 5,
// attention_bwd_tf32_hopper.cu, which takes every S from its border, or the
// CUDA cores), whose scratch is 3 floats a row.
//
// What bounds it on an H100: five products a tile pair at the least (Q K^T,
// G V^T, dV, dQ, dK), at the 3xTF32 rate (495 / 3 TFLOP/s); the route runs
// seven (pass 1's two, pass 2's three, kernel 2's two) at mma.sync's share of
// that rate, plus each operand's split, and moves the scratch (302 MB
// written and read at 16 x 512 x 16, 0.18 ms at 3.35 TB/s).

#include "attention_tf32.cuh"

#include <algorithm>

namespace {

using namespace mtt::tf32;
using namespace mtt::tf32::causal;

// Row stride of a W or dL tile in shared memory: at least KT, 4 mod 32 (load_at's banks).
__host__ __device__ constexpr int ldw(int KT) { return (KT - 4 + 31) / 32 * 32 + 4; }

// Pass 1's step on one key tile: the running max m over the quad that holds a
// row, this lane's part of s = sum exp(l - m) and of t = sum exp(l - m) dW,
// rescaled when m grows (the scale is the same on the quad).
template <int NT>
__device__ __forceinline__ void stats_step(const float sc[NT][4], const float dw[NT][4], float m[2],
                                           float s[2], float t[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -FLT_MAX;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    const float nm = fmaxf(m[r], row_max4(mx));
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
}

// Kernel 1: row statistics, W and dL to the scratch, and dQ, for one query tile.
template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const uint8_t* __restrict__ valid,
                                 const float* __restrict__ g, float* __restrict__ dq,
                                 float* __restrict__ wd, int S, int H, long long bh0,
                                 long long ld_in, long long ld_g, long long ld_out) {
  constexpr int NT = KT / 8;
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  extern __shared__ __align__(16) float smem[];
  const int nt = (S + KT - 1) / KT;
  const int kslots = nt > 1 ? 2 : 1;
  float* Qs = smem;                                           // TILE
  float* Gs = Qs + TILE;                                      // TILE
  float* Ks = Gs + TILE;                                      // kslots x TILE
  float* Vs = Ks + kslots * TILE;                             // TILE
  uint8_t* Vm = reinterpret_cast<uint8_t*>(Vs + TILE);        // kslots x KT key flags
  int* red = reinterpret_cast<int*>(Vm + 2 * KT);             // one int per warp

  const int j = blockIdx.x;  // this chunk's work item
  const long long bh = bh0 + j;
  const int b = (int)(bh / H);
  const int h = (int)(bh - (long long)b * H);
  const int qt = nt - 1 - (int)blockIdx.y;  // the longest key walk first
  const int q0 = qt * KT;
  const int qlast = min(q0 + KT, S) - 1;
  const long long off = (long long)b * S * ld_in + (long long)h * kD;
  const float* kb = k + off;
  const float* vb = v + off;
  const uint8_t* valid_b = valid + (long long)b * S;
  int kt0, nkt;
  mtt::key_tiles(q0, qlast, mtt::first_valid(valid_b, qlast + 1, red), S, KT, &kt0, &nkt);
  const bool one = nkt == 1;  // a walk of one tile: both passes in one
  const int items = one ? 1 : 2 * nkt;
  auto tile_of = [&](int it) { return kt0 + (it < nkt ? it : it - nkt); };
  auto load_k = [&](int it) {
    const int slot = it & (kslots - 1);
    load_tile<kD, kLd, KT, NTHREADS>(Ks + slot * TILE, kb, ld_in, tile_of(it) * KT, S);
    load_valid(Vm + slot * KT, valid_b, tile_of(it) * KT, S, KT);
  };
  auto load_v = [&](int it) { load_tile<kD, kLd, KT, NTHREADS>(Vs, vb, ld_in, tile_of(it) * KT, S); };
  load_tile<kD, kLd, KT, NTHREADS>(Qs, q + off, ld_in, q0, S);
  load_tile<kD, kLd, KT, NTHREADS>(Gs, g + (long long)b * S * ld_g + (long long)h * kD, ld_g, q0, S);
  load_k(0);
  load_v(0);
  mtt::cp_async_commit();

  // The scratch: W of pair (qt, kt) is tile j T + qt (qt + 1) / 2 + kt of wd;
  // dL the same tile one plane (gridDim.x T tiles) further; then the rows' w0
  // and r, gridDim.x S floats each (the header note).
  const long long tile2 = (long long)KT * KT;
  const long long T = (long long)nt * (nt + 1) / 2;
  const long long plane = (long long)gridDim.x * T * tile2;
  float* w_row = wd + ((long long)j * T + (long long)qt * (qt + 1) / 2) * tile2;
  float* w0_out = wd + 2 * plane + (long long)j * S;
  float* r_out = w0_out + (long long)gridDim.x * S;

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX}, s[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float rr[2], inv[2];

  // One step of a walk: the tiles in, dW = G V^T and S = Q K^T (masked); V's
  // slot refilled once every warp has read it.
  auto step = [&](int it, float sc[NT][4], float dw[NT][4]) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) {
      load_k(it + 1);
      mtt::cp_async_commit();
    }
    xyt<kD, kLd, NT>(dw, Gs, wr, Vs, lane);
    if (!one) {
      __syncthreads();
      if (it + 1 < items) {
        load_v(it + 1);
        mtt::cp_async_commit();
      }
    }
    const int slot = it & (kslots - 1);
    const uint8_t* vm = Vm + slot * KT;
    const int k0 = tile_of(it) * KT;
    xyt<kD, kLd, NT>(sc, Qs, wr, Ks + slot * TILE, lane);
    if (!mtt::tile_unmasked<KT>(vm, k0, q0 + wr, S, lane)) causal_mask<NT>(sc, rows, vm, k0, S, lane);
  };
  auto finish_stats = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] = row_sum4(s[r]);
      rr[r] = row_sum4(t[r]) / s[r];
      inv[r] = 1.f / s[r];
      if ((lane & 3) == 0 && rows[r] < S) {
        w0_out[rows[r]] = mtt::fast_exp(-FLT_MAX - m[r]) * inv[r];
        r_out[rows[r]] = rr[r];
      }
    }
  };

  if (!one) {
    for (int it = 0; it < nkt; ++it) {  // pass 1
      float sc[NT][4], dw[NT][4];
      step(it, sc, dw);
      stats_step<NT>(sc, dw, m, s, t);
    }
    finish_stats();
  }
  float dqa[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  for (int it = one ? 0 : nkt; it < items; ++it) {  // pass 2
    float sc[NT][4], dw[NT][4];
    step(it, sc, dw);
    if (one) {
      stats_step<NT>(sc, dw, m, s, t);
      finish_stats();
    }
    // W = exp(l - m) (1 / s) and dL = W (dW - r) (0 on rows past S), to the
    // scratch on and below the diagonal; then dQ += dL K.
    const int kt = tile_of(it);
    float* wt = w_row + (long long)kt * tile2 + (wr + (lane >> 2)) * KT + 2 * (lane & 3);
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
        if (kt <= qt) {
          float* p = wt + 8 * r * KT + 8 * n;
          *reinterpret_cast<float2*>(p) = w;
          *reinterpret_cast<float2*>(p + plane) = dl;
        }
      }
    }
    py<kD, kLd, NT>(dqa, sc, Ks + (it & (kslots - 1)) * TILE, lane);
  }
  const float one_[2] = {1.f, 1.f};
  store_tile<kD>(dq + (long long)b * S * ld_out + (long long)h * kD, ld_out, dqa, q0 + wr, one_, S,
                 lane);
}

// Kernel 2: dK and dV for one key tile, from kernel 1's W and dL tiles, or
// recomputed from the rows' w0 and r above the diagonal.
template <int KT>
__global__ void __launch_bounds__(2 * KT, 2)
    attention_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ v,
                                   const uint8_t* __restrict__ valid, const float* __restrict__ g,
                                   float* __restrict__ dk, float* __restrict__ dv,
                                   const float* __restrict__ wd, int S, int H, long long bh0,
                                   long long ld_in, long long ld_g, long long ld_out) {
  constexpr int NT = KT / 8;
  constexpr int NTHREADS = 2 * KT;
  constexpr int TILE = KT * kLd;
  constexpr int LDW = ldw(KT);
  constexpr int WTILE = KT * LDW;
  extern __shared__ __align__(16) float smem[];
  const int nt = (S + KT - 1) / KT;
  float* Qt = smem;           // TILE: the query tile's Q
  float* Gt = Qt + TILE;      // TILE: its G
  float* Vk = Gt + TILE;      // TILE: V of the key tile
  float* Wt = Vk + TILE;      // WTILE: W of the tile pair, rows queries
  float* Dt = Wt + WTILE;     // WTILE: dL
  float* St = Dt + WTILE;     // 2 KT: the query rows' w0 and r
  int* red = reinterpret_cast<int*>(St + 2 * KT);

  const int j = blockIdx.x;
  const long long bh = bh0 + j;
  const int b = (int)(bh / H);
  const int h = (int)(bh - (long long)b * H);
  const int kt = blockIdx.y;  // key tile 0 meets the most query tiles: the longest walk first
  const int k0 = kt * KT;
  const int klast = min(k0 + KT, S) - 1;
  const long long off = (long long)b * S * ld_in + (long long)h * kD;
  const float* qb = q + off;
  const float* gb = g + (long long)b * S * ld_g + (long long)h * kD;
  const uint8_t* valid_b = valid + (long long)b * S;
  const mtt::QueryWalk walk =
      mtt::query_tiles(k0, klast, mtt::first_valid(valid_b, S, red), S, KT);

  const long long tile2 = (long long)KT * KT;
  const long long T = (long long)nt * (nt + 1) / 2;
  const long long plane = (long long)gridDim.x * T * tile2;
  const float* w_item = wd + (long long)j * T * tile2;
  const float* w0_in = wd + 2 * plane + (long long)j * S;
  const float* r_in = w0_in + (long long)gridDim.x * S;
  auto load = [&](int it) {
    const int qt = walk.tile(it);
    load_tile<kD, kLd, KT, NTHREADS>(Qt, qb, ld_in, qt * KT, S);
    load_tile<kD, kLd, KT, NTHREADS>(Gt, gb, ld_g, qt * KT, S);
    if (qt >= kt) {
      const float* src = w_item + ((long long)qt * (qt + 1) / 2 + kt) * tile2;
      for (int i = threadIdx.x; i < KT * KT / 4; i += NTHREADS) {
        const int r = i / (KT / 4);
        const int c = (i - r * (KT / 4)) * 4;
        mtt::cp_async16(Wt + r * LDW + c, src + r * KT + c, true);
        mtt::cp_async16(Dt + r * LDW + c, src + plane + r * KT + c, true);
      }
    } else if ((int)threadIdx.x < KT) {
      const int row = qt * KT + threadIdx.x;
      St[threadIdx.x] = row < S ? w0_in[row] : 0.f;
      St[KT + threadIdx.x] = row < S ? r_in[row] : 0.f;
    }
    mtt::cp_async_commit();
  };
  load_tile<kD, kLd, KT, NTHREADS>(Vk, v + off, ld_in, k0, S);
  if (walk.count > 0) load(0);
  mtt::cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int wk = (threadIdx.x >> 5) * 16;
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  for (int it = 0; it < walk.count; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (walk.tile(it) >= kt) {
      pty<kD, kLd, KT, LDW>(dva, Wt, wk, Gt, lane);
      pty<kD, kLd, KT, LDW>(dka, Dt, wk, Qt, lane);
    } else {
      // Above the diagonal: W^T[key][i] = w0[i] at every key, dW^T = V G^T,
      // dL^T = w0 (dW^T - r), as kernel 1 forms W and dL there.
      float wt[NT][4], dlt[NT][4];
      xyt<kD, kLd, NT>(dlt, Vk, wk, Gt, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * (lane & 3) + (e & 1);
          wt[n][e] = St[c];
          dlt[n][e] = St[c] * (dlt[n][e] - St[KT + c]);
        }
      py<kD, kLd, NT>(dva, wt, Gt, lane);
      py<kD, kLd, NT>(dka, dlt, Qt, lane);
    }
    if (it + 1 < walk.count) {  // one slot: refill it once every warp is done with it
      __syncthreads();
      load(it + 1);
    }
  }
  const float one_[2] = {1.f, 1.f};
  const long long out_off = (long long)b * S * ld_out + (long long)h * kD;
  store_tile<kD>(dk + out_off, ld_out, dka, k0 + wk, one_, S, lane);
  store_tile<kD>(dv + out_off, ld_out, dva, k0 + wk, one_, S, lane);
}

template <typename K>
cudaError_t allow(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Floats of scratch one work item (batch row, head) takes: W and dL of the
// triangle's tile pairs, and the rows' w0 and r.
long long item_floats(int S) {
  const long long KT = tile_rows(S);
  const long long nt = (S + KT - 1) / KT;
  return nt * (nt + 1) * KT * KT + 2LL * S;
}

// The backward runs in chunks of work items whose scratch fits kScratchFloats
// (1 GiB: 302 MB for 16 x 512 x 16 and 588 MB for 2 x 2,100 x 16, one chunk
// each), the chunks as even as their count allows.
constexpr long long kScratchFloats = 1LL << 28;

long long chunk_items(int B, int S, int H) {
  const long long n = (long long)B * H;
  const long long most = std::min(n, std::max(1LL, kScratchFloats / item_floats(S)));
  const long long chunks = (n + most - 1) / most;
  return (n + chunks - 1) / chunks;
}

template <int KT>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const uint8_t* valid,
                       const float* g, float* dq, float* dk, float* dv, float* scratch, int B,
                       int S, int H, long long ld_in, long long ld_g, long long ld_out,
                       cudaStream_t stream) {
  const int nt = (S + KT - 1) / KT;
  const int kslots = nt > 1 ? 2 : 1;
  const size_t ints = sizeof(int) * (size_t)(2 * KT / 32);
  const size_t smem_dq = sizeof(float) * (size_t)(3 + kslots) * KT * kLd + 2 * KT + ints;
  const size_t smem_dkdv = sizeof(float) * ((size_t)3 * KT * kLd + 2 * KT * ldw(KT) + 2 * KT) + ints;
  cudaError_t err;
  if ((err = allow(attention_bwd_dq_tf32_kernel<KT>, smem_dq)) != cudaSuccess) return err;
  if ((err = allow(attention_bwd_dkdv_tf32_kernel<KT>, smem_dkdv)) != cudaSuccess) return err;
  const long long n = (long long)B * H;
  const long long items = chunk_items(B, S, H);
  for (long long bh0 = 0; bh0 < n; bh0 += items) {
    const dim3 grid((unsigned)std::min(items, n - bh0), nt);
    attention_bwd_dq_tf32_kernel<KT><<<grid, 2 * KT, smem_dq, stream>>>(
        q, k, v, valid, g, dq, scratch, S, H, bh0, ld_in, ld_g, ld_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attention_bwd_dkdv_tf32_kernel<KT><<<grid, 2 * KT, smem_dkdv, stream>>>(
        q, v, valid, g, dk, dv, scratch, S, H, bh0, ld_in, ld_g, ld_out);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int mtt_attention_route_override();

// Whether attention_bwd gives an fp32 call at (S, D) this route, where route 5
// (3xTF32 wgmma, attention_bwd_tf32_hopper.cu, checked first) does not take
// it: head_dim 80 below route 5's border while one work item's scratch fits
// the budget (S <= 16,320: the header note), unless the route override
// (attention_set_route) 3 keeps fp32 on the CUDA cores.
extern "C" int tf32_bwd_takes(int S, int D) {
  return D == kD && item_floats(S) <= kScratchFloats && mtt_attention_route_override() != 3;
}

// The layout this route reads and writes: q, k, v and g rows and bases
// 16-byte aligned (16-byte cp.async), dq, dk and dv 8-byte aligned (8-byte
// stores).
extern "C" int tf32_bwd_layout(const void* q, const void* k, const void* v, const void* g,
                               const void* dq, const void* dk, const void* dv, long long ld_in,
                               long long ld_g, long long ld_out) {
  return rows16(q, ld_in) && rows16(k, ld_in) && rows16(v, ld_in) && rows16(g, ld_g) &&
         rows8(dq, ld_out) && rows8(dk, ld_out) && rows8(dv, ld_out);
}

// Floats of scratch the route's backward needs at (B, S, H): one chunk's.
extern "C" long long tf32_bwd_scratch(int B, int S, int H) {
  return chunk_items(B, S, H) * item_floats(S);
}

// cfg as attention_bwd_config's: {route 4, threads, query rows per block of
// the dq kernel, keys per block of the dkdv kernel, heads per block, padded
// head_dim, output columns per block, 0}.
extern "C" void tf32_bwd_config(int S, int* cfg) {
  const int kt = tile_rows(S);
  const int c[8] = {4, 2 * kt, kt, kt, 1, kD, kD, 0};
  for (int i = 0; i < 8; ++i) cfg[i] = c[i];
}

// q, k, v: (B, S, H, 80) fp32 views with row stride ld_in; g: ld_g; dq, dk,
// dv: ld_out, written whole; valid: (B, S) bytes; scratch:
// tf32_bwd_scratch(B, S, H) floats, 16-byte aligned. The layout rule is
// tf32_bwd_layout's (the caller's check). Launches on `stream`.
extern "C" int tf32_attention_bwd(const void* q, const void* k, const void* v, const void* valid,
                                  const void* g, void* dq, void* dk, void* dv, void* scratch,
                                  int B, int S, int H, long long ld_in, long long ld_g,
                                  long long ld_out, void* stream) {
  if ((reinterpret_cast<uintptr_t>(scratch) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  const auto* vm = static_cast<const uint8_t*>(valid);
  const auto* gg = static_cast<const float*>(g);
  auto* dqq = static_cast<float*>(dq);
  auto* dkk = static_cast<float*>(dk);
  auto* dvv = static_cast<float*>(dv);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
#define MTT_LAUNCH(KT) \
  return (int)launch_bwd<KT>(qq, kk, vv, vm, gg, dqq, dkk, dvv, sc, B, S, H, ld_in, ld_g, ld_out, st)
  switch (tile_rows(S)) {
    case 16: MTT_LAUNCH(16);
    case 32: MTT_LAUNCH(32);
    case 48: MTT_LAUNCH(48);
    case 64: MTT_LAUNCH(64);
    default: MTT_LAUNCH(80);
  }
#undef MTT_LAUNCH
}
