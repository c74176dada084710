// Chronos-2 T5 attention backward (B4b) for Hopper (sm_90a): the backward
// half of the JAX package's multimodal_timesfm_tpu/ops/chronos_attention.py
// _bwd_kernel. The contract, the three routes, the dbias reduction and what
// bounds them are in the header note of chronos_attention.cu.

#include "chronos_common.cuh"

namespace {

// ------------------------------------------------------ bf16 one-pass route

template <int NK, int NQ, bool DBIAS>
__global__ void __launch_bounds__(32 * NQ)
    chronos_bwd_onepass_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                               const float* __restrict__ bias, const bf16* __restrict__ g,
                               bf16* __restrict__ dqkv, float* __restrict__ dbias_part, int B,
                               int S, int H, int D, int G, int vec_in, int vec_g, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int SP = 16 * NQ;  // query rows = keys per block
  constexpr int NT = SP / 8;
  constexpr int LDB = SP + 8;  // bias strip row stride (floats)
  constexpr int LDW = SP + 8;  // W and dL (hi and lo each) row stride (bf16)
  constexpr int NO = 2 * NK;
  constexpr int NTHREADS = 32 * NQ;
  constexpr int TILE = SP * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);       // SP x LDB: bias[h]
  bf16* ring = reinterpret_cast<bf16*>(Bs + SP * LDB);  // 2 slots x (q, k, v, g) x SP x LDS
  bf16* Wh = ring + 8 * TILE;                           // SP x LDW: W, high bf16 part (rows = queries)
  bf16* Wl = Wh + SP * LDW;                             // SP x LDW: W, low bf16 part
  bf16* Dh = Wl + SP * LDW;                             // SP x LDW: dL, high bf16 part
  bf16* Dl = Dh + SP * LDW;                             // SP x LDW: dL, low bf16 part
  int* Sg = reinterpret_cast<int*>(Dl + SP * LDW);      // 2 slots x SP segment ids

  const int h = blockIdx.x;
  const int b0 = blockIdx.y * G;
  const int nb = min(G, B - b0);
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  load_bias_tile<SP, SP, LDB, NTHREADS>(Bs, bias + (long long)h * S * S, 0, 0, S);
  auto prefetch = [&](int i) {
    const int slot = i & 1;
    const long long b = b0 + i;
    const bf16* src = qkv + b * S * ld + (long long)h * D;
    bf16* dst = ring + slot * 4 * TILE;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      mtt::load_tile_bf16<1, SP, DP, LDS, NTHREADS>(dst + m * TILE, TILE, src + m * hd, ld, D, 0,
                                                    1, 0, S, vec_in);
    mtt::load_tile_bf16<1, SP, DP, LDS, NTHREADS>(dst + 3 * TILE, TILE,
                                                  g + b * S * hd + (long long)h * D, hd, D, 0, 1,
                                                  0, S, vec_g);
    load_seg(Sg + slot * SP, seg + b * S, 0, S, SP);
    mtt::cp_async_commit();
  };
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const float* const brow[2] = {Bs + rows[0] * LDB, Bs + rows[1] * LDB};
  float dbacc[DBIAS ? NT : 1][4];
#pragma unroll
  for (int n = 0; n < (DBIAS ? NT : 1); ++n) dbacc[n][0] = dbacc[n][1] = dbacc[n][2] = dbacc[n][3] = 0.f;

  for (int i = 0; i < nb; ++i) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nb) prefetch(i + 1);
    const int slot = i & 1;
    const bf16* Qs = ring + slot * 4 * TILE;
    const bf16* Ks = Qs + TILE;
    const bf16* Vs = Ks + TILE;
    const bf16* Gs = Vs + TILE;
    const int* sk = Sg + slot * SP;
    bf16* ob = dqkv + (long long)(b0 + i) * S * ld + (long long)h * D;

    // Phase A, a warp per 16 query rows: W, dW, r and dL in registers.
    float sc[NT][4], dw[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qs + warp * 16 * LDS, Ks, lane);
    mma_abt<NK, NT, LDS>(dw, Gs + warp * 16 * LDS, Vs, lane);
    const int sq[2] = {sk[rows[0]], sk[rows[1]]};
    bias_mask<NT>(sc, brow, sq, sk, 0, S, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
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
      float rr = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][2 * r + e] *= inv;
          rr = fmaf(sc[n][2 * r + e], dw[n][2 * r + e], rr);
        }
      rr = quad_sum(rr);
      // W to shared memory (a hi + lo pair: one bf16 rounding of W left dV
      // outside BWD_TOL where its terms cancel), dL = W (dW - r) in place of W.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int at = rows[r] * LDW + n * 8 + 2 * t;
        const float w0 = sc[n][2 * r], w1 = sc[n][2 * r + 1];
        uint32_t hi, lo;
        mtt::split_bf16(w0, w1, hi, lo);
        *reinterpret_cast<uint32_t*>(Wh + at) = hi;
        *reinterpret_cast<uint32_t*>(Wl + at) = lo;
        const float d0 = w0 * (dw[n][2 * r] - rr);
        const float d1 = w1 * (dw[n][2 * r + 1] - rr);
        sc[n][2 * r] = d0;
        sc[n][2 * r + 1] = d1;
        mtt::split_bf16(d0, d1, hi, lo);
        *reinterpret_cast<uint32_t*>(Dh + at) = hi;
        *reinterpret_cast<uint32_t*>(Dl + at) = lo;
        if constexpr (DBIAS) {
          dbacc[n][2 * r] += d0;
          dbacc[n][2 * r + 1] += d1;
        }
      }
    }
    {
      float acc[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        mma_pv<NO, LDS, true>(acc, sc[2 * kk], sc[2 * kk + 1], Ks + kk * 16 * LDS, 0, lane);
      store_rows<NO>(ob, ld, acc, rows[0], 0, S, D, pair_out, lane);
    }
    __syncthreads();

    // Phase B, a warp per 16 keys: dV = W^T G, dK = dL^T Q, the transposes
    // read by ldmatrix.trans.
    float dv[NO][4], dk[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < NQ; ++kq) {
      uint32_t hi[4], lo[4];
      ldsm_at<LDW>(hi, Wh, kq * 16, warp * 16, lane);
      ldsm_at<LDW>(lo, Wl, kq * 16, warp * 16, lane);
      mma_a_tile<NO, LDS, true>(dv, hi, lo, Gs + kq * 16 * LDS, 0, lane);
      ldsm_at<LDW>(hi, Dh, kq * 16, warp * 16, lane);
      ldsm_at<LDW>(lo, Dl, kq * 16, warp * 16, lane);
      mma_a_tile<NO, LDS, true>(dk, hi, lo, Qs + kq * 16 * LDS, 0, lane);
    }
    store_rows<NO>(ob + hd, ld, dk, rows[0], 0, S, D, pair_out, lane);
    store_rows<NO>(ob + 2 * hd, ld, dv, rows[0], 0, S, D, pair_out, lane);
  }

  if constexpr (DBIAS) {
    // This group's sum of dL, in batch order, for this warp's rows.
    float* part = dbias_part + ((long long)blockIdx.y * H + h) * S * S;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = n * 8 + 2 * t + (e & 1);
        if (row < S && col < S) part[(long long)row * S + col] = dbacc[n][e];
      }
  }
}

template <int NK, int NQ, bool DBIAS>
cudaError_t launch_onepass(const bf16* qkv, const int* seg, const float* bias, const bf16* g,
                           bf16* dqkv, float* part, int B, int S, int H, int D, int G,
                           int vec_in, int vec_g, int pair_out, cudaStream_t stream) {
  constexpr int SP = 16 * NQ;
  constexpr int LDS = 16 * NK + 8;
  // At S = 96 (NK = 4): 39,936 + 110,592 + 79,872 + 768 = 231,168 bytes, inside the
  // 232,448 a block can have.
  const size_t smem = sizeof(float) * SP * (SP + 8) + sizeof(bf16) * 8 * SP * LDS +
                      sizeof(bf16) * 4 * SP * (SP + 8) + sizeof(int) * 2 * SP;
  auto kernel = chronos_bwd_onepass_kernel<NK, NQ, DBIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (B + G - 1) / G);
  kernel<<<grid, 32 * NQ, smem, stream>>>(qkv, seg, bias, g, dqkv, part, B, S, H, D, G, vec_in,
                                          vec_g, pair_out);
  return cudaGetLastError();
}

template <int NK, bool DBIAS>
cudaError_t launch_onepass_nq(int nq, const bf16* qkv, const int* seg, const float* bias,
                              const bf16* g, bf16* dqkv, float* part, int B, int S, int H, int D,
                              int G, int vec_in, int vec_g, int pair_out, cudaStream_t stream) {
#define MTT_LAUNCH(NQ)                                                                      \
  return launch_onepass<NK, NQ, DBIAS>(qkv, seg, bias, g, dqkv, part, B, S, H, D, G, vec_in, \
                                       vec_g, pair_out, stream)
  switch (nq) {
    case 1: MTT_LAUNCH(1);
    case 2: MTT_LAUNCH(2);
    case 3: MTT_LAUNCH(3);
    case 4: MTT_LAUNCH(4);
    case 5: MTT_LAUNCH(5);
    case 6: MTT_LAUNCH(6);
    default: return cudaErrorInvalidValue;
  }
#undef MTT_LAUNCH
}

// --------------------------------------------------------- bf16 tiled route

// Kernel 1: row statistics (m, 1/s, r), dQ and, with `partials`, dL per batch
// row, for one 64-row query tile.
template <int NK, int NKO>
__global__ void __launch_bounds__(kThreadsMma)
    chronos_bwd_dq_tiled_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                                const float* __restrict__ bias, const bf16* __restrict__ g,
                                bf16* __restrict__ dqkv, float* __restrict__ stats,
                                float* __restrict__ partials, int S, int H, int D, int vec_in,
                                int vec_g, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int BQ = 64;
  constexpr int BK = 64;
  constexpr int NT = BK / 8;
  constexpr int NO = 2 * NKO;
  constexpr int SPLIT = NK / NKO;
  constexpr int KV = BK * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LDS
  bf16* Gs = Qs + BQ * LDS;                      // BQ x LDS
  bf16* Ks = Gs + BQ * LDS;                      // 2 x BK x LDS
  bf16* Vs = Ks + 2 * KV;                        // 2 x BK x LDS
  int* Sq = reinterpret_cast<int*>(Vs + 2 * KV); // BQ query segments
  int* Sk = Sq + BQ;                             // 2 x BK key segments

  const int q0 = ((int)blockIdx.x / SPLIT) * BQ;
  const int col0 = ((int)blockIdx.x % SPLIT) * NKO * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const bf16* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const int nkt = (S + BK - 1) / BK;
  const int items = 2 * nkt;
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int k0 = (it < nkt ? it : it - nkt) * BK;
    mtt::load_tile_bf16<1, BK, DP, LDS, kThreadsMma>(Ks + buf * KV, KV, qb + hd, ld, D, 0, 1, k0,
                                                     S, vec_in);
    mtt::load_tile_bf16<1, BK, DP, LDS, kThreadsMma>(Vs + buf * KV, KV, qb + 2 * hd, ld, D, 0, 1,
                                                     k0, S, vec_in);
    load_seg(Sk + buf * BK, seg_b, k0, S, BK);
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<1, BQ, DP, LDS, kThreadsMma>(Qs, BQ * LDS, qb, ld, D, 0, 1, q0, S, vec_in);
  mtt::load_tile_bf16<1, BQ, DP, LDS, kThreadsMma>(
      Gs, BQ * LDS, g + (long long)b * S * hd + (long long)h * D, hd, D, 0, 1, q0, S, vec_g);
  load_seg(Sq, seg_b, q0, S, BQ);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  const long long bh = (long long)b * H + h;
  float* part = partials == nullptr || col0 != 0 ? nullptr : partials + bh * S * S;
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};
  float tt[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float r[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const bf16* Qw = Qs + wr * LDS;
  const bf16* Gw = Gs + wr * LDS;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = (it < nkt ? it : it - nkt) * BK;
    const bf16* Kw = Ks + buf * KV;
    float sc[NT][4], dw[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qw, Kw, lane);
    mma_abt<NK, NT, LDS>(dw, Gw, Vs + buf * KV, lane);
    const int sq[2] = {Sq[wr + (lane >> 2)], Sq[wr + (lane >> 2) + 8]};
    const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S + k0,
                                  bias_h + (long long)min(rows[1], S - 1) * S + k0};
    bias_mask<NT, false>(sc, brow, sq, Sk + buf * BK, k0, S, lane);
    if (it < nkt) {
      // Pass 1: online m, s and t over the quad that holds a row.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * rr], sc[n][2 * rr + 1]));
        const float nm = fmaxf(m[rr], quad_max(mx));
        float ps = 0.f, pt = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = mtt::fast_exp(sc[n][2 * rr + e] - nm);
            ps += x;
            pt = fmaf(x, dw[n][2 * rr + e], pt);
          }
        const float scale = mtt::fast_exp(m[rr] - nm);
        s[rr] = s[rr] * scale + quad_sum(ps);
        tt[rr] = tt[rr] * scale + quad_sum(pt);
        m[rr] = nm;
      }
      if (it + 1 == nkt) {
        const long long plane = (long long)gridDim.z * H * S;  // B * H * S
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          inv[rr] = 1.f / s[rr];
          r[rr] = tt[rr] / s[rr];
          if (col0 == 0 && t == 0 && rows[rr] < S) {
            stats[bh * S + rows[rr]] = m[rr];
            stats[plane + bh * S + rows[rr]] = inv[rr];
            stats[2 * plane + bh * S + rows[rr]] = r[rr];
          }
        }
      }
      continue;
    }
    // Pass 2: dL = W (dW - r) in registers, the A operand of dQ += dL K.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        sc[n][e] = mtt::fast_exp(sc[n][e] - m[rr]) * inv[rr] * (dw[n][e] - r[rr]);
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        if (part != nullptr && rows[rr] < S && col < S) part[(long long)rows[rr] * S + col] = sc[n][e];
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      mma_pv<NO, LDS, true>(o, sc[2 * kk], sc[2 * kk + 1], Kw + kk * 16 * LDS, col0, lane);
  }
  store_rows<NO>(dqkv + (long long)b * S * ld + (long long)h * D, ld, o, rows[0], col0, S, D,
                 pair_out, lane);
}

// Kernel 2: dK and dV for one 64-key tile, from kernel 1's statistics, on
// transposed tiles (rows = keys): W^T and dL^T sit in the accumulators in the
// A layout of dV += W^T G and dK += dL^T Q.
template <int NK, int NKO>
__global__ void __launch_bounds__(kThreadsMma)
    chronos_bwd_dkdv_tiled_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                                  const float* __restrict__ bias, const bf16* __restrict__ g,
                                  bf16* __restrict__ dqkv, const float* __restrict__ stats, int S,
                                  int H, int D, int vec_in, int vec_g, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int BQ = 64;  // queries per tile of the walk
  constexpr int BK = 64;  // keys per block
  constexpr int NO = 2 * NKO;
  constexpr int SPLIT = NK / NKO;
  constexpr int QG = BQ * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);       // BK x LDS
  bf16* Vs = Ks + BK * LDS;                           // BK x LDS
  bf16* Qs = Vs + BK * LDS;                           // 2 x BQ x LDS
  bf16* Gs = Qs + 2 * QG;                             // 2 x BQ x LDS
  float* St = reinterpret_cast<float*>(Gs + 2 * QG);  // 2 x 3 x BQ: m, 1/s, r
  int* Sk = reinterpret_cast<int*>(St + 6 * BQ);      // BK key segments
  int* Sq = Sk + BK;                                  // 2 x BQ query segments

  const int k0 = ((int)blockIdx.x / SPLIT) * BK;
  const int col0 = ((int)blockIdx.x % SPLIT) * NKO * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const bf16* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const bf16* gb = g + (long long)b * S * hd + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;
  const int nqt = (S + BQ - 1) / BQ;
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int q0 = it * BQ;
    mtt::load_tile_bf16<1, BQ, DP, LDS, kThreadsMma>(Qs + buf * QG, QG, qb, ld, D, 0, 1, q0, S,
                                                     vec_in);
    mtt::load_tile_bf16<1, BQ, DP, LDS, kThreadsMma>(Gs + buf * QG, QG, gb, hd, D, 0, 1, q0, S,
                                                     vec_g);
    for (int i = threadIdx.x; i < 3 * BQ; i += kThreadsMma) {
      const int part = i / BQ;  // m, 1/s, r
      const int row = q0 + i - part * BQ;
      const bool in = row < S;
      mtt::cp_async4(St + buf * 3 * BQ + i, in ? stats + part * plane + bh * S + row : stats, in);
    }
    load_seg(Sq + buf * BQ, seg_b, q0, S, BQ);
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<1, BK, DP, LDS, kThreadsMma>(Ks, BK * LDS, qb + hd, ld, D, 0, 1, k0, S,
                                                   vec_in);
  mtt::load_tile_bf16<1, BK, DP, LDS, kThreadsMma>(Vs, BK * LDS, qb + 2 * hd, ld, D, 0, 1, k0, S,
                                                   vec_in);
  load_seg(Sk, seg_b, k0, S, BK);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int keys[2] = {k0 + wr + (lane >> 2), k0 + wr + (lane >> 2) + 8};
  int skey[2] = {0, 0};
  float akv[NO][4], adk[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) akv[n][e] = adk[n][e] = 0.f;
  const bf16* Kw = Ks + wr * LDS;
  const bf16* Vw = Vs + wr * LDS;

  for (int it = 0; it < nqt; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it == 0) {
      skey[0] = Sk[wr + (lane >> 2)];
      skey[1] = Sk[wr + (lane >> 2) + 8];
    }
    if (it + 1 < nqt) prefetch(it + 1);
    const int buf = it & 1;
    const int q0 = it * BQ;
    const bf16* Qt = Qs + buf * QG;
    const bf16* Gt = Gs + buf * QG;
    const float* st = St + buf * 3 * BQ;
    const int* sqt = Sq + buf * BQ;
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      // Transposed 16 x 16 tiles: rows = this warp's keys, columns = queries.
      float sc[2][4], dw[2][4];
      mma_abt<NK, 2, LDS>(sc, Kw, Qt + kc * 16 * LDS, lane);
      mma_abt<NK, 2, LDS>(dw, Vw, Gt + kc * 16 * LDS, lane);
      float w[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = kc * 16 + n * 8 + 2 * t + (e & 1);  // query within the tile
          const int row = q0 + ci;
          const int key = keys[e >> 1];
          float x = 0.f;
          if (row < S && key < S) {
            const float l = sqt[ci] != skey[e >> 1] ? -FLT_MAX
                                                    : sc[n][e] + bias_h[(long long)row * S + key];
            x = mtt::fast_exp(l - st[ci]) * st[BQ + ci];
          }
          w[n][e] = x;
          sc[n][e] = x * (dw[n][e] - st[2 * BQ + ci]);
        }
      mma_pv<NO, LDS, true>(akv, w[0], w[1], Gt + kc * 16 * LDS, col0, lane);
      mma_pv<NO, LDS, true>(adk, sc[0], sc[1], Qt + kc * 16 * LDS, col0, lane);
    }
  }

  bf16* ob = dqkv + (long long)b * S * ld + (long long)h * D;
  store_rows<NO>(ob + hd, ld, adk, keys[0], col0, S, D, pair_out, lane);
  store_rows<NO>(ob + 2 * hd, ld, akv, keys[0], col0, S, D, pair_out, lane);
}

template <int NK>
cudaError_t launch_tiled(const bf16* qkv, const int* seg, const float* bias, const bf16* g,
                         bf16* dqkv, float* stats, float* part, int B, int S, int H, int D,
                         int vec_in, int vec_g, int pair_out, cudaStream_t stream) {
  constexpr int NKO = NK <= 5 ? NK : 4;
  constexpr int LDS = 16 * NK + 8;
  const size_t smem_dq = sizeof(bf16) * (size_t)6 * 64 * LDS + sizeof(int) * 3 * 64;
  const size_t smem_dkdv =
      sizeof(float) * 6 * 64 + sizeof(bf16) * (size_t)6 * 64 * LDS + sizeof(int) * 3 * 64;
  const dim3 grid((S + 63) / 64 * (NK / NKO), H, B);
  auto dq_kernel = chronos_bwd_dq_tiled_kernel<NK, NKO>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreadsMma, smem_dq, stream>>>(qkv, seg, bias, g, dqkv, stats, part, S, H, D,
                                                    vec_in, vec_g, pair_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv_kernel = chronos_bwd_dkdv_tiled_kernel<NK, NKO>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreadsMma, smem_dkdv, stream>>>(qkv, seg, bias, g, dqkv, stats, S, H, D,
                                                        vec_in, vec_g, pair_out);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Plan& p, const bf16* qkv, const int* seg, const float* bias,
                          const bf16* g, bf16* dqkv, float* stats, float* part, int B, int S,
                          int H, int D, cudaStream_t stream) {
  const int vec_in = D % 8 == 0 && aligned16(qkv);
  const int vec_g = D % 8 == 0 && aligned16(g);
  const int pair_out = D % 2 == 0 && aligned4(dqkv);
  const int nk = p.dp / 16;
  if (p.route == 1) {
#define MTT_LAUNCH(NK, DB)                                                                     \
  return launch_onepass_nq<NK, DB>(p.rows / 16, qkv, seg, bias, g, dqkv, part, B, S, H, D,    \
                                   p.group, vec_in, vec_g, pair_out, stream)
    if (part == nullptr) {
      if (nk == 1) MTT_LAUNCH(1, false);
      if (nk == 2) MTT_LAUNCH(2, false);
      MTT_LAUNCH(4, false);
    }
    if (nk == 1) MTT_LAUNCH(1, true);
    if (nk == 2) MTT_LAUNCH(2, true);
    MTT_LAUNCH(4, true);
#undef MTT_LAUNCH
  }
#define MTT_LAUNCH(NK)                                                                       \
  return launch_tiled<NK>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, vec_in, vec_g, \
                          pair_out, stream)
  if (nk == 1) MTT_LAUNCH(1);
  if (nk == 2) MTT_LAUNCH(2);
  if (nk == 4) MTT_LAUNCH(4);
  if (nk == 5) MTT_LAUNCH(5);
  if (nk == 8) MTT_LAUNCH(8);
  MTT_LAUNCH(16);
#undef MTT_LAUNCH
}

// ---------------------------------------------------------------- fp32 route

// Kernel 1 (fp32): row statistics (m, s, r), dQ and, with `partials`, dL per
// batch row, for one query tile.
template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    chronos_bwd_dq_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ seg,
                              const float* __restrict__ bias, const float* __restrict__ g,
                              float* __restrict__ dqkv, float* __restrict__ stats,
                              float* __restrict__ partials, int S, int H, int D, int stages) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;               // TB x dp
  float* Gs = Qs + TB * dp;       // TB x dp
  float* Ks = Gs + TB * dp;            // stages x TB x dp
  float* Vs = Ks + stages * TB * dp;   // stages x TB x dp
  float* Ps = Vs + stages * TB * dp;   // TB x (TB + 1): dL tile
  int* Sq = reinterpret_cast<int*>(Ps + TB * (TB + 1));  // TB query segments
  int* Sk = Sq + TB;                                      // 2 x TB key segments

  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const long long bh = (long long)b * H + h;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // One tile holds the whole row: one walk, the logits and dW computed once.
  const int nkt = (S + TB - 1) / TB;
  const bool one = nkt == 1;
  const int items = one ? 1 : 2 * nkt;
  auto tile_of = [&](int it) { return (it < nkt ? it : it - nkt) * TB; };
  auto prefetch = [&](int it) {
    const int buf = it & (stages - 1);
    const int k0 = tile_of(it);
    mtt::load_tile_f32<TB, kThreadsF32>(Ks + buf * TB * dp, qb + hd, k0, S, D, dp, ld);
    mtt::load_tile_f32<TB, kThreadsF32>(Vs + buf * TB * dp, qb + 2 * hd, k0, S, D, dp, ld);
    load_seg(Sk + buf * TB, seg_b, k0, S, TB);
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Qs, qb, q0, S, D, dp, ld);
  mtt::load_tile_f32<TB, kThreadsF32>(Gs, g + (long long)b * S * hd + (long long)h * D, q0, S, D,
                                      dp, hd);
  load_seg(Sq, seg_b, q0, S, TB);
  prefetch(0);

  float m[TM], s[TM], t[TM], r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
    t[i] = 0.f;
    r[i] = 0.f;
  }
  const long long plane = (long long)gridDim.z * H * S;  // B * H * S
  float* part = partials == nullptr ? nullptr : partials + bh * S * S;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < items; ++it) {
    if (stages == 1 && it > 0) {  // one slot: reload it once every thread is done with it
      __syncthreads();
      prefetch(it);
    }
    mtt::cp_async_wait_all();
    __syncthreads();
    if (stages == 2 && it + 1 < items) prefetch(it + 1);
    const int buf = it & (stages - 1);
    const int k0 = tile_of(it);
    const float* Kt = Ks + buf * TB * dp;
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qs, Kt, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq, Sk + buf * TB, bias_h, q0, k0, S, tx, ty);
    micro_dot<TM>(Gs, Vs + buf * TB * dp, D, dp, tx, ty, dw);
    if (one || it < nkt) {
      // Pass 1: online row max m, sum s of exp(l - m), and t = sum exp(l - m) dW.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float tmax = l[i][0];
#pragma unroll
        for (int j = 1; j < TM; ++j) tmax = fmaxf(tmax, l[i][j]);
        const float nm = fmaxf(m[i], row_max16(tmax));
        float ps = 0.f, pt = 0.f;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const float e = expf(l[i][j] - nm);
          ps += e;
          pt = fmaf(e, dw[i][j], pt);
        }
        const float scale = expf(m[i] - nm);
        s[i] = s[i] * scale + row_sum16(ps);
        t[i] = t[i] * scale + row_sum16(pt);
        m[i] = nm;
      }
      if (one || it + 1 == nkt) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          r[i] = t[i] / s[i];
          const int row = q0 + ty + 16 * i;
          if (tx == 0 && row < S) {
            stats[bh * S + row] = m[i];
            stats[plane + bh * S + row] = s[i];
            stats[2 * plane + bh * S + row] = r[i];
          }
        }
      }
      if (!one) continue;
    }
    // Pass 2: dL = W (dW - r) through shared memory (and to the partials),
    // dQ += dL K.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float dl = expf(l[i][j] - m[i]) / s[i] * (dw[i][j] - r[i]);
        Ps[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = dl;
        const int col = k0 + tx + 16 * j;
        if (part != nullptr && row < S && col < S) part[(long long)row * S + col] = dl;
      }
    }
    __syncthreads();
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float kv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? Kt[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float p = Ps[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(p, kv[c], acc[i][c]);
      }
    }
  }

  float* ob = dqkv + (long long)b * S * ld + (long long)h * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * ld + d] = acc[i][c];
    }
  }
}

// Kernel 2 (fp32): dK and dV for one key tile, from kernel 1's statistics.
template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    chronos_bwd_dkdv_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ seg,
                                const float* __restrict__ bias, const float* __restrict__ g,
                                float* __restrict__ dqkv, const float* __restrict__ stats, int S,
                                int H, int D, int stages) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Ks = smem;                // TB x dp
  float* Vs = Ks + TB * dp;        // TB x dp
  float* Qs = Vs + TB * dp;            // stages x TB x dp
  float* Gs = Qs + stages * TB * dp;   // stages x TB x dp
  float* Ws = Gs + stages * TB * dp;   // TB x (TB + 1): W tile, rows = queries
  float* Ps = Ws + TB * (TB + 1);      // TB x (TB + 1): dL tile
  float* St = Ps + TB * (TB + 1);      // 2 x 3 x TB: row max, sum, term
  int* Sk = reinterpret_cast<int*>(St + 6 * TB);  // TB key segments
  int* Sq = Sk + TB;                               // 2 x TB query segments

  const int k0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const float* gb = g + (long long)b * S * hd + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;

  const int nqt = (S + TB - 1) / TB;
  auto prefetch = [&](int it) {
    const int buf = it & (stages - 1);
    const int q0 = it * TB;
    mtt::load_tile_f32<TB, kThreadsF32>(Qs + buf * TB * dp, qb, q0, S, D, dp, ld);
    mtt::load_tile_f32<TB, kThreadsF32>(Gs + buf * TB * dp, gb, q0, S, D, dp, hd);
    for (int i = tid; i < 3 * TB; i += kThreadsF32) {  // m, s, r; 0 past S (never read)
      const int part = i / TB;
      const int row = q0 + i - part * TB;
      const bool in = row < S;
      mtt::cp_async4(St + (it & 1) * 3 * TB + i, in ? stats + part * plane + bh * S + row : stats, in);
    }
    load_seg(Sq + buf * TB, seg_b, q0, S, TB);
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Ks, qb + hd, k0, S, D, dp, ld);
  mtt::load_tile_f32<TB, kThreadsF32>(Vs, qb + 2 * hd, k0, S, D, dp, ld);
  load_seg(Sk, seg_b, k0, S, TB);
  prefetch(0);

  float akv[RPW][NDS], adk[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      akv[i][c] = 0.f;
      adk[i][c] = 0.f;
    }

  for (int it = 0; it < nqt; ++it) {
    if (stages == 1 && it > 0) {  // one slot: reload it once every thread is done with it
      __syncthreads();
      prefetch(it);
    }
    mtt::cp_async_wait_all();
    __syncthreads();
    if (stages == 2 && it + 1 < nqt) prefetch(it + 1);
    const int buf = it & (stages - 1);
    const int q0 = it * TB;
    const float* Qt = Qs + buf * TB * dp;
    const float* Gt = Gs + buf * TB * dp;
    const float* Sm = St + (it & 1) * 3 * TB;
    const float* Ss = Sm + TB;
    const float* Sr = Ss + TB;
    float l[TM][TM], dw[TM][TM];
    micro_dot<TM>(Qt, Ks, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq + buf * TB, Sk, bias_h, q0, k0, S, tx, ty);
    micro_dot<TM>(Gt, Vs, D, dp, tx, ty, dw);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ri = ty + 16 * i;
      const bool in = q0 + ri < S;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float w = in ? expf(l[i][j] - Sm[ri]) / Ss[ri] : 0.f;
        Ws[ri * (TB + 1) + tx + 16 * j] = w;
        Ps[ri * (TB + 1) + tx + 16 * j] = w * (dw[i][j] - Sr[ri]);
      }
    }
    __syncthreads();
    const int qn = min(TB, S - q0);
    for (int i = 0; i < qn; ++i) {
      float gv[NDS], qv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        gv[c] = d < D ? Gt[i * dp + d] : 0.f;
        qv[c] = d < D ? Qt[i * dp + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < RPW; ++a) {
        const int key = warp + 8 * a;
        const float w = Ws[i * (TB + 1) + key];
        const float p = Ps[i * (TB + 1) + key];
#pragma unroll
        for (int c = 0; c < NDS; ++c) {
          akv[a][c] = fmaf(w, gv[c], akv[a][c]);
          adk[a][c] = fmaf(p, qv[c], adk[a][c]);
        }
      }
    }
  }

  float* ob = dqkv + (long long)b * S * ld + (long long)h * D;
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    const int key = k0 + warp + 8 * a;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        ob[hd + (long long)key * ld + d] = adk[a][c];
        ob[2 * hd + (long long)key * ld + d] = akv[a][c];
      }
    }
  }
}

template <int TM, int NDS>
cudaError_t launch_f32(const float* qkv, const int* seg, const float* bias, const float* g,
                       float* dqkv, float* stats, float* part, int B, int S, int H, int D,
                       cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  // Tiles: two resident (Q, G or K, V) and two per stage of the walk's ring.
  // Two stages where two blocks still fit on an SM (or one block either way),
  // else one: at 64-row tiles two blocks per SM measured faster than the
  // overlap of a second slot.
  const auto smem_of = [&](int stages, size_t extra) {
    return sizeof(float) * (2 + 2 * stages) * (size_t)TB * dp + extra + sizeof(int) * 3 * TB;
  };
  const auto stages_of = [&](size_t extra) {
    return smem_of(2, extra) <= kTwoBlockSmem || smem_of(1, extra) > kTwoBlockSmem ? 2 : 1;
  };
  const size_t extra_dq = sizeof(float) * TB * (TB + 1);
  const size_t extra_dkdv = sizeof(float) * (2 * TB * (TB + 1) + 6 * TB);
  const int stages_dq = stages_of(extra_dq);
  const int stages_dkdv = stages_of(extra_dkdv);
  const size_t smem_dq = smem_of(stages_dq, extra_dq);
  const size_t smem_dkdv = smem_of(stages_dkdv, extra_dkdv);
  const dim3 grid((S + TB - 1) / TB, H, B);
  auto dq_kernel = chronos_bwd_dq_f32_kernel<TM, NDS>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreadsF32, smem_dq, stream>>>(qkv, seg, bias, g, dqkv, stats, part, S, H, D,
                                                    stages_dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv_kernel = chronos_bwd_dkdv_f32_kernel<TM, NDS>;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreadsF32, smem_dkdv, stream>>>(qkv, seg, bias, g, dqkv, stats, S, H, D,
                                                        stages_dkdv);
  return cudaGetLastError();
}

// Output columns per lane: ceil(D / 32), rounded up to an instantiated count
// (TM = 4 up to head_dim 96, TM = 5 up to 64: make_plan keeps to these).
template <int TM>
cudaError_t launch_f32_nds(const float* qkv, const int* seg, const float* bias, const float* g,
                           float* dqkv, float* stats, float* part, int B, int S, int H, int D,
                           cudaStream_t stream) {
  const int nds = (D + 31) / 32;
#define MTT_LAUNCH(NDS) \
  return launch_f32<TM, NDS>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, stream)
  if (nds == 1) MTT_LAUNCH(1);
  if (nds == 2) MTT_LAUNCH(2);
  if constexpr (TM <= 4) {
    if (nds == 3) MTT_LAUNCH(3);
  }
  if constexpr (TM <= 2) {
    if (nds == 4) MTT_LAUNCH(4);
    MTT_LAUNCH(8);
  }
#undef MTT_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const Plan& p, const float* qkv, const int* seg, const float* bias,
                         const float* g, float* dqkv, float* stats, float* part, int B, int S,
                         int H, int D, cudaStream_t stream) {
  const int tm = p.rows / 16;
  if (tm == 1) return launch_f32_nds<1>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, stream);
  if (tm == 2) return launch_f32_nds<2>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, stream);
  if (tm == 4) return launch_f32_nds<4>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, stream);
  return launch_f32_nds<5>(qkv, seg, bias, g, dqkv, stats, part, B, S, H, D, stream);
}

// dbias[e] += part[e]: a chunk's dbias added to the chunks' before it.
__global__ void __launch_bounds__(256)
    chronos_bwd_dbias_add_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                 long long n) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e < n) dbias[e] += part[e];
}

// dbias[e] = sum over the partial planes, in order, of partials[p][e].
__global__ void __launch_bounds__(256)
    chronos_bwd_dbias_kernel(const float* __restrict__ partials, float* __restrict__ dbias,
                             int planes, long long n) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int p = 0; p < planes; ++p) acc += partials[(long long)p * n + e];
  dbias[e] = acc;
}

}  // namespace

// Route 4, chronos_attention_bwd_short_hopper.cu.
extern "C" int chronos_short_bwd(const void* qkv, const void* seg, const void* bias,
                                 const void* g, void* dqkv, void* dbias, int groups, int B, int S,
                                 int H, void* stream);
// Route 3, chronos_attention_bwd_hopper.cu; route 5, chronos_attention_bwd_tf32.cu.
extern "C" int chronos_hopper_bwd(const void* qkv, const void* seg, const void* bias,
                                  const void* g, void* dqkv, void* dbias, void* stats, int groups,
                                  int B, int S, int H, void* stream);
extern "C" int chronos_tf32_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                                void* dqkv, void* dbias, void* scratch, int B, int S, int H,
                                void* stream);
extern "C" long long chronos_tf32_scratch(int B, int S, int H);
// Route 7, chronos_attention_bwd_tf32_hopper.cu.
extern "C" int chronos_tf32w_bwd(const void* qkv, const void* seg, const void* bias, const void* g,
                                 void* dqkv, void* dbias, void* scratch, int B, int S, int H,
                                 void* stream);
extern "C" long long chronos_tf32w_scratch(int B, int S, int H);
// Route 6, chronos_attention_bwd_short_tf32.cu.
extern "C" int chronos_short_tf32_bwd(const void* qkv, const void* seg, const void* bias,
                                      const void* g, void* dqkv, void* dbias, int groups, int B,
                                      int S, int H, void* stream);

namespace {

// The stats and the dbias partials (floats) a chunk of B rows needs.
void rows_buffers(int dtype, int B, int S, int H, int D, long long* stats, long long* partials) {
  const Plan p = make_plan(true, dtype, B, S, H, D);
  *stats = p.route == 4 || p.route == 6 ? 0
           : p.route == 5              ? chronos_tf32_scratch(B, S, H)
           : p.route == 7              ? chronos_tf32w_scratch(B, S, H)
                                       : 3LL * B * H * ((S + 63) / 64 * 64);
  *partials = p.groups > 1 ? (long long)p.groups * H * S * S : 0;
}

// chronos_attention_bwd on B <= kGridRows batch rows.
int bwd_rows(const void* qkv, const void* seg, const void* bias, const void* g, void* dqkv,
             void* dbias, void* stats, void* partials, int dtype, int B, int S, int H, int D,
             cudaStream_t st) {
  const Plan p = make_plan(true, dtype, B, S, H, D);
  float* db = static_cast<float*>(dbias);
  // With one plane the kernels write dbias itself.
  float* part = db == nullptr ? nullptr : p.groups == 1 ? db : static_cast<float*>(partials);
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  float* sc = static_cast<float*>(stats);
  cudaError_t err =
      p.route == 6
          ? static_cast<cudaError_t>(
                chronos_short_tf32_bwd(qkv, seg, bias, g, dqkv, part, p.groups, B, S, H, st))
      : p.route == 4
          ? static_cast<cudaError_t>(
                chronos_short_bwd(qkv, seg, bias, g, dqkv, part, p.groups, B, S, H, st))
      : p.route == 7
          ? static_cast<cudaError_t>(
                chronos_tf32w_bwd(qkv, seg, bias, g, dqkv, part, stats, B, S, H, st))
      : p.route == 3
          ? static_cast<cudaError_t>(
                chronos_hopper_bwd(qkv, seg, bias, g, dqkv, part, stats, p.groups, B, S, H, st))
      : p.route == 5
          ? static_cast<cudaError_t>(
                chronos_tf32_bwd(qkv, seg, bias, g, dqkv, part, stats, B, S, H, st))
      : dtype == 0
          ? dispatch_f32(p, static_cast<const float*>(qkv), sg, bs, static_cast<const float*>(g),
                         static_cast<float*>(dqkv), sc, part, B, S, H, D, st)
          : dispatch_bf16(p, static_cast<const bf16*>(qkv), sg, bs, static_cast<const bf16*>(g),
                          static_cast<bf16*>(dqkv), sc, part, B, S, H, D, st);
  if (err != cudaSuccess || db == nullptr || p.groups == 1) return (int)err;
  const long long n = (long long)H * S * S;
  chronos_bwd_dbias_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, db, p.groups, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch chronos_attention_bwd needs at (dtype, B, S, H, D):
// floats[0] the stats (0 on the persistent routes 4 and 6, where stats may be
// null), floats[1] the dbias partials (0 when the plan writes dbias itself:
// one float will do). Past kGridRows batch rows, the most any chunk needs,
// and one more (H, S, S) plane for a chunk's own dbias. Returns 0, or
// cudaErrorInvalidValue.
extern "C" int chronos_attention_bwd_buffers(int dtype, int B, int S, int H, int D,
                                             long long* floats) {
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int rows = mtt::grid_chunk_rows(B);
  const int last = B - (B - 1) / rows * rows;
  long long stats[2], parts[2];
  rows_buffers(dtype, rows, S, H, D, &stats[0], &parts[0]);
  rows_buffers(dtype, last, S, H, D, &stats[1], &parts[1]);
  floats[0] = std::max(stats[0], stats[1]);
  floats[1] = std::max(parts[0], parts[1]) + (rows < B ? (long long)H * S * S : 0);
  return 0;
}

// g (B, S, H*D) and dqkv (B, S, 3*H*D) contiguous in qkv's dtype, dqkv
// written whole; stats and partials: chronos_attention_bwd_buffers' floats
// of scratch (stats 16-byte aligned; null where that gives 0 stats: refused
// otherwise). dbias (H, S, S) fp32 and partials are both null or both given:
// with them, dbias is written whole. A batch of more than kGridRows rows runs
// as chunks of rows (mtt::grid_chunk_rows), each a call of its own on
// `stream`, in order, reusing stats and partials: the first chunk writes
// dbias, each later one its own into the last plane of partials, then adds
// it to dbias, so dbias is the chunks' sums added in batch order. Returns the
// CUDA error of the launches.
extern "C" int chronos_attention_bwd(const void* qkv, const void* seg, const void* bias,
                                     const void* g, void* dqkv, void* dbias, void* stats,
                                     void* partials, int dtype, int B, int S, int H, int D,
                                     void* stream) {
  if (bad_shape(B, S, H, D) || (dbias == nullptr) != (partials == nullptr) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  long long floats[2];
  chronos_attention_bwd_buffers(dtype, B, S, H, D, floats);
  if (stats == nullptr && floats[0] > 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = mtt::grid_chunk_rows(B);
  const long long n = (long long)H * S * S;
  float* own = dbias == nullptr || rows == B ? nullptr : static_cast<float*>(partials) + floats[1] - n;
  const long long row = (long long)S * H * D * (dtype == 0 ? 4 : 2);
  for (int b0 = 0; b0 < B; b0 += rows) {
    int err = bwd_rows(mtt::byte_at(qkv, 3 * row * b0), mtt::byte_at(seg, 4LL * S * b0), bias,
                       mtt::byte_at(g, row * b0), mtt::byte_at(dqkv, 3 * row * b0),
                       b0 == 0 ? dbias : own, stats, partials, dtype, std::min(rows, B - b0), S, H,
                       D, st);
    if (err != 0) return err;
    if (b0 == 0 || dbias == nullptr) continue;
    chronos_bwd_dbias_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        own, static_cast<float*>(dbias), n);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return 0;
}
