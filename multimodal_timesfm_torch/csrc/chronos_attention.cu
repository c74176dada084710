// Bidirectional T5 attention with a relative-position bias and segment
// masking, forward (this file) and backward (chronos_attention_bwd.cu), for
// Hopper (sm_90a); shared pieces in chronos_common.cuh.
//
// Replaces the Pallas TPU kernel of the JAX package's Chronos-2 encoder:
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _fwd_kernel (B4f)
//   multimodal_timesfm_tpu/ops/chronos_attention.py  _bwd_kernel (B4b)
// (fused_chronos_attention and its custom VJP). Per (batch, head):
//   L = Q K^T + bias[h]           q NOT scaled (T5), bias (H, S, S) fp32
//   L[i][j] = finfo(float32).min  where seg[b][i] != seg[b][j]
//   W = softmax(L) in fp32        every token keeps at least its own key
//   O = round(W) V                W rounded to the compute dtype, fp32 sum
// and, backward, from the same qkv, seg and bias (nothing else is saved):
//   dV = W^T G,  dW = G V^T,  dL = W o (dW - rowsum(dW o W)),
//   dQ = dL K,   dK = dL^T Q,  dbias[h] = sum over the batch of dL,
// with the unrounded fp32 W, each output cast once. q, k and v are read in
// place from the (B, S, 3*H*D) projection (column blocks q|k|v, head h at
// column h*D of each block, row stride 3*H*D); the output is (B, S, H*D) and
// dqkv (B, S, 3*H*D) in the same layout. Any S, head_dim 1..256, no atomics:
// two launches give bit-equal dqkv and dbias.
//
// Eight routes, numbered 0-7 in the plan; make_plan (chronos_common.cuh)
// picks one from (dtype, B, S, H, D), and chronos_attention_config reports it.
// Route 4 below (the wgmma route, numbered 3 in the plan) comes first where
// chronos_hopper_takes says so; routes 1 and 2 take the bf16 calls it leaves.
// In fp32 at head_dim 64 three tensor-core routes come in this order: for
// short sequences the persistent 3xTF32 route fed by TMA (plan route 6: the
// forward's chronos_attention_short_tf32.cu, the backward's
// chronos_attention_bwd_short_tf32.cu, their borders and design in their
// headers); past its borders the 3xTF32 route on wgmma fed by TMA (plan route
// 7: chronos_attention_tf32_hopper.cu and chronos_attention_bwd_tf32_hopper.cu,
// sharing chronos_tf32_hopper.cuh, from the borders kFwdFrom / kBwdFrom of
// chronos_tf32w_takes: 160 and 385 tokens); then the 3xTF32 route on mma.sync (plan route 5,
// chronos_attention_tf32.cu and chronos_attention_bwd_tf32.cu, with its design
// in the first one's header: chronos_tf32_takes), which keeps what the other
// two leave (the forward below 17 and at 113-159 tokens, the backward at
// 81-384, and the route override "tf32 mma.sync"). Route 3 below takes the fp32 calls they leave (other head dims,
// the override "cuda cores"). Ahead of all of them in
// bf16 at head_dim 64 for short sequences comes the persistent one-pass
// route (plan route 4): the forward's up to 128 tokens
// (chronos_attention_short_hopper.cu), the backward's up to 80
// (chronos_attention_bwd_short_hopper.cu), each with its design and bias
// bytes in its file's header; the one-pass route 1 keeps the other head
// dims and the calls the route override keeps off route 4.
//
// 1. bf16 one-pass (S padded to 16 up to 128 in the forward, 96 in the
//    backward; head_dim <= 64), on the tensor cores. A block takes one head
//    and a group of G batch rows (G = B H / 512, 1..8); its NQ = ceil(S/16)
//    warps each own 16 query rows against every key, so the query and key
//    tiles are S padded to 16 (S = 67: one 80-row tile, 5 warps; S = 80:
//    exactly one). The (S, S) fp32 bias strip of the head comes into shared
//    memory once per block and serves all G rows; each row's q, k, v (and g)
//    tiles come by 16-byte cp.async into a two-slot ring, the next batch
//    row's while the current one computes. Q K^T runs on mma.sync m16n8k16
//    (bf16 operands from ldmatrix, fp32 accumulators); the bias and the
//    segment mask are added in the accumulators. With the whole row in
//    registers the row max and sum are exact before any exponential, so
//    W = exp(l - m) / s, rounded to bf16 in the registers and fed to W V as
//    the A fragment (V by ldmatrix.trans), is the two-pass result computed
//    once. Backward, per batch row: phase A (warp = 16 query rows) forms W,
//    dW = G V^T, r = rowsum(dW o W) and dL = W (dW - r) in registers, dQ =
//    dL K with dL as a hi + lo bf16 pair (each row of dL sums to 0, so dQ and
//    dK are differences of terms; one bf16 rounding of dL failed BWD_TOL for
//    the causal kernels), and writes W and dL to shared memory, each as a hi
//    + lo pair (one bf16 rounding of W failed BWD_TOL where a cotangent
//    centred over a segment's rows leaves dV only W's spread); phase B (warp
//    = 16 keys) reads their transposes by ldmatrix.trans as A operands:
//    dV = W^T G, dK = dL^T Q. Q K^T and G V^T run once per batch row. dbias:
//    each warp adds its rows of dL over the group's batch rows in registers,
//    in batch order, and writes one (H, S, S) partial per group; a last
//    kernel sums the ceil(B / G) partials in group order (none when G = B).
// 2. bf16 tiled (longer S or head_dim > 64, where route 4 does not take
//    them), on the tensor cores: one block
//    per (64-row query tile, head, batch row), 4 warps x 16 rows, 64-key
//    tiles through a two-slot cp.async ring, two passes (pass 1 an online
//    row max and sum, pass 2 W = exp(l - m) / s rounded to bf16 in the
//    registers times V; a one-pass online softmax would round unnormalised
//    weights, a different result). Each lane reads its bias entries from
//    device memory (L2) as it adds them. Backward: the dq kernel (online m,
//    s and t = sum exp(l - m) dW, then dL and dQ = dL K; dL to a
//    per-batch-row partial when dbias is asked for) and the dkdv kernel on
//    transposed tiles (W^T, dL^T in registers as A operands) after the
//    causal kernels' design (attention_bwd.cu). For head_dim > 80 a block
//    writes 64 of the output columns.
// 3. fp32, on the CUDA cores (head dims other than 64; plain TF32 rounds to
//    2^-11, beyond the fp32 tolerance, so the tensor-core route takes three
//    TF32 products a pair): 256 threads, TB = 16 TM rows fitted to S
//    (16, 32, 64, and 80 for 64 < S <= 80 at head_dim <= 64: one tile at
//    Chronos-2's 67- and 80-token rows), each thread a TM x TM micro-tile,
//    4-byte cp.async into a two-slot ring, shared rows padded to D + 1; the
//    backward keeps one slot where two would leave one block per SM instead
//    of two (at 64-row tiles two blocks per SM measured faster). When the
//    whole row is one tile the forward and the dq kernel compute the logits
//    (and dW) once. dbias: per-batch-row partials summed in batch order. The
//    bias is read per (batch row, head) from L2.
// 4. bf16 wgmma + TMA at head_dim 64 (chronos_attention_hopper.cu,
//    chronos_attention_bwd_hopper.cu, sharing chronos_hopper.cuh), from the
//    border kFwdFrom / kBwdFrom there (measured by chip_smoke.py's Chronos
//    [gate] lines; chronos_set_route forces it on or off): persistent blocks
//    of two consumer warpgroups and a TMA producer warpgroup, 128-row work
//    items, 64-row tiles of q, k, v and g read in place by TMA. Forward: one
//    pass, online softmax. Backward: row statistics, dQ, dK and dV kernels,
//    and a dbias kernel whose blocks loop over the batch (no plane per batch
//    row; partials per group of batch rows only where the blocks alone do
//    not fill the card).
//
// Why routes 2 to 4 read the bias from L2. The (H, S, S) bias (16 MB
// at S = 577) stays in the H100's 50 MB L2, so re-reading it costs L2
// traffic only, and staging it in shared memory costs a 4-byte cp.async per
// entry (rows of an odd S are not 16-byte aligned). Measured at 16 x 577
// (chip_smoke.py --kernel-times, H100 80GB HBM3 at 700 W), bf16 forward:
// read from L2 0.375 ms; staged per block through the ring 0.485; G batch
// rows per thread-block cluster sharing each staged tile through
// distributed shared memory 0.738 / 0.458 / 0.423 / 0.466 ms at G = 1 / 2 /
// 4 / 8. Backward: staged 1.076 ms, L2 1.099, clusters 1.12-1.57; fp32
// forward and backward: L2 fastest, clusters 4-50% slower. Route 1 does
// group batch rows (a block takes G of them and stages the bias strip once:
// its loads then serve G rows and the strip is read as 8-byte pairs). Route
// 4 (bf16 forward, 16 x 577, the same card): copying each stage's block into
// shared memory with the producer warpgroup's three idle warps (4-byte
// cp.async, coalesced) ran nearly twice as long as each consumer thread's
// own reads from L2 in its accumulator layout (the copies could not keep
// up); reading it once for two batch rows was no faster.
//
// Bias bytes read per launch (fp32 bias, 4 bytes), at the main shapes:
//   S = 67, B = 128, H = 12 (fine-tune), bf16: G = 3, 43 groups x 12 heads
//     x 67 x 67 x 4 = 9.3 MB forward and 9.3 MB backward (64-row tiles read
//     it twice per batch row and query tile: 55 MB); dbias partials 9.3 MB
//     written and read back (27.6 MB for one partial per batch row). The
//     backward's persistent route: 132 blocks, 2.4 MB of bias read and 2.4 MB
//     of partials written and read back. fp32:
//     one tile, one pass, 27.6 MB from L2; dbias partials one per batch row
//     (27.6 MB).
//   S = 577, B = 16, H = 12 (serving at context 8192), bf16 tiled: each
//     bias entry once per pass and batch row, 2 x 16 x 12 x 577^2 x 4 =
//     511 MB from L2 (the 16 MB bias read from device memory about once);
//     the backward 3 x 255 MB, and with dbias 256 MB of per-batch-row
//     partials written and read back. Route 4: forward once per batch row,
//     255 MB; backward once per batch row in each of its three walks, 767
//     MB, and once per dbias block and batch group (16 MB at 16 x 577), with
//     no partials where one group fills the card.
// Segment ids (and the backward's row statistics) come by cp.async in the
// same commit groups as the tiles.
//
// What bounds it on an H100: at Chronos-2's shapes (H = 12, D = 64, S = 67
// to 577) the least time of the work is set by the bytes in bf16 (q, k, v,
// out, the bias once) and by the fp32 rate in fp32 (67 TFLOP/s on the CUDA
// cores; the same work as 3xTF32 at most 495 / 3 TFLOP/s on the tensor
// cores); chip_smoke.py prints all three. The bf16 one-pass route moves each batch row's tiles once and does
// the work once; it is bound by the latency of its ring at one or two
// blocks per SM (its shared memory: the bias strip, two slots of tiles and,
// backward, W and dL). The tiled route re-reads K and V from L2 once per
// query tile and pass, and the bias once per pass. The fp32 CUDA-core route
// is bound by the CUDA cores' 67 TFLOP/s; the 3xTF32 route's bound and
// design are in chronos_attention_tf32.cu.

#include "chronos_common.cuh"

namespace {

// ------------------------------------------------------ bf16 one-pass route

template <int NK, int NQ>
__global__ void __launch_bounds__(32 * NQ)
    chronos_fwd_onepass_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                               const float* __restrict__ bias, bf16* __restrict__ out, int B,
                               int S, int H, int D, int G, int vec, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int SP = 16 * NQ;   // query rows = keys per block
  constexpr int NT = SP / 8;    // n-tiles of a warp's logit row
  constexpr int LDB = SP + 8;   // bias strip row stride (floats)
  constexpr int NO = 2 * NK;    // n-tiles of the output
  constexpr int NTHREADS = 32 * NQ;
  constexpr int TILE = SP * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);       // SP x LDB: bias[h]
  bf16* ring = reinterpret_cast<bf16*>(Bs + SP * LDB);  // 2 slots x (q, k, v) x SP x LDS
  int* Sg = reinterpret_cast<int*>(ring + 6 * TILE);    // 2 slots x SP segment ids

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
    bf16* dst = ring + slot * 3 * TILE;
#pragma unroll
    for (int m = 0; m < 3; ++m)
      mtt::load_tile_bf16<1, SP, DP, LDS, NTHREADS>(dst + m * TILE, TILE, src + m * hd, ld, D, 0,
                                                    1, 0, S, vec);
    load_seg(Sg + slot * SP, seg + b * S, 0, S, SP);
    mtt::cp_async_commit();
  };
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const float* const brow[2] = {Bs + rows[0] * LDB, Bs + rows[1] * LDB};

  for (int i = 0; i < nb; ++i) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nb) prefetch(i + 1);
    const int slot = i & 1;
    const bf16* Qs = ring + slot * 3 * TILE;
    const bf16* Ks = Qs + TILE;
    const bf16* Vs = Ks + TILE;
    const int* sk = Sg + slot * SP;
    float sc[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qs + warp * 16 * LDS, Ks, lane);
    const int sq[2] = {sk[rows[0]], sk[rows[1]]};
    bias_mask<NT>(sc, brow, sq, sk, 0, S, lane);
    // The whole row is here: exact max and sum, then W = exp(l - m) / s.
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
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        sc[n][2 * r] *= inv;
        sc[n][2 * r + 1] *= inv;
      }
    }
    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      mma_pv<NO, LDS, false>(o, sc[2 * kk], sc[2 * kk + 1], Vs + kk * 16 * LDS, 0, lane);
    store_rows<NO>(out + (long long)(b0 + i) * S * hd + (long long)h * D, hd, o, rows[0], 0, S,
                   D, pair_out, lane);
  }
}

template <int NK, int NQ>
cudaError_t launch_onepass(const bf16* qkv, const int* seg, const float* bias, bf16* out, int B,
                           int S, int H, int D, int G, int vec, int pair_out,
                           cudaStream_t stream) {
  constexpr int SP = 16 * NQ;
  constexpr int LDS = 16 * NK + 8;
  const size_t smem = sizeof(float) * SP * (SP + 8) + sizeof(bf16) * 6 * SP * LDS +
                      sizeof(int) * 2 * SP;
  auto kernel = chronos_fwd_onepass_kernel<NK, NQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (B + G - 1) / G);
  kernel<<<grid, 32 * NQ, smem, stream>>>(qkv, seg, bias, out, B, S, H, D, G, vec, pair_out);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_onepass_nq(int nq, const bf16* qkv, const int* seg, const float* bias,
                              bf16* out, int B, int S, int H, int D, int G, int vec, int pair_out,
                              cudaStream_t stream) {
#define MTT_LAUNCH(NQ) \
  return launch_onepass<NK, NQ>(qkv, seg, bias, out, B, S, H, D, G, vec, pair_out, stream)
  switch (nq) {
    case 1: MTT_LAUNCH(1);
    case 2: MTT_LAUNCH(2);
    case 3: MTT_LAUNCH(3);
    case 4: MTT_LAUNCH(4);
    case 5: MTT_LAUNCH(5);
    case 6: MTT_LAUNCH(6);
    case 7: MTT_LAUNCH(7);
    case 8: MTT_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef MTT_LAUNCH
}

// --------------------------------------------------------- bf16 tiled route

}  // namespace

// Route 3, chronos_attention_hopper.cu; route 4, chronos_attention_short_hopper.cu;
// route 5, chronos_attention_tf32.cu; route 7, chronos_attention_tf32_hopper.cu;
// route 6, chronos_attention_short_tf32.cu.
extern "C" int chronos_hopper_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                  int B, int S, int H, void* stream);
extern "C" int chronos_tf32_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                int B, int S, int H, void* stream);
extern "C" int chronos_short_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                 int B, int S, int H, void* stream);
// Route 6, chronos_attention_short_tf32.cu.
extern "C" int chronos_tf32w_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                 int B, int S, int H, void* stream);
extern "C" int chronos_short_tf32_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                      int B, int S, int H, void* stream);

namespace {

template <int NK, int NKO>
__global__ void __launch_bounds__(kThreadsMma)
    chronos_fwd_tiled_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg,
                             const float* __restrict__ bias, bf16* __restrict__ out, int S, int H,
                             int D, int vec, int pair_out) {
  constexpr int DP = 16 * NK;
  constexpr int LDS = DP + 8;
  constexpr int BQ = 64;
  constexpr int BK = 64;
  constexpr int NT = BK / 8;
  constexpr int NO = 2 * NKO;
  constexpr int SPLIT = NK / NKO;  // blocks per query tile
  constexpr int KV = BK * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);           // BQ x LDS
  bf16* Ks = Qs + BQ * LDS;                               // 2 x BK x LDS
  bf16* Vs = Ks + 2 * KV;                                 // 2 x BK x LDS
  int* Sq = reinterpret_cast<int*>(Vs + 2 * KV);          // BQ query segments
  int* Sk = Sq + BQ;                                      // 2 x BK key segments

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
                                                     S, vec);
    if (it >= nkt)
      mtt::load_tile_bf16<1, BK, DP, LDS, kThreadsMma>(Vs + buf * KV, KV, qb + 2 * hd, ld, D, 0,
                                                       1, k0, S, vec);
    load_seg(Sk + buf * BK, seg_b, k0, S, BK);
    mtt::cp_async_commit();
  };
  mtt::load_tile_bf16<1, BQ, DP, LDS, kThreadsMma>(Qs, BQ * LDS, qb, ld, D, 0, 1, q0, S, vec);
  load_seg(Sq, seg_b, q0, S, BQ);
  prefetch(0);

  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float s[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const bf16* Qw = Qs + wr * LDS;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = (it < nkt ? it : it - nkt) * BK;
    float sc[NT][4];
    mma_abt<NK, NT, LDS>(sc, Qw, Ks + buf * KV, lane);
    const int sq[2] = {Sq[wr + (lane >> 2)], Sq[wr + (lane >> 2) + 8]};
    const float* const brow[2] = {bias_h + (long long)min(rows[0], S - 1) * S + k0,
                                  bias_h + (long long)min(rows[1], S - 1) * S + k0};
    bias_mask<NT, false>(sc, brow, sq, Sk + buf * BK, k0, S, lane);
    if (it < nkt) {
      // Pass 1: running row max and sum of exp over the quad that holds a row.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
        const float nm = fmaxf(m[r], quad_max(mx));
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          ps += mtt::fast_exp(sc[n][2 * r] - nm) + mtt::fast_exp(sc[n][2 * r + 1] - nm);
        s[r] = s[r] * mtt::fast_exp(m[r] - nm) + quad_sum(ps);
        m[r] = nm;
      }
      if (it + 1 == nkt) {
        inv[0] = 1.f / s[0];
        inv[1] = 1.f / s[1];
      }
      continue;
    }
    // Pass 2: W rounded to bf16 in registers is the A operand of W V.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = mtt::fast_exp(sc[n][e] - m[e >> 1]) * inv[e >> 1];
    const bf16* Vw = Vs + buf * KV;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      mma_pv<NO, LDS, false>(o, sc[2 * kk], sc[2 * kk + 1], Vw + kk * 16 * LDS, col0, lane);
  }
  store_rows<NO>(out + (long long)b * S * hd + (long long)h * D, hd, o, rows[0], col0, S, D,
                 pair_out, lane);
}

template <int NK>
cudaError_t launch_tiled(const bf16* qkv, const int* seg, const float* bias, bf16* out, int B,
                         int S, int H, int D, int vec, int pair_out, cudaStream_t stream) {
  constexpr int NKO = NK <= 5 ? NK : 4;
  constexpr int LDS = 16 * NK + 8;
  const size_t smem = sizeof(bf16) * (size_t)5 * 64 * LDS + sizeof(int) * 3 * 64;
  auto kernel = chronos_fwd_tiled_kernel<NK, NKO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64 * (NK / NKO), H, B);
  kernel<<<grid, kThreadsMma, smem, stream>>>(qkv, seg, bias, out, S, H, D, vec, pair_out);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const bf16* qkv, const int* seg, const float* bias, bf16* out, int B,
                          int S, int H, int D, cudaStream_t stream) {
  // 16-byte cp.async needs every row of q, k and v to start 16-byte aligned:
  // head_dim a multiple of 8 (then so is the row stride 3 H D) and qkv aligned.
  const int vec = D % 8 == 0 && aligned16(qkv);
  const int pair_out = D % 2 == 0 && aligned4(out);
  const Plan p = make_plan(false, 1, B, S, H, D);
  if (p.route == 3)
    return static_cast<cudaError_t>(chronos_hopper_fwd(qkv, seg, bias, out, B, S, H, stream));
  if (p.route == 4)
    return static_cast<cudaError_t>(chronos_short_fwd(qkv, seg, bias, out, B, S, H, stream));
  const int nk = p.dp / 16;
  if (p.route == 1) {
#define MTT_LAUNCH(NK) \
  return launch_onepass_nq<NK>(p.rows / 16, qkv, seg, bias, out, B, S, H, D, p.group, vec, pair_out, stream)
    if (nk == 1) MTT_LAUNCH(1);
    if (nk == 2) MTT_LAUNCH(2);
    MTT_LAUNCH(4);
#undef MTT_LAUNCH
  }
#define MTT_LAUNCH(NK) return launch_tiled<NK>(qkv, seg, bias, out, B, S, H, D, vec, pair_out, stream)
  if (nk == 1) MTT_LAUNCH(1);
  if (nk == 2) MTT_LAUNCH(2);
  if (nk == 4) MTT_LAUNCH(4);
  if (nk == 5) MTT_LAUNCH(5);
  if (nk == 8) MTT_LAUNCH(8);
  MTT_LAUNCH(16);
#undef MTT_LAUNCH
}

// ---------------------------------------------------------------- fp32 route

template <int TM, int NDS>
__global__ void __launch_bounds__(kThreadsF32)
    chronos_fwd_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ seg,
                           const float* __restrict__ bias, float* __restrict__ out, int S, int H,
                           int D) {
  constexpr int TB = 16 * TM;
  constexpr int RPW = TB / 8;  // output rows per warp
  extern __shared__ float smem[];
  const int dp = D + 1;
  const int ts = TB * max(dp, TB + 1);  // a K or V slot; in pass 2 K's slot then holds W
  float* Qs = smem;                 // TB x dp
  float* Ks = Qs + TB * dp;         // 2 slots: K tiles, then the W tile, TB x (TB + 1)
  float* Vs = Ks + 2 * ts;          // 2 slots: V tiles
  int* Sq = reinterpret_cast<int*>(Vs + 2 * ts);  // TB query segments
  int* Sk = Sq + TB;                                // 2 x TB key segments

  const int q0 = blockIdx.x * TB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long hd = (long long)H * D;
  const long long ld = 3 * hd;
  const float* qb = qkv + (long long)b * S * ld + (long long)h * D;
  const int* seg_b = seg + (long long)b * S;
  const float* bias_h = bias + (long long)h * S * S;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // One tile holds the whole row: one walk, the logits computed once.
  const int nkt = (S + TB - 1) / TB;
  const bool one = nkt == 1;
  const int items = one ? 1 : 2 * nkt;
  auto tile_of = [&](int it) { return (it < nkt ? it : it - nkt) * TB; };
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    const int k0 = tile_of(it);
    mtt::load_tile_f32<TB, kThreadsF32>(Ks + buf * ts, qb + hd, k0, S, D, dp, ld);
    if (one || it >= nkt)
      mtt::load_tile_f32<TB, kThreadsF32>(Vs + buf * ts, qb + 2 * hd, k0, S, D, dp, ld);
    load_seg(Sk + buf * TB, seg_b, k0, S, TB);
    mtt::cp_async_commit();
  };
  mtt::load_tile_f32<TB, kThreadsF32>(Qs, qb, q0, S, D, dp, ld);
  load_seg(Sq, seg_b, q0, S, TB);
  prefetch(0);

  float m[TM], s[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -FLT_MAX;
    s[i] = 0.f;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float acc[RPW][NDS];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < NDS; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < items; ++it) {
    mtt::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < items) prefetch(it + 1);
    const int buf = it & 1;
    const int k0 = tile_of(it);
    float* Kt = Ks + buf * ts;
    float l[TM][TM];
    micro_dot<TM>(Qs, Kt, D, dp, tx, ty, l);
    bias_and_mask<TM>(l, Sq, Sk + buf * TB, bias_h, q0, k0, S, tx, ty);
    if (one || it < nkt) {
      // Pass 1: running row max and sum of exp, in fp32.
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float tmax = l[i][0];
#pragma unroll
        for (int j = 1; j < TM; ++j) tmax = fmaxf(tmax, l[i][j]);
        const float nm = fmaxf(m[i], row_max16(tmax));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < TM; ++j) ps += expf(l[i][j] - nm);
        s[i] = s[i] * expf(m[i] - nm) + row_sum16(ps);
        m[i] = nm;
      }
      if (!one) continue;
    }
    // Pass 2: normalized weights (fp32: rounding is the identity), written over
    // the K tile once every thread has its logits, times V.
    __syncthreads();
    float* Ws = Kt;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        Ws[(ty + 16 * i) * (TB + 1) + tx + 16 * j] = expf(l[i][j] - m[i]) / s[i];
    __syncthreads();
    const float* Vt = Vs + buf * ts;
    const int kn = min(TB, S - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[NDS];
#pragma unroll
      for (int c = 0; c < NDS; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vt[j * dp + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float w = Ws[(warp + 8 * i) * (TB + 1) + j];
#pragma unroll
        for (int c = 0; c < NDS; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
      }
    }
  }

  float* ob = out + (long long)b * S * hd + (long long)h * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NDS; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[(long long)row * hd + d] = acc[i][c];
    }
  }
}

template <int TM, int NDS>
cudaError_t launch_f32(const float* qkv, const int* seg, const float* bias, float* out, int B,
                       int S, int H, int D, cudaStream_t stream) {
  constexpr int TB = 16 * TM;
  const int dp = D + 1;
  const size_t smem = sizeof(float) * ((size_t)TB * dp + (size_t)4 * TB * std::max(dp, TB + 1)) +
                      sizeof(int) * 3 * TB;
  auto kernel = chronos_fwd_f32_kernel<TM, NDS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TB - 1) / TB, H, B);
  kernel<<<grid, kThreadsF32, smem, stream>>>(qkv, seg, bias, out, S, H, D);
  return cudaGetLastError();
}

// Output columns per lane: ceil(D / 32), rounded up to an instantiated count
// (TM = 4 up to head_dim 128, TM = 5 up to 64: make_plan keeps to these).
template <int TM>
cudaError_t launch_f32_nds(const float* qkv, const int* seg, const float* bias, float* out, int B,
                           int S, int H, int D, cudaStream_t stream) {
  const int nds = (D + 31) / 32;
  if (nds == 1) return launch_f32<TM, 1>(qkv, seg, bias, out, B, S, H, D, stream);
  if (nds == 2) return launch_f32<TM, 2>(qkv, seg, bias, out, B, S, H, D, stream);
  if constexpr (TM <= 4) {
    if (nds == 3) return launch_f32<TM, 3>(qkv, seg, bias, out, B, S, H, D, stream);
    if (nds == 4) return launch_f32<TM, 4>(qkv, seg, bias, out, B, S, H, D, stream);
  }
  if constexpr (TM <= 2) return launch_f32<TM, 8>(qkv, seg, bias, out, B, S, H, D, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const float* qkv, const int* seg, const float* bias, float* out, int B,
                         int S, int H, int D, cudaStream_t stream) {
  const int tm = make_plan(false, 0, B, S, H, D).rows / 16;
  if (tm == 1) return launch_f32_nds<1>(qkv, seg, bias, out, B, S, H, D, stream);
  if (tm == 2) return launch_f32_nds<2>(qkv, seg, bias, out, B, S, H, D, stream);
  if (tm == 4) return launch_f32_nds<4>(qkv, seg, bias, out, B, S, H, D, stream);
  return launch_f32_nds<5>(qkv, seg, bias, out, B, S, H, D, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. qkv (B, S, 3*H*D) and out (B, S, H*D)
// contiguous in that dtype; seg (B, S) int32; bias (H, S, S) fp32. Returns
// the CUDA error of the launch (0 on success); launches on `stream` and does
// not synchronize.
namespace {

// chronos_attention_fwd on B <= kGridRows batch rows.
int fwd_rows(const void* qkv, const void* seg, const void* bias, void* out, int dtype, int B, int S,
             int H, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const float* bs = static_cast<const float*>(bias);
  const int route = dtype == 0 ? make_plan(false, 0, B, S, H, D).route : -1;
  if (route == 6) return chronos_short_tf32_fwd(qkv, seg, bias, out, B, S, H, stream);
  if (route == 7) return chronos_tf32w_fwd(qkv, seg, bias, out, B, S, H, stream);
  if (route == 5) return chronos_tf32_fwd(qkv, seg, bias, out, B, S, H, stream);
  if (dtype == 0)
    return (int)dispatch_f32(static_cast<const float*>(qkv), sg, bs, static_cast<float*>(out), B,
                             S, H, D, st);
  if (dtype == 1)
    return (int)dispatch_bf16(static_cast<const bf16*>(qkv), sg, bs, static_cast<bf16*>(out), B,
                              S, H, D, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A batch of more than kGridRows rows runs as chunks of rows
// (mtt::grid_chunk_rows), each a call of its own on `stream`, in order.
extern "C" int chronos_attention_fwd(const void* qkv, const void* seg, const void* bias, void* out,
                                     int dtype, int B, int S, int H, int D, void* stream) {
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int rows = mtt::grid_chunk_rows(B);
  const long long row = (long long)S * H * D * (dtype == 0 ? 4 : 2);
  for (int b0 = 0; b0 < B; b0 += rows) {
    const int err = fwd_rows(mtt::byte_at(qkv, 3 * row * b0), mtt::byte_at(seg, 4LL * S * b0), bias,
                             mtt::byte_at(out, row * b0), dtype, std::min(rows, B - b0), S, H, D,
                             stream);
    if (err != 0) return err;
  }
  return 0;
}

// The plan chronos_attention_fwd (backward = 0) or chronos_attention_bwd
// (backward = 1) takes for (dtype, B, S, H, D), for reports and for sizing the
// dbias partials: cfg = {route (0: fp32 CUDA cores, 1: bf16 mma.sync
// m16n8k16 one-pass, 2: bf16 mma.sync tiled, 3: bf16 wgmma + TMA, 4: bf16
// mma.sync one-pass fed by TMA, persistent: the forward's and the
// backward's routes for short sequences, 5: fp32 3xTF32 on mma.sync
// m16n8k8, 6: fp32 3xTF32 mma.sync m16n8k8 fed by TMA, persistent: the
// short forward's and backward's routes, 7: fp32 3xTF32 wgmma fed by TMA),
// threads, query rows per block (per work item on routes 3 and 4; a tile on
// 6; keys a block in route 7's dK/dV kernel),
// keys per tile, passes over the keys, batch rows per block, blocks along
// the batch (the (H, S, S) dbias partials the backward sums; route 4's
// forward: its blocks a head), padded
// head_dim, output columns per block, dL as a hi + lo bf16 pair (1) or not
// (0)}; past kGridRows batch rows, the plan of the first (largest) chunk.
// Returns 0, or cudaErrorInvalidValue.
extern "C" int chronos_attention_config(int backward, int dtype, int B, int S, int H, int D,
                                        int* cfg) {
  if (bad_shape(B, S, H, D) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(backward != 0, dtype, mtt::grid_chunk_rows(B), S, H, D);
  const int c[10] = {p.route, p.threads, p.rows, p.keys, p.passes,
                     p.group, p.groups,  p.dp,   p.cols, p.split_dl};
  for (int i = 0; i < 10; ++i) cfg[i] = c[i];
  return 0;
}
