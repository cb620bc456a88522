// RWKV-6 WKV backward for Hopper (sm_90a): r, k, v bf16, log-decay, bonus,
// state and cotangents fp32; dr, dk, dv out in bf16, dlogw, du and dS0 in
// fp32.  All sums fp32; products on the TF32 tensor cores with split
// operands.
//
// Replaces no TPU kernel: the reference trains rwkv6-7b by jax.grad through
// its plain chunked form (repro/models/rwkv.py:_wkv_chunked, :119,
// checkpointed at :164).  This is the backward of csrc/wkv6.cu's forward,
// launched by kernels/rwkv6/ops.py:WKV6 under autograd, and computes what
// kernels/rwkv6/ref.py:wkv6_bwd_ref does; kernels/rwkv6/ref.py:
// wkv6_bwd_subblocks is the same decomposition in plain torch.
//
// Per (batch, head), head size N, the forward's chunks of Q = 64 steps and
// sub-blocks of L = 16.  In a chunk, logP is the inclusive cumulative log
// decay from its start (logP_{-1} = 0), r~_t = r_t exp(logP_{t-1}), k~_s =
// k_s exp(logP_{Q-1} - logP_s) and a_c = exp(logP_{Q-1}); S_c is the state
// at chunk c's start and G_c the gradient of the state at its end.
//
//   states     S_{c+1} = diag(a_c) S_c + k~^T V              (the forward's)
//   gradient   G_{C-1} = dS (or 0), G_{c-1} = diag(a_c) G_c + r~^T dY,
//              dS0 = G_{-1}
//   per chunk  dA[t][s] = dy_t . v_s (s <= t; its diagonal c_t = v_t . dy_t),
//              A the forward's scores (the bonus r_t . (u k_t) on its
//              diagonal):
//              dr0 = (dY S_c^T) exp(logP_{t-1}) + intra,
//              dk0 = (V G_c^T) exp(logP_{Q-1} - logP_s) + intra,
//              dv  = k~ G_c + A^T dY,
//              dr = dr0 + u k_t c_t, dk = dk0 + u r_t c_t, du = sum r k c
//   decay      dlogw_t = D_c + sum_{t' > t in the chunk} (r dr0 - k dk0)_t'
//              - k_t dk0_t, D_c = rowsum(G_c * S_{c+1}) (the step form's
//              D_t = rowsum(dS_t * S_t) at the chunk's last step)
//
// The intra-chunk terms are factored by sub-blocks with every exponent
// <= 0 (logw = -exp(w_raw) reaches tens a step for a trained head, and
// exp(-logP) would overflow within a chunk): dr0's for t in sub-block i
// against all earlier sub-blocks at once, split at p, the step before i:
// exp(logP_{t-1} - logP_p) (dA (k_s exp(logP_p - logP_s))); dk0's for s in
// sub-block j against all later ones, split at e, j's last step:
// exp(logP_e - logP_s) (dA^T (r_t exp(logP_{t-1} - logP_e))).  Inside a
// sub-block (the 16 x 16 diagonal blocks) the terms are direct in fp32,
// the decay a running product of w over s < m < t.  The decay gradient
// restarts from the state at every chunk's end, so no sum runs longer than
// a chunk and none divides (w underflows to 0 for a strongly decaying
// channel).  (The formulas follow the public chunked RWKV-6 / GLA backward
// of flash-linear-attention.)
//
// Bound on this card.  At the training shape (8, 512, 64, 64) the work must
// move 403 MB (r, k, v in and dr, dk, dv out in bf16, logw, dy and dlogw in
// fp32): 0.120 ms at 3.35 TB/s; the chunked form's products at Q = 16
// (10 N^2 + 5 Q N flops a step and head) take 12.1 GFLOP, 0.024 ms at the
// 495 TFLOP/s TF32 peak, and its decays 0.4 GFLOP, 0.006 ms at 67
// TFLOP/s: the bytes bound it.
//
// Design: the chunked form (chunks of Q = 64 steps, sub-blocks of L = 16,
// the chunk states recomputed) in four launches on the caller's
// stream, the last three for programmatic dependent launch, every chunk of
// every head in parallel but for the short scan:
// 1. wkv6_bwd_inc_kernel, per (b, h, chunk), 8 warps, three blocks an SM:
//    the chunk's state increment k~^T V, its decay a_c and its gradient
//    increment r~^T dY, two (N x Q)(Q x N) products, into the scratch;
// 2. wkv6_bwd_scan_kernel, per (b, h, 256 state elements): walks the chunks
//    forward, S_c over the state increment, then back, G_c over the
//    gradient increment, and dS0; the first group of the backward walk's
//    loads goes out with the forward walk's.  The chunk start states are
//    recomputed here rather than kept from the forward: WKV6 saves nothing
//    more than its inputs, and under remat the forward runs again just
//    before anyway;
// 3. wkv6_bwd_chunk_kernel, per (b, h, chunk), 16 warps, one block an SM
//    (220,416 bytes of shared memory at N = 64): logP and the
//    decay-weighted k^ = k_s exp(logP_e - logP_s) and r^ = r_t
//    exp(logP_{t-1} - logP_p) from each sub-block's own sums, with a table
//    E of exp(logP_p - logP_e) between sub-blocks, so that every other
//    decay is a product of these; then sixteen 16 x 16 tiles on the
//    tensor cores, one a warp: the forward's scores A of sub-block pairs,
//    dA off and on the diagonal; the scores inside the sub-blocks (each
//    one's lower left 8 x 8 quarter on the tensor cores split at its 8th
//    step, the rest one thread a score, direct in fp32: the forward's
//    running products on four warps were this pass's longest chain); then
//    dr0, dk0 and dv by row sub-block and 16-column quarter, 48 products,
//    three a warp ordered by their cost, each the inter-chunk (Q x N)(N x
//    N) part and the intra-chunk part scaled and summed into shared
//    memory; then per (channel, sub-block) thread the diagonal
//    sub-blocks' terms in fp32 (dr0's and dk0's on two halves of the
//    block), the bonus, the decay gradient's reverse sums and du's part;
// 4. wkv6_bwd_du_kernel: du = the parts summed over b and chunks in order.
// The decay gradient needs no carry across chunks: pass 3 takes D_c =
// a_c rowsum(G_c * S_c) + sum_s k_s (V G_c^T)[s] exp(logP_{Q-1} - logP_s)
// from what it holds, so no sum runs longer than a chunk; the intra-chunk
// terms take one split point a sub-block rather than one a pair, one
// product a sub-block.
// Products are mma.sync m16n8k8 with TF32 operands and fp32 accumulators.
// Every fp32 operand of what dr, dk and dlogw read is split into hi + lo
// (cvt.rna: lo*b_hi + hi*b_lo + hi*b_hi; bf16 r, k and v are exact in
// TF32); the products only dv reads
// (the pair scores, k~ G_c and A^T dY) take one TF32 rounding: dv's limit
// is 1e-2 and it is written in bf16.  On the CPU mirror at T 512, n 64 the
// split leaves 1e-6 of max|plain|, one rounding 5e-4 on dv; one rounding on
// the intra-chunk products would leave 5.6e-3 on dlogw under strong decay,
// beyond its 1e-3 limit.  Not wgmma: its TF32 form reads B only K-major, so
// G_c, which the products take both ways round, would need a transposed
// copy, and each split operand a hi and a lo copy in the swizzled layout,
// beyond the shared memory left; mma.sync reads its fragments from the
// plain tiles (rows padded by 4 floats; 8-byte loads in a k order that
// serves them, with rows padded by 8 to keep them conflict-free, gained
// nothing on the card).
// Tiles come in by 16-byte cp.async, rows past T zero-filled (logw = 0 and
// r = k = v = dy = 0, so the state and its gradient are carried exactly).
// Scratch (allocated by the binding): B x H x chunks x (2 N^2 + 2 N) fp32,
// 136 MB at the training shape.
//
// What holds it back (kernels/rwkv6/probe.py --bwd on the card, and copies
// of this source with parts taken out; PERF.md has the numbers): pass 3 is
// about 70% of the time, and with one block an SM its tile loads are not
// overlapped with its work; building the product fragments (shared-memory
// loads, the decay factors, the splits) costs more than the products.
//
// Deterministic: no atomics, every sum in a fixed order, a (b, h) row's bits
// independent of B and of the other rows.
//
// C interface (loaded with ctypes), returning the cudaError_t of its
// launches (0 on success): repro_wkv6_bwd(r, k, v, logw, u, S0, dy, dS, dr,
// dk, dv, dlogw, du, dS0, scratch, B, T, H, N, stream); S0 and dS may be
// null (zeros), dS0 may be null (not computed); scratch is
// repro_wkv6_bwd_scratch_bytes(B, T, H, N) bytes.  r, k, v, logw, dy, dr,
// dk, dv, dlogw are (B, T, H, N), u and du (H, N), S0, dS and dS0 (B, H,
// N, N), all contiguous and 16-byte aligned; N is 16, 32 or 64.
// repro_wkv6_bwd_last_launch gives the threads a block, the chunk length,
// the dynamic shared memory and the blocks of the last call's main pass
// (3).

#include "wkv6_common.cuh"

namespace {

constexpr int CT = 256;              // threads a block, pass 1
constexpr int CW = CT / 32;
constexpr int CT3 = 512;             // threads a block, pass 3
constexpr int CW3 = CT3 / 32;
constexpr int SCAN_T = 64;           // threads a block, pass 2 (a float4 each)
int last_launch[4];

// two floats as a bf16 pair (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// How an operand enters a product: EXACT in TF32 (bf16 values), SPLIT into
// TF32 hi + lo (the product near fp32's), or ROUNDed to TF32 once.
enum { EXACT = 0, SPLIT = 1, ROUND = 2 };

__device__ __forceinline__ void tf32_operand(int how, float x, uint32_t& hi, uint32_t& lo) {
  if (how == SPLIT) split_tf32(x, hi, lo);
  else hi = how == ROUND ? to_tf32(x) : __float_as_uint(x);
}

// acc (16 x 8 NT) += A (16 x K) B (K x 8 NT) over k in [k0, k1), m16n8k8:
// fa(m, k) reads A, fb(k, n) reads B, each entering as OA and OB say.
template <int NT, int OA, int OB, typename FA, typename FB>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], int k0, int k1, FA fa, FB fb) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = k0; ks < k1; ks += 8) {
    const float a[4] = {fa(g, ks + q), fa(g + 8, ks + q), fa(g, ks + q + 4),
                        fa(g + 8, ks + q + 4)};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_operand(OA, a[e], ahi[e], alo[e]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0h, b0l, b1h, b1l;
      tf32_operand(OB, fb(ks + q, nt * 8 + g), b0h, b0l);
      tf32_operand(OB, fb(ks + q + 4, nt * 8 + g), b1h, b1l);
      if constexpr (OA == SPLIT) mma(acc[nt], alo, b0h, b1h);
      if constexpr (OB == SPLIT) mma(acc[nt], ahi, b0l, b1l);
      mma(acc[nt], ahi, b0h, b1h);
    }
  }
}

// C fragment element e of n-tile nt: its row and column in the 16 x 8 NT tile
__device__ __forceinline__ int frag_row(int e) { return (threadIdx.x % 32) / 4 + (e >= 2 ? 8 : 0); }
__device__ __forceinline__ int frag_col(int nt, int e) {
  return nt * 8 + 2 * (threadIdx.x % 4) + (e & 1);
}

// ---------------------------------------------------------------------------
// Pass 1: increments
// ---------------------------------------------------------------------------

template <int N>
struct IncSmem {
  bf16 k[Q][N + 8], v[Q][N + 8];
  float kt[Q][N + 4];      // logw, then k~ in place; read transposed
  float rt[Q][N + 4];      // r (bf16 rows, R below), then r~; read transposed
  float dy[Q][N + 4];
  float part[NSB][N];      // sub-block totals of logw
  float dec[N];            // a_c
  // r's bf16 rows in rt's place; 71.9 KB in all at N = 64: three blocks an SM
  __device__ bf16 (*R())[N + 8] { return reinterpret_cast<bf16 (*)[N + 8]>(rt); }
};

template <int N>
__global__ void __launch_bounds__(CT, 3)
wkv6_bwd_inc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ dy, float* __restrict__ Sinc,
                    float* __restrict__ Ginc, float* __restrict__ dec, int T, int H, int NC) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  IncSmem<N>& s = *reinterpret_cast<IncSmem<N>*>(smem_raw);
  static_assert(N * NSB <= CT, "one thread per (channel, sub-block)");
  pdl_trigger();                        // pass 2 may start: it waits for this
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = ch * Q;
  const int64_t row0 = (int64_t)b * T * H + h;
  const int64_t chunk = ((int64_t)b * H + h) * NC + ch;
  load_rows<N, CT>(s.k, k, row0, H, t0, T, tid);
  load_rows<N, CT>(s.v, v, row0, H, t0, T, tid);
  load_rows<N, CT>(s.R(), r, row0, H, t0, T, tid);
  load_rows<N, CT>(s.kt, lw, row0, H, t0, T, tid);
  load_rows<N, CT>(s.dy, dy, row0, H, t0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // k~_s = k_s exp((lpl_15 - lpl_s) + the later sub-blocks' totals) and
  // r~_t = r_t exp(logP_{t-1}), both exponents <= 0
  const int c = tid % N, seg = tid / N;
  float lpl[L], rr[L];
  if (seg < NSB) {
    local_cumsum(s.kt, s.part, c, seg, lpl);
#pragma unroll
    for (int m = 0; m < L; ++m) rr[m] = bf(s.R()[seg * L + m][c]);
  }
  __syncthreads();                      // every r read before r~ goes over it
  if (seg < NSB) {
    float later = 0.f, off = 0.f, end = 0.f;
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      end += s.part[j][c];
      if (j > seg) later += s.part[j][c];
      if (j < seg) off += s.part[j][c];
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int t = seg * L + m;
      s.kt[t][c] = bf(s.k[t][c]) * __expf((lpl[L - 1] - lpl[m]) + later);
      s.rt[t][c] = rr[m] * __expf(m ? lpl[m - 1] + off : off);
    }
    if (seg == 0) s.dec[c] = __expf(end);
  }
  __syncthreads();

  // M = N key channels i, N = N value columns j, K = Q steps; a warp takes
  // TPW consecutive n-tiles of one m-tile of both products
  constexpr int NTL = N / 8, TILES = (N / 16) * NTL;
  constexpr int TPW = (TILES + CW - 1) / CW;
  static_assert(NTL % TPW == 0, "a warp's tiles share one m-tile");
  const int warp = tid / 32, tile0 = warp * TPW;
  if (tile0 < TILES) {
    const int i0 = (tile0 / NTL) * 16, nt0 = (tile0 % NTL) * 8;
    float accS[TPW][4] = {}, accG[TPW][4] = {};
    mma_rows<TPW, SPLIT, EXACT>(accS, 0, Q, [&](int m, int kk) { return s.kt[kk][i0 + m]; },
                               [&](int kk, int n) { return bf(s.v[kk][nt0 + n]); });
    mma_rows<TPW, SPLIT, SPLIT>(accG, 0, Q, [&](int m, int kk) { return s.rt[kk][i0 + m]; },
                              [&](int kk, int n) { return s.dy[kk][nt0 + n]; });
    float* outS = Sinc + chunk * N * N;
    float* outG = Ginc + chunk * N * N;
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int64_t at = (int64_t)(i0 + frag_row(e)) * N + nt0 + frag_col(j, e);
        *reinterpret_cast<float2*>(&outS[at]) = make_float2(accS[j][e], accS[j][e + 1]);
        *reinterpret_cast<float2*>(&outG[at]) = make_float2(accG[j][e], accG[j][e + 1]);
      }
  }
  if (tid < N) dec[chunk * N + tid] = s.dec[tid];
}

// ---------------------------------------------------------------------------
// Pass 2: the scans over the chunks
// ---------------------------------------------------------------------------

// Per (b, h, 4 x SCAN_T state elements): S_c over the state increments
// (forward), then G_c over the gradient increments (backward).
template <int N>
__global__ void __launch_bounds__(SCAN_T, 8)
wkv6_bwd_scan_kernel(const float* __restrict__ S0, const float* __restrict__ dS,
                     float* __restrict__ Sbuf, float* __restrict__ Gbuf,
                     const float* __restrict__ dec, float* __restrict__ dS0, int H, int NC) {
  pdl_trigger();                        // pass 3 may start its loads
  pdl_wait();                           // every increment written
  const int h = blockIdx.y, b = blockIdx.z;
  const int e4 = blockIdx.x * SCAN_T + threadIdx.x;
  const int64_t head = (int64_t)b * H + h;
  float4* S4 = reinterpret_cast<float4*>(Sbuf + head * NC * N * N);
  float4* G4 = reinterpret_cast<float4*>(Gbuf + head * NC * N * N);
  const float* dc = dec + head * NC * N + e4 * 4 / N;
  constexpr int E4 = N * N / 4;         // float4 a state
  constexpr int UNR = 8;                // chunks whose loads go out together
  // the reverse walk's first group is loaded with the forward walk's
  float4 gd[UNR];
  float ga[UNR];
#pragma unroll
  for (int j = 0; j < UNR; ++j)
    if (NC - 1 - j >= 0) gd[j] = G4[(NC - 1 - j) * E4 + e4], ga[j] = dc[(NC - 1 - j) * N];
  float4 st = S0 ? reinterpret_cast<const float4*>(S0 + head * N * N)[e4]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < NC; c0 += UNR) {
    float4 d[UNR];
    float a[UNR];
#pragma unroll
    for (int j = 0; j < UNR; ++j)
      if (c0 + j < NC) d[j] = S4[(c0 + j) * E4 + e4], a[j] = dc[(c0 + j) * N];
#pragma unroll
    for (int j = 0; j < UNR; ++j)
      if (c0 + j < NC) {
        S4[(c0 + j) * E4 + e4] = st;
        st = make_float4(fmaf(a[j], st.x, d[j].x), fmaf(a[j], st.y, d[j].y),
                         fmaf(a[j], st.z, d[j].z), fmaf(a[j], st.w, d[j].w));
      }
  }
  float4 G = dS ? reinterpret_cast<const float4*>(dS + head * N * N)[e4]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c1 = NC - 1; c1 >= 0; c1 -= UNR) {
    if (c1 < NC - 1) {
#pragma unroll
      for (int j = 0; j < UNR; ++j)
        if (c1 - j >= 0) gd[j] = G4[(c1 - j) * E4 + e4], ga[j] = dc[(c1 - j) * N];
    }
#pragma unroll
    for (int j = 0; j < UNR; ++j) {
      const int c = c1 - j;
      if (c < 0) break;
      G4[c * E4 + e4] = G;
      G = make_float4(fmaf(ga[j], G.x, gd[j].x), fmaf(ga[j], G.y, gd[j].y),
                      fmaf(ga[j], G.z, gd[j].z), fmaf(ga[j], G.w, gd[j].w));
    }
  }
  if (dS0) reinterpret_cast<float4*>(dS0 + head * N * N)[e4] = G;
}

// ---------------------------------------------------------------------------
// Pass 3: the gradients of a chunk
// ---------------------------------------------------------------------------

template <int N>
struct ChunkSmem {
  bf16 r[Q][N + 8], k[Q][N + 8], v[Q][N + 8];
  bf16 dv[Q][N + 8];       // dv before its store
  float lp[Q][N + 4];      // logw, then logP: inclusive, from the chunk's start
  float dy[Q][N + 4];
  float S[N][N + 4];       // S_c
  float G[N][N + 4];       // G_c
  float A[Q][Q + 4];       // the forward's scores, lower block triangle
  float dA[Q][Q + 4];      // dy_t . v_s, lower block triangle
  float dr0[Q][N + 4];     // dr0 and dk0 but for the diagonal sub-blocks
  float dk0[Q][N + 4];
  float kh[Q][N + 4];      // k_s exp(logP_e - logP_s), e its sub-block's last step
  float rh[Q][N + 4];      // r_t exp(logP_{t-1} - logP_p), p the step before its sub-block
  float E[NSB + 1][NSB][N];  // exp(logP_p - logP_e): p = 16 i - 1, e = 16 j + 15, j < i
  float u[N];
  float part[NSB][N];      // sub-block totals of logw, then of r dr0 - k dk0
  float dup[NSB][N];       // du's sub-block parts
  float kd[NSB][N];        // sub-block parts of sum_s k_s (V G_c^T)[s] exp(logP_{Q-1} - logP_s)
  float gs[NSB][N];        // column parts of rowsum(G_c * S_c)
};

// The output products: kind (dr0, dk0 or dv) x row sub-block x 16-column
// quarter.  At N = 64 warp w takes three of quarter w % 4, ordered so that
// the warps' mma counts are 94-100 per quarter (dv's sub-block j costs 48 -
// 6j, dr0's i 24 + 6i, dk0's j 34 - 6j); below it one or two in the order
// of BY_COST.
enum { K_DR = 0, K_DK = 1, K_DV = 2 };
__host__ __device__ constexpr int task(int kind, int blk) { return kind * 4 + blk; }
__constant__ int TASKS64[4][3] = {
    {task(K_DV, 0), task(K_DV, 3), task(K_DK, 3)},
    {task(K_DR, 3), task(K_DR, 1), task(K_DK, 1)},
    {task(K_DV, 1), task(K_DK, 0), task(K_DK, 2)},
    {task(K_DR, 2), task(K_DV, 2), task(K_DR, 0)}};
__constant__ int BY_COST[12] = {task(K_DV, 0), task(K_DR, 3), task(K_DV, 1), task(K_DR, 2),
                                task(K_DV, 2), task(K_DK, 0), task(K_DR, 1), task(K_DV, 3),
                                task(K_DK, 1), task(K_DR, 0), task(K_DK, 2), task(K_DK, 3)};

template <int N>
__device__ __forceinline__ void output_task(ChunkSmem<N>& s, int tk, int quarter) {
  constexpr int NT = 2;                          // 16 columns a task
  const int kind = tk / 4, blk = tk % 4, cb = quarter * 16;
  const int r0 = blk * L;                        // the task's rows
  float acc[NT][4] = {}, intra[NT][4] = {};
  if (kind == K_DR) {
    // (dY S^T) exp(logP_{t-1}) + exp(logP_{t-1} - logP_p) (dA k^), p = r0 - 1
    mma_rows<NT, SPLIT, SPLIT>(acc, 0, N, [&](int m, int kk) { return s.dy[r0 + m][kk]; },
                               [&](int kk, int n) { return s.S[cb + n][kk]; });
    if (blk) {
      mma_rows<NT, SPLIT, SPLIT>(intra, 0, r0, [&](int m, int kk) { return s.dA[r0 + m][kk]; },
                               [&](int kk, int n) { return s.kh[kk][cb + n] * s.E[blk][kk / L][cb + n]; });
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + frag_row(e), i = cb + frag_col(nt, e);
        const float pm1 = t ? s.lp[t - 1][i] : 0.f;
        float x = acc[nt][e] * __expf(pm1);
        if (blk) x = fmaf(intra[nt][e], __expf(pm1 - s.lp[r0 - 1][i]), x);
        s.dr0[t][i] = x;
      }
  } else if (kind == K_DK) {
    // (V G^T) exp(logP_{Q-1} - logP_s) + exp(logP_e - logP_s) (dA^T r^),
    // e = the sub-block's last step
    mma_rows<NT, EXACT, SPLIT>(acc, 0, N, [&](int m, int kk) { return bf(s.v[r0 + m][kk]); },
                               [&](int kk, int n) { return s.G[cb + n][kk]; });
    const int e = r0 + L - 1;
    if (e + 1 < Q) {
      mma_rows<NT, SPLIT, SPLIT>(intra, e + 1, Q, [&](int m, int kk) { return s.dA[kk][r0 + m]; },
                               [&](int kk, int n) { return s.rh[kk][cb + n] * s.E[kk / L][blk][cb + n]; });
    }
    float kd[NT][2] = {};                        // over the rows, k_s times the inter part
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = r0 + frag_row(f), i = cb + frag_col(nt, f);
        float x = acc[nt][f] * __expf(s.lp[Q - 1][i] - s.lp[t][i]);
        kd[nt][f & 1] = fmaf(bf(s.k[t][i]), x, kd[nt][f & 1]);
        if (e + 1 < Q) x = fmaf(intra[nt][f], __expf(s.lp[e][i] - s.lp[t][i]), x);
        s.dk0[t][i] = x;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int o = 4; o < 32; o *= 2) kd[nt][j] += __shfl_xor_sync(0xffffffffu, kd[nt][j], o);
        if (threadIdx.x % 32 < 4) s.kd[blk][cb + frag_col(nt, j)] = kd[nt][j];
      }
  } else {
    // k~ G + A^T dY, from the sub-block's own rows of A on
    const float* Ee = s.E[NSB][blk];
    mma_rows<NT, ROUND, ROUND>(acc, 0, N, [&](int m, int kk) { return s.kh[r0 + m][kk] * Ee[kk]; },
                             [&](int kk, int n) { return s.G[kk][cb + n]; });
    mma_rows<NT, ROUND, ROUND>(acc, r0, Q, [&](int m, int kk) { return s.A[kk][r0 + m]; },
                             [&](int kk, int n) { return s.dy[kk][cb + n]; });
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 4; f += 2) {
        const int t = r0 + frag_row(f), j = cb + frag_col(nt, f);
        *reinterpret_cast<uint32_t*>(&s.dv[t][j]) = pack_bf(acc[nt][f], acc[nt][f + 1]);
      }
  }
}

// pass 3's tensors and sizes
struct ChunkArgs {
  const bf16 *r, *k, *v;
  const float *lw, *u, *dy, *Sbuf, *Gbuf;
  bf16 *dr, *dk, *dv;
  float *dlw, *du_part;
  int T, H, NC;
};

template <int N>
__global__ void __launch_bounds__(CT3, 1) wkv6_bwd_chunk_kernel(const ChunkArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<N>& s = *reinterpret_cast<ChunkSmem<N>*>(smem_raw);
  pdl_trigger();                        // pass 4 may start: it waits for this
  const bf16 *r = args.r, *k = args.k, *v = args.v;
  const float *lw = args.lw, *u = args.u, *dy = args.dy;
  const int T = args.T, H = args.H, NC = args.NC;
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = ch * Q;
  const int64_t row0 = (int64_t)b * T * H + h;
  const int64_t chunk = ((int64_t)b * H + h) * NC + ch;
  const int warp = tid / 32;
  // the inputs first: none of them is written by passes 1 and 2
  load_rows<N, CT3>(s.lp, lw, row0, H, t0, T, tid);
  load_rows<N, CT3>(s.r, r, row0, H, t0, T, tid);
  load_rows<N, CT3>(s.k, k, row0, H, t0, T, tid);
  load_rows<N, CT3>(s.v, v, row0, H, t0, T, tid);
  load_rows<N, CT3>(s.dy, dy, row0, H, t0, T, tid);
  cp_async_commit();
  if (tid < N) s.u[tid] = u[(int64_t)h * N + tid];
  pdl_wait();                           // passes 1 and 2 are done
  for (int p = tid; p < N * N / 4; p += CT3) {
    const int i = p / (N / 4), e = (p % (N / 4)) * 4;
    cp_async16(&s.S[i][e], args.Sbuf + chunk * N * N + i * N + e, true);
    cp_async16(&s.G[i][e], args.Gbuf + chunk * N * N + i * N + e, true);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // -- logP: thread (c, seg) over its own 16 elements, the earlier
  //    sub-blocks' totals added in order; k^ and r^ from the sub-block's
  //    own sums, E from the totals
  const int c = tid % N, seg = tid / N;
  const bool cs = seg < NSB;            // a (channel, sub-block) thread
  {
    float lpl[L];
    if (cs) {
      local_cumsum(s.lp, s.part, c, seg, lpl);
#pragma unroll
      for (int m = 0; m < L; ++m) {
        const int t = seg * L + m;
        s.kh[t][c] = bf(s.k[t][c]) * __expf(lpl[L - 1] - lpl[m]);
        s.rh[t][c] = bf(s.r[t][c]) * (m ? __expf(lpl[m - 1]) : 1.f);
      }
    }
    __syncthreads();
    if (cs) {
      float off = 0.f;
      for (int j = 0; j < seg; ++j) off += s.part[j][c];
#pragma unroll
      for (int m = 0; m < L; ++m) s.lp[seg * L + m][c] = lpl[m] + off;
      // E[seg + 1][j] = exp(the totals of sub-blocks j + 1 .. seg)
      float x = 0.f;
      for (int j = seg; j >= 0; --j) {
        s.E[seg + 1][j][c] = __expf(x);
        x += s.part[j][c];
      }
    }
  }
  __syncthreads();

  // -- 16 x 16 tiles on the tensor cores, one a warp: the scores of
  //    sub-block pairs j < i, r_t exp(logP_{t-1} - logP_e) . k_s exp(logP_e -
  //    logP_s) with e j's last step, and dA off and on the diagonal
  constexpr int NPAIR = NSB * (NSB - 1) / 2;
  if (warp < 2 * NPAIR + NSB) {
    const int tile = warp;
    int ri, sj;
    if (tile < 2 * NPAIR) {
      const int pair = tile % NPAIR;
      const int pi = pair < 1 ? 1 : pair < 3 ? 2 : 3;
      ri = pi * L, sj = (pair - (pi * (pi - 1)) / 2) * L;
    } else {
      ri = sj = (tile - 2 * NPAIR) * L;
    }
    float sc[2][4] = {};
    if (tile < NPAIR) {
      const float* Ee = s.E[ri / L][sj / L];
      mma_rows<2, ROUND, ROUND>(sc, 0, N, [&](int m, int kk) { return s.rh[ri + m][kk] * Ee[kk]; },
                                [&](int kk, int n) { return s.kh[sj + n][kk]; });
    } else {
      mma_rows<2, SPLIT, EXACT>(sc, 0, N, [&](int m, int kk) { return s.dy[ri + m][kk]; },
                                [&](int kk, int n) { return bf(s.v[sj + n][kk]); });
    }
    float (*dst)[Q + 4] = tile < NPAIR ? s.A : s.dA;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int f = 0; f < 4; f += 2)
        *reinterpret_cast<float2*>(&dst[ri + frag_row(f)][sj + frag_col(nt, f)]) =
            make_float2(sc[nt][f], sc[nt][f + 1]);
  }
  // -- the scores inside the sub-blocks, s < t.  Warp 12 + d takes the
  //    lower left quarter of sub-block d, t in its last 8 steps against s
  //    in its first 8, split at e, the 8th step (rows 0-7 of the 16-row
  //    product are zero); each of the other scores one thread, direct in
  //    fp32 over the channels in order; then the bonus r_t . (u k_t) on the
  //    diagonals and the zeros above them
  if (warp >= 2 * NPAIR && warp < 2 * NPAIR + NSB) {
    const int r0 = (warp - 2 * NPAIR) * L, e = r0 + L / 2 - 1;
    float sc[1][4] = {};
    mma_rows<1, ROUND, ROUND>(
        sc, 0, N,
        [&](int m, int kk) {
          return m < L / 2 ? 0.f
                           : bf(s.r[r0 + m][kk]) * __expf(s.lp[r0 + m - 1][kk] - s.lp[e][kk]);
        },
        [&](int kk, int n) { return bf(s.k[r0 + n][kk]) * __expf(s.lp[e][kk] - s.lp[r0 + n][kk]); });
    *reinterpret_cast<float2*>(&s.A[r0 + frag_row(2)][r0 + frag_col(0, 2)]) =
        make_float2(sc[0][2], sc[0][3]);
  }
  // (t, s), s < t, of the idx-th score below the diagonal of a square
  auto below = [](int idx, int& t, int& sl) {
    t = static_cast<int>(0.5f * (1.f + sqrtf(1.f + 8.f * idx)));
    if (t * (t - 1) / 2 > idx) --t;
    if (t * (t + 1) / 2 <= idx) ++t;
    sl = idx - t * (t - 1) / 2;
  };
  constexpr int NHALF = (L / 2) * (L / 2 - 1) / 2;     // below a half's diagonal
  constexpr int NLOW = L * (L - 1) / 2;                // below a sub-block's
  constexpr int BONUS0 = 256, ZERO0 = BONUS0 + Q;      // the threads of the rest
  static_assert(2 * NSB * NHALF <= BONUS0 && ZERO0 < CT3, "thread ranges");
  if (tid < 2 * NSB * NHALF) {
    int t, sl;
    below(tid % NHALF, t, sl);
    const int base = (tid / NHALF) * (L / 2);          // the half's first step
    const int ts = base + t, ss = base + sl;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < N; i += 4) {
      float rr[4], kk[4], pa[4], ps[4];
      load_bf<4>(&s.r[ts][i], rr);
      load_bf<4>(&s.k[ss][i], kk);
      load_f<4>(&s.lp[ts - 1][i], pa);
      load_f<4>(&s.lp[ss][i], ps);
#pragma unroll
      for (int m = 0; m < 4; ++m) a = fmaf(rr[m] * kk[m], __expf(pa[m] - ps[m]), a);
    }
    s.A[ts][ss] = a;
  } else if (tid >= BONUS0 && tid < ZERO0) {
    const int t = tid - BONUS0;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < N; i += 4) {
      float rr[4], kk[4];
      load_bf<4>(&s.r[t][i], rr);
      load_bf<4>(&s.k[t][i], kk);
#pragma unroll
      for (int m = 0; m < 4; ++m) a = fmaf(rr[m] * s.u[i + m], kk[m], a);
    }
    s.A[t][t] = a;
  } else if (tid >= ZERO0) {
    for (int e = tid - ZERO0; e < NSB * NLOW; e += CT3 - ZERO0) {
      int t, sl;
      below(e % NLOW, t, sl);
      s.A[(e / NLOW) * L + sl][(e / NLOW) * L + t] = 0.f;
    }
  }
  cp_async_wait<0>();                   // S_c and G_c landed
  __syncthreads();                      // every score and dA written

  // -- dr0, dk0 (but for the diagonal sub-blocks) and dv
  if constexpr (N == 64) {
#pragma unroll 1
    for (int j = 0; j < 3; ++j) output_task<N>(s, TASKS64[warp / 4][j], warp % 4);
  } else {
#pragma unroll 1
    for (int j = warp; j < 12 * (N / 16); j += CW3) output_task<N>(s, BY_COST[j % 12], j / 12);
  }
  __syncthreads();

  // -- the diagonal sub-blocks' terms in fp32, added to the staged sums:
  //    thread (c, seg) of the first N x NSB dr0's, of the next dk0's (and
  //    its columns of rowsum(G_c * S_c), row c), the decay w over s < m < t
  //    a running product
  {
    const int role = tid / (N * NSB), c2 = tid % N, sg = (tid / N) % NSB, tb = sg * L;
    if (role < 2) {
      float ww[L], x[L], y[L];
      float prev = tb ? s.lp[tb - 1][c2] : 0.f;
#pragma unroll
      for (int m = 0; m < L; ++m) {
        const float l = s.lp[tb + m][c2];
        ww[m] = __expf(l - prev);
        prev = l;
        x[m] = bf(role ? s.r[tb + m][c2] : s.k[tb + m][c2]);
        y[m] = 0.f;
      }
#pragma unroll
      for (int sl = 0; sl < L; ++sl) {
        float W = 1.f;                   // prod_{sl < m < t} w_m
#pragma unroll
        for (int t = sl + 1; t < L; ++t) {
          const float a = s.dA[tb + t][tb + sl];
          if (role) y[sl] = fmaf(a * x[t], W, y[sl]);
          else y[t] = fmaf(a * x[sl], W, y[t]);
          W *= ww[t];
        }
      }
      float (*dst)[N + 4] = role ? s.dk0 : s.dr0;
#pragma unroll
      for (int m = 0; m < L; ++m) dst[tb + m][c2] += y[m];
      if (role) {
        constexpr int CPS = N / NSB;
        float gsum = 0.f;
#pragma unroll
        for (int j = 0; j < CPS; j += 4) {
          const float4 gv = *reinterpret_cast<const float4*>(&s.G[c2][sg * CPS + j]);
          const float4 sv = *reinterpret_cast<const float4*>(&s.S[c2][sg * CPS + j]);
          gsum = fmaf(gv.x, sv.x, fmaf(gv.y, sv.y, fmaf(gv.z, sv.z, fmaf(gv.w, sv.w, gsum))));
        }
        s.gs[sg][c2] = gsum;
      }
    }
  }
  __syncthreads();

  // -- per (channel c, sub-block seg): the bonus, dlogw's reverse sums and
  //    du's part
  float kk[L], e0[L], sfx[L];
  if (cs) {
    float rr[L], d0[L], dup = 0.f, run = 0.f;
    const int tb = seg * L;
#pragma unroll
    for (int m = 0; m < L; ++m) {
      rr[m] = bf(s.r[tb + m][c]);
      kk[m] = bf(s.k[tb + m][c]);
      d0[m] = s.dr0[tb + m][c];
      e0[m] = s.dk0[tb + m][c];
    }
    const float uc = s.u[c];
#pragma unroll
    for (int m = L - 1; m >= 0; --m) {
      sfx[m] = run;
      run += rr[m] * d0[m] - kk[m] * e0[m];
    }
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const float cc = s.dA[tb + m][tb + m];       // v_t . dy_t
      dup = fmaf(rr[m] * kk[m], cc, dup);
      const int t = t0 + tb + m;
      if (t < T) {
        const int64_t at = (row0 + (int64_t)t * H) * N + c;
        args.dr[at] = __float2bfloat16_rn(fmaf(uc * kk[m], cc, d0[m]));
        args.dk[at] = __float2bfloat16_rn(fmaf(uc * rr[m], cc, e0[m]));
      }
    }
    s.part[seg][c] = run;
    s.dup[seg][c] = dup;
  }
  __syncthreads();
  if (cs) {
    // D_c = rowsum(G_c * S_{c+1}) = a_c rowsum(G_c * S_c) + rowsum(G_c * k~^T V),
    // the last sum_s k_s dk0's inter part
    float gsum = 0.f, kdsum = 0.f;
#pragma unroll
    for (int j = 0; j < NSB; ++j) gsum += s.gs[j][c], kdsum += s.kd[j][c];
    float base = fmaf(__expf(s.lp[Q - 1][c]), gsum, kdsum);
    for (int j = seg + 1; j < NSB; ++j) base += s.part[j][c];
#pragma unroll
    for (int m = 0; m < L; ++m) {
      const int t = t0 + seg * L + m;
      if (t < T) args.dlw[(row0 + (int64_t)t * H) * N + c] = (base + sfx[m]) - kk[m] * e0[m];
    }
    if (seg == 0) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < NSB; ++j) x += s.dup[j][c];
      args.du_part[chunk * N + c] = x;
    }
  }
  // dv, 16 bytes a thread
  constexpr int PIECES = N / 8;
  for (int p = tid; p < Q * PIECES; p += CT3) {
    const int tt = p / PIECES, e = (p % PIECES) * 8;
    if (t0 + tt < T)
      *reinterpret_cast<uint4*>(args.dv + (row0 + (int64_t)(t0 + tt) * H) * N + e) =
          *reinterpret_cast<const uint4*>(&s.dv[tt][e]);
  }
}

// Pass 4: du[h][i] = the (b, h, chunk) parts summed over b, then chunks, in order
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                                   int B, int H, int NC, int N) {
  pdl_wait();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * N) return;
  const int h = idx / N, i = idx % N;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < NC; ++c) s += part[(((int64_t)b * H + h) * NC + c) * N + i];
  du[idx] = s;
}

struct Scratch {
  float *S, *G, *dec, *du_part;
};

Scratch carve(void* scratch, int B, int T, int H, int N) {
  const int64_t heads = (int64_t)B * H * ((T + Q - 1) / Q);
  float* p = static_cast<float*>(scratch);
  Scratch s;
  s.S = p;
  s.G = s.S + heads * N * N;
  s.dec = s.G + heads * N * N;
  s.du_part = s.dec + heads * N;
  return s;
}

int64_t scratch_floats(int B, int T, int H, int N) {
  const int64_t heads = (int64_t)B * H * ((T + Q - 1) / Q);
  return heads * (2 * (int64_t)N * N + 2 * N);
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const void* S0, const void* dy, const void* dS, void* dr, void* dk, void* dv,
                   void* dlw, void* du, void* dS0, void* scratch, int B, int T, int H,
                   cudaStream_t st) {
  const int NC = (T + Q - 1) / Q;
  const Scratch sc = carve(scratch, B, T, H, N);
  const bf16 *rb = static_cast<const bf16*>(r), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float *lwf = static_cast<const float*>(lw), *dyf = static_cast<const float*>(dy);
  const dim3 grid(NC, H, B);
  const size_t smem1 = sizeof(IncSmem<N>), smem3 = sizeof(ChunkSmem<N>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_inc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_bwd_chunk_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  wkv6_bwd_inc_kernel<N><<<grid, CT, smem1, st>>>(rb, kb, vb, lwf, dyf, sc.S, sc.G, sc.dec, T,
                                                  H, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(N * N / 4 / SCAN_T, H, B);
  cfg.blockDim = dim3(SCAN_T);
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_scan_kernel<N>, static_cast<const float*>(S0),
                           static_cast<const float*>(dS), sc.S, sc.G,
                           static_cast<const float*>(sc.dec), static_cast<float*>(dS0), H, NC);
  if (err != cudaSuccess) return err;
  last_launch[0] = CT3;
  last_launch[1] = Q;
  last_launch[2] = (int)smem3;
  const ChunkArgs args{rb, kb, vb, lwf, static_cast<const float*>(u), dyf, sc.S, sc.G,
                       static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       static_cast<float*>(dlw), sc.du_part, T, H, NC};
  last_launch[3] = (int)(grid.x * grid.y * grid.z);
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CT3);
  cfg.dynamicSmemBytes = smem3;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_chunk_kernel<N>, args);
  if (err != cudaSuccess) return err;
  const int HN = H * N;
  cfg.gridDim = dim3((HN + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  return cudaLaunchKernelEx(&cfg, wkv6_bwd_du_kernel, static_cast<const float*>(sc.du_part),
                            static_cast<float*>(du), B, H, NC, N);
}

}  // namespace

extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* S0, const void* dy, const void* dS,
                              void* dr, void* dk, void* dv, void* dlogw, void* du, void* dS0,
                              void* scratch, int B, int T, int H, int N, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16:
      err = launch<16>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, scratch, B, T,
                       H, st);
      break;
    case 32:
      err = launch<32>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, scratch, B, T,
                       H, st);
      break;
    case 64:
      err = launch<64>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, scratch, B, T,
                       H, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" long long repro_wkv6_bwd_scratch_bytes(int B, int T, int H, int N) {
  return 4 * scratch_floats(B, T, H, N);
}

extern "C" void repro_wkv6_bwd_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
