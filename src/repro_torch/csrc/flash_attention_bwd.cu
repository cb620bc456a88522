// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces no TPU kernel: the JAX package differentiates its plain attention
// (jax.grad through repro/models/attention.py, use_pallas off for training),
// and the port's training path runs the forward kernel
// (flash_attention.cu), so its gradient needs a kernel too.  Given q, k, v,
// the forward's output o and its logsumexp lse (natural log, fp32 (B, H, Sq))
// and the output's gradient dO, it computes
//
//   P  = exp(scale q kᵀ - lse)          (masked: causal top-left, ragged S, T)
//   dV = Pᵀ dO                          dP = dO vᵀ
//   dS = P ∘ (dP - delta),  delta = rowsum(dO ∘ o)
//   dQ = scale dS k                     dK = scale dSᵀ q
//
// with GQA (q head h reads kv head h / G; dK and dV sum over the G heads of
// a kv head), on the model's layout: q, dQ (B, S, K, G, hd), o, dO (B, S, K,
// G, hd_v), k, dK (B, T, K, hd), v, dV (B, T, K, hd_v).  It takes (hd, hd_v)
// = (32, 32), (64, 64), (128, 128) and MLA's (192, 128) (deepseek-v2: q and
// k are nope 128 + rope 64 wide, v 128), and nothing else.  Every element of
// dQ, dK and dV is written: a kv tile with no q row below its diagonal writes
// zeros.
//
// Head dim 32 (a width the forward takes; no published config of the
// port trains at it) runs the (64, 64) instantiation on 64-column tiles:
// its tensor maps give the global width as 32, so TMA fills columns 32-63
// of every Q, K, V and dO tile with zeros (they add nothing to S or dP),
// delta sums the 32 columns that exist, and every dQ, dK and dV store stops
// at column 32.  That doubles the products at a width where the launches
// cost more than the work: at (4, 8, 256, 32) causal, q, k, v, o, dO, dQ,
// dK and dV are 524,288 B each and lse 32,768 B, 4.23 MB, 0.0013 ms at
// 3.35 TB/s.
//
// What bounds it on this card: at olmo-1b's training shape (8, 16, 512,
// 128) causal, q, k, v, o, dO in and dQ, dK, dV out are 134 MB (0.040 ms at
// 3.35 TB/s); the five products are 21.5 GFLOP (0.022 ms at 989 TFLOP/s),
// and 30 GFLOP with S and dP computed a second time in the dQ pass: bytes.
// At deepseek-v2's (8, 128 over 128, 512, 192 / 128) causal, q, k, dQ, dK
// are 201,326,592 B each, v, o, dO, dV 134,217,728 B each and lse 2,097,152
// B: 1.344 GB, 0.401 ms; the five products are 223.8 GFLOP over 134.5 M
// causal pairs at 1,664 flop a pair (0.226 ms; 310 GFLOP, 0.313 ms, with
// the dQ pass's second S and dP): bytes again.
//
// What held the first design (mma.sync) back: 0.53451 ms at olmo-1b's shape
// on an H100 80GB HBM3 at a 700 W power limit (chip_smoke.py), 13.3x its
// bound and 1.61x the deterministic SDPA backward.  Every product ran on
// mma.sync from ldmatrix fragments, a fraction of the tensor cores' rate;
// every tile went global -> registers -> padded shared memory behind a
// __syncthreads, so no load overlapped the math, and the dK / dV walk did so
// twice for each 32-row q step; four warps a block with 128 fp32
// accumulators a thread left nothing to hide the latency behind; and delta
// was a third launch that read o and dO once more.
//
// This design (timed by chip_smoke.py phase 3 and kernels/attention/probe.py
// --bwd; PERF.md has the numbers):
//
// * every product on wgmma (bf16 in, fp32 accumulate), 64-row tiles on both
//   sides, with the helpers of the forward (hopper.cuh).  Operands needed
//   transposed are read MN-major through the descriptor's transpose bit
//   from the tile TMA wrote: the same shared Q tile is the K-major B of
//   Sᵀ = K Qᵀ and the MN-major B of dK += dSᵀ Q.  P and dS go from the
//   accumulators, re-packed to bf16, straight into wgmma's register A
//   operand.  The first product of each accumulation ignores it (scale-d
//   0), so no ordinary instruction writes a register an asynchronous
//   product owns;
// * two launches, no atomics, every sum in a fixed order (deterministic: a
//   crash-recovered training run retraces a clean one bit for bit):
//   (1) dQ, one warpgroup a block, one block per (b, q head, q tile): it
//       computes delta for its 64 rows from o and dO while its tiles are in
//       flight, hands delta and lse·log2 e to pass 2 in a scratch row of
//       128 floats, then walks the kv tiles up to the diagonal, recomputing
//       S and dP;
//   (2) dK / dV in the Sᵀ form, one block per (b, kv head, kv tile): it
//       walks the kv head's G q heads and, for each, the q tiles from the
//       diagonal on; Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, then dV += Pᵀ dO and
//       dK += dSᵀ Q, so the GQA sum stays in its registers;
// * pass 2 at MLA's widths in two warpgroups.  One warpgroup holding dK
//   (96 fp32 a thread at 192 columns), dV (64), Sᵀ and dPᵀ (64) and the P
//   and dS fragments (32) needs some 256 registers with its addresses, past
//   the 255 a thread may have.  So the first warpgroup computes Sᵀ, dPᵀ, P
//   and dS and accumulates dV (about 160), and hands each step's dSᵀ
//   fragments to the second through a double-buffered 8 KB shared tile
//   (each thread writes its 16 words where its twin thread of the other
//   warpgroup reads them: no swizzle, no bank conflict) behind an mbarrier;
//   the second accumulates dK += dSᵀ Q from the same ring slot and frees
//   the slot through another mbarrier once its product is done.  The
//   (64, 64) and (128, 128) instantiations keep one warpgroup.  ptxas
//   (nvcc 12.9, -Xptxas -v), no spill anywhere: pass 2 <192, 128> 170
//   registers, pass 1 <192, 128> 202; <128, 128> 250 and 170, <64, 64>
//   186 and 138.  At (8, 128 over 128, 512, 192 / 128) on an H100 80GB
//   HBM3 at 700 W the two launches took 0.634 + 0.707 ms, 1.27 ms in all,
//   3.2x the bound (kernels/attention/probe.py --bwd; PERF.md).  Both
//   passes run one block an SM there, and pass 2's first warpgroup does
//   three of its four products; which of the two costs more is not
//   measured yet;
// * K and V (pass 2) or Q and dO (pass 1) of the block's own tile by TMA
//   once; the streamed tiles (Q, dO with their lse and delta rows in pass
//   2, K, V in pass 1) through a 2-stage mbarrier ring, by 4-D tensor maps
//   over (d, position, head, batch) that zero-fill past S and T.  A step's
//   first products start as soon as its tile has landed, behind the
//   last step's still-running products; the slot they free is refilled by
//   one thread once S has come back, so the next tile loads during the
//   rest of the step;
// * at hd 64 and 128 about 100 KB of shared memory and at most 255
//   registers a thread, so two blocks share an SM and each hides the
//   other's waits (a third ring stage leaves room for one block an SM, and
//   was 1.22x slower); at (192, 128) about 121 KB (pass 1) and 137 KB (pass
//   2, with the dSᵀ tiles), one block an SM;
// * the tiles of one head are neighbours in the grid, longest causal walk
//   first (the last q tiles in pass 1, the first kv tiles in pass 2), so
//   the blocks that stream the same tiles run side by side and find them
//   in L2.  Starting the longest walks of all heads first instead took
//   0.996-1.07x this order's time at the training shape and 1.04-1.06x at
//   (1, 16, 512, 128), in turns in two calls;
// * the tensor maps are encoded on the host by cuTensorMapEncodeTiled,
//   which needs the tensors' context current: autograd calls from a worker
//   thread that may have made no CUDA call yet, so the entry makes the
//   device of q current first (hopper.cuh, use_device_of).
//
// C interface (loaded with ctypes): repro_flash_attention_bwd_bf16 returns a
// cudaError_t (0 on success); strides in elements, multiples of 8 (TMA takes
// 16-byte strides).  `rows` is fp32 scratch of B·H·ceil(Sq / 64)·128 floats,
// 16-byte aligned, that the caller allocates: pass 1 writes all of it and
// pass 2 reads it.  cudaFuncSetAttribute runs once per instantiation.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;      // rows of every tile, q or kv: a warpgroup's wgmma M
constexpr int STAGES = 2;   // streamed tiles in flight a block

// Shared memory of either pass, from a 1024-aligned base: the block's own two
// tiles (Q and dO, or K and V), the ring of STAGES pairs of streamed tiles,
// STAGES rows of lse·log2 e and delta (pass 2 only), at MLA's widths the two
// dSᵀ tiles pass 2's warpgroups share, then the barriers.  Every tile is in
// wgmma's 128-byte swizzle as TMA writes it: 64-column blocks of 64 rows x
// 128 bytes; a Q or K tile is DQK wide, a dO or V tile DV.
template <int DQK, int DV>
struct Smem {
  // pass 2's dK in a warpgroup of its own (see the note above)
  static constexpr bool SPLIT = DQK > 128;
  static constexpr int THREADS = SPLIT ? 256 : 128;  // pass 2's block
  static constexpr int QK_TILE = BM * DQK * 2;
  static constexpr int V_TILE = BM * DV * 2;
  static constexpr int OWN = QK_TILE + V_TILE;
  static constexpr int STAGE = QK_TILE + V_TILE;
  static constexpr int ROWS = 2 * BM * 4;  // a q tile's lse·log2 e, then its delta
  static constexpr int DS_TILE = BM * BM * 2;
  static constexpr int DS = OWN + STAGES * STAGE + STAGES * ROWS;
  static constexpr int BARS = DS + (SPLIT ? 2 * DS_TILE : 0);
  // own, full[STAGES]; with SPLIT also empty[STAGES], ds_full[2], ds_empty[2]
  static constexpr int N_BARS = 1 + STAGES + (SPLIT ? STAGES + 4 : 0);
  static constexpr size_t BYTES = 1024 + (size_t)BARS + 8 * N_BARS;
};

// The 16-deep k-step kk of a K-major operand (d contiguous), and the 16-row
// k-step j of an MN-major one (the tile's rows are the product's k).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * (BM * 128) + (kk % 4) * 32, 16);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int j) {
  return desc_sw128(tile + j * 2048, BM * 128);
}

// Accumulator (64 x 64) of n-tiles 2j, 2j + 1 -> the register A fragment of
// k-step j, packed to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    a[nt / 2][(nt % 2) * 2 + 0] = pack_f32(c[nt][0], c[nt][1]);
    a[nt / 2][(nt % 2) * 2 + 1] = pack_f32(c[nt][2], c[nt][3]);
  }
}

// A warpgroup's accumulator (64 x N: this thread's rows 16 warp + gr and
// + 8, columns 8 nt + 2 t and + 1, warp and lane within its warpgroup)
// times `scale`, to bf16, rows below `limit` only.
// Columns from NC on (a tile wider than its tensor) are not stored.
template <int N, int NC = N>
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float (&acc)[N / 8][4],
                                           int limit, float scale) {
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32, gr = (wt % 32) / 4, t = wt % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gr + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      *reinterpret_cast<uint32_t*>(g + row * rs + nt * 8 + 2 * t) =
          pack_f32(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// (1) dQ of one 64-row q tile of one q head, and its rows of lse·log2 e and
// delta for pass 2.  GQK and GV are the widths q / k and v / o have in
// global memory: DQK and DV but at head dim 32 (see the note above).
template <int DQK, int DV, int GQK = DQK, int GV = DV>
__global__ void __launch_bounds__(128, 2)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ rows, bf16* __restrict__ dq,
              int H, int G, int Sq, int Sk, long long sqb, long long sqh, long long sqs,
              long long sob, long long soh, long long sos, float scale, float scale_log2,
              int causal) {
  using L = Smem<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t Qs = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t dOs = Qs + L::QK_TILE;
  const uint32_t ring = Qs + L::OWN;
  const uint32_t own_bar = Qs + L::BARS;
  auto full = [&](int s) { return own_bar + 8u * (1 + s); };

  // A head's q tiles are neighbours in the grid, its longest causal walk
  // first: they read the same K / V tiles at about the same time.
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;
  const int q0 = qt * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, t = lane % 4;

  int n_kv = (Sk + BM - 1) / BM;
  if (causal) n_kv = min(n_kv, (min(q0 + BM, Sq) - 1) / BM + 1);

  // The i-th kv tile into ring slot i % STAGES, by one thread.
  auto load_kv = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * L::STAGE;
    mbar_expect_tx(full(i % STAGES), L::STAGE);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c)
      tma_load_4d(st + c * BM * 128, &tmk, full(i % STAGES), c * 64, i * BM, kh, b);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_4d(st + L::QK_TILE + c * BM * 128, &tmv, full(i % STAGES), c * 64, i * BM, kh, b);
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(own_bar + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(own_bar, L::OWN);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c) tma_load_4d(Qs + c * BM * 128, &tmq, own_bar, c * 64, q0, h, b);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_4d(dOs + c * BM * 128, &tmdo, own_bar, c * 64, q0, h, b);
    for (int i = 0; i < STAGES - 1 && i < n_kv; ++i) load_kv(i);
  }

  // While the tiles fly: delta = rowsum(dO ∘ o) of this thread's rows 16 warp
  // + gr and + 8, the four lanes of a row each summing a quarter of d_v in
  // order, then a fixed butterfly; and lse in the log2 domain.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    float acc = 0.f;
    if (row < Sq) {
      const long long off = b * sob + h * soh + row * sos + t * (GV / 4);
#pragma unroll
      for (int c = 0; c < GV / 32; ++c) {
        const uint4 x = *reinterpret_cast<const uint4*>(o + off + 8 * c);
        const uint4 y = *reinterpret_cast<const uint4*>(dout + off + 8 * c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          acc = fmaf(a.x, d.x, acc);
          acc = fmaf(a.y, d.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lse2[r] = row < Sq ? lse[((long long)b * H + h) * Sq + row] * LOG2E : 0.f;
  }
  if (t == 0) {  // every row of the tile, the ones past Sq as zeros
    float* rr = rows + (((long long)b * H + h) * n_qt + qt) * (2 * BM);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rr[warp * 16 + gr + 8 * r] = lse2[r];
      rr[BM + warp * 16 + gr + 8 * r] = dl[r];
    }
  }
  mbar_wait(own_bar, 0);

  float dQ[DQK / 8][4];
  const int row0 = q0 + warp * 16 + gr;
  for (int i = 0; i < n_kv; ++i) {
    const int k0 = i * BM;
    const uint32_t Ks = ring + (i % STAGES) * L::STAGE, Vs = Ks + L::QK_TILE;
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);

    // S = Q Kᵀ and dP = dO Vᵀ (64 q x 64 kv), behind the last tile's dQ product.
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) wgmma_ss<64>(s, kmajor(Qs, kk), kmajor(Ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) wgmma_ss<64>(dp, kmajor(dOs, kk), kmajor(Vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the last dQ product and S are done
    fence_regs(s);
    named_sync(1, 128);  // ... in every warp: the last tile's slot is free
    if (tid == 0 && i + STAGES - 1 < n_kv) load_kv(i + STAGES - 1);

    // P: s[nt][e] is row row0 + 8 (e / 2), column k0 + 8 nt + 2 t + e % 2,
    // kept below the row's limit (Sk; causal: the diagonal).
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lim[r] = (causal ? min(row0 + 8 * r + 1, Sk) : Sk) - (k0 + 2 * t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1]));
        s[nt][e] = nt * 8 + (e & 1) < lim[e >> 1] ? p : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P ∘ (dP - delta), into the A operand of dQ += dS K.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dl[e >> 1]);
    uint32_t da[4][4];
    pack_a(da, dp);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<DQK>(dQ, da[j], mnmajor(Ks, j), i > 0 || j > 0);
    wgmma_commit();
    fence_regs(da);
  }
  wgmma_wait<0>();
  fence_regs(dQ);
  store_rows<DQK, GQK>(dq + b * sqb + h * sqh + q0 * sqs, sqs, dQ, Sq - q0, scale);
}

// (2) dK, dV of one 64-row kv tile of one kv head.  With SPLIT, warpgroup 0
// does all of the below but dK, which warpgroup 1 accumulates from the dSᵀ
// fragments warpgroup 0 hands it.
template <int DQK, int DV, int GQK = DQK, int GV = DV>
__global__ void __launch_bounds__(Smem<DQK, DV>::THREADS, Smem<DQK, DV>::SPLIT ? 1 : 2)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
                const float* __restrict__ rows, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int KH, int G, int Sq, int Sk, long long skb, long long skh, long long sks,
                long long svb, long long svh, long long svs, float scale, float scale_log2,
                int causal) {
  using L = Smem<DQK, DV>;
  constexpr bool SPLIT = L::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t Ks = (raw + 1023u) & ~1023u;
  const uint32_t Vs = Ks + L::QK_TILE;
  const uint32_t ring = Ks + L::OWN;
  const uint32_t row_ring = ring + STAGES * L::STAGE;
  const float* row_s = reinterpret_cast<const float*>(smem_raw + (row_ring - raw));
  uint4* const ds_tiles = reinterpret_cast<uint4*>(smem_raw + (Ks + L::DS - raw));
  const uint32_t own_bar = Ks + L::BARS;
  auto full = [&](int s) { return own_bar + 8u * (1 + s); };
  // SPLIT: slot s's dK product is done; dSᵀ tile d is written / read
  auto empty = [&](int s) { return own_bar + 8u * (1 + STAGES + s); };
  auto ds_full = [&](int d) { return own_bar + 8u * (1 + 2 * STAGES + d); };
  auto ds_empty = [&](int d) { return own_bar + 8u * (3 + 2 * STAGES + d); };

  // A kv head's kv tiles are neighbours in the grid, the first (the longest
  // causal walk) first: they read the same Q / dO tiles at about the same time.
  const int kt = blockIdx.x;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int H = KH * G;
  const int kv0 = kt * BM;
  const int n_qt = (Sq + BM - 1) / BM;
  const int qt0 = causal ? kt : 0;  // top-left causal: kv row j is seen by q rows >= j
  const int per_head = max(n_qt - qt0, 0);
  const int n = G * per_head;
  const int tid = threadIdx.x, wt = tid % 128, warp = wt / 32, lane = tid % 32, gr = lane / 4,
            t = lane % 4;
  bf16* const dk_tile = dk + b * skb + kh * skh + kv0 * sks;
  bf16* const dv_tile = dv + b * svb + kh * svh + kv0 * svs;

  // Step i (q head kh G + i / per_head, q tile qt0 + i % per_head) into ring
  // slot i % STAGES, by one thread: Q, dO and the tile's two rows.
  auto load_q = [&](int i) {
    const int h = kh * G + i / per_head, qt = qt0 + i % per_head;
    const int slot = i % STAGES;
    const uint32_t st = ring + slot * L::STAGE;
    mbar_expect_tx(full(slot), L::STAGE + L::ROWS);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c)
      tma_load_4d(st + c * BM * 128, &tmq, full(slot), c * 64, qt * BM, h, b);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_4d(st + L::QK_TILE + c * BM * 128, &tmdo, full(slot), c * 64, qt * BM, h, b);
    bulk_load(row_ring + slot * L::ROWS, rows + (((long long)b * H + h) * n_qt + qt) * (2 * BM),
              L::ROWS, full(slot));
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(own_bar + 8u * s, 1);
    if constexpr (SPLIT)
      for (int s = 0; s < STAGES + 4; ++s) mbar_init(empty(0) + 8u * s, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (SPLIT) {
    if (tid >= 128) {  // warpgroup 1: dK += dSᵀ Q, step by step
      float dK[DQK / 8][4];
      for (int i = 0; i < n; ++i) {
        const int slot = i % STAGES;
        const uint32_t Qs = ring + slot * L::STAGE;
        mbar_wait(full(slot), (i / STAGES) & 1);
        mbar_wait(ds_full(i % 2), (i / 2) & 1);
        const uint4* src = ds_tiles + (i % 2) * (L::DS_TILE / 16);
        uint32_t da[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 x = src[j * 128 + wt];
          da[j][0] = x.x;
          da[j][1] = x.y;
          da[j][2] = x.z;
          da[j][3] = x.w;
        }
        mbar_arrive(ds_empty(i % 2));
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_rs<DQK>(dK, da[j], mnmajor(Qs, j), i > 0 || j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dK);
        fence_regs(da);
        mbar_arrive(empty(slot));  // this warpgroup is done with the slot
      }
      if (n == 0) zero(dK);
      store_rows<DQK, GQK>(dk_tile, sks, dK, Sk - kv0, scale);
      return;
    }
  }

  if (tid == 0) {
    mbar_expect_tx(own_bar, L::OWN);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c) tma_load_4d(Ks + c * BM * 128, &tmk, own_bar, c * 64, kv0, kh, b);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c) tma_load_4d(Vs + c * BM * 128, &tmv, own_bar, c * 64, kv0, kh, b);
    for (int i = 0; i < STAGES - 1 && i < n; ++i) load_q(i);
  }
  mbar_wait(own_bar, 0);

  float dK[SPLIT ? 1 : DQK / 8][4], dV[DV / 8][4];
  const int kvrow0 = kv0 + warp * 16 + gr;
  for (int i = 0; i < n; ++i) {
    const int qs = (qt0 + i % per_head) * BM;
    const int slot = i % STAGES;
    const uint32_t Qs = ring + slot * L::STAGE, dOs = Qs + L::QK_TILE;
    const float* lse2 = row_s + slot * (2 * BM);
    const float* dl = lse2 + BM;
    mbar_wait(full(slot), (i / STAGES) & 1);

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (64 kv x 64 q), behind the last step's dK / dV products.
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) wgmma_ss<64>(s, kmajor(Ks, kk), kmajor(Qs, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) wgmma_ss<64>(dp, kmajor(Vs, kk), kmajor(dOs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the last step's dK / dV products and Sᵀ are done
    fence_regs(s);
    named_sync(1, 128);  // ... in every warp: the last step's slot is free
    if (tid == 0 && i + STAGES - 1 < n) {
      if constexpr (SPLIT) {  // ... and warpgroup 1's dK product on it too
        if (i > 0) mbar_wait(empty((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      }
      load_q(i + STAGES - 1);
    }

    // Pᵀ: s[nt][e] is kv row kvrow0 + 8 (e / 2), q column qs + 8 nt + 2 t + e % 2,
    // kept for q columns below Sq and (causal) on or past the kv row.
    int lo[2];
    const int hi = Sq - (qs + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) lo[r] = causal ? kvrow0 + 8 * r - (qs + 2 * t) : -BM;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (e & 1);
        const float p = ex2(fmaf(s[nt][e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        s[nt][e] = (c >= lo[e >> 1] && c < hi) ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dSᵀ = Pᵀ ∘ (dPᵀ - delta), delta by q column.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? d2.y : d2.x));
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, s);
    pack_a(da, dp);
    if constexpr (SPLIT) {  // dSᵀ to warpgroup 1, once it has read the tile's last use
      mbar_wait(ds_empty(i % 2), ((i / 2) & 1) ^ 1);
      uint4* dst = ds_tiles + (i % 2) * (L::DS_TILE / 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j * 128 + wt] = make_uint4(da[j][0], da[j][1], da[j][2], da[j][3]);
      mbar_arrive(ds_full(i % 2));
    }
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    // dV += Pᵀ dO and dK += dSᵀ Q, dO and Q read MN-major.
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<DV>(dV, pa[j], mnmajor(dOs, j), i > 0 || j > 0);
    if constexpr (!SPLIT) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<DQK>(dK, da[j], mnmajor(Qs, j), i > 0 || j > 0);
    }
    wgmma_commit();
    fence_regs(pa);
    fence_regs(da);
  }
  wgmma_wait<0>();
  if constexpr (!SPLIT) fence_regs(dK);
  fence_regs(dV);
  if (n == 0) {
    if constexpr (!SPLIT) zero(dK);
    zero(dV);
  }
  if constexpr (!SPLIT) store_rows<DQK, GQK>(dk_tile, sks, dK, Sk - kv0, scale);
  store_rows<DV, GV>(dv_tile, svs, dV, Sk - kv0, 1.f);
}

// st: the (batch, head, position) strides of q (and dq), k (dk), v (dv), o
// (dout), in that order.
template <int DQK, int DV, int GQK = DQK, int GV = DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* rows, int B, int H,
                   int KH, int Sq, int Sk, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using L = Smem<DQK, DV>;
  CUtensorMap tmq, tmk, tmv, tmdo;
  if (!encode_4d(&tmq, q, GQK, Sq, H, B, st[2], st[1], st[0], BM) ||
      !encode_4d(&tmdo, dout, GV, Sq, H, B, st[11], st[10], st[9], BM) ||
      !encode_4d(&tmk, k, GQK, Sk, KH, B, st[5], st[4], st[3], BM) ||
      !encode_4d(&tmv, v, GV, Sk, KH, B, st[8], st[7], st[6], BM))
    return cudaErrorInvalidValue;
  constexpr int smem = (int)L::BYTES;
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<DQK, DV, GQK, GV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dkdv_kernel<DQK, DV, GQK, GV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attributes_set = true;
  }
  const float scale_log2 = scale * LOG2E;
  const int n_qt = (Sq + BM - 1) / BM, n_kt = (Sk + BM - 1) / BM;
  bwd_dq_kernel<DQK, DV, GQK, GV><<<dim3(n_qt, H, B), 128, smem, stream>>>(
      tmq, tmk, tmv, tmdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows,
      static_cast<bf16*>(dq), H, H / KH, Sq, Sk, st[0], st[1], st[2], st[9], st[10], st[11], scale,
      scale_log2, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<DQK, DV, GQK, GV><<<dim3(n_kt, KH, B), L::THREADS, smem, stream>>>(
      tmq, tmk, tmv, tmdo, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), KH, H / KH, Sq,
      Sk, st[3], st[4], st[5], st[6], st[7], st[8], scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// Strides (batch, head, position; the head stride walks the flattened (K, G)
// axes of q and o, the K axis of k and v): q and dq share (sqb, sqh, sqs), k
// and dk (skb, skh, sks), v and dv (svb, svh, svs), o and dout (sob, soh,
// sos).  (hd, hd_v) is (32, 32), (64, 64), (128, 128) or (192, 128).  lse is fp32
// (B, H, Sq), contiguous; rows is the scratch described above.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dout, void* dq, void* dk, void* dv, float* rows, int B, int H, int KH, int Sq,
    int Sk, int hd, int hd_v, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh, long long svs, long long sob,
    long long soh, long long sos, float scale, int causal, void* stream) {
  const bool widths = (hd == 32 && hd_v == 32) || (hd == 64 && hd_v == 64) ||
                      (hd == 128 && hd_v == 128) || (hd == 192 && hd_v == 128);
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 || !widths)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos};
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[10] = {q, k, v, o, dout, dq, dk, dv, lse, rows};
  for (int i = 0; i < 10; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t bound = use_device_of(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 32)  // the (64, 64) tiles over 32 columns (see the note above)
    err = launch<64, 64, 32, 32>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk, st,
                                 scale, causal, s);
  else if (hd == 64)
    err = launch<64, 64>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk, st, scale,
                         causal, s);
  else if (hd == 128)
    err = launch<128, 128>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk, st, scale,
                           causal, s);
  else
    err = launch<192, 128>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk, st, scale,
                           causal, s);
  return static_cast<int>(err);
}
