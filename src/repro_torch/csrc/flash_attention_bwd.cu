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
// a kv head), on the model's layout: q, o, dO, dQ (B, S, K, G, hd), k, v,
// dK, dV (B, T, K, hd), hd 64 or 128.  Every element of dQ, dK and dV is
// written: a kv tile with no q row below its diagonal writes zeros.
//
// What bounds it on this card: at the training shape (8, 16, 512, 128)
// causal, q, k, v, o, dO in and dQ, dK, dV out are 134 MB (0.040 ms at
// 3.35 TB/s); the five products are 21.5 GFLOP (0.022 ms at 989 TFLOP/s),
// and 30 GFLOP with S and dP computed a second time in the dQ pass: bytes.
//
// What held the first design (mma.sync) back: 0.53451 ms at that shape on an
// H100 80GB HBM3 at a 700 W power limit (chip_smoke.py), 13.3x its bound and
// 1.61x the deterministic SDPA backward.  Every product ran on mma.sync from
// ldmatrix fragments, a fraction of the tensor cores' rate; every tile went
// global -> registers -> padded shared memory behind a __syncthreads, so no
// load overlapped the math, and the dK / dV walk did so twice for each
// 32-row q step; four warps a block with 128 fp32 accumulators a thread
// left nothing to hide the latency behind; and delta was a third launch
// that read o and dO once more.
//
// This design (timed by chip_smoke.py phase 3 and kernels/attention/probe.py
// --bwd; PERF.md has the numbers):
//
// * every product on wgmma (bf16 in, fp32 accumulate), one warpgroup a
//   block, 64-row tiles on both sides, with the helpers of the forward
//   (hopper.cuh).  Operands needed transposed are read MN-major through the
//   descriptor's transpose bit from the tile TMA wrote: the same shared Q
//   tile is the K-major B of Sᵀ = K Qᵀ and the MN-major B of dK += dSᵀ Q.
//   P and dS go from the accumulators, re-packed to bf16, straight into
//   wgmma's register A operand and never touch shared memory.  The first
//   product of each accumulation ignores it (scale-d 0), so no ordinary
//   instruction writes a register an asynchronous product owns;
// * two launches, no atomics, every sum in a fixed order (deterministic: a
//   crash-recovered training run retraces a clean one bit for bit):
//   (1) dQ, one block per (b, q head, q tile): it computes delta for its 64
//       rows from o and dO while its tiles are in flight, hands delta and
//       lse·log2 e to pass 2 in a scratch row of 128 floats, then walks the
//       kv tiles up to the diagonal, recomputing S and dP;
//   (2) dK / dV in the Sᵀ form, one block per (b, kv head, kv tile): it
//       walks the kv head's G q heads and, for each, the q tiles from the
//       diagonal on; Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, then dV += Pᵀ dO and
//       dK += dSᵀ Q, so the GQA sum stays in its registers;
// * K and V (pass 2) or Q and dO (pass 1) of the block's own tile by TMA
//   once; the streamed tiles (Q, dO with their lse and delta rows in pass
//   2, K, V in pass 1) through a 2-stage mbarrier ring, by 4-D tensor maps
//   over (d, position, head, batch) that zero-fill past S and T.  A step's
//   first products start as soon as its tile has landed, behind the
//   last step's still-running products; the slot they free is refilled by
//   one thread once S has come back, so the next tile loads during the
//   rest of the step;
// * about 100 KB of shared memory and at most 255 registers a thread, so
//   two blocks share an SM and each hides the other's waits (a third ring
//   stage leaves room for one block an SM, and was 1.22x slower);
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
// STAGES rows of lse·log2 e and delta (pass 2 only), then the barriers.  Every
// tile is in wgmma's 128-byte swizzle as TMA writes it: 64-column blocks of
// 64 rows x 128 bytes.
template <int HD>
struct Smem {
  static constexpr int TILE = BM * HD * 2;
  static constexpr int OWN = 2 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ROWS = 2 * BM * 4;  // a q tile's lse·log2 e, then its delta
  static constexpr int BARS = OWN + STAGES * STAGE + STAGES * ROWS;
  static constexpr size_t BYTES = 1024 + (size_t)BARS + 8 * (1 + STAGES);
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

// A warpgroup's accumulator (64 x HD: this thread's rows 16 warp + gr and
// + 8, columns 8 nt + 2 t and + 1) times `scale`, to bf16, rows below
// `limit` only.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* g, long long rs, const float (&acc)[HD / 8][4],
                                           int limit, float scale) {
  const int warp = threadIdx.x / 32, gr = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gr + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
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
// delta for pass 2.
template <int HD>
__global__ void __launch_bounds__(128, 2)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ rows, bf16* __restrict__ dq,
              int H, int G, int Sq, int Sk, long long sqb, long long sqh, long long sqs,
              float scale, float scale_log2, int causal) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t Qs = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t dOs = Qs + L::TILE;
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
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(st + c * BM * 128, &tmk, full(i % STAGES), c * 64, i * BM, kh, b);
      tma_load_4d(st + L::TILE + c * BM * 128, &tmv, full(i % STAGES), c * 64, i * BM, kh, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(own_bar + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(own_bar, L::OWN);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(Qs + c * BM * 128, &tmq, own_bar, c * 64, q0, h, b);
      tma_load_4d(dOs + c * BM * 128, &tmdo, own_bar, c * 64, q0, h, b);
    }
    for (int i = 0; i < STAGES - 1 && i < n_kv; ++i) load_kv(i);
  }

  // While the tiles fly: delta = rowsum(dO ∘ o) of this thread's rows 16 warp
  // + gr and + 8, the four lanes of a row each summing a quarter of d in
  // order, then a fixed butterfly; and lse in the log2 domain.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    float acc = 0.f;
    if (row < Sq) {
      const long long off = b * sqb + h * sqh + row * sqs + t * (HD / 4);
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
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

  float dQ[HD / 8][4];
  const int row0 = q0 + warp * 16 + gr;
  for (int i = 0; i < n_kv; ++i) {
    const int k0 = i * BM;
    const uint32_t Ks = ring + (i % STAGES) * L::STAGE, Vs = Ks + L::TILE;
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);

    // S = Q Kᵀ and dP = dO Vᵀ (64 q x 64 kv), behind the last tile's dQ product.
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<64>(s, kmajor(Qs, kk), kmajor(Ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<64>(dp, kmajor(dOs, kk), kmajor(Vs, kk), kk > 0);
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
    for (int j = 0; j < 4; ++j) wgmma_rs<HD>(dQ, da[j], mnmajor(Ks, j), i > 0 || j > 0);
    wgmma_commit();
    fence_regs(da);
  }
  wgmma_wait<0>();
  fence_regs(dQ);
  store_rows<HD>(dq + b * sqb + h * sqh + q0 * sqs, sqs, dQ, Sq - q0, scale);
}

// (2) dK, dV of one 64-row kv tile of one kv head.
template <int HD>
__global__ void __launch_bounds__(128, 2)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
                const float* __restrict__ rows, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int KH, int G, int Sq, int Sk, long long skb, long long skh, long long sks,
                float scale, float scale_log2, int causal) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t Ks = (raw + 1023u) & ~1023u;
  const uint32_t Vs = Ks + L::TILE;
  const uint32_t ring = Ks + L::OWN;
  const uint32_t row_ring = ring + STAGES * L::STAGE;
  const float* row_s = reinterpret_cast<const float*>(smem_raw + (row_ring - raw));
  const uint32_t own_bar = Ks + L::BARS;
  auto full = [&](int s) { return own_bar + 8u * (1 + s); };

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
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane / 4, t = lane % 4;

  // Step i (q head kh G + i / per_head, q tile qt0 + i % per_head) into ring
  // slot i % STAGES, by one thread: Q, dO and the tile's two rows.
  auto load_q = [&](int i) {
    const int h = kh * G + i / per_head, qt = qt0 + i % per_head;
    const int slot = i % STAGES;
    const uint32_t st = ring + slot * L::STAGE;
    mbar_expect_tx(full(slot), L::STAGE + L::ROWS);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(st + c * BM * 128, &tmq, full(slot), c * 64, qt * BM, h, b);
      tma_load_4d(st + L::TILE + c * BM * 128, &tmdo, full(slot), c * 64, qt * BM, h, b);
    }
    bulk_load(row_ring + slot * L::ROWS, rows + (((long long)b * H + h) * n_qt + qt) * (2 * BM),
              L::ROWS, full(slot));
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(own_bar + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(own_bar, L::OWN);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) {
      tma_load_4d(Ks + c * BM * 128, &tmk, own_bar, c * 64, kv0, kh, b);
      tma_load_4d(Vs + c * BM * 128, &tmv, own_bar, c * 64, kv0, kh, b);
    }
    for (int i = 0; i < STAGES - 1 && i < n; ++i) load_q(i);
  }
  mbar_wait(own_bar, 0);

  float dK[HD / 8][4], dV[HD / 8][4];
  const int kvrow0 = kv0 + warp * 16 + gr;
  for (int i = 0; i < n; ++i) {
    const int qs = (qt0 + i % per_head) * BM;
    const int slot = i % STAGES;
    const uint32_t Qs = ring + slot * L::STAGE, dOs = Qs + L::TILE;
    const float* lse2 = row_s + slot * (2 * BM);
    const float* dl = lse2 + BM;
    mbar_wait(full(slot), (i / STAGES) & 1);

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (64 kv x 64 q), behind the last step's dK / dV products.
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<64>(s, kmajor(Ks, kk), kmajor(Qs, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<64>(dp, kmajor(Vs, kk), kmajor(dOs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the last step's dK / dV products and Sᵀ are done
    fence_regs(s);
    named_sync(1, 128);  // ... in every warp: the last step's slot is free
    if (tid == 0 && i + STAGES - 1 < n) load_q(i + STAGES - 1);

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
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    // dV += Pᵀ dO and dK += dSᵀ Q, dO and Q read MN-major.
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<HD>(dV, pa[j], mnmajor(dOs, j), i > 0 || j > 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<HD>(dK, da[j], mnmajor(Qs, j), i > 0 || j > 0);
    wgmma_commit();
    fence_regs(pa);
    fence_regs(da);
  }
  wgmma_wait<0>();
  fence_regs(dK);
  fence_regs(dV);
  if (n == 0) {
    zero(dK);
    zero(dV);
  }
  const long long off = b * skb + kh * skh + kv0 * sks;
  store_rows<HD>(dk + off, sks, dK, Sk - kv0, scale);
  store_rows<HD>(dv + off, sks, dV, Sk - kv0, 1.f);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* rows, int B, int H,
                   int KH, int Sq, int Sk, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv, tmdo;
  if (!encode_4d(&tmq, q, HD, Sq, H, B, st[2], st[1], st[0], BM) ||
      !encode_4d(&tmdo, dout, HD, Sq, H, B, st[2], st[1], st[0], BM) ||
      !encode_4d(&tmk, k, HD, Sk, KH, B, st[5], st[4], st[3], BM) ||
      !encode_4d(&tmv, v, HD, Sk, KH, B, st[5], st[4], st[3], BM))
    return cudaErrorInvalidValue;
  constexpr int smem = (int)Smem<HD>::BYTES;
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attributes_set = true;
  }
  const float scale_log2 = scale * LOG2E;
  const int n_qt = (Sq + BM - 1) / BM, n_kt = (Sk + BM - 1) / BM;
  bwd_dq_kernel<HD><<<dim3(n_qt, H, B), 128, smem, stream>>>(
      tmq, tmk, tmv, tmdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows,
      static_cast<bf16*>(dq), H, H / KH, Sq, Sk, st[0], st[1], st[2], scale, scale_log2, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<HD><<<dim3(n_kt, KH, B), 128, smem, stream>>>(
      tmq, tmk, tmv, tmdo, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv), KH, H / KH, Sq,
      Sk, st[3], st[4], st[5], scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq share the strides (sqb, sqh, sqs) and k, v, dk, dv the
// strides (skb, skh, sks): batch, head (the flattened (K, G) axes of q, K of
// k), position.  lse is fp32 (B, H, Sq), contiguous; rows is the scratch
// described above.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dout, void* dq, void* dk, void* dv, float* rows, int B, int H, int KH, int Sq,
    int Sk, int hd, long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[6] = {sqb, sqh, sqs, skb, skh, sks};
  for (int i = 0; i < 6; ++i)
    if (st[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[10] = {q, k, v, o, dout, dq, dk, dv, lse, rows};
  for (int i = 0; i < 10; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t bound = use_device_of(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return static_cast<int>(launch<64>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk,
                                       st, scale, causal, s));
  return static_cast<int>(launch<128>(q, k, v, o, lse, dout, dq, dk, dv, rows, B, H, KH, Sq, Sk,
                                      st, scale, causal, s));
}
