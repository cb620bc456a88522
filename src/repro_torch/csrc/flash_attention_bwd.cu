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
// dK, dV (B, T, K, hd), hd 64 or 128.
//
// Deterministic, because crash-recovered training must retrace a clean run
// bit for bit: no atomics, every sum in a fixed order, three launches:
//
// (a) delta: one warp a row, a fixed shuffle tree;
// (b) dK / dV: one block per (b, kv head, 64-row kv tile); it walks the kv
//     head's G q heads and, for each, the q rows from the causal diagonal on
//     in 32-row steps, recomputing Pᵀ and dPᵀ, so the GQA sum stays in its
//     registers;
// (c) dQ: one block per (b, q head, 64-row q tile); it walks the kv tiles up
//     to the diagonal, recomputing P and dP.
//
// What bounds it on this card: at the training shape (8, 16, 512, 128)
// causal, q, k, v, o, dO in and dQ, dK, dV out are 134 MB (0.040 ms at
// 3.35 TB/s), the five products 21.5 GFLOP (0.022 ms at 989 TFLOP/s): bytes.
// This first version is simple and right, not fast: mma.sync m16n8k16
// (bf16 in, fp32 accumulate) from ldmatrix fragments, tiles staged through
// padded shared memory with plain 16-byte loads and a __syncthreads, and two
// products (S, dP) computed twice, once in (b) and once in (c).  A TMA ring
// and wgmma, as the forward has, are later work.
//
// Four warps a block, each owning 16 rows of the block's tile; P and dS go
// from the accumulators straight into the A fragments of the next product
// (bf16, as the forward's P), so they never touch shared memory.  Rows past
// S or T are zero-filled on load and masked out of P, and every element of
// dQ, dK and dV is written (a kv tile with no q row below its diagonal
// writes zeros).
//
// C interface (loaded with ctypes): repro_flash_attention_bwd_bf16 returns a
// cudaError_t (0 on success); strides in elements, multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BT = 64;   // rows of a block's own tile: 4 warps x 16
constexpr int BQS = 32;  // q rows a step of the dK / dV walk

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses in a shared tile of row stride LD (elements), for lane l:
//  A (16 x 16 at row r0, col c0), rows of the tile = the product's rows;
//  B "rows" (the tile's rows are the product's n, its columns k): n-tiles
//    n0 and n0 + 8 at k0, fragments {r0, r1} and {r2, r3};
//  B "cols" (the tile's rows are the product's k, its columns n; .trans):
//    n-tiles n0 and n0 + 8 at k0, the same register pairs.
template <int LD>
__device__ __forceinline__ uint32_t frag_a(const __nv_bfloat16* s, int r0, int c0, int l) {
  return smem_addr(s + (r0 + (l & 15)) * LD + c0 + (l >> 4) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t frag_b_rows(const __nv_bfloat16* s, int n0, int k0, int l) {
  return smem_addr(s + (n0 + (l & 7) + (l >> 4) * 8) * LD + k0 + ((l >> 3) & 1) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t frag_b_cols(const __nv_bfloat16* s, int k0, int n0, int l) {
  return smem_addr(s + (k0 + (l & 15)) * LD + n0 + (l >> 4) * 8);
}

// `rows` rows of HD bf16 from g (row stride `rs`, elements) into a shared tile
// of row stride HD + 8 (the padding keeps ldmatrix free of bank conflicts);
// rows from `valid` on are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long rs,
                                          int rows, int valid) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, k = c % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(g + r * rs + k * 8);
    *reinterpret_cast<uint4*>(s + r * (HD + 8) + k * 8) = v;
  }
}

// C (16 x N) = A_tile rows [r0, r0 + 16) (16 x HD) times B_tileᵀ (B's rows are
// the N columns): both operands from shared tiles with d contiguous.
template <int HD, int N>
__device__ __forceinline__ void gemm_abt(float (&c)[N / 8][4], const __nv_bfloat16* a, int r0,
                                         const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, frag_a<LD>(a, r0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, frag_b_rows<LD>(b, np * 16, kk * 16, lane));
      mma(c[2 * np], fa, fb[0], fb[1]);
      mma(c[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x HD) += P (16 x K, accumulators packed to bf16 A fragments) times
// the shared tile b (K rows x HD, d contiguous).
template <int HD, int K>
__device__ __forceinline__ void gemm_pb(float (&acc)[HD / 8][4], const uint32_t (&p)[K / 16][4],
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int j = 0; j < K / 16; ++j) {
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t fb[4];
      ldsm_x4_t(fb, frag_b_cols<LD>(b, j * 16, np * 16, lane));
      mma(acc[2 * np], p[j], fb[0], fb[1]);
      mma(acc[2 * np + 1], p[j], fb[2], fb[3]);
    }
  }
}

// Accumulators of n-tiles 2j, 2j + 1 are exactly the A fragment of k-step j.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack_f32(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_f32(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_f32(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_f32(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// Rows [r0, r0 + 16) of a warp's accumulator (16 x HD) times `scale`, to bf16,
// rows below `limit` only.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g, long long rs, const float (&acc)[HD / 8][4],
                                           int r0, int limit, float scale, int lane) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gr + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(g + row * rs + nt * 8 + 2 * t) =
          pack_f32(acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

// (a) delta[b, h, s] = Σ_d dO·o, one warp a row.
template <int HD>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ delta, int H, int Sq, long long sqb, long long sqh,
                 long long sqs, long long rows) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const long long b = row / ((long long)Sq * H);
  const long long off = b * sqb + h * sqh + s * sqs;
  float acc = 0.f;
#pragma unroll
  for (int d = lane * 2; d < HD; d += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
    acc += x.x * y.x + x.y * y.y;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// (b) dK, dV of one 64-row kv tile of one kv head.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int G, int Sq,
                int Sk, long long sqb, long long sqh, long long sqs, long long skb,
                long long skh, long long sks, float scale, float scale_log2, int causal) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BT * LD;
  __nv_bfloat16* Qs = Vs + BT * LD;
  __nv_bfloat16* dOs = Qs + BQS * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BQS * LD);  // log2 domain
  float* dl_s = lse_s + BQS;

  const int kv0 = blockIdx.x * BT;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;

  const long long kvoff = b * skb + kh * skh;
  load_tile<HD>(Ks, k + kvoff + kv0 * sks, sks, BT, min(BT, Sk - kv0));
  load_tile<HD>(Vs, v + kvoff + kv0 * sks, sks, BT, min(BT, Sk - kv0));

  float dK[HD / 8][4], dV[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[i][e] = dV[i][e] = 0.f;

  // top-left causal: q row i sees kv rows <= i, so this tile's first q row is kv0
  const int q_first = causal ? (kv0 / BQS) * BQS : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long qoff = b * sqb + h * sqh;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* dl_h = delta + ((long long)b * H + h) * Sq;
    for (int qs = q_first; qs < Sq; qs += BQS) {
      __syncthreads();  // the last step's Q / dO are no longer read
      load_tile<HD>(Qs, q + qoff + qs * sqs, sqs, BQS, min(BQS, Sq - qs));
      load_tile<HD>(dOs, dout + qoff + qs * sqs, sqs, BQS, min(BQS, Sq - qs));
      if (threadIdx.x < BQS) {
        const bool ok = qs + (int)threadIdx.x < Sq;
        lse_s[threadIdx.x] = ok ? lse_h[qs + threadIdx.x] * LOG2E : 0.f;
        dl_s[threadIdx.x] = ok ? dl_h[qs + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // Pᵀ (16 kv x 32 q) from Sᵀ = K_w Qᵀ; element [nt][e] is kv row
      // kv0 + 16 warp + gr + 8 (e / 2), q column qs + 8 nt + 2 t + e % 2.
      float p[BQS / 8][4];
      gemm_abt<HD, BQS>(p, Ks, warp * 16, Qs, lane);
#pragma unroll
      for (int nt = 0; nt < BQS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + 2 * t + (e & 1);
          const int qrow = qs + qc;
          const int kvrow = kv0 + warp * 16 + gr + 8 * (e >> 1);
          const bool ok = qrow < Sq && kvrow < Sk && (!causal || qrow >= kvrow);
          p[nt][e] = ok ? exp2f(p[nt][e] * scale_log2 - lse_s[qc]) : 0.f;
        }
      uint32_t pa[BQS / 16][4];
      pack_a<BQS>(pa, p);
      gemm_pb<HD, BQS>(dV, pa, dOs, lane);  // dV += Pᵀ dO

      // dPᵀ = V_w dOᵀ, then dSᵀ = Pᵀ ∘ (dPᵀ - delta)
      float ds[BQS / 8][4];
      gemm_abt<HD, BQS>(ds, Vs, warp * 16, dOs, lane);
#pragma unroll
      for (int nt = 0; nt < BQS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (ds[nt][e] - dl_s[nt * 8 + 2 * t + (e & 1)]);
      pack_a<BQS>(pa, ds);
      gemm_pb<HD, BQS>(dK, pa, Qs, lane);  // dK += dSᵀ Q (scaled at the end)
    }
  }
  store_rows<HD>(dk + kvoff + kv0 * sks, sks, dK, warp * 16, Sk - kv0, scale, lane);
  store_rows<HD>(dv + kvoff + kv0 * sks, sks, dV, warp * 16, Sk - kv0, 1.f, lane);
}

// (c) dQ of one 64-row q tile of one q head.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int G, int Sq, int Sk, long long sqb,
              long long sqh, long long sqs, long long skb, long long skh, long long sks,
              float scale, float scale_log2, int causal) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BT * LD;
  __nv_bfloat16* Ks = dOs + BT * LD;
  __nv_bfloat16* Vs = Ks + BT * LD;

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int kh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, t = lane & 3;

  const long long qoff = b * sqb + h * sqh;
  const long long kvoff = b * skb + kh * skh;
  load_tile<HD>(Qs, q + qoff + q0 * sqs, sqs, BT, min(BT, Sq - q0));
  load_tile<HD>(dOs, dout + qoff + q0 * sqs, sqs, BT, min(BT, Sq - q0));
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gr + 8 * r;
    const long long i = ((long long)b * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[i] * LOG2E : 0.f;
    dl[r] = row < Sq ? delta[i] : 0.f;
  }

  float dQ[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) dQ[i][0] = dQ[i][1] = dQ[i][2] = dQ[i][3] = 0.f;

  int n_kv = (Sk + BT - 1) / BT;
  if (causal) n_kv = min(n_kv, (min(q0 + BT, Sq) - 1) / BT + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // the last tile's K / V are no longer read
    load_tile<HD>(Ks, k + kvoff + k0 * sks, sks, BT, min(BT, Sk - k0));
    load_tile<HD>(Vs, v + kvoff + k0 * sks, sks, BT, min(BT, Sk - k0));
    __syncthreads();

    // P (16 q x 64 kv); element [nt][e] is q row q0 + 16 warp + gr + 8 (e / 2),
    // kv column k0 + 8 nt + 2 t + e % 2.
    float p[BT / 8][4];
    gemm_abt<HD, BT>(p, Qs, warp * 16, Ks, lane);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kvc = k0 + nt * 8 + 2 * t + (e & 1);
        const int qrow = q0 + warp * 16 + gr + 8 * (e >> 1);
        const bool ok = qrow < Sq && kvc < Sk && (!causal || kvc <= qrow);
        p[nt][e] = ok ? exp2f(p[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
      }
    // dP = dO_w Vᵀ, then dS = P ∘ (dP - delta)
    float ds[BT / 8][4];
    gemm_abt<HD, BT>(ds, dOs, warp * 16, Vs, lane);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (ds[nt][e] - dl[e >> 1]);
    uint32_t da[BT / 16][4];
    pack_a<BT>(da, ds);
    gemm_pb<HD, BT>(dQ, da, Ks, lane);  // dQ += dS K (scaled at the end)
  }
  store_rows<HD>(dq + qoff + q0 * sqs, sqs, dQ, warp * 16, Sq - q0, scale, lane);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* delta, int B, int H,
                   int KH, int Sq, int Sk, const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int LD = HD + 8;
  const float scale_log2 = scale * LOG2E;
  const long long rows = (long long)B * H * Sq;
  bwd_delta_kernel<HD><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, H, Sq, st[0], st[1],
      st[2], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_b = (2 * BT + 2 * BQS) * LD * 2 + 2 * BQS * 4;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<HD><<<dim3((Sk + BT - 1) / BT, KH, B), 128, smem_b, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      H / KH, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], scale, scale_log2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_c = 4 * BT * LD * 2;
  err = cudaFuncSetAttribute(bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<HD><<<dim3((Sq + BT - 1) / BT, H, B), 128, smem_c, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), H / KH, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq share the strides (sqb, sqh, sqs) and k, v, dk, dv the
// strides (skb, skh, sks): batch, head (the flattened (K, G) axes of q, K of
// k), position.  lse and delta are fp32 (B, H, Sq), contiguous; delta is
// scratch the caller allocates.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dout, void* dq, void* dk, void* dv, float* delta, int B, int H, int KH, int Sq,
    int Sk, int hd, long long sqb, long long sqh, long long sqs, long long skb, long long skh,
    long long sks, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[6] = {sqb, sqh, sqs, skb, skh, sks};
  for (int i = 0; i < 6; ++i)
    if (st[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[9] = {q, k, v, o, dout, dq, dk, dv, lse};
  for (int i = 0; i < 9; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return static_cast<int>(launch<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KH, Sq, Sk,
                                       st, scale, causal, s));
  return static_cast<int>(launch<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, KH, Sq, Sk,
                                      st, scale, causal, s));
}
