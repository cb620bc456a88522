// FlashAttention-2 forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py:flash_attention_kernel
// (body _fa_kernel).  It computes what that kernel computes — online-softmax
// attention with fp32 statistics and accumulator, GQA (q head h reads kv head
// h / (H/KH); KV is never repeated), causal masking with top-left alignment,
// kv tiles above the diagonal skipped, ragged Sq / Sk masked in-kernel, and
// hd_v allowed to differ from hd — but not its block structure:
//
// * one CUDA block per (b, h, 64-row q tile); a loop over 64-row kv tiles inside
//   the block replaces the TPU's sequential 4th grid axis and its VMEM scratch
//   (running max / denominator / accumulator live in registers here);
// * four warps, 16 q rows each; both products (Q·Kᵀ and P·V) run on the tensor
//   cores through mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  The score
//   accumulators are re-packed in registers as the A operand of P·V (the
//   FlashAttention-2 register trick), so P never touches shared memory;
// * tiles are 64 x (hd padded to 64/128/256) bf16 in shared memory — 16 KB per
//   64x128 tile, 52 KB for Q, K and V at hd = 128 — against the 1.5 MB of VMEM
//   the TPU's 128x128 tiles need.
//
// Bound on this card at the serving path's shape: memory.  At (1, 16, 512, 128)
// bf16, q + k + v + o = 4 * 16 * 512 * 128 * 2 B = 8.4 MB, about 2.5 us at
// 3.35 TB/s, against about 1.1 us of causal tensor work at 989 TFLOP/s.  This
// simple design reads each q tile once and each kv tile once per q tile
// (L2-resident at this size), with 16-byte vector loads into padded
// (bank-conflict-free) shared memory; it does not yet overlap the loads with
// the math (no cp.async / TMA pipeline, no wgmma) — that is later work.
//
// Deterministic: no atomics, and every sum is taken in a fixed order.
//
// C interface (loaded with ctypes): repro_flash_attention_fwd_bf16 returns the
// cudaError_t of the launch (0 on success).  Strides are in elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // q rows per block: 4 warps x 16 rows
constexpr int BK = 64;   // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;   // bf16 elements of row padding in shared memory

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 from shared memory -> one register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16) |
         static_cast<uint32_t>(__bfloat16_as_ushort(lo));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a ROWS x COLS bf16 tile from global memory (row stride `ld` elements)
// into shared memory (row stride `lds`), 16 bytes at a time, zero-filling rows
// >= n_rows and columns >= n_cols.  n_cols and COLS are multiples of 8.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, int lds,
                                          const __nv_bfloat16* g, long long ld,
                                          int n_rows, int n_cols) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows && col < n_cols)
      val = *reinterpret_cast<const uint4*>(g + r * ld + col);
    *reinterpret_cast<uint4*>(smem + r * lds + col) = val;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int group, int Sq, int Sk, int hd, int hd_v,
                 long long sqb, long long sqh, long long sqs,
                 long long skb, long long skh, long long sks,
                 long long svb, long long svh, long long svs,
                 long long sob, long long soh, long long sos,
                 float scale_log2, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LQ = DQK + PAD;
  constexpr int LV = DV + PAD;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LQ;
  __nv_bfloat16* Vs = Ks + BK * LQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;                   // GQA head map
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // mma group: rows g and g + 8
  const int t = lane % 4;                     // mma thread-in-group: column pair

  const __nv_bfloat16* kg = k + b * skb + kh * skh;
  const __nv_bfloat16* vg = v + b * svb + kh * svh;
  load_tile<BQ, DQK>(Qs, LQ, q + b * sqb + h * sqh + q0 * sqs, sqs, Sq - q0, hd);

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain) of rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominators

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) {  // skip kv tiles entirely above the diagonal (top-left aligned)
    const int q_last = min(q0 + BQ, Sq) - 1;
    n_kv = min(n_kv, q_last / BK + 1);
  }
  const int row0 = q0 + warp * 16 + g;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K / V tile
    load_tile<BK, DQK>(Ks, LQ, kg + k0 * sks, sks, Sk - k0, hd);
    load_tile<BK, DV>(Vs, LV, vg + k0 * svs, svs, Sk - k0, hd_v);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows x 64 kv columns (8 n-tiles of 8).
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * LQ + kk * 16 + t * 2;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LQ), ld32(qa + 8),
                             ld32(qa + 8 * LQ + 8)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * LQ + kk * 16 + t * 2;
        mma_16816(s[nt], a, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale into the log2 domain, mask padding and the causal upper triangle.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * scale_log2;
        if (col >= Sk || (causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // Online softmax: the four lanes of a row group share each row.
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      base[i] = (m_new == -INFINITY) ? 0.f : m_new;  // fully masked so far
      const float corr = exp2f(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - base[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V: the score accumulators of n-tiles 2j, 2j+1 are exactly the
    // A fragment of k-step j.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                             pack_f32(s[2 * j][2], s[2 * j][3]),
                             pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        const __nv_bfloat16* vb = Vs + (j * 16 + t * 2) * LV + nt * 8 + g;
        mma_16816(acc[nt], a, pack_bf16(vb[0], vb[LV]),
                  pack_bf16(vb[8 * LV], vb[9 * LV]));
      }
    }
  }

  // Finalize: full row denominators, divide, write rows < Sq, columns < hd_v.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-20f);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * sob + h * soh + row * sos;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int col = nt * 8 + t * 2;
      if (col < hd_v)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_f32(acc[nt][2 * i] / denom, acc[nt][2 * i + 1] / denom);
    }
  }
}

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int group, int Sq, int Sk, int hd, int hd_v,
                   const long long* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(BQ * (DQK + PAD) + BK * (DQK + PAD) + BK * (DV + PAD));
  auto kern = flash_fwd_kernel<DQK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), group, Sq,
      Sk, hd, hd_v, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale_log2, causal);
  return cudaGetLastError();
}

template <int DQK>
cudaError_t dispatch_dv(int dv, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int group, int Sq, int Sk, int hd, int hd_v,
                        const long long* st, float scale_log2, int causal,
                        cudaStream_t stream) {
  switch (dv) {
    case 64:
      return launch<DQK, 64>(q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
    case 128:
      return launch<DQK, 128>(q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
    default:
      return launch<DQK, 256>(q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
  }
}

int bucket(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

}  // namespace

extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int Sq,
    int Sk, int hd, int hd_v, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sob, long long soh, long long sos, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 || hd < 8 ||
      hd > 256 || hd % 8 != 0 || hd_v < 8 || hd_v > 256 || hd_v % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos};
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int group = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bucket(hd)) {
    case 64:
      err = dispatch_dv<64>(bucket(hd_v), q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
    case 128:
      err = dispatch_dv<128>(bucket(hd_v), q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
    default:
      err = dispatch_dv<256>(bucket(hd_v), q, k, v, o, B, H, group, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
  }
  return static_cast<int>(err);
}
