// Grouped (per-expert) matmul for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py:grouped_matmul_kernel
// (body _gmm_kernel).  It computes what that kernel computes — for every
// expert e, out[e] = x[e] (C, D) @ w[e] (D, F), fp32 accumulation, one
// rounding to bf16 at the end — but not its block structure:
//
// * one CUDA block per (64-row C tile, 128-column F tile, expert); a loop
//   over D in 32-deep chunks inside the block replaces the TPU's sequential
//   contraction grid axis and its fp32 VMEM scratch (the accumulator lives
//   in registers here);
// * four warps in a 2 x 2 layout, each owning a 32 x 64 piece of the tile;
//   the products run on the tensor cores through mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulate).  x tiles feed the A operand through ldmatrix; w is read
//   row-major (D, F) and feeds the B operand through ldmatrix.trans, so
//   neither operand is transposed in memory;
// * a 4-stage cp.async ring keeps three D chunks of x and w in flight while
//   the fourth is multiplied (14 KB a stage, 55 KB of shared memory);
// * ragged C, D and F are zero-filled on load (cp.async with a source size
//   of 0) and masked on store, so the wrapper pads nothing — the TPU
//   reference pads C / D / F to whole blocks only because Pallas needs them.
//   D and F must be multiples of 8 (16-byte rows); the wrapper checks.
//
// Bound on this card at the MoE serving path's shapes: memory.  A decode
// launch (64, 32, 2048) @ (64, 2048, 1024) moves 281 MB, 268 MB of it the
// expert weights, about 84 us at 3.35 TB/s, against 8.7 us of tensor work at
// 989 TFLOP/s; a prefill launch (64, 80, 2048) @ (64, 2048, 1024) moves
// 300 MB (90 us) against 22 us of tensor work.  So the design streams every
// weight element from device memory exactly once per C tile (one C tile at
// decode, two at prefill, the second read of a weight tile adjacent in the
// grid so it hits L2), with 16-byte cp.async loads and loads kept in flight
// behind the math.  At decode most of the 64-row tile is padding; that costs
// tensor work, not bytes.  wgmma, TMA and an M tile sized to C are later work.
//
// Deterministic, and the same bits for a row wherever it sits: no split-K and
// no atomics; every output element is summed over D in the same order (chunk
// by chunk, 16 at a time), whatever C is, wherever the row lies in its tile
// and whatever the other rows hold.  A token's expert output is therefore
// bit-identical whichever serving slot and capacity row it lands in, which
// crash-resume bit-identity rests on.
//
// C interface (loaded with ctypes): repro_grouped_matmul_bf16 returns the
// cudaError_t of the launch (0 on success).  x (E, C, D), w (E, D, F) and
// out (E, C, F) are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // C rows per block
constexpr int BN = 128;       // F columns per block
constexpr int BK = 32;        // D depth per pipeline stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 128; // 4 warps, 2 x 2
constexpr int WM = 32;        // rows per warp
constexpr int WN = 64;        // columns per warp
constexpr int LDA = BK + 8;   // padded smem row strides (bf16 elements):
constexpr int LDB = BN + 8;   // 80 and 272 bytes, ldmatrix conflict-free
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * STAGES * (A_STAGE + B_STAGE);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the cp.async copies of D chunk `kt` into ring slot `slot`:
// x rows [m0, m0+BM) x cols [k0, k0+BK) and w rows [k0, k0+BK) x cols
// [n0, n0+BN); chunks past C, D or F are zero-filled.
__device__ __forceinline__ void load_stage(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                           const __nv_bfloat16* xe,
                                           const __nv_bfloat16* we, int C, int D,
                                           int F, int m0, int n0, int kt) {
  const int k0 = kt * BK;
  constexpr int A_CHUNKS = BM * (BK / 8);  // 256: two per thread
#pragma unroll
  for (int i = 0; i < A_CHUNKS / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / (BK / 8);
    const int col = (c % (BK / 8)) * 8;
    const bool ok = (m0 + r < C) && (k0 + col < D);
    const __nv_bfloat16* src = ok ? xe + (size_t)(m0 + r) * D + k0 + col : xe;
    cp_async16(As + r * LDA + col, src, ok ? 16 : 0);
  }
  constexpr int B_CHUNKS = BK * (BN / 8);  // 512: four per thread
#pragma unroll
  for (int i = 0; i < B_CHUNKS / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / (BN / 8);
    const int col = (c % (BN / 8)) * 8;
    const bool ok = (k0 + r < D) && (n0 + col < F);
    const __nv_bfloat16* src = ok ? we + (size_t)(k0 + r) * F + n0 + col : we;
    cp_async16(Bs + r * LDB + col, src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NTHREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  const int m0 = blockIdx.x * BM;   // C tiles vary fastest: the tiles that
  const int n0 = blockIdx.y * BN;   // share a weight tile run side by side
  const int e = blockIdx.z;
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* we = w + (size_t)e * D * F;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * WM;   // this warp's rows / columns in the tile
  const int wn = (warp % 2) * WN;

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(As + s * A_STAGE, Bs + s * B_STAGE, xe, we, C, D, F, m0, n0, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and slot (kt-1) % STAGES is free
    const int pre = kt + STAGES - 1;
    if (pre < nk)
      load_stage(As + (pre % STAGES) * A_STAGE, Bs + (pre % STAGES) * B_STAGE, xe, we, C,
                 D, F, m0, n0, pre);
    cp_async_commit();            // possibly empty: keeps the group count uniform

    const __nv_bfloat16* A = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* B = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[WM / 16][4];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)   // rows (lane % 16), k half (lane / 16)
        ldmatrix_x4(a[i], A + (wm + i * 16 + (lane % 16)) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {  // two n-tiles of 8 per ldmatrix
        uint32_t b[4];
        ldmatrix_x4_trans(b, B + (kk + (lane % 16)) * LDB + wn + j * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) {
          mma_16816(acc[i][2 * j], a[i], b[0], b[1]);
          mma_16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: one rounding to bf16, rows < C and columns < F only.
  const int g = lane / 4;
  const int t = lane % 4;
  __nv_bfloat16* oe = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + h * 8;
      if (row >= C) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + wn + j * 8 + t * 2;
        if (col < F) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)row * F + col) = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int repro_grouped_matmul_bf16(const void* x, const void* w, void* out, int E,
                                         int C, int D, int F, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 8 || F < 8 || D % 8 != 0 || F % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  gmm_bf16_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}
