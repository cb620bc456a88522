// Device helpers shared by the WKV-6 forward (csrc/wkv6.cu) and backward
// (csrc/wkv6_bwd.cu): the chunk geometry, 16-byte async copies, programmatic
// dependent launch, TF32 splits and the m16n8k8 TF32 product, tile loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 64;                // chunk length
constexpr int L = 16;                // sub-block: the rows of one m16n8k8
constexpr int NSB = Q / L;           // sub-blocks a chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// Programmatic dependent launch: a grid launched with the stream
// serialization attribute may start once every block of the grid before
// it has triggered; it must wait before it reads what that grid writes.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b, m16n8k8, TF32 operands, fp32 accumulators.  Fragments (g = lane / 4,
// q = lane % 4): a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]; b = B[q][g],
// B[q+4][g]; c = C[g][2q], C[g][2q+1], C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of steps [t0, t0 + Q) of a (B, T, H, N) tensor's (b, h)
// rows into dst[Q][STRIDE]; steps at or past T read as zeros.
template <int N, int NTH, int STRIDE, typename Tp>
__device__ __forceinline__ void load_rows(Tp (*dst)[STRIDE], const Tp* src, int64_t row0,
                                          int H, int t0, int T, int tid) {
  constexpr int PER = 16 / sizeof(Tp);
  constexpr int PIECES = N / PER;
  for (int p = tid; p < Q * PIECES; p += NTH) {
    const int tt = p / PIECES, e = (p % PIECES) * PER;
    const bool ok = t0 + tt < T;
    cp_async16(&dst[tt][e], src + (ok ? (row0 + (int64_t)(t0 + tt) * H) * N + e : 0), ok);
  }
}

// Thread (c, seg) of a chunk pass: channel c, sub-block seg.  Reads its 16
// steps of logw (rows seg * L .. seg * L + L - 1 of lw, column c) into
// registers as the local inclusive cumulative sums lpl (from the
// sub-block's start), and leaves the sub-block's total in part[seg][c].
template <int STRIDE, int PS>
__device__ __forceinline__ void local_cumsum(const float (*lw)[STRIDE], float (*part)[PS],
                                             int c, int seg, float lpl[L]) {
  float run = 0.f;
#pragma unroll
  for (int m = 0; m < L; ++m) {
    run += lw[seg * L + m][c];
    lpl[m] = run;
  }
  part[seg][c] = run;
}

// n consecutive bf16 aligned to 2n bytes (n = 2, 4, 8, 16), as floats
template <int n>
__device__ __forceinline__ void load_bf(const bf16* p, float* out) {
  if constexpr (n == 2) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __low2float(x), out[1] = __high2float(x);
  } else if constexpr (n == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int m = 0; m < 4; ++m) out[m] = bf(e[m]);
  } else {
#pragma unroll
    for (int h = 0; h < n / 8; ++h) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + 8 * h);
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int m = 0; m < 8; ++m) out[8 * h + m] = bf(e[m]);
    }
  }
}

// n consecutive floats aligned to 4n bytes (n = 2, 4, 8)
template <int n>
__device__ __forceinline__ void load_f(const float* p, float* out) {
  if constexpr (n == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int h = 0; h < n / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(p + 4 * h);
      out[4 * h] = x.x, out[4 * h + 1] = x.y, out[4 * h + 2] = x.z, out[4 * h + 3] = x.w;
    }
  }
}

}  // namespace
