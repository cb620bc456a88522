// Mamba (S6) selective scan for Hopper (sm_90a): fp32 in, fp32 out.
//
// Replaces the TPU kernel repro/kernels/mamba/kernel.py:selective_scan_kernel
// (body _scan_kernel).  It computes what that kernel computes — per batch
// row b and channel i, with state h[i] in R^N:
//
//     h_t[i][n] = dA_t[i][n] * h_{t-1}[i][n] + dBu_t[i][n]
//     y_t[i]    = sum_n h_t[i][n] * C_t[n]
//
// for dA, dBu (B, S, I, N), C (B, S, N), h0 (B, I, N) -> y (B, S, I) and the
// final h (B, I, N).  The Pallas kernel keeps h in VMEM across a sequential
// grid axis over time and stages dA / dBu in blocks of up to 4 MB (2 x 64
// steps x 128 channels x 64 states, fp32): far beyond a Hopper block's
// 227 KB of shared memory, and a Hopper grid has no sequential axis.  So
// here:
//
// * one block owns one batch row b and CH consecutive channels; the loop
//   over t runs inside the block, and h stays in registers all along;
// * a channel's N states are split over L = N / NV lanes (NV = 4 when N is
//   a multiple of 4, else 1), so a thread holds NV states and loads one
//   16-byte float4 of dA and of dBu a step (N = 16: 4 lanes a channel, 32
//   channels in a block of 128 threads).  Consecutive threads hold
//   consecutive (channel, state) pairs, so a block's share of one step is
//   one contiguous, coalesced run of CH * N floats;
// * the time steps stream through shared memory TC = 8 at a time, in a
//   double buffer filled by cp.async: while a chunk is computed the next
//   one is in flight (32 KB a block at N = 16, 3 blocks an SM).  Each
//   thread copies and later reads only its own pieces of dA and dBu, so
//   those need no barrier; C_t, shared by every channel of the row, is
//   staged once a chunk for the whole block;
// * the step loop holds no shuffle and no global store: each thread leaves
//   its partial sum of y_t (its NV states) in shared memory, and one pass
//   a chunk adds the L parts of each channel in a fixed order and writes a
//   coalesced row of y per step.  Steps past S and channels past I are
//   neither copied nor stored.
//
// Bound on this card: bytes.  At the jamba-1.5-large prefill chunk (1, 256,
// 16384, 16) dA and dBu are 536,870,912 bytes, y 16,777,216 and h in and
// out 2,097,152: 0.166 ms at 3.35 TB/s, where the 4 fp32 operations per
// (t, i, n) take 0.004 ms at 67 TFLOP/s.  A decode step (4, 1, 16384, 16)
// moves about 17.0 MB (dA, dBu, h in and out): 0.0051 ms.  Fusing the
// computation of dA and dBu into the kernel would keep them out of device
// memory altogether; this kernel keeps the TPU kernel's interface.
//
// Deterministic, and a (b, i) row's bits do not depend on B, on I or on the
// other rows: no atomics and no split over t; every sum runs in a fixed
// order.  Crash-resume bit-identity rests on that.
//
// h may alias h0 (the serving cache's ssm leaf is updated in place): each
// thread reads its own states of h0 before it writes the same states of h,
// and no other thread touches them.
//
// C interface (loaded with ctypes): repro_selective_scan_fwd returns the
// cudaError_t of the launch (0 on success).  All arrays are contiguous fp32
// and 16-byte aligned; 1 <= N <= 64, 1 <= B <= 65535, S, I >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 8;            // time steps staged per chunk
constexpr int NTHREADS = 128;    // threads a block (at most)
constexpr int MAX_N = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Async copy of NV floats global -> shared (16 bytes, or 4 bytes for NV = 1).
template <int NV>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (NV == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
                 "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// The block's geometry, the same on host and device.
struct Geom {
  int N, L, CH, nt;   // states, lanes a channel, channels a block, threads
  int slab;           // floats of dA (or dBu) a step for the block
  int NP;             // N rounded up to 4 (C rows, 16-byte aligned)
  int ys;             // row stride of the partial sums (bank spread)
  int tcap, nbuf;     // steps a buffer, buffers
  __host__ __device__ Geom(int N_, int S, int NV) {
    N = N_;
    L = N / NV;
    CH = NTHREADS / L;
    nt = CH * L;
    slab = nt * NV;
    NP = (N + 3) & ~3;
    // part q of channel c sits at q * ys + c: with ys = CH + 32 / L the L
    // parts of the 32 / L channels of a warp fall on distinct banks
    ys = CH + ((32 % L == 0) ? 32 / L : 1);
    tcap = S < TC ? S : TC;
    nbuf = S > TC ? 2 : 1;
  }
  __host__ __device__ int ring() const { return nbuf * tcap * slab; }
  __host__ __device__ int floats() const {
    return 2 * ring() + nbuf * tcap * NP + tcap * L * ys;
  }
};

// Start the copies of steps [t0, t0 + steps) into buffer `buf`.
template <int NV>
__device__ __forceinline__ void load_chunk(const Geom& g, float* ra, float* rb, float* cs,
                                            int buf, const float* dA, const float* dBu,
                                            const float* C, int64_t IN, int64_t own,
                                            bool live, int t0, int steps, int tid) {
  if (live) {
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (tt < steps) {
        const int64_t off = (int64_t)(t0 + tt) * IN + own;
        const int dst = (buf * g.tcap + tt) * g.slab + tid * NV;
        cp_async<NV>(ra + dst, dA + off);
        cp_async<NV>(rb + dst, dBu + off);
      }
    }
  }
  const int pieces = g.N / NV;
  for (int p = tid; p < steps * pieces; p += g.nt) {
    const int tt = p / pieces, e = (p % pieces) * NV;
    cp_async<NV>(cs + (buf * g.tcap + tt) * g.NP + e, C + (int64_t)(t0 + tt) * g.N + e);
  }
  cp_async_commit();
}

template <int NV>
__global__ void __launch_bounds__(NTHREADS)
selective_scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBu,
                      const float* __restrict__ C, const float* h0, float* __restrict__ y,
                      float* h, int S, int I, int N) {
  extern __shared__ __align__(16) float smem[];
  const Geom g(N, S, NV);
  float* ra = smem;                       // dA   [nbuf][tcap][slab]
  float* rb = ra + g.ring();              // dBu  [nbuf][tcap][slab]
  float* cs = rb + g.ring();              // C    [nbuf][tcap][NP]
  float* yp = cs + g.nbuf * g.tcap * g.NP;  // partial y [tcap][L][ys]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * g.CH;
  const int c = tid / g.L;                // channel i0 + c
  const int q = tid % g.L;                // states q*NV .. q*NV + NV - 1
  const int nch = min(g.CH, I - i0);      // channels of this block that exist
  const bool live = c < nch;
  const int64_t IN = (int64_t)I * N;
  const int64_t own = (int64_t)i0 * N + (int64_t)tid * NV;   // (i0 + c) * N + q * NV
  const float* dA_b = dA + (int64_t)b * S * IN;
  const float* dBu_b = dBu + (int64_t)b * S * IN;
  const float* C_b = C + (int64_t)b * S * N;
  float* y_b = y + (int64_t)b * S * I;

  const int nchunks = (S + TC - 1) / TC;
  load_chunk<NV>(g, ra, rb, cs, 0, dA_b, dBu_b, C_b, IN, own, live, 0, min(TC, S), tid);

  float hv[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) hv[e] = live ? h0[(int64_t)b * IN + own + e] : 0.f;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * TC;
    const int steps = min(TC, S - t0);
    if (ch + 1 < nchunks) {
      load_chunk<NV>(g, ra, rb, cs, buf ^ 1, dA_b, dBu_b, C_b, IN, own, live, t0 + TC,
                     min(TC, S - t0 - TC), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk ch landed; every thread is done with ch - 1

    // -- the recurrence over this chunk's steps: h in registers, partial
    //    sums of y to shared memory
    const float* a_s = ra + buf * g.tcap * g.slab + tid * NV;
    const float* b_s = rb + buf * g.tcap * g.slab + tid * NV;
    const float* c_s = cs + buf * g.tcap * g.NP + q * NV;
    float* y_s = yp + q * g.ys + c;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (tt < steps) {
        float av[NV], bv[NV], cv[NV];
        if constexpr (NV == 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(a_s + tt * g.slab);
          const float4 b4 = *reinterpret_cast<const float4*>(b_s + tt * g.slab);
          const float4 c4 = *reinterpret_cast<const float4*>(c_s + tt * g.NP);
          av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
          bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
          cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
        } else {
          av[0] = a_s[tt * g.slab];
          bv[0] = b_s[tt * g.slab];
          cv[0] = c_s[tt * g.NP];
        }
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          hv[e] = fmaf(av[e], hv[e], bv[e]);
          part = fmaf(hv[e], cv[e], part);
        }
        y_s[tt * g.L * g.ys] = part;
      }
    }
    __syncthreads();

    // -- y = the sum of each channel's L parts, in lane order; one
    //    coalesced row of the block's channels per step
    for (int p = tid; p < steps * nch; p += g.nt) {
      const int tt = p / nch, cc = p % nch;
      const float* parts = yp + tt * g.L * g.ys + cc;
      float s = parts[0];
      for (int l = 1; l < g.L; ++l) s += parts[l * g.ys];
      y_b[(int64_t)(t0 + tt) * I + i0 + cc] = s;
    }
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < NV; ++e) h[(int64_t)b * IN + own + e] = hv[e];
  }
}

template <int NV>
cudaError_t launch(const float* dA, const float* dBu, const float* C, const float* h0,
                   float* y, float* h, int B, int S, int I, int N, cudaStream_t stream) {
  const Geom g(N, S, NV);
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.floats());
  static size_t granted = 48 * 1024;      // the default dynamic limit
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  const dim3 grid((I + g.CH - 1) / g.CH, B);
  selective_scan_kernel<NV><<<grid, g.nt, bytes, stream>>>(dA, dBu, C, h0, y, h, S, I, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_selective_scan_fwd(const void* dA, const void* dBu, const void* C,
                                        const void* h0, void* y, void* h, int B, int S,
                                        int I, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || I < 1 || N < 1 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dA);
  const float* bu = static_cast<const float*>(dBu);
  const float* c = static_cast<const float*>(C);
  const float* h_in = static_cast<const float*>(h0);
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h);
  if (N % 4 == 0) return static_cast<int>(launch<4>(a, bu, c, h_in, yo, ho, B, S, I, N, st));
  return static_cast<int>(launch<1>(a, bu, c, h_in, yo, ho, B, S, I, N, st));
}
