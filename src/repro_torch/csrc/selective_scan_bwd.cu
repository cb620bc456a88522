// Mamba (S6) selective-scan backward for Hopper (sm_90a): fp32 in, fp32 out.
//
// Replaces no TPU kernel: the reference trains jamba by jax.grad through its
// chunk solver (repro/models/mamba.py:_chunk_scan, :94, an associative scan
// inside the checkpointed chunk body at :128-144).  This is the backward of
// csrc/selective_scan.cu's forward, launched by kernels/mamba/ops.py:
// SelectiveScan under autograd.
//
// Per batch row b and channel i, with h_t[i] in R^N the state after step t
// (h_{-1} = h0) and g_t = dL/dh_t (the final h's cotangent dh enters at
// t = S - 1):
//
//     g_t        = dy_t[i] C_t + dA_{t+1}[i] * g_{t+1}
//     d(dBu)_t   = g_t
//     d(dA)_t    = g_t * h_{t-1}
//     dC_t       = sum_i dy_t[i] h_t[i]
//     dh0        = dA_0 * g_0
//
// for dA, dBu (B, S, I, N), C (B, S, N), h0 (B, I, N), dy (B, S, I) and
// dh (B, I, N) -> d(dA), d(dBu) (B, S, I, N), dC (B, S, N), dh0 (B, I, N).
//
// Bound on this card: bytes.  At jamba-1.5-large's training chunk (8, 256,
// 16384, 16) reading dA and dBu once and writing d(dA) and d(dBu) once is
// 8.59e9 bytes (2.56 ms at 3.35 TB/s; 2.61 ms with the small tensors),
// where the ~8 fp32 operations per (t, i, n) take 0.06 ms at 67 TFLOP/s.
//
// Design (simple first).  The forward's split of the work: one block owns
// one batch row b and CH consecutive channels, a channel's N states spread
// over L = N / NV lanes (NV = 4 when N is a multiple of 4, else 1), each
// thread's states in registers, every load and store of dA, dBu, d(dA) and
// d(dBu) one coalesced 16-byte vector a thread.  The time axis is cut into
// segments of K = 8 steps:
//
// * sweep 1 (forward): h_t = dA_t h_{t-1} + dBu_t over all S steps; the
//   state before each segment but the first is parked in d(dA)'s own row of
//   that segment's first step (no scratch: the thread that parks it reads
//   it back, and only then writes that row's gradient);
// * sweep 2 (reverse, a segment at a time, last first): the segment's dA
//   and dBu are read again, h is recomputed from the parked state into
//   registers (h_{t-1} for each of its K steps), then the reverse steps
//   give g, d(dBu) and d(dA) and carry dA_t g_t to the step before;
// * dC: each thread leaves dy_t[i] h_t[i][n] for its states in shared
//   memory, and once a segment the block sums its channels in channel
//   order into a per-block part (B x blocks x S x N fp32, scratch the
//   binding allocates); a second launch sums the parts over the blocks in
//   block order.
//
// So dA and dBu are read twice (6 passes over a (B, S, I, N) tensor, plus
// an eighth of one for the parked states): about 1.6x the bound above;
// keeping a segment's inputs from the forward would take it to ~4 passes.
//
// Deterministic: no atomics, every sum in a fixed order, so two launches
// give the same bits (crash recovery is checked bit for bit).  A (b, i)
// row's d(dA), d(dBu) and dh0 do not depend on B, on I or on other rows.
//
// C interface (loaded with ctypes), returning the cudaError_t of its
// launches (0 on success): repro_selective_scan_bwd(dA, dBu, C, h0, dy, dh,
// ddA, ddBu, dC, dh0, part, B, S, I, N, stream); h0 and dh may be null
// (zeros), dh0 may be null (not computed); part holds
// repro_selective_scan_bwd_part_floats(B, S, I, N) floats.  All arrays are
// contiguous fp32, 16-byte aligned; 1 <= N <= 64, 1 <= B <= 65535, S, I >=
// 1.  repro_selective_scan_bwd_last_launch gives the threads a block, the
// steps a segment, the dynamic shared memory and the blocks of the last
// call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 8;             // steps a segment
constexpr int NTHREADS = 128;    // threads a block (at most)
constexpr int MAX_N = 64;
constexpr int DC_THREADS = 256;
int last_launch[4];

// The block's geometry, the same on host and device.
struct Geom {
  int N, L, CH, nt;   // states, lanes a channel, channels a block, threads
  int cs;             // row stride of the dC parts in shared memory
  __host__ __device__ Geom(int N_, int NV) {
    N = N_;
    L = N / NV;
    CH = NTHREADS / L;
    nt = CH * L;
    // part (tt, n) of channel c sits at (tt * N + n) * cs + c: with cs =
    // CH + 2 the 4 lanes of the 8 channels of a warp (N = 16) fall on 32
    // distinct banks
    cs = CH + 2;
  }
  __host__ __device__ int floats() const { return K * N * cs; }
};

template <int NV>
__device__ __forceinline__ void ld_nc(float (&r)[NV], const float* p) {
  if constexpr (NV == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
    r[0] = __ldg(p);
  }
}

// A load of what this kernel wrote itself (the parked state): no
// read-only path.
template <int NV>
__device__ __forceinline__ void ld(float (&r)[NV], const float* p) {
  if constexpr (NV == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else {
    r[0] = *p;
  }
}

template <int NV>
__device__ __forceinline__ void st(float* p, const float (&r)[NV]) {
  if constexpr (NV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

template <int NV>
__global__ void __launch_bounds__(NTHREADS)
selective_scan_bwd_kernel(const float* __restrict__ dA, const float* __restrict__ dBu,
                          const float* __restrict__ C, const float* __restrict__ h0,
                          const float* __restrict__ dy, const float* __restrict__ dh,
                          float* ddA, float* __restrict__ ddBu, float* __restrict__ dh0,
                          float* __restrict__ part, int S, int I, int N) {
  extern __shared__ __align__(16) float smem[];   // dC parts [K][N][cs]
  const Geom g(N, NV);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int i0 = blk * g.CH;
  const int c = tid / g.L;                // channel i0 + c
  const int q = tid % g.L;                // states q*NV .. q*NV + NV - 1
  const int nch = min(g.CH, I - i0);      // channels of this block that exist
  const bool live = c < nch;
  const int64_t IN = (int64_t)I * N;
  const int64_t own = (int64_t)i0 * N + (int64_t)tid * NV;   // (i0 + c) * N + q * NV
  const int64_t row = (int64_t)b * S * IN + own;             // (b, t = 0, i, q * NV)
  const float* dA_o = dA + row;
  const float* dBu_o = dBu + row;
  float* ddA_o = ddA + row;
  float* ddBu_o = ddBu + row;
  const float* dy_o = dy + (int64_t)b * S * I + i0 + c;
  const float* C_o = C + (int64_t)b * S * N + q * NV;
  const int64_t state = (int64_t)b * IN + own;
  const int nseg = (S + K - 1) / K;

  float h[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) h[e] = (live && h0 != nullptr) ? __ldg(h0 + state + e) : 0.f;

  // -- sweep 1: h forward, the state before each segment parked in d(dA)
  if (live) {
    for (int s = 0; s < nseg; ++s) {
      const int t0 = s * K;
      const int steps = min(K, S - t0);
      if (s > 0) st<NV>(ddA_o + t0 * IN, h);
      float a[K][NV], u[K][NV];
#pragma unroll
      for (int tt = 0; tt < K; ++tt) {
        if (tt < steps) {
          ld_nc<NV>(a[tt], dA_o + (t0 + tt) * IN);
          ld_nc<NV>(u[tt], dBu_o + (t0 + tt) * IN);
        }
      }
#pragma unroll
      for (int tt = 0; tt < K; ++tt) {
        if (tt < steps) {
#pragma unroll
          for (int e = 0; e < NV; ++e) h[e] = fmaf(a[tt][e], h[e], u[tt][e]);
        }
      }
    }
  }

  // -- sweep 2: a segment at a time, last first
  float carry[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) carry[e] = (live && dh != nullptr) ? __ldg(dh + state + e) : 0.f;
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * K;
    const int steps = min(K, S - t0);
    if (live) {
      float a[K][NV], hp[K][NV], hc[NV];
      {
        float u[K][NV];
        if (s == 0) {
#pragma unroll
          for (int e = 0; e < NV; ++e) hc[e] = h0 != nullptr ? __ldg(h0 + state + e) : 0.f;
        } else {
          ld<NV>(hc, ddA_o + t0 * IN);
        }
#pragma unroll
        for (int tt = 0; tt < K; ++tt) {
          if (tt < steps) {
            ld_nc<NV>(a[tt], dA_o + (t0 + tt) * IN);
            ld_nc<NV>(u[tt], dBu_o + (t0 + tt) * IN);
          }
        }
        // recompute: hp[tt] = h_{t0 + tt - 1}, hc ends as h_{t0 + steps - 1}
#pragma unroll
        for (int tt = 0; tt < K; ++tt) {
          if (tt < steps) {
#pragma unroll
            for (int e = 0; e < NV; ++e) {
              hp[tt][e] = hc[e];
              hc[e] = fmaf(a[tt][e], hc[e], u[tt][e]);
            }
          }
        }
      }
#pragma unroll
      for (int tt = K - 1; tt >= 0; --tt) {
        if (tt < steps) {
          const int t = t0 + tt;
          const float d = __ldg(dy_o + (int64_t)t * I);
          float cv[NV], gg[NV], da[NV];
          ld_nc<NV>(cv, C_o + (int64_t)t * N);
          float* ps = smem + (tt * N + q * NV) * g.cs + c;
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            gg[e] = fmaf(d, cv[e], carry[e]);
            da[e] = gg[e] * hp[tt][e];
            ps[e * g.cs] = d * hc[e];                 // dy_t[i] h_t[i][n]
            carry[e] = a[tt][e] * gg[e];
            hc[e] = hp[tt][e];
          }
          st<NV>(ddBu_o + t * IN, gg);
          st<NV>(ddA_o + t * IN, da);
        }
      }
    }
    __syncthreads();

    // -- the block's part of dC: its channels summed in channel order
    for (int p = tid; p < steps * N; p += g.nt) {
      const int tt = p / N, n = p % N;
      const float* parts = smem + (tt * N + n) * g.cs;
      float sum = parts[0];
      for (int cc = 1; cc < nch; ++cc) sum += parts[cc];
      part[(((int64_t)b * gridDim.x + blk) * S + t0 + tt) * N + n] = sum;
    }
    __syncthreads();
  }

  if (live && dh0 != nullptr) st<NV>(dh0 + state, carry);
}

// dC[b, t, n] = the blocks' parts summed in block order.
__global__ void __launch_bounds__(DC_THREADS)
dc_kernel(const float* __restrict__ part, float* __restrict__ dC, int B, int S, int N,
          int nblk) {
  const int64_t SN = (int64_t)S * N;
  const int64_t idx = (int64_t)blockIdx.x * DC_THREADS + threadIdx.x;
  if (idx >= (int64_t)B * SN) return;
  const int64_t b = idx / SN, r = idx % SN;
  const float* p = part + b * nblk * SN + r;
  float sum = __ldg(p);
#pragma unroll 8
  for (int k = 1; k < nblk; ++k) sum += __ldg(p + k * SN);
  dC[idx] = sum;
}

template <int NV>
cudaError_t launch(const float* dA, const float* dBu, const float* C, const float* h0,
                   const float* dy, const float* dh, float* ddA, float* ddBu, float* dC,
                   float* dh0, float* part, int B, int S, int I, int N, cudaStream_t stream) {
  const Geom g(N, NV);
  const int nblk = (I + g.CH - 1) / g.CH;
  const size_t bytes = sizeof(float) * static_cast<size_t>(g.floats());
  const dim3 grid(nblk, B);
  selective_scan_bwd_kernel<NV><<<grid, g.nt, bytes, stream>>>(dA, dBu, C, h0, dy, dh, ddA,
                                                              ddBu, dh0, part, S, I, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * S * N;
  dc_kernel<<<static_cast<unsigned>((total + DC_THREADS - 1) / DC_THREADS), DC_THREADS, 0,
              stream>>>(part, dC, B, S, N, nblk);
  last_launch[0] = g.nt;
  last_launch[1] = K;
  last_launch[2] = static_cast<int>(bytes);
  last_launch[3] = nblk * B;
  return cudaGetLastError();
}

int blocks_a_row(int I, int N) {
  const Geom g(N, N % 4 == 0 ? 4 : 1);
  return (I + g.CH - 1) / g.CH;
}

}  // namespace

extern "C" long long repro_selective_scan_bwd_part_floats(int B, int S, int I, int N) {
  if (B < 1 || S < 1 || I < 1 || N < 1 || N > MAX_N) return -1;
  return static_cast<long long>(B) * blocks_a_row(I, N) * S * N;
}

extern "C" int repro_selective_scan_bwd(const void* dA, const void* dBu, const void* C,
                                        const void* h0, const void* dy, const void* dh,
                                        void* ddA, void* ddBu, void* dC, void* dh0, void* part,
                                        int B, int S, int I, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || I < 1 || N < 1 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dA);
  const float* bu = static_cast<const float*>(dBu);
  const float* c = static_cast<const float*>(C);
  const float* hi = static_cast<const float*>(h0);
  const float* gy = static_cast<const float*>(dy);
  const float* gh = static_cast<const float*>(dh);
  float* ga = static_cast<float*>(ddA);
  float* gb = static_cast<float*>(ddBu);
  float* gc = static_cast<float*>(dC);
  float* g0 = static_cast<float*>(dh0);
  float* pt = static_cast<float*>(part);
  if (N % 4 == 0)
    return static_cast<int>(launch<4>(a, bu, c, hi, gy, gh, ga, gb, gc, g0, pt, B, S, I, N, st));
  return static_cast<int>(launch<1>(a, bu, c, hi, gy, gh, ga, gb, gc, g0, pt, B, S, I, N, st));
}

extern "C" void repro_selective_scan_bwd_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
