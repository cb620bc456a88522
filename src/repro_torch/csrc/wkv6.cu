// RWKV-6 WKV recurrence for Hopper (sm_90a): r, k, v bf16, log-decay and
// state fp32, output fp32.
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py:wkv6_kernel (body
// _wkv6_kernel).  It computes what that kernel computes — per (batch, head),
// with head size N and state S (N x N, key-major):
//
//     y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i]
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j],      w_t = exp(logw_t)
//
// — but as the step-by-step recurrence, not the TPU's chunked closed form.
// The Pallas kernel carries S across a sequential grid axis in VMEM and
// evaluates each 64-step chunk through a (Q, Q, N) decay tensor, 1 MB of
// fp32 at Q = N = 64: beyond a Hopper block's 227 KB of shared memory, and a
// Hopper grid has no sequential axis.  So here:
//
// * one block owns one (b, h) and a slice of CS = 16 value columns of S.
//   Columns of S evolve independently (column j only needs v[j] and the
//   per-row r, k, w), so the N / CS slices of a head run as separate blocks
//   and never talk; the loop over t inside the block replaces the sequential
//   grid axis;
// * each thread keeps a 2-column x 4-row piece of S in registers (P = N / 4
//   threads share a column: 128 threads a block at N = 64);
// * the block stages TC = 16 steps at a time: r, k, logw and the slice's v
//   come in by 16-byte cp.async into a double buffer (the next chunk is in
//   flight while this one is computed), then one pass converts them to fp32
//   and takes w = exp(logw).  Steps past T are neither copied nor run;
// * the step loop holds no shuffle and no global store: each thread leaves
//   its partial sum of y (its rows' share of r.S and of the bonus
//   v * r.(u*k)) in shared memory, and one pass per chunk adds the P parts
//   in a fixed pairwise order and writes a coalesced row of y per step, so
//   consecutive steps can overlap: only one multiply-add a step carries
//   each state element from one step to the next.
//
// Bound on this card.  A prefill launch (1, 512, 64, 64) moves 31.5 MB (r,
// k, v bf16, logw and y fp32, S in and out): 9.4 us at 3.35 TB/s; the
// chunked closed form at Q = 16 needs 671 MFLOP of products (1.4 us on the
// TF32 tensor cores) and 42 MFLOP of fp32 decays (0.6 us), so the bytes
// bound it.  A decode launch (4, 1, 64, 64) moves 8.6 MB,
// nearly all of it S in and out (2.6 us).  With one to four warps a block
// and two blocks an SM at prefill, this kernel is latency-bound well above
// both (its times are in PERF.md); the chunked tensor-core form (wgmma,
// TMA) is later work.
//
// Deterministic, and a (b, h) row's bits do not depend on B or on the other
// rows: no atomics and no split over t; every sum runs in a fixed order.
// Crash-resume bit-identity rests on that.
//
// S may alias S0 (the serving cache is updated in place): each block reads
// its own columns of S0 before it writes the same columns of S, and no other
// block touches them.
//
// C interface (loaded with ctypes): repro_wkv6_fwd returns the cudaError_t
// of the launch (0 on success).  r, k, v, logw and y are (B, T, H, N), u is
// (H, N), S0 and S are (B, H, N, N), all contiguous; N is 16, 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CS = 16;       // value columns per block
constexpr int CJ = 2;        // columns per thread: c, c + CW, ...
constexpr int CW = CS / CJ;  // column groups per block
constexpr int TC = 16;       // time steps staged per chunk

template <int N>
struct Cfg {
  static constexpr int R = 4;                        // rows per thread
  static constexpr int P = N / R;                    // threads per column
  static constexpr int NTHREADS = CW * P;            // 128, 64 or 32
  static_assert(P % 4 == 0 && (P & (P - 1)) == 0, "parts must fill float4s");
  static_assert(N % CS == 0 && N % 8 == 0, "unsupported head size");
  static_assert(NTHREADS % 32 == 0 && 32 % P == 0, "thread layout");
};

template <int N>
struct Smem {
  using C = Cfg<N>;
  // raw copies, double buffered, filled by cp.async
  __nv_bfloat16 r_raw[2][TC][N];
  __nv_bfloat16 k_raw[2][TC][N];
  float lw_raw[2][TC][N];
  __nv_bfloat16 v_raw[2][TC][CS];
  // fp32: thread part q reads rows q*R .. q*R + R - 1 as one float4
  float r[TC][N];
  float w[TC][N];
  float k[TC][N];
  float v[TC][CS];
  // per-thread partial sums of y, bonus included, [t][column][part]:
  // summed over the parts once per chunk
  float ypart[TC][CS][C::P];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

// Start the copies of steps [t0, min(T, t0 + TC)) into raw buffer `buf`.
template <int N>
__device__ __forceinline__ void load_chunk(Smem<N>& s, int buf, const __nv_bfloat16* r,
                                            const __nv_bfloat16* k, const float* lw,
                                            const __nv_bfloat16* v, int64_t row0, int64_t H,
                                            int steps, int t0, int col0, int tid) {
  constexpr int NT = Cfg<N>::NTHREADS;
  for (int p = tid; p < steps * (N / 8); p += NT) {     // r, k: 8 bf16 a piece
    const int tt = p / (N / 8), c8 = (p % (N / 8)) * 8;
    const int64_t off = (row0 + (t0 + tt) * H) * N + c8;
    cp_async16(&s.r_raw[buf][tt][c8], r + off);
    cp_async16(&s.k_raw[buf][tt][c8], k + off);
  }
  for (int p = tid; p < steps * (N / 4); p += NT) {     // logw: 4 fp32 a piece
    const int tt = p / (N / 4), c4 = (p % (N / 4)) * 4;
    cp_async16(&s.lw_raw[buf][tt][c4], lw + (row0 + (t0 + tt) * H) * N + c4);
  }
  for (int p = tid; p < steps * (CS / 8); p += NT) {    // v: this slice only
    const int tt = p / (CS / 8), c8 = (p % (CS / 8)) * 8;
    cp_async16(&s.v_raw[buf][tt][c8], v + (row0 + (t0 + tt) * H) * N + col0 + c8);
  }
  cp_async_commit();
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::NTHREADS)
wkv6_fwd_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* S0, float* __restrict__ y,
                float* S, int T, int H) {
  using C = Cfg<N>;
  constexpr int P = C::P, R = C::R, NT = C::NTHREADS;
  __shared__ __align__(16) Smem<N> s;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * CS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q = tid % P;                 // row part: rows q*R .. q*R + R - 1
  const int c = tid / P;                 // columns c, c + CW, ... of the slice
  const int64_t row0 = (int64_t)b * T * H + h;   // (b, t = 0, h) row index
  const int64_t sbase = ((int64_t)b * H + h) * N * N;

  const int nchunks = (T + TC - 1) / TC;
  load_chunk<N>(s, 0, r, k, lw, v, row0, H, min(TC, T), 0, col0, tid);

  float sv[CJ][R], uq[R];                // this thread's piece of S, its u
#pragma unroll
  for (int m = 0; m < R; ++m) {
    uq[m] = u[(int64_t)h * N + q * R + m];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
      sv[jj][m] = S0[sbase + (int64_t)(q * R + m) * N + col0 + c + jj * CW];
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * TC;
    const int steps = min(TC, T - t0);
    if (ch + 1 < nchunks) {
      load_chunk<N>(s, buf ^ 1, r, k, lw, v, row0, H, min(TC, T - t0 - TC), t0 + TC,
                     col0, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // chunk ch landed; every thread is done with ch - 1

    // -- convert to fp32 and take w = exp(logw): element p of the chunk to
    //    thread p % NT, unrolled so that a thread starts all its loads first
#pragma unroll
    for (int i = 0; i < TC * N / NT; ++i) {
      const int p = tid + i * NT, tt = p / N, e = p % N;
      if (tt < steps) {
        s.r[tt][e] = __bfloat162float(s.r_raw[buf][tt][e]);
        s.k[tt][e] = __bfloat162float(s.k_raw[buf][tt][e]);
        s.w[tt][e] = expf(s.lw_raw[buf][tt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < TC * CS / NT; ++i) {
      const int p = tid + i * NT;
      if (p < steps * CS) s.v[p / CS][p % CS] = __bfloat162float(s.v_raw[buf][p / CS][p % CS]);
    }
    __syncthreads();

    // -- the recurrence over this chunk's steps: no shuffle and no global
    //    store inside, so consecutive steps overlap; partial sums of y go
    //    to shared memory
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      float vv[CJ], yy[CJ], bonus = 0.f;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        vv[jj] = s.v[tt][c + jj * CW];
        yy[jj] = 0.f;
      }
      const float4 r4 = *reinterpret_cast<const float4*>(&s.r[tt][q * R]);
      const float4 w4 = *reinterpret_cast<const float4*>(&s.w[tt][q * R]);
      const float4 k4 = *reinterpret_cast<const float4*>(&s.k[tt][q * R]);
      const float rr[R] = {r4.x, r4.y, r4.z, r4.w};
      const float ww[R] = {w4.x, w4.y, w4.z, w4.w};
      const float kk[R] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int m = 0; m < R; ++m) {
        bonus = fmaf(rr[m] * uq[m], kk[m], bonus);
#pragma unroll
        for (int jj = 0; jj < CJ; ++jj) {
          yy[jj] = fmaf(rr[m], sv[jj][m], yy[jj]);
          sv[jj][m] = fmaf(ww[m], sv[jj][m], kk[m] * vv[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj)
        s.ypart[tt][c + jj * CW][q] = fmaf(vv[jj], bonus, yy[jj]);
    }
    __syncthreads();

    // -- y = the sum of the P parts, as a fixed pairwise tree; one
    //    coalesced row of CS columns per step
#pragma unroll
    for (int i = 0; i < TC * CS / NT; ++i) {
      const int p = tid + i * NT, tt = p / CS, col = p % CS;
      if (p >= steps * CS) break;
      float part[P / 4];
#pragma unroll
      for (int g = 0; g < P / 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(&s.ypart[tt][col][4 * g]);
        part[g] = (a.x + a.y) + (a.z + a.w);
      }
#pragma unroll
      for (int width = P / 4; width > 1; width /= 2)
#pragma unroll
        for (int g = 0; g < width / 2; ++g) part[g] = part[2 * g] + part[2 * g + 1];
      y[(row0 + (int64_t)(t0 + tt) * H) * N + col0 + col] = part[0];
    }
  }

#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
      S[sbase + (int64_t)(q * R + m) * N + col0 + c + jj * CW] = sv[jj][m];
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw,
                   const void* u, const void* S0, void* y, void* S, int B, int T, int H,
                   cudaStream_t stream) {
  const dim3 grid(N / CS, H, B);
  wkv6_fwd_kernel<N><<<grid, Cfg<N>::NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(S0), static_cast<float*>(y),
      static_cast<float*>(S), T, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* S0, void* y, void* S, int B, int T,
                              int H, int N, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch<16>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    case 32: err = launch<32>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    case 64: err = launch<64>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
