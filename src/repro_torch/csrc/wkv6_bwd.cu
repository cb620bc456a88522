// RWKV-6 WKV backward for Hopper (sm_90a): r, k, v bf16, log-decay, bonus,
// state and cotangents fp32; dr, dk, dv out in bf16, dlogw, du and dS0 in
// fp32.  All arithmetic fp32.
//
// Replaces no TPU kernel: the reference trains rwkv6-7b by jax.grad through
// its plain chunked form (repro/models/rwkv.py:_wkv_chunked, :119,
// checkpointed at :164).  This is the backward of csrc/wkv6.cu's forward,
// launched by kernels/rwkv6/ops.py:WKV6 under autograd.
//
// Per (batch, head), head size N, w_t = exp(logw_t), S_t the state after
// step t (S_{-1} = S0) and dS_t its gradient (dS_{T-1} = the cotangent of
// the final state, or 0):
//
//   forward sweep   dr0_t = S_{t-1} dy_t
//   reverse sweep   dk0_t = dS_t v_t,  dv0_t = dS_t^T k_t,
//                   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T;   dS0 = dS_{-1}
//   bonus           c_t = v_t . dy_t,  a_t = r_t . (u k_t):
//                   dr_t = dr0_t + u k_t c_t,  dk_t = dk0_t + u r_t c_t,
//                   dv_t = dv0_t + a_t dy_t,   du = sum_{b,t} r_t k_t c_t
//   decay           D_t = rowsum(dS_t * S_t) obeys D_t = dlogw_t + k_t dk0_t
//                   and D_{t-1} = dlogw_t + r_t dr0_t, so from D_{T-1} =
//                   rowsum(dS * S_{T-1}) the reverse sweep gives dlogw_t =
//                   D_t - k_t dk0_t, then D_{t-1} = dlogw_t + r_t dr0_t:
//                   no second copy of the state, no division by w (which
//                   underflows to 0 for a strongly decaying channel).
//
// (The formulas follow RWKV-LM's public wkv6 CUDA backward and the decay
// gradient of flash-linear-attention's chunked GLA / RWKV-6 kernels.)
//
// Bound on this card.  At the training shape (8, 512, 64, 64) the work must
// move 403 MB (r, k, v in and dr, dk, dv out in bf16, logw, dy and dlogw in
// fp32): 0.120 ms at 3.35 TB/s; the step form does about 10 N^2 fp32
// operations a step per (b, h), 10.7 GFLOP, 0.160 ms at 67 TFLOP/s outside
// the tensor cores: the operations bound it.
//
// Design (simple first; a chunked form on the tensor cores, as the
// forward's, is later work).  One block of 4N threads per (b, h), the state
// in registers:
// * the forward sweep: thread (i, q) holds a quarter of row i of S (N/4
//   columns); dr0_t[i] is its partial sum reduced over the 4 lanes of the
//   row by two shuffles, and is written into dlogw's own slots (no scratch),
//   from where the reverse sweep reads it back before overwriting them;
// * the reverse sweep: two copies of dS, each updated by the same fp32
//   operations: threads 0 .. 2N-1 hold half a row each (row i: dk0[i]),
//   threads 2N .. 4N-1 half a column each (column j: dv0[j]), each sum
//   finished by one shuffle; the bonus terms, dlogw's running D and the
//   block's part of du are computed by the row's first lane;
// * steps come through shared memory L = 16 at a time (fp32, each row's
//   second half 16 bytes on, so two halves read together hit distinct
//   banks), and a stage's outputs go back from shared memory in 16-byte
//   stores;
// * du: each block writes its (b, h) part, summed over t in order, and a
//   second launch sums the parts over b in order.
// Deterministic: no atomics, every sum in a fixed order, a (b, h) row's bits
// independent of B and of the other rows.
//
// C interface (loaded with ctypes), returning the cudaError_t of its
// launches (0 on success): repro_wkv6_bwd(r, k, v, logw, u, S0, dy, dS, dr,
// dk, dv, dlogw, du, dS0, du_part, B, T, H, N, stream); S0 and dS may be
// null (zeros), dS0 may be null (not computed); du_part is B x H x N fp32
// scratch.  r, k, v, logw, dy, dr, dk, dv, dlogw are (B, T, H, N), u and du
// (H, N), S0, dS and dS0 (B, H, N, N), all contiguous and 16-byte aligned; N
// is 16, 32 or 64.  repro_wkv6_bwd_last_launch gives the threads a block,
// the steps a stage, the static shared memory and the blocks of the last
// call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int L = 16;                // steps a stage
int last_launch[4];

template <int N>
struct Cfg {
  static constexpr int NT = 4 * N;   // threads a block
  static constexpr int W = N + 4;    // a staged row, its second half 16 B on
  static constexpr int QA = N / 4;   // forward sweep: columns a thread
  static constexpr int HB = N / 2;   // reverse sweep: elements a thread
  static_assert(N % 16 == 0 && N <= 64, "head size");
};

// two floats as a bf16 pair (round to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// where column j of a staged row sits
template <int N>
__device__ __forceinline__ int pc(int j) {
  return j + (j >= N / 2 ? 4 : 0);
}

template <int N>
struct Smem {
  static constexpr int W = Cfg<N>::W;
  float r[L][W], k[L][W], v[L][W], w[L][W], dy[L][W];
  float x[L][W];                     // dr0, read back by the reverse sweep
  float o[4][L][N];                  // a stage's outputs before their store
  float c[L], a[L];                  // the bonus dots of the stage's steps
  float u[W];
  float D[N];                        // rowsum(dS * S_{T-1})
};

// Steps [t0, t0 + cnt) of a (B, T, H, N) tensor's (b, h) rows (step t at
// base + t * stride) into dst, as fp32.
template <int N>
__device__ __forceinline__ void stage_bf(float (*dst)[Cfg<N>::W], const bf16* src,
                                         int64_t base, int64_t stride, int t0, int cnt,
                                         int tid) {
  constexpr int V = N / 8;
  for (int p = tid; p < cnt * V; p += Cfg<N>::NT) {
    const int s = p / V, c = (p % V) * 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + base + (int64_t)(t0 + s) * stride + c);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 e0 = __bfloat1622float2(e[0]), e1 = __bfloat1622float2(e[1]);
    const float2 e2 = __bfloat1622float2(e[2]), e3 = __bfloat1622float2(e[3]);
    float* d = &dst[s][pc<N>(c)];
    *reinterpret_cast<float4*>(d) = make_float4(e0.x, e0.y, e1.x, e1.y);
    *reinterpret_cast<float4*>(d + 4) = make_float4(e2.x, e2.y, e3.x, e3.y);
  }
}

template <int N, bool EXP>
__device__ __forceinline__ void stage_f(float (*dst)[Cfg<N>::W], const float* src,
                                        int64_t base, int64_t stride, int t0, int cnt,
                                        int tid) {
  constexpr int V = N / 4;
  for (int p = tid; p < cnt * V; p += Cfg<N>::NT) {
    const int s = p / V, c = (p % V) * 4;
    float4 x = *reinterpret_cast<const float4*>(src + base + (int64_t)(t0 + s) * stride + c);
    if (EXP) x = make_float4(expf(x.x), expf(x.y), expf(x.z), expf(x.w));
    *reinterpret_cast<float4*>(&dst[s][pc<N>(c)]) = x;
  }
}

template <int N>
__device__ __forceinline__ void store_bf(bf16* dst, const float (*src)[N], int64_t base,
                                         int64_t stride, int t0, int cnt, int tid) {
  constexpr int V = N / 8;
  for (int p = tid; p < cnt * V; p += Cfg<N>::NT) {
    const int s = p / V, c = (p % V) * 8;
    const float4 a = *reinterpret_cast<const float4*>(&src[s][c]);
    const float4 b = *reinterpret_cast<const float4*>(&src[s][c + 4]);
    *reinterpret_cast<uint4*>(dst + base + (int64_t)(t0 + s) * stride + c) =
        make_uint4(pack_bf(a.x, a.y), pack_bf(a.z, a.w), pack_bf(b.x, b.y), pack_bf(b.z, b.w));
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* dst, const float (*src)[N], int64_t base,
                                        int64_t stride, int t0, int cnt, int tid) {
  constexpr int V = N / 4;
  for (int p = tid; p < cnt * V; p += Cfg<N>::NT) {
    const int s = p / V, c = (p % V) * 4;
    *reinterpret_cast<float4*>(dst + base + (int64_t)(t0 + s) * stride + c) =
        *reinterpret_cast<const float4*>(&src[s][c]);
  }
}

template <int N>
__global__ void __launch_bounds__(4 * N)
wkv6_bwd_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ S0,
                const float* __restrict__ dy, const float* __restrict__ dS,
                bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* dlw, float* __restrict__ dS0, float* __restrict__ du_part, int T,
                int H) {
  using C = Cfg<N>;
  __shared__ __align__(16) Smem<N> sm;
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int64_t stride = (int64_t)H * N;
  const int64_t base = ((int64_t)b * T * H + h) * N;
  const int64_t sbase = ((int64_t)b * H + h) * N * N;
  const int stages = (T + L - 1) / L;
  for (int i = tid; i < N; i += C::NT) sm.u[pc<N>(i)] = u[(int64_t)h * N + i];

  // ---- the forward sweep: thread (i, q) holds S[i][q N/4 .. (q + 1) N/4)
  {
    const int i = tid >> 2, q = tid & 3, j0 = q * C::QA;
    float S[C::QA];
#pragma unroll
    for (int m = 0; m < C::QA; m += 4) {
      const float4 s4 = S0 ? *reinterpret_cast<const float4*>(S0 + sbase + (int64_t)i * N + j0 + m)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      S[m] = s4.x, S[m + 1] = s4.y, S[m + 2] = s4.z, S[m + 3] = s4.w;
    }
    for (int st = 0; st < stages; ++st) {
      const int t0 = st * L, cnt = min(L, T - t0);
      stage_bf<N>(sm.k, k, base, stride, t0, cnt, tid);
      stage_bf<N>(sm.v, v, base, stride, t0, cnt, tid);
      stage_f<N, true>(sm.w, lw, base, stride, t0, cnt, tid);
      stage_f<N, false>(sm.dy, dy, base, stride, t0, cnt, tid);
      __syncthreads();
      for (int s = 0; s < cnt; ++s) {
        const float wi = sm.w[s][pc<N>(i)], ki = sm.k[s][pc<N>(i)];
        const float* vs = &sm.v[s][pc<N>(j0)];
        const float* ds = &sm.dy[s][pc<N>(j0)];
        float p = 0.f;
#pragma unroll
        for (int m = 0; m < C::QA; ++m) {
          p = fmaf(S[m], ds[m], p);
          S[m] = fmaf(wi, S[m], ki * vs[m]);
        }
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        if (q == 0) sm.o[0][s][i] = p;
      }
      __syncthreads();
      store_f<N>(dlw, sm.o[0], base, stride, t0, cnt, tid);     // dr0, for now
    }
    float d = 0.f;
    if (dS) {
#pragma unroll
      for (int m = 0; m < C::QA; ++m) d = fmaf(dS[sbase + (int64_t)i * N + j0 + m], S[m], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (q == 0) sm.D[i] = d;
  }
  __syncthreads();            // dr0 in dlogw's slots, D in shared memory

  // ---- the reverse sweep: row e (threads < 2N) or column e of dS, half of it
  const bool row = tid < 2 * N;
  const int e = (tid & (2 * N - 1)) >> 1, half = tid & 1, m0 = half * C::HB;
  float G[C::HB];
#pragma unroll
  for (int m = 0; m < C::HB; ++m)
    G[m] = !dS ? 0.f : row ? dS[sbase + (int64_t)e * N + m0 + m] : dS[sbase + (int64_t)(m0 + m) * N + e];
  float D = row ? sm.D[e] : 0.f;
  const float ue = sm.u[pc<N>(e)];
  float dup = 0.f;
  for (int st = stages - 1; st >= 0; --st) {
    const int t0 = st * L, cnt = min(L, T - t0);
    stage_bf<N>(sm.r, r, base, stride, t0, cnt, tid);
    stage_bf<N>(sm.k, k, base, stride, t0, cnt, tid);
    stage_bf<N>(sm.v, v, base, stride, t0, cnt, tid);
    stage_f<N, true>(sm.w, lw, base, stride, t0, cnt, tid);
    stage_f<N, false>(sm.dy, dy, base, stride, t0, cnt, tid);
    stage_f<N, false>(sm.x, dlw, base, stride, t0, cnt, tid);
    __syncthreads();
    {  // c_t and a_t: N/4 lanes a step, 4 channels each (4N threads, L steps)
      constexpr int G4 = N / 4;
      const int s = tid / G4, c0 = pc<N>((tid % G4) * 4);
      float c = 0.f, a = 0.f;
      if (s < cnt) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          c = fmaf(sm.v[s][c0 + m], sm.dy[s][c0 + m], c);
          a = fmaf(sm.r[s][c0 + m], sm.u[c0 + m] * sm.k[s][c0 + m], a);
        }
      }
#pragma unroll
      for (int off = 1; off < G4; off <<= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
        a += __shfl_xor_sync(0xffffffffu, a, off);
      }
      if (tid % G4 == 0 && s < cnt) sm.c[s] = c, sm.a[s] = a;
    }
    __syncthreads();
    for (int s = cnt - 1; s >= 0; --s) {
      float p = 0.f;
      if (row) {
        const float wi = sm.w[s][pc<N>(e)], ri = sm.r[s][pc<N>(e)];
        const float* vs = &sm.v[s][pc<N>(m0)];
        const float* ds = &sm.dy[s][pc<N>(m0)];
#pragma unroll
        for (int m = 0; m < C::HB; ++m) {
          p = fmaf(G[m], vs[m], p);
          G[m] = fmaf(wi, G[m], ri * ds[m]);
        }
        p += __shfl_xor_sync(0xffffffffu, p, 1);                // dk0[e]
        if (half == 0) {
          const float ki = sm.k[s][pc<N>(e)], c = sm.c[s], x = sm.x[s][pc<N>(e)];
          sm.o[0][s][e] = fmaf(ue * ki, c, x);                   // dr
          sm.o[1][s][e] = fmaf(ue * ri, c, p);                   // dk
          const float dl = fmaf(-ki, p, D);                      // dlogw
          sm.o[3][s][e] = dl;
          D = fmaf(ri, x, dl);
          dup = fmaf(ri * ki, c, dup);
        }
      } else {
        const float dyj = sm.dy[s][pc<N>(e)];
        const float* ks = &sm.k[s][pc<N>(m0)];
        const float* ws = &sm.w[s][pc<N>(m0)];
        const float* rs = &sm.r[s][pc<N>(m0)];
#pragma unroll
        for (int m = 0; m < C::HB; ++m) {
          p = fmaf(G[m], ks[m], p);
          G[m] = fmaf(ws[m], G[m], rs[m] * dyj);
        }
        p += __shfl_xor_sync(0xffffffffu, p, 1);                // dv0[e]
        if (half == 0) sm.o[2][s][e] = fmaf(sm.a[s], dyj, p);   // dv
      }
    }
    __syncthreads();
    store_bf<N>(dr, sm.o[0], base, stride, t0, cnt, tid);
    store_bf<N>(dk, sm.o[1], base, stride, t0, cnt, tid);
    store_bf<N>(dv, sm.o[2], base, stride, t0, cnt, tid);
    store_f<N>(dlw, sm.o[3], base, stride, t0, cnt, tid);
  }
  if (row) {
    if (dS0) {
#pragma unroll
      for (int m = 0; m < C::HB; m += 4)
        *reinterpret_cast<float4*>(dS0 + sbase + (int64_t)e * N + m0 + m) =
            make_float4(G[m], G[m + 1], G[m + 2], G[m + 3]);
    }
    if (half == 0) du_part[((int64_t)b * H + h) * N + e] = dup;
  }
}

// du[h][i] = sum over b, in order, of the blocks' parts
__global__ void wkv6_du_kernel(const float* __restrict__ part, float* __restrict__ du, int B,
                               int HN) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HN) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(int64_t)b * HN + idx];
  du[idx] = s;
}

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const void* S0, const void* dy, const void* dS, void* dr, void* dk, void* dv,
                   void* dlw, void* du, void* dS0, void* du_part, int B, int T, int H,
                   cudaStream_t st) {
  const dim3 grid(H, B);
  last_launch[0] = Cfg<N>::NT;
  last_launch[1] = L;
  last_launch[2] = static_cast<int>(sizeof(Smem<N>));
  last_launch[3] = H * B;
  wkv6_bwd_kernel<N><<<grid, Cfg<N>::NT, 0, st>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u),
      static_cast<const float*>(S0), static_cast<const float*>(dy),
      static_cast<const float*>(dS), static_cast<bf16*>(dr), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dlw), static_cast<float*>(dS0),
      static_cast<float*>(du_part), T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HN = H * N;
  wkv6_du_kernel<<<(HN + 255) / 256, 256, 0, st>>>(static_cast<const float*>(du_part),
                                                   static_cast<float*>(du), B, HN);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* S0, const void* dy, const void* dS,
                              void* dr, void* dk, void* dv, void* dlogw, void* du, void* dS0,
                              void* du_part, int B, int T, int H, int N, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16:
      err = launch<16>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, du_part, B, T,
                       H, st);
      break;
    case 32:
      err = launch<32>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, du_part, B, T,
                       H, st);
      break;
    case 64:
      err = launch<64>(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du, dS0, du_part, B, T,
                       H, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" void repro_wkv6_bwd_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
