// RWKV-6 WKV recurrence for Hopper (sm_90a): r, k, v bf16, log-decay and
// state fp32, output fp32.
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py:wkv6_kernel (body
// _wkv6_kernel).  Per (batch, head), with head size N and state S (N x N,
// key-major):
//
//     y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * sum_i r_t[i] u[i] k_t[i]
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j],      w_t = exp(logw_t)
//
// Bound on this card.  A prefill launch (1, 512, 64, 64) moves 31.5 MB (r,
// k, v bf16, logw and y fp32, S in and out): 9.4 us at 3.35 TB/s; the
// chunked closed form at Q = 16 needs 671 MFLOP of products (1.4 us on the
// TF32 tensor cores) and 42 MFLOP of fp32 decays (0.6 us), so the bytes
// bound it.  A decode launch (4, 1, 64, 64) moves 8.6 MB, nearly all of it
// S in and out: 2.6 us.
//
// What held the earlier kernel (one block per (b, h, 16 value columns),
// the step recurrence with S in registers) back:
// * prefill was serial and latency-bound: each block walked all T steps
//   one after another, with three barriers, an fp32 conversion pass and a
//   reduction of partial sums every 16 steps, on 256 blocks of 4 warps
//   (8 warps an SM) and no tensor core: 0.102 ms at (1, 512, 64, 64),
//   about 400 cycles a step, 10.9x the bound;
// * decode read and wrote S uncoalesced: a warp touched 16 rows x 2 floats
//   of S per load, a quarter of each 32-byte sector used: 0.0111 ms at
//   (4, 1, 64, 64), 4.3x the bound.
//
// So this kernel has two routes, chosen by T alone (never by B):
//
// * The chunked route, T >= CHUNKED_MIN_T (= Q = 64): the TPU kernel's
//   closed form over chunks of Q = 64 steps, in three launches on the
//   caller's stream: the chunks of a head run in parallel, B x H x T/Q
//   blocks (512 at the rwkv6-7b prefill, where B x H = 64 is half the
//   SMs), with one short sequential pass between.  A walk of the chunks in
//   order per (b, h, 16 rows of S), the state held in the tensor cores'
//   accumulators, in place of passes 1 and 2, was tried and dropped: it was
//   slower than both passes together, each block waiting on its own chain
//   of barriers and products chunk after chunk.  logP is the inclusive
//   cumulative log decay from the chunk's start (logP_{-1} = 0):
//   1. wkv6_chunk_state_kernel, per (b, h, chunk): the chunk's state
//      increment dS = (k_s exp(logP_{Q-1} - logP_s))^T v, a (N x Q)(Q x N)
//      product, and its decay exp(logP_{Q-1}), into the scratch;
//   2. wkv6_chunk_scan_kernel, per (b, h, 256 state elements): walks the
//      chunks in order, S_{c+1} = exp(logP_{Q-1}) S_c + dS_c in fp32,
//      writes each chunk's start state S_c over dS_c, and the final S;
//   3. wkv6_chunk_out_kernel, per (b, h, chunk): y = (r_t exp(logP_{t-1}))
//      S_c + A v, a (Q x N)(N x N) and a (Q x Q)(Q x N) product, where the
//      scores A[t][s] = sum_i r_t[i] k_s[i] exp(logP_{t-1}[i] - logP_s[i]),
//      s < t, plus the bonus r_t . (u k_t) at s = t.  The TPU kernel takes
//      A through a (Q, Q, N) tensor, 1 MB at Q = N = 64, beyond shared
//      memory; here A is factored by sub-blocks of L = 16 steps.  Pairs of
//      sub-blocks j < i split the decay at e, the last step of j:
//      exp(logP_{t-1} - logP_s) = exp(logP_{t-1} - logP_e) exp(logP_e -
//      logP_s), both factors <= 1, so each pair is a 16 x 16 x N product on
//      the tensor cores.  The four 16 x 16 diagonal sub-blocks are direct
//      in fp32, the decay a running product of w over s < m < t.  No
//      exponent is ever positive: logw = -exp(w_raw) reaches tens a step
//      for a trained head, and exp(-logP) would overflow within a chunk.
//      Four warps do the tensor-core work (one sub-block's rows each)
//      while the other four do the diagonal sub-blocks, so the two overlap.
//   Products take TF32 operands with fp32 accumulation.  A decay-weighted
//   operand x is split as x = hi + lo, both TF32 (cvt.rna), and a product
//   taken as lo*b + hi*b (b = v, exact in TF32: bf16 has 8 mantissa bits)
//   or lo*b_hi + hi*b_lo + hi*b_hi.  On the CPU mirror of this
//   decomposition (kernels/rwkv6/ref.py:wkv6_subblocks and its test) one
//   TF32 rounding costs 4.0e-4 of max|y|, close to half the 1e-3 limit,
//   and the split 4.3e-7.  The largest
//   product, pass 3's (Q x N)(N x N) with the start state, runs on wgmma
//   (m64nNk8, the four tensor-core warps one warpgroup): the decayed r from
//   registers, S_c's hi and lo parts from shared memory, K-major with the
//   128-byte swizzle; the rest are 16-row products on mma.sync m16n8k8.
//   r, k, v and logw tiles come in by 16-byte cp.async, rows past T
//   zero-filled (logw = 0 and r = k = v = 0, so the state is exact).
//   Passes 2 and 3 are launched for programmatic dependent launch: pass 3
//   loads its tiles and computes logP and the scores while passes 1 and 2
//   still run, and waits for them (griddepcontrol.wait) only before it
//   reads the start state.  Two blocks of 8 warps share an
//   SM (112 KB of shared memory each at N = 64, 1 KB more to align the
//   swizzled tiles).  Scratch (allocated by the binding): B x H x chunks x
//   (N x N + N) fp32, 8.5 MB at the rwkv6-7b prefill, written by pass 1,
//   read and rewritten by pass 2, read by pass 3: 34 MB of traffic, much
//   of it in the 50 MB L2.
//   What holds it back (src/repro_torch/kernels/rwkv6/probe.py on the card;
//   PERF.md has the numbers): passes 1 and 2 move the inputs and the
//   scratch a second time; in pass 3 a block first waits for its copies,
//   then its fp32 diagonal sub-blocks on four warps finish last; taking out
//   every mma.sync product (pairs, intra, pass 1) saves about a fifth of
//   pass 3 and a quarter of pass 1, taking out every exponential less.
// * The step route, T < CHUNKED_MIN_T (the decode tick is T = 1): one
//   block per (b, h), S in registers for the whole call, each thread 4
//   consecutive columns of R rows, so a warp's load of S reads whole
//   256-byte rows: every sector fully used.  y's sum over the rows goes
//   through a shuffle butterfly inside each warp and then the warps' parts
//   in warp order.  A step's r, k, logw and v are loaded while the
//   previous step's sum is reduced.
//
// The chunk geometry and the device helpers this file shares with the
// backward (csrc/wkv6_bwd.cu) live in csrc/wkv6_common.cuh.
//
// Deterministic, and a (b, h) row's bits do not depend on B or on the
// other rows: no atomics, no split whose order varies; every sum runs in a
// fixed order.  Crash-resume bit-identity rests on that.
//
// S may alias S0 (the serving cache is updated in place): on the step
// route each thread reads its elements of S0 before it writes the same
// elements of S; on the chunked route pass 2 is the only one that reads S0
// or writes S, element by element in the same thread, and pass 3 reads the
// start states from the scratch.
//
// C interface (loaded with ctypes), every entry returning the cudaError_t
// of its launches (0 on success): repro_wkv6_fwd runs the step route for
// any T; repro_wkv6_fwd_chunked the chunked route, with the scratch of
// repro_wkv6_scratch_bytes bytes; repro_wkv6_chunked_min_t gives the
// threshold the binding chooses by; repro_wkv6_last_launch the threads a
// block, the chunk length (0 on the step route), the dynamic shared memory
// and the blocks of the last call's output launch.  r, k, v, logw and y are
// (B, T, H, N), u is (H, N), S0 and S are (B, H, N, N), all contiguous; N
// is 16, 32 or 64.

#include "wkv6_common.cuh"

namespace {

constexpr int CHUNKED_MIN_T = Q;
constexpr int CT = 256;              // threads a block, chunked passes
constexpr int CW = CT / 32;          // warps a block, chunked passes
constexpr int SCAN_T = 64;           // threads a block, pass 2 (float4 each)

int last_launch[4];

// ---- wgmma: TF32, A from registers, B from shared memory K-major with the
// 128-byte swizzle (rows of 32 fp32 along K, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;     // LBO: unused when swizzled K-major
  d |= static_cast<uint64_t>(1024 >> 4) << 32;   // SBO: the 8-row groups
  d |= static_cast<uint64_t>(1) << 62;           // 128-byte swizzle
  return d;
}
// byte offset of B[k][n] in an N-row K-major tile with the 128-byte swizzle
template <int N>
__device__ __forceinline__ uint32_t sw128_offset(int k, int n) {
  return (k / 32) * (N * 128) + n * 128 + ((((k % 32) / 4) ^ (n % 8)) * 16) + (k % 4) * 4;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// Keep the compiler from moving reads or writes of registers across the
// asynchronous products that own them.
template <int M>
__device__ __forceinline__ void fence_regs(float (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[e])::"memory");
}

// d (64 x N) [+]= a (64 x 8, registers: rows 16w.. of warp w, laid out as
// mma.sync's m16n8k8 A fragment) b (8 x N, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[2][4], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_tf32_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, db, scale_d);
  else wgmma_tf32_n64(d, a, db, scale_d);
}

// ---------------------------------------------------------------------------
// The chunked route
// ---------------------------------------------------------------------------

template <int N>
struct StateSmem {
  bf16 k[Q][N + 8];        // bf16 rows of 16-byte multiples; fragments conflict-free
  bf16 v[Q][N + 8];
  float kt[Q][N + 8];      // logw, then the decayed k in place; read transposed
  float part[NSB][N];      // sub-block totals of logw
  float dec[N];            // the chunk's decay exp(logP_{Q-1})
};

// Pass 1: the chunk's state increment dS = Kt^T V, Kt[s][i] = k_s[i]
// exp(logP_{Q-1}[i] - logP_s[i]), and its decay D = exp(logP_{Q-1}).
template <int N>
__global__ void __launch_bounds__(CT)
wkv6_chunk_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const float* __restrict__ lw, float* __restrict__ dS,
                        float* __restrict__ D, int T, int H, int NC) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<N>& s = *reinterpret_cast<StateSmem<N>*>(smem_raw);
  static_assert(N * NSB <= CT, "one thread per (channel, sub-block)");
  pdl_trigger();                        // pass 2 may start: it waits for this
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = ch * Q;
  const int64_t row0 = (int64_t)b * T * H + h;
  const int64_t chunk = ((int64_t)b * H + h) * NC + ch;
  load_rows<N, CT>(s.k, k, row0, H, t0, T, tid);
  load_rows<N, CT>(s.v, v, row0, H, t0, T, tid);
  load_rows<N, CT>(s.kt, lw, row0, H, t0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Kt[s] = k_s exp((lpl_15 - lpl_s) + the later sub-blocks' totals): both
  // parts <= 0, each thread over its own elements
  const int c = tid % N, seg = tid / N;
  float lpl[L];
  if (seg < NSB) local_cumsum(s.kt, s.part, c, seg, lpl);
  __syncthreads();
  if (seg < NSB) {
    float later = 0.f, end = 0.f;
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      end += s.part[j][c];
      if (j > seg) later += s.part[j][c];
    }
#pragma unroll
    for (int m = 0; m < L; ++m)
      s.kt[seg * L + m][c] = bf(s.k[seg * L + m][c]) * __expf((lpl[L - 1] - lpl[m]) + later);
    if (seg == 0) s.dec[c] = __expf(end);
  }
  __syncthreads();

  // M = N key channels i, N = N value columns j, K = Q steps; a warp takes
  // TPW consecutive n-tiles of one m-tile
  constexpr int NTL = N / 8, TILES = (N / 16) * NTL;
  constexpr int TPW = (TILES + CW - 1) / CW;
  static_assert(NTL % TPW == 0, "a warp's tiles share one m-tile");
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  const int tile0 = warp * TPW;
  if (tile0 < TILES) {
    const int i0 = (tile0 / NTL) * 16 + g, i1 = i0 + 8, nt0 = tile0 % NTL;
    float acc[TPW][4] = {};
#pragma unroll
    for (int ks = 0; ks < Q / 8; ++ks) {
      const int s0 = ks * 8 + q, s1 = s0 + 4;
      uint32_t hi[4], lo[4];
      split_tf32(s.kt[s0][i0], hi[0], lo[0]);
      split_tf32(s.kt[s0][i1], hi[1], lo[1]);
      split_tf32(s.kt[s1][i0], hi[2], lo[2]);
      split_tf32(s.kt[s1][i1], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int col = (nt0 + j) * 8 + g;
        const uint32_t b0 = __float_as_uint(bf(s.v[s0][col]));   // exact in TF32
        const uint32_t b1 = __float_as_uint(bf(s.v[s1][col]));
        mma(acc[j], lo, b0, b1);
        mma(acc[j], hi, b0, b1);
      }
    }
    float* out = dS + chunk * N * N;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int col = (nt0 + j) * 8 + 2 * q;
      *reinterpret_cast<float2*>(&out[i0 * N + col]) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(&out[i1 * N + col]) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  if (tid < N) D[chunk * N + tid] = s.dec[tid];
}

// Pass 2: per (b, h), walk the chunks in order; S_c goes over dS_c.
template <int N>
__global__ void __launch_bounds__(SCAN_T)
wkv6_chunk_scan_kernel(const float* S0, float* __restrict__ dS, const float* __restrict__ D,
                       float* S, int H, int NC) {
  pdl_trigger();                        // pass 3 may start its loads and scores
  pdl_wait();                           // every dS and D written
  const int h = blockIdx.y, b = blockIdx.z;
  const int e4 = blockIdx.x * SCAN_T + threadIdx.x;   // float4 of the head's state
  const int i = e4 * 4 / N;
  const int64_t head = (int64_t)b * H + h;
  float4 st = reinterpret_cast<const float4*>(S0 + head * N * N)[e4];
  // chunks in groups of UNR, their loads issued together
  constexpr int UNR = 8;
  for (int c0 = 0; c0 < NC; c0 += UNR) {
    float4 d[UNR];
    float dec[UNR];
#pragma unroll
    for (int j = 0; j < UNR; ++j) {
      if (c0 + j < NC) {
        d[j] = reinterpret_cast<const float4*>(dS + (head * NC + c0 + j) * N * N)[e4];
        dec[j] = D[(head * NC + c0 + j) * N + i];
      }
    }
#pragma unroll
    for (int j = 0; j < UNR; ++j) {
      if (c0 + j < NC) {
        reinterpret_cast<float4*>(dS + (head * NC + c0 + j) * N * N)[e4] = st;
        st = make_float4(fmaf(dec[j], st.x, d[j].x), fmaf(dec[j], st.y, d[j].y),
                         fmaf(dec[j], st.z, d[j].z), fmaf(dec[j], st.w, d[j].w));
      }
    }
  }
  reinterpret_cast<float4*>(S + head * N * N)[e4] = st;
}

template <int N>
struct OutSmem {
  // the start state S_c split into TF32 hi and lo, each K-major (k = c,
  // n = j) with the 128-byte swizzle, as wgmma reads B; S_c first lands in
  // S_lo row-major.  1024-aligned: the kernel rounds its base up
  static constexpr int SB = (N + 31) / 32 * N * 32;
  float S_hi[SB];
  float S_lo[SB];
  bf16 r[Q][N + 8];
  bf16 k[Q][N + 8];
  bf16 v[Q][N + 8];
  float lp[Q][N + 4];      // logw, then logP: inclusive, from the chunk's start
  float w[Q][N + 4];       // exp(logw)
  float A[Q][Q + 4];       // scores, the lower block triangle
  float u[N];
  float part[NSB][N];      // sub-block totals of logw
};

// Pass 3: y for one chunk.  Warps 0-3 (TW) do the tensor-core work, each
// for the 16 rows of one sub-block: the inter-chunk product, the scores of
// sub-block pairs, then the intra-chunk product; warps 4-7 meanwhile do the
// diagonal sub-blocks' scores in fp32, so the two kinds of work overlap.
constexpr int TW = NSB;               // tensor-core warps, one a sub-block

template <int N>
__global__ void __launch_bounds__(CT)
wkv6_chunk_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ lw,
                      const float* __restrict__ u, const float* __restrict__ Sc,
                      float* __restrict__ y, int T, int H, int NC) {
  static_assert(2 * TW == CW, "half the warps on each kind of work");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem<N>& s = *reinterpret_cast<OutSmem<N>*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  const int ch = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = ch * Q;
  const int64_t row0 = (int64_t)b * T * H + h;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  const bool tensor_warp = warp < TW;
  // what every warp needs first; v, which only the tensor-core warps
  // read, in a second group of theirs.  None of it is written by passes 1
  // and 2, so this block may run while they do: only the start state
  // waits for them (pdl_wait below)
  load_rows<N, CT>(s.r, r, row0, H, t0, T, tid);
  load_rows<N, CT>(s.k, k, row0, H, t0, T, tid);
  load_rows<N, CT>(s.lp, lw, row0, H, t0, T, tid);
  cp_async_commit();
  if (tensor_warp) {
    load_rows<N, 32 * TW>(s.v, v, row0, H, t0, T, tid);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  if (tid < N) s.u[tid] = u[(int64_t)h * N + tid];
  __syncthreads();

  // -- logP (inclusive, from the chunk's start) and w = exp(logw): thread
  //    (c, seg) over its own 16 elements, the earlier sub-blocks' totals
  //    added in order
  {
    const int c = tid % N, seg = tid / N;
    float lpl[L];
    if (seg < NSB) {
#pragma unroll
      for (int m = 0; m < L; ++m) s.w[seg * L + m][c] = __expf(s.lp[seg * L + m][c]);
      local_cumsum(s.lp, s.part, c, seg, lpl);
    }
    __syncthreads();
    if (seg < NSB) {
      float off = 0.f;
      for (int j = 0; j < seg; ++j) off += s.part[j][c];
#pragma unroll
      for (int m = 0; m < L; ++m) s.lp[seg * L + m][c] = lpl[m] + off;
    }
  }
  __syncthreads();

  constexpr int NTL = N / 8;                     // n-tiles of y's columns
  const int ta = warp * 16 + g, tb = ta + 8;     // a tensor-core warp's rows
  float acc[NTL][4];
  if (tensor_warp) {
    // -- scores of sub-block pairs j < i: pairs (1,0) (2,0) (2,1) (3,0)
    //    (3,1) (3,2) in turn over the tensor-core warps
    constexpr int NPAIR = NSB * (NSB - 1) / 2;
    for (int pair = warp; pair < NPAIR; pair += TW) {
      const int pi = pair < 1 ? 1 : pair < 3 ? 2 : 3;
      const int pj = pair - (pi * (pi - 1)) / 2;
      const int ra = pi * L + g, rb = ra + 8, e = pj * L + L - 1;
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 8; ++ks) {
        const int c0 = ks * 8 + q, c1 = c0 + 4;
        const float e0 = s.lp[e][c0], e1 = s.lp[e][c1];
        uint32_t ahi[4], alo[4];
        // r_t exp(logP_{t-1} - logP_e): t - 1 >= e
        split_tf32(bf(s.r[ra][c0]) * __expf(s.lp[ra - 1][c0] - e0), ahi[0], alo[0]);
        split_tf32(bf(s.r[rb][c0]) * __expf(s.lp[rb - 1][c0] - e0), ahi[1], alo[1]);
        split_tf32(bf(s.r[ra][c1]) * __expf(s.lp[ra - 1][c1] - e1), ahi[2], alo[2]);
        split_tf32(bf(s.r[rb][c1]) * __expf(s.lp[rb - 1][c1] - e1), ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // k_s exp(logP_e - logP_s): s <= e
          const int cs = pj * L + nt * 8 + g;
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32(bf(s.k[cs][c0]) * __expf(e0 - s.lp[cs][c0]), b0h, b0l);
          split_tf32(bf(s.k[cs][c1]) * __expf(e1 - s.lp[cs][c1]), b1h, b1l);
          mma(sc[nt], alo, b0h, b1h);
          mma(sc[nt], ahi, b0l, b1l);
          mma(sc[nt], ahi, b0h, b1h);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = pj * L + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(&s.A[ra][col]) = make_float2(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<float2*>(&s.A[rb][col]) = make_float2(sc[nt][2], sc[nt][3]);
      }
    }
    pdl_wait();                         // passes 1 and 2 are done
    {
      const float* src = Sc + (((int64_t)b * H + h) * NC + ch) * N * N;
      for (int p = tid; p < N * N / 4; p += 32 * TW) {
        const int i = p / (N / 4), e = (p % (N / 4)) * 4;
        cp_async16(&s.S_lo[i * N + e], src + i * N + e, true);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * TW));   // v and S_c landed
    // S_c split into TF32 hi + lo, rewritten K-major with the swizzle
    {
      constexpr int PER = N * N / (32 * TW);
      float x[PER];
#pragma unroll
      for (int e = 0; e < PER; ++e) x[e] = s.S_lo[tid + e * 32 * TW];
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * TW));
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int p = tid + e * 32 * TW;
        const uint32_t off = sw128_offset<N>(p / N, p % N);
        uint32_t hi, lo;
        split_tf32(x[e], hi, lo);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(s.S_hi) + off) = hi;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(s.S_lo) + off) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(32 * TW));
    }

    // -- y = (r_t exp(logP_{t-1})) S_c on wgmma, the four tensor-core warps
    //    one warpgroup of 64 rows: per k-step lo * S_hi + hi * S_lo + hi *
    //    S_hi, A from registers in batches of two k-steps, two batches in
    //    flight
    const uint32_t bhi = smem_addr(s.S_hi), blo = smem_addr(s.S_lo);
    constexpr int KS = N / 8;
    uint32_t ahi[2][2][4], alo[2][2][4];
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 2) {
      const int set = (k0 / 2) % 2;
      if (k0 >= 4) {                       // the batch that held this set is done
        wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          fence_regs(ahi[set][kk]);
          fence_regs(alo[set][kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c0 = (k0 + kk) * 8 + q, c1 = c0 + 4;
        const float pa0 = ta ? s.lp[ta - 1][c0] : 0.f, pa1 = ta ? s.lp[ta - 1][c1] : 0.f;
        split_tf32(bf(s.r[ta][c0]) * __expf(pa0), ahi[set][kk][0], alo[set][kk][0]);
        split_tf32(bf(s.r[tb][c0]) * __expf(s.lp[tb - 1][c0]), ahi[set][kk][1], alo[set][kk][1]);
        split_tf32(bf(s.r[ta][c1]) * __expf(pa1), ahi[set][kk][2], alo[set][kk][2]);
        split_tf32(bf(s.r[tb][c1]) * __expf(s.lp[tb - 1][c1]), ahi[set][kk][3], alo[set][kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = k0 + kk;
        const uint32_t off = (ks / 4) * (N * 128) + (ks % 4) * 32;
        wgmma_tf32<N>(acc, alo[set][kk], desc_sw128(bhi + off), ks > 0);
        wgmma_tf32<N>(acc, ahi[set][kk], desc_sw128(blo + off), 1);
        wgmma_tf32<N>(acc, ahi[set][kk], desc_sw128(bhi + off), 1);
      }
      wgmma_commit();
    }

    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        fence_regs(ahi[st][kk]);
        fence_regs(alo[st][kk]);
      }
  } else {
    // -- the diagonal sub-blocks, direct in fp32: warp 4 + d takes
    //    sub-block d.  A lane holds four columns s of it, {g, 7 - g, 8 + g,
    //    15 - g} for g = lane / 8 (30 (t, s) pairs), and an eighth of the
    //    channels; each step t's r_t and w_t serve all four, and the eighths
    //    are summed by shuffles in a fixed order
    constexpr int NE = N / 8;
    const int d = warp - TW, gq = lane / 8, e8 = lane % 8, c0 = e8 * NE;
    const int sl[4] = {gq, 7 - gq, 8 + gq, 15 - gq};
    float kw[4][NE], rr[NE], ww[NE], diag[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      load_bf<NE>(&s.k[d * L + sl[j]][c0], kw[j]);
      load_bf<NE>(&s.r[d * L + sl[j]][c0], rr);
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < NE; ++m) a = fmaf(rr[m] * s.u[c0 + m], kw[j][m], a);
      diag[j] = a;
    }
#pragma unroll
    for (int o = 1; o < 8; o *= 2)
#pragma unroll
      for (int j = 0; j < 4; ++j) diag[j] += __shfl_xor_sync(0xffffffffu, diag[j], o);
#pragma unroll 1
    for (int t = 0; t < L; ++t) {
      load_bf<NE>(&s.r[d * L + t][c0], rr);
      load_f<NE>(&s.w[d * L + t][c0], ww);
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // kw = k_s prod_{s < m < t} w_m
        a[j] = 0.f;
        if (t > sl[j]) {
#pragma unroll
          for (int m = 0; m < NE; ++m) {
            a[j] = fmaf(rr[m], kw[j][m], a[j]);
            kw[j][m] *= ww[m];
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o *= 2)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
      if (e8 == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.A[d * L + t][d * L + sl[j]] = t == sl[j] ? diag[j] : a[j];
      }
    }
  }
  __syncthreads();          // every score written
  if (!tensor_warp) return;

  // -- y += A v over the sub-blocks up to this warp's own
  for (int ks = 0; ks < (warp + 1) * (L / 8); ++ks) {
    const int s0 = ks * 8 + q, s1 = s0 + 4;
    uint32_t ahi[4], alo[4];
    split_tf32(s.A[ta][s0], ahi[0], alo[0]);
    split_tf32(s.A[tb][s0], ahi[1], alo[1]);
    split_tf32(s.A[ta][s1], ahi[2], alo[2]);
    split_tf32(s.A[tb][s1], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int col = j * 8 + g;
      const uint32_t b0 = __float_as_uint(bf(s.v[s0][col]));
      const uint32_t b1 = __float_as_uint(bf(s.v[s1][col]));
      mma(acc[j], alo, b0, b1);
      mma(acc[j], ahi, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
    const int col = j * 8 + 2 * q;
    if (t0 + ta < T)
      *reinterpret_cast<float2*>(&y[(row0 + (int64_t)(t0 + ta) * H) * N + col]) =
          make_float2(acc[j][0], acc[j][1]);
    if (t0 + tb < T)
      *reinterpret_cast<float2*>(&y[(row0 + (int64_t)(t0 + tb) * H) * N + col]) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

int64_t scratch_floats(int B, int T, int H, int N) {
  const int64_t nc = (T + Q - 1) / Q;
  return (int64_t)B * H * nc * ((int64_t)N * N + N);
}

template <int N>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* lw,
                           const void* u, const void* S0, void* y, void* S, void* scratch,
                           int B, int T, int H, cudaStream_t st) {
  const int NC = (T + Q - 1) / Q;
  float* dS = static_cast<float*>(scratch);
  float* D = dS + (int64_t)B * H * NC * N * N;
  const bf16 *rb = static_cast<const bf16*>(r), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const float* lwf = static_cast<const float*>(lw);
  const dim3 grid(NC, H, B);
  const size_t smem1 = sizeof(StateSmem<N>), smem3 = sizeof(OutSmem<N>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_state_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_chunk_out_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  wkv6_chunk_state_kernel<N><<<grid, CT, smem1, st>>>(kb, vb, lwf, dS, D, T, H, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(N * N / 4 / SCAN_T, H, B);
  cfg.blockDim = dim3(SCAN_T);
  err = cudaLaunchKernelEx(&cfg, wkv6_chunk_scan_kernel<N>, static_cast<const float*>(S0),
                           dS, static_cast<const float*>(D), static_cast<float*>(S), H, NC);
  if (err != cudaSuccess) return err;
  last_launch[0] = CT;
  last_launch[1] = Q;
  last_launch[2] = (int)smem3;
  last_launch[3] = (int)(grid.x * grid.y * grid.z);
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = smem3;
  return cudaLaunchKernelEx(&cfg, wkv6_chunk_out_kernel<N>, rb, kb, vb, lwf,
                            static_cast<const float*>(u), static_cast<const float*>(dS),
                            static_cast<float*>(y), T, H, NC);
}

// ---------------------------------------------------------------------------
// The step route
// ---------------------------------------------------------------------------

template <int N>
struct StepCfg {
  static constexpr int TPR = N / 4;               // threads a row, a float4 each
  static constexpr int R = N == 16 ? 2 : 4;       // rows a thread
  static constexpr int NT = TPR * (N / R);        // 256, 64, 32
  static constexpr int NW = NT / 32;
  static_assert(NT % 32 == 0 && TPR <= 16, "thread layout");
};

template <int N>
__global__ void __launch_bounds__(StepCfg<N>::NT)
wkv6_step_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* S0, float* __restrict__ y,
                 float* S, int T, int H) {
  using C = StepCfg<N>;
  constexpr int R = C::R;
  __shared__ __align__(16) float ypart[2][C::NW][N];
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int j0 = (tid % C::TPR) * 4, i0 = (tid / C::TPR) * R;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t sbase = ((int64_t)b * H + h) * N * N;
  const int64_t row0 = (int64_t)b * T * H + h;

  float4 st[R];
  float uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m)
    st[m] = *reinterpret_cast<const float4*>(S0 + sbase + (int64_t)(i0 + m) * N + j0);
  load_f<R>(u + (int64_t)h * N + i0, uu);
  // a step's rows of r, k, logw and columns of v: one vector load each
  float rr[R], kk[R], ww[R], vv[4];
  auto load_step = [&](int t) {
    const int64_t off = (row0 + (int64_t)t * H) * N;
    load_bf<R>(r + off + i0, rr);
    load_bf<R>(k + off + i0, kk);
    load_f<R>(lw + off + i0, ww);
#pragma unroll
    for (int m = 0; m < R; ++m) ww[m] = expf(ww[m]);
    load_bf<4>(v + off + j0, vv);
  };
  load_step(0);
  for (int t = 0; t < T; ++t) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < R; ++m) {
      float* sm = reinterpret_cast<float*>(&st[m]);
      const float uk = uu[m] * kk[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = fmaf(rr[m], fmaf(uk, vv[j], sm[j]), p[j]);
        sm[j] = fmaf(ww[m], sm[j], kk[m] * vv[j]);
      }
    }
    if (t + 1 < T) load_step(t + 1);
#pragma unroll
    for (int off = C::TPR; off < 32; off *= 2)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] += __shfl_xor_sync(0xffffffffu, p[j], off);
    if (lane < C::TPR)
      *reinterpret_cast<float4*>(&ypart[t & 1][warp][j0]) = make_float4(p[0], p[1], p[2], p[3]);
    __syncthreads();
    if (tid < N / 4) {
      float4 a = *reinterpret_cast<const float4*>(&ypart[t & 1][0][tid * 4]);
#pragma unroll
      for (int w = 1; w < C::NW; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(&ypart[t & 1][w][tid * 4]);
        a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      }
      *reinterpret_cast<float4*>(&y[(row0 + (int64_t)t * H) * N + tid * 4]) = a;
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
    *reinterpret_cast<float4*>(S + sbase + (int64_t)(i0 + m) * N + j0) = st[m];
}

template <int N>
cudaError_t launch_step(const void* r, const void* k, const void* v, const void* lw,
                        const void* u, const void* S0, void* y, void* S, int B, int T, int H,
                        cudaStream_t st) {
  const dim3 grid(H, B);
  last_launch[0] = StepCfg<N>::NT;
  last_launch[1] = 0;
  last_launch[2] = 0;
  last_launch[3] = H * B;
  wkv6_step_kernel<N><<<grid, StepCfg<N>::NT, 0, st>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u),
      static_cast<const float*>(S0), static_cast<float*>(y), static_cast<float*>(S), T, H);
  return cudaGetLastError();
}

bool bad_shape(int B, int T, int H) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1;
}

}  // namespace

extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* S0, void* y, void* S, int B, int T,
                              int H, int N, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch_step<16>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    case 32: err = launch_step<32>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    case 64: err = launch_step<64>(r, k, v, logw, u, S0, y, S, B, T, H, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" int repro_wkv6_fwd_chunked(const void* r, const void* k, const void* v,
                                      const void* logw, const void* u, const void* S0,
                                      void* y, void* S, void* scratch, int B, int T, int H,
                                      int N, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch_chunked<16>(r, k, v, logw, u, S0, y, S, scratch, B, T, H, st); break;
    case 32: err = launch_chunked<32>(r, k, v, logw, u, S0, y, S, scratch, B, T, H, st); break;
    case 64: err = launch_chunked<64>(r, k, v, logw, u, S0, y, S, scratch, B, T, H, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" long long repro_wkv6_scratch_bytes(int B, int T, int H, int N) {
  return 4 * scratch_floats(B, T, H, N);
}

extern "C" int repro_wkv6_chunked_min_t() { return CHUNKED_MIN_T; }

extern "C" void repro_wkv6_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
