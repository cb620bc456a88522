// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py:flash_attention_kernel
// (body _fa_kernel).  It computes what that kernel computes — online-softmax
// attention with fp32 statistics and accumulator, GQA (q head h reads kv head
// h / (H/KH); KV is never repeated), causal masking with top-left alignment,
// kv tiles above the diagonal skipped, ragged Sq / Sk masked in-kernel, hd_v
// allowed to differ from hd (each bucketed to 64, 128 or 256), on the model's
// strided layout — but not its block structure.
//
// What bounds it on this card: at the serving paths' shapes, latency.  At
// (1, 16, 512, 128) causal, q + k + v + o are 8.4 MB (2.5 us at 3.35 TB/s)
// and the causal products 1.1 us at 989 TFLOP/s; at jamba-1.5-large's
// (1, 64 q heads over 8 kv heads, 512, 128) 18.9 MB (5.6 us).  What costs
// is the serial walk of the longest causal q tile over its kv tiles.
//
// What held the first design back, on an H100 80GB HBM3 at 700 W as
// chip_smoke.py timed it (0.05161 ms at (1,16,512,128) against SDPA's
// 0.02897, 0.06742 against 0.03862 at jamba's shape): each kv tile went
// global -> registers -> shared and through a __syncthreads before any math, so no
// load overlapped the math and each of the longest tile's 8 steps paid a
// full load latency; K fragments came from scalar 32-bit shared loads and V
// fragments from four 16-bit loads and a pack an mma; and 128 blocks of 4
// warps on 132 SMs left nothing to hide latency behind.
//
// This design (timed on an H100 80GB HBM3 at 700 W by chip_smoke.py;
// PERF.md has the numbers):
//
// * one block per (b, h, 64-row q tile).  The blocks start longest causal
//   walk first across all heads (heads vary fastest in the grid, q tiles
//   from the last), so the longest walks do not start last;
// * two block shapes, chosen at launch.  While there are no more q tiles
//   than SMs, each block has two warpgroups that split the tile's kv tiles
//   between them — warpgroup 0 the even ones, warpgroup 1 the odd — so the
//   longest walk is half as long; at the end warpgroup 1 hands its (max,
//   denominator, accumulator) to warpgroup 0 through shared memory, which
//   merges them in that fixed order.  Past that, a block is one warpgroup
//   and two blocks share an SM;
// * TMA into an mbarrier ring of K / V tiles a warpgroup (3 stages with two
//   warpgroups, 2 with one): 4-D tensor maps over the model's strided
//   layout (d, position, head, batch), zero-filled past Sk, hd and hd_v, so
//   no thread spends an instruction on a load or a mask of the ragged edge.
//   Q is loaded once.  Tiles land in wgmma's 128-byte swizzle (64-column
//   blocks of rows x 128 bytes);
// * both products run on the tensor cores through wgmma (bf16 in, fp32
//   accumulate), a warpgroup at a time: S = Q·Kᵀ with Q and K read from
//   shared memory (K-major), O += P·V with P from registers — the score
//   accumulators re-packed to bf16 are exactly wgmma's A fragment, so P
//   never touches shared memory — and V read MN-major (d contiguous: the
//   transpose bit).  An mma.sync version of this pipeline (a cp.async ring
//   each warpgroup, ldmatrix for Q, K and V) was slower on the card;
// * no ordinary instruction writes a register that an asynchronous product
//   owns: the first product of S and of O ignores what the accumulator holds
//   (scale-d 0) instead of zeroing it, or ptxas serializes the products.
//
// Deterministic: no atomics, and every sum is taken in a fixed order.
//
// For training, the launch may also write the natural-log logsumexp of each
// row's scaled, masked scores, fp32 (B, H, Sq), which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from: warpgroup 0
// writes it after the merge, one lane a row.  Serving passes a null pointer.
//
// C interface (loaded with ctypes): repro_flash_attention_fwd_bf16 returns a
// cudaError_t (0 on success).  Strides are in elements and multiples of 8
// (TMA takes 16-byte strides).  The tensor maps are encoded on the host at
// each call, through cuTensorMapEncodeTiled from cudaGetDriverEntryPoint, so
// the library needs no -lcuda; the device of q is made current first, as
// the encoder needs the context on the calling thread.  The mbarrier,
// TMA and wgmma helpers are in hopper.cuh, shared with the backward.

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;       // q rows per block: 4 warps x 16 rows

// Shared memory, from a 1024-aligned base: the Q tile, then each warpgroup's
// ring of STAGES K / V tiles, then the barriers.  Every tile is in wgmma's
// 128-byte swizzle as TMA writes it: 64-column blocks of rows x 128 bytes.
// With two warpgroups, warpgroup 1's ring also carries its hand-over.
template <int DQK, int DV, int NWG>
struct Cfg {
  static constexpr int BK = (DQK + DV > 256) ? 32 : 64;  // kv rows per tile
  static constexpr int STAGES = NWG == 2 ? 3 : 2;  // one block an SM, or two
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;
  static constexpr int STAGE_BYTES = K_BYTES + BK * DV * 2;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // warpgroup 1's hand-over: the accumulator and (m, l) of two rows a thread
  static constexpr int MERGE_BYTES = (DV / 2 + 4) * 128 * 4;
  static constexpr int WG1_BYTES = RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES;
  static constexpr int BARS = Q_BYTES + RING_BYTES + (NWG == 2 ? WG1_BYTES : 0);
  static constexpr size_t SMEM = 1024 + (size_t)BARS + 8 * (1 + NWG * STAGES);
};

template <int DQK, int DV, int NWG>
__global__ void __launch_bounds__(NWG * 128, NWG == 1 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int group, int Sq, int Sk, int hd_v, long long sob,
                 long long soh, long long sos, float scale_log2, int causal) {
  using K_ = Cfg<DQK, DV, NWG>;
  constexpr int BK = K_::BK, STAGES = K_::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t Qs = (raw + 1023u) & ~1023u;  // swizzled tiles start 1024-aligned
  const int wg = NWG == 1 ? 0 : threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const uint32_t ring = Qs + K_::Q_BYTES + wg * K_::RING_BYTES;
  const uint32_t qbar = Qs + K_::BARS;
  auto full = [&](int s) { return qbar + 8u * (1 + wg * STAGES + s); };

  // Heads vary fastest and the last q tiles (the longest causal walks) come
  // first, so the blocks start longest first across all heads.
  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;                   // GQA head map
  const int q0 = qt * BQ;
  const int warp = (threadIdx.x / 32) % 4;    // this warp's 16 rows of the tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                     // rows g and g + 8 of the warp's 16
  const int t = lane % 4;                     // column pair

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) {  // skip kv tiles entirely above the diagonal (top-left aligned)
    const int q_last = min(q0 + BQ, Sq) - 1;
    n_kv = min(n_kv, q_last / BK + 1);
  }
  const int n_mine = (n_kv - wg + NWG - 1) / NWG;  // kv tiles wg, wg + NWG, ...

  // This warpgroup's i-th kv tile into ring slot i % STAGES, by one thread:
  // K and V in 64-column boxes, zero-filled past Sk, hd and hd_v.
  auto load_kv = [&](int i) {
    const int k0 = (NWG * i + wg) * BK;
    const uint32_t st = ring + (i % STAGES) * K_::STAGE_BYTES;
    mbar_expect_tx(full(i % STAGES), K_::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c)
      tma_load_4d(st + c * BK * 128, &tmk, full(i % STAGES), c * 64, k0, kh, b);
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
      tma_load_4d(st + K_::K_BYTES + c * BK * 128, &tmv, full(i % STAGES), c * 64, k0, kh, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NWG * STAGES; ++s) mbar_init(qbar + 8u * (1 + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q and each warpgroup's first kv tiles in flight together.
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, K_::Q_BYTES);
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c) tma_load_4d(Qs + c * BQ * 128, &tmq, qbar, c * 64, q0, h, b);
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      if (i < n_mine) load_kv(i);
  }
  mbar_wait(qbar, 0);

  // acc holds nothing until the first P·V, which ignores it (scale-d 0): no
  // ordinary instruction defines a register an asynchronous product owns
  // (ptxas would serialize the products).
  float acc[DV / 8][4];
  uint32_t pa[BK / 16][4];
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 domain) of rows g, g+8
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominators
  const int row0 = q0 + warp * 16 + g;

  for (int i = 0; i < n_mine; ++i) {
    wgmma_wait<0>();                    // this warp's P·V of tile i - 1 is done
    fence_regs(acc);
    named_sync(1 + wg, 128);            // ... every warp's: tile i - 1's slot is free
    if (tid == 0 && i + STAGES - 1 < n_mine) load_kv(i + STAGES - 1);
    mbar_wait(full(i % STAGES), (i / STAGES) & 1);  // tile i has landed
    const int k0 = (NWG * i + wg) * BK;
    const uint32_t Ks = ring + (i % STAGES) * K_::STAGE_BYTES;
    const uint32_t Vs = Ks + K_::K_BYTES;

    // S = Q Kᵀ: 64 q rows x BK kv columns, 16 d a step (the first ignores s).
    float s[BK / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss<BK>(s, desc_sw128(Qs + (kk / 4) * (BQ * 128) + (kk % 4) * 32, 16),
                   desc_sw128(Ks + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Scale into the log2 domain, mask padding and the causal upper triangle:
    // s[nt][e] is row row0 + 8 (e / 2), column k0 + 8 nt + 2 t + e % 2, kept
    // if that column is below the row's limit.
    float mx[2] = {-INFINITY, -INFINITY};
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lim[r] = (causal ? min(row0 + 8 * r + 1, Sk) : Sk) - (k0 + t * 2);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (nt * 8 + (e & 1) >= lim[e >> 1]) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // Online softmax: the four lanes of a row group share each row.
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = (m_new == -INFINITY) ? 0.f : m_new;  // fully masked so far
      const float corr = ex2(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
    // P, packed to bf16: the score accumulators of n-tiles 2j, 2j+1 are
    // exactly the register A fragment of k-step j.
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = ex2(s[nt][e] - base[e >> 1]);
        l[e >> 1] += pv[e];
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_f32(pv[0], pv[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_f32(pv[2], pv[3]);
    }

    // O += P V, 16 kv rows a step; V is MN-major (d contiguous).
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_rs<DV>(acc, pa[j], desc_sw128(Vs + j * 2048, BK * 128), i > 0 || j > 0);
    wgmma_commit();
    fence_regs(pa);
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n_mine == 0) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  // Full row denominators of this warpgroup's share.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (NWG == 2) {
    // Warpgroup 1 hands its state to warpgroup 0 through its own ring's
    // memory; warpgroup 0 merges its share first, then 1's.
    float* mg =
        reinterpret_cast<float*>(smem_raw + (Qs - raw) + K_::Q_BYTES + K_::RING_BYTES);
    if (wg == 1) {
      named_sync(2, 128);               // every warp of warpgroup 1 is done with its ring
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mg[(j * 4 + e) * 128 + tid] = acc[j][e];
      mg[(DV / 2 + 0) * 128 + tid] = m[0];
      mg[(DV / 2 + 1) * 128 + tid] = m[1];
      mg[(DV / 2 + 2) * 128 + tid] = l[0];
      mg[(DV / 2 + 3) * 128 + tid] = l[1];
    }
    __syncthreads();
    if (wg == 1) return;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = mg[(DV / 2 + r) * 128 + tid];
      const float l1 = mg[(DV / 2 + 2 + r) * 128 + tid];
      const float m_new = fmaxf(m[r], m1);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      c0[r] = ex2(m[r] - base);
      c1[r] = ex2(m1 - base);
      l[r] = l[r] * c0[r] + l1 * c1[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * c0[e >> 1] + mg[(j * 4 + e) * 128 + tid] * c1[e >> 1];
  }

  // Divide, write rows < Sq and columns < hd_v.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-20f);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * sob + h * soh + row * sos;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const int col = nt * 8 + t * 2;
      if (col < hd_v)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_f32(acc[nt][2 * r] / denom, acc[nt][2 * r + 1] / denom);
    }
  }
  // The natural-log logsumexp of each row's scaled, masked scores, for the
  // backward: the row's max and denominator are in the log2 domain, and
  // the four lanes of a row group hold the same pair after the merge.
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float base = (m[r] == -INFINITY) ? 0.f : m[r];
      lse[((long long)b * gridDim.x + h) * Sq + row] = (base + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

// The configuration of the last launch, for a report: warpgroups a block,
// K / V ring stages a warpgroup, dynamic shared memory in bytes, blocks.
int last_launch[4];

template <int DQK, int DV, int NWG>
cudaError_t launch_nwg(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int KH, int Sq, int Sk, int hd, int hd_v,
                       const long long* st, float scale_log2, int causal,
                       cudaStream_t stream) {
  using K_ = Cfg<DQK, DV, NWG>;
  CUtensorMap tmq, tmk, tmv;
  if (!encode_4d(&tmq, q, hd, Sq, H, B, st[2], st[1], st[0], BQ) ||
      !encode_4d(&tmk, k, hd, Sk, KH, B, st[5], st[4], st[3], K_::BK) ||
      !encode_4d(&tmv, v, hd_v, Sk, KH, B, st[8], st[7], st[6], K_::BK))
    return cudaErrorInvalidValue;
  const size_t smem = K_::SMEM;
  auto kern = flash_fwd_kernel<DQK, DV, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  last_launch[0] = NWG;
  last_launch[1] = K_::STAGES;
  last_launch[2] = (int)smem;
  last_launch[3] = (int)(grid.x * grid.y * grid.z);
  kern<<<grid, NWG * 128, smem, stream>>>(tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), lse,
                                          H / KH, Sq, Sk, hd_v, st[9], st[10], st[11],
                                          scale_log2, causal);
  return cudaGetLastError();
}

// Two warpgroups splitting each q tile's kv tiles while there are no more q
// tiles than SMs (the longest tile's walk is the time); one warpgroup a
// block, two blocks an SM, once there are more.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int KH, int Sq, int Sk, int hd, int hd_v,
                   const long long* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long tiles = (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (tiles <= n_sm)
    return launch_nwg<DQK, DV, 2>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2,
                                  causal, stream);
  return launch_nwg<DQK, DV, 1>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2,
                                causal, stream);
}

template <int DQK>
cudaError_t dispatch_dv(int dv, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int KH, int Sq, int Sk, int hd, int hd_v,
                        const long long* st, float scale_log2, int causal,
                        cudaStream_t stream) {
  switch (dv) {
    case 64:
      return launch<DQK, 64>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
    case 128:
      return launch<DQK, 128>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
    default:
      return launch<DQK, 256>(q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, stream);
  }
}

int bucket(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

}  // namespace

extern "C" int repro_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KH, int Sq,
    int Sk, int hd, int hd_v, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sob, long long soh, long long sos, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 || hd < 8 ||
      hd > 256 || hd % 8 != 0 || hd_v < 8 || hd_v > 256 || hd_v % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos};
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cudaError_t bound = use_device_of(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bucket(hd)) {
    case 64:
      err = dispatch_dv<64>(bucket(hd_v), q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
    case 128:
      err = dispatch_dv<128>(bucket(hd_v), q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
    default:
      err = dispatch_dv<256>(bucket(hd_v), q, k, v, o, lse, B, H, KH, Sq, Sk, hd, hd_v, st, scale_log2, causal, s);
      break;
  }
  return static_cast<int>(err);
}

extern "C" void repro_flash_attention_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
