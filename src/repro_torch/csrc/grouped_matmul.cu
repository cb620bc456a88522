// Grouped (per-expert) matmul for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py:grouped_matmul_kernel
// (body _gmm_kernel).  It computes what that kernel computes — for every
// expert e, out[e] = x[e] (C, D) @ w[e] (D, F), fp32 accumulation, one
// rounding to bf16 at the end — and, like it, runs every expert, including
// experts that hold no token.
//
// What bounds it on this card: device memory, at every shape of the serving
// paths.  The expert weights are most of the bytes — 6.4 GB a launch at
// jamba-1.5-large (E 16, D / F 8192 / 24576: 1.93-1.95 ms at 3.35 TB/s),
// 268 MB at olmoe-1b-7b (E 64, D / F 2048 / 1024: 0.084-0.090 ms) — against
// tensor work of at most 0.52 ms (jamba, C = 80) at 989 TFLOP/s.
//
// What held the first design back, on an H100 80GB HBM3 at 700 W as
// chip_smoke.py timed it: each block owned a fixed 64-row C tile, so at C = 80
// two tiles read every weight element from device memory — a jamba prefill
// launch took 4.07-4.53 ms against the 2.22-2.31 ms of a decode launch
// (C = 32) over the same weights, and torch.bmm's 2.05-2.07 ms; at C = 32
// half of each 64-row mma.sync tile was padding; and all 128 threads spent
// instructions on address math and 16-byte cp.async copies into a ring of
// 4 x 14 KB, which reached about 87% of the memory rate at decode.
//
// This design:
//
// * the operands are swapped: the kernel computes out[e]^T = w[e]^T x[e]^T
//   with wgmma, so F — the large dimension — is the 64-row M of the
//   tensor-core product and C its N.  A is a 64 F x 16 D tile of w read
//   from shared memory through a descriptor, MN-major (w is (D, F), F
//   contiguous: the transpose bit); B is x's rows, K-major.  C pads to a
//   multiple of 16 (NCH 16-row chunks, a template parameter), not to 64;
// * every weight byte leaves device memory once, whatever C is: a tile is
//   (expert, F strip, all of D, up to 256 C rows); one m64nNk16 instruction
//   a 16-deep step multiplies a 64-row weight tile by all N = 16 NCH rows of
//   the pass while the stage sits in shared memory, so each weight element
//   is also read from shared memory once.  Only C > 256 takes a second pass
//   over the weights.  A consumer warpgroup owns two 64-row F tiles while
//   their accumulators fit in registers (NCH <= 8: a 256-column strip), one
//   past that (128 columns): the wider strip halves how often x's rows are
//   re-read from L2, which at jamba's prefill (C = 80) came to 4 GB a launch
//   at 128 columns, beside the 6.4 GB of weights;
// * TMA into an mbarrier ring: 3-D tensor maps over x (E, C, D) and
//   w (E, D, F), 128-byte swizzled, zero-filled by the hardware past C, D
//   and F, so nothing is masked on load.  One producer warp keeps the ring
//   full; two consumer warpgroups run wgmma and release each stage as soon
//   as the products that read it are done.  The ring takes as many stages
//   as fit beside the epilogue's buffer (4 of 42 KB at C = 80, 5 of 36 KB at
//   C = 32: 128-160 KB of weights in flight an SM);
// * persistent: one block an SM walks the (expert, C pass, F strip) tiles,
//   so one tile's epilogue overlaps the next tile's loads, and neighbouring
//   blocks work on neighbouring strips of one expert (x[e] stays in L2);
// * epilogue: one rounding to bf16 of the fp32 sums, transposed through
//   shared memory, out's rows written 16 bytes a thread; rows >= C and
//   columns >= F masked.
//
// Deterministic, and the same bits for a row wherever it sits: no split-K
// and no atomics; every output element is summed over D in the same order
// (16 at a time, 64 a stage), whatever C is, whatever N the instruction has
// and whichever column of it the row lands in, and whatever the other rows
// hold — the card tests hold a row's bits across C = 70 / 8 (N 80 / 16) and
// C = 80 / 32 (N 80 / 32).  A token's expert output is therefore
// bit-identical whichever serving slot and capacity row it lands in, which
// crash-resume rests on.
//
// The backward (no TPU kernel: the reference differentiates its einsum with
// jax.grad), for olmoe-1b-7b's training, bf16 in and out after one rounding
// of fp32 sums, deterministic as the forward:
//
// * dx[e] (C, D) = dy[e] (C, F) w[e]^T is the forward's kernel with D and F
//   swapped and w's tile read K-major (the WK template argument): the TMA
//   box over w takes 64 F x 64 D at (k step, D strip) instead of (F strip,
//   k step), and the A descriptor steps 32 bytes along a 128-byte row with
//   the transpose bit off.  The forward's instructions are unchanged;
// * dw[e] (D, F) = x[e]^T (D, C) dy[e] (C, F) contracts over the capacity
//   rows C: gmm_dw_kernel, persistent like the forward, one producer warp
//   and two consumer warpgroups, a tile 128 D x 256 F; a stage holds 64 C
//   rows of both operands and each warpgroup issues m64n256k16 with A
//   (x) and B (dy) MN-major.  Every output element sums over C in order,
//   64 rows a stage, with no split and no atomics, so a crash-recovered run
//   retraces a clean one bit for bit; capacity rows that hold no token are
//   zeros and add nothing, rows past C are zero-filled by TMA.
//
// At olmoe's training shapes (E 64, C 640, D / F 2048 / 1024 and back) each
// moves 520 MB and does 172 GFLOP: 0.174 ms at 989 TFLOP/s, operations.
// That is what bounds them; this first design sits at 2.3-2.7x it (the
// third 256-row pass of dx is half padding, and dw stores 4 bytes a
// thread from registers), PERF.md has the times.
//
// C interface (loaded with ctypes): repro_grouped_matmul_bf16 (out = x w),
// repro_grouped_matmul_dx_bf16 (dx = dy w^T) and repro_grouped_matmul_dw_bf16
// (dw = x^T dy) return a cudaError_t (0 on success).  x (E, C, D), w (E, D,
// F), out and dy (E, C, F), dx (E, C, D) and dw (E, D, F) are contiguous and
// 16-byte aligned; D and F are multiples of 8 (TMA takes 16-byte strides).  The tensor maps are encoded on the host at each call,
// through cuTensorMapEncodeTiled from cudaGetDriverEntryPoint, so the
// library needs no -lcuda, after the device that holds the first operand is
// made current on the calling thread (use_device_of): the encoder fails on a
// thread that has made no CUDA call of its own, and autograd runs the
// backward on a thread of its own.  The mbarrier, wgmma-fence and
// tensor-map helpers are hopper.cuh's, shared with flash attention.

#include "hopper.cuh"

namespace {

constexpr int BD = 64;                  // D depth a stage: one 128-byte row
constexpr int CH = 16;                  // C rows a chunk (N = 16 NCH)
constexpr int MAX_NCH = 16;             // at most 256 C rows a pass
constexpr int MAX_STAGES = 8;
constexpr int NCONSUMER = 256;          // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 32;  // and one producer warp
constexpr int W_BOX_BYTES = 64 * BD * 2;  // a 64 F x 64 D box of w: 8 KB
constexpr int SMEM_BUDGET = 227 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// ---- TMA -------------------------------------------------------------------
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle.  K-major (x): rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO).  MN-major (w): each 128-byte
// row holds 64 consecutive F of one D; groups of 8 D rows are 1024 bytes
// apart (SBO); LBO, the stride between 64-wide F groups, is unused at M = 64.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;             // LBO (unused), 16 bytes
  d |= static_cast<uint64_t>(1024 >> 4) << 32;     // SBO
  d |= static_cast<uint64_t>(1) << 62;             // 128-byte swizzle
  return d;
}
// d (64 F x N C, fp32) += A (64 F x 16 D, MN-major: the transpose bit)
//                        * B (16 D x N C, K-major), N = 16 NCH.  One
// instruction a 16-deep step for all of a pass's C rows, so each weight
// element is read from shared memory once a pass.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n80(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// A is w's tile: MN-major in the forward (TA 1), K-major in dx (TA 0).
template <int NCH, int TA>
__device__ __forceinline__ void wgmma_tile(float (&d)[NCH * 8], uint64_t da, uint64_t db) {
  if constexpr (NCH == 1) wgmma_n16<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 2) wgmma_n32<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 3) wgmma_n48<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 4) wgmma_n64<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 5) wgmma_n80<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 6) wgmma_n96<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 8) wgmma_n128<TA, 0>(d, da, db, 1);
  else if constexpr (NCH == 12) wgmma_n192<TA, 0>(d, da, db, 1);
  else wgmma_n256<TA, 0>(d, da, db, 1);
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// A tile's F strip is 2 MT boxes of 64 columns: MT 64-row wgmma M tiles a
// consumer warpgroup, two while the accumulators of both fit in registers.
// Shared memory, from a 1024-aligned base: `stages` ring slots of
// [2 MT w boxes of 64 F x 64 D | x box of NCH*16 rows x 64 D], then one
// transpose buffer a consumer warpgroup, then the full / empty barriers.
template <int NCH>
struct Layout {
  static constexpr int MT = NCH <= 8 ? 2 : 1;
  static constexpr int NBOX = 2 * MT;
  static constexpr int BF = 64 * NBOX;               // F columns a tile
  static constexpr int X_BYTES = NCH * CH * 128;
  static constexpr int STAGE = NBOX * W_BOX_BYTES + X_BYTES;
  static constexpr int EPI_LD = 64 * MT + 8;         // bf16 a transpose row
  static constexpr int EPI = NCH * CH * EPI_LD * 2;  // bytes a warpgroup
  static constexpr int BARS = 2 * MAX_STAGES * 8;
  static int stages() {
    const int s = (SMEM_BUDGET - 1024 - 2 * EPI - BARS) / STAGE;
    return s < MAX_STAGES ? s : MAX_STAGES;
  }
  static size_t bytes(int stages) { return 1024 + (size_t)stages * STAGE + 2 * EPI + BARS; }
};

// D is the contracted depth and F the width of out's rows: the forward's D
// and F; dx's F and D (WK: w's tile is read K-major, its rows are out's
// columns).
template <int NCH, bool WK>
__global__ void __launch_bounds__(NTHREADS, 1)
gmm_bf16_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                __nv_bfloat16* __restrict__ out, int C, int D, int F, int n_f, int n_pass,
                int n_tiles, int stages) {
  using L = Layout<NCH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t epi0 = base + stages * L::STAGE;
  const uint32_t bars = epi0 + 2 * L::EPI;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);        // the producer's arrive + the TMA bytes
      mbar_init(empty(s), 8);       // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (D + BD - 1) / BD;
  constexpr int NCP = NCH * CH;     // C rows a pass

  if (warp == NCONSUMER / 32) {     // ---- producer warp ----------------------
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int fs = tile % n_f;
        const int p = (tile / n_f) % n_pass;
        const int e = tile / (n_f * n_pass);
        const int f0 = fs * L::BF;
        int nbox = (F - f0 + 63) / 64;  // the boxes that hold data
        if (nbox > L::NBOX) nbox = L::NBOX;
        const uint32_t bytes = W_BOX_BYTES * nbox + L::X_BYTES;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % stages;
          mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
          const uint32_t st = base + s * L::STAGE;
          mbar_expect_tx(full(s), bytes);
          for (int i = 0; i < nbox; ++i) {
            if constexpr (WK)
              tma_load_3d(st + i * W_BOX_BYTES, &tmw, full(s), kt * BD, f0 + 64 * i, e);
            else
              tma_load_3d(st + i * W_BOX_BYTES, &tmw, full(s), f0 + 64 * i, kt * BD, e);
          }
          tma_load_3d(st + L::NBOX * W_BOX_BYTES, &tmx, full(s), kt * BD, p * NCP, e);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns F rows f0 + 64 MT wg .. + 64 MT - 1 ------
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int row_w = (warp % 4) * 16;   // this warp's 16 of the 64 F rows
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(gbase + (epi0 - base) + wg * L::EPI);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int fs = tile % n_f;
    const int p = (tile / n_f) % n_pass;
    const int e = tile / (n_f * n_pass);
    const int fw = fs * L::BF + wg * 64 * L::MT;  // first F column of this warpgroup
    const bool active = fw < F;
    float acc[L::MT][NCH * 8];
#pragma unroll
    for (int m = 0; m < L::MT; ++m) {
#pragma unroll
      for (int i = 0; i < NCH * 8; ++i) acc[m][i] = 0.f;
      fence_acc(acc[m]);
    }

    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(full(s), (it / stages) & 1);
      const uint32_t st = base + s * L::STAGE;
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < L::MT; ++m) {
        if (fw + 64 * m < F) {
#pragma unroll
          for (int kk = 0; kk < BD / 16; ++kk)   // A: 16 D rows (WK: columns); B: 16 D columns
            wgmma_tile<NCH, WK ? 0 : 1>(
                acc[m], desc_sw128(st + (wg * L::MT + m) * W_BOX_BYTES + kk * (WK ? 32 : 2048)),
                desc_sw128(st + L::NBOX * W_BOX_BYTES + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < L::MT; ++m) fence_acc(acc[m]);
    if (lane == 0) mbar_arrive(empty(prev));

    // Epilogue: acc[m][i] is out^T at F row 64 m + row_w + g + 8 ((i / 2) % 2)
    // and C column 8 (i / 4) + 2 t + i % 2.  Transpose through shared memory,
    // then write 16 bytes a thread along out's rows.
    named_sync(1 + wg, 128);          // the previous tile's stores have read epi
    if (active) {
#pragma unroll
      for (int m = 0; m < L::MT; ++m)
#pragma unroll
        for (int i = 0; i < NCH * 8; ++i) {
          const int fr = 64 * m + row_w + g + 8 * ((i / 2) % 2);
          const int cc = 8 * (i / 4) + 2 * t + (i % 2);
          epi[cc * L::EPI_LD + fr] = __float2bfloat16_rn(acc[m][i]);
        }
    }
    named_sync(1 + wg, 128);
    if (active) {
      constexpr int CPR = 8 * L::MT;  // 16-byte chunks a row
      const int c0 = p * NCP;
      __nv_bfloat16* oe = out + (size_t)e * C * F;
      for (int idx = tid; idx < NCP * CPR; idx += 128) {
        const int cc = idx / CPR, ch = idx % CPR;
        const int f = fw + ch * 8;
        if (c0 + cc < C && f < F)
          *reinterpret_cast<uint4*>(oe + (size_t)(c0 + cc) * F + f) =
              *reinterpret_cast<const uint4*>(epi + cc * L::EPI_LD + ch * 8);
      }
    }
  }
}

// ---- dw[e] = x[e]^T dy[e] ---------------------------------------------------
// A tile of dw is (expert, 128 D rows, 256 F columns); consumer warpgroup wg
// owns its D rows 64 wg .. 64 wg + 63.  A stage holds 64 C rows of both
// operands, as TMA writes them: two 64 D x 64 C boxes of x (x is (C, D), D
// contiguous: each warpgroup's A, MN-major) and four 64 F x 64 C boxes of dy
// (the B of m64n256k16, MN-major, its 64-column blocks 8 KB apart: LBO).
constexpr int DW_NX = 2;                       // x boxes a stage: 128 D rows
constexpr int DW_NY = 4;                       // dy boxes a stage
constexpr int DW_BM = 64 * DW_NX;
constexpr int DW_BN = 64 * DW_NY;              // F columns a tile
constexpr int DW_STAGE = (DW_NX + DW_NY) * W_BOX_BYTES;
constexpr int DW_BARS = 2 * MAX_STAGES * 8;

int dw_stages() {
  const int s = (SMEM_BUDGET - 1024 - DW_BARS) / DW_STAGE;
  return s < MAX_STAGES ? s : MAX_STAGES;
}
size_t dw_bytes(int stages) { return 1024 + (size_t)stages * DW_STAGE + DW_BARS; }

__global__ void __launch_bounds__(NTHREADS, 1)
gmm_dw_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmy,
              __nv_bfloat16* __restrict__ dw, int C, int D, int F, int n_d, int n_f,
              int n_tiles, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + stages * DW_STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (C + BD - 1) / BD;     // 64 C rows a stage

  if (warp == NCONSUMER / 32) {     // ---- producer warp ----------------------
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int fs = tile % n_f;
        const int ds = (tile / n_f) % n_d;
        const int e = tile / (n_f * n_d);
        const int d0 = ds * DW_BM, f0 = fs * DW_BN;
        int nx = (D - d0 + 63) / 64;    // the boxes that hold data
        if (nx > DW_NX) nx = DW_NX;
        int ny = (F - f0 + 63) / 64;
        if (ny > DW_NY) ny = DW_NY;
        const uint32_t bytes = W_BOX_BYTES * (nx + ny);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % stages;
          mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
          const uint32_t st = base + s * DW_STAGE;
          mbar_expect_tx(full(s), bytes);
          for (int i = 0; i < nx; ++i)
            tma_load_3d(st + i * W_BOX_BYTES, &tmx, full(s), d0 + 64 * i, kt * BD, e);
          for (int j = 0; j < ny; ++j)
            tma_load_3d(st + (DW_NX + j) * W_BOX_BYTES, &tmy, full(s), f0 + 64 * j, kt * BD, e);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----------------------------------------------------
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row_w = (warp % 4) * 16;   // this warp's 16 of the 64 D rows
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int fs = tile % n_f;
    const int ds = (tile / n_f) % n_d;
    const int e = tile / (n_f * n_d);
    const int dwg = ds * DW_BM + 64 * wg;  // first D row of this warpgroup
    const int f0 = fs * DW_BN;
    const bool active = dwg < D;
    float acc[DW_BN / 2];
#pragma unroll
    for (int i = 0; i < DW_BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);

    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(full(s), (it / stages) & 1);
      const uint32_t st = base + s * DW_STAGE;
      wgmma_fence();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < BD / 16; ++kk)   // 16 C rows of both operands
          wgmma_n256<1, 1>(acc, desc_sw128(st + wg * W_BOX_BYTES + kk * 2048),
                           desc_sw128(st + DW_NX * W_BOX_BYTES + kk * 2048, W_BOX_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    // Epilogue: acc[4 q + 2 r + c] is dw at D row dwg + row_w + g + 8 r and
    // F column f0 + 8 q + 2 t + c; two columns (4 bytes) a store, rows >= D
    // and columns >= F masked (F is even).
    if (active) {
      __nv_bfloat16* oe = dw + (size_t)e * D * F;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = dwg + row_w + g + 8 * r;
#pragma unroll
        for (int q = 0; q < DW_BN / 8; ++q) {
          const int f = f0 + 8 * q + 2 * t;
          if (d < D && f < F)
            *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)d * F + f) =
                __floats2bfloat162_rn(acc[4 * q + 2 * r], acc[4 * q + 2 * r + 1]);
        }
      }
    }
  }
}

// A 3-D bf16 tensor map (dims innermost first), 128-byte swizzle, zero fill.
bool encode_3d(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t b0, uint32_t b1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The configuration of the last launch, for a report: NCH (dw: its tile's F
// columns), ring stages, dynamic shared memory in bytes, blocks.
int last_launch[4];

cudaError_t sm_count(int* n_sm) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n_sm = n;
  return cudaSuccess;
}

// out (E, C, F) = x (E, C, D) w (E, D, F) in the forward; with WK, x is dy
// (E, C, D = the forward's F), w is (E, F = the forward's D, D), read
// K-major, and out is dx (E, C, F = the forward's D).
template <int NCH, bool WK>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  using L = Layout<NCH>;
  CUtensorMap tmx, tmw;
  if (!encode_3d(&tmx, x, D, C, E, BD, NCH * CH) ||
      !(WK ? encode_3d(&tmw, w, D, F, E, BD, 64) : encode_3d(&tmw, w, F, D, E, 64, BD)))
    return cudaErrorInvalidValue;
  const int stages = L::stages();
  const size_t smem = L::bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel<NCH, WK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  if ((err = sm_count(&n_sm)) != cudaSuccess) return err;
  const int n_f = (F + L::BF - 1) / L::BF;
  const int n_pass = (C + NCH * CH - 1) / (NCH * CH);
  const long long n_tiles = (long long)E * n_pass * n_f;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = n_tiles < n_sm ? (int)n_tiles : n_sm;
  last_launch[0] = NCH;
  last_launch[1] = stages;
  last_launch[2] = (int)smem;
  last_launch[3] = grid;
  gmm_bf16_kernel<NCH, WK><<<grid, NTHREADS, smem, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(out), C, D, F, n_f, n_pass, (int)n_tiles, stages);
  return cudaGetLastError();
}

// the fewest 16-row chunks that hold C (C > 256 takes passes of 256)
template <bool WK>
cudaError_t run(const void* x, const void* w, void* out, int E, int C, int D, int F,
                cudaStream_t s) {
  const int nch = (C + CH - 1) / CH;
  if (nch <= 1) return launch<1, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 2) return launch<2, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 3) return launch<3, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 4) return launch<4, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 5) return launch<5, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 6) return launch<6, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 8) return launch<8, WK>(x, w, out, E, C, D, F, s);
  if (nch <= 12) return launch<12, WK>(x, w, out, E, C, D, F, s);
  return launch<MAX_NCH, WK>(x, w, out, E, C, D, F, s);
}

cudaError_t launch_dw(const void* x, const void* dy, void* dw, int E, int C, int D, int F,
                      cudaStream_t stream) {
  CUtensorMap tmx, tmy;
  if (!encode_3d(&tmx, x, D, C, E, 64, BD) || !encode_3d(&tmy, dy, F, C, E, 64, BD))
    return cudaErrorInvalidValue;
  const int stages = dw_stages();
  const size_t smem = dw_bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  if ((err = sm_count(&n_sm)) != cudaSuccess) return err;
  const int n_d = (D + DW_BM - 1) / DW_BM;
  const int n_f = (F + DW_BN - 1) / DW_BN;
  const long long n_tiles = (long long)E * n_d * n_f;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = n_tiles < n_sm ? (int)n_tiles : n_sm;
  last_launch[0] = DW_BN;
  last_launch[1] = stages;
  last_launch[2] = (int)smem;
  last_launch[3] = grid;
  gmm_dw_kernel<<<grid, NTHREADS, smem, stream>>>(
      tmx, tmy, static_cast<__nv_bfloat16*>(dw), C, D, F, n_d, n_f, (int)n_tiles, stages);
  return cudaGetLastError();
}

// What every entry point checks first: the shapes the kernels take, three
// 16-byte aligned pointers, the encoder, and the device of `a` made current
// on the calling thread.
cudaError_t prelude(const void* a, const void* b, const void* c, int E, int C, int D, int F) {
  if (E < 1 || E > 65535 || C < 1 || D < 8 || F < 8 || D % 8 != 0 || F % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 != 0)
    return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  return use_device_of(a);
}

}  // namespace

// out (E, C, F) = x (E, C, D) @ w (E, D, F)
extern "C" int repro_grouped_matmul_bf16(const void* x, const void* w, void* out, int E,
                                         int C, int D, int F, void* stream) {
  cudaError_t err = prelude(x, w, out, E, C, D, F);
  if (err == cudaSuccess) err = run<false>(x, w, out, E, C, D, F, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// dx (E, C, D) = dy (E, C, F) @ w (E, D, F)^T
extern "C" int repro_grouped_matmul_dx_bf16(const void* dy, const void* w, void* dx, int E,
                                            int C, int D, int F, void* stream) {
  cudaError_t err = prelude(dy, w, dx, E, C, D, F);
  if (err == cudaSuccess) err = run<true>(dy, w, dx, E, C, F, D, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// dw (E, D, F) = x (E, C, D)^T @ dy (E, C, F)
extern "C" int repro_grouped_matmul_dw_bf16(const void* x, const void* dy, void* dw, int E,
                                            int C, int D, int F, void* stream) {
  cudaError_t err = prelude(x, dy, dw, E, C, D, F);
  if (err == cudaSuccess) err = launch_dw(x, dy, dw, E, C, D, F, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" void repro_grouped_matmul_last_launch(int* info) {
  for (int i = 0; i < 4; ++i) info[i] = last_launch[i];
}
