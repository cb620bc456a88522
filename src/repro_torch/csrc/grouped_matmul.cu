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
// of fp32 sums, deterministic as the forward.  Both products are one
// kernel, gmm_bwd_kernel, in their natural orientation:
//
// * dx[e] (C, D) = dy[e] (C, F) w[e]^T: M = C rows, N = D columns, K = F.
//   Both operands are K-major as they lie (dy's rows and w's rows have F
//   contiguous), so the wgmma takes no transpose bit and the epilogue no
//   transpose: C 640 is five 128-row tiles with no padding;
// * dw[e] (D, F) = x[e]^T (D, C) dy[e] (C, F): M = D, N = F, K = C; both
//   operands MN-major (x's rows have D contiguous, dy's F), the template's
//   MN argument.
//
// What bounds them at olmoe's training shapes (E 64, C 640, D / F 2048 /
// 1024 and back): 172 GFLOP against 520 MB each, 0.174 ms at 989 TFLOP/s,
// operations.  The first design sat at 2.3-2.7x that and 1.5-1.7x
// torch.bmm: dx reused the forward's kernel (C as the wgmma N in 256-row
// passes, the third of three half padding, and a scalar transpose through
// a buffer that left 3 ring stages), dw stored 4 bytes a thread from
// registers, neither overlapped its epilogue with products, and each read
// 2-2.4 GB a launch from L2 into shared memory.  This design:
//
// * a tile is 128 rows (two consumer warpgroups of 64) x 256 columns: one
//   m64n256k16 a warpgroup and 16-deep step, fp32 sums in 128 registers a
//   thread; a stage holds 64 deep of A (two 8 KB pieces, one a warpgroup)
//   and of B (two 16 KB halves of 128 columns), 48 KB, in a ring of 4
//   (192 KB), filled by one producer warp through TMA, 128-byte swizzled
//   and zero-filled past C, D and F;
// * few, large TMA requests: a stage takes two a block — A's two pieces in
//   one box and the block's half of B, or the other way round — each of
//   16 KB.  dw's MN-major operands are 64 columns a box under the swizzle,
//   so they are read through a 4-D view whose third dimension counts
//   64-column blocks (D and F multiples of 64; a ragged dw takes a box a
//   block).  On the card, a stage of three or more requests of 8-16 KB
//   took 12-19% longer, and 32-deep stages of twice the count (8 stages of
//   24 KB) 50% longer: the load path pays by the request;
// * 2-CTA clusters: the two blocks of a cluster take two tiles that share
//   an operand, and each loads half of it with TMA multicast into both:
//   two M tiles of one N tile share B (w's rows in dx, dy's F strip in dw),
//   so a block reads 32 KB a stage from L2 instead of 48.  Where the M
//   tiles are odd (dx at C 640: five), the last M row pairs its N tiles
//   and shares A instead (dy's rows); an odd last N tile is computed twice
//   and stored once.  A stage is free when the consumers of both blocks
//   have released it (its empty barrier counts 16 warps, 8 of them remote);
// * persistent: one cluster per two SMs walks the tile pairs expert by
//   expert (an expert's operands, 1.3-4.2 MB, stay in L2 while its tiles
//   run), so the producer fills the next tile's stages during an epilogue;
// * epilogue through shared memory: each warpgroup writes its 64 x 256
//   rounded sums as four 64 x 64 chunks with stmatrix (16 bytes a row, into
//   the 128-byte swizzled layout, no bank conflicts), and one thread stores
//   each chunk with an asynchronous TMA store, which clips at C, D and F,
//   two chunk buffers a warpgroup (32 KB in all) so the next chunk's
//   writes overlap the last one's store and the stores overlap the next
//   tile's products; no store is narrower than 16 bytes.
//
// Deterministic: no split-K and no atomics.  Every output element is summed
// over K in one order (64 a stage, 16 an instruction) that depends on
// nothing else — not the grid, the cluster pairing, the SM count or the
// other rows — so two launches give the same bits and a crash-recovered run
// retraces a clean one.  Capacity rows that hold no token are zeros: they
// add nothing to dw and give zero rows of dx.
//
// What still holds them back, measured on the card with parts of the
// kernel switched off: the loads alone take about as long as torch.bmm's
// whole product (0.22-0.25 ms at olmoe's shapes), the products alone
// 0.20-0.22 ms, and the epilogue, which the tensor cores wait out, about
// 1.5 us a tile (10-15%).  Hiding it needs a tile's rounded sums held
// somewhere while the next tile's products run: 64 more registers a
// consumer thread (ptxas holds 9 warps to 168 registers, and setmaxnreg
// with a producer warpgroup did not raise its allocation: the sums went to
// local memory), or 64 KB of shared memory beside a 4-stage ring (3 stages
// cost 10-13%).  A ping-pong of two warpgroups on two tiles was not taken
// for the same reason (a warpgroup's 64 x 256 tile is as wide as its
// registers allow, and two 128 x 128 tiles read 1.5x the bytes a product).
// Also tried and dropped: releasing a stage as soon as its products are
// done, 8 stages of 32 deep, 16-byte stores from registers through a
// warp's own staging buffer, and an L2 evict-first hint on the stores.
//
// C interface (loaded with ctypes): repro_grouped_matmul_bf16 (out = x w),
// repro_grouped_matmul_dx_bf16 (dx = dy w^T) and repro_grouped_matmul_dw_bf16
// (dw = x^T dy) return a cudaError_t (0 on success).  x (E, C, D), w (E, D,
// F), out and dy (E, C, F), dx (E, C, D) and dw (E, D, F) are contiguous and
// 16-byte aligned; D and F are multiples of 8 (TMA takes 16-byte strides).
// The tensor maps are encoded on the host at each call,
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

// The forward's product: A (w's tile) MN-major, B (x's rows) K-major.
template <int NCH>
__device__ __forceinline__ void wgmma_tile(float (&d)[NCH * 8], uint64_t da, uint64_t db) {
  if constexpr (NCH == 1) wgmma_n16<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 2) wgmma_n32<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 3) wgmma_n48<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 4) wgmma_n64<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 5) wgmma_n80<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 6) wgmma_n96<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 8) wgmma_n128<1, 0>(d, da, db, 1);
  else if constexpr (NCH == 12) wgmma_n192<1, 0>(d, da, db, 1);
  else wgmma_n256<1, 0>(d, da, db, 1);
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

template <int NCH>
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
          for (int i = 0; i < nbox; ++i)
            tma_load_3d(st + i * W_BOX_BYTES, &tmw, full(s), f0 + 64 * i, kt * BD, e);
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
          for (int kk = 0; kk < BD / 16; ++kk)   // A: 16 D rows; B: 16 D columns
            wgmma_tile<NCH>(
                acc[m], desc_sw128(st + (wg * L::MT + m) * W_BOX_BYTES + kk * 2048),
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

// ---- the backward: dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e] ------------
// A tile is BW_BM x BW_BN of the output; consumer warpgroup wg owns its rows
// 64 wg .. 64 wg + 63.  A stage holds BW_BK deep of both operands, as TMA
// writes them (128-byte swizzle, 1024-aligned), in 8 KB blocks of 64 rows
// (K-major) or 64 columns (MN-major) x 64 deep:
//   [A piece 0 | A piece 1 | B half 0 (2 blocks) | B half 1 (2 blocks)]
// an A piece is one block, a B half two.  K-major (dx): a block is 64 rows
// of 128 bytes, and the 256 B rows lie 128 bytes apart as one operand.
// MN-major (dw): a block is 64 K rows of 64 columns, B's blocks 8 KB apart
// (the descriptor's LBO).  A request brings whole pieces: a multicast one
// piece (the block's rank's) into both blocks of the cluster, a local one
// both pieces at once — one box of 128 / 256 rows (K-major), or a box over
// a 4-D view whose third dimension counts 64-column blocks (MN-major, when
// the operand's extent is a multiple of 64); a ragged MN-major operand takes
// a box a block.
constexpr int BW_BM = 128;
constexpr int BW_BN = 256;
constexpr int BW_BK = 64;
constexpr int BW_STAGES = 4;
constexpr int BW_CLUSTER = 2;
constexpr int BW_BLOCK = 64 * BW_BK * 2;                  // 8 KB
constexpr int BW_STAGE = 6 * BW_BLOCK;                    // 48 KB
constexpr int BW_EPI = 64 * 64 * 2;                       // a 64 x 64 chunk of out
constexpr int BW_SMEM = 1024 + BW_STAGES * BW_STAGE + 4 * BW_EPI + 2 * BW_STAGES * 8;

// ---- clusters, multicast and the TMA store --------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both blocks: what one wrote to its shared memory or to the
// other's barriers before is seen after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}
// Arrive on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar), "r"(cta)
      : "memory");
}
// A box into this block's shared memory, or with mc into the same offset of
// both blocks' shared memory, completing on the barrier at the same offset
// in each.  3-D (c3 < 0) or 4-D.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         bool mc, int c0, int c1, int c2, int c3) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const uint16_t mask = (1u << BW_CLUSTER) - 1;
  if (c3 < 0 && !mc)
    tma_load_3d(dst, map, bar, c0, c1, c2);
  else if (c3 < 0)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(dst),
        "l"(m), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else if (!mc)
    tma_load_4d(dst, map, bar, c0, c1, c2, c3);
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(dst),
        "l"(m), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Make this thread's writes to shared memory visible to a TMA store.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Four 8 x 8 bf16 matrices, a register of each a thread in the mma layout;
// each thread gives one 16-byte row's address.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// The tile a block of the cluster takes for work unit u.  An expert's units
// are first its pairs of M tiles (2 p, 2 p + 1) of each N tile, which share
// B; then, where the M tiles are odd, its last M tile's pairs of N tiles,
// which share A.  An odd last N tile is taken by both blocks, and stored by
// rank 0 only.
struct BwTile {
  int e, m, n;
  bool share_a, store;
};
__device__ __forceinline__ BwTile bw_tile(int u, int rank, int n_m, int n_n) {
  const int mp = n_m / 2;
  const int per_e = mp * n_n + (n_m % 2) * ((n_n + 1) / 2);
  BwTile t;
  t.e = u / per_e;
  int v = u % per_e;
  if (v < mp * n_n) {
    t.n = v / mp;
    t.m = 2 * (v % mp) + rank;
    t.share_a = false;
    t.store = true;
  } else {
    v -= mp * n_n;
    t.m = n_m - 1;
    t.n = 2 * v + rank;
    t.share_a = true;
    t.store = t.n < n_n;
    if (!t.store) t.n = n_n - 1;
  }
  return t;
}

// The tensor maps: a1 / a2 bring one / both pieces of A, b1 / b2 one / both
// halves of B (a ragged MN-major operand: one block each), o takes 64 x 64
// chunks of the output.
struct BwMaps {
  CUtensorMap a1, a2, b1, b2, o;
};

// Loads pieces [p0, p0 + np) of an operand, `pb` blocks a piece, of extent
// `lim` (rows or columns) at depth k0 of expert e into dst.  K-major: one
// 3-D box; MN-major: one box over the 4-D view (`merged`), or a box a
// block that holds data.
template <bool MN>
__device__ __forceinline__ void load_pieces(const CUtensorMap* one, const CUtensorMap* both,
                                            bool merged, uint32_t dst, uint32_t bar, bool mc,
                                            int pb, int p0, int np, int lim, int k0, int e) {
  const CUtensorMap* map = np == 1 ? one : both;
  const int b0 = p0 * pb;                         // first 64-wide block
  if (!MN) {
    tma_load(dst, map, bar, mc, k0, 64 * b0, e, -1);
  } else if (merged) {
    tma_load(dst, map, bar, mc, 0, k0, b0, e);
  } else {
    for (int b = 0; b < np * pb && 64 * (b0 + b) < lim; ++b)
      tma_load(dst + b * BW_BLOCK, one, bar, mc, 64 * (b0 + b), k0, e, -1);
  }
}

// The bytes a stage of operand X brings to each block: whole pieces (a box
// counts whole, zero fill included), or with a box a block the blocks that
// hold data; a multicast piece that holds no data is not loaded.
__device__ __forceinline__ uint32_t piece_bytes(bool per_block, bool mc, int pb, int lim) {
  const int blocks = min(2 * pb, (lim + 63) / 64);           // that hold data
  if (per_block) return blocks * BW_BLOCK;
  const int pieces = mc ? (blocks + pb - 1) / pb : 2;
  return pieces * pb * BW_BLOCK;
}

// out (M x N of each expert) = A (M x K) B (K x N).  MN false: dx, A and B
// K-major; MN true: dw, both MN-major.  M, N and K are the output's rows
// and columns and the contracted depth; n_m, n_n the tiles along M and N;
// merged: MN-major operands read through the 4-D view.
template <bool MN>
__global__ void __cluster_dims__(BW_CLUSTER, 1, 1) __launch_bounds__(NTHREADS, 1)
gmm_bwd_kernel(const __grid_constant__ BwMaps maps, int M, int N, int K, int n_m, int n_n,
               int n_units, int merged) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t epi0 = base + BW_STAGES * BW_STAGE;
  const uint32_t bars = epi0 + 4 * BW_EPI;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (BW_STAGES + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rank = (int)cluster_rank();
  const int cid = blockIdx.x / BW_CLUSTER;
  const int n_cl = gridDim.x / BW_CLUSTER;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);                  // the producer's arrive + the bytes
      mbar_init(empty(s), 8 * BW_CLUSTER);    // each consumer warp of both blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // both blocks' barriers exist before either multicasts

  const int nk = (K + BW_BK - 1) / BW_BK;

  if (warp == NCONSUMER / 32) {     // ---- producer warp ----------------------
    if (lane == 0) {
      int it = 0;
      for (int u = cid; u < n_units; u += n_cl) {
        const BwTile t = bw_tile(u, rank, n_m, n_n);
        const int m0 = t.m * BW_BM, n0 = t.n * BW_BN;
        const bool per_block = MN && !merged;
        const uint32_t bytes = piece_bytes(per_block, t.share_a, 1, M - m0) +
                               piece_bytes(per_block, !t.share_a, 2, N - n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % BW_STAGES;
          mbar_wait(empty(s), ((it / BW_STAGES) & 1) ^ 1);
          const uint32_t st = base + s * BW_STAGE;
          const int k0 = kt * BW_BK;
          mbar_expect_tx(full(s), bytes);
          // the shared operand: this block's piece, into both blocks
          if (t.share_a) {
            if (64 * rank < M - m0)
              load_pieces<MN>(&maps.a1, &maps.a2, merged, st + rank * BW_BLOCK, full(s), true,
                              1, t.m * 2 + rank, 1, M, k0, t.e);
            load_pieces<MN>(&maps.b1, &maps.b2, merged, st + 2 * BW_BLOCK, full(s), false, 2,
                            t.n * 2, 2, N, k0, t.e);
          } else {
            load_pieces<MN>(&maps.a1, &maps.a2, merged, st, full(s), false, 1, t.m * 2, 2, M,
                            k0, t.e);
            if (128 * rank < N - n0)
              load_pieces<MN>(&maps.b1, &maps.b2, merged, st + (2 + 2 * rank) * BW_BLOCK,
                              full(s), true, 2, t.n * 2 + rank, 1, N, k0, t.e);
          }
        }
      }
    }
  } else {                          // ---- consumer warpgroups ----------------
    const int wg = warp / 4;
    const int tid = threadIdx.x % 128;
    const int wq = warp % 4;          // this warp's 16 of the warpgroup's 64 rows
    int it = 0, q = 0;                // q: chunks this warpgroup has stored
    for (int u = cid; u < n_units; u += n_cl) {
      const BwTile t = bw_tile(u, rank, n_m, n_n);
      const int m0 = t.m * BW_BM, n0 = t.n * BW_BN;
      float acc[BW_BN / 2];
#pragma unroll
      for (int i = 0; i < BW_BN / 2; ++i) acc[i] = 0.f;
      fence_acc(acc);

      int prev = -1;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % BW_STAGES;
        mbar_wait(full(s), (it / BW_STAGES) & 1);
        const uint32_t st = base + s * BW_STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BW_BK / 16; ++kk) {   // 16 deep of both operands
          if constexpr (MN)
            wgmma_n256<1, 1>(acc, desc_sw128(st + wg * BW_BLOCK + kk * 2048),
                             desc_sw128(st + 2 * BW_BLOCK + kk * 2048, BW_BLOCK), 1);
          else
            wgmma_n256<0, 0>(acc, desc_sw128(st + wg * BW_BLOCK + kk * 32),
                             desc_sw128(st + 2 * BW_BLOCK + kk * 32), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();              // the previous stage's products are done
        if (prev >= 0 && lane == 0)
          for (int r = 0; r < BW_CLUSTER; ++r) mbar_arrive_cluster(empty(prev), r);
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0)
        for (int r = 0; r < BW_CLUSTER; ++r) mbar_arrive_cluster(empty(prev), r);

      // Epilogue: acc[i] is out at row 16 wq + g + 8 ((i / 2) % 2) of the
      // warpgroup's 64 and column 8 (i / 4) + 2 t + i % 2 (g = lane / 4,
      // t = lane % 4).  A 16-column block j is acc[8 j .. 8 j + 7]: four 8 x 8
      // matrices for one stmatrix.  Chunks that hold no stored element are
      // skipped (the condition is the same for the whole warpgroup).
      if (!t.store || m0 + 64 * wg >= M) continue;
      const int row = 16 * wq + (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int c = 0; c < BW_BN / 64; ++c) {
        if (n0 + 64 * c >= N) continue;
        const uint32_t buf = epi0 + (2 * wg + (q & 1)) * BW_EPI;
        if (q >= 2 && tid == 0) bulk_wait_read<1>();   // its store before last
        named_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * c + jj;
          const uint32_t ch = 2 * jj + lane / 16;    // 16-byte chunk of the row
          stmatrix_x4(buf + row * 128 + ((ch ^ (row % 8)) << 4),
                      pack_f32(acc[8 * j], acc[8 * j + 1]),
                      pack_f32(acc[8 * j + 2], acc[8 * j + 3]),
                      pack_f32(acc[8 * j + 4], acc[8 * j + 5]),
                      pack_f32(acc[8 * j + 6], acc[8 * j + 7]));
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if (tid == 0) {
          tma_store_3d(&maps.o, buf, n0 + 64 * c, m0 + 64 * wg, t.e);
          bulk_commit();
        }
        ++q;
      }
    }
    if (tid == 0) bulk_wait_all();
  }
  __syncwarp();
  cluster_sync();   // neither block leaves while the other may still arrive on its barriers
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

// The same bf16 tensor (E, rows, cols) seen as 4-D (64, rows, cols / 64, E):
// a box of `blocks` 64-column blocks x 64 rows is one request (cols a
// multiple of 64).
bool encode_blocks(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows, uint64_t E,
                   uint32_t blocks) {
  const cuuint64_t dims[4] = {64, rows, cols / 64, E};
  const cuuint64_t strides[3] = {cols * 2, 128, cols * rows * 2};
  const cuuint32_t box[4] = {64, 64, blocks, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The configuration of the last launch, for a report: the forward's 16-row
// chunks (the backward's tile rows), ring stages, dynamic shared memory in
// bytes, blocks, tile columns, blocks a cluster.
int last_launch[6];

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

// out (E, C, F) = x (E, C, D) w (E, D, F)
template <int NCH>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  using L = Layout<NCH>;
  CUtensorMap tmx, tmw;
  if (!encode_3d(&tmx, x, D, C, E, BD, NCH * CH) || !encode_3d(&tmw, w, F, D, E, 64, BD))
    return cudaErrorInvalidValue;
  const int stages = L::stages();
  const size_t smem = L::bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int n_sm = 0;
  if ((err = sm_count(&n_sm)) != cudaSuccess) return err;
  const int n_f = (F + L::BF - 1) / L::BF;
  const int n_pass = (C + NCH * CH - 1) / (NCH * CH);
  const long long n_tiles = (long long)E * n_pass * n_f;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = n_tiles < n_sm ? (int)n_tiles : n_sm;
  const int report[6] = {NCH, stages, (int)smem, grid, L::BF, 1};
  for (int i = 0; i < 6; ++i) last_launch[i] = report[i];
  gmm_bf16_kernel<NCH><<<grid, NTHREADS, smem, stream>>>(
      tmx, tmw, static_cast<__nv_bfloat16*>(out), C, D, F, n_f, n_pass, (int)n_tiles, stages);
  return cudaGetLastError();
}

// the fewest 16-row chunks that hold C (C > 256 takes passes of 256)
cudaError_t run(const void* x, const void* w, void* out, int E, int C, int D, int F,
                cudaStream_t s) {
  const int nch = (C + CH - 1) / CH;
  if (nch <= 1) return launch<1>(x, w, out, E, C, D, F, s);
  if (nch <= 2) return launch<2>(x, w, out, E, C, D, F, s);
  if (nch <= 3) return launch<3>(x, w, out, E, C, D, F, s);
  if (nch <= 4) return launch<4>(x, w, out, E, C, D, F, s);
  if (nch <= 5) return launch<5>(x, w, out, E, C, D, F, s);
  if (nch <= 6) return launch<6>(x, w, out, E, C, D, F, s);
  if (nch <= 8) return launch<8>(x, w, out, E, C, D, F, s);
  if (nch <= 12) return launch<12>(x, w, out, E, C, D, F, s);
  return launch<MAX_NCH>(x, w, out, E, C, D, F, s);
}

// out (E, M, N) = A B over K for each expert; the tensor maps are the
// caller's (gmm_bwd_kernel's note has their boxes).  One cluster per two SMs
// while units last: as many as the card holds at once, read once a device.
template <bool MN>
cudaError_t launch_bwd(const BwMaps& maps, int E, int M, int N, int K, bool merged,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bwd_kernel<MN>, cudaFuncAttributeMaxDynamicSharedMemorySize, BW_SMEM);
  if (err != cudaSuccess) return err;
  static int max_clusters[64] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (max_clusters[dev] == 0) {
    int n_sm = 0;
    if ((err = sm_count(&n_sm)) != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_sm / BW_CLUSTER * BW_CLUSTER);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = BW_SMEM;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, gmm_bwd_kernel<MN>, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    max_clusters[dev] = n;
  }
  const long long n_m = (M + BW_BM - 1) / BW_BM, n_n = (N + BW_BN - 1) / BW_BN;
  const long long n_units = E * ((n_m / 2) * n_n + (n_m % 2) * ((n_n + 1) / 2));
  if (n_units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int clusters = n_units < max_clusters[dev] ? (int)n_units : max_clusters[dev];
  const int grid = clusters * BW_CLUSTER;
  const int report[6] = {BW_BM, BW_STAGES, BW_SMEM, grid, BW_BN, BW_CLUSTER};
  for (int i = 0; i < 6; ++i) last_launch[i] = report[i];
  gmm_bwd_kernel<MN><<<grid, NTHREADS, BW_SMEM, stream>>>(maps, M, N, K, (int)n_m, (int)n_n,
                                                         (int)n_units, merged ? 1 : 0);
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
  if (err == cudaSuccess) err = run(x, w, out, E, C, D, F, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// dx (E, C, D) = dy (E, C, F) @ w (E, D, F)^T: M = C, N = D, K = F
extern "C" int repro_grouped_matmul_dx_bf16(const void* dy, const void* w, void* dx, int E,
                                            int C, int D, int F, void* stream) {
  cudaError_t err = prelude(dy, w, dx, E, C, D, F);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwMaps m;
  if (!encode_3d(&m.a1, dy, F, C, E, 64, 64) || !encode_3d(&m.a2, dy, F, C, E, 64, 128) ||
      !encode_3d(&m.b1, w, F, D, E, 64, 128) || !encode_3d(&m.b2, w, F, D, E, 64, 256) ||
      !encode_3d(&m.o, dx, D, C, E, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_bwd<false>(m, E, C, D, F, false, static_cast<cudaStream_t>(stream)));
}

// dw (E, D, F) = x (E, C, D)^T @ dy (E, C, F): M = D, N = F, K = C
extern "C" int repro_grouped_matmul_dw_bf16(const void* x, const void* dy, void* dw, int E,
                                            int C, int D, int F, void* stream) {
  cudaError_t err = prelude(x, dy, dw, E, C, D, F);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwMaps m;
  const bool merged = D % 64 == 0 && F % 64 == 0;
  const bool ok = merged ? encode_blocks(&m.a1, x, D, C, E, 1) &&
                               encode_blocks(&m.a2, x, D, C, E, 2) &&
                               encode_blocks(&m.b1, dy, F, C, E, 2) &&
                               encode_blocks(&m.b2, dy, F, C, E, 4)
                         : encode_3d(&m.a1, x, D, C, E, 64, 64) &&
                               encode_3d(&m.b1, dy, F, C, E, 64, 64);
  if (!merged) {
    m.a2 = m.a1;
    m.b2 = m.b1;
  }
  if (!ok || !encode_3d(&m.o, dw, F, D, E, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_bwd<true>(m, E, D, F, C, merged, static_cast<cudaStream_t>(stream)));
}

extern "C" void repro_grouped_matmul_last_launch(int* info) {
  for (int i = 0; i < 6; ++i) info[i] = last_launch[i];
}
