#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--json PATH]

Drives the port's serving path at the full width of olmo-1b, of
olmoe-1b-7b, of rwkv6-7b and of jamba-1.5-large-398b (depth cut to 5
layers), then the CXL0 model's tensor twin at a fuzzing run's batch, then
olmo-1b's serving features (commit schedules, static baseline, prefix
reuse) and a fleet of olmo-1b engines over one pool (live migration,
the placement policy), both at full width with the depth cut to 2
layers, then durable training of olmo-1b at full width (depth cut to 2
layers) through the flash forward and backward kernels, then serving of
the other five decoder-only architectures at full width (internlm2-1.8b,
phi3-medium-14b, yi-34b, chameleon-34b; deepseek-v2-236b's depth cut to 8
layers), then durable training, prefill and decode of the encoder-decoder
whisper-small at full width and depth, then real process kills of the
serving and training workers inside the commit window, then the rank
cluster (three rank processes on the card, one killed), whole-lane KV
tiers and legacy serving of olmo-1b at 2 layers, then elastic scaling (a
joiner rank grows the live cluster and is killed at each join phase, an
olmo-1b fleet at 2 layers grows and drains, the autoscaler's cell); durable
training of olmoe-1b-7b at full width (depth cut to 1 layer) through the
grouped matmul's forward and backward kernels, then of rwkv6-7b at full width
(depth cut to 2 layers) through the WKV-6 forward and backward kernels,
then of jamba-1.5-large-398b at full width (depth cut to 1 layer) through
the selective scan's forward and backward kernels, then of
deepseek-v2-236b at full width (depth cut to 1 layer) through the flash
forward and backward at MLA's widths, run right after olmo-1b's training
(phases 17 to 20 below; the rank processes of phases 15 (a) and 16 (a)
run beside phase 20 and the in-process parts of 15 and 16, which follow
it), then, after phase 12, the example twins (phase 21) and the
mesh-native durable commit on a 2x4 mesh of the card's places with a
killed and restarted mesh worker (phase 22).  It prints one line per
phase:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions;
2. build — compiles the seven kernel libraries of the paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, started together: the four
   TPU kernels' counterparts, the grouped matmul's library holding its dx
   and dw kernels too, the flash backward, the WKV-6 backward and the
   scan's backward) and
   shows ptxas's register / spill / static shared-memory report for each
   kernel instantiation (template arguments kept); the dynamic shared
   memory, ring stages and blocks of each flash and grouped-matmul launch
   are printed with its case in phase 3;
3. kernels — each kernel against its plain PyTorch version on the card,
   bf16, with kernel / plain / library times (CUDA events, after warm-up)
   and the least time the card could take (bytes at 3.35 TB/s vs
   operations at 989 TFLOP/s).  Where a library call exists, kernel and
   library are timed in turns (library, kernel, kernel, library, twice)
   and the median of each is kept, printed beside kernel/library and
   kernel/bound; speed is printed, never checked:
   * the flash backward (``csrc/flash_attention_bwd.cu``: dQ a q tile a
     block, with delta, then dK / dV a kv tile a block walking its G q
     heads, in two warpgroups at MLA's widths; TMA rings and wgmma, no
     atomics) at the training shape (8, 16, 512, 128) causal, the serving
     shape (1, 16, 512, 128), GQA (2, 32 over 8, 200, 128) and (1, 8 over
     2, 512, 128), ragged S = T = 77 at hd 64 and S = T = 300, hd 64 at
     512, causal Sq 100 < Sk 300 (its dk, dv rows past the last q row
     exactly 0) and non-causal (2, 16, 300, 700, 128), whisper-small's
     three training shapes (see the forward's cases below), and at MLA's
     widths (hd 192, hd_v 128): deepseek-v2's training step (8, 128 over
     128, 512), one sequence (1, 128, 512), ragged S = T = 77 and
     non-causal Sq 100 < Sk 300 (2, 4 heads), and at head dim 32 (the
     64-wide tiles over 32 columns; a width the backward takes, though
     no published config trains at it): (4, 8, 256), ragged GQA (1, 8
     over 2, 77) and non-causal (2, 4, 100 over 300) (the kernels line
     reports the first as ``hd32``): the forward's logsumexp
     within 1e-4 abs of the plain
     ``logsumexp``; dq, dk, dv against the fp32 plain backward on the same
     bf16 inputs (the kernel's own output and logsumexp), elementwise
     within 2e-2 x max|plain| (bf16 P and dS operands and outputs, fp32
     sums in another order); two launches bit-identical; the kernel's
     eager call (in turns with SDPA's deterministic backward: library,
     kernel, kernel, library, twice; medians) and its device time (a CUDA
     graph, the host's launch cost out), kernel forward + backward, plain,
     SDPA forward + backward (with deterministic algorithms, and backward
     and forward + backward without them) and the bound (bytes of q, k, v,
     o, dO, lse in and dq, dk, dv out at 3.35 TB/s vs the five products
     at 989 TFLOP/s) printed, with the SDPA backend PyTorch picked for
     each (at hd_v != hd the one that takes those widths).  The forward's time at the serving shape is
     printed beside its time before it gained the logsumexp;
   * flash attention (one block a 64-row q tile, its kv tiles split
     between two warpgroups while q tiles are fewer than SMs; K / V by TMA
     into an mbarrier ring, both products on wgmma) at the path's shape
     (1, 16, 512, 128) causal, at the static baseline's batched prefill
     (4, 16, 512, 128) causal, at jamba-1.5-large's (1, 64 heads over 8
     kv heads, 512, 128), at deepseek-v2's MLA prefill (1, 128 heads over
     128, 512, hd 192 in the 256-wide instantiation, hd_v 128), at
     whisper-small's training shapes (hd 64, 12 heads, B 8: the encoder's
     1500 x 1500 and the cross-attention's 448 over 1500, non-causal, Sk
     a ragged 23 x 64 + 28; the decoder's 448 x 448 causal) and at
     ragged, GQA, hd_v != hd and non-causal shapes: max abs error against the fp32 plain version (limit 2e-2:
     bf16 output rounding, one ulp near 1 is 7.8e-3); library: SDPA;
   * the grouped matmul (TMA ring, wgmma on out^T = w^T x^T, each weight
     byte read once whatever C is, persistent blocks) at the olmoe path's
     four shapes (prefill up/gate (64, 80, 2048) @ (64, 2048, 1024) and
     down, decode up/gate (64, 32, 2048) @ (64, 2048, 1024) and down), at
     the jamba-1.5-large path's four ((16, 80 | 32, 8192) @ (16, 8192,
     24576) and down) and at ragged shapes (C 37 and C 1 with D 200, F 72;
     D 1000, not a multiple of 64; C 300, two passes, with F 200), at
     deepseek-v2's four ((160, 24 | 32, 5120) @ (160, 5120, 1536) and
     down: its prefill and per-sequence decode capacities) and at olmoe's
     training capacity (C 640 at (8, 512): (64, 640, 2048) @ (64, 2048,
     1024) and down): elementwise
     |kernel - plain_fp32| <= 1e-2 * max|plain_fp32| (one rounding to
     bf16 is half an ulp, 3.9e-3 relative); library: ``torch.bmm``;
   * the grouped matmul's backward: dx = dy w^T (the forward's kernel
     with w's tile read K-major) and dw = x^T dy (a kernel of its own:
     128 D x 256 F tiles, both operands MN-major, summed over C in one
     fixed order) at the two training shapes (the last 37 capacity rows
     empty) and at the four ragged ones: the same limit against the fp32
     plain backward, two launches bit-identical; timed at the training
     shapes beside ``torch.bmm(dy, w.transpose(1, 2))`` and
     ``torch.bmm(x.transpose(1, 2), dy)``; each row moves the same bytes
     and operations as the forward's (bound 0.17371 ms, operations);
   * the WKV-6 recurrence (two routes chosen by T: below 64 steps the
     step recurrence with S in registers, read and written coalesced; at
     64 and above the chunked closed form in three launches, the chunks of
     a head in parallel, TF32 tensor-core products with split operands)
     at the rwkv6-7b path's two shapes (prefill (1, 512, 64, 64), decode
     (4, 1, 64, 64)), at ragged T, at the routes' threshold (63, 64), at
     the edges of 64-step chunks and 16-step sub-blocks, at 2048 steps,
     with strong and near-identity decays and at the reference's sweep
     shapes: y and S against the fp32 step-by-step oracle ``wkv6_ref`` on
     the same bf16-valued inputs, elementwise within 1e-3 x max|oracle|
     (TF32 products with split operands, fp32 sums in another order), and
     a row of every B > 1 case bit-identical to a B = 1 call; the output
     launch's configuration and the scratch bytes printed; plain: the
     dispatcher's plain version (chunked form, Q = 256; the direct
     recurrence at T = 1); bound: the larger of the bytes (r, k, v bf16,
     logw, u, y fp32, S in and out) at 3.35 TB/s and the operations of
     the chunked closed form at Q = 16 (its products at the 495 TFLOP/s
     TF32 tensor-core peak, its decays at 67 TFLOP/s); library: none, no
     one PyTorch call computes WKV-6;
   * the WKV-6 backward (``csrc/wkv6_bwd.cu``: the chunked form on the
     TF32 tensor cores, every 64-step chunk of every head in parallel
     but for a short scan of the chunk states and their gradients,
     split operands where dr, dk and dlogw need them, no atomics) at the
     rwkv6-7b training shape (8, 512, 64, 64) and phase 18 (a)'s (1, 64,
     64, 64) (both timed), at T 1, 37, 64, 65, 128 and 129 (chunk seams),
     at n 16 and 32, at B 5 with T 300, with strong decay at T 200 and
     weak decay at T 2048, and with S0 and the final state's cotangent
     given: dr, dk, dv within 1e-2 and dlogw, du, dS0 within 1e-3 x
     max|plain| of ``wkv6_bwd_ref`` on the same bf16-valued inputs (one
     rounding to bf16; TF32 products, fp32 sums in another order), two
     launches bit-identical; the main pass's configuration printed;
     plain: ``wkv6_bwd_ref``; bound: the larger of the bytes (r, k, v,
     dr, dk, dv bf16, logw, dy, dlogw fp32) at 3.35 TB/s and the chunked
     form's operations at Q = 16 (products at the 495 TFLOP/s TF32 peak,
     decays at 67 TFLOP/s), with the step form's bound (10 n^2 fp32
     operations a step and head) beside it; library: none;
   * the selective scan at the jamba-1.5-large path's two shapes (prefill
     chunk (1, 256, 16384, 16), decode (4, 1, 16384, 16)), at ragged S (37,
     100) and I (1000), at N 4, 8 and 6 (not a multiple of 4) and at the
     reference's sweep shapes: y and h against the fp32 plain step
     recurrence on the same fp32 inputs, elementwise within 1e-4 x
     max|plain| (only the order of the sums differs); bound: the larger of
     the bytes (dA, dBu, C, h0 read once, y and h written once, fp32) at
     3.35 TB/s and 4 fp32 operations per (t, i, n) at 67 TFLOP/s; library:
     none, no one PyTorch call computes a selective scan;
   * the selective scan's backward (``csrc/selective_scan_bwd.cu``: the
     forward's split, a block a batch row and 32 channels at N 16; a
     forward sweep parks h before each 8-step segment, a reverse sweep
     recomputes a segment's h in registers and writes d(dA) and d(dBu);
     dC summed a block at a time in channel order, then over the blocks
     by a second launch; no atomics) at jamba-1.5-large's training chunk
     (8, 256, 16384, 16) with h0 and the final h's cotangent given (timed),
     its prefill chunk (1, 256, 16384, 16), ragged S (37, 100) and I
     (1000), N 1, 4, 6, 8 and 64: d(dA) and d(dBu) within 1e-4 and dC and
     dh0 within 1e-3 x max|plain| of ``selective_scan_bwd_ref`` on the same
     fp32 inputs, two launches bit-identical; bound: the larger of the
     bytes (dA, dBu, dy, C, h0 and dh read once, d(dA), d(dBu), dC and dh0
     written once, fp32) at 3.35 TB/s and 8 fp32 operations per (t, i, n)
     at 67 TFLOP/s; library: none, no one PyTorch call computes it;
4. olmo-1b path — ``build_serve_engine("olmo-1b", smoke=False)`` with
   random weights from a torch.Generator seeded 0: 4 slots, 16 requests
   of 512 prompt tokens and budgets 4,8,16,32,48, a pool in a temp dir
   committed every 4 ticks (schedule sync), run to completion.  The flash
   kernel's launch count must equal 16 x prefills.  Then
   ``torch.profiler`` over 8 ticks of the same path on a fresh pool:
   device time by kernel name against the window's wall time.  Then crash
   and resume — the same trace on a fresh pool for 10 ticks (not a
   multiple of the commit cadence), the engine dropped without ``finish``
   and ``ctx.crash()``; a new engine on that pool resumes and runs to
   completion; every session's tokens must equal the uninterrupted run's
   bit for bit;
5. olmoe-1b-7b path — the same trace, schedule, profile and crash-resume
   at full width and full depth (16 layers, 64 experts top-8, d_model
   2048, d_ff_expert 1024, vocab 50304, bf16, 6.9e9 parameters), after
   the olmo-1b engine is freed.  The grouped matmul must run 48 times per
   prefill and per decode tick (3 products x 16 layers), the flash kernel
   16 times per prefill; the schedule (97 ticks, 16 prefills, 25 commits)
   and the D2H bytes must equal olmo-1b's, as the KV lanes are the same;
6. rwkv6-7b path — the same trace, schedule, profile and crash-resume at
   full width and full depth (32 layers, d_model 4096, 64 WKV heads of 64,
   d_ff 14336, vocab 65536, bf16, 7.58e9 parameters), after the olmoe
   engine is freed.  The WKV kernel must run once per layer per prefill
   and per decode tick (32 x (16 + 97) = 3,616), the flash kernel, the
   grouped matmul and the WKV-6 backward (no serving path launches it)
   never; the schedule must equal olmo-1b's, and the D2H
   bytes must be olmo-1b's count of lane copies times the rwkv lane's
   34,078,720 bytes (the state S, 32 x 64 x 64 x 64 fp32, and the two
   token-shift rows);
7. jamba-1.5-large-398b path — the same trace, schedule, profile and
   crash-resume at full width (d_model 8192, 64 heads over 8 kv heads,
   Mamba inner 16384 with d_state 16, 16 experts top-2 with d_ff 24576,
   vocab 65536, bf16) with the depth cut from 72 layers to 5, the most
   that one 80 GB card holds (24,045,707,264 parameters, 48.1 GB), after
   the rwkv6-7b engine is freed.  Layers 0-4 hold every block kind jamba
   has: mamba + dense MLP, mamba + MoE, attention + dense MLP.  The scan
   must run once per mamba layer per prefill chunk of ``ssm_chunk`` (256)
   tokens and per decode tick (4 x (2 x 16 + 97) = 516), the flash kernel
   once per prefill (16), the grouped matmul 3 times per MoE layer per
   prefill and per decode tick (678); the schedule must equal olmo-1b's,
   the D2H bytes olmo-1b's count of lane copies times the jamba lane's
   6,881,280 bytes, and the pool must take olmo-1b's token blocks plus one
   state object per lane copy;
8. the CXL0 model (``repro_torch.core``; plain PyTorch and host code, no
   kernel of its own), after the jamba engine is freed, with deterministic
   algorithms off again as the model's own bench runs:
   (a) 65,536 schedules of 64 steps drawn from a CPU ``torch.Generator``
       seeded 0, on the model_fuzz bench's system (owner (0, 0, 1, 1),
       machine 1 volatile), through ``run_schedules`` on the card and on
       the CPU: ``C``, ``M`` and ``obs`` must be bit-identical (the
       semantics are integer-only);
   (b) the first 4,096 of them through the Python LTS (``lts_run``, eager
       flushes): equal exactly;
   (c) 1,048,576 schedules of 64 steps drawn on the card (1.34 GB of
       actions) on that system and on a 4-machine, 8-location one (owner
       (0, 0, 1, 1, 2, 2, 3, 3), machines 1 and 3 volatile): 0 invariant
       violations over the whole batch, counted on the card; schedules/s,
       steps/s and peak memory printed beside the card's name and power
       limit, and the card's busy time from ``torch.profiler`` over the
       same run repeated, against the unprofiled run's wall time;
   (d) the ``flit``, ``table1`` and ``latency`` bench twins against the
       committed ``benchmarks/baselines/*.json`` (exact; ``latency`` at
       its ``rel_tol``), and ``ctx.transform(CounterSpec())`` on a pool
       in a temp dir: 64 increments with a crash after op 40, recovered
       at ``ops_done`` 40 with the counter at 41, then run to 64.

9. the serving features (``repro_torch.serve``, ``repro_torch.dsm``) on
   olmo-1b at full width with its depth cut from 16 layers to 2
   (``OLMO_LAYERS``, for the time limit: host-bound decode ticks and
   commits scale with the depth; phases 10, 15 (b, c) and 16 serve
   olmo-1b at this depth too), with phase 4's trace and a fresh weight set from the same
   seed, deterministic algorithms on again:
   (a) the run of phase 4 under each commit schedule — ``sync``,
       ``async``, ``sharded`` (4 shards) and ``sharded-async`` (the
       automatic shard count: one pipeline per card) — each with tokens
       bit-identical to sync's, 97 ticks, 16 prefills, 25 commits,
       olmo-1b's D2H bytes at 2 layers (``FEATURES_D2H_BYTES``) and 16
       flash launches a layer; the objects its
       completeOps published (a sharded object counted once) equal
       between sync and sharded and between async and sharded-async
       (the async schedules re-flush each block staged at the previous
       commit, as the reference does); tok/s and host seconds in commit
       printed side by side.  Then a crash after 10 ticks under
       sharded-async: the resume lands on committed tick 4 (the async
       schedules publish one commit behind) and every session's tokens
       equal sync's;
   (b) ``run_static`` (B = 4): 4 prefills, 172 decode ticks, 4 flash
       launches a layer; tok/s beside a stateless continuous run's, and how many
       of the 16 token streams equal continuous's (printed: cuBLAS may
       pick another algorithm at B = 4);
   (c) prefix reuse: 16 requests over 2 prompts; engine 0 with
       ``prefix_reuse`` prefills 2 and hits 14, then an ``engine_id=3``
       engine on the same pool prefills 0, hits 16, launches no flash
       kernel and emits engine 0's tokens; the pool holds 64 ``kvblk/``
       objects of 262,144 bytes and 2 ``kvhead/`` objects, each written
       once; engine 0's D2H is (a)'s plus one lane a publish, engine
       3's (a)'s.

10. the fleet (``repro_torch.serve.fleet``) on olmo-1b at full width
    and phase 9's depth (2 layers), one weight set from a
    torch.Generator seeded 0 shared by every engine, the fleet bench's
    trace at prompt 512: 24 requests over 2 prompts, budgets 4,8,16,24,
    2 slots an engine, prefix reuse on, a commit every 4 ticks (schedule
    sync):
    (a) one engine with a pool, then a 2-engine fleet over one pool with
        rebalancing on: tokens bit-identical; the per-round speedup (the
        fleet's tokens per lockstep round over the engine's tokens per
        tick) at least serve.json's 1.6; the admission decisions and the
        rebalancing migrations printed; per engine, tok/s of the fleet's
        wall and host s in admit / decode / commit; the flash kernel once
        per layer per prefill, and launched;
    (b) an ``engine_id=3`` engine on the fleet's pool: 0 prefills, 24
        hits, 0 flash launches, (a)'s tokens;
    (c) a fresh fleet, one live migration forced from engine 1 to engine
        2 at engine 1's tick 3: its four phases logged, token loss 0,
        (a)'s tokens; the frames and bytes staged into engine 2's buffer,
        each engine's D2H bytes and the objects of the handoff commit
        printed;
    (d) the same fleet killed right after ``mig_commit`` (the hook
        raises), engine 2's staging buffer wiped, a fresh fleet's
        ``resume()`` adopting the session from the pool arm (no staged
        copy read): (a)'s tokens, one owner per session;
    (e) the fleet of (a) under ``--commit-mode auto --topology
        cxl20-switched-pool``: each engine's schedule and shard count and
        the policy's priced costs (modelled CXL ns, not measured times)
        printed; tokens and every count equal (a)'s under sync.

11. durable training (``repro_torch.train``) of olmo-1b at full width
    with its depth cut from 16 layers to 2 (for the time limit;
    237,240,320 parameters, random weights from a torch.Generator seeded
    0, deterministic algorithms on):
    (a) the loss and the global grad norm of one (1, 64) batch on the card
        through the kernels (2 layers: 4 forward launches under remat,
        2 backward) against the port on the CPU with the same weights in
        fp32 and plain attention: within 2e-2 relative;
    (b) the clean run: 8 train steps at the reference launcher's global
        batch 8 x seq 512 on ``run_durable_loop``'s pipeline, with no
        commit: losses, ms a step, peak memory and the bf16 param elements
        that moved printed; 32 forward and 16 backward flash launches;
    (c) ``run_durable_loop`` on a pool in a temp dir (the free disk printed
        first: the phase fails below ~12 GB): 8 steps, a ``sync`` commit
        every 4, retention 2, a crash before the commit of step 6: 1 crash,
        recovered from the pool at step 3, steps 4-7 run again; params,
        mu, nu, the step, the key data and the pipeline state
        bit-identical to (b)'s, and the losses of steps 4-7 too; each
        commit exactly 2,372,403,228 bytes (params bf16, mu and nu fp32,
        28 bytes of counters and pipeline), the newest manifest step 7,
        two kept; host s a commit printed; 11 steps' flash launches.
    The phase's time is printed.
17. durable training of olmoe-1b-7b (runs right after phase 11, when the
    card is free) at full width — 64 experts top-8, d_model 2048,
    d_ff_expert 1024, 16 heads of 128, vocab 50304, bf16 — with its depth
    cut from 16 layers to 1 (``reduced``: 16 layers hold 6.9e9 params, a
    69.2 GB state the out-of-place update holds twice; 1 layer, for the
    time limit beside phase 18, counts 625,606,656 and holds 625,613,056
    with the norm scales), random weights from a torch.Generator seeded
    0:
    (a) the loss and the global grad norm of one (1, 64) batch on the card
        through the kernels against the port on the CPU in fp32 with the
        plain versions: within 2e-2 relative; the launches a step of the
        CPU rehearsal: the grouped matmul 3 a forward pass (one layer is
        no stacked group, so remat recomputes nothing), dx and dw 3 each,
        flash 1 forward and 1 backward;
    (b) the clean run: 4 steps of (8, 512) (capacity 640) on the loop's
        pipeline with no commit: losses, ms a step, peak memory, launches
        4 x (a)'s;
    (c) ``run_durable_loop``: ``sync`` commits every 2 steps, one
        manifest kept, a crash before the commit of step 3 (the free disk
        printed first: the phase fails below ~25 GB): recovered from the
        pool at step 1, steps 2-3 run again; params, mu, nu, the step, the
        key data and the pipeline state bit-identical to (b)'s, the losses
        of steps 0-3 and of the rerun steps 2-3 equal to (b)'s; each
        commit exactly 6,256,392,732 bytes (params bf16 with the router in
        fp32, mu and nu fp32, 28 bytes); 6 steps' launches.
    ms a step (compute), host s a commit, peak GB, launches and the
    phase's time are printed.
18. durable training of rwkv6-7b (right after phase 17) at full width —
    d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab 65536, bf16 —
    with its depth cut from 32 layers to 2 (``reduced``: 32 layers hold
    7.58e9 params, a 75.8 GB state the out-of-place update holds twice;
    2 layers count 976,756,736 and hold 976,887,808 with the norms, mixes
    and decay biases ``param_count`` leaves out), random weights from a
    torch.Generator seeded 0, as phase 17 otherwise:
    (a) one (1, 64) batch (T 64: the forward's chunked route) on the card
        through the kernels against the port on the CPU in fp32 with the
        plain versions: the loss and the grad norm of the decay's leaves
        (``RWKV_DECAY_LEAVES``: they reach the loss only through the
        backward's dlogw) within 2e-2 relative, the global grad norm
        within 0.25 (``RWKV_GRAD_NORM_TOL``: bf16 moves it this far where
        a head's group-norm variance at t = 0 lies near eps, in the
        reference too); launches a step: ``wkv6`` 4 (2 layers, each twice
        under remat) and ``wkv6_bwd`` 2, every other kernel 0;
    (b) 4 clean steps of (8, 512): finite losses, launches 4 x (a)'s;
    (c) ``run_durable_loop`` as phase 17's (c) (the free disk printed
        first: the phase fails below ~22 GB): recovered from the pool at
        step 1, bit-identical to (b), each commit exactly 9,768,878,108
        bytes (params bf16, mu and nu fp32, 28 bytes); 6 steps' launches.
19. durable training of jamba-1.5-large-398b (right after phase 18) at
    full width — d_model 8192, mamba inner 16384, d_state 16, vocab 65536,
    bf16 params and moments — with its depth cut from 72 layers to 1
    (``reduced``: 72 layers hold 398e9 params; layer 0 is a mamba mixer
    and a dense MLP, 2,098,020,352 params counted and 2,098,077,696 held
    with the norms and the conv and dt biases; layer 1 would add a
    16-expert MoE, 12.18e9 params, whose state the card cannot hold
    twice), random weights from a torch.Generator seeded 0, as phase 17
    otherwise:
    (a) one (1, 64) batch, with ``ssm_chunk`` 48 on both sides so its 64
        tokens make 2 chunks (the second ragged), on the card through the
        kernels against the port on the CPU in fp32 with the plain
        versions: the loss, the grad norm and the grad norm of the leaves
        that reach the loss only through the scan (``JAMBA_SCAN_LEAVES``:
        A_log, dt_bias, dt_proj) within 2e-2 relative;
        launches: the scan's forward 4 (each chunk's body runs under a
        checkpoint: the forward, then the recompute), its backward 2,
        every other kernel 0 (``jamba_step_launches``: a function of the
        chunks, ceil(S / ssm_chunk));
    (b) 4 clean steps of (8, 512), 2 chunks of 256 a step: finite losses,
        launches 4 x 4 forward and 4 x 2 backward scans;
    (c) ``run_durable_loop`` as phase 17's (c) (the free disk printed
        first: the phase fails below ~29 GB): recovered from the pool at
        step 1, bit-identical to (b), each commit exactly 12,588,466,204
        bytes (params, mu and nu bf16, 28 bytes); 6 steps' launches.
20. durable training of deepseek-v2-236b (right after phase 19) at full
    width — d_model 5120, 128 MLA heads (q / k nope 128 + rope 64, v 128,
    q_lora 1536, kv_lora 512), dense d_ff 12288, vocab 102400, bf16
    params and moments — with its depth cut from 60 layers to 1
    (``reduced``: layer 0 is MLA and the config's dense first MLP,
    1,386,545,152 params counted and 1,386,562,560 held with the norms;
    layer 1 would add 160 routed and 2 shared experts, 5.36e9 params,
    whose state the card cannot hold twice), random weights from a
    torch.Generator seeded 0, as phase 17 otherwise:
    (a) one (1, 64) batch on the card through the kernels against the
        port on the CPU in fp32 with the plain versions: the loss, the
        grad norm and the grad norm of the leaves that reach the loss
        only through the attention (``DEEPSEEK_MLA_LEAVES``: w_uq, w_uk,
        w_uv, w_dkv; w_dkv's rope columns take their gradient only from
        dk's rope columns) within 2e-2 relative; launches a step: flash
        1 and its backward 1, every other kernel 0
        (``deepseek_step_launches``);
    (b) 4 clean steps of (8, 512): finite losses, launches 4 x (a)'s;
    (c) ``run_durable_loop`` as phase 17's (c) (the free disk printed
        first: the phase fails below ~20 GB): recovered from the pool at
        step 1, bit-identical to (b), each commit exactly 8,319,375,388
        bytes (params, mu and nu bf16, 28 bytes); 6 steps' launches.
    Phase 15 (a)'s rank processes, then phase 16 (a)'s, run in a thread
    beside it and beside phases 15 (b, c) and 16 (b, c), which follow it
    (the card's free memory checked first, ``PHASE_20_FREE_BYTES``):
    every time, rate and peak those print is taken beside the rank
    processes, and is marked so.  Phase 12 follows.
12. the other five decoder-only architectures — internlm2-1.8b,
    phi3-medium-14b, yi-34b, chameleon-34b at full width and depth
    (yi-34b's and chameleon-34b's stacked MLP leaves drawn a layer at a
    time: ``models.params.SLICED_DRAW_ELEMENTS``) and deepseek-v2-236b at
    full width, 8 of its 60 layers (1 dense + 7 MoE: 58.4 GB) — each
    served on the first 8 requests of phase 4's trace as phase 4 serves
    (random weights, seed 0; 4 slots, t_max 560, a ``sync`` commit every
    4 ticks), after the training state is freed: flash once a layer a
    prefill (MLA's prefill at hd 192 / hd_v 128, 128 heads, G = 1), the
    grouped matmul 21 times a forward on deepseek-v2 and never elsewhere;
    decode ticks, prefills, commits, lane copies and token blocks flushed
    equal across the five and to a CPU rehearsal of the same trace (the
    olmo-1b smoke config), D2H bytes = lane copies x lane bytes, each
    analytic parameter count and lane size as expected; internlm2 and
    deepseek-v2 crash after 10 ticks and resume with every session's
    tokens bit-identical.  Printed for each: tok/s, host s in admit /
    decode / commit, ms a decode tick, peak GB and its seconds, beside
    the card's name and power limit; then the phase's time.
13. whisper-small (``repro_torch.models.encdec``) at full width and
    depth — 12 encoder and 12 decoder layers, d 768, 12 heads of 64,
    vocab 51865, 1500 frames, bf16; random weights from a torch.Generator
    seeded 0 — after phase 12's engines are freed: the held parameters
    equal ``param_count()`` plus the layernorms' scales and biases it
    leaves out, and ``param_count()`` lies within 4% of the published
    0.244e9;
    (a) ``run_durable_loop`` over a pipeline that adds the frames
        (``enc_embeds`` (8, 1500, 768) drawn with numpy from the
        committed (seed, step): the reference's audio frontend is a stub;
        the host time of one such batch and a ``torch.profiler`` window
        over one step are printed after the runs):
        6 steps of batch 8 x 448 decoder tokens (the model's trained
        context), a ``sync`` commit every 2, retention 2: losses, ms a
        step, host s a commit and peak memory printed; each commit the
        bf16 params, fp32 mu and nu and 28 bytes of counters and
        pipeline; 72 forward flash launches a step (the encoder's
        self-attention 1500 x 1500, the decoder's causal 448 x 448 and the
        cross-attention 448 over 1500, each twice under remat) and 36
        backward; then the same run with a crash before the last commit:
        recovered from the pool at step 3, steps 4-5 run again, the state,
        the pipeline and those losses bit-identical to the clean run's;
    (b) 4 sequences: a prefill of 64 tokens with their frames (the flash
        kernel once per attention: 36 launches) and 32 greedy decode steps
        (plain attention over the self and cross caches): each step's
        logits within 0.05 abs of a full forward over the same tokens on
        the card (the reference's own tolerance), with the same argmax
        wherever the full forward's top-2 margin exceeds twice the step's
        error (bf16 logits over 51,865 tokens tie exactly; there the two
        orders are both within the bound, and each such step is printed);
        ms a prefill and a decode step printed; then the phase's time.

14. crash scenarios (``repro_torch.scenarios``), run beside phase 13
    for the time limit (the parent trains whisper-small on the card while
    this phase's orchestration waits on its children in a thread): the
    port's runner spawns the killable workers as child processes on the
    card (they load the libraries phase 2 built), after the parent has
    freed every model before phase 13; the independent chains run at once
    (the serving reference, each serving kill and its restart, the training
    reference, the training kill and its restart), the children of a chain
    one after another; a child that exits with anything but 0 or 17 fails
    the phase:
    (a) serving olmo-1b at full width and depth (random weights, seed 0):
        10 requests of 128 prompt tokens, budgets 4,8,16,24, 4 slots, a
        ``sync`` session commit every 3 ticks; an uninterrupted run, then
        a kill (``os._exit(17)`` in the commit window's fault hook) at
        each of ``pre_flush``, ``mid_flush`` and ``post_completeOp`` at
        tick >= 6 and its restart: each restart resumes at the newest
        completed commit (ticks 3, 3, 6) and every session's tokens equal
        the uninterrupted run's bit for bit;
    (b) training olmo-1b at full width cut to 2 layers: (8, 512) batches,
        ``sharded-async`` over 4 shards, 4 steps, a commit every 2, two
        manifests kept; an uninterrupted run, then a kill at
        ``mid_flush`` of step 3 and its restart, which resumes at step 1
        and ends with the uninterrupted run's params digest.
    Each child's flash launches (its own counters, from 0 at its start;
    the killed ones print theirs in their kill line) must equal 16 a
    prefill (serving) or 4 forward and 2 backward a step (training), at
    the prefills and steps the CPU rehearsal of the phase predicts
    (``CRASH_SERVE_PREFILLS``, ``CRASH_TRAIN_STEPS``).  Printed for each
    child beside the card's name and power limit: wall s, ``recover_s``
    (from the process's start to the end of its first step or scheduler
    round) and the bytes it recovered into the card.
    Every time, rate and peak that phases 13 and 14 print is taken with the
    other phase running on the card and the host, and is marked so; the
    card memory the parent holds is read before either starts.
15. the rank cluster (beside phase 20), then the KV cache's tiers and
    legacy serving, after phase 20 (phases 12, 13 and 14 run after 16):
    (a) three rank processes of ``scenarios.cluster_worker`` with
        ``--device cuda`` share the card (``reduced``: dim 2048 x 12
        tensors, 603,979,776 bytes of p / mu / nu, 201,326,592 a rank, cut
        from a data-parallel rank of olmo-1b, ~4.7 GB at world 3), 8
        steps, a commit every 2; rank 1 dies (``os._exit(17)``) at
        ``pre_flush`` of step 3 with ring staging on, and in a second
        cell at ``post_completeOp`` of step 3 with it off; the survivors
        must recover its partition from ``peer-staging`` (resp. the
        ``pool``) at step 3, land on or past the newest completed commit,
        and end with merged digests equal to a planned shrink at step 4
        on the card AND to the same planned run on ``--device cpu``.  The
        two cells and the two planned runs run at once (twelve rank
        processes) for the time limit; each rank's wall s, ``start_s``,
        ``recover_s``, bytes read back and commits are printed beside the
        card's name and power limit;
    (b) one olmo-1b lane at full width and phase 9's depth (t_max 560,
        9,175,040 bytes, random bf16) through ``TieredKVCache``:
        ``stage``, a peer ``spill``, ``spill_durable`` and ``spill_auto``
        under ``cxl11-direct`` (staging) and under ``cxl30-fabric`` with staging
        priced out (the pool), as ``tests/test_placement.py:224-250``;
        each restored into a lane on the card bit-identically, each copy
        to the host counted once; bytes and ms of each printed;
    (c) olmo-1b at full width and phase 9's depth served with
        ``paged=False`` (the legacy whole-lane commits) on the first 8
        requests of phase 4's trace, 4 slots, a ``sync`` commit every 4:
        the schedule (50 ticks, 8 prefills, 13 commits) as the CPU
        rehearsal gives it, 2 flash launches a prefill, D2H = 30 lane
        copies; tokens equal to the paged run of the same requests; a
        crash after 10 ticks resumes at tick 8 from the whole lanes with
        every token equal.  Commits, D2H bytes and host s in commit
        printed against the paged run's.
16. elastic scaling (``repro_torch.scenarios.scale``), after phase 15:
    (a) (beside phases 20, 15 (b, c) and 16 (b, c), right after 15 (a))
        the grow cells at phase 15 (a)'s size (``reduced`` as there):
        three rank processes and a joiner (rank 3, ``--joiner --join-at
        4``) with ``--device cuda``, 8 steps, a commit every 2; no kill,
        and the joiner killed (``os._exit(17)``) at each of
        ``join_staged``, ``join_committed`` and ``join_adopted``; the four
        cells run at once (sixteen processes).  The joiner must exit 17
        at each kill point, the survivors end on live ``(0, 1, 2)``
        after a kill and on ``(0, 1, 2, 3)`` at gen 1 without one, and
        every cell's merged digests must equal phase 15's planned shrink
        on the card AND on the CPU (a straight run's digests equal the
        planned shrink's: ``tests/test_torch_scale_cells.py``); the
        no-kill joiner's bytes adopted from peer staging must equal its
        partition's bytes at world 4, and each rank's exit
        code, wall s, ``start_s`` and ``recover_s`` beside the card's
        name and power limit;
    (b) olmo-1b at full width and phase 9's depth, one set of weights for
        both fleets, the first 8 requests of phase 10's trace (prompt 512,
        budgets 4,8,16,24, two distinct prompts), 2 slots an engine: a
        2-engine fleet takes half, ticks 3 times, grows by engine 3, takes
        the rest, ticks twice and drains the busiest engine with RUNNING
        sessions; it must have grown, drained, migrated at least once and
        end with all 8 outputs equal to a fixed 2-engine fleet's, token
        for token; one flash launch a layer a prefill at the prefills
        the CPU rehearsal gives (``SCALE_FLEET_PREFILLS``: 2 a fleet);
    (c) the autoscale cell (host code, the emulator's modelled ns): the
        controller must beat every fixed fleet size with no session lost;
        its cost against the best fixed fleet's is printed.

21. the example twins (``repro_torch.examples``) on the card at their
    defaults, after phase 12 and before phases 13 and 14, each run driven
    through its ``main``:
    (a) ``train_durable``: the reference's ``small_cfg`` (olmo-1b's config
        at 4 layers, d_model 256, 8 heads of olmo-1b's 128, d_ff 1024, a
        vocabulary of 8192; ``remat="none"``), 60 steps of (4, 256), an
        ``async`` commit every 10, crashes at steps 20 and 40 each healed
        by ``ctx.recover``, then a clean run over a fresh pool: the final
        params must be identical, and the flash forward and backward
        launched once a layer a step computed (4 x the steps of both
        runs, the replayed ones included), nothing else;
    (b) ``serve``: olmo-1b's smoke config, 12 requests of 32 prompt
        tokens, 4 slots, a session commit every 4 ticks into one pool,
        run twice: the first prefills every request (one flash launch a
        layer a prefill), the second resumes all 12 finished sessions
        from the pool with 0 decode ticks, 0 launches and the same
        tokens;
22. the mesh-native durable commit (``dsm.meshio``) on the card:
    (a) ``bench.checkpoint``'s mesh rows: 8 leaves of 512 x 512 fp32
        laid over a 2x4 (data, model) mesh of ``cuda:0`` places,
        committed ``sharded`` device-local against host-gather at the
        shard count the mesh derives: 8 shards of 1,048,576 bytes,
        manifests equal, 0 whole-tree gather bytes on the device path
        (``benchmarks/baselines/checkpoint.json``'s values); each path's
        fastest commit of 3 printed;
    (b) (in a thread beside phase 21 and 22 (a)) the scenario runner's
        mesh lane: ``scenarios.worker --mesh 2x4 --device cuda`` on the
        toy state at dim 2048 (``reduced``: 6 tensors of params, mu and
        nu, 301,989,888 bytes, each (2048, 2048) split over both axes, the
        counters replicated), ``sharded-async``, the shard count priced
        under ``cxl20-switched-pool`` from the per-place bytes, 8 steps,
        a commit every 2: a worker killed (``os._exit(17)``) at
        ``mid_flush`` of step 3 and its restart, beside an uninterrupted
        run; the killed one must exit 17, the restart resume from the
        newest completed commit, device-sharded, with the uninterrupted
        run's params digest; both runs' whole-tree gather bytes 0.

Each path and each run of phases 9, 10, 11, 12, 13, 15 (c), 16 (b), 17,
18, 19, 20 and 21 is
driven with every launch count set to 0 just before it and read just
after; the children of phases 14 and 22 start with theirs at 0.  Then a
``{"kernels": [...]}`` line, the card line again, and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a CUDA device, or without
the repo's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 2e-2
GMM_REL_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
WKV_REL_TOL = 1e-3
#: the WKV-6 backward's limits (x max|plain|): dr, dk, dv are written in
#: bf16 (one rounding, half an ulp: 3.9e-3 relative), dlogw, du and dS0 in
#: fp32 (sums in another order)
WKV_BWD_REL_TOL = {"dr": 1e-2, "dk": 1e-2, "dv": 1e-2, "dlogw": 1e-3,
                   "du": 1e-3, "dS0": 1e-3}
SCAN_REL_TOL = 1e-4
#: the scan backward's limits (x max|plain|): d(dA) and d(dBu) elementwise
#: fp32 (one fma in another order a step), dC and dh0 sums over I and S in
#: another order
SCAN_BWD_REL_TOL = {"ddA": 1e-4, "ddBu": 1e-4, "dC": 1e-3, "dh0": 1e-3}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:89"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/moe_gmm/kernel.py:45"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:91"),
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/kernels/mamba/kernel.py:70"),
    # no TPU kernel: the reference differentiates its plain attention
    # (jax.grad through attention_ref, use_pallas off for training)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:164"),
    # no TPU kernel: jax.grad differentiates the reference's expert einsums
    # (repro/models/moe.py:_expert_mlp); both live in the forward's library
    "grouped_matmul_dx": ("src/repro_torch/csrc/grouped_matmul.cu",
                          "src/repro/models/moe.py:108"),
    "grouped_matmul_dw": ("src/repro_torch/csrc/grouped_matmul.cu",
                          "src/repro/models/moe.py:108"),
    # no TPU kernel: jax.grad differentiates the reference's chunked WKV
    # (repro/models/rwkv.py:_wkv_chunked) when it trains rwkv6-7b
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                 "src/repro/models/rwkv.py:119"),
    # no TPU kernel: jax.grad differentiates the reference's chunk solver
    # (repro/models/mamba.py:_chunk_scan) when it trains jamba
    "selective_scan_bwd": ("src/repro_torch/csrc/selective_scan_bwd.cu",
                           "src/repro/models/mamba.py:94"),
}
#: the kernel libraries the rows above live in (one nvcc each)
LIBRARIES = sorted({os.path.basename(src)[:-3] for src, _ in
                    KERNELS.values()})
ARCHS = ("olmo-1b", "olmoe-1b-7b", "rwkv6-7b", "jamba-1.5-large-398b")
#: olmo-1b's depth in phases 9, 10, 15 (b, c) and 16 (the serving
#: features, the fleet, the KV tiers and legacy serving, elastic
#: scaling): 2 of its 16 layers, for the time limit (host-bound decode
#: ticks and commits scale with the depth; the schedule and every check's
#: form do not; 2 is the least depth where a layer-index fault can show).
#: Phases 4 and 14 serve all 16
OLMO_LAYERS = 2
#: the depth each path runs at (the rest of each config as published):
#: jamba-1.5-large-398b is 797 GB in bf16 at its 72 layers; 5 hold 48.1 GB
DEPTH = {"jamba-1.5-large-398b": 5}
PATH_KW = dict(n_slots=4, commit_every=4)
OLMO_D2H_BYTES = 5_431_623_680     # olmo-1b's 25 commits of this trace
#: the same at ``OLMO_LAYERS`` (the lanes scale with the depth): phase 9
FEATURES_D2H_BYTES = OLMO_D2H_BYTES * OLMO_LAYERS // 16
RWKV_LANE_BYTES = 34_078_720       # one rwkv6-7b slot's cache
JAMBA_LANE_BYTES = 6_881_280       # one jamba-1.5-large (5 layers) slot's
#: jamba-1.5-large at 5 layers: ``ModelConfig.param_count`` (the analytic
#: count, equal to the reference's) and the descriptors the bundle holds,
#: which add the 221,184 norm scales and conv / dt biases it leaves out
JAMBA_PARAM_COUNT = 24_045_486_080
JAMBA_PARAMS = 24_045_707_264


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise CheckFailed(msg)


def reset_counts(counters: dict):
    """Set every kernel's launch count to 0 (``counters``: kernel name ->
    (dispatcher module, count attribute))."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters: dict) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per eager call, CUDA events around ``iters`` back-to-back
    calls: the larger of the device time and the host's cost to issue
    the call (argument checks, allocation, launch)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times between CUDA events, so the
    host's cost per call is out of the measurement.  Inputs stay in the
    50 MB L2 between calls, as a prefill's freshly projected q/k/v do."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def paired_ms(kernel_fn, library_fn, rounds: int = 2,
              timer=device_ms) -> tuple:
    """Kernel and library times from one card, in turns (library, kernel,
    kernel, library) ``rounds`` times, each a ``timer`` (``device_ms``
    unless given); the median of each, and every sample."""
    ks, ls = [], []
    for _ in range(rounds):
        ls.append(timer(library_fn))
        ks.append(timer(kernel_fn))
        ks.append(timer(kernel_fn))
        ls.append(timer(library_fn))
    return statistics.median(ks), statistics.median(ls), ks, ls


def launch_config(kernel_module, fn_name: str) -> list:
    """The configuration the kernel library reports for its last launch
    (4 ints: block shape, ring stages, dynamic shared memory in bytes,
    blocks)."""
    import ctypes
    fn = getattr(kernel_module.library(), fn_name)
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    info = (ctypes.c_int * 4)()
    fn(info)
    return list(info)


def ptxas_report(log: str):
    """(kernel instantiation, ptxas line) for each 'Used ... registers'
    line of an ``nvcc -Xptxas -v`` log, the instantiation read from the
    preceding 'Compiling entry function' line (template arguments kept)."""
    import re

    def demangle(name):
        # a mangled identifier is its length, then itself; the kernel's
        # is the one that ends in "_kernel", its template arguments after
        for m in re.finditer(r"\d+", name):
            for j in range(len(m.group())):
                n = int(m.group()[j:])
                ident = name[m.end():m.end() + n]
                rest = name[m.end() + n:]
                if ident.endswith("_kernel") and len(ident) == n:
                    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
                    return (f"{ident}<"
                            f"{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"
                            if args else ident)
        return name

    entry = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = demangle(m.group(1))
        elif "registers" in line or "spill" in line:
            yield entry, line.strip()


def attention_bound_ms(B, H, K, Sq, Sk, hd, hd_v, causal) -> tuple:
    """Least time for the work: each input read once and the output
    written once (bf16), vs the q·k and p·v multiply-adds the unmasked
    (q, kv) pairs need."""
    nbytes = 2 * (B * H * Sq * hd + B * K * Sk * (hd + hd_v)
                  + B * H * Sq * hd_v)
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    flops = 2 * (hd + hd_v) * pairs * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernel(torch, ops):
    """Phase 3: the flash kernel against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    cases = [  # (name, B, H, K, Sq, Sk, hd, hd_v, causal)
        ("path_s128", 1, 16, 16, 128, 128, 128, 128, True),
        ("path_s512", 1, 16, 16, 512, 512, 128, 128, True),
        ("static_b4_s512", 4, 16, 16, 512, 512, 128, 128, True),
        ("jamba_h64_k8", 1, 64, 8, 512, 512, 128, 128, True),
        ("ragged_s1000", 1, 16, 16, 1000, 1000, 128, 128, True),
        ("gqa_h32_k8", 1, 32, 8, 512, 512, 128, 128, True),
        ("hdv64_hd128", 1, 16, 16, 384, 384, 128, 64, True),
        ("noncausal_sq300_sk700", 2, 16, 16, 300, 700, 128, 128, False),
        ("mla_h128_hd192", 1, 128, 128, 512, 512, 192, 128, True),
        # phase 12's dense prefills (chameleon-34b's is jamba_h64_k8's)
        ("internlm2_h16_k8", 1, 16, 8, 512, 512, 128, 128, True),
        ("phi3_h40_k10", 1, 40, 10, 512, 512, 128, 128, True),
        ("yi_h56_k8", 1, 56, 8, 512, 512, 128, 128, True),
        # phase 13's whisper-small training shapes (hd 64, Sk 1500 = 23 x
        # 64 + 28): the encoder, the cross-attention, the decoder
        ("whisper_enc_b8_s1500", 8, 12, 12, 1500, 1500, 64, 64, False),
        ("whisper_cross_b8_sq448_sk1500", 8, 12, 12, 448, 1500, 64, 64,
         False),
        ("whisper_dec_b8_s448", 8, 12, 12, 448, 448, 64, 64, True),
    ]
    gen = torch.Generator("cuda").manual_seed(1234)
    rows = {}
    for name, B, H, K, Sq, Sk, hd, hd_v, causal in cases:
        G = H // K
        q = torch.randn((B, Sq, K, G, hd), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        k = torch.randn((B, Sk, K, hd), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        v = torch.randn((B, Sk, K, hd_v), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        config = launch_config(kernel, "repro_flash_attention_last_launch")
        ref = ops.plain_attention(q.float(), k.float(), v.float(),
                                  causal=causal)
        err = float((out.float() - ref).abs().max())
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(err <= TOL, f"{name}: max abs err {err} > {TOL}")
        # SDPA's inputs in its own layout, kv heads repeated for GQA
        # (outside the timed call)
        qh = q.reshape(B, Sq, H, hd).transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        # the kernel alone (raw binding, output allocated once), then the
        # dispatcher as the model calls it (checks, allocation, launch)
        buf = torch.empty_like(out)
        kernel_ms, library_ms, k_runs, l_runs = paired_ms(
            lambda: kernel.flash_attention_fwd(q, k, v, buf, causal=causal,
                                               scale=hd ** -0.5),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=causal))
        # SDPA again with deterministic algorithms off: the serving path
        # runs with them on (``set_determinism``), where SDPA takes a slower
        # backend; this is the fastest SDPA the card offers
        torch.use_deterministic_algorithms(False)
        try:
            _, fast_ms, _, _ = paired_ms(
                lambda: kernel.flash_attention_fwd(q, k, v, buf,
                                                   causal=causal,
                                                   scale=hd ** -0.5),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=causal),
                rounds=1)
        finally:
            torch.use_deterministic_algorithms(True)
        kernel_call_ms = call_ms(lambda: ops.flash_attention(q, k, v,
                                                             causal=causal))
        plain_ms = device_ms(lambda: ops.plain_attention(q, k, v,
                                                         causal=causal),
                             reps=5)
        bound_ms, bound_by = attention_bound_ms(B, H, K, Sq, Sk, hd, hd_v,
                                                causal)
        rows[name] = dict(shape=[B, H, K, Sq, Sk, hd, hd_v],
                          causal=causal, max_abs_err=err,
                          kernel_ms=kernel_ms,
                          kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by,
                          kernel_over_library=kernel_ms / library_ms,
                          kernel_over_bound=kernel_ms / bound_ms,
                          kernel_runs_ms=k_runs, library_runs_ms=l_runs,
                          library_nondeterministic_ms=fast_ms,
                          launch=dict(warpgroups=config[0],
                                      stages=config[1],
                                      shared_bytes=config[2],
                                      blocks=config[3]))
        print(f"kernel flash_attention {name}: B={B} H={H} K={K} Sq={Sq} "
              f"Sk={Sk} hd={hd} hd_v={hd_v} causal={causal} "
              f"max_abs_err={err:.3e} (tol {TOL}) kernel_ms={kernel_ms:.5f} "
              f"(per eager call {kernel_call_ms:.5f}) "
              f"plain_ms={plain_ms:.5f} library_ms(sdpa)={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) kernel/library="
              f"{kernel_ms / library_ms:.3f} kernel/bound="
              f"{kernel_ms / bound_ms:.2f} sdpa without deterministic "
              f"algorithms {fast_ms:.5f} (kernel/that "
              f"{kernel_ms / fast_ms:.3f}); launch: {config[0]} warpgroups "
              f"a block, {config[1]} stages, {config[2]} bytes of shared "
              f"memory, {config[3]} blocks", flush=True)
    return rows


#: the forward's time at the serving shape (1, 16, 512, 128) causal before
#: the logsumexp output came (PERF.md; H100 80GB HBM3, 700 W): printed
#: beside this run's, so a slower serving launch shows
FLASH_SERVE_MS_BEFORE = 0.01065


def attention_bwd_bound_ms(B, H, K, Sq, Sk, hd, hd_v, causal) -> tuple:
    """Least time for the backward: q, k, v, o, dO read once and dq, dk,
    dv written once (bf16; q, k, dq, dk hd wide, v, o, dO, dv hd_v; the
    fp32 lse rows read once too), vs the five products over the unmasked
    (q, kv) pairs (q·k, dS·k, dS·q: 2 hd multiply-adds each; dO·v, P·dO:
    2 hd_v)."""
    nbytes = (2 * (2 * B * H * Sq * (hd + hd_v) + 2 * B * K * Sk * (hd + hd_v))
              + 4 * B * H * Sq)
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    flops = 2 * (3 * hd + 2 * hd_v) * pairs * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_calls(torch, qh, kh, vh, dout_h, causal: bool) -> tuple:
    """SDPA's forward + backward and its backward alone (autograd through
    ``scaled_dot_product_attention`` on requires-grad copies), as calls
    to time under the determinism setting in force."""
    import torch.nn.functional as F
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (qh, kh, vh))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.grad(o, (qg, kg, vg), dout_h)

    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    return fwd_bwd, lambda: torch.autograd.grad(o, (qg, kg, vg), dout_h,
                                                retain_graph=True)


def sdpa_call_ms(fn) -> float:
    return call_ms(fn, iters=10, warmup=2)


#: SDPA's backends by the aten op each runs
SDPA_OPS = (("flash", "_scaled_dot_product_flash_attention"),
            ("efficient", "_scaled_dot_product_efficient_attention"),
            ("cudnn", "_scaled_dot_product_cudnn_attention"),
            ("math", "_scaled_dot_product_attention_math"))


def sdpa_backend(torch, fn) -> str:
    """The SDPA backend PyTorch picks for ``fn`` under the settings in
    force, read off the aten ops of one call (profiler, host side)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.key for e in prof.key_averages()]
    return next((b for b, op in SDPA_OPS if any(op in n for n in names)),
                "unknown")


#: phase 3's backward cases: (name, B, H, K, Sq, Sk, hd, hd_v, causal)
FLASH_BWD_CASES = [
    ("train_b8_s512", 8, 16, 16, 512, 512, 128, 128, True),
    ("path_s512", 1, 16, 16, 512, 512, 128, 128, True),
    ("gqa_h32_k8_s200", 2, 32, 8, 200, 200, 128, 128, True),
    ("ragged_s77_hd64", 1, 16, 16, 77, 77, 64, 64, True),
    ("noncausal_sq300_sk700", 2, 16, 16, 300, 700, 128, 128, False),
    ("gqa_h8_k2_s512", 1, 8, 2, 512, 512, 128, 128, True),
    ("ragged_s300", 1, 4, 4, 300, 300, 128, 128, True),
    ("hd64_s512", 1, 8, 8, 512, 512, 64, 64, True),
    ("causal_sq100_sk300", 1, 4, 2, 100, 300, 128, 128, True),
    # phase 13's whisper-small training shapes (see phase_kernel)
    ("whisper_enc_b8_s1500", 8, 12, 12, 1500, 1500, 64, 64, False),
    ("whisper_cross_b8_sq448_sk1500", 8, 12, 12, 448, 1500, 64, 64,
     False),
    ("whisper_dec_b8_s448", 8, 12, 12, 448, 448, 64, 64, True),
    # MLA (deepseek-v2: q / k nope 128 + rope 64, v 128): phase 20's
    # training step, one sequence, a ragged and a non-causal Sq < Sk
    ("mla_train_b8_h128_s512", 8, 128, 128, 512, 512, 192, 128, True),
    ("mla_s512", 1, 128, 128, 512, 512, 192, 128, True),
    ("mla_ragged_s77", 1, 4, 4, 77, 77, 192, 128, True),
    ("mla_noncausal_sq100_sk300", 2, 4, 4, 100, 300, 192, 128, False),
    # head dim 32 (the (64, 64) tiles over 32 columns; no published
    # config trains at it): B 4, S 256, 8 heads, a ragged GQA and a
    # non-causal Sq < Sk
    ("hd32_b4_h8_s256", 4, 8, 8, 256, 256, 32, 32, True),
    ("hd32_gqa_ragged_s77", 1, 8, 2, 77, 77, 32, 32, True),
    ("hd32_noncausal_sq100_sk300", 2, 4, 4, 100, 300, 32, 32, False),
]
#: the hd-32 case the kernels line reports beside the training shape's
FLASH_BWD_HD32 = "hd32_b4_h8_s256"


def phase_flash_bwd(torch, ops):
    """Phase 3, the backward: the forward's logsumexp and the backward
    kernel against their plain versions, two launches bit for bit, and
    times beside SDPA's and the bound."""
    from repro_torch.kernels.attention import kernel
    gen = torch.Generator("cuda").manual_seed(4321)
    rows = {}
    for name, B, H, K, Sq, Sk, hd, hd_v, causal in FLASH_BWD_CASES:
        G = H // K
        scale = hd ** -0.5
        rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                        ).to(torch.bfloat16)
        q, k, v = rn(B, Sq, K, G, hd), rn(B, Sk, K, hd), rn(B, Sk, K, hd_v)
        dout = rn(B, Sq, K, G, hd_v)
        out = torch.empty_like(dout)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
        kernel.flash_attention_fwd(q, k, v, out, causal=causal, scale=scale,
                                   lse=lse)
        grads = [torch.empty_like(t) for t in (q, k, v, q, k, v)]
        kernel.flash_attention_bwd(q, k, v, out, lse, dout, *grads[:3],
                                   causal=causal, scale=scale)
        kernel.flash_attention_bwd(q, k, v, out, lse, dout, *grads[3:],
                                   causal=causal, scale=scale)
        torch.cuda.synchronize()
        _, ref_lse = ops.plain_attention_lse(q, k, v, causal=causal)
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= 1e-4, f"bwd {name}: lse max abs err {lse_err} "
                               f"> 1e-4")
        ref = ops.plain_attention_bwd(q, k, v, out, lse, dout,
                                      causal=causal)
        errs = {}
        for g_name, got, want, again in zip(("dq", "dk", "dv"), grads[:3],
                                            ref, grads[3:]):
            check(bool(torch.isfinite(got).all()),
                  f"bwd {name}: non-finite {g_name}")
            check(torch.equal(got, again),
                  f"bwd {name}: {g_name} differs between two launches")
            rel = float((got.float() - want).abs().max()
                        / want.abs().max())
            check(rel <= TOL, f"bwd {name}: {g_name} max abs err "
                              f"{rel:.3e} x max|plain| > {TOL}")
            errs[g_name] = rel
        if causal and Sq < Sk:        # no q row sees kv rows Sq..Sk-1
            check(all(bool((g[:, Sq:] == 0).all()) for g in grads[1:3]),
                  f"bwd {name}: dk / dv rows past the last q row not 0")
        bufs = grads[:3]

        def bwd():
            kernel.flash_attention_bwd(q, k, v, out, lse, dout, *bufs,
                                       causal=causal, scale=scale)
        graph_ms = device_ms(bwd)
        fwd_bwd_ms = call_ms(lambda: (
            kernel.flash_attention_fwd(q, k, v, out, causal=causal,
                                       scale=scale, lse=lse),
            kernel.flash_attention_bwd(q, k, v, out, lse, dout, *bufs,
                                       causal=causal, scale=scale)),
            iters=20, warmup=3)
        plain_ms = call_ms(lambda: ops.plain_attention_bwd(
            q, k, v, out, lse, dout, causal=causal), iters=3, warmup=1)
        qh = q.reshape(B, Sq, H, hd).transpose(1, 2).contiguous()
        kh = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vh = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        doh = dout.reshape(B, Sq, H, hd_v).transpose(1, 2).contiguous()
        torch.use_deterministic_algorithms(False)
        try:
            fast_calls = sdpa_calls(torch, qh, kh, vh, doh, causal)
            fast_backend = sdpa_backend(torch, fast_calls[0])
            fast_fb, fast_bwd = map(sdpa_call_ms, fast_calls)
        finally:
            torch.use_deterministic_algorithms(True)
        try:      # a yardstick only: SDPA may refuse a deterministic bwd
            lib_fb_fn, lib_bwd_fn = sdpa_calls(torch, qh, kh, vh, doh,
                                               causal)
            backend = sdpa_backend(torch, lib_fb_fn)
            lib_fb = sdpa_call_ms(lib_fb_fn)
            kernel_ms, lib_bwd, k_runs, l_runs = paired_ms(
                bwd, lib_bwd_fn, timer=sdpa_call_ms)
        except RuntimeError as e:
            print(f"kernel flash_attention_bwd {name}: SDPA backward under "
                  f"deterministic algorithms not available ({e}); library "
                  f"times below are without them", flush=True)
            lib_fb, lib_bwd, backend = fast_fb, fast_bwd, fast_backend
            kernel_ms, k_runs, l_runs = sdpa_call_ms(bwd), [], []
        bound_ms, bound_by = attention_bwd_bound_ms(B, H, K, Sq, Sk, hd,
                                                    hd_v, causal)
        rows[name] = dict(shape=[B, H, K, Sq, Sk, hd, hd_v], causal=causal,
                          max_abs_err=max(errs.values()), errs=errs,
                          lse_err=lse_err, kernel_ms=kernel_ms,
                          device_ms=graph_ms, kernel_runs=k_runs,
                          library_runs=l_runs,
                          fwd_bwd_ms=fwd_bwd_ms, plain_ms=plain_ms,
                          library_ms=lib_bwd, library_fwd_bwd_ms=lib_fb,
                          library_nondeterministic_ms=fast_bwd,
                          library_nondeterministic_fwd_bwd_ms=fast_fb,
                          library_backend=backend,
                          library_nondeterministic_backend=fast_backend,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_over_bound=kernel_ms / bound_ms,
                          kernel_over_library=kernel_ms / lib_bwd)
        print(f"kernel flash_attention_bwd {name}: B={B} H={H} K={K} "
              f"Sq={Sq} Sk={Sk} hd={hd} hd_v={hd_v} causal={causal} "
              f"err/max|plain| dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} "
              f"(tol {TOL}) lse_err={lse_err:.3e} (tol 1e-4) two launches "
              f"bit-identical; kernel_ms={kernel_ms:.5f} (eager, in turns "
              f"with SDPA; device_ms {graph_ms:.5f} from a CUDA graph; "
              f"fwd+bwd {fwd_bwd_ms:.5f}) plain_ms={plain_ms:.5f} "
              f"library_ms(sdpa bwd)={lib_bwd:.5f} (fwd+bwd {lib_fb:.5f}; "
              f"backend {backend}) [deterministic algorithms off: bwd "
              f"{fast_bwd:.5f}, fwd+bwd {fast_fb:.5f}; backend "
              f"{fast_backend}] bound_ms={bound_ms:.5f} ({bound_by}) "
              f"kernel/bound={kernel_ms / bound_ms:.2f} "
              f"kernel/library={kernel_ms / lib_bwd:.3f}", flush=True)
    return rows


class PhaseTimer:
    """Host seconds spent in the engine's admit (prefill), decode and
    commit steps, and how often each ran.  Each ends in a host read of
    device results (argmax token, next tokens, D2H block copies), so the
    host clock covers the device work without extra synchronisation."""

    def __init__(self, engine):
        self.t = {"admit": 0.0, "decode": 0.0, "commit": 0.0}
        self.n = dict.fromkeys(self.t, 0)
        for attr, key in (("_admit", "admit"), ("_decode_tick", "decode"),
                          ("_commit", "commit")):
            setattr(engine, attr, self._wrap(getattr(engine, attr), key))

    def _wrap(self, fn, key):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.t[key] += time.perf_counter() - t0
                self.n[key] += 1
        return timed


def pool_objects(pool: str) -> dict:
    """Count the object versions on disk in the pool at ``pool``: token
    blocks ``kv/<rid>/b<k>`` (empty lists for a cache with no token axis)
    and recurrent-state objects ``kv/<rid>/state``.  Serving runs no
    retention GC, so a run's flushes are the difference of two counts."""
    counts = {"blocks": 0, "states": 0}
    for dirpath, _, filenames in os.walk(os.path.join(pool, "objects")):
        rel = os.path.relpath(dirpath, pool).split(os.sep)
        if len(rel) != 4 or rel[1] != "kv":
            continue
        n = sum(f.endswith(".cxl0") for f in filenames)
        counts["states" if rel[3] == "state" else "blocks"] += n
    return counts


def gmm_bound_ms(E, C, D, F) -> tuple:
    """Least time for the work: x, w read once and out written once
    (bf16), vs the E*C*D*F multiply-adds."""
    nbytes = 2 * (E * C * D + E * D * F + E * C * F)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * E * C * D * F / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: olmoe-1b-7b's training capacity at (8, 512): ceil(4096 x 8 x 1.25 / 64)
GMM_TRAIN_C = 640


def phase_gmm(torch, gmm_ops):
    """Phase 3: the grouped-matmul kernel against its plain version on the
    card, timed at the olmoe and the jamba-1.5-large paths' four shapes,
    then its dx and dw kernels.  Returns the forward's, dx's and dw's
    rows."""
    from repro_torch.kernels.moe_gmm import kernel
    from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_dw_ref,
                                                 grouped_matmul_dx_ref,
                                                 grouped_matmul_ref)
    C_T = GMM_TRAIN_C
    cases = [  # (name, E, C, D, F, timed)
        ("prefill_up", 64, 80, 2048, 1024, True),
        ("prefill_down", 64, 80, 1024, 2048, True),
        ("decode_up", 64, 32, 2048, 1024, True),
        ("decode_down", 64, 32, 1024, 2048, True),
        ("jamba_prefill_up", 16, 80, 8192, 24576, True),
        ("jamba_prefill_down", 16, 80, 24576, 8192, True),
        ("jamba_decode_up", 16, 32, 8192, 24576, True),
        ("jamba_decode_down", 16, 32, 24576, 8192, True),
        ("deepseek_prefill_up", 160, 24, 5120, 1536, True),
        ("deepseek_prefill_down", 160, 24, 1536, 5120, True),
        ("deepseek_decode_up", 160, 32, 5120, 1536, True),
        ("deepseek_decode_down", 160, 32, 1536, 5120, True),
        ("train_up", 64, C_T, 2048, 1024, True),
        ("train_down", 64, C_T, 1024, 2048, True),
        ("ragged_c37", 3, 37, 200, 72, False),
        ("ragged_c1", 3, 1, 200, 72, False),
        ("d1000", 8, 48, 1000, 256, False),
        ("c300_f200", 4, 300, 512, 200, False),
    ]
    # the backward at the training shapes and at the ragged ones
    bwd_cases = [c for c in cases if c[0].startswith("train_")
                 or not c[5]]
    gen = torch.Generator("cuda").manual_seed(4321)

    def report_row(what, name, shape, out, ref, config, timed_fns):
        err = float((out.float() - ref).abs().max())
        limit = GMM_REL_TOL * float(ref.abs().max())
        check(bool(torch.isfinite(out).all()), f"{what} {name}: non-finite")
        check(err <= limit, f"{what} {name}: max abs err {err} > {limit}")
        bwd = what != "grouped_matmul"
        launch = dict(stages=config[1], shared_bytes=config[2],
                      blocks=config[3])
        if bwd:
            launch.update(tile_rows=config[0], tile_cols=config[4],
                          cluster=config[5])
            shape_of = (f"tile {config[0]} x {config[4]}, cluster of "
                        f"{config[5]}")
        else:
            launch.update(chunks=config[0])
            shape_of = f"{config[0]} 16-row chunks"
        row = dict(shape=shape, max_abs_err=err, limit=limit, launch=launch)
        msg = (f"kernel {what} {name}: E C D F {shape} max_abs_err="
               f"{err:.3e} (limit {limit:.3e}) launch: {shape_of}, "
               f"{config[1]} stages, {config[2]} bytes of shared memory, "
               f"{config[3]} blocks")
        if timed_fns is not None:
            raw, library, call, plain, big = timed_fns
            kernel_ms, library_ms, k_runs, l_runs = paired_ms(raw, library)
            kernel_call_ms = call_ms(call)
            # the plain version makes an fp32 copy of w (12.9 GB at
            # jamba's widths): one call a graph there
            plain_ms = device_ms(plain, reps=1 if big else 5)
            bound_ms, bound_by = gmm_bound_ms(*shape)
            row.update(kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_over_library=kernel_ms / library_ms,
                       kernel_over_bound=kernel_ms / bound_ms,
                       kernel_runs_ms=k_runs, library_runs_ms=l_runs)
            msg += (f" kernel_ms={kernel_ms:.5f} (per eager call "
                    f"{kernel_call_ms:.5f}) plain_ms={plain_ms:.5f} "
                    f"library_ms(bmm)={library_ms:.5f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by}) kernel/library="
                    f"{kernel_ms / library_ms:.3f} kernel/bound="
                    f"{kernel_ms / bound_ms:.2f}")
        print(msg, flush=True)
        return row

    rows, dx_rows, dw_rows = {}, {}, {}
    for name, E, C, D, F, timed in cases:
        x = torch.randn((E, C, D), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        w = torch.randn((E, D, F), generator=gen, device="cuda"
                        ).mul_(0.02).to(torch.bfloat16)
        out = gmm_ops.grouped_matmul(x, w)
        torch.cuda.synchronize()
        config = kernel.last_launch()
        ref = grouped_matmul_ref(x.float(), w.float())
        big = E * D * F >= 1e9
        rows[name] = report_row(
            "grouped_matmul", name, [E, C, D, F], out, ref, config,
            (lambda: kernel.grouped_matmul_fwd(x, w, out),
             lambda: torch.bmm(x, w),
             lambda: gmm_ops.grouped_matmul(x, w),
             lambda: grouped_matmul_ref(x, w), big) if timed else None)
        del out, ref
        if not any(c[0] == name for c in bwd_cases):
            del x, w
            continue
        # dx = dy w^T and dw = x^T dy; the last rows of a training-sized
        # buffer hold no token (zeros), as a capacity buffer's do
        dy = torch.randn((E, C, F), generator=gen, device="cuda"
                         ).to(torch.bfloat16)
        if name.startswith("train_"):
            x[:, -37:] = 0
            dy[:, -37:] = 0
        xf, wf, dyf = x.float(), w.float(), dy.float()
        for what, launch_fn, a, b, out_like, plain, ref, library in (
                ("grouped_matmul_dx", kernel.grouped_matmul_dx, dy, w, x,
                 lambda: grouped_matmul_dx_ref(w, dy),
                 grouped_matmul_dx_ref(wf, dyf),
                 lambda: torch.bmm(dy, w.transpose(1, 2))),
                ("grouped_matmul_dw", kernel.grouped_matmul_dw, x, dy, w,
                 lambda: grouped_matmul_dw_ref(x, dy),
                 grouped_matmul_dw_ref(xf, dyf),
                 lambda: torch.bmm(x.transpose(1, 2), dy))):
            got = torch.empty_like(out_like)
            again = torch.empty_like(out_like)
            launch_fn(a, b, got)
            torch.cuda.synchronize()
            config = kernel.last_launch()
            launch_fn(a, b, again)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"{what} {name}: two launches differ in bits")

            def call(fn=launch_fn, a=a, b=b, like=out_like):
                fn(a, b, torch.empty_like(like))

            def raw(fn=launch_fn, a=a, b=b, got=got):
                fn(a, b, got)

            row = report_row(what, name, [E, C, D, F], got, ref, config,
                             (raw, library, call, plain, big)
                             if timed else None)
            row["repeat_bit_identical"] = True
            (dx_rows if what.endswith("_dx") else dw_rows)[name] = row
            del got, again
        del x, w, dy, xf, wf, dyf, ref
    return rows, dx_rows, dw_rows


def wkv_bound_ms(B, T, H, n, Q=16) -> tuple:
    """Least time for the work: r, k, v (bf16), logw (fp32) and u read
    once, y (fp32) written once, S read and written once, vs the
    operations of the chunked closed form, the form with the least work.
    Per step and head, a chunk of Q steps does 4n^2 + 4Qn flops of
    products (r S, the state update, the (Q, Q) scores and their product
    with v) on the TF32 tensor cores, and n^2/Q + Qn decays (S at the
    chunk's end, the masked (Q, Q, n) weights) in fp32.  Q = 16 is the
    least row count of a TF32 tensor-core product."""
    nbytes = (3 * 2 + 4 + 4) * B * T * H * n + 4 * H * n + 2 * 4 * B * H * n * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    steps = B * T * H
    t_ops = (steps * (4 * n * n + 4 * Q * n) / TF32_FLOPS
             + steps * (n * n / Q + Q * n) / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_wkv(torch, wkv_ops):
    """Phase 3: the WKV-6 kernel against its plain versions on the card,
    timed at the rwkv6-7b path's two shapes, on both of its routes, with
    a (b, h) row's bits held against a B = 1 call on each."""
    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    cases = [  # (name, B, T, H, n, timed, log decay)
        ("prefill", 1, 512, 64, 64, True, None),
        ("decode", 4, 1, 64, 64, True, None),
        ("ragged_t37", 2, 37, 8, 64, False, None),
        ("sweep_n32", 2, 128, 2, 32, False, None),
        ("sweep_n64", 1, 96, 4, 64, False, None),
        ("sweep_n16", 2, 100, 2, 16, False, None),
        ("sweep_t33", 1, 33, 1, 64, False, None),
        # the routes' threshold, the edges of 64-step chunks and 16-step
        # sub-blocks, many chunks, a batch the rows must not depend on
        ("step_t63", 1, 63, 4, 64, False, None),
        ("chunked_t64", 1, 64, 4, 64, False, None),
        ("chunk_edge_t65", 2, 65, 3, 32, False, None),
        ("chunk_edge_t129_n16", 1, 129, 2, 16, False, None),
        ("many_chunks_t2048", 1, 2048, 8, 64, False, None),
        ("batch5_t300", 5, 300, 3, 32, False, None),
        # log decays -exp(x): x in [1, 3] forgets within a step, x in
        # [-9, -7] keeps nearly everything
        ("strong_decay_t1", 4, 1, 8, 64, False, "strong"),
        ("strong_decay_t200", 2, 200, 4, 64, False, "strong"),
        ("weak_decay_t40", 1, 40, 4, 64, False, "weak"),
        ("weak_decay_t2048", 1, 2048, 8, 64, False, "weak"),
    ]
    gen = torch.Generator("cuda").manual_seed(5678)
    rows = {}
    for name, B, T, H, n, timed, decay in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, v = randn(B, T, H, n).bfloat16(), randn(B, T, H, n).bfloat16()
        k = (randn(B, T, H, n) * 0.5).bfloat16()
        if decay is None:
            logw = -torch.exp(randn(B, T, H, n) * 0.5)
        else:
            lo, hi = {"strong": (1.0, 3.0), "weak": (-9.0, -7.0)}[decay]
            logw = -torch.exp(lo + (hi - lo) * torch.rand(
                (B, T, H, n), generator=gen, device="cuda"))
        u, S0 = randn(H, n) * 0.3, randn(B, H, n, n) * 0.1
        y, S = wkv_ops.wkv6(r, k, v, logw, u, S0)
        torch.cuda.synchronize()
        y_ref, S_ref = wkv6_ref(r, k, v, logw, u, S0)
        errs = {}
        for what, got, want in (("y", y, y_ref), ("S", S, S_ref)):
            err = float((got - want).abs().max())
            limit = WKV_REL_TOL * float(want.abs().max())
            check(bool(torch.isfinite(got).all()),
                  f"wkv6 {name}: non-finite {what}")
            check(err <= limit, f"wkv6 {name}: {what} max abs err {err} > "
                                f"{limit}")
            errs[what] = (err, limit)
        route = "chunked" if T >= kernel.CHUNKED_MIN_T else "step"
        row = dict(shape=[B, T, H, n], route=route,
                   max_abs_err=max(errs["y"][0], errs["S"][0]),
                   errs={w: list(e) for w, e in errs.items()})
        msg = (f"kernel wkv6 {name}: B={B} T={T} H={H} n={n} ({route} "
               f"route) y max_abs_err={errs['y'][0]:.3e} (limit "
               f"{errs['y'][1]:.3e}) S max_abs_err={errs['S'][0]:.3e} "
               f"(limit {errs['S'][1]:.3e})")
        if B > 1:
            b = B // 2
            one = wkv_ops.wkv6(*(t[b:b + 1].contiguous()
                                 for t in (r, k, v, logw)), u,
                               S0[b:b + 1].contiguous())
            check(torch.equal(one[0], y[b:b + 1])
                  and torch.equal(one[1], S[b:b + 1]),
                  f"wkv6 {name}: row {b}'s bits depend on B")
            msg += f"; row {b} bit-identical at B=1"
        if timed:
            yb, Sb = torch.empty_like(y), torch.empty_like(S)
            kernel_ms = device_ms(lambda: kernel.wkv6_fwd(
                r, k, v, logw, u, S0, yb, Sb))
            kernel_call_ms = call_ms(lambda: wkv_ops.wkv6(r, k, v, logw, u,
                                                          S0))
            plain_ms = device_ms(lambda: wkv_ops.plain_wkv6(
                r, k, v, logw, u, S0), reps=2, replays=5)
            bound_ms, bound_by = wkv_bound_ms(B, T, H, n)
            config = launch_config(kernel, "repro_wkv6_last_launch")
            scratch = (kernel.library().repro_wkv6_scratch_bytes(B, T, H, n)
                       if route == "chunked" else 0)
            row.update(kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
                       plain_ms=plain_ms, library_ms=None,
                       bound_ms=bound_ms, bound_by=bound_by,
                       launch=config, scratch_bytes=scratch)
            msg += (f" kernel_ms={kernel_ms:.5f} (per eager call "
                    f"{kernel_call_ms:.5f}) plain_ms={plain_ms:.5f} "
                    f"library_ms=none bound_ms={bound_ms:.5f} ({bound_by}); "
                    f"output launch: {config[0]} threads, chunk "
                    f"{config[1]}, {config[2]} B dynamic shared memory, "
                    f"{config[3]} blocks; scratch {scratch} B")
        rows[name] = row
        print(msg, flush=True)
        del r, k, v, logw, u, S0, y, S, y_ref, S_ref
    return rows


def wkv_bwd_bytes(B, T, H, n, state: bool) -> int:
    """The backward's bytes: r, k, v (bf16), logw, dy (fp32) and u read
    once, dr, dk, dv (bf16), dlogw (fp32) and du written once, and with
    ``state`` S0 and the final state's cotangent read and dS0 written."""
    nbytes = (3 * 2 + 2 * 4 + 3 * 2 + 4) * B * T * H * n + 2 * 4 * H * n
    if state:
        nbytes += 3 * 4 * B * H * n * n
    return nbytes


def wkv_bwd_bound_ms(B, T, H, n, state: bool, Q=16) -> tuple:
    """Least time for the backward's work: its bytes (``wkv_bwd_bytes``)
    at 3.35 TB/s vs the operations of the chunked form, the form with the
    least work, stated as the forward's bound is (``wkv_bound_ms``).  Per
    step and head, a chunk of Q steps does 10 n^2 + 5 Q n flops of
    products on the TF32 tensor cores (the chunk's state and state
    gradient increments, dy S^T, v G^T and k~ G, each 2 n^2; the (Q, Q)
    scores and their cotangents dy v^T, and the three products with
    them, each Q n) and 2 n^2 / Q + Q n decays in fp32 (the two scans
    over the chunks, the masked (Q, Q, n) weights).  Q = 16 is the least
    row count of a TF32 tensor-core product."""
    t_bytes = wkv_bwd_bytes(B, T, H, n, state) / HBM_BYTES_PER_S * 1e3
    steps = B * T * H
    t_ops = (steps * (10 * n * n + 5 * Q * n) / TF32_FLOPS
             + steps * (2 * n * n / Q + Q * n) / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def wkv_bwd_step_bound_ms(B, T, H, n, state: bool) -> float:
    """The bound the step form would have: the same bytes vs its fp32
    operations, 10 n^2 a step and head (S's update and dr0 = S dy, dS's
    update, dk0 = dS v and dv0 = dS^T k) at 67 TFLOP/s outside the tensor
    cores; printed beside the chunked form's for the record."""
    t_bytes = wkv_bwd_bytes(B, T, H, n, state) / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, 10 * n * n * B * T * H / FP32_FLOPS * 1e3)


def phase_wkv_bwd(torch, wkv_ops):
    """Phase 3: the WKV-6 backward kernel against ``wkv6_bwd_ref`` on the
    card (bf16-valued r, k, v upcast for the plain version), timed at the
    rwkv6-7b training shape and at phase 18 (a)'s, two launches
    bit-identical in every case."""
    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    cases = [  # (name, B, T, H, n, timed, log decay, S0 and dS given)
        ("train", 8, 512, 64, 64, True, None, False),
        ("train_a", 1, 64, 64, 64, True, None, False),
        ("ragged_t1", 2, 1, 4, 64, False, None, False),
        ("ragged_t37", 2, 37, 4, 64, False, None, False),
        # exact chunk seams: one and two whole 64-step chunks
        ("chunk_t64", 1, 64, 4, 64, False, None, False),
        ("chunks_t128", 2, 128, 4, 64, False, None, False),
        ("ragged_t65_n32", 2, 65, 3, 32, False, None, False),
        ("ragged_t129_n16", 1, 129, 2, 16, False, None, False),
        ("n16", 2, 100, 2, 16, False, None, False),
        ("n32", 2, 128, 2, 32, False, None, False),
        ("batch5_t300", 5, 300, 3, 32, False, None, False),
        ("strong_decay_t200", 2, 200, 4, 64, False, "strong", False),
        ("weak_decay_t2048", 1, 2048, 8, 64, False, "weak", False),
        ("state_t70", 2, 70, 4, 64, False, None, True),
    ]
    gen = torch.Generator("cuda").manual_seed(4321)
    rows = {}
    for name, B, T, H, n, timed, decay, state in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, v = randn(B, T, H, n).bfloat16(), randn(B, T, H, n).bfloat16()
        k = (randn(B, T, H, n) * 0.5).bfloat16()
        if decay is None:
            logw = -torch.exp(randn(B, T, H, n) * 0.5)
        else:
            lo, hi = {"strong": (1.0, 3.0), "weak": (-9.0, -7.0)}[decay]
            logw = -torch.exp(lo + (hi - lo) * torch.rand(
                (B, T, H, n), generator=gen, device="cuda"))
        u, dy = randn(H, n) * 0.3, randn(B, T, H, n)
        S0, dS = ((randn(B, H, n, n) * 0.1, randn(B, H, n, n)) if state
                  else (None, None))

        def outputs():
            return [torch.empty_like(r), torch.empty_like(k),
                    torch.empty_like(v), torch.empty_like(logw),
                    torch.empty_like(u),
                    torch.empty_like(S0) if state else None]

        got, again = outputs(), outputs()
        kernel.wkv6_bwd(r, k, v, logw, u, S0, dy, dS, *got)
        kernel.wkv6_bwd(r, k, v, logw, u, S0, dy, dS, *again)
        torch.cuda.synchronize()
        want = wkv6_bwd_ref(r, k, v, logw, u, S0, dy, dS)
        errs = {}
        for what, x, y, ref in zip(WKV_BWD_REL_TOL, got, again, want):
            if x is None:
                continue
            err = float((x.float() - ref).abs().max())
            limit = WKV_BWD_REL_TOL[what] * float(ref.abs().max())
            check(bool(torch.isfinite(x).all()),
                  f"wkv6_bwd {name}: non-finite {what}")
            check(err <= limit, f"wkv6_bwd {name}: {what} max abs err "
                                f"{err} > {limit}")
            check(torch.equal(x, y), f"wkv6_bwd {name}: {what} differs "
                                     f"between two launches")
            errs[what] = (err, limit)
        row = dict(shape=[B, T, H, n], state=state,
                   max_abs_err=max(e for e, _ in errs.values()),
                   errs={w: list(e) for w, e in errs.items()})
        msg = (f"kernel wkv6_bwd {name}: B={B} T={T} H={H} n={n}"
               f"{' with S0, dS' if state else ''}: " + ", ".join(
                   f"{w} max_abs_err={e:.3e} (limit {lim:.3e})"
                   for w, (e, lim) in errs.items())
               + "; two launches bit-identical")
        if timed:
            kernel_ms = device_ms(lambda: kernel.wkv6_bwd(
                r, k, v, logw, u, S0, dy, dS, *got))
            plain_ms = device_ms(lambda: wkv6_bwd_ref(
                r, k, v, logw, u, S0, dy, dS), reps=2, replays=5)
            bound_ms, bound_by = wkv_bwd_bound_ms(B, T, H, n, state)
            step_bound = wkv_bwd_step_bound_ms(B, T, H, n, state)
            config = kernel.last_bwd_launch()
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       kernel_over_bound=kernel_ms / bound_ms, launch=config,
                       step_form_bound_ms=step_bound)
            msg += (f" kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
                    f"library_ms=none bound_ms={bound_ms:.5f} ({bound_by}),"
                    f" kernel/bound {kernel_ms / bound_ms:.2f} (the step "
                    f"form's bound {step_bound:.5f}); main pass: "
                    f"{config[0]} threads, chunk {config[1]}, {config[2]} B "
                    f"dynamic shared memory, {config[3]} blocks")
        rows[name] = row
        print(msg, flush=True)
        del r, k, v, logw, u, dy, S0, dS, got, again, want
    return rows


def scan_bound_ms(B, S, I, N) -> tuple:
    """Least time for the work: dA, dBu, C and h0 read once, y and h
    written once (fp32), vs 4 fp32 operations per (t, i, n) (the state's
    multiply and add, the readout's)."""
    nbytes = 4 * (2 * B * S * I * N + B * S * N + 2 * B * I * N + B * S * I)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * B * S * I * N / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_scan(torch, scan_ops):
    """Phase 3: the selective-scan kernel against its plain version on the
    card, timed at the jamba-1.5-large path's two shapes.  At decode the
    inputs (17 MB) stay in the 50 MB L2 between calls, as the path's
    freshly computed dA / dBu do; at prefill they (556 MB) cannot."""
    from repro_torch.kernels.mamba import kernel
    from repro_torch.kernels.mamba.ref import selective_scan_ref
    cases = [  # (name, B, S, I, N, timed)
        ("prefill", 1, 256, 16384, 16, True),
        ("decode", 4, 1, 16384, 16, True),
        ("ragged_s37", 2, 37, 4096, 16, False),
        ("ragged_s100", 1, 100, 2048, 16, False),
        ("ragged_i1000", 2, 64, 1000, 16, False),
        ("n4", 1, 64, 1024, 4, False),
        ("n8", 1, 64, 1024, 8, False),
        ("n6", 1, 20, 70, 6, False),
        ("sweep_b2s128", 2, 128, 128, 16, False),
        ("sweep_n8", 1, 100, 256, 8, False),
        ("sweep_b2s64", 2, 64, 128, 16, False),
        ("sweep_n4", 1, 37, 128, 4, False),
    ]
    gen = torch.Generator("cuda").manual_seed(8765)
    rows = {}
    for name, B, S, I, N, timed in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        dA = torch.sigmoid(randn(B, S, I, N))
        dBu, C, h0 = randn(B, S, I, N) * 0.3, randn(B, S, N), \
            randn(B, I, N) * 0.1
        y, h = scan_ops.selective_scan(dA, dBu, C, h0)
        torch.cuda.synchronize()
        y_ref, h_ref = selective_scan_ref(dA, dBu, C, h0)
        errs = {}
        for what, got, want in (("y", y, y_ref), ("h", h, h_ref)):
            err = float((got - want).abs().max())
            limit = SCAN_REL_TOL * float(want.abs().max())
            check(bool(torch.isfinite(got).all()),
                  f"scan {name}: non-finite {what}")
            check(err <= limit, f"scan {name}: {what} max abs err {err} > "
                                f"{limit}")
            errs[what] = (err, limit)
        row = dict(shape=[B, S, I, N], max_abs_err=max(errs["y"][0],
                                                       errs["h"][0]),
                   errs={w: list(e) for w, e in errs.items()})
        msg = (f"kernel selective_scan {name}: B={B} S={S} I={I} N={N} y "
               f"max_abs_err={errs['y'][0]:.3e} (limit {errs['y'][1]:.3e}) "
               f"h max_abs_err={errs['h'][0]:.3e} (limit "
               f"{errs['h'][1]:.3e})")
        if timed:
            yb, hb = torch.empty_like(y), torch.empty_like(h)
            kernel_ms = device_ms(lambda: kernel.selective_scan_fwd(
                dA, dBu, C, h0, yb, hb))
            kernel_call_ms = call_ms(lambda: scan_ops.selective_scan(
                dA, dBu, C, h0))
            plain_ms = device_ms(lambda: selective_scan_ref(dA, dBu, C, h0),
                                 reps=2, replays=5)
            bound_ms, bound_by = scan_bound_ms(B, S, I, N)
            row.update(kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
                       plain_ms=plain_ms, library_ms=None,
                       bound_ms=bound_ms, bound_by=bound_by)
            msg += (f" kernel_ms={kernel_ms:.5f} (per eager call "
                    f"{kernel_call_ms:.5f}) plain_ms={plain_ms:.5f} "
                    f"library_ms=none bound_ms={bound_ms:.5f} ({bound_by})")
        rows[name] = row
        print(msg, flush=True)
        del dA, dBu, C, h0, y, h, y_ref, h_ref
    return rows


def scan_bwd_bound_ms(B, S, I, N, state: bool) -> tuple:
    """Least time for the backward's work: dA and dBu read once and d(dA)
    and d(dBu) written once, dy, C read and dC written (fp32), with
    ``state`` h0 and the final h's cotangent read and dh0 written, vs 8
    fp32 operations per (t, i, n) (h's update, g's multiply-add, the
    products for d(dA), the carry and dC)."""
    nbytes = 4 * (4 * B * S * I * N + B * S * I + 2 * B * S * N)
    if state:
        nbytes += 4 * 3 * B * I * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * B * S * I * N / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_scan_bwd(torch, scan_ops):
    """Phase 3: the selective scan's backward kernel against
    ``selective_scan_bwd_ref`` on the card, timed at jamba-1.5-large's
    training chunk (8, 256, 16384, 16), two launches bit-identical in
    every case."""
    from repro_torch.kernels.mamba import kernel
    from repro_torch.kernels.mamba.ref import selective_scan_bwd_ref
    cases = [  # (name, B, S, I, N, timed, h0 and dh given)
        ("train", 8, 256, 16384, 16, True, True),
        ("prefill", 1, 256, 16384, 16, False, False),
        ("ragged_s37", 2, 37, 4096, 16, False, True),
        ("ragged_s100", 1, 100, 2048, 16, False, False),
        ("ragged_i1000", 2, 64, 1000, 16, False, True),
        ("n4", 1, 64, 1024, 4, False, True),
        ("n8", 1, 64, 1024, 8, False, False),
        ("n6", 1, 20, 70, 6, False, True),
        ("n64_s1", 1, 1, 33, 64, False, True),
        ("n1", 3, 9, 5, 1, False, True),
    ]
    gen = torch.Generator("cuda").manual_seed(9876)
    rows = {}
    for name, B, S, I, N, timed, state in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        dA = torch.sigmoid(randn(B, S, I, N))
        dBu, C, dy = randn(B, S, I, N) * 0.3, randn(B, S, N), randn(B, S, I)
        h0, dh = ((randn(B, I, N) * 0.1, randn(B, I, N)) if state
                  else (None, None))

        def outputs():
            return [torch.empty_like(dA), torch.empty_like(dBu),
                    torch.empty_like(C),
                    torch.empty_like(h0) if state else None]

        got, again = outputs(), outputs()
        kernel.selective_scan_bwd(dA, dBu, C, h0, dy, dh, *got)
        kernel.selective_scan_bwd(dA, dBu, C, h0, dy, dh, *again)
        torch.cuda.synchronize()
        want = selective_scan_bwd_ref(dA, dBu, C, h0, dy, dh)
        errs = {}
        for what, x, y, ref in zip(SCAN_BWD_REL_TOL, got, again, want):
            if x is None:
                continue
            err = float((x - ref).abs().max())
            limit = SCAN_BWD_REL_TOL[what] * float(ref.abs().max())
            check(bool(torch.isfinite(x).all()),
                  f"scan_bwd {name}: non-finite {what}")
            check(err <= limit, f"scan_bwd {name}: {what} max abs err "
                                f"{err} > {limit}")
            check(torch.equal(x, y), f"scan_bwd {name}: {what} differs "
                                     f"between two launches")
            errs[what] = (err, limit)
        row = dict(shape=[B, S, I, N], state=state,
                   max_abs_err=max(e for e, _ in errs.values()),
                   errs={w: list(e) for w, e in errs.items()})
        msg = (f"kernel selective_scan_bwd {name}: B={B} S={S} I={I} N={N}"
               f"{' with h0, dh' if state else ''}: " + ", ".join(
                   f"{w} max_abs_err={e:.3e} (limit {lim:.3e})"
                   for w, (e, lim) in errs.items())
               + "; two launches bit-identical")
        if timed:
            kernel_ms = device_ms(lambda: kernel.selective_scan_bwd(
                dA, dBu, C, h0, dy, dh, *got))
            plain_ms = device_ms(lambda: selective_scan_bwd_ref(
                dA, dBu, C, h0, dy, dh), reps=2, replays=5)
            bound_ms, bound_by = scan_bwd_bound_ms(B, S, I, N, state)
            config = kernel.last_bwd_launch()
            row.update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       kernel_over_bound=kernel_ms / bound_ms, launch=config)
            msg += (f" kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
                    f"library_ms=none (no one PyTorch call) bound_ms="
                    f"{bound_ms:.5f} ({bound_by}), kernel/bound "
                    f"{kernel_ms / bound_ms:.2f}; launch: {config[0]} "
                    f"threads, {config[1]} steps a segment, {config[2]} B "
                    f"dynamic shared memory, {config[3]} blocks")
        rows[name] = row
        print(msg, flush=True)
        del dA, dBu, C, dy, h0, dh, got, again, want
    return rows


def phase_profile(torch, engine, trace, ticks: int = 8) -> dict:
    """Where a serving window's device time goes: ``torch.profiler`` over
    ``ticks`` ticks of the path after the first admissions (prefills,
    decodes and commits as they fall), device time summed by kernel or
    copy name, beside the window's wall time and the host seconds of each
    engine step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.submit(trace)
    engine.tick()                      # first admissions, outside the window
    torch.cuda.synchronize()
    timer = PhaseTimer(engine)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    ours = {"flash_fwd_kernel": [], "gmm_bf16_kernel": [],
            "wkv6_step_kernel": [], "wkv6_chunk_state_kernel": [],
            "wkv6_chunk_scan_kernel": [], "wkv6_chunk_out_kernel": [],
            "selective_scan_kernel": []}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3)
            for k in ours:
                if k in ev.name:
                    ours[k].append(ev.device_time_total)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kern = "; ".join(
        f"{k} {len(us)} launches, mean {sum(us) / len(us):.1f} us, "
        f"{sum(us) / 1e3:.1f} ms = {100 * sum(us) / 1e3 / wall_ms:.1f}% "
        f"of the window" for k, us in ours.items() if us)
    print(f"profile: {ticks} ticks ({timer.n['admit']} prefills, "
          f"{timer.n['decode']} decodes, {timer.n['commit']} commits) in "
          f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); {kern}; host ms in admit "
          f"{timer.t['admit'] * 1e3:.1f} decode {timer.t['decode'] * 1e3:.1f}"
          f" commit {timer.t['commit'] * 1e3:.1f}", flush=True)
    for name, ms in top:
        print(f"profile: {ms:9.3f} ms  {name[:90]}", flush=True)
    return dict(ticks=ticks, wall_ms=wall_ms, device_busy_ms=busy_ms,
                kernel_launch_us=ours, host_s=timer.t, steps=timer.n,
                top=[[n, ms] for n, ms in top])


def count_lane_copies(engine) -> list:
    """A list that gains one entry each time ``engine`` stages a slot's
    cache lane for a commit (its device-to-host copy)."""
    copies = []
    stage = engine._stage_paged
    engine._stage_paged = lambda *a, **kw: (copies.append(1)
                                            or stage(*a, **kw))
    return copies


def phase_path(torch, cfg, trace, t_max, counters, *, profile=True,
               resume=True) -> dict:
    """Phases 4 to 7 (and each run of phase 12): one architecture's
    serving path at full width (at the depth ``cfg`` has), then its
    profile window (``profile``), then crash and resume (``resume``).  The
    model is built from ``cfg`` and its weights drawn from a
    torch.Generator seeded 0, then handed to ``build_serve_engine``.
    ``counters`` maps a kernel name to its dispatcher module and count
    (``reset_counts`` / ``read_counts``); every count is set to 0 just
    before the path runs and read just after."""
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.utils.tree import tree_leaves
    arch = cfg.arch_id
    kinds = [cfg.layer_kind(l) for l in range(cfg.n_layers)]
    n_attn, n_rwkv = kinds.count("attn"), kinds.count("rwkv")
    n_mamba = kinds.count("mamba")
    n_moe = sum(cfg.mlp_kind(l) == "moe" for l in range(cfg.n_layers)
                if kinds[l] != "rwkv")
    prompt = {len(r.prompt) for r in trace}
    check(len(prompt) == 1, f"trace prompts of lengths {prompt}")
    chunks = -(-prompt.pop() // cfg.ssm_chunk)   # scan launches a prefill
    pools = [tempfile.mkdtemp(prefix="chip_smoke_pool_") for _ in range(3)]
    try:
        t0 = time.perf_counter()
        bundle = build(cfg, device="cuda")
        params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
        engine, _ = build_serve_engine(
            arch, smoke=False, t_max=t_max, pool_path=pools[0],
            bundle=bundle, params=params, device="cuda", **PATH_KW)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the full-width prefill gives finite logits of the vocab's width
        logits, _ = bundle.prefill(
            params, {"tokens": torch.tensor([trace[0].prompt],
                                            device="cuda")},
            bundle.init_caches(1, t_max))
        check(tuple(logits.shape) == (1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits {tuple(logits.shape)} not "
              f"finite/shaped")
        del logits
        timer = PhaseTimer(engine)
        lane_copies = count_lane_copies(engine)
        before = pool_objects(pools[0])
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        res = engine.run(trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts(counters)
        d2h = engine.store.tiers.d2h_gather_bytes
        engine.close()
        flushed = {k: n - before[k]
                   for k, n in pool_objects(pools[0]).items()}
        check(sorted(res.outputs) == sorted(r.rid for r in trace),
              f"{arch}: not every request finished")
        for r in trace:
            toks = res.outputs[r.rid]
            check(len(toks) == r.max_new_tokens
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{arch} {r.rid}: bad output {toks}")
        check(timer.n["decode"] == res.decode_ticks,
              f"{arch}: {timer.n['decode']} decode steps in "
              f"{res.decode_ticks} ticks")
        check(launches["flash_attention"] == n_attn * res.prefills,
              f"{arch}: flash kernel launches "
              f"{launches['flash_attention']} != {n_attn} attention layers "
              f"x {res.prefills} prefills")
        want_gmm = 3 * n_moe * (res.prefills + res.decode_ticks)
        check(launches["grouped_matmul"] == want_gmm,
              f"{arch}: grouped-matmul launches "
              f"{launches['grouped_matmul']} != 3 x {n_moe} MoE layers x "
              f"({res.prefills} prefills + {res.decode_ticks} decode ticks)")
        want_wkv = n_rwkv * (res.prefills + res.decode_ticks)
        check(launches["wkv6"] == want_wkv,
              f"{arch}: wkv6 launches {launches['wkv6']} != {n_rwkv} rwkv "
              f"layers x ({res.prefills} prefills + {res.decode_ticks} "
              f"decode ticks)")
        check(launches["wkv6_bwd"] == launches["selective_scan_bwd"] == 0,
              f"{arch}: serving launched the wkv6 backward "
              f"{launches['wkv6_bwd']} times, the scan's "
              f"{launches['selective_scan_bwd']}")
        want_scan = n_mamba * (chunks * res.prefills + res.decode_ticks)
        check(launches["selective_scan"] == want_scan,
              f"{arch}: selective_scan launches "
              f"{launches['selective_scan']} != {n_mamba} mamba layers x "
              f"({chunks} chunks x {res.prefills} prefills + "
              f"{res.decode_ticks} decode ticks)")
        lane_bytes = sum(s.nbytes for s in tree_leaves(
            bundle.abstract_caches(1, t_max)))
        path = dict(arch=arch, n_params=bundle.n_params(),
                    param_count=cfg.param_count(), init_s=init_s,
                    emitted_tokens=res.emitted_tokens, wall_s=dt,
                    tokens_per_s=res.emitted_tokens / dt,
                    decode_ticks=res.decode_ticks, prefills=res.prefills,
                    commits=res.commits, d2h_bytes=d2h, launches=launches,
                    lane_bytes=lane_bytes, lane_copies=len(lane_copies),
                    flushed=flushed, phase_s=timer.t, t_max=t_max,
                    decode_ms=1e3 * timer.t["decode"] / max(
                        timer.n["decode"], 1),
                    peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(f"path: {arch} full width (L={cfg.n_layers} d={cfg.d_model} "
              f"H={cfg.n_heads} hd={cfg.head_dim} V={cfg.vocab_size}"
              + (f" MLA kv_lora={cfg.mla.kv_lora_rank} qk="
                 f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim} "
                 f"v={cfg.mla.v_head_dim}" if cfg.mla is not None else "")
              + (f" E={cfg.moe.n_experts} top-{cfg.moe.top_k} "
                 f"d_ff_e={cfg.moe.d_ff_expert}" if n_moe else "")
              + (f" shared={cfg.moe.n_shared} {n_moe} MoE / "
                 f"{cfg.n_layers - n_moe} dense layers"
                 if n_moe and cfg.moe.n_shared else "")
              + (f" rwkv n={cfg.rwkv.head_dim} d_ff={cfg.d_ff}"
                 if n_rwkv else "")
              + (f" K={cfg.n_kv_heads} mamba inner="
                 f"{cfg.mamba.expand * cfg.d_model} N={cfg.mamba.d_state} "
                 f"{n_mamba} mamba / {n_attn} attention layers"
                 if n_mamba else "")
              + f", {bundle.n_params()} params, init {init_s:.1f}s) "
              f"4 slots {len(trace)} requests prompt 512: "
              f"{res.emitted_tokens} tokens "
              f"in {dt:.3f}s = {res.emitted_tokens / dt:.1f} tok/s, "
              f"{res.decode_ticks} decode ticks, {res.prefills} prefills, "
              f"{res.commits} commits flushing {flushed['blocks']} token-block "
              f"and {flushed['states']} state objects, D2H {d2h} bytes "
              f"({lane_bytes} a lane), "
              f"launches "
              f"{launches}; host s in admit {timer.t['admit']:.3f} decode "
              f"{timer.t['decode']:.3f} commit {timer.t['commit']:.3f} "
              f"({path['decode_ms']:.2f} ms a decode tick); "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

        def engine_on(pool):
            return build_serve_engine(
                arch, smoke=False, t_max=t_max, pool_path=pool,
                bundle=bundle, params=params, device="cuda", **PATH_KW)[0]

        # -- profile: where the path's device time goes ---------------------
        if profile:
            e_prof = engine_on(pools[2])
            path["profile"] = phase_profile(torch, e_prof, trace)
            e_prof.close()
            del e_prof
        if not resume:
            return path

        # -- crash and resume --------------------------------------------
        crash_ticks = 10
        e2 = engine_on(pools[1])
        e2.submit(trace)
        for _ in range(crash_ticks):
            e2.tick()
        e2.store.ctx.crash()
        del e2
        e3 = engine_on(pools[1])
        step = e3.resume()
        res3 = e3.run(trace)
        e3.close()
        del e3
        check(step == crash_ticks - crash_ticks % 4,
              f"{arch}: resumed at tick {step}, expected the last commit "
              f"{crash_ticks - crash_ticks % 4}")
        diff = [rid for rid in res.outputs
                if res3.outputs.get(rid) != res.outputs[rid]]
        check(not diff, f"{arch}: resumed tokens differ for {diff}")
        path["resume"] = dict(crash_after_ticks=crash_ticks,
                              resumed_tick=step,
                              sessions_resumed=res3.resumed_sessions,
                              prefills_after_resume=res3.prefills)
        print(f"resume: {arch} crashed after {crash_ticks} ticks, resumed "
              f"from committed tick {step}, {res3.resumed_sessions} "
              f"sessions resumed, {res3.prefills} prefills after resume, "
              f"all {len(res.outputs)} sessions' tokens bit-identical to "
              f"the uninterrupted run", flush=True)
        return path
    finally:
        for p in pools:
            shutil.rmtree(p, ignore_errors=True)


#: phase 12: the five decoder-only architectures the earlier phases do not
#: serve, in the order they run
ARCHS_12 = ("internlm2-1.8b", "phi3-medium-14b", "yi-34b", "chameleon-34b",
            "deepseek-v2-236b")
#: deepseek-v2-236b is 472 GB in bf16 at its 60 layers; 8 (1 dense + 7
#: MoE) hold 58.4 GB.  The others run at full depth.
DEPTH_12 = {"deepseek-v2-236b": 8}
#: at the depth phase 12 runs each at: ``ModelConfig.param_count`` (the
#: reference's analytic count) and the weights the bundle holds, which add
#: the norm scales the analytic count leaves out
PARAMS_12 = {"internlm2-1.8b": (1_889_009_664, 1_889_110_016),
             "phi3-medium-14b": (14_659_092_480, 14_659_507_200),
             "yi-34b": (34_388_049_920, 34_388_917_248),
             "chameleon-34b": (34_292_629_504, 34_293_436_416),
             "deepseek-v2-236b": (29_191_274_496, 29_191_377_920)}
#: one slot's cache at t_max 560: 560 x layers x bytes a token a layer
#: (GQA: 2 x kv heads x head_dim x 2; MLA: (512 + 64) x 2)
LANE_BYTES_12 = {"internlm2-1.8b": 55_050_240,
                 "phi3-medium-14b": 114_688_000,
                 "yi-34b": 137_625_600,
                 "chameleon-34b": 110_100_480,
                 "deepseek-v2-236b": 5_160_960}
#: grouped-matmul launches a forward (3 a MoE layer)
GMM_12 = {"deepseek-v2-236b": 21}
#: the architectures phase 12 also crashes after 10 ticks and resumes
CRASH_12 = ("internlm2-1.8b", "deepseek-v2-236b")
N_REQUESTS_12 = 8                  # the first 8 requests of phase 4's trace


def rehearse_schedule(torch, trace, t_max) -> dict:
    """The serving schedule of ``trace`` as a run on the CPU gives it: the
    olmo-1b smoke config (the schedule depends on the prompts' lengths,
    the budgets, the slots and the commit cadence, not on the model) with
    the same slots, cadence and pool commits.  Returns the decode ticks,
    prefills, commits, lane copies staged for commits and token blocks
    flushed."""
    from repro_torch.serve.engine import build_serve_engine
    pool = tempfile.mkdtemp(prefix="chip_smoke_rehearsal_")
    try:
        engine, cfg = build_serve_engine(
            "olmo-1b", smoke=True, t_max=t_max, pool_path=pool,
            device="cpu", **PATH_KW)
        small = [dataclasses.replace(r, prompt=tuple(
            t % cfg.vocab_size for t in r.prompt)) for r in trace]
        copies = count_lane_copies(engine)
        before = pool_objects(pool)
        res = engine.run(small)
        engine.close()
        return dict(decode_ticks=res.decode_ticks, prefills=res.prefills,
                    commits=res.commits, lane_copies=len(copies),
                    blocks=pool_objects(pool)["blocks"] - before["blocks"])
    finally:
        shutil.rmtree(pool, ignore_errors=True)


def phase_archs(torch, trace, t_max, counters) -> dict:
    """12. The five decoder-only architectures the earlier phases do not
    serve, one after another at full width (deepseek-v2-236b at 8 of its
    60 layers), each through ``phase_path`` on the first 8 requests of
    phase 4's trace, with a ``sync`` commit every 4 ticks; internlm2-1.8b
    and deepseek-v2-236b also crash after 10 ticks and resume.  Checks:
    each one's launches (flash once a layer a prefill; the grouped matmul
    21 times a forward on deepseek-v2, 0 elsewhere), its analytic
    parameter count and lane bytes; the schedule (decode ticks, prefills,
    commits, lane copies, flushed token blocks) equal across the five and
    to the CPU rehearsal's; D2H bytes = lane copies x lane bytes."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    trace = trace[:N_REQUESTS_12]
    t0 = time.perf_counter()
    want = rehearse_schedule(torch, trace, t_max)
    print(f"archs: CPU rehearsal of the {len(trace)}-request trace "
          f"(olmo-1b smoke, {time.perf_counter() - t0:.1f}s): "
          f"{want['decode_ticks']} decode ticks, {want['prefills']} "
          f"prefills, {want['commits']} commits, {want['lane_copies']} lane "
          f"copies, {want['blocks']} token blocks flushed", flush=True)
    runs = {}
    for arch in ARCHS_12:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch in DEPTH_12:
            cfg = cfg.with_(n_layers=DEPTH_12[arch])
        run = phase_path(torch, cfg, trace, t_max, counters, profile=False,
                         resume=arch in CRASH_12)
        run["run_s"] = time.perf_counter() - t0
        runs[arch] = run
        got = {k: run[k] for k in ("decode_ticks", "prefills", "commits",
                                   "lane_copies")}
        got["blocks"] = run["flushed"]["blocks"]
        check(got == want, f"{arch}: schedule {got} != the CPU "
                           f"rehearsal's {want}")
        check((run["param_count"], run["n_params"]) == PARAMS_12[arch],
              f"{arch} counts {run['param_count']} params and holds "
              f"{run['n_params']}, expected {PARAMS_12[arch]}")
        check(run["lane_bytes"] == LANE_BYTES_12[arch]
              and run["d2h_bytes"] == want["lane_copies"] * run["lane_bytes"],
              f"{arch}: D2H {run['d2h_bytes']} bytes, lane "
              f"{run['lane_bytes']}: expected {want['lane_copies']} lane "
              f"copies x {LANE_BYTES_12[arch]}")
        n = run["launches"]
        check(n["flash_attention"] == cfg.n_layers * want["prefills"]
              and n["grouped_matmul"] == GMM_12.get(arch, 0) * (
                  want["prefills"] + want["decode_ticks"])
              and n["wkv6"] == n["selective_scan"] == 0
              and n["flash_attention_bwd"] == 0,
              f"{arch}: launches {n}")
        print(f"archs: {arch} {cfg.n_layers} layers "
              f"{run['n_params']} params: {run['tokens_per_s']:.1f} tok/s, "
              f"host s in admit {run['phase_s']['admit']:.3f} decode "
              f"{run['phase_s']['decode']:.3f} commit "
              f"{run['phase_s']['commit']:.3f}, {run['decode_ms']:.2f} ms a "
              f"decode tick, peak {run['peak_mem_bytes'] / 1e9:.2f} GB, "
              f"{run['run_s']:.1f} s; {card_line()}", flush=True)
        del run
    out = dict(rehearsal=want, runs=runs,
               launches={f"{a} (phase 12)": r["launches"]
                         for a, r in runs.items()},
               phase_s=time.perf_counter() - t_phase)
    print(f"archs: phase 12 took {out['phase_s']:.1f} s", flush=True)
    return out


CXL0_BATCH_CHECK = 65_536          # (a): card against CPU
CXL0_LTS_CHECK = 4_096             # (b): against the Python LTS
CXL0_BATCH = 1_048_576             # (c): a fuzzing run's batch
CXL0_T = 64
CXL0_SYSTEMS = {  # name -> (owner, volatile, machines)
    "2m4l": ((0, 0, 1, 1), (False, True), 2),
    "4m8l": ((0, 0, 1, 1, 2, 2, 3, 3), (False, True, False, True), 4),
}


def phase_cxl0(torch, card: str) -> dict:
    """8. The CXL0 model: the tensor twin on the card against the CPU and
    the Python LTS, at a fuzzing run's batch, and the host model's
    benches and the §6 transform on this machine (see the docstring)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bench import flit, latency, table1
    from repro_torch.bench.report import check_against
    from repro_torch.core import semantics_torch as ts
    from repro_torch.core.objects import CounterSpec
    from repro_torch.dsm.api import open_cxl0
    out = {}
    sys2 = ts.TorchSystem(*CXL0_SYSTEMS["2m4l"])

    # (a) card against CPU
    acts = ts.random_schedules(sys2, torch.Generator().manual_seed(0),
                               CXL0_BATCH_CHECK, CXL0_T)
    t0 = time.perf_counter()
    cpu = ts.run_schedules(sys2, acts)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = ts.run_schedules(sys2, acts.cuda())
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    for what, d, c in zip(("C", "M", "obs"), dev, cpu):
        check(d.device.type == "cuda" and torch.equal(d.cpu(), c),
              f"cxl0 (a): {what} on the card differs from the CPU's")
    print(f"cxl0 (a): {CXL0_BATCH_CHECK} schedules x {CXL0_T} on 2m4l: C, "
          f"M, obs bit-identical on the card and the CPU (card "
          f"{dev_s:.3f}s with warm-up, CPU {cpu_s:.3f}s)", flush=True)
    out["a"] = dict(batch=CXL0_BATCH_CHECK, card_s=dev_s, cpu_s=cpu_s)

    # (b) against the Python LTS
    cfg = sys2.config()
    t0 = time.perf_counter()
    for b in range(CXL0_LTS_CHECK):
        Cp, Mp, op = ts.lts_run(cfg, acts[b].tolist())
        check(np.array_equal(cpu[0][b].numpy(), Cp)
              and np.array_equal(cpu[1][b].numpy(), Mp)
              and np.array_equal(cpu[2][b].numpy(), op),
              f"cxl0 (b): schedule {b} differs from the Python LTS")
    lts_s = time.perf_counter() - t0
    print(f"cxl0 (b): the first {CXL0_LTS_CHECK} schedules equal the "
          f"Python LTS exactly ({lts_s:.1f}s on the host)", flush=True)
    out["b"] = dict(schedules=CXL0_LTS_CHECK, host_s=lts_s)
    del acts, cpu, dev

    # (c) a fuzzing run's batch on the card
    out["c"] = {}
    for name, system in CXL0_SYSTEMS.items():
        sys_ = ts.TorchSystem(*system)
        gen = torch.Generator(device="cuda").manual_seed(1)
        ts.run_schedules(sys_, ts.random_schedules(sys_, gen, 4096, CXL0_T))
        torch.cuda.synchronize()                       # warm-up
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()        # held by earlier phases
        acts = ts.random_schedules(sys_, gen, CXL0_BATCH, CXL0_T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, M, obs = ts.run_schedules(sys_, acts)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        bad = int(ts.invariant_violations(C))
        peak = torch.cuda.max_memory_allocated() - base
        # the same run again under the profiler: the card's busy time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ts.run_schedules(sys_, acts)
            torch.cuda.synchronize()
        dev_events = [ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA]
        busy_s = sum(ev.device_time_total for ev in dev_events) / 1e6
        by_name = {}
        for ev in dev_events:
            by_name[ev.name] = by_name.get(ev.name, 0) + 1
        check(tuple(C.shape) == (CXL0_BATCH, sys_.n_machines, sys_.n_locs)
              and tuple(obs.shape) == (CXL0_BATCH, CXL0_T),
              f"cxl0 (c) {name}: shapes {tuple(C.shape)} {tuple(obs.shape)}")
        check(bad == 0, f"cxl0 (c) {name}: {bad} invariant violations")
        row = dict(batch=CXL0_BATCH, length=CXL0_T,
                   action_bytes=acts.nbytes, run_s=run_s,
                   schedules_per_s=CXL0_BATCH / run_s,
                   steps_per_s=CXL0_BATCH * CXL0_T / run_s,
                   peak_bytes=peak, base_bytes=base,
                   invariant_violations=bad,
                   device_busy_s=busy_s, device_busy_share=busy_s / run_s,
                   device_ops_per_step=len(dev_events) / CXL0_T,
                   device_ops_by_name=by_name)
        out["c"][name] = row
        print(f"cxl0 (c): {name} {CXL0_BATCH} schedules x {CXL0_T} "
              f"({acts.nbytes / 1e9:.2f} GB of actions) in {run_s:.4f}s = "
              f"{row['schedules_per_s']:.0f} schedules/s, "
              f"{row['steps_per_s']:.0f} steps/s, peak device memory "
              f"{peak / 1e9:.2f} GB above the {base / 1e9:.2f} GB earlier "
              f"phases hold, 0 invariant violations; profiled "
              f"again: {len(dev_events)} device ops "
              f"({len(dev_events) / CXL0_T:.1f} a step), device busy "
              f"{busy_s:.4f}s = {100 * busy_s / run_s:.1f}% of the "
              f"unprofiled run [{card}]", flush=True)
        for n, c in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"cxl0 (c): {name} {c / CXL0_T:6.2f} a step  {n[:100]}",
                  flush=True)
        del acts, C, M, obs

    # (d) the host model on this machine, and the §6 transform
    out["d"] = {}
    for mod in (flit, table1, latency):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):    # its CSV rows
            report = mod.run()
        base = os.path.join(ROOT, "benchmarks", "baselines",
                            f"{report.name}.json")
        with open(base) as f:
            baseline = json.load(f)
        fails = check_against(report.values(), baseline)
        check(not fails, f"cxl0 (d) {report.name}: {fails}")
        out["d"][report.name] = dict(metrics=len(baseline["metrics"]),
                                     host_s=time.perf_counter() - t0)
        print(f"cxl0 (d): bench {report.name}: all "
              f"{len(baseline['metrics'])} metrics meet "
              f"benchmarks/baselines/{report.name}.json", flush=True)
    pool = tempfile.mkdtemp(prefix="chip_smoke_cxl0_")
    try:
        ctx = open_cxl0(pool, schedule="sync")
        counter = ctx.transform(CounterSpec(), name="counter")
        for _ in range(41):                         # ops 0 .. 40
            counter.op("inc")
        ctx.crash()
        again = open_cxl0(pool, schedule="sync").transform(CounterSpec(),
                                                           name="counter")
        check((again.ops_done, again.state, again.recovered_from)
              == (40, 41, (40, "pool")),
              f"cxl0 (d) transform: recovered ops_done {again.ops_done} "
              f"state {again.state} from {again.recovered_from}")
        got = [again.op("inc") for _ in range(64 - 41)]
        check(got == list(range(41, 64)) and again.state == 64
              and again.ops_done == 63,
              f"cxl0 (d) transform: after recovery {got}, {again.state}")
    finally:
        shutil.rmtree(pool, ignore_errors=True)
    print("cxl0 (d): ctx.transform(CounterSpec()): crash after op 40, "
          "recovered at ops_done 40 with the counter at 41, ran on to 64",
          flush=True)
    out["d"]["transform"] = dict(ops=64, crash_after=40, ops_done=40)
    return out


FEATURE_SCHEDULES = (("sync", None), ("async", None), ("sharded", 4),
                     ("sharded-async", None))     # (mode, n_shards)
#: one olmo-1b kvblk/ object at ``OLMO_LAYERS``: k + v of 16 tokens,
#: 131,072 bytes a layer
KVBLK_BYTES = 131_072 * OLMO_LAYERS


def durable_tick(mode: str, crash_ticks: int, every: int):
    """The tick a crash after ``crash_ticks`` ticks resumes from: the last
    commit under a blocking schedule, the one before it under an async
    one (commit(s) publishes s - every and launches s)."""
    ticks = list(range(every, crash_ticks + 1, every))
    if mode in ("async", "sharded-async"):
        ticks = ticks[:-1]
    return ticks[-1] if ticks else None


def phase_features(torch, cfg, trace, t_max, counters) -> dict:
    """9. The serving features on olmo-1b at full width (at the depth
    ``cfg`` has; see the docstring): (a) the four commit schedules and a
    crash under sharded-async, (b) the static baseline, (c) prefix reuse
    across two engines on one pool.  Every run is driven with the launch
    counts set to 0 just before it and read just after."""
    from repro_torch.dsm import stream
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace
    from repro_torch.utils.tree import tree_leaves
    arch = cfg.arch_id
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_features_")
    out = {"runs": {}, "launches": {}}

    def engine(pool=None, **kw):
        kw = {**PATH_KW, **kw}
        if pool is None:
            kw["commit_every"] = 0
        return build_serve_engine(
            arch, smoke=False, t_max=t_max, bundle=bundle, params=params,
            device="cuda", pool_path=pool and os.path.join(tmp, pool),
            **kw)[0]

    def drive(name, fn, e):
        timer = PhaseTimer(e)
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["launches"][name] = read_counts(counters)
        run = dict(wall_s=dt, tokens_per_s=res.emitted_tokens / dt,
                   decode_ticks=res.decode_ticks, prefills=res.prefills,
                   commits=res.commits, prefix_hits=res.prefix_hits,
                   host_s=dict(timer.t), launches=out["launches"][name])
        if e.store is not None:
            # objects the completeOps published as fresh flushes (a
            # sharded object counts once, whatever its shards)
            run.update(d2h_bytes=e.store.tiers.d2h_gather_bytes,
                       flushed=sum(st.n_objects
                                   for st in e.store.committer.stats),
                       n_shards=e.store.committer.n_shards)
        out["runs"][name] = run
        return res, run

    try:
        # -- (a) the four schedules ----------------------------------------
        outs = {}
        for mode, shards in FEATURE_SCHEDULES:
            e = engine(mode, commit_mode=mode, n_shards=shards)
            res, run = drive(mode, lambda: e.run(trace), e)
            e.close()
            outs[mode] = res.outputs
            check((res.decode_ticks, res.prefills, res.commits)
                  == (97, 16, 25),
                  f"(a) {mode}: {res.decode_ticks} ticks, {res.prefills} "
                  f"prefills, {res.commits} commits; expected 97, 16, 25")
            check(run["launches"]["flash_attention"] == n_attn * 16,
                  f"(a) {mode}: {run['launches']['flash_attention']} flash "
                  f"launches, expected {n_attn} x 16")
            check(run["d2h_bytes"] == FEATURES_D2H_BYTES,
                  f"(a) {mode}: D2H {run['d2h_bytes']} bytes, expected "
                  f"{FEATURES_D2H_BYTES}")
            diff = [r for r in outs["sync"] if res.outputs[r]
                    != outs["sync"][r]]
            check(not diff, f"(a) {mode}: tokens differ from sync's for "
                            f"{diff}")
        runs = out["runs"]
        check(runs["sharded"]["flushed"] == runs["sync"]["flushed"]
              and runs["sharded-async"]["flushed"]
              == runs["async"]["flushed"],
              f"(a) flushed objects: " + ", ".join(
                  f"{m} {runs[m]['flushed']}" for m, _ in FEATURE_SCHEDULES)
              + "; expected sharded = sync and sharded-async = async")
        print("features (a): " + arch + " 16 requests prompt 512 under "
              "each schedule, tokens bit-identical to sync's, 97 ticks, 16 "
              "prefills, 25 commits, D2H " + str(FEATURES_D2H_BYTES)
              + " bytes in each; " + "; ".join(
                  f"{m} (n_shards {runs[m]['n_shards']}): "
                  f"{runs[m]['tokens_per_s']:.1f} tok/s, wall "
                  f"{runs[m]['wall_s']:.3f}s, host s in commit "
                  f"{runs[m]['host_s']['commit']:.3f} decode "
                  f"{runs[m]['host_s']['decode']:.3f} admit "
                  f"{runs[m]['host_s']['admit']:.3f}, "
                  f"{runs[m]['flushed']} objects flushed"
                  for m, _ in FEATURE_SCHEDULES), flush=True)

        crash_ticks, mode = 10, "sharded-async"
        e = engine("crash", commit_mode=mode)
        e.submit(trace)
        for _ in range(crash_ticks):
            e.tick()
        e.store.ctx.crash()
        del e
        e = engine("crash", commit_mode=mode)
        step = e.resume()
        res = e.run(trace)
        e.close()
        want = durable_tick(mode, crash_ticks, PATH_KW["commit_every"])
        check(step == want, f"(a) {mode}: resumed at tick {step}, "
                            f"expected {want}")
        diff = [r for r in outs["sync"] if res.outputs.get(r)
                != outs["sync"][r]]
        check(not diff, f"(a) {mode} resume: tokens differ for {diff}")
        out["resume"] = dict(mode=mode, crash_after_ticks=crash_ticks,
                             resumed_tick=step,
                             sessions_resumed=res.resumed_sessions,
                             prefills_after_resume=res.prefills)
        print(f"features (a): {mode} crashed after {crash_ticks} ticks, "
              f"resumed from committed tick {step} (one commit behind), "
              f"{res.resumed_sessions} sessions resumed, {res.prefills} "
              f"prefills after resume, every session's tokens "
              f"bit-identical", flush=True)

        # -- (b) the static baseline ---------------------------------------
        e = engine()
        res_c, cont = drive("continuous", lambda: e.run(trace), e)
        e = engine()
        res_s, stat = drive("static", lambda: e.run_static(trace), e)
        check((res_s.prefills, res_s.decode_ticks) == (4, 172),
              f"(b) static: {res_s.prefills} prefills, "
              f"{res_s.decode_ticks} ticks; expected 4, 172")
        check(stat["launches"]["flash_attention"] == n_attn * 4,
              f"(b) static: {stat['launches']['flash_attention']} flash "
              f"launches, expected {n_attn} x 4")
        check(res_s.emitted_tokens == res_c.emitted_tokens
              and sorted(res_s.outputs) == sorted(res_c.outputs),
              "(b) static and continuous emitted different counts")
        same = sum(res_s.outputs[r] == res_c.outputs[r]
                   for r in res_c.outputs)
        stat["streams_equal_continuous"] = same
        print(f"features (b): static B=4: {res_s.prefills} prefills, "
              f"{res_s.decode_ticks} decode ticks, "
              f"{stat['launches']['flash_attention']} flash launches, "
              f"{stat['tokens_per_s']:.1f} tok/s (wall {stat['wall_s']:.3f}s)"
              f" against continuous {cont['tokens_per_s']:.1f} tok/s (wall "
              f"{cont['wall_s']:.3f}s, {res_c.decode_ticks} ticks, no pool); "
              f"{same} of {len(res_c.outputs)} token streams equal "
              f"continuous's", flush=True)

        # -- (c) prefix reuse across engines ---------------------------------
        shared = synthetic_trace(16, seed=0, prompt_lens=(512,),
                                 new_tokens=(4, 8, 16, 32, 48),
                                 vocab_size=cfg.vocab_size, n_prompts=2)
        e = engine("prefix", prefix_reuse=True)
        res0, r0 = drive("prefix engine 0", lambda: e.run(shared), e)
        e.close()
        e = engine("prefix", prefix_reuse=True, engine_id=3)
        res3, r3 = drive("prefix engine 3", lambda: e.run(shared), e)
        e.close()
        check((res0.prefills, res0.prefix_hits) == (2, 14),
              f"(c) engine 0: {res0.prefills} prefills, {res0.prefix_hits} "
              f"hits; expected 2, 14")
        check((res3.prefills, res3.prefix_hits,
               r3["launches"]["flash_attention"]) == (0, 16, 0),
              f"(c) engine 3: {res3.prefills} prefills, {res3.prefix_hits} "
              f"hits, {r3['launches']['flash_attention']} flash launches; "
              f"expected 0, 16, 0")
        check(res3.outputs == res0.outputs,
              "(c) engine 3's tokens differ from engine 0's")
        lane = sum(l.nbytes for l in tree_leaves(bundle.abstract_caches(
            1, t_max)))
        check((r0["d2h_bytes"], r3["d2h_bytes"])
              == (FEATURES_D2H_BYTES + 2 * lane, FEATURES_D2H_BYTES),
              f"(c) D2H bytes {r0['d2h_bytes']} / {r3['d2h_bytes']}: "
              f"expected (a)'s {FEATURES_D2H_BYTES} plus one lane a "
              f"publish ({lane}) / none")
        objs = os.path.join(tmp, "prefix", "objects")
        found = {}
        for kind in ("kvblk", "kvhead"):
            d = os.path.join(objs, kind)
            names = sorted(os.listdir(d)) if os.path.isdir(d) else []
            found[kind] = names
            for n in names:
                files = sorted(os.listdir(os.path.join(d, n)))
                check(files == ["00000001.cxl0"],
                      f"(c) {kind}/{n}: files {files}, expected one write")
                leaves, _, _ = stream.read_frame(os.path.join(d, n,
                                                              files[0]))
                if kind == "kvblk":
                    nb = sum(l.nbytes for l in leaves)
                    check(nb == KVBLK_BYTES, f"(c) kvblk/{n}: {nb} bytes")
        check((len(found["kvblk"]), len(found["kvhead"])) == (64, 2),
              f"(c) {len(found['kvblk'])} kvblk and {len(found['kvhead'])} "
              f"kvhead objects; expected 64 and 2")
        out["prefix"] = dict(kvblk=len(found["kvblk"]),
                             kvhead=len(found["kvhead"]))
        print(f"features (c): 16 requests over 2 prompts: engine 0 "
              f"{res0.prefills} prefills, {res0.prefix_hits} hits, "
              f"{r0['tokens_per_s']:.1f} tok/s; engine 3 on the same pool "
              f"{res3.prefills} prefills, {res3.prefix_hits} hits, "
              f"{r3['launches']['flash_attention']} flash launches, "
              f"{r3['tokens_per_s']:.1f} tok/s, tokens bit-identical to "
              f"engine 0's; pool: {len(found['kvblk'])} kvblk objects of "
              f"{KVBLK_BYTES} bytes and {len(found['kvhead'])} kvhead "
              f"objects, each written once", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


FLEET_REQUESTS = 24                # the fleet bench's trace at prompt 512
FLEET_NEW_TOKENS = (4, 8, 16, 24)
FLEET_KW = dict(n_slots=2, commit_every=4, prefix_reuse=True)
FLEET_TOPOLOGY = "cxl20-switched-pool"


def staged_bytes(pool: str, engine: int) -> tuple:
    """(frames, payload bytes) staged INTO ``engine``'s buffer of the fleet
    whose pool is ``pool``, read from the frames' headers."""
    from repro_torch.dsm import stream
    area = os.path.join(pool, "staging", f"w{engine}")
    names = sorted(f for f in os.listdir(area) if f.endswith(".cxl0")) \
        if os.path.isdir(area) else []
    return len(names), sum(sum(stream.read_header(os.path.join(area, f))[0]
                               ["nbytes"]) for f in names)


def phase_fleet(torch, cfg, counters) -> dict:
    """10. N serving engines over one pool on olmo-1b at full width (at
    the depth ``cfg`` has; see the docstring): (a) one engine, then a
    2-engine fleet with rebalancing, (b) engine 3 on the fleet's pool,
    (c) a forced live migration, (d) a kill at ``mig_commit`` with engine
    2's staging buffer wiped and a fresh fleet's resume, (e) the fleet
    under ``auto`` on the switched-pool topology.  Every run is driven
    with the launch counts set to 0 just before it and read just after."""
    from repro_torch.bench.serve import force_migration
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.fleet import FleetController, MIGRATION_POINTS
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    arch = cfg.arch_id
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    trace = synthetic_trace(FLEET_REQUESTS, seed=0, prompt_lens=(512,),
                            new_tokens=FLEET_NEW_TOKENS,
                            vocab_size=cfg.vocab_size, n_prompts=2)
    t_max = trace_t_max(trace)
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    out = {"runs": {}, "launches": {}}
    kw = dict(smoke=False, t_max=t_max, bundle=bundle, params=params,
              device="cuda", **FLEET_KW)

    def fleet(pool, **more):
        return FleetController(arch, pool_path=os.path.join(tmp, pool),
                               n_engines=2, **kw, **more)

    def drive(name, fn, engines):
        timers = {i: PhaseTimer(e) for i, e in engines.items()}
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["launches"][name] = read_counts(counters)
        per = getattr(res, "per_engine", None) or {0: res}
        run = dict(wall_s=dt, tokens_per_s=res.emitted_tokens / dt,
                   emitted_tokens=res.emitted_tokens,
                   launches=out["launches"][name], engines={
                       i: dict(decode_ticks=r.decode_ticks,
                               prefills=r.prefills, commits=r.commits,
                               prefix_hits=r.prefix_hits,
                               emitted_tokens=r.emitted_tokens,
                               tokens_per_s=r.emitted_tokens / dt,
                               migrated_in=r.migrated_in,
                               migrated_out=r.migrated_out,
                               host_s=dict(timers[i].t) if i in timers
                               else None)
                       for i, r in per.items()})
        out["runs"][name] = run
        return res, run

    def flash_is_per_prefill(name, res):
        per = getattr(res, "per_engine", None) or {0: res}
        prefills = sum(r.prefills for r in per.values())
        got = out["launches"][name]["flash_attention"]
        check(got == n_attn * prefills,
              f"{name}: {got} flash launches, expected {n_attn} x "
              f"{prefills} prefills")
        return got

    def engines_line(run):
        return "; ".join(
            f"e{i}: {e['emitted_tokens']} tokens ({e['tokens_per_s']:.1f} "
            f"tok/s of the fleet's wall), {e['decode_ticks']} ticks, "
            f"{e['prefills']} prefills, {e['prefix_hits']} hits, "
            f"{e['commits']} commits, migrated in/out {e['migrated_in']}/"
            f"{e['migrated_out']}" + (
                f", host s admit {e['host_s']['admit']:.3f} decode "
                f"{e['host_s']['decode']:.3f} commit "
                f"{e['host_s']['commit']:.3f}" if e["host_s"] else "")
            for i, e in sorted(run["engines"].items()))

    def one_owner(res):
        served = [r for e in res.per_engine.values() for r in e.outputs]
        return len(served) == len(set(served)) == len(trace)

    try:
        # -- (a) one engine, then the fleet ---------------------------------
        single, _ = build_serve_engine(
            arch, pool_path=os.path.join(tmp, "single"), **kw)
        res1, run1 = drive("single", lambda: single.run(trace),
                           {0: single})
        single.close()
        want = res1.outputs
        fl = fleet("fleet")
        resf, runf = drive("fleet", lambda: fl.run(trace), fl.engines)
        diff = [r for r in want if resf.outputs.get(r) != want[r]]
        check(not diff, f"(a) fleet tokens differ from one engine's for "
                        f"{diff}")
        rounds = max(r.decode_ticks for r in resf.per_engine.values())
        speedup = ((resf.emitted_tokens / rounds)
                   / (res1.emitted_tokens / res1.decode_ticks))
        check(speedup >= 1.6, f"(a) fleet speedup {speedup:.3f} per round "
                              f"< serve.json's 1.6")
        admits = [d.choice for d in fl.policy.decisions_for("admit")]
        moves = [(r, s_, d_) for p_, r, s_, d_ in fl.migration_log
                 if p_ == "mig_release"]
        check(resf.migrations == len(moves), "(a) migration log")
        f1, ff = (flash_is_per_prefill("single", res1),
                  flash_is_per_prefill("fleet", resf))
        check(f1 > 0 and ff > 0, "(a) no flash launch on a prefill")
        out["fleet"] = dict(speedup=speedup, single_ticks=res1.decode_ticks,
                            rounds=rounds, admissions=admits,
                            migrations=moves)
        print(f"fleet (a): {arch} {FLEET_REQUESTS} requests over 2 prompts, "
              f"prompt 512, budgets {FLEET_NEW_TOKENS}, 2 slots an engine, "
              f"commit every 4 ticks: one engine {res1.decode_ticks} decode "
              f"ticks, {res1.prefills} prefills, {res1.prefix_hits} hits, "
              f"{f1} flash launches, {run1['tokens_per_s']:.1f} tok/s (wall "
              f"{run1['wall_s']:.3f}s), host s admit "
              f"{run1['engines'][0]['host_s']['admit']:.3f} decode "
              f"{run1['engines'][0]['host_s']['decode']:.3f} commit "
              f"{run1['engines'][0]['host_s']['commit']:.3f}; 2-engine "
              f"fleet {rounds} rounds, {ff} flash launches, "
              f"{runf['tokens_per_s']:.1f} tok/s (wall {runf['wall_s']:.3f}s)"
              f", tokens bit-identical to one engine's; speedup per round "
              f"{speedup:.3f} (serve.json: >= 1.6); admissions "
              f"{' '.join(admits)}; {len(moves)} "
              f"rebalancing migrations {moves}; {engines_line(runf)}",
              flush=True)

        # -- (b) engine 3 on the fleet's pool --------------------------------
        e3, _ = build_serve_engine(
            arch, pool_path=os.path.join(tmp, "fleet"), engine_id=3, **kw)
        res3, run3 = drive("engine 3", lambda: e3.run(trace), {3: e3})
        e3.close()
        fl.close()
        del fl
        check((res3.prefills, res3.prefix_hits,
               run3["launches"]["flash_attention"])
              == (0, FLEET_REQUESTS, 0),
              f"(b) engine 3: {res3.prefills} prefills, {res3.prefix_hits} "
              f"hits, {run3['launches']['flash_attention']} flash launches; "
              f"expected 0, {FLEET_REQUESTS}, 0")
        check(res3.outputs == want, "(b) engine 3's tokens differ from (a)")
        print(f"fleet (b): engine 3 on the fleet's pool: {res3.prefills} "
              f"prefills, {res3.prefix_hits} hits, "
              f"{run3['launches']['flash_attention']} flash launches, "
              f"{run3['tokens_per_s']:.1f} tok/s, tokens bit-identical to "
              f"(a)", flush=True)

        # -- (c) a forced live migration ------------------------------------
        handoff = {}

        def at_point(point, rid=None, src=None, dst=None):
            if point == "mig_commit":
                eng = flm.engines[src]
                handoff.update(
                    rid=rid, fresh=eng.store.committer.stats[-1].n_objects,
                    manifest=len(eng.store.peek_engine(src)["objects"]))
        flm = fleet("mig", mig_hook=at_point)
        moved_box = []

        def run_migration():
            res, rid = force_migration(flm, trace)
            moved_box.append(rid)
            return res
        resm, runm = drive("migration", run_migration, flm.engines)
        moved = moved_box[0]
        d2h = {i: e.store.tiers.d2h_gather_bytes
               for i, e in flm.engines.items()}
        flm.close()
        frames, nbytes = staged_bytes(os.path.join(tmp, "mig"), 2)
        loss = res1.emitted_tokens - resm.emitted_tokens
        check(moved is not None and resm.migrations == 1
              and [p_ for p_, r, *_ in flm.migration_log if r == moved]
              == list(MIGRATION_POINTS), "(c) the migration did not run "
                                         "its four phases")
        check(loss == 0 and resm.outputs == want,
              f"(c) token loss {loss}, outputs equal: "
              f"{resm.outputs == want}")
        check(frames > 0 and handoff.get("rid") == moved,
              f"(c) {frames} frames staged into engine 2's buffer")
        flash_is_per_prefill("migration", resm)
        out["migration"] = dict(rid=moved, staged_frames=frames,
                                staged_bytes=nbytes, d2h_bytes=d2h,
                                handoff=handoff)
        print(f"fleet (c): {moved} live-migrated from engine 1 to engine 2 "
              f"at engine 1's tick 3: token loss 0, outputs bit-identical "
              f"to (a); {frames} frames of {nbytes} bytes staged into "
              f"engine 2's buffer; D2H bytes e1 {d2h[1]} e2 {d2h[2]}; the "
              f"handoff commit flushed {handoff['fresh']} objects, its "
              f"manifest holds {handoff['manifest']}; "
              f"{runm['tokens_per_s']:.1f} tok/s; {engines_line(runm)}",
              flush=True)

        # -- (d) kill at mig_commit, staging wiped, resume ------------------
        class Kill(Exception):
            pass

        def kill(point, rid=None, src=None, dst=None):
            if point == "mig_commit":
                raise Kill(rid)
        flk = fleet("kill", mig_hook=kill)
        try:
            force_migration(flk, trace)
            check(False, "(d) the kill at mig_commit never fired")
        except Kill as e:
            killed = str(e)
        del flk                       # the fleet process is dead
        fl2 = fleet("kill")
        fl2.staging.wipe(2)
        hits = []
        view = fl2.staging.view

        def counted_view(rank, templates):
            got = view(rank, templates)
            hits.append(len(got.staging))
            return got
        fl2.staging.view = counted_view
        steps = fl2.resume()
        fl2.staging.view = view
        adopted = list(fl2.migration_log)
        resd, rund = drive("resume", lambda: fl2.run(trace), fl2.engines)
        fl2.close()
        check([p_ for p_, r, *_ in adopted if r == killed]
              == ["mig_adopt", "mig_release"] and hits and not any(hits),
              f"(d) the resume did not adopt {killed} from the pool arm "
              f"(log {adopted}, staged hits {hits})")
        check(resd.outputs == want, "(d) resumed streams differ from (a)")
        check(one_owner(resd), "(d) a session has more or less than one "
                               "owner")
        print(f"fleet (d): killed at mig_commit of {killed}, engine 2's "
              f"staging wiped, a fresh fleet resumed (ticks "
              f"{ {i: s_ for i, s_ in steps.items()} }) and adopted it from "
              f"the pool arm (0 staged hits); every stream bit-identical "
              f"to (a), one owner per session; {rund['tokens_per_s']:.1f} "
              f"tok/s", flush=True)

        # -- (e) the fleet under auto on the switched pool --------------------
        fla = fleet("auto", commit_mode="auto", topology=FLEET_TOPOLOGY)
        resa, runa = drive("auto", lambda: fla.run(trace), fla.engines)
        chosen = {}
        for i, e in fla.engines.items():
            pol = e.store.placement
            chosen[i] = dict(
                schedule=e.store.committer.mode,
                n_shards=e.store.committer.n_shards,
                decisions=[(d.kind, d.nbytes, d.choice, d.costs)
                           for d in pol.decisions])
        fla.close()
        check(resa.outputs == want, "(e) auto's tokens differ from (a)")
        same = {i: (e["decode_ticks"], e["prefills"], e["prefix_hits"],
                    e["commits"], e["migrated_in"], e["migrated_out"])
                for i, e in runa["engines"].items()} == \
            {i: (e["decode_ticks"], e["prefills"], e["prefix_hits"],
                 e["commits"], e["migrated_in"], e["migrated_out"])
             for i, e in runf["engines"].items()}
        check(same and resa.migrations == resf.migrations,
              f"(e) counts under auto differ from (a)'s sync fleet: "
              f"{runa['engines']} vs {runf['engines']}")
        flash_is_per_prefill("auto", resa)
        out["auto"] = chosen
        print(f"fleet (e): --commit-mode auto --topology {FLEET_TOPOLOGY}: "
              + "; ".join(
                  f"e{i} chose {c['schedule']} with {c['n_shards']} shard(s)"
                  f", priced (modelled CXL ns, not measured): "
                  + ", ".join(f"{k} {nb} B -> {ch} {costs}"
                              for k, nb, ch, costs in c["decisions"])
                  for i, c in sorted(chosen.items()))
              + f"; tokens and counts equal (a)'s under sync; "
              f"{runa['tokens_per_s']:.1f} tok/s; {engines_line(runa)}",
              flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 11 trains olmo-1b at full width with its depth cut from 16 layers
#: to 2, to keep the script within its time limit beside phases 14 and 19
#: (each full-depth commit of 11.8 GB took ~23 host s; at 4 layers the
#: phase took 36.5 s)
TRAIN_LAYERS = 2
#: the cut model's parameters (``ModelConfig.param_count``; 1,176,764,416
#: at 16 layers, 371,458,048 at 4) and its committed bytes: params bf16 +
#: mu and nu fp32 + 28 bytes of counters (int32 step, (2,) uint32 key
#: data) and pipeline (two int64)
TRAIN_PARAMS = 237_240_320
TRAIN_CKPT_BYTES = 2_372_403_228
#: phase 11's run: the reference launcher's batch and sequence
#: (``repro/launch/train.py`` defaults), 8 steps, a sync commit every 4,
#: two manifests kept
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_KW = dict(n_steps=8, commit_every=4, commit_mode="sync", retention=2)
#: retention 2 keeps at most three ~2.4 GB commits on disk at once
TRAIN_DISK_BYTES = 12e9


def _loss_and_grad_norm(torch, bundle, params, batch, held=()) -> tuple:
    """The loss and the global grad norm of one batch (no update), and
    with ``held`` the grad norm of the leaves under those dict keys."""
    from repro_torch.utils.tree import tree_flatten, tree_leaves
    leaves, treedef = tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = bundle.loss(treedef.unflatten(live), batch)
    grads = torch.autograd.grad(loss, live)
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    if not held:
        return float(loss.detach()), float(norm)
    ids = set()

    def walk(t):
        for k, v in (t.items() if isinstance(t, dict) else enumerate(t)):
            if k in held:
                ids.update(id(x) for x in tree_leaves(v))
            elif isinstance(v, (dict, list, tuple)):
                walk(v)

    walk(params)
    part = torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for x, g in zip(leaves, grads) if id(x) in ids))
    return float(loss.detach()), float(norm), float(part)


def _timing_means(r) -> tuple:
    comp = [t.compute_s for t in r.timings if t.compute_s]
    commits = [t.commit_s for t in r.timings if t.commit_s]
    return (statistics.mean(comp) * 1e3 if comp else 0.0,
            statistics.mean(commits) if commits else 0.0, len(commits))


def clean_run(torch, step, state0, pipe, n_steps: int) -> tuple:
    """``n_steps`` of the train step on ``pipe``'s batches, as
    ``run_durable_loop`` feeds them, with no commit: (state, pipeline state,
    losses, host s of each step, wall s)."""
    import numpy as np
    state, losses, step_s = state0, [], []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                 for k, v in pipe.next_global().items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    return state, pipe.state, losses, step_s, time.perf_counter() - t0


def phase_train(torch, cfg, counters) -> dict:
    """Phase 11: durable training of olmo-1b at full width and depth
    through the hand-written forward and backward kernels (see the module
    docstring)."""
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.models.registry import build
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    L = cfg.n_layers
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"train: free disk in {tmp}: {free / 1e9:.1f} GB", flush=True)
    check(free >= TRAIN_DISK_BYTES,
          f"train: the temp filesystem {tmp} holds {free / 1e9:.1f} GB free; "
          f"phase 11 keeps up to three ~2.4 GB commits (retention 2) and "
          f"needs ~{TRAIN_DISK_BYTES / 1e9:.0f} GB")
    out = {}
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == TRAIN_PARAMS == cfg.param_count(),
          f"train: olmo-1b at {L} layers holds {n_params} params, expected "
          f"{TRAIN_PARAMS}")

    # (a) the kernel path against the plain path: one (1, 64) batch
    tok = torch.randint(0, cfg.vocab_size, (1, 65),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    reset_counts(counters)
    card = _loss_and_grad_norm(torch, bundle, params,
                               {k: v.cuda() for k, v in batch.items()})
    a_launches = read_counts(counters)
    cpu_cfg = cfg.with_(param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    plain = _loss_and_grad_norm(torch, build(cpu_cfg, device="cpu"),
                                tree_map(lambda x: x.float().cpu(), params),
                                batch)
    cpu_s = time.perf_counter() - t0
    rel = [abs(c - p) / abs(p) for c, p in zip(card, plain)]
    out["kernel_vs_plain"] = dict(card=card, cpu_fp32=plain, rel=rel,
                                  launches=a_launches, cpu_s=cpu_s)
    print(f"train (a): olmo-1b (1, 64) loss {card[0]:.6f} grad norm "
          f"{card[1]:.6f} on the card (bf16, kernels: "
          f"{a_launches['flash_attention']} forward, "
          f"{a_launches['flash_attention_bwd']} backward launches) vs "
          f"{plain[0]:.6f} / {plain[1]:.6f} plain fp32 on the CPU "
          f"({cpu_s:.1f} s); rel {rel[0]:.2e} / {rel[1]:.2e} (tol 2e-2)",
          flush=True)
    check(max(rel) <= TOL, f"train (a): card vs plain rel {rel} > {TOL}")
    check(a_launches["flash_attention"] == 2 * L
          and a_launches["flash_attention_bwd"] == L,
          f"train (a): launches {a_launches}, expected {2 * L} forward "
          f"(remat runs each twice) and {L} backward")

    # (b) the clean run: the loop's steps on its pipeline, no commit
    state0 = init_train_state(params, 0, cfg.moment_dtype)
    step = make_train_step(bundle)

    def pipeline():
        return DataPipeline(SyntheticLMSource(cfg.vocab_size), TRAIN_BATCH,
                            TRAIN_SEQ)

    n_steps = TRAIN_KW["n_steps"]
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    rb_state, rb_pipe, losses_b, step_s, wall_b = clean_run(
        torch, step, state0, pipeline(), n_steps)
    b_launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.mean(step_s[1:]) * 1e3
    moved = sum(int((a != b).sum()) for a, b in
                zip(tree_leaves(rb_state.params), tree_leaves(params)))
    out["clean"] = dict(losses=losses_b, wall_s=wall_b, step_ms=step_ms,
                        step_s=step_s, launches=b_launches, peak_gb=peak_gb,
                        params_moved=moved)
    print(f"train (b): {n_steps} steps of ({TRAIN_BATCH}, {TRAIN_SEQ}), no "
          f"commit: losses {[round(x, 6) for x in losses_b]}; {step_ms:.1f} "
          f"ms a step (compute, steps 1-{n_steps - 1}; step 0 "
          f"{step_s[0] * 1e3:.1f} ms), wall {wall_b:.1f} s; launches "
          f"{b_launches}; peak {peak_gb:.2f} GB; bf16 param elements moved "
          f"{moved} of {n_params}", flush=True)
    check(int(rb_state.opt.step) == n_steps,
          f"train (b): opt step {int(rb_state.opt.step)}")
    check(all(math.isfinite(x) for x in losses_b) and len(losses_b)
          == n_steps, f"train (b): losses {losses_b}")
    check(b_launches["flash_attention"] == n_steps * 2 * L
          and b_launches["flash_attention_bwd"] == n_steps * L,
          f"train (b): launches {b_launches}, expected {n_steps * 2 * L} "
          f"forward and {n_steps * L} backward")

    # (c) the durable run: a sync commit every 4 steps, two manifests kept,
    # a crash before the commit of step 6, recovery, the end
    pool_c = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = run_durable_loop(step, state0, pipeline(), pool_c, **TRAIN_KW,
                              crash_at={6: "before_commit"})
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        c_launches = read_counts(counters)
        man = DSMPool(pool_c).latest_manifest()
        n_manifests = len(DSMPool(pool_c).manifests_desc())
    finally:
        shutil.rmtree(pool_c, ignore_errors=True)
    nbytes = sum(o["nbytes"] for o in man["objects"].values())
    check(rc.crashes == 1 and rc.recoveries == ["pool"],
          f"train (c): {rc.crashes} crashes, recoveries {rc.recoveries}")
    # steps 0-6, then 4-7 again from the commit of step 3
    check(len(rc.losses) == n_steps + 3,
          f"train (c): {len(rc.losses)} losses, expected steps 0-6 then "
          f"4-7")
    check(rc.losses[-4:] == losses_b[4:],
          f"train (c): losses of steps 4-7 {rc.losses[-4:]} != clean "
          f"{losses_b[4:]}")
    same = {
        "params": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.params), tree_leaves(rb_state.params))),
        "opt_mu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.mu), tree_leaves(rb_state.opt.mu))),
        "opt_nu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.nu), tree_leaves(rb_state.opt.nu))),
        "opt_step": int(rc.state.opt.step) == int(rb_state.opt.step),
        "rng": torch.equal(rc.state.rng, rb_state.rng),
        "pipeline": rc.pipeline_state == rb_pipe,
    }
    step_ms_c, commit_s, n_commits = _timing_means(rc)
    out["crash"] = dict(losses=rc.losses, wall_s=wall_c, step_ms=step_ms_c,
                        commit_s=commit_s, commits_timed=n_commits,
                        ckpt_bytes_per_commit=nbytes, launches=c_launches,
                        recoveries=rc.recoveries, manifests_kept=n_manifests,
                        bit_identical=same)
    print(f"train (c): sync every 4, crash before the commit of step 6: "
          f"{rc.crashes} crash, recoveries {rc.recoveries}, resumed at step "
          f"4; losses of steps 4-7 bit-identical to (b)'s; bit-identical to "
          f"(b): {same}; wall {wall_c:.1f} s, {step_ms_c:.1f} ms a step, "
          f"{commit_s:.3f} host s a commit ({n_commits} timed); "
          f"ckpt_bytes_per_commit {nbytes}; manifests kept {n_manifests}; "
          f"launches {c_launches}", flush=True)
    check(all(same.values()), f"train (c): not bit-identical: {same}")
    check(nbytes == TRAIN_CKPT_BYTES,
          f"train (c): {nbytes} bytes a commit, expected {TRAIN_CKPT_BYTES}")
    check(man["step"] == n_steps - 1 and n_manifests == TRAIN_KW["retention"],
          f"train (c): newest manifest step {man['step']}, {n_manifests} "
          f"kept")
    check(c_launches["flash_attention"] == len(rc.losses) * 2 * L
          and c_launches["flash_attention_bwd"] == len(rc.losses) * L,
          f"train (c): launches {c_launches}, expected {len(rc.losses)} "
          f"steps of {2 * L} forward and {L} backward")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train: phase 11 took {out['phase_s']:.1f} s", flush=True)
    out["launches"] = {"train (a)": a_launches, "train (b)": b_launches,
                       "train (c)": c_launches}
    return out


#: phase 17 trains olmoe-1b-7b at full width with its depth cut from 16
#: layers to 1: 16 layers hold 6,919,028,736 params, a 69.2 GB state (bf16
#: params, fp32 mu and nu) that the out-of-place update holds twice; 1
#: layer leaves room in the time limit for phase 18.  A single layer is
#: a group of one repeat, so remat recomputes nothing
MOE_TRAIN_LAYERS = 1
#: ``ModelConfig.param_count`` at 1 layer (the analytic count, equal to the
#: reference's) and the params the bundle holds, which add the 6,400 norm
#: scales it leaves out (two block norms and the q / k norms, and the
#: final norm)
MOE_TRAIN_PARAM_COUNT = 625_606_656
MOE_TRAIN_PARAMS = 625_613_056
#: the held params (bf16, the router's 131,072 fp32) + mu and nu fp32 + 28
#: bytes of counters and pipeline
MOE_TRAIN_CKPT_BYTES = 6_256_392_732
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 512
MOE_TRAIN_STEPS = 4
#: (c): a sync commit every 2 steps, one manifest kept, a crash before the
#: commit of step 3 (recovered from the commit of step 1)
MOE_TRAIN_KW = dict(n_steps=MOE_TRAIN_STEPS, commit_every=2,
                    commit_mode="sync", retention=1)
MOE_TRAIN_CRASH = {3: "before_commit"}
#: retention 1 keeps one commit on disk and writes the next beside it
MOE_TRAIN_DISK_BYTES = 15e9


def moe_step_launches(cfg, seq: int) -> dict:
    """Kernel launches of one olmoe train step (``with_remat``): the
    grouped matmul 3 times a MoE layer a forward pass and flash once an
    attention, each forward twice when the stacked group repeats (remat
    recomputes it); dx, dw and the flash backward once each a backward,
    whatever the sequence length."""
    L = cfg.n_layers
    passes = 2 if L > 1 else 1
    return {"flash_attention": passes * L, "flash_attention_bwd": L,
            "grouped_matmul": 3 * passes * L, "grouped_matmul_dx": 3 * L,
            "grouped_matmul_dw": 3 * L, "wkv6": 0, "wkv6_bwd": 0,
            "selective_scan": 0, "selective_scan_bwd": 0}


def phase_moe_train(torch, cfg, counters) -> dict:
    """Phase 17: durable training of olmoe-1b-7b at full width through the
    flash forward and backward and the grouped matmul's forward, dx and dw
    kernels (see the module docstring)."""
    return durable_train_cell(torch, cfg, counters, TrainCell(
        label="moe train", phase=17, param_count=MOE_TRAIN_PARAM_COUNT,
        params=MOE_TRAIN_PARAMS, ckpt_bytes=MOE_TRAIN_CKPT_BYTES,
        batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, kw=MOE_TRAIN_KW,
        crash=MOE_TRAIN_CRASH, disk_bytes=MOE_TRAIN_DISK_BYTES,
        per_step=moe_step_launches))


#: phase 18 trains rwkv6-7b at full width with its depth cut from 32 layers
#: to 2: 32 layers hold 7,577,018,368 params, a 75.8 GB state (bf16 params,
#: fp32 mu and nu) that the out-of-place update holds twice.  Two layers are
#: one stacked group of two repeats, so remat recomputes each WKV forward
#: and the backward runs on the recompute's saved tensors
RWKV_TRAIN_LAYERS = 2
#: ``ModelConfig.param_count`` at 2 layers (the analytic count, equal to the
#: reference's) and the params the bundle holds, which add the 131,072 it
#: leaves out (the block norms' scales and biases, the token-shift mixes,
#: the decay biases and the group norms' parameters, and the final norm)
RWKV_TRAIN_PARAM_COUNT = 976_756_736
RWKV_TRAIN_PARAMS = 976_887_808
#: the held params (bf16) + mu and nu fp32 + 28 bytes of counters and
#: pipeline
RWKV_TRAIN_CKPT_BYTES = 9_768_878_108
RWKV_TRAIN_STEPS = 4
#: as phase 17's (c): sync commits every 2 steps, one manifest kept, a
#: crash before the commit of step 3
RWKV_TRAIN_KW = dict(n_steps=RWKV_TRAIN_STEPS, commit_every=2,
                     commit_mode="sync", retention=1)
#: retention 1 keeps one ~9.8 GB commit on disk and writes the next beside
#: it
RWKV_TRAIN_DISK_BYTES = 22e9
#: (a)'s bound on the bf16 grad norm against the CPU's fp32 one.  Where a
#: head's WKV output at t = 0, y_0 = (r_0 . (u * k_0)) v_0, has a variance
#: near the group norm's eps (64e-5), the norm's gradient there is steep
#: and set by a cancelling bf16 dot product, and every leaf below it moves
#: with it: bf16 moves the reference's own grad norm 11.0% (CPU, seed 1),
#: the port's plain versions on the CPU 17.5% at this phase's weights
#: (layer 1, head 45) and the card 19.6% (PERF.md,
#: ``tests/rwkv_bf16_witness.py``)
RWKV_GRAD_NORM_TOL = 0.25
#: the decay's leaves reach the loss only through the WKV-6 backward's
#: dlogw, and y_0 and y_1 do not depend on the decay, so (a) holds their
#: grad norm to the CPU's fp32 one within ``TOL``
RWKV_DECAY_LEAVES = ("dec_w1", "dec_w2", "dec_bias")


def rwkv_step_launches(cfg, seq: int) -> dict:
    """Kernel launches of one rwkv6-7b train step (``with_remat``): the
    WKV-6 forward once a layer a forward pass, twice when the stacked group
    repeats (remat recomputes it), its backward once a layer, whatever the
    sequence length (the kernel takes the whole sequence)."""
    L = cfg.n_layers
    passes = 2 if L > 1 else 1
    return {"flash_attention": 0, "flash_attention_bwd": 0,
            "grouped_matmul": 0, "grouped_matmul_dx": 0,
            "grouped_matmul_dw": 0, "wkv6": passes * L, "wkv6_bwd": L,
            "selective_scan": 0, "selective_scan_bwd": 0}


def phase_rwkv_train(torch, cfg, counters) -> dict:
    """Phase 18: durable training of rwkv6-7b at full width through the
    WKV-6 forward and backward kernels (see the module docstring)."""
    return durable_train_cell(torch, cfg, counters, TrainCell(
        label="rwkv train", phase=18, param_count=RWKV_TRAIN_PARAM_COUNT,
        params=RWKV_TRAIN_PARAMS, ckpt_bytes=RWKV_TRAIN_CKPT_BYTES,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, kw=RWKV_TRAIN_KW,
        crash={3: "before_commit"}, disk_bytes=RWKV_TRAIN_DISK_BYTES,
        per_step=rwkv_step_launches,
        grad_norm_tol=RWKV_GRAD_NORM_TOL, held=RWKV_DECAY_LEAVES))


#: phase 19 trains jamba-1.5-large-398b at full width with its depth cut
#: from 72 layers to 1: one layer is a mamba mixer and a dense MLP, the
#: scan's forward and backward its only kernels (layer 1 would add a
#: 16-expert MoE, 12.18e9 params, whose state the card cannot hold twice)
JAMBA_TRAIN_LAYERS = 1
#: ``ModelConfig.param_count`` at 1 layer (the analytic count, equal to the
#: reference's) and the params the bundle holds, which add the 57,344 it
#: leaves out (the two block norms' and the final norm's scales, the conv
#: and dt biases)
JAMBA_TRAIN_PARAM_COUNT = 2_098_020_352
JAMBA_TRAIN_PARAMS = 2_098_077_696
#: the held params, mu and nu, all bf16 (the config keeps its moments in
#: bf16), + 28 bytes of counters and pipeline
JAMBA_TRAIN_CKPT_BYTES = 12_588_466_204
JAMBA_TRAIN_STEPS = 4
#: as phase 17's (c): sync commits every 2 steps, one manifest kept, a
#: crash before the commit of step 3
JAMBA_TRAIN_KW = dict(n_steps=JAMBA_TRAIN_STEPS, commit_every=2,
                      commit_mode="sync", retention=1)
#: retention 1 keeps one ~12.6 GB commit on disk and writes the next
#: beside it
JAMBA_TRAIN_DISK_BYTES = 29e9
#: (a)'s chunk: its 64 tokens make 2 chunks (48 + a ragged 16), as the
#: (8, 512) batch makes 2 of the config's 256, so the cotangent of h
#: crosses a chunk boundary on the card in (a) too
JAMBA_A_CHUNK = 48
#: A_log, dt_bias and dt_proj reach the loss only through the scan (as dA
#: and dBu's dt), so (a) holds their grad norm to the CPU's fp32 one within
#: ``TOL``: the global norm is mostly the embeddings' (1.07e9 of the
#: 2.1e9 params) and could hide a backward that drops the cotangent of h
#: across chunks or dC
JAMBA_SCAN_LEAVES = ("A_log", "dt_bias", "dt_proj")


def jamba_step_launches(cfg, seq: int) -> dict:
    """Kernel launches of one jamba-1.5-large train step at one layer (a
    mamba mixer and a dense MLP; no stacked group, so remat recomputes
    nothing): each chunk's body runs under a checkpoint, so the scan's
    forward runs twice a chunk (the forward, then the recompute in the
    backward) and its backward once; chunks = ceil(seq / ssm_chunk)."""
    check(cfg.n_layers == 1, f"jamba_step_launches counts 1 layer, not "
                             f"{cfg.n_layers}")
    chunks = -(-seq // min(cfg.ssm_chunk, seq))
    return {"flash_attention": 0, "flash_attention_bwd": 0,
            "grouped_matmul": 0, "grouped_matmul_dx": 0,
            "grouped_matmul_dw": 0, "wkv6": 0, "wkv6_bwd": 0,
            "selective_scan": 2 * chunks, "selective_scan_bwd": chunks}


def phase_jamba_train(torch, cfg, counters) -> dict:
    """Phase 19: durable training of jamba-1.5-large-398b at full width
    through the selective scan's forward and backward kernels (see the
    module docstring)."""
    return durable_train_cell(torch, cfg, counters, TrainCell(
        label="jamba train", phase=19, param_count=JAMBA_TRAIN_PARAM_COUNT,
        params=JAMBA_TRAIN_PARAMS, ckpt_bytes=JAMBA_TRAIN_CKPT_BYTES,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, kw=JAMBA_TRAIN_KW,
        crash={3: "before_commit"}, disk_bytes=JAMBA_TRAIN_DISK_BYTES,
        per_step=jamba_step_launches, held=JAMBA_SCAN_LEAVES,
        a_kw=dict(ssm_chunk=JAMBA_A_CHUNK)))


#: phase 20 trains deepseek-v2-236b at full width with its depth cut from
#: 60 layers to 1: one layer is MLA and the config's dense first MLP (d_ff
#: 12288), flash's forward and backward at hd 192 / hd_v 128 its only
#: kernels (a second layer adds 160 routed experts and 2 shared ones,
#: 5.36e9 params, whose bf16 params and moments, held twice by the
#: out-of-place update, do not fit one card)
DEEPSEEK_TRAIN_LAYERS = 1
#: ``ModelConfig.param_count`` at 1 layer (the analytic count, equal to the
#: reference's) and the params the bundle holds, which add the 17,408 it
#: leaves out (the two block norms' and the final norm's scales, MLA's q
#: and kv norms)
DEEPSEEK_TRAIN_PARAM_COUNT = 1_386_545_152
DEEPSEEK_TRAIN_PARAMS = 1_386_562_560
#: the held params, mu and nu, all bf16 (the config keeps its moments in
#: bf16), + 28 bytes of counters and pipeline
DEEPSEEK_TRAIN_CKPT_BYTES = 8_319_375_388
DEEPSEEK_TRAIN_STEPS = 4
#: as phase 17's (c): sync commits every 2 steps, one manifest kept, a
#: crash before the commit of step 3
DEEPSEEK_TRAIN_KW = dict(n_steps=DEEPSEEK_TRAIN_STEPS, commit_every=2,
                         commit_mode="sync", retention=1)
#: retention 1 keeps one ~8.3 GB commit on disk and writes the next beside
#: it
DEEPSEEK_TRAIN_DISK_BYTES = 20e9
#: the leaves that reach the loss only through the attention: (a) holds
#: their grad norm to the CPU's fp32 one within ``TOL``.  The global norm
#: is mostly the two 524M-param embeddings', and w_dkv's last 64 columns
#: take their gradient only from dk's rope columns (128-191) summed over
#: the 128 heads, so a backward that dropped them would show here
DEEPSEEK_MLA_LEAVES = ("w_uq", "w_uk", "w_uv", "w_dkv")
#: the card's free memory phase 20 and the rank processes beside it need
#: at once: phase 20's durable run peaks near 51 GB (PERF.md), and up to
#: sixteen rank processes (16 (a)) hold a CUDA context and a partition of
#: 2048 x 2048 x 12 fp32 tensors each on the card
PHASE_20_FREE_BYTES = 70e9


def deepseek_step_launches(cfg, seq: int) -> dict:
    """Kernel launches of one deepseek-v2 train step at one layer: MLA's
    flash forward once and its backward once (a singleton layer is no
    stacked group, so remat recomputes nothing; layer 0 is dense, so no
    grouped matmul), whatever the sequence length."""
    check(cfg.n_layers == 1 and cfg.moe.first_dense == 1,
          f"deepseek_step_launches counts 1 dense layer, not "
          f"{cfg.n_layers} (first_dense {cfg.moe.first_dense})")
    return {"flash_attention": 1, "flash_attention_bwd": 1,
            "grouped_matmul": 0, "grouped_matmul_dx": 0,
            "grouped_matmul_dw": 0, "wkv6": 0, "wkv6_bwd": 0,
            "selective_scan": 0, "selective_scan_bwd": 0}


def phase_deepseek_train(torch, cfg, counters, note: str = "") -> dict:
    """Phase 20: durable training of deepseek-v2-236b at full width through
    the flash forward and backward kernels at MLA's widths (see the module
    docstring)."""
    return durable_train_cell(torch, cfg, counters, TrainCell(
        label="deepseek train", phase=20,
        param_count=DEEPSEEK_TRAIN_PARAM_COUNT, params=DEEPSEEK_TRAIN_PARAMS,
        ckpt_bytes=DEEPSEEK_TRAIN_CKPT_BYTES, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, kw=DEEPSEEK_TRAIN_KW, crash={3: "before_commit"},
        disk_bytes=DEEPSEEK_TRAIN_DISK_BYTES,
        per_step=deepseek_step_launches, held=DEEPSEEK_MLA_LEAVES,
        note=note))


@dataclasses.dataclass(frozen=True)
class TrainCell:
    """What phases 17 to 20 check: the held and analytic parameter
    counts, the bytes a commit, the batch, the loop's arguments and crash
    (a sync commit every 2 steps, one kept, a crash before the commit of
    step 3), the free disk needed and the kernel launches a step, a
    function of the config and the batch's sequence length (the scan runs
    once a chunk)."""
    label: str
    phase: int
    param_count: int
    params: int
    ckpt_bytes: int
    batch: int
    seq: int
    kw: dict
    crash: dict
    disk_bytes: float
    per_step: Callable[[Any, int], dict]
    #: (a)'s bound on the grad norm against the CPU's fp32 one
    grad_norm_tol: float = TOL
    #: dict keys whose leaves' grad norm (a) also holds to the CPU's fp32
    #: one, within ``TOL``
    held: tuple = ()
    #: config fields (a) changes on both sides
    a_kw: dict = dataclasses.field(default_factory=dict)
    #: what runs beside (b) and (c) besides the CPU's side of (a), printed
    #: with their times
    note: str = ""


def durable_train_cell(torch, cfg, counters, cell: TrainCell) -> dict:
    """One durable-training phase at full width (the depth ``cfg`` has):
    (a) one (1, 64) batch through the kernels against the port on the CPU
    in fp32 with the plain versions; (b) the clean run on the loop's
    pipeline, no commit; (c) ``run_durable_loop`` with the cell's commits
    and crash, held bit for bit to (b).  The CPU's side of (a) runs in a
    thread beside (a), (b) and (c) on the card; (b)'s and (c)'s times are
    taken with it running."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.models.registry import build
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    tag, n_steps = cell.label, cell.kw["n_steps"]
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"{tag}: free disk in {tmp}: {free / 1e9:.1f} GB", flush=True)
    check(free >= cell.disk_bytes,
          f"{tag}: the temp filesystem {tmp} holds {free / 1e9:.1f} GB "
          f"free; phase {cell.phase} writes a "
          f"{cell.ckpt_bytes / 1e9:.1f} GB commit beside the one it keeps "
          f"and needs ~{cell.disk_bytes / 1e9:.0f} GB")
    out = {}
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    check((cfg.param_count(), n_params) == (cell.param_count, cell.params),
          f"{tag}: {cfg.arch_id} at {cfg.n_layers} layers counts "
          f"{cfg.param_count()} params and holds {n_params}, expected "
          f"{cell.param_count} and {cell.params}")
    # (a) the kernel path against the plain path: one (1, 64) batch.  The
    # CPU's fp32 reference runs in a thread beside the card's (a), (b) and
    # (c), and is compared after (c)
    tok = torch.randint(0, cfg.vocab_size, (1, 65),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    a_cfg = cfg.with_(**cell.a_kw)
    cpu_cfg = a_cfg.with_(param_dtype="float32", compute_dtype="float32")
    cpu_params = tree_map(lambda x: x.float().cpu(), params)

    def plain_fp32():
        t0 = time.perf_counter()
        got = _loss_and_grad_norm(torch, build(cpu_cfg, device="cpu"),
                                  cpu_params, batch, cell.held)
        return got, time.perf_counter() - t0

    beside = ThreadPoolExecutor(1)
    f_plain = beside.submit(plain_fp32)
    beside.shutdown(wait=False)
    per_step = cell.per_step(a_cfg, batch["tokens"].shape[1])
    reset_counts(counters)
    card = _loss_and_grad_norm(
        torch, build(a_cfg, device="cuda") if cell.a_kw else bundle, params,
        {k: v.cuda() for k, v in batch.items()}, cell.held)
    a_launches = read_counts(counters)
    print(f"{tag} (a): {cfg.arch_id} (1, 64) loss {card[0]:.6f} grad norm "
          f"{card[1]:.6f} on the card (bf16, kernels; launches "
          f"{a_launches}); the CPU's fp32 runs beside (b) and (c)",
          flush=True)
    check(a_launches == per_step,
          f"{tag} (a): launches {a_launches}, expected {per_step}")

    state0 = init_train_state(params, 0, cfg.moment_dtype)
    step = make_train_step(bundle)

    def pipeline():
        return DataPipeline(SyntheticLMSource(cfg.vocab_size),
                            cell.batch, cell.seq)

    # (b) the clean run: the loop's steps on its pipeline, no commit
    per_step = cell.per_step(cfg, cell.seq)
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    rb_state, rb_pipe, losses_b, step_s, wall_b = clean_run(
        torch, step, state0, pipeline(), n_steps)
    b_launches = read_counts(counters)
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.mean(step_s[1:]) * 1e3
    out["clean"] = dict(losses=losses_b, wall_s=wall_b, step_ms=step_ms,
                        step_s=step_s, launches=b_launches, peak_gb=peak_b)
    print(f"{tag} (b): {n_steps} steps of ({cell.batch}, "
          f"{cell.seq}), no commit: losses "
          f"{[round(x, 6) for x in losses_b]}; {step_ms:.1f} ms a step "
          f"(compute, steps 1-{n_steps - 1}; step 0 "
          f"{step_s[0] * 1e3:.1f} ms), wall {wall_b:.1f} s; launches "
          f"{b_launches}; peak {peak_b:.2f} GB{cell.note}", flush=True)
    check(all(math.isfinite(x) for x in losses_b),
          f"{tag} (b): losses {losses_b}")
    check(b_launches == {k: n_steps * n for k, n in per_step.items()},
          f"{tag} (b): launches {b_launches}, expected "
          f"{n_steps} x {per_step}")

    # (c) the durable run: sync commits every 2 steps, a crash before the
    # commit of step 3, recovery from the pool at step 1, then the end
    pool_c = tempfile.mkdtemp(prefix="chip_smoke_train_cell_")
    try:
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = run_durable_loop(step, state0, pipeline(), pool_c,
                              crash_at=dict(cell.crash), **cell.kw)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        c_launches = read_counts(counters)
        peak_c = torch.cuda.max_memory_allocated() / 1e9
        man = DSMPool(pool_c).latest_manifest()
        n_manifests = len(DSMPool(pool_c).manifests_desc())
    finally:
        shutil.rmtree(pool_c, ignore_errors=True)
    nbytes = sum(o["nbytes"] for o in man["objects"].values())
    step_ms_c, commit_s, n_commits = _timing_means(rc)
    same = {
        "params": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.params), tree_leaves(rb_state.params))),
        "opt_mu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.mu), tree_leaves(rb_state.opt.mu))),
        "opt_nu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.nu), tree_leaves(rb_state.opt.nu))),
        "opt_step": int(rc.state.opt.step) == int(rb_state.opt.step),
        "rng": torch.equal(rc.state.rng, rb_state.rng),
        "pipeline": rc.pipeline_state == rb_pipe,
    }
    n_runs = len(rc.losses)
    out["durable"] = dict(losses=rc.losses, wall_s=wall_c,
                          step_ms=step_ms_c, commit_s=commit_s,
                          commits_timed=n_commits,
                          ckpt_bytes_per_commit=nbytes, launches=c_launches,
                          peak_gb=peak_c, recoveries=rc.recoveries,
                          manifests_kept=n_manifests, bit_identical=same)
    print(f"{tag} (c): sync every 2, crash before the commit of step 3: "
          f"{rc.crashes} crash, recoveries {rc.recoveries}, {n_runs} steps "
          f"run (0-3, then 2-3 again from the commit of step 1); losses "
          f"{[round(x, 6) for x in rc.losses]}; {step_ms_c:.1f} ms a step "
          f"(compute), {commit_s:.3f} host s a commit ({n_commits} timed), "
          f"wall {wall_c:.1f} s; ckpt_bytes_per_commit {nbytes} "
          f"({nbytes / 1e9:.2f} GB); manifests kept {n_manifests}; launches "
          f"{c_launches}; peak {peak_c:.2f} GB; bit-identical to (b): "
          f"{same}{cell.note}", flush=True)
    check(rc.crashes == 1 and rc.recoveries == ["pool"],
          f"{tag} (c): {rc.crashes} crashes, recoveries "
          f"{rc.recoveries}")
    check(n_runs == n_steps + 2,
          f"{tag} (c): {n_runs} losses, expected steps 0-3 then 2-3 "
          f"(a recovery at step 1)")
    check(rc.losses[:n_steps] == losses_b
          and rc.losses[-2:] == losses_b[2:],
          f"{tag} (c): losses {rc.losses} against (b)'s {losses_b}")
    check(all(same.values()), f"{tag} (c): not bit-identical: {same}")
    check(nbytes == cell.ckpt_bytes,
          f"{tag} (c): {nbytes} bytes a commit, expected "
          f"{cell.ckpt_bytes}")
    check(man["step"] == n_steps - 1 and n_manifests == 1,
          f"{tag} (c): newest manifest step {man['step']}, "
          f"{n_manifests} kept")
    check(c_launches == {k: n_runs * n for k, n in per_step.items()},
          f"{tag} (c): launches {c_launches}, expected {n_runs} x "
          f"{per_step}")
    plain, cpu_s = f_plain.result()
    rel = [abs(c - p) / abs(p) for c, p in zip(card, plain)]
    tols = [TOL, cell.grad_norm_tol] + [TOL] * bool(cell.held)
    out["kernel_vs_plain"] = dict(card=card, cpu_fp32=plain, rel=rel,
                                  tol=tols, launches=a_launches,
                                  cpu_s=cpu_s)
    held = (f"; the grad norm of {'/'.join(cell.held)} {card[2]:.6f} vs "
            f"{plain[2]:.6f}, rel {rel[2]:.2e} (tol {tols[2]})"
            if cell.held else "")
    print(f"{tag} (a): loss {card[0]:.6f} / grad norm {card[1]:.6f} on "
          f"the card vs {plain[0]:.6f} / {plain[1]:.6f} plain fp32 on the "
          f"CPU ({cpu_s:.1f} s, beside (b) and (c)); rel {rel[0]:.2e} (tol "
          f"{tols[0]}) / {rel[1]:.2e} (tol {tols[1]}){held}", flush=True)
    check(all(r <= t for r, t in zip(rel, tols)),
          f"{tag} (a): card vs plain rel {rel} > {tols}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{tag}: phase {cell.phase} took {out['phase_s']:.1f} s"
          f"{cell.note}", flush=True)
    out["launches"] = {f"{tag} (a)": a_launches,
                       f"{tag} (b)": b_launches,
                       f"{tag} (c)": c_launches}
    return out


#: phase 13: whisper-small trained at the model's decoder context (448
#: tokens) over its 1500 frames, batch 8, 6 steps, a sync commit every 2,
#: two manifests kept; then prefill of 64 tokens and 32 greedy decode steps
#: for 4 sequences
WHISPER_BATCH, WHISPER_SEQ = 8, 448
WHISPER_KW = dict(n_steps=6, commit_every=2, commit_mode="sync",
                  retention=2)
WHISPER_SEQS, WHISPER_PROMPT, WHISPER_DECODE = 4, 64, 32
#: retention 2 keeps at most three ~2.4 GB commits on disk at once
WHISPER_DISK_BYTES = 10e9
#: the reference's own prefill / decode tolerance (``tests/test_arch_smoke.py``)
DECODE_ATOL = 0.05


class FramesPipeline:
    """A data pipeline plus frame embeddings: ``enc_embeds`` (B, enc_seq,
    D) float32 drawn with numpy from the pipeline's (seed, step), so a
    batch is a function of the pipeline state the loop commits (the
    reference's audio frontend is a stub and has no source of frames)."""

    def __init__(self, base, enc_seq: int, d_model: int):
        self.base, self.enc_seq, self.d_model = base, enc_seq, d_model

    @property
    def state(self):
        return self.base.state

    @state.setter
    def state(self, s):
        self.base.state = s

    def next_global(self):
        import numpy as np
        st = self.base.state
        batch = self.base.next_global()
        rng = np.random.default_rng([st.seed, st.step])
        batch["enc_embeds"] = rng.standard_normal(
            (self.base.global_batch, self.enc_seq, self.d_model),
            dtype=np.float32)
        return batch


def attention_layers(cfg) -> int:
    """Flash launches of one encoder-decoder forward: the encoder's
    self-attention, the decoder's and the cross-attention, a layer each."""
    return cfg.encdec.n_enc_layers + 2 * cfg.n_layers


def _norm_params(descs) -> int:
    """Elements of the layernorms' scales and biases (``ModelConfig.
    param_count`` leaves them out)."""
    from repro_torch.models.params import is_desc
    from repro_torch.utils.tree import tree_leaves
    return sum(math.prod(d.shape) for d in tree_leaves(descs, is_leaf=is_desc)
               if d.logical[-1] == "embed_nofsdp")


def profile_train_step(torch, step, state, pipe) -> dict:
    """Where one train step's time goes: the batch drawn on the host, then
    the step under ``torch.profiler`` (device time summed by kernel name;
    the flash forward and backward and the matmuls beside the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    batch_np = pipe.next_global()
    host_batch_ms = (time.perf_counter() - t0) * 1e3
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    groups = {"flash forward": ("flash_fwd_kernel",),
              "flash backward": ("bwd_dq_kernel", "bwd_dkdv_kernel"),
              "matmuls": ("nvjet", "gemm", "cutlass", "sm90_xmma")}
    shares = {g: sum(ms for n, ms in by_name.items()
                     if any(k in n for k in keys))
              for g, keys in groups.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: a batch drawn on the host {host_batch_ms:.1f} ms; a "
          f"step in {wall_ms:.1f} ms wall (profiled), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%): "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in shares.items())
          + f", the rest {busy_ms - sum(shares.values()):.1f} ms",
          flush=True)
    for name, ms in top:
        print(f"profile: {ms:9.3f} ms  {name[:90]}", flush=True)
    return dict(host_batch_ms=host_batch_ms, wall_ms=wall_ms,
                device_busy_ms=busy_ms, groups_ms=shares,
                top=[[n, ms] for n, ms in top])


def phase_whisper(torch, cfg, counters) -> dict:
    """Phase 13: whisper-small (encoder-decoder) trained durably at full
    width and depth through the flash forward and backward kernels, then
    prefill and greedy decode held to a full forward (see the module
    docstring)."""
    import numpy as np
    from repro_torch.configs import PUBLISHED_PARAMS
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.models import common, encdec
    from repro_torch.models.registry import build
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves
    t_phase = time.perf_counter()
    A = attention_layers(cfg)
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    print(f"whisper: free disk in {tmp}: {free / 1e9:.1f} GB", flush=True)
    check(free >= WHISPER_DISK_BYTES,
          f"whisper: the temp filesystem {tmp} holds {free / 1e9:.1f} GB "
          f"free; phase 13 keeps up to three ~2.4 GB commits")
    out = {}
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    analytic = cfg.param_count()
    norms = _norm_params(bundle.descs)
    published = PUBLISHED_PARAMS[cfg.arch_id]
    out["params"] = dict(held=n_params, param_count=analytic,
                         norm_params=norms, published=published)
    print(f"whisper: {cfg.arch_id} holds {n_params} params: param_count() "
          f"{analytic} + {norms} layernorm scales and biases it leaves out; "
          f"{analytic / published:.4f}x the published {published:.4g}",
          flush=True)
    check(n_params == analytic + norms,
          f"whisper: holds {n_params} params, expected {analytic} + {norms}")
    check(abs(analytic - published) / published < 0.04,
          f"whisper: param_count {analytic} not within 4% of {published}")

    # (a) durable training: a clean run, then a crash before the last commit
    state0 = init_train_state(params, 0, cfg.moment_dtype)
    ckpt_bytes = 28 + sum(t.numel() * t.element_size() for t in
                          tree_leaves((state0.params, state0.opt.mu,
                                       state0.opt.nu)))
    step = make_train_step(bundle)

    def frames_pipe():
        return FramesPipeline(
            DataPipeline(SyntheticLMSource(cfg.vocab_size), WHISPER_BATCH,
                         WHISPER_SEQ), cfg.encdec.enc_seq, cfg.d_model)

    def loop(pool, **kw):
        pipe = frames_pipe()
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = run_durable_loop(step, state0, pipe, pool, **WHISPER_KW, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, read_counts(counters)

    n_steps = WHISPER_KW["n_steps"]
    pool_b = tempfile.mkdtemp(prefix="chip_smoke_whisper_")
    try:
        rb, wall_b, b_launches = loop(pool_b)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        man = DSMPool(pool_b).latest_manifest()
    finally:
        shutil.rmtree(pool_b, ignore_errors=True)
    nbytes = sum(o["nbytes"] for o in man["objects"].values())
    step_ms, commit_s, n_commits = _timing_means(rb)
    out["clean"] = dict(losses=rb.losses, wall_s=wall_b, step_ms=step_ms,
                        commit_s=commit_s, commits_timed=n_commits,
                        ckpt_bytes_per_commit=nbytes, launches=b_launches,
                        peak_gb=peak_gb)
    print(f"whisper (a): {n_steps} steps of ({WHISPER_BATCH}, "
          f"{WHISPER_SEQ}) over {cfg.encdec.enc_seq} frames, losses "
          f"{[round(x, 6) for x in rb.losses]}; {step_ms:.1f} ms a step "
          f"(compute), {commit_s:.3f} host s a commit ({n_commits} timed, "
          f"schedule sync), wall {wall_b:.1f} s; ckpt_bytes_per_commit "
          f"{nbytes}; launches {b_launches} (expected {n_steps * 2 * A} "
          f"forward, {n_steps * A} backward); peak {peak_gb:.2f} GB",
          flush=True)
    check(nbytes == ckpt_bytes,
          f"whisper (a): {nbytes} bytes a commit, expected {ckpt_bytes}")
    check(man["step"] == n_steps - 1 and int(rb.state.opt.step) == n_steps,
          f"whisper (a): newest manifest step {man['step']}, opt step "
          f"{int(rb.state.opt.step)}")
    check(all(math.isfinite(x) for x in rb.losses)
          and len(rb.losses) == n_steps, f"whisper (a): losses {rb.losses}")
    check(b_launches["flash_attention"] == n_steps * 2 * A
          and b_launches["flash_attention_bwd"] == n_steps * A,
          f"whisper (a): launches {b_launches}, expected {n_steps * 2 * A} "
          f"forward (remat runs each twice) and {n_steps * A} backward")

    last = n_steps - 1
    every = WHISPER_KW["commit_every"]
    pool_c = tempfile.mkdtemp(prefix="chip_smoke_whisper_")
    try:
        rc, wall_c, c_launches = loop(pool_c,
                                      crash_at={last: "before_commit"})
    finally:
        shutil.rmtree(pool_c, ignore_errors=True)
    redo = n_steps - (last - every + 1)          # steps after the commit
    same = {
        "params": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.params), tree_leaves(rb.state.params))),
        "opt_mu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.mu), tree_leaves(rb.state.opt.mu))),
        "opt_nu": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rc.state.opt.nu), tree_leaves(rb.state.opt.nu))),
        "opt_step": int(rc.state.opt.step) == int(rb.state.opt.step),
        "rng": torch.equal(rc.state.rng, rb.state.rng),
        "pipeline": rc.pipeline_state == rb.pipeline_state,
        "losses": rc.losses[-redo:] == rb.losses[-redo:],
    }
    step_ms_c, commit_s_c, _ = _timing_means(rc)
    out["crash"] = dict(losses=rc.losses, wall_s=wall_c, step_ms=step_ms_c,
                        commit_s=commit_s_c, launches=c_launches,
                        recoveries=rc.recoveries, bit_identical=same)
    print(f"whisper (a): crash before the commit of step {last}: "
          f"{rc.crashes} crash, recoveries {rc.recoveries}, steps "
          f"{last - redo + 1}-{last} run again; bit-identical to the clean "
          f"run: {same}; wall {wall_c:.1f} s, {step_ms_c:.1f} ms a step, "
          f"{commit_s_c:.3f} host s a commit; launches {c_launches}",
          flush=True)
    check(rc.crashes == 1 and rc.recoveries == ["pool"],
          f"whisper (a): {rc.crashes} crashes, recoveries {rc.recoveries}")
    check(len(rc.losses) == n_steps + redo,
          f"whisper (a): {len(rc.losses)} losses, expected {n_steps + redo}")
    check(all(same.values()), f"whisper (a): not bit-identical: {same}")
    check(c_launches["flash_attention"] == (n_steps + redo) * 2 * A
          and c_launches["flash_attention_bwd"] == (n_steps + redo) * A,
          f"whisper (a): crash run launches {c_launches}")
    out["profile"] = profile_train_step(torch, step, state0, frames_pipe())
    del rb, rc, state0, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) prefill and greedy decode, each step against a full forward
    g = np.random.default_rng(13)
    B, P, T = WHISPER_SEQS, WHISPER_PROMPT, WHISPER_DECODE
    prompt = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, P),
                                         np.int64)).cuda()
    frames = torch.from_numpy(g.standard_normal(
        (B, cfg.encdec.enc_seq, cfg.d_model), dtype=np.float32)).cuda()
    caches = bundle.init_caches(B, P + T)
    reset_counts(counters)
    steps, toks = [], [prompt]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = bundle.prefill(params, {"tokens": prompt,
                                             "enc_embeds": frames}, caches)
        steps.append(logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(T):
            nxt = torch.argmax(logits, -1)[:, None]
            toks.append(nxt)
            logits, st = bundle.decode(params, nxt, st)
            steps.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        inf_launches = read_counts(counters)
        seq = torch.cat(toks, 1)
        enc = encdec.encode(cfg, params, frames)
        x, _ = encdec.decode_tokens(cfg, params, seq, enc)
        full = common.unembed(cfg, params["embed"], x).float()
    # each step's logits against the full forward's at its position; an
    # argmax may differ only where the full forward's top-2 margin is
    # within twice the step's error (bf16 logits over 51,865 tokens tie
    # exactly), where the error bound cannot order the two
    errs, flips = [], []
    for j, lg in enumerate(steps):
        ref = full[:, P - 1 + j]
        errs.append(float((lg.float() - ref).abs().max()))
        top2 = torch.topk(ref, 2, dim=-1).values
        for b in torch.nonzero(torch.argmax(lg, -1)
                               != torch.argmax(ref, -1)).flatten().tolist():
            flips.append((j, b, float(top2[b, 0] - top2[b, 1])))
    out["decode"] = dict(prefill_ms=(t1 - t0) * 1e3,
                         decode_ms=(t2 - t1) * 1e3 / T, launches=inf_launches,
                         max_abs_err=max(errs), errs=errs,
                         argmax_flips=flips, pos=int(st.pos))
    print(f"whisper (b): prefill of ({B}, {P}) with its frames "
          f"{(t1 - t0) * 1e3:.1f} ms, {T} greedy decode steps "
          f"{(t2 - t1) * 1e3 / T:.2f} ms each; launches {inf_launches} "
          f"(expected {A} forward, one prefill); logits against the full "
          f"forward over the {P + T} tokens: max abs {max(errs):.3e} (tol "
          f"{DECODE_ATOL}); argmax equal at {len(steps) * B - len(flips)} "
          f"of {len(steps) * B} (step, sequence) pairs, the others (step, "
          f"sequence, the full forward's top-2 margin) {flips}",
          flush=True)
    check(int(st.pos) == P + T, f"whisper (b): pos {int(st.pos)}")
    check(inf_launches["flash_attention"] == A
          and inf_launches["flash_attention_bwd"] == 0,
          f"whisper (b): launches {inf_launches}, expected {A} forward")
    check(max(errs) < DECODE_ATOL
          and all(m <= 2 * errs[j] for j, _, m in flips),
          f"whisper (b): logits against the full forward: errs {errs}, "
          f"argmax flips {flips}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"whisper: phase 13 took {out['phase_s']:.1f} s (beside phase "
          f"14)", flush=True)
    out["launches"] = {"whisper train (a)": b_launches,
                       "whisper train (a) crash": c_launches,
                       "whisper decode (b)": inf_launches}
    return out


#: phase 14: real process kills of the port's serving and training workers
#: (``repro_torch.scenarios``), spawned one after another on the card.
#: Serving: olmo-1b at full width and depth, 10 requests of 128 prompt
#: tokens, budgets 4,8,16,24, 4 slots, a sync session commit every 3
#: ticks; each kill at the first hook of its point at tick >= 6.
#: Training: olmo-1b at full width cut to 2 layers (for the time limit),
#: (8, 512) batches, sharded-async over 4 shards, 4 steps, a commit every
#: 2, two manifests kept; killed at mid_flush of step 3 (the second
#: commit; a 4-step run commits no step >= 4)
CRASH_SERVE_KW = dict(requests=10, slots=4, commit_every=3, prompt_len=128,
                      new_tokens="4,8,16,24", commit_mode="sync", full=True)
CRASH_SERVE_KILL_STEP = 6
CRASH_TRAIN_KW = dict(steps=4, commit_every=2, mode="sharded-async",
                      shards=4, retention=2, model="full", layers=2)
CRASH_TRAIN_KILL = ("mid_flush", 3)
#: the CPU rehearsal of this phase (the same trace, kill points and
#: schedules on olmo-1b's smoke config, ``--device cpu``): prefills of each
#: serving child, steps computed by each training child, and the step each
#: restart must resume at (the newest completed commit)
CRASH_SERVE_PREFILLS = {
    "reference": 10,
    "pre_flush": (5, 6), "mid_flush": (5, 6), "post_completeOp": (5, 5)}
CRASH_TRAIN_STEPS = {"reference": 4, "kill": 4, "restart": 2}
CRASH_RESUME = {"pre_flush": 3, "mid_flush": 3, "post_completeOp": 6,
                "train": 1}
#: the training scenario keeps at most three ~4.7 GB commits of one pool,
#: and its reference's pool and its kill's fill at once
CRASH_DISK_BYTES = 30e9
CUBLAS_WORKSPACE = ":4096:8"


def _crash_child(name: str, child: dict, card: str) -> dict:
    """Print one child of phase 14 and return its launches."""
    r = child["result"] or {}
    rec = r.get("recover_s")
    print(f"crash: {name}: rc {child['rc']}, wall {child['wall_s']:.2f} s, "
          f"recover_s {'-' if rec is None else format(rec, '.2f')}, "
          f"recovered bytes into HBM {r.get('recovered_bytes', '-')}, "
          f"launches {r.get('launches')} [{card}]", flush=True)
    return r.get("launches") or {}


def phase_crash(torch, card: str) -> dict:
    """Phase 14: the crash scenarios on the card (see the module
    docstring): every child runs ``--device cuda``; a child that exits
    with anything but 0 (restarts, references) or 17 (kills) fails.  For
    the time limit the independent chains run at once: the serving
    reference, each serving kill + restart, the training reference and
    the training kill + restart (its digest is held to the reference's
    once both have ended); each chain's children run one after another,
    and the checks come after all have ended."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.dsm.flit_runtime import KILL_POINTS
    from repro_torch.scenarios.runner import (reference_run, run_scenario,
                                              run_serve_scenario,
                                              serve_reference_run)
    from repro_torch.scenarios.worker import KILL_EXIT
    t_phase = time.perf_counter()
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= CRASH_DISK_BYTES,
          f"crash: {tmp} holds {free / 1e9:.1f} GB free, the training "
          f"scenario needs ~{CRASH_DISK_BYTES / 1e9:.0f} GB")
    L = get_config("olmo-1b").n_layers
    LT = CRASH_TRAIN_KW["layers"]
    out = {"children": {}, "launches": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    serve_dir, train_dir = (os.path.join(work, d) for d in ("serve", "train"))
    point, kill_step = CRASH_TRAIN_KILL

    def serve_cell(p):
        # the reference runs beside it: the tokens are compared below
        r = run_serve_scenario(p, serve_dir, kill_step=CRASH_SERVE_KILL_STEP,
                               ref_outputs={}, device="cuda",
                               **CRASH_SERVE_KW)
        shutil.rmtree(os.path.join(serve_dir, f"serve_{p}_cache"),
                      ignore_errors=True)
        return r

    def train_reference():
        tref = reference_run(train_dir, device="cuda", **CRASH_TRAIN_KW)
        shutil.rmtree(os.path.join(train_dir, "pool_reference"),
                      ignore_errors=True)
        return tref

    try:
        with ThreadPoolExecutor(3 + len(KILL_POINTS)) as ex:
            f_tref = ex.submit(train_reference)
            # the kill chain runs beside the reference, whose digest the
            # check below compares with the restart's; a digest given keeps
            # run_scenario from running a reference of its own
            f_train = ex.submit(run_scenario, point, train_dir,
                                kill_step=kill_step, ref_digest=0,
                                device="cuda", **CRASH_TRAIN_KW)
            f_ref = ex.submit(serve_reference_run, serve_dir, device="cuda",
                              **CRASH_SERVE_KW)
            f_cells = {p: ex.submit(serve_cell, p) for p in KILL_POINTS}
            ref = f_ref.result()
            cells = {p: f.result() for p, f in f_cells.items()}
            tref = f_tref.result()
            r = f_train.result()
        # (a) serving: an uninterrupted run, then one kill per point
        res = ref["result"]
        n = _crash_child("serve reference", ref, card)
        out["children"]["serve reference"] = ref
        out["launches"]["crash serve reference"] = n
        check(res["prefills"] == CRASH_SERVE_PREFILLS["reference"]
              and n.get("flash_attention") == L * res["prefills"]
              and res["resumed_from"] is None
              and res["cublas_workspace"] == CUBLAS_WORKSPACE,
              f"crash: serve reference: {res['prefills']} prefills, "
              f"launches {n}, resumed {res['resumed_from']}, workspace "
              f"{res['cublas_workspace']}")
        for p, sr in cells.items():
            for c in sr.children:
                out["children"][f"serve {p} {c['role']}"] = c
            check(sr.killed and len(sr.children) == 2
                  and sr.children[0]["rc"] == KILL_EXIT
                  and sr.children[1]["rc"] == 0,
                  f"crash: serve {p}: exit codes "
                  f"{[c['rc'] for c in sr.children]} (17 then 0): "
                  f"{sr.detail}")
            kill, restart = sr.children
            sr = dataclasses.replace(sr, outputs_match=(
                restart["result"]["outputs"] == res["outputs"]))
            kn = _crash_child(f"serve {p} kill", kill, card)
            rn = _crash_child(f"serve {p} restart", restart, card)
            out["launches"][f"crash serve {p} kill"] = kn
            out["launches"][f"crash serve {p} restart"] = rn
            want_k, want_r = CRASH_SERVE_PREFILLS[p]
            got = (kill["result"]["prefills"], restart["result"]["prefills"])
            check(got == (want_k, want_r)
                  and kn.get("flash_attention") == L * want_k
                  and rn.get("flash_attention") == L * want_r,
                  f"crash: serve {p}: prefills {got} (rehearsal "
                  f"{(want_k, want_r)}), launches {kn} / {rn}, expected "
                  f"{L} a prefill")
            check(sr.ok and sr.resumed_from == CRASH_RESUME[p]
                  and restart["result"]["cublas_workspace"]
                  == CUBLAS_WORKSPACE,
                  f"crash: serve {p}: completed {sr.completed_ticks_at_kill},"
                  f" resumed {sr.resumed_from} (expected "
                  f"{CRASH_RESUME[p]}), outputs bit-identical "
                  f"{sr.outputs_match}")
            print(f"crash: serve {p}: killed at tick "
                  f"{kill['result']['tick']}, commits durable "
                  f"{sr.completed_ticks_at_kill}, resumed at tick "
                  f"{sr.resumed_from} with {sr.resumed_sessions} sessions "
                  f"running and {sr.recovered_done} done; every session's "
                  f"tokens bit-identical to the uninterrupted run",
                  flush=True)

        # (b) training: an uninterrupted run, then a mid_flush kill
        out["children"]["train reference"] = tref
        for c in r.children:
            out["children"][f"train {point} {c['role']}"] = c
        check(r.killed and len(r.children) == 2
              and r.children[0]["rc"] == KILL_EXIT
              and r.children[1]["rc"] == 0,
              f"crash: train {point}: exit codes "
              f"{[c['rc'] for c in r.children]} (17 then 0): {r.detail}")
        for role, child in (("reference", tref), ("kill", r.children[0]),
                            ("restart", r.children[1])):
            n = _crash_child(f"train {role}", child, card)
            out["launches"][f"crash train {role}"] = n
            steps = child["result"]["steps_run"]
            check(steps == CRASH_TRAIN_STEPS[role]
                  and n.get("flash_attention") == 2 * LT * steps
                  and n.get("flash_attention_bwd") == LT * steps,
                  f"crash: train {role}: {steps} steps (rehearsal "
                  f"{CRASH_TRAIN_STEPS[role]}), launches {n}, expected "
                  f"{2 * LT} forward (remat) and {LT} backward a step")
        restart = r.children[1]["result"]
        want_digest = tref["result"]["digest"]
        check(r.recovered_completed_commit
              and r.resumed_from == CRASH_RESUME["train"]
              == max(r.completed_steps_at_kill)
              and r.final_digest == want_digest
              and restart["device"] == torch.cuda.get_device_name(0)
              and restart["cublas_workspace"] == CUBLAS_WORKSPACE,
              f"crash: train {point}: completed {r.completed_steps_at_kill}, "
              f"resumed {r.resumed_from} (expected {CRASH_RESUME['train']}),"
              f" digest {r.final_digest} vs {want_digest}")
        print(f"crash: train {point}: killed at step {kill_step}, commits "
              f"durable {r.completed_steps_at_kill}, resumed at step "
              f"{r.resumed_from} from the {r.recovery_source} "
              f"({restart['recovered_bytes']} bytes into HBM), final params "
              f"digest {r.final_digest} equal to the uninterrupted run's",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"crash: phase 14 took {out['phase_s']:.1f} s (beside phase 13) "
          f"[{card}]", flush=True)
    return out


#: phase 15 (a): the rank cluster on the card.  dim 2048, 12 tensors:
#: 16,777,216 bytes an array, 603,979,776 bytes of p / mu / nu in all,
#: 201,326,592 a rank at world 3.  ``reduced``: cut from a data-parallel
#: rank of olmo-1b (~4.7 GB of params and both moments a rank at world 3)
#: to fit the script's time limit.
CLUSTER_KW = dict(world=3, victim=1, steps=8, commit_every=2, dim=2048,
                  tensors=12)
CLUSTER_KILL_STEP = 3
CLUSTER_STATE_BYTES = 603_979_776
CLUSTER_REDUCED = ("dim 2048 x 12 tensors (603,979,776 bytes of p, mu, nu; "
                   "201,326,592 a rank) cut from a data-parallel rank of "
                   "olmo-1b (~4.7 GB a rank at world 3)")
#: (kill point, replicated) -> (recovery source, resume step)
CLUSTER_CELLS = {("pre_flush", True): ("peer-staging", 3),
                 ("post_completeOp", False): ("pool", 3)}
CLUSTER_SHRINK_AT = 4              # both cells resume at 3
#: phase 15 (b): the tier presets of ``tests/test_placement.py:224-250``
TIER_STAGING_PRESET = "cxl11-direct"
TIER_POOL_PRESET = "cxl30-fabric"
TIER_POOL_KW = dict(p_peer_loss=1.0, replay_ns_per_byte=1e3)
#: phase 15 (c): legacy serving, the first 8 requests of phase 4's trace
LEGACY_REQUESTS = 8
LEGACY_CRASH_TICKS = 10


def _cluster_child(name: str, child: dict, card: str,
                   tag: str = "cluster") -> dict:
    """Print one rank of phase 15 (a) or 16 (a) and return its numbers."""
    r = child["result"] or {}
    row = dict(rc=child["rc"], wall_s=child["wall_s"],
               start_s=r.get("start_s"), recover_s=r.get("recover_s"),
               recovered_bytes=r.get("recovered_bytes"),
               commits=r.get("commits"), steps_run=r.get("steps_run"))
    fmt = lambda v: "-" if v is None else format(v, ".2f")
    print(f"{tag}: {name}: rc {row['rc']}, wall {row['wall_s']:.2f} s, "
          f"start_s {fmt(row['start_s'])}, recover_s "
          f"{fmt(row['recover_s'])}, bytes read back "
          f"{row['recovered_bytes'] if row['recovered_bytes'] is not None else '-'}"
          f", commits {row['commits'] if row['commits'] is not None else '-'}"
          f", steps {row['steps_run']} [{card}]", flush=True)
    return row


def phase_cluster_ranks(torch, card: str) -> dict:
    """15 (a): three rank processes (``--device cuda``) share the card;
    one dies in the commit window, the survivors shrink bit-identically
    (see the module docstring).  For the time limit the two planned runs
    (card, CPU) and the two kill cells run at once: twelve rank processes
    share the host and, but for the CPU run's three, the card."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.scenarios.cluster import (run_cluster_planned,
                                               run_cluster_scenario)
    from repro_torch.scenarios.worker import KILL_EXIT
    out = {"cells": {}, "planned": {}, "reduced": CLUSTER_REDUCED}
    kw = dict(CLUSTER_KW)
    work = tempfile.mkdtemp(prefix="chip_smoke_cluster_")

    def planned_on(device, pool):
        t0 = time.perf_counter()
        children = []
        digests = run_cluster_planned(
            os.path.join(work, pool), shrink_at=CLUSTER_SHRINK_AT,
            device=device, children=children, timeout=600, **kw)
        shutil.rmtree(os.path.join(work, pool), ignore_errors=True)
        return digests, children, time.perf_counter() - t0

    def cell(point, replicate):
        t0 = time.perf_counter()
        # the cell's reference is the planned run on the card, running
        # beside it: the placeholder keeps the cell from starting its own
        r = run_cluster_scenario(
            point, work, replicate=replicate, kill_step=CLUSTER_KILL_STEP,
            device="cuda", timeout=600,
            ref_cache={CLUSTER_SHRINK_AT - 1: None}, **kw)
        shutil.rmtree(os.path.join(
            work, f"cluster_{point}_{'peer' if replicate else 'pool'}"),
            ignore_errors=True)
        return r, time.perf_counter() - t0

    try:
        planned = {}
        with ThreadPoolExecutor(2 + len(CLUSTER_CELLS)) as ex:
            futs = {d: ex.submit(planned_on, d, f"planned_{label}")
                    for d, label in (("cuda", "card"), ("cpu", "host"))}
            cells = {k: ex.submit(cell, *k) for k in CLUSTER_CELLS}
            runs = {d: f.result() for d, f in futs.items()}
            results = {k: f.result() for k, f in cells.items()}
        for device, (digests, children, wall) in runs.items():
            planned[device] = digests
            out["planned"][device] = dict(
                wall_s=wall, ranks=[_cluster_child(
                    f"planned shrink at {CLUSTER_SHRINK_AT} ({device}) "
                    f"{c['role']}", c, card) for c in children])
            check(len(digests) == kw["tensors"]
                  and all(c["rc"] == 0 for c in children),
                  f"cluster: planned shrink on {device}: {len(digests)} "
                  f"digests, exit codes {[c['rc'] for c in children]}")
            print(f"cluster: planned shrink at step {CLUSTER_SHRINK_AT} on "
                  f"{device}: {wall:.2f} s, {len(digests)} tensor digests "
                  f"[{card}]", flush=True)
        check(planned["cuda"] == planned["cpu"],
              "cluster: the planned shrink's digests on the card differ "
              "from the CPU's")
        out["planned_digests"] = planned
        for (point, replicate), (source, resume) in CLUSTER_CELLS.items():
            name = f"{point} {'replicated' if replicate else 'unreplicated'}"
            r, wall = results[(point, replicate)]
            ranks = [_cluster_child(f"{name} {c['role']}", c, card)
                     for c in r.children]
            check(r.killed and r.children
                  and r.children[0]["rc"] == KILL_EXIT
                  and all(c["rc"] == 0 for c in r.children[1:]),
                  f"cluster: {name}: exit codes "
                  f"{[c['rc'] for c in r.children]} (17, 0, 0): {r.detail}")
            check((r.recovery_source, r.resumed_from) == (source, resume)
                  and r.recovered_completed_commit,
                  f"cluster: {name}: recovered from {r.recovery_source} at "
                  f"{r.resumed_from}, expected {source} at {resume}; "
                  f"completed {r.completed_steps_at_kill}: {r.detail}")
            check(r.killed and len(r.digests) == kw["tensors"]
                  and r.digests == planned["cuda"] == planned["cpu"],
                  f"cluster: {name}: merged digests differ from the planned "
                  f"shrink's on the card and on the CPU")
            commits = {c["role"]: c["result"]["commits"]
                       for c in r.children[1:]}
            out["cells"][name] = dict(
                wall_s=wall, source=r.recovery_source,
                resumed_from=r.resumed_from,
                completed=r.completed_steps_at_kill, ranks=ranks)
            print(f"cluster: {name}: rank 1 killed at {point} of step "
                  f"{CLUSTER_KILL_STEP}, commits durable "
                  f"{r.completed_steps_at_kill}, survivors recovered from "
                  f"{r.recovery_source} at step {r.resumed_from}, commits "
                  f"a survivor {commits}, merged digests equal the planned "
                  f"shrink's on the card and on the CPU; {wall:.2f} s "
                  f"[{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase_tiers(torch, cfg, t_max: int, card: str) -> dict:
    """15 (b): one full-width olmo-1b lane (``t_max`` tokens) through the
    KV cache's tiers, each restored into a lane on the card."""
    from repro_torch.dsm.placement import PlacementPolicy
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.dsm.tiers import TierManager
    from repro_torch.models.registry import build
    from repro_torch.serve.kvcache import TieredKVCache
    from repro_torch.utils.tree import tree_flatten, tree_leaves
    bundle = build(cfg, device="cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    out = {}
    try:
        g = torch.Generator("cuda").manual_seed(0)
        specs, treedef = tree_flatten(bundle.abstract_caches(1, t_max))
        lane1 = treedef.unflatten(
            [torch.randn(s.shape, generator=g, device="cuda").to(s.dtype)
             for s in specs])
        want = [l.clone() for l in tree_leaves(lane1)]
        nbytes = sum(l.nbytes for l in want)

        def kv_on(tag, placement=None):
            tiers = TierManager(DSMPool(os.path.join(work, tag)), 0)
            kv = TieredKVCache(bundle, 2, t_max, tiers=tiers,
                               placement=placement)
            kv.write_slot(1, lane1)
            return kv, tiers

        def restored(kv, tree, what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kv.write_slot(0, tree)
            got = kv.read_slot(0)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            check(all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(got), want)),
                  f"tiers: {what}: the restored lane differs")
            return ms

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, 1e3 * (time.perf_counter() - t0)

        peer = TierManager(DSMPool(os.path.join(work, "peer")), 1)
        rows = {}
        kv, tiers = kv_on("stage")
        lane = kv.read_slot(1)
        v, ms = timed(lambda: kv.stage("kv/s", lane))
        rows["stage"] = dict(ms=ms, d2h=tiers.d2h_gather_bytes,
                             restore_ms=restored(kv, kv.restore("kv/s"),
                                                 "stage"))
        v, ms = timed(lambda: kv.spill("kv/p", lane, peer=peer))
        rows["peer spill"] = dict(ms=ms, d2h=tiers.d2h_gather_bytes,
                                  restore_ms=restored(
                                      kv, peer.rload("kv/p"), "peer spill"))
        d0 = tiers.d2h_gather_bytes
        entry, ms = timed(lambda: kv.spill_durable("kv/d", lane))
        kv.discard("kv/d")
        rows["spill_durable"] = dict(
            ms=ms, d2h=tiers.d2h_gather_bytes - d0,
            shards=len(entry["shards"]),
            restore_ms=restored(kv, kv.restore("kv/d", entry=entry),
                                "spill_durable"))
        tiers.close()
        for label, pol in (
                (f"spill_auto {TIER_STAGING_PRESET}",
                 PlacementPolicy(TIER_STAGING_PRESET)),
                (f"spill_auto {TIER_POOL_PRESET} (staging priced out)",
                 PlacementPolicy(TIER_POOL_PRESET, **TIER_POOL_KW))):
            kv, tiers = kv_on(label.split()[1], pol)
            lane = kv.read_slot(1)
            info, ms = timed(lambda: kv.spill_auto("kv/a", lane, peer=peer))
            want_tier = "staging" if "direct" in label else "pool"
            check(info["tier"] == want_tier and info["nbytes"] == nbytes,
                  f"tiers: {label} chose {info['tier']} for "
                  f"{info['nbytes']} bytes, expected {want_tier}")
            if want_tier == "staging":
                back = peer.rload("kv/a")
            else:
                kv.discard("kv/a")
                back = kv.restore("kv/a", entry=info["entry"])
            rows[label] = dict(ms=ms, d2h=tiers.d2h_gather_bytes,
                               tier=info["tier"],
                               restore_ms=restored(kv, back, label))
            tiers.close()
        peer.close()
        # each tier but the object tier copies the lane to the host once
        for label, row in rows.items():
            got = row["d2h"]
            check(got == (0 if label == "stage" else nbytes),
                  f"tiers: {label}: D2H {got} bytes, expected "
                  f"{0 if label == 'stage' else nbytes}")
        for label, row in rows.items():
            print(f"tiers: olmo-1b lane ({nbytes} bytes, t_max {t_max}) "
                  f"{label}: {row['ms']:.2f} ms, D2H {row['d2h']} bytes, "
                  f"restored into a lane on the card bit-identically in "
                  f"{row['restore_ms']:.2f} ms [{card}]", flush=True)
        out = dict(lane_bytes=nbytes, rows=rows)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase_legacy_serving(torch, cfg, trace, t_max, counters,
                         card: str) -> dict:
    """15 (c): olmo-1b served at full width (at the depth ``cfg`` has) with
    the legacy whole-lane commits: an uninterrupted run, the paged run of the same
    requests, and a crash after 10 ticks with its resume."""
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.utils.tree import tree_leaves
    trace = trace[:LEGACY_REQUESTS]
    want = rehearse_schedule(torch, trace, t_max)
    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    lane_bytes = sum(s.nbytes for s in tree_leaves(
        bundle.abstract_caches(1, t_max)))
    pools = [tempfile.mkdtemp(prefix="chip_smoke_legacy_")
             for _ in range(3)]
    out = {"runs": {}, "launches": {}}
    try:
        def engine_on(pool, paged):
            return build_serve_engine(
                cfg.arch_id, smoke=False, t_max=t_max, pool_path=pool,
                bundle=bundle, params=params, device="cuda", paged=paged,
                **PATH_KW)[0]

        res = {}
        for label, paged, pool in (("legacy", False, pools[0]),
                                   ("paged", True, pools[1])):
            e = engine_on(pool, paged)
            timer = PhaseTimer(e)
            torch.cuda.synchronize()
            reset_counts(counters)
            t0 = time.perf_counter()
            r = e.run(trace)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = read_counts(counters)
            d2h = e.store.tiers.d2h_gather_bytes
            e.close()
            res[label] = r
            out["launches"][f"olmo-1b {label} serving (phase 15)"] = n
            out["runs"][label] = dict(
                wall_s=dt, tokens_per_s=r.emitted_tokens / dt,
                commits=r.commits, prefills=r.prefills,
                decode_ticks=r.decode_ticks, d2h_bytes=d2h,
                commit_s=timer.t["commit"], launches=n)
            check((r.decode_ticks, r.prefills, r.commits)
                  == (want["decode_ticks"], want["prefills"],
                      want["commits"]),
                  f"legacy: {label}: {r.decode_ticks} ticks, {r.prefills} "
                  f"prefills, {r.commits} commits; the CPU rehearsal "
                  f"{want}")
            check(n["flash_attention"] == cfg.n_layers * r.prefills
                  and n["grouped_matmul"] == n["wkv6"]
                  == n["selective_scan"] == n["flash_attention_bwd"] == 0,
                  f"legacy: {label}: launches {n}, expected "
                  f"{cfg.n_layers} flash a prefill and nothing else")
            check(d2h == want["lane_copies"] * lane_bytes,
                  f"legacy: {label}: D2H {d2h} bytes, expected "
                  f"{want['lane_copies']} lane copies x {lane_bytes}")
            print(f"legacy: olmo-1b {label} commits, {len(trace)} requests "
                  f"prompt 512, 4 slots, sync every 4: {r.emitted_tokens} "
                  f"tokens in {dt:.3f} s, {r.commits} commits, D2H {d2h} "
                  f"bytes, host s in commit {timer.t['commit']:.3f}, "
                  f"launches {n} [{card}]", flush=True)
        check(res["legacy"].outputs == res["paged"].outputs,
              "legacy: the legacy and paged runs' tokens differ")
        # crash after 10 ticks, then resume on the same pool
        e = engine_on(pools[2], False)
        e.submit(trace)
        for _ in range(LEGACY_CRASH_TICKS):
            e.tick()
        e.store.ctx.crash()
        del e
        e = engine_on(pools[2], False)
        reset_counts(counters)
        step = e.resume()
        r3 = e.run(trace)
        n = read_counts(counters)
        e.close()
        out["launches"]["olmo-1b legacy resume (phase 15)"] = n
        check(step == LEGACY_CRASH_TICKS - LEGACY_CRASH_TICKS % 4
              and r3.outputs == res["legacy"].outputs
              and n["flash_attention"] == cfg.n_layers * r3.prefills,
              f"legacy: resumed at tick {step}, tokens equal "
              f"{r3.outputs == res['legacy'].outputs}, launches {n}")
        out["resume"] = dict(resumed_tick=step,
                             sessions_resumed=r3.resumed_sessions,
                             prefills_after_resume=r3.prefills)
        print(f"legacy: crashed after {LEGACY_CRASH_TICKS} ticks, resumed "
              f"from committed tick {step} with {r3.resumed_sessions} "
              f"whole lanes restored, {r3.prefills} prefills after the "
              f"resume; every session's tokens equal the uninterrupted "
              f"legacy run's and the paged run's [{card}]", flush=True)
    finally:
        for p in pools:
            shutil.rmtree(p, ignore_errors=True)
    return out


def phase_cluster(torch, cfg, trace, t_max, counters, card: str) -> dict:
    """Phase 15 (b) whole-lane tiers, (c) legacy serving (see the module
    docstring); (a), the rank cluster, is ``phase_cluster_ranks``, run
    beside phase 20."""
    t_phase = time.perf_counter()
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tiers"] = phase_tiers(torch, cfg, t_max, card)
    out["tiers_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["legacy"] = phase_legacy_serving(torch, cfg, trace, t_max, counters,
                                         card)
    out["legacy_s"] = time.perf_counter() - t0
    out["launches"] = out["legacy"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"cluster: phase 15 (b) and (c) took {out['phase_s']:.1f} s ((b) "
          f"{out['tiers_s']:.1f}, (c) {out['legacy_s']:.1f}) [{card}]",
          flush=True)
    return out


#: phase 16 (a): the grow cells at phase 15's cluster size; the joiner
#: (rank 3) joins at step 4 and adopts the state of step 3.  Their
#: reference is phase 15's planned shrink (the straight 3-rank run's
#: digests equal it: ``tests/test_torch_scale_cells.py``)
GROW_KW = {k: v for k, v in CLUSTER_KW.items() if k != "victim"}
GROW_JOIN_AT = 4
#: phase 16 (b): the first 8 requests of phase 10's trace, 2 slots an engine
SCALE_FLEET_REQUESTS = 8
#: the CPU rehearsal of phase 16 (b) (olmo-1b's smoke config, the same
#: trace): prefills of the grown-and-drained fleet and of the fixed fleet
#: (prefix reuse serves the other 6 requests of each)
SCALE_FLEET_PREFILLS = {"grown": 2, "fixed": 2}


def phase_grow_cells(planned: dict, card: str) -> dict:
    """16 (a): the grow cells, all four at once (sixteen rank processes on
    the card; see the module docstring).  ``planned`` maps "cuda" / "cpu"
    to phase 15's planned-shrink digests."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.dsm.faults import JOIN_POINTS
    from repro_torch.scenarios.scale import run_grow_scenario
    from repro_torch.scenarios.worker import KILL_EXIT
    out = {"cells": {}, "reduced": CLUSTER_REDUCED}
    work = tempfile.mkdtemp(prefix="chip_smoke_grow_")
    dim, n_tensors = GROW_KW["dim"], GROW_KW["tensors"]
    try:
        def cell(point):
            t0 = time.perf_counter()
            r = run_grow_scenario(point, work, join_at=GROW_JOIN_AT,
                                  ref_digests=planned["cuda"],
                                  device="cuda", timeout=600, **GROW_KW)
            shutil.rmtree(os.path.join(work, f"scale_grow_{point}"),
                          ignore_errors=True)
            return r, time.perf_counter() - t0

        points = ("none",) + JOIN_POINTS
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(points)) as ex:
            results = dict(zip(points, ex.map(cell, points)))
        out["grow_s"] = time.perf_counter() - t0
        for point, (r, wall) in results.items():
            name = ("no kill" if point == "none"
                    else f"joiner killed at {point}")
            ranks = [_cluster_child(f"{name} {c['role']}", c, card,
                                    tag="scale") for c in r.children]
            rcs = [c["rc"] for c in r.children]
            if point == "none":
                check(rcs == [0, 0, 0, 0] and not r.killed,
                      f"scale: {name}: exit codes {rcs}: {r.detail}")
                check(r.gens == [1] * 4,
                      f"scale: {name}: gens {r.gens}, expected 1 (0 + 1) "
                      f"on every rank")
            else:
                joiner = r.children[0]["result"] if r.children else None
                check(r.killed and rcs == [KILL_EXIT, 0, 0, 0]
                      and joiner is not None
                      and joiner.get("point") == point,
                      f"scale: {name}: exit codes {rcs} (17, 0, 0, 0), "
                      f"joiner's line {joiner}: {r.detail}")
            check(set(r.lives) == {r.expected_live},
                  f"scale: {name}: live sets {sorted(set(r.lives))}, "
                  f"expected {r.expected_live}")
            check(len(r.digests) == n_tensors
                  and r.digests == planned["cuda"] == planned["cpu"]
                  and r.ok,
                  f"scale: {name}: merged digests ({len(r.digests)}) differ "
                  f"from the planned shrink's on the card and on the CPU")
            row = dict(wall_s=wall, lives=sorted(set(r.lives)),
                       gens=r.gens, sources=r.sources, ranks=ranks)
            if point == "none":
                res = r.children[-1]["result"]
                part = len(res["digests"]) * 3 * dim * dim * 4
                check(res["recovered_bytes"] == part
                      and res["source"] == "peer-staging",
                      f"scale: {name}: the joiner adopted "
                      f"{res['recovered_bytes']} bytes from {res['source']}, "
                      f"expected its partition's {part}")
                row.update(joiner_adopted_bytes=res["recovered_bytes"],
                           joiner_partition_bytes=part)
                print(f"scale: {name}: the joiner adopted "
                      f"{res['recovered_bytes']} bytes from "
                      f"{res['source']} at step {res['resumed_from']}, its "
                      f"partition at world 4 {len(res['digests'])} tensors "
                      f"= {part} bytes; recover_s {res['recover_s']:.2f} "
                      f"[{card}]", flush=True)
            out["cells"][name] = row
            print(f"scale: {name}: live {sorted(set(r.lives))}, gens "
                  f"{sorted(set(r.gens))}, sources "
                  f"{sorted(set(map(str, r.sources)))}, merged digests "
                  f"equal the planned shrink's on the card and on the CPU; "
                  f"{wall:.2f} s [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase_scale(torch, cfg, counters, card: str) -> dict:
    """Phase 16 (b) the fleet grow-and-drain cell, (c) the autoscale cell
    (see the module docstring); (a), the grow cells, is
    ``phase_grow_cells``, run beside phases 20, 15 (b, c) and these."""
    from repro_torch.models.registry import build
    from repro_torch.scenarios.scale import (run_autoscale_cell,
                                             run_fleet_scale_cell)
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    t_phase = time.perf_counter()
    out = {"launches": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    try:
        # -- (b) the fleet grows and drains, against a fixed fleet ----------
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        trace_kw = dict(prompt_lens=(512,), new_tokens=FLEET_NEW_TOKENS,
                        n_prompts=2, vocab_size=cfg.vocab_size)
        t_max = trace_t_max(synthetic_trace(SCALE_FLEET_REQUESTS, seed=0,
                                            **trace_kw))
        bundle = build(cfg, device="cuda")
        params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        reset_counts(counters)
        t1 = time.perf_counter()
        fr = run_fleet_scale_cell(
            work, requests=SCALE_FLEET_REQUESTS, n_slots=2, t_max=t_max,
            smoke=False, bundle=bundle, params=params, device="cuda",
            **trace_kw)
        torch.cuda.synchronize()
        cell_s = time.perf_counter() - t1
        n = read_counts(counters)
        del bundle, params
        out["launches"]["olmo-1b fleet grow and drain (phase 16)"] = n
        n_attn = sum(cfg.layer_kind(l) == "attn"
                     for l in range(cfg.n_layers))
        prefills = SCALE_FLEET_PREFILLS
        check(fr.grew and fr.drained and fr.migrations >= 1
              and fr.outputs_match and fr.n_outputs == SCALE_FLEET_REQUESTS,
              f"scale: fleet: {fr}")
        check(n["flash_attention"] == n_attn * sum(prefills.values())
              and sum(v for k, v in n.items()
                      if k != "flash_attention") == 0,
              f"scale: fleet: launches {n}: expected {n_attn} flash a "
              f"prefill of the rehearsal's {prefills} and nothing else")
        out["fleet"] = dict(wall_s=cell_s, grew=fr.grew, drained=fr.drained,
                            migrations=fr.migrations,
                            n_outputs=fr.n_outputs, prefills=prefills,
                            launches=n)
        out["fleet_s"] = time.perf_counter() - t0
        print(f"scale: olmo-1b fleet, {SCALE_FLEET_REQUESTS} requests prompt "
              f"512, 2 slots an engine: grew to engine 3, drained an engine "
              f"with running sessions, {fr.migrations} migrations; all "
              f"{fr.n_outputs} outputs equal the fixed 2-engine fleet's "
              f"token for token; prefills {prefills['grown']} (grown) + "
              f"{prefills['fixed']} (fixed), flash launches "
              f"{n['flash_attention']}; {cell_s:.2f} s the two fleets, "
              f"{out['fleet_s']:.2f} s with the weights [{card}]",
              flush=True)

        # -- (c) the autoscale cell (host code, modelled costs) -------------
        t0 = time.perf_counter()
        ar = run_autoscale_cell(work)
        out["autoscale_s"] = time.perf_counter() - t0
        check(ar.ok, f"scale: autoscale: {ar}")
        out["autoscale"] = {k: v for k, v in dataclasses.asdict(ar).items()
                            if k != "decision_log"}
        print(f"scale: autoscale (host, modelled CXL ns): auto "
              f"{ar.auto_cost_ns:.6g} against the best fixed fleet "
              f"(n={ar.best_fixed_n}) {ar.best_fixed_cost_ns:.6g}, ratio "
              f"{ar.auto_cost_ns / ar.best_fixed_cost_ns:.4f}; p99 "
              f"{ar.auto_p99} vs {ar.best_fixed_p99} ticks, lost "
              f"{ar.lost_sessions}, {ar.decisions} decisions, {ar.grows} "
              f"grows, {ar.shrinks} shrinks; {out['autoscale_s']:.2f} s "
              f"[{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"scale: phase 16 (b) and (c) took {out['phase_s']:.1f} s ((b) "
          f"{out['fleet_s']:.1f}, (c) {out['autoscale_s']:.1f}) [{card}]",
          flush=True)
    return out


#: small_cfg's layers: one flash forward and one backward each a step
#: (``remat="none"``)
TWIN_LAYERS = 4
TWIN_REQUESTS = 12                 # the serve twin's default trace


def _twin_lines(name: str, text: str, card: str):
    for line in text.splitlines():
        print(f"twins: {name}: {line} [{card}]", flush=True)


def phase_twins(torch, counters, card: str) -> dict:
    """Phase 21: the example twins on the card at their defaults (see the
    module docstring), each with every launch count at 0 before it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve as serve_twin
    from repro_torch.examples import train_durable
    out = {"launches": {}}
    others = [k for k in counters if not k.startswith("flash_attention")]
    reset_counts(counters)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = train_durable.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = read_counts(counters)
    name = "train_durable"
    _twin_lines(name, buf.getvalue(), card)
    steps = len(r["losses"]) + len(r["clean_losses"])
    check(r["same"] and "identical to clean run: True" in buf.getvalue(),
          f"twins: {name}: identical to the clean run: {r['same']}")
    check(len(r["recoveries"]) == 2 and all(
        math.isfinite(x) for x in r["losses"] + r["clean_losses"]),
        f"twins: {name}: recoveries {r['recoveries']}, losses finite "
        f"{all(math.isfinite(x) for x in r['losses'])}")
    want = TWIN_LAYERS * steps
    check(n["flash_attention"] == want
          and n["flash_attention_bwd"] == want
          and not any(n[k] for k in others),
          f"twins: {name}: launches {n}, expected {want} flash "
          f"forwards and backwards ({TWIN_LAYERS} layers x {steps} "
          f"steps computed)")
    out["launches"][name] = n
    hd = r["cfg"].head_dim
    out[name] = dict(wall_s=wall, steps_computed=steps, head_dim=hd,
                     losses=r["losses"], crashes=r["crashes"],
                     recoveries=r["recoveries"])
    print(f"twins: {name}: head dim {hd}, {steps} steps computed (crash "
          f"run and clean run), launches flash {n['flash_attention']} / "
          f"backward {n['flash_attention_bwd']}, {wall:.1f} s [{card}]",
          flush=True)
    pool = tempfile.mkdtemp(prefix="chip_smoke_serve_twin_")
    layers = get_smoke_config("olmo-1b").n_layers
    try:
        runs = {}
        for label in ("first", "resumed"):
            reset_counts(counters)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = serve_twin.main(["--pool", pool, "--device", "cuda"])
            wall = time.perf_counter() - t0
            n = read_counts(counters)
            _twin_lines(f"serve {label}", buf.getvalue(), card)
            runs[label] = (res, buf.getvalue(), n, wall)
            out["launches"][f"serve twin {label}"] = n
        (r1, t1, n1, w1), (r2, t2, n2, w2) = runs["first"], runs["resumed"]
        check(len(r1.outputs) == TWIN_REQUESTS and "resumed" not in t1
              and n1["flash_attention"] == layers * r1.prefills > 0,
              f"twins: serve first run: {len(r1.outputs)} outputs, "
              f"{r1.prefills} prefills, launches {n1}")
        check(f"resumed {TWIN_REQUESTS} finished sessions" in t2
              and r2.decode_ticks == 0 and r2.outputs == r1.outputs
              and not any(n2.values()),
              f"twins: serve rerun over the pool: resumed "
              f"{'resumed' in t2}, {r2.decode_ticks} ticks, outputs equal "
              f"{r2.outputs == r1.outputs}, launches {n2}")
        out["serve"] = dict(first_s=w1, resumed_s=w2, prefills=r1.prefills,
                            decode_ticks=r1.decode_ticks,
                            tokens=r1.emitted_tokens)
        print(f"twins: serve twice over one pool: {r1.emitted_tokens} tokens,"
              f" {r1.prefills} prefills ({n1['flash_attention']} flash "
              f"launches), {w1:.1f} s; the rerun resumed all "
              f"{TWIN_REQUESTS} sessions in {w2:.1f} s, 0 launches, tokens "
              f"equal [{card}]", flush=True)
    finally:
        shutil.rmtree(pool, ignore_errors=True)
    return out


#: phase 22 (b): the runner's mesh lane on the card (``reduced``: the toy
#: state at dim 2048, 6 tensors of params / mu / nu, 301,989,888 bytes)
MESH_LANE_KW = dict(steps=8, commit_every=2, mode="sharded-async", shards=0,
                    mesh="2x4", topology="cxl20-switched-pool", dim=2048,
                    device="cuda", timeout=600)
MESH_LANE_KILL = "mid_flush"
MESH_STATE_BYTES = 3 * 6 * 2048 * 2048 * 4
#: phase 22 (a): ``benchmarks/baselines/checkpoint.json``'s mesh rows
CKPT_MESH = {"ckpt_mesh_shards": 8,
             "ckpt_mesh_shard_bytes": [1_048_576] * 8,
             "ckpt_mesh_manifest_equal": True,
             "ckpt_mesh_d2h_gather_bytes": 0}


def phase_mesh_lane(card: str) -> dict:
    """Phase 22 (b), processes only: a ``--mesh 2x4 --device cuda`` worker
    killed in the commit window and its restart, beside an uninterrupted
    run of the same lane."""
    import dataclasses as dc
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.scenarios import runner
    from repro_torch.scenarios.worker import KILL_EXIT
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(1) as ex:
            f_ref = ex.submit(runner.reference_run, work, **MESH_LANE_KW)
            r = runner.run_scenario(MESH_LANE_KILL, work, ref_digest=0,
                                    **MESH_LANE_KW)
            ref = f_ref.result()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    r = dc.replace(r, reference_digest=ref["result"]["digest"])
    kids = {c["role"]: c for c in r.children}
    kids["reference"] = ref
    check(kids["kill"]["rc"] == KILL_EXIT,
          f"mesh: the killed worker exited {kids['kill']['rc']}, not "
          f"{KILL_EXIT} (detail {r.detail})")
    check(r.ok, f"mesh: restart resumed from {r.resumed_from} (completed "
                f"{r.completed_steps_at_kill}), digest {r.final_digest} vs "
                f"the uninterrupted run's {r.reference_digest} ({r.detail})")
    rows = {}
    for role in ("reference", "restart"):
        res = kids[role]["result"]
        check(res["mesh"] == "2x4" and res["d2h_gather_bytes"] == 0
              and res["d2h_shard_bytes"] > 0,
              f"mesh: {role}: mesh {res['mesh']}, gather bytes "
              f"{res['d2h_gather_bytes']}, block bytes "
              f"{res['d2h_shard_bytes']}")
        rows[role] = {k: res.get(k) for k in (
            "d2h_gather_bytes", "d2h_shard_bytes", "recover_s",
            "recovered_bytes", "resumed_from", "digest", "device")}
        rows[role]["wall_s"] = kids[role]["wall_s"]
        print(f"mesh: {role} worker (--mesh 2x4 --device cuda, dim "
              f"{MESH_LANE_KW['dim']}): exit {kids[role]['rc']}, "
              f"{kids[role]['wall_s']:.1f} s, resumed from "
              f"{res['resumed_from']}, D2H gather {res['d2h_gather_bytes']} "
              f"/ per-block {res['d2h_shard_bytes']} bytes, recover_s "
              f"{res['recover_s']}, recovered {res['recovered_bytes']} "
              f"bytes [{card}]", flush=True)
    check(rows["restart"]["recovered_bytes"] == MESH_STATE_BYTES + 8 + 4,
          f"mesh: the restart recovered {rows['restart']['recovered_bytes']} "
          f"bytes into the card, expected {MESH_STATE_BYTES + 12}")
    print(f"mesh: killed at {MESH_LANE_KILL} (exit {KILL_EXIT}) with "
          f"commits {r.completed_steps_at_kill} complete; the restart "
          f"resumed device-sharded from {r.resumed_from}, digest equal to "
          f"the uninterrupted run's; lane {wall:.1f} s [{card}]", flush=True)
    return dict(lane_s=wall, completed=r.completed_steps_at_kill,
                resumed_from=r.resumed_from, workers=rows)


def phase_mesh_commit(torch, card: str) -> dict:
    """Phase 22 (a): the checkpoint bench's four mesh rows on a 2x4 mesh of
    ``cuda:0`` places."""
    from repro_torch.bench.checkpoint import bench_mesh_commit
    from repro_torch.bench.report import Report
    report = Report("checkpoint")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_mesh_")
    try:
        extra = bench_mesh_commit(report, tmp, "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = {k: m["value"] for k, m in report.metrics.items()}
    for k, want in CKPT_MESH.items():
        check(got[k] == want, f"mesh: {k} {got[k]}, expected {want}")
    check(extra["d2h_shard_bytes"] == 3 * 8 * 1_048_576,
          f"mesh: per-block copies {extra['d2h_shard_bytes']} bytes")
    print(f"mesh: the checkpoint bench's rows on a 2x4 mesh of cuda:0 "
          f"places: {got['ckpt_mesh_shards']} shards of 1,048,576 bytes, "
          f"manifests equal, 0 gather bytes; fastest commit device-local "
          f"{extra['device_s']:.4f} s, host-gather {extra['gather_s']:.4f} s "
          f"[{card}]", flush=True)
    return dict(rows=got, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch.serve import set_determinism
    set_determinism()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.mamba import ops as scan_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    counters = {"flash_attention": (ops, "LAUNCHES"),
                "flash_attention_bwd": (ops, "BWD_LAUNCHES"),
                "grouped_matmul": (gmm_ops, "LAUNCHES"),
                "grouped_matmul_dx": (gmm_ops, "DX_LAUNCHES"),
                "grouped_matmul_dw": (gmm_ops, "DW_LAUNCHES"),
                "wkv6": (wkv_ops, "LAUNCHES"),
                "wkv6_bwd": (wkv_ops, "BWD_LAUNCHES"),
                "selective_scan": (scan_ops, "LAUNCHES"),
                "selective_scan_bwd": (scan_ops, "BWD_LAUNCHES")}

    report = {"clock": {}}
    t_start = time.perf_counter()

    def clock(label):
        """When each phase starts, in s since the script's start (read
        the budget off these)."""
        at = time.perf_counter() - t_start
        report["clock"][label] = at
        print(f"clock: {label} starts at {at:.1f} s", flush=True)

    # -- 1. environment ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} python "
          f"{sys.version.split()[0]}", flush=True)
    report["card"] = card

    # -- 2. build: one nvcc per source, all started together ----------------
    clock("phase 2")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(build.build, LIBRARIES)))
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(LIBRARIES)} in {build_s:.1f}s (in parallel)",
          flush=True)
    for name, lib in libs.items():
        print(f"build: {name} -> {lib}", flush=True)
        for entry, line in ptxas_report(build.build_log(name)):
            print(f"build: {name} {entry} ptxas {line}", flush=True)
    report["build_s"] = build_s

    # -- 3. kernels against their plain versions ----------------------------
    clock("phase 3")
    report["kernel_cases"] = phase_kernel(torch, ops)
    serve_ms = report["kernel_cases"]["path_s512"]["kernel_ms"]
    print(f"kernel flash_attention path_s512 with the logsumexp output in "
          f"the source (a null pointer at serving): {serve_ms:.5f} ms "
          f"beside {FLASH_SERVE_MS_BEFORE} before it (PERF.md); "
          f"ratio {serve_ms / FLASH_SERVE_MS_BEFORE:.3f}", flush=True)
    report["bwd_cases"] = phase_flash_bwd(torch, ops)
    (report["gmm_cases"], report["gmm_dx_cases"],
     report["gmm_dw_cases"]) = phase_gmm(torch, gmm_ops)
    report["wkv_cases"] = phase_wkv(torch, wkv_ops)
    report["wkv_bwd_cases"] = phase_wkv_bwd(torch, wkv_ops)
    report["scan_cases"] = phase_scan(torch, scan_ops)
    report["scan_bwd_cases"] = phase_scan_bwd(torch, scan_ops)

    # -- 4. to 7. the four serving paths ------------------------------------
    clock("phase 4-7")
    trace = synthetic_trace(16, seed=0, prompt_lens=(512,),
                            new_tokens=(4, 8, 16, 32, 48),
                            vocab_size=get_config("olmo-1b").vocab_size)
    t_max = trace_t_max(trace)
    paths = {}
    for arch in ARCHS:
        gc.collect()          # the previous path's engines hold cycles
        torch.cuda.empty_cache()            # ... and its weights
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if arch in DEPTH:
            cfg = cfg.with_(n_layers=DEPTH[arch])
        paths[arch] = phase_path(torch, cfg, trace, t_max, counters)
    report["paths"] = paths
    olmo, olmoe, rw, jamba = (paths[a] for a in ARCHS)
    check(olmo["launches"]["grouped_matmul"] == 0,
          "olmo-1b (dense) launched the grouped matmul")
    check(olmoe["launches"]["grouped_matmul"] > 0,
          "olmoe-1b-7b never launched the grouped matmul")
    check(rw["launches"]["wkv6"] > 0, "rwkv6-7b never launched the wkv6 "
                                      "kernel")
    for key in ("decode_ticks", "prefills", "commits", "d2h_bytes"):
        check(olmoe[key] == olmo[key],
              f"olmoe {key} {olmoe[key]} != olmo-1b's {olmo[key]}")
    for key in ("decode_ticks", "prefills", "commits"):
        check(rw[key] == olmo[key],
              f"rwkv6-7b {key} {rw[key]} != olmo-1b's {olmo[key]}")
    lane_copies = olmo["d2h_bytes"] // olmo["lane_bytes"]
    check(rw["lane_bytes"] == RWKV_LANE_BYTES
          and rw["d2h_bytes"] == lane_copies * RWKV_LANE_BYTES,
          f"rwkv6-7b D2H {rw['d2h_bytes']} bytes, lane {rw['lane_bytes']}: "
          f"expected {lane_copies} lane copies x {RWKV_LANE_BYTES}")
    check((jamba["param_count"], jamba["n_params"])
          == (JAMBA_PARAM_COUNT, JAMBA_PARAMS),
          f"jamba-1.5-large at 5 layers counts {jamba['param_count']} params "
          f"and holds {jamba['n_params']}, expected {JAMBA_PARAM_COUNT} and "
          f"{JAMBA_PARAMS}")
    for key in ("decode_ticks", "prefills", "commits"):
        check(jamba[key] == olmo[key],
              f"jamba {key} {jamba[key]} != olmo-1b's {olmo[key]}")
    check(jamba["lane_bytes"] == JAMBA_LANE_BYTES
          and jamba["d2h_bytes"] == lane_copies * JAMBA_LANE_BYTES,
          f"jamba D2H {jamba['d2h_bytes']} bytes, lane "
          f"{jamba['lane_bytes']}: expected {lane_copies} lane copies x "
          f"{JAMBA_LANE_BYTES}")
    check(jamba["flushed"] == {"blocks": olmo["flushed"]["blocks"],
                               "states": lane_copies},
          f"jamba flushed {jamba['flushed']}: expected olmo-1b's "
          f"{olmo['flushed']['blocks']} token blocks and {lane_copies} "
          f"state objects")
    check((olmo["decode_ticks"], olmo["prefills"], olmo["commits"],
           olmo["d2h_bytes"]) == (97, 16, 25, OLMO_D2H_BYTES),
          f"schedule {olmo['decode_ticks']} ticks, {olmo['prefills']} "
          f"prefills, {olmo['commits']} commits, {olmo['d2h_bytes']} D2H "
          f"bytes; expected 97, 16, 25, {OLMO_D2H_BYTES}")
    olmo_cfg = get_config("olmo-1b").with_(n_layers=OLMO_LAYERS)

    # -- 8. the CXL0 model --------------------------------------------------
    clock("phase 8")
    gc.collect()
    torch.cuda.empty_cache()
    # as ``python -m repro_torch.bench.model_fuzz`` runs it: without the
    # serving paths' deterministic algorithms, which fill every new tensor
    # (one more kernel per op; the twin is integer-only and exact anyway)
    torch.use_deterministic_algorithms(False)
    report["cxl0"] = phase_cxl0(torch, card)

    # -- 9. the serving features on olmo-1b -----------------------------------
    clock("phase 9")
    set_determinism()
    gc.collect()
    torch.cuda.empty_cache()
    report["features"] = phase_features(
        torch, olmo_cfg, trace, t_max, counters)
    # -- 10. the fleet on olmo-1b ---------------------------------------------
    clock("phase 10")
    gc.collect()
    torch.cuda.empty_cache()
    report["fleet"] = phase_fleet(
        torch, olmo_cfg, counters)
    # -- 11. durable training of olmo-1b ------------------------------------
    clock("phase 11")
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = phase_train(
        torch, get_config("olmo-1b").with_(n_layers=TRAIN_LAYERS), counters)
    # -- 17. durable training of olmoe-1b-7b (after 11: the card is free) --
    clock("phase 17")
    gc.collect()
    torch.cuda.empty_cache()
    report["moe_train"] = phase_moe_train(
        torch, get_config("olmoe-1b-7b").with_(n_layers=MOE_TRAIN_LAYERS),
        counters)
    # -- 18. durable training of rwkv6-7b ------------------------------------
    clock("phase 18")
    gc.collect()
    torch.cuda.empty_cache()
    report["rwkv_train"] = phase_rwkv_train(
        torch, get_config("rwkv6-7b").with_(n_layers=RWKV_TRAIN_LAYERS),
        counters)
    # -- 19. durable training of jamba-1.5-large-398b ----------------------
    clock("phase 19")
    gc.collect()
    torch.cuda.empty_cache()
    report["jamba_train"] = phase_jamba_train(
        torch, get_config("jamba-1.5-large-398b").with_(
            n_layers=JAMBA_TRAIN_LAYERS), counters)
    # -- 20. durable training of deepseek-v2-236b, then 15 (b, c) and 16
    # (b, c); beside them, in a thread, 15 (a) and then 16 (a): rank
    # processes only (their launches count in their own processes), so
    # every time, rate and peak these print is taken beside the other work
    # and is marked so.  The card holds phase 20 and the ranks at once
    clock("phases 20, 15 and 16")
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    print(f"deepseek train: the card has {free / 1e9:.1f} GB free before "
          f"phase 20 and the rank processes of phases 15 (a) and 16 (a) "
          f"start; they run at once", flush=True)
    check(free >= PHASE_20_FREE_BYTES,
          f"phases 20, 15 (a) and 16 (a): {free / 1e9:.1f} GB free on the "
          f"card, {PHASE_20_FREE_BYTES / 1e9:.0f} GB needed")

    def rank_cells():
        """15 (a), then 16 (a) on its planned digests, each timed."""
        tag = f"{card}; beside phases 20, 15 (b, c) and 16 (b, c)"
        t0 = time.perf_counter()
        ranks = phase_cluster_ranks(torch, tag)
        ranks_s = time.perf_counter() - t0
        grow = phase_grow_cells(ranks["planned_digests"], tag)
        return dict(ranks=ranks, ranks_s=ranks_s), grow

    beside_note = " (beside phases 15 (a) and 16 (a))"
    with ThreadPoolExecutor(1) as beside:
        f_ranks = beside.submit(rank_cells)
        report["deepseek_train"] = phase_deepseek_train(
            torch, get_config("deepseek-v2-236b").with_(
                n_layers=DEEPSEEK_TRAIN_LAYERS), counters, note=beside_note)
        # -- 15. whole-lane tiers, legacy serving -------------------------
        clock("phase 15 (b, c)")
        gc.collect()
        torch.cuda.empty_cache()
        report["cluster"] = phase_cluster(torch, olmo_cfg, trace, t_max,
                                          counters, card + beside_note)
        # -- 16. elastic scaling: the fleet, the autoscaler ---------------
        clock("phase 16 (b, c)")
        gc.collect()
        torch.cuda.empty_cache()
        report["scale"] = phase_scale(torch, olmo_cfg, counters,
                                      card + beside_note)
        clock("the end of phases 15 (a) and 16 (a)")
        ranks, grow = f_ranks.result()
    report["cluster"].update(ranks)
    report["scale"].update(grow)
    print(f"cluster: phase 15 (a) took {ranks['ranks_s']:.1f} s, then 16 (a) "
          f"{grow['grow_s']:.1f} s, beside phases 20, 15 (b, c) and 16 (b, "
          f"c) [{card}]", flush=True)
    # -- 12. the other five decoder-only architectures ----------------------
    clock("phase 12")
    gc.collect()
    torch.cuda.empty_cache()
    report["archs"] = phase_archs(torch, trace, t_max, counters)
    # -- 21. the example twins; beside them, in a thread, 22 (b): the mesh
    # lane's worker processes (their launches count in their own
    # processes; every time either prints is taken beside the other)
    clock("phases 21 and 22")
    gc.collect()
    torch.cuda.empty_cache()
    beside_22 = f"{card}; beside phase 22 (b)"
    with ThreadPoolExecutor(1) as beside:
        f_lane = beside.submit(phase_mesh_lane, f"{card}; beside phase 21")
        report["twins"] = phase_twins(torch, counters, beside_22)
        # -- 22 (a). the checkpoint bench's mesh rows ---------------------
        clock("phase 22 (a)")
        report["mesh"] = phase_mesh_commit(torch, beside_22)
        clock("the end of phase 22 (b)")
        report["mesh"]["lane"] = f_lane.result()
    # -- 13. whisper-small: durable training, prefill and decode, and ----
    # -- 14. crash scenarios: real process kills of the workers, at once:
    # phase 14's children are processes of their own (their launches count
    # there), and whisper-small (10.2 GB) leaves the card room for them
    clock("phases 13 and 14")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"crash: the parent holds {torch.cuda.memory_allocated() / 1e9:.3f}"
          f" GB of the card before phase 14 spawns its children; phases 13 "
          f"and 14 run at once, so every time, rate and peak either prints "
          f"is taken beside the other", flush=True)
    with ThreadPoolExecutor(1) as beside:
        f_crash = beside.submit(phase_crash, torch, card)
        report["whisper"] = phase_whisper(torch, get_config("whisper-small"),
                                          counters)
        report["crash"] = f_crash.result()
    clock("the kernels line")
    by_run = {a: p["launches"] for a, p in paths.items()}
    by_run.update({f"olmo-1b {r}": n
                   for r, n in report["features"]["launches"].items()})
    by_run.update({f"olmo-1b fleet {r}": n
                   for r, n in report["fleet"]["launches"].items()})
    by_run.update({f"olmo-1b {r}": n
                   for r, n in report["train"]["launches"].items()})
    by_run.update({f"olmoe-1b-7b {r}": n
                   for r, n in report["moe_train"]["launches"].items()})
    by_run.update({f"rwkv6-7b {r}": n
                   for r, n in report["rwkv_train"]["launches"].items()})
    by_run.update({f"jamba-1.5-large-398b {r}": n
                   for r, n in report["jamba_train"]["launches"].items()})
    by_run.update({f"deepseek-v2-236b {r}": n
                   for r, n in report["deepseek_train"]["launches"].items()})
    by_run.update(report["archs"]["launches"])
    by_run.update(report["twins"]["launches"])
    by_run.update(report["whisper"]["launches"])
    # the children of phase 14 count in their own processes and report
    # the flash pair
    by_run.update(report["crash"]["launches"])
    by_run.update(report["cluster"]["launches"])
    by_run.update(report["scale"]["launches"])

    mains = {"flash_attention": report["kernel_cases"]["path_s512"],
             "grouped_matmul": report["gmm_cases"]["decode_up"],
             "wkv6": report["wkv_cases"]["prefill"],
             "selective_scan": report["scan_cases"]["prefill"],
             "flash_attention_bwd": report["bwd_cases"]["train_b8_s512"],
             "grouped_matmul_dx": report["gmm_dx_cases"]["train_up"],
             "grouped_matmul_dw": report["gmm_dw_cases"]["train_up"],
             "wkv6_bwd": report["wkv_bwd_cases"]["train"],
             "selective_scan_bwd": report["scan_bwd_cases"]["train"]}
    timed = {"flash_attention": report["kernel_cases"],
             "grouped_matmul": report["gmm_cases"],
             "wkv6": report["wkv_cases"], "selective_scan": report["scan_cases"],
             "flash_attention_bwd": report["bwd_cases"],
             "grouped_matmul_dx": report["gmm_dx_cases"],
             "grouped_matmul_dw": report["gmm_dw_cases"],
             "wkv6_bwd": report["wkv_bwd_cases"],
             "selective_scan_bwd": report["scan_bwd_cases"]}
    kernels = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        row = mains[name]
        cases = {c: {k: r[k] for k in ("kernel_ms", "device_ms",
                                       "library_ms", "bound_ms",
                                       "kernel_over_bound")
                     if k in r} for c, r in timed[name].items()
                 if "kernel_ms" in r}
        for c, r in timed[name].items():
            if "kernel_ms" in r and r["library_ms"] is not None:
                cases[c]["kernel_over_library"] = (r["kernel_ms"]
                                                   / r["library_ms"])
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(n.get(name, 0) for n in by_run.values()),
            "launches_by_path": {a: n[name] for a, n in by_run.items()
                                 if name in n},
            "shape": row["shape"],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "kernel_over_bound": row["kernel_ms"] / row["bound_ms"],
            "kernel_over_library": (row["kernel_ms"] / row["library_ms"]
                                    if row["library_ms"] is not None
                                    else None),
            "timed_cases": cases,
            **{k: row[k] for k in ("launch", "step_form_bound_ms")
               if k in row}})
        if name == "flash_attention_bwd":      # the 32-wide tiles' case
            hd32 = timed[name][FLASH_BWD_HD32]
            kernels["kernels"][-1]["hd32"] = {
                "shape": hd32["shape"], "max_abs_err": hd32["max_abs_err"],
                **cases[FLASH_BWD_HD32]}
    report.update(kernels)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
