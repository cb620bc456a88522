#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--json PATH]

Drives the port's serving path at the full width of olmo-1b, of
olmoe-1b-7b, of rwkv6-7b and of jamba-1.5-large-398b (depth cut to 5
layers), then the CXL0 model's tensor twin at a fuzzing run's batch, then
olmo-1b's serving features (commit schedules, static baseline, prefix
reuse), then a fleet of olmo-1b engines over one pool (live migration,
the placement policy), then durable training of olmo-1b at full width
(depth cut to 4 layers) through the flash forward and backward kernels,
then serving of the
other five decoder-only architectures at full width (internlm2-1.8b,
phi3-medium-14b, yi-34b, chameleon-34b; deepseek-v2-236b's depth cut to 8
layers), then durable training, prefill and decode of the encoder-decoder
whisper-small at full width and depth, then real process kills of the
serving and training workers inside the commit window, then the rank
cluster (three rank processes on the card, one killed), whole-lane KV
tiers and legacy serving of olmo-1b, and prints one line per phase:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions;
2. build — compiles the five kernel libraries of the paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, started together: the four
   TPU kernels' counterparts and the flash backward) and
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
     heads; TMA rings and wgmma, no atomics) at the training shape (8, 16,
     512, 128) causal, the serving shape (1, 16, 512, 128), GQA (2, 32
     over 8, 200, 128) and (1, 8 over 2, 512, 128), ragged S = T = 77 at
     hd 64 and S = T = 300, hd 64 at 512, causal Sq 100 < Sk 300 (its dk,
     dv rows past the last q row exactly 0) and non-causal (2, 16, 300,
     700, 128) and whisper-small's three training shapes (see the
     forward's cases below): the forward's logsumexp within 1e-4 abs of
     the plain
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
     at 989 TFLOP/s) printed.  The forward's time at the serving shape is
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
     D 1000, not a multiple of 64; C 300, two passes, with F 200) and at
     deepseek-v2's four ((160, 24 | 32, 5120) @ (160, 5120, 1536) and
     down: its prefill and per-sequence decode capacities):
     elementwise
     |kernel - plain_fp32| <= 1e-2 * max|plain_fp32| (one rounding to
     bf16 is half an ulp, 3.9e-3 relative); library: ``torch.bmm``;
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
   * the selective scan at the jamba-1.5-large path's two shapes (prefill
     chunk (1, 256, 16384, 16), decode (4, 1, 16384, 16)), at ragged S (37,
     100) and I (1000), at N 4, 8 and 6 (not a multiple of 4) and at the
     reference's sweep shapes: y and h against the fp32 plain step
     recurrence on the same fp32 inputs, elementwise within 1e-4 x
     max|plain| (only the order of the sums differs); bound: the larger of
     the bytes (dA, dBu, C, h0 read once, y and h written once, fp32) at
     3.35 TB/s and 4 fp32 operations per (t, i, n) at 67 TFLOP/s; library:
     none, no one PyTorch call computes a selective scan;
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
   and per decode tick (32 x (16 + 97) = 3,616), the flash kernel and the
   grouped matmul never; the schedule must equal olmo-1b's, and the D2H
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
   olmo-1b at full width and depth, with phase 4's trace and a fresh
   weight set from the same seed, deterministic algorithms on again:
   (a) the run of phase 4 under each commit schedule — ``sync``,
       ``async``, ``sharded`` (4 shards) and ``sharded-async`` (the
       automatic shard count: one pipeline per card) — each with tokens
       bit-identical to sync's, 97 ticks, 16 prefills, 25 commits,
       olmo-1b's D2H bytes and 256 flash launches; the objects its
       completeOps published (a sharded object counted once) equal
       between sync and sharded and between async and sharded-async
       (the async schedules re-flush each block staged at the previous
       commit, as the reference does); tok/s and host seconds in commit
       printed side by side.  Then a crash after 10 ticks under
       sharded-async: the resume lands on committed tick 4 (the async
       schedules publish one commit behind) and every session's tokens
       equal sync's;
   (b) ``run_static`` (B = 4): 4 prefills, 172 decode ticks, 64 flash
       launches; tok/s beside a stateless continuous run's, and how many
       of the 16 token streams equal continuous's (printed: cuBLAS may
       pick another algorithm at B = 4);
   (c) prefix reuse: 16 requests over 2 prompts; engine 0 with
       ``prefix_reuse`` prefills 2 and hits 14, then an ``engine_id=3``
       engine on the same pool prefills 0, hits 16, launches no flash
       kernel and emits engine 0's tokens; the pool holds 64 ``kvblk/``
       objects of 2,097,152 bytes and 2 ``kvhead/`` objects, each written
       once; engine 0's D2H is olmo-1b's plus one lane a publish, engine
       3's olmo-1b's.

10. the fleet (``repro_torch.serve.fleet``) on olmo-1b at full width and
    depth, one weight set from a torch.Generator seeded 0 shared by every
    engine, the fleet bench's trace at prompt 512: 24 requests over 2
    prompts, budgets 4,8,16,24, 2 slots an engine, prefix reuse on, a
    commit every 4 ticks (schedule sync):
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
    with its depth cut from 16 layers to 4 (since PR 25, for the time
    limit; 371,458,048 parameters, random weights from a torch.Generator
    seeded 0, deterministic algorithms on):
    (a) the loss and the global grad norm of one (1, 64) batch on the card
        through the kernels (4 layers: 8 forward launches under remat,
        4 backward) against the port on the CPU with the same weights in
        fp32 and plain attention: within 2e-2 relative;
    (b) ``run_durable_loop``: 8 steps at the reference launcher's global
        batch 8 x seq 512, a ``sync`` commit every 4 steps, retention 2,
        on a pool in a temp dir (the free disk printed first: the phase
        fails below ~12 GB): losses, ms a step, host s a commit, peak
        memory and the bf16 param elements that moved printed; each
        commit exactly 3,714,580,508 bytes (params bf16, mu and nu fp32,
        28 bytes of counters and pipeline); 64 forward and 32 backward
        flash launches;
    (c) the same run on a fresh pool with a crash before the commit of
        step 6: 1 crash, recovered from the pool at step 3, steps 4-7 run
        again; params, mu, nu, the step, the key data and the pipeline
        state bit-identical to (b)'s, and the losses of steps 4-7 too.
    The phase's time is printed.
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

14. crash scenarios (``repro_torch.scenarios``): the port's runner spawns
    the killable workers as child processes on the card, one after
    another (they load the libraries phase 2 built), after the parent has
    freed every earlier model; a child that exits with anything but 0 or
    17 fails the phase:
    (a) serving olmo-1b at full width and depth (random weights, seed 0):
        10 requests of 128 prompt tokens, budgets 4,8,16,24, 4 slots, a
        ``sync`` session commit every 3 ticks; an uninterrupted run, then
        a kill (``os._exit(17)`` in the commit window's fault hook) at
        each of ``pre_flush``, ``mid_flush`` and ``post_completeOp`` at
        tick >= 6 and its restart: each restart resumes at the newest
        completed commit (ticks 3, 3, 6) and every session's tokens equal
        the uninterrupted run's bit for bit;
    (b) training olmo-1b at full width cut to 4 layers: (8, 512) batches,
        ``sharded-async`` over 4 shards, 4 steps, a commit every 2, two
        manifests kept; an uninterrupted run, then a kill at
        ``mid_flush`` of step 3 and its restart, which resumes at step 1
        and ends with the uninterrupted run's params digest.
    Each child's flash launches (its own counters, from 0 at its start;
    the killed ones print theirs in their kill line) must equal 16 a
    prefill (serving) or 8 forward and 4 backward a step (training), at
    the prefills and steps the CPU rehearsal of the phase predicts
    (``CRASH_SERVE_PREFILLS``, ``CRASH_TRAIN_STEPS``).  Printed for each
    child beside the card's name and power limit: wall s, ``recover_s``
    (from the process's start to the end of its first step or scheduler
    round) and the bytes it recovered into the card.
15. the rank cluster, the KV cache's tiers and legacy serving, after the
    parent has freed every earlier model:
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
    (b) one olmo-1b lane at full width (t_max 560, 73,400,320 bytes,
        random bf16) through ``TieredKVCache``: ``stage``, a peer
        ``spill``, ``spill_durable`` and ``spill_auto`` under
        ``cxl11-direct`` (staging) and under ``cxl30-fabric`` with staging
        priced out (the pool), as ``tests/test_placement.py:224-250``;
        each restored into a lane on the card bit-identically, each copy
        to the host counted once; bytes and ms of each printed;
    (c) olmo-1b at full width and depth served with ``paged=False`` (the
        legacy whole-lane commits) on the first 8 requests of phase 4's
        trace, 4 slots, a ``sync`` commit every 4: the schedule (50 ticks,
        8 prefills, 13 commits) as the CPU rehearsal gives it, 16 flash
        launches a prefill, D2H = 30 lane copies; tokens equal to the
        paged run of the same requests; a crash after 10 ticks resumes at
        tick 8 from the whole lanes with every token equal.  Commits, D2H
        bytes and host s in commit printed against the paged run's.

Each path and each run of phases 9, 10, 11, 12, 13 and 15 (c) is driven
with every launch count set to 0 just before it and read just after; the
children of phase 14 start with theirs at 0.  Then a
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

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 2e-2
GMM_REL_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
WKV_REL_TOL = 1e-3
SCAN_REL_TOL = 1e-4
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
}
ARCHS = ("olmo-1b", "olmoe-1b-7b", "rwkv6-7b", "jamba-1.5-large-398b")
#: the depth each path runs at (the rest of each config as published):
#: jamba-1.5-large-398b is 797 GB in bf16 at its 72 layers; 5 hold 48.1 GB
DEPTH = {"jamba-1.5-large-398b": 5}
PATH_KW = dict(n_slots=4, commit_every=4)
OLMO_D2H_BYTES = 5_431_623_680     # olmo-1b's 25 commits of this trace
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
                    args = re.match(r"I((?:Li\d+E)+)E", rest)
                    return (f"{ident}<"
                            f"{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
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


def attention_bwd_bound_ms(B, H, K, Sq, Sk, hd, causal) -> tuple:
    """Least time for the backward: q, k, v, o, dO read once and dq, dk,
    dv written once (bf16; the fp32 lse rows read once too), vs
    the five products over the unmasked (q, kv) pairs (q·k, dO·v, P·dO,
    dS·k, dS·q: 2 hd multiply-adds each)."""
    nbytes = (2 * (3 * B * H * Sq * hd + 4 * B * K * Sk * hd
                   + B * H * Sq * hd) + 4 * B * H * Sq)
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    flops = 5 * 2 * hd * pairs * B * H
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


def phase_flash_bwd(torch, ops):
    """Phase 3, the backward: the forward's logsumexp and the backward
    kernel against their plain versions, two launches bit for bit, and
    times beside SDPA's and the bound."""
    from repro_torch.kernels.attention import kernel
    cases = [  # (name, B, H, K, Sq, Sk, hd, causal)
        ("train_b8_s512", 8, 16, 16, 512, 512, 128, True),
        ("path_s512", 1, 16, 16, 512, 512, 128, True),
        ("gqa_h32_k8_s200", 2, 32, 8, 200, 200, 128, True),
        ("ragged_s77_hd64", 1, 16, 16, 77, 77, 64, True),
        ("noncausal_sq300_sk700", 2, 16, 16, 300, 700, 128, False),
        ("gqa_h8_k2_s512", 1, 8, 2, 512, 512, 128, True),
        ("ragged_s300", 1, 4, 4, 300, 300, 128, True),
        ("hd64_s512", 1, 8, 8, 512, 512, 64, True),
        ("causal_sq100_sk300", 1, 4, 2, 100, 300, 128, True),
        # phase 13's whisper-small training shapes (see phase_kernel)
        ("whisper_enc_b8_s1500", 8, 12, 12, 1500, 1500, 64, False),
        ("whisper_cross_b8_sq448_sk1500", 8, 12, 12, 448, 1500, 64, False),
        ("whisper_dec_b8_s448", 8, 12, 12, 448, 448, 64, True),
    ]
    gen = torch.Generator("cuda").manual_seed(4321)
    rows = {}
    for name, B, H, K, Sq, Sk, hd, causal in cases:
        G = H // K
        scale = hd ** -0.5
        rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda"
                                        ).to(torch.bfloat16)
        q, k, v = rn(B, Sq, K, G, hd), rn(B, Sk, K, hd), rn(B, Sk, K, hd)
        dout = rn(B, Sq, K, G, hd)
        out = torch.empty_like(q)
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
        doh = dout.reshape(B, Sq, H, hd).transpose(1, 2).contiguous()
        torch.use_deterministic_algorithms(False)
        try:
            fast_fb, fast_bwd = map(sdpa_call_ms, sdpa_calls(
                torch, qh, kh, vh, doh, causal))
        finally:
            torch.use_deterministic_algorithms(True)
        try:      # a yardstick only: SDPA may refuse a deterministic bwd
            lib_fb_fn, lib_bwd_fn = sdpa_calls(torch, qh, kh, vh, doh,
                                               causal)
            lib_fb = sdpa_call_ms(lib_fb_fn)
            kernel_ms, lib_bwd, k_runs, l_runs = paired_ms(
                bwd, lib_bwd_fn, timer=sdpa_call_ms)
        except RuntimeError as e:
            print(f"kernel flash_attention_bwd {name}: SDPA backward under "
                  f"deterministic algorithms not available ({e}); library "
                  f"times below are without them", flush=True)
            lib_fb, lib_bwd = fast_fb, fast_bwd
            kernel_ms, k_runs, l_runs = sdpa_call_ms(bwd), [], []
        bound_ms, bound_by = attention_bwd_bound_ms(B, H, K, Sq, Sk, hd,
                                                    causal)
        rows[name] = dict(shape=[B, H, K, Sq, Sk, hd, hd], causal=causal,
                          max_abs_err=max(errs.values()), errs=errs,
                          lse_err=lse_err, kernel_ms=kernel_ms,
                          device_ms=graph_ms, kernel_runs=k_runs,
                          library_runs=l_runs,
                          fwd_bwd_ms=fwd_bwd_ms, plain_ms=plain_ms,
                          library_ms=lib_bwd, library_fwd_bwd_ms=lib_fb,
                          library_nondeterministic_ms=fast_bwd,
                          library_nondeterministic_fwd_bwd_ms=fast_fb,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_over_bound=kernel_ms / bound_ms,
                          kernel_over_library=kernel_ms / lib_bwd)
        print(f"kernel flash_attention_bwd {name}: B={B} H={H} K={K} "
              f"Sq={Sq} Sk={Sk} hd={hd} causal={causal} err/max|plain| dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} "
              f"(tol {TOL}) lse_err={lse_err:.3e} (tol 1e-4) two launches "
              f"bit-identical; kernel_ms={kernel_ms:.5f} (eager, in turns "
              f"with SDPA; device_ms {graph_ms:.5f} from a CUDA graph; "
              f"fwd+bwd {fwd_bwd_ms:.5f}) plain_ms={plain_ms:.5f} "
              f"library_ms(sdpa bwd)={lib_bwd:.5f} (fwd+bwd {lib_fb:.5f}) "
              f"[deterministic algorithms off: bwd {fast_bwd:.5f}, fwd+bwd "
              f"{fast_fb:.5f}] bound_ms={bound_ms:.5f} ({bound_by}) "
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


def phase_gmm(torch, gmm_ops):
    """Phase 3: the grouped-matmul kernel against its plain version on the
    card, timed at the olmoe and the jamba-1.5-large paths' four shapes."""
    from repro_torch.kernels.moe_gmm import kernel
    from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref
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
        ("ragged_c37", 3, 37, 200, 72, False),
        ("ragged_c1", 3, 1, 200, 72, False),
        ("d1000", 8, 48, 1000, 256, False),
        ("c300_f200", 4, 300, 512, 200, False),
    ]
    gen = torch.Generator("cuda").manual_seed(4321)
    rows = {}
    for name, E, C, D, F, timed in cases:
        x = torch.randn((E, C, D), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        w = torch.randn((E, D, F), generator=gen, device="cuda"
                        ).mul_(0.02).to(torch.bfloat16)
        out = gmm_ops.grouped_matmul(x, w)
        torch.cuda.synchronize()
        config = launch_config(kernel, "repro_grouped_matmul_last_launch")
        ref = grouped_matmul_ref(x.float(), w.float())
        err = float((out.float() - ref).abs().max())
        limit = GMM_REL_TOL * float(ref.abs().max())
        check(bool(torch.isfinite(out).all()), f"gmm {name}: non-finite")
        check(err <= limit, f"gmm {name}: max abs err {err} > {limit}")
        row = dict(shape=[E, C, D, F], max_abs_err=err, limit=limit,
                   launch=dict(chunks=config[0], stages=config[1],
                               shared_bytes=config[2], blocks=config[3]))
        msg = (f"kernel grouped_matmul {name}: E={E} C={C} D={D} F={F} "
               f"max_abs_err={err:.3e} (limit {limit:.3e}) launch: "
               f"{config[0]} 16-row chunks, {config[1]} stages, {config[2]} "
               f"bytes of shared memory, {config[3]} blocks")
        if timed:
            kernel_ms, library_ms, k_runs, l_runs = paired_ms(
                lambda: kernel.grouped_matmul_fwd(x, w, out),
                lambda: torch.bmm(x, w))
            kernel_call_ms = call_ms(lambda: gmm_ops.grouped_matmul(x, w))
            # the plain version makes an fp32 copy of w (12.9 GB at
            # jamba's widths): one call a graph there
            plain_ms = device_ms(lambda: grouped_matmul_ref(x, w),
                                 reps=5 if E * D * F < 1e9 else 1)
            bound_ms, bound_by = gmm_bound_ms(E, C, D, F)
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
        rows[name] = row
        print(msg, flush=True)
        del x, w, out, ref
    return rows


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
KVBLK_BYTES = 2_097_152        # one olmo-1b kvblk/ object: k + v, 16 tokens


def durable_tick(mode: str, crash_ticks: int, every: int):
    """The tick a crash after ``crash_ticks`` ticks resumes from: the last
    commit under a blocking schedule, the one before it under an async
    one (commit(s) publishes s - every and launches s)."""
    ticks = list(range(every, crash_ticks + 1, every))
    if mode in ("async", "sharded-async"):
        ticks = ticks[:-1]
    return ticks[-1] if ticks else None


def phase_features(torch, cfg, trace, t_max, counters) -> dict:
    """9. The serving features on olmo-1b at full width and depth (see the
    docstring): (a) the four commit schedules and a crash under
    sharded-async, (b) the static baseline, (c) prefix reuse across two
    engines on one pool.  Every run is driven with the launch counts set
    to 0 just before it and read just after."""
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
            check(run["d2h_bytes"] == OLMO_D2H_BYTES,
                  f"(a) {mode}: D2H {run['d2h_bytes']} bytes, expected "
                  f"{OLMO_D2H_BYTES}")
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
              "prefills, 25 commits, D2H " + str(OLMO_D2H_BYTES)
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
              == (OLMO_D2H_BYTES + 2 * lane, OLMO_D2H_BYTES),
              f"(c) D2H bytes {r0['d2h_bytes']} / {r3['d2h_bytes']}: "
              f"expected olmo-1b's {OLMO_D2H_BYTES} plus one lane a "
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
    """10. N serving engines over one pool on olmo-1b at full width and
    depth (see the docstring): (a) one engine, then a 2-engine fleet with
    rebalancing, (b) engine 3 on the fleet's pool, (c) a forced live
    migration, (d) a kill at ``mig_commit`` with engine 2's staging buffer
    wiped and a fresh fleet's resume, (e) the fleet under ``auto`` on the
    switched-pool topology.  Every run is driven with the launch counts set
    to 0 just before it and read just after."""
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
#: to 4, to keep the script within its time limit beside phase 14 (each
#: full-depth commit of 11.8 GB took ~23 host s)
TRAIN_LAYERS = 4
#: the cut model's parameters (``ModelConfig.param_count``; 1,176,764,416
#: at 16 layers) and its committed bytes: params bf16 + mu and nu fp32 +
#: 28 bytes of counters (int32 step, (2,) uint32 key data) and pipeline
#: (two int64)
TRAIN_PARAMS = 371_458_048
TRAIN_CKPT_BYTES = 3_714_580_508
#: phase 11's run: the reference launcher's batch and sequence
#: (``repro/launch/train.py`` defaults), 8 steps, a sync commit every 4,
#: two manifests kept
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_KW = dict(n_steps=8, commit_every=4, commit_mode="sync", retention=2)
#: retention 2 keeps at most three ~3.7 GB commits on disk at once
TRAIN_DISK_BYTES = 12e9


def _loss_and_grad_norm(torch, bundle, params, batch) -> tuple:
    """The loss and the global grad norm of one batch (no update)."""
    from repro_torch.utils.tree import tree_flatten
    leaves, treedef = tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = bundle.loss(treedef.unflatten(live), batch)
    grads = torch.autograd.grad(loss, live)
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    return float(loss.detach()), float(norm)


def _timing_means(r) -> tuple:
    comp = [t.compute_s for t in r.timings if t.compute_s]
    commits = [t.commit_s for t in r.timings if t.commit_s]
    return (statistics.mean(comp) * 1e3 if comp else 0.0,
            statistics.mean(commits) if commits else 0.0, len(commits))


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
          f"phase 11 keeps up to three ~3.7 GB commits (retention 2) and "
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

    # (b) the clean run
    state0 = init_train_state(params, 0, cfg.moment_dtype)
    step = make_train_step(bundle)

    def loop(pool, **kw):
        pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size), TRAIN_BATCH,
                            TRAIN_SEQ)
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = run_durable_loop(step, state0, pipe, pool, **TRAIN_KW, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, read_counts(counters)

    pool_b = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        rb, wall_b, b_launches = loop(pool_b)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        man = DSMPool(pool_b).latest_manifest()
        n_manifests = len(DSMPool(pool_b).manifests_desc())
    finally:
        shutil.rmtree(pool_b, ignore_errors=True)
    nbytes = sum(o["nbytes"] for o in man["objects"].values())
    step_ms, commit_s, n_commits = _timing_means(rb)
    moved = sum(int((a != b).sum()) for a, b in
                zip(tree_leaves(rb.state.params), tree_leaves(params)))
    n_steps = TRAIN_KW["n_steps"]
    out["clean"] = dict(losses=rb.losses, wall_s=wall_b, step_ms=step_ms,
                        commit_s=commit_s, commits_timed=n_commits,
                        ckpt_bytes_per_commit=nbytes, launches=b_launches,
                        peak_gb=peak_gb, params_moved=moved,
                        manifests_kept=n_manifests)
    print(f"train (b): {n_steps} steps of ({TRAIN_BATCH}, {TRAIN_SEQ}), "
          f"losses {[round(x, 6) for x in rb.losses]}; {step_ms:.1f} ms a "
          f"step (compute), {commit_s:.3f} host s a commit ({n_commits} "
          f"timed, schedule sync), wall {wall_b:.1f} s; "
          f"ckpt_bytes_per_commit {nbytes}; launches {b_launches}; peak "
          f"{peak_gb:.2f} GB; bf16 param elements moved {moved} of "
          f"{n_params}; manifests kept {n_manifests}", flush=True)
    check(nbytes == TRAIN_CKPT_BYTES,
          f"train (b): {nbytes} bytes a commit, expected {TRAIN_CKPT_BYTES}")
    check(man["step"] == n_steps - 1 and int(rb.state.opt.step) == n_steps,
          f"train (b): newest manifest step {man['step']}, opt step "
          f"{int(rb.state.opt.step)}")
    check(all(math.isfinite(x) for x in rb.losses) and len(rb.losses)
          == n_steps, f"train (b): losses {rb.losses}")
    check(b_launches["flash_attention"] == n_steps * 2 * L
          and b_launches["flash_attention_bwd"] == n_steps * L,
          f"train (b): launches {b_launches}, expected {n_steps * 2 * L} "
          f"forward and {n_steps * L} backward")

    # (c) crash before the commit of step 6, recover, finish
    pool_c = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        rc, wall_c, c_launches = loop(pool_c,
                                      crash_at={6: "before_commit"})
    finally:
        shutil.rmtree(pool_c, ignore_errors=True)
    check(rc.crashes == 1 and rc.recoveries == ["pool"],
          f"train (c): {rc.crashes} crashes, recoveries {rc.recoveries}")
    # steps 0-6, then 4-7 again from the commit of step 3
    check(len(rc.losses) == n_steps + 3,
          f"train (c): {len(rc.losses)} losses, expected steps 0-6 then "
          f"4-7")
    check(rc.losses[-4:] == rb.losses[4:],
          f"train (c): losses of steps 4-7 {rc.losses[-4:]} != clean "
          f"{rb.losses[4:]}")
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
    }
    step_ms_c, commit_s_c, _ = _timing_means(rc)
    out["crash"] = dict(losses=rc.losses, wall_s=wall_c, step_ms=step_ms_c,
                        commit_s=commit_s_c, launches=c_launches,
                        recoveries=rc.recoveries, bit_identical=same)
    print(f"train (c): crash before the commit of step 6: {rc.crashes} "
          f"crash, recoveries {rc.recoveries}, resumed at step 4; losses "
          f"of steps 4-7 bit-identical to (b)'s; bit-identical to (b): "
          f"{same}; wall {wall_c:.1f} s, {step_ms_c:.1f} ms a step, "
          f"{commit_s_c:.3f} host s a commit; launches {c_launches}",
          flush=True)
    check(all(same.values()), f"train (c): not bit-identical: {same}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train: phase 11 took {out['phase_s']:.1f} s", flush=True)
    out["launches"] = {"train (a)": a_launches, "train (b)": b_launches,
                       "train (c)": c_launches}
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
    print(f"whisper: phase 13 took {out['phase_s']:.1f} s", flush=True)
    out["launches"] = {"whisper train (a)": b_launches,
                       "whisper train (a) crash": c_launches,
                       "whisper decode (b)": inf_launches}
    return out


#: phase 14: real process kills of the port's serving and training workers
#: (``repro_torch.scenarios``), spawned one after another on the card.
#: Serving: olmo-1b at full width and depth, 10 requests of 128 prompt
#: tokens, budgets 4,8,16,24, 4 slots, a sync session commit every 3
#: ticks; each kill at the first hook of its point at tick >= 6.
#: Training: olmo-1b at full width cut to 4 layers, (8, 512) batches,
#: sharded-async over 4 shards, 4 steps, a commit every 2, two manifests
#: kept; killed at mid_flush of step 3 (the second commit; a 4-step run
#: commits no step >= 4)
CRASH_SERVE_KW = dict(requests=10, slots=4, commit_every=3, prompt_len=128,
                      new_tokens="4,8,16,24", commit_mode="sync", full=True)
CRASH_SERVE_KILL_STEP = 6
CRASH_TRAIN_KW = dict(steps=4, commit_every=2, mode="sharded-async",
                      shards=4, retention=2, model="full", layers=4)
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
#: the training scenario keeps at most three ~4.7 GB commits of one pool
CRASH_DISK_BYTES = 20e9
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
    with anything but 0 (restarts, references) or 17 (kills) fails."""
    from repro_torch.configs import get_config
    from repro_torch.dsm.flit_runtime import KILL_POINTS
    from repro_torch.scenarios.runner import (reference_run, run_scenario,
                                              run_serve_scenario,
                                              serve_reference_run)
    from repro_torch.scenarios.worker import KILL_EXIT
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    print(f"crash: the parent holds {held / 1e9:.3f} GB of the card before "
          f"spawning its children", flush=True)
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= CRASH_DISK_BYTES,
          f"crash: {tmp} holds {free / 1e9:.1f} GB free, the training "
          f"scenario needs ~{CRASH_DISK_BYTES / 1e9:.0f} GB")
    L = get_config("olmo-1b").n_layers
    LT = CRASH_TRAIN_KW["layers"]
    out = {"children": {}, "launches": {}}
    work = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    try:
        # (a) serving: an uninterrupted run, then one kill per point
        ref = serve_reference_run(work, device="cuda", **CRASH_SERVE_KW)
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
        for p in KILL_POINTS:
            r = run_serve_scenario(p, work, kill_step=CRASH_SERVE_KILL_STEP,
                                   ref_outputs=res["outputs"],
                                   device="cuda", **CRASH_SERVE_KW)
            for c in r.children:
                out["children"][f"serve {p} {c['role']}"] = c
            check(r.killed and len(r.children) == 2
                  and r.children[0]["rc"] == KILL_EXIT
                  and r.children[1]["rc"] == 0,
                  f"crash: serve {p}: exit codes "
                  f"{[c['rc'] for c in r.children]} (17 then 0): {r.detail}")
            kill, restart = r.children
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
            check(r.ok and r.resumed_from == CRASH_RESUME[p]
                  and restart["result"]["cublas_workspace"]
                  == CUBLAS_WORKSPACE,
                  f"crash: serve {p}: completed {r.completed_ticks_at_kill},"
                  f" resumed {r.resumed_from} (expected "
                  f"{CRASH_RESUME[p]}), outputs bit-identical "
                  f"{r.outputs_match}")
            print(f"crash: serve {p}: killed at tick "
                  f"{kill['result']['tick']}, commits durable "
                  f"{r.completed_ticks_at_kill}, resumed at tick "
                  f"{r.resumed_from} with {r.resumed_sessions} sessions "
                  f"running and {r.recovered_done} done; every session's "
                  f"tokens bit-identical to the uninterrupted run",
                  flush=True)
        shutil.rmtree(work, ignore_errors=True)

        # (b) training: an uninterrupted run, then a mid_flush kill
        os.makedirs(work, exist_ok=True)
        tref = reference_run(work, device="cuda", **CRASH_TRAIN_KW)
        shutil.rmtree(os.path.join(work, "pool_reference"),
                      ignore_errors=True)
        point, kill_step = CRASH_TRAIN_KILL
        r = run_scenario(point, work, kill_step=kill_step,
                         ref_digest=tref["result"]["digest"], device="cuda",
                         **CRASH_TRAIN_KW)
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
        check(r.ok and r.resumed_from == CRASH_RESUME["train"]
              and restart["device"] == torch.cuda.get_device_name(0)
              and restart["cublas_workspace"] == CUBLAS_WORKSPACE,
              f"crash: train {point}: completed {r.completed_steps_at_kill}, "
              f"resumed {r.resumed_from} (expected {CRASH_RESUME['train']}),"
              f" digest {r.final_digest} vs {r.reference_digest}")
        print(f"crash: train {point}: killed at step {kill_step}, commits "
              f"durable {r.completed_steps_at_kill}, resumed at step "
              f"{r.resumed_from} from the {r.recovery_source} "
              f"({restart['recovered_bytes']} bytes into HBM), final params "
              f"digest {r.final_digest} equal to the uninterrupted run's",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"crash: phase 14 took {out['phase_s']:.1f} s [{card}]", flush=True)
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


def _cluster_child(name: str, child: dict, card: str) -> dict:
    """Print one rank of phase 15 (a) and return its numbers."""
    r = child["result"] or {}
    row = dict(rc=child["rc"], wall_s=child["wall_s"],
               start_s=r.get("start_s"), recover_s=r.get("recover_s"),
               recovered_bytes=r.get("recovered_bytes"),
               commits=r.get("commits"), steps_run=r.get("steps_run"))
    fmt = lambda v: "-" if v is None else format(v, ".2f")
    print(f"cluster: {name}: rc {row['rc']}, wall {row['wall_s']:.2f} s, "
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
    """15 (c): olmo-1b served at full width and depth with the legacy
    whole-lane commits: an uninterrupted run, the paged run of the same
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
    """Phase 15: (a) the rank cluster, (b) whole-lane tiers, (c) legacy
    serving (see the module docstring)."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["ranks"] = phase_cluster_ranks(torch, card)
    out["ranks_s"] = time.perf_counter() - t0
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
    print(f"cluster: phase 15 took {out['phase_s']:.1f} s ((a) "
          f"{out['ranks_s']:.1f}, (b) {out['tiers_s']:.1f}, (c) "
          f"{out['legacy_s']:.1f}) [{card}]", flush=True)
    return out


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
                "wkv6": (wkv_ops, "LAUNCHES"),
                "selective_scan": (scan_ops, "LAUNCHES")}

    report = {}
    # -- 1. environment ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} python "
          f"{sys.version.split()[0]}", flush=True)
    report["card"] = card

    # -- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(KERNELS)} in {build_s:.1f}s (in parallel)",
          flush=True)
    for name, lib in libs.items():
        print(f"build: {name} -> {lib}", flush=True)
        for entry, line in ptxas_report(build.build_log(name)):
            print(f"build: {name} {entry} ptxas {line}", flush=True)
    report["build_s"] = build_s

    # -- 3. kernels against their plain versions ----------------------------
    report["kernel_cases"] = phase_kernel(torch, ops)
    serve_ms = report["kernel_cases"]["path_s512"]["kernel_ms"]
    print(f"kernel flash_attention path_s512 with the logsumexp output in "
          f"the source (a null pointer at serving): {serve_ms:.5f} ms "
          f"beside {FLASH_SERVE_MS_BEFORE} before it (PERF.md); "
          f"ratio {serve_ms / FLASH_SERVE_MS_BEFORE:.3f}", flush=True)
    report["bwd_cases"] = phase_flash_bwd(torch, ops)
    report["gmm_cases"] = phase_gmm(torch, gmm_ops)
    report["wkv_cases"] = phase_wkv(torch, wkv_ops)
    report["scan_cases"] = phase_scan(torch, scan_ops)

    # -- 4. to 7. the four serving paths ------------------------------------
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

    # -- 8. the CXL0 model --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    # as ``python -m repro_torch.bench.model_fuzz`` runs it: without the
    # serving paths' deterministic algorithms, which fill every new tensor
    # (one more kernel per op; the twin is integer-only and exact anyway)
    torch.use_deterministic_algorithms(False)
    report["cxl0"] = phase_cxl0(torch, card)

    # -- 9. the serving features on olmo-1b -----------------------------------
    set_determinism()
    gc.collect()
    torch.cuda.empty_cache()
    report["features"] = phase_features(torch, get_config("olmo-1b"), trace,
                                        t_max, counters)
    # -- 10. the fleet on olmo-1b ---------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["fleet"] = phase_fleet(torch, get_config("olmo-1b"), counters)
    # -- 11. durable training of olmo-1b ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = phase_train(
        torch, get_config("olmo-1b").with_(n_layers=TRAIN_LAYERS), counters)
    # -- 12. the other five decoder-only architectures ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["archs"] = phase_archs(torch, trace, t_max, counters)
    # -- 13. whisper-small: durable training, prefill and decode -----------
    gc.collect()
    torch.cuda.empty_cache()
    report["whisper"] = phase_whisper(torch, get_config("whisper-small"),
                                      counters)
    # -- 14. crash scenarios: real process kills of the workers ------------
    gc.collect()
    torch.cuda.empty_cache()
    report["crash"] = phase_crash(torch, card)
    # -- 15. the rank cluster, whole-lane tiers, legacy serving -----------
    gc.collect()
    torch.cuda.empty_cache()
    report["cluster"] = phase_cluster(torch, get_config("olmo-1b"), trace,
                                      t_max, counters, card)
    by_run = {a: p["launches"] for a, p in paths.items()}
    by_run.update({f"olmo-1b {r}": n
                   for r, n in report["features"]["launches"].items()})
    by_run.update({f"olmo-1b fleet {r}": n
                   for r, n in report["fleet"]["launches"].items()})
    by_run.update({f"olmo-1b {r}": n
                   for r, n in report["train"]["launches"].items()})
    by_run.update(report["archs"]["launches"])
    by_run.update(report["whisper"]["launches"])
    # the children of phase 14 count in their own processes and report
    # the flash pair
    by_run.update(report["crash"]["launches"])
    by_run.update(report["cluster"]["launches"])

    mains = {"flash_attention": report["kernel_cases"]["path_s512"],
             "grouped_matmul": report["gmm_cases"]["decode_up"],
             "wkv6": report["wkv_cases"]["prefill"],
             "selective_scan": report["scan_cases"]["prefill"],
             "flash_attention_bwd": report["bwd_cases"]["train_b8_s512"]}
    timed = {"flash_attention": report["kernel_cases"],
             "grouped_matmul": report["gmm_cases"],
             "wkv6": report["wkv_cases"], "selective_scan": report["scan_cases"],
             "flash_attention_bwd": report["bwd_cases"]}
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
            "timed_cases": cases})
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
