#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--json PATH]

Drives the port's serving path at the full width of olmo-1b, of
olmoe-1b-7b, of rwkv6-7b and of jamba-1.5-large-398b (depth cut to 5
layers), then the CXL0 model's tensor twin at a fuzzing run's batch, and
prints one line per phase:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions;
2. build — compiles the four kernels of the paths from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, started together) and
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
   * flash attention (one block a 64-row q tile, its kv tiles split
     between two warpgroups while q tiles are fewer than SMs; K / V by TMA
     into an mbarrier ring, both products on wgmma) at the path's shape
     (1, 16, 512, 128) causal, at jamba-1.5-large's (1, 64 heads over 8 kv
     heads, 512, 128) and at ragged, GQA, hd_v != hd and non-causal
     shapes: max abs error against the fp32 plain version (limit 2e-2:
     bf16 output rounding, one ulp near 1 is 7.8e-3); library: SDPA;
   * the grouped matmul (TMA ring, wgmma on out^T = w^T x^T, each weight
     byte read once whatever C is, persistent blocks) at the olmoe path's
     four shapes (prefill up/gate (64, 80, 2048) @ (64, 2048, 1024) and
     down, decode up/gate (64, 32, 2048) @ (64, 2048, 1024) and down), at
     the jamba-1.5-large path's four ((16, 80 | 32, 8192) @ (16, 8192,
     24576) and down) and at ragged shapes (C 37 and C 1 with D 200, F 72;
     D 1000, not a multiple of 64; C 300, two passes, with F 200):
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

Each path is driven with every launch count set to 0 just before it and
read just after.  Then a ``{"kernels": [...]}`` line, the card line again,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a CUDA device, or without
the repo's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
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


def paired_ms(kernel_fn, library_fn, rounds: int = 2) -> tuple:
    """Kernel and library times from one card, in turns (library, kernel,
    kernel, library) ``rounds`` times, each a ``device_ms``; the median of
    each, and every sample."""
    ks, ls = [], []
    for _ in range(rounds):
        ls.append(device_ms(library_fn))
        ks.append(device_ms(kernel_fn))
        ks.append(device_ms(kernel_fn))
        ls.append(device_ms(library_fn))
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
        ("jamba_h64_k8", 1, 64, 8, 512, 512, 128, 128, True),
        ("ragged_s1000", 1, 16, 16, 1000, 1000, 128, 128, True),
        ("gqa_h32_k8", 1, 32, 8, 512, 512, 128, 128, True),
        ("hdv64_hd128", 1, 16, 16, 384, 384, 128, 64, True),
        ("noncausal_sq300_sk700", 2, 16, 16, 300, 700, 128, 128, False),
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


def phase_path(torch, cfg, trace, t_max, counters) -> dict:
    """Phases 4 to 7: one architecture's serving path at full width (at
    the depth ``cfg`` has), then its profile window, then crash and
    resume.  The model is built from ``cfg`` and its weights drawn from a
    torch.Generator seeded 0, then handed to ``build_serve_engine``.
    ``counters`` maps a kernel name to its dispatcher module
    (``LAUNCHES``); every count is set to 0 just before the path runs and
    read just after."""
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
        before = pool_objects(pools[0])
        torch.cuda.synchronize()
        for mod in counters.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        res = engine.run(trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: mod.LAUNCHES for k, mod in counters.items()}
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
                    lane_bytes=lane_bytes, flushed=flushed,
                    phase_s=timer.t, t_max=t_max,
                    peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(f"path: {arch} full width (L={cfg.n_layers} d={cfg.d_model} "
              f"H={cfg.n_heads} hd={cfg.head_dim} V={cfg.vocab_size}"
              + (f" E={cfg.moe.n_experts} top-{cfg.moe.top_k} "
                 f"d_ff_e={cfg.moe.d_ff_expert}" if n_moe else "")
              + (f" rwkv n={cfg.rwkv.head_dim} d_ff={cfg.d_ff}"
                 if n_rwkv else "")
              + (f" K={cfg.n_kv_heads} mamba inner="
                 f"{cfg.mamba.expand * cfg.d_model} N={cfg.mamba.d_state} "
                 f"{n_mamba} mamba / {n_attn} attention layers"
                 if n_mamba else "")
              + f", {bundle.n_params()} params, init {init_s:.1f}s) "
              f"4 slots 16 requests prompt 512: {res.emitted_tokens} tokens "
              f"in {dt:.3f}s = {res.emitted_tokens / dt:.1f} tok/s, "
              f"{res.decode_ticks} decode ticks, {res.prefills} prefills, "
              f"{res.commits} commits flushing {flushed['blocks']} token-block "
              f"and {flushed['states']} state objects, D2H {d2h} bytes "
              f"({lane_bytes} a lane), "
              f"launches "
              f"{launches}; host s in admit {timer.t['admit']:.3f} decode "
              f"{timer.t['decode']:.3f} commit {timer.t['commit']:.3f}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)

        def engine_on(pool):
            return build_serve_engine(
                arch, smoke=False, t_max=t_max, pool_path=pool,
                bundle=bundle, params=params, device="cuda", **PATH_KW)[0]

        # -- profile: where the path's device time goes ---------------------
        e_prof = engine_on(pools[2])
        path["profile"] = phase_profile(torch, e_prof, trace)
        e_prof.close()
        del e_prof

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
    counters = {"flash_attention": ops, "grouped_matmul": gmm_ops,
                "wkv6": wkv_ops, "selective_scan": scan_ops}

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

    mains = {"flash_attention": report["kernel_cases"]["path_s512"],
             "grouped_matmul": report["gmm_cases"]["decode_up"],
             "wkv6": report["wkv_cases"]["prefill"],
             "selective_scan": report["scan_cases"]["prefill"]}
    timed = {"flash_attention": report["kernel_cases"],
             "grouped_matmul": report["gmm_cases"],
             "wkv6": report["wkv_cases"], "selective_scan": report["scan_cases"]}
    kernels = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        row = mains[name]
        cases = {c: {k: r[k] for k in ("kernel_ms", "library_ms", "bound_ms",
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
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {a: p["launches"][name]
                                 for a, p in paths.items()},
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
