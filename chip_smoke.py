#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--json PATH]

Drives the port's serving path at the full width of olmo-1b and prints
one line per phase:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions;
2. build — compiles the path's kernel from ``src/repro_torch/csrc`` and
   shows ptxas's register / shared-memory report;
3. kernel — the flash-attention kernel against its plain PyTorch version
   on the card, bf16, at the path's shape (1, 16, 512, 128) causal and at
   ragged, GQA, hd_v != hd and non-causal shapes: max abs error against
   the fp32 plain version (limit 2e-2: bf16 output rounding, one ulp near
   1 is 7.8e-3), kernel / plain / SDPA times (CUDA events, after warm-up)
   and the least time the card could take (bytes at 3.35 TB/s vs
   operations at 989 TFLOP/s);
4. path — ``build_serve_engine("olmo-1b", smoke=False)`` with random
   weights from a torch.Generator seeded 0: 4 slots, 16 requests of 512
   prompt tokens and budgets 4,8,16,32,48, a pool in a temp dir committed
   every 4 ticks (schedule sync), run to completion.  The flash kernel's
   launch count must equal 16 x prefills.  Then ``torch.profiler`` over
   8 ticks of the same path on a fresh pool: device time by kernel name
   against the window's wall time;
5. crash and resume — the same trace on a fresh pool for 10 ticks (not a
   multiple of the commit cadence), the engine dropped without ``finish``
   and ``ctx.crash()``; a new engine on that pool resumes and runs to
   completion; every session's tokens must equal phase 4's bit for bit.

Then a ``{"kernels": [...]}`` line, the card line again, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device, or without the repo's
``src/repro_torch`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
KERNEL_REPLACES = "src/repro/kernels/attention/kernel.py:89"
KERNEL_SOURCE = "src/repro_torch/csrc/flash_attention.cu"


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
    """Phase 3: the kernel against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention import kernel
    cases = [  # (name, B, H, K, Sq, Sk, hd, hd_v, causal)
        ("path_s128", 1, 16, 16, 128, 128, 128, 128, True),
        ("path_s512", 1, 16, 16, 512, 512, 128, 128, True),
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
        kernel_ms = device_ms(lambda: kernel.flash_attention_fwd(
            q, k, v, buf, causal=causal, scale=hd ** -0.5))
        kernel_call_ms = call_ms(lambda: ops.flash_attention(q, k, v,
                                                             causal=causal))
        plain_ms = device_ms(lambda: ops.plain_attention(q, k, v,
                                                         causal=causal),
                             reps=5)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal))
        bound_ms, bound_by = attention_bound_ms(B, H, K, Sq, Sk, hd, hd_v,
                                                causal)
        rows[name] = dict(shape=[B, H, K, Sq, Sk, hd, hd_v],
                          causal=causal, max_abs_err=err,
                          kernel_ms=kernel_ms,
                          kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        print(f"kernel flash_attention {name}: B={B} H={H} K={K} Sq={Sq} "
              f"Sk={Sk} hd={hd} hd_v={hd_v} causal={causal} "
              f"max_abs_err={err:.3e} (tol {TOL}) kernel_ms={kernel_ms:.5f} "
              f"(per eager call {kernel_call_ms:.5f}) "
              f"plain_ms={plain_ms:.5f} library_ms(sdpa)={library_ms:.5f} "
              f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
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
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_us = [ev.device_time_total for ev in prof.events()
                if ev.device_type == DeviceType.CUDA
                and "flash_fwd_kernel" in ev.name]
    print(f"profile: {ticks} ticks ({timer.n['admit']} prefills, "
          f"{timer.n['decode']} decodes, {timer.n['commit']} commits) in "
          f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); flash kernel "
          f"{len(flash_us)} launches, mean "
          f"{sum(flash_us) / max(len(flash_us), 1):.1f} us; host ms in admit "
          f"{timer.t['admit'] * 1e3:.1f} decode {timer.t['decode'] * 1e3:.1f}"
          f" commit {timer.t['commit'] * 1e3:.1f}", flush=True)
    for name, ms in top:
        print(f"profile: {ms:9.3f} ms  {name[:90]}", flush=True)
    return dict(ticks=ticks, wall_ms=wall_ms, device_busy_ms=busy_ms,
                flash_launch_us=flash_us,
                host_s=timer.t, steps=timer.n,
                top=[[n, ms] for n, ms in top])


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
    from repro_torch.launch.serve import set_determinism
    set_determinism()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max

    report = {}
    # -- 1. environment ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} python "
          f"{sys.version.split()[0]}", flush=True)
    report["card"] = card

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build("flash_attention")
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in build.build_log("flash_attention").splitlines()
             if "registers" in l or "spill" in l]
    print(f"build: flash_attention in {build_s:.1f}s -> {lib}", flush=True)
    for l in ptxas:
        print(f"build: ptxas {l}", flush=True)
    report["build_s"] = build_s

    # -- 3. kernel -------------------------------------------------------------
    rows = phase_kernel(torch, ops)
    report["kernel_cases"] = rows

    # -- 4. path ---------------------------------------------------------------
    cfg = get_config("olmo-1b")
    trace = synthetic_trace(16, seed=0, prompt_lens=(512,),
                            new_tokens=(4, 8, 16, 32, 48),
                            vocab_size=cfg.vocab_size)
    t_max = trace_t_max(trace)
    pools = [tempfile.mkdtemp(prefix="chip_smoke_pool_")
             for _ in range(3)]
    try:
        engine, _ = build_serve_engine(
            "olmo-1b", smoke=False, n_slots=4, t_max=t_max,
            pool_path=pools[0], commit_every=4, seed=0, device="cuda")
        bundle, params = engine.bundle, engine.params
        # the full-width prefill gives finite logits of the vocab's width
        logits, _ = bundle.prefill(
            params, {"tokens": torch.tensor([trace[0].prompt],
                                            device="cuda")},
            bundle.init_caches(1, t_max))
        check(tuple(logits.shape) == (1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite/shaped")
        timer = PhaseTimer(engine)
        torch.cuda.synchronize()
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        res = engine.run(trace)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.LAUNCHES
        d2h = engine.store.tiers.d2h_gather_bytes
        engine.close()
        check(sorted(res.outputs) == sorted(r.rid for r in trace),
              "not every request finished")
        for r in trace:
            toks = res.outputs[r.rid]
            check(len(toks) == r.max_new_tokens
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{r.rid}: bad output {toks}")
        check(launches == cfg.n_layers * res.prefills,
              f"flash kernel launches {launches} != {cfg.n_layers} x "
              f"{res.prefills} prefills")
        path = dict(emitted_tokens=res.emitted_tokens, wall_s=dt,
                    tokens_per_s=res.emitted_tokens / dt,
                    decode_ticks=res.decode_ticks, prefills=res.prefills,
                    commits=res.commits, d2h_bytes=d2h,
                    flash_launches=launches, phase_s=timer.t,
                    t_max=t_max)
        report["path"] = path
        print(f"path: olmo-1b full width (L={cfg.n_layers} d={cfg.d_model} "
              f"H={cfg.n_heads} hd={cfg.head_dim} V={cfg.vocab_size}) "
              f"4 slots 16 requests prompt 512: {res.emitted_tokens} tokens "
              f"in {dt:.3f}s = {res.emitted_tokens / dt:.1f} tok/s, "
              f"{res.decode_ticks} decode ticks, {res.prefills} prefills, "
              f"{res.commits} commits, D2H {d2h} bytes, flash launches "
              f"{launches} = {cfg.n_layers} x {res.prefills} prefills; "
              f"host s in admit {timer.t['admit']:.3f} decode "
              f"{timer.t['decode']:.3f} commit {timer.t['commit']:.3f}",
              flush=True)

        def engine_on(pool):
            return build_serve_engine(
                "olmo-1b", smoke=False, n_slots=4, t_max=t_max,
                pool_path=pool, commit_every=4, bundle=bundle,
                params=params, device="cuda")[0]

        # -- profile: where the path's device time goes ---------------------
        e_prof = engine_on(pools[2])
        report["profile"] = phase_profile(torch, e_prof, trace)
        e_prof.close()
        del e_prof

        # -- 5. crash and resume --------------------------------------------
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
        check(step == crash_ticks - crash_ticks % 4,
              f"resumed at tick {step}, expected the last commit "
              f"{crash_ticks - crash_ticks % 4}")
        diff = [rid for rid in res.outputs
                if res3.outputs.get(rid) != res.outputs[rid]]
        check(not diff, f"resumed tokens differ for {diff}")
        report["resume"] = dict(crash_after_ticks=crash_ticks,
                                resumed_tick=step,
                                sessions_resumed=res3.resumed_sessions,
                                prefills_after_resume=res3.prefills)
        print(f"resume: crashed after {crash_ticks} ticks, resumed from "
              f"committed tick {step}, {res3.resumed_sessions} sessions "
              f"resumed, {res3.prefills} prefills after resume, all "
              f"{len(res.outputs)} sessions' tokens bit-identical to the "
              f"uninterrupted run", flush=True)
    finally:
        for p in pools:
            shutil.rmtree(p, ignore_errors=True)

    main_row = rows["path_s512"]
    kernels = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
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
