"""The killable SERVE worker: one continuous-batching serving process over
a DSM pool — the port of ``repro.scenarios.serve_worker``.

Serving twin of ``scenarios.worker``: runs the durable serving engine
(``repro_torch.serve``) on a deterministic synthetic trace and, when
``--kill-point`` is set, dies with ``os._exit(KILL_EXIT)`` the first time
the session committer's fault hook fires at that point on or after
``--kill-step``: a real process death inside the session-commit window.

On restart (the same command, ``--kill-point none``) the engine recovers
the newest completed session commit: finished sessions come back as
results, running ones resume from their committed KV cache (or replay
from the prompt with ``--restore-mode replay``).  The JSON result reports
every session's output tokens plus a CRC digest, so the runner can compare
kill + restart against an uninterrupted run: the durable-serving contract
is that they are bit-identical.

Fleet mode (``--engines N``, N >= 2) runs the FleetController over the
same pool: forced live migration (``--migrate-at TICK`` moves engine 1's
oldest running session to engine 2), migration kill points
(``--mig-kill-point``) and ``--wipe-staging R`` (engine R's host buffer
lost before recovery, forcing the pool arm of the adoption).
``--engine-id`` + ``--trace-slice`` run ONE namespaced engine of a fleet
pool over a slice of the trace.

    python -m repro_torch.scenarios.serve_worker --device cpu \\
        --pool "$TMPDIR/sp" --kill-point mid_flush --kill-step 6
    python -m repro_torch.scenarios.serve_worker --pool "$TMPDIR/sp" \\
        --full --prompt-len 128 --kill-point mid_flush   # on the card

``--device cuda`` (the default) runs on the card and raises without one;
``--full`` serves the architecture at its published width and depth (the
reference serves the smoke config only).  Weights come from a
``torch.Generator`` seeded ``--seed``.  Beside the reference's fields the
result reports the flash launches (``launches``), the seconds from the
process's start to the end of its first scheduler round (``recover_s``)
and the bytes of the KV caches it recovered (``recovered_bytes``); a
killed worker prints one JSON line with its kill point, tick, launches and
prefills before it exits.  The reference's ``--warmup`` is not offered:
eager PyTorch compiles nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

from repro_torch.dsm.flit_runtime import COMMIT_MODES, KILL_POINTS
from repro_torch.scenarios.worker import (flash_launches, kill_now,
                                          process_age_s)
from repro_torch.serve.fleet import MIGRATION_POINTS


def outputs_digest(outputs: dict) -> int:
    """CRC32 over the canonicalized per-session outputs — the
    cross-process equality check."""
    doc = json.dumps({k: outputs[k] for k in sorted(outputs)},
                     separators=(",", ":"))
    return zlib.crc32(doc.encode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", required=True)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", default="4,8,16,24")
    ap.add_argument("--commit-every", type=int, default=3)
    ap.add_argument("--commit-mode", default="sync", choices=COMMIT_MODES)
    ap.add_argument("--restore-mode", default="cache",
                    choices=["cache", "replay"])
    ap.add_argument("--kill-point", default="none",
                    choices=("none",) + KILL_POINTS)
    ap.add_argument("--kill-step", type=int, default=6,
                    help="fire at the first --kill-point hook whose commit "
                         "tick is >= this")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--result", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true",
                    help="the published config, not the smoke one")
    # fleet mode -------------------------------------------------------------
    ap.add_argument("--engines", type=int, default=1,
                    help=">= 2 runs the FleetController over the pool")
    ap.add_argument("--migrate-at", type=int, default=0,
                    help="fleet: once engine 1 reaches this tick, live-"
                         "migrate its oldest running session to engine 2 "
                         "(0 = no forced migration)")
    ap.add_argument("--mig-kill-point", default="none",
                    choices=("none",) + MIGRATION_POINTS,
                    help="fleet: os._exit after this migration phase")
    ap.add_argument("--wipe-staging", type=int, default=-1,
                    help="wipe engine R's staging buffer before recovery "
                         "(simulated host-buffer loss; -1 = keep)")
    ap.add_argument("--prefix-reuse", action="store_true",
                    help="content-addressed cross-engine prefix blocks")
    ap.add_argument("--rebalance", action="store_true",
                    help="fleet: cost-approved automatic rebalancing")
    # single-engine-of-a-fleet mode -----------------------------------------
    ap.add_argument("--engine-id", type=int, default=0,
                    help="run ONE namespaced engine of a fleet pool")
    ap.add_argument("--trace-slice", default="",
                    help="serve only trace[a:b] (python slice 'a:b')")
    ap.add_argument("--n-prompts", type=int, default=0,
                    help="shared-prefix workload: draw only this many "
                         "distinct prompts and cycle them (0 = every "
                         "request gets a fresh prompt)")
    args = ap.parse_args(argv)

    live = {}                        # the engine, once it is built
    hook = None
    if args.kill_point != "none":
        def hook(point, step):
            if point == args.kill_point and step >= args.kill_step:
                eng = live.get("engine")
                kill_now(point, step, "tick",
                         prefills=None if eng is None else eng._n_prefills)

    mig_hook = None
    if args.mig_kill_point != "none":
        def mig_hook(point, rid=None, src=None, dst=None):
            if point == args.mig_kill_point:
                kill_now(point, rid, "rid")

    # deterministic algorithms and the cuBLAS workspace before the first
    # CUDA call: the restart must decode what the killed run decoded
    from repro_torch.launch.serve import set_determinism
    set_determinism()
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dsm.api import CXL0Config
    from repro_torch.dsm.emu import tree_nbytes
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    from repro_torch.utils.device import resolve_device
    resolve_device(args.device)

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    new_tokens = tuple(int(t) for t in args.new_tokens.split(","))
    # the trace is a pure function of the flags: the restarted process
    # regenerates the request stream the killed one was serving
    trace = synthetic_trace(args.requests, seed=args.seed,
                            prompt_lens=(args.prompt_len,),
                            new_tokens=new_tokens,
                            vocab_size=cfg.vocab_size,
                            n_prompts=args.n_prompts)
    t_max = trace_t_max(trace)
    if args.trace_slice:
        a, b = args.trace_slice.split(":")
        trace = trace[int(a or 0):int(b) if b else None]

    if args.engines >= 2:
        return _fleet_main(args, trace, t_max, hook, mig_hook)

    engine, _ = build_serve_engine(
        args.arch, smoke=not args.full, n_slots=args.slots, t_max=t_max,
        dsm=CXL0Config(path=args.pool, schedule=args.commit_mode,
                       retention=2, fault_hook=hook),
        commit_every=args.commit_every,
        restore_mode=args.restore_mode, seed=args.seed,
        engine_id=args.engine_id, prefix_reuse=args.prefix_reuse,
        device=args.device)
    live["engine"] = engine

    resumed_from = engine.resume()
    recovered_done = len(engine.results)      # finished before the kill
    recovered_bytes = sum(tree_nbytes(c) for c in
                          engine._resume_cache.values() if c is not None)
    t0 = time.perf_counter()
    engine.submit(trace)
    ticks0 = engine._tick
    recover_s = None
    while not engine.sched.done:
        engine.tick()
        if recover_s is None:
            if args.device == "cuda":
                import torch
                torch.cuda.synchronize()
            recover_s = process_age_s()
    res = engine.finish(ticks0)
    serve_seconds = time.perf_counter() - t0
    engine.close()

    result = {
        "ok": True,
        "outputs": res.outputs,
        "digest": outputs_digest(res.outputs),
        "resumed_from": resumed_from,
        "resumed_sessions": res.resumed_sessions,
        "recovered_done": recovered_done,
        "commits": res.commits,
        "decode_ticks": res.decode_ticks,
        "prefills": res.prefills,
        "prefix_hits": res.prefix_hits,
        "emitted_tokens": res.emitted_tokens,
        "serve_seconds": serve_seconds,
        "launches": flash_launches(),
        "recover_s": recover_s,
        "recovered_bytes": recovered_bytes,
        "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
    }
    return _emit(result, args)


def _emit(result: dict, args) -> int:
    line = json.dumps(result)
    if args.result:
        with open(args.result, "w") as f:
            f.write(line)
    print(line)
    return 0


def _fleet_main(args, trace, t_max, fault_hook, mig_hook) -> int:
    """N engines over one pool in this process: forced-migration kill
    cells and the zero-token-loss check.  The restart command (kill points
    off) recovers every engine, completes any half-done handoff and
    finishes the same trace."""
    from repro_torch.serve.fleet import FleetController
    fl = FleetController(
        args.arch, pool_path=args.pool, n_engines=args.engines,
        smoke=not args.full, n_slots=args.slots, t_max=t_max,
        commit_every=args.commit_every, commit_mode=args.commit_mode,
        prefix_reuse=args.prefix_reuse, seed=args.seed,
        restore_mode=args.restore_mode, fault_hook=fault_hook,
        mig_hook=mig_hook, device=args.device)
    if args.wipe_staging >= 0:
        # the target's host buffer vanished with its previous
        # incarnation: adoption must take the pool arm
        fl.staging.wipe(args.wipe_staging)
    steps = fl.resume()
    resumed_from = max((s for s in steps.values() if s is not None),
                       default=None)
    resumed_sessions = sum(e._n_resumed for e in fl.engines.values())
    recovered_done = sum(len(e.results) for e in fl.engines.values())
    fl.submit(trace)
    migrated = False
    ticks0 = {i: e._tick for i, e in fl.engines.items()}
    t0 = time.perf_counter()
    recover_s = None
    while not fl.done:
        fl.tick(rebalance=args.rebalance)
        if recover_s is None:
            recover_s = process_age_s()
        if (args.migrate_at and not migrated
                and fl.engines[1]._tick >= args.migrate_at):
            src = fl.engines[1]
            rid = next((r for r in src.sched.admission_order
                        if r in src.sched.running), None)
            if rid is not None:
                migrated = True
                fl.migrate(rid, 1, 2)
    res = fl.finish(ticks0)
    serve_seconds = time.perf_counter() - t0
    fl.close()

    result = {
        "ok": True,
        "outputs": res.outputs,
        "digest": outputs_digest(res.outputs),
        "resumed_from": resumed_from,
        "resumed_sessions": resumed_sessions,
        "recovered_done": recovered_done,
        "commits": sum(r.commits for r in res.per_engine.values()),
        "decode_ticks": max(r.decode_ticks
                            for r in res.per_engine.values()),
        "prefills": sum(r.prefills for r in res.per_engine.values()),
        "prefix_hits": res.prefix_hits,
        "migrations": res.migrations,
        "emitted_tokens": res.emitted_tokens,
        "serve_seconds": serve_seconds,
        "per_engine_outputs": {i: len(r.outputs)
                               for i, r in res.per_engine.items()},
        "launches": flash_launches(),
        "recover_s": recover_s,
    }
    return _emit(result, args)


if __name__ == "__main__":
    sys.exit(main())
