"""Serving launcher: continuous batching over the durable tier stack — the
port of ``repro.launch.serve`` (one engine, one device, no mesh).

    # stateless continuous batching, mixed-length synthetic trace
    python -m repro_torch.launch.serve --arch olmo-1b --smoke --requests 16

    # durable serving: sessions commit through the FliT path; re-running
    # the same command after a kill resumes every committed session
    python -m repro_torch.launch.serve --smoke --pool "$TMPDIR/serve_pool" \\
        --commit-every 4 --commit-mode sharded-async

    # the static-batch baseline the benchmark compares against
    python -m repro_torch.launch.serve --smoke --mode static

    # a 2-engine fleet over one pool: cost-routed admission, rebalancing
    # live migrations, cross-engine prefix reuse; the placement policy of
    # the emulated topology picks the schedule under --commit-mode auto
    python -m repro_torch.launch.serve --smoke --pool "$TMPDIR/fleet_pool" \
        --engines 2 --topology cxl20-switched-pool --commit-mode auto

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import os
import time


def set_determinism():
    """The decode must be bit-reproducible across runs and batch
    compositions (crash-resume rests on it): deterministic algorithms, a
    fixed cuBLAS workspace, no TF32."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _servable(arch: str) -> str:
    """``--arch``'s type: an encoder-decoder id of the reference is
    refused with the reference's reason (anything else unknown by
    ``choices``)."""
    from repro_torch.configs import ENCDEC_ARCHS
    from repro_torch.serve.engine import DECODER_ONLY
    if arch in ENCDEC_ARCHS:
        raise argparse.ArgumentTypeError(f"{arch}: {DECODER_ONLY}")
    return arch


def main(argv=None):
    from repro_torch.dsm.emu import PRESETS
    from repro_torch.dsm.flit_runtime import AUTO_MODE, COMMIT_MODES
    from repro_torch.serve.engine import servable_archs
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", type=_servable,
                    choices=servable_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", default="4,8,16,32,48",
                    help="cycled per-request decode budgets")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", default=None,
                    help="DSM pool dir: enables durable sessions + resume")
    ap.add_argument("--commit-every", type=int, default=4,
                    help="session-commit cadence in decode ticks")
    ap.add_argument("--commit-mode", default="sync",
                    choices=COMMIT_MODES + (AUTO_MODE,),
                    help="flush schedule; 'auto' defers to the placement "
                         "policy (requires --topology)")
    ap.add_argument("--topology", default=None, choices=sorted(PRESETS),
                    help="emulated CXL topology: cost-driven commit shard "
                         "count (and schedule, with --commit-mode auto)")
    ap.add_argument("--engines", type=int, default=1,
                    help=">= 2 serves the trace with a FLEET of engines "
                         "over one pool")
    ap.add_argument("--retire-done", action="store_true")
    ap.add_argument("--restore-mode", default="cache",
                    choices=["cache", "replay"])
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="paged KV layout: tokens per pool block")
    ap.add_argument("--no-prefix-reuse", action="store_true",
                    help="fleet: disable content-addressed cross-engine "
                         "prefix blocks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.commit_mode == AUTO_MODE and args.topology is None:
        ap.error("--commit-mode auto requires --topology")
    if args.topology is not None and args.pool is None:
        ap.error("--topology drives durable-commit placement: it needs "
                 "--pool (stateless serving has nothing to place)")
    if args.engines < 1:
        ap.error(f"--engines {args.engines}: at least one")
    if args.engines >= 2:
        if args.pool is None:
            ap.error("--engines >= 2 is fleet serving over a SHARED pool: "
                     "it needs --pool")
        if args.mode != "continuous":
            ap.error("fleet serving is continuous-batching only")

    set_determinism()
    if args.engines >= 2:
        return _fleet_main(args)
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max

    new_tokens = tuple(int(t) for t in args.new_tokens.split(","))
    trace = synthetic_trace(args.requests, seed=args.seed,
                            prompt_lens=(args.prompt_len,),
                            new_tokens=new_tokens, vocab_size=1)
    engine, cfg = build_serve_engine(
        args.arch, smoke=args.smoke, n_slots=args.slots,
        t_max=trace_t_max(trace), pool_path=args.pool,
        commit_every=args.commit_every if args.pool else 0,
        commit_mode=args.commit_mode, topology=args.topology,
        restore_mode=args.restore_mode, retire_done=args.retire_done,
        seed=args.seed, block_tokens=args.block_tokens, device=args.device)
    # regenerate with the real vocab now the config is known
    trace = synthetic_trace(args.requests, seed=args.seed,
                            prompt_lens=(args.prompt_len,),
                            new_tokens=new_tokens,
                            vocab_size=cfg.vocab_size)

    resumed = engine.resume() if args.pool else None
    if resumed is not None:
        print(f"resumed from committed tick {resumed}")
    t0 = time.perf_counter()
    res = (engine.run(trace) if args.mode == "continuous"
           else engine.run_static(trace))
    if engine.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    engine.close()
    print(f"{res.mode} on {args.device}: {len(res.outputs)} requests, "
          f"{res.emitted_tokens} tokens in {dt:.2f}s "
          f"({res.emitted_tokens / dt:.0f} tok/s), "
          f"{res.decode_ticks} decode ticks, {res.prefills} prefills"
          + (f", {res.commits} session commits (schedule "
             f"{engine.store.committer.mode})" if res.commits else "")
          + (f", {res.resumed_sessions} sessions resumed"
             if res.resumed_sessions else ""))
    return res


def _fleet_main(args):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve.fleet import FleetController
    from repro_torch.serve.trace import synthetic_trace, trace_t_max

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    new_tokens = tuple(int(t) for t in args.new_tokens.split(","))
    trace = synthetic_trace(args.requests, seed=args.seed,
                            prompt_lens=(args.prompt_len,),
                            new_tokens=new_tokens,
                            vocab_size=cfg.vocab_size)
    fl = FleetController(
        args.arch, pool_path=args.pool, n_engines=args.engines,
        smoke=args.smoke, n_slots=args.slots, t_max=trace_t_max(trace),
        commit_every=args.commit_every, commit_mode=args.commit_mode,
        topology=args.topology, seed=args.seed,
        block_tokens=args.block_tokens,
        prefix_reuse=not args.no_prefix_reuse,
        restore_mode=args.restore_mode, retire_done=args.retire_done,
        device=args.device)
    steps = fl.resume()
    resumed = [f"e{i}@{s}" for i, s in steps.items() if s is not None]
    if resumed:
        print(f"resumed: {', '.join(resumed)}")
    t0 = time.perf_counter()
    res = fl.run(trace)
    if args.device == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    schedules = {i: e.store.committer.mode for i, e in fl.engines.items()}
    fl.close()
    per = ", ".join(
        f"e{i}: {len(r.outputs)} req / {r.prefills} prefills / "
        f"{r.prefix_hits} prefix hits / schedule {schedules.get(i)}"
        for i, r in sorted(res.per_engine.items()))
    print(f"fleet[{args.engines}] on {args.device}: {len(res.outputs)} "
          f"requests, {res.emitted_tokens} tokens in {dt:.2f}s "
          f"({res.emitted_tokens / dt:.0f} tok/s), {res.migrations} "
          f"migrations, {res.prefix_hits} prefix hits ({per})")
    return res


if __name__ == "__main__":
    main()
