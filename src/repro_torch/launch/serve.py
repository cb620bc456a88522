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

``--device cuda`` (the default) runs on the card and raises without one;
``--device cpu`` runs the plain PyTorch versions.  Flags of features that
are not ported yet (``--commit-mode auto``, ``--topology``, ``--engines``
above 1, ``--no-prefix-reuse``) exit with an error naming them.
"""
from __future__ import annotations

import argparse
import os
import time

NOT_PORTED = "not yet ported to repro_torch (the JAX launcher has it)"


def set_determinism():
    """The decode must be bit-reproducible across runs and batch
    compositions (crash-resume rests on it): deterministic algorithms, a
    fixed cuBLAS workspace, no TF32."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.dsm.flit_runtime import AUTO_MODE, COMMIT_MODES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
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
                    help="flush schedule ('auto' is not ported yet)")
    ap.add_argument("--topology", default=None)
    ap.add_argument("--engines", type=int, default=1)
    ap.add_argument("--retire-done", action="store_true")
    ap.add_argument("--restore-mode", default="cache",
                    choices=["cache", "replay"])
    ap.add_argument("--block-tokens", type=int, default=16,
                    help="paged KV layout: tokens per pool block")
    ap.add_argument("--no-prefix-reuse", action="store_true",
                    help="fleet flag (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.commit_mode == AUTO_MODE:
        ap.error(f"--commit-mode auto (placement-priced, "
                 f"repro.dsm.placement) is {NOT_PORTED}")
    if args.topology is not None:
        ap.error(f"--topology (repro.dsm.emu) is {NOT_PORTED}")
    if args.engines != 1:
        ap.error(f"--engines {args.engines} (fleet serving, "
                 f"repro.serve.fleet) is {NOT_PORTED}")
    if args.no_prefix_reuse:
        ap.error(f"--no-prefix-reuse (a fleet flag, repro.serve.fleet) is "
                 f"{NOT_PORTED}")

    set_determinism()
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
        commit_mode=args.commit_mode, restore_mode=args.restore_mode,
        retire_done=args.retire_done, seed=args.seed,
        block_tokens=args.block_tokens, device=args.device)
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
          + (f", {res.commits} session commits" if res.commits else "")
          + (f", {res.resumed_sessions} sessions resumed"
             if res.resumed_sessions else ""))
    return res


if __name__ == "__main__":
    main()
