"""Serve a small model with continuous batching (and, optionally, durable
sessions that survive a kill) — the port of ``examples/serve.py``, on
``repro_torch``.

Thin front-end over the ``repro_torch.serve`` subsystem: a slot-based
scheduler admits requests into fixed decode lanes, a slot-masked decode
step advances every lane at its own position, finished sequences free
their lane immediately, and — when ``--pool`` is given — session state
commits through the FliT durable path so re-running the same command
resumes every committed session bit-identically.  The model is the arch's
smoke config, weights from a ``torch.Generator`` seeded 0; ``--device
cuda`` (the default) serves on the card, every prefill through the
hand-written flash forward, and ``--device cpu`` runs its plain version.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve --arch olmo-1b
      PYTHONPATH=src python -m repro_torch.examples.serve \\
          --pool "$TMPDIR/serve_pool"
"""
import argparse
import time

from repro_torch.configs import get_smoke_config
from repro_torch.serve.engine import build_serve_engine, servable_archs
from repro_torch.serve.trace import synthetic_trace, trace_t_max


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=servable_archs())
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--pool", default=None,
                    help="enable durable sessions in this DSM pool dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import set_determinism
    set_determinism()
    cfg = get_smoke_config(args.arch)
    trace = synthetic_trace(args.requests, prompt_lens=(args.prompt_len,),
                            vocab_size=cfg.vocab_size)
    engine, _ = build_serve_engine(
        args.arch, smoke=True, n_slots=args.slots,
        t_max=trace_t_max(trace), pool_path=args.pool,
        commit_every=4 if args.pool else 0, device=args.device)

    if args.pool and engine.resume() is not None:
        print(f"resumed {len(engine.results)} finished sessions "
              f"from the pool")
    t0 = time.perf_counter()
    res = engine.run(trace)
    dt = time.perf_counter() - t0
    engine.close()

    print(f"arch={args.arch} ({engine.bundle.n_params() / 1e6:.1f}M smoke "
          f"config), {args.slots} slots")
    print(f"{len(res.outputs)} requests, {res.emitted_tokens} tokens in "
          f"{dt:.2f}s ({res.emitted_tokens / dt:.0f} tok/s incl. compile); "
          f"{res.decode_ticks} decode ticks vs "
          f"{sum(r.max_new_tokens for r in trace)} static-worst-case")
    rid = trace[0].rid
    print(f"sampled token ids ({rid}):", res.outputs[rid][:16])
    return res


if __name__ == "__main__":
    main()
