"""Serving benchmark: static vs continuous batching on a mixed-length
trace, durable commits and cross-engine prefix reuse; the twin of
``benchmarks/bench_serve.py``.

    python -m repro_torch.bench.serve [--device cpu] [--out DIR]

On the olmo-1b smoke config (weights from a ``torch.Generator`` seeded 0),
20 requests of a 32-token prompt with decode budgets 4/8/16/32/64 through
4 slots:

* ``serve_decode_ticks.<mode>`` — decode steps of the static baseline
  (each batch decodes until its longest sequence ends) and of continuous
  batching; ``serve_emitted_tokens`` — identical across the two (their
  outputs are asserted equal);
* ``serve_durable_commits`` — session commits of the continuous run with
  a pool, committed every 4 ticks under ``sharded-async``;
* ``serve_fleet_prefix_hits`` / ``serve_fleet_prefix_prefills`` — 24
  requests over 2 prompts through 2 slots: an engine with prefix reuse
  publishes its prompts' blocks, then an ``engine_id=3`` engine on the
  same pool serves the trace again from the ``kvblk/`` objects alone
  (its outputs asserted equal to the first engine's);
* ``serve_tokens_per_s.<mode>``, ``serve_speedup`` (continuous over
  static) and ``serve_commit_overhead_frac`` (durable over stateless wall
  time) — printed, not held to the baseline: they are this host's.

The reference's fleet metrics (``serve_fleet_speedup_ge_1.6``, the
migration's token loss and outputs) wait for the fleet's port.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

from repro_torch.bench.report import Report, arg_parser

N_REQUESTS = 20
N_SLOTS = 4
PROMPT_LEN = 32
NEW_TOKENS = (4, 8, 16, 32, 64)
COMMIT_EVERY = 4
COMMIT_MODE = "sharded-async"
N_FLEET_REQS = 24
FLEET_SLOTS = 2
FLEET_NEW_TOKENS = (4, 8, 16, 24)
FLEET_PROMPTS = 2


def _timed(engine, trace, mode: str):
    t0 = time.perf_counter()
    res = (engine.run(trace) if mode == "continuous"
           else engine.run_static(trace))
    if engine.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run(device: str = "cuda") -> Report:
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max

    def trace_of(vocab, n=N_REQUESTS, new=NEW_TOKENS, **kw):
        return synthetic_trace(n, prompt_lens=(PROMPT_LEN,),
                               new_tokens=new, vocab_size=vocab, **kw)

    t_max = trace_t_max(trace_of(2))
    eng, cfg = build_serve_engine("olmo-1b", smoke=True, n_slots=N_SLOTS,
                                  t_max=t_max, device=device)
    shared = dict(smoke=True, t_max=t_max, bundle=eng.bundle,
                  params=eng.params, device=device)
    trace = trace_of(cfg.vocab_size)
    eng.run_static(trace[:N_SLOTS])                     # warm-up batch
    res_s, dt_s = _timed(eng, trace, "static")
    eng_c, _ = build_serve_engine("olmo-1b", n_slots=N_SLOTS, **shared)
    res_c, dt_c = _timed(eng_c, trace, "continuous")
    assert res_c.outputs == res_s.outputs, \
        "continuous and static batching must emit identical tokens"

    tmp = tempfile.mkdtemp(prefix="bench_serve_")
    try:
        eng_d, _ = build_serve_engine(
            "olmo-1b", n_slots=N_SLOTS, pool_path=os.path.join(tmp, "pool"),
            commit_every=COMMIT_EVERY, commit_mode=COMMIT_MODE, **shared)
        res_d, dt_d = _timed(eng_d, trace, "continuous")
        eng_d.close()

        fleet = trace_of(cfg.vocab_size, N_FLEET_REQS, FLEET_NEW_TOKENS,
                         n_prompts=FLEET_PROMPTS)
        pool = os.path.join(tmp, "prefix")
        first, _ = build_serve_engine(
            "olmo-1b", n_slots=FLEET_SLOTS, pool_path=pool,
            commit_every=COMMIT_EVERY, prefix_reuse=True, **shared)
        res_1 = first.run(fleet)
        first.close()
        third, _ = build_serve_engine(
            "olmo-1b", n_slots=FLEET_SLOTS, pool_path=pool, engine_id=3,
            commit_every=COMMIT_EVERY, prefix_reuse=True, **shared)
        res_3 = third.run(fleet)
        third.close()
        assert res_3.outputs == res_1.outputs, \
            "a prefix hit must emit the tokens of the prefill it replaces"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    report = Report("serve")
    report.set_config(arch="olmo-1b smoke", device=device,
                      n_requests=N_REQUESTS, n_slots=N_SLOTS,
                      prompt_len=PROMPT_LEN, new_tokens=list(NEW_TOKENS),
                      commit_every=COMMIT_EVERY, commit_mode=COMMIT_MODE)
    for mode, res, dt in (("static", res_s, dt_s),
                          ("continuous", res_c, dt_c)):
        report.record(f"serve_tokens_per_s.{mode}", res.emitted_tokens / dt,
                      f"mode={mode}", fmt=".0f")
        report.record(f"serve_decode_ticks.{mode}", res.decode_ticks,
                      f"mode={mode}")
    report.record("serve_emitted_tokens", res_c.emitted_tokens,
                  "identical across modes (asserted)")
    report.record("serve_speedup", (res_c.emitted_tokens / dt_c)
                  / (res_s.emitted_tokens / dt_s),
                  "continuous/static tokens per s (printed, not checked)",
                  fmt=".2f")
    report.record("serve_commit_overhead_frac", dt_d / dt_c - 1.0,
                  f"durable sessions ({COMMIT_MODE}, commit every "
                  f"{COMMIT_EVERY} ticks) vs stateless", fmt=".3f")
    report.record("serve_durable_commits", res_d.commits,
                  "commits in the durable run")
    report.record("serve_fleet_prefix_hits", res_3.prefix_hits,
                  "engine 3 on the publishing engine's pool: admissions "
                  "served from content-addressed blocks")
    report.record("serve_fleet_prefix_prefills", res_3.prefills,
                  "engine 3 on the publishing engine's pool: prefills")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    run(args.device).write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
