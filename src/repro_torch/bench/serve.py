"""Serving benchmark: static vs continuous batching on a mixed-length
trace, durable commits, and a fleet of engines over one pool with
cross-engine prefix reuse and live migration; the twin of
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
* the fleet section: 24 requests over 2 prompts, 2 slots an engine,
  prefix reuse on, committed every 4 ticks.  One engine with a pool
  serves the trace; then a 2-engine ``FleetController`` (rebalancing on)
  serves it with the same tokens (asserted):
  ``serve_fleet_speedup`` is the fleet's tokens per lockstep round over
  the single engine's tokens per tick (rounds, not wall time: the
  engines of an in-process fleet tick one after the other) and
  ``serve_fleet_speedup_ge_1.6`` its floor;
* ``serve_fleet_prefix_hits`` / ``serve_fleet_prefix_prefills`` — an
  ``engine_id=3`` engine on the fleet's pool serves the trace again from
  the ``kvblk/`` objects alone (its outputs asserted equal);
* ``serve_fleet_migration_token_loss`` / ``..._outputs_match`` — a
  fresh 2-engine fleet with one live migration forced from engine 1 to
  engine 2 at engine 1's tick 3: tokens lost against the single engine,
  and whether every stream equals it;
* ``serve_tokens_per_s.<mode>``, ``serve_speedup`` (continuous over
  static), ``serve_commit_overhead_frac`` (durable over stateless wall
  time) and ``serve_fleet_tokens_per_s`` — printed, not held to the
  baseline: they are this host's.
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
#: fleet cells: 24 requests drawing from 2 distinct prompts (the
#: shared-prefix serving workload), 2 slots per engine
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


def force_migration(fleet, trace, at_tick: int = 3):
    """Serve ``trace`` on ``fleet`` without rebalancing, live-migrating
    the first running session of engine 1 to engine 2 once engine 1 has
    ticked ``at_tick`` times.  Returns ``(FleetResult, moved rid)``."""
    fleet.submit(trace)
    moved = None
    while not fleet.done:
        fleet.tick(rebalance=False)
        if moved is None and fleet.engines[1]._tick >= at_tick:
            src = fleet.engines[1]
            moved = next((r for r in src.sched.admission_order
                          if r in src.sched.running), None)
            if moved is not None:
                fleet.migrate(moved, 1, 2)
    return fleet.finish(), moved


def fleet_section(bundle, params, vocab: int, t_max: int,
                  device: str) -> dict:
    """The three fleet cells of the docstring on one weight set."""
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.fleet import FleetController
    from repro_torch.serve.trace import synthetic_trace
    trace = synthetic_trace(N_FLEET_REQS, prompt_lens=(PROMPT_LEN,),
                            new_tokens=FLEET_NEW_TOKENS, vocab_size=vocab,
                            n_prompts=FLEET_PROMPTS)
    kw = dict(smoke=True, n_slots=FLEET_SLOTS, t_max=t_max,
              commit_every=COMMIT_EVERY, prefix_reuse=True, bundle=bundle,
              params=params, device=device)
    tmp = tempfile.mkdtemp(prefix="bench_fleet_")
    try:
        single, _ = build_serve_engine(
            "olmo-1b", pool_path=os.path.join(tmp, "single"), **kw)
        res1, dt1 = _timed(single, trace, "continuous")
        single.close()

        fl = FleetController("olmo-1b", pool_path=os.path.join(tmp, "fleet"),
                             n_engines=2, **kw)
        t0 = time.perf_counter()
        resf = fl.run(trace)        # rebalancing on
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        dtf = time.perf_counter() - t0
        assert resf.outputs == res1.outputs, \
            "fleet placement must not change any token stream"
        rounds = max(r.decode_ticks for r in resf.per_engine.values())

        eng3, _ = build_serve_engine(
            "olmo-1b", pool_path=os.path.join(tmp, "fleet"), engine_id=3,
            **kw)
        res3 = eng3.run(trace)
        eng3.close()
        fl.close()
        assert res3.outputs == res1.outputs

        flm = FleetController("olmo-1b", pool_path=os.path.join(tmp, "mig"),
                              n_engines=2, **kw)
        resm, _ = force_migration(flm, trace)
        flm.close()
        return {
            "speedup": ((resf.emitted_tokens / rounds)
                        / (res1.emitted_tokens / res1.decode_ticks)),
            "single_ticks": res1.decode_ticks, "fleet_rounds": rounds,
            "tokens_per_s": resf.emitted_tokens / dtf,
            "single_tokens_per_s": res1.emitted_tokens / dt1,
            "prefix_hits": res3.prefix_hits,
            "prefix_prefills": res3.prefills,
            "migrations": resm.migrations,
            "migration_token_loss":
                res1.emitted_tokens - resm.emitted_tokens,
            "migration_outputs_match": resm.outputs == res1.outputs,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fleet = fleet_section(eng.bundle, eng.params, cfg.vocab_size, t_max,
                          device)

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
    report.record("serve_fleet_speedup", fleet["speedup"],
                  f"2-engine aggregate tokens/round over 1 engine "
                  f"({fleet['single_ticks']} ticks -> "
                  f"{fleet['fleet_rounds']} rounds, {FLEET_SLOTS} slots "
                  f"each, shared-prefix {FLEET_PROMPTS}-prompt trace)",
                  fmt=".2f")
    report.record("serve_fleet_speedup_ge_1.6",
                  bool(fleet["speedup"] >= 1.6), "acceptance floor")
    report.record("serve_fleet_tokens_per_s", fleet["tokens_per_s"],
                  "in-process fleet wall-clock (engines tick one after "
                  "the other; printed, not checked)", fmt=".0f")
    report.record("serve_fleet_prefix_hits", fleet["prefix_hits"],
                  "3rd engine on the fleet pool: admissions served from "
                  "content-addressed blocks")
    report.record("serve_fleet_prefix_prefills", fleet["prefix_prefills"],
                  "3rd engine on the fleet pool: prefills (0 = every "
                  "prompt restored)")
    report.record("serve_fleet_migration_token_loss",
                  fleet["migration_token_loss"],
                  f"emitted-token delta vs uninterrupted run across "
                  f"{fleet['migrations']} live migration(s)")
    report.record("serve_fleet_migration_outputs_match",
                  fleet["migration_outputs_match"],
                  "bit-identical token streams across the handoff")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    run(args.device).write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
