"""Elastic autoscaling: the cost-priced controller against every fixed
fleet size under the deterministic bursty diurnal trace, per CXL topology
preset; the twin of ``benchmarks/bench_autoscale.py``.

    python -m repro_torch.bench.autoscale [--out DIR]

For each preset the SAME trace (one compressed day of seeded Poisson
arrivals, ``scale.traffic``) is served by every fixed fleet size ``1 ..
max_engines`` and by the autoscaled fleet (``scale.autoscaler``: hold /
grow / shrink priced each tick with the emulator's modelled CXL costs,
joins landing after the modelled join delay).  Everything is a pure
function of (seed, config), so the counts are exact-gated
(``benchmarks/baselines/autoscale.json``); costs are modelled ns, not
times of any device.  The simulation's host wall time is printed, not
held to the baseline.
"""
from __future__ import annotations

import time

from repro_torch.bench.report import Report, arg_parser
from repro_torch.scale.autoscaler import (Autoscaler, AutoscaleConfig,
                                          simulate_autoscale, simulate_fixed)
from repro_torch.scale.traffic import (TrafficConfig, offered_tokens,
                                       traffic_trace)

SEED = 3
TOPOLOGIES = ("cxl11-direct", "cxl20-switched-pool", "cxl30-fabric")


def run() -> Report:
    trace = traffic_trace(TrafficConfig(seed=SEED))
    report = Report("autoscale")
    report.set_config(seed=SEED, n_requests=len(trace),
                      offered_tokens=offered_tokens(trace),
                      topologies=list(TOPOLOGIES))
    report.record("autoscale_trace_requests", len(trace),
                  "sessions in the compressed day")

    t0 = time.perf_counter()
    for topo in TOPOLOGIES:
        cfg = AutoscaleConfig(topology=topo)
        auto = simulate_autoscale(trace, cfg, scaler=Autoscaler(cfg))
        fixed = {n: simulate_fixed(trace, n, cfg)
                 for n in range(1, cfg.max_engines + 1)}
        best_n = min(fixed, key=lambda n: fixed[n].priced_cost_ns)
        best = fixed[best_n]
        beats = (auto.priced_cost_ns < best.priced_cost_ns
                 and auto.p99_admission_ticks < best.p99_admission_ticks
                 and auto.lost_sessions == 0)
        report.record(f"autoscale_beats_best_fixed.{topo}", beats,
                      f"cost {auto.priced_cost_ns:.3g} < "
                      f"{best.priced_cost_ns:.3g} (n={best_n}), p99 "
                      f"{auto.p99_admission_ticks:.0f} < "
                      f"{best.p99_admission_ticks:.0f}")
        report.record(f"autoscale_lost_sessions.{topo}",
                      auto.lost_sessions, "must be zero")
        report.record(f"autoscale_cost_over_best_fixed.{topo}",
                      auto.priced_cost_ns / best.priced_cost_ns,
                      "priced cost ratio, lower is better", fmt=".3f")
        report.record(f"autoscale_p99_ticks.{topo}",
                      auto.p99_admission_ticks,
                      f"vs fixed-{best_n}'s {best.p99_admission_ticks:.0f}")
        report.record(f"autoscale_decisions.{topo}", auto.decisions,
                      "scale decisions logged (all priced alternatives)")
        report.record(f"autoscale_grows.{topo}", auto.grows,
                      "applied scale-out events")
        report.record(f"autoscale_shrinks.{topo}", auto.shrinks,
                      "applied scale-in events")
        report.record(f"autoscale_engines_span.{topo}",
                      f"{auto.engines_min}-{auto.engines_max}",
                      "capacity range the controller used")
        report.record(f"autoscale_tokens_per_tick.{topo}",
                      auto.tokens_per_tick, "served throughput", fmt=".2f")
    report.record("autoscale_sim_wall_s", time.perf_counter() - t0,
                  "3 presets x (1 auto + 12 fixed) simulations, host wall "
                  "time (not gated)", fmt=".1f")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    report = run()
    report.write(args.out)
    v = report.values()
    return 0 if all(v[f"autoscale_beats_best_fixed.{t}"]
                    and v[f"autoscale_lost_sessions.{t}"] == 0
                    for t in TOPOLOGIES) else 1


if __name__ == "__main__":
    raise SystemExit(main())
