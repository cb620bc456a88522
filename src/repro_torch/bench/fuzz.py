"""Adversarial crash-fuzzer bench: a pinned slice of the fuzz suite as a
gated regression metric — the twin of ``benchmarks/bench_fuzz.py``.

    python -m repro_torch.bench.fuzz [--out DIR]

``EPISODES`` (3) episodes, seed ``SEED`` (0), of each of the three
original workloads (train, serve, cluster) on each topology preset, one
fresh pool each, through ``scenarios.fuzz.run_fuzz_suite`` on the port's
DSM stack (host code: numpy clean replays, the pool's frames on disk).
Every episode is a pure function of (seed, config, schedule), so the six
gated counts are exact: ``benchmarks/baselines/fuzz.json`` pins the
invariant violations to 0 and the episodes, kills, torn writes,
recoveries and cold starts to their values.  With
``REPRO_FUZZ_BREAK_RECOVERY=1`` in the environment the recovery seam is
broken on purpose and the violation count goes above 0.
"""
from __future__ import annotations

import tempfile
import time

from repro_torch.bench.report import Report, arg_parser

EPISODES = 3
SEED = 0
#: the three workloads the gated counts are pinned to (``scale`` has its
#: own tests)
WORKLOADS = ("train", "serve", "cluster")


def run() -> Report:
    from repro_torch.scenarios.fuzz import TOPOLOGIES, run_fuzz_suite

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bench-fuzz-") as d:
        s = run_fuzz_suite(d, episodes=EPISODES, seed=SEED, shrink=False,
                           workloads=WORKLOADS)
    dt = time.perf_counter() - t0

    report = Report("fuzz")
    report.set_config(episodes_per_cell=EPISODES, seed=SEED,
                      workloads=list(WORKLOADS), topologies=list(TOPOLOGIES))
    report.record("fuzz_episodes", s.episodes,
                  f"{EPISODES} x {len(WORKLOADS)} workloads x "
                  f"{len(TOPOLOGIES)} topologies")
    report.record("fuzz_invariant_violations", s.violations,
                  "recovery != newest completed commit, or not "
                  "bit-identical")
    report.record("fuzz_kills_fired", s.kills_fired,
                  "scheduled worker deaths that actually landed")
    report.record("fuzz_torn_writes", s.torn_writes,
                  "durable writes corrupted after their rename")
    report.record("fuzz_recoveries", s.recoveries,
                  "checked recovery invocations (incl. forced finals)")
    report.record("fuzz_cold_starts", s.cold_starts,
                  "episodes that legitimately had nothing recoverable")
    report.record("fuzz_episodes_per_s", s.episodes / dt,
                  "suite wall-clock throughput on the host (not gated)",
                  fmt=".1f")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    report = run()
    report.write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
