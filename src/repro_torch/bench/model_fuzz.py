"""Vectorized-semantics benchmark: batched CXL0 schedule fuzzing; the twin
of ``benchmarks/bench_model_fuzz.py``.

    python -m repro_torch.bench.model_fuzz [--out DIR] [--device cuda|cpu]

The tensor twin of the LTS (``repro_torch.core.semantics_torch``) runs
B = 2048 random schedules of T = 64 steps at once on ``--device``
(default the card), drawn from a ``torch.Generator`` seeded 0 there.  It
reports schedules/s and steps/s (the mean of 10 runs after one warm-up,
printed and not held to a baseline) and the invariant violations over the
first 256 end states (the reference's definition), which must be 0.
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench.report import Report, arg_parser
from repro_torch.core.semantics_torch import (
    TorchSystem, invariant_violations, random_schedules, run_schedules,
)
from repro_torch.utils.device import resolve_device

SYS = TorchSystem(owner=(0, 0, 1, 1), volatile=(False, True), n_machines=2)
B, T = 2048, 64
N_REP = 10
N_CHECKED = 256


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device="cuda") -> Report:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    acts = random_schedules(SYS, gen, batch=B, length=T, p_crash=0.03)
    C, M, obs = run_schedules(SYS, acts)          # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(N_REP):
        C, M, obs = run_schedules(SYS, acts)
    _sync(dev)
    dt = (time.perf_counter() - t0) / N_REP
    report = Report("model_fuzz")
    report.set_config(batch=B, length=T, device=str(dev))
    report.record("fuzz_schedules_per_s", B / dt, f"batch={B} length={T}",
                  fmt=".0f")
    report.record("fuzz_steps_per_s", B * T / dt, "batched LTS steps",
                  fmt=".0f")
    report.record("fuzz_invariant_violations",
                  int(invariant_violations(C[:N_CHECKED])),
                  f"over {N_CHECKED} sampled end states")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    run(args.device).write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
