"""Paper §6 — the FliT transformation: correctness against cost; the twin
of ``benchmarks/bench_flit.py``.

    python -m repro_torch.bench.flit [--out DIR]

Per (workload × policy):
* durability violations over a seed sweep with injected crashes
  (raw / original-FliT violate; Alg. 2 / MStore-all never do);
* modelled operation cost (the paper's Fig. 5 CXL latencies, not times of
  any GPU) — Alg. 2's LStore+one-RFlush beats MStore-everything;
* simulator throughput (ops/s, in each violation row's note) as a health
  line of the host it ran on: printed, not held to a baseline.
"""
from __future__ import annotations

import time

from repro_torch.bench.report import Report, arg_parser
from repro_torch.core.flit import POLICIES
from repro_torch.core.harness import WORKLOADS, run_once
from repro_torch.core.latency import DEVICE, trace_cost

N_SEEDS = 150


def violation_rates():
    out = []
    for wl_name, mk in WORKLOADS.items():
        for policy in POLICIES:
            t0 = time.perf_counter()
            viol = ops = 0
            for seed in range(N_SEEDS):
                r = run_once(mk, policy, seed, p_crash=0.08, max_crashes=2)
                viol += (not r.durable)
                ops += sum(1 for e in r.history if e.kind == "res")
            dt = time.perf_counter() - t0
            out.append((f"flit_violations_{wl_name}_{policy}",
                        viol, f"{N_SEEDS} seeds; {ops/dt:.0f} ops/s checked"))
    return out


def op_cost_model():
    """Modelled ns per high-level op (device issuing, remote object)."""
    out = []
    # counter inc: raw = 1 RMW; flit = cnt-RMW + RMW + RFlush + cnt-RMW;
    # mstore_all = 1 M-RMW
    raw = [(DEVICE, "faa", "remote")]
    flit = [(DEVICE, "faa", "remote")] * 3 + [(DEVICE, "rflush", "remote")]
    mstore = [(DEVICE, "faa", "remote")]
    out.append(("flit_cost_inc_raw_ns", trace_cost(raw), "no durability"))
    out.append(("flit_cost_inc_flit_cxl0_ns",
                trace_cost(flit), "durable (Alg. 2)"))
    out.append(("flit_cost_inc_mstore_ns",
                trace_cost(mstore, flavors=["m"]),
                "durable (MStore; no counters)"))
    # 4-store op (e.g. stack push: 2 private field stores + CAS publish)
    flit4 = ([(DEVICE, "lstore", "remote")] * 3
             + [(DEVICE, "rflush", "remote")] * 3
             + [(DEVICE, "cas", "remote"), (DEVICE, "rflush", "remote")])
    mstore4 = [(DEVICE, "mstore", "remote")] * 3 + [(DEVICE, "cas", "remote")]
    out.append(("flit_cost_push_flit_cxl0_ns", trace_cost(flit4),
                "Alg. 2: LStore+RFlush per field"))
    out.append(("flit_cost_push_mstore_ns",
                trace_cost(mstore4, flavors=["l", "l", "l", "m"]),
                "MStore fields + M-CAS"))
    return out


def run() -> Report:
    report = Report("flit")
    report.set_config(n_seeds=N_SEEDS)
    for name, val, derived in violation_rates() + op_cost_model():
        report.record(name, val, derived)
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    run().write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
