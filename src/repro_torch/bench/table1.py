"""Paper Table 1 — CXL transactions observable per CXL0 primitive; the
twin of ``benchmarks/bench_table1.py``.

    python -m repro_torch.bench.table1 [--out DIR]

Emits the encoded mapping and the availability summary (which primitives
current hardware cannot issue — the paper's '???' rows), plus the
primitive sets of each §4 system configuration.
"""
from __future__ import annotations

from repro_torch.bench.report import Report, arg_parser
from repro_torch.core.latency import (
    CONFIG_PRIMITIVES, TABLE1, available_primitives,
)


def run() -> Report:
    report = Report("table1")
    for r in TABLE1:
        report.record(f"table1_{r.node}_{r.primitive}",
                      1 if r.available else 0,
                      f"op={r.operation} | HM={'/'.join(r.to_hm)} | "
                      f"HDM={'/'.join(r.to_hdm)}")
    for node in ("host", "device"):
        av = available_primitives(node)
        report.record(f"table1_available_{node}", len(av), "/".join(av))
    for config, nodes in CONFIG_PRIMITIVES.items():
        for node, prims in nodes.items():
            report.record(f"config_{config}_{node}", len(prims),
                          "/".join(prims))
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    run().write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
