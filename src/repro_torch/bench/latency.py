"""Paper Fig. 5 — latency of CXL0 primitives on host and device; the twin
of ``benchmarks/bench_latency.py``.

    python -m repro_torch.bench.latency [--out DIR]

Every ns here is the paper's CXL measurement (an x86 host and an FPGA
device over CXL 1.1) as ``repro_torch.core.latency`` stores it — the
model's data, not a time of the GPU this runs beside.
"""
from __future__ import annotations

from repro_torch.bench.report import Report, arg_parser
from repro_torch.core.latency import (DEVICE, HOST, LATENCY_NS,
                                      primitive_latency)


def rows():
    out = []
    for node in (HOST, DEVICE):
        for prim in ("load", "lstore", "rstore", "mstore", "rflush"):
            for loc in ("local", "remote"):
                try:
                    ns = primitive_latency(node, prim, loc)
                except KeyError:
                    continue
                out.append((f"fig5_{node}_{prim}_{loc}", ns,
                            f"{node} {prim} -> {loc}"))
    # headline ratios from the paper text
    out.append(("fig5_ratio_host_remote_over_local",
                LATENCY_NS[(HOST, "load", "remote")]
                / LATENCY_NS[(HOST, "load", "local")], "paper: 2.34x"))
    out.append(("fig5_ratio_device_remote_over_local",
                LATENCY_NS[(DEVICE, "load", "remote")]
                / LATENCY_NS[(DEVICE, "load", "local")], "paper: 1.94x"))
    out.append(("fig5_ratio_dev_rstore_over_lstore",
                LATENCY_NS[(DEVICE, "rstore", "remote")]
                / LATENCY_NS[(DEVICE, "lstore", "remote")], "paper: 2.08x"))
    out.append(("fig5_ratio_dev_mstore_over_rstore",
                LATENCY_NS[(DEVICE, "mstore", "remote")]
                / LATENCY_NS[(DEVICE, "rstore", "remote")], "paper: 1.45x"))
    return out


def run() -> Report:
    report = Report("latency")
    for name, val, derived in rows():
        report.record(name, val, derived, fmt=".2f")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    run().write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
