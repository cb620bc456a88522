"""The benchmarks' one writer, and the check of a result against a
committed baseline.

A ``Report`` prints one ``metric,value,note`` row per ``record`` and
writes ``BENCH_<name>.json``::

    {"bench": "<name>",
     "metrics": {"<key>": {"value": <number|bool|str>, "note": "..."}},
     "config": {...}}

the schema of the reference harness (``benchmarks/harness.py``), so a
baseline of ``benchmarks/baselines/`` holds a twin's result as it holds
the reference's.  ``check_against`` reads a baseline's ``direction``
(``exact`` / ``higher`` / ``lower``) and its ``rel_tol`` / ``abs_tol``
as ``scripts/bench_gate.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional


class Report:
    def __init__(self, name: str):
        self.name = name
        self.metrics: Dict[str, Dict[str, Any]] = {}
        self.config: Dict[str, Any] = {}

    def record(self, metric: str, value: Any, note: str = "", *,
               fmt: Optional[str] = None) -> Any:
        """Print the row (``fmt`` shapes only the printed value) and keep
        the raw value under ``metric``, which must be new."""
        if metric in self.metrics:
            raise KeyError(f"{self.name}: metric {metric!r} recorded twice")
        display = format(value, fmt) if fmt else value
        print(f"{metric},{display},{note}", flush=True)
        self.metrics[metric] = {"value": value, "note": note}
        return value

    def set_config(self, **kw):
        self.config.update(kw)

    def values(self) -> Dict[str, Any]:
        return {k: m["value"] for k, m in self.metrics.items()}

    def write(self, out_dir: Optional[str] = None) -> str:
        out_dir = out_dir or os.environ.get("BENCH_DIR", ".")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"BENCH_{self.name}.json")
        with open(path, "w") as f:
            json.dump({"bench": self.name, "metrics": self.metrics,
                       "config": self.config}, f, indent=2)
        print(f"bench_json,{path},written", flush=True)
        return path


def check_metric(spec: dict, actual: Any) -> Optional[str]:
    """None if ``actual`` meets the baseline entry ``spec``, else why not."""
    want = spec["value"]
    if isinstance(want, bool) or not isinstance(want, (int, float)):
        return None if actual == want else f"expected {want!r}, got {actual!r}"
    tol = max(float(spec.get("abs_tol", 0.0)),
              float(spec.get("rel_tol", 0.0)) * abs(float(want)))
    a = float(actual)
    direction = spec.get("direction", "exact")
    if direction == "exact":
        bad = abs(a - want) > tol
    elif direction == "higher":
        bad = a < want - tol
    elif direction == "lower":
        bad = a > want + tol
    else:
        return f"unknown direction {direction!r}"
    return f"{a!r} against {want!r} ({direction}, tol {tol:g})" if bad \
        else None


def check_against(values: Dict[str, Any], baseline: dict) -> List[str]:
    """Every metric of ``baseline`` (a parsed baseline document) held
    against ``values``; returns the failures, ``[]`` when all pass."""
    out = []
    for key, spec in baseline["metrics"].items():
        if key not in values:
            out.append(f"{key}: missing")
            continue
        why = check_metric(spec, values[key])
        if why is not None:
            out.append(f"{key}: {why}")
    return out


def arg_parser(doc: str, device: bool = False) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for BENCH_<name>.json (default: "
                         "$BENCH_DIR, else the working directory)")
    if device:
        ap.add_argument("--device", default="cuda",
                        help="where the schedules run (default cuda)")
    return ap
