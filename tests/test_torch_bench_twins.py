"""The port's twins of the model benchmarks and examples.

* ``python -m repro_torch.bench.{flit,table1,latency,model_fuzz,
  placement,autoscale}`` write ``BENCH_<name>.json`` in the reference harness's
  schema, and the committed baselines (``benchmarks/baselines/*.json``)
  hold them by each metric's ``direction`` / ``rel_tol`` / ``abs_tol`` —
  through the repo's own gate (``scripts/bench_gate.py``) and through the
  port's ``check_against``; ``model_fuzz`` and ``placement`` run here
  with ``--device cpu``; ``autoscale`` (host code) meets every metric of
  ``autoscale.json``: the 363 trace requests and each preset's counts
  exactly, its cost ratios within rel_tol 0.02;
* ``python -m repro_torch.bench.serve --device cpu`` meets all nine
  metrics of ``benchmarks/baselines/serve.json`` exactly, the fleet's
  three (``serve_fleet_speedup_ge_1.6``, the migration's token loss and
  outputs) included;
* ``python -m repro_torch.bench.checkpoint --device cpu`` meets
  ``benchmarks/baselines/checkpoint.json`` on the four metrics it
  produces (``ckpt_bytes_per_commit`` 3,768,348, ``ckpt_recoveries`` 1,
  from ``['peer-staging']``, ``ckpt_write_object_speedup_x`` >= 5 over
  the legacy writer and ``ckpt_write_object_speedup_ok``), through
  ``scripts/bench_gate.py`` on a baseline cut to those four; the mesh
  rows are ROADMAP A7 and reported missing;
* ``python -m repro_torch.bench.fuzz`` (host code: the crash fuzzer at 3
  episodes x train / serve / cluster x 3 topologies, seed 0) meets all six
  of ``fuzz.json``'s exact counts, 27 / 0 / 19 / 55 / 40 / 6, and with
  ``REPRO_FUZZ_BREAK_RECOVERY=1`` its violation count is above 0;
* ``python -m repro_torch.bench.cluster --device cpu`` meets all five
  metrics of ``cluster.json``: ``cluster_commits_total`` 200 with zero
  lost commits, ``cluster_staged_bytes`` 8,388,608, the streamed spill
  format's stage and view speedups over the legacy one (each >= 10) and
  ``cluster_stream_speedup_ok``; its step-rate rows ran 2, 3 and 4 rank
  processes;
* ``python -m repro_torch.examples.{quickstart,durable_kv}`` print what
  the reference examples print, line for line.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))              # scripts/ as a package

from scripts.bench_gate import gate_bench  # noqa: E402

from repro_torch.bench import (autoscale, checkpoint, flit,  # noqa: E402
                               latency, model_fuzz, placement, serve,
                               table1)
from repro_torch.bench import cluster as cluster_bench  # noqa: E402
from repro_torch.bench import fuzz as fuzz_bench  # noqa: E402
from repro_torch.bench.report import check_against  # noqa: E402

BENCHES = {"flit": (flit, []), "table1": (table1, []),
           "latency": (latency, []),
           "model_fuzz": (model_fuzz, ["--device", "cpu"]),
           "placement": (placement, ["--device", "cpu"]),
           "autoscale": (autoscale, []), "fuzz": (fuzz_bench, [])}
N_METRICS = {"flit": 21, "table1": 19, "latency": 22, "model_fuzz": 1,
             "placement": 11, "autoscale": 25, "fuzz": 6}


@pytest.mark.parametrize("name", list(BENCHES))
def test_twin_meets_the_committed_baseline(tmp_path, capsys, name):
    mod, extra = BENCHES[name]
    assert mod.main(["--out", str(tmp_path)] + extra) == 0
    rows = [l for l in capsys.readouterr().out.splitlines()
            if not l.startswith("bench_json,")]
    baseline_path = ROOT / "benchmarks" / "baselines" / f"{name}.json"
    baseline = json.loads(baseline_path.read_text())
    assert len(baseline["metrics"]) == N_METRICS[name]
    bench, failures = gate_bench(str(baseline_path), str(tmp_path))
    assert (bench, failures) == (name, [])
    doc = json.loads((tmp_path / f"BENCH_{name}.json").read_text())
    assert sorted(doc) == ["bench", "config", "metrics"]
    assert doc["bench"] == name
    values = {k: m["value"] for k, m in doc["metrics"].items()}
    assert check_against(values, baseline) == []
    # one printed row per metric, in the reference's metric,value,note form
    assert [r.split(",", 1)[0] for r in rows] == list(doc["metrics"])


def test_serve_twin_meets_the_baseline_on_the_metrics_it_produces(
        tmp_path, capsys):
    assert serve.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    rows = [l for l in capsys.readouterr().out.splitlines()
            if not l.startswith("bench_json,")]
    baseline_path = ROOT / "benchmarks" / "baselines" / "serve.json"
    baseline = json.loads(baseline_path.read_text())
    assert len(baseline["metrics"]) == 9
    doc = json.loads((tmp_path / "BENCH_serve.json").read_text())
    assert doc["bench"] == "serve"
    values = {k: m["value"] for k, m in doc["metrics"].items()}
    # every metric of the baseline is produced now, and each holds
    assert set(baseline["metrics"]) <= set(values)
    assert check_against(values, baseline) == []
    assert gate_bench(str(baseline_path), str(tmp_path)) == ("serve", [])
    assert values["serve_fleet_speedup"] >= 1.6
    assert (values["serve_fleet_migration_token_loss"],
            values["serve_fleet_migration_outputs_match"]) == (0, True)
    assert [r.split(",", 1)[0] for r in rows] == list(doc["metrics"])


def test_checkpoint_twin_meets_the_baseline_on_the_metrics_it_produces(
        tmp_path, capsys):
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert checkpoint.main(["--out", str(tmp_path), "--device",
                                "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    lines = capsys.readouterr().out.splitlines()
    rows = [l for l in lines if not l.startswith(("bench_json,", "#"))]
    baseline_path = ROOT / "benchmarks" / "baselines" / "checkpoint.json"
    baseline = json.loads(baseline_path.read_text())
    doc = json.loads((tmp_path / "BENCH_checkpoint.json").read_text())
    assert doc["bench"] == "checkpoint"
    values = {k: m["value"] for k, m in doc["metrics"].items()}
    produced = ["ckpt_bytes_per_commit", "ckpt_recoveries",
                "ckpt_write_object_speedup_x", "ckpt_write_object_speedup_ok"]
    assert (values["ckpt_bytes_per_commit"], values["ckpt_recoveries"]) \
        == (3768348, 1)
    assert doc["metrics"]["ckpt_recoveries"]["note"] == "source=peer-staging"
    assert values["ckpt_write_object_speedup_x"] >= 5.0
    assert values["ckpt_write_object_speedup_ok"] is True
    cut = {"bench": "checkpoint",
           "metrics": {k: baseline["metrics"][k] for k in produced}}
    cut_path = tmp_path / "checkpoint_cut.json"
    cut_path.write_text(json.dumps(cut))
    assert gate_bench(str(cut_path), str(tmp_path)) == ("checkpoint", [])
    # what is not produced yet is reported missing, and nothing else fails
    _, failures = gate_bench(str(baseline_path), str(tmp_path))
    assert sorted(f.split(":")[0] for f in failures) == sorted(
        k for k in baseline["metrics"] if k not in produced)
    assert all("missing" in f for f in failures)
    assert [r.split(",", 1)[0] for r in rows] == list(doc["metrics"])
    assert sum(l.startswith("# ckpt_") for l in lines) == 1


def test_fuzz_twin_goes_red_when_recovery_is_broken(tmp_path, capsys,
                                                   monkeypatch):
    from repro_torch.scenarios.fuzz import BREAK_ENV
    monkeypatch.setenv(BREAK_ENV, "1")
    assert fuzz_bench.main(["--out", str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "BENCH_fuzz.json").read_text())
    assert doc["metrics"]["fuzz_invariant_violations"]["value"] > 0
    baseline_path = ROOT / "benchmarks" / "baselines" / "fuzz.json"
    _, failures = gate_bench(str(baseline_path), str(tmp_path))
    assert any(f.startswith("fuzz_invariant_violations") for f in failures)


def test_cluster_twin_meets_the_baseline_on_the_metrics_it_produces(
        tmp_path, capsys):
    assert cluster_bench.main(["--out", str(tmp_path), "--device",
                               "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [l for l in lines if not l.startswith(("bench_json,", "#"))]
    baseline_path = ROOT / "benchmarks" / "baselines" / "cluster.json"
    baseline = json.loads(baseline_path.read_text())
    assert len(baseline["metrics"]) == 5
    doc = json.loads((tmp_path / "BENCH_cluster.json").read_text())
    assert doc["bench"] == "cluster"
    values = {k: m["value"] for k, m in doc["metrics"].items()}
    # every metric of the baseline is produced now, and each holds
    assert set(baseline["metrics"]) <= set(values)
    assert [values[k] for k in ("cluster_commits_total",
                                "cluster_staged_bytes")] == [200, 8388608]
    assert values["cluster_stage_speedup_x"] >= 10.0
    assert values["cluster_view_speedup_x"] >= 10.0
    assert values["cluster_stream_speedup_ok"] is True
    assert check_against(values, baseline) == []
    assert gate_bench(str(baseline_path), str(tmp_path)) == ("cluster", [])
    assert all(values[f"cluster_steps_per_s_world{w}"] > 0
               for w in (2, 3, 4))
    assert [r.split(",", 1)[0] for r in rows] == list(doc["metrics"])
    assert not any(l.startswith("# cluster_") for l in lines)


def test_check_against_catches_a_regression():
    baseline = {"metrics": {
        "a": {"value": 4, "direction": "exact"},
        "b": {"value": 2.0, "direction": "exact", "rel_tol": 1e-6},
        "c": {"value": 10.0, "direction": "higher", "rel_tol": 0.1}}}
    assert check_against({"a": 4, "b": 2.0000001, "c": 9.5}, baseline) == []
    bad = check_against({"a": 5, "b": 2.001, "c": 8.0}, baseline)
    assert [f.split(":")[0] for f in bad] == ["a", "b", "c"]
    assert check_against({}, baseline) == ["a: missing", "b: missing",
                                          "c: missing"]


def test_example_twins_print_what_the_reference_examples_print():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    cmds = {}
    for name in ("quickstart", "durable_kv"):
        cmds[("port", name)] = [sys.executable, "-m",
                                f"repro_torch.examples.{name}"]
        cmds[("reference", name)] = [sys.executable,
                                     str(ROOT / "examples" / f"{name}.py")]
    procs = {k: subprocess.Popen(c, env=env, cwd=str(ROOT), text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    outs = {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (k, err[-2000:])
        outs[k] = out.splitlines()
    for name in ("quickstart", "durable_kv"):
        assert outs[("port", name)] == outs[("reference", name)], name
        assert len(outs[("port", name)]) >= 8
