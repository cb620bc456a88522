"""The PyTorch port imports neither JAX nor the JAX package.

``repro_torch`` keeps its own copy of everything it needs, so it runs on
the machine with the card, where there is no JAX; ``chip_smoke.py`` drives
it there.  Checked two ways: what importing every submodule actually
loads (in a fresh interpreter), and what the sources say.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print("N=%d" % len(names))
print("NAMES=" + ",".join(names))
print("BAD=" + ",".join(bad))
"""

#: modules each slice added, which the walk must have imported
SLICE_MODULES = [
    "repro_torch.kernels.attention.kernel", "repro_torch.models.attention",
    "repro_torch.kernels.moe_gmm.kernel", "repro_torch.models.moe",
    "repro_torch.configs.rwkv6_7b", "repro_torch.kernels.rwkv6.kernel",
    "repro_torch.kernels.rwkv6.ops", "repro_torch.kernels.rwkv6.ref",
    "repro_torch.models.rwkv",
    "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.kernels.mamba.kernel", "repro_torch.kernels.mamba.ops",
    "repro_torch.kernels.mamba.ref", "repro_torch.models.mamba",
    "repro_torch.core", "repro_torch.core.state",
    "repro_torch.core.semantics", "repro_torch.core.explore",
    "repro_torch.core.refine", "repro_torch.core.litmus",
    "repro_torch.core.props", "repro_torch.core.latency",
    "repro_torch.core.objects", "repro_torch.core.sim",
    "repro_torch.core.flit", "repro_torch.core.durable",
    "repro_torch.core.harness", "repro_torch.core.semantics_torch",
    "repro_torch.bench", "repro_torch.bench.report",
    "repro_torch.bench.flit", "repro_torch.bench.table1",
    "repro_torch.bench.latency", "repro_torch.bench.model_fuzz",
    "repro_torch.bench.serve",
    "repro_torch.examples", "repro_torch.examples.quickstart",
    "repro_torch.examples.durable_kv",
    "repro_torch.dsm.emu", "repro_torch.dsm.placement",
    "repro_torch.dsm.cluster", "repro_torch.serve.fleet",
    "repro_torch.bench.placement",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.schedule",
    "repro_torch.train.state", "repro_torch.train.step",
    "repro_torch.train.loop", "repro_torch.launch.train",
    "repro_torch.bench.checkpoint",
    "repro_torch.configs.whisper_small", "repro_torch.models.encdec",
    "repro_torch.scale", "repro_torch.scale.traffic",
    "repro_torch.scale.autoscaler", "repro_torch.scale.grow",
    "repro_torch.train.elastic", "repro_torch.bench.autoscale",
    "repro_torch.dsm.faults", "repro_torch.scenarios",
    "repro_torch.scenarios.fuzz", "repro_torch.scenarios.runner",
    "repro_torch.scenarios.worker", "repro_torch.scenarios.serve_worker",
    "repro_torch.bench.fuzz", "repro_torch.bench.cluster",
    "repro_torch.launch.mesh", "repro_torch.launch.cluster",
    "repro_torch.scenarios.cluster", "repro_torch.scenarios.cluster_worker",
    "repro_torch.serve.kvcache", "repro_torch.serve.sessions",
    "repro_torch.scenarios.scale",
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.parallel.compression", "repro_torch.dsm.meshio",
    "repro_torch.examples.train_durable", "repro_torch.examples.serve",
]

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+repro\b(?!_)|from\s+repro\b(?!_)|import\s+ml_dtypes\b"
    r"|from\s+ml_dtypes\b)", re.M)


def test_importing_every_submodule_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split("=", 1) for l in out.stdout.splitlines()
                 if l.startswith(("N=", "NAMES=", "BAD=")))
    assert int(lines["N"]) >= 30              # every module was imported
    assert set(SLICE_MODULES) <= set(lines["NAMES"].split(","))
    assert lines["BAD"] == "", f"port loaded {lines['BAD']}"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_has_no_jax_repro_or_ml_dtypes_import(path):
    src = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
    assert not hits, f"{path}: {hits}"


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the raise path is for hosts "
                    "without one")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    with pytest.raises(RuntimeError, match="CUDA"):
        build(get_smoke_config("olmo-1b"))            # device="cuda" default
    with pytest.raises(RuntimeError, match="CUDA"):
        build_serve_engine("olmo-1b", smoke=True)
