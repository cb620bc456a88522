"""The plain modules of ``repro_torch.core`` are copies of ``repro.core``'s,
and ``repro_torch.data`` of ``repro.data``'s:
each may differ from its reference only in lines that name the package
(imports, and docstring lines that say ``repro.`` / ``repro_torch.``,
``semantics_jax`` / ``semantics_torch``).  Histories, verdicts and counts
then match the reference bit for bit wherever the parity tests do not
reach (the other Prop. 1 items, the slow refinement checks)."""
import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PLAIN = ("state", "semantics", "explore", "refine", "litmus", "props",
         "latency", "objects", "sim", "flit", "durable", "harness",
         "__init__")


def _normalised(text: str) -> list:
    return (text.replace("repro_torch.", "repro.")
            .replace("semantics_torch", "semantics_jax").splitlines())


@pytest.mark.parametrize("module", PLAIN)
def test_copy_differs_only_in_lines_naming_the_package(module):
    ref = (ROOT / "src/repro/core" / f"{module}.py").read_text().splitlines()
    ours = (ROOT / "src/repro_torch/core" / f"{module}.py").read_text()
    diff = [l for l in difflib.unified_diff(ref, _normalised(ours), n=0,
                                            lineterm="")
            if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    stray = [l for l in diff if "repro" not in l and "semantics_" not in l]
    assert not stray, f"{module}.py drifted from the reference: {stray}"


@pytest.mark.parametrize("module", ["pipeline", "__init__"])
def test_data_copy_differs_only_in_lines_naming_the_package(module):
    ref = (ROOT / "src/repro/data" / f"{module}.py").read_text().splitlines()
    ours = (ROOT / "src/repro_torch/data" / f"{module}.py").read_text()
    diff = [l for l in difflib.unified_diff(ref, _normalised(ours), n=0,
                                            lineterm="")
            if l[:1] in "+-" and not l.startswith(("+++", "---"))]
    stray = [l for l in diff if "repro" not in l]
    assert not stray, f"data/{module}.py drifted from the reference: {stray}"
