"""The port's twins of ``examples/train_durable.py`` and
``examples/serve.py`` (``repro_torch.examples``), on the CPU.

* both run headless end to end as ``tests/test_examples_smoke.py`` runs
  the reference's (``train_durable --steps 8``: "identical to clean run:
  True"; ``serve --requests 4 --slots 2``), with ``--device cpu``; the
  serve run is made twice over one pool (``--pool``): the second run
  resumes every finished session and prints the same tokens.  The train
  run starts beside the first serve run;
* the train_durable twin's ``small_cfg`` equals the reference's field for
  field (olmo-1b's head dim of 128 included);
* started from the reference's initial params (carried across by
  ``models.params.from_reference``), the twin's ``train()`` gives the
  reference example's ``train()`` losses within 1e-4 relative, through a
  crash and its recovery, on an fp32 cut of ``small_cfg`` (2 layers,
  batches of 2 x 32 tokens, 6 steps, a commit every 2).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["repro_torch.examples.train_durable", "--steps", "8"]
SERVE = ["repro_torch.examples.serve", "--requests", "4", "--slots", "2"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _popen(args):
    return subprocess.Popen([sys.executable, "-m", *args, "--device", "cpu"],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"rc={proc.returncode}\n{out[-2000:]}\n" \
                                 f"{err[-2000:]}"
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every twin's stdout: the train run beside the serve run, the serve
    run's second pass over its pool after its first."""
    pooled = SERVE + ["--pool", str(tmp_path_factory.mktemp("serve_pool"))]
    train = _popen(TRAIN)
    first = _finish(_popen(pooled))
    second = _finish(_popen(pooled))
    return dict(train=_finish(train), serve=first, serve_resumed=second)


def test_train_durable_twin_runs(outputs):
    out = outputs["train"]
    assert "model: 9.4M params, 4L d256" in out
    assert "crashes at [2, 5]" in out and "crashes: 2" in out
    assert "crash-recovered final params identical to clean run: True" in out


def test_serve_twin_runs(outputs):
    out = outputs["serve"]
    assert "requests" in out and "tokens" in out
    assert "4 requests, " in out and "2 slots" in out


def test_serve_twin_resumes_from_its_pool(outputs):
    first, second = outputs["serve"], outputs["serve_resumed"]
    assert "resumed" not in first
    assert "resumed 4 finished sessions from the pool" in second
    assert "0 decode ticks" in second
    tokens = lambda s: [l for l in s.splitlines()
                        if l.startswith("sampled token ids")]
    assert tokens(first) == tokens(second) and tokens(first)


def _ref_example():
    spec = importlib.util.spec_from_file_location(
        "ref_train_durable", ROOT / "examples" / "train_durable.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_small_cfg_equals_the_reference():
    from repro_torch.examples import train_durable
    ref = _ref_example()
    for full in (False, True):
        got = dataclasses.asdict(train_durable.small_cfg(full))
        want = dataclasses.asdict(ref.small_cfg(full))
        assert {k: got[k] for k in want} == want
    assert train_durable.small_cfg(False).head_dim == 128


def test_train_losses_equal_the_reference_example(tmp_path):
    import jax
    import torch
    from repro.data.pipeline import DataPipeline as RefPipeline
    from repro.data.pipeline import SyntheticLMSource as RefSource
    from repro.models.registry import build as ref_build
    from repro.train.state import init_train_state as ref_init_state
    from repro.train.step import make_train_step as ref_make_step
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.examples import train_durable
    from repro_torch.models.params import from_reference
    from repro_torch.models.registry import build
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves

    ref = _ref_example()
    cut = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
    steps, batch, seq, crashes = 6, 2, 32, (3,)
    ref_cfg = ref.small_cfg(False).with_(**cut)
    ref_bundle = ref_build(ref_cfg)
    key = jax.random.PRNGKey(0)
    ref_params = ref_bundle.init_params(key)
    ref_state = ref_init_state(ref_params, key)
    ref_step = jax.jit(ref_make_step(ref_bundle, peak_lr=3e-4,
                                     total_steps=steps))
    _, ref_losses, ref_rec = ref.train(
        str(tmp_path / "ref"), ref_step, ref_state,
        RefPipeline(RefSource(ref_cfg.vocab_size), batch, seq),
        n_steps=steps, commit_every=2, crash_steps=crashes)

    cfg = train_durable.small_cfg(False).with_(**cut)
    bundle = build(cfg, device="cpu")
    params = from_reference(jax.tree_util.tree_map(np.asarray, ref_params),
                            device="cpu")
    state = init_train_state(params, 0)
    step = make_train_step(bundle, peak_lr=3e-4, total_steps=steps)
    final, losses, rec = train_durable.train(
        str(tmp_path / "port"), step, state,
        DataPipeline(SyntheticLMSource(cfg.vocab_size), batch, seq),
        n_steps=steps, commit_every=2, crash_steps=crashes)
    assert rec == ref_rec == ["pool"]
    assert len(losses) == len(ref_losses) > steps     # the replayed steps
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(final.params))


def test_twins_default_to_the_card():
    """Without ``--device cpu`` both twins run on the card, and raise on a
    host without one."""
    import torch
    from repro_torch.examples import serve, train_durable
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main in (train_durable.main, serve.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--steps", "2"] if main is train_durable.main else [])
