"""The port's static-batch baseline (``ServeEngine.run_static``) and the
batched decode it runs, against the JAX package's, mirroring
``tests/test_serve.py::test_continuous_matches_static_bitwise``.

* with the reference's weights carried over (fp32 smoke configs), the
  port's ``run_static`` emits the reference's ``run_static`` tokens with
  the same tick and prefill counts, on olmo-1b, on olmoe-1b-7b, whose
  batched decode pools the batch's tokens under one MoE capacity, and on
  rwkv6-7b (a batched recurrent state);
* the batched ``decode_step(per_sequence=False)`` gives the reference's
  batched decode logits (1e-4), while the slot decode's per-sequence
  routing (``per_sequence=True``) stays the default;
* static and continuous batching emit the same tokens on olmo-1b (on
  olmoe-1b-7b the streams the reference's two modes agree on), continuous
  in fewer decode ticks, and static needs one prompt length per batch;
* ``launch.serve --mode static`` runs on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.registry import build as ref_build
from repro.serve.engine import build_serve_engine as ref_build_engine
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.engine import build_serve_engine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.trace import synthetic_trace, trace_t_max

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TRACE_KW = dict(prompt_lens=(12,), new_tokens=(3, 6, 9, 4))
N_REQ = 10
ARCHS = ["olmo-1b", "olmoe-1b-7b", "rwkv6-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_smoke_config(arch).with_(**FP32)
    trace = synthetic_trace(N_REQ, vocab_size=cfg.vocab_size, **TRACE_KW)
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config(arch).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return dict(arch=arch, cfg=cfg, trace=trace, t_max=t_max, rb=rb,
                rp=rp, b=b, p=p)


def _port(s):
    return build_serve_engine(s["arch"], smoke=True, n_slots=4,
                              t_max=s["t_max"], bundle=s["b"],
                              params=s["p"], device="cpu")[0]


def test_run_static_emits_the_reference_tokens(setup):
    theirs = ref_build_engine(setup["arch"], smoke=True, n_slots=4,
                              t_max=setup["t_max"], bundle=setup["rb"],
                              params=setup["rp"])[0].run_static(
                                  setup["trace"])
    ours = _port(setup).run_static(setup["trace"])
    assert ours.mode == theirs.mode == "static"
    assert ours.outputs == theirs.outputs
    assert (ours.decode_ticks, ours.prefills, ours.emitted_tokens) == \
        (theirs.decode_ticks, theirs.prefills, theirs.emitted_tokens)
    # batches of budgets (3, 6, 9, 4), (3, 6, 9, 4), (3, 6): each decodes
    # until its longest sequence ends
    assert (ours.prefills, ours.decode_ticks) == (3, 8 + 8 + 5)


def test_batched_decode_pools_the_reference_way(setup):
    """Four sequences' prefill, then two batched decode steps, logits held
    against the reference's batched ``decode_step``."""
    cfg, t_max = setup["cfg"], setup["t_max"]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    r_logits, r_st = setup["rb"].prefill(
        setup["rp"], {"tokens": jnp.asarray(toks)},
        setup["rb"].init_caches(jax.random.PRNGKey(0), 4, t_max))
    logits, st = setup["b"].prefill(
        setup["p"], {"tokens": torch.from_numpy(toks).long()},
        setup["b"].init_caches(4, t_max))
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(r_logits, -1))[:, None].astype(np.int32)
        r_logits, r_st = setup["rb"].decode(setup["rp"], jnp.asarray(nxt),
                                            r_st)
        logits, st = setup["b"].decode(setup["p"],
                                       torch.from_numpy(nxt).long(), st,
                                       per_sequence=False)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=1e-4, atol=1e-4)


def test_static_matches_continuous_where_the_reference_does(setup):
    """Dense: every stream equal, as ``bench_serve.py`` asserts.  MoE: the
    batched prefill and decode pool the batch under one capacity while the
    continuous path routes one sequence at a time, so a stream may
    differ — in the reference too; the port's equal streams are the
    reference's."""
    res_s = _port(setup).run_static(setup["trace"])
    res_c = _port(setup).run(setup["trace"])
    assert res_c.decode_ticks < res_s.decode_ticks
    assert res_c.emitted_tokens == res_s.emitted_tokens
    ours = {r for r in res_c.outputs if res_c.outputs[r] == res_s.outputs[r]}
    if setup["arch"] == "olmo-1b":
        assert res_c.outputs == res_s.outputs
    ref = [ref_build_engine(setup["arch"], smoke=True, n_slots=4,
                            t_max=setup["t_max"], bundle=setup["rb"],
                            params=setup["rp"])[0] for _ in range(2)]
    r_s = ref[0].run_static(setup["trace"])
    r_c = ref[1].run(setup["trace"])
    assert ours == {r for r in r_c.outputs if r_c.outputs[r] == r_s.outputs[r]}


def test_static_batches_need_one_prompt_length(setup):
    reqs = [Request("a", (1, 2, 3), 2), Request("b", (1, 2), 2)]
    with pytest.raises(ValueError, match="one length"):
        _port(setup).run_static(reqs)


def test_launcher_runs_the_static_baseline_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--mode", "static", "--requests", "6", "--prompt-len",
         "8", "--new-tokens", "2,5"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # two batches of 4 and 2, each decoding until its 5-token budget ends
    assert "static on cpu: 6 requests" in out.stdout
    assert "8 decode ticks, 2 prefills" in out.stdout
