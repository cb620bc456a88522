"""Gradient compression, the port (``repro_torch.parallel.compression``)
against the reference (``repro.parallel.compression``), on the CPU.

* ``int8_roundtrip`` and ``topk_roundtrip`` equal the reference's bit for
  bit on the same numpy gradients (fp32 and bf16 inputs, several scales,
  top-k fractions whose k ties a magnitude);
* the int8 and top-k transforms with error feedback equal the
  reference's over 5 steps of a two-leaf gradient tree, the sent
  gradients and the residuals both; sent plus the last residual sums to
  the true gradients; without feedback (``err=None``) a step compresses
  its gradient alone, as the reference's;
* ``launch.train --compress int8`` trains through the step's
  ``grad_transform`` hook: its gradients are the int8 round trip of the
  plain step's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as ref
from repro_torch.parallel import compression
from repro_torch.utils.tree import tree_leaves


def _grad(seed, shape=(64, 48), scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bits(a) -> bytes:
    return np.asarray(a, np.float32).tobytes()


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 250.0),
                                        (3, 3.0)])
def test_int8_roundtrip_equals_the_reference(seed, scale):
    g = _grad(seed, scale=scale)
    got = compression.int8_roundtrip(torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert _bits(got) == _bits(ref.int8_roundtrip(jnp.asarray(g)))
    # max error <= scale / 2 = max|g| / 254
    assert float((got - torch.from_numpy(g)).abs().max()) <= \
        float(np.abs(g).max()) / 254 + 1e-6 * scale


def test_int8_roundtrip_of_bf16_equals_the_reference():
    g = _grad(4)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    want = ref.int8_roundtrip(jnp.asarray(gb.float().numpy()).astype(
        jnp.bfloat16))
    assert _bits(compression.int8_roundtrip(gb)) == _bits(want)


@pytest.mark.parametrize("frac", [0.34, 0.1, 0.5, 1e-4])
def test_topk_roundtrip_equals_the_reference(frac):
    g = _grad(5, (40, 30))
    g[0, :4] = 7.0                           # a tie at the top
    got = compression.topk_roundtrip(torch.from_numpy(g), frac)
    assert _bits(got) == _bits(ref.topk_roundtrip(jnp.asarray(g), frac))
    assert int((got != 0).sum()) >= max(1, int(g.size * frac))


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 1.0])
    kept = compression.topk_roundtrip(g, frac=0.34)      # k = 2
    assert kept.tolist() == [0.0, -5.0, 0.0, 3.0, 0.0, 0.0]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_equals_the_reference_over_five_steps(scheme):
    if scheme == "int8":
        ours, init = compression.make_int8_transform()
        theirs, ref_init = ref.make_int8_transform()
    else:
        ours, init = compression.make_topk_transform(0.1)
        theirs, ref_init = ref.make_topk_transform(0.1)
    shapes = {"w": (32, 16), "b": (16,)}
    err = init({k: torch.zeros(s) for k, s in shapes.items()})
    ref_err = ref_init({k: jnp.zeros(s) for k, s in shapes.items()})
    sent_sum = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    truth = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for step in range(5):
        g = {k: _grad(10 * step + i, s) for i, (k, s) in
             enumerate(sorted(shapes.items()))}
        sent, err = ours({k: torch.from_numpy(v) for k, v in g.items()}, err)
        ref_sent, ref_err = theirs({k: jnp.asarray(v) for k, v in g.items()},
                                   ref_err)
        for k in shapes:
            assert _bits(sent[k]) == _bits(ref_sent[k]), (step, k)
            assert _bits(err[k]) == _bits(ref_err[k]), (step, k)
            sent_sum[k] += sent[k].numpy()
            truth[k] += g[k]
    for k in shapes:
        np.testing.assert_allclose(sent_sum[k] + err[k].numpy(), truth[k],
                                   rtol=1e-4, atol=1e-4)
    # without feedback: one step's gradient alone, err passed through
    g = {k: _grad(99, s) for k, s in shapes.items()}
    sent, none = ours({k: torch.from_numpy(v) for k, v in g.items()}, None)
    ref_sent, _ = theirs({k: jnp.asarray(v) for k, v in g.items()}, None)
    assert none is None
    assert all(_bits(sent[k]) == _bits(ref_sent[k]) for k in shapes)


def test_int8_without_feedback_keeps_err():
    ours, init = compression.make_int8_transform(with_error_feedback=False)
    err = init({"w": torch.zeros(8)})
    sent, back = ours({"w": torch.from_numpy(_grad(7, (8,)))}, err)
    assert back is err
    assert _bits(sent["w"]) == _bits(ref.int8_roundtrip(
        jnp.asarray(_grad(7, (8,)))))


def test_launcher_compress_int8_goes_through_the_step_hook(tmp_path,
                                                           monkeypatch):
    from repro_torch.launch import train as launcher
    from repro_torch.train import step as step_mod
    seen = []
    make = step_mod.make_train_step

    def spy(bundle, **kw):
        hook = kw.get("grad_transform")
        if hook is not None:
            def wrapped(grads, ctx):
                out = hook(grads, ctx)
                seen.append((grads, out))
                return out
            kw["grad_transform"] = wrapped
        return make(bundle, **kw)
    monkeypatch.setattr(step_mod, "make_train_step", spy)
    r = launcher.main(["--device", "cpu", "--smoke", "--steps", "2",
                       "--global-batch", "2", "--seq", "16", "--pool",
                       str(tmp_path), "--commit-every", "2", "--compress",
                       "int8"])
    assert len(r.losses) == 2 and len(seen) == 2
    grads, out = seen[0]
    leaves = tree_leaves(grads)
    assert len(leaves) == len(tree_leaves(out)) > 0
    for a, b in zip(leaves, tree_leaves(out)):
        assert torch.equal(b, compression.int8_roundtrip(a).to(a.dtype))
