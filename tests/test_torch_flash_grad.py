"""The plain versions of the flash kernels' training pair, against the
reference, on the CPU.

The JAX package differentiates its plain attention; the port's card path
runs a forward kernel that also writes the logsumexp and a backward kernel
(``csrc/flash_attention_bwd.cu``), each held on the card against the plain
versions here (``kernels/attention/ref.py``):

* ``attention_bwd_ref`` (the explicit formulas from the saved logsumexp,
  GQA summed over the G q heads of a kv head) equals ``jax.grad`` of the
  reference's ``attention_ref`` on causal, GQA, ragged and non-causal
  cases, in fp32 within 1e-5 x max|ref|; ``attention_ref_lse``'s lse
  equals ``jax.nn.logsumexp`` of the reference's scaled, masked scores
  within 1e-5 and its output the reference's;
* in the model layout, ``plain_attention_bwd`` equals torch autograd
  through ``plain_attention`` (what the dispatcher runs for CPU tensors),
  and the dispatcher's CPU branch stays differentiable;
* the backward kernel's dispatcher takes (hd, hd_v) = (32, 32), (64, 64),
  (128, 128) and MLA's (192, 128), and refuses, before any launch, every
  other pair (hd 256, hd_v 64 under hd 128, hd 16).

The cases include MLA's widths (hd_v != hd): the smoke config's (q / k
24, v 16) and the published ones (192, 128), and head dim 32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_ref_lse)

CASES = {  # B, H, K, Sq, Sk, hd, hd_v, causal
    "causal": (2, 4, 4, 32, 32, 16, 16, True),
    "gqa": (1, 8, 2, 24, 24, 16, 16, True),
    "ragged": (1, 4, 2, 77, 77, 8, 8, True),
    "noncausal": (2, 4, 4, 13, 29, 16, 16, False),
    "causal_sq_lt_sk": (1, 2, 1, 20, 33, 8, 8, True),
    # MLA: deepseek-v2's smoke widths (nope 16 + rope 8, v 16) and its
    # published ones (nope 128 + rope 64, v 128)
    "mla_smoke": (1, 4, 4, 40, 40, 24, 16, True),
    "mla": (1, 2, 2, 33, 33, 192, 128, True),
    # head dim 32: the (64, 64) tiles over 32 columns on the card
    "hd32": (2, 8, 4, 70, 70, 32, 32, True),
}
TOL = 1e-5


def _inputs(case, seed=0):
    B, H, K, Sq, Sk, hd, hd_v, _ = case
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in
            ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd_v),
             (B, H, Sq, hd_v))]


def _close(ours, theirs, tol=TOL):
    theirs = np.asarray(theirs, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == theirs.shape
    assert float(np.abs(ours - theirs).max()) <= \
        tol * max(float(np.abs(theirs).max()), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_equals_jax_grad_of_the_reference(name):
    causal = CASES[name][-1]
    q, k, v, do = _inputs(CASES[name])
    out, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v,
                                                         causal=causal),
                       q, k, v)
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = attention_ref_lse(*t[:3], causal=causal)
    _close(o, out)
    got = attention_bwd_ref(t[0], t[1], t[2], o, lse, t[3], causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_lse_equals_jax_logsumexp_of_the_reference_scores(name):
    B, H, K, Sq, Sk, hd, _, causal = CASES[name]
    q, k, v, _ = _inputs(CASES[name], seed=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) * hd ** -0.5,
                   jnp.repeat(jnp.asarray(k), H // K, axis=1))
    if causal:
        mask = jnp.arange(Sq)[:, None] >= jnp.arange(Sk)[None, :]
        s = jnp.where(mask[None, None], s, -jnp.inf)
    want = jax.nn.logsumexp(s, axis=-1)
    _, lse = attention_ref_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Sq)
    assert float(np.abs(lse.numpy() - np.asarray(want)).max()) <= TOL * max(
        float(np.abs(np.asarray(want)).max()), 1.0)


def _model_layout(case, seed=2):
    B, H, K, Sq, Sk, hd, hd_v, _ = case
    g = np.random.default_rng(seed)
    shapes = ((B, Sq, K, H // K, hd), (B, Sk, K, hd), (B, Sk, K, hd_v),
              (B, Sq, K, H // K, hd_v))
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_equals_autograd_in_the_model_layout(name):
    causal = CASES[name][-1]
    q, k, v, do = _model_layout(CASES[name])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    # the dispatcher on CPU tensors: the plain version, differentiable
    out = ops.flash_attention(*leaves, causal=causal)
    out.backward(do)
    o, lse = ops.plain_attention_lse(q, k, v, causal=causal)
    assert torch.equal(o, ops.plain_attention(q, k, v, causal=causal))
    assert tuple(lse.shape) == (q.shape[0], q.shape[2] * q.shape[3],
                                q.shape[1])
    got = ops.plain_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, leaf in zip(got, leaves):
        assert g.shape == leaf.shape
        assert float((g - leaf.grad).abs().max()) <= \
            TOL * float(leaf.grad.abs().max())


@pytest.mark.parametrize("hd,hd_v,ok", [(64, 64, True), (128, 128, True),
                                        (256, 256, False),
                                        (192, 128, True), (128, 64, False),
                                        (32, 32, True), (16, 16, False)])
def test_backward_refuses_what_its_kernel_does_not_take(hd, hd_v, ok):
    q = torch.zeros(1, 4, 2, 1, hd)
    k = torch.zeros(1, 4, 2, hd)
    v = torch.zeros(1, 4, 2, hd_v)
    if ok:
        ops._check_bwd(q, k, v)
    else:
        with pytest.raises(ValueError, match=r"\(hd, hd_v\) in "
                           r"\(\(32, 32\), \(64, 64\), \(128, 128\), "
                           r"\(192, 128\)\)"):
            ops._check_bwd(q, k, v)
