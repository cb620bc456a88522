"""The selective scan's plain backward and jamba's chunked training path
against the JAX package's gradients, on the CPU.

``kernels.mamba.ref.selective_scan_bwd_ref(dA, dBu, C, h0, dy, dh)`` is
what the card's backward kernel (``csrc/selective_scan_bwd.cu``) is held
to.  The reference has no backward kernel: ``jax.grad`` differentiates its
chunk solver (``repro/models/mamba.py:_chunk_scan``, an associative scan,
and the chunk body's ``einsum`` readout) when it trains jamba.  Here the
same numpy inputs from a seed, with cotangents on y and on the final h, go
through:

* ``jax.vjp`` of ``repro.kernels.mamba.ref.selective_scan_ref`` (the step
  oracle) and of ``_chunk_scan`` plus its readout in 16-step chunks, the
  last one padded with identity steps as the reference pads it;
* ``selective_scan_bwd_ref``;
* torch autograd through the port's dispatcher on the CPU
  (``ops.selective_scan``, its plain branch: no kernel launch counted).

d(dA), d(dBu), dC and dh0 within 1e-5 x max|ref| in fp32 (the same sums
in another order), at ragged S (1, 37, 50, 100), N 4, 8 and 16, h0 given
and absent (zeros to JAX, no dh0), dh given and absent (zeros).

Then the model: under grad ``models.mamba.mamba_forward`` gives each
chunk a new h and runs each chunk's body under ``torch.utils.checkpoint``,
so no tensor of a chunk's (B, Q, I, N) shape stays saved past the forward
(counted with ``torch.autograd.graph.saved_tensors_hooks``); and jamba's
smoke config in fp32 at S 40 (three 16-step chunks, the last ragged) gives
the loss and every param gradient of ``jax.grad`` of the reference's loss
on the same weights within 1e-5 x max|ref| per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.mamba.ref import selective_scan_ref as jax_scan_ref
from repro.models.mamba import _chunk_scan as jax_chunk_scan
from repro.models.registry import build as ref_build
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba import ops
from repro_torch.kernels.mamba.ref import selective_scan_bwd_ref
from repro_torch.models import mamba
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.utils.tree import tree_leaves, tree_structure

CASES = [  # B, S, I, N, h0 given, dh given
    (2, 1, 4, 8, True, True),
    (2, 37, 8, 4, False, False),
    (2, 37, 6, 8, True, True),
    (1, 64, 5, 16, True, False),
    (2, 100, 3, 16, False, True),
    (1, 50, 7, 16, True, True),
]
NAMES = ("ddA", "ddBu", "dC", "dh0")
CHUNK = 16
TOL = 1e-5


def _id(c):
    return "B%dS%dI%dN%d" % c[:4] + ("-h0" if c[4] else "") + \
        ("-dh" if c[5] else "")


def _inputs(case, seed=0):
    B, S, I, N, _, _ = case
    g = np.random.default_rng(seed)
    dA = 1.0 / (1.0 + np.exp(-g.standard_normal((B, S, I, N))))
    return dict(dA=dA.astype(np.float32),
                dBu=(g.standard_normal((B, S, I, N)) * 0.3).astype(
                    np.float32),
                C=g.standard_normal((B, S, N)).astype(np.float32),
                h0=(g.standard_normal((B, I, N)) * 0.1).astype(np.float32),
                dy=g.standard_normal((B, S, I)).astype(np.float32),
                dh=g.standard_normal((B, I, N)).astype(np.float32))


def _chunked(dA, dBu, C, h0):
    """The reference's chunk loop without the model around it: identity
    steps pad the last chunk, ``_chunk_scan`` solves each chunk from the
    carried h, and the chunk body's einsum reads y out."""
    B, S, I, N = dA.shape
    pad = -S % CHUNK
    if pad:
        dA = jnp.pad(dA, ((0, 0), (0, pad), (0, 0), (0, 0)),
                     constant_values=1.0)
        dBu = jnp.pad(dBu, ((0, 0), (0, pad), (0, 0), (0, 0)))
        C = jnp.pad(C, ((0, 0), (0, pad), (0, 0)))
    h, ys = h0, []
    for c0 in range(0, S + pad, CHUNK):
        hc = jax_chunk_scan(dA[:, c0:c0 + CHUNK], dBu[:, c0:c0 + CHUNK], h)
        ys.append(jnp.einsum("bqin,bqn->bqi", hc, C[:, c0:c0 + CHUNK]))
        h = hc[:, -1]
    return jnp.concatenate(ys, 1)[:, :S], h


def _jax_grads(fn, a, with_h0, with_dh):
    h0 = a["h0"] if with_h0 else np.zeros_like(a["h0"])
    dh = a["dh"] if with_dh else np.zeros_like(a["dh"])
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (a["dA"], a["dBu"],
                                                      a["C"], h0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(a["dy"]),
                                        jnp.asarray(dh)))]


def _close(got, want, what, tol=TOL):
    got = got.detach().float().numpy()
    err = float(np.max(np.abs(got - want)))
    bound = tol * float(np.max(np.abs(want)))
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_backward_matches_jax_vjp_of_the_oracle_and_the_chunk_solver(
        case):
    a = _inputs(case)
    with_h0, with_dh = case[4], case[5]
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    got = selective_scan_bwd_ref(t["dA"], t["dBu"], t["C"],
                                 t["h0"] if with_h0 else None, t["dy"],
                                 t["dh"] if with_dh else None)
    assert (got[3] is None) == (not with_h0)
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    for fn, label in ((jax_scan_ref, "oracle"), (_chunked, "chunked")):
        want = _jax_grads(fn, a, with_h0, with_dh)
        for name, g, w in zip(NAMES, got, want):
            if g is None:
                continue
            assert tuple(g.shape) == w.shape, (label, name)
            _close(g, w, f"{label} {name}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_backward_matches_autograd_of_the_cpu_dispatcher(case):
    a = _inputs(case, seed=1)
    with_h0, with_dh = case[4], case[5]
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    leaves = [t[k].clone().requires_grad_(True) for k in ("dA", "dBu", "C",
                                                           "h0")]
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    y, h = ops.selective_scan(*leaves[:3], leaves[3] if with_h0 else None)
    loss = (y * t["dy"]).sum()
    if with_dh:
        loss = loss + (h * t["dh"]).sum()
    loss.backward()
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == before
    want = selective_scan_bwd_ref(t["dA"], t["dBu"], t["C"],
                                  t["h0"] if with_h0 else None, t["dy"],
                                  t["dh"] if with_dh else None)
    for name, leaf, w in zip(NAMES, leaves, want):
        if w is None:
            assert leaf.grad is None
            continue
        _close(leaf.grad, w.numpy(), name)


def _smoke(dt="float32"):
    cfg = get_smoke_config("jamba-1.5-large-398b").with_(
        param_dtype=dt, compute_dtype=dt)
    return cfg, build(cfg, device="cpu")


def _saved_shapes(fn):
    """Shapes of the tensors autograd saves while ``fn`` runs, outside any
    checkpoint (a checkpoint's own hooks take the ones saved inside it)."""
    shapes = []

    def pack(x):
        shapes.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn()
    return out, shapes


@pytest.mark.parametrize("S", [16, 40])
def test_mamba_forward_keeps_no_chunk_tensor_past_the_forward(S):
    cfg, b = _smoke()
    p = b.init_params(torch.Generator().manual_seed(0))
    layer = p["groups"][0]["blocks"][0]["mamba"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    _, inner, _ = mamba._dims(cfg)
    Q, N = cfg.ssm_chunk, cfg.mamba.d_state
    chunk_shapes = {(2, q, inner, N) for q in {Q, S - (S - 1) // Q * Q}}
    (out, _), shapes = _saved_shapes(
        lambda: mamba.mamba_forward(cfg, leaves, x))
    assert not chunk_shapes & set(shapes), shapes
    out.sum().backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all())
               for v in leaves.values())
    # the same body outside the checkpoint saves them: the count sees them
    u = torch.randn((2, Q, inner), requires_grad=True)
    _, shapes = _saved_shapes(lambda: mamba._chunk(cfg, leaves, u, None))
    assert (2, Q, inner, N) in shapes


def test_mamba_serving_prefill_keeps_the_in_place_cache():
    cfg, b = _smoke()
    p = b.init_params(torch.Generator().manual_seed(0))
    layer = p["groups"][0]["blocks"][0]["mamba"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    _, inner, _ = mamba._dims(cfg)
    cache = mamba.MambaCache(
        conv=torch.zeros((2, cfg.mamba.d_conv - 1, inner)),
        ssm=torch.zeros((2, inner, cfg.mamba.d_state)))
    ssm = cache.ssm
    with torch.no_grad():
        out, got = mamba.mamba_forward(cfg, layer, x, initial=cache)
        want, fresh = mamba.mamba_forward(cfg, layer, x)
    assert got is cache and got.ssm is ssm
    assert torch.equal(out, want) and torch.equal(got.ssm, fresh.ssm)
    # under grad the cache is still written in place, from a new h
    leaves = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
    cache2 = mamba.MambaCache(conv=torch.zeros_like(cache.conv),
                              ssm=torch.zeros_like(cache.ssm))
    out2, got2 = mamba.mamba_forward(cfg, leaves, x, initial=cache2)
    assert got2 is cache2 and torch.equal(got2.ssm.detach(), fresh.ssm)
    assert torch.allclose(out2.detach(), want, rtol=0, atol=0)
    out2.sum().backward()


def _ref_grads(rb, rp, batch):
    loss, grads = jax.value_and_grad(
        lambda p: rb.loss(p, batch)[0])(rp)
    return float(loss), grads


def test_jamba_backward_over_three_chunks_matches_jax_grad():
    """S 40 is three chunks of the smoke config's 16, the last ragged: the
    chunk loop used to overwrite the h a chunk's backward had saved."""
    kw = dict(param_dtype="float32", compute_dtype="float32")
    arch = "jamba-1.5-large-398b"
    rb = ref_build(ref_smoke_config(arch).with_(**kw))
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(get_smoke_config(arch).with_(**kw), device="cpu")
    assert b.cfg.ssm_chunk == CHUNK
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    tok = np.random.default_rng(7).integers(0, b.cfg.vocab_size, (2, 41),
                                            np.int32)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    r_loss, r_grads = _ref_grads(rb, rp, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(p)]
    loss, _ = b.loss(tree_structure(p).unflatten(leaves),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - r_loss) <= TOL * abs(r_loss)
    flat = jax.tree_util.tree_leaves(r_grads)
    assert len(flat) == len(grads)
    for i, (g, w) in enumerate(zip(grads, flat)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, i
        bound = TOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, (i, err, bound)
