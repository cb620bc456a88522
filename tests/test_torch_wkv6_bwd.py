"""WKV-6's plain backward against the JAX package's gradients, on the CPU.

``kernels.rwkv6.ref.wkv6_bwd_ref(r, k, v, logw, u, S0, dy, dS)`` is what
the card's backward kernel (``csrc/wkv6_bwd.cu``) is held to.  The
reference has no backward kernel: ``jax.grad`` differentiates its chunked
form (``repro/models/rwkv.py:_wkv_chunked``) when it trains rwkv6-7b.  Here
the same numpy inputs from a seed, with cotangents on y and on the final
state, go through:

* ``jax.vjp`` of ``repro.kernels.rwkv6.ref.wkv6_ref`` (the step oracle) and
  of ``repro.models.rwkv._wkv_chunked`` (16-step chunks: T 37, 65 and 130
  end in a padded chunk);
* ``wkv6_bwd_ref``;
* torch autograd through the port's dispatcher on the CPU (``ops.wkv6``,
  its plain branch: no kernel launch counted).

``kernels.rwkv6.ref.wkv6_bwd_subblocks`` is the plain-torch mirror of the
kernel's decomposition (64-step chunks, 16-step sub-blocks, the state
gradient's scan over the chunks, the decay gradient's reverse sums
restarted at every chunk's end).  In fp32 it is held to both of JAX's
vjps and to ``wkv6_bwd_ref`` within 1e-5 x max|ref| (T 37, 65 and 130, n
16, S0 and dS given, strong and weak decay); with its products' operands
rounded to TF32 as the card's tensor cores take them, split where the
kernel splits them, it stays within the card's limits (1e-2 x max|plain|
for dr, dk and dv, written in bf16; 1e-3 for dlogw, du and dS0) at the
training length T 512 with n 64.

All six gradients (dr, dk, dv, dlogw, du, dS0) within 1e-5 x max|ref| in
fp32 (the same sums in another order; dlogw comes from the two reverse
sums of the decay identity instead of the state, which holds the same
bound at these lengths: the sums do not cancel badly, see the last test),
and within 1e-2 x max|ref| when r, k and v are bf16-valued and the
gradients of r, k and v are rounded to bf16 as the kernel writes them (one
rounding, half an ulp: 3.9e-3 relative).  Head sizes 16, 32 and 64; T 1,
37, 65 and 130; B 2; S0 given and absent (zeros to JAX); the reference
sweep's decays and strong (-exp(x), x in [1, 3]) and weak (x in [-9, -7])
ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models.rwkv import _wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import (wkv6_bwd_ref, wkv6_bwd_subblocks,
                                           wkv6_ref)

CASES = [  # B, T, H, n, S0 given, decay
    (2, 1, 2, 16, True, None),
    (2, 37, 3, 16, False, None),
    (2, 65, 2, 32, True, None),
    (2, 130, 2, 64, True, None),
    (2, 37, 2, 64, False, "strong"),
    (2, 65, 2, 32, True, "weak"),
    (2, 130, 2, 16, False, "weak"),
]
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dS0")
CHUNK = 16


def _id(c):
    return "B%dT%dH%dn%d" % c[:4] + ("-S0" if c[4] else "") + \
        (f"-{c[5]}" if c[5] else "")


def _inputs(case, seed=0):
    B, T, H, n, with_s0, decay = case
    g = np.random.default_rng(seed)
    r = g.standard_normal((B, T, H, n), np.float32)
    k = g.standard_normal((B, T, H, n), np.float32) * 0.5
    v = g.standard_normal((B, T, H, n), np.float32)
    logw = -np.exp(g.standard_normal((B, T, H, n), np.float32) * 0.5)
    if decay is not None:
        lo, hi = {"strong": (1.0, 3.0), "weak": (-9.0, -7.0)}[decay]
        logw = -np.exp(g.uniform(lo, hi, (B, T, H, n))).astype(np.float32)
    u = g.standard_normal((H, n), np.float32) * 0.3
    S0 = (g.standard_normal((B, H, n, n), np.float32) * 0.1 if with_s0
          else np.zeros((B, H, n, n), np.float32))
    dy = g.standard_normal((B, T, H, n), np.float32)
    dS = g.standard_normal((B, H, n, n), np.float32)
    return dict(r=r, k=k, v=v, logw=logw, u=u, S0=S0, dy=dy, dS=dS)


def _bf16_valued(x):
    return np.asarray(torch.from_numpy(x).bfloat16().float())


def _vjp(fn):
    """jit of the vjp of ``fn`` at (y, S)'s cotangents: the fp32 and the
    bf16-valued cases of a shape share one compilation."""
    return jax.jit(lambda args, cot: jax.vjp(fn, *args)[1](cot))


VJP_STEP = _vjp(jax_wkv6_ref)
VJP_CHUNKED = _vjp(lambda r, k, v, logw, u, S0: jax_wkv_chunked(
    r, k, v, logw, u, S0, CHUNK, False))


def _jax_grads(vjp, a):
    args = [jnp.asarray(a[name]) for name in ("r", "k", "v", "logw", "u",
                                              "S0")]
    return [np.asarray(g) for g in vjp(args, (jnp.asarray(a["dy"]),
                                              jnp.asarray(a["dS"])))]


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    err = float(np.max(np.abs(got - want)))
    bound = tol * float(np.max(np.abs(want)))
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_backward_matches_jax_vjp_and_torch_autograd(case, bf16):
    a = _inputs(case)
    if bf16:
        for name in ("r", "k", "v"):
            a[name] = _bf16_valued(a[name])
    want_step = _jax_grads(VJP_STEP, a)
    want_chunked = _jax_grads(VJP_CHUNKED, a)
    t = {name: torch.from_numpy(x) for name, x in a.items()}
    rkv = [t[name].bfloat16() if bf16 else t[name] for name in "rkv"]
    S0 = t["S0"] if case[4] else None
    got = list(wkv6_bwd_ref(*rkv, t["logw"], t["u"], S0, t["dy"], t["dS"]))
    assert all(g.dtype == torch.float32 for g in got)
    assert [tuple(g.shape) for g in got] == [x.shape for x in want_step]
    if bf16:                       # as the kernel writes dr, dk and dv
        got[:3] = [g.bfloat16() for g in got[:3]]
    tol = 1e-2 if bf16 else 1e-5
    for name, g, ws, wc in zip(NAMES, got, want_step, want_chunked):
        _close(g, ws, tol, f"{name} vs jax.vjp(wkv6_ref)")
        _close(g, wc, tol, f"{name} vs jax.vjp(_wkv_chunked)")
    # torch autograd through the dispatcher's plain branch (fp32 inputs:
    # the CPU path differentiates the chunked form)
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    leaves = [t[name].clone().requires_grad_(True)
              for name in ("r", "k", "v", "logw", "u", "S0")]
    y, S = ops.wkv6(*leaves[:5], leaves[5] if case[4] else None,
                    chunk=CHUNK)
    ((y * t["dy"]).sum() + (S * t["dS"]).sum()).backward()
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == before
    for name, leaf, ws in zip(NAMES, leaves, want_step):
        if name == "dS0" and not case[4]:
            assert leaf.grad is None
            continue
        _close(leaf.grad, ws, 1e-5, f"{name} vs the dispatcher's autograd")


@pytest.mark.parametrize("with_dS", [False, True], ids=["dy", "dy+dS"])
def test_plain_backward_without_a_final_state_cotangent(with_dS):
    """dS None (training: the loss never reads the final state) is a zero
    cotangent; S0 None is a zero state."""
    a = _inputs((2, 20, 2, 32, False, None), seed=3)
    t = {name: torch.from_numpy(x) for name, x in a.items()}
    args = [t[name] for name in ("r", "k", "v", "logw", "u")]
    dS = t["dS"] if with_dS else None
    got = wkv6_bwd_ref(*args, None, t["dy"], dS)
    want = wkv6_bwd_ref(*args, torch.zeros_like(t["S0"]), t["dy"],
                        t["dS"] if with_dS else torch.zeros_like(t["dS"]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    leaves = [x.clone().requires_grad_(True) for x in args]
    y, S = wkv6_ref(*leaves)
    loss = (y * t["dy"]).sum() + ((S * dS).sum() if with_dS else 0)
    loss.backward()
    for name, leaf, g in zip(NAMES, leaves, got):
        _close(leaf.grad, g.numpy(), 1e-5, name)


def test_decay_identity_holds_in_fp32_at_the_training_length():
    """dlogw from the decay identity in fp32 against torch autograd through
    the oracle's step formulas in fp64 at T 2048 with weak decay
    (logw near -1e-4: the state keeps everything, the two reverse sums are
    longest): within 1e-5 x max|dlogw|."""
    B, T, H, n = 1, 2048, 1, 16
    g = np.random.default_rng(7)
    r, k, v, dy = (g.standard_normal((B, T, H, n)) for _ in range(4))
    k *= 0.5
    logw = -np.exp(g.uniform(-9.0, -7.0, (B, T, H, n)))
    u = g.standard_normal((H, n)) * 0.3
    S0 = g.standard_normal((B, H, n, n)) * 0.1
    dS = g.standard_normal((B, H, n, n))
    f32 = [torch.from_numpy(x.astype(np.float32))
           for x in (r, k, v, logw, u, S0, dy, dS)]
    got = wkv6_bwd_ref(*f32)[3]
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (r, k, v, logw, u, S0)]
    # the oracle's step formulas in fp64 (wkv6_ref casts to fp32)
    rf, kf, vf, lw, uf, S = leaves
    ys = []
    for t in range(T):
        ys.append(torch.einsum(
            "bhij,bhi->bhj", S + (uf * kf[:, t])[..., :, None]
            * vf[:, t, :, None, :], rf[:, t]))
        S = torch.exp(lw[:, t])[..., :, None] * S \
            + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    y = torch.stack(ys, 1)
    ((y * torch.from_numpy(dy)).sum()
     + (S * torch.from_numpy(dS)).sum()).backward()
    _close(got, leaves[3].grad.numpy(), 1e-5, "dlogw")


SUBBLOCK_CASES = [  # B, T, H, n, S0 and dS given, decay: 1, 2 and 3 chunks
    (2, 37, 2, 16, True, None),
    (2, 65, 2, 16, True, None),
    (2, 65, 2, 16, True, "strong"),
    (2, 130, 2, 16, False, "weak"),
]


@pytest.mark.parametrize("case", SUBBLOCK_CASES, ids=_id)
def test_subblock_mirror_matches_jax_vjp_and_the_plain_backward(case):
    """The kernel's decomposition in fp32 against jax.vjp of the
    reference's chunked form and of its step oracle, and against
    ``wkv6_bwd_ref``: within 1e-5 x max|ref| (the same sums in another
    order).  dlogw is a difference of sums of r * dr0 and k * dk0, which
    under strong decay reach 40 x max|dlogw|: its bound is 1e-5 x the
    larger of max|dlogw| and max|r * dr|."""
    a = _inputs(case, seed=4)
    if not case[4]:
        a["dS"] = np.zeros_like(a["dS"])
    wants = {"jax.vjp(_wkv_chunked)": _jax_grads(VJP_CHUNKED, a),
             "jax.vjp(wkv6_ref)": _jax_grads(VJP_STEP, a)}
    t = {name: torch.from_numpy(x) for name, x in a.items()}
    S0, dS = (t["S0"], t["dS"]) if case[4] else (None, None)
    args = [t[name] for name in ("r", "k", "v", "logw", "u")]
    got = wkv6_bwd_subblocks(*args, S0, t["dy"], dS)
    wants["wkv6_bwd_ref"] = [x.numpy() for x in wkv6_bwd_ref(*args, S0,
                                                             t["dy"], dS)]
    terms = float(np.max(np.abs(a["r"] * wants["wkv6_bwd_ref"][0])))
    for what, want in wants.items():
        for name, g, w in zip(NAMES, got, want):
            scale = float(np.max(np.abs(w)))
            if name == "dlogw":
                scale = max(scale, terms)
            err = float(np.max(np.abs(g.numpy() - w)))
            assert err <= 1e-5 * scale, (f"{name} vs {what}", err, scale)


@pytest.mark.parametrize("decay", [None, "strong"], ids=["decay", "strong"])
def test_subblock_mirror_at_tf32_stays_within_the_card_limits(decay):
    """The card's arithmetic on the CPU: at the training length (T 512, n
    64) with S0 and dS given, every product's operands rounded to TF32,
    split into hi + lo where the kernel splits them, and dr, dk, dv rounded
    to bf16 as the kernel writes them, against the fp32 ``wkv6_bwd_ref``
    within ``chip_smoke.py``'s limits."""
    a = _inputs((1, 512, 1, 64, True, decay), seed=5)
    t = {name: torch.from_numpy(x) for name, x in a.items()}
    for name in "rkv":
        t[name] = t[name].bfloat16()
    args = [t[name] for name in ("r", "k", "v", "logw", "u", "S0", "dy",
                                 "dS")]
    want = wkv6_bwd_ref(*args)
    got = list(wkv6_bwd_subblocks(*args, operands="tf32", split=True))
    got[:3] = [g.bfloat16() for g in got[:3]]
    for name, g, w, tol in zip(NAMES, got, want,
                               (1e-2, 1e-2, 1e-2, 1e-3, 1e-3, 1e-3)):
        _close(g, w.numpy(), tol, name)
