"""The grouped matmul's plain backward against the JAX package's gradient,
on the CPU.

``kernels.moe_gmm.ref.grouped_matmul_bwd_ref(x, w, dy)`` is what the card's
dx and dw kernels (``csrc/grouped_matmul.cu``) are held to.  The reference
has no backward kernel: ``jax.grad`` differentiates its einsum
(``repro/models/moe.py:_expert_mlp``).  Here the same numpy inputs from a
seed go through:

* ``jax.vjp`` of ``repro.kernels.moe_gmm.ref.grouped_matmul_ref``;
* torch autograd through the port's ``grouped_matmul_ref`` and through
  its dispatcher's CPU branch (no kernel launch counted);
* ``grouped_matmul_bwd_ref``.

fp32 within 1e-5 x max|ref| (the same sums in another order); bf16 within
1e-2 x max|ref| elementwise (one rounding of an fp32 sum to bf16 is half an
ulp, 3.9e-3 relative, and the two frameworks' fp32 sums differ in order).
The shapes take ragged C (1, 37), D 1000 and a capacity buffer whose last
rows hold no token (zeros): those rows add nothing to dw and get a zero dx
row wherever dy is zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jax_gmm_ref
from repro_torch.kernels.moe_gmm import ops
from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_bwd_ref,
                                             grouped_matmul_ref)

CASES = [  # E, C, D, F, empty capacity rows at the end
    (3, 37, 200, 72, 0),
    (3, 1, 200, 72, 0),
    (2, 48, 1000, 256, 0),
    (4, 40, 64, 96, 13),
    (2, 70, 136, 264, 9),
]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(case, seed=0):
    E, C, D, F, empty = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D), np.float32)
    w = rng.standard_normal((E, D, F), np.float32) * 0.1
    dy = rng.standard_normal((E, C, F), np.float32)
    if empty:
        x[:, C - empty:] = 0
        dy[:, C - empty:] = 0
    return x, w, dy


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.max(np.abs(ours.float().numpy() - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "E%dC%dD%dF%de%d" % c)
def test_plain_backward_matches_jax_vjp_and_torch_autograd(case, dtype):
    x, w, dy = _inputs(case)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(jax_gmm_ref, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    jdx, jdw = vjp(jnp.asarray(dy, jdt))
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    dx, dw = grouped_matmul_bwd_ref(tx, tw, tdy)
    assert dx.dtype == dw.dtype == tdt
    assert dx.shape == tx.shape and dw.shape == tw.shape
    tol = TOL[dtype]
    _close(dx, jdx.astype(jnp.float32), tol)
    _close(dw, jdw.astype(jnp.float32), tol)
    # autograd through the plain forward and through the dispatcher's CPU
    # branch
    before = (ops.LAUNCHES, ops.BWD_LAUNCHES)
    for fn in (grouped_matmul_ref, ops.grouped_matmul):
        lx, lw = (t.clone().requires_grad_(True) for t in (tx, tw))
        fn(lx, lw).backward(tdy)
        _close(lx.grad, dx.float(), tol)
        _close(lw.grad, dw.float(), tol)
    assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == before
    if case[4]:
        # empty capacity rows: zero dx rows, and dw equals the product over
        # the occupied rows alone
        assert not bool(dx[:, case[1] - case[4]:].any())
        keep = case[1] - case[4]
        _, dw_kept = grouped_matmul_bwd_ref(tx[:, :keep], tw, tdy[:, :keep])
        _close(dw, dw_kept.float(), tol)
