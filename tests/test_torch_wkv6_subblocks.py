"""The decomposition the Hopper WKV-6 kernel's chunked route computes, held
on the CPU against the JAX package's oracle and its Pallas TPU kernel.

``repro_torch.kernels.rwkv6.ref.wkv6_subblocks`` is a plain mirror of
``csrc/wkv6.cu``'s chunked route: chunks of 64 steps, the (64, 64) scores
factored by sub-blocks of 16 steps (pairs of sub-blocks split at the
earlier one's last step, diagonal sub-blocks as running products of the
decay), every product's operands rounded as the card's tensor cores take
them.  The kernel takes its products in TF32 with each decay-weighted
operand split in two (``operands="tf32", split=True``); this file holds
the mirror at that precision, and in fp32, against
``repro.kernels.rwkv6.ref.wkv6_ref`` (the step-by-step oracle) and
``repro.kernels.rwkv6.kernel.wkv6_kernel`` (run as the reference's own
tests run it: the Pallas interpreter here), on the same numpy inputs:

* T at the edges of sub-blocks and chunks (1, 15, 16, 17, 63, 64, 65,
  129) and n in {16, 32, 64}, with three heads whose log decays run from
  -exp(3) (strong: the state forgets within a step) to -exp(-9) (near
  identity: it forgets nothing over the sequence), and a non-zero S0;
* y and the final state within 1e-3 x max|oracle| (the card's limit),
  against both;
* why the kernel splits: on the same inputs a single TF32 rounding of each
  operand costs up to half the limit and bf16 operands break it, while
  the split stays near fp32.

r, k and v are bf16-valued (the kernel's input type) and carried in fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.kernel import wkv6_kernel
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6.ref import wkv6_subblocks

LIMIT = 1e-3
T_EDGES = [1, 15, 16, 17, 63, 64, 65, 129]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_valued(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(T, n, B=1, seed=0):
    """Heads 0 / 1 / 2: logw = -exp(x), x uniform in [1, 3] (strong
    decay), [-9, -7] (near identity) and [-9, 3] (both, per channel)."""
    g = np.random.default_rng(seed)
    H = 3
    r = _bf16_valued(g.standard_normal((B, T, H, n), np.float32))
    k = _bf16_valued(g.standard_normal((B, T, H, n), np.float32) * 0.5)
    v = _bf16_valued(g.standard_normal((B, T, H, n), np.float32))
    lo = np.array([1.0, -9.0, -9.0], np.float32)[None, None, :, None]
    hi = np.array([3.0, -7.0, 3.0], np.float32)[None, None, :, None]
    x = lo + (hi - lo) * g.random((B, T, H, n), np.float32)
    logw = (-np.exp(x)).astype(np.float32)
    u = g.standard_normal((H, n), np.float32) * 0.3
    S0 = g.standard_normal((B, H, n, n), np.float32) * 0.1
    return r, k, v, logw, u, S0


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("T", T_EDGES)
def test_mirror_matches_the_oracle_and_the_pallas_kernel(T, n,
                                                         pallas_interpret):
    ins = _inputs(T, n)
    y_orc, S_orc = jax_wkv6_ref(*(jnp.asarray(a) for a in ins))
    y_pal, S_pal = wkv6_kernel(*(jnp.asarray(a) for a in ins), block_t=64,
                               interpret=pallas_interpret)
    t = [torch.from_numpy(a) for a in ins]
    for operands, split in ((None, False), ("tf32", True)):
        y, S = wkv6_subblocks(*t, operands=operands, split=split)
        assert y.shape == (1, T, 3, n) and S.shape == (1, 3, n, n)
        for got, ref in ((y, y_orc), (S, S_orc), (y, y_pal), (S, S_pal)):
            assert bool(torch.isfinite(got).all())
            assert _rel(got.numpy(), ref) <= LIMIT


def test_operand_precision_sets_the_kernel_split():
    ins = _inputs(129, 64, seed=1)
    y_orc, S_orc = (np.asarray(a) for a in
                    jax_wkv6_ref(*(jnp.asarray(a) for a in ins)))
    t = [torch.from_numpy(a) for a in ins]

    def err(operands, split):
        y, S = wkv6_subblocks(*t, operands=operands, split=split)
        return max(_rel(y.numpy(), y_orc), _rel(S.numpy(), S_orc))

    assert err("tf32", True) <= 2e-5                 # the kernel's choice
    assert 2e-5 < err("tf32", False) <= LIMIT        # up to half the limit
    assert err("bf16", False) > LIMIT                # breaks it
