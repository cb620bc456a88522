"""The port's flash attention against the JAX package's.

On the CPU the port's dispatcher (``ops.flash_attention``) runs the plain
version; it is held against the JAX TPU kernel run by the Pallas
interpreter (``flash_attention_kernel(..., interpret=True)``, small blocks
so the ragged edges and causal block skipping are exercised) and against
the JAX plain version.  Same numpy inputs on both sides.

Tolerances: fp32 at atol = rtol = 1e-5 (the same function, summed in
another order); bf16 inputs at 2e-2 (bf16 output rounding: one ulp near 1
is 7.8e-3, and the two sides round P and O at different places).

The CUDA kernel itself has no CPU mode: ``tests/test_torch_cuda.py``
holds it against the plain version on the card (it imports no JAX, which
that machine lacks), and ``chip_smoke.py`` does so at the path's shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.kernel import flash_attention_kernel
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.utils.convert import from_numpy

CASES = [
    # B, H, K, Sq, Sk, hd, hd_v, causal, (block_q, block_k) for Pallas
    (1, 2, 2, 37, 37, 16, 16, True, (16, 16)),      # ragged, causal
    (2, 4, 2, 40, 40, 16, 16, True, (16, 16)),      # GQA
    (1, 4, 1, 24, 24, 32, 16, True, (8, 16)),       # hd_v != hd, K=1
    (2, 2, 2, 20, 33, 16, 16, False, (16, 16)),     # non-causal, Sq != Sk
    (1, 4, 2, 33, 33, 8, 24, False, (16, 8)),       # hd_v > hd, GQA
]
IDS = [f"B{c[0]}H{c[1]}K{c[2]}S{c[3]}x{c[4]}hd{c[5]}v{c[6]}"
       f"{'c' if c[7] else 'f'}" for c in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    B, H, K, Sq, Sk, hd, hd_v, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd), np.float32)
    k = rng.standard_normal((B, K, Sk, hd), np.float32)
    v = rng.standard_normal((B, K, Sk, hd_v), np.float32)
    return q, k, v


def _model_layout(q, k, v, H, K):
    """(B,H,S,hd) / (B,K,T,hd) -> the model layout the dispatcher takes."""
    B, _, S, hd = q.shape
    qm = q.reshape(B, K, H // K, S, hd).permute(0, 3, 1, 2, 4).contiguous()
    return qm, k.permute(0, 2, 1, 3).contiguous(), \
        v.permute(0, 2, 1, 3).contiguous()


def _from_model_layout(o):
    B, S, K, G, hd_v = o.shape
    return o.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd_v)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_matches_jax_fp32(case):
    q, k, v = _inputs(case)
    causal = case[7]
    ours = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal).numpy()
    theirs = np.asarray(jax_attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dispatcher_matches_pallas_kernel_fp32(case):
    B, H, K, Sq, Sk, hd, hd_v, causal, (bq, bk) = case
    q, k, v = _inputs(case, seed=1)
    theirs = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True))
    before = ops.LAUNCHES
    out = ops.flash_attention(*_model_layout(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        H, K), causal=causal)
    assert ops.LAUNCHES == before          # the plain path launches nothing
    assert out.shape == (B, Sq, K, H // K, hd_v)
    np.testing.assert_allclose(_from_model_layout(out).numpy(), theirs,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dispatcher_matches_pallas_kernel_bf16(case):
    B, H, K, Sq, Sk, hd, hd_v, causal, (bq, bk) = case
    q, k, v = _inputs(case, seed=2)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    theirs = np.asarray(flash_attention_kernel(
        *jb, causal=causal, block_q=bq, block_k=bk,
        interpret=True).astype(jnp.float32))
    tb = [from_numpy(np.asarray(a)) for a in jb]     # same bf16 bits
    assert all(t.dtype == torch.bfloat16 for t in tb)
    out = ops.flash_attention(*_model_layout(*tb, H, K), causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_from_model_layout(out).float().numpy(),
                               theirs, atol=2e-2, rtol=2e-2)
