"""The port's kernel dispatchers under autograd, on the CPU.

Every CUDA kernel of the port has its backward: the flash kernel
(``kernels.attention.ops.FlashAttention``: the forward kernel writes the
logsumexp, ``csrc/flash_attention_bwd.cu`` computes dq, dk, dv), the
grouped matmul (``kernels.moe_gmm.ops.GroupedMatmul``: the dx and dw
kernels of ``csrc/grouped_matmul.cu``), WKV-6 (``kernels.rwkv6.ops.WKV6``:
``csrc/wkv6_bwd.cu``) and the selective scan
(``kernels.mamba.ops.SelectiveScan``: ``csrc/selective_scan_bwd.cu``), so
each dispatcher's CUDA branch runs its kernels under autograd.  Here, on
the CPU, the four dispatchers' CPU branches (the plain versions) stay
differentiable: the same inputs that require grad give finite gradients
equal to autograd's through the plain version called directly.

``tests/test_torch_cuda.py`` checks the CUDA branches on the card: each
dispatcher's gradients go through its kernels and match its plain
backward.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.kernels.mamba import ops as scan_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops


def _inputs(name, seed=0):
    """(dispatcher, plain version, inputs) on the CPU, fp32, from numpy."""
    g = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (g.standard_normal(shape) * scale).astype(np.float32))

    if name == "flash_attention":
        return (flash_ops.flash_attention, flash_ops.plain_attention,
                [t(1, 5, 2, 2, 8), t(1, 5, 2, 8), t(1, 5, 2, 8)])
    if name == "grouped_matmul":
        return (gmm_ops.grouped_matmul, gmm_ops.grouped_matmul_ref,
                [t(2, 3, 8), t(2, 8, 4)])
    if name == "wkv6":
        B, T, H, n = 1, 6, 2, 4
        return (wkv_ops.wkv6, wkv_ops.plain_wkv6,
                [t(B, T, H, n), t(B, T, H, n, scale=0.5), t(B, T, H, n),
                 -torch.exp(t(B, T, H, n, scale=0.5)), t(H, n, scale=0.3),
                 t(B, H, n, n, scale=0.1)])
    return (scan_ops.selective_scan, scan_ops.selective_scan_ref,
            [torch.sigmoid(t(1, 4, 3, 2)), t(1, 4, 3, 2), t(1, 4, 2),
             t(1, 3, 2)])


def _loss(out):
    outs = out if isinstance(out, tuple) else (out,)
    return sum((o * o).sum() for o in outs)


@pytest.mark.parametrize("name", ["flash_attention", "grouped_matmul",
                                  "wkv6", "selective_scan"])
def test_cpu_dispatchers_stay_differentiable(name):
    dispatch, plain, inputs = _inputs(name)
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    _loss(dispatch(*leaves)).backward()
    want = [x.clone().requires_grad_(True) for x in inputs]
    _loss(plain(*want)).backward()
    for got, ref in zip(leaves, want):
        assert got.grad is not None and bool(torch.isfinite(got.grad).all())
        assert torch.allclose(got.grad, ref.grad, rtol=1e-5, atol=1e-6)
