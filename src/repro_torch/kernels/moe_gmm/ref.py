"""Plain PyTorch version of the grouped (per-expert) matmul — the port of
``repro/kernels/moe_gmm/ref.py``.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F), fp32 accumulation, cast to
    ``x.dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_dx_ref(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx (E, C, D) = dy (E, C, F) @ w (E, D, F)^T, fp32 sums cast to
    ``dy.dtype``."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw (E, D, F) = x (E, C, D)^T @ dy (E, C, F), fp32 sums cast to
    ``dy.dtype``."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(dy.dtype)


def grouped_matmul_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                           dy: torch.Tensor) -> tuple:
    """The gradients of ``grouped_matmul_ref`` for the output gradient dy
    (E, C, F): (dx, dw), fp32 sums cast to the inputs' dtype — what
    ``jax.vjp`` of the reference's einsum gives, and what the card's
    backward kernels are held to."""
    return (grouped_matmul_dx_ref(w, dy).to(x.dtype),
            grouped_matmul_dw_ref(x, dy).to(w.dtype))
