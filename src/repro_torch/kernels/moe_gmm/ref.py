"""Plain PyTorch version of the grouped (per-expert) matmul — the port of
``repro/kernels/moe_gmm/ref.py``.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F), fp32 accumulation, cast to
    ``x.dtype``."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
