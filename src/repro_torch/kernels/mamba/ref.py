"""Plain PyTorch version of the Mamba (S6) selective scan — the port of
``repro/kernels/mamba/ref.py`` (the step-by-step recurrence).  The CPU
path runs it, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card.

    h_t = dA_t ⊙ h_{t-1} + dBu_t          h ∈ R^{I×N}
    y_t = Σ_n h_t[:, n] · C_t[n]

Shapes: dA / dBu (B, S, I, N); C (B, S, N); h0 (B, I, N).  All math fp32;
returns y (B, S, I) fp32 and the final h (B, I, N) fp32.  At S = 1 it is
the reference model's decode step (``mamba_decode``).
"""
from __future__ import annotations

from typing import Optional

import torch


def selective_scan_ref(dA, dBu, C, h0: Optional[torch.Tensor] = None):
    B, S, I, N = dA.shape
    h = (torch.zeros((B, I, N), dtype=torch.float32, device=dA.device)
         if h0 is None else h0.float())
    dAf, dBuf, Cf = dA.float(), dBu.float(), C.float()
    ys = []
    for t in range(S):
        h = dAf[:, t] * h + dBuf[:, t]
        ys.append(torch.einsum("bin,bn->bi", h, Cf[:, t]))
    return torch.stack(ys, 1), h
