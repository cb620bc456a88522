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


def selective_scan_bwd_ref(dA, dBu, C, h0, dy, dh=None):
    """The plain backward of ``selective_scan_ref``: the gradients of a loss
    whose cotangents are ``dy`` (B, S, I) on y and ``dh`` (B, I, N) on the
    final h (None: zero), from the state ``h0`` (None: zero), step by step
    as ``csrc/selective_scan_bwd.cu`` computes them.  Returns d(dA), d(dBu)
    (B, S, I, N), dC (B, S, N) and dh0 (B, I, N), or None for dh0 when h0
    is None; all fp32.

    With h_t the state after step t and g_t = dL/dh_t (g_{S-1} takes dh):

        g_t       = dy_t ⊗ C_t + dA_{t+1} ⊙ g_{t+1}
        d(dBu)_t  = g_t
        d(dA)_t   = g_t ⊙ h_{t-1}
        dC_t      = Σ_i dy_t[i] h_t[i, :]
        dh0       = dA_0 ⊙ g_0
    """
    B, S, I, N = dA.shape
    dAf, dBuf, Cf, dyf = dA.float(), dBu.float(), C.float(), dy.float()
    h = (torch.zeros((B, I, N), dtype=torch.float32, device=dA.device)
         if h0 is None else h0.float())
    hs = [h]                                       # h_{t-1} for each t
    for t in range(S):
        h = dAf[:, t] * h + dBuf[:, t]
        hs.append(h)
    carry = (torch.zeros_like(h) if dh is None else dh.float())
    ddA, ddBu, dC = [None] * S, [None] * S, [None] * S
    for t in reversed(range(S)):
        g = carry + dyf[:, t, :, None] * Cf[:, t, None, :]
        ddBu[t] = g
        ddA[t] = g * hs[t]
        dC[t] = torch.einsum("bi,bin->bn", dyf[:, t], hs[t + 1])
        carry = dAf[:, t] * g
    return (torch.stack(ddA, 1), torch.stack(ddBu, 1), torch.stack(dC, 1),
            None if h0 is None else carry)
