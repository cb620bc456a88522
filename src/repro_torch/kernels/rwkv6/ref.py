"""Plain PyTorch versions of the RWKV-6 WKV recurrence — the port of
``repro/kernels/rwkv6/ref.py`` (the step-by-step oracle) and of
``repro/models/rwkv.py:_wkv_chunked`` (the chunked closed form the
reference model runs).  The CPU path runs them, and ``chip_smoke.py`` holds
the CUDA kernel against them on the card.

Per head, head size n, state S in R^{n x n} (key-major):

    y_t = (S_{t-1} + diag(u * k_t) v_t^T)^T r_t      (read out)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T              (decay + rank-1 update)

Shapes: r, k, v, logw (B, T, H, n); u (H, n); S0 (B, H, n, n).  All math
fp32; both return y (B, T, H, n) fp32 and the final state (B, H, n, n) fp32.
"""
from __future__ import annotations

from typing import Optional

import torch


def _state0(r, S0: Optional[torch.Tensor]):
    B, _, H, n = r.shape
    if S0 is None:
        return torch.zeros((B, H, n, n), dtype=torch.float32,
                           device=r.device)
    return S0.float()


def wkv6_ref(r, k, v, logw, u, S0=None):
    """The step-by-step oracle; at T = 1 it is the reference model's
    decode (``rwkv_time_mix``'s direct recurrence)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())                  # decay in (0, 1)
    uf = u.float()
    S = _state0(r, S0)
    ys = []
    for t in range(r.shape[1]):
        k_t, v_t = kf[:, t], vf[:, t]
        # bonus: the current token adds diag(u * k) v^T without decay
        S_plus = S + (uf * k_t)[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhij,bhi->bhj", S_plus, rf[:, t]))
        S = wf[:, t, :, :, None] * S + k_t[..., :, None] * v_t[..., None, :]
    return torch.stack(ys, 1), S


def wkv6_chunked(r, k, v, logw, u, S0=None, *, chunk: int = 256):
    """Chunked closed form (FLA-style), as the reference model computes it:
    within a chunk of Q tokens the cross-token terms are weighted by
    exp(logP_{t-1} - logP_s), s < t (exponents <= 0, so stable), and the
    state is carried from chunk to chunk.  A ragged tail is padded with
    identity decay (logw = 0) and zero r / k / v, so the carried state is
    exact."""
    B, T, H, n = r.shape
    Q = min(chunk, T)
    pad = -T % Q
    rf, kf, vf, lw = (a.float() for a in (r, k, v, logw))
    if pad:
        rf, kf, vf, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (rf, kf, vf, lw))
    uf = u.float()
    causal_lt = torch.ones((Q, Q), dtype=torch.bool,
                           device=r.device).tril(-1)             # s < t
    S_c = _state0(r, S0)
    ys = []
    for c in range(rf.shape[1] // Q):
        sl = slice(c * Q, (c + 1) * Q)
        r_c, k_c, v_c, lw_c = rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl]
        logP = torch.cumsum(lw_c, 1)                              # inclusive
        logPm1 = logP - lw_c                                      # exclusive
        # inter-chunk: r_t decayed against the carried state
        y_inter = torch.einsum("bthi,bhij->bthj", r_c * torch.exp(logPm1),
                               S_c)
        # intra-chunk: A[t,s] = sum_i r_t k_s exp(logPm1_t - logP_s), s < t
        expo = logPm1[:, :, None] - logP[:, None, :]              # (B,t,s,H,n)
        expo = expo.masked_fill(~causal_lt[None, :, :, None, None],
                                float("-inf"))
        A = (r_c[:, :, None] * k_c[:, None] * torch.exp(expo)).sum(-1)
        diag = torch.einsum("bthi,bthi->bth", r_c, uf * k_c)      # bonus
        y_intra = (torch.einsum("btsh,bshj->bthj", A, v_c)
                   + diag[..., None] * v_c)
        # state to the chunk's end
        k_tilde = k_c * torch.exp(logP[:, -1:] - logP)
        S_c = (torch.exp(logP[:, -1])[..., None] * S_c
               + torch.einsum("bshi,bshj->bhij", k_tilde, v_c))
        ys.append(y_inter + y_intra)
    return torch.cat(ys, 1)[:, :T], S_c
