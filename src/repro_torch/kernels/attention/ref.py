"""Plain PyTorch versions of flash attention (dense softmax, fp32) — the
port of ``repro/kernels/attention/ref.py``, and the forward's logsumexp and
the backward that the training slice's kernel computes.  The CPU tests run
them, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card; the path on a card never calls them."""
from __future__ import annotations

from typing import Optional

import torch


def _scores(q, k, *, causal: bool, scale: Optional[float]):
    """fp32 scaled scores (B, H, Sq, Sk), kv heads repeated for GQA, the
    causal upper triangle at -inf (top-left aligned)."""
    B, H, Sq, hd = q.shape
    _, K, Sk, _ = k.shape
    qf = q.float() * (hd ** -0.5 if scale is None else scale)
    kf = torch.repeat_interleave(k.float(), H // K, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, float("-inf"))
    return s


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None):
    """q: (B, H, Sq, hd); k/v: (B, K, Sk, hd[/v]) with K | H. fp32 math;
    causal masking is top-left aligned (q and kv positions start at 0)."""
    group = q.shape[1] // k.shape[1]
    s = _scores(q, k, causal=causal, scale=scale)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def attention_ref_lse(q, k, v, *, causal: bool = True,
                      scale: Optional[float] = None):
    """``(attention_ref(...), lse)``: lse (B, H, Sq) fp32 is the
    natural-log logsumexp of each row's scaled, masked scores — what the
    forward kernel writes for the backward."""
    s = _scores(q, k, causal=causal, scale=scale)
    return (attention_ref(q, k, v, causal=causal, scale=scale),
            torch.logsumexp(s, dim=-1))


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                      scale: Optional[float] = None):
    """The backward from the saved logsumexp, fp32, in ``attention_ref``'s
    layout: P = exp(scale q kᵀ - lse), dV = Pᵀ dO, dP = dO vᵀ, dS = P ∘
    (dP - rowsum(dO ∘ out)), dQ = scale dS k, dK = scale dSᵀ q; the G q
    heads of a kv head summed into its dK / dV.  Returns fp32 (dq, dk,
    dv)."""
    B, H, Sq, hd = q.shape
    _, K, Sk, _ = k.shape
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qf, of, dof = q.float(), out.float(), dout.float()
    kf = torch.repeat_interleave(k.float(), G, dim=1)
    vf = torch.repeat_interleave(v.float(), G, dim=1)
    p = torch.exp(_scores(q, k, causal=causal, scale=scale)
                  - lse.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - torch.sum(dof * of, dim=-1)[..., None])
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return (dq, dk.reshape(B, K, G, Sk, hd).sum(2),
            dv.reshape(B, K, G, Sk, v.shape[-1]).sum(2))
