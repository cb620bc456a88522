"""Plain PyTorch version of flash attention (dense softmax, fp32) — the
port of ``repro/kernels/attention/ref.py``.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None):
    """q: (B, H, Sq, hd); k/v: (B, K, Sk, hd[/v]) with K | H. fp32 math;
    causal masking is top-left aligned (q and kv positions start at 0)."""
    B, H, Sq, hd = q.shape
    _, K, Sk, _ = k.shape
    group = H // K
    qf = q.float() * (hd ** -0.5 if scale is None else scale)
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-20)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
