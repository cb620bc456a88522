"""Dispatcher: model layout in and out, the Hopper kernel for CUDA tensors,
the plain version for CPU tensors — the port of
``repro/kernels/attention/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor goes to ``ref.attention_ref`` (the CPU tests), a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises.  There is no fallback from
the kernel to the plain version.  Under grad mode, with an input that
requires grad, the CUDA branch runs ``FlashAttention``: the forward kernel
also writes the logsumexp, and the backward launches
``csrc/flash_attention_bwd.cu``.  ``LAUNCHES`` counts forward launches and
``BWD_LAUNCHES`` backward ones, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import (attention_bwd_ref,
                                               attention_ref,
                                               attention_ref_lse)

#: forward kernel launches since the last reset (the plain CPU path does
#: not count)
LAUNCHES = 0
#: backward launches (one per backward: its two kernels, one C call)
BWD_LAUNCHES = 0
#: the (hd, hd_v) pairs the backward kernel takes: hd == hd_v at 32 (the
#: durable-training example's model, on the 64-wide tiles), 64 and 128, and
#: MLA's (deepseek-v2: q / k nope 128 + rope 64, v 128)
BWD_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))


def _check_cuda(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bfloat16, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel takes contiguous "
                             f"tensors; {name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    B, S, K, G, hd = q.shape
    if (k.ndim != 4 or v.ndim != 4 or k.shape[0] != B or k.shape[2] != K
            or k.shape[3] != hd or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want q (B,S,K,G,hd), "
                         f"k (B,T,K,hd), v (B,T,K,hd_v)")
    hd_v = v.shape[3]
    for name, d in (("hd", hd), ("hd_v", hd_v)):
        if d % 8 or not 8 <= d <= 256:
            raise ValueError(f"flash_attention kernel takes {name} a "
                             f"multiple of 8 in [8, 256], got {d}")
    if S == 0 or k.shape[1] == 0 or B == 0:
        raise ValueError("flash_attention kernel takes non-empty sequences")


def _forward(q, k, v, *, causal: bool, scale: float, with_lse: bool):
    """One forward launch (checked inputs): ``(out, lse or None)``."""
    global LAUNCHES
    B, S, K, G, _ = q.shape
    out = torch.empty((B, S, K, G, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    lse = (torch.empty((B, K * G, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel.flash_attention_fwd(q, k, v, out, causal=causal, scale=scale,
                               lse=lse)
    LAUNCHES += 1
    return out, lse


def _check_bwd(q, k, v):
    hd, hd_v = q.shape[-1], v.shape[-1]
    if (hd, hd_v) not in BWD_HEAD_DIMS:
        raise ValueError(
            f"flash_attention backward kernel takes (hd, hd_v) in "
            f"{BWD_HEAD_DIMS}, got ({hd}, {hd_v})")


class FlashAttention(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel writes the
    output and the logsumexp, and the backward kernel computes dq, dk, dv
    from them (``csrc/flash_attention_bwd.cu``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = _forward(q, k, v, causal=causal, scale=scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        global BWD_LAUNCHES
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.dtype != out.dtype or dout.shape != out.shape:
            raise ValueError(f"flash_attention backward: dout "
                             f"{dout.dtype}{tuple(dout.shape)}, out "
                             f"{out.dtype}{tuple(out.shape)}")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        kernel.flash_attention_bwd(q, k, v, out, lse, dout, dq, dk, dv,
                                   causal=ctx.causal, scale=ctx.scale)
        BWD_LAUNCHES += 1
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B, S, K, G, hd); k/v: (B, T, K, hd[/v]) -> (B, S, K, G, hd_v)."""
    B, S, K, G, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        _check_cuda(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            _check_bwd(q, k, v)
            return FlashAttention.apply(q, k, v, causal, scale)
        return _forward(q, k, v, causal=causal, scale=scale,
                        with_lse=False)[0]
    if q.device.type != "cpu" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    return plain_attention(q, k, v, causal=causal, scale=scale)


def plain_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """The plain version in the model layout (any device): what the
    dispatcher runs for CPU tensors, and what ``chip_smoke.py`` holds the
    kernel against on the card."""
    B, S, K, G, _ = q.shape
    oh = attention_ref(*_heads(q, k, v), causal=causal, scale=scale)
    return oh.reshape(B, K, G, S, v.shape[-1]).permute(0, 3, 1, 2, 4)


def _heads(q, k, v):
    """Model layout -> ``attention_ref``'s: (B, K*G, S, hd), (B, K, T, hd)."""
    B, S, K, G, hd = q.shape
    return (q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


def plain_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``(plain_attention(...), lse (B, K*G, S) fp32)`` in the model
    layout: what the forward kernel writes under autograd."""
    B, S, K, G, _ = q.shape
    out, lse = attention_ref_lse(*_heads(q, k, v), causal=causal,
                                 scale=scale)
    return (out.reshape(B, K, G, S, v.shape[-1]).permute(0, 3, 1, 2, 4),
            lse)


def plain_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: Optional[float] = None):
    """``ref.attention_bwd_ref`` in the model layout: fp32 (dq (B,S,K,G,hd),
    dk, dv (B,T,K,hd)) — what ``chip_smoke.py`` holds the backward kernel
    against."""
    B, S, K, G, hd = q.shape
    qh, kh, vh = _heads(q, k, v)
    oh = _heads(out, k, v)[0]
    doh = _heads(dout, k, v)[0]
    dq, dk, dv = attention_bwd_ref(qh, kh, vh, oh, lse, doh, causal=causal,
                                   scale=scale)
    return (dq.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))
