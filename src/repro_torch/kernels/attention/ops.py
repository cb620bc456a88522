"""Dispatcher: model layout in and out, the Hopper kernel for CUDA tensors,
the plain version for CPU tensors — the port of
``repro/kernels/attention/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor goes to ``ref.attention_ref`` (the CPU tests), a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises.  There is no fallback from
the kernel to the plain version.  ``LAUNCHES`` counts kernel launches, so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.attention import kernel
from repro_torch.kernels.attention.ref import attention_ref

#: kernel launches since the last reset (the plain CPU path does not count)
LAUNCHES = 0


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


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B, S, K, G, hd); k/v: (B, T, K, hd[/v]) -> (B, S, K, G, hd_v)."""
    global LAUNCHES
    B, S, K, G, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        refuse_grad("flash_attention", q, k, v)
        _check_cuda(q, k, v)
        out = torch.empty((B, S, K, G, v.shape[-1]), dtype=q.dtype,
                          device=q.device)
        kernel.flash_attention_fwd(q, k, v, out, causal=causal, scale=scale)
        LAUNCHES += 1
        return out
    if q.device.type != "cpu" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    return plain_attention(q, k, v, causal=causal, scale=scale)


def plain_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """The plain version in the model layout (any device): what the
    dispatcher runs for CPU tensors, and what ``chip_smoke.py`` holds the
    kernel against on the card."""
    B, S, K, G, hd = q.shape
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd)
    kh = k.permute(0, 2, 1, 3)                        # (B, K, T, hd)
    vh = v.permute(0, 2, 1, 3)
    oh = attention_ref(qh, kh, vh, causal=causal, scale=scale)
    return oh.reshape(B, K, G, S, vh.shape[-1]).permute(0, 3, 1, 2, 4)
