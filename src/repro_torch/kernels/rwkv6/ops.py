"""Dispatcher for the RWKV-6 WKV recurrence: the Hopper kernel for CUDA
tensors, the plain version for CPU tensors — the port of
``repro/kernels/rwkv6/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor runs the plain version the reference model runs (the chunked
closed form for T > 1, the direct recurrence for T = 1), a CUDA tensor
launches ``csrc/wkv6.cu`` or raises.  There is no fallback from the kernel
to the plain version.  Under grad mode, with an input that requires grad,
the CUDA branch runs ``WKV6``: the forward kernel, then in the backward
``csrc/wkv6_bwd.cu``.  ``LAUNCHES`` counts forward launches and
``BWD_LAUNCHES`` backward ones, so a run can show that its path went
through the kernels.

Unlike the reference's wrapper, y comes back in fp32: the model feeds it
to the group norm unrounded, as the reference model's own chunked form
does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cotangent
from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_ref

#: forward kernel launches since the last reset (the plain CPU path does
#: not count)
LAUNCHES = 0
#: backward kernel launches (one a backward call)
BWD_LAUNCHES = 0
HEAD_SIZES = (16, 32, 64)


def _span(t: torch.Tensor):
    lo = t.data_ptr()
    return lo, lo + t.numel() * t.element_size()


def _check_cuda(r, k, v, logw, u, S0, state_out):
    want = {"r": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16,
            "logw": torch.float32, "u": torch.float32, "S0": torch.float32,
            "state_out": torch.float32}
    given = {"r": r, "k": k, "v": v, "logw": logw, "u": u, "S0": S0,
             "state_out": state_out}
    for name, t in given.items():
        if t is None:
            continue
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if t.dtype != want[name]:
            raise TypeError(f"wkv6 kernel takes {name} as {want[name]}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel takes contiguous tensors; {name} "
                             f"has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if r.ndim != 4:
        raise ValueError(f"r {tuple(r.shape)}: want (B, T, H, n)")
    B, T, H, n = r.shape
    for name in ("k", "v", "logw"):
        if given[name].shape != r.shape:
            raise ValueError(f"{name} {tuple(given[name].shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, n):
        raise ValueError(f"u {tuple(u.shape)}: want {(H, n)}")
    for name in ("S0", "state_out"):
        t = given[name]
        if t is not None and t.shape != (B, H, n, n):
            raise ValueError(f"{name} {tuple(t.shape)}: want {(B, H, n, n)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes head sizes {HEAD_SIZES}, "
                         f"got {n}")
    if min(B, T, H) < 1 or B > 65535 or H > 65535:
        raise ValueError(f"wkv6 kernel takes 1 <= B, H <= 65535 and T >= 1; "
                         f"got B={B} T={T} H={H}")
    if S0 is not None and state_out is not None \
            and state_out.data_ptr() != S0.data_ptr():
        (a0, a1), (b0, b1) = _span(S0), _span(state_out)
        if a0 < b1 and b0 < a1:
            raise ValueError("state_out overlaps S0 without being S0")


def _forward(r, k, v, logw, u, S0, state_out):
    """One forward launch (checked inputs)."""
    global LAUNCHES
    B, T, H, n = r.shape
    if S0 is None:
        S0 = torch.zeros((B, H, n, n), dtype=torch.float32, device=r.device)
    S = state_out if state_out is not None else torch.empty_like(S0)
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    kernel.wkv6_fwd(r, k, v, logw, u, S0, y, S)
    LAUNCHES += 1
    return y, S


class WKV6(torch.autograd.Function):
    """The forward kernel under autograd; the backward launches
    ``csrc/wkv6_bwd.cu`` once for all six gradients.  ``S0`` None is a
    zero state (no gradient).  The cotangent of the final state may be
    None (training never reads it): then the kernel takes it as zero."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, S0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, S0)
        return _forward(r, k, v, logw, u, S0, None)

    @staticmethod
    def backward(ctx, dy, dS):
        global BWD_LAUNCHES
        r, k, v, logw, u, S0 = ctx.saved_tensors
        dy = cotangent(dy)
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dS = cotangent(dS)
        dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
        dlogw = torch.empty_like(logw)
        du = torch.empty_like(u)
        dS0 = (torch.empty_like(S0) if S0 is not None
               and ctx.needs_input_grad[5] else None)
        kernel.wkv6_bwd(r, k, v, logw, u, S0, dy, dS, dr, dk, dv, dlogw, du,
                        dS0)
        BWD_LAUNCHES += 1
        need = ctx.needs_input_grad
        return tuple(g if need[i] else None
                     for i, g in enumerate((dr, dk, dv, dlogw, du, dS0)))


def wkv6(r, k, v, logw, u, S0: Optional[torch.Tensor] = None, *,
         chunk: int = 256, state_out: Optional[torch.Tensor] = None):
    """RWKV-6 WKV.  r / k / v / logw: (B, T, H, n); u: (H, n); S0: (B, H,
    n, n) fp32 or None (zeros).  Returns y (B, T, H, n) fp32 and the final
    state (B, H, n, n) fp32.  ``state_out``, if given, receives the state
    and is returned; it may be ``S0`` itself (the serving cache, updated in
    place); under grad, on the card, it raises ``ValueError``.  ``chunk``
    is the plain chunked form's Q (the CPU path only)."""
    if r.device.type == "cuda":
        _check_cuda(r, k, v, logw, u, S0, state_out)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (r, k, v, logw, u, S0)):
            if state_out is not None:
                raise ValueError("wkv6: state_out writes the state in place, "
                                 "which autograd cannot see; pass no "
                                 "state_out under grad")
            return WKV6.apply(r, k, v, logw, u, S0)
        return _forward(r, k, v, logw, u, S0, state_out)
    for name, t in (("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("S0", S0), ("state_out", state_out)):
        if t is not None and t.device != r.device:
            raise ValueError(f"wkv6: {name} on {t.device}, r on {r.device}")
    if r.device.type != "cpu":
        raise ValueError(f"wkv6: tensors on {r.device}")
    y, S = plain_wkv6(r, k, v, logw, u, S0, chunk=chunk)
    if state_out is not None:
        state_out.copy_(S)
        S = state_out
    return y, S


def plain_wkv6(r, k, v, logw, u, S0=None, *, chunk: int = 256):
    """The plain version (any device): what the dispatcher runs for CPU
    tensors, and what ``chip_smoke.py`` times beside the kernel."""
    if r.shape[1] == 1:
        return wkv6_ref(r, k, v, logw, u, S0)
    return wkv6_chunked(r, k, v, logw, u, S0, chunk=chunk)
