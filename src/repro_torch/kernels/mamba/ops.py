"""Dispatcher for the Mamba (S6) selective scan: the Hopper kernel for
CUDA tensors, the plain version for CPU tensors — the port of
``repro/kernels/mamba/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor runs the plain step recurrence (``ref.selective_scan_ref``),
a CUDA tensor launches ``csrc/selective_scan.cu`` or raises.  There is no
fallback from the kernel to the plain version.  Under grad mode, with an
input that requires grad, the CUDA branch runs ``SelectiveScan``: the
forward kernel, then in the backward ``csrc/selective_scan_bwd.cu``.
``LAUNCHES`` counts forward launches and ``BWD_LAUNCHES`` backward ones, so
a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cotangent
from repro_torch.kernels.mamba import kernel
from repro_torch.kernels.mamba.ref import selective_scan_ref

#: forward kernel launches since the last reset (the plain CPU path does
#: not count)
LAUNCHES = 0
#: backward kernel launches (one a backward call)
BWD_LAUNCHES = 0
MAX_STATE = 64


def _span(t: torch.Tensor):
    lo = t.data_ptr()
    return lo, lo + t.numel() * t.element_size()


def _check_cuda(dA, dBu, C, h0, h_out):
    given = {"dA": dA, "dBu": dBu, "C": C, "h0": h0, "h_out": h_out}
    for name, t in given.items():
        if t is None:
            continue
        if t.device != dA.device:
            raise ValueError(f"{name} on {t.device}, dA on {dA.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan kernel takes float32, {name} "
                            f"is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan kernel takes contiguous "
                             f"tensors; {name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if dA.ndim != 4:
        raise ValueError(f"dA {tuple(dA.shape)}: want (B, S, I, N)")
    B, S, I, N = dA.shape
    if dBu.shape != dA.shape:
        raise ValueError(f"dBu {tuple(dBu.shape)} != dA {tuple(dA.shape)}")
    if C.shape != (B, S, N):
        raise ValueError(f"C {tuple(C.shape)}: want {(B, S, N)}")
    for name in ("h0", "h_out"):
        t = given[name]
        if t is not None and t.shape != (B, I, N):
            raise ValueError(f"{name} {tuple(t.shape)}: want {(B, I, N)}")
    if not 1 <= N <= MAX_STATE or min(B, S, I) < 1 or B > 65535:
        raise ValueError(f"selective_scan kernel takes 1 <= N <= "
                         f"{MAX_STATE}, 1 <= B <= 65535, S, I >= 1; got "
                         f"B={B} S={S} I={I} N={N}")
    if h0 is not None and h_out is not None \
            and h_out.data_ptr() != h0.data_ptr():
        (a0, a1), (b0, b1) = _span(h0), _span(h_out)
        if a0 < b1 and b0 < a1:
            raise ValueError("h_out overlaps h0 without being h0")


def _forward(dA, dBu, C, h0, h_out):
    """One forward launch (checked inputs)."""
    global LAUNCHES
    B, S, I, N = dA.shape
    if h0 is None:
        h0 = torch.zeros((B, I, N), dtype=torch.float32, device=dA.device)
    h = h_out if h_out is not None else torch.empty_like(h0)
    y = torch.empty((B, S, I), dtype=torch.float32, device=dA.device)
    kernel.selective_scan_fwd(dA, dBu, C, h0, y, h)
    LAUNCHES += 1
    return y, h


class SelectiveScan(torch.autograd.Function):
    """The forward kernel under autograd; the backward launches
    ``csrc/selective_scan_bwd.cu`` once for all four gradients.  ``h0``
    None is a zero state (no gradient).  The cotangent of the final h may
    be None (a chunk whose h nothing reads): then the kernel takes it as
    zero."""

    @staticmethod
    def forward(ctx, dA, dBu, C, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dA, dBu, C, h0)
        return _forward(dA, dBu, C, h0, None)

    @staticmethod
    def backward(ctx, dy, dh):
        global BWD_LAUNCHES
        dA, dBu, C, h0 = ctx.saved_tensors
        B, S, I, _ = dA.shape
        dy = cotangent(dy)
        if dy is None:
            dy = torch.zeros((B, S, I), dtype=torch.float32, device=dA.device)
        dh = cotangent(dh)
        ddA, ddBu, dC = (torch.empty_like(t) for t in (dA, dBu, C))
        dh0 = (torch.empty_like(h0) if h0 is not None
               and ctx.needs_input_grad[3] else None)
        kernel.selective_scan_bwd(dA, dBu, C, h0, dy, dh, ddA, ddBu, dC, dh0)
        BWD_LAUNCHES += 1
        need = ctx.needs_input_grad
        return tuple(g if need[i] else None
                     for i, g in enumerate((ddA, ddBu, dC, dh0)))


def selective_scan(dA, dBu, C, h0: Optional[torch.Tensor] = None, *,
                   h_out: Optional[torch.Tensor] = None):
    """S6 scan.  dA, dBu: (B, S, I, N); C: (B, S, N); h0: (B, I, N) or None
    (zeros).  Returns y (B, S, I) fp32 and the final h (B, I, N) fp32.
    ``h_out``, if given, receives h and is returned; it may be ``h0``
    itself (the serving cache, updated in place); under grad, on the card,
    it raises ``ValueError``."""
    if dA.device.type == "cuda":
        _check_cuda(dA, dBu, C, h0, h_out)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (dA, dBu, C, h0)):
            if h_out is not None:
                raise ValueError("selective_scan: h_out writes h in place, "
                                 "which autograd cannot see; pass no h_out "
                                 "under grad")
            return SelectiveScan.apply(dA, dBu, C, h0)
        return _forward(dA, dBu, C, h0, h_out)
    for name, t in (("dBu", dBu), ("C", C), ("h0", h0), ("h_out", h_out)):
        if t is not None and t.device != dA.device:
            raise ValueError(f"selective_scan: {name} on {t.device}, dA on "
                             f"{dA.device}")
    if dA.device.type != "cpu":
        raise ValueError(f"selective_scan: tensors on {dA.device}")
    y, h = selective_scan_ref(dA, dBu, C, h0)
    if h_out is not None:
        h_out.copy_(h)
        h = h_out
    return y, h
