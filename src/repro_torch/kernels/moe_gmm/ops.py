"""Dispatcher for the grouped (per-expert) matmul: the Hopper kernel for
CUDA tensors, the plain version for CPU tensors — the port of
``repro/kernels/moe_gmm/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor goes to ``ref.grouped_matmul_ref`` (the CPU tests), a CUDA
tensor launches ``csrc/grouped_matmul.cu`` or raises.  There is no
fallback from the kernel to the plain version.  Under grad mode, with an
input that requires grad, the CUDA branch runs ``GroupedMatmul``: the
forward kernel, then in the backward the dx kernel for x and the dw
kernel for w.  ``LAUNCHES`` counts forward launches, ``DX_LAUNCHES`` and
``DW_LAUNCHES`` the two backward kernels' and ``BWD_LAUNCHES`` backward
calls, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cotangent
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref

#: forward kernel launches since the last reset (the plain CPU path does
#: not count)
LAUNCHES = 0
#: backward calls (each launches dx, dw or both)
BWD_LAUNCHES = 0
#: launches of the dx and of the dw kernel
DX_LAUNCHES = 0
DW_LAUNCHES = 0


def _check_cuda(x, w):
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"grouped_matmul kernel takes bfloat16, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul kernel takes contiguous "
                             f"tensors; {name} has strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if x.ndim != 3 or w.ndim != 3 or w.shape[:2] != (x.shape[0], x.shape[2]):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: "
                         f"want x (E, C, D), w (E, D, F)")
    E, C, D = x.shape
    F = w.shape[2]
    if D % 8 or F % 8:
        raise ValueError(f"grouped_matmul kernel takes D and F multiples "
                         f"of 8 (16-byte rows), got D={D} F={F}")
    if min(E, C, D, F) == 0 or E > 65535:
        raise ValueError(f"grouped_matmul kernel takes 1 <= E <= 65535 and "
                         f"non-empty C, D, F; got {(E, C, D, F)}")


def _forward(x, w):
    """One forward launch (checked inputs)."""
    global LAUNCHES
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    kernel.grouped_matmul_fwd(x, w, out)
    LAUNCHES += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """The forward kernel under autograd; the backward launches the dx
    kernel (dy @ w^T) for x and the dw kernel (x^T @ dy) for w, each only
    if its input needs a gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        global BWD_LAUNCHES, DX_LAUNCHES, DW_LAUNCHES
        x, w = ctx.saved_tensors
        dy = cotangent(dy)
        want = (x.shape[0], x.shape[1], w.shape[2])
        if dy.dtype != x.dtype or tuple(dy.shape) != want:
            raise ValueError(f"grouped_matmul backward: dy {dy.dtype}"
                             f"{tuple(dy.shape)}, want {x.dtype}{want}")
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty_like(x)
            kernel.grouped_matmul_dx(dy, w, dx)
            DX_LAUNCHES += 1
        if ctx.needs_input_grad[1]:
            dw = torch.empty_like(w)
            kernel.grouped_matmul_dw(x, dy, dw)
            DW_LAUNCHES += 1
        BWD_LAUNCHES += 1
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in ``x.dtype``, fp32
    accumulation."""
    if x.device.type == "cuda":
        _check_cuda(x, w)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return GroupedMatmul.apply(x, w)
        return _forward(x, w)
    if x.device.type != "cpu" or w.device != x.device:
        raise ValueError(f"grouped_matmul: x on {x.device}, w on "
                         f"{w.device}")
    return grouped_matmul_ref(x, w)
