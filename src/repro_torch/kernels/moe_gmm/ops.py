"""Dispatcher for the grouped (per-expert) matmul: the Hopper kernel for
CUDA tensors, the plain version for CPU tensors — the port of
``repro/kernels/moe_gmm/ops.py``.

The choice follows the DEVICE of the tensors it is given and nothing else:
a CPU tensor goes to ``ref.grouped_matmul_ref`` (the CPU tests), a CUDA
tensor launches ``csrc/grouped_matmul.cu`` or raises.  There is no
fallback from the kernel to the plain version.  ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref

#: kernel launches since the last reset (the plain CPU path does not count)
LAUNCHES = 0


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


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in ``x.dtype``, fp32
    accumulation."""
    global LAUNCHES
    if x.device.type == "cuda":
        refuse_grad("grouped_matmul", x, w)
        _check_cuda(x, w)
        out = torch.empty((x.shape[0], x.shape[1], w.shape[2]),
                          dtype=x.dtype, device=x.device)
        kernel.grouped_matmul_fwd(x, w, out)
        LAUNCHES += 1
        return out
    if x.device.type != "cpu" or w.device != x.device:
        raise ValueError(f"grouped_matmul: x on {x.device}, w on "
                         f"{w.device}")
    return grouped_matmul_ref(x, w)
