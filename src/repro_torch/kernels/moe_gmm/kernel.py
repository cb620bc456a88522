"""Binding of the hand-written Hopper grouped matmul
(``csrc/grouped_matmul.cu``), the port of the TPU kernel
``repro/kernels/moe_gmm/kernel.py:grouped_matmul_kernel``.

The CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes (pointers and the stream as
``c_void_p``).  The kernel masks ragged C / D / F itself, so nothing is
padded here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "grouped_matmul"
_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 3 + [_C] * 4 + [_P]

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.repro_grouped_matmul_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def grouped_matmul_fwd(x: torch.Tensor, w: torch.Tensor,
                       out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: x (E, C, D) @ w (E, D, F)
    -> out (E, C, F), bf16, contiguous, on one CUDA device — the
    dispatcher (``ops.grouped_matmul``) checks all of that.  Raises if the
    launch is refused."""
    E, C, D = x.shape
    F = w.shape[2]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().repro_grouped_matmul_bf16(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError_t {err}")
