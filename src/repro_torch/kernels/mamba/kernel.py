"""Binding of the hand-written Hopper selective scan
(``csrc/selective_scan.cu``), the port of the TPU kernel
``repro/kernels/mamba/kernel.py:selective_scan_kernel``.

The CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes (pointers and the stream as
``c_void_p``).  The kernel reads the reference's layout (B, S, I, N)
directly and masks ragged S and I itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "selective_scan"
_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 6 + [_C] * 4 + [_P]

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.repro_selective_scan_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def selective_scan_fwd(dA: torch.Tensor, dBu: torch.Tensor, C: torch.Tensor,
                       h0: torch.Tensor, y: torch.Tensor,
                       h: torch.Tensor) -> None:
    """Launch the kernel on the current stream: dA, dBu (B, S, I, N), C
    (B, S, N), h0 (B, I, N), all fp32 -> y (B, S, I) fp32 and h (B, I, N)
    fp32, which may be h0 itself (the cache's ``ssm`` leaf, updated in
    place).  All contiguous on one CUDA device — the dispatcher
    (``ops.selective_scan``) checks that.  Raises if the launch is
    refused."""
    B, S, I, N = dA.shape
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    err = library().repro_selective_scan_fwd(
        dA.data_ptr(), dBu.data_ptr(), C.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), B, S, I, N, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError_t {err}")
