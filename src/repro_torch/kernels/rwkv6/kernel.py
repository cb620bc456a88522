"""Binding of the hand-written Hopper WKV-6 recurrence (``csrc/wkv6.cu``),
the port of the TPU kernel ``repro/kernels/rwkv6/kernel.py:wkv6_kernel``.

The CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes (pointers and the stream as
``c_void_p``).  The kernel reads the model layout (B, T, H, n) directly, so
nothing is transposed or padded here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "wkv6"
_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [_C] * 4 + [_P]

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.repro_wkv6_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, S0: torch.Tensor,
             y: torch.Tensor, S: torch.Tensor) -> None:
    """Launch the kernel on the current stream: r, k, v (B, T, H, n) bf16,
    logw (B, T, H, n) fp32, u (H, n) fp32, S0 (B, H, n, n) fp32 -> y
    (B, T, H, n) fp32 and S (B, H, n, n) fp32, which may be S0 itself.
    All contiguous on one CUDA device — the dispatcher (``ops.wkv6``)
    checks that.  Raises if the launch is refused."""
    B, T, H, n = r.shape
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = library().repro_wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), S0.data_ptr(), y.data_ptr(), S.data_ptr(),
        B, T, H, n, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError_t {err}")
