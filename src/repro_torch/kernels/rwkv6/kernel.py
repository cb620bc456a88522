"""Binding of the hand-written Hopper WKV-6 recurrence (``csrc/wkv6.cu``),
the port of the TPU kernel ``repro/kernels/rwkv6/kernel.py:wkv6_kernel``,
and of its backward (``csrc/wkv6_bwd.cu``, a library of its own: the
reference has no backward kernel, ``jax.grad`` differentiates its chunked
form ``repro/models/rwkv.py:_wkv_chunked``).

The CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes (pointers and the stream as
``c_void_p``).  The kernel reads the model layout (B, T, H, n) directly, so
nothing is transposed or padded here.

The source has two routes, chosen by T alone: the step recurrence below
``CHUNKED_MIN_T`` steps (the decode tick), the chunked closed form at or
above it, which needs a scratch buffer that this binding allocates.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "wkv6"
#: T at or above which the source takes the chunked route (its
#: ``CHUNKED_MIN_T``, checked when the library loads)
CHUNKED_MIN_T = 64
_C = ctypes.c_int
_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [_C] * 4 + [_P]
_CHUNKED_ARGTYPES = [_P] * 9 + [_C] * 4 + [_P]
BWD_NAME = "wkv6_bwd"
_BWD_ARGTYPES = [_P] * 15 + [_C] * 4 + [_P]

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        for fn, args in ((lib.repro_wkv6_fwd, _ARGTYPES),
                         (lib.repro_wkv6_fwd_chunked, _CHUNKED_ARGTYPES)):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_wkv6_scratch_bytes.argtypes = [_C] * 4
        lib.repro_wkv6_scratch_bytes.restype = ctypes.c_longlong
        lib.repro_wkv6_chunked_min_t.restype = ctypes.c_int
        if lib.repro_wkv6_chunked_min_t() != CHUNKED_MIN_T:
            raise RuntimeError("csrc/wkv6.cu's CHUNKED_MIN_T is not "
                               f"{CHUNKED_MIN_T}")
        _lib = lib
    return _lib


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, S0: torch.Tensor,
             y: torch.Tensor, S: torch.Tensor) -> None:
    """Launch the kernel on the current stream: r, k, v (B, T, H, n) bf16,
    logw (B, T, H, n) fp32, u (H, n) fp32, S0 (B, H, n, n) fp32 -> y
    (B, T, H, n) fp32 and S (B, H, n, n) fp32, which may be S0 itself.
    All contiguous on one CUDA device — the dispatcher (``ops.wkv6``)
    checks that.  At T >= ``CHUNKED_MIN_T`` the chunked route's scratch
    (each 64-step chunk's state increment, then its start state, and its
    decay: B x H x ceil(T / 64) x (n x n + n) fp32) comes from
    ``torch.empty`` on the same stream.  Raises if a launch is refused."""
    B, T, H, n = r.shape
    lib = library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), S0.data_ptr(), y.data_ptr(), S.data_ptr())
    if T >= CHUNKED_MIN_T:
        scratch = torch.empty(lib.repro_wkv6_scratch_bytes(B, T, H, n),
                              dtype=torch.uint8, device=r.device)
        err = lib.repro_wkv6_fwd_chunked(*ptrs, scratch.data_ptr(), B, T, H,
                                         n, stream)
    else:
        err = lib.repro_wkv6_fwd(*ptrs, B, T, H, n, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError_t {err}")


def bwd_library() -> ctypes.CDLL:
    """Build (first use only) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load(BWD_NAME)
        lib.repro_wkv6_bwd.argtypes = _BWD_ARGTYPES
        lib.repro_wkv6_bwd.restype = ctypes.c_int
        lib.repro_wkv6_bwd_scratch_bytes.argtypes = [_C] * 4
        lib.repro_wkv6_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.repro_wkv6_bwd_last_launch.argtypes = [_P]
        lib.repro_wkv6_bwd_last_launch.restype = None
        _bwd_lib = lib
    return _bwd_lib


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, S0: Optional[torch.Tensor],
             dy: torch.Tensor, dS: Optional[torch.Tensor], dr: torch.Tensor,
             dk: torch.Tensor, dv: torch.Tensor, dlogw: torch.Tensor,
             du: torch.Tensor, dS0: Optional[torch.Tensor]) -> None:
    """Launch the backward on the current stream: r, k, v (B, T, H, n)
    bf16, logw and dy (B, T, H, n) fp32, u (H, n) fp32, S0 and dS (B, H,
    n, n) fp32 or None (zeros) -> dr, dk, dv (B, T, H, n) bf16, dlogw
    (B, T, H, n) fp32, du (H, n) fp32 (summed over B) and dS0 (B, H, n, n)
    fp32, or None when it is not wanted.  All contiguous, 16-byte aligned,
    on one CUDA device — the dispatcher's backward (``ops.WKV6``) checks
    that.  The scratch (per (b, h) and 64-step chunk the chunk's start
    state and its end state's gradient, n x n fp32 each, its decay and
    du's part: B x H x ceil(T / 64) x (2 n^2 + 2 n) fp32) comes from
    ``torch.empty`` on the same stream.  Raises if a launch is refused."""
    B, T, H, n = r.shape
    lib = bwd_library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    scratch = torch.empty(lib.repro_wkv6_bwd_scratch_bytes(B, T, H, n),
                          dtype=torch.uint8, device=r.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), ptr(S0), dy.data_ptr(), ptr(dS), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
        ptr(dS0), scratch.data_ptr(), B, T, H, n, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward launch failed: cudaError_t {err}")


def last_bwd_launch() -> list:
    """The backward's last main pass (4 ints): threads a block, the chunk
    length, dynamic shared memory in bytes, blocks."""
    info = (ctypes.c_int * 4)()
    bwd_library().repro_wkv6_bwd_last_launch(info)
    return list(info)
