"""Binding of the hand-written Hopper selective scan
(``csrc/selective_scan.cu``), the port of the TPU kernel
``repro/kernels/mamba/kernel.py:selective_scan_kernel``, and of its
backward (``csrc/selective_scan_bwd.cu``, a library of its own: the
reference has no backward kernel, ``jax.grad`` differentiates its chunk
solver ``repro/models/mamba.py:_chunk_scan``).

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
BWD_NAME = "selective_scan_bwd"
_BWD_ARGTYPES = [_P] * 11 + [_C] * 4 + [_P]

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


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


def bwd_library() -> ctypes.CDLL:
    """Build (first use only) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load(BWD_NAME)
        lib.repro_selective_scan_bwd.argtypes = _BWD_ARGTYPES
        lib.repro_selective_scan_bwd.restype = ctypes.c_int
        lib.repro_selective_scan_bwd_part_floats.argtypes = [_C] * 4
        lib.repro_selective_scan_bwd_part_floats.restype = ctypes.c_longlong
        lib.repro_selective_scan_bwd_last_launch.argtypes = [_P]
        lib.repro_selective_scan_bwd_last_launch.restype = None
        _bwd_lib = lib
    return _bwd_lib


def selective_scan_bwd(dA: torch.Tensor, dBu: torch.Tensor, C: torch.Tensor,
                       h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dh: Optional[torch.Tensor], ddA: torch.Tensor,
                       ddBu: torch.Tensor, dC: torch.Tensor,
                       dh0: Optional[torch.Tensor]) -> None:
    """Launch the backward on the current stream: dA, dBu (B, S, I, N), C
    (B, S, N), h0 (B, I, N) or None (zeros), dy (B, S, I), dh (B, I, N) or
    None (zeros), all fp32 -> d(dA), d(dBu) (B, S, I, N), dC (B, S, N) and
    dh0 (B, I, N), or None when it is not wanted.  All contiguous, 16-byte
    aligned, on one CUDA device — the dispatcher's backward
    (``ops.SelectiveScan``) sees to that.  dC's per-block parts come from
    ``torch.empty`` on the same stream.  Raises if a launch is refused."""
    B, S, I, N = dA.shape
    lib = bwd_library()
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    part = torch.empty(lib.repro_selective_scan_bwd_part_floats(B, S, I, N),
                       dtype=torch.float32, device=dA.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.repro_selective_scan_bwd(
        dA.data_ptr(), dBu.data_ptr(), C.data_ptr(), ptr(h0), dy.data_ptr(),
        ptr(dh), ddA.data_ptr(), ddBu.data_ptr(), dC.data_ptr(), ptr(dh0),
        part.data_ptr(), B, S, I, N, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan backward launch failed: "
                           f"cudaError_t {err}")


def last_bwd_launch() -> list:
    """The backward's last launch (4 ints): threads a block, steps a
    segment, dynamic shared memory in bytes, blocks."""
    info = (ctypes.c_int * 4)()
    bwd_library().repro_selective_scan_bwd_last_launch(info)
    return list(info)
