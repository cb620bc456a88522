"""Binding of the hand-written Hopper grouped matmul
(``csrc/grouped_matmul.cu``), the port of the TPU kernel
``repro/kernels/moe_gmm/kernel.py:grouped_matmul_kernel``, and of its
backward in the same library: dx = dy @ w^T and dw = x^T @ dy, two
instantiations of one kernel (128 x 256 tiles, 2-block clusters that
multicast a shared operand, a TMA-store epilogue).  The reference has no
backward kernel: ``jax.grad`` differentiates its einsum.

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
        for name in ("repro_grouped_matmul_bf16",
                     "repro_grouped_matmul_dx_bf16",
                     "repro_grouped_matmul_dw_bf16"):
            fn = getattr(lib, name)
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
    _launch("repro_grouped_matmul_bf16", x, w, out, E, C, D, w.shape[2])


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor,
                      dx: torch.Tensor) -> None:
    """Launch dx (E, C, D) = dy (E, C, F) @ w (E, D, F)^T on the current
    stream; bf16, contiguous, 16-byte aligned, one CUDA device (the
    dispatcher's backward checks it).  Raises if the launch is refused."""
    E, C, F = dy.shape
    _launch("repro_grouped_matmul_dx_bf16", dy, w, dx, E, C, w.shape[1], F)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor,
                      dw: torch.Tensor) -> None:
    """Launch dw (E, D, F) = x (E, C, D)^T @ dy (E, C, F) on the current
    stream, summed over the C rows in one fixed order (no split, no
    atomics); as ``grouped_matmul_dx`` otherwise."""
    E, C, D = x.shape
    _launch("repro_grouped_matmul_dw_bf16", x, dy, dw, E, C, D, dy.shape[2])


def last_launch() -> list:
    """The configuration of the library's last launch (6 ints): the
    forward's 16-row chunks or the backward's tile rows, ring stages,
    dynamic shared memory in bytes, blocks, tile columns, blocks a
    cluster."""
    fn = library().repro_grouped_matmul_last_launch
    fn.argtypes, fn.restype = [_P], None
    info = (_C * 6)()
    fn(info)
    return list(info)


def _launch(fn: str, a, b, out, E, C, D, F) -> None:
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(library(), fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 E, C, D, F, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")
