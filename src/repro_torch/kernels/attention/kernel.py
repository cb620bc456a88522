"""Binding of the hand-written Hopper flash-attention forward
(``csrc/flash_attention.cu``), the port of the TPU kernel
``repro/kernels/attention/kernel.py:flash_attention_kernel``.

The CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes.  Every pointer and the stream go
over as ``c_void_p`` (a plain int would cut a 64-bit pointer), strides as
``c_longlong``.  The kernel works directly on the model layout through
strides — q (B, S, K, G, hd), k / v (B, T, K, hd[_v]), o (B, S, K, G,
hd_v) — so the dispatcher needs no transposes on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
_C = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 4 + [_C] * 7 + [_L] * 12
             + [ctypes.c_float, _C, _P])

_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.repro_flash_attention_fwd_bf16
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, *, causal: bool,
                        scale: float) -> None:
    """Launch the kernel on the current stream.  q (B,S,K,G,hd), k
    (B,T,K,hd), v (B,T,K,hd_v), out (B,S,K,G,hd_v): bf16, contiguous, on
    one CUDA device — the dispatcher (``ops.flash_attention``) checks all
    of that.  Raises if the launch is refused."""
    B, S, K, G, hd = q.shape
    T, hd_v = k.shape[1], v.shape[-1]
    strides = []
    for t in (q, k, v, out):
        # (batch, head, sequence) strides in elements; the head stride of
        # q / out walks the flattened (K, G) axes, of k / v the K axis
        if t.ndim == 5:
            strides += [t.stride(0), t.stride(3), t.stride(1)]
        else:
            strides += [t.stride(0), t.stride(2), t.stride(1)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().repro_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, K * G, K, S, T, hd, hd_v, *strides, float(scale), int(causal),
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
