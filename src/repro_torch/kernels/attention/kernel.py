"""Bindings of the hand-written Hopper flash attention: the forward
(``csrc/flash_attention.cu``), the port of the TPU kernel
``repro/kernels/attention/kernel.py:flash_attention_kernel``, and its
backward (``csrc/flash_attention_bwd.cu``), which training needs (the JAX
package differentiates its plain attention instead).

Each CUDA source has a plain C interface; it is compiled at first use by
``kernels.build`` and loaded with ctypes.  Every pointer and the stream go
over as ``c_void_p`` (a plain int would cut a 64-bit pointer), strides as
``c_longlong``.  The kernel works directly on the model layout through
strides — q (B, S, K, G, hd), k / v (B, T, K, hd[_v]), o (B, S, K, G,
hd_v) — so the dispatcher needs no transposes on the card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
_C = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 5 + [_C] * 7 + [_L] * 12
             + [ctypes.c_float, _C, _P])
_BWD_ARGTYPES = [_P] * 10 + [_C] * 7 + [_L] * 12 + [ctypes.c_float, _C, _P]

_libs: Dict[str, ctypes.CDLL] = {}


def _load(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    """Build (first use only) and load a kernel library."""
    if name not in _libs:
        lib = build.load(name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def library() -> ctypes.CDLL:
    return _load(NAME, "repro_flash_attention_fwd_bf16", _ARGTYPES)


def bwd_library() -> ctypes.CDLL:
    return _load(BWD_NAME, "repro_flash_attention_bwd_bf16", _BWD_ARGTYPES)


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _bhs(t: torch.Tensor) -> list:
    """(batch, head, sequence) strides in elements: the head stride of a
    (B, S, K, G, d) tensor walks the flattened (K, G) axes, of a
    (B, T, K, d) tensor the K axis."""
    if t.ndim == 5:
        return [t.stride(0), t.stride(3), t.stride(1)]
    return [t.stride(0), t.stride(2), t.stride(1)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, *, causal: bool, scale: float,
                        lse: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on the current stream.  q (B,S,K,G,hd), k
    (B,T,K,hd), v (B,T,K,hd_v), out (B,S,K,G,hd_v): bf16, contiguous, on
    one CUDA device — the dispatcher (``ops.flash_attention``) checks all
    of that.  ``lse``, if given, is a contiguous fp32 (B, K*G, S) that the
    kernel fills with each row's natural-log logsumexp (for the backward).
    Raises if the launch is refused."""
    B, S, K, G, hd = q.shape
    T, hd_v = k.shape[1], v.shape[-1]
    strides = _bhs(q) + _bhs(k) + _bhs(v) + _bhs(out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().repro_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, K * G, K, S, T, hd, hd_v, *strides, float(scale), int(causal),
        stream)
    _check(err, "flash_attention")


def bwd_scratch_floats(B: int, H: int, S: int) -> int:
    """fp32 elements of the backward's scratch: 128 a 64-row q tile of each
    (batch, q head) — the tile's lse in the log2 domain, then its delta."""
    return B * H * -(-S // 64) * 128


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, dq: torch.Tensor,
                        dk: torch.Tensor, dv: torch.Tensor, *, causal: bool,
                        scale: float) -> None:
    """Launch the backward's two kernels on the current stream: dq (which
    also writes each q row's delta = rowsum(dout * out) and lse in the log2
    domain into an fp32 scratch), then dk / dv.  q, dq (B,S,K,G,hd), out,
    dout (B,S,K,G,hd_v), k, dk (B,T,K,hd) and v, dv (B,T,K,hd_v): bf16,
    contiguous, (hd, hd_v) one of ``ops.BWD_HEAD_DIMS``; lse fp32 (B, K*G,
    S) from the forward — ``ops.FlashAttention`` checks all of that.  Each
    gradient takes the strides of its tensor.  Raises if a launch is
    refused."""
    B, S, K, G, hd = q.shape
    T, hd_v = k.shape[1], v.shape[-1]
    for g, t in ((dq, q), (dk, k), (dv, v), (dout, out)):
        if g.shape != t.shape or g.stride() != t.stride():
            raise ValueError(f"flash_attention_bwd: {tuple(g.shape)} "
                             f"strides {g.stride()} beside "
                             f"{tuple(t.shape)} strides {t.stride()}")
    rows = torch.empty(bwd_scratch_floats(B, K * G, S), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = bwd_library().repro_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), rows.data_ptr(), B, K * G, K, S, T, hd, hd_v,
        *_bhs(q), *_bhs(k), *_bhs(v), *_bhs(out), float(scale),
        int(causal), stream)
    _check(err, "flash_attention_bwd")
