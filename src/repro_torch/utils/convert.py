"""numpy <-> torch conversion, bfloat16 included, without ``ml_dtypes``.

numpy has no bfloat16 of its own; the JAX package gets one from
``ml_dtypes``, which the machine with the card does not have.  The port
therefore moves 16-bit floats through 16-bit INTEGER views: a torch
bfloat16 tensor is ``view(torch.int16)`` -> numpy ``int16``/``uint16``
(same bytes), and back.  The dtype TOKEN (``"bfloat16"``) travels beside
the bytes, exactly as the reference's ``.cxl0`` frame header records it.

Arrays carried over from the JAX package arrive as ``ml_dtypes`` arrays;
they are recognised by ``a.dtype.name == "bfloat16"`` (no import needed)
and reinterpreted with ``a.view(np.uint16)``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

#: frame dtype token <-> torch dtype.  Tokens are numpy's ``str(dtype)``
#: (``ml_dtypes`` names for the types numpy lacks), as the reference writes.
TOKEN_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint32": torch.uint32,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
TORCH_TO_TOKEN = {v: k for k, v in TOKEN_TO_TORCH.items()}

#: dtypes numpy cannot hold natively -> the same-width integer view
_RAW_VIEW = {torch.bfloat16: (torch.int16, np.uint16),
             torch.float8_e4m3fn: (torch.uint8, np.uint8),
             torch.float8_e5m2: (torch.uint8, np.uint8)}


def dtype_token(x: Any) -> str:
    """The frame dtype token of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return TORCH_TO_TOKEN[x.dtype]
    return str(np.asarray(x).dtype)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``."""
    if isinstance(name, torch.dtype):
        return name
    return TOKEN_TO_TORCH[str(name)]


def raw_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """``(C-contiguous numpy array with the leaf's exact bytes, token)``
    for a CPU tensor or a numpy array (ml_dtypes bfloat16 included).  No
    copy when the input is already contiguous."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("raw_numpy needs a host tensor; copy it with "
                             ".cpu() first (and count the D2H)")
        tok = TORCH_TO_TOKEN[x.dtype]
        t = x.detach().contiguous()
        view = _RAW_VIEW.get(t.dtype)
        if view is not None:
            return t.view(view[0]).numpy().view(view[1]), tok
        return t.numpy(), tok
    a = np.asarray(x)
    if not a.flags.c_contiguous:      # (ascontiguousarray would make a
        a = np.ascontiguousarray(a)   # 0-d array 1-d)
    tok = str(a.dtype)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), tok
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8), tok
    return a, tok


def from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 included) -> torch tensor on
    ``device``.  Copies, so the result never aliases the caller's array."""
    a = np.array(a, copy=True, order="C")
    name = a.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif name.startswith("float8"):
        t = torch.from_numpy(a.view(np.uint8)).view(TOKEN_TO_TORCH[name])
    else:
        t = torch.from_numpy(a)
    return t.to(device)
