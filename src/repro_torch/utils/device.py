"""Device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``).  Asking for the
card on a machine without one RAISES — the port never carries on on the
CPU behind the caller's back.  Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but torch sees no CUDA "
            f"device (torch {torch.__version__}); pass device='cpu' to run "
            f"the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev
