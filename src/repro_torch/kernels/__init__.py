"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each with the reference's kernel / ops / ref split."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a kernel launch that autograd would not see.

    The WKV-6 and selective-scan kernels have no backward yet: a launch
    fills a fresh tensor that has no ``grad_fn``, so an input that
    requires grad would get no gradient through the kernel, silently.
    Both dispatchers' CUDA branches call this first (the flash kernel and
    the grouped matmul have their backwards, ``attention.ops.
    FlashAttention`` and ``moe_gmm.ops.GroupedMatmul``); the CPU branches
    run the differentiable plain versions.  ``None`` entries are
    skipped."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            f"backward yet (ROADMAP A2: it comes when its architecture "
            f"trains on the card); run it under torch.no_grad() or on "
            f"tensors that do not require grad")
