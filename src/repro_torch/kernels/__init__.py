"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each with the reference's kernel / ops / ref split."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise before a kernel launch that autograd would not see.

    The selective-scan kernel has no backward yet: a launch fills a fresh
    tensor that has no ``grad_fn``, so an input that requires grad would
    get no gradient through the kernel, silently.  Its dispatcher's CUDA
    branch calls this first (the flash kernel, the grouped matmul and
    WKV-6 have their backwards, ``attention.ops.FlashAttention``,
    ``moe_gmm.ops.GroupedMatmul`` and ``rwkv6.ops.WKV6``); the CPU branch
    runs the differentiable plain version.  ``None`` entries are
    skipped."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            f"backward yet (ROADMAP B8: the selective scan's comes when "
            f"jamba trains on the card); run it under torch.no_grad() or "
            f"on tensors that do not require grad")
