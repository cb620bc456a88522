"""Gradient compression with error feedback — the port of
``repro.parallel.compression``.

Two schemes, both pluggable into ``train.step.make_train_step(
grad_transform=...)``:

* ``int8_roundtrip`` — symmetric int8 quantization with a per-tensor fp32
  scale (max |g| / 127, round half to even, clipped to +-127) and back:
  what the wire of a compressed all-reduce carries;
* ``topk_roundtrip`` — magnitude top-k sparsification (k a fraction of
  the entries, at least 1): entries at or above the k-th largest
  magnitude are kept, the rest zeroed.

``make_int8_transform`` / ``make_topk_transform`` return ``(transform,
init_err)``: ``transform(grads, err)`` gives ``(sent, new_err)``, where
the residual ``err`` (fp32, one leaf a gradient leaf, ``init_err(params)``
zeros) is added to the next step's gradient before it is compressed, so
the sum of what was sent plus the last residual equals the sum of the
true gradients.  With ``err=None`` (or int8's ``with_error_feedback=
False``) a step compresses its gradient alone.  Each computes in fp32 and
casts what it sends back to the gradient's dtype, as the reference does.
On one card there is no all-reduce to shrink (ROADMAP A7b): the launcher's
``--compress int8`` applies the round trip to the step's gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils.tree import tree_flatten, tree_map


def int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Quantize to int8 + dequantize, in fp32."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def topk_roundtrip(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top-``frac`` entries by magnitude; zero the rest (fp32)."""
    gf = g.to(torch.float32)
    flat = gf.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(flat.abs() >= thresh, flat, torch.zeros_like(flat))
    return kept.reshape(g.shape)


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


def _with_feedback(roundtrip):
    """``transform(grads, err)`` around one leaf's round trip."""
    def transform(grads, err: Optional[object] = None):
        leaves, treedef = tree_flatten(grads)
        errs = (treedef.flatten_up_to(err) if err is not None
                else [None] * len(leaves))
        sent, resid = [], []
        for g, e in zip(leaves, errs):
            gf = g.to(torch.float32) + (e if e is not None else 0.0)
            out = roundtrip(gf)
            sent.append(out.to(g.dtype))
            resid.append(gf - out)
        if err is None:
            return treedef.unflatten(sent), None
        return treedef.unflatten(sent), treedef.unflatten(resid)
    return transform


def make_int8_transform(with_error_feedback: bool = True):
    """``(transform, init_err)`` of the int8 scheme (see the module
    docstring); without error feedback the residual is neither used nor
    returned (``err`` comes back as given)."""
    feedback = _with_feedback(int8_roundtrip)

    def transform(grads, err=None):
        if err is None or not with_error_feedback:
            return feedback(grads, None)[0], err
        return feedback(grads, err)

    return transform, _zeros_like_tree


def make_topk_transform(frac: float = 0.1):
    """``(transform, init_err)`` of the top-``frac`` scheme."""
    return _with_feedback(lambda g: topk_roundtrip(g, frac)), _zeros_like_tree
