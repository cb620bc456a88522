"""AdamW with dtype-configurable moments — the port of
``repro.optim.adamw``, written on tensors (not ``torch.optim.AdamW``,
whose order of ops differs).

The update math runs in fp32 whatever the moments' and params' dtypes, no
weight decay where a leaf has ``ndim < 2`` (norms, biases; a layer-stacked
norm scale is 2-D and decays, as in the reference), and the gradient is
clipped by its global norm.  The update is out of place: it returns new
trees and leaves its inputs as they are, so a tree a pending flush or a
peer's staging still holds is never written.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils.convert import torch_dtype
from repro_torch.utils.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: Any                    # first moment, tree like params
    nu: Any                    # second moment, tree like params


def adamw_init(params, moment_dtype: str = "float32") -> AdamWState:
    dt = torch_dtype(moment_dtype)
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def adamw_update(params, grads, state: AdamWState, lr,
                 *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0):
    """One AdamW step; ``lr`` may be a scalar tensor (from a schedule).
    Returns ``(params, AdamWState, grad_norm)``."""
    step = state.step + 1
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(
            torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
        scale = torch.ones((), dtype=torch.float32, device=step.device)

    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = g.to(torch.float32) * scale
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if p.ndim >= 2:                      # no decay on norms / biases
            delta = delta + weight_decay * p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], out,
                              is_leaf=lambda t: isinstance(t, tuple)
                              and len(t) == 3 and isinstance(t[0],
                                                             torch.Tensor))
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), gnorm
