"""Parameter descriptors: one source of truth for shape / init.

Every model module builds a pytree of ``ParamDesc`` leaves (the JAX
package's trees, leaf for leaf).  From that tree we derive (a) params
initialised from an explicit ``torch.Generator``, (b) ``TensorSpec``
trees (shape + dtype, no allocation) used as unflatten templates by the
pool, and (c) params carried over from the JAX package
(``from_reference``), so both packages compute the same function in the
parity tests.  ``torch.Generator`` and ``jax.random`` give different
numbers from one seed: only ``from_reference`` reproduces JAX weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.convert import from_numpy, torch_dtype
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    dtype: Optional[str] = None          # None -> model param_dtype
    init: str = "normal"   # normal | zeros | ones | uniform_small | decay_bias
    init_scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype of a tensor that is not allocated (the counterpart of
    ``jax.ShapeDtypeStruct``; a dataclass, so trees treat it as a leaf)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize


def is_desc(x: Any) -> bool:
    return isinstance(x, ParamDesc)


def tree_map_descs(fn, tree):
    return tree_map(fn, tree, is_leaf=is_desc)


def abstract_params(descs, default_dtype: str):
    return tree_map_descs(
        lambda d: TensorSpec(d.shape, torch_dtype(d.dtype or default_dtype)),
        descs)


#: a "normal" leaf of more elements than this is drawn one slice of its
#: leading axis at a time (see ``init_params``).  2^32 lies above every
#: leaf of the paths served before yi-34b (so their weights stay the whole
#: draws, bit for bit) and caps a whole draw's fp32 copy at 17 GB
SLICED_DRAW_ELEMENTS = 2 ** 32


def _normal(shape, scale: float, dt, generator, device) -> torch.Tensor:
    """N(0, scale^2) draws in fp32, cast to ``dt``.  A leaf of at most
    ``SLICED_DRAW_ELEMENTS`` elements is one draw, scaled in place (the
    largest such leaf the card draws, one jamba-1.5-large layer's experts
    at 3.2e9 elements, needs one fp32 copy, not two).  A larger
    one (yi-34b's 60 stacked MLP layers, 8.8e9 elements: 35 GB in fp32) is
    drawn slice by slice of its leading axis into the cast tensor, so the
    fp32 it holds at once is one slice."""
    n = int(np.prod(shape))
    if n <= SLICED_DRAW_ELEMENTS:
        return torch.randn(shape, generator=generator,
                           device=device).mul_(scale).to(dt)
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=generator,
                             device=device).mul_(scale)
    return out


def init_params(descs, generator: torch.Generator, default_dtype: str):
    """Materialise params on ``generator.device``, one draw per leaf in
    tree order (fp32 draws, cast to the leaf's dtype; a leaf past
    ``SLICED_DRAW_ELEMENTS`` one draw per slice of its leading axis)."""
    leaves, treedef = tree_flatten(descs, is_leaf=is_desc)
    device = generator.device
    out = []
    for d in leaves:
        dt = torch_dtype(d.dtype or default_dtype)
        if d.init == "zeros":
            v = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            v = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init == "uniform_small":
            v = (torch.rand(d.shape, generator=generator, device=device)
                 - 0.5).to(dt)
        elif d.init == "decay_bias":
            n = int(np.prod(d.shape))
            v = torch.linspace(-6.0, -0.5, n, device=device).reshape(
                d.shape).to(dt)
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[-1], 1)
            scale = d.init_scale if d.init_scale else 1.0 / math.sqrt(fan_in)
            v = _normal(d.shape, scale, dt, generator, device)
        out.append(v)
    return treedef.unflatten(out)


def zeros_like_specs(specs, device) -> Any:
    """Allocate zeros for a ``TensorSpec`` tree (decode caches)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), specs)


def count_params(descs) -> int:
    return int(sum(int(np.prod(d.shape))
                   for d in tree_leaves(descs, is_leaf=is_desc)))


def from_reference(tree, device="cuda"):
    """The JAX package's parameter pytree, as plain nested dicts / lists of
    numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), to the
    port's parameters on ``device``.  ml_dtypes bfloat16 leaves are
    recognised by dtype name and reinterpreted through uint16 views."""
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(a, dev), tree)
