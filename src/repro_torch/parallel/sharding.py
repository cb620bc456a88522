"""Logical-axis sharding rules and the mesh layout of a state — the port of
``repro.parallel.sharding``.

Every parameter dimension carries a *logical* axis name
(``models.params.ParamDesc.logical``); ``spec_for`` maps logical axes to
mesh axes with the reference's two-pass resolver and gives a
``PartitionSpec`` (a tuple of mesh-axis entries, one a dimension, as
``jax.sharding.PartitionSpec`` is), ``param_specs`` a tree of them.

The layout itself is the counterpart of ``NamedSharding`` and
``jax.device_put``: ``NamedSharding(mesh, spec)`` cuts a shape into one
block a place of a ``launch.mesh.Mesh``, and ``place(tensor, sharding)``
gives a ``ShardedTensor`` that carries every place's block (its index, its
place, its torch device, its replica id, its data), as a jax array
carries its ``addressable_shards``.  It is not a ``DTensor``: a DTensor
is one rank's view in an SPMD world, and no process holds the other
ranks' blocks, where the durable commit of a mesh-sharded state
(``dsm.meshio``) reads every block itself, single-controller, as the
reference does.  A dimension the spec leaves unsharded is whole in each
block, and places that hold the same index are replicas, numbered in
mesh order; only replica 0 is written and priced.  When every place of
the mesh maps to one device (a mesh on one card), the blocks are views of
one tensor on it, so placing a leaf copies nothing and ``full()`` gives
that tensor back; across devices each block is a copy on its place's
device.

Sharded compute is not ported (ROADMAP A7b): the port's train step runs
on the leaves' whole tensors (``unshard``) and the loop places its result
back onto the template's layout (``place_like``), so ``constrain`` is the
identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import ParamDesc, tree_map_descs
from repro_torch.utils.tree import tree_map


class PartitionSpec(tuple):
    """One entry a dimension: None (unsharded), a mesh axis name, or a
    tuple of axis names (the dimension split over their product, the first
    axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Optional[Mesh]
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)
    ep: bool = True
    #: "tp" (default): TP over the model axis; "dp_only": batch over ALL
    #: axes, weights FSDP over data, no TP
    strategy: str = "tp"

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.strategy == "dp_only":
            return 1
        return self.mesh.shape[self.tp_axis]

    @property
    def dp_size(self) -> int:
        if not self.mesh:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def fsdp_size(self) -> int:
        if not self.mesh:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.fsdp_axes)


def ctx_for_mesh(mesh: Optional[Mesh], *, ep: bool = True,
                 fsdp: bool = True, strategy: str = "tp") -> ParallelCtx:
    if mesh is None:
        return ParallelCtx(None, ep=False)
    if strategy == "dp_only":
        dp = tuple(a for a in ("pod", "data", "model")
                   if a in mesh.axis_names)
        return ParallelCtx(mesh, dp_axes=dp,
                           fsdp_axes=("data",) if fsdp else (),
                           ep=False, strategy="dp_only")
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelCtx(mesh, dp_axes=dp or ("data",),
                       fsdp_axes=("data",) if fsdp else (),
                       ep=ep, strategy=strategy)


# logical axis -> mesh axis resolver, two passes (the reference's):
#   1. primary: embed->FSDP(data), {vocab,heads,mlp,expert,mamba_inner,
#      kv_heads,mla_lora}->TP(model), batch->DP — each only if divisible;
#   2. TP fallback: if no dim took the model axis, the first divisible
#      fallback dim (q_per_kv, then head_dim) takes it.

_TP_PRIMARY = ("vocab", "heads", "mlp", "expert", "mamba_inner", "kv_heads",
               "mla_lora")
_TP_FALLBACK = ("q_per_kv", "head_dim")


def spec_for(ctx: ParallelCtx, desc: ParamDesc) -> PartitionSpec:
    if ctx.mesh is None:
        return P(*([None] * len(desc.shape)))
    spec = [None] * len(desc.shape)
    tp_used = ctx.strategy == "dp_only"     # disables TP assignment
    fsdp = (ctx.fsdp_axes if len(ctx.fsdp_axes) > 1
            else (ctx.fsdp_axes[0] if ctx.fsdp_axes else None))
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    for i, (ax, n) in enumerate(zip(desc.logical, desc.shape)):
        if ax == "embed" and fsdp is not None and n % ctx.fsdp_size == 0:
            spec[i] = fsdp
        elif ax in _TP_PRIMARY and not tp_used and n % ctx.tp_size == 0:
            spec[i] = ctx.tp_axis
            tp_used = True
        elif ax == "batch" and n % ctx.dp_size == 0:
            spec[i] = dp
    if not tp_used:
        for i, (ax, n) in enumerate(zip(desc.logical, desc.shape)):
            if (spec[i] is None and ax in _TP_FALLBACK
                    and n % ctx.tp_size == 0):
                spec[i] = ctx.tp_axis
                tp_used = True
                break
    return P(*spec)


def param_specs(ctx: ParallelCtx, descs):
    return tree_map_descs(lambda d: spec_for(ctx, d), descs)


def param_shardings(ctx: ParallelCtx, descs):
    if ctx.mesh is None:
        raise ValueError("param_shardings needs a mesh")
    return tree_map_descs(lambda d: NamedSharding(ctx.mesh, spec_for(ctx, d)),
                          descs)


def batch_spec(ctx: ParallelCtx, ndim_rest: int = 1) -> PartitionSpec:
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    return P(dp, *([None] * ndim_rest))


def constrain(ctx: ParallelCtx, x, spec: PartitionSpec):
    """The identity: the port computes on whole tensors (ROADMAP A7b)."""
    return x


# -- the layout: named shardings and sharded tensors -------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: how a shape is cut into one block a place."""
    mesh: Mesh
    spec: PartitionSpec

    def blocks(self, shape: Tuple[int, ...]
               ) -> List[Tuple[int, Tuple[slice, ...], int]]:
        """``(place, index, replica id)`` of every place, in mesh order;
        the index is a tuple of slices (one a dimension, ``slice(None)``
        where the dimension is whole).  A sharded dimension must divide
        evenly, as the resolver only ever assigns such dimensions."""
        spec = tuple(self.spec)
        if len(spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dimensions")
        used = [a for e in spec for a in _axes(e)]
        for a in used:
            if a not in self.mesh.axis_names:
                raise ValueError(f"spec {self.spec}: no mesh axis {a!r} in "
                                 f"{self.mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")
        sizes = self.mesh.shape
        out, seen = [], {}
        for place in range(self.mesh.size):
            coords = self.mesh.coords(place)
            index = []
            for d, n in enumerate(shape):
                axes = _axes(spec[d]) if d < len(spec) else ()
                if not axes:
                    index.append(slice(None))
                    continue
                parts = math.prod(sizes[a] for a in axes)
                if n % parts:
                    raise ValueError(f"dimension {d} of {tuple(shape)} does "
                                     f"not split into {parts} blocks")
                k = 0
                for a in axes:
                    k = k * sizes[a] + coords[a]
                step = n // parts
                index.append(slice(k * step, (k + 1) * step))
            key = tuple((s.start, s.stop) for s in index)
            replica = seen.get(key, 0)
            seen[key] = replica + 1
            out.append((place, tuple(index), replica))
        return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """One place's block of a ``ShardedTensor`` (the counterpart of a jax
    array's ``Shard``)."""
    index: Tuple[slice, ...]
    place: int
    device: torch.device
    replica_id: int
    data: torch.Tensor


class ShardedTensor:
    """A tensor laid out over a mesh: its shape, dtype, sharding and every
    place's block (``addressable_shards``).  A tree leaf (not a tuple or a
    dict), so the pool's trees hold it whole."""

    __slots__ = ("shape", "dtype", "sharding", "addressable_shards", "_base")

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding,
                 shards: List[Shard], base: Optional[torch.Tensor] = None):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.addressable_shards = list(shards)
        self._base = base

    @property
    def nbytes(self) -> int:
        """The whole tensor's bytes, from metadata (no copy)."""
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def device(self) -> torch.device:
        """Place 0's device."""
        return self.addressable_shards[0].device

    def full(self) -> torch.Tensor:
        """The whole tensor: the one the blocks view when every place is on
        one device, else the replica-0 blocks gathered onto place 0's."""
        if self._base is not None:
            return self._base
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for s in self.addressable_shards:
            if s.replica_id == 0:
                out[s.index] = s.data.to(self.device)
        return out

    def snapshot(self) -> "ShardedTensor":
        """A copy of each replica-0 block on its own device (what a flush
        in flight reads while the caller may write the blocks)."""
        shards = [dataclasses.replace(s, data=s.data.clone())
                  for s in self.addressable_shards if s.replica_id == 0]
        return ShardedTensor(self.shape, self.dtype, self.sharding, shards)

    def __repr__(self) -> str:
        return (f"ShardedTensor({list(self.shape)}, {self.dtype}, "
                f"spec={self.sharding.spec}, {len(self.addressable_shards)} "
                f"blocks)")


def place(x: Any, sharding: NamedSharding) -> ShardedTensor:
    """``x`` (a tensor, an array or a ShardedTensor) laid out by
    ``sharding`` — the counterpart of ``jax.device_put``."""
    if isinstance(x, ShardedTensor):
        if x.sharding == sharding:
            return x
        x = x.full()
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    blocks = sharding.blocks(tuple(t.shape))
    devices = {mesh.device_of(p) for p, _, _ in blocks}
    if len(devices) == 1:
        base = t.to(devices.pop())
        shards = [Shard(idx, p, base.device, r, base[idx])
                  for p, idx, r in blocks]
        return ShardedTensor(t.shape, t.dtype, sharding, shards, base)
    shards = []
    for p, idx, r in blocks:
        dev = mesh.device_of(p)
        shards.append(Shard(idx, p, dev, r, t[idx].to(dev)))
    return ShardedTensor(t.shape, t.dtype, sharding, shards)


def unshard(tree: Any) -> Any:
    """Every ShardedTensor leaf as its whole tensor (``full()``)."""
    return tree_map(lambda x: x.full() if isinstance(x, ShardedTensor)
                    else x, tree)


def place_like(tree: Any, template: Any) -> Any:
    """Each leaf of ``tree`` onto its template leaf's sharding where that
    is a ShardedTensor; other leaves as they are."""
    return tree_map(lambda x, t: (place(x, t.sharding)
                                  if isinstance(t, ShardedTensor) else x),
                    tree, template)

