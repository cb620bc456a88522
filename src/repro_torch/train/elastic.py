"""Elastic scaling: re-lay training state when the worker set changes —
the port of ``repro.train.elastic``.

On a worker-count change (scale-up, or shrink after a permanent failure)
the launcher recovers the newest durable state, re-lays it on the new
worker set and re-plans the data shards (``data.pipeline.shard_plan``).
The planners (``shrink_plan``, ``grow_plan``, ``plan_delta``,
``partition_plan``) are pure functions of the membership.

``reshard`` / ``remesh`` re-lay the state.  Over a ``launch.mesh.Mesh``
they do what the reference's do: the sharding of every leaf comes from
the SAME logical axes (``shardings_for``: the rules are mesh-shape
agnostic) and each leaf is placed onto it (``parallel.sharding.place``,
the counterpart of ``device_put``), and ``remesh`` returns the new
``ParallelCtx``.  A rank's device slice (``launch.mesh.rank_submesh``: a
list of torch devices) keeps the single-device behaviour, a ``.to`` of
every leaf onto the slice's device, and ``remesh`` returns ``(tree,
device)`` there; a slice of several devices is laid out as the
reference's ``rank_submesh`` mesh is, an (n, 1) mesh with every leaf
replicated over it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import (NamedSharding, ParallelCtx, P,
                                           ctx_for_mesh, param_specs, place)
from repro_torch.utils.tree import tree_map


def shardings_for(ctx: ParallelCtx, descs):
    """NamedShardings on ``ctx.mesh`` from the logical-axis rules (any
    mesh shape: the same descs serve 1, 8 or 256 places)."""
    specs = param_specs(ctx, descs)
    return tree_map(lambda s: NamedSharding(ctx.mesh, s), specs,
                    is_leaf=lambda x: isinstance(x, P))


def _devices(x) -> Optional[list]:
    """``x`` as a list of devices (a device, or a rank's device slice), or
    None when it is not one."""
    if isinstance(x, (str, torch.device)):
        return [x]
    if isinstance(x, (list, tuple)) and x and all(
            isinstance(d, (str, torch.device)) for d in x):
        return list(x)
    return None


def _slice_mesh(devices) -> Mesh:
    """A slice of several devices as the reference's (n, 1) mesh."""
    return Mesh((len(devices), 1), ("data", "model"), devices)


def reshard(tree: Any, new_shardings: Any) -> Any:
    """Every leaf onto its new layout: a tree of NamedShardings (or one
    for every leaf) places each leaf; a device, or a one-device slice,
    moves every tensor leaf there (numpy leaves become tensors there); a
    slice of several devices replicates every leaf over its (n, 1)
    mesh."""
    if isinstance(new_shardings, NamedSharding):
        return tree_map(lambda a: place(a, new_shardings), tree)
    devs = _devices(new_shardings)
    if devs is None:
        return tree_map(place, tree, new_shardings)
    if len(devs) > 1:
        return reshard(tree, NamedSharding(_slice_mesh(devs), P()))
    dev = torch.device(devs[0])
    return tree_map(lambda a: (a.to(dev) if isinstance(a, torch.Tensor)
                               else torch.as_tensor(a, device=dev)), tree)


def remesh(tree: Any, descs: Any, new_mesh, *, ep: bool = True
           ) -> Tuple[Any, Any]:
    """Recovered state -> state laid out on ``new_mesh``.  A Mesh gives
    ``(placed, ParallelCtx)``, as the reference's; ``descs`` (a tree of
    ``ParamDesc`` matching ``tree``) picks each leaf's sharding, and
    without it every leaf is replicated.  A rank's device slice gives
    ``(placed, device)`` for one device (``descs`` and ``ep`` then change
    nothing), and an (n, 1) mesh's ``(placed, ParallelCtx)`` for more."""
    if not isinstance(new_mesh, Mesh):
        devs = _devices(new_mesh)
        if len(devs) == 1:
            dev = torch.device(devs[0])
            return reshard(tree, dev), dev
        new_mesh = _slice_mesh(devs)
    ctx = ctx_for_mesh(new_mesh, ep=ep)
    if descs is None:
        return reshard(tree, NamedSharding(new_mesh, P())), ctx
    return reshard(tree, shardings_for(ctx, descs)), ctx


def shrink_plan(old_ranks: int, new_ranks: int) -> dict:
    """Which old rank's data-shard responsibilities move where (documented
    plan consumed by the launcher; data reshuffling itself is free because
    the pipeline is deterministic — any rank can compute any shard)."""
    assert new_ranks > 0
    return {r: r % new_ranks for r in range(old_ranks)}


def grow_plan(old_ranks: int, new_ranks: int) -> dict:
    """``shrink_plan``'s inverse direction: which new rank inherits each
    old rank's data-shard responsibilities when the cluster GROWS.  Old
    ranks keep their identity (r -> r); the added ranks start fresh —
    the deterministic pipeline means a joiner can compute any shard, so
    the plan only documents continuity for the launcher."""
    assert new_ranks >= old_ranks > 0, (old_ranks, new_ranks)
    return {r: r for r in range(old_ranks)}


def plan_delta(old_plan: Dict[str, int], new_plan: Dict[str, int]
               ) -> Dict[str, Tuple[int, int]]:
    """The entries that change owner between two partition plans:
    ``{name: (old_owner, new_owner)}``.  This is exactly the transfer
    set of a grow (or shrink) by repartition — the survivors RStore each
    moving entry into its new owner's staging buffer, and everything not
    in the delta stays put."""
    assert set(old_plan) == set(new_plan), \
        (sorted(set(old_plan) ^ set(new_plan)))
    return {n: (old_plan[n], new_plan[n]) for n in sorted(old_plan)
            if old_plan[n] != new_plan[n]}


def partition_plan(names: Sequence[str], ranks: Sequence[int],
                   device_sets: Optional[Dict[int, Any]] = None
                   ) -> Dict[str, int]:
    """Stable ownership map of named state entries over a rank set — the
    FSDP-style state partition of the cluster protocol
    (``dsm.cluster``): each data-parallel rank OWNS a disjoint slice
    of the model/optimizer state and commits it under its ``w<i>/``
    namespace.  Round-robin over the sorted names and the sorted live
    ranks, so every process (and a restarted one) derives the identical
    map from the same membership — no coordinator needed.  On a shrink the
    plan recomputed for the surviving ranks reassigns the victim's entries
    deterministically.

    ``device_sets`` maps each rank to its mesh-slice weight — a device
    count, or anything with a ``len`` (a device list, a ``Mesh``'s device
    array) — and expands the round-robin over per-device SLOTS: a rank
    owning twice the devices draws twice the entries, so partitions land
    proportionally on the actual sub-grids (``launch.mesh.rank_submesh``).
    Every process derives the same plan from the same (live, device_sets)
    pair; equal weights reduce to the classic per-rank round-robin."""
    ranks = sorted(ranks)
    assert ranks, "partition over an empty rank set"
    if device_sets:
        slots: list = []
        for r in ranks:
            w = device_sets.get(r, 1)
            try:
                w = len(w)
            except TypeError:
                w = int(w)
            slots.extend([r] * max(1, w))
    else:
        slots = ranks
    return {n: slots[i % len(slots)] for i, n in enumerate(sorted(names))}
