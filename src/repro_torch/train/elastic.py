"""Elastic scaling: re-lay training state when the worker set changes —
the port of ``repro.train.elastic``.

On a worker-count change (scale-up, or shrink after a permanent failure)
the launcher recovers the newest durable state, re-lays it on the new
worker set and re-plans the data shards (``data.pipeline.shard_plan``).
The planners (``shrink_plan``, ``grow_plan``, ``plan_delta``,
``partition_plan``) are pure functions of the membership.  ``reshard`` /
``remesh`` re-lay the state: here the single-device part, a ``.to`` of
every leaf onto the rank's device (``launch.mesh.rank_submesh``), which
is what the reference's ``device_put`` does on a one-device mesh.  A
slice of more than one device needs a sharded layout (``ParallelCtx``)
and raises (ROADMAP A7).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_map


def _one_device(devices) -> torch.device:
    devs = ([devices] if isinstance(devices, (str, torch.device))
            else list(devices))
    if len(devs) != 1:
        raise NotImplementedError(
            f"re-laying state over {len(devs)} devices needs a sharded "
            f"layout, not ported yet (reference: repro.train.elastic."
            f"remesh with a ParallelCtx over a Mesh, ROADMAP A7)")
    return torch.device(devs[0])


def reshard(tree: Any, new_device) -> Any:
    """Move every tensor leaf onto ``new_device`` (one device, or a
    one-device slice); numpy leaves become tensors there."""
    dev = _one_device(new_device)
    return tree_map(lambda a: (a.to(dev) if isinstance(a, torch.Tensor)
                               else torch.as_tensor(a, device=dev)), tree)


def remesh(tree: Any, descs: Any, new_mesh: Sequence, *,
           ep: bool = True) -> Tuple[Any, torch.device]:
    """Recovered state -> state placed on ``new_mesh`` (a rank's device
    slice).  Returns ``(placed, device)``; the reference returns its
    ``ParallelCtx`` there.  ``descs`` and ``ep`` are the reference's
    arguments: with one device nothing is sharded, so neither changes the
    placement."""
    dev = _one_device(new_mesh)
    return reshard(tree, dev), dev


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
