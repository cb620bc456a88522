"""Elastic scaling: the host planners of a worker-count change — the
port of ``repro.train.elastic``'s ``shrink_plan``, ``grow_plan``,
``plan_delta`` and ``partition_plan`` (pure functions of the membership,
no device in them).

On a worker-count change (scale-up, or shrink after a permanent failure)
the launcher recovers the newest durable state, re-lays it on the new
worker set and re-plans the data shards (``data.pipeline.shard_plan``);
these planners say which rank owns what before and after.  Re-laying the
state itself (the reference's ``remesh`` / ``reshard`` over a device
mesh) is not ported yet (ROADMAP A6b).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple


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
