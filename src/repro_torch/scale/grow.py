"""Grow-by-repartition helpers: what moves to a joiner, and where — the
port of ``repro.scale.grow``, with its re-export of the join kill points
(``dsm.faults.JOIN_POINTS``).

The join protocol is three phases —

1. **staged** — every old rank RStores the entries the new partition
   assigns to the joiner into the JOINER's staging buffer (under the
   ``join/<name>`` namespace, tagged with the pre-join step ``q``);
2. **committed** — the old ranks flush their state at ``q`` under the
   OLD partition and elect ONE gen+1 cluster manifest whose meta names
   the joiner and carries both partitions;
3. **adopted** — everyone (joiner included) switches to the new
   membership: the joiner installs its partition staging-first
   (pool-fallback through the manifest's old-partition meta).

These helpers are pure functions of the two partition plans, so every
process — old rank, joiner, a replay — derives the identical move set
with no coordinator.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.dsm.faults import JOIN_POINTS     # noqa: F401  (re-export)
from repro_torch.train.elastic import plan_delta

#: staging namespace of entries in flight to a joiner — disjoint from the
#: ``w<i>/`` rank namespaces, so a join in progress can never shadow a
#: rank's own ring-staged copies
JOIN_NS = "join"


def join_name(tensor: str) -> str:
    return f"{JOIN_NS}/{tensor}"


def join_moves(old_partition: Dict[str, int], new_partition: Dict[str, int],
               joiner: int) -> Dict[str, int]:
    """``{tensor: old_owner}`` for every entry the new partition assigns
    to ``joiner`` — the transfer set each old rank filters by ownership
    to know what IT must stage."""
    return {n: src for n, (src, dst) in
            plan_delta(old_partition, new_partition).items()
            if dst == joiner}


def join_templates(moves: Dict[str, int], dim: int) -> Dict[str, Any]:
    """Pytree prototypes of the staged join entries, in the cluster toy
    state format ({p, mu, nu} per tensor)."""
    z = lambda: np.zeros((dim, dim), np.float32)
    return {join_name(t): {"p": z(), "mu": z(), "nu": z()}
            for t in sorted(moves)}
