"""KV-cache lanes in HBM — the port of ``repro.serve.kvcache``'s slot
surgery (lines 90-114) and template.

The decode batch's caches live as ONE batched pytree on the card with
``n_slots`` lanes on each leaf's batch axis (axis 1 on layer-stacked
groups; the axis map comes from the cache descriptors via
``train.step.cache_batch_axes``).  The reference's slot surgery is two
jitted primitives with the cache donated; here both are IN-PLACE index
copies on the lane axis:

* ``write_slot(slot, cache1)`` — copy a single-sequence cache (fresh
  prefill, or a restored session) into lane ``slot`` of each leaf;
* ``read_slot(slot)``         — a COPY of lane ``slot`` as a
  single-sequence cache (the lane itself keeps changing every tick).

Whole-lane spill / restore through the tiers, mesh sharding and
placement-routed spills are not ported yet (reference:
``TieredKVCache.stage`` / ``spill*`` / ``restore``): the engine's durable
path commits paged token blocks (``serve.paging``) instead.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.dsm.tiers import TierManager
from repro_torch.train.step import cache_batch_axes
from repro_torch.utils.tree import tree_flatten


class TieredKVCache:
    def __init__(self, bundle, n_slots: int, t_max: int,
                 tiers: Optional[TierManager] = None):
        self.n_slots = n_slots
        self.t_max = t_max
        self.tiers = tiers
        self.axes = cache_batch_axes(bundle)
        # zero-initialized batched cache (cache descs are init="zeros")
        self.caches = bundle.init_caches(n_slots, t_max)
        self._template1 = bundle.abstract_caches(1, t_max)

    def _lanes(self, tree):
        leaves, _ = tree_flatten(tree)
        axes, _ = tree_flatten(self.axes)
        return zip(leaves, axes)

    def write_slot(self, slot: int, cache1: Any):
        """Copy a single-sequence cache into lane ``slot`` (in place: an
        index copy per leaf on its batch axis; host leaves go H2D)."""
        ones, _ = tree_flatten(cache1)
        for (full, ax), one in zip(self._lanes(self.caches), ones):
            full.select(ax, slot).copy_(one.select(ax, 0))

    def read_slot(self, slot: int) -> Any:
        """A copy of lane ``slot`` as a single-sequence cache."""
        leaves, treedef = tree_flatten(self.caches)
        axes, _ = tree_flatten(self.axes)
        return treedef.unflatten(
            [full.narrow(ax, slot, 1).clone() for full, ax in
             zip(leaves, axes)])

    @property
    def template1(self):
        """Single-sequence cache pytree prototype (for pool unflattening)."""
        return self._template1
