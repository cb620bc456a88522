"""Tiered KV-cache manager: per-slot cache lanes in HBM, cold sessions in
the staging / pool tiers — the port of ``repro.serve.kvcache``.

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

Whole single-sequence caches leave HBM through the CXL0 tiers
(``dsm.tiers``):

* ``stage(name, cache1)``            — LStore into the worker's object
  tier; the committer RFlushes it as part of a session commit (the legacy
  layout of ``serve.sessions``);
* ``spill(name, cache1, peer=...)``  — also RStore a host copy into a
  PEER worker's buffer (survives OUR crash without pool I/O);
* ``spill_durable(name, cache1)``    — an immediate sharded RFlush into
  the pool over byte-balanced leaf blocks (``block_layout``); returns the
  manifest entry ``restore`` needs;
* ``spill_auto(name, cache1, peer=...)`` — the placement policy
  (``dsm.placement``) prices staging against the pool for this cache's
  bytes under its emulated topology and routes there (decision logged);
* ``restore(name, entry=...)``       — best tier first: the object tier,
  then OUR staging buffer, then the pool; byte-identical in every case
  (frames keep each leaf's raw bytes and dtype, bf16 included).

A CUDA lane's copies to the host go through the tiers' counted
``to_host``.  ``restore`` returns the tier's tree (host tensors from the
buffer or the pool); ``write_slot`` copies it into a lane on the card.
Mesh-sharded lanes and device-local spills (``parallel=`` with a mesh)
are not ported yet and raise (ROADMAP A7).
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from repro_torch.dsm.pool import manifest_entry, partition_leaves
from repro_torch.dsm.tiers import TierManager
from repro_torch.train.step import cache_batch_axes
from repro_torch.utils.tree import tree_flatten, tree_leaves


class TieredKVCache:
    def __init__(self, bundle, n_slots: int, t_max: int,
                 tiers: Optional[TierManager] = None,
                 placement=None, parallel=None):
        if getattr(parallel, "mesh", None) is not None:
            raise NotImplementedError(
                "mesh-sharded KV lanes and device-local spills are not "
                "ported yet (reference: repro.serve.kvcache.TieredKVCache "
                "with a ParallelCtx, ROADMAP A7)")
        self.n_slots = n_slots
        self.t_max = t_max
        self.tiers = tiers
        #: cost-driven spill routing (``dsm.placement.PlacementPolicy``):
        #: ``spill_auto`` asks it for the tier
        self.placement = placement
        self.axes = cache_batch_axes(bundle)
        # zero-initialized batched cache (cache descs are init="zeros")
        self.caches = bundle.init_caches(n_slots, t_max)
        self._template1 = bundle.abstract_caches(1, t_max)

    def _lanes(self, tree):
        leaves, _ = tree_flatten(tree)
        axes, _ = tree_flatten(self.axes)
        return zip(leaves, axes)

    # -- HBM slot surgery ----------------------------------------------------
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

    # -- tier movement -------------------------------------------------------
    def _need_tiers(self) -> TierManager:
        if self.tiers is None:
            raise ValueError("no TierManager configured (tiers=)")
        return self.tiers

    def stage(self, name: str, cache1: Any) -> int:
        """LStore a session cache into the object tier; returns the
        version the next RFlush / commit of ``name`` writes."""
        t = self._need_tiers()
        t.lstore(name, cache1)
        return t.versions[name]

    def spill(self, name: str, cache1: Any, *,
              peer: Optional[TierManager] = None) -> int:
        """Evict to the object tier; with ``peer``, also RStore a host copy
        into the peer's staging buffer (the cache then survives our crash
        without a flush)."""
        version = self.stage(name, cache1)
        if peer is not None:
            self._need_tiers().rstore(name, peer, tag=version)
        return version

    def spill_durable(self, name: str, cache1: Any,
                      n_blocks: Optional[int] = None) -> dict:
        """Evict straight to the pool: a sharded RFlush over byte-balanced
        leaf blocks.  Returns the manifest entry for ``restore``."""
        t = self._need_tiers()
        self.stage(name, cache1)
        n = n_blocks or len(self.block_layout())
        return manifest_entry(t.rflush_sharded(name, n))

    def spill_auto(self, name: str, cache1: Any, *,
                   peer: Optional[TierManager] = None) -> dict:
        """Cost-driven eviction: the placement policy prices staging
        against the pool for THIS cache's bytes and routes there (the
        decision is logged on the policy).  Returns ``{"tier", "nbytes",
        "version"}`` (staging) or ``{"tier", "nbytes", "entry"}`` (pool:
        pass ``entry`` back into ``restore``).  A staging choice with no
        peer keeps the object tier alone (restorable while we live)."""
        if self.placement is None:
            raise ValueError("no PlacementPolicy configured (placement=)")
        from repro_torch.dsm.emu import tree_nbytes
        nbytes = tree_nbytes(cache1)
        tier = self.placement.choose_spill(name, nbytes)
        if tier == "staging":
            return {"tier": "staging", "nbytes": nbytes,
                    "version": self.spill(name, cache1, peer=peer)}
        n = self.placement.choose_shards(nbytes, name)
        return {"tier": "pool", "nbytes": nbytes,
                "entry": self.spill_durable(name, cache1, n_blocks=n)}

    def restore(self, name: str, entry: Optional[dict] = None,
                *, drop_hot: bool = False) -> Optional[Any]:
        """Bring a session cache back, best tier first: the object tier
        (still resident), then OUR staging buffer (a peer RStored it here),
        then the pool (needs the manifest ``entry`` of ``spill_durable`` or
        of a session commit).  None if no tier holds it."""
        t = self._need_tiers()
        if name in t.hbm:
            tree = t.hbm[name]
            if drop_hot:
                t.ldiscard(name)
            return tree
        staged = t.rload(name)
        if staged is not None:
            return staged
        if entry is not None:
            return t.pool.read_entry(name, entry, self._template1)
        return None

    def discard(self, name: str):
        """Drop a session cache from the object tier (session finished)."""
        self._need_tiers().ldiscard(name)

    # -- block layout --------------------------------------------------------
    def block_layout(self, n_blocks: Optional[int] = None) -> List[List[int]]:
        """Byte-balanced partition of the per-slot cache leaves into spill
        blocks (``pool.partition_leaves``, the layout ``rflush_sharded``
        writes).  Default block count: one per local device of the lanes'
        kind (the CUDA devices torch sees for lanes on the card, 1 on the
        host), clamped by the leaf count."""
        leaves = tree_leaves(self._template1)
        nbytes = [int(l.nbytes) for l in leaves]
        if n_blocks:
            n = n_blocks
        else:
            lane = tree_leaves(self.caches)[0]
            n = (torch.cuda.device_count() if lane.device.type == "cuda"
                 else 1)
        return partition_leaves(nbytes, max(n, 1))
