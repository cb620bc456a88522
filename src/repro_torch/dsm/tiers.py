"""Tier manager: HBM / host-staging / pool with CXL0 primitive semantics —
the port of ``repro.dsm.tiers`` with the synchronous primitives.

Per worker, per object:

* ``lstore(name, tree)``  — update the HBM tier (in-memory reference, no
                            copy).  Marks dirty; seeds the version counter
                            above every version already on disk.
* ``ldiscard(name)``      — drop an object from the HBM tier.
* ``rflush(name)``        — durable write of the current HBM value into the
                            pool; completes only when on storage (fsync).
* ``mstore(name, tree)``  — lstore + rflush fused (Prop. 1.8).

The device -> host copy (``_to_host_counted``) takes every CUDA tensor
leaf through ONE ``.cpu()`` and charges its bytes to ``d2h_gather_bytes``;
host leaves pass through.  Sharded and async flush pipelines
(``rflush_sharded``, ``flush_async*``) come with the sharded schedules;
peer staging (``rstore`` into a peer's host buffer, ``rload`` of what a
peer staged here) comes with the fleet and cluster slices that use it.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import torch

from repro_torch.dsm.pool import DSMPool, PoolObject
from repro_torch.utils.tree import tree_flatten


class TierManager:
    def __init__(self, pool: DSMPool):
        self.pool = pool
        self.hbm: Dict[str, Any] = {}               # C_i — device tier
        self.versions: Dict[str, int] = {}
        self.flit_counter: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: D2H accounting (bytes): whole-leaf host gathers of the flush
        #: and paging paths (``d2h_gather_bytes``) and, kept for the sharded
        #: device-local pipelines to come, per-buffer copies
        #: (``d2h_shard_bytes``)
        self.d2h_gather_bytes = 0
        self.d2h_shard_bytes = 0

    @classmethod
    def open(cls, pool: DSMPool) -> "TierManager":
        """The tier stack over ``pool`` — how the dsm layer
        (``CXL0Context``) builds one."""
        return cls(pool)

    def count_d2h(self, kind: str, nbytes: int):
        with self._lock:
            if kind == "gather":
                self.d2h_gather_bytes += int(nbytes)
            else:
                self.d2h_shard_bytes += int(nbytes)

    def to_host(self, leaf: Any) -> Any:
        """One leaf to the host: a CUDA tensor through one counted
        ``.cpu()``; host tensors and numpy arrays pass through."""
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            host = leaf.cpu()
            self.count_d2h("gather", host.nbytes)
            return host
        return leaf

    def _to_host_counted(self, tree):
        leaves, treedef = tree_flatten(tree)
        return treedef.unflatten([self.to_host(l) for l in leaves])

    # -- CXL0 primitive realizations ----------------------------------------
    def lstore(self, name: str, tree: Any):
        """Update the volatile HBM tier. Completes immediately.  The first
        lstore of a name seeds the version counter ABOVE the highest
        version on disk, so a write never overwrites a file a retained
        manifest still references."""
        self.hbm[name] = tree
        if name not in self.versions:
            self.versions[name] = self.pool.max_version(name)
        self.versions[name] += 1

    def ldiscard(self, name: str):
        """Drop an object from the volatile HBM tier.  The version counter
        is KEPT, so a later lstore of the name keeps rising."""
        self.hbm.pop(name, None)

    def rflush(self, name: str) -> PoolObject:
        """Durable write; returns once the object is on storage."""
        self.flit_counter[name] = self.flit_counter.get(name, 0) + 1
        try:
            obj = self.pool.write_object(
                name, self.versions.get(name, 0),
                self._to_host_counted(self.hbm[name]))
        finally:
            self.flit_counter[name] -= 1
        return obj

    def mstore(self, name: str, tree: Any) -> PoolObject:
        self.lstore(name, tree)
        return self.rflush(name)

    def abort_flushes(self):
        """Join-and-discard outstanding async writes: the synchronous tier
        has none (kept so the crash path reads as the reference's)."""

    def close(self):
        """Release flush resources (none in the synchronous tier)."""

    # -- crash ----------------------------------------------------------------
    def crash(self):
        """f_i: all volatile tiers of this worker vanish."""
        self.abort_flushes()
        self.close()
        self.hbm.clear()
        self.versions.clear()
        self.flit_counter.clear()
