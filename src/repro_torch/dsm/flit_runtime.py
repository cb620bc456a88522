"""The FliT-protocol durable commit (paper Alg. 2 at object granularity) —
the port of ``repro.dsm.flit_runtime``.

One commit of step ``s`` is the high-level operation; the HBM-tier objects
are the shared locations::

    for each object X:  flit_counter(X)++ ; LStore(X) ; RFlush(X) ;
                        flit_counter(X)--
    completeOp()  =  atomic manifest rename

A commit whose completeOp finished survives any single-worker crash;
recovery always lands on SOME completed commit, never a torn mixture.

Four schedules, as in the reference:

* ``sync``          — rflush every object serially, then completeOp;
* ``async``         — one background flush thread per object runs while
                      step s+1 computes; the next commit joins them before
                      its completeOp;
* ``sharded``       — each object's leaves split into ``n_shards``
                      byte-balanced groups written in PARALLEL on a thread
                      pool, then completeOp (blocking);
* ``sharded-async`` — sharded writes of step s double-buffered behind step
                      s+1: commit(s) first joins + completeOps the PREVIOUS
                      step's shards, then launches step s's and returns.

Under the two async schedules the durable point is one commit behind:
``commit(s)`` publishes step s - stride and launches step s, and the
manifest carries the meta captured when its flushes LAUNCHED.  ``drain``
publishes the last one (planned shutdown).  Without ``n_shards`` the shard
count is ``auto_shard_count`` of the state's bytes, whose device term is
``torch.cuda.device_count()`` (1 without a card).

Retention: ``retention=k`` runs ``pool.gc(keep=k)`` after every
completeOp.  ``complete_fn`` delegation is ported — the paged session
store merges its carried block entries through it (and a delegated
completeOp turns retention GC off, as in the reference).

With a placement policy (``dsm.placement``, ``placement=``) the shard
count comes from ``placement.choose_shards`` of the state's bytes under
the policy's topology, and ``mode="auto"`` resolves at the first commit
to ``placement.choose_schedule`` (``sync`` or ``sharded-async``); both
decisions are logged on the policy with their priced costs.

``replicate_to`` RStores every object to a peer on each ``update``,
tagged with the step (a newer consistent staged copy beats the pool at
recovery), and ``fault_hook(point, step)`` fires at the reference's three
points of the commit window: ``pre_flush``, ``mid_flush`` (after the first
object, or the first shard, is durable) and ``post_completeOp``.  Not
ported yet: mesh-native shard pipelines (``repro.dsm.meshio``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.dsm.tiers import TierManager, leaf_nbytes
from repro_torch.utils.tree import tree_leaves

COMMIT_MODES = ("sync", "async", "sharded", "sharded-async")
AUTO_MODE = "auto"

#: fault-injection points inside the commit window
KILL_POINTS = ("pre_flush", "mid_flush", "post_completeOp")


def check_mode(mode: str, placement: Optional[Any] = None):
    """A commit schedule, or ``"auto"`` with the policy that resolves it."""
    if mode in COMMIT_MODES:
        return
    if mode == AUTO_MODE:
        if placement is None:
            raise ValueError("commit schedule 'auto' needs a PlacementPolicy "
                             "to price the flush (placement= or topology=)")
        return
    raise ValueError(f"unknown commit schedule {mode!r}")


@dataclasses.dataclass
class CommitStats:
    step: int
    seq: int
    n_objects: int
    bytes_written: int
    wall_s: float
    mode: str
    n_shards: int = 1


def auto_shard_count(total_bytes: int, *,
                     min_shard_bytes: int = 1 << 20,
                     n_devices: Optional[int] = None) -> int:
    """The default shard-count heuristic: one flush pipeline per local
    device, capped so no shard falls under ``min_shard_bytes``.  The
    device term is ``torch.cuda.device_count()`` (1 without a card) where
    the reference's is ``jax.local_device_count()``."""
    per_device = max(n_devices if n_devices is not None
                     else torch.cuda.device_count(), 1)
    by_bytes = max(total_bytes // min_shard_bytes, 1)
    return max(1, min(per_device, by_bytes))


class DurableCommitter:
    def __init__(self, tiers: TierManager, *, mode: str = "sync",
                 replicate_to: Optional[Any] = None,
                 n_shards: Optional[int] = None,
                 retention: Optional[int] = None,
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 placement: Optional[Any] = None,
                 complete_fn: Optional[
                     Callable[[int, Dict[str, Any], Optional[dict]],
                              int]] = None):
        check_mode(mode, placement)
        self.tiers = tiers
        self.mode = mode
        #: cost-driven placement (``dsm.placement``): the shard count and,
        #: under ``mode="auto"``, the schedule, priced at the first commit
        self.placement = placement
        #: peer for RStore staging (anything with a ``.staging`` mapping)
        self.replicate_to = replicate_to
        self.n_shards = n_shards or None     # None = auto at first commit
        self.retention = retention
        self.fault_hook = fault_hook
        #: delegated completeOp: ``complete_fn(step, written, meta) -> seq``
        #: replaces ``pool.commit_manifest`` (and turns off retention GC:
        #: the delegate owns the manifest protocol)
        self.complete_fn = complete_fn
        #: (step, object names, meta) of the in-flight async commit; meta
        #: is captured at LAUNCH so the manifest always describes the state
        #: that was actually flushed
        self._pending: Optional[Tuple[int, List[str], Optional[dict]]] = None
        self.stats: list = []

    def _hook(self, point: str, step: int):
        if self.fault_hook is not None:
            self.fault_hook(point, step)

    def _mid_flush_probe(self, first: bool, step: int):
        """The mid-flush callback of a sharded flush — only built when a
        hook is installed, because the tiers then wait on the first shard
        to fire it (which would serialize shard 0 otherwise)."""
        if not first or self.fault_hook is None:
            return None
        return lambda: self._hook("mid_flush", step)

    def _hbm_bytes(self) -> int:
        return sum(leaf_nbytes(l) for l in tree_leaves(dict(self.tiers.hbm)))

    def _resolve_shards(self) -> int:
        """Lazy auto shard count, sized from the HBM state volume at the
        first sharded flush: by the placement policy's cost model when one
        is configured, else the device-count heuristic."""
        if self.n_shards is None:
            total = self._hbm_bytes()
            self.n_shards = (self.placement.choose_shards(total)
                             if self.placement is not None
                             else auto_shard_count(total))
        return self.n_shards

    def _resolve_mode(self) -> str:
        """``mode="auto"`` waits for the first commit, when the state's
        bytes are known: the policy prices the flush under its topology
        and picks ``sync`` or ``sharded-async``."""
        if self.mode == AUTO_MODE:
            self.mode = self.placement.choose_schedule(self._hbm_bytes())
        return self.mode

    def _complete_op(self, step: int, written: Dict[str, Any],
                     meta, t0, label: str) -> CommitStats:
        """completeOp = atomic manifest rename (or the delegated
        completeOp), then retention GC."""
        if self.complete_fn is not None:
            seq = self.complete_fn(step, written, meta)
        else:
            seq = self.tiers.pool.commit_manifest(step, written, meta)
        if self.retention is not None and self.complete_fn is None:
            self.tiers.pool.gc(keep=self.retention)
        st = CommitStats(step, seq, len(written),
                         sum(o.nbytes for o in written.values()),
                         time.perf_counter() - t0, label,
                         (self.n_shards or 1) if "sharded" in self.mode
                         else 1)
        self.stats.append(st)
        self._hook("post_completeOp", step)
        return st

    def update(self, objects: Dict[str, Any], step: Optional[int] = None):
        """LStore the new state into HBM; with a peer configured, also
        RStore-stage each object, tagged with the step."""
        for name, tree in objects.items():
            self.tiers.lstore(name, tree)
            if self.replicate_to is not None:
                self.tiers.rstore(name, self.replicate_to, tag=step)

    def commit(self, step: int, meta: Optional[dict] = None
               ) -> Optional[CommitStats]:
        """Durable commit of the current HBM state.  Blocking schedules
        return the stats of THIS step; async ones the stats of the
        PREVIOUS step whose flushes were just joined (None on the first
        call)."""
        t0 = time.perf_counter()
        self._resolve_mode()
        if self.mode == "async":
            return self._commit_async(step, meta, t0)
        if self.mode == "sharded-async":
            return self._commit_sharded_async(step, meta, t0)
        self._hook("pre_flush", step)
        written: Dict[str, Any] = {}
        first = True
        for name in self.tiers.hbm:
            if self.mode == "sharded":
                written[name] = self.tiers.rflush_sharded(
                    name, self._resolve_shards(),
                    post_first_shard=self._mid_flush_probe(first, step))
            else:
                written[name] = self.tiers.rflush(name)
                if first:
                    self._hook("mid_flush", step)
            first = False
        return self._complete_op(step, written, meta, t0, self.mode)

    def _commit_async(self, step: int, meta, t0) -> Optional[CommitStats]:
        """Join the previous async flushes, completeOp them, then launch
        flushes of the CURRENT state in the background."""
        st = self._join_pending(t0, "async")
        self._hook("pre_flush", step)
        names = list(self.tiers.hbm)
        for i, name in enumerate(names):
            self.tiers.flush_async(name)
            if i == 0:      # the first write in flight, no manifest yet
                self._hook("mid_flush", step)
        self._pending = (step, names, meta)
        return st

    def _commit_sharded_async(self, step: int, meta, t0
                              ) -> Optional[CommitStats]:
        """Double-buffered sharded commit: join + completeOp step s-1's
        shard pipelines, then launch step s's and return."""
        st = self._join_pending(t0, "sharded-async")
        self._hook("pre_flush", step)
        names = list(self.tiers.hbm)
        first = True
        for name in names:
            self.tiers.flush_async_sharded(
                name, self._resolve_shards(),
                post_first_shard=self._mid_flush_probe(first, step))
            first = False
        self._pending = (step, names, meta)
        return st

    def _join_pending(self, t0, label: str) -> Optional[CommitStats]:
        if self._pending is None:
            return None
        prev_step, names, meta = self._pending
        self._pending = None        # cleared FIRST: a failed join must not
        #                             leave already-popped names re-joinable
        written: Dict[str, Any] = {}
        first_err: Optional[BaseException] = None
        for n in names:
            try:
                written[n] = self.tiers.flush_wait(n)
            except Exception as e:   # join the rest, then surface the first
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err          # step simply not durable; no manifest
        return self._complete_op(prev_step, written, meta, t0, label)

    def drain(self, meta: Optional[dict] = None) -> Optional[CommitStats]:
        """Publish a pending async commit (planned shutdown).  The manifest
        carries the meta captured when it LAUNCHED; ``meta`` is only a
        fallback when none was given then."""
        if self._pending is not None:
            if self._pending[2] is None and meta is not None:
                self._pending = (*self._pending[:2], meta)
            return self._join_pending(time.perf_counter(), "drain")
        return None

    def abort_pending(self):
        """Crash path: discard the pending commit WITHOUT completing it.
        Outstanding writes are joined (no stale write can land after the
        next incarnation starts) but no manifest is written."""
        self._pending = None
        self.tiers.abort_flushes()
