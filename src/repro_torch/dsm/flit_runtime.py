"""The FliT-protocol durable commit (paper Alg. 2 at object granularity) —
the port of ``repro.dsm.flit_runtime`` with the ``sync`` schedule.

One commit of step ``s`` is the high-level operation; the HBM-tier objects
are the shared locations::

    for each object X:  flit_counter(X)++ ; LStore(X) ; RFlush(X) ;
                        flit_counter(X)--
    completeOp()  =  atomic manifest rename

A commit whose completeOp finished survives any single-worker crash;
recovery always lands on SOME completed commit, never a torn mixture.

``sync`` rflushes every object serially, then completeOps.  The
``async``, ``sharded`` and ``sharded-async`` schedules (thread-pool flush
pipelines) and ``auto`` (placement-priced) are not ported yet: asking for
one raises ``NotImplementedError``.  ``complete_fn`` delegation is ported
— the paged session store merges its carried block entries through it.
RStore staging to a peer (``replicate_to``) and the fault-injection hook
come with the cluster and scenario slices that use them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.dsm.tiers import TierManager

COMMIT_MODES = ("sync", "async", "sharded", "sharded-async")
AUTO_MODE = "auto"
PORTED_MODES = ("sync",)


def check_mode(mode: str):
    if mode in PORTED_MODES:
        return
    if mode in COMMIT_MODES + (AUTO_MODE,):
        raise NotImplementedError(
            f"commit schedule {mode!r} is not ported yet (reference: "
            f"repro.dsm.flit_runtime.DurableCommitter); the port commits "
            f"with schedule='sync'")
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


class DurableCommitter:
    def __init__(self, tiers: TierManager, *, mode: str = "sync",
                 retention: Optional[int] = None,
                 complete_fn: Optional[
                     Callable[[int, Dict[str, Any], Optional[dict]],
                              int]] = None):
        check_mode(mode)
        self.tiers = tiers
        self.mode = mode
        self.retention = retention
        #: delegated completeOp: ``complete_fn(step, written, meta) -> seq``
        #: replaces ``pool.commit_manifest`` (and turns off retention GC:
        #: the delegate owns the manifest protocol)
        self.complete_fn = complete_fn
        self.stats: list = []

    def _complete_op(self, step: int, written: Dict[str, Any],
                     meta, t0) -> CommitStats:
        if self.complete_fn is not None:
            seq = self.complete_fn(step, written, meta)
        else:
            seq = self.tiers.pool.commit_manifest(step, written, meta)
        if self.retention is not None and self.complete_fn is None:
            self.tiers.pool.gc(keep=self.retention)
        st = CommitStats(step, seq, len(written),
                         sum(o.nbytes for o in written.values()),
                         time.perf_counter() - t0, self.mode)
        self.stats.append(st)
        return st

    def update(self, objects: Dict[str, Any]):
        """LStore the new state into HBM."""
        for name, tree in objects.items():
            self.tiers.lstore(name, tree)

    def commit(self, step: int, meta: Optional[dict] = None) -> CommitStats:
        """Durable commit of the current HBM state: rflush every object,
        then one completeOp."""
        t0 = time.perf_counter()
        written: Dict[str, Any] = {}
        for name in list(self.tiers.hbm):
            written[name] = self.tiers.rflush(name)
        return self._complete_op(step, written, meta, t0)

    def drain(self, meta: Optional[dict] = None) -> Optional[CommitStats]:
        """Flush a pending async commit: the sync schedule never has one."""
        return None

    def abort_pending(self):
        """Crash path: discard a pending commit (none under sync)."""
        self.tiers.abort_flushes()
