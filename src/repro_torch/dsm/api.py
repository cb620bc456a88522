"""CXL0Context — the programming-model API over the DSM runtime; the port
of ``repro.dsm.api`` with the synchronous schedule.

    from repro_torch.dsm.api import open_cxl0

    ctx = open_cxl0(pool_dir, schedule="sync")
    with ctx.commit(step, meta={"tag": "demo"}) as txn:
        txn.store("params", params)          # LStore
    objs, step, source = ctx.recover(templates)   # newest valid manifest

* **commit regions** — ``with ctx.commit(step, meta=...) as txn:`` LStores
  through ``txn.store``; on clean exit every HBM object is RFlushed and
  exactly one completeOp (atomic manifest rename) is emitted.  An
  exception inside the region emits NO completeOp and takes the region's
  stores back out of the volatile tier: recovery lands on the previous
  commit — the crash-anywhere contract;
* ``ctx.crash()`` / ``ctx.recover()`` — f_i and THE recovery path.

Not ported yet, and refused with ``NotImplementedError`` naming the
reference: topologies and placement policies (``repro.dsm.placement``,
``repro.dsm.emu``), mesh-native commits (``repro.dsm.meshio``), sharded /
async / auto schedules (``repro.dsm.flit_runtime``), peer staging
(RStore into a peer and recovery from it, ``repro.dsm.tiers`` /
``repro.dsm.recovery``), durable object handles and the §6
transformation (``repro.dsm.api``).  The port's default
schedule is therefore ``"sync"`` (the reference's is ``"auto"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.dsm.flit_runtime import (CommitStats, DurableCommitter,
                                          check_mode)
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.recovery import ColdStartError, RecoveryManager
from repro_torch.dsm.tiers import TierManager

_NOT_PORTED = {
    "topology": "repro.dsm.emu / repro.dsm.placement",
    "placement": "repro.dsm.placement.PlacementPolicy",
    "mesh": "repro.dsm.meshio",
    "n_shards": "repro.dsm.flit_runtime (sharded schedules)",
    "peers": "repro.dsm.recovery (peer-staging recovery)",
    "replicate_to": "repro.dsm.tiers.TierManager.rstore (peer staging)",
}


@dataclasses.dataclass
class CXL0Config:
    """Every wiring knob of the tier stack in one place."""

    path: Optional[str] = None
    topology: Optional[str] = None
    schedule: str = "sync"
    n_shards: Optional[int] = None
    retention: Optional[int] = None
    peers: Optional[Any] = None
    replicate_to: Optional[Any] = None
    placement: Optional[Any] = None
    mesh: Optional[Any] = None
    complete_fn: Optional[Callable] = None

    def __post_init__(self):
        for knob, ref in _NOT_PORTED.items():
            if getattr(self, knob) is not None:
                raise NotImplementedError(
                    f"CXL0Config({knob}=...) is not ported yet "
                    f"(reference: {ref})")
        check_mode(self.schedule)

    def open(self, pool: Optional[DSMPool] = None) -> "CXL0Context":
        return CXL0Context(self, pool=pool)


class CommitRegion:
    """``with ctx.commit(step, meta=...) as txn:`` — the Alg. 2 commit
    window as a scope (see the module docstring)."""

    def __init__(self, ctx: "CXL0Context", step: int,
                 meta: Optional[dict] = None):
        self._ctx = ctx
        self.step = step
        self.meta = meta
        #: pre-region HBM value per name stored through this region —
        #: restored on an aborted exit
        self._undo: Dict[str, Tuple[bool, Any]] = {}
        self.stats: Optional[CommitStats] = None

    def store(self, name: str, tree: Any):
        if name not in self._undo:
            hbm = self._ctx.tiers.hbm
            self._undo[name] = (name in hbm, hbm.get(name))
        self._ctx.committer.update({name: tree})

    def store_all(self, objects: Dict[str, Any]):
        for name, tree in objects.items():
            self.store(name, tree)

    def __enter__(self) -> "CommitRegion":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            hbm = self._ctx.tiers.hbm
            for name, (had, prev) in self._undo.items():
                if had:
                    hbm[name] = prev
                else:
                    hbm.pop(name, None)
            return False
        self.stats = self._ctx.committer.commit(self.step, meta=self.meta)
        return False


class CXL0Context:
    """Owns pool / tiers / committer / recovery behind one ``CXL0Config``."""

    def __init__(self, config: CXL0Config, *, pool: Optional[DSMPool] = None):
        if pool is None and config.path is None:
            raise ValueError("CXL0Config needs a pool path (or pass an "
                             "already-open DSMPool)")
        self.config = config
        self.pool = pool if pool is not None else DSMPool(config.path)
        self.placement = None
        # built through TierManager.open: the layering check in
        # tests/test_api.py counts direct constructions anywhere in src/
        # outside repro/dsm
        self.tiers = TierManager.open(self.pool)
        self.committer = DurableCommitter(
            self.tiers, mode=config.schedule, retention=config.retention,
            complete_fn=config.complete_fn)
        self.recovery = RecoveryManager(self.pool)

    def durable(self, name: str, init: Any = None):
        raise NotImplementedError("durable object handles are not ported "
                                  "yet (reference: repro.dsm.api."
                                  "DurableHandle)")

    def transform(self, spec: Any, name: str = "object",
                  recover: bool = True):
        raise NotImplementedError("the §6 transformation is not ported yet "
                                  "(reference: repro.dsm.api."
                                  "TransformedObject)")

    def put(self, objects: Dict[str, Any]):
        """Per-step LStore of new state WITHOUT committing."""
        self.committer.update(objects)

    def commit(self, step: int, meta: Optional[dict] = None) -> CommitRegion:
        return CommitRegion(self, step, meta)

    def drain(self, meta: Optional[dict] = None) -> Optional[CommitStats]:
        return self.committer.drain(meta)

    def recover(self, templates: Dict[str, Any], *,
                exact: bool = True) -> Tuple[Dict[str, Any], int, str]:
        """THE recovery path: the newest fully-CRC-valid manifest.  Raises
        ``ColdStartError`` when nothing is recoverable."""
        return self.recovery.recover(templates, exact=exact)

    def try_recover(self, templates: Dict[str, Any], *,
                    exact: bool = True
                    ) -> Optional[Tuple[Dict[str, Any], int, str]]:
        try:
            return self.recover(templates, exact=exact)
        except ColdStartError:
            return None

    def abort_pending(self):
        self.committer.abort_pending()

    def crash(self):
        """f_i: this worker's volatile tiers vanish.  The pool is
        uninterrupted."""
        self.committer.abort_pending()
        self.tiers.crash()

    def close(self):
        self.tiers.close()

    def __enter__(self) -> "CXL0Context":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def open_cxl0(path, *,
              topology: Optional[str] = None,
              placement: Optional[Any] = None,
              schedule: str = "sync",
              n_shards: Optional[int] = None,
              retention: Optional[int] = None,
              peers: Optional[Any] = None,
              replicate_to: Optional[Any] = None,
              mesh: Optional[Any] = None,
              complete_fn: Optional[Callable] = None) -> CXL0Context:
    """Open a CXL0 context over a pool directory (or an open DSMPool).
    ``peers`` / ``replicate_to`` (peer staging) are not ported yet and
    raise, like ``topology`` and ``mesh``."""
    pool = path if isinstance(path, DSMPool) else None
    cfg = CXL0Config(
        path=path if pool is None else path.path,
        topology=topology, placement=placement,
        schedule=schedule, n_shards=n_shards, retention=retention,
        peers=peers, replicate_to=replicate_to, mesh=mesh,
        complete_fn=complete_fn)
    return cfg.open(pool=pool)
