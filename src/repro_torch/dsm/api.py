"""CXL0Context — the programming-model API over the DSM runtime; the port
of ``repro.dsm.api``.

    from repro_torch.dsm.api import open_cxl0

    ctx = open_cxl0(pool_dir, schedule="sharded-async", n_shards=4)
    with ctx.commit(step, meta={"tag": "demo"}) as txn:
        txn.store("params", params)          # LStore
    objs, step, source = ctx.recover(templates)   # newest valid manifest

* **commit regions** — ``with ctx.commit(step, meta=...) as txn:`` LStores
  through ``txn.store``; on clean exit every HBM object is RFlushed and
  exactly one completeOp (atomic manifest rename) is emitted.  An
  exception inside the region emits NO completeOp and takes the region's
  stores back out of the volatile tier: recovery lands on the previous
  commit — the crash-anywhere contract.  Under the ``async`` /
  ``sharded-async`` schedules the completeOp emitted at exit publishes the
  PREVIOUS region, whose flushes overlapped compute (``ctx.drain()``
  publishes the last one);
* **durable object handles** — ``h = ctx.durable(name, init=tree)``
  with the primitive vocabulary verbatim: ``h.lstore(tree)``,
  ``h.rflush()``, ``h.mstore(tree)``; completeOp stays with commit
  regions and ``ctx.transform``;
* **§6 transformation** — ``ctx.transform(spec)`` wraps any linearizable
  object given as a sequential spec (``repro_torch.core.objects.SeqSpec``)
  with FliT-for-CXL0 at op granularity: every op LStores the post-state,
  RFlushes it and completeOps.  Frames and manifests equal the
  reference's byte for byte, so each package recovers the other's object;
* ``ctx.crash()`` / ``ctx.recover()`` — f_i and THE recovery path.

The four schedules ``sync`` / ``async`` / ``sharded`` / ``sharded-async``
and ``n_shards`` are ported (``repro_torch.dsm.flit_runtime``), and so are
``topology=`` / ``placement=`` (``dsm.emu``, ``dsm.placement``): the
policy prices the shard count and resolves the ``"auto"`` schedule at the
first commit.  Peer staging is wired as in the reference: ``peers`` are
recovery sources (anything with a ``.staging`` mapping — a TierManager, a
``CXL0Context``, a cluster staging view), ``replicate_to`` is the RStore
target of every ``put`` (tagged with the step), and a newer consistent
staged copy beats the pool at recovery.  ``worker_id`` names the flush
threads, and ``fault_hook(point, step)`` fires inside the commit window
(``pre_flush``, ``mid_flush``, ``post_completeOp``).  ``mesh`` (a
``launch.mesh.Mesh``) makes the sharded schedules commit device-local, as
the reference's does (``dsm.meshio``): each shard pipeline copies its own
leaves' per-place blocks, and nothing is gathered.  The port's default
schedule is ``"sync"`` (the reference's is ``"auto"``, which without a
topology resolves to ``"sharded-async"`` in both).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dsm.flit_runtime import (AUTO_MODE, CommitStats,
                                          DurableCommitter, check_mode)
from repro_torch.dsm.pool import DSMPool, PoolObject
from repro_torch.dsm.recovery import ColdStartError, RecoveryManager
from repro_torch.dsm.tiers import TierManager


#: what ``schedule="auto"`` resolves to when no topology or policy is
#: configured (the reference's production default)
DEFAULT_SCHEDULE = "sharded-async"


@dataclasses.dataclass
class CXL0Config:
    """Every wiring knob of the tier stack in one place: ``path`` /
    ``worker_id`` locate the pool and name the worker; ``peers`` are
    recovery sources and ``replicate_to`` the RStore target (an empty
    ``peers`` means none); ``fault_hook(point, step)`` and ``complete_fn``
    are the scenario / cluster extension points."""

    path: Optional[str] = None
    worker_id: int = 0
    topology: Optional[str] = None
    schedule: str = "sync"
    n_shards: Optional[int] = None
    retention: Optional[int] = None
    peers: Tuple[Any, ...] = ()
    replicate_to: Optional[Any] = None
    placement: Optional[Any] = None
    mesh: Optional[Any] = None
    fault_hook: Optional[Callable[[str, int], None]] = None
    complete_fn: Optional[Callable] = None

    def __post_init__(self):
        self.peers = tuple(self.peers or ())
        if self.schedule != AUTO_MODE:      # "auto" resolves at open time
            check_mode(self.schedule)

    def resolved_placement(self):
        """The PlacementPolicy this stack runs under: an explicit policy
        wins; else one is built from ``topology``; else None."""
        if self.placement is not None:
            return self.placement
        if self.topology is not None:
            from repro_torch.dsm.placement import PlacementPolicy
            return PlacementPolicy(self.topology)
        return None

    def resolved_schedule(self, placement=None) -> str:
        """``"auto"`` defers to the placement policy when one is configured
        (the committer prices the flush at the first commit) and otherwise
        takes ``DEFAULT_SCHEDULE``; explicit schedules pass through."""
        if self.schedule != AUTO_MODE:
            return self.schedule
        if placement is not None or self.placement is not None \
                or self.topology is not None:
            return AUTO_MODE
        return DEFAULT_SCHEDULE

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


@dataclasses.dataclass
class DurableHandle:
    """A named durable object: the paper's primitive vocabulary, verbatim,
    over the context's tier stack.  completeOp is not a handle method —
    it belongs to commit regions (``ctx.commit``) and the §6 transform."""

    ctx: "CXL0Context"
    name: str

    def lstore(self, tree: Any) -> "DurableHandle":
        """Update the volatile HBM tier (completes immediately)."""
        self.ctx.tiers.lstore(self.name, tree)
        return self

    def rstore(self, peer: Any = None, tag: Optional[int] = None):
        """Stage the current value into a peer's host buffer (it survives
        OUR crash).  ``peer`` defaults to the context's replication
        target."""
        peer = peer if peer is not None else self.ctx.committer.replicate_to
        if peer is None:
            raise ValueError(f"rstore({self.name!r}): no peer given and the "
                             f"context has no replicate_to target")
        self.ctx.tiers.rstore(self.name, peer, tag=tag)

    def rflush(self) -> PoolObject:
        """Durable write into the pool; returns once on storage."""
        return self.ctx.tiers.rflush(self.name)

    def mstore(self, tree: Any) -> PoolObject:
        """lstore + rflush fused (Prop. 1.8)."""
        return self.ctx.tiers.mstore(self.name, tree)

    @property
    def value(self) -> Any:
        return self.ctx.tiers.hbm.get(self.name)

    @property
    def version(self) -> int:
        return self.ctx.tiers.versions.get(self.name, 0)


# -- §6 transformation at object granularity --------------------------------

def _encode_state(state) -> Dict[str, np.ndarray]:
    """Spec states (ints / nested tuples) as a pool-storable tree: the
    reference's encoding, so the frames are byte-equal."""
    raw = json.dumps(state).encode()
    return {"state": np.frombuffer(raw, np.uint8).copy()}


def _decode_state(tree) -> Any:
    """The inverse of ``_encode_state`` on a recovered tree (host tensors)."""
    def tup(x):
        return tuple(tup(i) for i in x) if isinstance(x, list) else x
    return tup(json.loads(tree["state"].numpy().tobytes().decode()))


_STATE_TEMPLATE = {"state": np.zeros(0, np.uint8)}


class TransformedObject:
    """The paper's §6 FliT-for-CXL0 transformation applied to any
    linearizable object given as a sequential spec (``initial()`` +
    ``apply(state, op, args) -> (state', result)``); every ``op()`` runs
    Alg. 2 at op granularity:

        LStore(state') ; RFlush(state') ; completeOp (atomic manifest rename)

    so an op that returned to its caller survives any crash, and a crash
    mid-op is invisible: recovery (the shared ``ctx.recover`` path) lands on
    the newest completed op.  The op index is the commit step, so
    ``ops_done`` is the step of the newest completeOp."""

    def __init__(self, ctx: "CXL0Context", spec: Any, name: str = "object",
                 recover: bool = True):
        self.ctx = ctx
        self.spec = spec
        self.name = name
        self.state = spec.initial()
        self.ops_done = -1                    # step of the newest completeOp
        self.recovered_from: Optional[Tuple[int, str]] = None
        if recover:
            got = ctx.try_recover({name: _STATE_TEMPLATE}, exact=False)
            if got is not None:
                objs, step, source = got
                self.state = _decode_state(objs[name])
                self.ops_done = step
                self.recovered_from = (step, source)

    def op(self, op: str, *args) -> Any:
        """Apply one operation durably (Alg. 2 at op granularity)."""
        new_state, result = self.spec.apply(self.state, op, args)
        step = self.ops_done + 1
        self.ctx.tiers.lstore(self.name, _encode_state(new_state))  # LStore
        obj = self.ctx.tiers.rflush(self.name)                      # RFlush
        self.ctx.pool.commit_manifest(                              # completeOp
            step, {self.name: obj},
            meta={"kind": "flit-object", "object": self.name})
        self.state = new_state
        self.ops_done = step
        return result


class CXL0Context:
    """Owns pool / tiers / committer / recovery behind one ``CXL0Config``."""

    def __init__(self, config: CXL0Config, *, pool: Optional[DSMPool] = None):
        if pool is None and config.path is None:
            raise ValueError("CXL0Config needs a pool path (or pass an "
                             "already-open DSMPool)")
        self.config = config
        self.pool = pool if pool is not None else DSMPool(config.path)
        self.placement = config.resolved_placement()
        # built through TierManager.open: the layering check in
        # tests/test_api.py counts direct constructions anywhere in src/
        # outside repro/dsm
        self.tiers = TierManager.open(self.pool, config.worker_id)
        self.peers: Tuple[Any, ...] = config.peers
        self.committer = DurableCommitter(
            self.tiers, mode=config.resolved_schedule(self.placement),
            replicate_to=config.replicate_to, n_shards=config.n_shards,
            retention=config.retention, fault_hook=config.fault_hook,
            placement=self.placement, mesh=config.mesh,
            complete_fn=config.complete_fn)
        self.recovery = RecoveryManager(self.pool)

    @property
    def staging(self) -> Dict[str, Tuple[int, Any]]:
        """Peer-staged copies held BY this worker: a context is an RStore
        target wherever a ``.staging``-bearing peer is expected."""
        return self.tiers.staging

    @property
    def worker_id(self) -> int:
        return self.config.worker_id

    def durable(self, name: str, init: Any = None) -> DurableHandle:
        """A named durable-object handle; ``init`` LStores an initial value
        if the object is not already in the HBM tier."""
        if init is not None and name not in self.tiers.hbm:
            self.tiers.lstore(name, init)
        return DurableHandle(self, name)

    def transform(self, spec: Any, name: str = "object",
                  recover: bool = True) -> TransformedObject:
        """Apply the §6 transformation to a linearizable object (see
        ``TransformedObject``)."""
        return TransformedObject(self, spec, name=name, recover=recover)

    def put(self, objects: Dict[str, Any], step: Optional[int] = None):
        """Per-step LStore of new state (and the RStore replication, when
        configured, tagged ``step``) WITHOUT committing."""
        self.committer.update(objects, step=step)

    def commit(self, step: int, meta: Optional[dict] = None) -> CommitRegion:
        return CommitRegion(self, step, meta)

    def drain(self, meta: Optional[dict] = None) -> Optional[CommitStats]:
        return self.committer.drain(meta)

    def recover(self, templates: Dict[str, Any],
                peers: Optional[Sequence[Any]] = None, *,
                exact: bool = True) -> Tuple[Dict[str, Any], int, str]:
        """THE recovery path: a surviving peer's RStore-staged copy beats
        the pool when newer; else the newest fully-CRC-valid manifest.
        ``peers`` defaults to the context's; raises ``ColdStartError``
        when nothing is recoverable."""
        use = tuple(peers) if peers is not None else self.peers
        return self.recovery.recover(templates, use, exact=exact)

    def try_recover(self, templates: Dict[str, Any],
                    peers: Optional[Sequence[Any]] = None, *,
                    exact: bool = True
                    ) -> Optional[Tuple[Dict[str, Any], int, str]]:
        try:
            return self.recover(templates, peers, exact=exact)
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


def open_cxl0(path, worker_id: int = 0, *,
              topology: Optional[str] = None,
              placement: Optional[Any] = None,
              schedule: str = "sync",
              n_shards: Optional[int] = None,
              retention: Optional[int] = None,
              peers: Sequence[Any] = (),
              replicate_to: Optional[Any] = None,
              mesh: Optional[Any] = None,
              fault_hook: Optional[Callable[[str, int], None]] = None,
              complete_fn: Optional[Callable] = None) -> CXL0Context:
    """Open a CXL0 context over a pool directory (or an open DSMPool), with
    the reference's signature."""
    pool = path if isinstance(path, DSMPool) else None
    cfg = CXL0Config(
        path=path if pool is None else path.path,
        worker_id=worker_id, topology=topology, placement=placement,
        schedule=schedule, n_shards=n_shards, retention=retention,
        peers=tuple(peers), replicate_to=replicate_to, mesh=mesh,
        fault_hook=fault_hook, complete_fn=complete_fn)
    return cfg.open(pool=pool)
