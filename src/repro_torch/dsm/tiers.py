"""Tier manager: HBM / host-staging / pool with CXL0 primitive semantics —
the port of ``repro.dsm.tiers``.

Per worker, per object:

* ``lstore(name, tree)``  — update the HBM tier (in-memory reference, no
                            copy).  Marks dirty; seeds the version counter
                            above every version already on disk.
* ``ldiscard(name)``      — drop an object from the HBM tier.
* ``rflush(name)``        — durable write of the current HBM value into the
                            pool; completes only when on storage (fsync).
* ``mstore(name, tree)``  — lstore + rflush fused (Prop. 1.8).
* ``rstore(name, peer)``  — stage the current value into a PEER's host
                            buffer (``peer.staging``): it survives OUR
                            crash.  ``rload(name)`` reads back a copy a
                            peer staged into this worker's ``staging``.

A background ``flush_async`` thread overlaps rflush I/O with compute; the
commit barrier (``DurableCommitter``) joins it before completeOp.

Sharded variants (``rflush_sharded`` / ``flush_async_sharded``) partition
the object's flattened leaves into byte-balanced shards and run one
LStore/RFlush pipeline per shard on a thread pool — the write path of the
sharded / sharded-async commit schedules.  The shard writes are
SPLIT-PHASE (``DSMPool.start_write`` -> ``PendingWrite.finish``):
serialization / CRC of shard k+1 streams on the flush pool while shard k's
fsync runs on a one-thread fsync lane.
``flush_wait`` joins either flavor; ``abort_flushes`` joins-and-discards
every outstanding write (crash recovery: a stale in-flight write can never
land AFTER a new incarnation started reusing version numbers).

Snapshots.  The reference snapshots by reference, since jax arrays are
immutable; torch tensors are not.  So every async or sharded flush takes
its snapshot to the host AT LAUNCH, on the caller's thread: a CUDA leaf
through ONE counted ``.cpu()`` (``d2h_gather_bytes``), and, for the
asynchronous flushes, a host leaf the caller still holds through a copy
(``.cpu()`` of a host tensor is the tensor itself).  A flush thread never
sees a CUDA tensor or a tensor the caller may write later.

Peer staging copies to the host where the reference does: a peer whose
``staging`` declares ``materializes_leaves`` (the spill-file buffer of
``dsm.cluster``) gets the tree as it is and copies each leaf to the host
as it writes the frame, through this manager's counted ``to_host``; any
other peer gets a counted host snapshot up front.  Either way the bytes
staged from the card show in ``d2h_gather_bytes``.  The device-local
(mesh) shard pipelines are not ported yet.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dsm.pool import (DSMPool, PoolObject, ShardedObject,
                                  partition_leaves)
from repro_torch.utils.tree import tree_flatten


def leaf_nbytes(leaf: Any) -> int:
    """Payload bytes of one leaf (a tensor or anything numpy takes)."""
    if isinstance(leaf, torch.Tensor):
        return int(leaf.nbytes)
    return int(np.asarray(leaf).nbytes)


class TierManager:
    def __init__(self, pool: DSMPool, worker_id: int = 0):
        self.pool = pool
        #: names this worker's flush threads (``rflush-w<id>``)
        self.worker_id = worker_id
        self.hbm: Dict[str, Any] = {}               # C_i — device tier
        #: peer-staged copies: name -> (tag, host tree) staged INTO this
        #: worker by peers' rstore
        self.staging: Dict[str, Tuple[int, Any]] = {}
        self.versions: Dict[str, int] = {}
        self.flit_counter: Dict[str, int] = {}
        self._flush_threads: Dict[str, threading.Thread] = {}
        self._flush_results: Dict[str, PoolObject] = {}
        self._flush_errors: Dict[str, BaseException] = {}
        #   name -> (version, n_leaves, assignment, shard futures)
        self._sharded_futures: Dict[
            str, Tuple[int, int, List[List[int]], List[Future]]] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        self._fsync_lane: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        #: D2H accounting (bytes): whole-leaf host gathers of the flush
        #: and paging paths (``d2h_gather_bytes``) and, kept for the
        #: device-local shard pipelines to come, per-buffer copies
        #: (``d2h_shard_bytes``)
        self.d2h_gather_bytes = 0
        self.d2h_shard_bytes = 0

    @classmethod
    def open(cls, pool: DSMPool, worker_id: int = 0) -> "TierManager":
        """The tier stack over ``pool`` — how the dsm layer
        (``CXL0Context``) builds one."""
        return cls(pool, worker_id)

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

    def _snapshot_leaves(self, name: str, own: bool) -> List[Any]:
        """The object's leaves on the host, taken NOW on the caller's
        thread.  ``own``: also copy each host leaf that the caller still
        holds, so a later in-place write cannot reach a flush still in
        flight."""
        out = []
        for leaf in tree_flatten(self.hbm[name])[0]:
            host = self.to_host(leaf)
            if own and host is leaf:
                host = (leaf.clone() if isinstance(leaf, torch.Tensor)
                        else np.array(leaf, copy=True))
            out.append(host)
        return out

    def _get_executor(self, n_workers: int) -> ThreadPoolExecutor:
        """One lazily-created pool of flush pipelines, sized by the first
        sharded flush (the shard count is constant for a run)."""
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=max(1, n_workers),
                thread_name_prefix=f"rflush-w{self.worker_id}")
        return self._executor

    def _get_fsync_lane(self) -> ThreadPoolExecutor:
        """One-thread executor that only runs ``PendingWrite.finish``
        (fsync + rename): the flush pool keeps serializing / CRC-ing the
        NEXT shard while the current one flushes — fsync releases the GIL,
        so the pipeline overlaps even on a single CPU."""
        with self._lock:
            if self._fsync_lane is None:
                self._fsync_lane = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"fsync-w{self.worker_id}")
            return self._fsync_lane

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

    def rstore(self, name: str, peer: Any, tag: Optional[int] = None):
        """Stage our current value into a peer's host buffer: on our crash
        the peer still holds it.  ``tag`` (a step) makes staged copies
        comparable with pool manifests; it defaults to the version.
        ``peer`` is anything exposing a ``.staging`` mapping: a
        TierManager, a ``CXL0Context`` or a ``dsm.cluster.StagingProxy``.

        The D2H copy is DEFERRED when the peer's buffer declares
        ``materializes_leaves``: it is handed ``to_host`` and copies each
        leaf as it writes its frame, so an emulator-priced placement can
        reject the spill before any copy is paid.  In-process peers get
        a counted host snapshot now."""
        tree = self.hbm[name]
        tag = self.versions.get(name, 0) if tag is None else tag
        if getattr(peer.staging, "materializes_leaves", False):
            peer.staging.put(name, tag, tree, self.to_host)
        else:
            peer.staging[name] = (tag, self._to_host_counted(tree))

    def rload(self, name: str) -> Optional[Any]:
        """Read back a value a peer staged INTO this worker's host buffer.
        Returns the host tree or None."""
        staged = self.staging.get(name)
        return None if staged is None else staged[1]

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

    # -- sharded flush (parallel per-shard RFlush pipelines) -----------------
    def _shard_submit(self, name: str, n_shards: int, *, own: bool,
                      post_first_shard: Optional[Callable] = None,
                      device_local: bool = False
                      ) -> Tuple[int, int, List[List[int]], List[Future]]:
        """Snapshot the object NOW (``_snapshot_leaves``), partition its
        leaves into byte-balanced shards and submit one write per shard to
        the flush pool as a split-phase pipeline.  ``post_first_shard``
        runs once the FIRST shard is durable, before the rest are joined —
        the mid-flush fault-injection point."""
        if device_local:
            raise NotImplementedError(
                "device-local (mesh) shard pipelines are not ported yet "
                "(reference: repro.dsm.meshio)")
        version = self.versions.get(name, 0)
        leaves = self._snapshot_leaves(name, own)
        assignment = partition_leaves([leaf_nbytes(l) for l in leaves],
                                      n_shards)
        shards = [[leaves[i] for i in idxs] for idxs in assignment]
        ex = self._get_executor(len(assignment))
        futs = []
        try:
            for k, shard in enumerate(shards):
                futs.append(self._submit_split_phase(
                    ex, f"{name}.s{k}", version, shard))
                if k == 0 and post_first_shard is not None:
                    futs[0].result()
                    post_first_shard()
        except BaseException:
            # already-submitted shard writes must fully land (or fail)
            # before the caller unwinds: an untracked stale write could
            # race a later incarnation's version reuse
            for f in futs:
                try:
                    f.result()
                except Exception:
                    pass
            raise
        return version, len(leaves), assignment, futs

    def _submit_split_phase(self, ex: ThreadPoolExecutor, name: str,
                            version: int, leaves) -> Future:
        """One shard write as a two-stage pipeline: the flush pool thread
        serializes + CRCs the frame (``start_write``, no fsync), then hands
        the pending write to the fsync lane for ``finish`` (fsync + atomic
        rename).  The returned future resolves only after the rename — the
        durability point of a monolithic ``write_object``."""
        out: Future = Future()

        def serialize():
            try:
                pending = self.pool.start_write(name, version, leaves)
            except BaseException as e:
                out.set_exception(e)
                return

            def finish():
                try:
                    out.set_result(pending.finish())
                except BaseException as e:
                    try:
                        pending.abort()
                    except Exception:
                        pass
                    out.set_exception(e)
            try:
                self._get_fsync_lane().submit(finish)
            except BaseException as e:     # lane torn down mid-shutdown
                pending.abort()
                out.set_exception(e)

        ex.submit(serialize)
        return out

    def _shard_join(self, name: str, version: int, n_leaves: int,
                    assignment: List[List[int]],
                    futs: List[Future]) -> ShardedObject:
        """Join EVERY shard future (a failed shard must not leave later
        shards' writes in flight), then surface the first failure."""
        shards, first_err = [], None
        for f in futs:
            try:
                shards.append(f.result())
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return ShardedObject(name, version,
                             sum(s.nbytes for s in shards),
                             n_leaves, shards, assignment)

    def rflush_sharded(self, name: str, n_shards: int,
                       post_first_shard: Optional[Callable] = None,
                       device_local: bool = False) -> ShardedObject:
        """Blocking sharded durable write: all shards written in parallel,
        returns once every shard is on storage."""
        self.flit_counter[name] = self.flit_counter.get(name, 0) + 1
        try:
            return self._shard_join(
                name, *self._shard_submit(name, n_shards, own=False,
                                          post_first_shard=post_first_shard,
                                          device_local=device_local))
        finally:
            self.flit_counter[name] -= 1

    def flush_async_sharded(self, name: str, n_shards: int,
                            post_first_shard: Optional[Callable] = None,
                            device_local: bool = False):
        """Start a sharded durable write in the background (the double-
        buffered commit path); join via flush_wait.  The FliT counter
        stays raised until the join."""
        self.flit_counter[name] = self.flit_counter.get(name, 0) + 1
        try:
            self._sharded_futures[name] = self._shard_submit(
                name, n_shards, own=True, post_first_shard=post_first_shard,
                device_local=device_local)
        except BaseException:
            self.flit_counter[name] -= 1     # nothing tracked -> no join
            raise

    # -- async flush (compute/IO overlap) ------------------------------------
    def flush_async(self, name: str):
        """Start a durable write in the background; join via flush_wait.
        The FliT counter stays raised until the write completes."""
        self.flit_counter[name] = self.flit_counter.get(name, 0) + 1
        version = self.versions.get(name, 0)
        treedef = tree_flatten(self.hbm[name])[1]
        host_copy = treedef.unflatten(                       # snapshot NOW
            self._snapshot_leaves(name, own=True))

        def work():
            # a failed write surfaces at the join (flush_wait), and the
            # FliT counter comes back down either way
            try:
                obj = self.pool.write_object(name, version, host_copy)
            except BaseException as e:
                with self._lock:
                    self._flush_errors[name] = e
            else:
                with self._lock:
                    self._flush_results[name] = obj
            finally:
                with self._lock:
                    self.flit_counter[name] -= 1

        t = threading.Thread(target=work, daemon=True)
        self._flush_threads[name] = t
        t.start()

    def flush_wait(self, name: str):
        """Join one outstanding async flush (threaded or sharded); returns
        the PoolObject / ShardedObject for the manifest.  A write that
        failed in the background re-raises HERE — the commit is simply not
        durable (no manifest)."""
        pending = self._sharded_futures.pop(name, None)
        if pending is not None:
            try:
                return self._shard_join(name, *pending)
            finally:
                self.flit_counter[name] -= 1
        t = self._flush_threads.pop(name, None)
        if t is not None:
            t.join()
        with self._lock:
            err = self._flush_errors.pop(name, None)
            if err is not None:
                raise err
            return self._flush_results.pop(name)

    def abort_flushes(self):
        """Join-and-discard every outstanding async write (crash recovery:
        a stale write must fully land, or fail, BEFORE the next
        incarnation reuses version numbers)."""
        for name, (_, _, _, futs) in list(self._sharded_futures.items()):
            for f in futs:
                try:
                    f.result()
                except Exception:
                    pass
            self.flit_counter[name] -= 1
        self._sharded_futures.clear()
        for t in list(self._flush_threads.values()):
            t.join()            # work()'s finally lowered the counter
        self._flush_threads.clear()
        with self._lock:
            self._flush_results.clear()
            self._flush_errors.clear()

    def close(self):
        """Release the flush thread pool and fsync lane (idempotent;
        lazily recreated if another sharded flush happens)."""
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        with self._lock:
            lane, self._fsync_lane = self._fsync_lane, None
        if lane is not None:
            lane.shutdown(wait=False)

    # -- crash ----------------------------------------------------------------
    def crash(self):
        """f_i: all volatile tiers of this worker vanish."""
        self.abort_flushes()
        self.close()
        self.hbm.clear()
        self.staging.clear()
        self.versions.clear()
        self.flit_counter.clear()
