"""Persistent object pool — the ``M_k`` tier (owner memory); the port of
``repro.dsm.pool``, on-disk compatible with it in both directions.

On-disk layout (one directory per pool)::

    pool/
      objects/<object>/<version>.cxl0      # streamed, self-validating frame
      objects/<object>.s<k>/<version>.cxl0 # shard k of a SHARDED write
      manifest.json                        # CURRENT committed versions
      manifest.<n>.json                    # history (GC-bounded)

Write protocol (MStore / RFlush): stream ``<version>.cxl0`` to a temp name
(one pass, CRC folded as the bytes go out), fsync, atomic rename.  A commit
(completeOp) reserves ``manifest.<n>.json`` with ``O_EXCL`` and atomically
renames the full document over the reservation; the head
``manifest.json`` is a hardlink to the same fsync'd inode.  Readers
validate CRCs; a torn object fails its manifest and recovery falls back
to the previous one.  Frame leaves follow ``jax.tree_util`` order
(``utils.tree``), so frames, shard assignments and manifests equal the
reference's for equal state.

The legacy ``.npz`` write path and reader (pools from before the streamed
format) are not ported: reading one raises ``CorruptObjectError`` naming
the reference.  Sharded ENTRIES are read (a pool the reference wrote under
a sharded schedule recovers here); sharded WRITES come with the sharded
schedules.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.dsm import stream
from repro_torch.utils.tree import tree_flatten, tree_structure


@dataclasses.dataclass
class PoolObject:
    name: str
    version: int
    crc: int
    nbytes: int


@dataclasses.dataclass
class ShardedObject:
    """One logical object written as ``len(shards)`` pool objects
    (``<name>.s<k>``); ``assignment[k]`` lists the leaf indices of shard k."""
    name: str
    version: int
    nbytes: int
    n_leaves: int
    shards: List[PoolObject]
    assignment: List[List[int]]

    def to_entry(self) -> dict:
        return {
            "name": self.name, "version": self.version,
            "nbytes": self.nbytes, "n_leaves": self.n_leaves,
            "sharded": True,
            "shards": [dataclasses.asdict(s) for s in self.shards],
            "assignment": self.assignment,
        }


def manifest_entry(obj) -> dict:
    """Serialize a PoolObject / ShardedObject / ready-made dict for the
    manifest."""
    if isinstance(obj, ShardedObject):
        return obj.to_entry()
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(obj)


def shard_family(name: str) -> str:
    """``params.s3`` -> ``params``; anything else unchanged."""
    base, dot, suffix = name.rpartition(".s")
    if dot and suffix.isdigit():
        return base
    return name


def partition_leaves(nbytes: List[int], n_shards: int) -> List[List[int]]:
    """Byte-balanced partition of leaf indices into ``<= n_shards`` groups
    (greedy: biggest leaf onto the lightest shard).  Never returns an empty
    shard — the shard count is clamped to the leaf count."""
    n_shards = max(1, min(n_shards, len(nbytes)))
    order = sorted(range(len(nbytes)), key=lambda i: -nbytes[i])
    loads = [0] * n_shards
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    for i in order:
        k = min(range(n_shards), key=lambda j: loads[j])
        groups[k].append(i)
        loads[k] += nbytes[i]
    for g in groups:
        g.sort()
    return groups


class CorruptObjectError(Exception):
    pass


class PendingWrite:
    """A streamed-but-not-yet-durable object write: ``finish`` pays the
    fsync and performs the atomic rename."""

    __slots__ = ("_pool", "name", "version", "crc", "nbytes",
                 "_file", "_tmp", "_dst")

    def __init__(self, pool: "DSMPool", name: str, version: int,
                 crc: int, nbytes: int, file, tmp: str, dst: str):
        self._pool = pool
        self.name = name
        self.version = version
        self.crc = crc
        self.nbytes = nbytes
        self._file = file
        self._tmp = tmp
        self._dst = dst

    def finish(self) -> PoolObject:
        """Make the write durable (fsync) and visible (atomic rename)."""
        f, self._file = self._file, None
        try:
            f.flush()
            os.fsync(f.fileno())
        finally:
            f.close()
        os.replace(self._tmp, self._dst)
        self._pool._finalize_write(self.name, self.version, self._dst)
        return PoolObject(self.name, self.version, self.crc, self.nbytes)

    def abort(self):
        """Drop an unfinished write (nothing became visible)."""
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


class DSMPool:
    def __init__(self, path: str):
        self.path = path
        self.obj_dir = os.path.join(path, "objects")
        os.makedirs(self.obj_dir, exist_ok=True)
        self._manifest_seq = self._latest_manifest_seq()
        self._arena = stream.SpillArena()

    # -- low-level object IO -------------------------------------------------
    def _obj_path(self, name: str, version: int) -> str:
        d = os.path.join(self.obj_dir, name)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{version:08d}")

    def payload_path(self, name: str, version: int) -> str:
        return self._obj_path(name, version) + stream.SUFFIX

    def _mkstemp(self, base: str) -> Tuple[int, str]:
        try:
            return tempfile.mkstemp(dir=os.path.dirname(base))
        except FileNotFoundError:
            # a concurrent gc() rmdir'd the (momentarily empty) object dir
            os.makedirs(os.path.dirname(base), exist_ok=True)
            return tempfile.mkstemp(dir=os.path.dirname(base))

    def start_write(self, name: str, version: int, tree,
                    arena: Optional[stream.SpillArena] = None
                    ) -> PendingWrite:
        """Stream one object version onto a temp file (no fsync);
        durability and visibility happen in the handle's ``finish()``."""
        leaves, _ = tree_flatten(tree)
        base = self._obj_path(name, version)
        tmp_fd, tmp_name = self._mkstemp(base)
        f = os.fdopen(tmp_fd, "wb")
        try:
            crc, nbytes, _ = stream.write_frame(f, leaves,
                                                arena or self._arena)
        except BaseException:
            f.close()
            try:
                os.unlink(tmp_name)
            except OSError:
                pass
            raise
        return PendingWrite(self, name, version, crc, nbytes, f,
                            tmp_name, base + stream.SUFFIX)

    def write_object(self, name: str, version: int, tree) -> PoolObject:
        """Durable write of one object version (MStore semantics: complete
        only once on physical storage)."""
        pending = self.start_write(name, version, tree)
        try:
            return pending.finish()
        except BaseException:
            pending.abort()
            raise

    def _finalize_write(self, name: str, version: int, payload_path: str):
        """Hook after a payload's atomic rename (the reference's fault
        layer tears payloads here)."""

    def max_version(self, name: str) -> int:
        """Highest version on disk for ``name`` including its shard objects
        and torn/unreferenced files — a fresh incarnation seeds its version
        counter above this."""
        best = 0
        parent = os.path.dirname(os.path.join(self.obj_dir, name))
        base = os.path.basename(name)
        prefix = base + ".s"
        if not os.path.isdir(parent):
            return 0
        for d in os.listdir(parent):
            if d != base and not (d.startswith(prefix)
                                  and d[len(prefix):].isdigit()):
                continue
            p = os.path.join(parent, d)
            if not os.path.isdir(p):
                continue
            for fn in os.listdir(p):
                stem = fn.split(".")[0]
                if stem.isdigit():
                    best = max(best, int(stem))
        return best

    def read_object(self, name: str, version: int, treedef_like,
                    expected_crc: Optional[int] = None) -> Any:
        """Read + CRC-validate one object version into ``treedef_like``'s
        structure (host tensors viewing a private mapping of the file);
        raises CorruptObjectError on any mismatch."""
        base = self._obj_path(name, version)
        if not os.path.exists(base + stream.SUFFIX) \
                and os.path.exists(base + ".npz"):
            raise CorruptObjectError(
                f"{name}@{version}: legacy .npz object — its reader is not "
                f"ported (reference: repro.dsm.pool.DSMPool.read_object)")
        try:
            leaves, crc, _ = stream.read_frame(base + stream.SUFFIX)
        except (stream.FrameError, OSError) as e:
            raise CorruptObjectError(f"{name}@{version}: {e}") from e
        if expected_crc is not None and crc != expected_crc:
            raise CorruptObjectError(
                f"{name}@{version}: content does not match the "
                f"manifest (overwritten by a later write?)")
        return tree_structure(treedef_like).unflatten(leaves)

    # -- manifests (completeOp) ----------------------------------------------
    def _latest_manifest_seq(self) -> int:
        best = -1
        for fn in os.listdir(self.path):
            if fn.startswith("manifest.") and fn.endswith(".json"):
                mid = fn[len("manifest."):-len(".json")]
                if mid.isdigit():
                    best = max(best, int(mid))
        return best

    def _reserve_manifest_seq(self) -> Tuple[int, str]:
        """O_EXCL-reserve the next manifest sequence number, re-scanning
        and retrying on collision (multi-writer safe)."""
        while True:
            seq = max(self._latest_manifest_seq(), self._manifest_seq) + 1
            dst = os.path.join(self.path, f"manifest.{seq}.json")
            try:
                fd = os.open(dst, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._manifest_seq = seq
                continue
            os.close(fd)
            return seq, dst

    def commit_manifest(self, step: int, objects: Dict[str, Any],
                        meta: Optional[dict] = None) -> int:
        """Atomic commit: the step is durable iff the full manifest document
        replaced its reservation.  The document is serialized and fsync'd
        once; the head ``manifest.json`` is a hardlink to that inode (a
        second write where hardlinks are missing)."""
        seq, dst = self._reserve_manifest_seq()
        self._manifest_seq = seq
        doc = {
            "seq": seq,
            "step": step,
            "objects": {name: manifest_entry(o)
                        for name, o in objects.items()},
            "meta": meta or {},
        }
        tmp = os.path.join(self.path, f".manifest.tmp.{seq}")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        head = os.path.join(self.path, "manifest.json")
        tmp2 = os.path.join(self.path, f".manifest.head.tmp.{seq}")
        try:
            os.link(tmp, tmp2)
        except OSError:
            tmp2 = None
        os.replace(tmp, dst)
        if tmp2 is None:
            tmp2 = os.path.join(self.path, f".manifest.head.tmp.{seq}")
            with open(tmp2, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp2, head)
        return seq

    def read_entry(self, name: str, entry: dict, treedef_like) -> Any:
        """Read + validate one manifest entry, plain or sharded, against the
        manifest-recorded CRCs.  Any torn or corrupt shard raises
        CorruptObjectError for the WHOLE object."""
        if not entry.get("sharded"):
            return self.read_object(name, entry["version"], treedef_like,
                                    expected_crc=entry.get("crc"))
        leaves: List[Any] = [None] * entry["n_leaves"]
        for sh, idxs in zip(entry["shards"], entry["assignment"]):
            part = self.read_object(sh["name"], sh["version"],
                                    [0] * len(idxs),
                                    expected_crc=sh.get("crc"))
            for i, a in zip(idxs, part):
                leaves[i] = a
        if any(l is None for l in leaves):
            raise CorruptObjectError(
                f"{name}@{entry['version']}: incomplete shard assignment")
        return tree_structure(treedef_like).unflatten(leaves)

    def manifests_desc(self) -> List[dict]:
        """All manifests, newest first by (step, seq); unparseable files
        (reservations whose writer died before the rename) are skipped."""
        out = []
        for fn in os.listdir(self.path):
            if fn.startswith("manifest.") and fn.endswith(".json"):
                mid = fn[len("manifest."):-len(".json")]
                if not mid.isdigit():
                    continue
                try:
                    with open(os.path.join(self.path, fn)) as f:
                        out.append(json.load(f))
                except (OSError, ValueError):
                    continue
        return sorted(out, key=lambda d: (-d["step"], -d["seq"]))

    def latest_manifest(self) -> Optional[dict]:
        ms = self.manifests_desc()
        return ms[0] if ms else None

    def gc(self, keep: int = 3):
        """Drop all but the newest ``keep`` manifests + versions no kept
        manifest references (plain or sharded, namespaced names included),
        emptied object dirs and dead reservations.  An unreferenced version
        NEWER than every kept reference of its object family may be a
        concurrent writer's in-flight commit and is never deleted."""
        keep = max(1, keep)
        ms = self.manifests_desc()
        keep_ms, drop_ms = ms[:keep], ms[keep:]
        live = set()
        watermark: Dict[str, int] = {}

        def _mark(name: str, version: int):
            fam = shard_family(name)
            watermark[fam] = max(watermark.get(fam, 0), version)

        for m in keep_ms:
            for n, o in m["objects"].items():
                if o.get("sharded"):
                    for s in o["shards"]:
                        live.add((s["name"], s["version"]))
                        _mark(s["name"], s["version"])
                else:
                    live.add((n, o["version"]))
                    _mark(n, o["version"])
        for m in drop_ms:
            try:
                os.unlink(os.path.join(self.path,
                                       f"manifest.{m['seq']}.json"))
            except OSError:
                pass
        if keep_ms:
            min_kept = min(m["seq"] for m in keep_ms)
            parsed = {m["seq"] for m in ms}
            for fn in os.listdir(self.path):
                if not (fn.startswith("manifest.") and fn.endswith(".json")):
                    continue
                mid = fn[len("manifest."):-len(".json")]
                if mid.isdigit() and int(mid) < min_kept \
                        and int(mid) not in parsed:
                    try:
                        os.unlink(os.path.join(self.path, fn))
                    except OSError:
                        pass
        for dirpath, dirnames, filenames in os.walk(self.obj_dir,
                                                    topdown=False):
            name = os.path.relpath(dirpath, self.obj_dir).replace(os.sep, "/")
            for fn in filenames:
                stem = fn.split(".")[0]
                if not stem.isdigit():
                    continue        # tempfile from a crashed write
                v = int(stem)
                if (name, v) in live:
                    continue
                fam = shard_family(name)
                if fam in watermark and v > watermark[fam]:
                    continue
                try:
                    os.unlink(os.path.join(dirpath, fn))
                except OSError:
                    pass
            if dirpath != self.obj_dir:
                try:
                    os.rmdir(dirpath)       # fails (harmlessly) if non-empty
                except OSError:
                    pass
