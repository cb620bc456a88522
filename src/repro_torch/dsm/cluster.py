"""Multi-writer cluster protocol: N worker processes over ONE shared pool
— the port of ``repro.dsm.cluster``.

The paper's setting is several hosts sharing one CXL pool, where a crash
takes out one host's caches and everything else keeps running.  This
module is that setting at process scale:

* **per-worker namespaces** — rank *i* commits its objects as
  ``w<i>/<name>`` (``rank_ns``), so N writers never collide on object
  files; version counters are seeded from the shared pool
  (``TierManager.lstore`` / ``DSMPool.max_version``);
* **rank records + elected cluster completeOp** (``ClusterProtocol``) —
  each rank's flush ends with an atomic rank record
  (``records/g<gen>/s<step>/r<i>.json``) listing its objects' manifest
  entries; the last rank to record sees the full set and commits ONE
  cluster manifest referencing every rank's objects at that step.  At
  most one rank wins the per-step ``O_EXCL`` commit marker, and the
  manifest's sequence number is ``O_EXCL``-reserved
  (``DSMPool.commit_manifest``), so concurrent committers never clobber
  a completed commit;
* **cross-process staging** (``FileStagingArea``) — RStore's peer host
  buffer as spill files: ``root/w<i>/`` is worker (or engine) *i*'s
  buffer, ``proxy(i)`` the write side (a ``StagingProxy`` whose
  ``.staging`` takes ``TierManager.rstore``), ``view(i, templates)`` the
  read side (a ``StagedView`` shaped like a TierManager peer) and
  ``wipe(i)`` worker *i*'s crash.  Each entry is a streamed ``.cxl0``
  frame plus a JSON meta carrying the frame's CRC, both written by atomic
  rename and neither fsync'd (volatile by contract); a torn frame, or a
  meta whose CRC does not match the frame beside it, reads back as
  absent;
* **membership plumbing** (``ControlPlane``, ``ScalarReduceBoard``) — a
  lockstep all-reduce board doubles as the failure detector: survivors
  blocked on a dead rank's contribution learn the new membership from
  the control plane and raise ``MembershipChange``.

Records, cluster manifests, staging frames and metas equal the
reference's byte for byte for equal inputs, and each package reads the
other's.  ``FileStagingArea(legacy_format=True)`` writes the legacy spill
format instead (an ``np.savez`` payload and an fsync'd meta carrying the
dtypes and shapes), kept to fabricate old staging areas and as the
benchmarks' baseline; ``view`` reads both formats.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dsm import stream
from repro_torch.dsm.pool import (DSMPool, _crc_of_arrays, _plain_to_host,
                                  decode_arrays, encode_arrays,
                                  manifest_entry)
from repro_torch.utils.tree import tree_leaves, tree_structure

#: polling period of the file-based rendezvous primitives (seconds)
POLL_S = 0.02


def rank_ns(rank: int, name: str) -> str:
    """The per-worker object namespace: ``w<i>/<name>``."""
    return f"w{rank}/{name}"


def ring_sibling(rank: int, live: Sequence[int]) -> int:
    """The staging target of ``rank`` in the ring over the live rank set:
    each rank RStores its state into the next live rank's host buffer, so
    any single crash leaves the victim's newest state with a survivor."""
    live = sorted(live)
    return live[(live.index(rank) + 1) % len(live)]


class MembershipChange(Exception):
    """Raised out of a blocking rendezvous when the control plane reports
    a membership change affecting the live set (``kind="shrink"``: a
    worker died; planned grows are handled at step boundaries)."""

    def __init__(self, victim: int, kind: str = "shrink"):
        super().__init__(f"worker {victim} left the cluster"
                         if kind == "shrink"
                         else f"worker {victim} membership change ({kind})")
        self.victim = victim
        self.member = victim
        self.kind = kind


def _atomic_json(path: str, doc: dict, *, fsync: bool = True):
    """Write-fsync-rename.  ``fsync=False`` keeps only the rename's
    atomicity (readers never see a partial document) for files that only
    have to outlive their writer, like staging metas."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Optional[dict]:
    """None on a missing or torn document."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _prune_gen_step_dirs(root: str, gen: int, step: int):
    """Remove ``g<j>/`` trees of stale generations (j < gen) and
    ``g<gen>/s<k>/`` subtrees of superseded steps (k < step): the bounded
    growth sweep of the record and all-reduce directories.  Races between
    concurrent pruners are harmless."""
    if not os.path.isdir(root):
        return
    for gdir in os.listdir(root):
        g = gdir[1:]
        if not (gdir.startswith("g") and g.isdigit()):
            continue
        if int(g) < gen:
            shutil.rmtree(os.path.join(root, gdir), ignore_errors=True)
            continue
        if int(g) != gen:
            continue
        for sdir in os.listdir(os.path.join(root, gdir)):
            s = sdir[1:]
            if (sdir.startswith("s") and s.lstrip("-").isdigit()
                    and int(s) < step):
                shutil.rmtree(os.path.join(root, gdir, sdir),
                              ignore_errors=True)


# ---------------------------------------------------------------------------
# control plane: membership changes
# ---------------------------------------------------------------------------

class ControlPlane:
    """An ordered log of signed membership changes (grow and shrink).

    Each posting is one immutable file ``changes/c<idx>.json`` —
    ``{"idx", "kind": "grow"|"shrink", "member", "planned", "at_step"}``
    — posted by the launcher, a single writer by construction.  A planned
    change is posted before its step, and every rank runs it at the top
    of step ``at_step``; a crash shrink is posted after the orchestrator
    saw a worker die, and survivors notice it while blocked on the dead
    rank (``check_crash``).  ``post`` / ``read`` keep the shrink-only
    shapes of the single-file predecessor."""

    def __init__(self, root: str):
        self.root = root
        self.changes_dir = os.path.join(root, "changes")
        os.makedirs(self.changes_dir, exist_ok=True)

    def post_change(self, kind: str, member: int, *, planned: bool = False,
                    at_step: Optional[int] = None) -> dict:
        if kind not in ("grow", "shrink"):
            raise ValueError(f"unknown membership change {kind!r}")
        if kind == "grow" and not planned:
            raise ValueError("grow changes are planned-only")
        idx = len(self.changes())
        doc = {"idx": idx, "kind": kind, "member": int(member),
               "planned": bool(planned), "at_step": at_step}
        _atomic_json(os.path.join(self.changes_dir, f"c{idx:04d}.json"), doc)
        return doc

    def changes(self) -> list:
        """Every posted change, oldest first."""
        out = []
        for fn in sorted(os.listdir(self.changes_dir)):
            if fn.startswith("c") and fn.endswith(".json"):
                doc = _read_json(os.path.join(self.changes_dir, fn))
                if doc is not None:
                    out.append(doc)
        return out

    def post(self, victim: int, *, planned: bool = False,
             at_step: Optional[int] = None):
        self.post_change("shrink", victim, planned=planned, at_step=at_step)

    def read(self) -> Optional[dict]:
        """The newest change in the shrink-only shape (plus ``kind``)."""
        ch = self.changes()
        if not ch:
            return None
        d = ch[-1]
        return {"victim": d["member"], "planned": d["planned"],
                "at_step": d["at_step"], "kind": d["kind"]}

    def check_crash(self, live: Sequence[int]):
        """Raise MembershipChange if a crash change whose member is still
        in ``live`` has been posted (a spent change never re-raises)."""
        for d in self.changes():
            if not d["planned"] and d["member"] in live:
                raise MembershipChange(d["member"], d.get("kind", "shrink"))

    def post_shrink_result(self, gen: int, doc: dict):
        """The shrink adopter publishes its recovery decision."""
        _atomic_json(os.path.join(self.root, f"shrink_g{gen}.json"), doc)

    def wait_shrink_result(self, gen: int, *, timeout: float = 120.0) -> dict:
        deadline = time.monotonic() + timeout
        path = os.path.join(self.root, f"shrink_g{gen}.json")
        while True:
            doc = _read_json(path)
            if doc is not None:
                return doc
            if time.monotonic() > deadline:
                raise TimeoutError(f"no shrink result for gen {gen}")
            time.sleep(POLL_S)


# ---------------------------------------------------------------------------
# lockstep scalar all-reduce (the data-parallel gradient combine)
# ---------------------------------------------------------------------------

class ScalarReduceBoard:
    """File-based all-reduce of one scalar per (generation, step, rank).

    Bit-exact: contributions are written as ``float.hex()`` and summed in
    sorted-rank order, so every rank computes the same float64 and a
    re-run with the same membership history reproduces it.  Keyed by
    generation, so contributions from before a shrink never leak into the
    step re-run after it.  ``combine`` doubles as the failure detector:
    blocked on a missing contribution it polls the control plane and
    raises ``MembershipChange`` when a death is posted."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, gen: int, step: int, rank: int) -> str:
        return os.path.join(self.root, f"g{gen}", f"s{step}",
                            f"r{rank}.json")

    def contribute(self, gen: int, step: int, rank: int, value: float):
        _atomic_json(self._path(gen, step, rank),
                     {"v": float(value).hex()})

    def combine(self, gen: int, step: int, ranks: Sequence[int], *,
                control: Optional[ControlPlane] = None,
                timeout: float = 120.0) -> float:
        ranks = sorted(ranks)
        deadline = time.monotonic() + timeout
        while True:
            vals = {}
            for r in ranks:
                doc = _read_json(self._path(gen, step, r))
                if doc is None:
                    break
                vals[r] = float.fromhex(doc["v"])
            if len(vals) == len(ranks):
                total = 0.0
                for r in ranks:         # fixed order -> bit-exact
                    total += vals[r]
                # every rank contributed to `step`, so every rank is past
                # combine(step - 1): older dirs are dead weight
                _prune_gen_step_dirs(self.root, gen, step)
                return total
            if control is not None:
                control.check_crash(ranks)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"all-reduce g{gen}/s{step}: missing "
                    f"{sorted(set(ranks) - set(vals))}")
            time.sleep(POLL_S)


# ---------------------------------------------------------------------------
# cross-process RStore staging (the peer host buffer as spill files)
# ---------------------------------------------------------------------------

def _mangle(name: str) -> str:
    return name.replace("/", "__")


class _StagingBuffer:
    """The write side of one worker's host buffer: ``put(name, tag, tree)``
    (or ``buf[name] = (tag, tree)``) writes the staged copy through to a
    spill frame + meta.  Payload and meta are two atomic renames, so a
    crash between them CAN leave the previous meta next to a new payload:
    the meta carries the CRC of the payload it describes, and ``view``
    discards any pair that does not match.  ``legacy`` writes the legacy
    spill format (``_write_legacy``)."""

    #: tells ``TierManager.rstore`` it may hand over device trees as they
    #: are: this buffer copies each leaf to the host as it writes the frame
    materializes_leaves = True

    def __init__(self, path: str, legacy: bool = False):
        self.path = path
        self.legacy = legacy

    def __setitem__(self, name: str, value: Tuple[int, Any]):
        tag, tree = value
        self.put(name, tag, tree)

    def put(self, name: str, tag: int, tree: Any,
            to_host: Callable[[Any], Any] = _plain_to_host):
        """Stage ``tree`` under ``name``; ``to_host`` copies each leaf to
        the host (``TierManager.to_host``: counted)."""
        try:
            os.makedirs(self.path, exist_ok=True)
            leaves = tree_leaves(tree)
            base = os.path.join(self.path, _mangle(name))
            if self.legacy:
                self._write_legacy(name, base, int(tag),
                                   [to_host(l) for l in leaves])
                return
            fd, tmp = tempfile.mkstemp(dir=self.path)
            try:
                with os.fdopen(fd, "wb") as f:
                    crc, _, _ = stream.write_frame(f, leaves, to_host)
                os.replace(tmp, base + stream.SUFFIX)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            _atomic_json(base + ".json",
                         {"name": name, "tag": int(tag), "n": len(leaves),
                          "crc": crc, "format": "cxl0"},
                         fsync=False)
        except FileNotFoundError:
            # the buffer's owner crashed and its buffer was wiped under
            # this store: an RStore into a dead peer does not land (the
            # crash semantics, not an error)
            return

    def _write_legacy(self, name: str, base: str, tag: int, leaves):
        """The legacy spill format (``np.savez`` + fsync'd meta): kept to
        fabricate old staging areas and as the benchmarks' baseline for
        the streamed path."""
        raw, dtypes, shapes = encode_arrays(leaves)
        fd, tmp = tempfile.mkstemp(dir=self.path)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{f"a{i}": a for i, a in enumerate(raw)})
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, base + ".npz")
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _atomic_json(base + ".json",
                     {"name": name, "tag": tag, "n": len(leaves),
                      "crc": _crc_of_arrays(leaves),
                      "dtypes": dtypes, "shapes": shapes})


@dataclasses.dataclass
class StagingProxy:
    """RStore target for a remote sibling: quacks like a TierManager as far
    as ``rstore`` cares (exposes ``.staging``), but lands the copy in the
    sibling's buffer directory."""
    staging: _StagingBuffer


@dataclasses.dataclass
class StagedView:
    """Read side, shaped like a TierManager peer:
    ``.staging = {name: (tag, host tree)}``."""
    staging: Dict[str, Tuple[int, Any]]


class FileStagingArea:
    """Per-worker spill-file buffers emulating RStore's peer host memory.

    ``root/w<i>/`` is worker *i*'s buffer: copies staged INTO it by peers.
    Worker *i*'s crash loses it (``wipe``), exactly the CXL0 cache-loss
    model; the copies OF worker *i* held in a sibling's buffer survive."""

    def __init__(self, root: str, *, legacy_format: bool = False):
        self.root = root
        self.legacy_format = legacy_format
        os.makedirs(root, exist_ok=True)

    def area(self, rank: int) -> str:
        return os.path.join(self.root, f"w{rank}")

    def payload_path(self, rank: int, name: str) -> str:
        """Path of ``name``'s spill payload in ``rank``'s buffer: the
        streamed frame if present, else the legacy ``.npz``."""
        base = os.path.join(self.area(rank), _mangle(name))
        if os.path.exists(base + stream.SUFFIX):
            return base + stream.SUFFIX
        if os.path.exists(base + ".npz"):
            return base + ".npz"
        return base + stream.SUFFIX

    def proxy(self, rank: int) -> StagingProxy:
        """Write INTO ``rank``'s buffer (the rstore target)."""
        return StagingProxy(_StagingBuffer(self.area(rank),
                                           legacy=self.legacy_format))

    def view(self, rank: int, templates: Dict[str, Any]) -> StagedView:
        """Read ``rank``'s OWN buffer: the staged copies it holds for its
        peers, unflattened against ``templates`` (only requested names
        are read).  Torn, missing or meta/payload-mismatched entries are
        absent."""
        staged: Dict[str, Tuple[int, Any]] = {}
        for name, template in templates.items():
            base = os.path.join(self.area(rank), _mangle(name))
            meta = _read_json(base + ".json")
            if meta is None:
                continue
            if meta.get("format") == "cxl0":
                try:
                    arrays, crc, _ = stream.read_frame(base + stream.SUFFIX)
                except (stream.FrameError, OSError):
                    continue                # torn spill: not a usable copy
                if crc != meta.get("crc") or len(arrays) != meta.get("n"):
                    continue                # meta describes another payload
            else:
                try:
                    with np.load(base + ".npz") as z:
                        raw = [z[f"a{i}"] for i in range(meta["n"])]
                    arrays = decode_arrays(raw, meta["dtypes"],
                                           meta["shapes"])
                except (OSError, KeyError, ValueError, TypeError, EOFError,
                        RuntimeError, zipfile.BadZipFile, zlib.error):
                    continue                # torn spill: not a usable copy
                if _crc_of_arrays(arrays) != meta.get("crc"):
                    continue                # meta describes another payload
            staged[name] = (meta["tag"],
                            tree_structure(template).unflatten(arrays))
        return StagedView(staged)

    def wipe(self, rank: int):
        """Worker ``rank`` crashed: its host buffer is gone."""
        shutil.rmtree(self.area(rank), ignore_errors=True)


# ---------------------------------------------------------------------------
# rank records + elected cluster completeOp
# ---------------------------------------------------------------------------

class ClusterProtocol:
    """Per-rank handle for the multi-writer commit protocol over one pool.

    A cluster commit of step ``s`` (generation ``g``)::

        every rank:   flush its w<i>/ objects (any schedule)
                      -> atomic rank record records/g<g>/s<s>/r<i>.json
        last to record (sees all N records, wins the O_EXCL marker):
                      -> ONE cluster manifest referencing every rank's
                         objects at step s  (completeOp)

    ``cluster_complete`` has the shape of a ``DurableCommitter``
    ``complete_fn``, so each rank's committer keeps its schedules, shard
    pipelines and fault hooks and only the completeOp changes.  With
    ``confirm=True`` it also blocks until the step's cluster manifest is
    visible (so a ``post_completeOp`` kill is after the CLUSTER commit).
    """

    def __init__(self, pool: DSMPool, rank: int, live: Sequence[int], *,
                 gen: int = 0, confirm: bool = False,
                 retention: Optional[int] = None,
                 timeout: float = 120.0):
        self.pool = pool
        self.rank = rank
        self.live = sorted(live)
        self.gen = gen
        self.confirm = confirm
        #: manifests kept by the ELECTED committer's post-commit gc: right
        #: after its commit every live rank's objects for the step are
        #: referenced, and lockstep bounds rank skew to one step
        self.retention = retention
        self.timeout = timeout
        self.records_root = os.path.join(pool.path, "records")
        #: filename -> parsed manifest (manifests are immutable once their
        #: rename made them parseable, so the polling paths re-parse only
        #: files they have not seen)
        self._manifest_cache: Dict[str, dict] = {}

    def set_membership(self, gen: int, live: Sequence[int]):
        self.gen = gen
        self.live = sorted(live)

    # -- rank records --------------------------------------------------------
    def _rec_dir(self, step: int) -> str:
        return os.path.join(self.records_root, f"g{self.gen}", f"s{step}")

    def write_record(self, step: int, entries: Dict[str, dict]):
        _atomic_json(os.path.join(self._rec_dir(step),
                                  f"r{self.rank}.json"),
                     {"rank": self.rank, "objects": entries})

    def read_records(self, step: int) -> Optional[Dict[str, dict]]:
        """Merged object entries of every live rank's record for ``step``,
        or None while any record is missing."""
        merged: Dict[str, dict] = {}
        for r in self.live:
            doc = _read_json(os.path.join(self._rec_dir(step),
                                          f"r{r}.json"))
            if doc is None:
                return None
            merged.update(doc["objects"])
        return merged

    # -- the elected completeOp ---------------------------------------------
    def _win_commit_marker(self, step: int) -> bool:
        """At most one rank per (gen, step) performs the completeOp: the
        O_EXCL marker makes the election atomic, so a stalled also-ran
        never renames a duplicate manifest for an old step."""
        try:
            fd = os.open(os.path.join(self._rec_dir(step), ".commit"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def meta_for(self, **extra) -> dict:
        doc = {"kind": "cluster", "gen": self.gen, "live": self.live}
        doc.update(extra)
        return doc

    def _manifests_desc(self) -> list:
        """``pool.manifests_desc`` through the parse cache; entries of
        deleted files are dropped."""
        docs, seen = [], set()
        for fn in os.listdir(self.pool.path):
            if not (fn.startswith("manifest.") and fn.endswith(".json")):
                continue
            mid = fn[len("manifest."):-len(".json")]
            if not mid.isdigit():
                continue
            seen.add(fn)
            doc = self._manifest_cache.get(fn)
            if doc is None:
                doc = _read_json(os.path.join(self.pool.path, fn))
                if doc is None:
                    continue        # reservation still empty: poll again
                self._manifest_cache[fn] = doc
            docs.append(doc)
        for fn in list(self._manifest_cache):
            if fn not in seen:      # gc'd manifest
                del self._manifest_cache[fn]
        return sorted(docs, key=lambda d: (-d["step"], -d["seq"]))

    def find_manifest(self, step: int,
                      gen: Optional[int] = None) -> Optional[dict]:
        """Newest cluster manifest for ``step`` (optionally of one
        generation)."""
        for m in self._manifests_desc():
            if m["step"] != step:
                continue
            if gen is not None and m["meta"].get("gen") != gen:
                continue
            return m
        return None

    def wait_manifest(self, step: int, *,
                      control: Optional[ControlPlane] = None) -> dict:
        """Block until the cluster manifest for ``step`` is visible.

        Failover: if the marker's winner died between winning and renaming
        the manifest, nobody would commit, so after a grace period any
        waiter whose record set is complete commits directly.  The worst
        case is a duplicate manifest for the step with identical content,
        which is benign: seqs are reserved atomically and readers order by
        (step, seq)."""
        deadline = time.monotonic() + self.timeout
        takeover_at = time.monotonic() + min(5.0, self.timeout / 4)
        while True:
            m = self.find_manifest(step, gen=self.gen)
            if m is not None:
                return m
            if control is not None:
                control.check_crash(self.live)
            now = time.monotonic()
            if now > takeover_at:
                takeover_at = float("inf")
                merged = self.read_records(step)
                if merged is not None:
                    self.pool.commit_manifest(step, merged,
                                              self.meta_for())
                    self._prune_records(step)
                    if self.retention:
                        self.pool.gc(keep=self.retention)
                    continue        # our own commit is findable now
            if now > deadline:
                raise TimeoutError(
                    f"cluster manifest g{self.gen}/s{step} never appeared")
            time.sleep(POLL_S)

    def _prune_records(self, step: int):
        """Drop record dirs of committed-and-superseded steps (and stale
        generations); lockstep guarantees no live rank still needs one."""
        _prune_gen_step_dirs(self.records_root, self.gen, step)

    def try_commit(self, step: int, meta: Optional[dict] = None) -> int:
        """Commit the cluster manifest for ``step`` iff every live rank has
        recorded AND this rank wins the marker.  Returns the new seq, or
        -1 when someone else is (or will be) the committer."""
        merged = self.read_records(step)
        if merged is None or not self._win_commit_marker(step):
            return -1
        seq = self.pool.commit_manifest(step, merged,
                                        meta or self.meta_for())
        self._prune_records(step)
        if self.retention:
            self.pool.gc(keep=self.retention)
        return seq

    def cluster_complete(self, step: int, written: Dict[str, Any],
                         meta: Optional[dict] = None) -> int:
        """The DurableCommitter ``complete_fn``: rank record + elected
        cluster commit (+ the confirmation barrier when configured)."""
        entries = {name: manifest_entry(o) for name, o in written.items()}
        self.write_record(step, entries)
        seq = self.try_commit(step, meta)
        if self.confirm:
            seq = self.wait_manifest(step)["seq"]
        return seq
