"""Cross-process RStore staging: the peer host buffer as spill files — the
staging part of ``repro.dsm.cluster`` (its lines 306-500).

The paper's setting is several hosts sharing one CXL pool, where a crash
takes out one host's caches and everything else keeps running.  RStore
stages a value into a PEER's host memory, so it survives its writer's
crash.  ``FileStagingArea`` realizes that buffer as spill files:

* ``root/w<i>/`` is worker (or engine) *i*'s buffer — the copies peers
  staged INTO it;
* ``proxy(i)`` is the write side: a ``StagingProxy`` whose ``.staging``
  takes ``TierManager.rstore`` (and writes through to ``w<i>/``);
* ``view(i, templates)`` is the read side: a ``StagedView`` shaped like a
  TierManager peer (``.staging = {name: (tag, host tree)}``);
* ``wipe(i)``: worker *i* crashed, its volatile buffer is gone.

Each entry is a streamed ``.cxl0`` frame (``dsm.stream``) plus a JSON meta
carrying the frame's CRC; both are written by atomic rename and neither is
fsync'd (the buffer is volatile by contract: it must survive its WRITER's
crash, not its owner's).  A torn frame, or a meta whose CRC does not match
the frame beside it, reads back as absent, and recovery falls back to the
pool.  Frames and metas equal the reference's byte for byte for the same
leaves, and each package reads the other's buffer.

Not ported: the reference's legacy ``.npz`` staging format (an entry in it
reads back as absent here) and the rest of ``repro.dsm.cluster`` — rank
namespaces, rank records, the elected cluster completeOp, the control
plane and the all-reduce board (the rank cluster, ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.dsm import stream
from repro_torch.utils.tree import tree_leaves, tree_structure


def _plain_to_host(leaf: Any) -> Any:
    """An uncounted host copy, for writers that hand no counted one."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return leaf.cpu()
    return leaf


def _atomic_json(path: str, doc: dict):
    """Write-rename without fsync: readers never see a partial document,
    and the file only has to outlive its writer (a staging meta)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
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


def _mangle(name: str) -> str:
    return name.replace("/", "__")


class _StagingBuffer:
    """The write side of one worker's host buffer: ``put(name, tag, tree)``
    (or ``buf[name] = (tag, tree)``) writes the staged copy through to a
    spill frame + meta.  Payload and meta are two atomic renames, so a
    crash between them CAN leave the previous meta next to a new payload:
    the meta carries the CRC of the payload it describes, and ``view``
    discards any pair that does not match."""

    #: tells ``TierManager.rstore`` it may hand over device trees as they
    #: are: this buffer copies each leaf to the host as it writes the frame
    materializes_leaves = True

    def __init__(self, path: str, arena: Optional[stream.SpillArena] = None):
        self.path = path
        self.arena = arena

    def __setitem__(self, name: str, value: Tuple[int, Any]):
        tag, tree = value
        self.put(name, tag, tree)

    def put(self, name: str, tag: int, tree: Any,
            to_host: Callable[[Any], Any] = _plain_to_host):
        """Stage ``tree`` under ``name``; ``to_host`` copies each leaf to
        the host (``TierManager.to_host``: counted)."""
        try:
            os.makedirs(self.path, exist_ok=True)
            leaves = [to_host(l) for l in tree_leaves(tree)]
            base = os.path.join(self.path, _mangle(name))
            fd, tmp = tempfile.mkstemp(dir=self.path)
            try:
                with os.fdopen(fd, "wb") as f:
                    crc, _, _ = stream.write_frame(f, leaves, self.arena)
                os.replace(tmp, base + stream.SUFFIX)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            _atomic_json(base + ".json",
                         {"name": name, "tag": int(tag), "n": len(leaves),
                          "crc": crc, "format": "cxl0"})
        except FileNotFoundError:
            # the buffer's owner crashed and its buffer was wiped under
            # this store: an RStore into a dead peer does not land (the
            # crash semantics, not an error)
            return


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

    def __init__(self, root: str):
        self.root = root
        self._arena = stream.SpillArena()
        os.makedirs(root, exist_ok=True)

    def area(self, rank: int) -> str:
        return os.path.join(self.root, f"w{rank}")

    def proxy(self, rank: int) -> StagingProxy:
        """Write INTO ``rank``'s buffer (the rstore target)."""
        return StagingProxy(_StagingBuffer(self.area(rank), self._arena))

    def view(self, rank: int, templates: Dict[str, Any]) -> StagedView:
        """Read ``rank``'s OWN buffer: the staged copies it holds for its
        peers, unflattened against ``templates`` (only requested names
        are read).  Torn, missing or meta/payload-mismatched entries are
        absent."""
        staged: Dict[str, Tuple[int, Any]] = {}
        for name, template in templates.items():
            base = os.path.join(self.area(rank), _mangle(name))
            meta = _read_json(base + ".json")
            if meta is None or meta.get("format") != "cxl0":
                continue
            try:
                arrays, crc, _ = stream.read_frame(base + stream.SUFFIX)
            except (stream.FrameError, OSError):
                continue                    # torn spill: not a usable copy
            if crc != meta.get("crc") or len(arrays) != meta.get("n"):
                continue                    # meta describes another payload
            staged[name] = (meta["tag"],
                            tree_structure(template).unflatten(arrays))
        return StagedView(staged)

    def wipe(self, rank: int):
        """Worker ``rank`` crashed: its host buffer is gone."""
        shutil.rmtree(self.area(rank), ignore_errors=True)
