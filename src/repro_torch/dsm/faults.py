"""Injectable fault layer: seeded kill schedules, torn durable writes and
straggler perturbation for the adversarial crash fuzzer
(``repro_torch.scenarios.fuzz``) — the port of ``repro.dsm.faults``.

The kill-point suites enumerate three hand-picked commit-window points;
this module makes the whole primitive surface killable:

* ``KillSpec`` — one scheduled death: a worker, a primitive boundary
  (any ``lstore``/``rstore``/``rflush``/``mstore``/``completeOp`` call
  index, before or after the call), or one of the three commit-window
  points at a given step;
* ``TornSpec`` — torn-write emulation: a seeded per-(object, version)
  decision to truncate, bit-flip or zero a payload file AFTER its atomic
  rename, so the write is visible but wrong and the CRC / manifest path
  must reject it;
* ``StragglerSpec`` — seeded per-op delay multipliers routed through the
  ``TopologyEmulator`` pricing hook (``attach_emulator``), optionally with
  a real capped ``time.sleep`` so async flush pipelines really reorder;
* ``FaultyPool`` — a ``DSMPool`` that applies the torn-write spec on every
  durable write and records which ``(name, version)`` payloads it
  corrupted: the fuzzer's oracle reads this ledger;
* ``FaultInjector`` / ``attach_faults`` — per-worker op counting and kill
  firing, wrapped around a live ``CXL0Context``'s tier methods the way
  ``attach_emulator`` wraps them (faults outermost: a killed op is never
  priced).

Every decision is a pure hash of (salt, identity) — never the clock, never
thread timing — so the same (schedule, program) injects the same faults
in this package and in the reference: a schedule's JSON drives both to
the same ``fired`` list, and a ``FaultyPool`` of each, given the same
writes, corrupts the same files the same way, in both payload formats
(streamed ``.cxl0`` frames and legacy ``.npz`` objects).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.dsm import stream
from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.recovery import CrashError

#: phase boundaries of the grow-by-repartition join protocol: after
#: ``join_staged`` the joiner's partition sits in its staging buffer; after
#: ``join_committed`` the gen+1 manifest is elected; after ``join_adopted``
#: every rank runs the new membership.  A kill at any of them must recover
#: to the old or the new membership bit-identically, never a torn one.
JOIN_POINTS = ("join_staged", "join_committed", "join_adopted")

#: the primitive vocabulary a kill can target (async / sharded flush
#: variants count as ``rflush``; ``completeOp`` is the manifest commit)
PRIMITIVES = ("lstore", "rstore", "rflush", "mstore", "completeOp")

#: ways a torn write can mangle a payload file it leaves visible
TORN_MODES = ("truncate", "bitflip", "zero")


def _hash01(*parts: Any) -> float:
    """Deterministic uniform-ish [0, 1) from arbitrary identity parts."""
    h = zlib.crc32("|".join(str(p) for p in parts).encode()) & 0xFFFFFFFF
    return h / 2.0 ** 32


class InjectedCrash(CrashError):
    """A scheduled worker death fired at a primitive boundary; a
    ``CrashError``, so the crash / recover paths treat it like any other
    injected worker loss."""

    def __init__(self, worker: int, op: str, index: int, phase: str,
                 name: str = ""):
        super().__init__(
            f"injected crash: worker {worker} {phase} {op}[{index}]"
            + (f" ({name})" if name else ""))
        self.worker = worker
        self.op = op
        self.index = index
        self.phase = phase
        self.name = name


@dataclasses.dataclass(frozen=True)
class KillSpec:
    """One scheduled death, in one of two addressing modes:

    * **primitive boundary**: ``op`` is a primitive kind or ``"any"``,
      ``index`` the 0-based call index (per kind, or global for
      ``"any"``), ``phase`` before or after the call;
    * **commit-window point**: ``point`` is one of ``KILL_POINTS`` (or
      ``JOIN_POINTS``) and the kill fires at the first such hook whose
      step is >= ``at_step`` — the process-kill suites' addressing.
    """

    worker: int = 0
    op: Optional[str] = None
    index: int = 0
    phase: str = "before"
    point: Optional[str] = None
    at_step: int = 0

    def __post_init__(self):
        if (self.op is None) == (self.point is None):
            raise ValueError("KillSpec needs exactly one of op= / point=")
        if self.op is not None and self.op not in PRIMITIVES + ("any",):
            raise ValueError(f"unknown op {self.op!r}")
        if (self.point is not None
                and self.point not in KILL_POINTS + JOIN_POINTS):
            raise ValueError(f"unknown point {self.point!r}")
        if self.phase not in ("before", "after"):
            raise ValueError(f"phase must be before/after, got {self.phase!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KillSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class TornSpec:
    """Seeded torn-write model: each durable write of ``(name, version)``
    is corrupted with probability ``rate``, its mode drawn from ``modes``.
    Decisions hash the identity, not the call order, so they are stable
    across threads, retries and incarnations."""

    rate: float
    salt: int = 0
    modes: Tuple[str, ...] = TORN_MODES

    def decide(self, name: str, version: int) -> Optional[str]:
        if _hash01("torn", self.salt, name, version) >= self.rate:
            return None
        pick = _hash01("torn-mode", self.salt, name, version)
        return self.modes[int(pick * len(self.modes)) % len(self.modes)]


@dataclasses.dataclass(frozen=True)
class StragglerSpec:
    """Seeded slow-writer model: with probability ``rate`` an op's priced
    cost is multiplied by up to ``max_mult`` and the caller stalls for a
    real (capped) sleep.  Plugged into ``TopologyEmulator(fault_model=)``:
    the delay rides the topology model's pricing hook."""

    rate: float
    max_mult: float = 8.0
    sleep_s: float = 0.0005
    max_sleep_s: float = 0.005
    salt: int = 0

    def perturb(self, seq: int, op: str, name: str) -> Tuple[float, float]:
        """(cost multiplier, real sleep seconds) for trace entry ``seq``."""
        if _hash01("straggler", self.salt, seq, op, name) >= self.rate:
            return 1.0, 0.0
        mult = 1.0 + (self.max_mult - 1.0) * _hash01(
            "straggler-mult", self.salt, seq, op, name)
        return mult, min(self.sleep_s * mult, self.max_sleep_s)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """One episode's fault plan: any number of kills plus optional
    torn-write and straggler models.  JSON round-trippable: the minimal
    reproducer is (config, schedule)."""

    kills: Tuple[KillSpec, ...] = ()
    torn: Optional[TornSpec] = None
    straggler: Optional[StragglerSpec] = None

    def to_dict(self) -> dict:
        return {
            "kills": [k.to_dict() for k in self.kills],
            "torn": dataclasses.asdict(self.torn) if self.torn else None,
            "straggler": (dataclasses.asdict(self.straggler)
                          if self.straggler else None),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        torn = d.get("torn")
        strag = d.get("straggler")
        if torn is not None:
            torn = TornSpec(**{**torn, "modes": tuple(torn["modes"])})
        if strag is not None:
            strag = StragglerSpec(**strag)
        return cls(kills=tuple(KillSpec.from_dict(k)
                               for k in d.get("kills", ())),
                   torn=torn, straggler=strag)


# ---------------------------------------------------------------------------
# torn durable writes
# ---------------------------------------------------------------------------

def _payload_span(path: str) -> Tuple[int, int]:
    """(offset, length) of the largest leaf's (or zip member's) data
    bytes: the region the content CRC provably covers, so a corruption
    there must be rejected.  Sniffs the format: a streamed ``.cxl0`` frame
    through its header's leaf table, a legacy ``.npz`` through the zip
    local-file-header walk."""
    with open(path, "rb") as f:
        magic = f.read(len(stream.MAGIC))
    if magic == stream.MAGIC:
        return stream.payload_span(path)
    with zipfile.ZipFile(path) as z:
        info = max(z.infolist(), key=lambda i: i.file_size)
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        hdr = f.read(30)            # local file header: sizes at 26/28
    n_name = int.from_bytes(hdr[26:28], "little")
    n_extra = int.from_bytes(hdr[28:30], "little")
    return info.header_offset + 30 + n_name + n_extra, info.file_size


def corrupt_file(path: str, mode: str):
    """Mangle a payload file in place, deterministically, leaving it
    visible: ``truncate`` keeps a prefix (a frame's size equation fails
    and its footer is gone; a legacy zip loses its central directory),
    ``bitflip`` inverts one byte of leaf data, ``zero`` XOR-smears a
    64-byte window of leaf data (any nonzero burst under 32 bits changes a
    CRC32, so detection is certain).  The read path rejects all three in
    both payload formats."""
    size = os.path.getsize(path)
    if mode == "truncate":
        os.truncate(path, max(1, size // 3))
        return
    off, length = _payload_span(path)
    length = max(1, length)
    with open(path, "r+b") as f:
        if mode == "bitflip":
            pos = off + length // 2
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
        elif mode == "zero":
            span = min(64, length)
            f.seek(off)
            window = f.read(span)
            f.seek(off)
            f.write(bytes(c ^ 0xA5 for c in window))
        else:
            raise ValueError(f"unknown torn mode {mode!r}")
        f.flush()
        os.fsync(f.fileno())


class FaultyPool(DSMPool):
    """A DSMPool whose durable writes can be torn: after the payload's
    atomic rename (the write IS visible) the payload file is corrupted per
    the ``TornSpec`` (or a forced per-write override), while the frame
    footer and the manifest entry keep describing the original bytes —
    the mislabeled-but-visible state a writer dying mid-update leaves.
    Every corruption is recorded in ``injected``.

    The injection rides ``DSMPool._finalize_write`` (the post-rename
    hook): ``write_object`` and the split-phase ``start_write`` /
    ``PendingWrite.finish`` of the sharded pipelines both end there, so
    every durable-write flavor is corruptible."""

    def __init__(self, path: str, *, torn: Optional[TornSpec] = None,
                 injected: Optional[List[Tuple[str, int, str]]] = None):
        self.torn = torn
        #: (name, version, mode) actually corrupted; may be a list shared
        #: by several pool handles over one directory
        self.injected: List[Tuple[str, int, str]] = (
            injected if injected is not None else [])
        self._forced: Dict[Tuple[str, int], str] = {}
        self._faults_lock = threading.Lock()
        super().__init__(path)

    def force_corrupt(self, name: str, version: int, mode: str):
        """Tear the NEXT write of ``(name, version)`` with ``mode``
        whatever the spec says (targeted tests)."""
        if mode not in TORN_MODES:
            raise ValueError(f"unknown torn mode {mode!r}")
        with self._faults_lock:
            self._forced[(name, version)] = mode

    def _finalize_write(self, name: str, version: int, payload_path: str):
        super()._finalize_write(name, version, payload_path)
        with self._faults_lock:
            mode = self._forced.pop((name, version), None)
        if mode is None and self.torn is not None:
            mode = self.torn.decide(name, version)
        if mode is not None:
            corrupt_file(payload_path, mode)
            with self._faults_lock:
                self.injected.append((name, version, mode))


# ---------------------------------------------------------------------------
# kill firing
# ---------------------------------------------------------------------------

class FaultInjector:
    """Per-worker kill machinery: counts primitive boundaries, fires the
    schedule's kills for THIS worker (each spec at most once, in schedule
    order), and doubles as the ``CXL0Context`` ``fault_hook`` so
    commit-window kills ride the committer's hook.

    One injector persists across a worker's incarnations: its counters
    keep rising through crash and recovery, so a second kill later in the
    schedule lands at a well-defined global index."""

    def __init__(self, schedule: FaultSchedule, worker: int = 0):
        self.schedule = schedule
        self.worker = worker
        self.counts: Dict[str, int] = {k: 0 for k in PRIMITIVES}
        self.total = 0
        self.fired: List[dict] = []
        self.last_window: Optional[Tuple[str, int]] = None
        self._done: set = set()
        self._lock = threading.Lock()

    def _next_spec(self) -> Optional[Tuple[int, KillSpec]]:
        for i, s in enumerate(self.schedule.kills):
            if s.worker == self.worker and i not in self._done:
                return i, s
        return None

    def _fire(self, slot: int, op: str, name: str, index: int, phase: str):
        self._done.add(slot)
        self.fired.append({"worker": self.worker, "op": op, "index": index,
                           "phase": phase, "name": name})
        raise InjectedCrash(self.worker, op, index, phase, name)

    # -- primitive-boundary addressing ---------------------------------------
    def begin(self, op: str, name: str) -> Tuple[int, int]:
        """Count one primitive call and maybe die BEFORE it.  Returns the
        (per-kind, global) indices for the matching ``end``."""
        with self._lock:
            my, g = self.counts[op], self.total
            self.counts[op] += 1
            self.total += 1
        self._maybe_fire(op, name, my, g, "before")
        return my, g

    def end(self, op: str, name: str, my: int, g: int):
        """Maybe die AFTER a counted call."""
        self._maybe_fire(op, name, my, g, "after")

    def _maybe_fire(self, op: str, name: str, my: int, g: int, phase: str):
        armed = self._next_spec()
        if armed is None:
            return
        slot, s = armed
        if s.point is not None or s.phase != phase:
            return
        if (s.op == "any" and g == s.index) or (s.op == op and my == s.index):
            self._fire(slot, op, name, my, phase)

    def call(self, op: str, name: str, fn, *args, **kwargs):
        """Bracket an arbitrary call as one primitive boundary (the
        cluster's elected manifest commit, which bypasses the wrapped
        pool method)."""
        my, g = self.begin(op, name)
        out = fn(*args, **kwargs)
        self.end(op, name, my, g)
        return out

    # -- commit-window (point) addressing ------------------------------------
    def window(self, point: str, step: int):
        """The ``fault_hook(point, step)`` signature: fires a point kill at
        the first hook of its point whose step is >= ``at_step``."""
        self.last_window = (point, step)
        armed = self._next_spec()
        if armed is None:
            return
        slot, s = armed
        if s.point == point and step >= s.at_step:
            self._fire(slot, point, f"step{step}", step, "at")


def attach_faults(ctx, injector: FaultInjector, *, wrap_pool: bool = True):
    """Instrument a live ``CXL0Context`` in place: every tier primitive
    passes through ``injector`` boundaries (the async and sharded flush
    variants count as ``rflush``) and, unless ``wrap_pool=False`` (shared
    cluster pools bracket the elected completeOp themselves through
    ``injector.call``), so does ``pool.commit_manifest`` as
    ``completeOp``.  Apply AFTER ``attach_emulator``, so the kill check is
    outermost and a killed op is never priced.  Nested primitives (mstore
    = lstore + rflush) count once, as the emulator prices them.  Returns
    ``ctx`` with ``ctx.fault_injector`` set."""
    tiers = ctx.tiers
    nesting = threading.local()

    def _wrap(kind, orig):
        @functools.wraps(orig)
        def guarded(*args, **kwargs):
            if getattr(nesting, "depth", 0):
                return orig(*args, **kwargs)
            name = str(args[0]) if args else "?"
            my, g = injector.begin(kind, name)
            nesting.depth = 1
            try:
                out = orig(*args, **kwargs)
            finally:
                nesting.depth = 0
            injector.end(kind, name, my, g)
            return out
        return guarded

    tiers.lstore = _wrap("lstore", tiers.lstore)
    tiers.rstore = _wrap("rstore", tiers.rstore)
    tiers.mstore = _wrap("mstore", tiers.mstore)
    for meth in ("rflush", "rflush_sharded", "flush_async",
                 "flush_async_sharded"):
        setattr(tiers, meth, _wrap("rflush", getattr(tiers, meth)))
    if wrap_pool and getattr(ctx.pool, "_fault_injector", None) is not injector:
        orig_commit = ctx.pool.commit_manifest

        @functools.wraps(orig_commit)
        def commit_manifest(step, objects, meta=None):
            return injector.call("completeOp", f"manifest@{step}",
                                 orig_commit, step, objects, meta)

        ctx.pool.commit_manifest = commit_manifest
        ctx.pool._fault_injector = injector
    ctx.fault_injector = injector
    return ctx
