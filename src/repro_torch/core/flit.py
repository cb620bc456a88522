"""FliT for CXL0 (paper §6, Alg. 2) and the policies it is compared against.

A *memory view* wraps raw CXL0 primitives behind the four FliT methods
(``private_load`` / ``private_store`` / ``shared_load`` / ``shared_store``
plus RMW variants and ``completeOp``).  Object implementations
(``repro_torch.core.objects``) are written once against this interface; swapping
the view swaps the persistence discipline:

* ``RawView``       — no flushes at all (the untransformed linearizable
                      object).  NOT durable under crashes — the negative
                      control our durability checker must catch.
* ``OriginalFliT``  — Wei et al.'s Alg. 1 translated naively: ``Flush`` is
                      taken as *local* flush (next hierarchy level only).
                      Correct in the full-system-crash model, WRONG under
                      CXL0's partial crashes (paper §6 motivating example).
* ``FliTCXL0``      — the paper's Alg. 2: all stores are LStore, all
                      persistence flushes are RFlush, completeOp is empty.
* ``MStoreAll``     — every tagged store is an MStore (always durable, no
                      counters needed, works without coherence — the
                      paper's "inferior performance" strawman, §6.1).

Object code runs inside the concurrent simulator (``repro_torch.core.sim``) as
generators: every primitive is ``yield``-ed as a request and the simulator
returns its result, so arbitrary interleavings and crash points between
primitives are explored.

All views implement the same generator protocol; primitives are tuples
``(op, *args)`` with op ∈ {load, lstore, rstore, mstore, lflush, rflush,
faa, cas, gpf}.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple


class MemView:
    """Base view: FliT interface over yielded CXL0 primitives.

    ``counter_of``: data location -> FliT-counter location (or None if this
    policy needs no counters).
    """

    name = "abstract"
    uses_counters = False

    def __init__(self, counter_of=None):
        self.counter_of = counter_of or (lambda x: None)

    # -- raw primitive helpers (generators) --------------------------------
    def _load(self, x):
        return (yield ("load", x))

    def _lstore(self, x, v):
        yield ("lstore", x, v)

    def _mstore(self, x, v):
        yield ("mstore", x, v)

    def _lflush(self, x):
        yield ("lflush", x)

    def _rflush(self, x):
        yield ("rflush", x)

    def _faa(self, x, d, flavor="l"):
        return (yield ("faa", x, d, flavor))

    def _cas(self, x, old, new, flavor="l"):
        return (yield ("cas", x, old, new, flavor))

    def _atomic_begin(self):
        # Models the paper's synchronous-flush assumption (§B Condition 2):
        # the store→flush window is failure-atomic — the scheduler does not
        # inject crashes inside it (Simulator(respect_atomic=True)).  With
        # respect_atomic=False the window is exposed; see the FINDING tests.
        yield ("atomic_begin",)

    def _atomic_end(self):
        yield ("atomic_end",)

    # -- FliT interface (override in subclasses) ----------------------------
    def private_load(self, x):
        return (yield from self._load(x))

    def private_store(self, x, v, pflag=True):
        raise NotImplementedError

    def shared_load(self, x, pflag=True):
        raise NotImplementedError

    def shared_store(self, x, v, pflag=True):
        raise NotImplementedError

    def shared_cas(self, x, old, new, pflag=True):
        raise NotImplementedError

    def shared_faa(self, x, d, pflag=True):
        raise NotImplementedError

    def complete_op(self):
        if False:
            yield  # pragma: no cover
        return None


class RawView(MemView):
    """The untransformed linearizable object: plain stores, no flushes."""

    name = "raw"

    def private_store(self, x, v, pflag=True):
        yield from self._lstore(x, v)

    def shared_load(self, x, pflag=True):
        return (yield from self._load(x))

    def shared_store(self, x, v, pflag=True):
        yield from self._lstore(x, v)

    def shared_cas(self, x, old, new, pflag=True):
        return (yield from self._cas(x, old, new, "l"))

    def shared_faa(self, x, d, pflag=True):
        return (yield from self._faa(x, d, "l"))


class OriginalFliT(MemView):
    """Wei et al. Alg. 1 ported naively: Flush == LFlush (next level only).

    In the single-machine full-system-crash model this is FliT; under CXL0
    an LFlush only reaches the *owner's volatile cache*, so a completed
    operation can still be lost when the owner machine crashes.
    """

    name = "original_flit"
    uses_counters = True

    def private_store(self, x, v, pflag=True):
        yield from self._atomic_begin()
        yield from self._lstore(x, v)
        if pflag:
            yield from self._lflush(x)
        yield from self._atomic_end()

    def shared_load(self, x, pflag=True):
        v = yield from self._load(x)
        c = self.counter_of(x)
        if pflag and c is not None:
            if (yield from self._load(c)) > 0:
                yield from self._lflush(x)
        return v

    def shared_store(self, x, v, pflag=True):
        if not pflag:
            yield from self._lstore(x, v)
            return
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        yield from self._lstore(x, v)
        yield from self._lflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")

    def shared_cas(self, x, old, new, pflag=True):
        if not pflag:
            return (yield from self._cas(x, old, new, "l"))
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        ok = yield from self._cas(x, old, new, "l")
        yield from self._lflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")
        return ok

    def shared_faa(self, x, d, pflag=True):
        if not pflag:
            return (yield from self._faa(x, d, "l"))
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        old = yield from self._faa(x, d, "l")
        yield from self._lflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")
        return old


class FliTCXL0(OriginalFliT):
    """The paper's Alg. 2: LStore everywhere, RFlush for persistence,
    empty completeOp.  Provides durable linearizability under partial
    crashes (§B of the paper; checked by our simulator + checker)."""

    name = "flit_cxl0"
    uses_counters = True

    def private_store(self, x, v, pflag=True):
        yield from self._atomic_begin()
        yield from self._lstore(x, v)
        if pflag:
            yield from self._rflush(x)
        yield from self._atomic_end()

    def shared_load(self, x, pflag=True):
        v = yield from self._load(x)
        c = self.counter_of(x)
        if pflag and c is not None:
            if (yield from self._load(c)) > 0:
                yield from self._rflush(x)
        return v

    def shared_store(self, x, v, pflag=True):
        if not pflag:
            yield from self._lstore(x, v)
            return
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        yield from self._lstore(x, v)
        yield from self._rflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")

    def shared_cas(self, x, old, new, pflag=True):
        if not pflag:
            return (yield from self._cas(x, old, new, "l"))
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        ok = yield from self._cas(x, old, new, "l")
        yield from self._rflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")
        return ok

    def shared_faa(self, x, d, pflag=True):
        if not pflag:
            return (yield from self._faa(x, d, "l"))
        c = self.counter_of(x)
        yield from self._faa(c, 1, "l")
        yield from self._atomic_begin()
        old = yield from self._faa(x, d, "l")
        yield from self._rflush(x)
        yield from self._atomic_end()
        yield from self._faa(c, -1, "l")
        return old


class MStoreAll(MemView):
    """Every tagged store/RMW goes straight to physical memory (M-flavor).

    Durable by construction (Prop. 1.8: MStore ≈ LStore·RFlush) and needs no
    coherence or counters — the paper's high-cost alternative (§6.1).
    Loads may still observe unpersisted values written by *other* policies;
    within a homogeneous MStoreAll run every write is persistent.
    """

    name = "mstore_all"

    def private_store(self, x, v, pflag=True):
        if pflag:
            yield from self._mstore(x, v)
        else:
            yield from self._lstore(x, v)

    def shared_load(self, x, pflag=True):
        return (yield from self._load(x))

    def shared_store(self, x, v, pflag=True):
        if pflag:
            yield from self._mstore(x, v)
        else:
            yield from self._lstore(x, v)

    def shared_cas(self, x, old, new, pflag=True):
        return (yield from self._cas(x, old, new, "m" if pflag else "l"))

    def shared_faa(self, x, d, pflag=True):
        return (yield from self._faa(x, d, "m" if pflag else "l"))


POLICIES = {v.name: v for v in (RawView, OriginalFliT, FliTCXL0, MStoreAll)}

#: policies expected to be durably linearizable under CXL0 partial crashes
DURABLE_POLICIES = ("flit_cxl0", "mstore_all")
#: policies expected to exhibit durability violations (negative controls)
NON_DURABLE_POLICIES = ("raw", "original_flit")
