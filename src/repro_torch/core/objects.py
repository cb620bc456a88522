"""Concurrent objects: sequential specifications + linearizable
implementations written against the FliT memory-view interface.

Implementations are generator functions (see ``repro_torch.core.flit``): every
memory primitive is yielded to the simulator, so crashes and interleavings
can hit *between* any two primitives.  All implementations are linearizable
in the crash-free sequentially-consistent semantics of CXL0 (the paper:
"Without crashes, CXL0 has simple, sequentially consistent semantics");
wrapping them with ``FliTCXL0`` upgrades them to durable linearizability.

Objects:
* ``Register``     — read/write register.
* ``Counter``      — FAA counter (inc returns old value).
* ``TreiberStack`` — the classic lock-free stack: CAS on ``top``, nodes in
                     a preallocated per-thread pool (value, next fields).
* ``KVMap``        — fixed-key map of registers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

EMPTY = -1        # sentinel "empty" result for pop
NULL = 0          # null node pointer (slot ids start at 1)


# ---------------------------------------------------------------------------
# Sequential specifications (pure, hashable states)
# ---------------------------------------------------------------------------

class SeqSpec:
    """apply(state, op, args) -> (state', result); initial() -> state."""

    def initial(self):
        raise NotImplementedError

    def apply(self, state, op: str, args: Tuple):
        raise NotImplementedError


class RegisterSpec(SeqSpec):
    def initial(self):
        return 0

    def apply(self, state, op, args):
        if op == "write":
            return args[0], None
        if op == "read":
            return state, state
        raise ValueError(op)


class CounterSpec(SeqSpec):
    def initial(self):
        return 0

    def apply(self, state, op, args):
        if op == "inc":
            return state + 1, state          # returns old value (FAA)
        if op == "read":
            return state, state
        raise ValueError(op)


class StackSpec(SeqSpec):
    def initial(self):
        return ()

    def apply(self, state, op, args):
        if op == "push":
            return state + (args[0],), None
        if op == "pop":
            if not state:
                return state, EMPTY
            return state[:-1], state[-1]
        raise ValueError(op)


class KVSpec(SeqSpec):
    def __init__(self, n_keys: int):
        self.n_keys = n_keys

    def initial(self):
        return (0,) * self.n_keys

    def apply(self, state, op, args):
        if op == "put":
            k, v = args
            return state[:k] + (v,) + state[k + 1:], None
        if op == "get":
            return state, state[args[0]]
        raise ValueError(op)


# ---------------------------------------------------------------------------
# Layouts: how an object's locations are placed on machines
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Layout:
    """Assigns shared locations (and their FliT counters) to owners.

    ``alloc(owner)`` hands out the next location on ``owner``; after all
    allocations, ``n_locs`` / ``owner`` describe the SystemConfig and
    ``counter_of`` maps data locations to their counter locations.
    """
    owners: List[int] = dataclasses.field(default_factory=list)
    counters: Dict[int, int] = dataclasses.field(default_factory=dict)

    def alloc(self, owner: int) -> int:
        self.owners.append(owner)
        return len(self.owners) - 1

    def alloc_with_counter(self, owner: int) -> int:
        x = self.alloc(owner)
        self.counters[x] = self.alloc(owner)
        return x

    def counter_of(self, x: int) -> Optional[int]:
        return self.counters.get(x)

    @property
    def n_locs(self) -> int:
        return len(self.owners)


# ---------------------------------------------------------------------------
# Implementations
# ---------------------------------------------------------------------------

class Register:
    """Single shared location; write = shared_store, read = shared_load."""

    spec_cls = RegisterSpec

    def __init__(self, layout: Layout, owner: int = 0):
        self.x = layout.alloc_with_counter(owner)

    def spec(self):
        return RegisterSpec()

    def write(self, mv, v):
        yield from mv.shared_store(self.x, v, True)
        yield from mv.complete_op()
        return None

    def read(self, mv):
        v = yield from mv.shared_load(self.x, True)
        yield from mv.complete_op()
        return v

    OPS = {"write": "write", "read": "read"}


class Counter:
    """FAA counter; inc returns the old value."""

    def __init__(self, layout: Layout, owner: int = 0):
        self.x = layout.alloc_with_counter(owner)

    def spec(self):
        return CounterSpec()

    def inc(self, mv):
        old = yield from mv.shared_faa(self.x, 1, True)
        yield from mv.complete_op()
        return old

    def read(self, mv):
        v = yield from mv.shared_load(self.x, True)
        yield from mv.complete_op()
        return v


class TreiberStack:
    """Lock-free Treiber stack over preallocated node slots.

    Node slot ``s`` (1-based) has two shared locations: ``val[s]`` and
    ``next[s]``.  ``top`` holds a slot id (0 = empty).  Slots are handed to
    threads round-robin (one private free-list each) so allocation needs no
    synchronization; node fields are written with *private* stores before
    the node is published by the CAS on ``top`` (the FliT private/shared
    distinction, §6).
    """

    def __init__(self, layout: Layout, owner: int = 0, n_slots: int = 8,
                 n_threads: int = 2):
        self.top = layout.alloc_with_counter(owner)
        self.val = [None]   # 1-based
        self.next = [None]
        for _ in range(n_slots):
            self.val.append(layout.alloc_with_counter(owner))
            self.next.append(layout.alloc_with_counter(owner))
        self.n_slots = n_slots
        # per-thread free lists (round-robin slot assignment)
        self.free: Dict[int, List[int]] = {
            t: [s for s in range(1, n_slots + 1) if (s - 1) % n_threads == t]
            for t in range(n_threads)}

    def spec(self):
        return StackSpec()

    def push(self, mv, v, thread_id: int = 0):
        free = self.free.get(thread_id)
        if not free:
            raise RuntimeError("node pool exhausted — size the workload so "
                               "each thread pushes at most its pool share")
        s = free.pop()
        yield from mv.private_store(self.val[s], v, True)
        while True:
            h = yield from mv.shared_load(self.top, True)
            yield from mv.private_store(self.next[s], h, True)
            ok = yield from mv.shared_cas(self.top, h, s, True)
            if ok:
                break
        yield from mv.complete_op()
        return None

    def pop(self, mv, thread_id: int = 0):
        while True:
            h = yield from mv.shared_load(self.top, True)
            if h == NULL:
                yield from mv.complete_op()
                return EMPTY
            n = yield from mv.shared_load(self.next[h], True)
            v = yield from mv.shared_load(self.val[h], True)
            ok = yield from mv.shared_cas(self.top, h, n, True)
            if ok:
                yield from mv.complete_op()
                return v


class KVMap:
    """Fixed-key map; every key is an independent register (keys may live
    on different owners — exercises multi-machine layouts)."""

    def __init__(self, layout: Layout, n_keys: int, n_machines: int = 1):
        self.keys = [layout.alloc_with_counter(k % n_machines)
                     for k in range(n_keys)]
        self.n_keys = n_keys

    def spec(self):
        return KVSpec(self.n_keys)

    def put(self, mv, k, v):
        yield from mv.shared_store(self.keys[k], v, True)
        yield from mv.complete_op()
        return None

    def get(self, mv, k):
        v = yield from mv.shared_load(self.keys[k], True)
        yield from mv.complete_op()
        return v
