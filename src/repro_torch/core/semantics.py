"""CXL0 operational semantics (paper §3.3, Fig. 2) + variants (§3.5).

Every step of the labeled transition system is a function
``State -> Optional[State]`` (None = the step is not enabled).  Labels:

* machine actions:  LStore_i(x,v)  RStore_i(x,v)  MStore_i(x,v)
                    Load_i(x,v)    LFlush_i(x)    RFlush_i(x)   GPF_i
                    {L,R,M}-RMW_i(x, old, new)
* silent internal propagation τ:  PropCC(i,x)  (cache→owner-cache) and
                                  PropCM(x)    (owner-cache→memory)
* crash:  f_i

Variants:
* ``Variant.BASE`` — the CXL0 model of §3.3.
* ``Variant.PSN``  — crash poisons the crashed machine's addresses in all
  caches (CXL Isolation / MemData-NXM, §3.5).
* ``Variant.LWB``  — remote loads with implicit write-back: LOAD-from-C is
  restricted to the *own* cache; any other load must wait until no cache
  holds the line and read memory (§3.5).

Flushes are modeled as *blocking* preconditions (the MFENCE-in-TSO trick the
paper cites): ``LFlush_i(x)`` is enabled only once ``C_i(x) = ⊥``,
``RFlush_i(x)`` once no cache holds ``x``; nondeterministic τ steps do the
actual draining.  ``step_with_tau`` resolves the blocking by scheduling the
necessary propagation, which is what program-level simulators use.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.state import BOT, State, SystemConfig


class Variant(enum.Enum):
    BASE = "base"
    PSN = "psn"        # crash with cache-line poisoning
    LWB = "lwb"        # remote loads with implicit write-back


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Label:
    kind: str                       # lstore|rstore|mstore|load|lflush|rflush|
    #                                 gpf|rmw|tau_cc|tau_cm|crash
    machine: Optional[int] = None
    loc: Optional[int] = None
    val: Optional[int] = None       # store value / observed load value
    old: Optional[int] = None       # rmw expected value
    rmw_store: Optional[str] = None  # 'l'|'r'|'m' for RMW store flavor

    def __repr__(self):
        a = [k for k in ("machine", "loc", "val", "old") if getattr(self, k) is not None]
        args = ",".join(f"{k}={getattr(self, k)}" for k in a)
        tag = f"{self.kind}" + (f"[{self.rmw_store}]" if self.rmw_store else "")
        return f"{tag}({args})"


def LStore(i, x, v):  return Label("lstore", i, x, v)
def RStore(i, x, v):  return Label("rstore", i, x, v)
def MStore(i, x, v):  return Label("mstore", i, x, v)
def Load(i, x, v=None): return Label("load", i, x, v)
def LFlush(i, x):     return Label("lflush", i, x)
def RFlush(i, x):     return Label("rflush", i, x)
def GPF(i):           return Label("gpf", i)
def Crash(i):         return Label("crash", i)
def RMW(i, x, old, new, flavor="l"):
    return Label("rmw", i, x, new, old, rmw_store=flavor)
def TauCC(i, x):      return Label("tau_cc", i, x)
def TauCM(x):         return Label("tau_cm", None, x)


# ---------------------------------------------------------------------------
# Individual steps (Fig. 2)
# ---------------------------------------------------------------------------

def step_lstore(cfg: SystemConfig, s: State, i: int, x: int, v: int) -> State:
    """LStore_i(x,v): C_i(x) := v; invalidate x in all other caches."""
    return s.invalidate_others(i, x).set_cache(i, x, v)


def step_rstore(cfg: SystemConfig, s: State, i: int, x: int, v: int) -> State:
    """RStore_i(x,v): C_k(x) := v for the owner k; invalidate elsewhere."""
    k = cfg.owner[x]
    return s.invalidate_others(k, x).set_cache(k, x, v)


def step_mstore(cfg: SystemConfig, s: State, i: int, x: int, v: int) -> State:
    """MStore_i(x,v): M_k(x) := v; invalidate x in ALL caches."""
    return s.invalidate_others(None, x).set_mem(x, v)


def step_load(cfg: SystemConfig, s: State, i: int, x: int,
              variant: Variant = Variant.BASE) -> Optional[Tuple[State, int]]:
    """Load_i(x): returns (state', observed value) or None if blocked (LWB).

    BASE/PSN — LOAD-from-C: if any cache holds x, read that value and copy it
    into C_i (enables a future LFlush_i); LOAD-from-M otherwise (no state
    change).  LWB — own-cache hit reads without copying; otherwise blocked
    until no cache holds x, then LOAD-from-M.
    """
    if variant is Variant.LWB:
        own = s.C[i][x]
        if own is not BOT:
            return s, own
        if s.cached_anywhere(x):
            return None                       # blocked: must drain first
        return s, s.M[x]
    v = s.cached_value(x)
    if v is not BOT:
        return s.set_cache(i, x, v), v
    return s, s.M[x]


def step_lflush(cfg: SystemConfig, s: State, i: int, x: int) -> Optional[State]:
    """LFlush_i(x): enabled once C_i(x) = ⊥ (blocking-precondition model)."""
    return s if s.C[i][x] is BOT else None


def step_rflush(cfg: SystemConfig, s: State, i: int, x: int) -> Optional[State]:
    """RFlush_i(x): enabled once no cache holds x."""
    return s if not s.cached_anywhere(x) else None


def step_gpf(cfg: SystemConfig, s: State, i: int) -> Optional[State]:
    """GPF_i: enabled once ALL caches are fully drained (global RFlush)."""
    all_empty = all(v is BOT for row in s.C for v in row)
    return s if all_empty else None


def step_tau_cc(cfg: SystemConfig, s: State, i: int, x: int) -> Optional[State]:
    """Horizontal propagation: C_i(x) moves to the owner's cache, i ≠ owner."""
    k = cfg.owner[x]
    if i == k or s.C[i][x] is BOT:
        return None
    v = s.C[i][x]
    return s.set_cache(i, x, BOT).set_cache(k, x, v)


def step_tau_cm(cfg: SystemConfig, s: State, x: int) -> Optional[State]:
    """Vertical propagation: owner's cached value reaches owner's memory and
    is removed from ALL caches."""
    k = cfg.owner[x]
    if s.C[k][x] is BOT:
        return None
    v = s.C[k][x]
    return s.invalidate_others(None, x).set_mem(x, v)


def step_crash(cfg: SystemConfig, s: State, i: int,
               variant: Variant = Variant.BASE) -> State:
    """f_i: machine i loses its cache; volatile M_i resets to 0.
    PSN additionally poisons (⊥) i's addresses in every other cache."""
    C = list(s.C)
    C[i] = tuple(BOT for _ in range(cfg.n_locs))
    if variant is Variant.PSN:
        for j in range(cfg.n_machines):
            if j == i:
                continue
            C[j] = tuple(BOT if cfg.owner[x] == i else v
                         for x, v in enumerate(C[j]))
    M = s.M
    if cfg.volatile[i]:
        M = tuple(0 if cfg.owner[x] == i else v for x, v in enumerate(M))
    return State(tuple(C), M)


def step_rmw(cfg: SystemConfig, s: State, i: int, x: int, old: int, new: int,
             flavor: str = "l",
             variant: Variant = Variant.BASE) -> Optional[Tuple[State, bool]]:
    """Atomic load+store (§3.3).  Returns (state', success) or None (blocked).

    The load half observes the cached value if one exists, else memory (under
    LWB a non-own cached value blocks, as for Load).  On CAS failure
    (observed ≠ old) the RMW degenerates to a plain read.  On success the
    store half is an {L,R,M}Store of ``new`` according to ``flavor``.
    """
    loaded = step_load(cfg, s, i, x, variant)
    if loaded is None:
        return None
    _, v = loaded
    if v != old:
        # failed CAS ≡ plain read (paper §3.3) — incl. the load's cache copy
        return loaded[0], False
    if flavor == "l":
        return step_lstore(cfg, s, i, x, new), True
    if flavor == "r":
        return step_rstore(cfg, s, i, x, new), True
    if flavor == "m":
        return step_mstore(cfg, s, i, x, new), True
    raise ValueError(flavor)


def step_faa(cfg: SystemConfig, s: State, i: int, x: int, delta: int,
             flavor: str = "l",
             variant: Variant = Variant.BASE) -> Optional[Tuple[State, int]]:
    """Fetch-and-add, an always-succeeding RMW. Returns (state', old value)."""
    loaded = step_load(cfg, s, i, x, variant)
    if loaded is None:
        return None
    _, v = loaded
    new = v + delta
    if flavor == "l":
        return step_lstore(cfg, s, i, x, new), v
    if flavor == "r":
        return step_rstore(cfg, s, i, x, new), v
    if flavor == "m":
        return step_mstore(cfg, s, i, x, new), v
    raise ValueError(flavor)


# ---------------------------------------------------------------------------
# Generic transition application + enumeration
# ---------------------------------------------------------------------------

def apply_label(cfg: SystemConfig, s: State, lab: Label,
                variant: Variant = Variant.BASE) -> Optional[State]:
    """Apply one labeled transition; None if not enabled / not observable.

    For ``load`` labels with ``val`` set, the step is enabled only when the
    observed value matches (litmus-test style); with ``val=None`` any
    observation is allowed.
    """
    k = lab.kind
    if k == "lstore":
        return step_lstore(cfg, s, lab.machine, lab.loc, lab.val)
    if k == "rstore":
        return step_rstore(cfg, s, lab.machine, lab.loc, lab.val)
    if k == "mstore":
        return step_mstore(cfg, s, lab.machine, lab.loc, lab.val)
    if k == "load":
        r = step_load(cfg, s, lab.machine, lab.loc, variant)
        if r is None:
            return None
        s2, v = r
        if lab.val is not None and v != lab.val:
            return None
        return s2
    if k == "lflush":
        return step_lflush(cfg, s, lab.machine, lab.loc)
    if k == "rflush":
        return step_rflush(cfg, s, lab.machine, lab.loc)
    if k == "gpf":
        return step_gpf(cfg, s, lab.machine)
    if k == "crash":
        return step_crash(cfg, s, lab.machine, variant)
    if k == "rmw":
        r = step_rmw(cfg, s, lab.machine, lab.loc, lab.old, lab.val,
                     lab.rmw_store or "l", variant)
        return None if r is None else r[0]
    if k == "tau_cc":
        return step_tau_cc(cfg, s, lab.machine, lab.loc)
    if k == "tau_cm":
        return step_tau_cm(cfg, s, lab.loc)
    raise ValueError(k)


def tau_steps(cfg: SystemConfig, s: State) -> Iterator[Tuple[Label, State]]:
    """All enabled silent propagation steps from s."""
    for x in range(cfg.n_locs):
        for i in range(cfg.n_machines):
            s2 = step_tau_cc(cfg, s, i, x)
            if s2 is not None:
                yield TauCC(i, x), s2
        s2 = step_tau_cm(cfg, s, x)
        if s2 is not None:
            yield TauCM(x), s2


def tau_closure(cfg: SystemConfig, s: State) -> List[State]:
    """All states reachable from s via τ* (BFS; state spaces here are small)."""
    seen = {s}
    frontier = [s]
    while frontier:
        nxt = []
        for st in frontier:
            for _, st2 in tau_steps(cfg, st):
                if st2 not in seen:
                    seen.add(st2)
                    nxt.append(st2)
        frontier = nxt
    return list(seen)


def step_with_tau(cfg: SystemConfig, s: State, lab: Label,
                  variant: Variant = Variant.BASE) -> List[State]:
    """All states reachable by τ* · lab  (the paper's ⟶^{α} with silent steps).

    This is how blocking flushes actually execute: the scheduler interleaves
    the propagation steps needed to satisfy the precondition.
    """
    out = []
    seen = set()
    for st in tau_closure(cfg, s):
        s2 = apply_label(cfg, st, lab, variant)
        if s2 is not None and s2 not in seen:
            seen.add(s2)
            out.append(s2)
    return out


def enabled_labels(cfg: SystemConfig, s: State, values: Tuple[int, ...],
                   variant: Variant = Variant.BASE,
                   crashes: bool = True) -> Iterator[Tuple[Label, State]]:
    """Enumerate every enabled non-silent transition over a small value set.

    Used by the bounded explorer (props / refinement). ``values`` bounds the
    store-value alphabet.
    """
    n, L = cfg.n_machines, cfg.n_locs
    for i, x in itertools.product(range(n), range(L)):
        for v in values:
            yield LStore(i, x, v), step_lstore(cfg, s, i, x, v)
            yield RStore(i, x, v), step_rstore(cfg, s, i, x, v)
            yield MStore(i, x, v), step_mstore(cfg, s, i, x, v)
        r = step_load(cfg, s, i, x, variant)
        if r is not None:
            s2, v = r
            yield Load(i, x, v), s2
        s2 = step_lflush(cfg, s, i, x)
        if s2 is not None:
            yield LFlush(i, x), s2
        s2 = step_rflush(cfg, s, i, x)
        if s2 is not None:
            yield RFlush(i, x), s2
    for i in range(n):
        s2 = step_gpf(cfg, s, i)
        if s2 is not None:
            yield GPF(i), s2
        if crashes:
            yield Crash(i), step_crash(cfg, s, i, variant)
