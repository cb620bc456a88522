"""CXL0 system states (paper §3.3).

A state is a pair ``(C, M)``:

* ``C`` maps each machine ``i`` to its local cache ``C_i : Loc -> Val ⊎ {⊥}``
* ``M`` maps each machine ``i`` to its local memory ``M_i : Loc_i -> Val``

Locations are integers ``0..n_locs-1``; each is owned by exactly one machine
(``SystemConfig.owner``).  Values are small ints; ``BOT = None`` stands for ⊥.
States are immutable and hashable so the explorer can enumerate state spaces.

The global cache invariant (paper §3.3) is checked by ``check_invariant``:

    ∀ i, j, x.  C_i(x) ≠ ⊥ ∧ C_j(x) ≠ ⊥  ⇒  C_i(x) = C_j(x)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BOT = None            # ⊥ — the invalid cache value
INIT_VAL = 0          # the distinguished initial value "0" (paper §3.3)

Val = int
CacheRow = Tuple[Optional[Val], ...]     # one machine's cache over all locs


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static topology: who owns which location, which memories persist."""
    n_machines: int
    owner: Tuple[int, ...]               # owner[x] = machine owning loc x
    volatile: Tuple[bool, ...]           # volatile[i] -> M_i lost on crash

    def __post_init__(self):
        assert len(self.volatile) == self.n_machines
        assert all(0 <= o < self.n_machines for o in self.owner)

    @property
    def n_locs(self) -> int:
        return len(self.owner)

    def locs_of(self, i: int) -> Tuple[int, ...]:
        return tuple(x for x, o in enumerate(self.owner) if o == i)


def make_config(n_machines: int, locs_per_machine, volatile=None) -> SystemConfig:
    """``locs_per_machine``: int (same for all) or per-machine list."""
    if isinstance(locs_per_machine, int):
        locs_per_machine = [locs_per_machine] * n_machines
    owner = tuple(i for i, k in enumerate(locs_per_machine) for _ in range(k))
    if volatile is None:
        volatile = tuple(False for _ in range(n_machines))
    return SystemConfig(n_machines, owner, tuple(volatile))


@dataclasses.dataclass(frozen=True)
class State:
    """An immutable CXL0 state γ = (C, M)."""
    C: Tuple[CacheRow, ...]              # C[i][x] ∈ Val ⊎ {BOT}
    M: Tuple[Val, ...]                   # M[x]; owner implied by config

    # -- functional updates -------------------------------------------------
    def set_cache(self, i: int, x: int, v: Optional[Val]) -> "State":
        row = self.C[i][:x] + (v,) + self.C[i][x + 1:]
        return State(self.C[:i] + (row,) + self.C[i + 1:], self.M)

    def invalidate_others(self, i: Optional[int], x: int) -> "State":
        """Set C_j(x) = ⊥ for every j ≠ i (i=None -> every j)."""
        C = tuple(
            row if j == i or row[x] is BOT
            else row[:x] + (BOT,) + row[x + 1:]
            for j, row in enumerate(self.C))
        return State(C, self.M)

    def set_mem(self, x: int, v: Val) -> "State":
        return State(self.C, self.M[:x] + (v,) + self.M[x + 1:])

    # -- queries -------------------------------------------------------------
    def cached_value(self, x: int) -> Optional[Val]:
        """The unique valid cached value of x, or BOT (uses the invariant)."""
        for row in self.C:
            if row[x] is not BOT:
                return row[x]
        return BOT

    def cached_anywhere(self, x: int) -> bool:
        return any(row[x] is not BOT for row in self.C)

    def holders(self, x: int) -> Tuple[int, ...]:
        return tuple(i for i, row in enumerate(self.C) if row[x] is not BOT)

    def read_value(self, cfg: SystemConfig, x: int) -> Val:
        """The value a Load would observe (cache wins over memory)."""
        v = self.cached_value(x)
        return self.M[x] if v is BOT else v


def initial_state(cfg: SystemConfig) -> State:
    """Empty caches, zero-initialized memories (paper §3.3)."""
    empty: CacheRow = tuple(BOT for _ in range(cfg.n_locs))
    return State(C=tuple(empty for _ in range(cfg.n_machines)),
                 M=tuple(INIT_VAL for _ in range(cfg.n_locs)))


def check_invariant(s: State) -> bool:
    n_locs = len(s.M)
    for x in range(n_locs):
        vals = {row[x] for row in s.C if row[x] is not BOT}
        if len(vals) > 1:
            return False
    return True
