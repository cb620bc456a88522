"""Proposition 1 (paper §3.4): eight simulation facts between primitives.

The paper proves these in Rocq; we verify them *exhaustively* over bounded
universes: for every reachable state γ of a small system and all machine /
location / value choices, the set of states reachable via the left-hand
label sequence (τ-interleaved) is contained in the right-hand one.

``γ →^{α1..αn} γ'`` is read as: transitions labeled α1..αn possibly
interleaved with silent τ steps (before, between, after) — implemented by
``explore.trace_final_states``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.state import State, SystemConfig
from repro_torch.core.semantics import (
    Label, LFlush, LStore, MStore, RFlush, RStore, Variant,
)
from repro_torch.core.explore import reachable, trace_final_states


def _targets(cfg: SystemConfig, s: State, labels: Sequence[Label],
             variant: Variant) -> Set[State]:
    return set(trace_final_states(cfg, labels, variant, start=s))


@dataclasses.dataclass(frozen=True)
class PropItem:
    idx: int
    name: str
    # (cfg, i, j, k, x, v) -> (lhs labels, rhs labels) or None if inapplicable
    make: Callable


def _items() -> Tuple[PropItem, ...]:
    def item1(cfg, i, j, k, x, v):
        # RStore is stronger than LStore (any i)
        return [RStore(i, x, v)], [LStore(i, x, v)]

    def item2(cfg, i, j, k, x, v):
        # LStore by the OWNER is simulated by RStore by the owner
        return [LStore(k, x, v)], [RStore(k, x, v)]

    def item3(cfg, i, j, k, x, v):
        return [MStore(i, x, v)], [RStore(i, x, v)]

    def item4(cfg, i, j, k, x, v):
        return [RFlush(i, x)], [LFlush(i, x)]

    def item5(cfg, i, j, k, x, v):
        # LFlush after RStore by NON-owner is redundant
        if j == k:
            return None
        return [RStore(j, x, v)], [RStore(j, x, v), LFlush(j, x)]

    def item6(cfg, i, j, k, x, v):
        return [MStore(i, x, v)], [MStore(i, x, v), RFlush(i, x)]

    def item7(cfg, i, j, k, x, v):
        # RStore by non-owner is simulated by LStore + LFlush
        if j == k:
            return None
        return [LStore(j, x, v), LFlush(j, x)], [RStore(j, x, v)]

    def item8(cfg, i, j, k, x, v):
        return [LStore(i, x, v), RFlush(i, x)], [MStore(i, x, v)]

    return (
        PropItem(1, "RStore stronger than LStore", item1),
        PropItem(2, "owner LStore ≡ owner RStore", item2),
        PropItem(3, "MStore stronger than RStore", item3),
        PropItem(4, "RFlush stronger than LFlush", item4),
        PropItem(5, "LFlush after non-owner RStore redundant", item5),
        PropItem(6, "RFlush after MStore redundant", item6),
        PropItem(7, "non-owner RStore ≈ LStore·LFlush", item7),
        PropItem(8, "MStore ≈ LStore·RFlush", item8),
    )


PROP1_ITEMS = _items()


@dataclasses.dataclass
class PropResult:
    item: PropItem
    checked: int
    counterexample: Optional[Tuple[State, Sequence[Label], Sequence[Label],
                                   State]]

    @property
    def ok(self) -> bool:
        return self.counterexample is None


def check_prop1_item(item: PropItem, cfg: SystemConfig,
                     values: Tuple[int, ...] = (0, 1),
                     variant: Variant = Variant.BASE,
                     states: Optional[Set[State]] = None,
                     crashes_in_universe: bool = True) -> PropResult:
    """Exhaustively check one Proposition-1 item over reachable states."""
    if states is None:
        states = reachable(cfg, values, variant, crashes=crashes_in_universe)
    n, L = cfg.n_machines, cfg.n_locs
    checked = 0
    for s in states:
        for x in range(L):
            k = cfg.owner[x]
            for i, j in itertools.product(range(n), range(n)):
                for v in values:
                    pair = item.make(cfg, i, j, k, x, v)
                    if pair is None:
                        continue
                    lhs, rhs = pair
                    lhs_t = _targets(cfg, s, lhs, variant)
                    if not lhs_t:
                        continue
                    rhs_t = _targets(cfg, s, rhs, variant)
                    checked += 1
                    bad = lhs_t - rhs_t
                    if bad:
                        return PropResult(item, checked,
                                          (s, lhs, rhs, next(iter(bad))))
    return PropResult(item, checked, None)


def check_all(cfg: SystemConfig, values: Tuple[int, ...] = (0, 1),
              variant: Variant = Variant.BASE) -> List[PropResult]:
    states = reachable(cfg, values, variant)
    return [check_prop1_item(it, cfg, values, variant, states)
            for it in PROP1_ITEMS]
