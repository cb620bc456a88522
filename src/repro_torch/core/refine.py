"""Variant refinement (paper §3.5): trace inclusion between CXL0 models.

The paper encodes the models as CSP processes and uses the FDR4 refinement
checker.  Our stand-in is the textbook construction FDR itself uses:
determinize both LTSs over the observable alphabet (subset construction,
τ-closed) and BFS the product — a trace of ``sub`` escapes ``sup`` iff some
reachable pair has a label enabled in ``sub``'s subset but not ``sup``'s.
This decides full trace inclusion (all depths, to fixpoint), not a bounded
approximation.

Expected results (paper §3.5):
* traces(PSN) ⊆ traces(BASE) and traces(LWB) ⊆ traces(BASE);
* PSN ⊄ LWB (witness: litmus test 10) and LWB ⊄ PSN (witness: test 12),
  i.e. the two hardware variants are incomparable.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.state import State, SystemConfig, make_config, initial_state
from repro_torch.core.semantics import (
    Crash, Label, LFlush, Load, LStore, MStore, RFlush, RStore, Variant,
    apply_label,
)
from repro_torch.core.explore import tau_closure

Subset = FrozenSet[State]


def default_alphabet(cfg: SystemConfig,
                     values: Tuple[int, ...] = (0, 1)) -> List[Label]:
    """Observable alphabet: stores / loads (with observed value) / flushes /
    crashes.  Loads carry the observed value so the DFA is deterministic."""
    labs: List[Label] = []
    ms, locs = range(cfg.n_machines), range(cfg.n_locs)
    for i, x in itertools.product(ms, locs):
        for v in values:
            labs.append(LStore(i, x, v))
            labs.append(RStore(i, x, v))
            labs.append(MStore(i, x, v))
            labs.append(Load(i, x, v))
        labs.append(LFlush(i, x))
        labs.append(RFlush(i, x))
    for i in ms:
        labs.append(Crash(i))
    return labs


class _DetLTS:
    """τ-closed subset-construction view of one CXL0 variant."""

    def __init__(self, cfg: SystemConfig, variant: Variant):
        self.cfg, self.variant = cfg, variant
        self._closure_cache: Dict[State, FrozenSet[State]] = {}

    def closure(self, s: State) -> FrozenSet[State]:
        got = self._closure_cache.get(s)
        if got is None:
            got = frozenset(tau_closure(self.cfg, s))
            self._closure_cache[s] = got
        return got

    def initial(self) -> Subset:
        return self.closure(initial_state(self.cfg))

    def post(self, sub: Subset, lab: Label) -> Subset:
        out = set()
        for s in sub:
            s2 = apply_label(self.cfg, s, lab, self.variant)
            if s2 is not None:
                out.update(self.closure(s2))
        return frozenset(out)


@dataclasses.dataclass
class RefinementResult:
    sub: Variant
    sup: Variant
    explored_pairs: int
    witness: Optional[Tuple[str, ...]]        # a trace of sub not in sup

    @property
    def refines(self) -> bool:
        return self.witness is None


def check_refinement(sub: Variant, sup: Variant,
                     cfg: Optional[SystemConfig] = None,
                     values: Tuple[int, ...] = (0, 1),
                     max_pairs: int = 500_000) -> RefinementResult:
    """Full trace-language inclusion traces(sub) ⊆ traces(sup)."""
    cfg = cfg or make_config(2, 1)
    alphabet = default_alphabet(cfg, values)
    A, B = _DetLTS(cfg, sub), _DetLTS(cfg, sup)
    start = (A.initial(), B.initial())
    seen = {start}
    frontier: List[Tuple[Tuple[Subset, Subset], Tuple[str, ...]]] = [
        (start, ())]
    explored = 0
    while frontier:
        nxt = []
        for (sa, sb), trace in frontier:
            explored += 1
            if explored > max_pairs:
                raise RuntimeError("refinement product exceeds bound")
            for lab in alphabet:
                pa = A.post(sa, lab)
                if not pa:
                    continue
                pb = B.post(sb, lab)
                tr = trace + (repr(lab),)
                if not pb:
                    return RefinementResult(sub, sup, explored, tr)
                pair = (pa, pb)
                if pair not in seen:
                    seen.add(pair)
                    nxt.append((pair, tr))
        frontier = nxt
    return RefinementResult(sub, sup, explored, None)


def check_all_refinements(cfg: Optional[SystemConfig] = None) -> dict:
    """The paper's comparison matrix: variants ⊑ BASE; PSN vs LWB both ways."""
    cfg = cfg or make_config(2, 1)
    out = {}
    for sub, sup in [(Variant.PSN, Variant.BASE), (Variant.LWB, Variant.BASE),
                     (Variant.BASE, Variant.PSN), (Variant.BASE, Variant.LWB),
                     (Variant.PSN, Variant.LWB), (Variant.LWB, Variant.PSN)]:
        out[(sub.value, sup.value)] = check_refinement(sub, sup, cfg)
    return out
