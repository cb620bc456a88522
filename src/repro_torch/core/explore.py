"""Bounded exploration of the CXL0 LTS.

Two entry points:

* ``trace_feasible(cfg, trace)`` — is a *serialized* sequence of labels (the
  paper's litmus-test presentation, §3.4) realizable when interleaved with
  arbitrary silent τ propagation steps?  BFS over τ-closures.

* ``reachable(cfg, ...)`` — the full bounded reachable state space (for
  Proposition-1 checking and variant refinement), with the action alphabet
  restricted to a small value set.

State spaces here are tiny (≤ 3 machines × ≤ 3 locations × ≤ 3 values), as in
the paper's FDR4 experiments; plain BFS with hashing suffices.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.state import State, SystemConfig, initial_state, check_invariant
from repro_torch.core.semantics import (
    Label, Variant, apply_label, enabled_labels, step_with_tau, tau_closure,
)


def trace_feasible(cfg: SystemConfig, trace: Sequence[Label],
                   variant: Variant = Variant.BASE,
                   start: Optional[State] = None) -> bool:
    """Can ``trace`` be executed from the initial state (τ-interleaved)?"""
    frontier: Set[State] = {start or initial_state(cfg)}
    for lab in trace:
        nxt: Set[State] = set()
        for s in frontier:
            nxt.update(step_with_tau(cfg, s, lab, variant))
        if not nxt:
            return False
        frontier = nxt
    return True


def trace_final_states(cfg: SystemConfig, trace: Sequence[Label],
                       variant: Variant = Variant.BASE,
                       start: Optional[State] = None) -> List[State]:
    """All (τ-closed) states after executing ``trace`` (empty = infeasible)."""
    frontier: Set[State] = set(tau_closure(cfg, start or initial_state(cfg)))
    for lab in trace:
        nxt: Set[State] = set()
        for s in frontier:
            for s2 in step_with_tau(cfg, s, lab, variant):
                nxt.update(tau_closure(cfg, s2))
        frontier = nxt
        if not frontier:
            return []
    return list(frontier)


def reachable(cfg: SystemConfig, values: Tuple[int, ...] = (0, 1),
              variant: Variant = Variant.BASE, crashes: bool = True,
              max_states: int = 200_000) -> Set[State]:
    """Bounded reachable set under the full action alphabet (incl. τ)."""
    s0 = initial_state(cfg)
    seen: Set[State] = {s0}
    frontier = [s0]
    while frontier:
        nxt = []
        for s in frontier:
            succs = [s2 for _, s2 in enabled_labels(cfg, s, values, variant,
                                                    crashes)]
            succs.extend(tau_closure(cfg, s))
            for s2 in succs:
                if s2 not in seen:
                    assert check_invariant(s2), ("cache invariant violated",
                                                 s, s2)
                    seen.add(s2)
                    nxt.append(s2)
                    if len(seen) > max_states:
                        raise RuntimeError("state space exceeds bound")
        frontier = nxt
    return seen


# ---------------------------------------------------------------------------
# Observable-trace languages (for variant refinement, §3.5)
# ---------------------------------------------------------------------------

def traces_up_to(cfg: SystemConfig, depth: int,
                 values: Tuple[int, ...] = (0, 1),
                 variant: Variant = Variant.BASE,
                 crashes: bool = True,
                 label_filter=None) -> Set[Tuple[str, ...]]:
    """The set of observable traces (repr'd labels) of length ≤ depth.

    τ steps are silent: each visible step is taken from the τ-closure.
    ``label_filter(label) -> bool`` restricts the alphabet (keeps the
    language finite and comparison meaningful across variants).
    """
    out: Set[Tuple[str, ...]] = {()}
    frontier: Dict[Tuple[str, ...], Set[State]] = {
        (): set(tau_closure(cfg, initial_state(cfg)))}
    for _ in range(depth):
        nxt: Dict[Tuple[str, ...], Set[State]] = {}
        for prefix, states in frontier.items():
            for s in states:
                for lab, s2 in enabled_labels(cfg, s, values, variant,
                                              crashes):
                    if label_filter is not None and not label_filter(lab):
                        continue
                    tr = prefix + (repr(lab),)
                    out.add(tr)
                    nxt.setdefault(tr, set()).update(tau_closure(cfg, s2))
        frontier = nxt
    return out
