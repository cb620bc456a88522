"""Durable linearizability checking (paper §6, after Izraelevitz et al.).

A history is *durably linearizable* iff it is well formed and linearizable
once all crash events are removed (the paper keeps Herlihy–Wing
happens-before as is).  Pending invocations (threads killed by a crash
mid-operation) may be completed with any result or dropped — the standard
linearizability treatment.

``linearizable(history, spec)`` implements the Wing & Gong search with
memoization on (linearized-op frozenset, spec state): at each step any op
whose invocation precedes the first response of the remaining *completed*
ops may linearize next; completed ops must reproduce their observed result,
pending ops are unconstrained and optional.

Small histories only (≲ 25 ops) — exactly the regime our simulator
produces; the search is exact, not sampled.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.sim import Event, History
from repro_torch.core.objects import SeqSpec


@dataclasses.dataclass(frozen=True)
class OpRecord:
    op_id: int
    thread: int
    op: str
    args: Tuple
    inv_index: int
    res_index: Optional[int]          # None = pending (crashed mid-op)
    result: object = None

    @property
    def completed(self) -> bool:
        return self.res_index is not None


def strip_crashes(history: History) -> List[Event]:
    return [e for e in history if e.kind != "crash"]


def collect_ops(history: History) -> List[OpRecord]:
    inv: Dict[int, Tuple[int, Event]] = {}
    res: Dict[int, Tuple[int, Event]] = {}
    events = strip_crashes(history)
    for i, e in enumerate(events):
        if e.kind == "inv":
            inv[e.op_id] = (i, e)
        elif e.kind == "res":
            res[e.op_id] = (i, e)
    ops = []
    for op_id, (i, e) in sorted(inv.items()):
        r = res.get(op_id)
        ops.append(OpRecord(op_id, e.thread, e.op, e.args, i,
                            r[0] if r else None,
                            r[1].result if r else None))
    return ops


def well_formed(history: History) -> bool:
    """Each thread's local history alternates inv/res (possibly ending with
    a pending inv killed by a crash)."""
    open_op: Dict[int, Optional[int]] = {}
    for e in history:
        if e.kind == "crash":
            continue
        if e.kind == "inv":
            if open_op.get(e.thread) is not None:
                return False
            open_op[e.thread] = e.op_id
        elif e.kind == "res":
            if open_op.get(e.thread) != e.op_id:
                return False
            open_op[e.thread] = None
    return True


def linearizable(history: History, spec: SeqSpec,
                 max_nodes: int = 2_000_000) -> bool:
    """Exact linearizability check of the crash-stripped history."""
    assert well_formed(history), "history is not well formed"
    ops = collect_ops(history)
    completed = [o for o in ops if o.completed]
    by_id = {o.op_id: o for o in ops}
    all_completed_ids = frozenset(o.op_id for o in completed)

    seen: Set[Tuple[frozenset, object]] = set()
    nodes = 0

    def first_response_bound(done: frozenset) -> float:
        rs = [o.res_index for o in completed if o.op_id not in done]
        return min(rs) if rs else float("inf")

    def dfs(done: frozenset, state) -> bool:
        nonlocal nodes
        if all_completed_ids <= done:
            return True
        key = (done, state)
        if key in seen:
            return False
        seen.add(key)
        nodes += 1
        if nodes > max_nodes:
            raise RuntimeError("linearizability search exceeded bound")
        bound = first_response_bound(done)
        for o in ops:
            if o.op_id in done or o.inv_index > bound:
                continue
            state2, result = spec.apply(state, o.op, o.args)
            if o.completed and result != o.result:
                continue
            if dfs(done | {o.op_id}, state2):
                return True
        return False

    return dfs(frozenset(), spec.initial())


def durably_linearizable(history: History, spec: SeqSpec) -> bool:
    """The paper's criterion: well formed + linearizable after removing
    crash events."""
    return well_formed(history) and linearizable(history, spec)


# ---------------------------------------------------------------------------
# Convenience: run a workload under a policy and check durability
# ---------------------------------------------------------------------------

def explain_violation(history: History) -> str:
    return "\n".join(repr(e) for e in history)
