"""Workload harness: objects × policies × schedules × crashes → verdicts.

Builds small concurrent workloads over the simulator and checks durable
linearizability of the produced histories.  Used by tests, the hypothesis
property suite, and ``benchmarks/bench_flit.py``:

* durable policies (``flit_cxl0``, ``mstore_all``) must yield durably
  linearizable histories on EVERY schedule/seed;
* negative controls (``raw``, ``original_flit``) must exhibit at least one
  durability violation across a seed sweep (the §6 motivating example).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.state import SystemConfig
from repro_torch.core.semantics import Variant
from repro_torch.core.sim import Simulator, History
from repro_torch.core.flit import POLICIES, MemView
from repro_torch.core.objects import (
    Counter, KVMap, Layout, Register, TreiberStack,
)
from repro_torch.core.durable import durably_linearizable


@dataclasses.dataclass
class Workload:
    name: str
    cfg: SystemConfig
    spec: object
    # (sim, view) -> None: spawns threads on the simulator
    spawn: Callable[[Simulator, MemView], None]
    crashable: Tuple[int, ...]
    counter_of: Callable[[int], Optional[int]] = (lambda x: None)


def _sys(layout: Layout, n_machines: int) -> SystemConfig:
    return SystemConfig(n_machines=n_machines, owner=tuple(layout.owners),
                        volatile=tuple(False for _ in range(n_machines)))


# ---------------------------------------------------------------------------
# Workload builders
# ---------------------------------------------------------------------------

def counter_workload(n_machines: int = 2, incs_per_thread: int = 2) -> Workload:
    """Counter owned by machine 0; machines 0..n-1 each inc; machine n-1
    (never crashed) reads at the end."""
    layout = Layout()
    counter = Counter(layout, owner=0)
    cfg = _sys(layout, n_machines)

    def spawn(sim: Simulator, mv: MemView):
        for m in range(n_machines):
            ops = [("inc", lambda mv=mv: counter.inc(mv), ())
                   for _ in range(incs_per_thread)]
            sim.spawn(m, ops)
        sim.spawn(n_machines - 1,
                  [("read", lambda mv=mv: counter.read(mv), ())] * 2)

    return Workload("counter", cfg, counter.spec(), spawn,
                    crashable=tuple(range(n_machines - 1)),
                    counter_of=layout.counter_of)


def register_workload(n_machines: int = 2) -> Workload:
    layout = Layout()
    reg = Register(layout, owner=0)
    cfg = _sys(layout, n_machines)

    def spawn(sim: Simulator, mv: MemView):
        for m in range(n_machines):
            sim.spawn(m, [("write", (lambda v, mv=mv: reg.write(mv, v)),
                           (10 * (m + 1) + j,)) for j in range(2)])
        sim.spawn(n_machines - 1,
                  [("read", lambda mv=mv: reg.read(mv), ())] * 2)

    return Workload("register", cfg, reg.spec(), spawn,
                    crashable=tuple(range(n_machines - 1)),
                    counter_of=layout.counter_of)


def stack_workload(n_machines: int = 2, pushes: int = 2) -> Workload:
    layout = Layout()
    n_threads = n_machines
    stack = TreiberStack(layout, owner=0, n_slots=2 * pushes * n_threads,
                         n_threads=n_threads)
    cfg = _sys(layout, n_machines)

    def spawn(sim: Simulator, mv: MemView):
        for m in range(n_machines):
            ops = [("push", (lambda v, mv=mv, t=m: stack.push(mv, v, t)),
                    (10 * (m + 1) + j,)) for j in range(pushes)]
            sim.spawn(m, ops)
        sim.spawn(n_machines - 1,
                  [("pop", lambda mv=mv, t=n_machines - 1:
                    stack.pop(mv, t), ())] * (pushes + 1))

    return Workload("stack", cfg, stack.spec(), spawn,
                    crashable=tuple(range(n_machines - 1)),
                    counter_of=layout.counter_of)


def kv_workload(n_machines: int = 2, n_keys: int = 2) -> Workload:
    layout = Layout()
    kv = KVMap(layout, n_keys, n_machines)
    cfg = _sys(layout, n_machines)

    def spawn(sim: Simulator, mv: MemView):
        for m in range(n_machines):
            ops = []
            for k in range(n_keys):
                ops.append(("put", (lambda k, v, mv=mv: kv.put(mv, k, v)),
                            (k, 10 * (m + 1) + k)))
            sim.spawn(m, ops)
        sim.spawn(n_machines - 1,
                  [("get", (lambda k, mv=mv: kv.get(mv, k)), (k,))
                   for k in range(n_keys)])

    return Workload("kv", cfg, kv.spec(), spawn,
                    crashable=tuple(range(n_machines - 1)),
                    counter_of=layout.counter_of)


WORKLOADS: Dict[str, Callable[[], Workload]] = {
    "counter": counter_workload,
    "register": register_workload,
    "stack": stack_workload,
    "kv": kv_workload,
}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    workload: str
    policy: str
    seed: int
    crashed: int
    durable: bool
    history: History


def run_once(make_workload: Callable[[], Workload], policy: str, seed: int,
             *, variant: Variant = Variant.BASE, p_crash: float = 0.05,
             max_crashes: int = 1, p_tau: float = 0.3,
             respect_atomic: bool = True) -> RunResult:
    wl = make_workload()        # fresh object state per run
    view_cls = POLICIES[policy]
    sim = Simulator(wl.cfg, variant=variant, seed=seed, p_tau=p_tau,
                    p_crash=p_crash, max_crashes=max_crashes,
                    crashable=list(wl.crashable),
                    respect_atomic=respect_atomic)
    view = view_cls(counter_of=wl.counter_of)
    wl.spawn(sim, view)
    history = sim.run()
    ok = durably_linearizable(history, wl.spec)
    return RunResult(wl.name, policy, seed, sim.n_crashes, ok, history)


def sweep(make_workload: Callable[[], Workload], policy: str,
          seeds: range, **kw) -> List[RunResult]:
    return [run_once(make_workload, policy, s, **kw) for s in seeds]
