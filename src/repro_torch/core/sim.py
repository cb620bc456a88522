"""Concurrent simulator: threads over the CXL0 LTS with crash injection.

Threads are generators yielding primitive requests (see ``core.flit``); the
simulator owns the ``State`` and drives a randomized schedule:

* pick a runnable thread, execute its next primitive;
* with probability ``p_tau`` interleave a random silent propagation step
  (nondeterministic cache eviction — the dotted lines of the paper's Fig. 1);
* with probability ``p_crash`` (bounded by ``max_crashes``) crash a machine:
  its cache is lost, its memory reset if volatile, and every thread homed on
  it dies mid-operation (the op stays *pending* in the history);
* ``respect_atomic=True`` (default) honors the views' store→flush
  failure-atomic sections — the paper's synchronous-flush assumption (§B
  Condition 2): crashes are deferred while any thread is inside one.
  ``respect_atomic=False`` exposes the window (see the FINDING tests:
  Alg. 2 is NOT durable under unrestricted partial crashes);
* crashed machines recover after ``recovery_delay`` scheduler ticks and then
  run their remaining operations on fresh thread ids (the paper's "new
  threads with new and distinct identifiers").

Blocking primitives (LFlush/RFlush/GPF, LWB loads) are resolved by forcing
the required propagation steps — semantically these are just the τ steps the
blocking precondition waits for.

The output is a ``History`` of invocation/response/crash events for the
durable-linearizability checker (``repro_torch.core.durable``).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, Generator, List, Optional, Tuple

from repro_torch.core.state import BOT, State, SystemConfig, initial_state
from repro_torch.core.semantics import (
    Variant, step_crash, step_faa, step_load, step_lstore, step_mstore,
    step_rmw, step_rstore, step_tau_cc, step_tau_cm, tau_steps,
)


# ---------------------------------------------------------------------------
# History events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    kind: str                  # "inv" | "res" | "crash"
    thread: Optional[int] = None
    op_id: Optional[int] = None
    op: Optional[str] = None
    args: Tuple = ()
    result: object = None
    machine: Optional[int] = None

    def __repr__(self):
        if self.kind == "crash":
            return f"crash(m{self.machine})"
        if self.kind == "inv":
            return f"inv[{self.op_id}] t{self.thread}.{self.op}{self.args}"
        return f"res[{self.op_id}] -> {self.result}"


History = List[Event]


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ThreadCtx:
    thread_id: int
    machine: int
    ops: List[Tuple[str, Callable, Tuple]]   # (op name, generator fn, args)
    gen: Optional[Generator] = None
    pending_result: object = None            # result to send into gen
    cur_op: int = 0
    cur_op_id: Optional[int] = None
    done: bool = False
    atomic_depth: int = 0                    # inside a store→flush section


class Simulator:
    def __init__(self, cfg: SystemConfig, *, variant: Variant = Variant.BASE,
                 seed: int = 0, p_tau: float = 0.3, p_crash: float = 0.0,
                 max_crashes: int = 0, recovery_delay: int = 4,
                 crashable=None, respect_atomic: bool = True):
        self.cfg = cfg
        self.variant = variant
        self.rng = random.Random(seed)
        self.state = initial_state(cfg)
        self.p_tau = p_tau
        self.p_crash = p_crash
        self.max_crashes = max_crashes
        self.recovery_delay = recovery_delay
        self.crashable = (list(crashable) if crashable is not None
                          else list(range(cfg.n_machines)))
        self.respect_atomic = respect_atomic
        self.history: History = []
        self.threads: List[ThreadCtx] = []
        self.n_crashes = 0
        self._op_counter = 0
        self._thread_counter = 0
        self._recovering: List[Tuple[int, ThreadCtx]] = []  # (ready_tick, ctx)
        self._tick = 0

    # -- thread management ---------------------------------------------------
    def spawn(self, machine: int, ops) -> ThreadCtx:
        ctx = ThreadCtx(self._thread_counter, machine, list(ops))
        self._thread_counter += 1
        self.threads.append(ctx)
        return ctx

    # -- primitive execution --------------------------------------------------
    def _force_drain_one(self, x: int):
        """Apply one propagation step moving x toward its owner's memory."""
        k = self.cfg.owner[x]
        holders = self.state.holders(x)
        non_owner = [i for i in holders if i != k]
        if non_owner:
            self.state = step_tau_cc(self.cfg, self.state,
                                     self.rng.choice(non_owner), x)
        elif k in holders:
            self.state = step_tau_cm(self.cfg, self.state, x)

    def _exec(self, machine: int, req, ctx: Optional[ThreadCtx] = None) -> object:
        op = req[0]
        if op == "atomic_begin":
            if ctx is not None:
                ctx.atomic_depth += 1
            return None
        if op == "atomic_end":
            if ctx is not None:
                ctx.atomic_depth = max(0, ctx.atomic_depth - 1)
            return None
        s = self.state
        if op == "load":
            x = req[1]
            if self.variant is Variant.LWB:
                # drain until the LWB load is enabled
                while True:
                    r = step_load(self.cfg, s, machine, x, self.variant)
                    if r is not None:
                        break
                    self._force_drain_one(x)
                    s = self.state
            else:
                r = step_load(self.cfg, s, machine, x, self.variant)
            self.state, v = r
            return v
        if op == "lstore":
            self.state = step_lstore(self.cfg, s, machine, req[1], req[2])
            return None
        if op == "rstore":
            self.state = step_rstore(self.cfg, s, machine, req[1], req[2])
            return None
        if op == "mstore":
            self.state = step_mstore(self.cfg, s, machine, req[1], req[2])
            return None
        if op == "lflush":
            x = req[1]
            while self.state.C[machine][x] is not BOT:
                self._force_drain_one(x)
            return None
        if op == "rflush":
            x = req[1]
            while self.state.cached_anywhere(x):
                self._force_drain_one(x)
            return None
        if op == "gpf":
            for x in range(self.cfg.n_locs):
                while self.state.cached_anywhere(x):
                    self._force_drain_one(x)
            return None
        if op == "faa":
            _, x, d, flavor = req
            while True:
                r = step_faa(self.cfg, self.state, machine, x, d, flavor,
                             self.variant)
                if r is not None:
                    break
                self._force_drain_one(x)
            self.state, old = r
            return old
        if op == "cas":
            _, x, old, new, flavor = req
            while True:
                r = step_rmw(self.cfg, self.state, machine, x, old, new,
                             flavor, self.variant)
                if r is not None:
                    break
                self._force_drain_one(x)
            self.state, ok = r
            return ok
        raise ValueError(req)

    # -- crash / recovery ------------------------------------------------------
    def crash_machine(self, m: int):
        self.state = step_crash(self.cfg, self.state, m, self.variant)
        self.history.append(Event("crash", machine=m))
        self.n_crashes += 1
        for ctx in self.threads:
            if ctx.machine == m and not ctx.done:
                if ctx.gen is not None:
                    ctx.gen.close()
                # ops from cur_op (+1 if mid-op: that op stays pending) resume
                # on a NEW thread id after recovery
                resume_from = ctx.cur_op + (1 if ctx.gen is not None else 0)
                ctx.done = True
                remaining = ctx.ops[resume_from:]
                if remaining:
                    new_ctx = ThreadCtx(self._thread_counter, m, remaining)
                    self._thread_counter += 1
                    self._recovering.append(
                        (self._tick + self.recovery_delay, new_ctx))

    def _maybe_recover(self):
        still = []
        for ready, ctx in self._recovering:
            if ready <= self._tick:
                self.threads.append(ctx)
            else:
                still.append((ready, ctx))
        self._recovering = still

    # -- one scheduling tick ----------------------------------------------------
    def _runnable(self) -> List[ThreadCtx]:
        return [t for t in self.threads if not t.done]

    def step_thread(self, ctx: ThreadCtx):
        if ctx.gen is None:
            if ctx.cur_op >= len(ctx.ops):
                ctx.done = True
                return
            name, fn, args = ctx.ops[ctx.cur_op]
            ctx.cur_op_id = self._op_counter
            self._op_counter += 1
            self.history.append(Event("inv", ctx.thread_id, ctx.cur_op_id,
                                      name, tuple(args)))
            ctx.gen = fn(*args)
            ctx.pending_result = None
        try:
            req = ctx.gen.send(ctx.pending_result)
        except StopIteration as fin:
            self.history.append(Event("res", ctx.thread_id, ctx.cur_op_id,
                                      result=fin.value))
            ctx.gen = None
            ctx.cur_op += 1
            if ctx.cur_op >= len(ctx.ops):
                ctx.done = True
            return
        ctx.pending_result = self._exec(ctx.machine, req, ctx)

    def run(self, max_ticks: int = 100_000):
        while True:
            self._tick += 1
            self._maybe_recover()
            runnable = self._runnable()
            if not runnable and not self._recovering:
                break
            if self._tick > max_ticks:
                raise RuntimeError("simulation did not terminate")
            # random silent eviction (nondeterministic propagation)
            if self.rng.random() < self.p_tau:
                taus = list(tau_steps(self.cfg, self.state))
                if taus:
                    _, self.state = self.rng.choice(taus)
            # random crash (deferred while a store→flush section is open
            # when respect_atomic — the paper's synchronous-flush assumption)
            atomic_open = self.respect_atomic and any(
                t.atomic_depth > 0 for t in self.threads if not t.done)
            if (self.n_crashes < self.max_crashes and not atomic_open
                    and self.rng.random() < self.p_crash and self.crashable):
                self.crash_machine(self.rng.choice(self.crashable))
                continue
            if runnable:
                self.step_thread(self.rng.choice(runnable))
        return self.history
