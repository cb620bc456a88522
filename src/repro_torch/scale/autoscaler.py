"""Cost-priced autoscaling: capacity follows demand, per topology (the
port's copy of ``repro.scale.autoscaler``: host code, the same decisions
and simulations for the same trace).

The controller watches the fleet signals a ``FleetController`` exposes —
queue depth, per-engine occupancy — and every ``window_ticks`` prices
three alternatives with the SAME emulator cost model that prices spills
(``dsm.placement.PlacementPolicy.choose_scale``):

* **hold**   — keep paying the projected queue wait at current capacity;
* **grow**   — pay the join capital (staged state transfer + gen+1
  re-flush, ``emu.join_transfer_ns``) up front to widen the lane set;
* **shrink** — pay draining a closing engine's sessions to peers, to
  stop paying one engine's capacity rent.

Every decision is a logged ``Decision`` (kind ``"scale"``) carrying all
priced alternatives, so the decision log shows WHY capacity moved —
and flips per ``--topology`` preset, emucxl-style, instead of hand-tuned
thresholds.

``simulate_autoscale`` / ``simulate_fixed`` run a deterministic queueing
simulation of a fleet under an arrival-timed trace (``scale.traffic``):
a pure function of (trace, config), used by the bench and by the scale
scenario suite's autoscale cell (``scenarios.scale.run_autoscale_cell``)
to show the autoscaled fleet beats every fixed size on priced cost.  Both
only simulate: no ``FleetController`` is driven by these decisions (the
reference's cell does not drive one either).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.dsm.emu import get_topology, join_transfer_ns
from repro_torch.dsm.placement import Decision, PlacementPolicy
from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Controller + cost-model knobs.  ``state_nbytes`` is what a grow
    moves (the joining engine's share of pool-resident state);
    ``session_nbytes`` what a shrink drains per slot.  ``engine_tick_ns``
    is one engine's capacity rent per tick — the price of standing
    still; the emulator prices everything else."""
    topology: str = "cxl20-switched-pool"
    slots_per_engine: int = 4
    min_engines: int = 1
    max_engines: int = 12                # auto may BURST past any fixed
    state_nbytes: int = 1 << 20          # 1 MiB moved per join
    session_nbytes: int = 1 << 16        # 64 KiB drained per slot
    session_ticks: float = 16.0          # a lane is HELD this long
    window_ticks: int = 1                # decision cadence
    cooldown_ticks: int = 16             # min ticks between SHRINKS
    engine_tick_ns: float = 1e6

    def __post_init__(self):
        assert 1 <= self.min_engines <= self.max_engines
        assert self.slots_per_engine >= 1 and self.window_ticks >= 1
        assert self.session_ticks > 0


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One applied scale action (decisions that chose ``hold`` are in the
    policy's decision log but are not events)."""
    tick: int
    action: str                          # "grow" | "shrink"
    engines_before: int
    engines_after: int
    costs: Dict[str, float]              # the priced alternatives


class Autoscaler:
    """The decision loop: price hold/grow/shrink through the placement
    policy, apply a cooldown so one burst cannot thrash capacity, and
    keep the applied-event history.  Stateless about the FLEET — the
    caller (simulator or a live FleetController driver) owns engines and
    applies the returned action."""

    def __init__(self, cfg: AutoscaleConfig,
                 policy: Optional[PlacementPolicy] = None):
        self.cfg = cfg
        self.policy = policy or PlacementPolicy(cfg.topology)
        self.events: List[ScaleEvent] = []
        self._last_event_tick = -10**9

    def join_delay_ticks(self) -> int:
        """How many ticks a grow takes to come online: the modelled join
        transfer at the policy's decode-tick granularity.  New capacity
        is NOT instant — the simulator and the live driver both wait
        this out, so the controller cannot pretend joins are free."""
        ns = join_transfer_ns(get_topology(self.cfg.topology),
                              self.cfg.state_nbytes)
        return max(1, math.ceil(ns / self.policy.decode_tick_ns))

    def decide(self, tick: int, queue_depth: int, n_engines: int,
               busy_lanes: int = 0) -> int:
        """Price the three alternatives and return the signed ENGINE
        DELTA to apply (0 = hold).  Grow is greedy-proportional: the
        controller keeps adding engines while the marginal engine still
        pays for itself under the cost model, so one burst is answered
        by one decision, not a window-paced trickle.  Every iteration
        logs a ``scale`` Decision; cooldown forces hold (also logged —
        an auditable suppressed decision, not silence)."""
        c = self.cfg
        kw = dict(busy_lanes=busy_lanes, session_ticks=c.session_ticks,
                  session_nbytes=c.session_nbytes,
                  window_ticks=c.window_ticks,
                  engine_tick_ns=c.engine_tick_ns,
                  min_engines=c.min_engines, max_engines=c.max_engines)
        choice = self.policy.choose_scale(
            f"fleet@t{tick}", queue_depth, n_engines, c.slots_per_engine,
            c.state_nbytes, **kw)
        # asymmetric cooldown: scale-OUT is never suppressed (queue wait
        # compounds every tick a burst goes unanswered); scale-IN waits
        # out the cooldown so one lull between bursts cannot thrash
        # capacity into a fresh join right after a drain
        if (choice == "shrink"
                and tick - self._last_event_tick < c.cooldown_ticks):
            return 0
        if choice == "hold":
            return 0
        delta = 1 if choice == "grow" else -1
        while (choice == "grow"
               and n_engines + delta < c.max_engines
               and self.policy.choose_scale(
                   f"fleet@t{tick}+{delta}", queue_depth,
                   n_engines + delta, c.slots_per_engine,
                   c.state_nbytes, **kw) == "grow"):
            delta += 1
        self._last_event_tick = tick
        self.events.append(ScaleEvent(
            tick, choice, n_engines, n_engines + delta,
            self.policy.decisions[-1].costs))
        return delta

    # -- decision-log export -------------------------------------------------
    def dump_decisions(self, path: str):
        """One JSONL line per scale Decision (all priced alternatives) —
        the artifact the CI scale-smoke job uploads."""
        with open(path, "w") as f:
            for d in self.policy.decisions_for("scale"):
                f.write(json.dumps(dataclasses.asdict(d)) + "\n")


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Deterministic outcome of one simulated fleet under one trace."""
    n_requests: int
    served: int
    lost_sessions: int
    emitted_tokens: int
    total_ticks: int
    p99_admission_ticks: float
    mean_admission_ticks: float
    priced_cost_ns: float                # rent + wait + scale capital
    engines_min: int
    engines_max: int
    decisions: int                       # scale decisions logged
    grows: int
    shrinks: int

    @property
    def tokens_per_tick(self) -> float:
        return self.emitted_tokens / max(1, self.total_ticks)


class _Lane:
    __slots__ = ("remaining",)

    def __init__(self, remaining: int):
        self.remaining = remaining


class _SimEngine:
    __slots__ = ("eid", "lanes", "draining")

    def __init__(self, eid: int, n_slots: int):
        self.eid = eid
        self.lanes: List[Optional[_Lane]] = [None] * n_slots
        self.draining = False

    @property
    def busy(self) -> int:
        return sum(1 for l in self.lanes if l is not None)


def _simulate(trace: Sequence[Request], cfg: AutoscaleConfig, *,
              scaler: Optional[Autoscaler], n_engines: int,
              max_ticks: Optional[int] = None) -> SimResult:
    """The shared engine: time-stepped, one decoded token per busy lane
    per tick.  With ``scaler`` the fleet resizes (grow comes online after
    the modelled join delay; shrink drains the highest-id engine); the
    run extends past the last arrival until the queue drains or
    ``max_ticks`` hits (undrained sessions count as LOST)."""
    assert all(trace[i].arrival <= trace[i + 1].arrival
               for i in range(len(trace) - 1)), "trace must be arrival-sorted"
    horizon = (trace[-1].arrival + 1) if trace else 1
    max_ticks = max_ticks or 16 * horizon
    policy = scaler.policy if scaler else None
    topo = get_topology(cfg.topology)
    decode_tick_ns = (policy.decode_tick_ns if policy
                      else PlacementPolicy(cfg.topology).decode_tick_ns)

    engines: List[_SimEngine] = [_SimEngine(i + 1, cfg.slots_per_engine)
                                 for i in range(n_engines)]
    next_eid = n_engines + 1
    pending_grow: List[int] = []         # ticks each pending join lands
    queue: List[Request] = []
    latencies: List[int] = []
    emitted = 0
    cost = 0.0
    grows = shrinks = 0
    emin = emax = len(engines)
    i = 0                                # next trace index
    t = 0
    while t < max_ticks:
        while i < len(trace) and trace[i].arrival <= t:
            queue.append(trace[i])
            i += 1
        # decode: every busy lane emits one token
        for e in engines:
            for s, lane in enumerate(e.lanes):
                if lane is None:
                    continue
                lane.remaining -= 1
                emitted += 1
                if lane.remaining == 0:
                    e.lanes[s] = None
        # a draining engine with no busy lane closes NOW
        closing = [e for e in engines if e.draining and e.busy == 0]
        for e in closing:
            engines.remove(e)
        # pending joins land
        for d in list(pending_grow):
            if d <= t:
                pending_grow.remove(d)
                engines.append(_SimEngine(next_eid, cfg.slots_per_engine))
                next_eid += 1
        # admit FIFO into free lanes of non-draining engines
        for e in engines:
            if e.draining:
                continue
            for s, lane in enumerate(e.lanes):
                if lane is None and queue:
                    r = queue.pop(0)
                    latencies.append(t - r.arrival)
                    e.lanes[s] = _Lane(r.max_new_tokens)
        # the controller
        if scaler is not None and t % cfg.window_ticks == 0:
            effective = len(engines) + len(pending_grow)
            busy = sum(e.busy for e in engines)
            delta = scaler.decide(t, len(queue), effective,
                                  busy_lanes=busy)
            if delta > 0:
                for _ in range(delta):
                    pending_grow.append(t + scaler.join_delay_ticks())
                    cost += join_transfer_ns(topo, cfg.state_nbytes)
                grows += 1
            elif delta < 0:
                # drain the highest-id non-draining engine
                cands = [e for e in engines if not e.draining]
                if len(cands) > cfg.min_engines:
                    victim = max(cands, key=lambda e: e.eid)
                    victim.draining = True
                    cost += cfg.session_nbytes * victim.busy * 2.0
                    shrinks += 1
        # per-tick rent + queue wait
        cost += ((len(engines) + len(pending_grow)) * cfg.engine_tick_ns
                 + len(queue) * decode_tick_ns)
        emin = min(emin, len(engines) + len(pending_grow))
        emax = max(emax, len(engines) + len(pending_grow))
        t += 1
        if i >= len(trace) and not queue \
                and all(e.busy == 0 for e in engines):
            break
    lost = len(queue) + (len(trace) - i)
    lat = sorted(latencies)
    p99 = float(lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]) \
        if lat else 0.0
    mean = sum(lat) / len(lat) if lat else 0.0
    n_dec = len(policy.decisions_for("scale")) if policy else 0
    return SimResult(
        n_requests=len(trace), served=len(latencies),
        lost_sessions=lost, emitted_tokens=emitted, total_ticks=t,
        p99_admission_ticks=p99, mean_admission_ticks=mean,
        priced_cost_ns=cost, engines_min=emin, engines_max=emax,
        decisions=n_dec, grows=grows, shrinks=shrinks)


def simulate_fixed(trace: Sequence[Request], n_engines: int,
                   cfg: AutoscaleConfig) -> SimResult:
    """A fixed-size fleet under the trace — the baseline family the
    autoscaled run must beat on priced cost."""
    return _simulate(trace, cfg, scaler=None, n_engines=n_engines)


def simulate_autoscale(trace: Sequence[Request], cfg: AutoscaleConfig, *,
                       start_engines: Optional[int] = None,
                       scaler: Optional[Autoscaler] = None) -> SimResult:
    """The autoscaled fleet: same simulator, controller in the loop.
    Pass ``scaler`` to keep its decision log for export."""
    scaler = scaler or Autoscaler(cfg)
    return _simulate(trace, cfg, scaler=scaler,
                     n_engines=start_engines or cfg.min_engines)
