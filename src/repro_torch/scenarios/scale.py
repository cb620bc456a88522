"""Scale scenario suite: elastic autoscaling, end to end — the port of
``repro.scenarios.scale``.

Three cell families, each an independent verdict:

* **grow cells** (``run_grow_scenario``) — N=3 REAL rank processes
  (``scenarios.cluster_worker``) plus a JOINER that enters the live
  generation at ``join_at`` through the three-phase join protocol
  (``scale.grow``).  The no-kill cell requires the grown cluster (live =
  4 ranks, gen+1) to finish with per-tensor digests BIT-IDENTICAL to a
  straight 3-rank run — growth must not perturb a single value.  The kill
  cells ``os._exit`` the joiner at each ``JOIN_POINTS`` boundary; the
  orchestrator wipes the joiner's volatile staging buffer and posts the
  unplanned shrink, and the survivors must fall back to the OLD
  membership and still finish bit-identically to the straight reference
  — a torn join never happened, whatever phase it died in (the joiner's
  entries are derivable from the gen+1 manifest's partition meta alone);

* **fleet drain cell** (``run_fleet_scale_cell``) — an in-process
  ``FleetController`` grows by one engine mid-trace, then drains an engine
  with RUNNING sessions (live-migrating them to peers, re-routing its
  queue); every output token must equal a fixed-size fleet of the same
  trace — elasticity is invisible in the token streams;

* **autoscaler cell** (``run_autoscale_cell``) — the cost-priced
  controller under the deterministic bursty trace (``scale.traffic``),
  simulated (host code, modelled CXL costs; no fleet runs), must beat
  EVERY fixed fleet size on priced cost with zero lost sessions, and its
  decision log (each decision carrying all priced alternatives) is
  written to ``autoscale_decisions.jsonl`` in the workdir.

Beside the reference's arguments, every rank process and both fleets run
on ``device`` (``"cuda"`` by default; the ranks of a one-card cluster
share it), the grow cells and the straight reference take the worker's
width (``dim``), a grow cell keeps what every rank printed in
``children`` (role, exit code, wall seconds and its JSON line, the
killed joiner's included), and the fleet cell takes its trace's shape,
the engines' size and a shared ``bundle`` / ``params``.  The defaults
are the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

from repro_torch.dsm.cluster import ControlPlane, FileStagingArea
from repro_torch.dsm.faults import JOIN_POINTS
from repro_torch.scenarios.cluster import (_terminate, finish, merge_digests,
                                           spawn_worker)
from repro_torch.scenarios.worker import KILL_EXIT


@dataclasses.dataclass
class GrowScenarioResult:
    kill_point: str                       # "none" or a JOIN_POINTS entry
    killed: bool                          # joiner exited with KILL_EXIT
    lives: List[tuple]                    # final live sets reported
    gens: List[int]
    sources: List[Optional[str]]
    digests: Dict[str, int]
    reference_digests: Dict[str, int]
    n_tensors: int
    detail: str = ""
    #: every rank of the cell: {"role", "rc", "wall_s", "result"}
    children: List[dict] = dataclasses.field(default_factory=list)

    @property
    def expected_live(self) -> tuple:
        # a killed joiner must be shrunk back OUT; an unkilled one stays
        return (0, 1, 2) if self.kill_point != "none" else (0, 1, 2, 3)

    @property
    def ok(self) -> bool:
        return ((self.kill_point == "none" or self.killed)
                and set(self.lives) == {self.expected_live}
                and len(self.digests) == self.n_tensors
                and self.digests == self.reference_digests)


def straight_reference(workdir: str, *, world: int = 3, steps: int = 8,
                       commit_every: int = 2, tensors: int = 8,
                       dim: int = 16, timeout: float = 300.0,
                       device: str = "cuda"
                       ) -> Dict[str, int]:
    """An uninterrupted ``world``-rank run with NO membership change —
    the reference every grow cell must match bit-identically (state
    updates are membership-independent, so a grown, a failed-grow and a
    never-grown cluster all converge to the same values)."""
    pool = os.path.join(workdir, "scale_reference")
    procs = {r: spawn_worker(pool, r, world, steps=steps,
                             commit_every=commit_every, replicate=True,
                             tensors=tensors, dim=dim, timeout=timeout,
                             device=device)
             for r in range(world)}
    results = []
    try:
        for r, p in procs.items():
            child, err = finish(f"reference rank {r}", p, timeout)
            if child["rc"] != 0 or child["result"] is None:
                raise RuntimeError(f"reference rank {r} rc={child['rc']}: "
                                   f"{err[-2000:]}")
            results.append(child["result"])
    finally:
        _terminate(procs)
    return merge_digests(results)


def run_grow_scenario(kill_point: str, workdir: str, *, world: int = 3,
                      join_at: int = 4, steps: int = 8,
                      commit_every: int = 2, tensors: int = 8,
                      dim: int = 16,
                      ref_digests: Optional[Dict[str, int]] = None,
                      timeout: float = 300.0,
                      device: str = "cuda") -> GrowScenarioResult:
    """One grow cell: post the planned grow, launch ``world`` old ranks
    + the joiner (killed at ``kill_point`` unless "none"), orchestrate
    the environment's side of a joiner death (wipe its volatile staging
    buffer, post the crash shrink), and compare final digests against
    the straight reference."""
    if kill_point != "none" and kill_point not in JOIN_POINTS:
        raise ValueError(f"unknown join point {kill_point!r}; "
                         f"expected 'none' or one of {JOIN_POINTS}")
    joiner = world                        # first rank id outside the world
    pool = os.path.join(workdir, f"scale_grow_{kill_point}")
    control = ControlPlane(os.path.join(pool, "control"))
    control.post_change("grow", joiner, planned=True, at_step=join_at)
    sizes = dict(steps=steps, commit_every=commit_every, replicate=True,
                 tensors=tensors, dim=dim, timeout=timeout,
                 device=device)

    procs = {r: spawn_worker(pool, r, world, **sizes) for r in range(world)}
    procs[joiner] = spawn_worker(pool, joiner, world, joiner=True,
                                 join_at=join_at, kill_point=kill_point,
                                 kill_step=0, **sizes)
    children: List[dict] = []

    def failed(killed, detail):
        return GrowScenarioResult(kill_point, killed, [], [], [], {},
                                  ref_digests or {}, tensors, detail=detail,
                                  children=children)

    killed = False
    survivors = list(range(world))
    if kill_point != "none":
        # the joiner must die at the phase boundary; then the
        # environment plays its part: volatile staging vanishes, the
        # membership change goes out on the control plane
        try:
            child, err = finish(f"joiner rank {joiner}", procs[joiner],
                                timeout)
        except subprocess.TimeoutExpired:
            _terminate(procs)
            return failed(False, "joiner never died")
        children.append(child)
        if child["rc"] != KILL_EXIT:
            _terminate(procs)
            return failed(False, f"joiner rc={child['rc']}: {err[-1500:]}")
        killed = True
        FileStagingArea(os.path.join(pool, "staging")).wipe(joiner)
        control.post_change("shrink", joiner)
    else:
        survivors = survivors + [joiner]

    results = []
    try:
        for r in survivors:
            role = f"joiner rank {r}" if r == joiner else f"rank {r}"
            child, err = finish(role, procs[r], timeout)
            children.append(child)
            if child["rc"] != 0 or child["result"] is None:
                _terminate(procs)
                return failed(killed, f"rank {r} rc={child['rc']}: "
                                      f"{err[-1500:]}")
            results.append(child["result"])
    finally:
        _terminate(procs)

    if ref_digests is None:
        ref_digests = straight_reference(
            workdir, world=world, steps=steps, commit_every=commit_every,
            tensors=tensors, dim=dim, timeout=timeout, device=device)
    try:
        digests = merge_digests(results)
    except ValueError as e:
        return failed(killed, str(e))
    return GrowScenarioResult(
        kill_point, killed,
        [tuple(r["live"]) for r in results],
        [r["gen"] for r in results],
        [r["source"] for r in results],
        digests, ref_digests, tensors, children=children)


def run_grow_suite(workdir: Optional[str] = None,
                   points: Sequence[str] = ("none",) + JOIN_POINTS,
                   *, join_at: int = 4,
                   **kwargs) -> List[GrowScenarioResult]:
    """The grow matrix: the no-kill cell + a kill at every join phase,
    all against ONE straight reference run."""
    workdir = workdir or tempfile.mkdtemp(prefix="scenarios_scale_")
    ref = straight_reference(workdir, **kwargs)
    return [run_grow_scenario(p, workdir, join_at=join_at, ref_digests=ref,
                              **kwargs)
            for p in points]


# ---------------------------------------------------------------------------
# In-process cells: fleet drain-under-load + autoscaler decision log
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetScaleResult:
    grew: bool
    drained: bool
    migrations: int
    outputs_match: bool                   # == fixed-size fleet, exact
    n_outputs: int
    detail: str = ""

    @property
    def ok(self) -> bool:
        return (self.grew and self.drained and self.migrations >= 1
                and self.outputs_match)


def run_fleet_scale_cell(workdir: str, *, requests: int = 8,
                         n_slots: int = 2, t_max: int = 32,
                         prompt_lens: Sequence[int] = (4, 8),
                         new_tokens: Sequence[int] = (2, 6),
                         vocab_size: int = 64, n_prompts: int = 0,
                         smoke: bool = True, bundle=None, params=None,
                         device: str = "cuda") -> FleetScaleResult:
    """Grow a live fleet by one engine mid-trace, then drain an engine
    that still has RUNNING sessions.  Every session's tokens must equal
    a fixed 2-engine fleet of the same trace — add/remove engines moves
    sessions, never tokens.  ``bundle`` / ``params`` (one weight set for
    both fleets) are built from seed 0 when not given."""
    from repro_torch.serve.fleet import FleetController
    from repro_torch.serve.trace import synthetic_trace

    reqs = synthetic_trace(requests, seed=0, prompt_lens=prompt_lens,
                           new_tokens=new_tokens, vocab_size=vocab_size,
                           n_prompts=n_prompts)
    kw = dict(n_engines=2, smoke=smoke, n_slots=n_slots, t_max=t_max,
              bundle=bundle, params=params, device=device)
    fc = FleetController(pool_path=os.path.join(workdir, "fleet_pool"), **kw)
    try:
        fc.submit(reqs[: requests // 2])
        for _ in range(3):
            fc.tick(rebalance=False)
        new_eid = fc.add_engine()
        fc.submit(reqs[requests // 2:])
        for _ in range(2):
            fc.tick(rebalance=False)
        # drain an engine with running sessions if any has one (the new
        # engine took fresh admissions, so it usually does)
        busy = [i for i, e in sorted(fc.engines.items())
                if e.sched.running]
        victim = busy[-1] if busy else new_eid
        had_running = bool(fc.engines[victim].sched.running)
        fc.remove_engine(victim)
        res = fc.run()
    finally:
        fc.close()

    ref = FleetController(pool_path=os.path.join(workdir, "fleet_ref"),
                          **kw)
    try:
        ref_res = ref.run(reqs, rebalance=False)
    finally:
        ref.close()
    return FleetScaleResult(
        grew=new_eid == 3, drained=had_running,
        migrations=res.migrations,
        outputs_match=(res.outputs == ref_res.outputs
                       and len(res.outputs) == requests),
        n_outputs=len(res.outputs))


@dataclasses.dataclass
class AutoscaleCellResult:
    auto_cost_ns: float
    best_fixed_cost_ns: float
    best_fixed_n: int
    auto_p99: float
    best_fixed_p99: float
    lost_sessions: int
    decisions: int
    grows: int
    shrinks: int
    decision_log: str

    @property
    def ok(self) -> bool:
        return (self.auto_cost_ns < self.best_fixed_cost_ns
                and self.lost_sessions == 0
                and self.decisions > 0 and self.grows > 0
                and os.path.exists(self.decision_log))


def run_autoscale_cell(workdir: str, *, seed: int = 3,
                       topology: str = "cxl20-switched-pool"
                       ) -> AutoscaleCellResult:
    """The controller under the bursty diurnal trace vs every fixed
    fleet size, on one topology preset.  Writes the full scale-decision
    log (JSONL, one priced decision per line) into the workdir."""
    from repro_torch.scale.autoscaler import (Autoscaler, AutoscaleConfig,
                                              simulate_autoscale,
                                              simulate_fixed)
    from repro_torch.scale.traffic import TrafficConfig, traffic_trace

    trace = traffic_trace(TrafficConfig(seed=seed))
    cfg = AutoscaleConfig(topology=topology)
    scaler = Autoscaler(cfg)
    auto = simulate_autoscale(trace, cfg, scaler=scaler)
    fixed = {n: simulate_fixed(trace, n, cfg)
             for n in range(1, cfg.max_engines + 1)}
    best_n = min(fixed, key=lambda n: fixed[n].priced_cost_ns)
    log = os.path.join(workdir, "autoscale_decisions.jsonl")
    scaler.dump_decisions(log)
    return AutoscaleCellResult(
        auto_cost_ns=auto.priced_cost_ns,
        best_fixed_cost_ns=fixed[best_n].priced_cost_ns,
        best_fixed_n=best_n,
        auto_p99=auto.p99_admission_ticks,
        best_fixed_p99=fixed[best_n].p99_admission_ticks,
        lost_sessions=auto.lost_sessions,
        decisions=auto.decisions, grows=auto.grows,
        shrinks=auto.shrinks, decision_log=log)
