"""Scenario runner: kill a worker inside the commit window, restart it,
and check the durable-linearizability contract end to end — the port of
``repro.scenarios.runner``.

One TRAIN scenario (``run_scenario``):

1. **kill phase** — launch ``repro_torch.scenarios.worker`` with a kill
   point; the process ``os._exit``s mid-commit (exit code KILL_EXIT);
2. **inspect** — read the pool's manifests: the commits that COMPLETED
   before the death (a manifest exists iff its atomic rename finished);
3. **restart phase** — relaunch the same worker without the kill; it
   recovers and reports the step it resumed from;
4. **verdict** — the resumed step must be the NEWEST completed commit, and
   the final params digest must equal an uninterrupted run's.

One SERVE scenario (``run_serve_scenario``) applies the same protocol to
the serving worker (``scenarios.serve_worker``): kill inside a SESSION
commit, restart, and require that the restart resumed from the newest
completed session commit and finished the trace with every session's
tokens bit-identical to an uninterrupted run.  One FLEET scenario
(``run_fleet_scenario``) kills a 2-engine fleet right after a migration
phase; the restarted fleet must finish bit-identical to one engine.

Every worker runs on ``device`` (``"cuda"`` by default; ``"cpu"`` runs
the plain versions) and is started with ``PYTHONPATH`` at this package's
``src/``.  Each result keeps what every child printed (``children``: exit
code, wall seconds and its JSON line, the killed ones' included), so a
caller can hold the children's kernel launches and recovery times.

The CLUSTER suite (``--suite cluster``, ``scenarios.cluster``) kills 1 of
``--world`` real rank processes sharing one pool at each commit-window
point x {peer, pool} recovery source; the survivors must shrink and finish
bit-identical to a planned shrink.

    python -m repro_torch.scenarios.runner \\
        --suite train|serve|cluster|fuzz|all \\
        [--device cpu] [--workdir DIR] [--steps 8] [--commit-every 2] \\
        [--mode sharded-async] [--shards 4] [--world 3] \\
        [--kill-points pre_flush,...] [--cluster-sources peer,pool]

The scale suite spawns joiners through ``repro.scenarios.scale``, which is
not ported: ``--suite scale`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.dsm.pool import DSMPool
from repro_torch.scenarios.worker import KILL_EXIT

#: suites of the reference the runner does not run yet, and why
NOT_PORTED = {
    "scale": "repro.scenarios.scale (its grow cells, the fleet scale cell "
             "and the autoscale cell: ROADMAP A6b)",
}
#: the suites ``--suite all`` runs, in the reference's order
PORTED_SUITES = ("train", "serve", "cluster", "fuzz")


@dataclasses.dataclass
class ScenarioResult:
    kill_point: str
    killed: bool                         # kill phase exited with KILL_EXIT
    completed_steps_at_kill: List[int]   # manifest steps durable at death
    resumed_from: Optional[int]          # step the restart recovered at
    recovery_source: Optional[str]       # "pool" / "peer-staging"
    final_digest: Optional[int]
    reference_digest: Optional[int]
    detail: str = ""
    #: every child of the scenario: {"role", "rc", "wall_s", "result"}
    children: List[dict] = dataclasses.field(default_factory=list)

    @property
    def recovered_completed_commit(self) -> bool:
        return (self.resumed_from is not None
                and self.resumed_from in self.completed_steps_at_kill)

    @property
    def ok(self) -> bool:
        return (self.killed
                and self.recovered_completed_commit
                and self.resumed_from == max(self.completed_steps_at_kill)
                and self.final_digest is not None
                and self.final_digest == self.reference_digest)


def _worker_env() -> Dict[str, str]:
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _result_json(proc: subprocess.CompletedProcess) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _spawn(module: str, args: List[str], timeout: int) -> dict:
    """Run one worker to its end: ``{"proc", "rc", "wall_s", "result"}``
    (``result`` the JSON of its last stdout line, or None)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + args,
                          env=_worker_env(), capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    try:
        result = _result_json(proc)
    except (ValueError, IndexError):
        result = None
    return {"proc": proc, "rc": proc.returncode, "wall_s": wall,
            "result": result}


def _child(role: str, run: dict) -> dict:
    return {"role": role, "rc": run["rc"], "wall_s": run["wall_s"],
            "result": run["result"]}


def _run_worker(pool: str, *, steps: int, commit_every: int, mode: str,
                shards: int, retention: int, kill_point: str, kill_step: int,
                model: str, timeout: int, topology: str = "",
                decision_log: str = "", device: str = "cuda",
                layers: int = 0) -> dict:
    args = ["--pool", pool, "--steps", str(steps),
            "--commit-every", str(commit_every), "--mode", mode,
            "--shards", str(shards), "--retention", str(retention),
            "--kill-point", kill_point, "--kill-step", str(kill_step),
            "--model", model, "--device", device, "--layers", str(layers)]
    if topology:
        args += ["--topology", topology]
    if decision_log:
        args += ["--decision-log", decision_log]
    return _spawn("repro_torch.scenarios.worker", args, timeout)


def reference_run(workdir: str, *, steps: int = 8, commit_every: int = 2,
                  mode: str = "sharded-async", shards: int = 4,
                  retention: int = 0, model: str = "toy",
                  topology: str = "", device: str = "cuda",
                  layers: int = 0, timeout: int = 600) -> dict:
    """An uninterrupted run with the same configuration, as a child
    record (``{"role": "reference", "rc", "wall_s", "result"}``)."""
    pool = os.path.join(workdir, "pool_reference")
    run = _run_worker(pool, steps=steps, commit_every=commit_every,
                      mode=mode, shards=shards, retention=retention,
                      kill_point="none", kill_step=0, model=model,
                      topology=topology,
                      decision_log=(pool + "_decisions.jsonl"
                                    if topology else ""),
                      device=device, layers=layers, timeout=timeout)
    if run["rc"] != 0:
        raise RuntimeError(f"reference run failed: "
                           f"{run['proc'].stderr[-2000:]}")
    return _child("reference", run)


def reference_digest(workdir: str, **kwargs) -> int:
    """Digest of an uninterrupted run with the same configuration."""
    return reference_run(workdir, **kwargs)["result"]["digest"]


def run_scenario(kill_point: str, workdir: str, *, steps: int = 8,
                 commit_every: int = 2, mode: str = "sharded-async",
                 shards: int = 4, retention: int = 0,
                 kill_step: Optional[int] = None, model: str = "toy",
                 ref_digest: Optional[int] = None, topology: str = "",
                 device: str = "cuda", layers: int = 0,
                 timeout: int = 600) -> ScenarioResult:
    # a real raise, not an assert: under ``python -O`` an assert silently
    # accepts a bogus kill point and the scenario "passes" vacuously
    if kill_point not in KILL_POINTS:
        raise ValueError(f"unknown kill point {kill_point!r}; "
                         f"expected one of {KILL_POINTS}")
    if kill_step is None:
        # the second commit point: at least one real commit precedes it
        kill_step = 2 * commit_every - 1
    pool = os.path.join(workdir, f"pool_{kill_point}")
    common = dict(steps=steps, commit_every=commit_every, mode=mode,
                  shards=shards, retention=retention, model=model,
                  topology=topology, device=device, layers=layers,
                  timeout=timeout)

    # 1. kill phase
    p1 = _run_worker(pool, kill_point=kill_point, kill_step=kill_step,
                     decision_log=(pool + "_decisions_kill.jsonl"
                                   if topology else ""), **common)
    children = [_child("kill", p1)]
    if p1["rc"] != KILL_EXIT:
        return ScenarioResult(kill_point, False, [], None, None, None,
                              ref_digest,
                              detail=f"kill phase rc={p1['rc']}: "
                                     f"{p1['proc'].stderr[-1000:]}",
                              children=children)

    # 2. what was durably committed at the moment of death?
    completed = sorted(m["step"] for m in DSMPool(pool).manifests_desc())

    # 3. restart phase: same worker, no kill, resume from the pool
    p2 = _run_worker(pool, kill_point="none", kill_step=0,
                     decision_log=(pool + "_decisions_restart.jsonl"
                                   if topology else ""), **common)
    children.append(_child("restart", p2))
    if p2["rc"] != 0:
        return ScenarioResult(kill_point, True, completed, None, None, None,
                              ref_digest,
                              detail=f"restart rc={p2['rc']}: "
                                     f"{p2['proc'].stderr[-1000:]}",
                              children=children)
    res = p2["result"]

    # 4. verdict inputs
    if ref_digest is None:
        ref_digest = reference_digest(
            workdir, steps=steps, commit_every=commit_every, mode=mode,
            shards=shards, retention=retention, model=model,
            topology=topology, device=device, layers=layers,
            timeout=timeout)
    return ScenarioResult(
        kill_point, True, completed, res["resumed_from"],
        (res["recoveries"] or [None])[0], res["digest"], ref_digest,
        children=children)


def run_suite(workdir: Optional[str] = None, **kwargs) -> List[ScenarioResult]:
    """All three kill points, sharing one reference run."""
    workdir = workdir or tempfile.mkdtemp(prefix="scenarios_")
    ref = reference_digest(workdir, **{k: v for k, v in kwargs.items()
                                       if k != "kill_step"})
    return [run_scenario(p, workdir, ref_digest=ref, **kwargs)
            for p in KILL_POINTS]


# ---------------------------------------------------------------------------
# Serve-worker scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeScenarioResult:
    kill_point: str
    killed: bool
    completed_ticks_at_kill: List[int]   # session-commit ticks durable at death
    resumed_from: Optional[int]
    resumed_sessions: int
    recovered_done: int                  # sessions already finished at death
    outputs_match: bool                  # restart outputs == reference, exact
    detail: str = ""
    #: every child of the scenario: {"role", "rc", "wall_s", "result"}
    children: List[dict] = dataclasses.field(default_factory=list)

    @property
    def recovered_completed_commit(self) -> bool:
        return (self.resumed_from is not None
                and self.resumed_from in self.completed_ticks_at_kill)

    @property
    def ok(self) -> bool:
        return (self.killed
                and self.recovered_completed_commit
                and self.resumed_from == max(self.completed_ticks_at_kill)
                and self.outputs_match)


def _run_serve_worker(pool: str, *, requests: int, slots: int,
                      commit_every: int, restore_mode: str,
                      kill_point: str, kill_step: int, timeout: int,
                      device: str = "cuda", full: bool = False,
                      prompt_len: int = 16,
                      new_tokens: str = "4,8,16,24",
                      commit_mode: str = "sync") -> dict:
    args = ["--pool", pool, "--requests", str(requests),
            "--slots", str(slots), "--commit-every", str(commit_every),
            "--restore-mode", restore_mode,
            "--kill-point", kill_point, "--kill-step", str(kill_step),
            "--device", device, "--prompt-len", str(prompt_len),
            "--new-tokens", new_tokens, "--commit-mode", commit_mode]
    if full:
        args.append("--full")
    return _spawn("repro_torch.scenarios.serve_worker", args, timeout)


def serve_reference_run(workdir: str, *, requests: int = 10, slots: int = 4,
                        commit_every: int = 3, restore_mode: str = "cache",
                        timeout: int = 600, **worker) -> dict:
    """An uninterrupted serve run as a child record; ``worker`` takes
    ``device`` / ``full`` / ``prompt_len`` / ``new_tokens`` /
    ``commit_mode``."""
    run = _run_serve_worker(os.path.join(workdir, "serve_reference"),
                            requests=requests, slots=slots,
                            commit_every=commit_every,
                            restore_mode=restore_mode,
                            kill_point="none", kill_step=0,
                            timeout=timeout, **worker)
    if run["rc"] != 0:
        raise RuntimeError(f"serve reference failed: "
                           f"{run['proc'].stderr[-2000:]}")
    return _child("reference", run)


def serve_reference(workdir: str, **kwargs) -> dict:
    """Uninterrupted serve run: per-session outputs every kill scenario
    must reproduce exactly."""
    return serve_reference_run(workdir, **kwargs)["result"]["outputs"]


def run_serve_scenario(kill_point: str, workdir: str, *, requests: int = 10,
                       slots: int = 4, commit_every: int = 3,
                       restore_mode: str = "cache",
                       kill_step: int = 6,
                       ref_outputs: Optional[dict] = None,
                       timeout: int = 600, **worker) -> ServeScenarioResult:
    if kill_point not in KILL_POINTS:
        raise ValueError(f"unknown kill point {kill_point!r}; "
                         f"expected one of {KILL_POINTS}")
    pool = os.path.join(workdir, f"serve_{kill_point}_{restore_mode}")
    common = dict(requests=requests, slots=slots, commit_every=commit_every,
                  restore_mode=restore_mode, timeout=timeout, **worker)

    # 1. kill phase: die inside the session-commit window
    p1 = _run_serve_worker(pool, kill_point=kill_point,
                           kill_step=kill_step, **common)
    children = [_child("kill", p1)]
    if p1["rc"] != KILL_EXIT:
        return ServeScenarioResult(kill_point, False, [], None, 0, 0, False,
                                   detail=f"kill phase rc={p1['rc']}: "
                                          f"{p1['proc'].stderr[-1000:]}",
                                   children=children)

    # 2. session commits durable at the moment of death
    completed = sorted(m["step"] for m in DSMPool(pool).manifests_desc())

    # 3. restart: recover + finish the trace
    p2 = _run_serve_worker(pool, kill_point="none", kill_step=0, **common)
    children.append(_child("restart", p2))
    if p2["rc"] != 0:
        return ServeScenarioResult(kill_point, True, completed, None, 0, 0,
                                   False,
                                   detail=f"restart rc={p2['rc']}: "
                                          f"{p2['proc'].stderr[-1000:]}",
                                   children=children)
    res = p2["result"]

    # 4. verdict: every session's tokens bit-identical to the reference
    if ref_outputs is None:
        ref_outputs = serve_reference(workdir, **common)
    return ServeScenarioResult(
        kill_point, True, completed, res["resumed_from"],
        res["resumed_sessions"], res["recovered_done"],
        res["outputs"] == ref_outputs, children=children)


def run_serve_suite(workdir: Optional[str] = None, **kwargs
                    ) -> List[ServeScenarioResult]:
    """All three kill points against one shared serve reference run."""
    workdir = workdir or tempfile.mkdtemp(prefix="scenarios_")
    ref = serve_reference(workdir, **{k: v for k, v in kwargs.items()
                                      if k != "kill_step"})
    return [run_serve_scenario(p, workdir, ref_outputs=ref, **kwargs)
            for p in KILL_POINTS]


# ---------------------------------------------------------------------------
# Fleet migration scenarios (2 engines, one pool, kill mid-migration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetScenarioResult:
    """One kill-during-migration cell: the fleet dies right after a
    migration phase; the restarted fleet must re-establish the
    exactly-one-owner invariant and finish with outputs bit-identical to
    a single-engine run of the same trace.  ``staging`` says whether the
    target's host buffer survived ("kept") or was wiped ("wiped":
    adoption must take the pool arm)."""
    kill_point: str
    staging: str
    killed: bool
    outputs_match: bool
    resumed_sessions: int
    migrations_after_restart: int
    detail: str = ""
    children: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.killed and self.outputs_match


def _run_fleet_worker(pool: str, *, requests: int, slots: int,
                      commit_every: int, engines: int, migrate_at: int,
                      mig_kill_point: str, wipe_staging: int,
                      timeout: int, device: str = "cuda") -> dict:
    args = ["--pool", pool, "--requests", str(requests),
            "--slots", str(slots), "--commit-every", str(commit_every),
            "--engines", str(engines), "--migrate-at", str(migrate_at),
            "--mig-kill-point", mig_kill_point,
            "--wipe-staging", str(wipe_staging), "--device", device]
    return _spawn("repro_torch.scenarios.serve_worker", args, timeout)


def run_fleet_scenario(mig_kill_point: str, workdir: str, *,
                       requests: int = 6, slots: int = 2,
                       commit_every: int = 2, engines: int = 2,
                       migrate_at: int = 4, wipe_staging: bool = False,
                       ref_outputs: Optional[dict] = None,
                       device: str = "cuda",
                       timeout: int = 600) -> FleetScenarioResult:
    from repro_torch.serve.fleet import MIGRATION_POINTS
    if mig_kill_point not in MIGRATION_POINTS:
        raise ValueError(f"unknown migration point {mig_kill_point!r}; "
                         f"expected one of {MIGRATION_POINTS}")
    staging = "wiped" if wipe_staging else "kept"
    pool = os.path.join(workdir, f"fleet_{mig_kill_point}_{staging}")
    common = dict(requests=requests, slots=slots, commit_every=commit_every,
                  engines=engines, device=device, timeout=timeout)

    # 1. kill phase: the fleet process dies right after the phase
    p1 = _run_fleet_worker(pool, migrate_at=migrate_at,
                           mig_kill_point=mig_kill_point, wipe_staging=-1,
                           **common)
    children = [_child("kill", p1)]
    if p1["rc"] != KILL_EXIT:
        return FleetScenarioResult(mig_kill_point, staging, False, False,
                                   0, 0,
                                   detail=f"kill phase rc={p1['rc']}: "
                                          f"{p1['proc'].stderr[-1000:]}",
                                   children=children)

    # 2. restart: recover all engines, complete the handoff, finish.  The
    #    wiped variant loses the target's host buffer with the crash (the
    #    CXL0 cache-loss model): adoption must read the pool.
    p2 = _run_fleet_worker(pool, migrate_at=0, mig_kill_point="none",
                           wipe_staging=2 if wipe_staging else -1,
                           **common)
    children.append(_child("restart", p2))
    if p2["rc"] != 0:
        return FleetScenarioResult(mig_kill_point, staging, True, False,
                                   0, 0,
                                   detail=f"restart rc={p2['rc']}: "
                                          f"{p2['proc'].stderr[-1000:]}",
                                   children=children)
    res = p2["result"]

    # 3. verdict: bit-identical to a single-engine run of the same trace
    if ref_outputs is None:
        ref_outputs = fleet_reference(workdir, requests=requests,
                                      slots=slots,
                                      commit_every=commit_every,
                                      device=device, timeout=timeout)
    return FleetScenarioResult(
        mig_kill_point, staging, True, res["outputs"] == ref_outputs,
        res["resumed_sessions"], res.get("migrations", 0),
        children=children)


def fleet_reference(workdir: str, *, requests: int = 6, slots: int = 2,
                    commit_every: int = 2, device: str = "cuda",
                    timeout: int = 600) -> dict:
    """Single-engine uninterrupted run of the fleet trace: migration and
    fleet routing must not change a single output token."""
    run = _run_serve_worker(os.path.join(workdir, "fleet_reference"),
                            requests=requests, slots=slots,
                            commit_every=commit_every,
                            restore_mode="cache", kill_point="none",
                            kill_step=0, device=device, timeout=timeout)
    if run["rc"] != 0:
        raise RuntimeError(f"fleet reference failed: "
                           f"{run['proc'].stderr[-2000:]}")
    return run["result"]["outputs"]


def run_fleet_suite(workdir: Optional[str] = None, *,
                    points: Optional[List[str]] = None,
                    **kwargs) -> List[FleetScenarioResult]:
    """Kill at every migration phase x (staging kept, staging wiped),
    against one shared single-engine reference."""
    from repro_torch.serve.fleet import MIGRATION_POINTS
    workdir = workdir or tempfile.mkdtemp(prefix="scenarios_")
    ref = fleet_reference(workdir,
                          **{k: v for k, v in kwargs.items()
                             if k in ("requests", "slots", "commit_every",
                                      "device", "timeout")})
    out = []
    for p in (points or MIGRATION_POINTS):
        for wipe in (False, True):
            out.append(run_fleet_scenario(p, workdir, wipe_staging=wipe,
                                          ref_outputs=ref, **kwargs))
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="train",
                    choices=["train", "serve", "cluster", "scale", "fuzz",
                             "all"],
                    help="'all' runs the ported suites (train, serve, "
                         "cluster, fuzz); scale is not ported and raises "
                         "NotImplementedError")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every worker runs")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--commit-every", type=int, default=2)
    ap.add_argument("--mode", default="sharded-async")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--mesh", default="",
                    help="not ported (device-local mesh commits)")
    ap.add_argument("--model", default="toy",
                    choices=["toy", "smoke", "full"])
    ap.add_argument("--layers", type=int, default=0,
                    help="train suite, --model full: layers kept "
                         "(0 = the config's)")
    ap.add_argument("--requests", type=int, default=10,
                    help="serve suite: trace length")
    ap.add_argument("--slots", type=int, default=4,
                    help="serve suite: decode slots")
    ap.add_argument("--restore-mode", default="cache",
                    choices=["cache", "replay"])
    ap.add_argument("--full", action="store_true",
                    help="serve suite: the published config")
    ap.add_argument("--engines", type=int, default=1,
                    help="serve suite: >= 2 switches to the fleet "
                         "migration kill cells")
    def _world(v):
        if int(v) < 3:
            raise argparse.ArgumentTypeError(
                "--world must be >= 3 (the shrunk cluster still needs a "
                "staging sibling for every rank)")
        return int(v)
    ap.add_argument("--world", type=_world, default=3,
                    help="cluster suite: rank processes (N >= 3)")
    ap.add_argument("--kill-points", default=",".join(KILL_POINTS),
                    help="cluster suite: comma-separated subset of the "
                         "kill points")
    ap.add_argument("--cluster-sources", default="peer,pool",
                    help="cluster suite: recovery sources to exercise "
                         "(peer = sibling staging newer than the pool, "
                         "pool = replication off)")
    ap.add_argument("--episodes", type=int, default=10,
                    help="fuzz suite: episodes per (workload, topology)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fuzz suite: base seed of every episode draw")
    ap.add_argument("--topology", default="all",
                    help="fuzz suite: one topology preset, or 'all'")
    ap.add_argument("--fuzz-workloads", default="train,serve,cluster",
                    help="fuzz suite: comma-separated workload subset")
    args = ap.parse_args(argv)
    if args.suite in NOT_PORTED:
        raise NotImplementedError(
            f"--suite {args.suite} is not ported yet (reference: "
            f"{NOT_PORTED[args.suite]})")
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (reference: repro.dsm.meshio and "
            "repro.launch.mesh, ROADMAP A7)")
    workdir = args.workdir or tempfile.mkdtemp(prefix="scenarios_")
    failed = 0

    def _suite_guard(name, fn):
        """A crashed suite is a FAILED suite, and the remaining suites
        still run: no assert-and-continue, no masked exit code."""
        nonlocal failed
        try:
            fn()
        except Exception as e:                  # noqa: BLE001
            failed += 1
            print(f"runner_error,{name},{type(e).__name__}: {e}")

    def _train_suite():
        nonlocal failed
        for r in run_suite(workdir, steps=args.steps,
                           commit_every=args.commit_every, mode=args.mode,
                           shards=args.shards, model=args.model,
                           device=args.device, layers=args.layers):
            status = "OK" if r.ok else "FAIL"
            failed += not r.ok
            print(f"scenario,{r.kill_point},{status},"
                  f"completed={r.completed_steps_at_kill},"
                  f"resumed={r.resumed_from},source={r.recovery_source},"
                  f"digest_match={r.final_digest == r.reference_digest}"
                  + (f",detail={r.detail}" if r.detail else ""))

    def _serve_suite():
        nonlocal failed
        if args.engines >= 2:
            for r in run_fleet_suite(workdir, engines=args.engines,
                                     device=args.device):
                status = "OK" if r.ok else "FAIL"
                failed += not r.ok
                print(f"fleet_scenario,{r.kill_point},{r.staging},"
                      f"{status},"
                      f"resumed_sessions={r.resumed_sessions},"
                      f"outputs_bit_identical={r.outputs_match}"
                      + (f",detail={r.detail}" if r.detail else ""))
            return
        for r in run_serve_suite(workdir, requests=args.requests,
                                 slots=args.slots,
                                 restore_mode=args.restore_mode,
                                 device=args.device, full=args.full):
            status = "OK" if r.ok else "FAIL"
            failed += not r.ok
            print(f"serve_scenario,{r.kill_point},{status},"
                  f"completed={r.completed_ticks_at_kill},"
                  f"resumed={r.resumed_from},"
                  f"resumed_sessions={r.resumed_sessions},"
                  f"recovered_done={r.recovered_done},"
                  f"outputs_bit_identical={r.outputs_match}"
                  + (f",detail={r.detail}" if r.detail else ""))

    def _cluster_suite():
        nonlocal failed
        from repro_torch.scenarios.cluster import run_cluster_suite
        points = [p for p in args.kill_points.split(",") if p]
        srcs = [s for s in args.cluster_sources.split(",") if s]
        for r in run_cluster_suite(workdir, points=points, sources=srcs,
                                   world=args.world,
                                   # survivors must reach at least one
                                   # all-reduce AFTER the kill at commit
                                   # step 2C-1 to detect the death
                                   steps=max(args.steps,
                                             2 * args.commit_every + 1),
                                   commit_every=args.commit_every,
                                   device=args.device):
            status = "OK" if r.ok else "FAIL"
            failed += not r.ok
            print(f"cluster_scenario,{r.kill_point},"
                  f"{'peer' if r.replicate else 'pool'},{status},"
                  f"completed={r.completed_steps_at_kill},"
                  f"resumed={r.resumed_from},source={r.recovery_source},"
                  f"expected=({r.expected_resume},{r.expected_source}),"
                  f"digest_match={r.digests == r.reference_digests}"
                  + (f",detail={r.detail}" if r.detail else ""))

    def _fuzz_suite():
        nonlocal failed
        from repro_torch.dsm.emu import PRESETS
        from repro_torch.scenarios.fuzz import run_fuzz_suite
        topos = (sorted(PRESETS) if args.topology == "all"
                 else [args.topology])
        workloads = [w for w in args.fuzz_workloads.split(",") if w]
        s = run_fuzz_suite(os.path.join(workdir, "fuzz"),
                           episodes=args.episodes, seed=args.seed,
                           topologies=topos, workloads=workloads)
        for cell in s.cells:
            status = "OK" if not cell["violations"] else "FAIL"
            print(f"fuzz,{cell['workload']},{cell['topology']},{status},"
                  f"episodes={cell['episodes']},kills={cell['kills']},"
                  f"torn={cell['torn']},recoveries={cell['recoveries']},"
                  f"cold_starts={cell['cold_starts']},"
                  f"violations={cell['violations']}")
        failed += s.violations
        for p in s.reproducers:
            print(f"fuzz_reproducer,{p}")
        print(f"fuzz_summary,episodes={s.episodes},"
              f"violations={s.violations},kills={s.kills_fired},"
              f"torn={s.torn_writes},recoveries={s.recoveries},"
              f"log={s.log_path}")

    suites = {"train": _train_suite, "serve": _serve_suite,
              "cluster": _cluster_suite, "fuzz": _fuzz_suite}
    for name in PORTED_SUITES:
        if args.suite in (name, "all"):
            _suite_guard(name, suites[name])
    print(f"runner,{'FAIL' if failed else 'OK'},failed={failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
