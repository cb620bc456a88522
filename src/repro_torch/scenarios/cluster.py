"""Cluster scenario suite: kill 1 of N REAL rank processes sharing one
pool, inside the commit window, and require the survivors to shrink,
recover and finish bit-identically to a planned (uninterrupted) shrink —
the port of ``repro.scenarios.cluster``.

One scenario (``run_cluster_scenario``):

1. **kill phase** — launch N ``repro_torch.scenarios.cluster_worker``
   processes over one pool; the victim ``os._exit``s at the configured
   commit-window point (pre_flush / mid_flush / post_completeOp).  The
   orchestrator then plays the environment's part in the partial-crash
   model: it wipes the victim's (volatile) staging buffer and posts the
   membership change on the control plane.  The survivors — blocked on the
   victim's all-reduce contribution — run the shrink protocol and finish
   the run with one fewer rank;
2. **inspect** — the cluster manifests durable at the moment of death
   (read before the survivors are released, so the set is exact);
3. **verdict** — the survivors must report the EXPECTED recovery source
   (peer-staging when the sibling's staged copy is newer than the pool's
   newest cluster manifest, pool otherwise), must resume from the expected
   step, and their merged final per-tensor digests must equal a planned
   reference shrink at the same step (``run_cluster_planned``).

``run_cluster_suite`` runs the matrix: every kill point x {replicated
(peer-newer), unreplicated (pool-newer)}; references are shared across
scenarios that recover at the same step.  Every rank runs on ``device``
(``"cuda"`` by default: the ranks of a one-card cluster share it;
``"cpu"`` keeps the state on the host).  Each result keeps what every
rank printed (``children``: role, exit code, wall seconds and its JSON
line, the killed one's included).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.dsm.cluster import ControlPlane, FileStagingArea
from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.dsm.pool import DSMPool
from repro_torch.scenarios.runner import _worker_env
from repro_torch.scenarios.worker import KILL_EXIT


def spawn_worker(pool: str, rank: int, world: int, *, steps: int,
                 commit_every: int, replicate: bool,
                 kill_point: str = "none", kill_step: int = 0,
                 dim: int = 16, tensors: int = 6, global_batch: int = 6,
                 retention: int = 0, topology: str = None,
                 joiner: bool = False, join_at: int = 0,
                 timeout: float = 120.0,
                 device: str = "cuda") -> subprocess.Popen:
    """Start one ``cluster_worker`` rank: the one place its command line
    is put together, shared by the scenario suite, the N-worker launcher
    and the cluster benchmark.  ``joiner=True`` spawns a rank OUTSIDE
    ``world`` that grows the cluster at ``join_at`` (the launcher must
    also post the planned grow change).  The returned process carries its
    start time (``started``) for ``finish``."""
    cmd = [sys.executable, "-m", "repro_torch.scenarios.cluster_worker",
           "--pool", pool, "--rank", str(rank), "--world", str(world),
           "--steps", str(steps), "--commit-every", str(commit_every),
           "--dim", str(dim), "--tensors", str(tensors),
           "--global-batch", str(global_batch),
           "--replicate", str(int(replicate)),
           "--retention", str(retention),
           "--timeout", str(timeout),
           "--kill-point", kill_point, "--kill-step", str(kill_step),
           "--device", device]
    if topology:
        cmd += ["--topology", topology]
    if joiner:
        cmd += ["--joiner", "--join-at", str(join_at)]
    proc = subprocess.Popen(cmd, env=_worker_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    return proc


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def finish(role: str, proc: subprocess.Popen, timeout: float
           ) -> Tuple[dict, str]:
    """Wait for one rank: ``({"role", "rc", "wall_s", "result"}, stderr)``
    (``result`` the JSON of its last stdout line, or None)."""
    out, err = proc.communicate(timeout=timeout)
    try:
        result = _last_json(out)
    except (ValueError, IndexError):
        result = None
    return {"role": role, "rc": proc.returncode,
            "wall_s": time.perf_counter() - proc.started,
            "result": result}, err


def _terminate(procs: Dict[int, subprocess.Popen]):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
    for p in procs.values():
        try:
            p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def merge_digests(results: Sequence[dict]) -> Dict[str, int]:
    """Union of the per-rank final-partition digests; a tensor reported by
    two ranks with different values means the partition was inconsistent
    — surfaced as a failure, never silently picked."""
    merged: Dict[str, int] = {}
    for res in results:
        for t, crc in (res.get("digests") or {}).items():
            if t in merged and merged[t] != crc:
                raise ValueError(f"conflicting digests for {t}")
            merged[t] = crc
    return merged


def run_cluster_planned(pool: str, *, world: int, victim: int,
                        shrink_at: int, steps: int, commit_every: int,
                        replicate: bool = True, dim: int = 16,
                        tensors: int = 6, timeout: float = 300.0,
                        device: str = "cuda",
                        children: Optional[List[dict]] = None
                        ) -> Dict[str, int]:
    """The reference: an uninterrupted run whose rank set shrinks at the
    SAME step as the kill scenario's recovery — posted as a planned
    elastic scale-down before launch.  Returns merged final digests;
    ``children`` (a list) receives each rank's record."""
    ControlPlane(os.path.join(pool, "control")).post(
        victim, planned=True, at_step=shrink_at)
    procs = {r: spawn_worker(pool, r, world, steps=steps,
                             commit_every=commit_every,
                             replicate=replicate, dim=dim,
                             tensors=tensors, timeout=timeout,
                             device=device)
             for r in range(world)}
    results = []
    try:
        for r, p in procs.items():
            child, err = finish(f"planned rank {r}", p, timeout)
            if children is not None:
                children.append(child)
            if child["rc"] != 0 or child["result"] is None:
                raise RuntimeError(
                    f"planned-shrink rank {r} rc={child['rc']}: "
                    f"{err[-2000:]}")
            results.append(child["result"])
    finally:
        _terminate(procs)
    return merge_digests(results)


@dataclasses.dataclass
class ClusterScenarioResult:
    kill_point: str
    replicate: bool
    killed: bool
    completed_steps_at_kill: List[int]   # cluster-manifest steps at death
    resumed_from: Optional[int]
    recovery_source: Optional[str]
    expected_resume: int
    expected_source: str
    digests: Dict[str, int]
    reference_digests: Dict[str, int]
    n_tensors: int
    detail: str = ""
    #: every rank of the kill phase: {"role", "rc", "wall_s", "result"}
    children: List[dict] = dataclasses.field(default_factory=list)

    @property
    def recovered_completed_commit(self) -> bool:
        """Pool recovery must land on the NEWEST completed cluster commit;
        peer-staging legitimately resumes AHEAD of every manifest."""
        if self.resumed_from is None:
            return False
        if self.recovery_source == "peer-staging":
            return self.resumed_from >= max(self.completed_steps_at_kill)
        return self.resumed_from == max(self.completed_steps_at_kill)

    @property
    def ok(self) -> bool:
        return (self.killed
                and self.recovery_source == self.expected_source
                and self.resumed_from == self.expected_resume
                and self.recovered_completed_commit
                and len(self.digests) == self.n_tensors
                and self.digests == self.reference_digests)


def expected_recovery(kill_point: str, replicate: bool, kill_step: int,
                      commit_every: int) -> Tuple[int, str]:
    """Where recovery MUST land for each matrix cell.  A post-completeOp
    kill leaves the manifest of the dying commit durable, so the pool
    already matches the sibling's staged copy and wins the tie; before
    completeOp the staged copy (updated every step) is newer than the
    last manifest iff replication is on."""
    if kill_point == "post_completeOp":
        return kill_step, "pool"
    if replicate:
        return kill_step, "peer-staging"
    return kill_step - commit_every, "pool"


def run_cluster_scenario(kill_point: str, workdir: str, *,
                         replicate: bool = True, world: int = 3,
                         victim: int = 1, steps: int = 10,
                         commit_every: int = 2,
                         kill_step: Optional[int] = None,
                         dim: int = 16, tensors: int = 6,
                         ref_cache: Optional[Dict[int, Dict[str, int]]]
                         = None,
                         timeout: float = 300.0,
                         device: str = "cuda") -> ClusterScenarioResult:
    if kill_point not in KILL_POINTS:
        raise ValueError(f"unknown kill point {kill_point!r}")
    if world < 3:
        raise ValueError("need N >= 3 so the shrunk cluster still has peers")
    if kill_step is None:
        # the second commit: at least one completed cluster commit (plus
        # the initial floor) precedes the kill
        kill_step = 2 * commit_every - 1
    exp_resume, exp_source = expected_recovery(kill_point, replicate,
                                               kill_step, commit_every)
    pool = os.path.join(
        workdir, f"cluster_{kill_point}_{'peer' if replicate else 'pool'}")

    def failed(killed, completed, detail, children, resumed=None,
               source=None):
        return ClusterScenarioResult(
            kill_point, replicate, killed, completed, resumed, source,
            exp_resume, exp_source, {}, {}, tensors, detail=detail,
            children=children)

    # 1. kill phase
    procs = {r: spawn_worker(
        pool, r, world, steps=steps, commit_every=commit_every,
        replicate=replicate, dim=dim, tensors=tensors, timeout=timeout,
        kill_point=kill_point if r == victim else "none",
        kill_step=kill_step, device=device) for r in range(world)}
    children: List[dict] = []
    try:
        child, err = finish(f"victim rank {victim}", procs[victim], timeout)
    except subprocess.TimeoutExpired:
        _terminate(procs)
        return failed(False, [], "victim never died", children)
    children.append(child)
    if child["rc"] != KILL_EXIT:
        _terminate(procs)
        return failed(False, [], f"victim rc={child['rc']}: "
                                 f"{err[-1500:]}", children)

    # 2. cluster commits durable at the moment of death (survivors are
    #    still blocked on the victim's all-reduce slot, so this set is
    #    exact), then the environment side of the crash: the victim's
    #    volatile staging buffer vanishes and the membership change goes
    #    out on the control plane
    completed = sorted({m["step"]
                        for m in DSMPool(pool).manifests_desc()})
    FileStagingArea(os.path.join(pool, "staging")).wipe(victim)
    ControlPlane(os.path.join(pool, "control")).post(victim)

    # 3. survivors shrink + finish
    results = []
    try:
        for r, p in procs.items():
            if r == victim:
                continue
            child, err = finish(f"survivor rank {r}", p, timeout)
            children.append(child)
            if child["rc"] != 0 or child["result"] is None:
                _terminate(procs)
                return failed(True, completed,
                              f"survivor {r} rc={child['rc']}: "
                              f"{err[-1500:]}", children)
            results.append(child["result"])
    finally:
        _terminate(procs)

    resumed = {res["resumed_from"] for res in results}
    sources = {res["source"] for res in results}
    if len(resumed) != 1 or len(sources) != 1:
        return failed(True, completed,
                      f"survivors disagree: resumed={resumed} "
                      f"sources={sources}", children)
    resumed_from, source = resumed.pop(), sources.pop()
    try:
        digests = merge_digests(results)
    except ValueError as e:
        return failed(True, completed, str(e), children, resumed_from,
                      source)

    # 4. reference: a planned shrink at the recovered step + 1 (cached —
    #    every scenario recovering at the same step shares one reference)
    ref_cache = ref_cache if ref_cache is not None else {}
    if resumed_from not in ref_cache:
        ref_pool = os.path.join(workdir, f"cluster_ref_{resumed_from}")
        ref_cache[resumed_from] = run_cluster_planned(
            ref_pool, world=world, victim=victim,
            shrink_at=resumed_from + 1, steps=steps,
            commit_every=commit_every, dim=dim, tensors=tensors,
            timeout=timeout, device=device)
    return ClusterScenarioResult(
        kill_point, replicate, True, completed, resumed_from, source,
        exp_resume, exp_source, digests, ref_cache[resumed_from], tensors,
        children=children)


def run_cluster_suite(workdir: Optional[str] = None,
                      points: Sequence[str] = KILL_POINTS,
                      sources: Sequence[str] = ("peer", "pool"),
                      **kwargs) -> List[ClusterScenarioResult]:
    """The full matrix: every kill point x {peer-newer, pool-newer}
    recovery source (``sources`` trims the matrix for smoke jobs)."""
    workdir = workdir or tempfile.mkdtemp(prefix="scenarios_cluster_")
    ref_cache: Dict[int, Dict[str, int]] = {}
    out = []
    for point in points:
        for src in sources:
            out.append(run_cluster_scenario(
                point, workdir, replicate=(src == "peer"),
                ref_cache=ref_cache, **kwargs))
    return out
