"""The port's adversarial crash fuzzer (``repro_torch.scenarios.fuzz``)
against the JAX package's ``repro.scenarios.fuzz``.

* ``make_episode`` draws equal configs and schedules in both packages, and
  ``run_episode`` gives an equal ``EpisodeResult.to_json()`` (kills,
  recoveries with their sources and steps, cold starts, torn writes,
  violations) for every workload — train, serve, cluster and scale —
  over several seeds and all three topologies;
* the suite at the bench's size (3 episodes x train / serve / cluster x 3
  topologies, seed 0) reproduces ``benchmarks/baselines/fuzz.json``'s six
  counts exactly, cell for cell the reference's;
* the reference's own fuzzer properties on the port (``tests/
  test_fuzz.py``): determinism, clean episodes, a mid-commit kill, torn
  writes never recovered from, the ``REPRO_FUZZ_BREAK_RECOVERY`` canary
  caught and shrunk to a reproducer that replays, the suite's counting,
  and the runner's exit codes;
* across packages: a reproducer dumped by either package replays in the
  other to the same violations, and a torn pool left by one package's
  episode is recovered by the other's ``RecoveryManager`` at the step
  the episode's oracle named, bit-identical to the clean replay;
* ``--mesh`` (here on ``--suite cluster``) refuses with the reference
  module and ROADMAP item named (the cluster and scale suites themselves
  run: ``tests/test_torch_cluster_worker.py``,
  ``tests/test_torch_scale_cells.py``).
"""
import json
import os
import subprocess
import sys

import pytest

from repro.dsm.recovery import RecoveryManager as RefRecovery
from repro.dsm.pool import DSMPool as RefPool
from repro.scenarios import fuzz as ref_fuzz
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.recovery import RecoveryManager
from repro_torch.scenarios import fuzz
from repro_torch.scenarios.fuzz import (BREAK_ENV, EpisodeConfig,
                                        dump_reproducer, make_episode,
                                        replay_reproducer, run_episode,
                                        run_fuzz_suite)
from repro_torch.dsm.faults import FaultSchedule, KillSpec, TornSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUZZ_JSON = os.path.join(REPO, "benchmarks", "baselines", "fuzz.json")
SUMMARY_KEYS = {"fuzz_episodes": "episodes",
                "fuzz_invariant_violations": "violations",
                "fuzz_kills_fired": "kills_fired",
                "fuzz_torn_writes": "torn_writes",
                "fuzz_recoveries": "recoveries",
                "fuzz_cold_starts": "cold_starts"}


def _ref_pair(cfg, sched):
    return (ref_fuzz.EpisodeConfig.from_dict(cfg.to_dict()),
            ref_fuzz.FaultSchedule.from_dict(sched.to_dict()))


# ---------------------------------------------------------------------------
# the same episodes as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", fuzz.WORKLOADS)
def test_make_episode_equals_the_references(workload):
    assert fuzz.WORKLOADS == ref_fuzz.WORKLOADS
    assert fuzz.TOPOLOGIES == ref_fuzz.TOPOLOGIES
    for ep in range(12):
        for ti, topo in enumerate(fuzz.TOPOLOGIES):
            path = [3, ep, fuzz.WORKLOADS.index(workload), ti]
            cfg, sched = make_episode(path, workload, topo)
            rcfg, rsched = ref_fuzz.make_episode(path, workload, topo)
            assert cfg.to_dict() == rcfg.to_dict()
            assert sched.to_dict() == rsched.to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("workload", fuzz.WORKLOADS)
def test_episode_results_equal_the_references(tmp_path, workload, seed):
    wi = fuzz.WORKLOADS.index(workload)
    for ti, topo in enumerate(fuzz.TOPOLOGIES):
        path = [seed, 5, wi, ti]
        cfg, sched = make_episode(path, workload, topo)
        ours = run_episode(cfg, sched, str(tmp_path / f"p{ti}"))
        ref = ref_fuzz.run_episode(*_ref_pair(cfg, sched),
                                   str(tmp_path / f"r{ti}"))
        assert ours.ok, ours.violations
        assert ours.to_json() == ref.to_json()


def test_suite_reproduces_fuzz_json_cell_for_cell(tmp_path):
    kw = dict(episodes=3, seed=0, shrink=False,
              workloads=("train", "serve", "cluster"))
    ours = run_fuzz_suite(str(tmp_path / "port"), **kw)
    ref = ref_fuzz.run_fuzz_suite(str(tmp_path / "ref"), **kw)
    with open(FUZZ_JSON) as f:
        gated = json.load(f)["metrics"]
    for metric, field in SUMMARY_KEYS.items():
        assert getattr(ours, field) == gated[metric]["value"], metric
    assert (ours.episodes, ours.violations, ours.kills_fired,
            ours.torn_writes, ours.recoveries, ours.cold_starts) == \
        (27, 0, 19, 55, 40, 6)
    assert ours.cells == ref.cells
    with open(ours.log_path) as f, open(ref.log_path) as g:
        assert [json.loads(l) for l in f] == [json.loads(l) for l in g]


# ---------------------------------------------------------------------------
# the reference's fuzzer properties, on the port
# ---------------------------------------------------------------------------

def test_make_episode_is_pure_in_the_seed_path():
    a = make_episode([7, 3, 0, 1], "train", "cxl20-switched-pool")
    b = make_episode([7, 3, 0, 1], "train", "cxl20-switched-pool")
    assert a == b
    drawn = {make_episode([7, ep, 0, 1], "train", "cxl20-switched-pool")[1]
             for ep in range(8)}
    assert len(drawn) > 1, "8 episode draws produced one schedule"


@pytest.mark.parametrize("workload", ["train", "serve", "cluster", "scale"])
def test_episode_replay_is_bit_deterministic(workload, tmp_path):
    cfg, sched = make_episode([0, 1, 0, 0], workload, "cxl11-direct")
    r1 = run_episode(cfg, sched, str(tmp_path / "a"))
    r2 = run_episode(cfg, sched, str(tmp_path / "b"))
    assert r1.to_json() == r2.to_json()


@pytest.mark.parametrize("workload", ["train", "serve", "cluster", "scale"])
def test_clean_episode_has_no_violations(workload, tmp_path):
    cfg = EpisodeConfig(workload=workload, grow_at=3)
    res = run_episode(cfg, FaultSchedule(), str(tmp_path))
    assert res.ok, res.violations
    assert res.kills_fired == [] and res.torn_writes == 0
    # the forced final crash still exercises one recovery per episode
    assert res.recoveries


def test_kill_mid_commit_recovers_to_completed_commit(tmp_path):
    cfg = EpisodeConfig(workload="train", mode="sharded-async")
    sched = FaultSchedule(kills=(
        KillSpec(worker=0, op="rflush", index=5, phase="before"),))
    res = run_episode(cfg, sched, str(tmp_path))
    assert res.ok, res.violations
    assert len(res.kills_fired) == 1
    assert res.kills_fired[0]["op"] == "rflush"


def test_torn_writes_never_recovered_from(tmp_path):
    cfg = EpisodeConfig(workload="train")
    sched = FaultSchedule(
        kills=(KillSpec(worker=0, op="completeOp", index=2, phase="after"),),
        torn=TornSpec(rate=0.4, salt=11))
    res = run_episode(cfg, sched, str(tmp_path))
    assert res.ok, res.violations
    assert res.torn_writes > 0


def test_broken_recovery_is_caught_and_reproducer_replays(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv(BREAK_ENV, "1")
    cfg, sched = make_episode([0, 0, 0, 0], "train", "cxl11-direct")
    res = run_episode(cfg, sched, str(tmp_path / "run"))
    assert not res.ok, "stale-state swap at the seam went unnoticed"
    path = dump_reproducer(str(tmp_path), [0, 0, 0, 0], cfg, sched, res,
                           shrink=True)
    with open(path) as f:
        doc = json.load(f)
    assert doc["kind"] == "cxl0-fuzz-reproducer" and doc["violations"]
    replay = replay_reproducer(path)
    assert replay.violations == res.violations


def test_suite_counts_violations_and_dumps_reproducers(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv(BREAK_ENV, "1")
    s = run_fuzz_suite(str(tmp_path), episodes=1, seed=0,
                       topologies=["cxl11-direct"], workloads=["train"],
                       shrink=False)
    assert s.episodes == 1 and s.violations >= 1
    assert len(s.reproducers) == 1 and os.path.exists(s.reproducers[0])
    assert os.path.exists(s.log_path)
    with open(s.log_path) as f:
        logged = [json.loads(l) for l in f]
    assert len(logged) == 1 and logged[0]["violations"]


def test_shrinking_keeps_the_violation_and_matches_the_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv(BREAK_ENV, "1")
    cfg, sched = make_episode([0, 0, 0, 0], "train", "cxl11-direct")
    ours = fuzz.shrink_schedule(cfg, sched)
    ref = ref_fuzz.shrink_schedule(*_ref_pair(cfg, sched))
    assert ours.to_dict() == ref.to_dict()
    assert run_episode(cfg, ours, str(tmp_path)).violations


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "ref"])
def test_reproducer_replays_in_the_other_package(tmp_path, monkeypatch,
                                                 writer):
    monkeypatch.setenv(BREAK_ENV, "1")
    cfg, sched = make_episode([0, 2, 0, 1], "train", "cxl20-switched-pool")
    if writer == "port":
        res = run_episode(cfg, sched, str(tmp_path / "run"))
        path = dump_reproducer(str(tmp_path), [0, 2, 0, 1], cfg, sched,
                               res, shrink=False)
        replay = ref_fuzz.replay_reproducer(path)
    else:
        rcfg, rsched = _ref_pair(cfg, sched)
        res = ref_fuzz.run_episode(rcfg, rsched, str(tmp_path / "run"))
        path = ref_fuzz.dump_reproducer(str(tmp_path), [0, 2, 0, 1], rcfg,
                                        rsched, res, shrink=False)
        replay = replay_reproducer(path)
    assert res.violations
    assert replay.violations == res.violations
    assert replay.to_json() == res.to_json()


@pytest.mark.parametrize("mode", ["sync", "sharded-async"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_torn_pool_recovered_by_the_other_package(tmp_path, writer, mode):
    cfg = EpisodeConfig(workload="train", mode=mode)
    sched = FaultSchedule(
        kills=(KillSpec(worker=0, op="completeOp", index=2, phase="after"),),
        torn=TornSpec(rate=0.25, salt=4))
    work = str(tmp_path / writer)
    if writer == "port":
        res = run_episode(cfg, sched, work)
        recovery = RefRecovery(RefPool(os.path.join(work, "pool")))
        templates = ref_fuzz._train_templates(cfg)
    else:
        res = ref_fuzz.run_episode(*_ref_pair(cfg, sched), work)
        recovery = RecoveryManager(DSMPool(os.path.join(work, "pool")))
        templates = fuzz._train_templates(cfg)
    assert res.ok and res.torn_writes > 0, res.violations
    final = res.recoveries[-1]
    # the newest commits are torn: the final recovery falls back to step 8
    assert final["final"] and final["step"] == final["expected"] == 8
    objs, step, source = recovery.recover(templates, (), exact=True)
    assert (step, source) == (final["expected"], "pool")
    digests = fuzz._train_clean_digests(cfg)
    assert fuzz._named_crc(objs, fuzz._train_names(cfg)) == digests[step]


# ---------------------------------------------------------------------------
# the runner's exit codes (subprocess: the real contract)
# ---------------------------------------------------------------------------

def _run_runner(workdir, extra_env=None):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           **(extra_env or {})}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios.runner", "--suite",
         "fuzz", "--episodes", "1", "--seed", "0", "--topology",
         "cxl11-direct", "--fuzz-workloads", "train", "--device", "cpu",
         "--workdir", str(workdir)],
        capture_output=True, text=True, env=env, timeout=300)


def test_runner_fuzz_suite_green_exits_zero(tmp_path):
    p = _run_runner(tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "runner,OK,failed=0" in p.stdout


def test_runner_propagates_fuzz_violation_as_nonzero_exit(tmp_path):
    p = _run_runner(tmp_path, {BREAK_ENV: "1"})
    assert p.returncode != 0, p.stdout + p.stderr
    assert "runner,FAIL" in p.stdout and "fuzz_reproducer," in p.stdout
    repros = [f for f in os.listdir(tmp_path / "fuzz")
              if f.startswith("repro_") and f.endswith(".json")]
    assert repros, "violated run left no reproducer JSON"


@pytest.mark.parametrize("argv,names", [
    (["--suite", "cluster", "--mesh", "2x4"], ("repro.launch.mesh", "A7"))])
def test_runner_refuses_the_suites_not_ported(argv, names):
    from repro_torch.scenarios.runner import main
    with pytest.raises(NotImplementedError) as ei:
        main(argv + ["--device", "cpu"])
    for n in names:
        assert n in str(ei.value)
