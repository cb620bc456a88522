"""The durable training loop of the port (``repro_torch.train.loop``), on
the olmo-1b smoke config on the CPU: twins of the reference's loop tests
(``tests/test_dsm.py``, ``tests/test_sharded_commit.py``), the C3 repairs
of ``open_cxl0`` and pools that cross packages.

* an uninterrupted run and a crashy one end bit for bit equal (params, mu,
  nu, the pipeline position); a committed step survives a crash right
  after its commit; a torn write (objects flushed, no manifest) is
  invisible; a peer's newer staged copy wins over the pool; each of the
  four schedules leaves the same durable history; ``resume`` skips the
  initial commit; retention bounds the manifests and the object versions;
* ``fault_hook`` fires at ``pre_flush``, ``mid_flush`` and
  ``post_completeOp``, in the reference's order under every schedule, and
  a crash at the first two leaves no manifest while one after the third
  keeps the commit;
* ``open_cxl0(path, peers=())`` opens a context with no peers and
  ``open_cxl0(path, 1)`` names worker 1's flush threads;
* the reference writes a 6-step pool that the port resumes to step 10,
  and the port one that the reference resumes: the manifests' object names
  and every frame's dtypes and shapes are equal exactly, and the final
  states agree with a 10-step run of the other package within 1e-5 x
  max|ref| per leaf (fp32 smoke config);
* the launcher (``python -m repro_torch.launch.train --device cpu --smoke``)
  trains and commits, and a rerun with ``--resume`` has nothing to do.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.data.pipeline import SyntheticLMSource as RefSource
from repro.dsm.flit_runtime import DurableCommitter as RefCommitter
from repro.dsm.pool import DSMPool as RefPool
from repro.dsm.tiers import TierManager as RefTiers
from repro.models.registry import build as ref_build
from repro.train.loop import run_durable_loop as ref_run_durable_loop
from repro.train.state import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
from repro_torch.dsm import stream
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.flit_runtime import COMMIT_MODES, DurableCommitter
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.recovery import CrashError, RecoveryManager
from repro_torch.dsm.tiers import TierManager
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.train.loop import _state_objects, run_durable_loop
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("olmo-1b")
    bundle = build(cfg, device="cpu")
    state = init_train_state(bundle.init_params(seed=0), 0)
    return cfg, state, make_train_step(bundle)


def _pipeline(cfg, gb=2, seq=32):
    return DataPipeline(SyntheticLMSource(cfg.vocab_size), gb, seq)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _states_equal(r1, r2) -> bool:
    return (_equal(r1.state.params, r2.state.params)
            and _equal(r1.state.opt.mu, r2.state.opt.mu)
            and _equal(r1.state.opt.nu, r2.state.opt.nu)
            and int(r1.state.opt.step) == int(r2.state.opt.step)
            and r1.pipeline_state == r2.pipeline_state)


def test_uninterrupted_vs_crashy_run_identical(setup, tmp_path):
    cfg, state, step = setup
    r_clean = run_durable_loop(step, state, _pipeline(cfg),
                               DSMPool(str(tmp_path / "clean")), n_steps=8,
                               commit_every=2)
    r_crashy = run_durable_loop(
        step, state, _pipeline(cfg), DSMPool(str(tmp_path / "crashy")),
        n_steps=8, commit_every=2,
        crash_at={3: "before_commit", 6: "before_commit"})
    assert r_crashy.crashes == 2
    assert r_crashy.recoveries == ["pool", "pool"]
    assert _states_equal(r_clean, r_crashy)
    assert r_clean.pipeline_state.step == 8


def test_committed_step_survives(setup, tmp_path):
    cfg, state, step = setup
    r = run_durable_loop(step, state, _pipeline(cfg),
                         DSMPool(str(tmp_path / "p")), n_steps=6,
                         commit_every=2, commit_mode="sync",
                         crash_at={3: "after_commit"})
    assert r.crashes == 1 and r.recoveries == ["pool"]
    assert len(r.losses) == 6           # step 3 committed: no replay


def test_torn_write_invisible(setup, tmp_path):
    cfg, state, step = setup
    pool = DSMPool(str(tmp_path / "p"))
    r = run_durable_loop(step, state, _pipeline(cfg), pool, n_steps=6,
                         commit_every=3, commit_mode="sync",
                         crash_at={2: "mid_write"})
    assert r.crashes == 1 and r.recoveries == ["pool"]
    assert len(r.losses) == 6 + 3       # steps 0-2 replayed from step -1
    templates = _state_objects(state, _pipeline(cfg).state)
    for m in pool.manifests_desc():     # every manifest reads whole
        for name in templates:
            pool.read_entry(name, m["objects"][name], templates[name])
    r_clean = run_durable_loop(step, state, _pipeline(cfg),
                               DSMPool(str(tmp_path / "clean")), n_steps=6,
                               commit_every=3, commit_mode="sync")
    assert _states_equal(r, r_clean)


def test_peer_staging_recovers_newer_state(setup, tmp_path):
    cfg, state, step = setup
    peer = TierManager(DSMPool(str(tmp_path / "peer_pool")), worker_id=1)
    r = run_durable_loop(step, state, _pipeline(cfg),
                         DSMPool(str(tmp_path / "p")), n_steps=8,
                         commit_every=4, peer_tiers=peer, replicate=True,
                         crash_at={6: "before_commit"})
    assert r.crashes == 1 and r.recoveries == ["peer-staging"]
    assert len(r.losses) == 8           # resumed at 7: nothing replayed
    r_clean = run_durable_loop(step, state, _pipeline(cfg),
                               DSMPool(str(tmp_path / "clean")), n_steps=8,
                               commit_every=4)
    assert _states_equal(r, r_clean)


def test_mixed_tag_staging_is_not_adopted(setup, tmp_path):
    cfg, state, _ = setup
    templates = _state_objects(state, _pipeline(cfg).state)
    ctx = open_cxl0(str(tmp_path / "p"))
    ctx.put(templates, step=-1)
    with ctx.commit(-1):
        pass
    peer = TierManager(DSMPool(str(tmp_path / "peer")), worker_id=1)
    peer.staging.update({n: (5, t) for n, t in templates.items()})
    peer.staging["pipeline"] = (4, templates["pipeline"])
    assert ctx.recover(templates, [peer])[1:] == (-1, "pool")
    peer.staging["pipeline"] = (5, templates["pipeline"])
    assert ctx.recover(templates, [peer])[1:] == (5, "peer-staging")
    ctx.close()


@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_each_schedule_gives_the_same_durable_history(setup, mode, tmp_path):
    cfg, state, step = setup
    pool = DSMPool(str(tmp_path / mode))
    r = run_durable_loop(step, state, _pipeline(cfg), pool, n_steps=8,
                         commit_every=2, commit_mode=mode, n_shards=4)
    assert pool.latest_manifest()["step"] == 7     # drain flushed the tail
    r_ref = run_durable_loop(step, state, _pipeline(cfg),
                             DSMPool(str(tmp_path / f"{mode}_ref")),
                             n_steps=8, commit_every=2, commit_mode="sync")
    assert _states_equal(r, r_ref)
    got = RecoveryManager(pool).recover(
        _state_objects(state, _pipeline(cfg).state))
    assert got[1:] == (7, "pool")


def test_resume_skips_the_initial_commit(setup, tmp_path):
    cfg, state, step = setup
    pool = DSMPool(str(tmp_path / "p"))
    run_durable_loop(step, state, _pipeline(cfg), pool, n_steps=4,
                     commit_every=2, n_shards=2)
    seqs = [m["seq"] for m in pool.manifests_desc()]
    r = run_durable_loop(step, state, _pipeline(cfg), pool, n_steps=8,
                         commit_every=2, n_shards=2, resume=True)
    assert r.resumed_from == 3 and r.recoveries == ["pool"]
    assert len(r.losses) == 4
    # no step -1 manifest after the resume: the new seqs are steps 5, 7
    steps = {m["seq"]: m["step"] for m in pool.manifests_desc()}
    assert sorted(steps[s] for s in steps if s not in seqs) == [5, 7]
    r_ref = run_durable_loop(step, state, _pipeline(cfg),
                             DSMPool(str(tmp_path / "ref")), n_steps=8,
                             commit_every=2)
    assert _states_equal(r, r_ref)
    # a cold pool falls through to the fresh start
    r_cold = run_durable_loop(step, state, _pipeline(cfg),
                              DSMPool(str(tmp_path / "cold")), n_steps=2,
                              commit_every=2, resume=True)
    assert r_cold.resumed_from is None and len(r_cold.losses) == 2


def test_retention_bounds_manifests_and_versions(setup, tmp_path):
    cfg, state, step = setup
    pool = DSMPool(str(tmp_path / "p"))
    run_durable_loop(step, state, _pipeline(cfg), pool, n_steps=12,
                     commit_every=2, n_shards=4, retention=3)
    ms = pool.manifests_desc()
    assert len(ms) == 3
    got = RecoveryManager(pool).recover(
        _state_objects(state, _pipeline(cfg).state))
    assert got[1] == 11
    live = set()
    for m in ms:
        for n, o in m["objects"].items():
            if o.get("sharded"):
                live.update((s["name"], s["version"]) for s in o["shards"])
            else:
                live.add((n, o["version"]))
    for name in os.listdir(pool.obj_dir):
        for fn in os.listdir(os.path.join(pool.obj_dir, name)):
            stem = fn.split(".")[0]
            if stem.isdigit():
                assert (name, int(stem)) in live


# -- the commit window's fault hook -----------------------------------------

def _hook_log(committer_cls, tiers, mode, arrays):
    log = []
    c = committer_cls(tiers, mode=mode, n_shards=2,
                      fault_hook=lambda p, s: log.append((p, s)))
    for s in (0, 1, 2):
        c.update({"a": {"x": arrays[0]}, "b": {"y": arrays[1]}}, step=s)
        c.commit(s)
    c.drain()
    return log


@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_fault_hook_points_follow_the_reference(mode, tmp_path):
    g = np.random.default_rng(0)
    arrays = [g.standard_normal(64).astype(np.float32) for _ in range(2)]
    ours = _hook_log(DurableCommitter,
                     TierManager(DSMPool(str(tmp_path / "p"))), mode,
                     [torch.from_numpy(a) for a in arrays])
    theirs = _hook_log(RefCommitter,
                       RefTiers(RefPool(str(tmp_path / "r")), 0), mode,
                       arrays)
    assert ours == theirs
    assert {p for p, _ in ours} == {"pre_flush", "mid_flush",
                                    "post_completeOp"}


@pytest.mark.parametrize("mode", ["sync", "sharded"])
@pytest.mark.parametrize("point", ["pre_flush", "mid_flush",
                                   "post_completeOp"])
def test_a_crash_at_a_hook_point_keeps_the_contract(point, mode, tmp_path):
    pool = DSMPool(str(tmp_path / "p"))

    def hook(p, step):
        if p == point:
            raise CrashError(f"injected at {p}")

    c = DurableCommitter(TierManager(pool), mode=mode, n_shards=2,
                         fault_hook=hook)
    c.update({"obj": {"a": torch.arange(8.0), "b": torch.ones(3)}})
    with pytest.raises(CrashError):
        c.commit(0)
    if point == "post_completeOp":      # the completeOp happened: durable
        assert pool.latest_manifest()["step"] == 0
    else:                               # the torn write is invisible
        assert pool.latest_manifest() is None


def test_open_cxl0_takes_the_reference_calls(tmp_path):
    ctx = open_cxl0(str(tmp_path / "a"), peers=())
    assert ctx.peers == () and ctx.worker_id == 0
    ctx.close()
    ctx = open_cxl0(str(tmp_path / "b"), 1, schedule="sharded", n_shards=2)
    assert ctx.worker_id == 1 and ctx.tiers.worker_id == 1
    names = []
    ctx.tiers.lstore("x", {"a": torch.ones(4), "b": torch.zeros(4)})
    real = ctx.pool.start_write

    def spy(*a, **kw):
        names.append(threading.current_thread().name)
        return real(*a, **kw)

    ctx.pool.start_write = spy
    ctx.tiers.rflush_sharded("x", 2)
    assert names and all(n.startswith("rflush-w1") for n in names)
    ctx.close()
    points = []
    ctx = open_cxl0(str(tmp_path / "c"), 2,
                    fault_hook=lambda p, s: points.append((p, s)))
    ctx.put({"x": [torch.ones(2)]}, step=4)
    with ctx.commit(4):
        pass
    assert points == [("pre_flush", 4), ("mid_flush", 4),
                      ("post_completeOp", 4)]
    ctx.close()


# -- pools that cross packages ----------------------------------------------

@pytest.fixture(scope="module")
def both():
    rb = ref_build(ref_smoke_config("olmo-1b").with_(**FP32))
    key = jax.random.PRNGKey(0)
    r_state = ref_init_train_state(rb.init_params(key), key)
    b = build(get_smoke_config("olmo-1b").with_(**FP32), device="cpu")
    state = init_train_state(from_reference(
        jax.tree_util.tree_map(np.asarray, r_state.params), "cpu"), 0)
    return (jax.jit(ref_make_train_step(rb)), r_state,
            make_train_step(b), state)


def _frames(pool_dir):
    """Per object of the newest manifest: the dtypes and shapes of its
    frames, in leaf order."""
    pool = DSMPool(pool_dir)
    m = pool.latest_manifest()
    out = {}
    for name, e in m["objects"].items():
        parts = e["shards"] if e.get("sharded") else [e]
        heads = [stream.read_header(pool.payload_path(
            p.get("name", name), p["version"]))[0] for p in parts]
        out[name] = [(tuple(h["dtypes"]), tuple(map(tuple, h["shapes"])))
                     for h in heads]
    return out


def _close_to_ref(ours, theirs, tol=1e-5):
    for x, y in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        y = np.asarray(y, np.float32)
        assert float(np.abs(x.float().numpy() - y).max()) <= \
            tol * max(float(np.abs(y).max()), 1e-30)


def _ref_pipe():
    return RefDataPipeline(RefSource(256), 2, 32)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_pool_crosses_packages_both_ways(both, writer, tmp_path):
    r_step, r_state, step, state = both
    path = str(tmp_path / "pool")
    kw = dict(commit_every=2, commit_mode="sync")
    if writer == "reference":
        ref_run_durable_loop(r_step, r_state, _ref_pipe(), RefPool(path),
                             n_steps=6, **kw)
        frames_w = _frames(path)
        r = run_durable_loop(step, state, DataPipeline(SyntheticLMSource(256),
                                                       2, 32),
                             DSMPool(path), n_steps=10, resume=True, **kw)
        assert r.resumed_from == 5 and len(r.losses) == 4
        want = ref_run_durable_loop(r_step, r_state, _ref_pipe(),
                                    RefPool(str(tmp_path / "w")),
                                    n_steps=10, **kw)
        _close_to_ref(r.state.params, want.state.params)
        _close_to_ref(r.state.opt.mu, want.state.opt.mu)
        _close_to_ref(r.state.opt.nu, want.state.opt.nu)
        assert r.pipeline_state.step == want.pipeline_state.step == 10
    else:
        run_durable_loop(step, state, DataPipeline(SyntheticLMSource(256),
                                                   2, 32),
                         DSMPool(path), n_steps=6, **kw)
        frames_w = _frames(path)
        r = ref_run_durable_loop(r_step, r_state, _ref_pipe(), RefPool(path),
                                 n_steps=10, resume=True, **kw)
        assert r.resumed_from == 5 and len(r.losses) == 4
        want = run_durable_loop(step, state,
                                DataPipeline(SyntheticLMSource(256), 2, 32),
                                DSMPool(str(tmp_path / "w")), n_steps=10,
                                **kw)
        _close_to_ref(want.state.params, r.state.params)
        _close_to_ref(want.state.opt.mu, r.state.opt.mu)
        _close_to_ref(want.state.opt.nu, r.state.opt.nu)
        assert int(r.state.opt.step) == int(want.state.opt.step) == 10
    # the other package's commits have the writer's names, dtypes, shapes
    assert _frames(path) == frames_w
    assert sorted(frames_w) == ["counters", "opt_mu", "opt_nu", "params",
                                "pipeline"]
    assert frames_w["counters"] == [(("int32", "uint32"), ((), (2,)))]
    assert frames_w["pipeline"] == [(("int64", "int64"), ((), ()))]
    # the other package's 6-step history is what each reference pool holds
    other = str(tmp_path / "other")
    if writer == "reference":
        run_durable_loop(step, state, DataPipeline(SyntheticLMSource(256),
                                                   2, 32),
                         DSMPool(other), n_steps=6, **kw)
    else:
        ref_run_durable_loop(r_step, r_state, _ref_pipe(), RefPool(other),
                             n_steps=6, **kw)
    assert _frames(other) == frames_w


def test_launcher_trains_then_has_nothing_to_do(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--steps", "4", "--global-batch", "2", "--seq",
           "32", "--pool", str(tmp_path / "pool"), "--commit-every", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: 4 steps" in out.stdout and "commits in pool: 4" in \
        out.stdout
    out = subprocess.run(cmd + ["--resume"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == [
        "resumed from step 3 (source: pool)",
        "done: nothing to do; commits in pool up to step 3"]
