"""The port's fleet (``repro_torch.serve.fleet``) against the JAX package's
``repro.serve.fleet``: N engines over one pool, cost-routed admission and
the four-phase live migration, on the olmo-1b smoke config in fp32 with the
reference's weights carried over (``models.params.from_reference``) and
the reference's prefix key.

* ``tests/test_fleet.py``'s four tests on the port, with every token
  stream held to the reference's single engine exactly (token ids, no
  tolerance);
* the admission decisions (engine and modelled costs, exactly) and the
  ``migration_log`` equal the reference fleet's on the same trace — with
  rebalancing off, with one forced migration, and with rebalancing on;
* the kill matrix: the fleet killed right after each of the four
  migration points, the target's staging buffer kept or wiped, then a
  fresh fleet resumes from the pool: the reference's streams and exactly
  one owner per session (one parametrised test, 8 cases);
* under the ``async`` and ``sharded-async`` schedules a forced migration
  logs what the reference logs, and a kill at ``mig_commit`` resumes to
  the reference's streams;
* ``remove_engine`` drains an engine by live migration, losing no token;
* pool crossover: a reference fleet killed at ``mig_commit`` is resumed
  by the port's fleet, and the other way round, with the reference's
  tokens — from the staging arm and from the pool arm;
* a fleet asked for another device than its bundle's refuses, and so
  does one asked for no engine or to remove its last.
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.registry import build as ref_build
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.fleet import FleetController as RefFleet
from repro.serve.trace import synthetic_trace as ref_trace
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.fleet import FleetController, MIGRATION_POINTS
from repro_torch.serve.trace import synthetic_trace, trace_t_max

ARCH = "olmo-1b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
T_KW = dict(prompt_lens=(8,), new_tokens=(4, 8, 12), seed=5)
N_REQS = 6
REF_KEY = "olmo-1b|smoke|s0"         # the reference's key for its weights


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH).with_(**FP32)
    trace = synthetic_trace(N_REQS, vocab_size=cfg.vocab_size, **T_KW)
    assert [(r.rid, r.prompt, r.max_new_tokens) for r in trace] == \
        [(r.rid, r.prompt, r.max_new_tokens) for r in ref_trace(
            N_REQS, vocab_size=cfg.vocab_size, **T_KW)]
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config(ARCH).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, dec_pos_len=t_max, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return dict(trace=trace, t_max=t_max, rb=rb, rp=rp, b=b, p=p)


@pytest.fixture(scope="module")
def reference_outputs(smoke):
    """The reference's single engine, no store: the fleets' oracle."""
    return RefEngine(smoke["rb"], smoke["rp"], n_slots=2,
                     t_max=smoke["t_max"]).run(smoke["trace"]).outputs


def _fleet(smoke, pool, **kw):
    return FleetController(ARCH, pool_path=str(pool), n_engines=2,
                           n_slots=2, t_max=smoke["t_max"], commit_every=2,
                           bundle=smoke["b"], params=smoke["p"],
                           prefix_key=REF_KEY, device="cpu", **kw)


def _ref_fleet(smoke, pool, **kw):
    return RefFleet(ARCH, pool_path=str(pool), n_engines=2, n_slots=2,
                    t_max=smoke["t_max"], commit_every=2,
                    bundle=smoke["rb"], params=smoke["rp"], **kw)


def _force_migration(fl, trace, at_tick=3):
    """The reference tests' forced handoff: engine 1's first running
    session moves to engine 2 once engine 1 has ticked ``at_tick`` times."""
    fl.submit(trace)
    moved = None
    while not fl.done:
        fl.tick(rebalance=False)
        if moved is None and fl.engines[1]._tick >= at_tick:
            src = fl.engines[1]
            moved = next((r for r in src.sched.admission_order
                          if r in src.sched.running), None)
            if moved is not None:
                fl.migrate(moved, 1, 2)
    return fl.finish(), moved


def _decisions(fl):
    return [(d.kind, d.name, d.nbytes, d.choice, d.costs, d.topology)
            for d in fl.policy.decisions]


class _Kill(Exception):
    pass


def _kill_at(point):
    def mig_hook(p, rid=None, src=None, dst=None):
        if p == point:
            raise _Kill()
    return mig_hook


def _run_until_killed(fl, trace):
    """The reference's kill cell: tick, and migrate engine 1's first
    running session to engine 2 from engine 1's tick 3 on, until the hook
    kills the fleet."""
    fl.submit(trace)
    with pytest.raises(_Kill):
        while not fl.done:
            fl.tick(rebalance=False)
            if fl.engines[1]._tick >= 3:
                rid = next(r for r in fl.engines[1].sched.admission_order
                           if r in fl.engines[1].sched.running)
                fl.migrate(rid, 1, 2)


def _one_owner(res, trace):
    served = [rid for r in res.per_engine.values() for rid in r.outputs]
    return len(served) == len(set(served)) == len(trace)


# -- the reference's four tests (tests/test_fleet.py) on the port ---------------

def test_fleet_matches_single_engine_and_logs_admissions(
        smoke, reference_outputs, tmp_path):
    fl = _fleet(smoke, tmp_path / "pool")
    res = fl.run(smoke["trace"], rebalance=False)
    fl.close()
    assert res.outputs == reference_outputs
    admits = fl.policy.decisions_for("admit")
    assert [d.name for d in admits] == [r.rid for r in smoke["trace"]]
    for d in admits:
        assert set(d.costs) == {"e1", "e2"}
        assert d.costs[d.choice] == min(d.costs.values())
    assert all(len(r.outputs) > 0 for r in res.per_engine.values())
    # the reference's fleet on the same trace: the same decisions, costs
    # and per-engine outputs
    rfl = _ref_fleet(smoke, tmp_path / "ref")
    rres = rfl.run(smoke["trace"], rebalance=False)
    rfl.close()
    assert _decisions(fl) == _decisions(rfl)
    assert {i: r.outputs for i, r in res.per_engine.items()} == \
        {i: r.outputs for i, r in rres.per_engine.items()}
    assert [(r.decode_ticks, r.prefills, r.commits)
            for r in res.per_engine.values()] == \
        [(r.decode_ticks, r.prefills, r.commits)
         for r in rres.per_engine.values()]


def test_fleet_live_migration_loses_no_tokens(smoke, reference_outputs,
                                              tmp_path):
    fl = _fleet(smoke, tmp_path / "pool")
    res, moved = _force_migration(fl, smoke["trace"])
    fl.close()
    assert moved is not None
    assert res.outputs == reference_outputs
    assert res.migrations == 1
    assert [p for p, r, *_ in fl.migration_log if r == moved] \
        == list(MIGRATION_POINTS)
    assert moved in res.per_engine[2].outputs
    assert moved not in res.per_engine[1].outputs
    assert res.per_engine[2].migrated_in == 1
    assert res.per_engine[1].migrated_out == 1
    rfl = _ref_fleet(smoke, tmp_path / "ref")
    rres, rmoved = _force_migration(rfl, smoke["trace"])
    rfl.close()
    assert (moved, fl.migration_log, _decisions(fl)) == \
        (rmoved, rfl.migration_log, _decisions(rfl))
    assert {i: r.outputs for i, r in res.per_engine.items()} == \
        {i: r.outputs for i, r in rres.per_engine.items()}


@pytest.mark.parametrize("point", MIGRATION_POINTS)
@pytest.mark.parametrize("wipe", [False, True], ids=["kept", "wiped"])
def test_fleet_kill_during_migration_bit_identical(
        smoke, reference_outputs, tmp_path, point, wipe):
    """Kill the whole fleet right after ``point`` of a live handoff, keep
    or lose the target's staging buffer, restart a fresh fleet over the
    pool: resume() re-establishes exactly-one-owner and the finished
    streams equal the uninterrupted run."""
    pool = tmp_path / "pool"
    _run_until_killed(_fleet(smoke, pool, mig_hook=_kill_at(point)),
                      smoke["trace"])
    fl2 = _fleet(smoke, pool)
    if wipe:
        fl2.staging.wipe(2)
    steps = fl2.resume()
    assert any(s is not None for s in steps.values())
    res = fl2.run(smoke["trace"])
    fl2.close()
    assert res.outputs == reference_outputs
    assert _one_owner(res, smoke["trace"])
    # a kill after the handoff manifest leaves the adoption to resume()
    adopted = [e for e in fl2.migration_log if e[0] == "mig_adopt"]
    assert len(adopted) == (point == "mig_commit")


def test_fleet_restart_is_idempotent_after_clean_run(smoke, tmp_path,
                                                     reference_outputs):
    fl = _fleet(smoke, tmp_path / "pool")
    fl.run(smoke["trace"], rebalance=False)
    fl.close()
    fl2 = _fleet(smoke, tmp_path / "pool")
    fl2.resume()
    res = fl2.run(smoke["trace"])
    fl2.close()
    assert res.outputs == reference_outputs
    assert sum(r.prefills for r in res.per_engine.values()) == 0
    assert sum(r.decode_ticks for r in res.per_engine.values()) == 0


@pytest.mark.parametrize("mode", ["async", "sharded-async"])
def test_migration_under_an_async_schedule_equals_the_references(
        smoke, reference_outputs, tmp_path, mode):
    """Under an async schedule the handoff commit publishes one commit
    late; a forced migration still loses no token and logs what the
    reference's fleet logs, and a kill right after ``mig_commit`` (the
    marker launched, not yet durable) resumes to the same streams."""
    fl = _fleet(smoke, tmp_path / "pool", commit_mode=mode)
    res, moved = _force_migration(fl, smoke["trace"])
    fl.close()
    rfl = _ref_fleet(smoke, tmp_path / "ref", commit_mode=mode)
    rres, rmoved = _force_migration(rfl, smoke["trace"])
    rfl.close()
    assert res.outputs == rres.outputs == reference_outputs
    assert (moved, fl.migration_log) == (rmoved, rfl.migration_log)
    assert [r.commits for r in res.per_engine.values()] == \
        [r.commits for r in rres.per_engine.values()]
    pool = tmp_path / "killed"
    _run_until_killed(_fleet(smoke, pool, commit_mode=mode,
                             mig_hook=_kill_at("mig_commit")),
                      smoke["trace"])
    fl2 = _fleet(smoke, pool, commit_mode=mode)
    fl2.staging.wipe(2)
    fl2.resume()
    res2 = fl2.run(smoke["trace"])
    fl2.close()
    assert res2.outputs == reference_outputs
    assert _one_owner(res2, smoke["trace"])


# -- rebalancing and draining ----------------------------------------------------

def test_rebalancing_migrations_equal_the_references(smoke, tmp_path):
    """24 requests over 2 prompts through 2 slots an engine (the fleet
    bench's trace at the smoke prompt length): with rebalancing on, the
    port's fleet makes the reference's admissions, rebalancing decisions
    and migrations, and emits the reference's tokens."""
    trace = synthetic_trace(24, prompt_lens=(8,), new_tokens=(4, 8, 16, 24),
                            vocab_size=smoke["b"].cfg.vocab_size,
                            n_prompts=2)
    t_max = trace_t_max(trace)
    kw = dict(n_engines=2, n_slots=2, t_max=t_max, commit_every=4,
              prefix_reuse=True)
    rb = ref_build(ref_smoke_config(ARCH).with_(**FP32), dec_pos_len=t_max)
    b = build(smoke["b"].cfg, dec_pos_len=t_max, device="cpu")
    fl = FleetController(ARCH, pool_path=str(tmp_path / "port"),
                         bundle=b, params=smoke["p"], prefix_key=REF_KEY,
                         device="cpu", **kw)
    res = fl.run(trace)
    fl.close()
    rfl = RefFleet(ARCH, pool_path=str(tmp_path / "ref"), bundle=rb,
                   params=smoke["rp"], **kw)
    rres = rfl.run(trace)
    rfl.close()
    assert res.migrations == rres.migrations >= 1
    assert fl.migration_log == rfl.migration_log
    assert _decisions(fl) == _decisions(rfl)
    assert {d.kind for d in fl.policy.decisions} == {"admit", "migrate"}
    assert res.outputs == rres.outputs
    assert res.prefix_hits == rres.prefix_hits
    assert [(i, r.decode_ticks, r.prefills, r.migrated_in, r.migrated_out)
            for i, r in res.per_engine.items()] == \
        [(i, r.decode_ticks, r.prefills, r.migrated_in, r.migrated_out)
         for i, r in rres.per_engine.items()]


def test_remove_engine_drains_by_live_migration(smoke, reference_outputs,
                                                tmp_path):
    fl = _fleet(smoke, tmp_path / "pool")
    assert fl.add_engine() == 3
    fl.submit(smoke["trace"])
    fl.tick(rebalance=False)                  # first admissions + a decode
    running = [r for r in fl.engines[1].sched.admission_order
               if r in fl.engines[1].sched.running]
    pending = [r.rid for r in fl.engines[1].sched.pending]
    assert running
    fl.remove_engine(1)
    assert sorted(fl.engines) == [2, 3]
    moved = [r for p, r, s, d in fl.migration_log if p == "mig_release"]
    assert moved == running
    while not fl.done:
        fl.tick(rebalance=False)
    res = fl.finish()
    fl.close()
    assert res.outputs == reference_outputs
    assert res.migrations == len(running)
    assert _one_owner(res, smoke["trace"])
    assert sorted(res.per_engine) == [1, 2, 3]     # results outlive engine 1
    served_elsewhere = set(res.per_engine[2].outputs) \
        | set(res.per_engine[3].outputs)
    assert set(running) | set(pending) <= served_elsewhere


# -- pool crossover --------------------------------------------------------------

@pytest.fixture(scope="module")
def killed_reference_pool(smoke, tmp_path_factory):
    """A reference fleet killed right after ``mig_commit``."""
    pool = tmp_path_factory.mktemp("ref_killed") / "pool"
    _run_until_killed(_ref_fleet(smoke, pool, mig_hook=_kill_at(
        "mig_commit")), smoke["trace"])
    return pool


@pytest.mark.parametrize("wipe", [False, True], ids=["kept", "wiped"])
def test_port_fleet_resumes_a_killed_reference_fleet(
        smoke, reference_outputs, killed_reference_pool, tmp_path, wipe):
    pool = tmp_path / "pool"
    shutil.copytree(killed_reference_pool, pool)
    fl = _fleet(smoke, pool)
    if wipe:
        fl.staging.wipe(2)
    fl.resume()
    assert [e[0] for e in fl.migration_log] == ["mig_adopt", "mig_release"]
    res = fl.run(smoke["trace"])
    fl.close()
    assert res.outputs == reference_outputs
    assert _one_owner(res, smoke["trace"])


@pytest.mark.parametrize("wipe", [False, True], ids=["kept", "wiped"])
def test_reference_fleet_resumes_a_killed_port_fleet(
        smoke, reference_outputs, tmp_path, wipe):
    pool = tmp_path / "pool"
    _run_until_killed(_fleet(smoke, pool, mig_hook=_kill_at("mig_commit")),
                      smoke["trace"])
    rfl = _ref_fleet(smoke, pool)
    if wipe:
        rfl.staging.wipe(2)
    rfl.resume()
    assert [e[0] for e in rfl.migration_log] == ["mig_adopt", "mig_release"]
    res = rfl.run(smoke["trace"])
    rfl.close()
    assert res.outputs == reference_outputs
    assert _one_owner(res, smoke["trace"])


def test_fleet_refuses_a_bundle_on_another_device(smoke, tmp_path):
    with pytest.raises(ValueError, match="fleet asked for cuda"):
        FleetController(ARCH, pool_path=str(tmp_path / "p"),
                        bundle=smoke["b"], params=smoke["p"])
    with pytest.raises(ValueError, match="needs one"):
        FleetController(ARCH, pool_path=str(tmp_path / "q"), n_engines=0,
                        bundle=smoke["b"], params=smoke["p"], device="cpu")
    one = FleetController(ARCH, pool_path=str(tmp_path / "r"), n_engines=1,
                          t_max=smoke["t_max"], bundle=smoke["b"],
                          params=smoke["p"], device="cpu")
    with pytest.raises(ValueError, match="last engine"):
        one.remove_engine(1)
    one.close()
