"""The port's placement policy (``repro_torch.dsm.placement``) against the
JAX package's ``repro.dsm.placement``, its wiring into the port's
committer and config, and ``tests/test_placement.py``'s cases on the port.

* every decision — spill tier, shard count (by bytes and by per-device
  loads), schedule, fleet admission, rebalancing migration, fleet scale,
  rank staging — and every logged cost equals the reference's exactly
  (tolerance 0), over the three presets and a grid of sizes, queue
  depths and imbalances;
* ``DurableCommitter(placement=)`` takes its shard count from the policy
  and resolves ``mode="auto"`` at the first commit, as
  ``tests/test_placement.py:109-150`` ask of the reference;
* ``CXL0Config(topology=, placement=)`` resolves its policy and schedule
  as the reference's does, and a serving engine under ``auto`` makes the
  reference's schedule and shard decisions and emits its tokens.

Not here: ``test_durable_loop_with_placement_auto`` (the training loop,
ROADMAP A2) waits for its slice.  The twin of
``test_spill_auto_routes_by_policy_and_restores`` is in
``tests/test_torch_legacy_serve.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.dsm import placement as ref_placement
from repro.dsm.api import CXL0Config as RefConfig
from repro.dsm.flit_runtime import DurableCommitter as RefCommitter
from repro.dsm.pool import DSMPool as RefPool
from repro.dsm.tiers import TierManager as RefTiers
from repro_torch.dsm.api import CXL0Config, open_cxl0
from repro_torch.dsm.emu import PRESETS
from repro_torch.dsm.flit_runtime import DurableCommitter
from repro_torch.dsm.placement import PlacementPolicy, plan_rank_staging
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.tiers import TierManager

MB = 1 << 20
SIZES = [1, 4 << 10, 100_003, MB, 2 * MB + 7, 8 * MB, 64 * MB, 512 * MB]


def _decisions(policy):
    return [dataclasses.astuple(d) for d in policy.decisions]


def _both(preset, **kw):
    return (PlacementPolicy(preset, **kw),
            ref_placement.PlacementPolicy(preset, **kw))


# -- decisions equal the reference's --------------------------------------------

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_spill_shard_and_schedule_decisions_equal_the_references(preset):
    ours, theirs = _both(preset)
    rng = np.random.default_rng(0)
    for p in (ours, theirs):
        for i, nb in enumerate(SIZES):
            assert p.spill_costs(nb) == \
                (theirs if p is ours else ours).spill_costs(nb)
            p.choose_spill(f"kv/{i}", nb)
            p.choose_shards(nb, f"s{i}")
            p.choose_shards(nb, log=False)
            p.choose_schedule(nb, f"state{i}")
            plan_rank_staging(p, nb) if p is ours \
                else ref_placement.plan_rank_staging(p, nb)
    for loads in ([3 * MB], [MB] * 8, [int(x) for x in
                                       rng.integers(1, 64 * MB, 11)]):
        assert ours.choose_shards(sum(loads), device_bytes=loads) == \
            theirs.choose_shards(sum(loads), device_bytes=loads)
    assert _decisions(ours) == _decisions(theirs)
    assert len(ours.decisions) == 4 * len(SIZES) + 3


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fleet_decisions_equal_the_references(preset):
    ours, theirs = _both(preset)
    for p in (ours, theirs):
        for depths in ({1: 0, 2: 0}, {1: 3, 2: 1}, {1: 1, 2: 4, 3: 4},
                       {2: 7, 5: 2}):
            for nb in (4096, 131_072, 8 * MB):
                for hit in (False, True):
                    p.choose_admission("r", depths, nb,
                                       {i: hit for i in depths})
                p.choose_admission("r", depths, nb,
                                   {min(depths): True})
        for nb in (4096, 65_536, 8 * MB):
            for imbalance in (-1, 0, 1, 2, 5, 40):
                p.choose_migration("r", nb, imbalance)
        for q in (0, 3, 20):
            for n in (1, 2, 8):
                for busy in (0, 4):
                    p.choose_scale("fleet", q, n, 2, 64 * MB,
                                   busy_lanes=busy, session_nbytes=MB)
    assert _decisions(ours) == _decisions(theirs)
    assert {d.kind for d in ours.decisions} == {"admit", "migrate", "scale"}


def test_policy_knobs_reach_the_costs_as_in_the_reference():
    kw = dict(p_peer_loss=0.3, replay_ns_per_byte=1.5, sync_threshold_ns=5e5,
              max_shards=3, restore_fraction=0.5, decode_tick_ns=1e6)
    ours, theirs = _both("cxl30-fabric", **kw)
    for p in (ours, theirs):
        for nb in SIZES:
            p.choose_spill("o", nb)
            p.choose_shards(nb)
            p.choose_schedule(nb)
        p.choose_admission("r", {1: 2, 2: 0}, MB)
        p.choose_migration("r", MB, 3)
    assert _decisions(ours) == _decisions(theirs)


# -- the reference's cases (tests/test_placement.py) on the port ----------------

def test_shard_count_flips_with_topology():
    ks = {name: PlacementPolicy(name).choose_shards(64 * MB)
          for name in PRESETS}
    assert ks["cxl11-direct"] == 1
    assert (ks["cxl11-direct"] < ks["cxl20-switched-pool"]
            < ks["cxl30-fabric"])
    assert ks["cxl30-fabric"] <= PRESETS["cxl30-fabric"].n_links


def test_shard_count_scales_with_size():
    p = PlacementPolicy("cxl30-fabric")
    assert p.choose_shards(4 << 10) == 1
    assert p.choose_shards(64 * MB) > 1


def test_spill_tier_flips_with_topology():
    assert PlacementPolicy("cxl11-direct").choose_spill("kv", MB) == "staging"
    assert PlacementPolicy("cxl30-fabric").choose_spill("kv", MB) == "pool"


def test_spill_tier_flips_with_size():
    p = PlacementPolicy("cxl30-fabric")
    assert p.choose_spill("small", 4 << 10) == "staging"
    assert p.choose_spill("large", 64 * MB) == "pool"


def test_schedule_flips_with_size():
    p = PlacementPolicy("cxl11-direct")
    assert p.choose_schedule(64 << 10) == "sync"
    assert p.choose_schedule(64 * MB) == "sharded-async"


def test_decisions_are_logged_with_costs():
    p = PlacementPolicy("cxl20-switched-pool")
    p.choose_spill("kv/r1", 2 * MB)
    p.choose_shards(2 * MB, "kv/r1")
    p.choose_schedule(2 * MB, "state")
    assert [d.kind for d in p.decisions] == ["spill", "shards", "schedule"]
    spill = p.decisions_for("spill")[0]
    assert spill.name == "kv/r1" and spill.nbytes == 2 * MB
    assert set(spill.costs) == {"staging", "pool"}
    assert spill.costs[spill.choice] == min(spill.costs.values())
    assert spill.topology == "cxl20-switched-pool"
    sched = p.decisions_for("schedule")[0]
    assert sched.choice in ("sync", "sharded-async")
    assert "flush_ns" in sched.costs


def test_policy_never_loses_to_fixed_strategies():
    rng = np.random.default_rng(42)
    sizes = [int(x) for x in np.exp(rng.uniform(np.log(4 << 10),
                                                np.log(64 * MB), 16))]
    mixed = 0
    for name in PRESETS:
        p = PlacementPolicy(name)
        staging = pool = policy = 0.0
        choices = set()
        for nb in sizes:
            c = p.spill_costs(nb)
            staging += c["staging"]
            pool += c["pool"]
            ch = p.choose_spill("o", nb)
            choices.add(ch)
            policy += c[ch]
        assert policy <= staging + 1e-9
        assert policy <= pool + 1e-9
        mixed += len(choices) == 2
    assert mixed >= 1


def test_plan_rank_staging_flips_with_topology():
    p_direct = PlacementPolicy("cxl11-direct")
    p_fabric = PlacementPolicy("cxl30-fabric")
    assert plan_rank_staging(p_direct, MB) is True
    assert plan_rank_staging(p_fabric, MB) is False
    assert p_direct.decisions_for("staging")[0].choice is True
    assert p_fabric.decisions_for("staging")[0].nbytes == MB


# -- wiring: the committer (tests/test_placement.py:109-150) --------------------

def _state(nbytes):
    return {"params": {"w": torch.zeros(nbytes // 4, dtype=torch.float32)}}


def test_committer_resolves_shards_from_policy(tmp_path):
    p = PlacementPolicy("cxl30-fabric")
    tiers = TierManager(DSMPool(str(tmp_path / "pool")))
    c = DurableCommitter(tiers, mode="sharded", placement=p)
    c.update(_state(8 * MB))
    st = c.commit(0)
    assert st.n_shards == p.choose_shards(8 * MB, log=False)
    assert st.n_shards > 1
    assert p.decisions_for("shards")
    assert tiers.pool.latest_manifest()["step"] == 0
    tiers.close()


def test_committer_auto_mode_resolves_schedule(tmp_path):
    p = PlacementPolicy("cxl11-direct")
    tiers = TierManager(DSMPool(str(tmp_path / "pool")))
    c = DurableCommitter(tiers, mode="auto", placement=p)
    c.update(_state(64 << 10))                # small: the policy says sync
    st = c.commit(0)
    assert c.mode == "sync"
    assert st is not None and st.step == 0
    assert p.decisions_for("schedule")[0].choice == "sync"
    tiers.close()

    p2 = PlacementPolicy("cxl11-direct")
    tiers2 = TierManager(DSMPool(str(tmp_path / "pool2")))
    c2 = DurableCommitter(tiers2, mode="auto", placement=p2)
    c2.update(_state(64 * MB))                # large: the overlap pays
    assert c2.commit(0) is None               # async: published one behind
    assert c2.mode == "sharded-async"
    assert c2.drain().step == 0
    tiers2.close()


def test_auto_mode_requires_policy(tmp_path):
    tiers = TierManager(DSMPool(str(tmp_path / "pool")))
    with pytest.raises(ValueError, match="PlacementPolicy"):
        DurableCommitter(tiers, mode="auto")
    tiers.close()


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("nbytes", [64 << 10, 8 * MB])
def test_committer_decisions_equal_the_references(tmp_path, preset, nbytes):
    """The same state committed under ``auto`` in both packages: the same
    logged schedule and shard decisions, the same schedule and shard count,
    and the same manifest step."""
    ours, theirs = _both(preset)
    c = DurableCommitter(TierManager(DSMPool(str(tmp_path / "p"))),
                         mode="auto", placement=ours)
    rc = RefCommitter(RefTiers(RefPool(str(tmp_path / "r")), 0),
                      mode="auto", placement=theirs)
    c.update(_state(nbytes))
    rc.update({"params": {"w": np.zeros(nbytes // 4, np.float32)}})
    for committer in (c, rc):
        committer.commit(0)
        committer.drain()
        committer.tiers.close()
    assert (c.mode, c.n_shards) == (rc.mode, rc.n_shards)
    assert _decisions(ours) == _decisions(theirs)
    assert c.tiers.pool.latest_manifest()["step"] == \
        rc.tiers.pool.latest_manifest()["step"] == 0


# -- wiring: the config ---------------------------------------------------------

def test_config_resolves_placement_and_schedule_as_the_reference(tmp_path):
    # the port's default schedule is "sync" (the reference's is "auto"):
    # every case names its schedule
    for kw in ({"schedule": "sync"}, {"schedule": "auto"},
               {"schedule": "auto", "topology": "cxl11-direct"},
               {"schedule": "sync", "topology": "cxl20-switched-pool"},
               {"topology": "cxl30-fabric", "schedule": "sharded"}):
        ours = CXL0Config(path="p", **kw)
        theirs = RefConfig(path="p", **kw)
        assert ours.resolved_schedule() == theirs.resolved_schedule(), kw
        rp, tp = ours.resolved_placement(), theirs.resolved_placement()
        assert (rp is None) == (tp is None)
        if rp is not None:
            assert rp.topology.name == tp.topology.name
    policy = PlacementPolicy("cxl20-switched-pool")
    assert CXL0Config(path="p", placement=policy).resolved_placement() \
        is policy
    assert CXL0Config(path="p", schedule="auto",
                      placement=policy).resolved_schedule() == "auto"
    ctx = CXL0Config(path=str(tmp_path / "p"),
                     topology="cxl20-switched-pool", schedule="sync").open()
    assert ctx.committer.mode == "sync"
    assert ctx.placement.topology.name == "cxl20-switched-pool"
    assert ctx.committer.placement is ctx.placement
    ctx.close()
    ctx = open_cxl0(str(tmp_path / "q"), schedule="auto")
    assert ctx.committer.mode == "sharded-async" and ctx.placement is None
    ctx.close()
    with pytest.raises(ValueError):
        CXL0Config(path="p", schedule="bogus")


@pytest.mark.parametrize("preset", ["cxl11-direct", "cxl30-fabric"])
def test_serving_under_auto_makes_the_references_decisions(tmp_path, preset):
    """olmo-1b smoke (fp32, the reference's weights) served with
    ``commit_mode="auto"`` and a topology in both packages: the same
    schedule, shard count and logged decisions, and the same tokens."""
    import jax
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models.registry import build as ref_build
    from repro.serve.engine import build_serve_engine as ref_build_engine
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import from_reference
    from repro_torch.models.registry import build
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    cfg = get_smoke_config("olmo-1b").with_(**fp32)
    trace = synthetic_trace(5, prompt_lens=(40,), new_tokens=(3, 9),
                            vocab_size=cfg.vocab_size)
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config("olmo-1b").with_(**fp32),
                   dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    kw = dict(smoke=True, n_slots=2, t_max=t_max, commit_every=2,
              commit_mode="auto", topology=preset)
    ours, _ = build_serve_engine(
        "olmo-1b", pool_path=str(tmp_path / "port"), device="cpu",
        bundle=build(cfg, device="cpu"),
        params=from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu"),
        **kw)
    theirs, _ = ref_build_engine("olmo-1b", pool_path=str(tmp_path / "ref"),
                                 bundle=rb, params=rp, **kw)
    res, rres = ours.run(trace), theirs.run(trace)
    for e in (ours, theirs):
        e.close()
    assert res.outputs == rres.outputs
    assert (ours.store.committer.mode, ours.store.committer.n_shards) == \
        (theirs.store.committer.mode, theirs.store.committer.n_shards)
    assert ours.store.committer.mode in ("sync", "sharded-async")
    assert _decisions(ours.store.placement) == \
        _decisions(theirs.store.placement)
    assert ours.store.placement.decisions_for("schedule")
