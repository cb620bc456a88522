"""The autoscaler simulator of the port (``repro_torch.scale``,
``repro_torch.train.elastic``'s host planners) against the reference's
``repro.scale``, on the CPU: twins of ``tests/test_scale.py``'s traffic,
grow, ``choose_scale``, controller and simulation cases, each holding the
port to the reference's own output exactly (host code, no tolerance):

* arrival counts and traces are equal request for request;
* the partition plans, deltas, join move sets and templates are equal;
* the placement policy's scale costs and decision logs are equal, float
  for float;
* the controller's deltas and events, and every ``SimResult`` (the
  autoscaled fleet and each fixed size, per preset) are equal field for
  field.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.dsm.placement import PlacementPolicy as RefPolicy
from repro.scale import autoscaler as ref_autoscaler
from repro.scale import grow as ref_grow
from repro.scale import traffic as ref_traffic
from repro.train import elastic as ref_elastic
from repro_torch.dsm.emu import get_topology, join_transfer_ns
from repro_torch.dsm.placement import PlacementPolicy
from repro_torch.scale.autoscaler import (Autoscaler, AutoscaleConfig,
                                          simulate_autoscale, simulate_fixed)
from repro_torch.scale.grow import join_moves, join_name, join_templates
from repro_torch.scale.traffic import (TrafficConfig, arrival_counts,
                                       offered_tokens, traffic_trace)
from repro_torch.serve.trace import synthetic_trace
from repro_torch.train.elastic import (grow_plan, partition_plan,
                                       plan_delta, shrink_plan)

PRESETS = ("cxl11-direct", "cxl20-switched-pool", "cxl30-fabric")


def _requests(trace):
    return [dataclasses.astuple(r) for r in trace]


def _ref_cfg(cfg):
    """The reference's config of the same fields."""
    kind = (ref_traffic.TrafficConfig if isinstance(cfg, TrafficConfig)
            else ref_autoscaler.AutoscaleConfig)
    return kind(**dataclasses.asdict(cfg))


def _ref_trace(cfg):
    return ref_traffic.traffic_trace(_ref_cfg(cfg))


# ---------------------------------------------------------------------------
# traffic: pure in (seed, config), the reference's trace exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,horizon", [(7, 64), (0, 288), (3, 48)])
def test_arrival_counts_are_the_references(seed, horizon):
    cfg = TrafficConfig(seed=seed, horizon_ticks=horizon)
    a = arrival_counts(cfg)
    assert a.shape == (horizon,) and a.dtype == np.int64
    assert np.array_equal(a, arrival_counts(cfg))
    assert np.array_equal(a, ref_traffic.arrival_counts(_ref_cfg(cfg)))
    assert not np.array_equal(a, arrival_counts(TrafficConfig(
        seed=seed + 1, horizon_ticks=horizon)))


def test_traffic_trace_is_the_references_and_arrival_sorted():
    cfg = TrafficConfig(seed=3, horizon_ticks=48)
    t1 = traffic_trace(cfg)
    assert t1 == traffic_trace(cfg)
    assert _requests(t1) == _requests(_ref_trace(cfg))
    assert len(t1) == int(arrival_counts(cfg).sum())
    assert all(t1[i].arrival <= t1[i + 1].arrival
               for i in range(len(t1) - 1))
    assert offered_tokens(t1) == ref_traffic.offered_tokens(
        _ref_trace(cfg)) == sum(r.max_new_tokens for r in t1) > 0


def test_diurnal_swing_shapes_the_day():
    cfg = TrafficConfig(seed=0, horizon_ticks=96, base_rate=4.0,
                        burst_rate=0.0)
    counts = arrival_counts(cfg)
    q = len(counts) // 4
    assert counts[q:3 * q].mean() > counts[:q].mean()
    assert np.array_equal(counts, ref_traffic.arrival_counts(_ref_cfg(cfg)))


def test_synthetic_trace_arrivals_do_not_perturb_prompts():
    base = synthetic_trace(6, seed=5, vocab_size=64)
    timed = synthetic_trace(6, seed=5, vocab_size=64,
                            arrivals=[0, 1, 1, 2, 3, 5])
    assert [r.arrival for r in base] == [0] * 6
    assert [r.arrival for r in timed] == [0, 1, 1, 2, 3, 5]
    assert [r.prompt for r in base] == [r.prompt for r in timed]
    assert [r.max_new_tokens for r in base] == \
        [r.max_new_tokens for r in timed]


# ---------------------------------------------------------------------------
# grow-by-repartition helpers and the elastic planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_names", [8, 11])
def test_join_moves_are_the_references(n_names):
    names = [f"t{i}" for i in range(n_names)]
    old = partition_plan(names, [0, 1, 2])
    new = partition_plan(names, [0, 1, 2, 3])
    assert old == ref_elastic.partition_plan(names, [0, 1, 2])
    assert new == ref_elastic.partition_plan(names, [0, 1, 2, 3])
    assert plan_delta(old, new) == ref_elastic.plan_delta(old, new)
    moves = join_moves(old, new, 3)
    assert moves and moves == ref_grow.join_moves(old, new, 3)
    for n, src in moves.items():
        assert old[n] == src and new[n] == 3
    assert set(moves) == {n for n, (_, dst) in
                          plan_delta(old, new).items() if dst == 3}
    # per-rank filtering of the shared move set partitions it exactly
    per_rank = {r: {n for n, src in moves.items() if src == r}
                for r in (0, 1, 2)}
    assert set().union(*per_rank.values()) == set(moves)
    assert sum(len(v) for v in per_rank.values()) == len(moves)
    tpl, ref_tpl = join_templates(moves, dim=4), ref_grow.join_templates(
        moves, dim=4)
    assert list(tpl) == list(ref_tpl) == [join_name(n)
                                          for n in sorted(moves)]
    for k, v in tpl.items():
        assert list(v) == list(ref_tpl[k]) == ["p", "mu", "nu"]
        for leaf, ref_leaf in zip(v.values(), ref_tpl[k].values()):
            assert leaf.dtype == ref_leaf.dtype and leaf.shape == (4, 4)
            assert np.array_equal(leaf, ref_leaf)


def test_elastic_planners_are_the_references():
    for old, new in ((8, 4), (5, 3), (3, 3)):
        assert shrink_plan(old, new) == ref_elastic.shrink_plan(old, new)
    for old, new in ((4, 8), (1, 3), (3, 3)):
        assert grow_plan(old, new) == ref_elastic.grow_plan(old, new)
    names = [f"layer{i}/w" for i in range(13)]
    for ranks, sets in (([2, 0, 5], None), ([0, 1], {0: 3, 1: [7]}),
                        ([0, 1, 2], {0: 2, 1: 0, 2: 1})):
        assert partition_plan(names, ranks, sets) == \
            ref_elastic.partition_plan(names, ranks, sets)
    with pytest.raises(AssertionError):
        plan_delta({"a": 0}, {"b": 0})


# ---------------------------------------------------------------------------
# the cost-priced controller
# ---------------------------------------------------------------------------

def _decisions(policy):
    return [dataclasses.asdict(d) for d in policy.decisions_for("scale")]


def test_scale_costs_are_the_references_and_price_the_join_capital():
    kw = dict(session_ticks=16.0, engine_tick_ns=1e6, max_engines=12)
    for preset in PRESETS:
        pol, ref = PlacementPolicy(preset), RefPolicy(preset)
        for depth, n in ((0, 2), (64, 2), (8, 1), (3, 12)):
            assert pol.scale_costs(depth, n, 4, 1 << 20, **kw) == \
                ref.scale_costs(depth, n, 4, 1 << 20, **kw)
    pol = PlacementPolicy("cxl20-switched-pool")
    idle = pol.scale_costs(0, 2, 4, 1 << 20, **kw)
    assert set(idle) >= {"hold", "grow", "shrink"}
    assert idle["hold"] < idle["grow"]
    deep = pol.scale_costs(64, 2, 4, 1 << 20, **kw)
    assert deep["grow"] < deep["hold"]


def test_choose_scale_logs_what_the_reference_logs():
    pol, ref = (PlacementPolicy("cxl20-switched-pool"),
                RefPolicy("cxl20-switched-pool"))
    kw = dict(session_ticks=16.0, engine_tick_ns=1e6, max_engines=12)
    for p in (pol, ref):
        assert p.choose_scale("fleet@t0", 64, 2, 4, 1 << 20, **kw) == "grow"
        assert p.choose_scale("fleet@t1", 0, 3, 4, 1 << 20, busy_lanes=1,
                              **kw) == "shrink"
    d = _decisions(pol)
    assert d == _decisions(ref) and len(d) == 2
    assert d[0]["choice"] == "grow" and \
        set(d[0]["costs"]) >= {"hold", "grow", "shrink"}


def test_join_capital_tracks_the_topology():
    n = 1 << 20
    ns = [join_transfer_ns(get_topology(p), n) for p in PRESETS]
    assert ns[0] < ns[1] < ns[2]
    grow = {p: PlacementPolicy(p).scale_costs(
        8, 2, 4, n, session_ticks=16.0, engine_tick_ns=1e6,
        max_engines=12)["grow"] for p in PRESETS}
    assert grow["cxl11-direct"] < grow["cxl30-fabric"]


def _drive(scaler_cls, cfg, calls):
    sc = scaler_cls(cfg)
    deltas = [sc.decide(*a, **k) for a, k in calls]
    return sc, deltas, sc.join_delay_ticks()


@pytest.mark.parametrize("case", ["cooldown", "bounds"])
def test_the_controller_decides_what_the_references_decides(case):
    """Scale-out is never suppressed and scale-in honors the cooldown;
    a burst cannot grow past ``max_engines``; a join is never free — and
    every delta, event and logged decision is the reference's."""
    if case == "cooldown":
        cfg = AutoscaleConfig(cooldown_ticks=16)
        calls = [((0,), dict(queue_depth=64, n_engines=2)),
                 ((1,), dict(queue_depth=200, n_engines=4)),
                 ((2,), dict(queue_depth=0, n_engines=8, busy_lanes=0)),
                 ((17,), dict(queue_depth=0, n_engines=8, busy_lanes=0))]
    else:
        cfg = AutoscaleConfig(min_engines=1, max_engines=4)
        calls = [((0,), dict(queue_depth=10**6, n_engines=1))]
    sc, deltas, delay = _drive(Autoscaler, cfg, calls)
    ref, ref_deltas, ref_delay = _drive(ref_autoscaler.Autoscaler,
                                        _ref_cfg(cfg), calls)
    assert deltas == ref_deltas and delay == ref_delay >= 1
    assert [dataclasses.astuple(e) for e in sc.events] == \
        [dataclasses.astuple(e) for e in ref.events]
    assert _decisions(sc.policy) == _decisions(ref.policy)
    if case == "cooldown":
        assert deltas[0] > 0 and deltas[1] > 0
        assert deltas[2] == 0 and deltas[3] < 0
    else:
        assert 1 + deltas[0] <= cfg.max_engines


# ---------------------------------------------------------------------------
# the simulated fleet: elasticity must pay, and equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", PRESETS)
def test_autoscaled_fleet_beats_best_fixed_as_the_reference(topology):
    trace = traffic_trace(TrafficConfig(seed=3))
    ref_trace = _ref_trace(TrafficConfig(seed=3))
    cfg = AutoscaleConfig(topology=topology)
    auto = simulate_autoscale(trace, cfg)
    fixed = {n: simulate_fixed(trace, n, cfg)
             for n in range(1, cfg.max_engines + 1)}
    ref_cfg = _ref_cfg(cfg)
    assert dataclasses.astuple(auto) == dataclasses.astuple(
        ref_autoscaler.simulate_autoscale(ref_trace, ref_cfg))
    for n, r in fixed.items():
        assert dataclasses.astuple(r) == dataclasses.astuple(
            ref_autoscaler.simulate_fixed(ref_trace, n, ref_cfg)), n
    best = min(fixed.values(), key=lambda r: r.priced_cost_ns)
    assert auto.lost_sessions == 0 and auto.served == len(trace)
    assert auto.priced_cost_ns < best.priced_cost_ns
    assert auto.p99_admission_ticks < best.p99_admission_ticks
    assert auto.grows > 0 and auto.engines_max > auto.engines_min


def test_simulation_is_deterministic():
    trace = traffic_trace(TrafficConfig(seed=1, horizon_ticks=64))
    cfg = AutoscaleConfig()
    assert simulate_autoscale(trace, cfg) == simulate_autoscale(trace, cfg)
    assert simulate_fixed(trace, 3, cfg) == simulate_fixed(trace, 3, cfg)


def test_decision_log_dumps_what_the_reference_dumps(tmp_path):
    cfg = TrafficConfig(seed=3, horizon_ticks=64)
    logs = []
    for mod, trace, acfg in (
            (None, traffic_trace(cfg), AutoscaleConfig()),
            (ref_autoscaler, _ref_trace(cfg),
             ref_autoscaler.AutoscaleConfig())):
        scaler = (mod.Autoscaler if mod else Autoscaler)(acfg)
        res = (mod.simulate_autoscale if mod else simulate_autoscale)(
            trace, acfg, scaler=scaler)
        log = tmp_path / f"decisions{len(logs)}.jsonl"
        scaler.dump_decisions(str(log))
        logs.append((res.decisions, log.read_text()))
    assert logs[0] == logs[1]
    lines = [json.loads(l) for l in logs[0][1].splitlines()]
    assert len(lines) == logs[0][0] > 0
    for d in lines:
        assert d["kind"] == "scale" and d["choice"] in d["costs"]
        assert "hold" in d["costs"] and len(d["costs"]) >= 2
        assert set(d["costs"]) <= {"hold", "grow", "shrink"}
