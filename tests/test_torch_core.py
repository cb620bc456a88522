"""The port's CXL0 model (``repro_torch.core``) against the reference
(``repro.core``) on the same inputs: litmus verdicts, Proposition 1 and
refinement results, reachable state sets, simulator histories, checker
verdicts and the latency model.  Host code on both sides, so everything
is compared exactly.

The exhaustive checks run at their smallest here (two Prop. 1 items, the
two refinement checks that finish in under a second); the test of the
copies (``test_torch_core_copies.py``) holds the rest of the modules to
the reference line by line.
"""
import itertools

import pytest

from repro.core import durable as ref_durable
from repro.core import explore as ref_explore
from repro.core import harness as ref_harness
from repro.core import latency as ref_latency
from repro.core import litmus as ref_litmus
from repro.core import props as ref_props
from repro.core import refine as ref_refine
from repro.core import semantics as ref_semantics
from repro.core import state as ref_state
from repro_torch.core import durable, explore, harness, latency, litmus
from repro_torch.core import props, refine, semantics, state

VARIANTS = [v.value for v in semantics.Variant]
SEEDS = range(20)


def _variant(mod, name):
    return mod.Variant(name)


def _states(states):
    return {(s.C, s.M) for s in states}


def _history(history):
    return [(e.kind, e.thread, e.op_id, e.op, e.args, e.result, e.machine)
            for e in history]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("idx", range(len(ref_litmus.LITMUS_TESTS)),
                         ids=[t.name for t in ref_litmus.LITMUS_TESTS])
def test_litmus_verdicts_equal_reference(idx, variant):
    ours, ref = litmus.LITMUS_TESTS[idx], ref_litmus.LITMUS_TESTS[idx]
    assert ours.name == ref.name and repr(ours.trace) == repr(ref.trace)
    got = litmus.run_litmus(ours, _variant(semantics, variant))
    want = ref_litmus.run_litmus(ref, _variant(ref_semantics, variant))
    assert got == want
    assert got == ours.expected[_variant(semantics, variant)]


@pytest.mark.parametrize("item", [4, 6])
def test_prop1_item_equals_reference(item):
    ours = props.check_prop1_item(props.PROP1_ITEMS[item - 1],
                                  state.make_config(2, 1))
    ref = ref_props.check_prop1_item(ref_props.PROP1_ITEMS[item - 1],
                                     ref_state.make_config(2, 1))
    assert ours.item.name == ref.item.name
    assert (ours.checked, ours.ok) == (ref.checked, ref.ok)
    assert ours.checked > 0 and ours.ok


@pytest.mark.parametrize("sub,sup", [("psn", "lwb"), ("base", "lwb")])
def test_refinement_equals_reference(sub, sup):
    ours = refine.check_refinement(
        _variant(semantics, sub), _variant(semantics, sup),
        state.make_config(2, 1))
    ref = ref_refine.check_refinement(
        _variant(ref_semantics, sub), _variant(ref_semantics, sup),
        ref_state.make_config(2, 1))
    assert (ours.witness, ours.explored_pairs) == \
        (ref.witness, ref.explored_pairs)
    assert not ours.refines


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("volatile", [(False, False), (True, False)])
def test_reachable_sets_equal_reference(variant, volatile):
    ours = explore.reachable(state.make_config(2, 1, volatile=volatile),
                             variant=_variant(semantics, variant))
    ref = ref_explore.reachable(
        ref_state.make_config(2, 1, volatile=volatile),
        variant=_variant(ref_semantics, variant))
    assert _states(ours) == _states(ref)
    assert len(ours) > 50


@pytest.mark.parametrize("policy", list(ref_harness.POLICIES))
@pytest.mark.parametrize("workload", list(ref_harness.WORKLOADS))
def test_simulator_histories_equal_reference(workload, policy):
    for seed in SEEDS:
        ours = harness.run_once(harness.WORKLOADS[workload], policy, seed,
                                p_crash=0.08, max_crashes=2)
        ref = ref_harness.run_once(ref_harness.WORKLOADS[workload], policy,
                                   seed, p_crash=0.08, max_crashes=2)
        assert _history(ours.history) == _history(ref.history), seed
        assert (ours.crashed, ours.durable) == (ref.crashed, ref.durable)


@pytest.mark.parametrize("workload", list(ref_harness.WORKLOADS))
def test_checker_verdicts_equal_reference(workload):
    """Each package's checker on both packages' histories: the four
    verdicts of a run agree, and every FliT-for-CXL0 run is durable."""
    verdicts = []
    for seed, policy in itertools.product(SEEDS, ("raw", "flit_cxl0")):
        ours = harness.run_once(harness.WORKLOADS[workload], policy, seed,
                                p_crash=0.08, max_crashes=2)
        ref = ref_harness.run_once(ref_harness.WORKLOADS[workload], policy,
                                   seed, p_crash=0.08, max_crashes=2)
        spec = harness.WORKLOADS[workload]().spec
        ref_spec = ref_harness.WORKLOADS[workload]().spec
        got = {durable.durably_linearizable(ours.history, spec),
               durable.durably_linearizable(ref.history, spec),
               ref_durable.durably_linearizable(ours.history, ref_spec),
               ref_durable.durably_linearizable(ref.history, ref_spec)}
        assert len(got) == 1, (seed, policy)
        assert durable.linearizable(ours.history, spec) == \
            ref_durable.linearizable(ref.history, ref_spec)
        verdicts.append((policy, got.pop()))
    assert all(ok for policy, ok in verdicts if policy == "flit_cxl0")


def test_latency_table_equals_reference():
    assert latency.LATENCY_NS == ref_latency.LATENCY_NS
    for node, prim, loc, fl in itertools.product(
            (latency.HOST, latency.DEVICE),
            ("load", "lstore", "rstore", "mstore", "rflush", "lflush",
             "faa", "cas", "rmw"),
            ("local", "remote"), ("l", "r", "m")):
        try:
            want = ref_latency.primitive_latency(node, prim, loc, fl)
        except KeyError:
            with pytest.raises(KeyError):
                latency.primitive_latency(node, prim, loc, fl)
            continue
        assert latency.primitive_latency(node, prim, loc, fl) == want


def test_trace_cost_over_the_whole_table_equals_reference():
    keys = sorted(ref_latency.LATENCY_NS)
    flavors = [("l", "r", "m")[i % 3] for i in range(len(keys))]
    assert latency.trace_cost(keys) == ref_latency.trace_cost(keys)
    assert latency.trace_cost(keys, flavors=flavors) == \
        ref_latency.trace_cost(keys, flavors=flavors)
    rmw = [(n, p, l) for n, l in itertools.product(
        (latency.HOST, latency.DEVICE), ("local", "remote"))
        for p in ("faa", "cas")]
    for fl in ("l", "r", "m"):
        assert latency.trace_cost(rmw, flavors=[fl] * len(rmw)) == \
            ref_latency.trace_cost(rmw, flavors=[fl] * len(rmw))
    assert [(r.node, r.primitive, r.available, r.to_hm, r.to_hdm)
            for r in latency.TABLE1] == \
        [(r.node, r.primitive, r.available, r.to_hm, r.to_hdm)
         for r in ref_latency.TABLE1]
    assert latency.CONFIG_PRIMITIVES == ref_latency.CONFIG_PRIMITIVES
