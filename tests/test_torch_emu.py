"""The port's topology emulator (``repro_torch.dsm.emu``) against the JAX
package's ``repro.dsm.emu``, and ``tests/test_emu.py``'s cases on the port.

* the three presets equal the reference's field by field;
* every pricing function equals the reference's over a grid of sizes,
  stream and shard counts, exactly (tolerance 0: the same float
  operations in the same order);
* ``tree_nbytes`` sizes torch leaves from their metadata (a ``meta``
  tensor, which has no data to copy, is sized like any other);
* a ``TopologyEmulator`` attached to the port's ``TierManager`` records
  the reference's priced trace — ops, names, bytes, stream counts and ns
  — for the same op sequence and seed, on every preset;
* the reference's cases: the taxonomy, the model's shape, determinism
  under a seed, ``reset`` and behaviour-preserving instrumentation.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.latency import HOST as REF_HOST
from repro.core.latency import LATENCY_NS as REF_LATENCY_NS
from repro.dsm import emu as ref_emu
from repro.dsm.pool import DSMPool as RefPool
from repro.dsm.tiers import TierManager as RefTiers
from repro_torch.core.latency import HOST, LATENCY_NS
from repro_torch.dsm import emu
from repro_torch.dsm.emu import (PRESETS, TopologyEmulator, attach_emulator,
                                 get_topology, lstore_ns, rflush_ns,
                                 rload_pool_ns, rstore_ns, sharded_flush_ns,
                                 tree_nbytes)
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.tiers import TierManager

SIZES = [0, 1, 4096, 123_457, 1 << 20, 8_388_609, 64 << 20]


# -- presets and pricing against the reference ---------------------------------

def test_presets_equal_the_references_field_by_field():
    assert sorted(PRESETS) == sorted(ref_emu.PRESETS)
    for name, t in PRESETS.items():
        assert dataclasses.asdict(t) == \
            dataclasses.asdict(ref_emu.PRESETS[name])
        for k in range(1, 17):
            assert t.aggregate_bw_gbps(k) == \
                ref_emu.PRESETS[name].aggregate_bw_gbps(k)
    assert LATENCY_NS == REF_LATENCY_NS and HOST == REF_HOST


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_pricing_functions_equal_the_references(preset):
    ours, theirs = PRESETS[preset], ref_emu.PRESETS[preset]
    for fn in ("lstore_ns", "rstore_ns", "rload_staging_ns", "mstore_ns",
               "rload_pool_ns"):
        for nb in SIZES:
            assert getattr(emu, fn)(ours, nb) == \
                getattr(ref_emu, fn)(theirs, nb), (fn, nb)
    for nb in SIZES:
        for k in range(1, 18):
            assert rflush_ns(ours, nb, k) == ref_emu.rflush_ns(theirs, nb, k)
            assert sharded_flush_ns(ours, nb, k) == \
                ref_emu.sharded_flush_ns(theirs, nb, k)
            assert emu.join_transfer_ns(ours, nb, k) == \
                ref_emu.join_transfer_ns(theirs, nb, k)
    rng = np.random.default_rng(0)
    for loads in ([], [5], [1 << 20] * 8,
                  [int(x) for x in rng.integers(1, 1 << 24, 13)]):
        for k in range(1, 10):
            assert emu.sharded_flush_device_ns(ours, loads, k) == \
                ref_emu.sharded_flush_device_ns(theirs, loads, k)


def test_tree_nbytes_equals_the_references_and_reads_only_metadata():
    rng = np.random.default_rng(1)
    arrays = {"a": rng.standard_normal(37).astype(np.float32),
              "b": [rng.integers(0, 9, (3, 5)).astype(np.int64),
                    np.zeros((2, 2), np.int8)]}
    tensors = {"a": torch.from_numpy(arrays["a"]),
               "b": [torch.from_numpy(arrays["b"][0]),
                     torch.zeros((2, 2), dtype=torch.int8)]}
    assert tree_nbytes(tensors) == ref_emu.tree_nbytes(arrays) \
        == 37 * 4 + 15 * 8 + 4
    # a meta tensor has a shape and a dtype and no data: pricing a CUDA
    # leaf the same way never copies it to the host
    meta = [torch.empty((1024, 64), dtype=torch.bfloat16, device="meta")]
    assert tree_nbytes(meta) == 1024 * 64 * 2


# -- the priced trace against the reference -------------------------------------

def _drive(tiers, peer, leaf):
    """A fixed op sequence exercising every priced primitive."""
    a = {"x": leaf(np.arange(64, dtype=np.float32)),
         "y": leaf(np.ones((8, 8), np.float32))}
    tiers.lstore("obj", a)
    tiers.rstore("obj", peer)
    tiers.rflush("obj")
    tiers.mstore("obj", a)
    tiers.rflush_sharded("obj", 2)
    tiers.flush_async("obj")
    tiers.flush_wait("obj")
    peer.rload("obj")           # peer-side read of the staged copy


def _traced_run(tmp, seed, preset="cxl20-switched-pool"):
    e = TopologyEmulator(preset, seed=seed)
    tiers = attach_emulator(TierManager(DSMPool(f"{tmp}/pool")), e)
    peer = attach_emulator(TierManager(DSMPool(f"{tmp}/peer")), e)
    _drive(tiers, peer, torch.from_numpy)
    tiers.close()
    return e.trace


def _ref_traced_run(tmp, seed, preset="cxl20-switched-pool"):
    e = ref_emu.TopologyEmulator(preset, seed=seed)
    tiers = ref_emu.attach_emulator(RefTiers(RefPool(f"{tmp}/pool"), 0), e)
    peer = ref_emu.attach_emulator(RefTiers(RefPool(f"{tmp}/peer"), 1), e)
    _drive(tiers, peer, lambda a: a)
    tiers.close()
    return e.trace


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("seed", [0, 7])
def test_priced_trace_equals_the_references(tmp_path, preset, seed):
    ours = _traced_run(tmp_path / "port", seed, preset)
    theirs = _ref_traced_run(tmp_path / "ref", seed, preset)
    assert [dataclasses.astuple(p) for p in ours] == \
        [dataclasses.astuple(p) for p in theirs]
    assert len(ours) == 8


# -- the reference's cases (tests/test_emu.py) on the port ----------------------

def test_three_presets_span_the_taxonomy():
    assert set(PRESETS) == {"cxl11-direct", "cxl20-switched-pool",
                            "cxl30-fabric"}
    assert {t.generation for t in PRESETS.values()} == {"1.1", "2.0", "3.0"}
    direct = PRESETS["cxl11-direct"]
    assert direct.remote_multiplier == 1.0
    assert direct.switch_hop_ns == 0.0
    assert direct.n_links == 1


def test_presets_differ_in_remote_cost_and_fanout():
    d, s, f = (PRESETS["cxl11-direct"], PRESETS["cxl20-switched-pool"],
               PRESETS["cxl30-fabric"])
    lat = [rflush_ns(t, 0) for t in (d, s, f)]
    assert lat[0] < lat[1] < lat[2]
    assert d.n_links < s.n_links < f.n_links
    assert (d.aggregate_bw_gbps(8) < s.aggregate_bw_gbps(8)
            < f.aggregate_bw_gbps(8))


def test_direct_preset_matches_calibrated_table_at_zero_bytes():
    t = get_topology("cxl11-direct")
    assert rflush_ns(t, 0) == LATENCY_NS[(HOST, "rflush", "remote")]
    assert lstore_ns(t, 0) == LATENCY_NS[(HOST, "lstore", "local")]


def test_get_topology_rejects_unknown():
    with pytest.raises(KeyError):
        get_topology("cxl99-imaginary")
    assert get_topology(PRESETS["cxl30-fabric"]) is PRESETS["cxl30-fabric"]


def test_costs_monotone_in_bytes():
    for t in PRESETS.values():
        for fn in (lstore_ns, rstore_ns, rflush_ns, rload_pool_ns):
            assert fn(t, 1 << 20) < fn(t, 8 << 20)


def test_sharding_beyond_links_never_helps():
    for t in PRESETS.values():
        nb = 64 << 20
        at_links = sharded_flush_ns(t, nb, t.n_links)
        assert sharded_flush_ns(t, nb, t.n_links + 4) >= at_links
    d = PRESETS["cxl11-direct"]
    assert sharded_flush_ns(d, 64 << 20, 4) > sharded_flush_ns(d, 64 << 20, 1)


def test_tree_nbytes():
    tree = {"a": torch.zeros(8, dtype=torch.float32),
            "b": np.zeros((2, 4), np.int64)}
    assert tree_nbytes(tree) == 8 * 4 + 8 * 8


def test_same_topology_and_seed_identical_priced_trace(tmp_path):
    t1 = _traced_run(tmp_path / "a", seed=7)
    t2 = _traced_run(tmp_path / "b", seed=7)
    assert t1 == t2
    assert len(t1) > 0
    ops = [p.op for p in t1]
    for expected in ("lstore", "rstore", "rflush", "mstore",
                     "rflush_shard", "rload"):
        assert expected in ops


def test_different_seed_same_ops_different_costs(tmp_path):
    t1 = _traced_run(tmp_path / "a", seed=0)
    t2 = _traced_run(tmp_path / "b", seed=1)
    assert [p.op for p in t1] == [p.op for p in t2]
    assert [p.nbytes for p in t1] == [p.nbytes for p in t2]
    assert any(x.cost_ns != y.cost_ns for x, y in zip(t1, t2))


def test_reset_reprices_identically(tmp_path):
    e = TopologyEmulator("cxl30-fabric", seed=3)
    tiers = attach_emulator(TierManager(DSMPool(str(tmp_path / "p"))), e)
    tiers.lstore("o", {"x": torch.zeros(32)})
    tiers.rflush("o")
    first = list(e.trace)
    e.reset()
    tiers.lstore("o", {"x": torch.zeros(32)})
    tiers.rflush("o")
    assert [p.cost_ns for p in e.trace] == [p.cost_ns for p in first]


def test_instrumentation_preserves_behaviour(tmp_path):
    e = TopologyEmulator("cxl11-direct")
    tiers = attach_emulator(TierManager(DSMPool(str(tmp_path / "pool"))), e)
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    tiers.lstore("params", tree)
    obj = tiers.rflush("params")
    assert obj.version == tiers.versions["params"]
    back = tiers.pool.read_object("params", obj.version, tree,
                                  expected_crc=obj.crc)
    assert torch.equal(back["w"], tree["w"])
    sharded = tiers.rflush_sharded("params", 2)
    assert len(sharded.shards) >= 1
    assert tiers.emulator is e
    assert e.total_ns() > 0
    per_op = e.per_op_ns()
    assert per_op["lstore"] > 0 and per_op["rflush"] > 0
    tiers.close()
