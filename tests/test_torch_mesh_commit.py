"""The mesh-native durable commit — the port's twins of
``tests/test_mesh_commit.py``, held to the reference on the same numpy
state, on the CPU.

* a state laid over a 2x4 (data, model) mesh commits DEVICE-LOCAL
  (``CXL0Config(mesh=)``): its shard files, CRCs and manifest are
  byte-equal to the port's host-gather commit of the same state at the
  same shard count and to the reference's device-local commit (on its 8
  forced host devices); the device path gathers nothing
  (``d2h_gather_bytes`` 0, per-block copies in ``d2h_shard_bytes``) and
  the host-gather path copies nothing block by block;
* each package recovers the other's pool, in both directions, with and
  without a mesh configured;
* a 2x2 mesh sizes the auto shard count to its 4 places (the byte term
  allows 8); the host-gather path sizes it from the devices torch sees;
* under a topology the placement policy prices the shard count from the
  per-place byte loads: the port's logged decision (choice and every
  candidate's cost) equals the reference's;
* the checkpoint bench's four mesh rows: 8 shards of 1,048,576 bytes,
  manifests equal, 0 gather bytes — ``benchmarks/baselines/
  checkpoint.json``'s values;
* ``run_durable_loop(mesh=)`` trains a mesh-laid toy state through a crash
  under ``sharded-async``: the state stays ShardedTensors across the
  recovery, nothing is gathered, and the final params and the pool's
  files equal the same run without a mesh;
* the runner's mesh lane: a ``scenarios.worker --mesh 2x4`` process is
  killed mid-flush, its restart resumes from the newest completed commit,
  device-sharded (``d2h_gather_bytes`` 0), with the digest of an
  uninterrupted mesh run started at the same time.
"""
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.dsm.api import CXL0Config as RefConfig
from repro_torch.dsm.api import CXL0Config
from repro_torch.dsm.flit_runtime import auto_shard_count
from repro_torch.launch.mesh import parse_mesh
from repro_torch.parallel.sharding import (NamedSharding, P, ShardedTensor,
                                           place)
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def _np_tree(n_leaves=6, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    return {f"w{t}": rng.standard_normal((dim, dim)).astype(np.float32)
            for t in range(n_leaves)}


def _port_shard(tree, mesh):
    sh = NamedSharding(mesh, P("data", "model"))
    return {k: place(torch.from_numpy(v.copy()), sh) for k, v in tree.items()}


def _ref_shard(tree, shape=(2, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    sh = jax.sharding.NamedSharding(mesh,
                                    jax.sharding.PartitionSpec("data",
                                                               "model"))
    return {k: jax.device_put(v, sh) for k, v in tree.items()}, mesh


def _commit(cls, path, tree, *, mesh=None, n_shards=4, topology=None):
    ctx = cls(path=str(path), schedule="sharded", n_shards=n_shards,
              topology=topology, mesh=mesh).open()
    ctx.put({"params": tree}, step=1)
    with ctx.commit(1):
        pass
    return ctx


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


def _templates(tree):
    return {"params": {k: torch.zeros(v.shape) for k, v in tree.items()}}


def _assert_values(objs, want):
    assert sorted(objs["params"]) == sorted(want)
    for k, v in want.items():
        assert np.asarray(objs["params"][k]).tobytes() == v.tobytes()


def test_device_local_commit_is_byte_equal(host_devices_8, tmp_path):
    want = _np_tree()
    mesh = parse_mesh("2x4", device="cpu")
    ctx_dev = _commit(CXL0Config, tmp_path / "dev", _port_shard(want, mesh),
                      mesh=mesh)
    ctx_hg = _commit(CXL0Config, tmp_path / "hg", _port_shard(want, mesh))
    ref_tree, ref_mesh = _ref_shard(want)
    ref_dev = _commit(RefConfig, tmp_path / "ref", ref_tree, mesh=ref_mesh)
    # the transport differed: the device path gathered nothing, the
    # host-gather path copied nothing block by block
    assert ctx_dev.tiers.d2h_gather_bytes == 0
    assert ctx_dev.tiers.d2h_shard_bytes == sum(v.nbytes
                                                for v in want.values())
    assert ctx_hg.tiers.d2h_gather_bytes > 0
    assert ctx_hg.tiers.d2h_shard_bytes == 0
    assert ref_dev.tiers.d2h_gather_bytes == 0
    # ... and the durable bytes did not
    m_dev = ctx_dev.pool.latest_manifest()
    assert m_dev == ctx_hg.pool.latest_manifest() \
        == ref_dev.pool.latest_manifest()
    assert len(m_dev["objects"]["params"]["shards"]) == 4
    files = _files(tmp_path / "dev")
    assert files == _files(tmp_path / "hg") == _files(tmp_path / "ref")
    assert sum(n.startswith("objects") for n in files) == 4


def test_each_package_recovers_the_others_pool(host_devices_8, tmp_path):
    want = _np_tree(seed=3)
    mesh = parse_mesh("2x4", device="cpu")
    ref_tree, ref_mesh = _ref_shard(want)
    _commit(CXL0Config, tmp_path / "dev", _port_shard(want, mesh), mesh=mesh)
    _commit(CXL0Config, tmp_path / "hg", _port_shard(want, mesh))
    _commit(RefConfig, tmp_path / "ref", ref_tree, mesh=ref_mesh)
    ref_templates = {"params": dict(want)}
    # the port's device-local pool, read by a mesh-less port stack and by
    # the reference's stack with and without its mesh
    for ctx in (CXL0Config(path=str(tmp_path / "dev")).open(),):
        objs, step, src = ctx.recover(_templates(want))
        assert (step, src) == (1, "pool")
        _assert_values(objs, want)
    for m in (None, ref_mesh):
        objs, step, src = RefConfig(path=str(tmp_path / "dev"),
                                    mesh=m).open().recover(ref_templates)
        assert (step, src) == (1, "pool")
        _assert_values(objs, want)
    # the host-gather pool and the reference's device-local pool, read by
    # a mesh-configured port stack
    for pool in ("hg", "ref"):
        objs, step, src = CXL0Config(path=str(tmp_path / pool),
                                     mesh=mesh).open().recover(
                                         _templates(want))
        assert (step, src) == (1, "pool")
        _assert_values(objs, want)


def test_shard_count_derived_from_the_mesh(host_devices_8, tmp_path):
    want = _np_tree(n_leaves=8, dim=512, seed=1)
    m22 = parse_mesh("2x2", device="cpu")
    ctx = _commit(CXL0Config, tmp_path / "m22", _port_shard(want, m22),
                  mesh=m22, n_shards=None)
    assert ctx.committer.n_shards == 4
    ref_tree, ref_mesh = _ref_shard(want, (2, 2))
    ref = _commit(RefConfig, tmp_path / "ref22", ref_tree, mesh=ref_mesh,
                  n_shards=None)
    assert ref.committer.n_shards == 4
    assert _files(tmp_path / "m22") == _files(tmp_path / "ref22")
    m24 = parse_mesh("2x4", device="cpu")
    assert _commit(CXL0Config, tmp_path / "m24", _port_shard(want, m24),
                   mesh=m24, n_shards=None).committer.n_shards == 8
    # without a mesh the device term is the devices torch sees (the
    # reference's is its 8 forced host devices)
    flat = _commit(CXL0Config, tmp_path / "flat",
                   {k: torch.from_numpy(v) for k, v in want.items()},
                   n_shards=None)
    total = sum(v.nbytes for v in want.values())
    assert flat.committer.n_shards == auto_shard_count(total) == \
        max(torch.cuda.device_count(), 1)


def test_per_place_pricing_equals_the_reference(host_devices_8, tmp_path):
    want = _np_tree(seed=2)
    mesh = parse_mesh("2x4", device="cpu")
    ctx = _commit(CXL0Config, tmp_path / "priced", _port_shard(want, mesh),
                  mesh=mesh, n_shards=None, topology="cxl20-switched-pool")
    ref_tree, ref_mesh = _ref_shard(want)
    ref = _commit(RefConfig, tmp_path / "ref", ref_tree, mesh=ref_mesh,
                  n_shards=None, topology="cxl20-switched-pool")
    got = ctx.placement.decisions_for("shards")
    exp = ref.placement.decisions_for("shards")
    assert got and [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in exp]
    d = got[-1]
    assert ctx.committer.n_shards == d.choice == ref.committer.n_shards
    assert d.costs[f"k{d.choice}"] == min(d.costs.values())
    assert ctx.tiers.d2h_gather_bytes == 0
    assert _files(tmp_path / "priced") == _files(tmp_path / "ref")


def test_bench_mesh_rows_meet_the_baseline(tmp_path):
    from repro_torch.bench.checkpoint import bench_mesh_commit
    from repro_torch.bench.report import Report
    report = Report("checkpoint")
    extra = bench_mesh_commit(report, str(tmp_path), "cpu")
    baseline = json.loads((ROOT / "benchmarks" / "baselines"
                           / "checkpoint.json").read_text())["metrics"]
    got = {k: m["value"] for k, m in report.metrics.items()}
    for k in ("ckpt_mesh_shards", "ckpt_mesh_shard_bytes",
              "ckpt_mesh_manifest_equal", "ckpt_mesh_d2h_gather_bytes"):
        assert got[k] == baseline[k]["value"], k
    assert got["ckpt_mesh_shard_bytes"] == [1_048_576] * 8
    assert extra["d2h_shard_bytes"] == 3 * 8 * 1_048_576
    assert extra["gather_path_d2h_gather_bytes"] == 3 * 8 * 1_048_576


def _toy_loop(pool, mesh, crash_at=None):
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.scenarios.worker import make_toy_state, make_toy_step
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.utils.tree import tree_map
    state = make_toy_state(32)
    if mesh is not None:
        sh = NamedSharding(mesh, P("data", "model"))
        rep = NamedSharding(mesh, P())
        put = lambda t: place(t, sh)
        state = state._replace(
            params=tree_map(put, state.params),
            opt=state.opt._replace(mu=tree_map(put, state.opt.mu),
                                   nu=tree_map(put, state.opt.nu),
                                   step=place(state.opt.step, rep)),
            rng=place(state.rng, rep))
    pipe = DataPipeline(SyntheticLMSource(1024), 4, 32)
    ctx = CXL0Config(path=str(pool), schedule="sharded-async",
                     n_shards=4, mesh=mesh).open()
    r = run_durable_loop(make_toy_step(), state, pipe, ctx, n_steps=8,
                         commit_every=2, crash_at=crash_at)
    return r, ctx


def test_durable_loop_over_a_mesh(tmp_path):
    mesh = parse_mesh("2x4", device="cpu")
    r, ctx = _toy_loop(tmp_path / "mesh", mesh, crash_at={5: "before_commit"})
    assert r.crashes == 1 and r.recoveries == ["pool"]
    assert all(isinstance(l, ShardedTensor)
               for l in tree_leaves(r.state.params))
    assert isinstance(r.state.opt.step, ShardedTensor)
    assert ctx.tiers.d2h_gather_bytes == 0 < ctx.tiers.d2h_shard_bytes
    flat, _ = _toy_loop(tmp_path / "flat", None, crash_at={5: "before_commit"})
    for a, b in zip(tree_leaves(r.state.params),
                    tree_leaves(flat.state.params)):
        assert torch.equal(a.full(), b)
    assert r.losses == flat.losses
    assert _files(tmp_path / "mesh") == _files(tmp_path / "flat")


def test_runner_mesh_lane_kill_and_restart(tmp_path):
    from repro_torch.scenarios import runner
    kw = dict(steps=8, commit_every=2, mode="sharded-async", shards=0,
              mesh="2x4", topology="cxl20-switched-pool", device="cpu",
              timeout=300)
    with ThreadPoolExecutor(2) as ex:
        f_ref = ex.submit(runner.reference_run, str(tmp_path), **kw)
        r = runner.run_scenario("mid_flush", str(tmp_path), ref_digest=0,
                                **kw)
        ref = f_ref.result()
    r = dataclasses.replace(r, reference_digest=ref["result"]["digest"])
    assert r.ok, r
    assert r.resumed_from == max(r.completed_steps_at_kill) == 1
    kill, restart = r.children
    assert kill["rc"] == 17 and restart["rc"] == 0
    for res in (restart["result"], ref["result"]):
        assert res["mesh"] == "2x4"
        assert res["d2h_gather_bytes"] == 0 < res["d2h_shard_bytes"]
    # the shard count was priced from the per-place bytes and logged
    log = tmp_path / "pool_mid_flush_decisions_restart.jsonl"
    assert [json.loads(l)["kind"] for l in log.read_text().splitlines()] \
        == ["shards"]
