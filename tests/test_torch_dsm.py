"""The port's DSM layer against the JAX package's, byte for byte.

* ``.cxl0`` frames: identical leaf bytes give identical files (fp32, int32,
  bool, bf16 — ml_dtypes on the reference side, torch through int16 views
  on the port's — 0-d and empty leaves), and each package reads the
  other's frames;
* pools: a pool committed by the port's ``open_cxl0`` is recovered by the
  reference's ``RecoveryManager`` and the other way round, and the
  manifest documents are equal for equal objects and meta;
* ``recover_latest`` (a dynamic object set) returns what the reference's
  returns, on a pool either package committed;
* the port's own crash contract: a torn object falls back to the previous
  manifest, an exception inside a commit region publishes nothing, and
  the wiring knobs (mesh, topology, placement, ``"auto"``) open and reach
  the committer.
"""
import io
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dsm import stream as ref_stream
from repro.dsm.api import open_cxl0 as ref_open_cxl0
from repro.dsm.pool import DSMPool as RefPool
from repro.dsm.recovery import RecoveryManager as RefRecovery
from repro_torch.dsm import stream
from repro_torch.dsm.api import CXL0Config, open_cxl0
from repro_torch.dsm.pool import DSMPool, partition_leaves
from repro_torch.dsm.recovery import ColdStartError, RecoveryManager
from repro_torch.utils.convert import from_numpy, raw_numpy


def _np_leaves(seed=0):
    """Leaf kinds the pool carries, as the reference holds them."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
        "bool": rng.integers(0, 2, (2, 2)).astype(bool),
        "bf16": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
        "f32_0d": np.asarray(3.5, np.float32),
        "bf16_0d": np.asarray(-1.25, ml_dtypes.bfloat16),
        "f32_empty": np.zeros((0, 4), np.float32),
        "bf16_empty": np.zeros((2, 0), ml_dtypes.bfloat16),
        "big_f32": rng.standard_normal((300, 300)).astype(np.float32),
    }


def _bits(x):
    """Raw bytes of a numpy (ml_dtypes) array or a torch tensor."""
    return raw_numpy(x)[0].tobytes()


KINDS = sorted(_np_leaves())


@pytest.mark.parametrize("kind", KINDS + ["all"])
def test_frame_bytes_identical_to_reference(kind):
    leaves = _np_leaves()
    arrs = list(leaves.values()) if kind == "all" else [leaves[kind]]
    ref = io.BytesIO()
    ref_crc, ref_n, ref_hdr = ref_stream.write_frame(ref, arrs)
    ours = io.BytesIO()
    crc, n, hdr = stream.write_frame(ours, [from_numpy(a) for a in arrs])
    assert ours.getvalue() == ref.getvalue()
    assert (crc, n, hdr) == (ref_crc, ref_n, ref_hdr)
    # numpy (ml_dtypes) leaves given straight to the port: same bytes
    again = io.BytesIO()
    stream.write_frame(again, arrs)
    assert again.getvalue() == ref.getvalue()


def test_frames_read_across_packages(tmp_path):
    arrs = list(_np_leaves(1).values())
    p_ref, p_ours = str(tmp_path / "ref.cxl0"), str(tmp_path / "ours.cxl0")
    with open(p_ref, "wb") as f:
        ref_stream.write_frame(f, arrs)
    with open(p_ours, "wb") as f:
        stream.write_frame(f, [from_numpy(a) for a in arrs])
    ours_read, crc, _ = stream.read_frame(p_ref)
    ref_read, ref_crc, _ = ref_stream.read_frame(p_ours)
    assert crc == ref_crc
    for a, t, r in zip(arrs, ours_read, ref_read):
        assert isinstance(t, torch.Tensor)
        assert tuple(t.shape) == a.shape and _bits(t) == _bits(a)
        assert r.dtype == a.dtype and _bits(r) == _bits(a)


def test_partition_leaves_equals_reference():
    from repro.dsm.pool import partition_leaves as ref_partition
    rng = np.random.default_rng(3)
    for n in (1, 3, 7):
        sizes = [int(s) for s in rng.integers(1, 1000, 17)]
        assert partition_leaves(sizes, n) == ref_partition(sizes, n)


def _state(seed=0):
    leaves = _np_leaves(seed)
    return {"params": {"w": leaves["f32"], "emb": leaves["bf16"],
                       "norm": {}},
            "opt": [leaves["i32"], leaves["f32_0d"], leaves["bool"]]}


def _templates(state):
    return {k: v for k, v in state.items()}


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    return from_numpy(tree)


def _assert_tree_bits(ours, theirs):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            _assert_tree_bits(ours[k], theirs[k])
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_tree_bits(a, b)
    else:
        assert tuple(ours.shape) == tuple(np.shape(theirs))
        assert _bits(ours) == _bits(theirs)


def _commit_port(path, state, step, meta):
    ctx = open_cxl0(str(path), schedule="sync", retention=2)
    with ctx.commit(step, meta=meta) as txn:
        txn.store_all(_to_port(state))
    return ctx


def _commit_ref(path, state, step, meta):
    ctx = ref_open_cxl0(str(path), schedule="sync", retention=2)
    with ctx.commit(step, meta=meta) as txn:
        txn.store_all({k: v for k, v in state.items()})
    return ctx


def test_reference_recovers_a_pool_the_port_committed(tmp_path):
    s1, s2 = _state(0), _state(1)
    _commit_port(tmp_path, s1, 3, {"tag": "first"})
    _commit_port(tmp_path, s2, 7, {"tag": "second"})
    objs, step, source = RefRecovery(RefPool(str(tmp_path))).recover(
        _templates(s2))
    assert (step, source) == (7, "pool")
    _assert_tree_bits(objs, s2)


def test_port_recovers_a_pool_the_reference_committed(tmp_path):
    s1, s2 = _state(2), _state(3)
    _commit_ref(tmp_path, s1, 1, {"tag": "a"})
    _commit_ref(tmp_path, s2, 2, {"tag": "b"})
    objs, step, source = RecoveryManager(DSMPool(str(tmp_path))).recover(
        _templates(s2))
    assert (step, source) == (2, "pool")
    _assert_tree_bits(objs, s2)


def test_manifest_documents_equal_for_equal_objects_and_meta(tmp_path):
    meta = {"kind": "serve", "sessions": {"r0": {"emitted": [1, 2]}}}
    for step in (0, 4):
        _commit_port(tmp_path / "ours", _state(step), step, meta)
        _commit_ref(tmp_path / "ref", _state(step), step, meta)
    for fn in ("manifest.json", "manifest.0.json", "manifest.1.json"):
        a = (tmp_path / "ours" / fn).read_bytes()
        b = (tmp_path / "ref" / fn).read_bytes()
        assert a == b, fn
    assert json.loads(a)["objects"]["params"]["crc"] != 0
    for root, _, files in os.walk(tmp_path / "ref" / "objects"):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), tmp_path / "ref")
            assert (tmp_path / "ours" / rel).read_bytes() == \
                (tmp_path / "ref" / rel).read_bytes(), rel


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_recover_latest_equals_reference(tmp_path, writer):
    commit = _commit_port if writer == "port" else _commit_ref
    commit(tmp_path, _state(6), 1, {"tag": "old"})
    ctx = commit(tmp_path, _state(7), 5, {"tag": "new"})
    # tear the newest commit: both fall back to step 1
    entry = ctx.pool.latest_manifest()["objects"]["opt"]
    path = ctx.pool.payload_path("opt", entry["version"])
    data = bytearray(open(path, "rb").read())
    data[-5] ^= 0x01
    open(path, "wb").write(bytes(data))
    state = _state(6)

    def template_for(name, entry):
        return state[name]

    objs, m = RecoveryManager(DSMPool(str(tmp_path))).recover_latest(
        template_for)
    ref_objs, ref_m = RefRecovery(RefPool(str(tmp_path))).recover_latest(
        template_for)
    assert m == ref_m and (m["step"], m["meta"]) == (1, {"tag": "old"})
    _assert_tree_bits(objs, ref_objs)
    _assert_tree_bits(objs, state)


def test_torn_object_falls_back_to_previous_manifest(tmp_path):
    s1, s2 = _state(4), _state(5)
    _commit_port(tmp_path, s1, 1, None)
    ctx = _commit_port(tmp_path, s2, 2, None)
    entry = ctx.pool.latest_manifest()["objects"]["params"]
    path = ctx.pool.payload_path("params", entry["version"])
    data = bytearray(open(path, "rb").read())
    data[-30] ^= 0x40                                  # flip a payload bit
    open(path, "wb").write(bytes(data))
    objs, step, _ = ctx.recover(_templates(s1))
    assert step == 1
    _assert_tree_bits(objs, s1)


def test_exception_inside_commit_region_publishes_nothing(tmp_path):
    ctx = open_cxl0(str(tmp_path), schedule="sync")
    with pytest.raises(ColdStartError):
        ctx.recover({"x": [0]})
    with pytest.raises(RuntimeError):
        with ctx.commit(0) as txn:
            txn.store("x", [torch.ones(3)])
            raise RuntimeError("crash inside the region")
    assert "x" not in ctx.tiers.hbm
    assert ctx.pool.latest_manifest() is None
    ctx.crash()
    assert ctx.try_recover({"x": [0]}) is None


def test_unported_knobs_raise_naming_the_reference(tmp_path):
    from repro_torch.dsm.placement import PlacementPolicy
    from repro_torch.launch.mesh import parse_mesh
    ctx = open_cxl0(str(tmp_path))
    # mesh= is ported: the mesh reaches the committer, whose sharded
    # flushes then run device-local
    mesh = parse_mesh("2x4", device="cpu")
    assert CXL0Config(path=str(tmp_path), mesh=mesh).mesh is mesh
    meshed = open_cxl0(str(tmp_path / "m"), mesh=mesh)
    assert meshed.committer.mesh is mesh and meshed.committer._device_local
    assert not ctx.committer._device_local
    # the peer-staging wiring is ported: recovery sources and the RStore
    # target reach the context and its committer
    wired = open_cxl0(str(tmp_path / "w"), 2, peers=(ctx,),
                      replicate_to=ctx)
    assert wired.peers == (ctx,) and wired.committer.replicate_to is ctx
    assert wired.worker_id == 2
    wired.close()
    # ported: "auto" (resolved by a policy, or the default without one),
    # a topology (builds the policy) and an explicit policy
    policy = PlacementPolicy("cxl30-fabric")
    for kw, mode, topo in (
            ({"schedule": "auto"}, "sharded-async", None),
            ({"topology": "cxl20-switched-pool"}, "sync",
             "cxl20-switched-pool"),
            ({"placement": policy, "schedule": "auto"}, "auto",
             "cxl30-fabric")):
        opened = open_cxl0(str(tmp_path), **kw)
        assert opened.committer.mode == mode
        assert (opened.placement and opened.placement.topology.name) == topo
        opened.close()
    h = ctx.durable("x", init=[torch.ones(2)])      # handles are ported
    assert (h.mstore([torch.zeros(2)]).version, h.version) == (2, 2)


def test_d2h_counter_counts_only_device_leaves(tmp_path):
    ctx = open_cxl0(str(tmp_path), schedule="sync")
    ctx.put({"host": [torch.ones(4), np.zeros(3, np.float32)]})
    with ctx.commit(0):
        pass
    assert ctx.tiers.d2h_gather_bytes == 0     # host leaves: no copy
    if torch.cuda.is_available():
        ctx.put({"dev": [torch.ones(4, device="cuda")]})
        with ctx.commit(1):
            pass
        assert ctx.tiers.d2h_gather_bytes == 16
