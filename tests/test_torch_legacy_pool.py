"""The legacy object and staging formats in the port
(``DSMPool.write_object_legacy`` and its ``.npz`` reader,
``FileStagingArea(legacy_format=True)``, the fault layer's zip walk)
against the JAX package's.

* the twins of ``tests/test_stream_format.py:194-260``: a legacy write's
  CRC and byte count equal the streamed write's for the same tree; the
  pool reads legacy objects, CRC-validated, and recovers from them; one
  manifest may mix a legacy and a streamed object; a staging view reads a
  legacy spill;
* the twin of ``tests/test_pool_torn_write.py:37``: every torn mode
  (``truncate``, ``bitflip``, ``zero``) of ``corrupt_file`` is detected on
  a legacy ``.npz`` object, and on a legacy spill the view drops it;
* across packages, both ways, with bf16 (``ml_dtypes`` on the reference's
  side, ``torch.bfloat16`` on the port's), 0-d and empty leaves: each
  package reads the other's legacy objects and spills with equal leaves;
  the sidecars' ``crc``, ``n``, ``dtypes``, ``shapes`` and ``treedef``
  strings are equal (the ``.npz`` files themselves are not byte-equal:
  ``np.savez`` stamps each zip member with the time);
* the ``FaultyPool`` of each package tears the same legacy payloads.
"""
import collections
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dsm.cluster import FileStagingArea as RefArea
from repro.dsm.faults import FaultyPool as RefFaultyPool
from repro.dsm.pool import DSMPool as RefPool
from repro_torch.dsm.cluster import FileStagingArea
from repro_torch.dsm.faults import TORN_MODES, FaultyPool, corrupt_file
from repro_torch.dsm.pool import CorruptObjectError, DSMPool
from repro_torch.dsm.recovery import RecoveryManager
from repro_torch.utils.convert import from_numpy, raw_numpy
from repro_torch.utils.tree import tree_leaves

KV = collections.namedtuple("KVCache", "k v")


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
            "bool": rng.integers(0, 2, (2, 2)).astype(bool),
            "f64": np.asarray(1.5, np.float64),
            "empty": np.zeros((0, 3), np.float32),
            "kv": KV(rng.standard_normal((2, 4)).astype(ml_dtypes.bfloat16),
                     rng.standard_normal((4,)).astype(ml_dtypes.bfloat16))}


def _torch_tree(tree):
    return {k: (KV(*[from_numpy(x) for x in v]) if isinstance(v, KV)
                else from_numpy(v)) for k, v in tree.items()}


def _bits(leaves):
    return [(raw_numpy(a)[1], raw_numpy(a)[0].shape,
             raw_numpy(a)[0].tobytes()) for a in leaves]


def _sidecar(pool_dir, name, version):
    with open(os.path.join(pool_dir, "objects", name,
                           f"{version:08d}.crc")) as f:
        return json.load(f)


# -- the reference's stream-format cases, on the port -------------------------

def test_pool_crc_identical_across_formats(tmp_path):
    pool = DSMPool(str(tmp_path))
    tree = {"a": torch.arange(100, dtype=torch.float32),
            "b": {"c": torch.tensor(1.5, dtype=torch.float64)}}
    new = pool.write_object("x", 1, tree)
    old = pool.write_object_legacy("y", 1, tree)
    assert new.crc == old.crc
    assert new.nbytes == old.nbytes


def test_pool_reads_legacy_npz_objects(tmp_path):
    pool = DSMPool(str(tmp_path))
    tree = {"a": torch.arange(50, dtype=torch.float32)}
    obj = pool.write_object_legacy("t", 1, tree)
    assert os.path.basename(pool.payload_path("t", 1)).endswith(".npz")
    got = pool.read_object("t", 1, tree, expected_crc=obj.crc)
    assert torch.equal(got["a"], tree["a"])
    with pytest.raises(CorruptObjectError, match="does not match"):
        pool.read_object("t", 1, tree, expected_crc=obj.crc ^ 1)
    pool.commit_manifest(0, {"t": obj})
    objs, step, src = RecoveryManager(pool).recover({"t": tree})
    assert (step, src) == (0, "pool")
    assert torch.equal(objs["t"]["a"], tree["a"])


def test_mixed_format_manifest_recovers(tmp_path):
    pool = DSMPool(str(tmp_path))
    t1 = {"a": torch.arange(10, dtype=torch.float32)}
    t2 = {"b": torch.arange(20, dtype=torch.int32)}
    o1 = pool.write_object_legacy("old", 1, t1)
    o2 = pool.write_object("new", 1, t2)
    pool.commit_manifest(0, {"old": o1, "new": o2})
    objs, step, src = RecoveryManager(pool).recover({"old": t1, "new": t2})
    assert (step, src) == (0, "pool")
    assert torch.equal(objs["old"]["a"], t1["a"])
    assert torch.equal(objs["new"]["b"], t2["b"])


def test_staging_reads_legacy_spills(tmp_path):
    tree = {"w": torch.full((4, 4), 2.5)}
    legacy = FileStagingArea(str(tmp_path / "s"), legacy_format=True)
    legacy.proxy(1).staging["w0/t"] = (9, tree)
    assert legacy.payload_path(1, "w0/t").endswith(".npz")
    # a fresh, default-format handle on the same root reads it
    view = FileStagingArea(str(tmp_path / "s")).view(1, {"w0/t": tree})
    tag, got = view.staging["w0/t"]
    assert tag == 9 and torch.equal(got["w"], tree["w"])


# -- torn legacy payloads -------------------------------------------------------

@pytest.mark.parametrize("mode", TORN_MODES)
def test_each_torn_mode_is_detected_legacy(tmp_path, mode):
    pool = DSMPool(str(tmp_path))
    tree = {"w": torch.full((6, 6), 1.0),
            "b": torch.arange(6, dtype=torch.float32) + 1.0}
    pool.write_object_legacy("t", 1, tree)
    corrupt_file(pool.payload_path("t", 1), mode)
    with pytest.raises(CorruptObjectError):
        pool.read_object("t", 1, tree)


@pytest.mark.parametrize("mode", TORN_MODES)
def test_a_torn_legacy_spill_reads_back_as_absent(tmp_path, mode):
    area = FileStagingArea(str(tmp_path / "s"), legacy_format=True)
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    area.proxy(0).staging["t"] = (3, tree)
    assert area.view(0, {"t": tree}).staging
    corrupt_file(area.payload_path(0, "t"), mode)
    assert area.view(0, {"t": tree}).staging == {}


def test_faulty_pools_of_both_packages_tear_the_same_legacy_files(tmp_path):
    tree = _np_tree(3)
    ours = FaultyPool(str(tmp_path / "p"))
    theirs = RefFaultyPool(str(tmp_path / "r"))
    for p, t in ((ours, _torch_tree(tree)), (theirs, tree)):
        for v, mode in enumerate(TORN_MODES, 1):
            p.force_corrupt("t", v, mode)
            p.write_object_legacy("t", v, t)
    assert ours.injected == theirs.injected == [
        ("t", v, m) for v, m in enumerate(TORN_MODES, 1)]
    for v in range(1, len(TORN_MODES) + 1):
        with pytest.raises(CorruptObjectError):
            DSMPool(str(tmp_path / "r")).read_object("t", v, tree)


# -- across packages ----------------------------------------------------------

def test_sidecars_equal_the_references(tmp_path):
    tree = _np_tree()
    ro = RefPool(str(tmp_path / "r")).write_object_legacy("x", 1, tree)
    po = DSMPool(str(tmp_path / "p")).write_object_legacy(
        "x", 1, _torch_tree(tree))
    assert (po.crc, po.nbytes) == (ro.crc, ro.nbytes)
    assert _sidecar(str(tmp_path / "p"), "x", 1) == \
        _sidecar(str(tmp_path / "r"), "x", 1)
    # and the streamed write of the same tree has the same CRC
    assert DSMPool(str(tmp_path / "s")).write_object(
        "x", 1, _torch_tree(tree)).crc == ro.crc


def test_port_reads_the_references_legacy_objects(tmp_path):
    tree = _np_tree(1)
    ro = RefPool(str(tmp_path)).write_object_legacy("x", 4, tree)
    got = DSMPool(str(tmp_path)).read_object("x", 4, _torch_tree(tree),
                                             expected_crc=ro.crc)
    assert got["kv"].k.dtype == torch.bfloat16
    assert got["f64"].shape == () and got["empty"].shape == (0, 3)
    assert _bits(tree_leaves(got)) == _bits(tree_leaves(tree))


def test_reference_reads_the_ports_legacy_objects(tmp_path):
    tree = _np_tree(2)
    po = DSMPool(str(tmp_path)).write_object_legacy("x", 4,
                                                    _torch_tree(tree))
    got = RefPool(str(tmp_path)).read_object("x", 4, tree,
                                             expected_crc=po.crc)
    assert got["kv"].k.dtype == ml_dtypes.bfloat16
    assert _bits(tree_leaves(got)) == _bits(tree_leaves(tree))


def test_legacy_spills_cross_packages_both_ways(tmp_path):
    tree = _np_tree(4)
    RefArea(str(tmp_path / "r"), legacy_format=True).proxy(1).staging[
        "w0/params"] = (7, tree)
    tag, got = FileStagingArea(str(tmp_path / "r")).view(
        1, {"w0/params": tree}).staging["w0/params"]
    assert tag == 7 and _bits(tree_leaves(got)) == _bits(tree_leaves(tree))
    FileStagingArea(str(tmp_path / "p"), legacy_format=True).proxy(1).staging[
        "w0/params"] = (8, _torch_tree(tree))
    tag, got = RefArea(str(tmp_path / "p")).view(
        1, {"w0/params": tree}).staging["w0/params"]
    assert tag == 8 and _bits(tree_leaves(got)) == _bits(tree_leaves(tree))
    with open(os.path.join(tmp_path, "p", "w1", "w0__params.json")) as f:
        ours = json.load(f)
    with open(os.path.join(tmp_path, "r", "w1", "w0__params.json")) as f:
        theirs = json.load(f)
    assert {**ours, "tag": 0} == {**theirs, "tag": 0}
