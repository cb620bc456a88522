"""Peer staging in the port (``TierManager.rstore`` / ``rload``,
``dsm.cluster.FileStagingArea``, ``DurableHandle.rstore``) against the JAX
package's.

* a ``FileStagingArea`` entry — frame and meta — equals the reference's
  byte for byte for the same leaves (fp32, int32, bool, bf16, 0-d and
  empty), and each package's ``view`` reads the other's buffer;
* a torn frame, a meta whose CRC belongs to another payload and a
  missing meta all read back as absent; the reference's legacy ``.npz``
  entry reads back (the legacy format is ported:
  ``tests/test_torch_legacy_pool.py``);
* ``rstore`` into an in-process peer takes a host snapshot; into a
  spill-file proxy it hands the buffer its counted ``to_host``, one call
  a leaf; ``rload`` reads a staged copy back; ``crash()`` empties
  ``staging``;
* ``DurableHandle.rstore(peer)`` with a context as the peer, as
  ``tests/test_api.py::test_durable_handle_primitives`` does.
"""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dsm.api import open_cxl0 as ref_open_cxl0
from repro.dsm.cluster import FileStagingArea as RefArea
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.cluster import FileStagingArea, _mangle
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.tiers import TierManager
from repro_torch.utils.convert import from_numpy, raw_numpy
from repro_torch.utils.tree import tree_leaves


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"f32": rng.standard_normal((3, 5)).astype(np.float32),
            "i32": rng.integers(-9, 9, (7,)).astype(np.int32),
            "bool": rng.integers(0, 2, (2, 2)).astype(bool),
            "bf16": [rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
                     np.asarray(-1.25, ml_dtypes.bfloat16)],
            "f32_empty": np.zeros((0, 4), np.float32),
            "big": rng.standard_normal((300, 300)).astype(np.float32)}


def _torch_tree(t):
    return {k: ([from_numpy(x) for x in v] if isinstance(v, list)
                else from_numpy(v)) for k, v in t.items()}


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _bits(tree):
    return [raw_numpy(np.asarray(x) if not isinstance(x, torch.Tensor)
                      else x)[0].tobytes() for x in tree_leaves(tree)]


NAMES = ["kv/r0/b0", "e2/kv/r1/state", "plain"]


def test_staged_entries_equal_the_references_byte_for_byte(tmp_path):
    ours = FileStagingArea(str(tmp_path / "port"))
    theirs = RefArea(str(tmp_path / "ref"))
    for i, name in enumerate(NAMES):
        t = _np_tree(i)
        ours.proxy(2).staging[name] = (i + 5, _torch_tree(t))
        # the reference stages a jax array as it is, the port a tensor
        theirs.proxy(2).staging[name] = (i + 5, {**t, "f32": jnp.asarray(
            t["f32"])})
    a, b = _files(str(tmp_path / "port")), _files(str(tmp_path / "ref"))
    assert sorted(a) == sorted(b) == sorted(
        f"w2/{_mangle(n)}{ext}" for n in NAMES for ext in (".cxl0", ".json"))
    assert a == b
    assert "w2/kv__r0__b0.cxl0" in a


def test_each_package_reads_the_others_buffer(tmp_path):
    ours = FileStagingArea(str(tmp_path / "port"))
    theirs = RefArea(str(tmp_path / "ref"))
    t = _np_tree(3)
    ours.proxy(1).staging["x"] = (9, _torch_tree(t))
    theirs.proxy(1).staging["x"] = (9, t)
    tpl = {"x": _np_tree(3)}
    for area in (str(tmp_path / "port"), str(tmp_path / "ref")):
        got = FileStagingArea(area).view(1, tpl).staging["x"]
        rgot = RefArea(area).view(1, tpl).staging["x"]
        assert got[0] == rgot[0] == 9
        assert _bits(got[1]) == _bits(rgot[1]) == _bits(t)
        assert sorted(got[1]) == sorted(t)
    # only requested names are read; a name never staged is absent
    assert ours.view(1, {"y": t}).staging == {}


def _stage_two(area):
    area.proxy(0).staging["a"] = (1, [torch.arange(64, dtype=torch.int32)])
    area.proxy(0).staging["b"] = (1, [torch.ones(8)])
    return {"a": [0], "b": [0]}


def test_torn_or_mismatched_entries_read_back_as_absent(tmp_path):
    area = FileStagingArea(str(tmp_path / "s"))
    tpl = _stage_two(area)
    assert sorted(area.view(0, tpl).staging) == ["a", "b"]
    # a torn frame (truncated)
    path = os.path.join(area.area(0), "a.cxl0")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    assert sorted(area.view(0, tpl).staging) == ["b"]
    # a payload rewritten without its meta: the meta's CRC describes the
    # previous payload
    meta = os.path.join(area.area(0), "b.json")
    with open(meta) as f:
        old = f.read()
    area.proxy(0).staging["b"] = (2, [torch.zeros(8)])
    with open(meta, "w") as f:
        f.write(old)
    assert area.view(0, tpl).staging == {}
    # a missing meta is absent; the reference's legacy .npz entry reads
    # back in both packages
    os.unlink(meta)
    ref = RefArea(str(tmp_path / "legacy"), legacy_format=True)
    ref.proxy(0).staging["a"] = (1, [np.arange(4, dtype=np.int32)])
    assert RefArea(str(tmp_path / "legacy")).view(0, {"a": [0]}).staging
    tag, (got,) = FileStagingArea(str(tmp_path / "legacy")).view(
        0, {"a": [0]}).staging["a"]
    assert tag == 1 and torch.equal(got, torch.arange(4, dtype=torch.int32))
    # the owner's crash wipes its buffer
    area.wipe(0)
    assert not os.path.exists(area.area(0))
    assert area.view(0, tpl).staging == {}


def test_rstore_rload_and_crash_empties_staging(tmp_path):
    tiers = TierManager(DSMPool(str(tmp_path / "a")))
    peer = TierManager(DSMPool(str(tmp_path / "b")))
    x = torch.arange(6, dtype=torch.float32)
    tiers.lstore("obj", {"x": x})
    tiers.rstore("obj", peer)                 # tag defaults to the version
    tag, staged = peer.staging["obj"]
    assert tag == tiers.versions["obj"] == 1
    assert torch.equal(peer.rload("obj")["x"], x)
    assert peer.rload("absent") is None
    tiers.rstore("obj", peer, tag=41)
    assert peer.staging["obj"][0] == 41
    assert tiers.d2h_gather_bytes == 0        # host leaves: nothing copied
    tiers.crash()                             # OUR crash: the peer keeps it
    assert peer.rload("obj") is not None and tiers.staging == {}
    peer.crash()                              # the peer's crash loses it
    assert peer.staging == {} and peer.rload("obj") is None


def test_rstore_into_a_spill_file_proxy_copies_each_leaf_through_to_host(
        tmp_path):
    tiers = TierManager(DSMPool(str(tmp_path / "a")))
    area = FileStagingArea(str(tmp_path / "staging"))
    calls = []
    plain = tiers.to_host

    def spy(leaf):
        calls.append(tuple(leaf.shape))
        return plain(leaf)
    tiers.to_host = spy
    tree = [torch.ones(3, 4), torch.zeros(5, dtype=torch.int64)]
    tiers.lstore("kv/r0/b1", tree)
    tiers.rstore("kv/r0/b1", area.proxy(4), tag=12)
    assert calls == [(3, 4), (5,)]            # one counted copy a leaf
    got = area.view(4, {"kv/r0/b1": [0, 0]}).staging["kv/r0/b1"]
    assert got[0] == 12 and _bits(got[1]) == _bits(tree)


def test_durable_handle_rstores_into_a_context_peer(tmp_path):
    for opener, root in ((open_cxl0, "port"), (ref_open_cxl0, "ref")):
        ctx = opener(str(tmp_path / root / "a"), schedule="sync")
        peer = opener(str(tmp_path / root / "b"), schedule="sync")
        h = ctx.durable("obj", init={"v": np.zeros(2, np.float32)})
        assert h.version == 1
        obj = h.mstore({"v": np.full(2, 3.0, np.float32)})
        assert (obj.version, h.version) == (2, 2)
        h.rstore(peer, tag=7)                     # a context IS a peer
        assert peer.staging["obj"][0] == 7
        assert np.array_equal(np.asarray(peer.staging["obj"][1]["v"]),
                              np.full(2, 3.0, np.float32))
        with pytest.raises(ValueError, match="no peer"):
            ctx.durable("other",
                        init={"v": np.zeros(1, np.float32)}).rstore()
