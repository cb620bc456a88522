"""The paper's API in the port's runtime: durable object handles
(``ctx.durable``) and the §6 FliT-for-CXL0 transformation
(``ctx.transform``), against the reference's ``repro.dsm.api``.

* a handle's ``lstore`` / ``rflush`` / ``mstore`` / ``value`` /
  ``version``, and ``rstore`` refused (peer staging is not ported);
* a transformed counter, stack (tuple states) and KV map keep every
  acknowledged op across a crash;
* the same ops give the same pool as the reference's, file for file and
  byte for byte (frames and manifests);
* each package recovers — and goes on with — the other's object.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import objects as ref_objects
from repro.dsm.api import open_cxl0 as ref_open_cxl0
from repro_torch.core import objects
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.pool import DSMPool

#: per spec: its name, the ops to apply, and the state after all of them
OPS = {
    "CounterSpec": ([("inc",)] * 6 + [("read",)], 6),
    "StackSpec": ([("push", 3), ("push", 1), ("pop",), ("push", 4),
                   ("push", 1), ("pop",), ("push", 5)], (3, 4, 5)),
    "KVSpec": ([("put", 0, 7), ("put", 2, 9), ("get", 0), ("put", 0, 8),
                ("get", 3), ("put", 1, 1)], (8, 1, 9, 0)),
}


def _spec(mod, name):
    return getattr(mod, name)(4) if name == "KVSpec" else \
        getattr(mod, name)()


def _files(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_durable_handle_primitives(tmp_path):
    ctx = open_cxl0(str(tmp_path), schedule="sync")
    h = ctx.durable("w", init={"a": torch.arange(4, dtype=torch.float32)})
    assert h.version == 1 and torch.equal(h.value["a"], torch.arange(4.))
    obj = h.rflush()                                     # durable write
    assert (obj.name, obj.version) == ("w", 1)
    h.lstore({"a": torch.ones(4)})                       # volatile only
    assert h.version == 2 and torch.equal(h.value["a"], torch.ones(4))
    obj2 = h.mstore({"a": torch.full((4,), 2.0)})        # lstore + rflush
    assert obj2.version == 3
    assert ctx.durable("w", init={"a": torch.zeros(4)}).version == 3
    for v, want in ((1, torch.arange(4.)), (3, torch.full((4,), 2.0))):
        got = ctx.pool.read_object("w", v, {"a": 0})
        assert torch.equal(got["a"], want)
    assert ctx.tiers.flit_counter["w"] == 0              # no flush in flight
    with pytest.raises(ValueError, match="no peer"):
        h.rstore()
    with pytest.raises(NotImplementedError,
                       match="repro.dsm.tiers.TierManager.rstore"):
        h.rstore(peer=object())
    ctx.crash()
    assert ctx.durable("w").value is None                # HBM tier is gone


def test_durable_handle_pool_equals_reference(tmp_path):
    """The handle writes the same object files as the reference's."""
    for opener, root in ((open_cxl0, "ours"), (ref_open_cxl0, "ref")):
        ctx = opener(str(tmp_path / root), schedule="sync")
        h = ctx.durable("w", init=[np.arange(6, dtype=np.int32)])
        h.rflush()
        h.mstore([np.full(3, 2.5, np.float32)])
        assert h.version == 2
    assert _files(tmp_path / "ours") == _files(tmp_path / "ref")


@pytest.mark.parametrize("spec", list(OPS))
def test_transformed_object_survives_a_crash(tmp_path, spec):
    ops, final = OPS[spec]
    ctx = open_cxl0(str(tmp_path), schedule="sync")
    obj = ctx.transform(_spec(objects, spec), name="obj")
    assert obj.recovered_from is None and obj.ops_done == -1
    results, states = [], []
    for op in ops:
        results.append(obj.op(*op))
        states.append(obj.state)
    assert obj.state == final and obj.ops_done == len(ops) - 1
    ctx.crash()                          # every op above was acknowledged
    again = open_cxl0(str(tmp_path), schedule="sync").transform(
        _spec(objects, spec), name="obj")
    assert again.state == final and type(again.state) is type(final)
    assert again.recovered_from == (len(ops) - 1, "pool")
    # the sequential spec's own answers, op by op
    state = _spec(objects, spec).initial()
    for op, got, st in zip(ops, results, states):
        state, want = _spec(objects, spec).apply(state, op[0], op[1:])
        assert (got, st) == (want, state)


def test_a_crash_mid_op_is_invisible(tmp_path):
    """An op whose completeOp never ran is not in the recovered state."""
    ctx = open_cxl0(str(tmp_path), schedule="sync")
    c = ctx.transform(objects.CounterSpec(), name="c")
    for _ in range(3):
        c.op("inc")
    ctx.tiers.lstore("c", {"state": np.frombuffer(b"99", np.uint8).copy()})
    ctx.tiers.rflush("c")                 # LStore + RFlush, no completeOp
    ctx.crash()
    again = open_cxl0(str(tmp_path)).transform(objects.CounterSpec(),
                                               name="c")
    assert (again.state, again.ops_done) == (3, 2)


@pytest.mark.parametrize("spec", list(OPS))
def test_transformed_pool_equals_reference_byte_for_byte(tmp_path, spec):
    ops, _ = OPS[spec]
    ours = open_cxl0(str(tmp_path / "ours"), schedule="sync").transform(
        _spec(objects, spec), name="obj")
    ref = ref_open_cxl0(str(tmp_path / "ref"), schedule="sync").transform(
        _spec(ref_objects, spec), name="obj")
    for op in ops:
        assert ours.op(*op) == ref.op(*op)
    a, b = _files(tmp_path / "ours"), _files(tmp_path / "ref")
    assert sorted(a) == sorted(b)
    assert any(n.startswith("manifest.") for n in a)
    for name in a:
        assert a[name] == b[name], name
    assert DSMPool(str(tmp_path / "ours")).latest_manifest()["meta"] == \
        {"kind": "flit-object", "object": "obj"}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("spec", list(OPS))
def test_each_package_recovers_the_others_object(tmp_path, spec, writer):
    ops, final = OPS[spec]
    half = len(ops) // 2
    first, second = (open_cxl0, ref_open_cxl0) if writer == "port" else \
        (ref_open_cxl0, open_cxl0)
    mods = (objects, ref_objects) if writer == "port" else \
        (ref_objects, objects)
    ctx = first(str(tmp_path), schedule="sync")
    obj = ctx.transform(_spec(mods[0], spec), name="obj")
    for op in ops[:half]:
        obj.op(*op)
    ctx.crash()
    other = second(str(tmp_path), schedule="sync").transform(
        _spec(mods[1], spec), name="obj")
    assert other.recovered_from == (half - 1, "pool")
    assert other.state == obj.state
    for op in ops[half:]:
        other.op(*op)
    back = first(str(tmp_path), schedule="sync").transform(
        _spec(mods[0], spec), name="obj")
    assert back.state == final and back.ops_done == len(ops) - 1
