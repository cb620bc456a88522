"""The port's fault layer (``repro_torch.dsm.faults``) against the JAX
package's ``repro.dsm.faults``.

* the reference's fault-primitive tests (``tests/test_fuzz.py``) on the
  port: the injector fires once at the exact index and ignores other
  workers, ``KillSpec`` validates its addressing mode, the ``FaultyPool``
  ledger matches its spec, a schedule survives the JSON round trip, torn
  decisions hash identity and not call order;
* across packages: one ``FaultSchedule`` JSON drives both injectors (the
  same call sequence) to the same ``fired`` list and the same raise
  points; every torn / straggler decision is the reference's; a
  ``FaultyPool`` of each package given the same writes corrupts the same
  ``(name, version, mode)`` set and leaves byte-equal files, for plain
  and split-phase (sharded pipeline) writes;
* ``attach_faults`` on a port context counts the primitives the
  reference's counts for the same program, under all four schedules.
"""
import json
import os

import numpy as np
import pytest

from repro.dsm import faults as ref_faults
from repro.dsm.api import open_cxl0 as ref_open_cxl0
from repro_torch.dsm import faults
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.faults import (FaultInjector, FaultSchedule, FaultyPool,
                                    InjectedCrash, KillSpec, StragglerSpec,
                                    TornSpec)
from repro_torch.dsm.flit_runtime import COMMIT_MODES
from repro_torch.dsm.recovery import CrashError


# ---------------------------------------------------------------------------
# the reference's fault-primitive tests, on the port
# ---------------------------------------------------------------------------

def test_injector_fires_at_exact_index_once():
    sched = FaultSchedule(kills=(
        KillSpec(worker=0, op="lstore", index=2, phase="before"),))
    inj = FaultInjector(sched, worker=0)
    inj.begin("lstore", "a")
    inj.begin("lstore", "b")
    with pytest.raises(InjectedCrash) as ei:
        inj.begin("lstore", "c")
    assert (ei.value.op, ei.value.index) == ("lstore", 2)
    assert isinstance(ei.value, CrashError)
    # the spec is spent: the next incarnation's calls pass through
    for _ in range(5):
        inj.begin("lstore", "d")
    assert inj.counts["lstore"] == 8


def test_injector_ignores_other_workers():
    sched = FaultSchedule(kills=(
        KillSpec(worker=1, op="rflush", index=0, phase="before"),))
    inj0 = FaultInjector(sched, worker=0)
    inj0.begin("rflush", "x")           # not our kill
    inj1 = FaultInjector(sched, worker=1)
    with pytest.raises(InjectedCrash):
        inj1.begin("rflush", "x")


def test_killspec_validates_addressing_mode():
    with pytest.raises(ValueError):
        KillSpec(worker=0)                          # neither op nor point
    with pytest.raises(ValueError):
        KillSpec(worker=0, op="rflush", point="pre_flush")   # both
    with pytest.raises(ValueError):
        KillSpec(worker=0, op="warp")
    with pytest.raises(ValueError):
        KillSpec(worker=0, point="nowhere")
    with pytest.raises(ValueError):
        KillSpec(worker=0, op="rflush", phase="during")
    KillSpec(worker=3, point="join_adopted", at_step=2)   # a join point


def test_faulty_pool_ledger_matches_spec(tmp_path):
    spec = TornSpec(rate=0.5, salt=3)
    pool = FaultyPool(str(tmp_path), torn=spec)
    for v in range(1, 9):
        pool.write_object("t", v, {"a": np.arange(4.0) * v})
    expected = [("t", v, spec.decide("t", v)) for v in range(1, 9)
                if spec.decide("t", v) is not None]
    assert expected and pool.injected == expected
    # every torn payload is rejected by the read path
    from repro_torch.dsm.pool import CorruptObjectError
    for _, v, _ in expected:
        with pytest.raises(CorruptObjectError):
            pool.read_object("t", v, {"a": np.zeros(4)})


def test_schedule_json_round_trip():
    sched = FaultSchedule(
        kills=(KillSpec(worker=1, op="rflush", index=4, phase="after"),
               KillSpec(worker=0, point="mid_flush", at_step=3)),
        torn=TornSpec(rate=0.1, salt=5, modes=("bitflip",)),
        straggler=StragglerSpec(rate=0.2, salt=6))
    assert FaultSchedule.from_dict(
        json.loads(json.dumps(sched.to_dict()))) == sched


def test_torn_decisions_hash_identity_not_call_order():
    spec = TornSpec(rate=0.2, salt=123)
    first = [spec.decide(f"t{i}", v) for i in range(6) for v in range(6)]
    second = [spec.decide(f"t{i}", v)
              for i in reversed(range(6)) for v in reversed(range(6))]
    assert first == second[::-1]
    assert any(m is not None for m in first), "rate=0.2 over 36 draws"
    assert StragglerSpec(rate=0.5, salt=9).perturb(3, "rflush", "x") == \
        StragglerSpec(rate=0.5, salt=9).perturb(3, "rflush", "x")


def test_force_corrupt_and_unknown_modes(tmp_path):
    pool = FaultyPool(str(tmp_path))
    with pytest.raises(ValueError):
        pool.force_corrupt("x", 1, "melt")
    pool.force_corrupt("x", 1, "zero")
    pool.write_object("x", 1, {"a": np.ones(16, np.float32)})
    pool.write_object("x", 2, {"a": np.ones(16, np.float32)})
    assert pool.injected == [("x", 1, "zero")]
    with pytest.raises(ValueError):
        faults.corrupt_file(pool.payload_path("x", 2), "melt")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_decisions_equal_the_references():
    for salt in (0, 7, 123456):
        t, rt = TornSpec(0.3, salt), ref_faults.TornSpec(0.3, salt)
        s = StragglerSpec(0.4, 6.0, salt=salt)
        rs = ref_faults.StragglerSpec(0.4, 6.0, salt=salt)
        for v in range(20):
            assert t.decide(f"w1/t{v % 3}.s1", v) == \
                rt.decide(f"w1/t{v % 3}.s1", v)
            assert s.perturb(v, "rflush", f"n{v}") == \
                rs.perturb(v, "rflush", f"n{v}")
    assert (faults.JOIN_POINTS, faults.PRIMITIVES, faults.TORN_MODES) == \
        (ref_faults.JOIN_POINTS, ref_faults.PRIMITIVES,
         ref_faults.TORN_MODES)


def _drive(inj, calls):
    """Feed one call sequence through an injector; record where it died."""
    died = []
    for kind, arg in calls:
        try:
            if kind == "window":
                inj.window(*arg)
            else:
                my, g = inj.begin(kind, arg)
                inj.end(kind, arg, my, g)
        except (CrashError, ref_faults.InjectedCrash) as e:
            died.append((e.op, e.index, e.phase))
    return died


@pytest.mark.parametrize("seed", range(6))
def test_one_schedule_json_drives_both_injectors_alike(seed):
    rng = np.random.default_rng(seed)
    kills = []
    for _ in range(3):
        if rng.random() < 0.3:
            kills.append({"worker": int(rng.integers(0, 2)), "op": None,
                          "index": 0, "phase": "before",
                          "point": str(rng.choice(["pre_flush", "mid_flush",
                                                   "post_completeOp"])),
                          "at_step": int(rng.integers(0, 6))})
        else:
            kills.append({"worker": int(rng.integers(0, 2)),
                          "op": str(rng.choice(["any", "lstore", "rflush",
                                                "completeOp"])),
                          "index": int(rng.integers(0, 12)),
                          "phase": str(rng.choice(["before", "after"])),
                          "point": None, "at_step": 0})
    doc = json.dumps({"kills": kills, "torn": None, "straggler": None})
    calls = []
    for step in range(6):
        calls += [("lstore", f"t{j}") for j in range(3)]
        calls.append(("window", ("pre_flush", step)))
        calls += [("rflush", f"t{j}") for j in range(3)]
        calls.append(("window", ("mid_flush", step)))
        calls.append(("completeOp", f"manifest@{step}"))
        calls.append(("window", ("post_completeOp", step)))
    for worker in (0, 1):
        ours = FaultInjector(FaultSchedule.from_dict(json.loads(doc)),
                             worker=worker)
        ref = ref_faults.FaultInjector(
            ref_faults.FaultSchedule.from_dict(json.loads(doc)),
            worker=worker)
        assert _drive(ours, calls) == _drive(ref, calls)
        assert ours.fired == ref.fired
        assert (ours.counts, ours.total) == (ref.counts, ref.total)


def _write_all(pool, split_phase: bool):
    rng = np.random.default_rng(0)
    for v in range(1, 13):
        tree = {"a": rng.standard_normal((64,)).astype(np.float32),
                "b": np.arange(v, dtype=np.int64)}
        for name in ("params", "w1/opt.s0", "kv/3/b0"):
            if split_phase:
                pool.start_write(name, v, tree).finish()
            else:
                pool.write_object(name, v, tree)


@pytest.mark.parametrize("split_phase", [False, True])
def test_faulty_pools_of_both_packages_tear_the_same_files(tmp_path,
                                                           split_phase):
    spec = dict(rate=0.35, salt=42)
    ours = FaultyPool(str(tmp_path / "port"), torn=TornSpec(**spec))
    ref = ref_faults.FaultyPool(str(tmp_path / "ref"),
                                torn=ref_faults.TornSpec(**spec))
    _write_all(ours, split_phase)
    _write_all(ref, split_phase)
    assert ours.injected == ref.injected
    assert {m for _, _, m in ours.injected} == set(faults.TORN_MODES)
    files = 0
    for root, _, names in os.walk(tmp_path / "port" / "objects"):
        for fn in names:
            p = os.path.join(root, fn)
            q = p.replace(str(tmp_path / "port"), str(tmp_path / "ref"))
            with open(p, "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read(), p
            files += 1
    assert files == 36


def _program(ctx):
    for step in range(6):
        ctx.put({"a": {"x": np.full((8,), step, np.float32)},
                 "b": {"y": np.arange(4, dtype=np.int64) + step}}, step=step)
        if step % 2 == 1:
            with ctx.commit(step):
                pass
    ctx.drain()


@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_attach_faults_counts_what_the_reference_counts(tmp_path, mode):
    counts = {}
    for pkg, (open_, mod) in {"port": (open_cxl0, faults),
                              "ref": (ref_open_cxl0, ref_faults)}.items():
        inj = mod.FaultInjector(mod.FaultSchedule(), worker=0)
        ctx = open_(str(tmp_path / pkg), 0, schedule=mode, n_shards=2,
                    fault_hook=inj.window)
        mod.attach_faults(ctx, inj)
        _program(ctx)
        ctx.close()
        counts[pkg] = (dict(inj.counts), inj.total, inj.last_window)
    assert counts["port"] == counts["ref"]
    assert counts["port"][0]["completeOp"] == 3


def test_a_primitive_kill_lands_where_the_references_does(tmp_path):
    """The same schedule on the same program: both contexts die at the
    same op with the same completed manifests on disk."""
    sched = {"kills": [{"worker": 0, "op": "rflush", "index": 3,
                        "phase": "after", "point": None, "at_step": 0}],
             "torn": None, "straggler": None}
    out = {}
    for pkg, (open_, mod) in {"port": (open_cxl0, faults),
                              "ref": (ref_open_cxl0, ref_faults)}.items():
        inj = mod.FaultInjector(mod.FaultSchedule.from_dict(sched))
        ctx = open_(str(tmp_path / pkg), 0, schedule="sync",
                    fault_hook=inj.window)
        mod.attach_faults(ctx, inj)
        with pytest.raises(Exception) as ei:
            _program(ctx)
        assert type(ei.value).__name__ == "InjectedCrash"
        ctx.crash()
        ctx.close()
        out[pkg] = (inj.fired, sorted(m["step"] for m in
                                      ctx.pool.manifests_desc()))
    assert out["port"] == out["ref"]
