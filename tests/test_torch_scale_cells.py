"""The port's scale scenario suite (``repro_torch.scenarios.scale`` and the
runner's ``--suite scale`` / ``--suite all``) against the JAX package's
``repro.scenarios.scale``, every rank and fleet on ``device="cpu"``.

* the straight 3-rank reference (6 steps, 4 tensors, a commit every 2,
  the sizes of ``tests/test_scale.py``): the port's digests equal the
  reference's bit for bit, and equal the port's planned shrink (rank 1
  leaves at step 4) at the same sizes — state updates do not depend on
  membership, which is what lets a caller hand a planned run's digests to
  the grow cells as ``ref_digests``;
* the four grow cells (no kill, and the joiner killed at each of the
  three join phases, joining at step 4): each is ``ok``, a killed joiner
  exits 17, and for ``none`` and ``join_committed`` the lives, gens and
  recovery sources equal the reference's; the ``none`` cell's cluster
  manifests (steps, metas with the partitions and the join record, and
  the object entries but at the last step) equal the reference's;
* the fleet grow-and-drain cell on the olmo-1b smoke config in fp32 with
  the reference's weights carried over (``models.params.from_reference``):
  ``grew``, ``drained``, ``migrations``, ``n_outputs`` and every token of
  both fleets equal the reference cell's;
* the autoscale cell on every topology preset: every field equal to the
  reference's and ``autoscale_decisions.jsonl`` byte-equal;
* the runner as a subprocess: ``--suite scale`` on ``--device cpu``
  prints the reference's three line kinds and ends ``runner,OK``;
  ``--suite all`` runs its suites in the reference's order.

The reference's rank processes run with ``XLA_FLAGS`` forcing ONE host
device, the count the port sees, so both packages partition alike.  The
module fixture starts every cluster of both packages at once, each rank
with one compute thread.
"""
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.registry import build as ref_build
from repro.scenarios import scale as ref_scale
from repro.serve import fleet as ref_fleet
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.emu import PRESETS
from repro_torch.dsm.faults import JOIN_POINTS
from repro_torch.dsm.pool import DSMPool
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.scenarios import scale
from repro_torch.scenarios.cluster import run_cluster_planned
from repro_torch.scenarios.worker import KILL_EXIT
from repro_torch.serve import fleet

ROOT = Path(__file__).resolve().parents[1]
SIZES = dict(steps=6, tensors=4)           # tests/test_scale.py:279-290
JOIN_AT = 4
POINTS = ("none",) + JOIN_POINTS
REF_POINTS = ("none", "join_committed")
FP32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cluster of both packages, started at once: the port's
    straight reference, planned shrink and four grow cells, the
    reference's straight reference and two grow cells.  The grow cells
    get a placeholder reference and are held to their package's straight
    run afterwards."""
    root = tmp_path_factory.mktemp("scale_cells")
    port_dir, ref_dir = str(root / "port"), str(root / "ref")
    jobs = {
        "straight": lambda: scale.straight_reference(
            port_dir, device="cpu", **SIZES),
        "planned": lambda: run_cluster_planned(
            str(root / "planned"), world=3, victim=1, shrink_at=JOIN_AT,
            commit_every=2, device="cpu", **SIZES),
        "ref_straight": lambda: ref_scale.straight_reference(
            ref_dir, **SIZES),
    }
    for p in POINTS:
        jobs[p] = (lambda p=p: scale.run_grow_scenario(
            p, port_dir, join_at=JOIN_AT, ref_digests={}, device="cpu",
            **SIZES))
    for p in REF_POINTS:
        jobs[f"ref_{p}"] = (lambda p=p: ref_scale.run_grow_scenario(
            p, ref_dir, join_at=JOIN_AT, ref_digests={}, **SIZES))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
        mp.setenv("OMP_NUM_THREADS", "1")
        with ThreadPoolExecutor(len(jobs)) as ex:
            futs = {k: ex.submit(fn) for k, fn in jobs.items()}
            out = {k: f.result() for k, f in futs.items()}
    for p in POINTS:
        out[p] = dataclasses.replace(out[p],
                                     reference_digests=out["straight"])
    for p in REF_POINTS:
        out[f"ref_{p}"] = dataclasses.replace(
            out[f"ref_{p}"], reference_digests=out["ref_straight"])
    out["port_dir"], out["ref_dir"] = port_dir, ref_dir
    return out


# -- the straight reference ----------------------------------------------------

def test_straight_reference_equals_the_references(cells):
    assert len(cells["straight"]) == SIZES["tensors"]
    assert cells["straight"] == cells["ref_straight"]


def test_straight_reference_equals_the_planned_shrink(cells):
    assert cells["straight"] == cells["planned"]


# -- the grow cells ------------------------------------------------------------

@pytest.mark.parametrize("point", POINTS)
def test_grow_cell_is_ok(cells, point):
    r = cells[point]
    assert r.ok, (r.detail, r.lives, r.sources)
    assert r.killed == (point != "none")
    assert set(r.lives) == {r.expected_live}
    assert r.digests == r.reference_digests
    if point == "none":
        assert r.gens == [1, 1, 1, 1]
        assert [c["rc"] for c in r.children] == [0, 0, 0, 0]
    else:
        joiner, *old = r.children
        assert joiner["rc"] == KILL_EXIT and joiner["result"]["killed"]
        assert (joiner["result"]["point"], joiner["result"]["rank"],
                joiner["result"]["step"]) == (point, 3, JOIN_AT - 1)
        assert [c["rc"] for c in old] == [0, 0, 0]


@pytest.mark.parametrize("point", REF_POINTS)
def test_grow_cell_matches_the_references(cells, point):
    ours, theirs = cells[point], cells[f"ref_{point}"]
    assert theirs.ok, (theirs.detail, theirs.lives)
    assert ours.killed == theirs.killed
    assert ours.lives == theirs.lives
    assert ours.gens == theirs.gens
    assert ours.sources == theirs.sources
    assert ours.digests == theirs.digests


def test_grown_joiner_adopts_its_partition_from_staging(cells):
    *old, joiner = cells["none"].children
    res = joiner["result"]
    assert joiner["role"] == "joiner rank 3" and joiner["rc"] == 0
    assert res["live"] == [0, 1, 2, 3] and res["gen"] == 1
    assert (res["source"], res["resumed_from"]) == ("peer-staging",
                                                     JOIN_AT - 1)
    # one of 4 tensors at world 4: p, mu and nu of 16 x 16 fp32
    assert res["recovered_bytes"] == 3 * 16 * 16 * 4
    assert res["recover_s"] > 0 and res["device"] == "cpu"
    for c in old:
        assert c["result"]["source"] is None
        assert c["result"]["live"] == [0, 1, 2, 3]


def _by_step(pool, last):
    """Cluster manifests by (gen, step): the meta, and the object entries
    of every step but the ``last`` (whose entries depend on which rank
    sees the cadence commit land before its final flush, in both
    packages)."""
    return {(m["meta"]["gen"], m["step"]):
            (m["meta"], m["step"] == last or
             {n: (e.get("version"), e.get("crc"), e.get("nbytes"))
              for n, e in m["objects"].items()})
            for m in DSMPool(pool).manifests_desc()}


def test_grown_cluster_manifests_equal_the_references(cells):
    last = SIZES["steps"] - 1
    mine = _by_step(os.path.join(cells["port_dir"], "scale_grow_none"), last)
    theirs = _by_step(os.path.join(cells["ref_dir"], "scale_grow_none"),
                      last)
    assert mine == theirs
    assert sorted(mine) == [(0, -1), (0, 1), (0, 3), (1, 3), (1, 5)]
    join = mine[(1, JOIN_AT - 1)][0]
    assert join["join"] == {"member": 3, "at_step": JOIN_AT}
    assert join["live"] == [0, 1, 2]
    assert sorted(set(join["next_partition"].values())) == [0, 1, 2, 3]


def test_grow_scenario_refuses_an_unknown_point(tmp_path):
    with pytest.raises(ValueError, match="unknown join point"):
        scale.run_grow_scenario("mid_flush", str(tmp_path), device="cpu")


# -- the fleet cell --------------------------------------------------------------

def _recording(cls, runs, **inject):
    """``cls`` with ``inject`` added to its keywords and every ``run``'s
    outputs appended to ``runs``."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **inject})

        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            runs.append(res.outputs)
            return res
    return Recording


def test_fleet_cell_equals_the_references(tmp_path, monkeypatch):
    t_max = 32                          # the reference cell's default
    rb = ref_build(ref_smoke_config("olmo-1b").with_(**FP32),
                   dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(get_smoke_config("olmo-1b").with_(**FP32), dec_pos_len=t_max,
              device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    ref_runs, port_runs = [], []
    monkeypatch.setattr(ref_fleet, "FleetController", _recording(
        ref_fleet.FleetController, ref_runs, bundle=rb, params=rp))
    monkeypatch.setattr(fleet, "FleetController", _recording(
        fleet.FleetController, port_runs))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        theirs = ref_scale.run_fleet_scale_cell(str(tmp_path / "ref"))
        ours = scale.run_fleet_scale_cell(
            str(tmp_path / "port"), bundle=b, params=p, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert theirs.ok and ours.ok, (theirs, ours)
    for f in ("grew", "drained", "migrations", "outputs_match", "n_outputs"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.n_outputs == 8 and ours.migrations >= 1
    # the grown-and-drained fleet, then the fixed 2-engine fleet
    assert len(port_runs) == len(ref_runs) == 2
    assert port_runs == ref_runs
    assert port_runs[0] == port_runs[1]


# -- the autoscale cell ----------------------------------------------------------

@pytest.mark.parametrize("topology", sorted(PRESETS))
def test_autoscale_cell_equals_the_references(tmp_path, topology):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    theirs = ref_scale.run_autoscale_cell(str(tmp_path / "ref"),
                                          topology=topology)
    ours = scale.run_autoscale_cell(str(tmp_path / "port"),
                                    topology=topology)
    mine, want = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    log, ref_log = mine.pop("decision_log"), want.pop("decision_log")
    assert mine == want
    assert ours.ok == theirs.ok
    assert Path(log).read_bytes() == Path(ref_log).read_bytes()
    assert ours.decisions > 0


# -- the runner ------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def test_runner_suite_scale_on_cpu(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios.runner", "--suite",
         "scale", "--device", "cpu", "--workdir", str(tmp_path),
         "--scale-points", "none,join_committed"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    lines = p.stdout.splitlines()
    assert [l for l in lines if l.startswith("grow_scenario,")] == [
        "grow_scenario,none,OK,lives=[(0, 1, 2, 3)],"
        "sources=['None', 'peer-staging'],digest_match=True",
        "grow_scenario,join_committed,OK,lives=[(0, 1, 2)],"
        "sources=['pool'],digest_match=True"]
    assert [l for l in lines if l.startswith("fleet_scale,")] == [
        "fleet_scale,OK,grew=True,drained=True,migrations=2,"
        "outputs_bit_identical=True"]
    auto = [l for l in lines if l.startswith("autoscale,")]
    assert len(auto) == 1 and auto[0].startswith("autoscale,OK,")
    assert (tmp_path / "autoscale_decisions.jsonl").is_file()
    assert lines[-1] == "runner,OK,failed=0"


#: runs ``<package>.scenarios.runner --suite all`` with every suite's run
#: function replaced by one that prints its suite's name
_ORDER = r"""
import importlib, sys, types
pkg, argv = sys.argv[1], sys.argv[2:]
mod = lambda m: importlib.import_module(pkg + ".scenarios." + m)
runner, scale = mod("runner"), mod("scale")
def stub(name, result):
    def fn(*a, **kw):
        print("suite," + name, flush=True)
        return result
    return fn
runner.run_suite = stub("train", [])
runner.run_serve_suite = stub("serve", [])
mod("cluster").run_cluster_suite = stub("cluster", [])
scale.run_grow_suite = stub("scale", [])
scale.run_fleet_scale_cell = lambda *a, **kw: scale.FleetScaleResult(
    True, True, 1, True, 8)
scale.run_autoscale_cell = lambda *a, **kw: scale.AutoscaleCellResult(
    1.0, 2.0, 1, 1.0, 1.0, 0, 1, 1, 0, sys.executable)
mod("fuzz").run_fuzz_suite = stub("fuzz", types.SimpleNamespace(
    cells=[], violations=0, reproducers=[], episodes=0, kills_fired=0,
    torn_writes=0, recoveries=0, log_path="-"))
sys.exit(runner.main(argv))
"""


def test_runner_suite_all_runs_the_references_order(tmp_path):
    def order(pkg, *argv):
        p = subprocess.run(
            [sys.executable, "-c", _ORDER, pkg, "--suite", "all",
             "--workdir", str(tmp_path / pkg), *argv],
            env=dict(_env(), JAX_PLATFORMS="cpu"), capture_output=True,
            text=True, timeout=300)
        assert p.returncode == 0, p.stdout + p.stderr
        assert p.stdout.splitlines()[-1] == "runner,OK,failed=0"
        return [l.split(",")[1] for l in p.stdout.splitlines()
                if l.startswith("suite,")]
    ours = order("repro_torch", "--device", "cpu")
    assert ours == ["train", "serve", "cluster", "scale", "fuzz"]
    assert ours == order("repro")
