"""The rank-process cluster in the port (``launch.mesh``, ``train.elastic``'s
``reshard`` / ``remesh``, ``scenarios.cluster_worker``,
``scenarios.cluster``, ``launch.cluster`` and the runner's ``--suite
cluster``) against the JAX package's, every rank on ``--device cpu``.

* ``mesh_device_sets`` / ``rank_submesh`` on the host (one device: every
  rank's slice is it, the reference's shared-device fallback), ``remesh``
  onto it; the production, debug and parsed meshes, a slice of two
  devices laid out as an (n, 1) mesh, ``remesh`` onto a 2x4 mesh;
* partitions follow the device count: at the port's one host device they
  equal the reference's partition at one forced device;
* the planned shrink (3 ranks, rank 1 leaves at step 4, 6 steps, a
  commit every 2): the port's merged digests equal the reference's
  ``run_cluster_planned`` bit for bit, and so do its cluster manifests
  (steps, metas with the partitions; object versions and CRCs but at
  the last step, where which rank's final flush lands first decides
  them in both packages) — the
  reference's workers run with ``XLA_FLAGS`` forcing ONE host device, the
  count the port sees (under pytest the reference's workers see 8, which
  weighs their partition slots 2 a rank);
* real-process kill cells through the port's ``run_cluster_scenario``:
  ``pre_flush`` replicated recovers from ``peer-staging`` at step 3,
  ``pre_flush`` unreplicated from the ``pool`` at step 1, each ending
  with the port's planned shrink's digests, which equal the reference's
  ``run_cluster_planned`` at the same ``shrink_at``; the victim's JSON
  kill line and every rank's extra fields are checked;
* the fuzzer's pinned cluster cells (``scenarios.fuzz``) land where the
  real-process suite's ``expected_recovery`` says, for all six cells,
  and that table equals the reference's;
* the N-worker launcher and ``runner --suite cluster`` (one cell) on
  ``--device cpu`` (``--suite scale`` is held in
  ``test_torch_scale_cells.py``).

The rank processes import torch each (a few seconds of start-up); the
file runs seven clusters of three ranks (the reference's two among
them), each cluster's ranks at once.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.scenarios import cluster as ref_cluster
from repro.train.elastic import partition_plan as ref_partition_plan
from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.dsm.pool import DSMPool
from repro_torch.launch import mesh
from repro_torch.scenarios.cluster import (expected_recovery,
                                           run_cluster_planned,
                                           run_cluster_scenario)
from repro_torch.scenarios.cluster_worker import tensor_names
from repro_torch.scenarios.fuzz import corpus_cluster_cell
from repro_torch.scenarios.worker import KILL_EXIT
from repro_torch.train.elastic import partition_plan, remesh, reshard

ROOT = Path(__file__).resolve().parents[1]
RUN = dict(world=3, victim=1, steps=6, commit_every=2)
KILL_STEP = 3                      # the second commit


class Planned:
    """Planned shrinks by ``shrink_at``, each package's run once: the
    port's on cpu, the reference's with ONE forced host device.  ``port``
    maps a resumed step to the port's digests at ``shrink_at = step + 1``
    — the ``ref_cache`` of ``run_cluster_scenario``, so a kill cell reuses
    the run instead of repeating it."""

    def __init__(self, root):
        self.root = root
        self.port = {}
        self.ref = {}

    def __call__(self, shrink_at):
        q = shrink_at - 1
        if q not in self.port:
            self.port[q] = run_cluster_planned(
                str(self.root / f"p{shrink_at}"), shrink_at=shrink_at,
                device="cpu", **RUN)
        if q not in self.ref:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=1")
                self.ref[q] = ref_cluster.run_cluster_planned(
                    str(self.root / f"r{shrink_at}"), shrink_at=shrink_at,
                    **RUN)
        return (self.port[q], self.ref[q], str(self.root / f"p{shrink_at}"),
                str(self.root / f"r{shrink_at}"))


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    return Planned(tmp_path_factory.mktemp("planned"))


# -- device slices and re-placement ------------------------------------------

def test_rank_slices_and_remesh_on_the_host():
    live = [0, 2, 3]
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.mesh_device_sets(live, "cpu") == {0: 1, 2: 1, 3: 1}
    for r in live:
        assert mesh.rank_submesh(r, live, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not in live set"):
        mesh.rank_submesh(1, live, "cpu")
    tree = {"t00": {"p": np.arange(4, dtype=np.float32),
                    "mu": torch.zeros(2)}}
    placed, dev = remesh(tree, None, mesh.rank_submesh(0, live, "cpu"))
    assert dev == torch.device("cpu")
    assert torch.equal(placed["t00"]["p"], torch.arange(4.0))
    assert placed["t00"]["mu"] is tree["t00"]["mu"]     # already there
    # the meshes are ported: production (abstract), debug and parsed ones
    assert mesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh.make_debug_mesh(8, device="cpu").shape == \
        {"data": 8, "model": 1}
    m = mesh.parse_mesh("2x4", device="cpu")
    assert m.devices == (torch.device("cpu"),) * 8
    # a slice of several devices is laid out as the reference's (n, 1)
    # mesh, every leaf replicated; a Mesh takes the rules' shardings
    two = reshard(tree, ["cpu", "cpu"])
    assert two["t00"]["p"].sharding.mesh.shape == {"data": 2, "model": 1}
    assert torch.equal(two["t00"]["p"].full(), torch.arange(4.0))
    placed, ctx = remesh(tree, None, m)
    assert ctx.mesh is m and ctx.tp_size == 4
    assert len(placed["t00"]["mu"].addressable_shards) == 8


def test_partitions_follow_the_device_count():
    names, live = tensor_names(6), [0, 1, 2]
    ours = partition_plan(names, live, mesh.mesh_device_sets(live, "cpu"))
    # the reference's mesh_device_sets over one device gives every rank 1
    assert ours == ref_partition_plan(names, live, {r: 1 for r in live})
    assert list(ours.values()) == [0, 1, 2, 0, 1, 2]
    # at the 8 devices pytest forces on the reference, 2 slots a rank
    eight = ref_partition_plan(names, live, {r: 8 // 3 for r in live})
    assert list(eight.values()) == [0, 0, 1, 1, 2, 2]


# -- the planned shrink across packages ----------------------------------------

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


def test_planned_shrink_equals_the_references(planned):
    ours, theirs, p_pool, r_pool = planned(4)
    assert len(ours) == 6 and ours == theirs
    last = RUN["steps"] - 1
    mine = _by_step(p_pool, last)
    assert mine == _by_step(r_pool, last)
    assert sorted(mine) == [(0, -1), (0, 1), (0, 3), (1, 3), (1, 5)]


# -- real-process kill cells -----------------------------------------------------

@pytest.mark.parametrize("replicate,source,resume", [
    (True, "peer-staging", 3), (False, "pool", 1)])
def test_kill_cell_recovers_and_matches_both_planned_shrinks(
        tmp_path, planned, replicate, source, resume):
    _, theirs, _, _ = planned(resume + 1)
    r = run_cluster_scenario("pre_flush", str(tmp_path),
                             replicate=replicate, kill_step=KILL_STEP,
                             ref_cache=planned.port, device="cpu", **RUN)
    assert (r.recovery_source, r.resumed_from) == (source, resume), r.detail
    assert (r.expected_source, r.expected_resume) == (source, resume)
    assert r.killed and r.recovered_completed_commit and r.ok, r.detail
    assert r.completed_steps_at_kill == [-1, 1]
    assert r.digests == r.reference_digests == theirs
    victim, *survivors = r.children
    assert victim["rc"] == KILL_EXIT and victim["result"]["killed"]
    assert (victim["result"]["point"], victim["result"]["rank"],
            victim["result"]["step"]) == ("pre_flush", 1, KILL_STEP)
    for c in survivors:
        res = c["result"]
        assert c["rc"] == 0 and res["device"] == "cpu"
        assert res["live"] == [0, 2] and res["gen"] == 1
        assert res["recover_s"] > 0 and res["start_s"] > 0
        assert res["recovered_bytes"] > 0 and res["commits"] >= 3
        assert c["wall_s"] > res["start_s"] - 1


@pytest.mark.parametrize("point", KILL_POINTS)
@pytest.mark.parametrize("replicate", [True, False])
def test_pinned_fuzz_cells_land_where_the_real_process_suite_says(
        tmp_path, point, replicate):
    want = expected_recovery(point, replicate, KILL_STEP, 2)
    assert want == ref_cluster.expected_recovery(point, replicate,
                                                 KILL_STEP, 2)
    res = corpus_cluster_cell(point, replicate, str(tmp_path),
                              commit_every=2, kill_step=KILL_STEP)
    assert res.ok, res.violations
    assert (res.recoveries[0]["step"], res.recoveries[0]["source"]) == want


# -- the launcher and the runner ---------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def test_launcher_shrinks_on_cpu(tmp_path):
    pool = str(tmp_path / "pool")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", "--workers", "3", "--steps", "6", "--pool", pool,
         "--commit-every", "2", "--shrink-at", "3", "--victim", "2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "rank 2: departed at step 3 (planned shrink)" in p.stdout
    assert "live=[0, 1] gen=1" in p.stdout
    m = DSMPool(pool).latest_manifest()
    assert m["step"] == 5 and m["meta"]["live"] == [0, 1]


def test_runner_suite_cluster_on_cpu(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios.runner", "--suite",
         "cluster", "--device", "cpu", "--workdir", str(tmp_path),
         "--steps", "5", "--kill-points", "post_completeOp",
         "--cluster-sources", "peer"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    line = [l for l in p.stdout.splitlines()
            if l.startswith("cluster_scenario,")]
    assert line == ["cluster_scenario,post_completeOp,peer,OK,"
                    "completed=[-1, 1, 3],resumed=3,source=pool,"
                    "expected=(3,pool),digest_match=True"]
    assert "runner,OK,failed=0" in p.stdout
