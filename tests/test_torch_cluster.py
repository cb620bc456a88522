"""The port's rank protocol (``repro_torch.dsm.cluster``) against the JAX
package's ``repro.dsm.cluster``: the in-process tests of
``tests/test_cluster.py`` on the port, and byte equality across packages.

* ``ring_sibling``, ``rank_ns``, ``partition_plan``;
* the all-reduce board is bit-exact, keeps generations apart and detects a
  posted death; the control plane's change log;
* three ranks recording concurrently elect exactly one cluster manifest;
  commit-marker failover; the commit waits for every record; record dirs
  of superseded steps are pruned;
* subset recovery from a cluster manifest; a peer's staged copy recovered
  across "processes" (fresh handles);
* rank records, control-plane files, board files and cluster manifests
  are byte-equal to the reference's for equal inputs, and each package's
  ``ClusterProtocol`` commits the other's records;
* the kill matrix (3 commit-window points x replication on / off) through
  ``corpus_cluster_cell``, each cell landing where the reference's
  ``expected_recovery`` table says and equal to the reference's episode.
"""
import json
import os
import threading

import numpy as np
import pytest

from repro.dsm import cluster as ref_cluster
from repro.dsm.pool import DSMPool as RefPool
from repro.scenarios import fuzz as ref_fuzz
from repro.scenarios.cluster import expected_recovery
from repro_torch.dsm.cluster import (ClusterProtocol, ControlPlane,
                                     FileStagingArea, MembershipChange,
                                     ScalarReduceBoard, rank_ns,
                                     ring_sibling)
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.recovery import RecoveryManager
from repro_torch.dsm.tiers import TierManager
from repro_torch.scenarios.fuzz import corpus_cluster_cell
from repro_torch.train.elastic import partition_plan


def test_ring_sibling_and_namespaces():
    assert ring_sibling(0, [0, 1, 2]) == 1
    assert ring_sibling(2, [0, 1, 2]) == 0
    assert ring_sibling(0, [0, 2]) == 2
    for live in ([0, 1, 2], [0, 2], [1, 3, 4, 7]):
        for r in live:
            assert ring_sibling(r, live) == ref_cluster.ring_sibling(r, live)
            assert rank_ns(r, "params") == ref_cluster.rank_ns(r, "params")
    names = [f"t{i}" for i in range(7)]
    plan = partition_plan(names, [0, 1, 2])
    assert plan == partition_plan(list(reversed(names)), [2, 0, 1])
    assert set(partition_plan(names, [0, 2]).values()) <= {0, 2}


def test_reduce_board_bit_exact_and_detects_death(tmp_path):
    board = ScalarReduceBoard(str(tmp_path / "reduce"))
    control = ControlPlane(str(tmp_path / "control"))
    vals = {0: 0.1, 1: 2.30000000007, 2: -1.25}
    for r, v in vals.items():
        board.contribute(0, 5, r, v)
    total = board.combine(0, 5, [0, 1, 2], control=control)
    assert total == ((vals[0] + vals[1]) + vals[2])    # fixed order
    # generations never leak into each other
    with pytest.raises(TimeoutError):
        board.combine(1, 5, [0, 1, 2], timeout=0.2)
    # a posted death surfaces as MembershipChange while blocked
    board.contribute(0, 6, 0, 1.0)
    control.post(1)
    with pytest.raises(MembershipChange) as ei:
        board.combine(0, 6, [0, 1], control=control, timeout=5.0)
    assert (ei.value.victim, ei.value.kind) == (1, "shrink")
    # the survivor's combine of step 6 prunes the dirs of older steps
    assert os.path.isdir(tmp_path / "reduce" / "g0" / "s5")
    assert board.combine(0, 6, [0], timeout=1.0) == 1.0
    assert not os.path.exists(tmp_path / "reduce" / "g0" / "s5")


def test_control_plane_log_and_board_files_equal_the_references(tmp_path):
    for pkg, mod in (("port", None), ("ref", ref_cluster)):
        cp = (ControlPlane if mod is None else mod.ControlPlane)(
            str(tmp_path / pkg / "control"))
        cp.post_change("grow", 3, planned=True, at_step=4)
        cp.post(1)
        cp.post_shrink_result(1, {"gen": 1, "live": [0, 2], "step": 3})
        board = (ScalarReduceBoard if mod is None
                 else mod.ScalarReduceBoard)(str(tmp_path / pkg / "board"))
        board.contribute(2, 7, 1, 0.30000000000000004)
    ours = ControlPlane(str(tmp_path / "port" / "control"))
    assert ours.changes() == ref_cluster.ControlPlane(
        str(tmp_path / "ref" / "control")).changes()
    assert ours.read() == {"victim": 1, "planned": False, "at_step": None,
                           "kind": "shrink"}
    assert ours.wait_shrink_result(1, timeout=1.0)["live"] == [0, 2]
    with pytest.raises(ValueError):
        ours.post_change("grow", 5)          # grow is planned-only
    for root, _, files in os.walk(tmp_path / "port"):
        for fn in files:
            p = os.path.join(root, fn)
            q = p.replace(str(tmp_path / "port"), str(tmp_path / "ref"))
            with open(p, "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read(), p


def _records(pool, protos, step=2):
    """Each rank writes w<r>/state version 1 and records it for ``step``."""
    for r, proto in enumerate(protos):
        o = pool.write_object(rank_ns(r, "state"), 1,
                              {"t": np.full((2,), float(r), np.float32)})
        proto.write_record(step, {o.name: dict(name=o.name,
                                               version=o.version, crc=o.crc,
                                               nbytes=o.nbytes)})


def test_cluster_commit_elects_exactly_one_manifest(tmp_path):
    """Three rank handles record step 2 and all try to commit at once:
    one O_EXCL winner, one manifest referencing every rank's object."""
    pool_dir = str(tmp_path)
    protos = [ClusterProtocol(DSMPool(pool_dir), r, [0, 1, 2])
              for r in range(3)]
    _records(protos[0].pool, protos)
    barrier = threading.Barrier(3)
    seqs = [None] * 3

    def commit(r):
        barrier.wait()
        seqs[r] = protos[r].try_commit(2)

    threads = [threading.Thread(target=commit, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len([s for s in seqs if s != -1]) == 1
    ms = DSMPool(pool_dir).manifests_desc()
    assert len(ms) == 1 and ms[0]["step"] == 2
    assert set(ms[0]["objects"]) == {rank_ns(r, "state") for r in range(3)}
    assert ms[0]["meta"] == {"kind": "cluster", "gen": 0, "live": [0, 1, 2]}


def test_commit_marker_failover(tmp_path):
    """A winner dying between the marker and the manifest rename must not
    wedge the step: a waiter with the full record set takes over."""
    pool = DSMPool(str(tmp_path))
    protos = [ClusterProtocol(pool, r, [0, 1], timeout=8.0)
              for r in range(2)]
    _records(pool, protos, step=0)
    assert protos[0]._win_commit_marker(0)    # winner "dies" right here
    assert protos[1].try_commit(0) == -1      # wedged under the marker...
    m = protos[1].wait_manifest(0)            # ...until takeover kicks in
    assert m["step"] == 0
    assert set(m["objects"]) == {rank_ns(0, "state"), rank_ns(1, "state")}


def test_cluster_commit_waits_for_all_records(tmp_path):
    proto = ClusterProtocol(DSMPool(str(tmp_path)), 0, [0, 1])
    proto.write_record(0, {"w0/state": {"name": "w0/state", "version": 1,
                                        "crc": 0, "nbytes": 8}})
    assert proto.try_commit(0) == -1          # rank 1 not recorded yet
    assert proto.find_manifest(0) is None


def test_records_of_superseded_steps_are_pruned(tmp_path):
    pool = DSMPool(str(tmp_path))
    protos = [ClusterProtocol(pool, r, [0, 1], retention=2)
              for r in range(2)]
    for step in range(4):
        for r, proto in enumerate(protos):
            o = pool.write_object(rank_ns(r, "x"), step + 1,
                                  {"a": np.zeros(2, np.float32)})
            proto.cluster_complete(step, {o.name: o})
    left = sorted(os.listdir(tmp_path / "records" / "g0"))
    assert left == ["s3"]
    assert [m["step"] for m in pool.manifests_desc()] == [3, 2]


@pytest.mark.parametrize("committer", ["port", "ref"])
def test_records_and_manifests_byte_equal_across_packages(tmp_path,
                                                          committer):
    """Equal inputs give byte-equal rank records and cluster manifests; the
    ranks of one package and the elected committer of the other share one
    pool."""
    docs = {}
    for pkg, (Proto, Pool) in {"port": (ClusterProtocol, DSMPool),
                               "ref": (ref_cluster.ClusterProtocol,
                                       RefPool)}.items():
        pool = Pool(str(tmp_path / pkg))
        protos = [Proto(pool, r, [0, 1, 2], retention=3) for r in range(3)]
        for step in (1, 3):
            for r, proto in enumerate(protos):
                o = pool.write_object(rank_ns(r, "params"), step,
                                      {"w": np.arange(4, dtype=np.float32)
                                       * (r + step)})
                proto.cluster_complete(step, {o.name: o})
        docs[pkg] = {}
        for root, _, files in os.walk(tmp_path / pkg):
            for fn in files:
                if fn.startswith("manifest") or root.find("records") >= 0:
                    with open(os.path.join(root, fn), "rb") as f:
                        docs[pkg][os.path.relpath(
                            os.path.join(root, fn), tmp_path / pkg)] = \
                            f.read()
    assert docs["port"] and docs["port"] == docs["ref"]
    # mixed: ranks 0, 1 of one package, the committing rank 2 the other's
    mixed = str(tmp_path / "mixed")
    ranks = ((ref_cluster.ClusterProtocol, RefPool) if committer == "port"
             else (ClusterProtocol, DSMPool))
    last = ((ClusterProtocol, DSMPool) if committer == "port"
            else (ref_cluster.ClusterProtocol, RefPool))
    for r, (Proto, Pool) in enumerate([ranks, ranks, last]):
        pool = Pool(mixed)
        o = pool.write_object(rank_ns(r, "params"), 1,
                              {"w": np.arange(4, dtype=np.float32) * (r + 1)})
        seq = Proto(pool, r, [0, 1, 2]).cluster_complete(1, {o.name: o})
    assert seq == 0
    with open(os.path.join(mixed, "manifest.0.json"), "rb") as f:
        got = json.loads(f.read())
    with open(tmp_path / "port" / "manifest.0.json", "rb") as f:
        assert got == json.loads(f.read())


def test_subset_recovery_from_cluster_manifest(tmp_path):
    pool = DSMPool(str(tmp_path))
    tiers = TierManager(pool, worker_id=0)
    objs = {}
    for r in range(3):
        name = rank_ns(r, "params")
        tiers.lstore(name, {"t": np.full((2,), float(r), np.float32)})
        objs[name] = tiers.rflush(name)
    pool.commit_manifest(4, objs)
    tpl = {rank_ns(1, "params"): {"t": np.zeros((2,), np.float32)}}
    got = RecoveryManager(pool).recover_from_pool(tpl, exact=False)
    assert got is not None and got[1] == 4
    assert np.array_equal(got[0][rank_ns(1, "params")]["t"].numpy(),
                          np.full((2,), 1.0, np.float32))
    # exact mode still refuses the superset manifest
    assert RecoveryManager(pool).recover_from_pool(tpl) is None


def test_rstore_through_proxy_feeds_cross_process_recovery(tmp_path):
    pool = DSMPool(str(tmp_path / "pool"))
    area = FileStagingArea(str(tmp_path / "staging"))
    name = rank_ns(0, "params")
    tiers = TierManager(pool, worker_id=0)
    old = {"t": np.zeros((4,), np.float32)}
    new = {"t": np.full((4,), 2.5, np.float32)}
    tiers.lstore(name, old)
    pool.commit_manifest(3, {name: tiers.rflush(name)})   # pool at step 3
    tiers.lstore(name, new)
    tiers.rstore(name, area.proxy(1), tag=5)              # staged at step 5
    # the sibling side: fresh handles, as a separate process would have
    view = FileStagingArea(str(tmp_path / "staging")).view(1, {name: old})
    objs, step, source = RecoveryManager(
        DSMPool(str(tmp_path / "pool"))).recover(
        {name: old}, peers=(view,), exact=False)
    assert (step, source) == (5, "peer-staging")
    assert np.array_equal(objs[name]["t"].numpy(), new["t"])
    # the reference's view of the same buffer agrees
    rview = ref_cluster.FileStagingArea(str(tmp_path / "staging")).view(
        1, {name: old})
    assert rview.staging[name][0] == 5


@pytest.mark.parametrize("point", ["pre_flush", "mid_flush",
                                   "post_completeOp"])
@pytest.mark.parametrize("replicate", [True, False])
def test_kill_matrix_cell_via_fuzzer_corpus(tmp_path, point, replicate):
    """The 6-cell kill matrix as pinned fuzz schedules: rank 1 dies at
    ``point`` of the second commit; the recovery lands where the
    reference's table says, and the episode equals the reference's."""
    kill_step, commit_every = 3, 2
    res = corpus_cluster_cell(point, replicate, str(tmp_path / "port"),
                              commit_every=commit_every,
                              kill_step=kill_step)
    assert res.ok, res.violations
    assert len(res.kills_fired) == 1
    assert res.kills_fired[0]["worker"] == 1
    rec = res.recoveries[0]
    assert rec["victim"] == 1
    assert (rec["step"], rec["source"]) == expected_recovery(
        point, replicate, kill_step, commit_every)
    ref = ref_fuzz.corpus_cluster_cell(point, replicate,
                                       str(tmp_path / "ref"),
                                       commit_every=commit_every,
                                       kill_step=kill_step)
    assert res.to_json() == ref.to_json()
