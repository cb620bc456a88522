"""The port's ``DSMPool`` (``repro_torch.dsm.pool``) held to the JAX
package's multi-writer tests (``tests/test_multiwriter_pool.py``): two
committers sharing one pool must never lose or overwrite a completed
commit.

Covers: a real two-process race, every interleaving of length 6 and a
property test over longer ones, the stale-handle restart case, a dead
reservation skipped and collected, nested (``w<i>/``) namespaces, the gc
family watermark sparing an in-flight write, gc's empty-directory removal
and ``manifests_desc`` order.  Across packages: the reference's pool and
the port's commit to one pool in interleaved order, in one process and in
two processes, and every manifest survives with a unique ``seq``, read
alike by both."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.dsm.pool import DSMPool as RefPool
from repro_torch.dsm.pool import DSMPool

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_COMMIT_LOOP = """
import json, sys
from repro_torch.dsm.pool import DSMPool
writer, n, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
pool = DSMPool(path)
obj = pool.write_object(f"w{writer}/x", 1, {"a": [1.0, 2.0]})
seqs = []
for i in range(n):
    seqs.append(pool.commit_manifest(
        i, {f"w{writer}/x": obj}, meta={"writer": writer, "i": i}))
print(json.dumps(seqs))
"""


def test_two_processes_never_overwrite_a_commit(tmp_path):
    """Two concurrent committer PROCESSES: every commit of both remains
    present and readable; no sequence number is ever reused."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    n = 25
    procs = [subprocess.Popen(
        [sys.executable, "-c", _COMMIT_LOOP, w, str(n), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in ("A", "B")]
    seqs = {}
    for w, p in zip("AB", procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        seqs[w] = json.loads(out.strip().splitlines()[-1])
    # no writer ever reused another's seq
    assert not set(seqs["A"]) & set(seqs["B"])
    ms = DSMPool(str(tmp_path)).manifests_desc()
    assert len(ms) == 2 * n                        # nothing lost
    assert len({m["seq"] for m in ms}) == 2 * n    # nothing overwritten
    # every commit of both writers is individually recoverable
    by_writer = {(m["meta"]["writer"], m["meta"]["i"]) for m in ms}
    assert by_writer == {(w, i) for w in "AB" for i in range(n)}


def test_stale_handle_restart_cannot_clobber(tmp_path):
    """The original bug: a handle opened BEFORE later commits cached a
    stale _manifest_seq and os.replace'd over an existing manifest."""
    pool_a = DSMPool(str(tmp_path))
    stale = DSMPool(str(tmp_path))        # caches seq = -1 now
    o = pool_a.write_object("x", 1, {"a": np.zeros(3, np.float32)})
    committed = [pool_a.commit_manifest(i, {"x": o}, meta={"w": "a", "i": i})
                 for i in range(5)]
    s = stale.commit_manifest(99, {"x": o}, meta={"w": "stale"})
    assert s not in committed
    ms = DSMPool(str(tmp_path)).manifests_desc()
    assert len(ms) == 6
    assert {m["meta"].get("w") for m in ms} == {"a", "stale"}


def _check_interleaving(pool_dir, schedule):
    """Run one interleaving of two committer handles and assert no commit
    was lost, re-sequenced, or content-clobbered."""
    handles = [DSMPool(pool_dir), DSMPool(pool_dir)]
    obj = handles[0].write_object("x", 1, {"a": [0.5]})
    counts = [0, 0]
    seq_of = {}
    for w in schedule:
        i = counts[w]
        seq_of[(w, i)] = handles[w].commit_manifest(
            len(seq_of), {"x": obj}, meta={"w": w, "i": i})
        counts[w] += 1
    ms = DSMPool(pool_dir).manifests_desc()
    assert len(ms) == len(schedule)                      # none lost
    assert len({m["seq"] for m in ms}) == len(schedule)  # none reused
    for m in ms:                         # content never cross-clobbered
        assert seq_of[(m["meta"]["w"], m["meta"]["i"])] == m["seq"]


def test_all_interleavings_of_length_6(tmp_path_factory):
    """Exhaustive sweep over EVERY interleaving of two committers making 6
    commits between them (runs with or without hypothesis)."""
    for bits in range(64):
        schedule = [(bits >> k) & 1 for k in range(6)]
        _check_interleaving(str(tmp_path_factory.mktemp("il")), schedule)


def test_interleaved_commits_property(tmp_path_factory):
    """Property test over interleavings: two committer HANDLES of one pool
    interleaved per schedule — after any interleaving every completed
    commit is present, uniquely sequenced, and its content intact."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.integers(0, 1), min_size=2, max_size=14))
    def run(schedule):
        _check_interleaving(str(tmp_path_factory.mktemp("mw")), schedule)

    run()


def test_manifests_desc_orders_by_step_then_seq(tmp_path):
    """With concurrent committers a straggler can rename an OLDER step's
    manifest after a newer step committed (higher seq, older step);
    recovery must still prefer the newest STEP."""
    pool = DSMPool(str(tmp_path))
    o = pool.write_object("x", 1, {"a": np.zeros(2, np.float32)})
    pool.commit_manifest(7, {"x": o})
    pool.commit_manifest(3, {"x": o})     # late straggler, higher seq
    ms = pool.manifests_desc()
    assert [m["step"] for m in ms] == [7, 3]
    assert pool.latest_manifest()["step"] == 7


def test_namespaced_max_version_and_gc(tmp_path):
    """Nested ``w<i>/<name>`` objects: version seeding sees them and gc
    walks them (the flat listdir of the original code saw neither).
    An unreferenced version ABOVE the newest kept reference is presumed
    in flight (a concurrent writer's not-yet-committed flush) and kept;
    one below the watermark is garbage."""
    pool = DSMPool(str(tmp_path))
    tree = {"a": np.arange(4.0, dtype=np.float32)}
    assert pool.max_version("w0/params") == 0
    pool.write_object("w0/params", 1, tree)      # unreferenced, stale
    o3 = pool.write_object("w0/params", 3, tree)
    pool.write_object("w0/params", 5, tree)      # unreferenced, in-flight
    assert pool.max_version("w0/params") == 5
    pool.commit_manifest(0, {"w0/params": o3})
    pool.gc(keep=1)
    back = pool.read_object("w0/params", 3, tree, expected_crc=o3.crc)
    assert np.array_equal(back["a"].numpy(), np.arange(4.0))
    files = os.listdir(os.path.join(str(tmp_path), "objects", "w0",
                                    "params"))
    assert not any(f.startswith("00000001") for f in files)  # stale: gone
    assert any(f.startswith("00000005") for f in files)  # in-flight: kept
    # once a later manifest references past it, the dead version falls
    # behind the watermark and is collected
    o6 = pool.write_object("w0/params", 6, tree)
    pool.commit_manifest(1, {"w0/params": o6})
    pool.gc(keep=1)
    files = os.listdir(os.path.join(str(tmp_path), "objects", "w0",
                                    "params"))
    assert not any(f.startswith("00000005") for f in files)


def test_gc_family_watermark_protects_inflight_plain_write(tmp_path):
    """The kept manifests may reference an object only in SHARDED form
    (w0/params.s<k>) while a concurrent committer's in-flight flush of
    the same object is PLAIN (w0/params) — one version counter, two
    spellings.  gc's in-flight watermark is per family, so the plain
    write newer than the sharded watermark must survive (this exact race
    deleted shrink-flushed objects under retention gc)."""
    from repro_torch.dsm.pool import ShardedObject, shard_family
    assert shard_family("w0/params.s3") == "w0/params"
    assert shard_family("w0/params") == "w0/params"
    assert shard_family("kv/r1.spam") == "kv/r1.spam"
    pool = DSMPool(str(tmp_path))
    leaves = [np.arange(4, dtype=np.float32), np.ones(3, np.float32)]
    s0 = pool.write_object("w0/params.s0", 7, [leaves[0]])
    s1 = pool.write_object("w0/params.s1", 7, [leaves[1]])
    sharded = ShardedObject("w0/params", 7, s0.nbytes + s1.nbytes, 2,
                            [s0, s1], [[0], [1]])
    pool.commit_manifest(5, {"w0/params": sharded})
    # another committer's flush for the NEXT commit, manifest not yet up
    o8 = pool.write_object("w0/params", 8, {"a": leaves[0]})
    pool.gc(keep=1)
    pool.read_object("w0/params", 8, {"a": leaves[0]}, expected_crc=o8.crc)
    # the kept manifest's shards survived too
    pool.read_entry("w0/params", sharded.to_entry(), leaves)


def test_gc_removes_emptied_object_dirs(tmp_path):
    """Retiring an object (no retained manifest references it) must not
    leave its ``objects/<name>/`` directory behind forever."""
    pool = DSMPool(str(tmp_path))
    tree = {"a": np.zeros(4, np.float32)}
    keep = pool.write_object("keep", 1, tree)
    retired = pool.write_object("kv/r1", 1, tree)
    pool.commit_manifest(0, {"keep": keep, "kv/r1": retired})
    pool.commit_manifest(1, {"keep": keep})       # kv/r1 retired
    pool.gc(keep=1)
    obj_dir = os.path.join(str(tmp_path), "objects")
    assert not os.path.exists(os.path.join(obj_dir, "kv"))
    assert os.path.isdir(os.path.join(obj_dir, "keep"))
    # dirs holding a live version are untouched and still readable
    pool.read_object("keep", 1, tree, expected_crc=keep.crc)


def test_dead_reservation_skipped_and_collected(tmp_path):
    """A committer that died between seq reservation and rename leaves an
    empty manifest file: readers skip it, later commits step past it, and
    gc eventually collects it."""
    pool = DSMPool(str(tmp_path))
    o = pool.write_object("x", 1, {"a": np.zeros(2, np.float32)})
    pool.commit_manifest(0, {"x": o})
    # simulate the dead reservation for the next seq
    dead = os.path.join(str(tmp_path), "manifest.2.json")
    open(dead, "w").close()
    assert [m["step"] for m in pool.manifests_desc()] == [0]
    s = pool.commit_manifest(1, {"x": o})
    assert s > 2                                  # stepped past the corpse
    assert [m["step"] for m in pool.manifests_desc()] == [1, 0]
    pool.commit_manifest(2, {"x": o})
    pool.gc(keep=1)
    assert not os.path.exists(dead)


def test_reference_and_port_commit_interleaved_to_one_pool(tmp_path):
    """The reference's pool and the port's as two committer handles of one
    directory, in every interleaving of length 6: no commit lost, no seq
    reused, and both read the same manifest list."""
    for bits in range(64):
        d = str(tmp_path / f"il{bits}")
        handles = [RefPool(d), DSMPool(d)]
        obj = handles[1].write_object("x", 1, {"a": np.zeros(2, np.float32)})
        seq_of = {}
        for k in range(6):
            w = (bits >> k) & 1
            seq_of[(w, k)] = handles[w].commit_manifest(
                k, {"x": obj}, meta={"w": w, "k": k})
        ours, ref = DSMPool(d).manifests_desc(), RefPool(d).manifests_desc()
        assert ours == ref
        assert len(ours) == 6 and len({m["seq"] for m in ours}) == 6
        for m in ours:
            assert seq_of[(m["meta"]["w"], m["meta"]["k"])] == m["seq"]


_REF_COMMIT_LOOP = _COMMIT_LOOP.replace("repro_torch.dsm.pool",
                                        "repro.dsm.pool")


def test_reference_and_port_processes_never_overwrite_a_commit(tmp_path):
    """A port committer process and a reference committer process race on
    one pool: every commit of both survives with a unique seq."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    n = 20
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, w, str(n), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w, code in (("P", _COMMIT_LOOP),
                                   ("R", _REF_COMMIT_LOOP))]
    seqs = {}
    for w, p in zip("PR", procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        seqs[w] = json.loads(out.strip().splitlines()[-1])
    assert not set(seqs["P"]) & set(seqs["R"])
    ms = DSMPool(str(tmp_path)).manifests_desc()
    assert len(ms) == 2 * n and len({m["seq"] for m in ms}) == 2 * n
    assert {(m["meta"]["writer"], m["meta"]["i"]) for m in ms} == \
        {(w, i) for w in "PR" for i in range(n)}
