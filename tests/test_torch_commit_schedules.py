"""The port's commit schedules (``sync`` / ``async`` / ``sharded`` /
``sharded-async``) against the JAX package's, mirroring
``tests/test_sharded_commit.py``, ``tests/test_tiers_flush_errors.py`` and
``tests/test_serve.py::test_async_commit_meta_captured_at_launch``.

* a toy durable loop (five leaves of three dtypes, a step every tick, a
  commit every 2, ``n_shards=4`` given to both packages) commits the same
  history under every schedule: the last manifest says step 7, recovery
  gives the final state, and the pool — shard frames, manifest documents,
  head manifest — is the reference's byte for byte;
* retention GC keeps 3 manifests and no orphaned shard version, as the
  reference's pool does, file for file;
* a failed threaded or sharded flush surfaces at the join, its FliT
  counter drops back to 0, and a commit whose flush failed leaves no
  manifest; a shard write fails either while it serializes
  (``start_write``) or at its fsync (``PendingWrite.finish``, which then
  aborts and leaves no file), on the stock pool;
* an async commit's manifest carries the meta captured at launch, and a
  leaf written in place right after an async ``commit()`` is recovered
  with the value it had at launch (the snapshot is the port's own);
* serving under each schedule (olmo-1b smoke, fp32, the reference's
  weights carried over, ``n_shards=2``): the reference's tokens, the
  reference's count of flushed objects, and each package recovers the
  pool the other committed (sessions, block tables, cache bytes);
* a crash under ``sharded-async`` resumes from the commit before the last
  one, with the reference's tokens.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm.api import open_cxl0 as ref_open_cxl0
from repro.dsm.pool import DSMPool as RefPool
from repro.models.registry import build as ref_build
from repro.serve.engine import build_serve_engine as ref_build_engine
from repro.serve.paging import BlockPager as RefPager
from repro.serve.sessions import SessionStore as RefStore
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.flit_runtime import (COMMIT_MODES, DurableCommitter,
                                          auto_shard_count)
from repro_torch.dsm.pool import DSMPool, PendingWrite
from repro_torch.dsm.tiers import TierManager
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.engine import build_serve_engine
from repro_torch.serve.paging import BlockPager
from repro_torch.serve.sessions import SessionStore
from repro_torch.serve.trace import synthetic_trace, trace_t_max
from repro_torch.utils.convert import raw_numpy
from repro_torch.utils.tree import tree_leaves

FP32 = dict(param_dtype="float32", compute_dtype="float32")
TRACE_KW = dict(prompt_lens=(12,), new_tokens=(3, 6, 9))
N_REQ = 7
COMMIT_EVERY = 3
CRASH_AFTER = 7                    # commits at ticks 3 and 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- a toy durable loop in both packages --------------------------------------

def _toy_state(step: int):
    rng = np.random.default_rng(step)
    return {"params": {"w": rng.standard_normal((48, 32), np.float32),
                       "b": rng.standard_normal((32,), np.float32)},
            "opt": {"mu": rng.standard_normal((48, 32), np.float32),
                    "count": np.arange(40, dtype=np.int32) + step},
            "step": np.asarray([step], np.int64)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _run_loop(ctx, to_leaf, n_steps=8, every=2, put_kw=None):
    for s in range(n_steps):
        ctx.put({"state": to_leaf(_toy_state(s))}, **(put_kw or {}))
        if s % every == every - 1:
            with ctx.commit(s, meta={"step": s}):
                pass
    ctx.drain()


def _pool_files(path):
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


def _template():
    return {"state": _as_torch(_toy_state(0))}


@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_all_schedules_same_durable_history(mode, tmp_path):
    ours = open_cxl0(str(tmp_path / "port"), schedule=mode, n_shards=4)
    _run_loop(ours, _as_torch)
    ours.close()
    theirs = ref_open_cxl0(str(tmp_path / "ref"), schedule=mode, n_shards=4)
    _run_loop(theirs, lambda t: t, put_kw={"step": 0})
    theirs.close()
    pool = DSMPool(str(tmp_path / "port"))
    assert pool.latest_manifest()["step"] == 7      # drain flushed the tail
    entry = pool.latest_manifest()["objects"]["state"]
    assert entry.get("sharded", False) == ("sharded" in mode)
    objs, step, _ = open_cxl0(pool).recover(_template())
    assert step == 7
    want = _toy_state(7)
    got = objs["state"]
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert raw_numpy(a)[0].tobytes() == np.asarray(b).tobytes()
    assert _pool_files(str(tmp_path / "port")) == \
        _pool_files(str(tmp_path / "ref"))


@pytest.mark.parametrize("mode", ["sharded", "sharded-async"])
def test_each_package_recovers_the_others_sharded_pool(mode, tmp_path):
    theirs = ref_open_cxl0(str(tmp_path / "ref"), schedule=mode, n_shards=3)
    _run_loop(theirs, lambda t: t, n_steps=6, put_kw={"step": 0})
    objs, step, _ = open_cxl0(str(tmp_path / "ref")).recover(_template())
    assert step == 5
    for a, b in zip(tree_leaves(objs["state"]),
                    jax.tree_util.tree_leaves(_toy_state(5))):
        assert raw_numpy(a)[0].tobytes() == np.asarray(b).tobytes()
    ours = open_cxl0(str(tmp_path / "port"), schedule=mode, n_shards=3)
    _run_loop(ours, _as_torch, n_steps=6)
    robjs, rstep, _ = ref_open_cxl0(str(tmp_path / "port")).recover(
        {"state": _toy_state(0)})
    assert rstep == 5
    for a, b in zip(jax.tree_util.tree_leaves(robjs["state"]),
                    jax.tree_util.tree_leaves(_toy_state(5))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_sharded_async_crash_recovery_identical(tmp_path):
    """A crash between commits loses only the launched, unjoined commit:
    recovery lands on the one before, and running on from there gives the
    clean run's history."""
    ctx = open_cxl0(str(tmp_path / "p"), schedule="sharded-async",
                    n_shards=4)
    for s in range(6):
        ctx.put({"state": _as_torch(_toy_state(s))})
        if s % 2 == 1:
            with ctx.commit(s):
                pass                  # commits 1, 3, 5: durable 1 and 3
    ctx.crash()
    back = open_cxl0(str(tmp_path / "p"), schedule="sharded-async",
                     n_shards=4)
    objs, step, _ = back.recover(_template())
    assert step == 3
    for a, b in zip(tree_leaves(objs["state"]),
                    jax.tree_util.tree_leaves(_toy_state(3))):
        assert raw_numpy(a)[0].tobytes() == np.asarray(b).tobytes()
    for s in range(step + 1, 8):
        back.put({"state": _as_torch(_toy_state(s))})
        if s % 2 == 1:
            with back.commit(s):
                pass
    back.drain()
    objs, step, _ = back.recover(_template())
    assert step == 7
    for a, b in zip(tree_leaves(objs["state"]),
                    jax.tree_util.tree_leaves(_toy_state(7))):
        assert raw_numpy(a)[0].tobytes() == np.asarray(b).tobytes()


def test_retention_bounds_manifests_and_versions(tmp_path):
    ours = open_cxl0(str(tmp_path / "port"), schedule="sharded",
                     n_shards=4, retention=3)
    _run_loop(ours, _as_torch, n_steps=12)
    theirs = ref_open_cxl0(str(tmp_path / "ref"), schedule="sharded",
                           n_shards=4, retention=3)
    _run_loop(theirs, lambda t: t, n_steps=12, put_kw={"step": 0})
    pool = DSMPool(str(tmp_path / "port"))
    ms = pool.manifests_desc()
    assert len(ms) == 3
    assert open_cxl0(pool).recover(_template())[1] == 11
    live = set()
    for m in ms:
        for n, o in m["objects"].items():
            live.update((s["name"], s["version"]) for s in o["shards"])
    for name in os.listdir(pool.obj_dir):
        for fn in os.listdir(os.path.join(pool.obj_dir, name)):
            assert (name, int(fn.split(".")[0])) in live
    assert _pool_files(str(tmp_path / "port")) == \
        _pool_files(str(tmp_path / "ref"))


def test_auto_shard_count_and_the_unported_auto_schedule(tmp_path):
    # one pipeline per card (1 without one), capped by 1 MiB a shard
    assert auto_shard_count(64 << 20, n_devices=8) == 8
    assert auto_shard_count(3 << 20, n_devices=8) == 3
    assert auto_shard_count(10, n_devices=8) == 1
    assert auto_shard_count(64 << 20) == max(torch.cuda.device_count(), 1)
    c = DurableCommitter(TierManager(DSMPool(str(tmp_path))),
                         mode="sharded")
    c.update({"x": [torch.zeros(1 << 19)]})             # 2 MiB
    c.commit(0)
    assert c.n_shards == auto_shard_count(2 << 20)
    # "auto" is ported now: it needs the policy that resolves it
    with pytest.raises(ValueError, match="PlacementPolicy"):
        DurableCommitter(c.tiers, mode="auto")
    with pytest.raises(ValueError):
        DurableCommitter(c.tiers, mode="eager")


# -- failed background flushes (tests/test_tiers_flush_errors.py) -------------

class BoomError(OSError):
    pass


@pytest.fixture
def tiers(tmp_path):
    t = TierManager(DSMPool(str(tmp_path)))
    yield t
    t.close()


def _fail_writes(tiers, monkeypatch, where="write_object"):
    """Fail every write at ``where``: the threaded flush's whole-object
    ``write_object``, or a stage of the split-phase shard write on the
    stock pool — serializing (``start_write``, flush pool) or fsync +
    rename (``PendingWrite.finish``, fsync lane), which must then abort.
    Returns the names whose pending write was aborted."""
    aborted = []
    if where == "finish":
        def boom(self):
            raise BoomError(f"fsync failed on {self.name}@{self.version}")
        orig_abort = PendingWrite.abort

        def abort(self):
            aborted.append(self.name)
            orig_abort(self)
        monkeypatch.setattr(PendingWrite, "finish", boom)
        monkeypatch.setattr(PendingWrite, "abort", abort)
    else:
        def boom(name, version, tree, *a, **kw):
            raise BoomError(f"disk full writing {name}@{version}")
        monkeypatch.setattr(tiers.pool, where, boom)
    return aborted


def _payload_files(pool):
    return [f for _, _, fs in os.walk(pool.obj_dir) for f in fs]


def test_failed_threaded_flush_surfaces_and_counter_drops(tiers,
                                                          monkeypatch):
    tiers.lstore("x", {"a": torch.arange(8.0)})
    _fail_writes(tiers, monkeypatch)
    tiers.flush_async("x")
    with pytest.raises(BoomError):
        tiers.flush_wait("x")
    assert tiers.flit_counter["x"] == 0
    monkeypatch.undo()              # the error was consumed
    tiers.lstore("x", {"a": torch.arange(8.0)})
    tiers.flush_async("x")
    obj = tiers.flush_wait("x")
    assert obj.name == "x" and tiers.flit_counter["x"] == 0


def test_failed_threaded_flush_abort_drops_counter(tiers, monkeypatch):
    tiers.lstore("x", {"a": torch.arange(8.0)})
    _fail_writes(tiers, monkeypatch)
    tiers.flush_async("x")
    tiers.abort_flushes()           # crash path: join-and-discard
    assert tiers.flit_counter["x"] == 0
    assert not tiers._flush_errors and not tiers._flush_results


@pytest.mark.parametrize("where", ["start_write", "finish"])
def test_failed_sharded_flush_surfaces_and_counter_drops(tiers, where,
                                                         monkeypatch):
    tiers.lstore("x", {"a": torch.arange(8.0), "b": torch.arange(4.0)})
    aborted = _fail_writes(tiers, monkeypatch, where)
    tiers.flush_async_sharded("x", n_shards=2)
    with pytest.raises(BoomError):
        tiers.flush_wait("x")
    assert tiers.flit_counter["x"] == 0
    with pytest.raises(BoomError):             # the blocking variant too
        tiers.rflush_sharded("x", n_shards=2)
    assert tiers.flit_counter["x"] == 0
    if where == "finish":                      # each shard's temp file went
        assert sorted(aborted) == ["x.s0", "x.s0", "x.s1", "x.s1"]
    assert not _payload_files(tiers.pool)      # nothing became visible
    monkeypatch.undo()
    assert len(tiers.rflush_sharded("x", n_shards=2).shards) == 2


@pytest.mark.parametrize("mode,where", [("async", "write_object"),
                                        ("sharded-async", "start_write"),
                                        ("sharded-async", "finish")])
def test_async_commit_surfaces_failed_flush_without_manifest(
        mode, where, tmp_path, monkeypatch):
    pool = DSMPool(str(tmp_path))
    tiers = TierManager(pool)
    committer = DurableCommitter(tiers, mode=mode, n_shards=2)
    committer.update({"x": {"a": torch.arange(8.0), "b": torch.ones(2)}})
    committer.commit(0)                       # launches background flush
    _fail_writes(tiers, monkeypatch, where)
    committer.abort_pending()                 # the step-0 flush may hold the
    #                                           unpatched callable mid-write
    committer.update({"x": {"a": torch.arange(8.0), "b": torch.ones(2)}})
    committer.commit(1)
    with pytest.raises(BoomError):
        committer.commit(2)                   # joins step 1's failed flush
    assert tiers.flit_counter["x"] == 0
    assert pool.latest_manifest() is None     # nothing ever completed
    tiers.close()


@pytest.mark.parametrize("where", ["start_write", "finish"])
def test_sharded_commit_surfaces_failed_shard_without_manifest(
        where, tmp_path, monkeypatch):
    pool = DSMPool(str(tmp_path))
    tiers = TierManager(pool)
    committer = DurableCommitter(tiers, mode="sharded", n_shards=2)
    committer.update({"x": {"a": torch.arange(8.0), "b": torch.ones(2)}})
    _fail_writes(tiers, monkeypatch, where)
    with pytest.raises(BoomError):
        committer.commit(0)                   # blocking: raises at once
    assert tiers.flit_counter["x"] == 0
    assert pool.latest_manifest() is None
    assert not committer.stats
    tiers.close()


# -- snapshots and meta at launch ---------------------------------------------

def test_async_commit_meta_captured_at_launch(tmp_path):
    tiers = TierManager(DSMPool(str(tmp_path / "pool")))
    c = DurableCommitter(tiers, mode="async")
    c.update({"x": {"a": torch.arange(4)}})
    assert c.commit(0, meta={"tag": "step0"}) is None   # launched, no join
    c.update({"x": {"a": torch.arange(4) + 1}})
    st = c.commit(1, meta={"tag": "step1"})             # joins step 0
    assert st is not None and st.step == 0
    c.drain()
    manifests = {m["step"]: m for m in tiers.pool.manifests_desc()}
    assert manifests[0]["meta"] == {"tag": "step0"}
    assert manifests[1]["meta"] == {"tag": "step1"}


@pytest.mark.parametrize("mode", ["async", "sharded-async"])
def test_a_leaf_written_in_place_after_commit_keeps_its_launch_value(
        mode, tmp_path):
    ctx = open_cxl0(str(tmp_path), schedule=mode, n_shards=2)
    h = ctx.durable("x", init=[torch.arange(6, dtype=torch.float32),
                               torch.ones(3, 2)])
    with ctx.commit(0):
        pass
    h.value[0].mul_(-1.0)               # the caller writes on at once
    h.value[1].zero_()
    ctx.drain()
    objs, step, _ = ctx.recover({"x": [0, 0]})
    assert step == 0
    assert torch.equal(objs["x"][0], torch.arange(6, dtype=torch.float32))
    assert torch.equal(objs["x"][1], torch.ones(3, 2))
    assert ctx.tiers.d2h_gather_bytes == 0     # host leaves: no D2H
    ctx.close()


@pytest.mark.parametrize("mode", ["async", "sharded", "sharded-async"])
def test_flush_threads_write_snapshots_off_the_callers_thread(
        mode, tmp_path, monkeypatch):
    """Every write of these schedules streams (``start_write``) on a flush
    thread, from leaves the caller no longer holds."""
    import threading
    seen = []
    orig = DSMPool.start_write

    def spy(self, name, version, tree, *a, **kw):
        seen.append((threading.current_thread() is threading.main_thread(),
                     [id(l) for l in tree_leaves(tree)]))
        return orig(self, name, version, tree, *a, **kw)
    monkeypatch.setattr(DSMPool, "start_write", spy)
    ctx = open_cxl0(str(tmp_path), schedule=mode, n_shards=2)
    x = [torch.arange(8, dtype=torch.float32), torch.ones(4, 3)]
    ctx.put({"x": x})
    with ctx.commit(0):
        pass
    ctx.drain()
    assert sum(len(ids) for _, ids in seen) == 2
    assert not any(on_main for on_main, _ in seen)
    if mode != "sharded":              # the async flushes own their copy
        held = {id(l) for l in x}
        assert not any(held & set(ids) for _, ids in seen)
    ctx.close()


# -- serving under each schedule ----------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    arch = "olmo-1b"
    cfg = get_smoke_config(arch).with_(**FP32)
    trace = synthetic_trace(N_REQ, vocab_size=cfg.vocab_size, **TRACE_KW)
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config(arch).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    ref_out = ref_build_engine(arch, smoke=True, n_slots=4, t_max=t_max,
                               bundle=rb, params=rp)[0].run(trace).outputs
    return dict(arch=arch, trace=trace, t_max=t_max, rb=rb, rp=rp, b=b,
                p=p, outputs=ref_out)


def _port(s, **kw):
    return build_serve_engine(s["arch"], smoke=True, n_slots=4,
                              t_max=s["t_max"], bundle=s["b"],
                              params=s["p"], device="cpu", **kw)[0]


def _ref(s, **kw):
    return ref_build_engine(s["arch"], smoke=True, n_slots=4,
                            t_max=s["t_max"], bundle=s["rb"],
                            params=s["rp"], **kw)[0]


def _bits(x):
    return raw_numpy(x)[0].tobytes()


def _recover_both(s, pool, block_tokens=16):
    theirs = RefStore(RefPool(pool)).recover(
        s["rb"].abstract_caches(1, s["t_max"]),
        pager=RefPager(s["rb"], s["t_max"], block_tokens))
    ours = SessionStore(pool).recover(
        BlockPager(s["b"], s["t_max"], block_tokens))
    assert ours.step == theirs.step and ours.seq == theirs.seq
    assert {r: x.to_meta() for r, x in ours.sessions.items()} == \
        {r: x.to_meta() for r, x in theirs.sessions.items()}
    assert {r: t.to_meta() for r, t in ours.tables.items()} == \
        {r: t.to_meta() for r, t in theirs.tables.items()}
    assert sorted(ours.caches) == sorted(theirs.caches) and ours.caches
    for rid in theirs.caches:
        assert [_bits(a) for a in tree_leaves(ours.caches[rid])] == \
            [_bits(np.asarray(a))
             for a in jax.tree_util.tree_leaves(theirs.caches[rid])]
    return ours.step


def _fresh_flushes(engine):
    return sum(st.n_objects for st in engine.store.committer.stats)


@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_serving_under_each_schedule_matches_the_reference(olmo, mode,
                                                           tmp_path):
    kw = dict(commit_every=COMMIT_EVERY, commit_mode=mode, n_shards=2)
    ours = _port(olmo, pool_path=str(tmp_path / "port"), **kw)
    res = ours.run(olmo["trace"])
    ours.close()
    theirs = _ref(olmo, pool_path=str(tmp_path / "ref"), **kw)
    rres = theirs.run(olmo["trace"])
    theirs.close()
    assert res.outputs == olmo["outputs"] == rres.outputs
    assert (res.decode_ticks, res.prefills, res.commits) == \
        (rres.decode_ticks, rres.prefills, rres.commits)
    # the async schedules re-flush each block staged at the commit before
    # (its entry is absorbed one commit late) — the reference's count too
    assert _fresh_flushes(ours) == _fresh_flushes(theirs)
    ms = DSMPool(str(tmp_path / "port")).manifests_desc()
    rms = RefPool(str(tmp_path / "ref")).manifests_desc()
    assert [(m["step"], sorted(m["objects"]), m["meta"]["sessions"])
            for m in ms] == \
        [(m["step"], sorted(m["objects"]), m["meta"]["sessions"])
         for m in rms]


@pytest.mark.parametrize("committer", ["port", "reference"])
@pytest.mark.parametrize("mode", COMMIT_MODES)
def test_each_package_recovers_the_others_serving_pool(olmo, mode,
                                                       committer, tmp_path):
    pool = str(tmp_path / "pool")
    make = _port if committer == "port" else _ref
    e = make(olmo, pool_path=pool, commit_every=COMMIT_EVERY,
             commit_mode=mode, n_shards=2)
    e.submit(olmo["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    e.store.ctx.crash()
    step = _recover_both(olmo, pool)
    assert step == (3 if "async" in mode else 6)


def test_sharded_async_serving_crash_resumes_one_commit_behind(olmo,
                                                               tmp_path):
    pool = str(tmp_path / "pool")
    kw = dict(pool_path=pool, commit_every=COMMIT_EVERY,
              commit_mode="sharded-async", n_shards=2)
    e = _port(olmo, **kw)
    e.submit(olmo["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    e.store.ctx.crash()
    del e
    back = _port(olmo, **kw)
    assert back.resume() == 3            # commit(6) only launched
    res = back.run(olmo["trace"])
    back.close()
    assert res.outputs == olmo["outputs"]
    assert res.resumed_sessions > 0


@pytest.mark.parametrize("committer", ["port", "reference"])
def test_a_non_default_block_size_crosses_pools(olmo, committer, tmp_path):
    """``block_tokens=8`` (half the default): both packages page a session
    into the same smaller blocks, each recovers the other's pool, and the
    other package resumes there and emits the reference's tokens."""
    pool = str(tmp_path / "pool")
    make, other = (_port, _ref) if committer == "port" else (_ref, _port)
    kw = dict(pool_path=pool, commit_every=COMMIT_EVERY, block_tokens=8)
    e = make(olmo, **kw)
    e.submit(olmo["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    e.store.ctx.crash()
    assert _recover_both(olmo, pool, block_tokens=8) == 6
    m = DSMPool(pool).latest_manifest()
    assert m["meta"]["block_tokens"] == 8
    # a 12-token prompt spans blocks 0 and 1 at 8 tokens (block 0 at 16)
    assert any(n.endswith("/b1") for n in m["objects"])
    back = other(olmo, **kw)
    assert back.resume() == 6
    res = back.run(olmo["trace"])
    back.close()
    assert res.outputs == olmo["outputs"]
