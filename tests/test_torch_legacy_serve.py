"""The legacy whole-lane serving layout and the KV cache's tiers in the port
(``ServeEngine(paged=False)``, ``SessionStore.stage`` / ``commit`` /
``_read_legacy``, ``TieredKVCache.stage`` / ``spill*`` / ``restore``)
against the JAX package's, on olmo-1b's smoke config.

* the twin of ``tests/test_paging.py:237``: the legacy and the paged
  engines emit equal token streams with equal ticks, prefills and
  commits (the port's own weights, fp32 and the config's bf16);
* the port's legacy engine against the reference's (the reference's
  weights carried over, fp32): equal tokens; equal manifests' steps and
  session tables, and equal object names, versions, CRCs and sizes (the
  retention GC keeps the same two manifests in both); each package
  recovers the pool the other's legacy engine committed before a crash
  (7 ticks, commit every 3: not a commit tick) and finishes with the
  uninterrupted run's tokens;
* the twin of ``tests/test_placement.py:224``
  ``test_spill_auto_routes_by_policy_and_restores``: under
  ``cxl11-direct`` the policy spills a prefilled cache to staging (the
  object tier and a peer's buffer) and ``restore`` gives it back; under a
  ``cxl30-fabric`` policy whose staging is hopeless it spills to the pool
  and restores from the entry; every restore is bit-identical, and the
  logged decisions and the pool entry's layout equal the reference's;
* ``spill_durable`` and peer ``spill`` round trips through each tier,
  and a lane copied out and written back (``read_slot`` /
  ``write_slot``) unchanged.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm.placement import PlacementPolicy as RefPolicy
from repro.dsm.pool import DSMPool as RefPool
from repro.dsm.tiers import TierManager as RefTiers
from repro.models.registry import build as ref_build
from repro.serve.engine import build_serve_engine as ref_build_engine
from repro.serve.kvcache import TieredKVCache as RefKV
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.placement import PlacementPolicy
from repro_torch.dsm.pool import DSMPool
from repro_torch.dsm.tiers import TierManager
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.engine import ServeEngine, build_serve_engine
from repro_torch.serve.kvcache import TieredKVCache
from repro_torch.serve.sessions import SessionStore
from repro_torch.serve.trace import synthetic_trace, trace_t_max
from repro_torch.utils.convert import raw_numpy
from repro_torch.utils.tree import tree_leaves

ARCH = "olmo-1b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TRACE_KW = dict(prompt_lens=(8, 12), new_tokens=(4, 8, 16), seed=3)
N_REQ = 6
COMMIT_EVERY = 3
CRASH_AFTER = 7                    # ticks; 7 % 3 != 0: not a commit tick


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH).with_(**FP32)
    trace = synthetic_trace(N_REQ, vocab_size=cfg.vocab_size, **TRACE_KW)
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config(ARCH).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return dict(trace=trace, t_max=t_max, rb=rb, rp=rp, b=b, p=p)


def _bits(x):
    return raw_numpy(x)[0].tobytes()


def _port(s, **kw):
    return build_serve_engine(ARCH, smoke=True, n_slots=4, t_max=s["t_max"],
                              bundle=s["b"], params=s["p"], device="cpu",
                              **kw)[0]


def _ref(s, **kw):
    return ref_build_engine(ARCH, smoke=True, n_slots=4, t_max=s["t_max"],
                            bundle=s["rb"], params=s["rp"], **kw)[0]


# -- the paging test's twin ----------------------------------------------------

@pytest.mark.parametrize("dtypes", ["fp32", "bf16"])
def test_paged_engine_equivalent_to_legacy(tmp_path, dtypes):
    cfg = get_smoke_config(ARCH)
    if dtypes == "fp32":
        cfg = cfg.with_(**FP32)
    trace = synthetic_trace(N_REQ, vocab_size=cfg.vocab_size, **TRACE_KW)
    t_max = trace_t_max(trace)
    bundle = build(cfg, device="cpu")
    params = bundle.init_params(torch.Generator().manual_seed(0))

    def engine(path, **kw):
        return ServeEngine(bundle, params, n_slots=2, t_max=t_max,
                           store=SessionStore(str(path)), commit_every=2,
                           **kw)

    legacy = engine(tmp_path / "legacy", paged=False)
    r0 = legacy.run(trace)
    legacy.close()
    paged = engine(tmp_path / "paged", paged=True, block_tokens=8)
    r1 = paged.run(trace)
    paged.close()
    assert r1.outputs == r0.outputs
    assert (r1.decode_ticks, r1.prefills, r1.commits) \
        == (r0.decode_ticks, r0.prefills, r0.commits)


# -- against the reference's legacy engine -------------------------------------

def _manifest_view(pool):
    return [(m["step"], m["meta"],
             {n: (e["version"], e["crc"], e["nbytes"])
              for n, e in m["objects"].items()})
            for m in DSMPool(pool).manifests_desc()]


def test_legacy_engine_emits_the_references_tokens_and_manifests(
        setup, tmp_path):
    kw = dict(commit_every=COMMIT_EVERY, paged=False)
    ours = _port(setup, pool_path=str(tmp_path / "p"), **kw)
    r_ours = ours.run(setup["trace"])
    ours.close()
    theirs = _ref(setup, pool_path=str(tmp_path / "r"), **kw)
    r_theirs = theirs.run(setup["trace"])
    theirs.close()
    assert r_ours.outputs == r_theirs.outputs
    assert (r_ours.commits, r_ours.prefills) == \
        (r_theirs.commits, r_theirs.prefills)
    mp = _manifest_view(str(tmp_path / "p"))
    assert len(mp) == 2                      # build_serve_engine's retention
    assert mp == _manifest_view(str(tmp_path / "r"))


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_each_package_recovers_the_others_legacy_pool(setup, tmp_path,
                                                      writer, reader):
    kw = dict(commit_every=COMMIT_EVERY, paged=False)
    full = _ref(setup, **kw).run(setup["trace"]).outputs
    pool = str(tmp_path / "pool")
    make = {"port": _port, "ref": _ref}
    e = make[writer](setup, pool_path=pool, **kw)
    e.submit(setup["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    e.store.ctx.crash()                      # dropped without finish()
    del e
    again = make[reader](setup, pool_path=pool, **kw)
    step = again.resume()
    assert step == CRASH_AFTER - CRASH_AFTER % COMMIT_EVERY
    n_done = len(again.results)
    res = again.run(setup["trace"])
    assert res.outputs == full
    assert res.resumed_sessions > 0
    # the running sessions came back from their committed lanes
    assert res.prefills == N_REQ - n_done - res.resumed_sessions


# -- the KV cache's tiers --------------------------------------------------------

def _filled(setup):
    """One prefilled single-sequence cache in each package (8 tokens)."""
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0,
                                         64))
    _, rst = setup["rb"].prefill(setup["rp"], {"tokens": toks},
                                 setup["rb"].init_caches(
                                     jax.random.PRNGKey(0), 1,
                                     setup["t_max"]))
    _, st = setup["b"].prefill(setup["p"],
                               {"tokens": torch.tensor(toks).long()},
                               setup["b"].init_caches(1, setup["t_max"]))
    return st.caches, rst.caches


def _same(a, b):
    assert [_bits(x) for x in tree_leaves(a)] == \
        [_bits(x) for x in tree_leaves(b)]


def test_spill_auto_routes_by_policy_and_restores(setup, tmp_path):
    c1, _ = _filled(setup)
    b, t_max = setup["b"], setup["t_max"]
    # direct-attach: small caches go to staging (object tier + peer buffer)
    tiers = TierManager(DSMPool(str(tmp_path / "a")), 0)
    peer = TierManager(DSMPool(str(tmp_path / "peer")), 1)
    kv = TieredKVCache(b, 2, t_max, tiers=tiers,
                       placement=PlacementPolicy("cxl11-direct"))
    info = kv.spill_auto("kv/s0", c1, peer=peer)
    assert info["tier"] == "staging"
    _same(kv.restore("kv/s0"), c1)
    # ...and the copy really reached the peer's buffer (survives our loss)
    assert "kv/s0" in peer.staging
    _same(peer.rload("kv/s0"), c1)

    # the fabric at the same size, with staging made hopeless: the pool
    tiers2 = TierManager(DSMPool(str(tmp_path / "b")), 0)
    pol = PlacementPolicy("cxl30-fabric", p_peer_loss=1.0,
                          replay_ns_per_byte=1e3)
    kv2 = TieredKVCache(b, 2, t_max, tiers=tiers2, placement=pol)
    info2 = kv2.spill_auto("kv/s0", c1)
    assert info2["tier"] == "pool" and "entry" in info2
    tiers2.ldiscard("kv/s0")             # force the pool read path
    _same(kv2.restore("kv/s0", entry=info2["entry"]), c1)
    decisions = pol.decisions_for("spill")
    assert decisions and decisions[0].choice == "pool"

    # the reference's policies decide the same on the same bytes
    _, rc1 = _filled(setup)
    rpol = RefPolicy("cxl30-fabric", p_peer_loss=1.0,
                     replay_ns_per_byte=1e3)
    rtiers = RefTiers(RefPool(str(tmp_path / "rb")), 0)
    rkv = RefKV(setup["rb"], 2, t_max, tiers=rtiers, placement=rpol)
    rinfo = rkv.spill_auto("kv/s0", rc1)
    assert {k: v for k, v in rinfo.items() if k != "entry"} == \
        {k: v for k, v in info2.items() if k != "entry"}
    assert [dataclasses.astuple(d) for d in pol.decisions] == \
        [dataclasses.astuple(d) for d in rpol.decisions]
    # the same layout (fp32 prefills round differently in the two
    # packages, so the shards' CRCs are not compared)
    for k in ("n_leaves", "nbytes", "assignment", "version"):
        assert info2["entry"][k] == rinfo["entry"][k]
    assert [(s["name"], s["nbytes"]) for s in info2["entry"]["shards"]] == \
        [(s["name"], s["nbytes"]) for s in rinfo["entry"]["shards"]]
    for t in (tiers, peer, tiers2, rtiers):
        t.close()


def test_lanes_and_each_tier_round_trip(setup, tmp_path):
    c1, _ = _filled(setup)
    b, t_max = setup["b"], setup["t_max"]
    tiers = TierManager(DSMPool(str(tmp_path / "a")), 0)
    peer = TierManager(DSMPool(str(tmp_path / "peer")), 1)
    kv = TieredKVCache(b, 3, t_max, tiers=tiers)
    kv.write_slot(2, c1)
    lane = kv.read_slot(2)
    _same(lane, c1)
    v = kv.spill("kv/x", lane, peer=peer)
    assert v == 1 and peer.staging["kv/x"][0] == 1
    kv.discard("kv/x")
    assert "kv/x" not in tiers.hbm
    assert kv.restore("kv/x") is None        # nothing staged INTO us
    _same(peer.rload("kv/x"), c1)
    n = len(tree_leaves(c1))                 # k and v
    entry = kv.spill_durable("kv/y", lane, n_blocks=n)
    assert entry["sharded"] and len(entry["shards"]) == n
    assert sorted(i for g in kv.block_layout(n) for i in g) == \
        list(range(n))
    assert len(kv.block_layout()) == 1       # one host device
    _same(kv.restore("kv/y", drop_hot=True), c1)
    assert "kv/y" not in tiers.hbm
    _same(kv.restore("kv/y", entry=entry), c1)
    kv.write_slot(0, kv.restore("kv/y", entry=entry))
    _same(kv.read_slot(0), c1)
    with pytest.raises(ValueError, match="PlacementPolicy"):
        kv.spill_auto("kv/z", lane)
    with pytest.raises(NotImplementedError, match="A7"):
        TieredKVCache(b, 1, t_max, parallel=type("P", (), {"mesh": 1})())
    tiers.close()
    peer.close()
