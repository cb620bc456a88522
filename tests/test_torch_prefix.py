"""Cross-engine prefix reuse and per-engine namespaces in the port, against
the JAX package, mirroring ``tests/test_paging.py``
(``test_prefix_hash_is_prefix_stable``,
``test_prefix_reuse_skips_prefill_bit_identically``).

* ``prefix_hash`` and the object names (``kvblk/``, ``kvhead/``,
  ``e<i>/kv/...``) are the reference's;
* from the same prefill cache and the reference's key, ``publish_prefix``
  writes the reference's ``kvblk/`` and ``kvhead/`` frames byte for byte
  (olmo-1b: KV blocks; rwkv6-7b: a head holding the recurrent state), and
  each package's ``load_prefix`` restores the other's publish;
* engines 1 and 2 on one pool: engine 2 serves the same prompts with 3
  hits, 0 prefills and engine 1's tokens; and across packages, with the
  reference's weights carried over and the reference's key, a port engine
  serves from the reference's published blocks (and the reverse) with the
  reference's tokens.  The port's default key names its own weights, so
  it never takes the reference's blocks;
* an engine's commits live under its namespace: engine 3's pool recovers
  in both packages as engine 3, and engine 0 sees none of it;
* a torn head degrades to a normal prefill.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm.pool import DSMPool as RefPool
from repro.models.registry import build as ref_build
from repro.serve.engine import build_serve_engine as ref_build_engine
from repro.serve.paging import BlockPager as RefPager
from repro.serve.paging import block_object_name as ref_block_name
from repro.serve.paging import prefix_hash as ref_prefix_hash
from repro.serve.sessions import SessionStore as RefStore
from repro.serve.sessions import engine_ns as ref_engine_ns
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.pool import DSMPool
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.engine import build_serve_engine
from repro_torch.serve.paging import (BlockPager, block_object_name,
                                      prefix_hash, shared_block_name,
                                      shared_head_name)
from repro_torch.serve.scheduler import Request
from repro_torch.serve.sessions import SessionStore, engine_ns
from repro_torch.utils.convert import from_numpy, raw_numpy
from repro_torch.utils.tree import tree_leaves, tree_structure

FP32 = dict(param_dtype="float32", compute_dtype="float32")
PROMPT = 20                          # one full 16-token block + a tail
REF_KEY = "olmo-1b|smoke|s0"         # the reference's key for these weights


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, t_max=40):
    cfg = get_smoke_config(arch).with_(**FP32)
    rb = ref_build(ref_smoke_config(arch).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(3)
    prompt = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT))
    return dict(arch=arch, cfg=cfg, t_max=t_max, rb=rb, rp=rp, b=b, p=p,
                prompt=prompt)


@pytest.fixture(scope="module")
def olmo():
    return _setup("olmo-1b")


def _pool_files(path, prefixes=("objects/kvblk", "objects/kvhead")):
    out = {}
    for d, _, fs in os.walk(path):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), path)
            if rel.startswith(prefixes):
                with open(os.path.join(d, f), "rb") as fh:
                    out[rel] = fh.read()
    return out


# -- names and hashes ---------------------------------------------------------

def test_prefix_hash_is_prefix_stable():
    a = prefix_hash("k", [1, 2, 3, 4], 4)
    assert prefix_hash("k", [1, 2, 3, 4], 4) == a
    assert prefix_hash("k", [1, 2, 3, 5], 4) != a
    assert prefix_hash("k2", [1, 2, 3, 4], 4) != a          # model identity
    assert prefix_hash("k", [1, 2, 3, 4], 2) != a           # block geometry


@pytest.mark.parametrize("seed", range(4))
def test_prefix_hash_and_names_are_the_references(seed):
    rng = np.random.default_rng(seed)
    toks = [int(t) for t in rng.integers(0, 50304, rng.integers(1, 90))]
    key = f"arch{seed}|smoke|s{seed}"
    bt = int(rng.integers(1, 33))
    h = prefix_hash(key, toks, bt)
    assert h == ref_prefix_hash(key, toks, bt)
    assert shared_block_name(h) == f"kvblk/{h:08x}"
    assert shared_head_name(h) == f"kvhead/{h:08x}"
    for eid in (0, seed + 1):
        assert engine_ns(eid) == ref_engine_ns(eid)
        for blk in (-1, 0, seed):
            assert block_object_name("r7", blk, engine_ns(eid)) == \
                ref_block_name("r7", blk, ref_engine_ns(eid))


# -- publish / load against the reference --------------------------------------

def _prefill_cache(s):
    """The reference's prefill of the prompt: its cache as numpy leaves
    and as the port's tree, and its first token."""
    rb = s["rb"]
    logits, st = rb.prefill(s["rp"],
                            {"tokens": jnp.asarray([s["prompt"]], jnp.int32)},
                            rb.init_caches(jax.random.PRNGKey(0), 1,
                                           s["t_max"]))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.caches)]
    ours = tree_structure(s["b"].abstract_caches(1, s["t_max"])).unflatten(
        [from_numpy(l) for l in leaves])
    return st.caches, ours, int(jnp.argmax(logits, -1)[0])


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-7b"])
def test_publish_prefix_writes_the_references_frames(arch, tmp_path):
    s = _setup(arch)
    theirs_cache, our_cache, tok0 = _prefill_cache(s)
    rstore = RefStore(RefPool(str(tmp_path / "ref")))
    rpager = RefPager(s["rb"], s["t_max"])
    n_ref = rstore.publish_prefix(rpager, REF_KEY, s["prompt"],
                                  theirs_cache, tok0)
    store = SessionStore(str(tmp_path / "port"))
    pager = BlockPager(s["b"], s["t_max"])
    assert pager.token_nbytes == rpager.token_nbytes
    n = store.publish_prefix(pager, REF_KEY, s["prompt"], our_cache, tok0)
    assert n == n_ref == PROMPT // 16 + 1
    ours = _pool_files(str(tmp_path / "port"))
    assert len(ours) == n and ours == _pool_files(str(tmp_path / "ref"))
    # write-once: a second publish of the same prompt writes nothing
    assert store.publish_prefix(pager, REF_KEY, s["prompt"], our_cache,
                                tok0) == 0
    # each package restores the other's publish, bit for bit
    got = store.load_prefix(pager, REF_KEY, s["prompt"])
    rgot = rstore.load_prefix(rpager, REF_KEY, s["prompt"])
    assert got is not None and rgot is not None
    assert got[2] == rgot[2] == tok0
    assert {k: e for k, (_, e) in got[1].items()} == \
        {k: e for k, (_, e) in rgot[1].items()}
    a = tree_leaves(pager.assemble(got[0]))
    b = jax.tree_util.tree_leaves(rpager.assemble(rgot[0]))
    assert [raw_numpy(x)[0].tobytes() for x in a] == \
        [np.asarray(y).tobytes() for y in b]
    assert [raw_numpy(x)[0].tobytes() for x in a] == \
        [raw_numpy(x)[0].tobytes() for x in tree_leaves(our_cache)]
    assert store.load_prefix(pager, "another model", s["prompt"]) is None


# -- engines on one pool ------------------------------------------------------

def _requests(s, tag, n=3, new=6):
    return [Request(rid=f"{tag}{i}", prompt=s["prompt"], max_new_tokens=new)
            for i in range(n)]


def _port(s, pool, **kw):
    return build_serve_engine(s["arch"], smoke=True, n_slots=2,
                              t_max=s["t_max"], bundle=s["b"], params=s["p"],
                              device="cpu", pool_path=pool, commit_every=2,
                              prefix_reuse=True, **kw)[0]


def _ref(s, pool, **kw):
    return ref_build_engine(s["arch"], smoke=True, n_slots=2,
                            t_max=s["t_max"], bundle=s["rb"], params=s["rp"],
                            pool_path=pool, commit_every=2, prefix_reuse=True,
                            **kw)[0]


def test_prefix_reuse_skips_prefill_bit_identically(olmo, tmp_path):
    pool = str(tmp_path / "pool")
    e1 = _port(olmo, pool, engine_id=1)
    r1 = e1.run(_requests(olmo, "a"))
    e1.close()
    assert (r1.prefills, r1.prefix_hits) == (1, 2)  # the first one publishes
    e2 = _port(olmo, pool, engine_id=2)
    r2 = e2.run(_requests(olmo, "b"))
    e2.close()
    assert r2.prefills == 0 and r2.prefix_hits == 3
    assert [r2.outputs[f"b{i}"] for i in range(3)] == \
        [r1.outputs[f"a{i}"] for i in range(3)]
    objs = os.path.join(pool, "objects")
    assert sorted(os.listdir(objs)) == ["e1", "e2", "kvblk", "kvhead"]
    engines = {m["meta"]["engine"] for m in DSMPool(pool).manifests_desc()}
    assert engines == {1, 2}


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_an_engine_serves_from_the_other_packages_prefix(olmo, publisher,
                                                         tmp_path):
    pool = str(tmp_path / "pool")
    first = (_ref(olmo, pool, engine_id=1) if publisher == "reference"
             else _port(olmo, pool, engine_id=1, prefix_key=REF_KEY))
    r1 = first.run(_requests(olmo, "a"))
    first.close()
    assert r1.prefills == 1
    second = (_port(olmo, pool, engine_id=2, prefix_key=REF_KEY)
              if publisher == "reference" else _ref(olmo, pool, engine_id=2))
    r2 = second.run(_requests(olmo, "b"))
    second.close()
    assert (r2.prefills, r2.prefix_hits) == (0, 3)
    assert [r2.outputs[f"b{i}"] for i in range(3)] == \
        [r1.outputs[f"a{i}"] for i in range(3)]


def test_the_default_key_names_the_ports_own_weights(olmo, tmp_path):
    pool = str(tmp_path / "pool")
    _ref(olmo, pool, engine_id=1).run(_requests(olmo, "a"))
    e = _port(olmo, pool, engine_id=2)
    assert e.prefix_key == REF_KEY + "|torch"
    res = e.run(_requests(olmo, "b"))
    e.close()
    assert (res.prefills, res.prefix_hits) == (1, 2)   # its own publish


def test_engine_namespaces_recover_in_both_packages(olmo, tmp_path):
    pool = str(tmp_path / "pool")
    e = _port(olmo, pool, engine_id=3)
    e.submit(_requests(olmo, "a", new=9))
    for _ in range(4):
        e.tick()
    e.store.ctx.crash()
    names = {m for m in DSMPool(pool).latest_manifest()["objects"]}
    assert names and all(n.startswith(("e3/kv/", "kvblk/")) for n in names)
    ours = SessionStore(pool, engine_id=3).recover(
        BlockPager(olmo["b"], olmo["t_max"]))
    theirs = RefStore(RefPool(pool), engine_id=3).recover(
        olmo["rb"].abstract_caches(1, olmo["t_max"]),
        pager=RefPager(olmo["rb"], olmo["t_max"]))
    assert (ours.step, ours.seq) == (theirs.step, theirs.seq) == (4, 1)
    assert {r: t.to_meta() for r, t in ours.tables.items()} == \
        {r: t.to_meta() for r, t in theirs.tables.items()}
    for rid in theirs.caches:
        assert [raw_numpy(a)[0].tobytes()
                for a in tree_leaves(ours.caches[rid])] == \
            [np.asarray(a).tobytes()
             for a in jax.tree_util.tree_leaves(theirs.caches[rid])]
    assert SessionStore(pool).recover(
        BlockPager(olmo["b"], olmo["t_max"])) is None    # engine 0: nothing
    back = _port(olmo, pool, engine_id=3)
    assert back.resume() == 4
    res = back.run(_requests(olmo, "a", new=9))
    back.close()
    assert res.resumed_sessions == 2 and res.prefills == 0


def test_a_torn_head_degrades_to_a_prefill(olmo, tmp_path):
    pool = str(tmp_path / "pool")
    _port(olmo, pool, engine_id=1).run(_requests(olmo, "a", n=1))
    heads = os.path.join(pool, "objects", "kvhead")
    (name,) = os.listdir(heads)
    (fn,) = os.listdir(os.path.join(heads, name))
    path = os.path.join(heads, name, fn)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])
    e = _port(olmo, pool, engine_id=2)
    assert e.store.load_prefix(e.pager, e.prefix_key, olmo["prompt"]) is None
    res = e.run(_requests(olmo, "b", n=1))
    assert (res.prefills, res.prefix_hits) == (1, 0)
