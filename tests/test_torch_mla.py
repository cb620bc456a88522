"""deepseek-v2's pieces in the port against the JAX package, one at a time,
on its fp32 smoke config with the reference's weights carried over
(``from_reference``) and numpy inputs from a seed:

* MLA's projections ``_mla_q`` / ``_mla_ckv`` (atol 1e-5: one or two fp32
  products and a norm);
* the expanded forward (``mla_forward``: K / V up-projected whole, the
  attention through the flash dispatcher, on the CPU its plain version)
  against the reference's, which expands chunk by chunk inside its
  ``chunked_attention`` (atol 1e-4: the same sums in another order);
* the absorbed decode (``mla_decode``) at per-sequence positions against
  the reference's scalar-position decode of each sequence alone, output
  and the latent written into the cache (atol 1e-4);
* the latent cache's paging: its leaves' token axis is the logical
  ``seq_kv`` the pager blocks, and a session committed from the same
  cache writes the reference's ``kv/<rid>/b<k>`` objects byte for byte;
* the MoE with shared experts on (the smoke config's one) and off, under
  the pooled route (the batch shares one routing) and the per-sequence
  route (each row alone, as the reference's per-slot decode): output and
  aux loss (atol 1e-5);
* on the card the flash backward takes MLA's published widths (q / k
  192, v 128) and refuses the smoke config's (24, 16): the dispatcher's
  check names the pairs it takes.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm.pool import DSMPool as RefPool
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models.registry import build as ref_build
from repro.serve.paging import BlockPager as RefPager
from repro.serve.paging import BlockRef as RefBlockRef
from repro.serve.paging import BlockTable as RefBlockTable
from repro.serve.paging import cache_token_axes as ref_token_axes
from repro.serve.sessions import Session as RefSession
from repro.serve.sessions import SessionStore as RefStore
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.pool import DSMPool
from repro_torch.kernels.attention import ops
from repro_torch.models import attention, moe
from repro_torch.models.attention import KVCache
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.paging import (STATE_BLOCK, BlockPager, BlockRef,
                                      BlockTable, cache_token_axes)
from repro_torch.serve.sessions import Session, SessionStore
from repro_torch.utils.convert import from_numpy
from repro_torch.utils.tree import tree_leaves, tree_structure

ARCH = "deepseek-v2-236b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
T_MAX = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    cfg = get_smoke_config(ARCH).with_(**FP32)
    rcfg = ref_smoke_config(ARCH).with_(**FP32)
    rb = ref_build(rcfg)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    # layer 0: MLA + the dense MLP; layer 1: MLA + MoE with a shared expert
    blocks = p["groups"][0]["blocks"]
    rblocks = rp["groups"][0]["blocks"]
    return dict(cfg=cfg, rcfg=rcfg, rb=rb, rp=rp, b=b, p=p,
                attn=blocks[1]["attn"], rattn=rblocks[1]["attn"],
                moe=blocks[1]["moe"], rmoe=rblocks[1]["moe"])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(ours, theirs, atol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=atol)


def test_mla_projections_match_the_reference(ds):
    x = _x((2, 11, ds["cfg"].d_model), 1)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    q_nope, q_rope = attention._mla_q(ds["cfg"], ds["attn"], tx, tpos)
    r_nope, r_rope = ref_attention._mla_q(ds["rcfg"], ds["rattn"],
                                          jnp.asarray(x), jnp.asarray(pos))
    ckv, k_rope = attention._mla_ckv(ds["cfg"], ds["attn"], tx, tpos)
    r_ckv, r_krope = ref_attention._mla_ckv(ds["rcfg"], ds["rattn"],
                                            jnp.asarray(x), jnp.asarray(pos))
    m = ds["cfg"].mla
    assert tuple(q_nope.shape) == (2, 11, 4, m.qk_nope_head_dim)
    assert tuple(ckv.shape) == (2, 11, m.kv_lora_rank)
    assert tuple(k_rope.shape) == (2, 11, m.qk_rope_head_dim)
    for ours, theirs in ((q_nope, r_nope), (q_rope, r_rope), (ckv, r_ckv),
                         (k_rope, r_krope)):
        _close(ours, theirs, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_expanded_forward_matches_the_reference(ds, causal):
    # 45 tokens: past the smoke config's 32-token attention chunk, so the
    # reference expands K / V over two chunks
    x = _x((2, 45, ds["cfg"].d_model), 2)
    pos = np.tile(np.arange(45, dtype=np.int32), (2, 1))
    before = ops.LAUNCHES
    ours = attention.mla_forward(ds["cfg"], ds["attn"], torch.from_numpy(x),
                                 torch.from_numpy(pos), causal=causal)
    assert ops.LAUNCHES == before          # the plain version counts none
    theirs = ref_attention.mla_forward(ds["rcfg"], ds["rattn"],
                                       jnp.asarray(x), jnp.asarray(pos),
                                       causal=causal)
    _close(ours, theirs, 1e-4)


def test_absorbed_decode_at_per_sequence_positions_matches_the_reference(
        ds):
    m = ds["cfg"].mla
    B = 3
    pos = np.asarray([5, 17, 0], np.int32)
    x = _x((B, 1, ds["cfg"].d_model), 3)
    ck = _x((B, T_MAX, m.kv_lora_rank), 4)
    cv = _x((B, T_MAX, m.qk_rope_head_dim), 5)
    cache = KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    y, cache = attention.mla_decode(ds["cfg"], ds["attn"],
                                    torch.from_numpy(x), cache,
                                    torch.from_numpy(pos))
    for b in range(B):
        ry, rc = ref_attention.mla_decode(
            ds["rcfg"], ds["rattn"], jnp.asarray(x[b:b + 1]),
            ref_attention.KVCache(jnp.asarray(ck[b:b + 1]),
                                  jnp.asarray(cv[b:b + 1])),
            jnp.asarray(pos[b]))
        _close(y[b:b + 1], ry, 1e-4)
        _close(cache.k[b:b + 1], rc.k, 1e-5)
        _close(cache.v[b:b + 1], rc.v, 1e-5)
    # only each sequence's own position was written
    for b in range(B):
        keep = np.arange(T_MAX) != pos[b]
        assert np.array_equal(cache.k[b].numpy()[keep], ck[b][keep])


def _commit_one(store, pager, session_cls, ref_cls, table_cls, cache1,
                prompt, emitted, block_tokens):
    """Stage a session's dirty blocks from ``cache1`` and commit it, as
    both packages' engines do (``ServeEngine._stage_paged`` and
    ``_commit``)."""
    s = session_cls(rid="r0", prompt=tuple(prompt), max_new_tokens=8,
                    emitted=list(emitted))
    table = table_cls()
    for bid, (blk, leaves) in enumerate(
            pager.slice_dirty(cache1, s.pos, table).items()):
        ref = ref_cls(blk=blk, bid=bid, tokens=0,
                      name=store.block_name("r0", blk))
        table.refs[blk] = ref
        if blk != STATE_BLOCK:
            ref.tokens = pager.tokens_in_block(blk, s.pos)
        store.stage_block(s, ref, leaves)
    store.commit_paged({"r0": s}, {"r0": table}, 4,
                       block_tokens=block_tokens)


def _kv_files(path):
    out = {}
    root = os.path.join(path, "objects", "kv")
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), path)] = fh.read()
    return out


def test_the_latent_cache_pages_as_the_references(ds, tmp_path):
    rb, b = ds["rb"], ds["b"]
    # every leaf (ckv and k_rope of both layers) is blocked on its seq_kv
    # axis, axis 1 of (batch, seq_kv, mla_lora)
    axes = tree_leaves(cache_token_axes(b))
    assert axes == jax.tree_util.tree_leaves(ref_token_axes(rb)) == [1] * 4
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 256, 21)]
    _, st = rb.prefill(ds["rp"], {"tokens": jnp.asarray([prompt], jnp.int32)},
                       rb.init_caches(jax.random.PRNGKey(0), 1, T_MAX))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.caches)]
    ours = tree_structure(b.abstract_caches(1, T_MAX)).unflatten(
        [from_numpy(l) for l in leaves])
    pager, rpager = BlockPager(b, T_MAX), RefPager(rb, T_MAX)
    m = ds["cfg"].mla
    assert pager.token_nbytes == rpager.token_nbytes == \
        2 * 4 * (m.kv_lora_rank + m.qk_rope_head_dim)
    store = SessionStore(str(tmp_path / "port"))
    rstore = RefStore(RefPool(str(tmp_path / "ref")))
    emitted = [7, 9]                         # pos 22: blocks 0 and 1
    _commit_one(store, pager, Session, BlockRef, BlockTable, ours, prompt,
                emitted, pager.block_tokens)
    _commit_one(rstore, rpager, RefSession, RefBlockRef, RefBlockTable,
                st.caches, prompt, emitted, rpager.block_tokens)
    got = _kv_files(str(tmp_path / "port"))
    assert sorted(n.rsplit("/", 2)[1] for n in got) == ["b0", "b1"]
    assert got == _kv_files(str(tmp_path / "ref"))
    assert DSMPool(str(tmp_path / "port")).latest_manifest()["objects"] == \
        RefPool(str(tmp_path / "ref")).latest_manifest()["objects"]


@pytest.mark.parametrize("shared", [1, 0], ids=["shared", "no_shared"])
@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["pooled", "per_sequence"])
def test_moe_with_and_without_shared_experts_matches_the_reference(
        ds, shared, per_sequence):
    cfg, rcfg = ds["cfg"], ds["rcfg"]
    p = dict(ds["moe"])
    rp = dict(ds["rmoe"])
    if not shared:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=0))
        rcfg = rcfg.with_(moe=dataclasses.replace(rcfg.moe, n_shared=0))
        del p["shared"], rp["shared"]
        assert "shared" not in moe.moe_descs(cfg)
    else:
        assert moe.moe_descs(cfg)["shared"]["w_up"].shape == \
            (cfg.d_model, cfg.moe.n_shared * cfg.moe.d_ff_expert)
    x = _x((3, 6, cfg.d_model), 7)
    y, aux = moe.moe_forward(cfg, p, torch.from_numpy(x),
                             per_sequence=per_sequence)
    if per_sequence:                        # each row routed alone
        outs = [ref_moe.moe_forward(rcfg, rp, jnp.asarray(x[b:b + 1]))
                for b in range(3)]
        ry = np.concatenate([np.asarray(o[0]) for o in outs], 0)
        raux = np.mean([float(o[1]) for o in outs])
    else:
        ry, raux = ref_moe.moe_forward(rcfg, rp, jnp.asarray(x))
    _close(y, ry, 1e-5)
    assert abs(float(aux) - float(raux)) <= 1e-5
    if shared:                              # the shared expert is in y
        p0 = {k: v for k, v in p.items() if k != "shared"}
        cfg0 = cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=0))
        y0, _ = moe.moe_forward(cfg0, p0, torch.from_numpy(x),
                                per_sequence=per_sequence)
        assert float((y - y0).abs().max()) > 1e-3


def test_mla_training_on_the_card_is_refused_by_the_flash_backward():
    """At the smoke config's MLA widths (q / k 24, v 16): the backward
    kernel takes MLA's published widths (192, 128) alone."""
    q = torch.zeros((1, 8, 4, 1, 24), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(hd, hd_v\) in"):
        ops._check_bwd(q, q[:, :, :, 0], v)
    q = torch.zeros((1, 8, 4, 1, 192), dtype=torch.bfloat16)
    ops._check_bwd(q, q[:, :, :, 0], torch.zeros((1, 8, 4, 128)))
