"""The port's RWKV-6 path against the JAX package's: the WKV dispatcher,
its plain versions, the rwkv block and the rwkv6-7b LM.

* the WKV: the port's dispatcher on the CPU against the JAX TPU kernel run
  the way the reference's own tests run it (``pallas_interpret``: the
  Pallas interpreter here) and against both packages' step-by-step
  oracles, on the reference's ``WKV_CASES`` (``tests/test_kernels.py``)
  with a non-zero S0, in fp32 and with bf16 inputs.  Tolerances are the
  reference test's own: y atol 5e-4 in fp32, 0.2 against the bf16 output
  of the TPU kernel (the port keeps y in fp32: one bf16 rounding of |y|
  up to ~20 is 0.06); the state atol 5e-3.  Against the fp32 oracle on the
  same bf16-valued inputs the port's fp32 y is held to 5e-4;
* the port's chunked closed form against the reference model's
  ``_wkv_chunked`` (atol and rtol 1e-5: the same fp32 arithmetic, summed
  in another order);
* the model: ``rwkv_time_mix`` / ``rwkv_channel_mix`` with and without a
  cache at T > 1 and T = 1, ``block_forward``, and ``lm.forward`` /
  ``prefill`` / ``decode_step`` / the slot decode on the fp32 smoke config
  (atol 1e-5 for a block, 1e-4 through the LM);
* structure: param and cache descriptor trees equal the reference's
  (shapes, dtypes, logical axes, leaf order); ``param_count`` of the full
  config is 7,575,044,096;
* paging: a cache with no token axis gives empty ``b<k>`` block objects
  plus a ``state`` object, with the reference's names and frame bytes.

Weights are the reference's ``jax.random`` params carried across; inputs
are numpy from a seed.  The CUDA kernel has no CPU mode:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against the
plain version on the card.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm import stream as ref_stream
from repro.kernels.rwkv6.kernel import wkv6_kernel
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import lm as ref_lm
from repro.models import rwkv as ref_rwkv
from repro.models.params import init_params as ref_init_params
from repro.models.registry import build as ref_build
from repro.serve.paging import BlockPager as RefPager
from repro.serve.paging import BlockTable as RefTable
from repro.train.step import make_slot_decode_step as ref_slot_decode_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dsm import stream
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_chunked, wkv6_ref
from repro_torch.models import lm, rwkv
from repro_torch.models.params import from_reference, is_desc
from repro_torch.models.registry import build
from repro_torch.serve.paging import STATE_BLOCK, BlockPager, BlockTable
from repro_torch.train.step import make_slot_decode_step
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "rwkv6-7b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = 1e-5
LM_ATOL = 1e-4
T_MAX = 24

# tests/test_kernels.py WKV_CASES: B, T, H, n, block_t
WKV_CASES = [
    (2, 128, 2, 32, 32), (1, 96, 4, 64, 64), (2, 100, 2, 16, 32),
    (1, 33, 1, 64, 16),
]
WKV_IDS = [f"B{c[0]}T{c[1]}H{c[2]}n{c[3]}bt{c[4]}" for c in WKV_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wkv_inputs(B, T, H, n, seed=0):
    """The reference sweep's distributions, from numpy: r, k * 0.5, v,
    logw = -exp(N * 0.5), u * 0.3, S0 * 0.1."""
    g = np.random.default_rng(seed)
    r = g.standard_normal((B, T, H, n), np.float32)
    k = g.standard_normal((B, T, H, n), np.float32) * 0.5
    v = g.standard_normal((B, T, H, n), np.float32)
    logw = -np.exp(g.standard_normal((B, T, H, n), np.float32) * 0.5)
    u = g.standard_normal((H, n), np.float32) * 0.3
    S0 = g.standard_normal((B, H, n, n), np.float32) * 0.1
    return r, k, v, logw, u, S0


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The WKV and its plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES, ids=WKV_IDS)
def test_dispatcher_matches_pallas_kernel_and_oracles(case, dtype,
                                                      pallas_interpret):
    B, T, H, n, bt = case
    r, k, v, logw, u, S0 = _wkv_inputs(B, T, H, n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jr, jk, jv = (jnp.asarray(a, jdt) for a in (r, k, v))
    y_kern, S_kern = wkv6_kernel(jr, jk, jv, jnp.asarray(logw),
                                 jnp.asarray(u), jnp.asarray(S0),
                                 block_t=bt, interpret=pallas_interpret)
    y_orc, S_orc = jax_wkv6_ref(jr, jk, jv, jnp.asarray(logw),
                                jnp.asarray(u), jnp.asarray(S0))
    tr, tk, tv = (_t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
                  for a in (jr, jk, jv))
    before = ops.LAUNCHES
    y, S = ops.wkv6(tr, tk, tv, _t(logw), _t(u), _t(S0), chunk=bt)
    assert ops.LAUNCHES == before            # the CPU path launches nothing
    assert y.dtype == S.dtype == torch.float32
    assert tuple(y.shape) == (B, T, H, n) and tuple(S.shape) == (B, H, n, n)
    y_tol = 0.2 if dtype == "bfloat16" else 5e-4
    np.testing.assert_allclose(y.numpy(), np.asarray(y_kern, np.float32),
                               atol=y_tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_orc), atol=5e-4)
    for theirs in (S_kern, S_orc):
        np.testing.assert_allclose(S.numpy(), np.asarray(theirs), atol=5e-3)
    # the port's own oracle against the reference's
    y_o, S_o = wkv6_ref(tr, tk, tv, _t(logw), _t(u), _t(S0))
    np.testing.assert_allclose(y_o.numpy(), np.asarray(y_orc), atol=ATOL)
    np.testing.assert_allclose(S_o.numpy(), np.asarray(S_orc), atol=ATOL)


@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16), (7, 16), (33, 8)])
def test_chunked_form_matches_reference_model_chunked(T, chunk):
    B, H, n = 2, 2, 16
    r, k, v, logw, u, S0 = _wkv_inputs(B, T, H, n, seed=1)
    y_r, S_r = ref_rwkv._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, S0)), chunk=chunk,
        unroll=False)
    y, S = wkv6_chunked(*(_t(a) for a in (r, k, v, logw, u, S0)),
                        chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_r), atol=ATOL,
                               rtol=ATOL)


def test_dispatcher_writes_state_out_in_place_on_cpu():
    r, k, v, logw, u, S0 = (_t(a) for a in _wkv_inputs(1, 9, 2, 16, seed=2))
    want_y, want_S = ops.wkv6(r, k, v, logw, u, S0.clone(), chunk=4)
    S = S0.clone()
    y, got = ops.wkv6(r, k, v, logw, u, S, chunk=4, state_out=S)
    assert got is S
    assert torch.equal(S, want_S) and torch.equal(y, want_y)


def test_dispatcher_at_t1_is_the_direct_recurrence():
    r, k, v, logw, u, S0 = (_t(a) for a in _wkv_inputs(3, 1, 2, 16, seed=3))
    y, S = ops.wkv6(r, k, v, logw, u, S0)
    w = torch.exp(logw[:, 0])
    S_plus = S0 + (u * k[:, 0])[..., None] * v[:, 0, :, None, :]
    assert torch.equal(y[:, 0], torch.einsum("bhij,bhi->bhj", S_plus,
                                             r[:, 0]))
    assert torch.equal(S, w[..., None] * S0
                       + k[:, 0, ..., None] * v[:, 0, :, None, :])


def test_dispatcher_refuses_tensors_on_two_devices():
    r = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError):
        ops.wkv6(r, r, r, r.to("meta"), torch.zeros((1, 16)))


# ---------------------------------------------------------------------------
# The rwkv block
# ---------------------------------------------------------------------------

def _cfgs():
    return (get_smoke_config(ARCH).with_(**FP32),
            ref_smoke_config(ARCH).with_(**FP32))


@pytest.fixture(scope="module")
def block_params():
    cfg, ref_cfg = _cfgs()
    rp = ref_init_params(ref_rwkv.rwkv_descs(ref_cfg), jax.random.PRNGKey(0),
                         "float32")
    # non-trivial group-norm affine, so a missing one shows
    g = np.random.default_rng(7)
    rp = dict(rp, gn_scale=jnp.asarray(
        1 + 0.3 * g.standard_normal(rp["gn_scale"].shape), jnp.float32),
        gn_bias=jnp.asarray(0.1 * g.standard_normal(rp["gn_bias"].shape),
                            jnp.float32))
    return cfg, ref_cfg, rp, from_reference(
        jax.tree_util.tree_map(np.asarray, rp), "cpu")


def _cache(cfg, B, seed):
    """A random (non-zero) rwkv cache, as numpy leaves."""
    d = cfg.d_model
    H, n = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, 1, d), np.float32),
            g.standard_normal((B, 1, d), np.float32),
            g.standard_normal((B, H, n, n), np.float32) * 0.1)


@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["no_cache", "cache"])
@pytest.mark.parametrize("S", [11, 1])
def test_time_and_channel_mix_match_reference(block_params, S, with_cache):
    cfg, ref_cfg, rp, p = block_params
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model),
                                                 np.float32)
    if with_cache:
        leaves = _cache(cfg, 2, seed=4)
        rc = ref_rwkv.RWKVCache(*(jnp.asarray(a) for a in leaves))
        pc = rwkv.RWKVCache(*(_t(a.copy()) for a in leaves))
    else:
        rc = pc = None
    ry, (r_last, r_S) = ref_rwkv.rwkv_time_mix(ref_cfg, rp, jnp.asarray(x),
                                               rc)
    y, (last, S_last) = rwkv.rwkv_time_mix(cfg, p, _t(x), pc)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_array_equal(last.numpy(), np.asarray(r_last))
    np.testing.assert_allclose(S_last.numpy(), np.asarray(r_S), atol=ATOL)
    if with_cache:
        assert S_last is pc.S                # the cache's state, in place
    ry2, r_lc = ref_rwkv.rwkv_channel_mix(ref_cfg, rp, jnp.asarray(x), rc)
    y2, lc = rwkv.rwkv_channel_mix(cfg, p, _t(x), pc)
    np.testing.assert_allclose(y2.numpy(), np.asarray(ry2), atol=ATOL)
    np.testing.assert_array_equal(lc.numpy(), np.asarray(r_lc))


@pytest.mark.parametrize("S", [9, 1])
def test_block_forward_matches_reference_and_updates_cache_in_place(S):
    cfg, ref_cfg = _cfgs()
    kind = ("rwkv", "dense")
    rp = ref_init_params(ref_lm.block_descs(ref_cfg, kind),
                         jax.random.PRNGKey(1), "float32")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    assert sorted(p) == ["norm1", "norm2", "rwkv"]
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model),
                                                 np.float32)
    leaves = _cache(cfg, 2, seed=6)
    pos = np.full((2, S), 3, np.int32)
    rx, rcache, _ = ref_lm.block_forward(
        ref_cfg, kind, rp, jnp.asarray(x), jnp.asarray(pos),
        cache=ref_rwkv.RWKVCache(*(jnp.asarray(a) for a in leaves)),
        decode=S == 1)
    cache = rwkv.RWKVCache(*(_t(a.copy()) for a in leaves))
    ptrs = [l.data_ptr() for l in cache]
    ox, ocache, aux = lm.block_forward(cfg, p, _t(x), _t(pos), cache=cache,
                                       decode=S == 1)
    assert aux == 0.0
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), atol=ATOL)
    assert [l.data_ptr() for l in ocache] == ptrs          # in place
    for a, b in zip(ocache, rcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------

def _desc_rows(tree, ref):
    leaves = (jax.tree_util.tree_leaves(tree, is_leaf=lambda d: hasattr(
        d, "logical")) if ref else tree_leaves(tree, is_leaf=is_desc))
    return [(tuple(d.shape), tuple(d.logical), d.dtype, d.init)
            for d in leaves]


def test_descriptor_trees_equal_reference():
    cfg, ref_cfg = _cfgs()
    assert _desc_rows(lm.model_descs(cfg), False) == \
        _desc_rows(ref_lm.model_descs(ref_cfg), True)
    assert _desc_rows(lm.cache_descs(cfg, 3, T_MAX), False) == \
        _desc_rows(ref_lm.cache_descs(ref_cfg, 3, T_MAX), True)
    assert type(lm.cache_descs(cfg, 1, 4)[0]["blocks"][0]).__name__ == \
        "RWKVCache"
    assert rwkv.RWKVCache._fields == ref_rwkv.RWKVCache._fields


def test_full_config_param_count():
    assert get_config(ARCH).param_count() == \
        ref_config(ARCH).param_count() == 7_575_044_096
    assert get_config(ARCH) == get_config(ARCH).with_()       # frozen data
    full, ref_full = get_config(ARCH), ref_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size,
            full.rwkv.head_dim) == (ref_full.n_layers, ref_full.d_model,
                                    ref_full.d_ff, ref_full.vocab_size,
                                    ref_full.rwkv.head_dim) == \
        (32, 4096, 14336, 65536, 64)


# ---------------------------------------------------------------------------
# The LM and its serving steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg, ref_cfg = _cfgs()
    rb = ref_build(ref_cfg)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return rb, rp, b, p


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.int32)


def _assert_caches_close(ours, theirs):
    ol = tree_leaves(ours)
    tl = jax.tree_util.tree_leaves(theirs)
    assert len(ol) == len(tl) == 3
    for a, bb in zip(ol, tl):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=LM_ATOL)


def test_params_match_the_reference_tree(models):
    rb, rp, b, p = models
    assert [tuple(l.shape) for l in tree_leaves(p)] == \
        [l.shape for l in jax.tree_util.tree_leaves(rp)]
    assert [tuple(s.shape) for s in tree_leaves(b.abstract_params())] == \
        [l.shape for l in jax.tree_util.tree_leaves(rp)]


def test_forward_logits_match_reference(models):
    rb, rp, b, p = models
    toks = _tokens((2, 20))
    theirs, _ = rb.forward(rp, jnp.asarray(toks))
    ours = b.forward(p, torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=LM_ATOL)


def test_prefill_and_three_decode_steps_match_reference(models):
    rb, rp, b, p = models
    toks = _tokens((1, 21), seed=1)           # ragged: 16-token chunk + 5
    r_logits, r_st = rb.prefill(rp, {"tokens": jnp.asarray(toks)},
                                rb.init_caches(jax.random.PRNGKey(0), 1,
                                               T_MAX))
    logits, st = b.prefill(p, {"tokens": torch.from_numpy(toks).long()},
                           b.init_caches(1, T_MAX))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=LM_ATOL)
    _assert_caches_close(st.caches, r_st.caches)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)[:, None]
        r_logits, r_st = rb.decode(rp, jnp.asarray(nxt), r_st)
        logits, st = b.decode(p, torch.from_numpy(nxt).long(), st)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   atol=LM_ATOL)
        _assert_caches_close(st.caches, r_st.caches)
        assert int(st.pos) == int(r_st.pos)


def _slot_state(models, prompt_lens, seed=2):
    rb, rp, _, _ = models
    lanes, last = [], []
    for i, L in enumerate(prompt_lens):
        lg, st = rb.prefill(rp, {"tokens": jnp.asarray(
            _tokens((1, L), seed + i))},
            rb.init_caches(jax.random.PRNGKey(0), 1, T_MAX))
        lanes.append(st.caches)
        last.append(int(jnp.argmax(lg, -1)[0]))
    caches = jax.tree_util.tree_map(lambda *a: jnp.concatenate(a, 1),
                                    *lanes)        # batch axis 1 (stacked)
    return caches, np.asarray(last, np.int32), np.asarray(prompt_lens,
                                                          np.int32)


def _port_caches(b, ref_caches, batch):
    leaves, td = tree_flatten(b.init_caches(batch, T_MAX))
    ref_leaves = jax.tree_util.tree_leaves(ref_caches)
    assert len(ref_leaves) == len(leaves)
    return td.unflatten([torch.from_numpy(np.array(l)) for l in ref_leaves])


def test_slot_decode_at_different_positions_matches_reference(models):
    rb, rp, b, p = models
    caches, last, pos = _slot_state(models, [5, 9, 18, 7])
    active = np.asarray([True, True, False, True])
    r_step = jax.jit(ref_slot_decode_step(rb))
    ours_step = make_slot_decode_step(b)
    pc = _port_caches(b, caches, 4)
    tp = torch.from_numpy(pos)
    tok_r, tok_p = last[:, None], torch.from_numpy(last[:, None]).long()
    for _ in range(2):
        r_next, r_logits, caches, r_pos = r_step(
            rp, jnp.asarray(tok_r), caches, jnp.asarray(pos),
            jnp.asarray(active))
        p_next, p_logits, pc, tp = ours_step(
            p, tok_p, pc, tp, torch.from_numpy(active))
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                                   atol=LM_ATOL)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(r_pos))
        np.testing.assert_array_equal(p_next.numpy(), np.asarray(r_next))
        _assert_caches_close(pc, caches)
        pos = np.asarray(r_pos)
        tok_r = np.asarray(r_next)[:, None]
        tok_p = p_next[:, None].long()


def test_a_slot_is_unchanged_when_the_other_lanes_hold_other_sessions(
        models):
    """Lane 0 holds the same session in two batches whose other lanes hold
    different sessions: its logits, tokens and state stay bit-identical."""
    _, _, b, p = models
    step = make_slot_decode_step(b)
    active = torch.ones(4, dtype=torch.bool)

    def run(seed_of_others):
        caches, last, pos = _slot_state(models, [6, 9, 13, 7],
                                        seed=seed_of_others)
        lane0, last0, pos0 = _slot_state(models, [6], seed=11)
        caches = jax.tree_util.tree_map(
            lambda a, a0: a.at[:, :1].set(a0), caches, lane0)
        last[0], pos[0] = last0[0], pos0[0]
        pc = _port_caches(b, caches, 4)
        tok = torch.from_numpy(last[:, None]).long()
        tp = torch.from_numpy(pos)
        outs = []
        for _ in range(3):
            nxt, logits, pc, tp = step(p, tok, pc, tp, active)
            outs.append((nxt.clone(), logits.clone()))
            tok = nxt[:, None].long()
        return outs, pc

    base, base_c = run(20)
    other, other_c = run(40)
    assert not torch.equal(base[0][1][1:], other[0][1][1:])
    for (bn, bl), (on, ol) in zip(base, other):
        assert torch.equal(bl[0], ol[0]) and int(bn[0]) == int(on[0])
    for bc, oc in zip(tree_leaves(base_c), tree_leaves(other_c)):
        assert torch.equal(bc[:, 0], oc[:, 0])


# ---------------------------------------------------------------------------
# Paging a cache with no token axis
# ---------------------------------------------------------------------------

def _frame_bytes(write, leaves):
    f = io.BytesIO()
    write(f, leaves)
    return f.getvalue()


@pytest.mark.parametrize("pos", [1, 16, 21])
def test_state_only_cache_pages_as_empty_blocks_plus_state(models, pos):
    rb, _, b, _ = models
    t_max = 40
    leaves = [np.random.default_rng(9).standard_normal(
        s.shape).astype(np.float32)
        for s in jax.tree_util.tree_leaves(rb.abstract_caches(1, t_max))]
    ref_cache = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(rb.abstract_caches(1, t_max)),
        [jnp.asarray(a) for a in leaves])
    our_cache = tree_flatten(b.init_caches(1, t_max))[1].unflatten(
        [_t(a) for a in leaves])
    ref_pager, pager = RefPager(rb, t_max), BlockPager(b, t_max)
    assert pager.tok_idx == [] and pager.block_template == []
    theirs = ref_pager.slice_dirty(ref_cache, pos, RefTable())
    ours = pager.slice_dirty(our_cache, pos, BlockTable())
    assert sorted(ours) == sorted(theirs) == \
        [STATE_BLOCK] + list(range(pager.n_blocks(pos)))
    for blk in ours:
        if blk != STATE_BLOCK:
            assert ours[blk] == [] and list(theirs[blk]) == []
        assert _frame_bytes(stream.write_frame, ours[blk]) == \
            _frame_bytes(ref_stream.write_frame, list(theirs[blk]))
    assembled = pager.assemble(ours)
    assert all(torch.equal(a, _t(l))
               for a, l in zip(tree_leaves(assembled), leaves))
