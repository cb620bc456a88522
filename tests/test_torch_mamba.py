"""The port's Mamba path against the JAX package's: the selective-scan
dispatcher and its plain version, the mamba mixer, the jamba blocks and
the jamba-1.5-large LM, and the paging of its mixed cache.

* the scan: the port's dispatcher on the CPU (its plain step recurrence)
  against the JAX TPU kernel run the way the reference's own tests run it
  (``pallas_interpret``: the Pallas interpreter here) and against the
  reference's step oracle, on the reference's ``SCAN_CASES``
  (``tests/test_kernels.py``).  Tolerance: atol 1e-4 against the kernel,
  the reference test's own; 1e-5 against the oracle (the same fp32 steps,
  the readout summed in another order).  On the CPU it launches nothing;
* the mixer on the fp32 smoke config (atol 1e-5: the same fp32
  arithmetic, the reference's associative scan rounding otherwise than
  the step recurrence) and in bf16 (atol 4e-3 x max|reference|, one bf16
  ulp of the largest value: both packages round the same projections to
  bf16, and where an fp32 difference flips one rounding the output moves
  by about an ulp):
  ``_causal_conv``, ``_ssm_inputs``, ``mamba_forward`` with and without an
  initial cache at S a multiple of ``ssm_chunk`` and not, ``mamba_decode``;
* the blocks (mamba + dense MLP, mamba + MoE) with a cache, in place, at
  atol 1e-5; the LM's ``forward`` / ``prefill`` / ``decode_step`` and the
  slot decode at 8 layers (one period of the pattern, one repeat) and 16
  (the period stacked twice: every leaf gets a leading (2,) dim), at atol
  1e-4;
* structure: descriptor trees equal the reference's, and the path's cut,
  ``n_layers=5``, is one group of five kinds holding 24,045,707,264
  parameters (``param_count``, which leaves out norm scales and biases:
  24,045,486,080);
* paging: the mixed cache (attention k / v with a token axis, mamba conv /
  ssm without) gives token blocks plus one ``state`` object, with the
  reference's names and frame bytes.

Serving parity (tokens, crash-resume, pools recovered across packages,
the launcher) runs in ``tests/test_torch_serve.py``, whose architectures
include jamba-1.5-large-398b.  Weights are the reference's ``jax.random``
params carried across; inputs are numpy from a seed.  The CUDA kernel has
no CPU mode: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
against the plain version on the card.
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
from repro.kernels.mamba.kernel import selective_scan_kernel
from repro.kernels.mamba.ref import selective_scan_ref as jax_scan_ref
from repro.models import lm as ref_lm
from repro.models import mamba as ref_mamba
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro.models.registry import build as ref_build
from repro.serve.paging import BlockPager as RefPager
from repro.serve.paging import BlockTable as RefTable
from repro.train.step import cache_batch_axes as ref_cache_batch_axes
from repro.train.step import make_slot_decode_step as ref_slot_decode_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dsm import stream
from repro_torch.kernels.mamba import ops
from repro_torch.kernels.mamba.ref import selective_scan_ref
from repro_torch.models import lm, mamba
from repro_torch.models.params import count_params, from_reference, is_desc
from repro_torch.models.registry import build
from repro_torch.serve.paging import STATE_BLOCK, BlockPager, BlockTable
from repro_torch.train.step import make_slot_decode_step
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "jamba-1.5-large-398b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = 1e-5
LM_ATOL = 1e-4
BF16_REL = 4e-3
T_MAX = 24

# tests/test_kernels.py SCAN_CASES: B, S, I, N, block_s, block_i
SCAN_CASES = [
    (2, 128, 128, 16, 32, 128), (1, 100, 256, 8, 64, 128),
    (2, 64, 128, 16, 16, 64), (1, 37, 128, 4, 32, 128),
]
SCAN_IDS = [f"B{c[0]}S{c[1]}I{c[2]}N{c[3]}bs{c[4]}bi{c[5]}"
            for c in SCAN_CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, S, I, N, seed=0):
    """The reference sweep's distributions, from numpy: dA = sigmoid(N) in
    (0, 1), dBu * 0.3, C, h0 * 0.1."""
    g = np.random.default_rng(seed)
    dA = 1 / (1 + np.exp(-g.standard_normal((B, S, I, N), np.float32)))
    dBu = g.standard_normal((B, S, I, N), np.float32) * 0.3
    C = g.standard_normal((B, S, N), np.float32)
    h0 = g.standard_normal((B, I, N), np.float32) * 0.1
    return dA.astype(np.float32), dBu, C, h0


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The scan and its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SCAN_CASES, ids=SCAN_IDS)
def test_dispatcher_matches_pallas_kernel_and_oracle(case, pallas_interpret):
    B, S, I, N, bs, bi = case
    dA, dBu, C, h0 = _scan_inputs(B, S, I, N)
    y_kern, h_kern = selective_scan_kernel(
        *(jnp.asarray(a) for a in (dA, dBu, C, h0)), block_s=bs,
        block_i=bi, interpret=pallas_interpret)
    y_orc, h_orc = jax_scan_ref(*(jnp.asarray(a) for a in (dA, dBu, C, h0)))
    before = ops.LAUNCHES
    y, h = ops.selective_scan(*(_t(a) for a in (dA, dBu, C, h0)))
    assert ops.LAUNCHES == before            # the CPU path launches nothing
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, I) and tuple(h.shape) == (B, I, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_kern), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_kern), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_orc), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_orc), atol=ATOL)


def test_dispatcher_starts_from_zeros_and_writes_h_out_in_place():
    dA, dBu, C, h0 = (_t(a) for a in _scan_inputs(2, 9, 6, 4, seed=1))
    y0, h_zero = ops.selective_scan(dA, dBu, C)
    y1, h_want = ops.selective_scan(dA, dBu, C, torch.zeros_like(h0))
    assert torch.equal(y0, y1) and torch.equal(h_zero, h_want)
    want_y, want_h = ops.selective_scan(dA, dBu, C, h0.clone())
    state = h0.clone()
    y, got = ops.selective_scan(dA, dBu, C, state, h_out=state)
    assert got is state
    assert torch.equal(state, want_h) and torch.equal(y, want_y)


def test_plain_scan_at_s1_is_the_reference_decode_step():
    dA, dBu, C, h0 = (_t(a) for a in _scan_inputs(3, 1, 5, 4, seed=2))
    y, h = selective_scan_ref(dA, dBu, C, h0)
    h_dec = dA[:, 0] * h0 + dBu[:, 0]
    assert torch.equal(h, h_dec)
    assert torch.equal(y[:, 0], torch.einsum("bin,bn->bi", h_dec, C[:, 0]))


def test_dispatcher_refuses_tensors_on_two_devices():
    dA = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError):
        ops.selective_scan(dA, dA, torch.zeros((1, 2, 4)).to("meta"))


# ---------------------------------------------------------------------------
# The mamba mixer
# ---------------------------------------------------------------------------

def _cfgs(dtype="float32", **kw):
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    return (get_smoke_config(ARCH).with_(**dt, **kw),
            ref_smoke_config(ARCH).with_(**dt, **kw))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mixer(request):
    dtype = request.param
    cfg, ref_cfg = _cfgs(dtype)
    rp = ref_init_params(ref_mamba.mamba_descs(ref_cfg),
                         jax.random.PRNGKey(0), dtype)
    # a non-zero conv bias and a non-unit skip, so a missing one shows
    g = np.random.default_rng(7)
    rp = dict(rp, conv_b=jnp.asarray(
        0.1 * g.standard_normal(rp["conv_b"].shape), rp["conv_b"].dtype),
        D_skip=jnp.asarray(1 + 0.3 * g.standard_normal(
            rp["D_skip"].shape), rp["D_skip"].dtype))
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return dtype, cfg, ref_cfg, rp, p


def _x(cfg, shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), _t(a).to(getattr(torch, dtype))


def _mamba_cache(cfg, B, seed, dtype):
    """A random (non-zero) mamba cache: (jax, torch) pairs of conv, ssm."""
    mc = cfg.mamba
    inner = mc.expand * cfg.d_model
    g = np.random.default_rng(seed)
    conv = g.standard_normal((B, mc.d_conv - 1, inner)).astype(np.float32)
    ssm = (0.1 * g.standard_normal((B, inner, mc.d_state))).astype(
        np.float32)
    rc = ref_mamba.MambaCache(jnp.asarray(conv, dtype), jnp.asarray(ssm))
    pc = mamba.MambaCache(_t(conv).to(getattr(torch, dtype)), _t(ssm))
    return rc, pc


def _close(ours, theirs, dtype, atol=ATOL):
    theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
    ours = ours.float().numpy()
    if dtype == "bfloat16":
        atol = BF16_REL * float(np.abs(theirs).max())
    np.testing.assert_allclose(ours, theirs, atol=atol)


def test_causal_conv_and_ssm_inputs_match_reference(mixer):
    dtype, cfg, ref_cfg, rp, p = mixer
    inner = cfg.mamba.expand * cfg.d_model
    ju, tu = _x(cfg, (2, 11, inner), 1, dtype)
    jpre, tpre = _x(cfg, (2, cfg.mamba.d_conv - 1, inner), 2, dtype)
    ru = ref_mamba._causal_conv(ref_cfg, rp, ju, jpre)
    u = mamba._causal_conv(cfg, p, tu, tpre)
    assert u.dtype == tu.dtype
    _close(u, ru, dtype)
    theirs = ref_mamba._ssm_inputs(ref_cfg, rp, ru)
    ours = mamba._ssm_inputs(cfg, p, _t(np.asarray(
        jnp.asarray(ru, jnp.float32))).to(tu.dtype))
    for o, t in zip(ours, theirs):
        assert o.dtype == torch.float32 and o.is_contiguous()
        assert tuple(o.shape) == t.shape
        _close(o, t, dtype)


@pytest.mark.parametrize("S", [21, 32, 5])
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["no_cache", "cache"])
def test_mamba_forward_matches_reference(mixer, S, with_cache):
    """S = 21 and 5 are not multiples of the smoke ssm_chunk (16): a
    ragged last chunk, and a sequence shorter than one chunk."""
    dtype, cfg, ref_cfg, rp, p = mixer
    jx, tx = _x(cfg, (2, S, cfg.d_model), S, dtype)
    rc, pc = (_mamba_cache(cfg, 2, seed=4, dtype=dtype) if with_cache
              else (None, None))
    ry, rcache = ref_mamba.mamba_forward(ref_cfg, rp, jx, initial=rc)
    y, cache = mamba.mamba_forward(cfg, p, tx, initial=pc)
    assert y.dtype == tx.dtype
    _close(y, ry, dtype)
    if with_cache:
        assert cache is pc                   # the cache, written in place
    assert cache.conv.dtype == tx.dtype and cache.ssm.dtype == torch.float32
    _close(cache.conv, rcache.conv, dtype)
    _close(cache.ssm, rcache.ssm, dtype)


def test_mamba_decode_matches_reference(mixer):
    dtype, cfg, ref_cfg, rp, p = mixer
    rc, pc = _mamba_cache(cfg, 3, seed=5, dtype=dtype)
    ptrs = [l.data_ptr() for l in pc]
    for step in range(3):
        jx, tx = _x(cfg, (3, 1, cfg.d_model), 10 + step, dtype)
        ry, rc = ref_mamba.mamba_decode(ref_cfg, rp, jx, rc)
        y, pc = mamba.mamba_decode(cfg, p, tx, pc)
        _close(y, ry, dtype)
        _close(pc.conv, rc.conv, dtype)
        _close(pc.ssm, rc.ssm, dtype)
    assert [l.data_ptr() for l in pc] == ptrs            # in place


# ---------------------------------------------------------------------------
# Blocks and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mlp", ["dense", "moe"])
@pytest.mark.parametrize("S", [9, 1])
def test_block_forward_matches_reference_and_updates_cache_in_place(S, mlp):
    cfg, ref_cfg = _cfgs()
    kind = ("mamba", mlp)
    rp = ref_init_params(ref_lm.block_descs(ref_cfg, kind),
                         jax.random.PRNGKey(1), "float32")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    assert sorted(p) == ["mamba", mlp if mlp == "moe" else "mlp", "norm1",
                         "norm2"]
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model),
                                                 np.float32)
    rc, pc = _mamba_cache(cfg, 2, seed=6, dtype="float32")
    pos = np.full((2, S), 3, np.int32)
    rx, rcache, _ = ref_lm.block_forward(
        ref_cfg, kind, rp, jnp.asarray(x), jnp.asarray(pos), cache=rc,
        decode=S == 1)
    ptrs = [l.data_ptr() for l in pc]
    ox, ocache, _ = lm.block_forward(cfg, p, _t(x), _t(pos), cache=pc,
                                     decode=S == 1)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), atol=ATOL)
    assert [l.data_ptr() for l in ocache] == ptrs          # in place
    for a, b in zip(ocache, rcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def _desc_rows(tree, ref):
    leaves = (jax.tree_util.tree_leaves(tree, is_leaf=lambda d: hasattr(
        d, "logical")) if ref else tree_leaves(tree, is_leaf=is_desc))
    return [(tuple(d.shape), tuple(d.logical), d.dtype, d.init,
             d.init_scale) for d in leaves]


@pytest.mark.parametrize("n_layers", [8, 16, 5])
def test_descriptor_trees_equal_reference(n_layers):
    cfg, ref_cfg = _cfgs(n_layers=n_layers)
    assert lm.layer_groups(cfg) == [
        lm.LayerGroup(g.kinds, g.n_repeats)
        for g in ref_lm.layer_groups(ref_cfg)]
    assert _desc_rows(lm.model_descs(cfg), False) == \
        _desc_rows(ref_lm.model_descs(ref_cfg), True)
    assert _desc_rows(lm.cache_descs(cfg, 3, T_MAX), False) == \
        _desc_rows(ref_lm.cache_descs(ref_cfg, 3, T_MAX), True)
    assert mamba.MambaCache._fields == ref_mamba.MambaCache._fields


def test_full_config_and_the_five_layer_cut():
    full, ref_full = get_config(ARCH), ref_config(ARCH)
    assert full == full.with_()                              # frozen data
    assert full.param_count() == ref_full.param_count()
    cut = full.with_(n_layers=5)
    assert cut.param_count() == ref_full.with_(n_layers=5).param_count() \
        == 24_045_486_080
    # the descriptors add what the analytic count leaves out: 11 norm
    # scales of d_model and the 4 mamba layers' conv and dt biases
    assert count_params(lm.model_descs(cut)) == ref_count_params(
        ref_lm.model_descs(ref_full.with_(n_layers=5))) == \
        24_045_486_080 + 11 * 8192 + 4 * 2 * 16384 == 24_045_707_264
    # one group of the five kinds jamba has, not stacked
    assert lm.layer_groups(cut) == [lm.LayerGroup(
        (("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
         ("mamba", "moe"), ("attn", "dense")), 1)]
    assert (cut.d_model, cut.n_heads, cut.n_kv_heads, cut.head_dim,
            cut.moe.n_experts, cut.moe.d_ff_expert, cut.mamba.d_state,
            cut.vocab_size) == (8192, 64, 8, 128, 16, 24576, 16, 65536)


# ---------------------------------------------------------------------------
# The LM and its serving steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[8, 16], ids=["L8", "L16"])
def models(request):
    cfg, ref_cfg = _cfgs(n_layers=request.param)
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
    assert len(ol) == len(tl)
    for a, bb in zip(ol, tl):
        assert tuple(a.shape) == bb.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=LM_ATOL)


def test_params_match_the_reference_tree(models):
    rb, rp, b, p = models
    assert [tuple(l.shape) for l in tree_leaves(p)] == \
        [l.shape for l in jax.tree_util.tree_leaves(rp)]
    assert b.n_params() == rb.n_params()


def test_forward_logits_match_reference(models):
    rb, rp, b, p = models
    toks = _tokens((2, 21))
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
    rb, rp, b, _ = models
    axes = jax.tree_util.tree_leaves(ref_cache_batch_axes(rb))
    lanes, last = [], []
    for i, L in enumerate(prompt_lens):
        lg, st = rb.prefill(rp, {"tokens": jnp.asarray(
            _tokens((1, L), seed + i))},
            rb.init_caches(jax.random.PRNGKey(0), 1, T_MAX))
        lanes.append(jax.tree_util.tree_leaves(st.caches))
        last.append(int(jnp.argmax(lg, -1)[0]))
    leaves = [jnp.concatenate([lane[j] for lane in lanes], ax)
              for j, ax in enumerate(axes)]
    caches = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(st.caches), leaves)
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


# ---------------------------------------------------------------------------
# Paging the mixed cache
# ---------------------------------------------------------------------------

def _frame_bytes(write, leaves):
    f = io.BytesIO()
    write(f, leaves)
    return f.getvalue()


@pytest.mark.parametrize("pos", [1, 16, 21])
def test_mixed_cache_pages_as_token_blocks_plus_state(models, pos):
    rb, _, b, _ = models
    t_max = 40
    specs = jax.tree_util.tree_leaves(rb.abstract_caches(1, t_max))
    g = np.random.default_rng(9)
    leaves = [g.standard_normal(s.shape).astype(np.float32) for s in specs]
    ref_cache = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(rb.abstract_caches(1, t_max)),
        [jnp.asarray(a) for a in leaves])
    our_cache = tree_flatten(b.init_caches(1, t_max))[1].unflatten(
        [_t(a) for a in leaves])
    ref_pager, pager = RefPager(rb, t_max), BlockPager(b, t_max)
    # k / v of the attention layers page by token; conv / ssm as state
    # (a period of 8 has one attention block and seven mamba blocks)
    assert len(pager.tok_idx) == 2 and len(pager.state_idx) == 14
    theirs = ref_pager.slice_dirty(ref_cache, pos, RefTable())
    ours = pager.slice_dirty(our_cache, pos, BlockTable())
    assert sorted(ours) == sorted(theirs) == \
        [STATE_BLOCK] + list(range(pager.n_blocks(pos)))
    for blk in ours:
        assert len(ours[blk]) == len(theirs[blk])
        assert _frame_bytes(stream.write_frame, ours[blk]) == \
            _frame_bytes(ref_stream.write_frame, list(theirs[blk]))
    assembled = pager.assemble(ours)
    for a, l, ax in zip(tree_leaves(assembled), leaves, pager._axes):
        if ax < 0:                       # state: whole
            assert torch.equal(a, _t(l))
        else:                            # tokens: the first pos, then zeros
            n = pager.n_blocks(pos) * pager.block_tokens
            assert torch.equal(a.narrow(ax, 0, n), _t(l).narrow(ax, 0, n))
