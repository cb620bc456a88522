"""The port's LM against the JAX package's, on seven smoke configs in fp32:
olmo-1b (dense), olmoe-1b-7b (MoE in every block, qk-norm, RMSNorm,
untied unembedding), the dense GQA four internlm2-1.8b (G = 2, rope theta
1e6), phi3-medium-14b (head_dim 8 at G = 5), yi-34b (G = 7, vocab 250) and
chameleon-34b (qk-norm at G = 4), and deepseek-v2-236b (MLA with its
latent cache, a dense first layer, then MoE with a shared expert: two
unstacked blocks, so its cache leaves carry the batch on axis 0).

Weights are the reference's own ``jax.random`` params carried across with
``models.params.from_reference``, so both packages compute the same
function; inputs are numpy from a seed.  Tolerance: atol 1e-4 in fp32
(the same arithmetic summed in another order, through 2 layers and a
vocab projection).  The serving steps are compared too: prefill (last
logits AND cache contents), three single-token decodes, and the
continuous-batching slot decode with slots at different positions — plus
slot independence: which lane holds which session changes nothing (for
olmoe that includes per-slot MoE routing: a slot's token is routed alone,
as in the reference's per-slot ``vmap``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PUBLISHED_PARAMS as REF_PUBLISHED_PARAMS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.lm import ServeState as RefServeState
from repro.models.registry import build as ref_build
from repro.train.step import make_slot_decode_step as ref_slot_decode_step
from repro_torch.configs import get_smoke_config
from repro_torch.models.lm import ServeState
from repro_torch.models.params import from_reference, is_desc
from repro_torch.models.registry import build
from repro_torch.train.step import make_slot_decode_step
from repro_torch.utils.tree import tree_flatten

ATOL = 1e-4
FP32 = dict(param_dtype="float32", compute_dtype="float32")
T_MAX = 24
ARCHS = ["olmo-1b", "olmoe-1b-7b", "internlm2-1.8b", "phi3-medium-14b",
         "yi-34b", "chameleon-34b", "deepseek-v2-236b"]
ALL_ARCHS = ARCHS + ["rwkv6-7b", "jamba-1.5-large-398b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    rb = ref_build(ref_smoke_config(request.param).with_(**FP32))
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(get_smoke_config(request.param).with_(**FP32), device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return rb, rp, b, p


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape, np.int32)


def _batch_axes(b):
    """Each cache leaf's batch axis, in leaf order: 1 under a stacked
    (layers,) dim, else 0."""
    descs = tree_flatten(b.cache_descs(1, 2), is_leaf=is_desc)[0]
    return [d.logical.index("batch") for d in descs]


def _port_caches(b, ref_caches, batch):
    """The reference's cache pytree as the port's (same leaf order)."""
    leaves, td = tree_flatten(b.init_caches(batch, T_MAX))
    ref_leaves = jax.tree_util.tree_leaves(ref_caches)
    assert len(ref_leaves) == len(leaves)
    return td.unflatten([torch.from_numpy(np.array(l)) for l in ref_leaves])


def _assert_caches_close(ours, theirs):
    ol = tree_flatten(ours)[0]
    tl = jax.tree_util.tree_leaves(theirs)
    assert len(ol) == len(tl) and len(ol) % 2 == 0 and ol   # (k, v) pairs
    for a, bb in zip(ol, tl):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=ATOL)


def test_params_and_caches_have_the_reference_structure(models):
    rb, rp, b, p = models
    assert [tuple(l.shape) for l in tree_flatten(p)[0]] == \
        [l.shape for l in jax.tree_util.tree_leaves(rp)]
    ours = b.init_caches(3, T_MAX)
    theirs = rb.init_caches(jax.random.PRNGKey(0), 3, T_MAX)
    assert [tuple(l.shape) for l in tree_flatten(ours)[0]] == \
        [l.shape for l in jax.tree_util.tree_leaves(theirs)]
    assert type(ours[0]["blocks"][0]).__name__ == "KVCache"


def test_forward_logits_match_reference(models):
    rb, rp, b, p = models
    toks = _tokens((2, 20), vocab=b.cfg.vocab_size)
    theirs, _ = rb.forward(rp, jnp.asarray(toks))
    ours = b.forward(p, torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def test_prefill_and_three_decode_steps_match_reference(models):
    rb, rp, b, p = models
    toks = _tokens((1, 13), seed=1, vocab=b.cfg.vocab_size)
    r_logits, r_st = rb.prefill(rp, {"tokens": jnp.asarray(toks)},
                                rb.init_caches(jax.random.PRNGKey(0), 1,
                                               T_MAX))
    logits, st = b.prefill(p, {"tokens": torch.from_numpy(toks).long()},
                           b.init_caches(1, T_MAX))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=ATOL)
    _assert_caches_close(st.caches, r_st.caches)
    assert int(st.pos) == int(r_st.pos) == 13
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)[:, None]
        r_logits, r_st = rb.decode(rp, jnp.asarray(nxt), r_st)
        logits, st = b.decode(p, torch.from_numpy(nxt).long(), st)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   atol=ATOL)
        _assert_caches_close(st.caches, r_st.caches)
        assert int(st.pos) == int(r_st.pos)


def _slot_state(models, prompt_lens, seed=2):
    """Per-slot caches after prefilling prompts of different lengths."""
    rb, rp, b, _ = models
    lanes, last = [], []
    for i, L in enumerate(prompt_lens):
        lg, st = rb.prefill(rp, {"tokens": jnp.asarray(
            _tokens((1, L), seed + i, b.cfg.vocab_size))},
            rb.init_caches(jax.random.PRNGKey(0), 1, T_MAX))
        lanes.append(st.caches)
        last.append(int(jnp.argmax(lg, -1)[0]))
    per_lane = [jax.tree_util.tree_leaves(c) for c in lanes]
    caches = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(lanes[0]),
        [jnp.concatenate(ls, ax)
         for ls, ax in zip(zip(*per_lane), _batch_axes(b))])
    return caches, np.asarray(last, np.int32), np.asarray(prompt_lens,
                                                          np.int32)


def test_slot_decode_at_different_positions_matches_reference(models):
    rb, rp, b, p = models
    caches, last, pos = _slot_state(models, [5, 9, 13, 7])
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
                                   atol=ATOL)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(r_pos))
        np.testing.assert_array_equal(p_next.numpy(), np.asarray(r_next))
        _assert_caches_close(pc, caches)
        pos = np.asarray(r_pos)
        tok_r = np.asarray(r_next)[:, None]
        tok_p = p_next[:, None].long()


def test_slot_independence_under_permutation(models):
    """Permuting which lane holds which session leaves every session's
    logits, next token and cache bit-identical."""
    _, _, b, p = models
    caches, last, pos = _slot_state(models, [5, 9, 13, 7], seed=5)
    step = make_slot_decode_step(b)
    active = torch.ones(4, dtype=torch.bool)

    axes = _batch_axes(b)
    idx = torch.from_numpy

    def run(order):
        leaves, td = tree_flatten(_port_caches(b, caches, 4))
        pc = td.unflatten([l.index_select(ax, idx(order)).contiguous()
                           for l, ax in zip(leaves, axes)])
        tok = torch.from_numpy(last[order][:, None]).long()
        tp = torch.from_numpy(pos[order])
        outs = []
        for _ in range(3):
            nxt, logits, pc, tp = step(p, tok, pc, tp, active)
            outs.append((nxt.clone(), logits.clone()))
            tok = nxt[:, None].long()
        return outs, pc, order

    base, base_c, _ = run(np.arange(4))
    perm = np.asarray([2, 0, 3, 1])
    got, got_c, _ = run(perm)
    for (bn, bl), (gn, gl) in zip(base, got):
        for lane, sess in enumerate(perm):
            assert torch.equal(gl[lane], bl[sess])
            assert int(gn[lane]) == int(bn[sess])
    for bl, gl, ax in zip(tree_flatten(base_c)[0], tree_flatten(got_c)[0],
                          axes):
        assert torch.equal(gl, bl.index_select(ax, idx(perm)))


def test_init_params_is_a_function_of_the_generator_seed(models):
    _, _, b, _ = models
    a = b.init_params(torch.Generator().manual_seed(3))
    c = b.init_params(torch.Generator().manual_seed(3))
    d = b.init_params(torch.Generator().manual_seed(4))
    la, lc, ld = (tree_flatten(x)[0] for x in (a, c, d))
    assert all(torch.equal(x, y) for x, y in zip(la, lc))
    assert not all(torch.equal(x, y) for x, y in zip(la, ld))
    assert [tuple(x.shape) for x in la] == [
        tuple(s.shape) for s in tree_flatten(b.abstract_params())[0]]



def test_a_slot_is_unchanged_when_the_other_lanes_hold_other_sessions(
        models):
    """Lane 0 holds the same session in two batches whose other three
    lanes hold different sessions: lane 0's logits, tokens and cache stay
    bit-identical (for olmoe: each slot's token is routed through the
    experts alone, with its own capacity rows)."""
    _, _, b, p = models
    step = make_slot_decode_step(b)
    active = torch.ones(4, dtype=torch.bool)
    axes = _batch_axes(b)

    def run(seed_of_others):
        caches, last, pos = _slot_state(models, [6, 9, 13, 7],
                                        seed=seed_of_others)
        lane0, last0, pos0 = _slot_state(models, [6], seed=11)
        caches = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(caches),
            [jax.lax.dynamic_update_slice_in_dim(a, a0, 0, ax)
             for a, a0, ax in zip(jax.tree_util.tree_leaves(caches),
                                  jax.tree_util.tree_leaves(lane0), axes)])
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
    for bc, oc, ax in zip(tree_flatten(base_c)[0], tree_flatten(other_c)[0],
                          axes):
        assert torch.equal(bc.select(ax, 0), oc.select(ax, 0))


# -- configs and the drawing of large leaves ---------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_are_the_references_and_count_the_published_params(arch):
    """Each registered config (full and smoke) is the reference's field for
    field, and its analytic parameter count is within 4% of the published
    total (the reference's ``tests/test_arch_smoke.py`` check)."""
    import dataclasses
    from repro.configs import get_config as ref_config
    from repro_torch.configs import PUBLISHED_PARAMS, get_config
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(ref_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(ref_smoke_config(arch))
    assert PUBLISHED_PARAMS[arch] == REF_PUBLISHED_PARAMS[arch]
    n = get_config(arch).param_count()
    assert abs(n - PUBLISHED_PARAMS[arch]) / PUBLISHED_PARAMS[arch] < 0.04


def test_the_port_registers_every_decoder_only_arch_of_the_reference():
    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, ENCDEC_ARCHS, get_config
    assert ARCH_IDS == [a for a in REF_ARCH_IDS
                        if not ref_smoke_config(a).is_encdec]
    assert list(ENCDEC_ARCHS) == [a for a in REF_ARCH_IDS
                                  if a not in ARCH_IDS]
    with pytest.raises(KeyError, match="unknown arch 'whisper-small'"):
        get_config("whisper-small")


@pytest.mark.parametrize("arch", ["yi-34b", "deepseek-v2-236b"])
def test_leaves_past_the_threshold_are_drawn_in_slices(arch, monkeypatch):
    """With the threshold lowered to 4,000 elements, the smoke config's
    larger leaves are drawn one slice of their leading axis at a time:
    still a function of the generator's seed, each slice a draw of the
    generator's stream in turn; the leaves drawn before the first sliced
    one are bit-identical to the whole draws.  At the real threshold
    (2^32) no leaf of the four paths that ran before yi-34b (at the depths
    the card runs them) is sliced, so their weights are the whole draws,
    bit for bit, and neither is deepseek-v2's at 8 layers; yi-34b's and
    chameleon-34b's stacked MLP leaves are."""
    from repro_torch.models import params as params_mod
    b = build(get_smoke_config(arch), device="cpu")
    whole = tree_flatten(b.init_params(torch.Generator().manual_seed(3)))[0]
    default = params_mod.SLICED_DRAW_ELEMENTS
    monkeypatch.setattr(params_mod, "SLICED_DRAW_ELEMENTS", 4000)
    a = tree_flatten(b.init_params(torch.Generator().manual_seed(3)))[0]
    c = tree_flatten(b.init_params(torch.Generator().manual_seed(3)))[0]
    d = tree_flatten(b.init_params(torch.Generator().manual_seed(4)))[0]
    descs = tree_flatten(b.descs, is_leaf=is_desc)[0]
    sliced = [i for i, x in enumerate(descs) if x.init == "normal"
              and int(np.prod(x.shape)) > 4000]
    assert sliced and len(sliced) < len(descs)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    for i in sliced:
        assert not torch.equal(a[i], d[i])
        assert a[i].shape == whole[i].shape and a[i].dtype == whole[i].dtype
    assert all(torch.equal(x, y) for x, y in zip(a[:sliced[0]],
                                                 whole[:sliced[0]]))
    # a sliced leaf is its slices drawn in turn from the generator's stream
    leaf = {"w": params_mod.ParamDesc((5, 40, 30), ("layers", "a", "b"))}
    got = params_mod.init_params(leaf, torch.Generator().manual_seed(3),
                                 "bfloat16")["w"]
    g = torch.Generator().manual_seed(3)
    want = torch.stack([torch.randn((40, 30), generator=g).mul_(0.02)
                        for _ in range(5)]).to(torch.bfloat16)
    assert torch.equal(got, want)
    from repro_torch.configs import get_config
    assert default == 2 ** 32

    def largest(a, **kw):
        return max(int(np.prod(x.shape)) for x in tree_flatten(
            build(get_config(a).with_(**kw), device="cpu").descs,
            is_leaf=is_desc)[0])
    assert max(largest(a) for a in ("olmo-1b", "olmoe-1b-7b", "rwkv6-7b")
               ) <= default
    # jamba-1.5-large as the card runs it, at 5 layers: one layer's 16
    # experts, (16, 24576, 8192)
    assert largest("jamba-1.5-large-398b", n_layers=5) == 16 * 24576 * 8192
    assert largest("yi-34b") > default and largest("chameleon-34b") > default
    assert largest("deepseek-v2-236b", n_layers=8) <= default
