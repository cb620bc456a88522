"""whisper-small (``repro_torch.models.encdec``) against the reference's
``repro.models.encdec``, on the smoke config on the CPU (2 encoder + 2
decoder layers, d 64, 4 heads, enc_seq 48).

Weights are the reference's own ``jax.random`` params carried across with
``models.params.from_reference``; tokens and frame embeddings are numpy
from a seed.  Tolerances: fp32 within 1e-4 (the same arithmetic summed in
another order; the loss and the train step within 1e-5 x |ref|, as the
decoder-only models' are held), bf16 within 2e-2 relative for the loss
and the train step and 0.05 abs for logits (the reference's own
prefill / decode check, ``tests/test_arch_smoke.py``).

* the parameter and cache trees equal the reference's leaf for leaf;
  ``from_reference`` carries the reference's tree over unchanged;
* the full decoder forward's logits and ``loss_fn`` (which ignores
  ``batch["targets"]``, as the reference does) match, in fp32 and bf16,
  and the decoder positional table is clamped past its 448 rows at train
  and at decode exactly as the reference clamps;
* prefill (both caches) and three greedy decode steps match, and the
  decode's logits hold against a full forward over the same tokens;
* remat recomputes the same loss and gradients;
* three train steps match: the loss, grad norm and nll within 1e-5 (fp32)
  / 2e-2 (bf16) relative, the lr exactly, and params, mu and nu per leaf
  within 1e-5 / 5e-2 x max|ref| — bf16's nu holds the square of
  gradients through cross-attention's 48-frame sums (measured up to
  2.5e-2) — and a zero-initialised leaf (the layernorms' biases) within
  10x that: it holds only Adam's steps, each normalised per element, so
  it carries each element's gradient error undamped (measured up to
  1.1e-5 in fp32 and 4.9e-2 in bf16 against values of ~3e-6);
* a durable training loop over a pipeline that adds frame embeddings
  (drawn from the pipeline's committed (seed, step)) runs in both
  packages, and each resumes the other's pool to the other's result.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataPipeline as RefDataPipeline
from repro.data.pipeline import SyntheticLMSource as RefSource
from repro.dsm.pool import DSMPool as RefPool
from repro.models import common as ref_common
from repro.models import encdec as ref_encdec
from repro.models.registry import build as ref_build
from repro.train.loop import run_durable_loop as ref_run_durable_loop
from repro.train.state import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
from repro_torch.dsm.pool import DSMPool
from repro_torch.models import common, encdec
from repro_torch.models.params import from_reference, is_desc
from repro_torch.models.registry import build
from repro_torch.train.loop import run_durable_loop
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import tree_flatten, tree_leaves

ARCH = "whisper-small"
DTYPES = {"fp32": dict(param_dtype="float32", compute_dtype="float32"),
          "bf16": {}}
ATOL = 1e-4
TOL = {"fp32": 1e-5, "bf16": 2e-2}
STATE_TOL = {"fp32": 1e-5, "bf16": 5e-2}
DEC_POS_LEN = 64
T_MAX = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _models(dt):
    """The reference's bundle and params, and the port's with the same
    weights (no test mutates them: the train step is out of place)."""
    rb = ref_build(ref_smoke_config(ARCH).with_(**DTYPES[dt]),
                   dec_pos_len=DEC_POS_LEN)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(get_smoke_config(ARCH).with_(**DTYPES[dt]),
              dec_pos_len=DEC_POS_LEN, device="cpu")
    return rb, rp, b, from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                     "cpu")


def _inputs(cfg, B, S, seed=0):
    g = np.random.default_rng(seed)
    return (g.integers(0, cfg.vocab_size, (B, S), np.int32),
            g.standard_normal((B, cfg.encdec.enc_seq, cfg.d_model),
                              dtype=np.float32))


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


def _assert_trees_close(ours, theirs, tols, what):
    """Per leaf, ``|ours - theirs| <= tol * max|theirs|`` with ``tols``
    one tolerance per leaf (or one for all)."""
    a, b = tree_leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert len(a) == len(b) > 0, what
    if not isinstance(tols, list):
        tols = [tols] * len(a)
    for i, (x, y, tol) in enumerate(zip(a, b, tols)):
        x, y = _f32(x), _f32(y)
        assert x.shape == y.shape, (what, i)
        err = float(np.abs(x - y).max())
        assert err <= tol * max(float(np.abs(y).max()), 1e-30), \
            f"{what} leaf {i}: {err}"


# -- structure ----------------------------------------------------------------

def test_params_and_caches_have_the_reference_structure():
    rb, rp, b, p = _models("fp32")
    shapes = [l.shape for l in jax.tree_util.tree_leaves(rp)]
    assert [tuple(l.shape) for l in tree_flatten(p)[0]] == shapes
    assert [tuple(s.shape) for s in tree_flatten(b.abstract_params())[0]] \
        == shapes
    assert tree_flatten(p)[1] == tree_flatten(b.abstract_params())[1]
    assert b.n_params() == rb.n_params()
    assert p["dec_pos"].shape == (448, 64)          # max(448, dec_pos_len)
    ours = b.init_caches(3, T_MAX)
    theirs = rb.init_caches(jax.random.PRNGKey(0), 3, T_MAX)
    assert type(ours).__name__ == "EncDecCaches"
    assert ours.self_kv.k.shape == (2, 3, T_MAX, 4, 64)
    assert ours.cross_kv.k.shape == (2, 3, 48, 4, 64)
    assert [tuple(l.shape) for l in tree_flatten(ours)[0]] == \
        [l.shape for l in jax.tree_util.tree_leaves(theirs)]
    assert b.forward is None


# -- forward and loss ---------------------------------------------------------

def _full_logits_ref(cfg, rp, toks, emb):
    enc = ref_encdec.encode(cfg, rp, jnp.asarray(emb))
    x, _ = ref_encdec.decode_tokens(cfg, rp, jnp.asarray(toks), enc)
    return np.asarray(ref_common.unembed(cfg, rp["embed"], x)
                      .astype(jnp.float32))


def _full_logits(cfg, p, toks, emb):
    enc = encdec.encode(cfg, p, torch.from_numpy(emb))
    x, _ = encdec.decode_tokens(cfg, p, torch.from_numpy(toks).long(), enc)
    return common.unembed(cfg, p["embed"], x).float().numpy()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_forward_and_loss_match_the_reference(dt):
    rb, rp, b, p = _models(dt)
    toks, emb = _inputs(b.cfg, 2, 21)
    cases = [(toks, emb)]
    if dt == "fp32":   # past the 448-row table: 450 positions, clamped
        cases.append((_inputs(b.cfg, 1, 450, seed=1)[0], emb[:1]))
    for t, e in cases:
        theirs = _full_logits_ref(rb.cfg, rp, t, e)
        ours = _full_logits(b.cfg, p, t, e)
        np.testing.assert_allclose(ours, theirs,
                                   atol=ATOL if dt == "fp32" else 0.05)
    for batch in ({"tokens": toks, "enc_embeds": emb},
                  {"tokens": toks, "enc_embeds": emb,
                   "targets": np.zeros_like(toks)}):   # ignored
        r_loss, r_met = rb.loss(rp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        loss, met = b.loss(p, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        for ours, theirs in ((loss, r_loss), (met["nll"], r_met["nll"])):
            assert abs(float(ours) - float(theirs)) <= \
                TOL[dt] * abs(float(theirs)), (dt, float(ours), theirs)
        assert float(met["aux"]) == float(r_met["aux"]) == 0.0


def test_remat_recomputes_the_same_values():
    _, _, b, p = _models("fp32")
    toks, emb = _inputs(b.cfg, 2, 9, seed=6)
    batch = {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(emb)}
    out = []
    for remat in (True, False):
        leaves, td = tree_flatten(p)
        live = [x.clone().requires_grad_(True) for x in leaves]
        loss, _ = b.loss(td.unflatten(live), batch, with_remat=remat)
        out.append([loss.detach()] + list(torch.autograd.grad(loss, live)))
    assert all(torch.equal(x, y) for x, y in zip(*out))


# -- prefill and decode --------------------------------------------------------

def _caches_close(ours, theirs, atol):
    ol, tl = tree_flatten(ours)[0], jax.tree_util.tree_leaves(theirs)
    assert len(ol) == len(tl) == 4
    for a, t in zip(ol, tl):
        np.testing.assert_allclose(_f32(a), _f32(t), atol=atol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_prefill_and_three_decode_steps_match_the_reference(dt):
    rb, rp, b, p = _models(dt)
    toks, emb = _inputs(b.cfg, 2, 13, seed=2)
    atol = ATOL if dt == "fp32" else 0.05
    r_logits, r_st = rb.prefill(
        rp, {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(emb)},
        rb.init_caches(jax.random.PRNGKey(0), 2, T_MAX))
    logits, st = b.prefill(p, {"tokens": torch.from_numpy(toks).long(),
                               "enc_embeds": torch.from_numpy(emb)},
                           b.init_caches(2, T_MAX))
    np.testing.assert_allclose(_f32(logits), _f32(r_logits), atol=atol)
    _caches_close(st.caches, r_st.caches, atol)
    assert int(st.pos) == int(r_st.pos) == 13
    seq = toks
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(r_logits, -1)).astype(np.int32)[:, None]
        seq = np.concatenate([seq, nxt], 1)
        r_logits, r_st = rb.decode(rp, jnp.asarray(nxt), r_st)
        logits, st = b.decode(p, torch.from_numpy(nxt).long(), st)
        np.testing.assert_allclose(_f32(logits), _f32(r_logits), atol=atol)
        _caches_close(st.caches, r_st.caches, atol)
        assert int(st.pos) == int(r_st.pos)
        # the decode holds against a full forward over the same tokens
        full = _full_logits(b.cfg, p, seq, emb)[:, -1]
        assert float(np.abs(_f32(logits) - full).max()) < 0.05
        assert np.array_equal(_f32(logits).argmax(-1), full.argmax(-1))


def test_decode_past_the_table_clamps_as_the_reference():
    """A decode at position 500 (past the 448-row table) reads its last
    row: one step from a zero cache, as the reference's ``decode_tokens``
    takes it."""
    rb, rp, b, p = _models("fp32")
    cfg = b.cfg
    toks, emb = _inputs(cfg, 2, 1, seed=3)
    r_caches = rb.init_caches(jax.random.PRNGKey(0), 2, 512)
    enc = ref_encdec.encode(rb.cfg, rp, jnp.asarray(emb))
    _, r_caches = ref_encdec.decode_tokens(
        rb.cfg, rp, jnp.asarray(toks), enc, caches=r_caches)
    caches = b.init_caches(2, 512)
    _, caches = encdec.decode_tokens(
        cfg, p, torch.from_numpy(toks).long(),
        encdec.encode(cfg, p, torch.from_numpy(emb)), caches=caches)
    pos = 500
    rx, _ = ref_encdec.decode_tokens(rb.cfg, rp, jnp.asarray(toks), None,
                                     caches=r_caches,
                                     pos=jnp.asarray(pos, jnp.int32),
                                     decode=True)
    x, _ = encdec.decode_tokens(cfg, p, torch.from_numpy(toks).long(), None,
                                caches=caches,
                                pos=torch.tensor(pos, dtype=torch.int32),
                                decode=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=ATOL)


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_train_step_matches_the_reference_over_three_steps(dt):
    rb, rp, b, p = _models(dt)
    r_state = ref_init_train_state(rp, jax.random.PRNGKey(0))
    r_step = jax.jit(ref_make_train_step(rb))
    state = init_train_state(p, 0)
    step = make_train_step(b)
    tol = TOL[dt]
    zero_init = [d.init == "zeros"
                 for d in tree_flatten(b.descs, is_leaf=is_desc)[0]]
    p_tols = [STATE_TOL[dt] * (10 if z else 1) for z in zero_init]
    for i in range(3):
        toks, emb = _inputs(b.cfg, 2, 17, seed=10 + i)
        batch = {"tokens": toks, "enc_embeds": emb}
        r_state, r_met = r_step(r_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        assert sorted(met) == sorted(r_met)
        assert int(met["step"]) == int(r_met["step"]) == i + 1
        assert float(met["lr"]) == float(r_met["lr"])
        for k in ("loss", "grad_norm", "nll"):
            assert abs(float(met[k]) - float(r_met[k])) <= \
                tol * abs(float(r_met[k])), (i, k)
        _assert_trees_close(state.params, r_state.params, p_tols, "params")
        _assert_trees_close(state.opt.mu, r_state.opt.mu, STATE_TOL[dt],
                            "mu")
        _assert_trees_close(state.opt.nu, r_state.opt.nu, STATE_TOL[dt],
                            "nu")
    assert float(r_met["lr"]) > 0 and any(zero_init)


class FramesPipeline:
    """A data pipeline plus frame embeddings: ``enc_embeds`` (B, enc_seq,
    D) float32 drawn with numpy from the pipeline's (seed, step), so a
    batch is a function of the pipeline state the loop commits (the
    reference's audio frontend is a stub and has no source of frames)."""

    def __init__(self, base, enc_seq: int, d_model: int):
        self.base, self.enc_seq, self.d_model = base, enc_seq, d_model

    @property
    def state(self):
        return self.base.state

    @state.setter
    def state(self, s):
        self.base.state = s

    def next_global(self):
        st = self.base.state
        batch = self.base.next_global()
        rng = np.random.default_rng([st.seed, st.step])
        batch["enc_embeds"] = rng.standard_normal(
            (self.base.global_batch, self.enc_seq, self.d_model),
            dtype=np.float32)
        return batch


def _frames_pipe(pipe_cls, source_cls, cfg):
    return FramesPipeline(pipe_cls(source_cls(cfg.vocab_size), 2, 16),
                          cfg.encdec.enc_seq, cfg.d_model)


def test_frames_pipeline_batches_follow_the_committed_state():
    cfg = get_smoke_config(ARCH)
    a = _frames_pipe(DataPipeline, SyntheticLMSource, cfg)
    first = [a.next_global() for _ in range(3)]
    b = _frames_pipe(RefDataPipeline, RefSource, cfg)
    b.state = type(b.state)(seed=0, step=1)
    again = b.next_global()
    for k in ("tokens", "enc_embeds"):
        assert np.array_equal(first[1][k], again[k])
    assert not np.array_equal(first[0]["enc_embeds"], first[1]["enc_embeds"])


def _close(ours, theirs, tol=1e-5):
    for x, y in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        y = np.asarray(y, np.float32)
        assert float(np.abs(x.float().numpy() - y).max()) <= \
            tol * max(float(np.abs(y).max()), 1e-30)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_whisper_pool_crosses_packages_both_ways(writer, tmp_path):
    """Each package writes 4 steps of the durable loop (a sync commit every
    2) on the frames pipeline; the other resumes at step 3 and runs to 6,
    ending where a 6-step run of the writer ends (fp32, 1e-5 x max|ref|)."""
    rb, rp, b, p = _models("fp32")
    r_step, step = jax.jit(ref_make_train_step(rb)), make_train_step(b)
    r_state = ref_init_train_state(rp, jax.random.PRNGKey(0))
    state = init_train_state(p, 0)
    kw = dict(commit_every=2, commit_mode="sync")
    path = str(tmp_path / "pool")

    def ref_run(pool, n, **more):
        return ref_run_durable_loop(
            r_step, r_state, _frames_pipe(RefDataPipeline, RefSource,
                                          rb.cfg),
            RefPool(pool), n_steps=n, **kw, **more)

    def port_run(pool, n, **more):
        return run_durable_loop(
            step, state, _frames_pipe(DataPipeline, SyntheticLMSource, b.cfg),
            DSMPool(pool), n_steps=n, **kw, **more)

    first, then = ((ref_run, port_run) if writer == "reference"
                   else (port_run, ref_run))
    first(path, 4)
    r = then(path, 6, resume=True)
    assert r.resumed_from == 3 and len(r.losses) == 2
    assert r.pipeline_state.step == 6
    want = first(str(tmp_path / "whole"), 6)
    ours, theirs = (r, want) if writer == "reference" else (want, r)
    assert int(ours.state.opt.step) == int(theirs.state.opt.step) == 6
    _close(ours.state.params, theirs.state.params)
    _close(ours.state.opt.mu, theirs.state.opt.mu)
    _close(ours.state.opt.nu, theirs.state.opt.nu)
    np.testing.assert_allclose(ours.losses[-2:], theirs.losses[-2:],
                               rtol=1e-5)
