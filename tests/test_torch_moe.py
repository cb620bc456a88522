"""The port's MoE block and grouped matmul against the JAX package's.

* the grouped matmul: the port's dispatcher on the CPU (its plain version)
  against the JAX TPU kernel run by the Pallas interpreter
  (``grouped_matmul_kernel(..., interpret=True)``, the block sizes of
  ``tests/test_kernels.py``'s ``GMM_CASES``, so the padded edges are
  exercised) and against the JAX plain version.  fp32 at atol 1e-4 (the
  same sums in another order); bf16 inputs at atol 0.5, the reference
  test's own tolerance (bf16 output rounding of values up to ~30);
* qk-norm: ``rms_head_norm`` and GQA prefill / decode with q / k normed
  before rope, fp32 at atol 1e-5;
* ``moe_forward`` against ``repro.models.moe.moe_forward(parallel=None)``
  on the olmoe smoke config in fp32: y and aux at atol 1e-5; with a
  skewed router that forces capacity drops, the drop destinations equal
  exactly; per-sequence routing against the reference's per-sequence
  ``vmap``; top-k ties to the lower expert index as ``jax.lax.top_k``;
  shared experts (deepseek-v2's ``n_shared``) under both routes.

Weights are the reference's ``jax.random`` params carried across; inputs
are numpy from a seed.  The CUDA kernel has no CPU mode:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against the
plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels.moe_gmm.kernel import grouped_matmul_kernel
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jax_gmm_ref
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models.common import rms_head_norm as ref_rms_head_norm
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.moe_gmm import ops
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref
from repro_torch.models import attention, moe
from repro_torch.models.common import rms_head_norm
from repro_torch.models.params import from_reference

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ATOL = 1e-5

# tests/test_kernels.py GMM_CASES: E, C, D, F, (block_c, block_f, block_d)
GMM_CASES = [
    (4, 64, 128, 256, (32, 64, 64)), (8, 40, 64, 96, (16, 32, 32)),
    (2, 128, 96, 64, (64, 64, 32)), (16, 8, 32, 32, (8, 32, 32)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return (get_smoke_config("olmoe-1b-7b").with_(**FP32),
            ref_smoke_config("olmoe-1b-7b").with_(**FP32))


def _params(descs_fn, cfg, ref_cfg, seed=0):
    """The reference's params for one module, and the port's copy."""
    rp = ref_init_params(descs_fn(ref_cfg), jax.random.PRNGKey(seed),
                         ref_cfg.param_dtype)
    return rp, from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES,
                         ids=lambda c: f"E{c[0]}C{c[1]}D{c[2]}F{c[3]}")
def test_plain_grouped_matmul_matches_pallas_kernel(case, dtype):
    E, C, D, F, (bc, bf, bd) = case
    rng = np.random.default_rng(0)
    x = rng.standard_normal((E, C, D), np.float32)
    w = rng.standard_normal((E, D, F), np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    kern = grouped_matmul_kernel(jx, jw, block_c=bc, block_f=bf,
                                 block_d=bd, interpret=True)
    theirs = jax_gmm_ref(jx, jw)
    before = ops.LAUNCHES
    ours = ops.grouped_matmul(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt))
    assert ops.LAUNCHES == before           # the CPU path launches nothing
    assert ours.dtype == tdt and tuple(ours.shape) == (E, C, F)
    tol = 0.5 if dtype == "bfloat16" else 1e-4
    for ref in (kern, theirs):
        np.testing.assert_allclose(ours.float().numpy(),
                                   np.asarray(ref, np.float32), atol=tol)


def test_dispatcher_refuses_tensors_on_two_devices():
    x = torch.zeros((2, 3, 8))
    w = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul(x, w)


def test_rms_head_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 2, 16), np.float32) * 3
    s = rng.standard_normal((16,), np.float32)
    ours = rms_head_norm(torch.from_numpy(x), torch.from_numpy(s))
    theirs = ref_rms_head_norm(jnp.asarray(x), jnp.asarray(s))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def test_gqa_with_qk_norm_matches_reference():
    """Prefill attention and one decode step with q / k normed before
    rope; the decode's cache holds the normed, roped k."""
    cfg, ref_cfg = _cfg()
    assert cfg.qk_norm
    rp, p = _params(ref_attention.gqa_descs, cfg, ref_cfg)
    # non-trivial norm scales, so a missing or misplaced norm shows
    rng = np.random.default_rng(2)
    for name in ("q_norm", "k_norm"):
        s = 1 + 0.5 * rng.standard_normal(cfg.head_dim).astype(np.float32)
        rp[name] = jnp.asarray(s)
        p[name] = torch.from_numpy(s)
    B, S, T = 2, 9, 16
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    theirs = ref_attention.gqa_forward(ref_cfg, rp, jnp.asarray(x),
                                       jnp.asarray(pos))
    ours = attention.gqa_forward(cfg, p, torch.from_numpy(x),
                                 torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)

    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape, np.float32)
    cv = rng.standard_normal(shape, np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ry, rc = ref_attention.gqa_decode(
        ref_cfg, rp, jnp.asarray(x1),
        ref_attention.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
        jnp.asarray(7, jnp.int32))
    y, c = attention.gqa_decode(
        cfg, p, torch.from_numpy(x1),
        attention.KVCache(torch.from_numpy(ck.copy()),
                          torch.from_numpy(cv.copy())),
        torch.tensor(7))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-4)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(rc.k), atol=ATOL)
    np.testing.assert_allclose(c.v.numpy(), np.asarray(rc.v), atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 12), (2, 20), (3, 7)],
                         ids=lambda s: f"B{s[0]}S{s[1]}")
def test_moe_forward_matches_reference(shape):
    cfg, ref_cfg = _cfg()
    rp, p = _params(ref_moe.moe_descs, cfg, ref_cfg)
    x = np.random.default_rng(3).standard_normal(
        shape + (cfg.d_model,), np.float32)
    ry, raux = ref_moe.moe_forward(ref_cfg, rp, jnp.asarray(x),
                                   parallel=None)
    y, aux = moe.moe_forward(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), atol=ATOL)


def _skewed(rp, p, cfg):
    """A router whose logits favour experts 0 and 1 by a wide margin, so
    nearly every token picks them and their capacity binds."""
    bias = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    bias[:, :2] = 0.5
    rp = dict(rp, router=rp["router"] + jnp.asarray(bias))
    p = dict(p, router=p["router"] + torch.from_numpy(bias))
    return rp, p


def test_skewed_router_drops_the_reference_choices():
    cfg, ref_cfg = _cfg()
    rp, p = _skewed(*_params(ref_moe.moe_descs, cfg, ref_cfg, seed=1), cfg)
    T = 40
    x = np.abs(np.random.default_rng(4).standard_normal(
        (T, cfg.d_model), np.float32))      # positive: the bias dominates
    cap = moe._capacity(T, cfg)
    assert cap == ref_moe._capacity(T, ref_cfg)
    rw, ridx, raux = ref_moe._route(ref_cfg, rp["router"], jnp.asarray(x))
    w, idx, aux = moe._route(cfg, p["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(raux), atol=ATOL)
    rbuf, rdest = ref_moe._pack(ref_cfg, jnp.asarray(x), ridx, cap)
    buf, dest = moe._pack(cfg, torch.from_numpy(x), idx, cap)
    drop = cfg.moe.n_experts * cap
    assert int((dest == drop).sum()) > T // 2     # capacity really binds
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    ry, _ = ref_moe.moe_forward(ref_cfg, rp, jnp.asarray(x)[None],
                                parallel=None)
    y, _ = moe.moe_forward(cfg, p, torch.from_numpy(x)[None])
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)


def test_per_sequence_routing_matches_the_reference_per_sequence_vmap():
    """``per_sequence=True`` is the reference's ``vmap`` of single-sequence
    MoE: each row its own capacity.  With the skewed router capacity
    binds, so pooled routing would give a different function."""
    cfg, ref_cfg = _cfg()
    rp, p = _skewed(*_params(ref_moe.moe_descs, cfg, ref_cfg, seed=2), cfg)
    x = np.abs(np.random.default_rng(5).standard_normal(
        (4, 10, cfg.d_model), np.float32))
    ry, raux = jax.vmap(lambda r: ref_moe.moe_forward(
        ref_cfg, rp, r[None], parallel=None))(jnp.asarray(x))
    y, aux = moe.moe_forward(cfg, p, torch.from_numpy(x), per_sequence=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry)[:, 0], atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jnp.mean(raux)), atol=ATOL)
    pooled, _ = moe.moe_forward(cfg, p, torch.from_numpy(x))
    assert not np.allclose(pooled.numpy(), y.numpy(), atol=1e-3)


def test_top_k_ties_go_to_the_lower_index():
    probs = np.asarray([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                        [0.4, 0.1, 0.4, 0.1]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(probs), 2)
    v, i = moe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["pooled", "per_sequence"])
def test_shared_experts_match_the_reference(per_sequence):
    """The olmoe smoke config with 2 shared experts (deepseek-v2's count):
    the shared MLP's params are the reference's, and its output is added
    under both routes."""
    import dataclasses
    cfg, ref_cfg = _cfg()
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=2))
    ref_cfg = ref_cfg.with_(moe=dataclasses.replace(ref_cfg.moe, n_shared=2))
    rp, p = _params(ref_moe.moe_descs, cfg, ref_cfg, seed=2)
    assert tuple(p["shared"]["w_up"].shape) == (cfg.d_model,
                                                2 * cfg.moe.d_ff_expert)
    x = np.random.default_rng(4).standard_normal((3, 5, cfg.d_model),
                                                 np.float32)
    y, aux = moe.moe_forward(cfg, p, torch.from_numpy(x),
                             per_sequence=per_sequence)
    rows = [x[b:b + 1] for b in range(3)] if per_sequence else [x]
    outs = [ref_moe.moe_forward(ref_cfg, rp, jnp.asarray(r), parallel=None)
            for r in rows]
    np.testing.assert_allclose(
        y.numpy(), np.concatenate([np.asarray(o[0]) for o in outs]),
        atol=ATOL)
    np.testing.assert_allclose(float(aux),
                               np.mean([float(o[1]) for o in outs]),
                               atol=ATOL)
