"""The port on the card: the hand-written Hopper kernels and the paths that
run them.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card, where there is no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

* the flash-attention kernel against its plain version at small ragged,
  GQA, ``hd_v != hd`` and non-causal shapes (bf16; max abs error 2e-2 =
  bf16 output rounding, one ulp near 1 is 7.8e-3), one launch counted per
  call; and at the edges of its tiles and buckets (Sq 1, Sq 65, non-causal
  Sq != Sk, hd 64 and 256, hd_v != hd), each run twice with the same bits;
* the dispatcher refuses what the kernel does not take (it never falls
  back to the plain version for a CUDA tensor);
* a serving run of the olmo-1b smoke config on the card launches the
  kernel once per layer per prefill;
* the grouped-matmul kernel against its plain version at small ragged
  shapes (bf16; limit 1e-2 * max|plain| elementwise: one rounding of the
  fp32 sum to bf16 is half an ulp, 3.9e-3 relative) — C 1 to 300 (one
  16-row chunk, several, past 128 rows, two passes of 256), D 1000, F 72
  and F not a multiple of 64 — a row's output bit-identical wherever the
  row sits (C 70 / 8, and the capacities C 80 / 32), the dispatcher's
  refusals, and an
  olmoe-1b-7b smoke serving run that launches it 3 times per MoE block
  per forward (6 = 3 x 2 blocks, prefills and decode ticks alike) while
  the flash kernel runs once per layer per prefill;
* the WKV-6 kernel against the fp32 step-by-step oracle on the same
  bf16-valued inputs, on the reference's sweep shapes, the rwkv6-7b
  path's two shapes (prefill (1, 512, 64, 64), decode (4, 1, 64, 64)),
  ragged T, T at the step / chunked routes' threshold (63, 64) and at the
  edges of the 64-step chunks and 16-step sub-blocks, 2048 steps (32
  chunks), and strong and near-identity decays (y and S within 1e-3 x
  max|oracle|: TF32 products with split operands, fp32 sums in another
  order); on both routes the state written in place over S0 with the same
  bits and a (b, h) row bit-identical whatever B is and whatever the other
  rows hold; the dispatcher's refusals, and an rwkv6-7b smoke serving run
  that launches it once per layer per prefill and per decode tick;
* the selective-scan kernel against the fp32 step recurrence on the
  reference's sweep shapes (``SCAN_CASES``), the jamba-1.5-large path's
  two shapes (prefill chunk (1, 256, 16384, 16), decode (4, 1, 16384, 16)),
  ragged S and I and N in {4, 8, 16} and one not a multiple of 4 (y and h
  within 1e-4 x max|plain|: the inputs are fp32, so only the order of the
  sums differs), h written in place over h0 with the same bits, a (b, i)
  row bit-identical whatever B and I are and whatever the other rows
  hold, the dispatcher's refusals, and a jamba smoke serving run that
  launches it once per mamba layer per prefill chunk and per decode tick,
  the flash kernel once per attention layer per prefill and the grouped
  matmul 3 times per MoE layer per forward;
* each of the four dispatchers, given an input that requires grad under
  grad mode, raises before it launches (the kernels have no backward
  yet), and launches the same call under ``torch.no_grad()``;
* the CXL0 model's tensor twin (``core.semantics_torch``, plain PyTorch:
  no kernel of its own) gives on the card the bits it gives on the CPU
  for 4,096 schedules on two systems, and ``random_schedules`` with a
  CUDA generator draws CUDA actions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import semantics_torch as cxl0
from repro_torch.kernels.attention import ops
from repro_torch.kernels.mamba import ops as scan_ops
from repro_torch.kernels.mamba.ref import selective_scan_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_ref

CASES = [
    # B, H, K, Sq, Sk, hd, hd_v, causal
    (1, 2, 2, 37, 37, 16, 16, True),        # ragged, causal
    (2, 4, 2, 40, 40, 16, 16, True),        # GQA
    (1, 4, 1, 24, 24, 32, 16, True),        # hd_v != hd, K=1
    (2, 2, 2, 20, 33, 16, 16, False),       # non-causal, Sq != Sk
    (1, 4, 2, 33, 33, 8, 24, False),        # hd_v > hd, GQA
    (1, 2, 1, 130, 200, 128, 128, True),    # several tiles, Sq < Sk
]
IDS = [f"B{c[0]}H{c[1]}K{c[2]}S{c[3]}x{c[4]}hd{c[5]}v{c[6]}"
       f"{'c' if c[7] else 'f'}" for c in CASES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, device, seed):
    """bf16 inputs in the model layout: q (B,S,K,G,hd), k/v (B,T,K,hd)."""
    B, H, K, Sq, Sk, hd, hd_v, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, K, H // K, hd), np.float32)
    k = rng.standard_normal((B, Sk, K, hd), np.float32)
    v = rng.standard_normal((B, Sk, K, hd_v), np.float32)
    return [torch.from_numpy(a).to(device, torch.bfloat16) for a in (q, k, v)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_matches_plain_version(case, cuda):
    B, H, K, Sq, Sk, hd, hd_v, causal = case
    q, k, v = _inputs(case, cuda, seed=3)
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert out.shape == (B, Sq, K, H // K, hd_v) and out.dtype == torch.bfloat16
    ref = ops.plain_attention(q.float(), k.float(), v.float(), causal=causal)
    assert float((out.float() - ref).abs().max()) <= 2e-2


def test_kernel_is_deterministic(cuda):
    q, k, v = _inputs(CASES[-1], cuda, seed=4)
    a = ops.flash_attention(q, k, v, causal=True)
    b = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(a, b)


EDGE_CASES = [
    # B, H, K, Sq, Sk, hd, hd_v, causal
    (1, 4, 2, 1, 1, 128, 128, True),        # one row
    (2, 4, 4, 1, 77, 128, 128, False),      # one row against a cache
    (1, 4, 2, 65, 65, 128, 128, True),      # one row past a q tile
    (1, 2, 2, 65, 130, 128, 128, False),    # non-causal, Sq != Sk
    (1, 4, 2, 200, 200, 64, 64, True),      # hd 64
    (1, 2, 1, 150, 150, 256, 256, True),    # hd 256
    (1, 4, 2, 130, 130, 128, 64, True),     # hd_v < hd
    (1, 2, 2, 100, 160, 64, 256, False),    # hd_v > hd
    (1, 8, 1, 300, 300, 256, 128, True),    # hd 256, hd_v 128, GQA 8
    (2, 48, 8, 200, 200, 128, 128, True),   # more q tiles than SMs
    (1, 48, 4, 200, 230, 256, 128, False),  # ... at hd 256, non-causal
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=[
    f"B{c[0]}H{c[1]}K{c[2]}S{c[3]}x{c[4]}hd{c[5]}v{c[6]}"
    f"{'c' if c[7] else 'f'}" for c in EDGE_CASES])
def test_kernel_edges_match_plain_version_bit_for_bit_twice(case, cuda):
    B, H, K, Sq, Sk, hd, hd_v, causal = case
    q, k, v = _inputs(case, cuda, seed=14)
    out = ops.flash_attention(q, k, v, causal=causal)
    again = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.shape == (B, Sq, K, H // K, hd_v)
    ref = ops.plain_attention(q.float(), k.float(), v.float(), causal=causal)
    assert float((out.float() - ref).abs().max()) <= 2e-2


@pytest.mark.parametrize("bad", ["float32", "strided", "hd_not_mult_8"])
def test_dispatcher_raises_on_what_the_kernel_does_not_take(bad, cuda):
    q, k, v = _inputs(CASES[0], cuda, seed=5)
    if bad == "float32":
        q, k, v = q.float(), k.float(), v.float()
        err = TypeError
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    else:
        q, k = q[..., :12].contiguous(), k[..., :12].contiguous()
        err = ValueError
    before = ops.LAUNCHES
    with pytest.raises(err):
        ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES == before


def test_serving_prefills_run_the_kernel(cuda):
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(5, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("olmo-1b", smoke=True, n_slots=2,
                                     t_max=trace_t_max(trace), device=cuda)
    before = ops.LAUNCHES
    res = engine.run(trace)
    assert res.prefills == len(trace)
    assert ops.LAUNCHES - before == cfg.n_layers * res.prefills
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


GMM_CASES = [  # E, C, D, F
    (3, 37, 200, 72),       # ragged C, D % 64 != 0, F < one tile
    (3, 1, 200, 72),        # one row
    (2, 70, 136, 264),      # two C tiles, ragged F over three tiles
    (4, 32, 256, 128),      # the decode layout at small width
    (1, 8, 8, 8),           # the smallest shape the kernel takes
    (2, 1, 128, 128),       # C 1: one row of one 16-row chunk
    (2, 8, 64, 256),        # C 8
    (3, 32, 512, 384),      # C 32: the decode capacity, two chunks
    (2, 80, 448, 256),      # C 80: the prefill capacity, five chunks
    (2, 129, 256, 136),     # past 128 rows; F past one 128-column strip
    (2, 256, 128, 200),     # the most rows one pass holds; F % 64 != 0
    (2, 300, 136, 72),      # two passes over the weights
    (3, 48, 1000, 256),     # D 1000: a ragged last 64-deep stage
    (2, 40, 264, 72),       # F 72: the second 64-column box past F
]


def _gmm_inputs(case, device, seed):
    E, C, D, F = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D), np.float32)
    w = rng.standard_normal((E, D, F), np.float32) * 0.1
    return [torch.from_numpy(a).to(device, torch.bfloat16) for a in (x, w)]


@pytest.mark.parametrize("case", GMM_CASES,
                         ids=lambda c: "E%dC%dD%dF%d" % c)
def test_grouped_matmul_kernel_matches_plain_version(case, cuda):
    x, w = _gmm_inputs(case, cuda, seed=6)
    before = gmm_ops.LAUNCHES
    out = gmm_ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm_ops.LAUNCHES == before + 1
    E, C, D, F = case
    assert out.shape == (E, C, F) and out.dtype == torch.bfloat16
    ref = grouped_matmul_ref(x.float(), w.float())
    err = float((out.float() - ref).abs().max())
    assert err <= 1e-2 * float(ref.abs().max())


def test_grouped_matmul_row_bits_do_not_depend_on_where_the_row_sits(cuda):
    x, w = _gmm_inputs((2, 70, 136, 264), cuda, seed=7)
    out = gmm_ops.grouped_matmul(x, w)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(70)).to(cuda)
    moved = gmm_ops.grouped_matmul(x[:, perm].contiguous(), w)
    assert torch.equal(moved, out[:, perm])
    # the same rows in a buffer of another capacity give the same bits
    part = gmm_ops.grouped_matmul(x[:, 3:11].contiguous(), w)
    assert torch.equal(part, out[:, 3:11])
    assert torch.equal(gmm_ops.grouped_matmul(x, w), out)
    # the prefill and decode capacities: rows 40..71 of a C = 80 buffer
    # alone in a C = 32 one
    x, w = _gmm_inputs((2, 80, 448, 256), cuda, seed=17)
    out = gmm_ops.grouped_matmul(x, w)
    part = gmm_ops.grouped_matmul(x[:, 40:72].contiguous(), w)
    assert torch.equal(part, out[:, 40:72])


@pytest.mark.parametrize("bad", ["float32", "strided", "d_not_mult_8",
                                 "w_on_cpu"])
def test_grouped_matmul_dispatcher_raises_on_what_the_kernel_does_not_take(
        bad, cuda):
    x, w = _gmm_inputs((2, 16, 64, 32), cuda, seed=8)
    if bad == "float32":
        x, w = x.float(), w.float()
        err = TypeError
    elif bad == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    elif bad == "d_not_mult_8":
        x, w = x[..., :60].contiguous(), w[:, :60].contiguous()
        err = ValueError
    else:
        w = w.cpu()
        err = ValueError
    before = gmm_ops.LAUNCHES
    with pytest.raises(err):
        gmm_ops.grouped_matmul(x, w)
    assert gmm_ops.LAUNCHES == before


def test_olmoe_serving_runs_both_kernels(cuda):
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(5, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("olmoe-1b-7b", smoke=True, n_slots=2,
                                     t_max=trace_t_max(trace), device=cuda)
    decodes = []
    step = engine._slot_decode
    engine._slot_decode = lambda *a: decodes.append(1) or step(*a)
    flash0, gmm0 = ops.LAUNCHES, gmm_ops.LAUNCHES
    res = engine.run(trace)
    assert res.prefills == len(trace) and decodes
    assert ops.LAUNCHES - flash0 == cfg.n_layers * res.prefills
    assert gmm_ops.LAUNCHES - gmm0 == \
        3 * cfg.n_layers * (res.prefills + len(decodes))
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


WKV_CASES = [  # B, T, H, n[, log decay]
    (2, 128, 2, 32), (1, 96, 4, 64), (2, 100, 2, 16), (1, 33, 1, 64),
    (1, 512, 64, 64),       # the rwkv6-7b prefill
    (4, 1, 64, 64),         # the rwkv6-7b decode tick
    (3, 17, 3, 32),         # ragged: one full chunk of 16 steps and one step
    # the routes' threshold (the step route below 64 steps) and the edges
    # of the chunked route's 64-step chunks and 16-step sub-blocks
    (1, 63, 2, 64), (1, 64, 2, 64), (2, 65, 3, 32), (1, 128, 2, 64),
    (1, 129, 2, 16), (5, 300, 3, 32),
    (1, 2048, 8, 64),       # many chunks
    # log decays -exp(x), x in [1, 3]: the state forgets within a step
    (2, 1, 4, 64, "strong"), (1, 40, 2, 32, "strong"),
    (2, 200, 4, 64, "strong"),
    # x in [-9, -7]: near identity, the state keeps everything
    (1, 40, 2, 64, "weak"), (2, 200, 4, 64, "weak"),
    (1, 2048, 8, 64, "weak"),
]


def _wkv_id(case):
    return "B%dT%dH%dn%d" % case[:4] + ("-" + case[4] if len(case) > 4 else "")


def _wkv_inputs(case, device, seed):
    """r, k, v bf16; logw, u, S0 fp32 — the kernel's types.  The log
    decay is the reference sweep's -exp(N * 0.5) unless the case names
    "strong" (-exp(x), x uniform in [1, 3]) or "weak" (x in [-9, -7])."""
    B, T, H, n = case[:4]
    decay = case[4] if len(case) > 4 else None
    g = np.random.default_rng(seed)
    r = g.standard_normal((B, T, H, n), np.float32)
    k = g.standard_normal((B, T, H, n), np.float32) * 0.5
    v = g.standard_normal((B, T, H, n), np.float32)
    logw = -np.exp(g.standard_normal((B, T, H, n), np.float32) * 0.5)
    if decay is not None:
        lo, hi = {"strong": (1.0, 3.0), "weak": (-9.0, -7.0)}[decay]
        logw = -np.exp(g.uniform(lo, hi, (B, T, H, n))).astype(np.float32)
    u = g.standard_normal((H, n), np.float32) * 0.3
    S0 = g.standard_normal((B, H, n, n), np.float32) * 0.1
    bf = [torch.from_numpy(a).to(device, torch.bfloat16) for a in (r, k, v)]
    return bf + [torch.from_numpy(a).to(device) for a in (logw, u, S0)]


@pytest.mark.parametrize("case", WKV_CASES, ids=_wkv_id)
def test_wkv6_kernel_matches_the_oracle(case, cuda):
    r, k, v, logw, u, S0 = _wkv_inputs(case, cuda, seed=9)
    before = wkv_ops.LAUNCHES
    y, S = wkv_ops.wkv6(r, k, v, logw, u, S0)
    torch.cuda.synchronize()
    assert wkv_ops.LAUNCHES == before + 1
    assert y.shape == r.shape and y.dtype == torch.float32
    y_ref, S_ref = wkv6_ref(r, k, v, logw, u, S0)
    for got, want in ((y, y_ref), (S, S_ref)):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("T", [40, 200], ids=["step", "chunked"])
def test_wkv6_kernel_writes_the_state_in_place(T, cuda):
    r, k, v, logw, u, S0 = _wkv_inputs((2, T, 3, 64), cuda, seed=10)
    y, S = wkv_ops.wkv6(r, k, v, logw, u, S0)
    state = S0.clone()
    y2, S2 = wkv_ops.wkv6(r, k, v, logw, u, state, state_out=state)
    assert S2 is state
    assert torch.equal(S2, S) and torch.equal(y2, y)


@pytest.mark.parametrize("T", [37, 200], ids=["step", "chunked"])
def test_wkv6_row_bits_do_not_depend_on_the_batch(T, cuda):
    r, k, v, logw, u, S0 = _wkv_inputs((4, T, 4, 64), cuda, seed=11)
    y, S = wkv_ops.wkv6(r, k, v, logw, u, S0)
    one = wkv_ops.wkv6(*(t[2:3].contiguous() for t in (r, k, v, logw)), u,
                       S0[2:3].contiguous())
    assert torch.equal(one[0], y[2:3]) and torch.equal(one[1], S[2:3])
    # row 2 again, the other rows holding other data
    o = _wkv_inputs((4, T, 4, 64), cuda, seed=12)
    mixed = [torch.cat([b[:2], a[2:3], b[3:]]) for a, b in
             zip((r, k, v, logw), o[:4])]
    y3, S3 = wkv_ops.wkv6(*mixed, u, torch.cat([o[5][:2], S0[2:3],
                                                o[5][3:]]))
    assert torch.equal(y3[2], y[2]) and torch.equal(S3[2], S[2])


@pytest.mark.parametrize("bad", ["r_float32", "logw_bf16", "strided",
                                 "n48", "s0_on_cpu", "overlap"])
def test_wkv6_dispatcher_raises_on_what_the_kernel_does_not_take(bad, cuda):
    r, k, v, logw, u, S0 = _wkv_inputs((2, 8, 2, 32), cuda, seed=13)
    state_out, err = None, ValueError
    if bad == "r_float32":
        r, err = r.float(), TypeError
    elif bad == "logw_bf16":
        logw, err = logw.to(torch.bfloat16), TypeError
    elif bad == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "n48":
        r, k, v, logw, u, S0 = _wkv_inputs((2, 8, 2, 48), cuda, seed=13)
    elif bad == "s0_on_cpu":
        S0 = S0.cpu()
    else:                                  # state_out overlaps S0
        big = torch.zeros(S0.numel() + 8, device=cuda)
        S0, state_out = (big[:S0.numel()].view(S0.shape),
                         big[8:].view(S0.shape))
    before = wkv_ops.LAUNCHES
    with pytest.raises(err):
        wkv_ops.wkv6(r, k, v, logw, u, S0, state_out=state_out)
    assert wkv_ops.LAUNCHES == before


def test_rwkv_serving_runs_the_wkv_kernel(cuda):
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(5, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("rwkv6-7b", smoke=True, n_slots=2,
                                     t_max=trace_t_max(trace), device=cuda)
    decodes = []
    step = engine._slot_decode
    engine._slot_decode = lambda *a: decodes.append(1) or step(*a)
    flash0, wkv0 = ops.LAUNCHES, wkv_ops.LAUNCHES
    res = engine.run(trace)
    assert res.prefills == len(trace) and decodes
    assert ops.LAUNCHES == flash0                  # attention-free
    assert wkv_ops.LAUNCHES - wkv0 == \
        cfg.n_layers * (res.prefills + len(decodes))
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


def _grad_case(name, device):
    """(dispatcher module, call, inputs) at a small shape the CUDA kernel
    takes, in its types."""
    g = torch.Generator(device).manual_seed(17)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    if name == "flash_attention":
        return ops, ops.flash_attention, [rn(1, 16, 2, 1, 64),
                                          rn(1, 16, 2, 64), rn(1, 16, 2, 64)]
    if name == "grouped_matmul":
        return gmm_ops, gmm_ops.grouped_matmul, [rn(2, 16, 64), rn(2, 64, 32)]
    if name == "wkv6":
        return wkv_ops, wkv_ops.wkv6, _wkv_inputs((1, 8, 2, 32), device, 18)
    f32 = torch.float32
    return scan_ops, scan_ops.selective_scan, [
        torch.sigmoid(rn(1, 8, 32, 4, dtype=f32)), rn(1, 8, 32, 4, dtype=f32),
        rn(1, 8, 4, dtype=f32), rn(1, 32, 4, dtype=f32)]


@pytest.mark.parametrize("name", ["flash_attention", "grouped_matmul",
                                  "wkv6", "selective_scan"])
def test_cuda_dispatchers_refuse_inputs_that_require_grad(name, cuda):
    module, call, inputs = _grad_case(name, cuda)
    inputs[0] = inputs[0].clone().requires_grad_(True)
    before = module.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        call(*inputs)
    assert module.LAUNCHES == before                # refused before launch
    with torch.no_grad():
        out = call(*inputs)
    torch.cuda.synchronize()
    assert module.LAUNCHES == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


SCAN_CASES = [  # B, S, I, N
    (2, 128, 128, 16), (1, 100, 256, 8), (2, 64, 128, 16), (1, 37, 128, 4),
    (1, 256, 16384, 16),    # the jamba-1.5-large prefill chunk
    (4, 1, 16384, 16),      # the jamba-1.5-large decode tick
    (3, 9, 50, 16),         # ragged: one chunk of 8 steps and one step;
    (2, 13, 37, 8),         # channels not a multiple of the block's
    (1, 20, 70, 6),         # N not a multiple of 4
]


def _scan_inputs(case, device, seed):
    """The reference sweep's distributions: dA in (0, 1), dBu * 0.3, C,
    h0 * 0.1, all fp32 (the kernel's type)."""
    B, S, I, N = case
    g = np.random.default_rng(seed)
    dA = 1 / (1 + np.exp(-g.standard_normal((B, S, I, N), np.float32)))
    dBu = g.standard_normal((B, S, I, N), np.float32) * 0.3
    C = g.standard_normal((B, S, N), np.float32)
    h0 = g.standard_normal((B, I, N), np.float32) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (dA, dBu, C, h0)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "B%dS%dI%dN%d" % c)
def test_selective_scan_kernel_matches_the_plain_version(case, cuda):
    dA, dBu, C, h0 = _scan_inputs(case, cuda, seed=21)
    before = scan_ops.LAUNCHES
    y, h = scan_ops.selective_scan(dA, dBu, C, h0)
    torch.cuda.synchronize()
    assert scan_ops.LAUNCHES == before + 1
    B, S, I, N = case
    assert y.shape == (B, S, I) and h.shape == (B, I, N)
    y_ref, h_ref = selective_scan_ref(dA, dBu, C, h0)
    for got, want in ((y, y_ref), (h, h_ref)):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())


def test_selective_scan_writes_h_in_place(cuda):
    dA, dBu, C, h0 = _scan_inputs((2, 19, 64, 16), cuda, seed=22)
    y, h = scan_ops.selective_scan(dA, dBu, C, h0)
    state = h0.clone()
    y2, h2 = scan_ops.selective_scan(dA, dBu, C, state, h_out=state)
    assert h2 is state
    assert torch.equal(h2, h) and torch.equal(y2, y)


def test_selective_scan_row_bits_do_not_depend_on_the_batch(cuda):
    dA, dBu, C, h0 = _scan_inputs((4, 21, 96, 16), cuda, seed=23)
    y, h = scan_ops.selective_scan(dA, dBu, C, h0)
    one = scan_ops.selective_scan(dA[2:3].contiguous(), dBu[2:3].contiguous(),
                                  C[2:3].contiguous(), h0[2:3].contiguous())
    assert torch.equal(one[0], y[2:3]) and torch.equal(one[1], h[2:3])
    # row 2's channels 40..79 alone (another I, another block split)
    part = scan_ops.selective_scan(
        dA[2:3, :, 40:80].contiguous(), dBu[2:3, :, 40:80].contiguous(),
        C[2:3].contiguous(), h0[2:3, 40:80].contiguous())
    assert torch.equal(part[0], y[2:3, :, 40:80])
    assert torch.equal(part[1], h[2:3, 40:80])
    # row 2 again, the other rows holding other data
    o = _scan_inputs((4, 21, 96, 16), cuda, seed=24)
    mixed = [torch.cat([b[:2], a[2:3], b[3:]]) for a, b in
             zip((dA, dBu, C, h0), o)]
    y3, h3 = scan_ops.selective_scan(*mixed)
    assert torch.equal(y3[2], y[2]) and torch.equal(h3[2], h[2])


@pytest.mark.parametrize("bad", ["bf16", "strided", "n65", "c_shape",
                                 "h0_on_cpu", "overlap"])
def test_selective_scan_dispatcher_raises_on_what_the_kernel_does_not_take(
        bad, cuda):
    dA, dBu, C, h0 = _scan_inputs((2, 8, 16, 8), cuda, seed=25)
    h_out, err = None, ValueError
    if bad == "bf16":
        dA, err = dA.to(torch.bfloat16), TypeError
    elif bad == "strided":
        dBu = dBu.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "n65":
        dA, dBu, C, h0 = _scan_inputs((2, 8, 16, 65), cuda, seed=25)
    elif bad == "c_shape":
        C = C[:, :, :4].contiguous()
    elif bad == "h0_on_cpu":
        h0 = h0.cpu()
    else:                                  # h_out overlaps h0
        big = torch.zeros(h0.numel() + 8, device=cuda)
        h0, h_out = (big[:h0.numel()].view(h0.shape),
                     big[8:].view(h0.shape))
    before = scan_ops.LAUNCHES
    with pytest.raises(err):
        scan_ops.selective_scan(dA, dBu, C, h0, h_out=h_out)
    assert scan_ops.LAUNCHES == before


def test_jamba_serving_runs_the_scan_flash_and_gmm_kernels(cuda):
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(5, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("jamba-1.5-large-398b", smoke=True,
                                     n_slots=2, t_max=trace_t_max(trace),
                                     device=cuda)
    decodes = []
    step = engine._slot_decode
    engine._slot_decode = lambda *a: decodes.append(1) or step(*a)
    kinds = [(cfg.layer_kind(l), cfg.mlp_kind(l))
             for l in range(cfg.n_layers)]
    n_mamba = sum(k == "mamba" for k, _ in kinds)
    n_attn = sum(k == "attn" for k, _ in kinds)
    n_moe = sum(m == "moe" for _, m in kinds)
    chunks = -(-20 // cfg.ssm_chunk)          # prompt 20, chunks of 16
    flash0, gmm0, scan0 = ops.LAUNCHES, gmm_ops.LAUNCHES, scan_ops.LAUNCHES
    res = engine.run(trace)
    assert res.prefills == len(trace) and decodes
    assert scan_ops.LAUNCHES - scan0 == \
        n_mamba * (chunks * res.prefills + len(decodes))
    assert ops.LAUNCHES - flash0 == n_attn * res.prefills
    assert gmm_ops.LAUNCHES - gmm0 == \
        3 * n_moe * (res.prefills + len(decodes))
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


# ---------------------------------------------------------------------------
# the CXL0 model's tensor twin
# ---------------------------------------------------------------------------

CXL0_SYSTEMS = [((0, 0, 1, 1), (False, True), 2),
                ((0, 0, 1, 1, 2, 2, 3, 3), (False, True, False, True), 4)]


@pytest.mark.parametrize("system", CXL0_SYSTEMS, ids=["2m4l", "4m8l"])
def test_cxl0_twin_on_the_card_equals_the_cpu(cuda, system):
    sys_ = cxl0.TorchSystem(*system)
    acts = cxl0.random_schedules(sys_, torch.Generator().manual_seed(0),
                                 batch=4096, length=64, p_crash=0.03)
    want = cxl0.run_schedules(sys_, acts)
    got = cxl0.run_schedules(sys_, acts.to(cuda))
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    assert int(cxl0.invariant_violations(got[0])) == 0


def test_cxl0_random_schedules_on_a_cuda_generator(cuda):
    sys_ = cxl0.TorchSystem(*CXL0_SYSTEMS[0])
    gen = torch.Generator(device=cuda).manual_seed(1)
    acts = cxl0.random_schedules(sys_, gen, batch=2048, length=64)
    assert acts.device.type == "cuda" and acts.dtype == torch.int32
    assert acts.shape == (2048, 64, 5)
    assert int(acts[..., 1].max()) == 1 and int(acts[..., 2].max()) == 3
    C, M, obs = cxl0.run_schedules(sys_, acts)
    assert obs.device.type == "cuda" and int(cxl0.invariant_violations(C)) == 0
