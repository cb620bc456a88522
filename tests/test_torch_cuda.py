"""The port on the card: the hand-written Hopper kernels and the paths that
run them.  Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card, where there is no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

* the flash-attention kernel against its plain version at small ragged,
  GQA, ``hd_v != hd`` and non-causal shapes and at MLA's widths (hd 192
  in the 256-wide instantiation, hd_v 128; small, and deepseek-v2's
  prefill (1, 128 over 128, 512)) (bf16; max abs error 2e-2 = bf16
  output rounding, one ulp near 1 is 7.8e-3), one launch counted per
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
  row sits (C 70 / 8, and the capacities C 80 / 32), at deepseek-v2's
  four shapes (160 experts, D 5120, F 1536, C 24 and 32), launched from
  a thread that has made no CUDA call yet (with the main thread's
  bits), the dispatcher's refusals, and olmoe-1b-7b and deepseek-v2
  smoke serving runs that launch it 3 times per MoE block per forward
  (prefills and decode ticks alike) while the flash kernel runs once per
  layer per prefill (deepseek-v2: MLA's expanded prefill);
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
* the flash backward kernel against the fp32 plain backward at ragged,
  GQA (G 2 and G 4 at 512), non-causal, Sq > Sk and Sq < Sk causal, S 300
  and hd 64 at 512 shapes (2e-2 x max|plain|), the forward's
  logsumexp (1e-4), two launches with the same bits, the dispatcher's
  refusal of head dims the backward does not take, and both flash kernels
  launched from a thread that has made no CUDA call yet (the tensor maps
  need the tensors' context current there) with the main thread's bits;
* the flash dispatcher, given inputs that require grad under grad mode,
  runs the forward kernel (with its logsumexp) and the backward kernel,
  and the gradients match the plain backward; each of the other three
  dispatchers raises before it launches (their kernels have no backward
  yet), and launches the same call under ``torch.no_grad()``;
* the flash kernel at the static baseline's batched prefill shape (4, 16,
  512, 128) causal against its plain version (2e-2), and ``run_static``
  of the olmo-1b smoke config launching it once per layer per batch;
* the async and sharded flush pipelines: every leaf a pool write receives
  is a host tensor (no CUDA tensor reaches a flush thread), the D2H is
  counted once per leaf, and a CUDA leaf written in place right after an
  async ``commit()`` is recovered with the value it had at launch;
* a 2-engine olmo-1b smoke fleet on the card with one live migration
  forced from engine 1 to engine 2: every stream equal to one engine's
  on the card, 0 tokens lost, the flash kernel once per layer per
  prefill, the migrated blocks staged as frames in engine 2's buffer and
  their bytes counted as D2H; an RStore of a CUDA tree into a spill-file
  buffer counts its bytes once, and the emulator prices it from metadata;
* whisper-small's smoke config (bf16, hd 64) on the card against the
  same weights on the CPU: the full forward's logits within 0.05 abs, the
  loss and the gradients' norm within 2e-2 relative, the flash forward
  once per attention (twice under remat) and its backward once; prefill
  and 8 greedy decode steps held to a full forward on the card (0.05 abs,
  the same argmax), the kernel launched by the prefill only; and both
  flash kernels at its cross-attention's non-causal hd 64, Sq < Sk;
* the CXL0 model's tensor twin (``core.semantics_torch``, plain PyTorch:
  no kernel of its own) gives on the card the bits it gives on the CPU
  for 4,096 schedules on two systems, and ``random_schedules`` with a
  CUDA generator draws CUDA actions;
* a CUDA KV lane (olmo-1b smoke) through the tiers: a peer ``spill`` by
  ``spill_auto`` (one counted D2H copy of the lane) and a sharded
  ``spill_durable``, each read back as host tensors and written into a
  lane on the card bit-identically; ``remesh`` places recovered host
  state on the rank's slice of the card (every rank shares ``cuda:0``
  on one card).
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
    (1, 4, 4, 70, 70, 192, 128, True),      # MLA's widths: hd 192 in the
                                            # 256 bucket, hd_v 128, G = 1
    (2, 12, 12, 100, 300, 64, 64, False),   # whisper's cross-attention:
                                            # hd 64, ragged Sq < Sk
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


BWD_CASES = [
    # B, H, K, Sq, Sk, hd, causal
    (1, 2, 2, 37, 37, 64, True),            # ragged, one partial tile
    (2, 4, 2, 130, 130, 128, True),         # GQA, three tiles
    (1, 2, 1, 77, 200, 64, False),          # non-causal, Sq != Sk
    (1, 2, 2, 200, 77, 128, True),          # causal, Sq > Sk
    (1, 8, 2, 512, 512, 128, True),         # G 4: the GQA sum over every ring stage
    (1, 4, 4, 300, 300, 128, True),         # S not a multiple of 64 or 128
    (1, 8, 8, 512, 512, 64, True),          # hd 64 at 512
    (1, 4, 2, 100, 300, 128, True),         # causal, Sq < Sk: kv tiles past
                                            # the last q row write zeros
    (2, 12, 12, 100, 300, 64, False),       # whisper's cross-attention:
                                            # every q tile for each kv tile
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[
    f"B{c[0]}H{c[1]}K{c[2]}S{c[3]}x{c[4]}hd{c[5]}{'c' if c[6] else 'f'}"
    for c in BWD_CASES])
def test_flash_backward_matches_plain_version_bit_for_bit_twice(case, cuda):
    """dq, dk, dv of the backward kernel against the fp32 plain backward on
    the same bf16 inputs (2e-2 x max|plain|), the forward's logsumexp
    within 1e-4, and two backward launches with the same bits."""
    B, H, K, Sq, Sk, hd, causal = case
    q, k, v = _inputs((B, H, K, Sq, Sk, hd, hd, causal), cuda, 41)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=causal)
        out.backward(dout)
        runs.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = ops._forward(q, k, v, causal=causal, scale=hd ** -0.5,
                            with_lse=True)
    _, ref_lse = ops.plain_attention_lse(q, k, v, causal=causal)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    want = ops.plain_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    for got, ref in zip(runs[0], want):
        assert bool(torch.isfinite(got).all())
        assert float((got.float() - ref).abs().max()) <= \
            2e-2 * float(ref.abs().max())
    if causal and Sq < Sk:          # no q row sees kv rows Sq..Sk-1
        for got in runs[0][1:]:
            assert bool((got[:, Sq:] == 0).all())


def test_flash_kernels_launch_from_a_fresh_thread(cuda):
    """The forward and the backward encode their tensor maps with
    cuTensorMapEncodeTiled, which needs the tensors' context current on the
    calling thread; autograd runs the backward (and, under remat, the
    forward) on a worker thread that may have made no CUDA call yet.  Both
    launch from a fresh thread, into buffers made beforehand, with the main
    thread's bits."""
    import threading

    from repro_torch.kernels.attention import kernel
    B, H, K, S, hd = 1, 4, 2, 130, 128
    q, k, v = _inputs((B, H, K, S, S, hd, hd, True), cuda, 43)
    dout = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    scale = hd ** -0.5

    def run():
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        torch.cuda.synchronize()
        return out, lse, grads

    main = run()
    kernel.flash_attention_fwd(q, k, v, main[0], causal=True, scale=scale,
                               lse=main[1])
    kernel.flash_attention_bwd(q, k, v, main[0], main[1], dout, *main[2],
                               causal=True, scale=scale)
    fresh = run()
    errors = []

    def launch():
        try:
            kernel.flash_attention_fwd(q, k, v, fresh[0], causal=True,
                                       scale=scale, lse=fresh[1])
            kernel.flash_attention_bwd(q, k, v, fresh[0], fresh[1], dout,
                                       *fresh[2], causal=True, scale=scale)
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(e)

    worker = threading.Thread(target=launch)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert errors == []
    assert torch.equal(fresh[0], main[0]) and torch.equal(fresh[1], main[1])
    assert all(torch.equal(a, b) for a, b in zip(fresh[2], main[2]))


def test_kernel_at_the_mla_prefill_shape_matches_plain_version(cuda):
    """deepseek-v2's prefill: 128 heads over 128 (G = 1), 512 tokens, q / k
    of width 192 (nope 128 + rope 64, run in the 256-wide instantiation:
    TMA's zero fill covers columns 192-255) and v of width 128."""
    q, k, v = _inputs((1, 128, 128, 512, 512, 192, 128, True), cuda, 44)
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert out.shape == (1, 512, 128, 1, 128)
    ref = ops.plain_attention(q.float(), k.float(), v.float(), causal=True)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) <= 2e-2
    assert torch.equal(ops.flash_attention(q, k, v, causal=True), out)


def test_flash_backward_refuses_head_dims_it_does_not_take(cuda):
    q, k, v = _inputs((1, 2, 2, 16, 16, 32, 32, True), cuda, 42)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd = ops.LAUNCHES
    with pytest.raises(ValueError, match="hd == hd_v"):
        ops.flash_attention(*leaves, causal=True)
    assert ops.LAUNCHES == fwd                      # refused before launch


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


def test_kernel_at_the_static_batch_shape_matches_plain_version(cuda):
    case = (4, 16, 16, 512, 512, 128, 128, True)
    q, k, v = _inputs(case, cuda, seed=6)
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    ref = ops.plain_attention(q.float(), k.float(), v.float(), causal=True)
    assert float((out.float() - ref).abs().max()) <= 2e-2


def test_static_baseline_runs_the_kernel_once_per_layer_per_batch(cuda):
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(6, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("olmo-1b", smoke=True, n_slots=4,
                                     t_max=trace_t_max(trace), device=cuda)
    before = ops.LAUNCHES
    res = engine.run_static(trace)
    assert res.prefills == 2
    assert ops.LAUNCHES - before == cfg.n_layers * res.prefills
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


@pytest.mark.parametrize("mode", ["async", "sharded", "sharded-async"])
def test_flush_threads_get_host_snapshots_taken_at_launch(mode, cuda,
                                                          tmp_path,
                                                          monkeypatch):
    import threading
    from repro_torch.dsm.api import open_cxl0
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.utils.tree import tree_leaves
    seen = []
    orig = DSMPool.start_write

    # every write, threaded or sharded, streams through start_write
    # (write_object calls it too)
    def spy(self, name, version, tree, *a, **kw):
        seen.append((threading.current_thread() is threading.main_thread(),
                     [l.device.type for l in tree_leaves(tree)]))
        return orig(self, name, version, tree, *a, **kw)
    monkeypatch.setattr(DSMPool, "start_write", spy)
    ctx = open_cxl0(str(tmp_path), schedule=mode, n_shards=2)
    x = [torch.arange(8, dtype=torch.float32, device=cuda),
         torch.ones(4, 3, device=cuda)]
    ctx.put({"x": x})
    with ctx.commit(0):
        pass
    x[0].add_(100.0)                   # the caller writes on at once
    x[1].zero_()
    ctx.drain()
    assert ctx.tiers.d2h_gather_bytes == 32 + 48
    assert seen and all(devs == ["cpu"] * len(devs) for _, devs in seen)
    assert not any(on_main for on_main, _ in seen)
    objs, step, _ = ctx.recover({"x": [0, 0]})
    assert step == 0
    assert torch.equal(objs["x"][0], torch.arange(8, dtype=torch.float32))
    assert torch.equal(objs["x"][1], torch.ones(4, 3))
    ctx.close()


def test_fleet_migrates_on_the_card_without_token_loss(cuda, tmp_path):
    import os
    from repro_torch.serve.engine import ServeEngine, build_serve_engine
    from repro_torch.serve.fleet import FleetController
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(6, prompt_lens=(20,), new_tokens=(4, 8, 12),
                            seed=5)
    t_max = trace_t_max(trace)
    single, cfg = build_serve_engine("olmo-1b", smoke=True, n_slots=2,
                                     t_max=t_max, device=cuda)
    want = single.run(trace).outputs
    fl = FleetController("olmo-1b", pool_path=str(tmp_path / "pool"),
                         n_engines=2, n_slots=2, t_max=t_max,
                         commit_every=2, bundle=single.bundle,
                         params=single.params, device=cuda)
    assert all(isinstance(e, ServeEngine) and e.device.type == "cuda"
               for e in fl.engines.values())
    before = ops.LAUNCHES
    fl.submit(trace)
    moved = None
    while not fl.done:
        fl.tick(rebalance=False)
        if moved is None and fl.engines[1]._tick >= 3:
            src = fl.engines[1]
            moved = next((r for r in src.sched.admission_order
                          if r in src.sched.running), None)
            if moved is not None:
                fl.migrate(moved, 1, 2)
    d2h = {i: e.store.tiers.d2h_gather_bytes for i, e in fl.engines.items()}
    res = fl.finish()
    fl.close()
    assert moved is not None and res.migrations == 1
    assert res.outputs == want
    assert res.emitted_tokens == sum(len(v) for v in want.values())
    prefills = sum(r.prefills for r in res.per_engine.values())
    assert ops.LAUNCHES - before == cfg.n_layers * prefills
    staged = os.listdir(tmp_path / "pool" / "staging" / "w2")
    assert any(f.startswith(f"e1__kv__{moved}__") and f.endswith(".cxl0")
               for f in staged)
    assert d2h[1] > 0 and d2h[2] > 0


def test_rstore_of_a_cuda_tree_counts_its_d2h_once(cuda, tmp_path):
    from repro_torch.dsm.cluster import FileStagingArea
    from repro_torch.dsm.emu import TopologyEmulator, attach_emulator
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.dsm.tiers import TierManager
    emu = TopologyEmulator("cxl20-switched-pool")
    tiers = attach_emulator(TierManager(DSMPool(str(tmp_path / "p"))), emu)
    area = FileStagingArea(str(tmp_path / "staging"))
    tree = [torch.arange(256, dtype=torch.float32, device=cuda),
            torch.ones(8, 16, dtype=torch.bfloat16, device=cuda)]
    tiers.lstore("kv/r0/b0", tree)
    assert tiers.d2h_gather_bytes == 0
    tiers.rstore("kv/r0/b0", area.proxy(1), tag=3)
    assert tiers.d2h_gather_bytes == 1024 + 256
    assert [(p.op, p.nbytes) for p in emu.trace] == \
        [("lstore", 1280), ("rstore", 1280)]
    got = area.view(1, {"kv/r0/b0": [0, 0]}).staging["kv/r0/b0"][1]
    assert torch.equal(got[0], tree[0].cpu())
    assert torch.equal(got[1], tree[1].cpu())


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


#: deepseek-v2's four expert products: up / gate and down at the prefill
#: capacity (512 tokens x top-6 x 1.25 / 160 experts -> 24) and at the
#: per-sequence decode's (4 slots x 8)
DEEPSEEK_GMM_CASES = [(160, 24, 5120, 1536), (160, 24, 1536, 5120),
                      (160, 32, 5120, 1536), (160, 32, 1536, 5120)]


@pytest.mark.parametrize("case", DEEPSEEK_GMM_CASES,
                         ids=lambda c: "E%dC%dD%dF%d" % c)
def test_grouped_matmul_at_the_deepseek_shapes_matches_plain_version(
        case, cuda):
    gen = torch.Generator(cuda).manual_seed(9)
    E, C, D, F = case
    x = torch.randn((E, C, D), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((E, D, F), generator=gen, device=cuda).mul_(0.02).to(
        torch.bfloat16)
    out = gmm_ops.grouped_matmul(x, w)
    ref = grouped_matmul_ref(x.float(), w.float())
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) <= \
        1e-2 * float(ref.abs().max())


def test_grouped_matmul_launches_from_a_fresh_thread(cuda):
    """The grouped matmul encodes its tensor maps with
    cuTensorMapEncodeTiled, which needs the tensors' context current on the
    calling thread.  It launches from a fresh thread whose buffers all come
    from PyTorch's cache (made beforehand), with the main thread's bits."""
    import threading

    from repro_torch.kernels.moe_gmm import kernel
    x, w = _gmm_inputs((3, 40, 264, 200), cuda, seed=10)
    main = torch.empty((3, 40, 200), dtype=torch.bfloat16, device=cuda)
    fresh = torch.empty_like(main)
    kernel.grouped_matmul_fwd(x, w, main)
    torch.cuda.synchronize()
    errors = []

    def launch():
        try:
            kernel.grouped_matmul_fwd(x, w, fresh)
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(e)

    worker = threading.Thread(target=launch)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert errors == []
    assert torch.equal(fresh, main)


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


def test_deepseek_serving_runs_both_kernels(cuda):
    """deepseek-v2's smoke config on the card: MLA's expanded prefill
    through the flash kernel once per layer per prefill, its absorbed
    decode in plain torch, and the grouped matmul 3 times per MoE layer
    (one: the first layer is dense) per forward, the shared expert beside
    it as plain matmuls."""
    from repro_torch.serve.engine import build_serve_engine
    from repro_torch.serve.trace import synthetic_trace, trace_t_max
    trace = synthetic_trace(5, prompt_lens=(20,), new_tokens=(2, 5))
    engine, cfg = build_serve_engine("deepseek-v2-236b", smoke=True,
                                     n_slots=2, t_max=trace_t_max(trace),
                                     device=cuda)
    decodes = []
    step = engine._slot_decode
    engine._slot_decode = lambda *a: decodes.append(1) or step(*a)
    flash0, gmm0 = ops.LAUNCHES, gmm_ops.LAUNCHES
    res = engine.run(trace)
    n_moe = sum(cfg.mlp_kind(l) == "moe" for l in range(cfg.n_layers))
    assert res.prefills == len(trace) and decodes and n_moe == 1
    assert ops.LAUNCHES - flash0 == cfg.n_layers * res.prefills
    assert gmm_ops.LAUNCHES - gmm0 == \
        3 * n_moe * (res.prefills + len(decodes))
    assert all(len(res.outputs[r.rid]) == r.max_new_tokens for r in trace)


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
    if name == "flash_attention":
        # the flash kernel has its backward: a gradient goes through both
        # kernels and matches the plain backward (2e-2 x max|plain|: bf16
        # P / dS operands and outputs)
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        dout = torch.randn(inputs[0].shape, device=cuda).to(torch.bfloat16)
        fwd, bwd = ops.LAUNCHES, ops.BWD_LAUNCHES
        out = call(*leaves, causal=True)
        out.backward(dout)
        torch.cuda.synchronize()
        assert (ops.LAUNCHES, ops.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
        _, lse = ops.plain_attention_lse(*inputs, causal=True)
        want = ops.plain_attention_bwd(*inputs, out.detach(), lse, dout,
                                       causal=True)
        for got, ref in zip(leaves, want):
            assert bool(torch.isfinite(got.grad).all())
            assert float((got.grad.float() - ref).abs().max()) <= \
                2e-2 * float(ref.abs().max())
        return
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
# whisper-small (encoder-decoder) through the flash kernels
# ---------------------------------------------------------------------------

def _whisper_models(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.utils.tree import tree_map
    cfg = get_smoke_config("whisper-small")
    b_cpu = build(cfg, device="cpu")
    p_cpu = b_cpu.init_params(seed=0)
    return cfg, b_cpu, p_cpu, build(cfg, device=cuda), tree_map(
        lambda t: t.to(cuda), p_cpu)


def _whisper_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                          np.int64)),
            torch.from_numpy(rng.standard_normal(
                (B, cfg.encdec.enc_seq, cfg.d_model), np.float32)))


def _whisper_logits(cfg, p, toks, frames):
    from repro_torch.models import common, encdec
    x, _ = encdec.decode_tokens(cfg, p, toks,
                                encdec.encode(cfg, p, frames))
    return common.unembed(cfg, p["embed"], x).float()


def test_whisper_smoke_on_the_card_matches_the_cpu(cuda):
    """whisper-small's smoke config (bf16, hd 64) on the card against the
    same weights on the CPU: the full forward's logits within 0.05 abs
    (the reference's bf16 prefill / decode tolerance) with the flash
    kernel once per attention (encoder self, decoder self, cross); the
    loss and the gradients' global norm within 2e-2 relative, with each
    attention's forward launched twice under remat and its backward once."""
    from repro_torch.utils.tree import tree_flatten
    cfg, b_cpu, p_cpu, b, p = _whisper_models(cuda)
    n_attn = cfg.encdec.n_enc_layers + 2 * cfg.n_layers
    toks, frames = _whisper_inputs(cfg, 2, 40, seed=5)
    with torch.no_grad():
        want = _whisper_logits(cfg, p_cpu, toks, frames)
        before = ops.LAUNCHES
        got = _whisper_logits(cfg, p, toks.to(cuda), frames.to(cuda))
        torch.cuda.synchronize()
    assert ops.LAUNCHES - before == n_attn
    assert float((got.cpu() - want).abs().max()) < 0.05

    def loss_and_norm(bundle, params, device):
        leaves, td = tree_flatten(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = bundle.loss(td.unflatten(live),
                              {"tokens": toks.to(device),
                               "enc_embeds": frames.to(device)})
        grads = torch.autograd.grad(loss, live)
        return float(loss.detach()), float(torch.sqrt(sum(
            torch.sum(g.float() ** 2) for g in grads)))

    want = loss_and_norm(b_cpu, p_cpu, "cpu")
    fwd, bwd = ops.LAUNCHES, ops.BWD_LAUNCHES
    got = loss_and_norm(b, p, cuda)
    assert (ops.LAUNCHES - fwd, ops.BWD_LAUNCHES - bwd) == \
        (2 * n_attn, n_attn)
    for g, w in zip(got, want):
        assert abs(g - w) <= 2e-2 * abs(w), (got, want)


def test_whisper_smoke_decode_on_the_card_holds_to_its_full_forward(cuda):
    """Prefill (the flash kernel once per attention) and 8 greedy decode
    steps (plain attention over the self and cross caches, no launch) on
    the card: each step's logits within 0.05 of a full forward over the
    same tokens on the card, with the same argmax."""
    cfg, _, _, b, p = _whisper_models(cuda)
    n_attn = cfg.encdec.n_enc_layers + 2 * cfg.n_layers
    toks, frames = _whisper_inputs(cfg, 2, 16, seed=6)
    toks, frames = toks.to(cuda), frames.to(cuda)
    steps, seq = [], [toks]
    with torch.no_grad():
        before = ops.LAUNCHES
        logits, st = b.prefill(p, {"tokens": toks, "enc_embeds": frames},
                               b.init_caches(2, 24))
        steps.append(logits)
        for _ in range(8):
            nxt = torch.argmax(logits, -1)[:, None]
            seq.append(nxt)
            logits, st = b.decode(p, nxt, st)
            steps.append(logits)
        torch.cuda.synchronize()
        assert ops.LAUNCHES - before == n_attn and int(st.pos) == 24
        full = _whisper_logits(cfg, p, torch.cat(seq, 1), frames)
    for j, lg in enumerate(steps):
        ref = full[:, 15 + j]
        assert float((lg.float() - ref).abs().max()) < 0.05
        assert torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1))


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


def test_cuda_lane_spills_and_restores_bit_identically(cuda, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.dsm.placement import PlacementPolicy
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.dsm.tiers import TierManager
    from repro_torch.models.registry import build
    from repro_torch.serve.kvcache import TieredKVCache
    from repro_torch.utils.tree import tree_leaves
    bundle = build(get_smoke_config("olmo-1b"), device=cuda)
    params = bundle.init_params(torch.Generator(cuda).manual_seed(0))
    _, st = bundle.prefill(
        params, {"tokens": torch.arange(12, device=cuda)[None] % 64},
        bundle.init_caches(1, 32))
    tiers = TierManager(DSMPool(str(tmp_path / "a")), 0)
    peer = TierManager(DSMPool(str(tmp_path / "peer")), 1)
    kv = TieredKVCache(bundle, 2, 32, tiers=tiers,
                       placement=PlacementPolicy("cxl11-direct"))
    kv.write_slot(1, st.caches)
    lane = kv.read_slot(1)
    want = [l.cpu() for l in tree_leaves(lane)]
    nbytes = sum(l.nbytes for l in want)
    assert all(l.device.type == "cuda" for l in tree_leaves(lane))
    # peer staging: one counted D2H copy of the lane
    assert kv.spill_auto("kv/s", lane, peer=peer)["tier"] == "staging"
    assert tiers.d2h_gather_bytes == nbytes
    # the pool: a sharded flush, restored into a lane on the card
    entry = kv.spill_durable("kv/p", lane, n_blocks=2)
    for tree in (peer.rload("kv/s"),
                 tiers.pool.read_entry("kv/p", entry, kv.template1)):
        assert all(l.device.type == "cpu" for l in tree_leaves(tree))
        kv.write_slot(0, tree)
        got = kv.read_slot(0)
        assert all(l.device.type == "cuda" for l in tree_leaves(got))
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(tree_leaves(got), want))
    tiers.close()
    peer.close()


def test_remesh_places_recovered_state_on_the_card(cuda):
    from repro_torch.launch.mesh import mesh_device_sets, rank_submesh
    from repro_torch.train.elastic import remesh
    live = [0, 1, 2]
    n = torch.cuda.device_count()
    assert mesh_device_sets(live) == {r: max(1, n // 3) for r in live}
    if n == 1:                         # every rank shares the one card
        assert all(rank_submesh(r, live) == [torch.device("cuda", 0)]
                   for r in live)
    host = {"t00": {"p": torch.arange(6.0), "mu": np.zeros(3, np.float32)}}
    placed, dev = remesh(host, None, rank_submesh(0, live)[:1])
    assert dev.type == "cuda"
    assert placed["t00"]["p"].device == dev
    assert torch.equal(placed["t00"]["p"].cpu(), host["t00"]["p"])
    assert placed["t00"]["mu"].device == dev
