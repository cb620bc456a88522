"""The port's durable continuous-batching server against the JAX package's,
on the smoke configs (fp32) of all nine decoder-only architectures:
olmo-1b, olmoe-1b-7b, rwkv6-7b, jamba-1.5-large-398b, the dense GQA four
(internlm2-1.8b, phi3-medium-14b, yi-34b, chameleon-34b) and
deepseek-v2-236b (MLA: its pool holds the latent cache).

* same weights (the reference's, carried across), same ``synthetic_trace``
  (the port's copy gives the same requests): the port's ``ServeEngine``
  emits exactly the reference engine's tokens on the fp32 smoke config;
* crash after a tick that is not a commit tick, then resume from the pool
  (committed cache blocks restored, or the prompt replayed): tokens
  bit-identical to the uninterrupted run; with ``retire_done`` the same
  tokens, and finished sessions leave the committed table;
* pools cross over: the reference's ``SessionStore.recover`` reads a pool
  the port committed (same sessions, same block tables, same cache bytes)
  and the port reads the reference's;
* the launcher runs end to end on the CPU and resumes from its pool; each
  fleet flag (``--engines 2``, ``--topology``, ``--commit-mode auto``,
  ``--no-prefix-reuse``) runs on the CPU, and misused flags exit 2.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.dsm.pool import DSMPool as RefPool
from repro.models.registry import build as ref_build
from repro.serve.engine import build_serve_engine as ref_build_engine
from repro.serve.paging import BlockPager as RefPager
from repro.serve.sessions import SessionStore as RefStore
from repro.serve.trace import synthetic_trace as ref_trace
from repro_torch.configs import get_smoke_config
from repro_torch.dsm.pool import DSMPool
from repro_torch.models.params import from_reference
from repro_torch.models.registry import build
from repro_torch.serve.engine import build_serve_engine
from repro_torch.serve.paging import BlockPager
from repro_torch.serve.sessions import SessionStore
from repro_torch.serve.trace import synthetic_trace, trace_t_max
from repro_torch.utils.convert import raw_numpy
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TRACE_KW = dict(prompt_lens=(12,), new_tokens=(3, 6, 9))
N_REQ = 7
COMMIT_EVERY = 3
CRASH_AFTER = 7                    # ticks; 7 % 3 != 0: not a commit tick
ARCHS = ["olmo-1b", "olmoe-1b-7b", "rwkv6-7b", "jamba-1.5-large-398b",
         "internlm2-1.8b", "phi3-medium-14b", "yi-34b", "chameleon-34b",
         "deepseek-v2-236b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = get_smoke_config(arch).with_(**FP32)
    trace = synthetic_trace(N_REQ, vocab_size=cfg.vocab_size, **TRACE_KW)
    t_max = trace_t_max(trace)
    rb = ref_build(ref_smoke_config(arch).with_(**FP32), dec_pos_len=t_max)
    rp = rb.init_params(jax.random.PRNGKey(0))
    b = build(cfg, device="cpu")
    p = from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return dict(arch=arch, trace=trace, t_max=t_max, rb=rb, rp=rp, b=b,
                p=p)


def _port_engine(s, **kw):
    e, _ = build_serve_engine(s["arch"], smoke=True, n_slots=4,
                              t_max=s["t_max"], bundle=s["b"],
                              params=s["p"], device="cpu", **kw)
    return e


def _ref_engine(s, **kw):
    e, _ = ref_build_engine(s["arch"], smoke=True, n_slots=4,
                            t_max=s["t_max"], bundle=s["rb"],
                            params=s["rp"], **kw)
    return e


@pytest.fixture(scope="module")
def reference_outputs(setup):
    return _ref_engine(setup).run(setup["trace"]).outputs


def test_trace_is_the_reference_trace(setup):
    import dataclasses
    assert [dataclasses.astuple(r) for r in setup["trace"]] == \
        [dataclasses.astuple(r)
         for r in ref_trace(N_REQ, vocab_size=setup["b"].cfg.vocab_size,
                            **TRACE_KW)]


def test_engine_emits_the_reference_tokens(setup, reference_outputs):
    res = _port_engine(setup).run(setup["trace"])
    assert res.outputs == reference_outputs
    assert res.prefills == N_REQ
    assert res.emitted_tokens == sum(len(v) for v in
                                     reference_outputs.values())


@pytest.mark.parametrize("restore_mode", ["cache", "replay"])
def test_crash_after_a_non_commit_tick_resumes_bit_identically(
        setup, reference_outputs, tmp_path, restore_mode):
    pool = str(tmp_path / "pool")
    e = _port_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY)
    e.submit(setup["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    assert e._n_commits == CRASH_AFTER // COMMIT_EVERY
    e.store.ctx.crash()                      # dropped without finish()
    del e
    e2 = _port_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY,
                      restore_mode=restore_mode)
    step = e2.resume()
    assert step == CRASH_AFTER - CRASH_AFTER % COMMIT_EVERY
    n_done = len(e2.results)                 # finished by the commit
    res = e2.run(setup["trace"])
    assert res.outputs == reference_outputs
    assert res.resumed_sessions > 0
    if restore_mode == "cache":
        # resumed sessions came back from their committed cache blocks
        assert res.prefills == N_REQ - n_done - res.resumed_sessions
    else:
        # replay re-prefills every unfinished session from its prompt
        assert res.prefills == N_REQ - n_done


def test_retire_done_drops_finished_sessions_from_later_tables(
        setup, reference_outputs, tmp_path):
    pool = str(tmp_path / "pool")
    res = _port_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY,
                       retire_done=True).run(setup["trace"])
    assert res.outputs == reference_outputs
    last = DSMPool(pool).latest_manifest()["meta"]["sessions"]
    # sessions retired at an earlier commit are gone from the last table;
    # the ones it still holds finished after that commit
    assert 0 < len(last) < N_REQ
    again = _port_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY,
                         retire_done=True)
    assert again.resume() is not None
    assert all(s.done for s in again.sessions.values())


def _bits(x):
    return raw_numpy(x)[0].tobytes()


def _assert_recovered_equal(ours, theirs):
    assert ours.step == theirs.step and ours.seq == theirs.seq
    assert {r: s.to_meta() for r, s in ours.sessions.items()} == \
        {r: s.to_meta() for r, s in theirs.sessions.items()}
    assert {r: t.to_meta() for r, t in ours.tables.items()} == \
        {r: t.to_meta() for r, t in theirs.tables.items()}
    assert sorted(ours.caches) == sorted(theirs.caches)
    assert ours.caches                        # some session was running
    for rid in theirs.caches:
        ol = tree_leaves(ours.caches[rid])
        tl = jax.tree_util.tree_leaves(theirs.caches[rid])
        assert [_bits(a) for a in ol] == [_bits(np.asarray(a)) for a in tl]


def _recover_both(setup, pool):
    theirs = RefStore(RefPool(pool), mode="sync").recover(
        setup["rb"].abstract_caches(1, setup["t_max"]),
        pager=RefPager(setup["rb"], setup["t_max"]))
    ours = SessionStore(pool).recover(
        BlockPager(setup["b"], setup["t_max"]))
    return ours, theirs


def test_reference_recovers_the_pool_the_port_committed(setup, tmp_path):
    pool = str(tmp_path / "pool")
    e = _port_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY)
    e.submit(setup["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    ours, theirs = _recover_both(setup, pool)
    _assert_recovered_equal(ours, theirs)


def test_port_recovers_the_pool_the_reference_committed(setup, tmp_path):
    pool = str(tmp_path / "pool")
    e = _ref_engine(setup, pool_path=pool, commit_every=COMMIT_EVERY)
    e.submit(setup["trace"])
    for _ in range(CRASH_AFTER):
        e.tick()
    ours, theirs = _recover_both(setup, pool)
    _assert_recovered_equal(ours, theirs)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_and_resumes_on_cpu(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--arch", arch, "--smoke", "--requests", "5",
           "--prompt-len", "8",
           "--new-tokens", "2,5", "--pool", str(tmp_path / "pool"),
           "--commit-every", "2"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr
    assert "5 requests" in first.stdout and "session commits" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed from committed tick" in again.stdout
    assert "0 prefills" in again.stdout       # every session came back done


def test_launcher_pages_at_the_block_size_it_is_given(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    pool = str(tmp_path / "pool")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--smoke", "--requests", "3", "--prompt-len", "12",
           "--new-tokens", "9", "--pool", pool, "--commit-every", "2",
           "--block-tokens", "8"]
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    ms = DSMPool(pool).manifests_desc()
    assert ms and all(m["meta"]["block_tokens"] == 8 for m in ms)
    # 12 prompt + 8 fed-back tokens span blocks 0-2 at 8 tokens a block
    assert {n.rsplit("/", 1)[1] for m in ms for n in m["objects"]} == \
        {"b0", "b1", "b2"}


#: each case: the flags, then what the launcher must say on its way out
FLEET_FLAGS = {
    "engines": ["--engines", "2"],
    "topology": ["--topology", "cxl30-fabric"],
    "auto": ["--commit-mode", "auto", "--topology", "cxl20-switched-pool"],
    "no-prefix-reuse": ["--engines", "2", "--no-prefix-reuse"],
}


@pytest.mark.parametrize("case", sorted(FLEET_FLAGS))
def test_launcher_runs_each_fleet_flag_on_cpu(tmp_path, case):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    pool = str(tmp_path / "pool")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--smoke", "--requests", "6", "--prompt-len", "16",
           "--new-tokens", "2,5,9", "--pool", pool, "--commit-every", "2",
           "--slots", "2"] + FLEET_FLAGS[case]
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    fleet = "--engines" in cmd
    assert ("fleet[2] on cpu: 6 requests" if fleet else "6 requests") \
        in run.stdout
    metas = [m["meta"] for m in DSMPool(pool).manifests_desc()]
    assert {m["engine"] for m in metas} == ({1, 2} if fleet else {0})
    if case == "auto":
        # the policy priced the first commit's smoke blocks: small, so sync
        assert "session commits (schedule sync)" in run.stdout
    if case == "no-prefix-reuse":
        assert "0 prefix hits" in run.stdout
        assert not os.path.isdir(os.path.join(pool, "objects", "kvblk"))
    if fleet:
        again = subprocess.run(cmd, env=env, capture_output=True,
                               text=True, timeout=300)
        assert again.returncode == 0, again.stderr
        assert "resumed: e1@" in again.stdout and "0 prefills" in again.stdout


@pytest.mark.parametrize("flag", [["--engines", "2"],
                                  ["--commit-mode", "auto"],
                                  ["--engines", "2", "--pool", "unused",
                                   "--mode", "static"],
                                  ["--topology", "cxl20-switched-pool"]])
def test_launcher_refuses_flags_of_unported_features(flag, capsys):
    """Every fleet flag is ported; what the launcher still refuses is a
    flag without what it needs: a fleet or a topology without a pool,
    ``auto`` without a topology, a static fleet."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", "--smoke"] + flag)
    assert ei.value.code == 2
    err = capsys.readouterr().err
    want = {"--engines": "needs --pool", "--commit-mode":
            "requires --topology", "--topology": "needs --pool"}
    assert ("continuous-batching only" if "static" in flag
            else want[flag[0]]) in err


def test_whisper_small_is_refused_as_the_reference_refuses_it(capsys):
    """The reference's one encoder-decoder architecture:
    ``build_serve_engine`` raises the reference's decoder-only ValueError,
    the launcher exits 2 with the same reason, and ``servable_archs`` is
    the reference's minus it."""
    from repro.serve.engine import servable_archs as ref_servable
    from repro_torch.launch.serve import main
    from repro_torch.serve.engine import servable_archs
    with pytest.raises(ValueError) as ours:
        build_serve_engine("whisper-small", device="cpu")
    with pytest.raises(ValueError) as theirs:
        ref_build_engine("whisper-small")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as ei:
        main(["--device", "cpu", "--smoke", "--arch", "whisper-small"])
    assert ei.value.code == 2
    assert str(theirs.value) in capsys.readouterr().err
    assert servable_archs() == ref_servable()
