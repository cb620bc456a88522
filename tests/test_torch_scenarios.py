"""Training kill scenarios of the port (``repro_torch.scenarios``) — the
twins of ``tests/test_scenarios.py``, on the CPU (``--device cpu``).

A real worker process (``scenarios.worker``, the toy state) is killed with
``os._exit`` at each commit-window point, restarted, and must recover the
newest completed commit with a final state bit-identical to an
uninterrupted run:

* each kill point: the killed worker exits 17 and printed its kill line,
  the restart resumes at the newest completed commit from the pool, the
  final digest equals the uninterrupted run's;
* the mid-flush kill leaves no manifest for the dying commit;
* the blocking ``sync`` schedule under the same harness;
* the workers report their flash launches (none: the toy step has no
  attention, and on the CPU no kernel launches anyway), ``recover_s`` and
  the bytes recovered, and read the cuBLAS workspace setting before any
  device call;
* across packages: a toy-train pool the reference's worker was killed on
  at mid_flush is resumed by the port's worker, and the other way round:
  the same resume step as the killer's own restart, the recovered commit
  the same bytes in both packages, the final params within 1e-6 relative
  (fp32 arithmetic of two frameworks).
"""
import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.dsm.pool import DSMPool

from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.scenarios.runner import reference_run, run_scenario
from repro_torch.scenarios.worker import KILL_EXIT

STEPS = 8
COMMIT_EVERY = 2
SHARDS = 4
KW = dict(steps=STEPS, commit_every=COMMIT_EVERY, shards=SHARDS,
          device="cpu")
#: the toy state's bytes: params, mu, nu (6 x 64 x 64 fp32 each), the
#: int32 step and the (2,) uint32 key data
TOY_STATE_BYTES = 3 * 6 * 64 * 64 * 4 + 4 + 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


#: the JAX package's worker processes: one compute thread each
JAX_ENV = dict(JAX_PLATFORMS="cpu", XLA_FLAGS=(
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_children():
    """The worker processes run several at a time: one compute thread
    each (the port's workers inherit this environment)."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One uninterrupted run shared by every kill point."""
    return reference_run(str(tmp_path_factory.mktemp("ref")), **KW)


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory, reference):
    """The three kill points, run side by side (each is its own pool)."""
    digest = reference["result"]["digest"]
    with cf.ThreadPoolExecutor(len(KILL_POINTS)) as ex:
        futs = {p: ex.submit(run_scenario, p,
                             str(tmp_path_factory.mktemp(p)),
                             ref_digest=digest, **KW)
                for p in KILL_POINTS}
        return {p: f.result() for p, f in futs.items()}


@pytest.mark.parametrize("point", KILL_POINTS)
def test_kill_point_recovers_completed_commit(point, scenarios):
    res = scenarios[point]
    assert res.killed, res.detail
    kill, restart = res.children
    assert kill["rc"] == KILL_EXIT and kill["result"]["killed"]
    assert kill["result"]["point"] == point
    assert kill["result"]["step"] == 2 * COMMIT_EVERY - 1
    # recovery landed on a COMPLETED commit, in fact the newest one
    assert res.recovered_completed_commit, res
    assert res.resumed_from == max(res.completed_steps_at_kill), res
    assert res.recovery_source == "pool"
    # crash + recover + replay is bit-identical to the uninterrupted run
    assert res.final_digest == res.reference_digest, res
    assert res.ok
    assert restart["rc"] == 0
    out = restart["result"]
    assert out["completed_losses"] == STEPS - 1 - res.resumed_from
    assert out["recovered_bytes"] == TOY_STATE_BYTES
    assert out["launches"] == {"flash_attention": 0,
                               "flash_attention_bwd": 0}
    assert 0 < out["recover_s"] < restart["wall_s"] + 1
    assert out["cublas_workspace"] == ":4096:8"


def test_mid_flush_kill_leaves_torn_write_invisible(scenarios):
    """The mid-flush kill leaves >= 1 shard of the dying commit durable but
    no manifest; that step must NOT appear in the completed set."""
    res = scenarios["mid_flush"]
    assert res.killed, res.detail
    assert 2 * COMMIT_EVERY - 1 not in res.completed_steps_at_kill
    assert res.ok


def test_reference_run_reports_its_fields(reference):
    out = reference["result"]
    assert (out["resumed_from"], out["completed_losses"],
            out["final_manifest_step"], out["recovered_bytes"]) == \
        (None, STEPS, STEPS - 1, 0)
    assert out["device"] == "cpu"


def test_sync_schedule_scenario(tmp_path, reference):
    """The kill harness also covers the blocking schedules (pre-flush kill
    -> the in-flight commit is simply not durable)."""
    res = run_scenario("pre_flush", str(tmp_path), mode="sync",
                       ref_digest=reference["result"]["digest"],
                       **{**KW, "shards": 1})
    assert res.killed, res.detail
    assert res.recovered_completed_commit, res
    assert res.resumed_from == max(res.completed_steps_at_kill), res
    assert res.final_digest == res.reference_digest, res


def test_unknown_kill_point_raises(tmp_path):
    with pytest.raises(ValueError):
        run_scenario("mid_air", str(tmp_path), **KW)


# ---------------------------------------------------------------------------
# toy-train pools across packages
# ---------------------------------------------------------------------------

REF_WORKER = "repro.scenarios.worker"
PORT_WORKER = "repro_torch.scenarios.worker"
#: final params of the two packages' restarts: fp32 elementwise updates
#: computed by XLA and by PyTorch (the batch mean sums in another order)
PARAMS_REL_TOL = 1e-6


def _worker(module: str, pool: str, kill_point: str) -> dict:
    args = [sys.executable, "-m", module, "--pool", pool, "--steps",
            str(STEPS), "--commit-every", str(COMMIT_EVERY), "--shards",
            str(SHARDS), "--kill-point", kill_point]
    if module == PORT_WORKER:
        args += ["--device", "cpu"]
    p = subprocess.run(args, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=SRC, **JAX_ENV))
    return {"rc": p.returncode, "stderr": p.stderr,
            "result": (json.loads(p.stdout.strip().splitlines()[-1])
                       if p.stdout.strip() else None)}


def _cross(workdir: str, killer: str) -> dict:
    """``killer``'s worker dies at mid_flush; the pool is copied and each
    package's worker restarts on its own copy."""
    pool = os.path.join(workdir, "killed")
    kill = _worker(killer, pool, "mid_flush")
    assert kill["rc"] == KILL_EXIT, kill["stderr"][-2000:]
    copies = {m: os.path.join(workdir, m.split(".")[0]) for m in
              (REF_WORKER, PORT_WORKER)}
    for dst in copies.values():
        shutil.copytree(pool, dst)
    with cf.ThreadPoolExecutor(2) as ex:
        restarts = {m: ex.submit(_worker, m, dst, "none")
                    for m, dst in copies.items()}
        restarts = {m: f.result() for m, f in restarts.items()}
    for r in restarts.values():
        assert r["rc"] == 0, r["stderr"][-2000:]
    return {"pool": pool, "copies": copies, "restarts": restarts}


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {k: ex.submit(_cross, str(tmp_path_factory.mktemp(k)), k)
                for k in (REF_WORKER, PORT_WORKER)}
        return {k: f.result() for k, f in futs.items()}


def _read_state(pool_dir: str, step: int, pkg: str) -> dict:
    """The toy state committed at ``step``, read by one package's pool, as
    {leaf path: bytes}."""
    from repro.dsm.pool import DSMPool as RefPool
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.scenarios.worker import make_toy_state
    from repro_torch.utils.convert import raw_numpy
    pool = (DSMPool if pkg == "port" else RefPool)(pool_dir)
    m = next(m for m in pool.manifests_desc() if m["step"] == step)
    st = make_toy_state()
    templates = {"params": st.params, "opt_mu": st.opt.mu,
                 "opt_nu": st.opt.nu, "counters": [0, 0],
                 "pipeline": [0, 0]}
    out = {}
    for name, tpl in templates.items():
        if pkg == "ref":
            tpl = [0] * len(tpl) if isinstance(tpl, list) else \
                {k: 0 for k in tpl}
        got = pool.read_entry(name, m["objects"][name], tpl)
        leaves = got.values() if isinstance(got, dict) else got
        for i, leaf in enumerate(leaves):
            a = raw_numpy(leaf)[0] if pkg == "port" else np.asarray(leaf)
            out[f"{name}/{i}"] = (str(a.dtype), a.shape, a.tobytes())
    return out


@pytest.mark.parametrize("killer", [REF_WORKER, PORT_WORKER])
def test_toy_pool_resumed_by_the_other_package(killer, crossed):
    """A pool one package's worker was killed on (mid_flush) is resumed by
    the other package's worker: the same resume step, the same recovered
    bytes, and final params within ``PARAMS_REL_TOL`` of the killer's own
    restart."""
    run = crossed[killer]
    ref_r = run["restarts"][REF_WORKER]["result"]
    port_r = run["restarts"][PORT_WORKER]["result"]
    step = ref_r["resumed_from"]
    assert step == port_r["resumed_from"] == 1
    assert ref_r["recoveries"] == port_r["recoveries"] == ["pool"]
    completed = sorted(m["step"] for m in
                       DSMPool(run["pool"]).manifests_desc())
    assert step == max(completed)
    # the recovered commit, read by each package, is the same bytes
    assert _read_state(run["pool"], step, "port") == \
        _read_state(run["pool"], step, "ref")
    # both restarts finished the run; params agree within the tolerance
    ours = _read_state(run["copies"][PORT_WORKER], STEPS - 1, "port")
    theirs = _read_state(run["copies"][REF_WORKER], STEPS - 1, "port")
    for key in (k for k in ours if k.startswith("params/")):
        a = np.frombuffer(ours[key][2], np.float32)
        b = np.frombuffer(theirs[key][2], np.float32)
        assert np.max(np.abs(a - b)) <= PARAMS_REL_TOL * np.max(np.abs(b))
    assert ours["pipeline/1"] == theirs["pipeline/1"]


def test_workers_refuse_the_card_when_there_is_none(tmp_path):
    """``--device cuda`` (the default) on a host without a card raises
    before any work; nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the raise path is for hosts "
                    "without one")
    from repro_torch.scenarios import serve_worker, worker
    # the workers set the process's determinism before anything else:
    # give this test process its own settings back afterwards
    saved = (torch.are_deterministic_algorithms_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for main in (worker.main, serve_worker.main):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["--pool", str(tmp_path / main.__module__)])
    finally:
        torch.use_deterministic_algorithms(saved[0])
        if saved[1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[1]
        torch.backends.cuda.matmul.allow_tf32 = saved[2]
        torch.backends.cudnn.allow_tf32 = saved[3]
    assert not any(os.scandir(tmp_path))
