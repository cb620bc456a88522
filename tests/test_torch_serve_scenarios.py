"""Serving kill scenarios of the port (``repro_torch.scenarios``) — the
twins of ``tests/test_serve_scenarios.py``, on the CPU (``--device cpu``).

A real serving process (``scenarios.serve_worker``, olmo-1b's smoke
config, 10 requests, 4 slots, a ``sync`` session commit every 3 ticks) is
killed with ``os._exit`` inside the session-commit window at each kill
point, restarted, and must resume from the newest completed session
commit and finish with every session's tokens bit-identical to an
uninterrupted run:

* each kill point, and the prompt-replay restore mode;
* the scenario's fields — the completed commits at the kill, the resumed
  tick and sessions, the sessions already done, the restart's commits,
  prefills and decode ticks — equal the reference's serve worker's for
  the same trace and kill point (the weights differ by seed, so tokens
  are compared within each package);
* one fleet migration cell: two engines, the fleet killed right after the
  handoff commit (``mig_commit``), the target's staging wiped; the restart
  finishes with one engine's tokens.
"""
import concurrent.futures as cf
import json
import os
import subprocess
import sys

import pytest

from repro.dsm.pool import DSMPool as RefPool
from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.scenarios.runner import (run_fleet_scenario,
                                          run_serve_scenario,
                                          serve_reference_run)
from repro_torch.scenarios.worker import KILL_EXIT

REQUESTS = 10
SLOTS = 4
COMMIT_EVERY = 3
KILL_STEP = 6
KW = dict(requests=REQUESTS, slots=SLOTS, commit_every=COMMIT_EVERY,
          device="cpu")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
FIELDS = ("resumed_from", "resumed_sessions", "recovered_done", "commits",
          "prefills", "decode_ticks", "emitted_tokens")


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


def _ref_worker(pool: str, kill_point: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC, **JAX_ENV)
    return subprocess.run(
        [sys.executable, "-m", "repro.scenarios.serve_worker", "--pool",
         pool, "--requests", str(REQUESTS), "--slots", str(SLOTS),
         "--commit-every", str(COMMIT_EVERY), "--kill-point", kill_point,
         "--kill-step", str(KILL_STEP)],
        env=env, capture_output=True, text=True, timeout=600)


def _ref_scenario(workdir: str, kill_point: str) -> dict:
    """The reference's serve worker killed at ``kill_point`` and restarted:
    the durable ticks at the kill and the restart's JSON."""
    pool = os.path.join(workdir, f"ref_{kill_point}")
    p1 = _ref_worker(pool, kill_point)
    assert p1.returncode == KILL_EXIT, p1.stderr[-2000:]
    completed = sorted(m["step"] for m in RefPool(pool).manifests_desc())
    p2 = _ref_worker(pool, "none")
    assert p2.returncode == 0, p2.stderr[-2000:]
    return {"completed": completed,
            "result": json.loads(p2.stdout.strip().splitlines()[-1])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process of this file's scenarios, four at a time: the port's
    reference run, three kill points, the replay restore and the fleet
    cell, and the reference package's three kill points."""
    d = lambda name: str(tmp_path_factory.mktemp(name))
    with cf.ThreadPoolExecutor(4) as ex:
        ref = ex.submit(serve_reference_run, d("serve_ref"), **KW)
        ref_pkg = {p: ex.submit(_ref_scenario, d(f"jax_{p}"), p)
                   for p in KILL_POINTS}
        fleet = ex.submit(run_fleet_scenario, "mig_commit", d("fleet"),
                          wipe_staging=True, device="cpu")
        outputs = ref.result()["result"]["outputs"]
        ours = {p: ex.submit(run_serve_scenario, p, d(p),
                             kill_step=KILL_STEP, ref_outputs=outputs, **KW)
                for p in KILL_POINTS}
        replay = ex.submit(run_serve_scenario, "post_completeOp",
                           d("replay"), restore_mode="replay",
                           kill_step=KILL_STEP, ref_outputs=outputs, **KW)
        return {"reference": ref.result(),
                "ours": {p: f.result() for p, f in ours.items()},
                "replay": replay.result(), "fleet": fleet.result(),
                "ref_pkg": {p: f.result() for p, f in ref_pkg.items()}}


@pytest.mark.parametrize("point", KILL_POINTS)
def test_serve_kill_point_replays_bit_identical(point, runs):
    res = runs["ours"][point]
    assert res.killed, res.detail
    kill, restart = res.children
    assert kill["rc"] == KILL_EXIT and kill["result"]["point"] == point
    assert kill["result"]["tick"] >= KILL_STEP
    # recovery landed on a COMPLETED session commit, the newest one
    assert res.recovered_completed_commit, res
    assert res.resumed_from == max(res.completed_ticks_at_kill), res
    # the whole point: kill + restart emits the SAME tokens per session
    assert res.outputs_match, res
    assert res.ok
    out = restart["result"]
    assert out["recovered_bytes"] > 0 and out["recover_s"] > 0
    assert out["launches"] == {"flash_attention": 0,
                               "flash_attention_bwd": 0}    # the CPU
    assert out["cublas_workspace"] == ":4096:8"


@pytest.mark.parametrize("point", KILL_POINTS)
def test_serve_scenario_fields_equal_the_references(point, runs):
    res = runs["ours"][point]
    ref = runs["ref_pkg"][point]
    assert res.completed_ticks_at_kill == ref["completed"]
    ours = res.children[1]["result"]
    assert {k: ours[k] for k in FIELDS} == \
        {k: ref["result"][k] for k in FIELDS}
    assert sorted(ours["outputs"]) == sorted(ref["result"]["outputs"])
    assert [len(v) for _, v in sorted(ours["outputs"].items())] == \
        [len(v) for _, v in sorted(ref["result"]["outputs"].items())]


def test_serve_replay_restore_mode(runs):
    """The prompt-replay restore path (no cache restore) reproduces the
    same outputs — the deterministic-recompute fallback."""
    res = runs["replay"]
    assert res.killed and res.ok, res


def test_fleet_migration_kill_with_staging_wiped(runs):
    """Two engines over one pool, killed right after the handoff commit,
    the target's host buffer gone: the restarted fleet adopts from the
    pool and finishes with one engine's tokens."""
    res = runs["fleet"]
    assert res.killed, res.detail
    assert res.children[0]["rc"] == KILL_EXIT
    assert res.children[0]["result"]["point"] == "mig_commit"
    assert res.outputs_match and res.ok, res
    assert res.staging == "wiped"


def test_reference_run_is_uninterrupted(runs):
    out = runs["reference"]["result"]
    assert out["resumed_from"] is None and out["recovered_done"] == 0
    assert len(out["outputs"]) == REQUESTS
    assert out["prefills"] == REQUESTS
