"""DSM-runtime benchmark: durable-commit throughput of the training loop —
the twin of ``benchmarks/bench_checkpoint.py``.

    python -m repro_torch.bench.checkpoint [--device cpu] [--out DIR]

A real (small) training run — olmo-1b's smoke config, weights from a
``torch.Generator`` seeded 0, global batch 4 x 64 tokens, 12 steps with a
commit every 2 — through ``run_durable_loop``:

* ``ckpt_bytes_per_commit`` — the bytes of the newest manifest's objects
  (params, both moments, counters, pipeline), held exactly by the
  baseline;
* ``ckpt_commit_blocking_s.<mode>.<shards>`` / ``ckpt_wall_s...`` — the
  four schedules, the sharded ones swept over 1 / 2 / 4 / 8 shards,
  ``ckpt_sharded_async_speedup.<n>`` and whether sharded-async at 4
  shards blocks no longer than sync: measured, not asserted (this host's
  I/O);
* ``ckpt_recoveries`` — a run replicating into a peer context (worker 1)
  crashes before the commit of step 5; the peer's staged copy (step 5) is
  newer than the pool's (step 3), so the one recovery's source is
  ``peer-staging``.

Not produced yet: ``ckpt_write_object_*`` (the legacy ``.npz`` writer it
compares against, ROADMAP A5) and ``ckpt_mesh_*`` (device-local mesh
commits, ROADMAP A7).  The reference warms its ``jit`` with one extra
run; eager PyTorch has nothing to warm.
"""
from __future__ import annotations

import shutil
import tempfile
import time

from repro_torch.bench.report import Report, arg_parser

N_STEPS = 12
COMMIT_EVERY = 2
SHARD_SWEEP = (1, 2, 4, 8)
NOT_PRODUCED = {
    "ckpt_write_object_*": "the legacy np.savez writer it compares "
                           "against is not ported (ROADMAP A5)",
    "ckpt_mesh_*": "device-local mesh commits are not ported (ROADMAP A7)",
}


def run(mode: str, tmp: str, device: str, *, n_shards=1, replicate=False,
        crash=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.api import open_cxl0
    from repro_torch.dsm.pool import DSMPool
    from repro_torch.models.registry import build
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    cfg = get_smoke_config("olmo-1b")
    bundle = build(cfg, device=device)
    state = init_train_state(bundle.init_params(seed=0), 0)
    step = make_train_step(bundle)
    pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size), 4, 64)
    pool = DSMPool(f"{tmp}/pool_{mode}_{n_shards}_{replicate}")
    # a CXL0Context is itself a valid RStore peer (it exposes .staging)
    peer = open_cxl0(f"{tmp}/peer_{mode}_{n_shards}", 1)
    t0 = time.perf_counter()
    r = run_durable_loop(step, state, pipe, pool, n_steps=N_STEPS,
                         commit_every=COMMIT_EVERY, commit_mode=mode,
                         n_shards=n_shards,
                         peer_tiers=peer if replicate else None,
                         replicate=replicate, crash_at=crash)
    wall = time.perf_counter() - t0
    peer.close()
    return r, wall, pool


def blocking_commit_s(r) -> float:
    return sum(t.commit_s for t in r.timings)


def bench(device: str) -> Report:
    from repro_torch.utils.device import resolve_device
    resolve_device(device)
    report = Report("checkpoint")
    report.set_config(n_steps=N_STEPS, commit_every=COMMIT_EVERY,
                      shard_sweep=list(SHARD_SWEEP), device=device)
    tmp = tempfile.mkdtemp(prefix="bench_ckpt_")
    try:
        r_sync, t_sync, pool_s = run("sync", tmp, device)
        commit_sync = blocking_commit_s(r_sync)
        latest = pool_s.latest_manifest()
        nbytes = sum(o["nbytes"] for o in latest["objects"].values())
        report.record("ckpt_bytes_per_commit", nbytes,
                      f"{nbytes / 1e6:.1f} MB")
        report.record("ckpt_commit_blocking_s.sync.1", commit_sync,
                      "mode=sync shards=1", fmt=".3f")
        report.record("ckpt_wall_s.sync.1", t_sync, "mode=sync shards=1",
                      fmt=".3f")
        r_async, t_async, _ = run("async", tmp, device)
        report.record("ckpt_commit_blocking_s.async.1",
                      blocking_commit_s(r_async), "mode=async shards=1",
                      fmt=".3f")
        report.record("ckpt_wall_s.async.1", t_async, "mode=async shards=1",
                      fmt=".3f")
        results = {}
        for mode in ("sharded", "sharded-async"):
            for n in SHARD_SWEEP:
                r, wall, _ = run(mode, tmp, device, n_shards=n)
                results[(mode, n)] = blocking_commit_s(r)
                report.record(f"ckpt_commit_blocking_s.{mode}.{n}",
                              results[(mode, n)], f"mode={mode} shards={n}",
                              fmt=".3f")
                report.record(f"ckpt_wall_s.{mode}.{n}", wall,
                              f"mode={mode} shards={n}", fmt=".3f")
        for n in SHARD_SWEEP:
            report.record(
                f"ckpt_sharded_async_speedup.{n}",
                commit_sync / max(results[("sharded-async", n)], 1e-9),
                f"sync/sharded-async blocking time at {n} shards",
                fmt=".2f")
        report.record("ckpt_sharded_async_beats_sync_at_4_shards",
                      bool(results[("sharded-async", 4)] <= commit_sync),
                      f"{results[('sharded-async', 4)]:.3f}s vs "
                      f"{commit_sync:.3f}s")
        r2, _, _ = run("sync", tmp + "/rec2", device, replicate=True,
                       crash={5: "before_commit"})
        report.record("ckpt_recoveries", len(r2.recoveries),
                      f"source={','.join(r2.recoveries)}")
        for metrics, why in NOT_PRODUCED.items():
            print(f"# {metrics}: not produced: {why}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    report = bench(args.device)
    report.write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
