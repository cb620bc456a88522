"""Cluster-protocol benchmark — the twin of ``benchmarks/bench_cluster.py``.

    python -m repro_torch.bench.cluster [--device cpu] [--out DIR]

* contended multi-writer commits: K committer threads share one pool
  (``DSMPool``); every commit must survive (the ``O_EXCL`` sequence
  reservation turns collisions into rescans, never into overwrites).
  Zero lost or overwritten commits is asserted for 1 and 4 writers;
  ``cluster_commits_total`` counts the manifests of both runs (200) and
  the commit rates are this host's (not gated);
* cross-process staging: an 8 MiB partition staged into a sibling's
  spill buffer (``FileStagingArea``) and read back through a recovery
  view, bit for bit; ``cluster_staged_bytes`` is its size (8,388,608);
* the streamed spill format against the legacy ``np.savez`` one
  (``FileStagingArea(legacy_format=True)``) on a paged-KV partition of
  8192 x 1 KiB leaves: ``cluster_stage_speedup_x`` and
  ``cluster_view_speedup_x`` (each >= 10, asserted as ratios of two runs
  on the same host) and ``cluster_stream_speedup_ok``;
* ``cluster_steps_per_s_world{2,3,4}``: 2, 3 and 4 rank processes
  (``scenarios.cluster_worker`` on ``--device``) over one pool, 12
  lockstep steps with a commit every 3, process start-up included (this
  host's, not gated).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.bench.report import Report, arg_parser

WRITERS = 4
PER_WRITER = 40
STAGED_MB = 8
PAGES = 8192                    # the streamed-vs-legacy partition's leaves
PAGE_KIB = 1
#: timed stage rounds a format, the last ``VIEW_REPS`` of them each with a
#: timed view; the fastest of each counts.  The reference times 2 of each;
#: the stage gets more rounds here, as its ratio lies nearer the gate and
#: a stall of the host in few rounds could decide it
STAGE_REPS = 10
VIEW_REPS = 2
STEP_RATE_WORLDS = (2, 3, 4)
STEP_RATE_STEPS = 12
STEP_RATE_COMMIT_EVERY = 3


def bench_contended_commits(report: Report, tmp: str, *,
                            writers: int = WRITERS,
                            per_writer: int = PER_WRITER):
    from repro_torch.dsm.pool import DSMPool
    obj_pool = DSMPool(os.path.join(tmp, "contended"))
    objs = {w: obj_pool.write_object(f"w{w}/x", 1,
                                     {"a": np.zeros(64, np.float32)})
            for w in range(writers)}

    def run_writers(n_writers: int) -> float:
        pool_dir = os.path.join(tmp, f"commit_{n_writers}")
        handles = {w: DSMPool(pool_dir) for w in range(n_writers)}
        for w in range(n_writers):
            handles[w].write_object(f"w{w}/x", 1,
                                    {"a": np.zeros(64, np.float32)})
        t0 = time.perf_counter()

        def work(w):
            for i in range(per_writer):
                handles[w].commit_manifest(i, {f"w{w}/x": objs[w]},
                                           meta={"w": w})

        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ms = DSMPool(pool_dir).manifests_desc()
        total = n_writers * per_writer
        if len(ms) != total or len({m["seq"] for m in ms}) != total:
            raise AssertionError(
                f"{n_writers} writers: {len(ms)} manifests, "
                f"{len({m['seq'] for m in ms})} seqs; expected {total}")
        return total / wall

    solo = run_writers(1)
    contended = run_writers(writers)
    report.record("cluster_commit_rate_1_writer", solo,
                  "commits/s on this host (not gated)", fmt=".0f")
    report.record("cluster_commit_rate_contended", contended,
                  f"commits/s aggregate of {writers} writers; zero "
                  f"lost/overwritten commits asserted", fmt=".0f")
    report.record("cluster_commit_contention_ratio", contended / solo,
                  "aggregate vs solo (O_EXCL rescan overhead)", fmt=".2f")
    report.record("cluster_commits_total", (1 + writers) * per_writer,
                  "manifests across both runs; every one present and "
                  "unique (zero-loss asserted in-bench)")


def bench_staging(report: Report, tmp: str, *, mb: int = STAGED_MB):
    from repro_torch.dsm.cluster import FileStagingArea
    area = FileStagingArea(os.path.join(tmp, "staging"))
    tree = {"p": np.random.default_rng(0).standard_normal(
        (mb * 1024 * 1024 // 4,)).astype(np.float32)}
    t0 = time.perf_counter()
    area.proxy(1).staging["w0/params"] = (3, tree)
    t_stage = time.perf_counter() - t0
    t0 = time.perf_counter()
    view = area.view(1, {"w0/params": tree})
    t_view = time.perf_counter() - t0
    back = view.staging["w0/params"][1]["p"].numpy()
    if back.tobytes() != tree["p"].tobytes():
        raise AssertionError("staged partition read back differently")
    report.record("cluster_rstore_stage_mb_s", mb / t_stage,
                  f"{mb} MiB partition -> sibling spill buffer, this host "
                  f"(not gated)", fmt=".0f")
    report.record("cluster_staging_view_mb_s", mb / t_view,
                  "sibling buffer -> recovery view (read + CRC validate), "
                  "this host (not gated)", fmt=".0f")
    report.record("cluster_staged_bytes", int(tree["p"].nbytes),
                  "bytes per staged copy (deterministic)")


def bench_streamed_vs_legacy(report: Report, tmp: str, *,
                             pages: int = PAGES, page_kib: int = PAGE_KIB):
    """Stage + view throughput of the streamed spill format against the
    legacy ``np.savez`` one on the SAME fine-grained workload (a paged KV
    partition: thousands of ~KiB leaves, where the legacy per-zip-member
    and double-CRC overheads dominate), the fastest of ``STAGE_REPS``
    stages and ``VIEW_REPS`` views each.  Asserted as RATIOS, so the gate does not depend on the host's
    speed."""
    from repro_torch.dsm.cluster import FileStagingArea
    tree = {f"page{i}": np.random.default_rng(i).integers(
                0, 255, (page_kib * 1024,), dtype=np.uint8).astype(np.uint8)
            for i in range(pages)}
    mb = pages * page_kib / 1024

    def run_area(area):
        area.proxy(1).staging["w0/kv"] = (1, tree)      # warm (dirs)
        stage = view = float("inf")
        last = 1 + STAGE_REPS
        for tag in range(2, last + 1):
            t0 = time.perf_counter()
            area.proxy(1).staging["w0/kv"] = (tag, tree)
            stage = min(stage, time.perf_counter() - t0)
            if tag > last - VIEW_REPS:
                t0 = time.perf_counter()
                got = area.view(1, {"w0/kv": tree})
                view = min(view, time.perf_counter() - t0)
        if got.staging["w0/kv"][0] != last:
            raise AssertionError("the view missed the newest staged copy")
        return stage, view

    s_stage, s_view = run_area(FileStagingArea(os.path.join(tmp, "fast")))
    l_stage, l_view = run_area(FileStagingArea(os.path.join(tmp, "slow"),
                                               legacy_format=True))
    stage_x, view_x = l_stage / s_stage, l_view / s_view
    note = f"{pages} x {page_kib} KiB pages ({mb:.0f} MiB)"
    report.record("cluster_stream_stage_mb_s", mb / s_stage,
                  f"streamed spill, {note}, this host", fmt=".0f")
    report.record("cluster_legacy_stage_mb_s", mb / l_stage,
                  f"legacy np.savez spill, {note}, this host", fmt=".0f")
    report.record("cluster_stream_view_mb_s", mb / s_view,
                  "streamed mmap view read + CRC, this host", fmt=".0f")
    report.record("cluster_legacy_view_mb_s", mb / l_view,
                  "legacy np.load view read + CRC, this host", fmt=".0f")
    report.record("cluster_stage_speedup_x", stage_x,
                  "streamed vs legacy stage, same workload", fmt=".1f")
    report.record("cluster_view_speedup_x", view_x,
                  "streamed vs legacy view, same workload", fmt=".1f")
    if stage_x < 10.0 or view_x < 10.0:
        raise AssertionError(
            f"staging fast path regressed: stage {stage_x:.1f}x, view "
            f"{view_x:.1f}x (each must be >= 10x legacy)")
    report.record("cluster_stream_speedup_ok", True,
                  "stage AND view >= 10x legacy (asserted)")


def bench_cluster_step_rate(report: Report, tmp: str, device: str, *,
                            steps: int = STEP_RATE_STEPS,
                            commit_every: int = STEP_RATE_COMMIT_EVERY):
    """N rank processes over one pool, the full lockstep protocol (board
    all-reduce, rank records, elected cluster manifests), per world
    size."""
    from repro_torch.scenarios.cluster import finish, spawn_worker
    for world in STEP_RATE_WORLDS:
        pool = os.path.join(tmp, f"cluster_w{world}")
        t0 = time.perf_counter()
        procs = [spawn_worker(pool, r, world, steps=steps,
                              commit_every=commit_every, replicate=True,
                              device=device)
                 for r in range(world)]
        errs = []
        for r, p in enumerate(procs):
            child, err = finish(f"rank {r}", p, 600)
            if child["rc"] != 0:
                errs.append(f"rank {r} rc={child['rc']}: {err[-500:]}")
        wall = time.perf_counter() - t0
        if errs:
            raise AssertionError(f"cluster bench world {world}: {errs}")
        report.record(f"cluster_steps_per_s_world{world}", steps / wall,
                      f"{steps} lockstep steps, commit every "
                      f"{commit_every} (incl. process start-up), {device}, "
                      f"this host", fmt=".2f")


def run(device: str = "cuda") -> Report:
    from repro_torch.utils.device import resolve_device
    resolve_device(device)
    report = Report("cluster")
    report.set_config(writers=WRITERS, per_writer=PER_WRITER,
                      staged_mb=STAGED_MB, pages=PAGES, page_kib=PAGE_KIB,
                      stage_reps=STAGE_REPS, view_reps=VIEW_REPS,
                      step_rate_steps=STEP_RATE_STEPS,
                      step_rate_commit_every=STEP_RATE_COMMIT_EVERY,
                      device=device)
    with tempfile.TemporaryDirectory(prefix="bench-cluster-") as tmp:
        bench_contended_commits(report, tmp)
        bench_staging(report, tmp)
        bench_streamed_vs_legacy(report, tmp)
        bench_cluster_step_rate(report, tmp, device)
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    report = run(args.device)
    report.write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
