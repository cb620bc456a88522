"""Cluster-protocol benchmark, the part that needs no rank process — a
partial twin of ``benchmarks/bench_cluster.py`` (its lines 35-100).

    python -m repro_torch.bench.cluster [--out DIR]

* contended multi-writer commits: K committer threads share one pool
  (``DSMPool``); every commit must survive (the ``O_EXCL`` sequence
  reservation turns collisions into rescans, never into overwrites).
  Zero lost or overwritten commits is asserted for 1 and 4 writers;
  ``cluster_commits_total`` counts the manifests of both runs (200) and
  the commit rates are this host's (not gated);
* cross-process staging: an 8 MiB partition staged into a sibling's
  spill buffer (``FileStagingArea``) and read back through a recovery
  view, bit for bit; ``cluster_staged_bytes`` is its size (8,388,608).

Not produced yet: ``cluster_stage_speedup_x`` and
``cluster_view_speedup_x`` compare the streamed spill format with the
legacy ``np.savez`` one, which is not ported (ROADMAP A5b);
``cluster_stream_speedup_ok`` and the step-rate rows spawn
``repro.scenarios.cluster_worker`` rank processes (ROADMAP A5b / A6b).
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
NOT_PRODUCED = {
    "cluster_stage_speedup_x, cluster_view_speedup_x":
        "they compare against the legacy np.savez staging format, which "
        "is not ported (ROADMAP A5b)",
    "cluster_stream_speedup_ok, cluster step rates":
        "they spawn repro.scenarios.cluster_worker rank processes, not "
        "ported (ROADMAP A5b / A6b)",
}


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


def run() -> Report:
    report = Report("cluster")
    report.set_config(writers=WRITERS, per_writer=PER_WRITER,
                      staged_mb=STAGED_MB)
    with tempfile.TemporaryDirectory(prefix="bench-cluster-") as tmp:
        bench_contended_commits(report, tmp)
        bench_staging(report, tmp)
    for metrics, why in NOT_PRODUCED.items():
        print(f"# {metrics}: not produced: {why}", flush=True)
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__).parse_args(argv)
    report = run()
    report.write(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
