"""N-worker cluster launcher: elastic multi-process training over ONE shared
DSM pool — the port of ``repro.launch.cluster``.

Spawns N ``repro_torch.scenarios.cluster_worker`` data-parallel rank
processes against one pool directory: each rank owns a partition of the
model state (``train.elastic.partition_plan``), stages it into its ring
sibling's host buffer every step (cross-process RStore), and commits
through the multi-writer manifest protocol — rank records, one elected
cluster manifest per step.  ``--shrink-at`` demonstrates elastic
scale-down: the victim rank leaves at that step after a planned GPF commit
and the survivors repartition and continue — the protocol the crash
scenarios (``repro_torch.scenarios.runner --suite cluster``) drive with a
real mid-commit process kill instead of a planned exit.

The ranks run the deterministic toy cluster state; ``--device cuda`` (the
default) keeps each rank's tensors on the card (the ranks of a one-card
machine share it) and ``--device cpu`` on the host.

    python -m repro_torch.launch.cluster --device cpu --workers 3 \\
        --steps 20 --pool "$TMPDIR/cluster_pool" [--commit-every 5] \\
        [--shrink-at 10 --victim 1] [--no-replicate]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from repro_torch.dsm.cluster import ControlPlane
from repro_torch.dsm.pool import DSMPool
from repro_torch.scenarios.cluster import finish, spawn_worker
from repro_torch.train.elastic import shrink_plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pool", required=True)
    ap.add_argument("--commit-every", type=int, default=5)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--tensors", type=int, default=6)
    ap.add_argument("--global-batch", type=int, default=6)
    ap.add_argument("--no-replicate", action="store_true",
                    help="disable RStore staging into the ring sibling "
                         "(recovery then only has the pool)")
    ap.add_argument("--retention", type=int, default=5,
                    help="cluster manifests kept by the elected "
                         "committer's post-commit gc (0 = unbounded)")
    ap.add_argument("--topology", default=None,
                    help="emulated CXL topology preset forwarded to every "
                         "rank (cost-driven staging + shard sizing — see "
                         "repro_torch.dsm.emu.PRESETS)")
    ap.add_argument("--shrink-at", type=int, default=0,
                    help="planned elastic scale-down: --victim leaves at "
                         "this step (0 = no shrink)")
    ap.add_argument("--victim", type=int, default=1,
                    help="rank that departs at --shrink-at")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every rank's tensors live")
    args = ap.parse_args(argv)
    if args.workers < 2:
        ap.error("a cluster needs at least 2 workers")

    if args.shrink_at:
        if not 0 < args.shrink_at < args.steps:
            ap.error("--shrink-at must lie inside (0, --steps)")
        if not 0 <= args.victim < args.workers:
            ap.error("--victim must be one of the workers")
        ControlPlane(os.path.join(args.pool, "control")).post(
            args.victim, planned=True, at_step=args.shrink_at)
        plan = shrink_plan(args.workers, args.workers - 1)
        print(f"planned shrink at step {args.shrink_at}: rank "
              f"{args.victim} departs; data-shard responsibilities "
              f"reassign {plan}")

    procs = {r: spawn_worker(args.pool, r, args.workers,
                             steps=args.steps,
                             commit_every=args.commit_every,
                             replicate=not args.no_replicate,
                             dim=args.dim, tensors=args.tensors,
                             global_batch=args.global_batch,
                             retention=args.retention,
                             topology=args.topology,
                             timeout=args.timeout, device=args.device)
             for r in range(args.workers)}
    print(f"launched {args.workers} workers over {args.pool} "
          f"(device {args.device})")

    failed = 0
    for r, p in procs.items():
        try:
            child, err = finish(f"rank {r}", p, args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            print(f"rank {r}: TIMEOUT\n{err[-1000:]}")
            failed += 1
            continue
        res = child["result"]
        if child["rc"] != 0 or res is None:
            print(f"rank {r}: rc={child['rc']}\n{err[-1000:]}")
            failed += 1
            continue
        if "planned_exit_at" in res:
            print(f"rank {r}: departed at step {res['planned_exit_at']} "
                  f"(planned shrink), {child['wall_s']:.2f} s")
        else:
            print(f"rank {r}: done; live={res['live']} gen={res['gen']} "
                  f"owned={sorted(res['digests'])}, {child['wall_s']:.2f} s")
    m = DSMPool(args.pool).latest_manifest()
    if m is not None:
        print(f"pool: newest cluster commit step {m['step']} "
              f"(seq {m['seq']}, live {m['meta'].get('live')})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
