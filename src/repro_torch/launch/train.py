"""Training launcher: the durable FliT-commit training loop on one device —
the port of ``repro.launch.train`` (no mesh, one process).

    python -m repro_torch.launch.train --arch olmo-1b --steps 100 \\
        --global-batch 8 --seq 512 --pool "$TMPDIR/pool" \\
        [--commit-every 10] [--mode sharded-async] [--shards 8] \\
        [--retention 5] [--resume] [--compress int8]

    # the CPU dev loop (plain PyTorch versions of the kernels)
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 \\
        --global-batch 2 --seq 64 --pool "$TMPDIR/pool" --commit-every 2

``--device cuda`` (the default) runs on the card, where every attention
forward and backward is the hand-written flash kernel, every expert
product the grouped matmul's forward, dx and dw kernels, every WKV the
WKV-6 forward and backward kernels and every selective scan the scan's
forward and backward kernels, and raises without one.  The flash
backward takes head dims 32, 64 and 128 (and MLA's 192 / 128), so on the
card every published config trains at its widths, and the smoke configs
(head dim 16) raise ``ValueError``; on the CPU everything runs the plain
versions.  olmoe-1b-7b's full depth does not fit one 80 GB card: its
6.9e9 params make a 69.2 GB state (bf16 params, fp32 mu and nu) that the
out-of-place update holds twice, so ``--arch olmoe-1b-7b`` runs out of
device memory here (``chip_smoke.py`` phase 17 trains it cut to 1 of its
16 layers; a sharded state is ROADMAP A7b's).  rwkv6-7b trains on the card
likewise, and its full 32 layers do not fit either: 7,575,044,096 params
make a 75.8 GB state, held twice by the update (phase 18 trains it cut
to 2 layers).  jamba-1.5-large-398b trains on the card through the
scan's kernels (each 256-token chunk under a checkpoint: the scan's
forward twice a chunk, its backward once), but its 72 layers (398e9
params, 797 GB in bf16) fit no card: one layer (a mamba mixer and a dense
MLP, 2,098,020,352 params, a 12.6 GB state with its bf16 moments) is what
one card trains durably (phase 19; a second layer adds a 16-expert MoE,
12.18e9 params, whose state the update cannot hold twice), and the
launcher offers no depth cut (a sharded state is ROADMAP A7b's).  Weights
are random,
from a ``torch.Generator`` seeded 0; the key data committed with them is
the reference's ``PRNGKey(0)``.  ``--compress int8`` sends every
gradient through the int8 round trip (``parallel.compression``, no error
feedback) through the step's ``grad_transform`` hook, as the reference's
launcher wires it.  ``--mesh-data``, ``--mesh-model`` and
``--distributed`` shard the reference's compute, not its commit, and are
not offered yet (ROADMAP A7b).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.serve import set_determinism


def main(argv=None):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.dsm.emu import PRESETS
    from repro_torch.dsm.flit_runtime import AUTO_MODE, COMMIT_MODES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU dev loop)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--pool", required=True, help="DSM pool directory")
    ap.add_argument("--commit-every", type=int, default=10)
    ap.add_argument("--mode", default="sharded-async",
                    choices=COMMIT_MODES + (AUTO_MODE,),
                    help="flush schedule; 'auto' defers to the placement "
                         "policy (requires --topology)")
    ap.add_argument("--topology", default=None, choices=sorted(PRESETS),
                    help="emulated CXL topology: cost-driven commit shard "
                         "count (and schedule, with --mode auto)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard pipelines per object (0 = auto)")
    ap.add_argument("--retention", type=int, default=5,
                    help="manifests kept by GC after each commit "
                         "(0 = unbounded)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from the pool before training "
                         "(restart of a crashed or preempted worker)")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mode == AUTO_MODE and args.topology is None:
        ap.error("--mode auto requires --topology")

    set_determinism()
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.api import CXL0Config
    from repro_torch.models.registry import build
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    bundle = build(cfg, device=args.device)
    state = init_train_state(bundle.init_params(seed=0), 0,
                             cfg.moment_dtype)
    grad_transform = None
    if args.compress == "int8":
        from repro_torch.parallel.compression import make_int8_transform
        transform, _ = make_int8_transform(with_error_feedback=False)
        grad_transform = lambda g, ctx: transform(g, None)[0]
    step = make_train_step(bundle, microbatch=args.microbatch,
                           total_steps=args.steps,
                           grad_transform=grad_transform)
    pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size),
                        args.global_batch, args.seq)
    ctx = CXL0Config(path=args.pool, schedule=args.mode,
                     topology=args.topology, n_shards=args.shards or None,
                     retention=args.retention or None).open()
    pool = ctx.pool
    r = run_durable_loop(step, state, pipe, ctx, n_steps=args.steps,
                         commit_every=args.commit_every, resume=args.resume)
    if r.resumed_from is not None:
        print(f"resumed from step {r.resumed_from} "
              f"(source: {r.recoveries[0]})")
    if not r.losses:        # resume found every step already committed
        print(f"done: nothing to do; commits in pool up to step "
              f"{pool.latest_manifest()['step']}")
        return r
    print(f"done: {len(r.losses)} steps, loss {r.losses[0]:.3f} -> "
          f"{r.losses[-1]:.3f}; commits in pool: "
          f"{pool.latest_manifest()['step'] + 1}")
    comp = np.mean([t.compute_s for t in r.timings if t.compute_s])
    print(f"mean step {comp*1e3:.1f} ms")
    return r


if __name__ == "__main__":
    main()
