"""The killable scenario worker: one training process over a DSM pool — the
port of ``repro.scenarios.worker``.

Runs the durable training loop and, when ``--kill-point`` is set, dies with
``os._exit(KILL_EXIT)`` the first time the committer's fault hook fires at
that point on or after ``--kill-step``: a real process death inside the
commit window, with background shard writes cut off wherever they are and,
on the card, the model's state in HBM.

On restart (the same command, ``--kill-point none``) the loop runs with
``resume=True``: it recovers from the pool and continues; the JSON result
on stdout reports the recovered step and source and a CRC digest of the
final params, so the runner can compare against an uninterrupted run.

    python -m repro_torch.scenarios.worker --device cpu --pool "$TMPDIR/p" \\
        --kill-point mid_flush --kill-step 3
    python -m repro_torch.scenarios.worker --pool "$TMPDIR/p" \\
        --model full --layers 4 --steps 4 --commit-every 2   # on the card

Models: ``toy`` (default), a small multi-tensor state drawn from a
``torch.Generator`` with the reference's elementwise update in fp32;
``smoke``, olmo-1b's smoke config through the real train step; ``full``,
olmo-1b at its published width (``--layers N`` cuts the depth, 0 keeps it)
with batches of 8 x 512 tokens, the shape ``launch.train`` and
``chip_smoke.py`` train at.  ``--device cuda`` (the default) runs on the
card and raises without one.  Beside the reference's fields the result
reports the flash kernels' launches (``launches``), the seconds from the
process's start to the end of its first step (``recover_s``: start-up,
imports, model build, recovery into the device and one step) and the
bytes it recovered (``recovered_bytes``), and the steps it computed
(``steps_run``).  A killed worker prints one JSON line with its kill
point, step, launches and steps computed before it exits.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

#: exit code of an injected kill (distinguishes it from real failures)
KILL_EXIT = 17

#: the olmo-1b training batch of ``--model full`` (global batch, sequence)
FULL_BATCH = (8, 512)


def make_toy_state(dim: int = 64, n_tensors: int = 6, seed: int = 0,
                   device="cpu"):
    """A small multi-tensor TrainState: enough leaves that the sharded
    write path really partitions work across pipelines.  Drawn on the
    host from a ``torch.Generator`` (the same values on every device),
    then moved to ``device``."""
    import torch
    from repro_torch.train.state import init_train_state
    g = torch.Generator().manual_seed(seed)
    params = {f"w{t}": torch.randn((dim, dim), generator=g,
                                   dtype=torch.float32).to(device)
              for t in range(n_tensors)}
    return init_train_state(params, seed)


def make_toy_step():
    """The reference's deterministic pseudo-training step in fp32 (no
    model): a pure function of (state, batch), so crash + recover + replay
    is bit-identical to an uninterrupted run."""
    import torch
    from repro_torch.train.state import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_map

    def step(state, batch):
        x = batch["tokens"].to(torch.float32).mean() / 1000.0
        grads = tree_map(lambda p: 0.01 * p + x, state.params)
        params = tree_map(lambda p, g: p - 0.1 * g, state.params, grads)
        opt = state.opt._replace(
            step=state.opt.step + 1,
            mu=tree_map(lambda m, g: 0.9 * m + 0.1 * g, state.opt.mu, grads),
            nu=tree_map(lambda v, g: 0.95 * v + 0.05 * g * g,
                        state.opt.nu, grads))
        loss = sum(torch.mean(torch.square(l)) for l in tree_leaves(params))
        return TrainState(params, opt, state.rng), {"loss": loss}

    return step


def make_smoke_model(device="cpu"):
    """olmo-1b's smoke config through the real train step."""
    return make_model("smoke", device=device)


def make_model(kind: str, *, device="cuda", layers: int = 0):
    """(step, state, vocab) of olmo-1b: ``smoke`` config or ``full`` width
    (``layers`` > 0 cuts the depth), weights from a ``torch.Generator``
    seeded 0 on ``device``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.registry import build
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    cfg = (get_smoke_config("olmo-1b") if kind == "smoke"
           else get_config("olmo-1b"))
    if layers:
        cfg = cfg.with_(n_layers=layers)
    bundle = build(cfg, device=device)
    state = init_train_state(bundle.init_params(seed=0), 0,
                             cfg.moment_dtype)
    return make_train_step(bundle), state, cfg.vocab_size


def state_digest(state) -> int:
    """CRC32 over the final params as fp32 — the cross-process check."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    crc = 0
    for l in tree_leaves(state.params):
        a = l.detach().to(torch.float32).cpu().contiguous().numpy()
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def flash_launches() -> dict:
    """The flash kernels' launch counters of this process."""
    from repro_torch.kernels.attention import ops
    return {"flash_attention": ops.LAUNCHES,
            "flash_attention_bwd": ops.BWD_LAUNCHES}


def kill_now(point: str, step, what: str = "step", **fields):
    """The injected death: one JSON line (the point, the step, the
    launches so far and ``fields``), then ``os._exit`` — no cleanup, no
    flush joins."""
    sys.stderr.write(f"KILL {point} {what}={step}\n")
    sys.stderr.flush()
    print(json.dumps({"killed": True, "point": point, what: step,
                      "launches": flash_launches(), **fields}), flush=True)
    os._exit(KILL_EXIT)


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat`` field 22
    against ``/proc/uptime``; clock-tick resolution), so start-up and
    imports count."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> int:
    from repro_torch.dsm.flit_runtime import COMMIT_MODES, KILL_POINTS
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--commit-every", type=int, default=2)
    ap.add_argument("--mode", default="sharded-async", choices=COMMIT_MODES)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--retention", type=int, default=0,
                    help="manifests kept by GC (0 = unbounded)")
    ap.add_argument("--kill-point", default="none",
                    choices=("none",) + KILL_POINTS)
    ap.add_argument("--kill-step", type=int, default=3,
                    help="fire at the first hook of --kill-point whose "
                         "commit step is >= this")
    ap.add_argument("--model", default="toy",
                    choices=["toy", "smoke", "full"])
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=0,
                    help="--model full: layers kept (0 = the config's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default="",
                    help="not ported (device-local mesh commits)")
    ap.add_argument("--topology", default="",
                    help="emulated CXL topology preset: builds a "
                         "PlacementPolicy so shard counts are priced")
    ap.add_argument("--decision-log", default="",
                    help="write the placement policy's priced decisions "
                         "as JSONL to this path")
    ap.add_argument("--result", default="", help="also write the result "
                                                 "JSON to this path")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (reference: repro.dsm.meshio and "
            "repro.launch.mesh, ROADMAP A7)")

    # deterministic algorithms and the cuBLAS workspace before the first
    # CUDA call: the restart must compute what the killed run computed
    from repro_torch.launch.serve import set_determinism
    set_determinism()
    import torch
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.dsm.api import CXL0Config
    from repro_torch.dsm.emu import tree_nbytes
    from repro_torch.train.loop import run_durable_loop
    from repro_torch.utils.device import resolve_device
    device = resolve_device(args.device)

    steps_run = []                   # one entry per step computed here
    hook = None
    if args.kill_point != "none":
        def hook(point, step):
            if point == args.kill_point and step >= args.kill_step:
                kill_now(point, step, steps_run=len(steps_run))

    batch, seq = 4, 32
    if args.model == "toy":
        step_fn, state, vocab = (make_toy_step(),
                                 make_toy_state(args.dim, device=device),
                                 1024)
    else:
        step_fn, state, vocab = make_model(args.model, device=device,
                                           layers=args.layers)
        if args.model == "full":
            batch, seq = FULL_BATCH

    recover_s = []

    def timed_step(st, b):
        out = step_fn(st, b)
        if not steps_run:
            if device.type == "cuda":
                torch.cuda.synchronize()
            recover_s.append(process_age_s())
        steps_run.append(1)
        return out

    pipe = DataPipeline(SyntheticLMSource(vocab), batch, seq)
    ctx = CXL0Config(path=args.pool, schedule=args.mode,
                     n_shards=args.shards or None,
                     retention=args.retention or None,
                     topology=args.topology or None,
                     fault_hook=hook).open()
    r = run_durable_loop(timed_step, state, pipe, ctx, n_steps=args.steps,
                         commit_every=args.commit_every, resume=True)

    if args.decision_log and ctx.placement is not None:
        import dataclasses
        with open(args.decision_log, "w") as f:
            for d in ctx.placement.decisions:
                f.write(json.dumps(dataclasses.asdict(d)) + "\n")

    recovered = 0
    if r.resumed_from is not None:
        recovered = tree_nbytes(r.state)
    result = {
        "ok": True,
        "completed_losses": len(r.losses),
        "resumed_from": r.resumed_from,
        "recoveries": r.recoveries,
        "digest": state_digest(r.state),
        "final_manifest_step": ctx.pool.latest_manifest()["step"],
        "pipeline_step": r.pipeline_state.step,
        "mesh": None,
        "n_devices": torch.cuda.device_count() if device.type == "cuda"
        else 1,
        "d2h_gather_bytes": ctx.tiers.d2h_gather_bytes,
        "d2h_shard_bytes": ctx.tiers.d2h_shard_bytes,
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "launches": flash_launches(),
        "recover_s": recover_s[0] if recover_s else None,
        "steps_run": len(steps_run),
        "recovered_bytes": recovered,
        "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
    }
    line = json.dumps(result)
    if args.result:
        with open(args.result, "w") as f:
            f.write(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
