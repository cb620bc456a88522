"""End-to-end driver: train a language model durably with the unified CXL0
programming-model API — the port of ``examples/train_durable.py``, on
``repro_torch``: `open_cxl0` + commit regions, nothing else.

The whole durable loop is the paper's model verbatim: every step LStores
the new state into the context (`ctx.put`), every tenth step opens a
*commit region* whose clean exit emits exactly one completeOp, and a
mid-run crash (`ctx.crash()` — the worker's volatile tiers vanish) is
healed by the ONE recovery path `ctx.recover`, which replays from the
newest completed commit.  The final state is verified IDENTICAL to an
uninterrupted run — durable linearizability, end to end.

The model is the reference's ``small_cfg``: olmo-1b's config with 4
layers, d_model 256, 8 heads, d_ff 1024, a vocabulary of 8192, batches of
4 x 256 tokens, 60 steps (``--full``: 8 layers, d_model 768, 12 heads,
d_ff 3072, a vocabulary of 32000, 8 x 512, 300 steps).  Both keep
olmo-1b's head dim of 128, as the reference's do (``with_`` replaces the
fields it is given and recomputes none).  Weights come from a
``torch.Generator`` seeded 0.  ``--device cuda`` (the default) trains on
the card, every attention through the hand-written flash forward and
backward kernels; ``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_durable \\
          [--full] [--replicate] [--steps N] [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline, PipelineState, \
    SyntheticLMSource
from repro_torch.dsm.api import open_cxl0
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map


def small_cfg(full: bool):
    base = get_config("olmo-1b")
    if full:    # ~100M params
        return base.with_(n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
                          d_ff=3072, vocab_size=32000, attn_chunk=256,
                          remat="none")
    return base.with_(n_layers=4, d_model=256, n_heads=8, n_kv_heads=8,
                      d_ff=1024, vocab_size=8192, attn_chunk=128,
                      remat="none")


def state_objects(state, pipe_state):
    """The committed object set: params + optimizer moments + counters +
    data-pipeline position (so replay resumes exactly where the recovered
    step left off — no data loss or dupes)."""
    return {
        "params": state.params,
        "opt_mu": state.opt.mu,
        "opt_nu": state.opt.nu,
        "counters": {"opt_step": state.opt.step, "rng": state.rng},
        "pipeline": {"seed": np.int64(pipe_state.seed),
                     "step": np.int64(pipe_state.step)},
    }


def objects_to_state(objs, template, pipe):
    """Recovered (host) objects back onto the template state's devices."""
    def onto(tree, like):
        return tree_map(lambda r, t: torch.as_tensor(r).to(t.device), tree,
                        like)
    st = template.__class__(
        params=onto(objs["params"], template.params),
        opt=template.opt._replace(
            mu=onto(objs["opt_mu"], template.opt.mu),
            nu=onto(objs["opt_nu"], template.opt.nu),
            step=onto(objs["counters"]["opt_step"], template.opt.step)),
        rng=onto(objs["counters"]["rng"], template.rng))
    pipe.state = PipelineState(seed=int(objs["pipeline"]["seed"]),
                               step=int(objs["pipeline"]["step"]))
    return st


def train(pool_path, step_fn, init_state, pipe, *, n_steps,
          commit_every=10, crash_steps=(), peer=None):
    """The 5-line durable loop (plus crash injection): open a context,
    put + commit-region on a cadence, recover after any crash."""
    ctx = open_cxl0(pool_path, schedule="async", peers=(peer,) if peer
                    else (), replicate_to=peer)
    templates = state_objects(init_state, pipe.state)
    ctx.put(templates, step=-1)
    with ctx.commit(-1):                       # durable floor: step -1
        pass
    ctx.drain()
    device = tree_leaves(init_state.params)[0].device

    state, losses, recoveries = init_state, [], []
    crash_steps = set(crash_steps)
    i = 0
    while i < n_steps:
        if i in crash_steps:
            crash_steps.discard(i)
            ctx.crash()                        # f_i: volatile tiers vanish
            objs, rec_step, source = ctx.recover(templates)
            state = objects_to_state(objs, state, pipe)
            recoveries.append(source)
            i = rec_step + 1
            continue
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.next_global().items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        ctx.put(state_objects(state, pipe.state), step=i)
        if (i + 1) % commit_every == 0:
            with ctx.commit(i):                # ONE completeOp on exit
                pass
        i += 1
    ctx.drain()                                # tail flush (planned GPF)
    ctx.close()
    return state, losses, recoveries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--replicate", action="store_true",
                    help="RStore-stage state into a peer (faster recovery)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import set_determinism
    set_determinism()
    cfg = small_cfg(args.full)
    n_steps = args.steps or (300 if args.full else 60)
    batch, seq = (8, 512) if args.full else (4, 256)

    from repro_torch.models.registry import build
    bundle = build(cfg, device=args.device)
    print(f"model: {bundle.n_params()/1e6:.1f}M params, "
          f"{cfg.n_layers}L d{cfg.d_model}")
    state = init_train_state(bundle.init_params(seed=0), 0)
    step = make_train_step(bundle, peak_lr=3e-4, total_steps=n_steps)
    tmp = tempfile.mkdtemp(prefix="train_durable_")
    try:
        # a peer context IS a valid RStore target / recovery source
        peer = (open_cxl0(f"{tmp}/peer", 1) if args.replicate else None)
        crashes = sorted({max(n_steps // 3, 1), max(2 * n_steps // 3, 2)})
        pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size), batch, seq)
        print(f"training {n_steps} steps, commit every 10, crashes at "
              f"{crashes} …")
        final, losses, recoveries = train(
            f"{tmp}/pool", step, state, pipe, n_steps=n_steps,
            crash_steps=crashes, peer=peer)
        print(f"crashes: {len(recoveries)}  recoveries: {recoveries}")
        print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f}")

        # verify against an uninterrupted run over a fresh pool
        pipe2 = DataPipeline(SyntheticLMSource(cfg.vocab_size), batch, seq)
        clean, clean_losses, _ = train(f"{tmp}/pool2", step, state, pipe2,
                                       n_steps=n_steps)
        same = all(
            torch.equal(a.float(), b.float())
            for a, b in zip(tree_leaves(final.params),
                            tree_leaves(clean.params)))
        print(f"crash-recovered final params identical to clean run: {same}")
        assert same
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"cfg": cfg, "losses": losses, "clean_losses": clean_losses,
            "recoveries": recoveries, "crashes": crashes, "same": same}


if __name__ == "__main__":
    main()
