"""The durable training loop: train steps + FliT-protocol commits + crash
recovery, with fault-injection hooks — the port of ``repro.train.loop``.

The loop guarantees, as the reference's does:

* any step whose commit completed survives a crash (durable
  linearizability of the step history — the paper's §6 transformation at
  system scale);
* recovery resumes from the newest recoverable state — a peer's
  RStore-staged copy if fresher than the pool, else the newest CRC-valid
  manifest;
* the data pipeline resumes exactly where the recovered step left off
  (``PipelineState`` is one of the committed objects) — no data loss or
  duplicates.

The committed objects, their leaves, names, dtypes and shapes equal the
reference's (``params``, ``opt_mu``, ``opt_nu``, ``counters`` with the
int32 step and the uint32 key data, ``pipeline`` with two int64 scalars),
so each package resumes the other's pool.

With a mesh (``mesh=``, or the context's ``CXL0Config.mesh``) the state's
leaves are ``parallel.sharding.ShardedTensor``s and every sharded commit
runs device-local: each shard pipeline copies its own leaves' per-place
blocks, and the tree is never gathered (``dsm.meshio``).  The step runs
on the leaves' whole tensors and the loop places its result back onto the
initial state's layout (on one card the blocks are views: nothing is
copied); recovered leaves are put back onto their template's sharding
(``_restore_placement``), so a resumed run commits device-locally again.
Sharded compute (each place computing its own block) is ROADMAP A7b's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import DataPipeline, PipelineState
from repro_torch.dsm.api import CXL0Context, open_cxl0
from repro_torch.dsm.recovery import ColdStartError, CrashError
from repro_torch.parallel.sharding import (ShardedTensor, place, place_like,
                                           unshard)
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class StepTiming:
    """Per-step wall times (compute ends in a host read of the loss, so on
    the card it covers the device work)."""
    step: int
    compute_s: float
    commit_s: float


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    pipeline_state: PipelineState
    losses: List[float]
    timings: List[StepTiming]
    recoveries: List[str]       # recovery sources used ("pool"/"peer-staging")
    crashes: int
    resumed_from: Optional[int] = None    # step recovered at startup
    #                                       (resume=True), None if cold


def _state_objects(state: TrainState, pipe_state: PipelineState):
    return {
        "params": state.params,
        "opt_mu": state.opt.mu,
        "opt_nu": state.opt.nu,
        "counters": {"opt_step": state.opt.step, "rng": state.rng},
        "pipeline": {"seed": np.int64(pipe_state.seed),
                     "step": np.int64(pipe_state.step)},
    }


def _restore_placement(tree, template):
    """Recovered (host) leaves onto the template leaves' layout: a
    ShardedTensor template's sharding, else its device."""
    def one(r, t):
        if isinstance(t, ShardedTensor):
            return place(torch.as_tensor(r), t.sharding)
        return torch.as_tensor(r).to(t.device)
    return tree_map(one, tree, template)


def _objects_to_state(objs, template: TrainState):
    st = TrainState(
        params=_restore_placement(objs["params"], template.params),
        opt=template.opt._replace(
            mu=_restore_placement(objs["opt_mu"], template.opt.mu),
            nu=_restore_placement(objs["opt_nu"], template.opt.nu),
            step=_restore_placement(objs["counters"]["opt_step"],
                                    template.opt.step)),
        rng=_restore_placement(objs["counters"]["rng"], template.rng))
    ps = PipelineState(seed=int(objs["pipeline"]["seed"]),
                       step=int(objs["pipeline"]["step"]))
    return st, ps


def _on_whole_tensors(step_fn: Callable, template: TrainState) -> Callable:
    """``step_fn`` on the whole tensors of a sharded state, its result
    placed back onto ``template``'s layout."""
    def step(state, batch):
        new_state, metrics = step_fn(unshard(state), batch)
        return place_like(new_state, template), metrics
    return step


def run_durable_loop(
    step_fn: Callable,
    init_state: TrainState,
    pipeline: DataPipeline,
    pool,
    *,
    n_steps: int,
    commit_every: int = 5,
    commit_mode: str = "sharded-async",   # the reference's default schedule
    n_shards: Optional[int] = None,      # sharded modes; None = auto
    placement=None,         # PlacementPolicy (dsm.placement)
    retention: Optional[int] = None,     # keep newest k manifests (GC)
    worker_id: int = 0,
    peer_tiers=None,        # one peer or a sequence (anything with a
    #                         .staging mapping); replication targets the
    #                         FIRST, recovery consults them all
    replicate: bool = False,
    crash_at: Optional[Dict[int, str]] = None,   # step -> "before_commit" |
    #                                              "after_commit" | "mid_write"
    fault_hook: Optional[Callable] = None,  # (point, step) inside the commit
    #                                         window — see dsm.flit_runtime
    resume: bool = False,   # recover from the pool before training; skips
    #                         the initial step -1 commit
    mesh=None,              # launch.mesh.Mesh: device-local commits (see
    #                         the module docstring)
    to_device: Optional[Callable] = None,
) -> LoopResult:
    """Run ``n_steps`` with durable commits every ``commit_every`` steps.

    ``crash_at`` injects worker crashes at precise points; after a crash
    the loop RECOVERS and continues (the scheduler restarting the worker).
    ``fault_hook`` fires inside the commit window (pre-flush, mid-flush,
    post-completeOp); a restarted process passes ``resume=True`` to
    recover from the pool instead of committing a fresh step -1, which
    would shadow newer manifests — only a ``ColdStartError`` falls through
    to the fresh start.

    ``pool`` is a ``DSMPool`` (or a pool path), from which the loop opens a
    ``CXL0Context`` with the wiring keywords above, or an open
    ``CXL0Context``, whose own wiring then wins.  ``to_device`` maps each
    numpy batch array to a tensor; by default onto the device of the
    state's params."""
    if isinstance(pool, CXL0Context):
        ctx = pool
    else:
        peers = (tuple(peer_tiers) if isinstance(peer_tiers, (tuple, list))
                 else (peer_tiers,) if peer_tiers is not None else ())
        ctx = open_cxl0(
            pool, worker_id, schedule=commit_mode, n_shards=n_shards,
            retention=retention, placement=placement, peers=peers,
            replicate_to=peers[0] if (replicate and peers) else None,
            mesh=mesh, fault_hook=fault_hook)
    if (mesh if mesh is not None else ctx.config.mesh) is not None:
        step_fn = _on_whole_tensors(step_fn, init_state)
    if to_device is None:
        device = tree_leaves(init_state.params)[0].device
        to_device = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    templates = _state_objects(init_state, pipeline.state)

    state = init_state
    losses: List[float] = []
    timings: List[StepTiming] = []
    recoveries: List[str] = []
    crashes = 0
    resumed_from: Optional[int] = None
    crash_at = dict(crash_at or {})

    i = 0
    if resume:
        try:
            objs, rec_step, source = ctx.recover(templates)
            state, pipeline.state = _objects_to_state(objs, state)
            recoveries.append(source)
            resumed_from = rec_step
            i = rec_step + 1
        except ColdStartError:
            pass                # cold pool: fall through to the fresh path
    if resumed_from is None:
        # initial durable state (step -1): a cold restart is always possible
        ctx.put(_state_objects(state, pipeline.state), step=-1)
        with ctx.commit(-1):
            pass
        ctx.drain()
    while i < n_steps:
        plan = crash_at.get(i)
        try:
            t0 = time.perf_counter()
            batch_np = pipeline.next_global()
            batch = {k: to_device(v) for k, v in batch_np.items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            t1 = time.perf_counter()

            ctx.put(_state_objects(state, pipeline.state), step=i)

            if plan == "before_commit":
                raise CrashError(f"injected before commit of step {i}")

            commit_s = 0.0
            if (i + 1) % commit_every == 0:
                if plan == "mid_write":
                    # dying midway through the durable write: some objects
                    # reach the pool, the manifest does NOT
                    for name in list(ctx.tiers.hbm)[:2]:
                        ctx.tiers.rflush(name)
                    raise CrashError(f"injected mid-write at step {i}")
                tc = time.perf_counter()
                with ctx.commit(i):
                    pass
                commit_s = time.perf_counter() - tc
                if plan == "after_commit":
                    raise CrashError(f"injected after commit of step {i}")

            timings.append(StepTiming(i, t1 - t0, commit_s))
            i += 1
        except CrashError:
            crashes += 1
            crash_at.pop(i, None)
            ctx.crash()       # f_i: abort in-flight flushes, volatile tiers
            #                   vanish
            objs, rec_step, source = ctx.recover(templates)
            state, pipeline.state = _objects_to_state(objs, state)
            recoveries.append(source)
            i = rec_step + 1

    td = time.perf_counter()
    drained = ctx.drain()
    if drained is not None:
        # the tail flush join is blocking commit time (it overlaps no
        # compute): charged so schedule comparisons stay honest
        timings.append(StepTiming(n_steps, 0.0, time.perf_counter() - td))
    ctx.close()
    return LoopResult(state, pipeline.state, losses, timings, recoveries,
                      crashes, resumed_from)
