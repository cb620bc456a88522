"""Step factories: the train step and the serve steps — the port of
``repro.train.step``.

``make_train_step(bundle)`` returns ``step(state, batch) -> (state,
metrics)`` with the loss and its gradient under remat (``cfg.remat``),
optional microbatching (gradient accumulation in fp32 over microbatch
slices, as the reference's ``lax.scan``), an optional gradient hook and
the AdamW update on a cosine schedule.  The update is out of place: the
state handed in is left as it is.

``make_slot_decode_step`` is the continuous-batching decode: every slot
advances by one token at its OWN position.  The reference builds it as a
``vmap`` of single-sequence decode, so a slot's tokens never depend on the
other slots or on its lane index — the property crash-resume bit-identity
rests on.  Here it is one batched decode with per-slot positions (rope at
``pos[b]``, k / v written at ``pos[b]``, mask ``kv_pos <= pos[b]``, and
MoE routing per slot: each slot's token gets its own capacity and its own
rows of the expert buffers, as a single-sequence decode would); the batch
shape is fixed at ``n_slots``, so the card runs the same kernels with the
same shapes every tick, and each row's arithmetic is the same whatever the
other rows hold.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.lm import ServeState
from repro_torch.models.params import tree_map_descs
from repro_torch.models.registry import ModelBundle
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_flatten, tree_map


def make_train_step(bundle: ModelBundle, *, microbatch: int = 1,
                    peak_lr: float = 3e-4, total_steps: int = 10_000,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """The train step.  ``grad_transform(grads, None) -> grads`` is the
    reference's gradient hook (its second argument, the mesh context, has
    no counterpart here).  Metrics: ``loss``, ``lr``, ``grad_norm``,
    ``step`` (after the increment), ``nll`` and ``aux`` — with
    microbatches, the loss is their mean and ``nll`` / ``aux`` come from
    the last one, as the reference's scan returns them."""

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = bundle.loss(treedef.unflatten(live), batch,
                                    with_remat=True)
        grads = torch.autograd.grad(loss, live)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, treedef.unflatten(grads)

    def accumulate(params, batch):
        if microbatch <= 1:
            return grads_of(params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} does not split into {microbatch} "
                             f"microbatches")
        mb = B // microbatch
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, part)
            acc = tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        inv = 1.0 / microbatch
        return (loss_sum * inv, metrics,
                tree_map(lambda g: g * inv, acc))

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads = accumulate(state.params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads, None)
        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr,
                             total=total_steps)
        params, opt, gnorm = adamw_update(
            state.params, grads, state.opt, lr, weight_decay=0.1,
            grad_clip=1.0)
        new_state = TrainState(params=params, opt=opt, rng=state.rng)
        return new_state, {"loss": loss, "lr": lr, "grad_norm": gnorm,
                           "step": opt.step, **metrics}

    return step


def make_serve_steps(bundle: ModelBundle):
    """``(prefill_step, decode_step)``: the batched steps of the static
    baseline.  ``decode_step`` routes the batch's tokens through the MoE
    under one shared capacity, as the reference's batched decode does (the
    slot decode below routes each slot on its own)."""
    def prefill_step(params, batch, caches):
        return bundle.prefill(params, batch, caches)

    def decode_step(params, tokens, state):
        return bundle.decode(params, tokens, state, per_sequence=False)

    return prefill_step, decode_step


def cache_batch_axes(bundle: ModelBundle):
    """Per-leaf index of the BATCH axis in the decode-cache pytree (layer-
    stacked groups put batch at axis 1, singleton groups at axis 0) — read
    off the cache descriptors' logical axis names, as the reference does."""
    return tree_map_descs(lambda d: d.logical.index("batch"),
                          bundle.cache_descs(1, 2))


def make_slot_decode_step(bundle: ModelBundle):
    """``slot_decode(params, tokens, caches, pos, active)`` with

    * ``tokens`` (B, 1) int — last sampled token per slot,
    * ``caches`` — batched cache pytree, updated in place,
    * ``pos``    (B,) int — per-slot decode position,
    * ``active`` (B,) bool — slot occupancy mask,

    returns ``(next_tokens (B,), logits (B, V), caches, pos)``; greedy
    argmax (first index on ties) is the repo's only sampler.  Inactive
    slots still compute (the price of a fixed batch shape) but their
    position does not advance; their lane is overwritten at admission."""
    if bundle.cfg.is_encdec:
        raise ValueError("slot decode is decoder-only")

    def slot_decode(params, tokens, caches, pos, active):
        logits, st = bundle.decode(params, tokens, ServeState(caches, pos))
        new_pos = torch.where(active, st.pos, pos)
        next_tokens = torch.argmax(logits, -1).to(torch.int32)
        return next_tokens, logits, st.caches, new_pos

    return slot_decode
