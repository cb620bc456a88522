"""Serve-step factories — the port of ``repro.train.step`` lines 117-189
(``make_train_step`` comes with the training slice).

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

import torch

from repro_torch.models.lm import ServeState
from repro_torch.models.params import tree_map_descs
from repro_torch.models.registry import ModelBundle


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
