"""Model registry: config -> params / loss / serve steps — the port of
``repro.models.registry``.

    bundle = build(cfg, device="cuda")
    params = bundle.init_params(torch.Generator("cuda").manual_seed(0))
    loss, metrics = bundle.loss(params, {"tokens": t, "targets": y})
    logits, state = bundle.prefill(params, {"tokens": t}, caches)
    logits, state = bundle.decode(params, tokens, state)

An encoder-decoder config (whisper-small) builds ``models.encdec``'s
bundle, as the reference's does: its batches carry ``enc_embeds`` (B,
enc_seq, D) beside the tokens, its caches are ``EncDecCaches`` (self and
cross ``KVCache`` leaves of (L, B, T, K, hd)), ``forward`` is None, and
``dec_pos_len`` sizes its decoder positional table.

A bundle lives on one device (``"cuda"`` by default; asking for it without
a card raises).  Its caches are allocated there, and ``init_params`` wants
a generator on the same device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.params import (abstract_params, count_params,
                                       init_params, zeros_like_specs)
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    descs: Any
    forward: Optional[Callable]
    loss: Callable             # (params, batch, **kw) -> (loss, metrics)
    prefill: Callable
    decode: Callable
    cache_descs: Callable      # (batch, t_max) -> cache desc tree

    def abstract_params(self):
        return abstract_params(self.descs, self.cfg.param_dtype)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    seed: int = 0):
        """Params from ``generator`` (default: a fresh one on the bundle's
        device seeded with ``seed``)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(seed)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, bundle on "
                             f"{self.device}")
        return init_params(self.descs, generator, self.cfg.param_dtype)

    def abstract_caches(self, batch: int, t_max: int):
        return abstract_params(self.cache_descs(batch, t_max),
                               self.cfg.compute_dtype)

    def init_caches(self, batch: int, t_max: int):
        """Zero caches (the cache descriptors are all ``init="zeros"``)."""
        return zeros_like_specs(self.abstract_caches(batch, t_max),
                                self.device)

    def n_params(self) -> int:
        return count_params(self.descs)


def build(cfg: ModelConfig, dec_pos_len: int = 448,
          device="cuda") -> ModelBundle:
    """``dec_pos_len``: the encoder-decoder's decoder positional table
    length (at least 448); decoder-only models ignore it."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        return ModelBundle(
            cfg=cfg, device=dev,
            descs=encdec.model_descs(cfg, dec_pos_len=dec_pos_len),
            forward=None,
            loss=lambda p, b, **kw: encdec.loss_fn(cfg, p, b, **kw),
            prefill=lambda p, b, caches: encdec.prefill(cfg, p, b, caches),
            decode=lambda p, t, s: encdec.decode_step(cfg, p, t, s),
            cache_descs=lambda batch, t_max: encdec.cache_descs(
                cfg, batch, t_max))
    return ModelBundle(
        cfg=cfg, device=dev, descs=lm.model_descs(cfg),
        forward=lambda p, t: lm.forward(cfg, p, t),
        loss=lambda p, b, **kw: lm.loss_fn(cfg, p, b, **kw),
        prefill=lambda p, b, caches: lm.prefill(cfg, p, b["tokens"], caches),
        decode=lambda p, t, s, per_sequence=True: lm.decode_step(
            cfg, p, t, s, per_sequence=per_sequence),
        cache_descs=lambda batch, t_max: lm.cache_descs(cfg, batch, t_max))
