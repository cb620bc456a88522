"""Decoder-only LM assembly, attention blocks with a dense or MoE channel
mixer and rwkv blocks — the port of ``repro.models.lm``.

Layer stacking follows the reference exactly (``layer_groups``): a prefix
of singleton groups plus one periodic group whose params are stacked with
a leading (repeats,) dim.  The reference scans over that dim
(``lax.scan``); here it is a Python loop over the stacked leaves
(``leaf[r]`` views — no copies).  olmo-1b is one group of 16 repeats, so
every param and cache leaf carries a leading (16,) dim, and the cache
pytree is ``[{"blocks": [KVCache(k, v)]}]`` with k / v of shape
(16, B, T_max, K, hd) — the structure the pool layout depends on.

Caches are updated IN PLACE (the reference donates them): ``prefill``
writes the prompt's k / v at t = 0, ``decode_step`` writes one position
per sequence.  olmoe-1b-7b has the same structure with a MoE channel
mixer in every block (``models.moe``; its aux loss is returned by
``block_forward`` as in the reference, summed for training by
``loss_fn`` and discarded by serving).
rwkv6-7b is one group of 32 rwkv blocks (``models.rwkv``: time mix, then
its own channel mix, no ``mlp``), whose cache is ``RWKVCache(last_tm,
last_cm, S)`` with no token axis: prefill and decode both overwrite it
whole.  jamba-1.5-large's mamba blocks (``models.mamba``: the selective
scan, then a dense or MoE channel mixer, as an attention block has) carry
``MambaCache(conv, ssm)``, also with no token axis, beside the attention
blocks' ``KVCache``: prefill and decode overwrite it whole, in place.
deepseek-v2's attention is MLA (``attention.mla_*``): its ``KVCache``
holds the latent, k = ckv (B, T_max, kv_lora) and v = k_rope (B, T_max,
rope).  Its first ``first_dense`` layers have a dense MLP and the rest
MoE with shared experts, so ``layer_groups`` gives one group of 8
distinct kinds at depth 8 and, at 60, a dense singleton before 59 stacked
MoE layers.

Training (``loss_fn``): next-token cross entropy plus the weighted MoE aux
loss, each repeat of a stacked group under ``torch.utils.checkpoint`` when
``cfg.remat`` is ``"full"`` or ``"dots"`` (both recompute the whole block
in the backward: the reference's ``"dots"`` keeps the matmul outputs, a
memory policy with the same values).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mamba, moe, rwkv
from repro_torch.models.params import ParamDesc, tree_map_descs
from repro_torch.utils.convert import torch_dtype
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kinds: Tuple[Tuple[str, str], ...]    # per position: (mixer, mlp)
    n_repeats: int


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    return [(cfg.layer_kind(l), cfg.mlp_kind(l)) for l in range(cfg.n_layers)]


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """(prefix of singletons) + one periodic group covering the rest."""
    kinds = layer_kinds(cfg)
    L = len(kinds)
    for prefix in range(0, L):
        rest = kinds[prefix:]
        n = len(rest)
        for p in range(1, min(16, n) + 1):
            if n % p:
                continue
            if all(rest[i] == rest[i % p] for i in range(n)):
                groups = [LayerGroup((kinds[i],), 1) for i in range(prefix)]
                groups.append(LayerGroup(tuple(rest[:p]), n // p))
                return groups
    return [LayerGroup((k,), 1) for k in kinds]


# ---------------------------------------------------------------------------
# Param / cache descriptors
# ---------------------------------------------------------------------------

def block_descs(cfg: ModelConfig, kind: Tuple[str, str]):
    mixer, mlp = kind
    if mixer == "rwkv":                 # rwkv has its own channel mix
        return {"norm1": common.norm_descs(cfg),
                "norm2": common.norm_descs(cfg),
                "rwkv": rwkv.rwkv_descs(cfg)}
    if mixer == "mamba":
        out = {"norm1": common.norm_descs(cfg),
               "mamba": mamba.mamba_descs(cfg),
               "norm2": common.norm_descs(cfg)}
    elif mixer == "attn":
        out = {"norm1": common.norm_descs(cfg),
               "attn": (attention.mla_descs(cfg) if cfg.mla is not None
                        else attention.gqa_descs(cfg)),
               "norm2": common.norm_descs(cfg)}
    else:
        raise ValueError(mixer)
    if mlp == "dense":
        out["mlp"] = common.mlp_descs(cfg)
    elif mlp == "moe":
        out["moe"] = moe.moe_descs(cfg)
    else:
        raise ValueError(mlp)
    return out


def _stack(descs, n: int):
    if n == 1:
        return descs
    return tree_map_descs(
        lambda p: ParamDesc((n,) + p.shape, ("layers",) + p.logical,
                            dtype=p.dtype, init=p.init,
                            init_scale=p.init_scale), descs)


def model_descs(cfg: ModelConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {"embed": common.embed_descs(cfg)}
    out["groups"] = [
        {"blocks": [_stack(block_descs(cfg, kind), g.n_repeats)
                    for kind in g.kinds]}
        for g in layer_groups(cfg)]
    out["final_norm"] = common.norm_descs(cfg)
    return out


def _block_cache_desc(cfg: ModelConfig, mixer: str, batch: int,
                      t_max: int):
    if mixer == "rwkv":
        return rwkv.rwkv_cache_desc(cfg, batch)
    if mixer == "mamba":
        return mamba.mamba_cache_desc(cfg, batch)
    if mixer != "attn":
        raise ValueError(mixer)
    if cfg.mla is not None:
        return attention.mla_cache_desc(cfg, batch, t_max)
    return attention.gqa_cache_desc(cfg, batch, t_max)


def cache_descs(cfg: ModelConfig, batch: int, t_max: int):
    return [
        {"blocks": [_stack(_block_cache_desc(cfg, mixer, batch, t_max),
                           g.n_repeats)
                    for mixer, _ in g.kinds]}
        for g in layer_groups(cfg)]


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def block_forward(cfg: ModelConfig, p, x, positions, *, cache=None,
                  pos=None, decode: bool = False,
                  per_sequence: bool = True):
    """One transformer block (attention or mamba, then a dense or MoE
    channel mixer).  Returns ``(x, cache, aux)``: a given cache is written
    in place (attention prefill: the prompt at t = 0; decode: one token at
    ``pos``; mamba: the conv window and the state, whole), and ``aux`` is
    the MoE load-balance loss (0 for a dense block).  A decode with
    ``per_sequence`` routes each sequence's token through the MoE on its
    own, as the reference's serving decode (a per-slot ``vmap``) does;
    without it, and in a forward or prefill of B sequences, the batch
    shares one routing under one capacity, as the reference's batched
    decode and forward do.  An rwkv block (time mix,
    channel mix) overwrites its cache whole: the state in place inside the
    WKV, then last_tm / last_cm."""
    if "rwkv" in p:
        return _rwkv_block(cfg, p, x, cache)
    h = common.apply_norm(cfg, p["norm1"], x)
    if "mamba" in p:
        if decode:
            y, cache = mamba.mamba_decode(cfg, p["mamba"], h, cache)
        else:
            y, _ = mamba.mamba_forward(cfg, p["mamba"], h, initial=cache)
    elif decode:
        decode_fn = (attention.mla_decode if cfg.mla is not None
                     else attention.gqa_decode)
        y, cache = decode_fn(cfg, p["attn"], h, cache, pos)
    elif cfg.mla is not None:
        ckv, k_rope = attention._mla_ckv(cfg, p["attn"], h, positions)
        y = attention.mla_forward(cfg, p["attn"], h, positions,
                                  ckv=(ckv, k_rope))
        if cache is not None:           # prefill: the latent at t = 0
            S = ckv.shape[1]
            cache.k[:, :S] = ckv.to(cache.k.dtype)
            cache.v[:, :S] = k_rope.to(cache.v.dtype)
    else:
        q, k, v = attention.project_qkv(cfg, p["attn"], h, positions)
        y = attention.gqa_forward(cfg, p["attn"], h, positions,
                                  qkv=(q, k, v))
        if cache is not None:           # prefill: write the cache at t = 0
            S = k.shape[1]
            cache.k[:, :S] = k.to(cache.k.dtype)
            cache.v[:, :S] = v.to(cache.v.dtype)
    x = x + y
    h2 = common.apply_norm(cfg, p["norm2"], x)
    if "moe" in p:
        y2, aux = moe.moe_forward(cfg, p["moe"], h2,
                                  per_sequence=decode and per_sequence)
    else:
        y2, aux = common.apply_mlp(cfg, p["mlp"], h2), 0.0
    return x + y2, cache, aux


def _rwkv_block(cfg: ModelConfig, p, x, cache):
    h = common.apply_norm(cfg, p["norm1"], x)
    y, (last_tm, _) = rwkv.rwkv_time_mix(cfg, p["rwkv"], h, cache)
    x = x + y
    h2 = common.apply_norm(cfg, p["norm2"], x)
    y2, last_cm = rwkv.rwkv_channel_mix(cfg, p["rwkv"], h2, cache)
    if cache is not None:
        cache.last_tm.copy_(last_tm)
        cache.last_cm.copy_(last_cm)
    return x + y2, cache, 0.0


def _run_groups(cfg: ModelConfig, params, x, positions, *, caches=None,
                pos=None, decode: bool = False, per_sequence: bool = True,
                with_remat: bool = False):
    """Apply all layer groups; the stacked (repeats,) dim is a loop.
    Returns ``(x, aux)``: the MoE aux loss summed as the reference sums it
    (per repeat of a group, then over repeats; a dense model's stays the
    float 0.0, so serving it issues no extra op).  ``with_remat``
    checkpoints each repeat of a stacked group (the reference remats its
    scanned groups, not the singletons) when ``cfg.remat`` asks for it;
    the backward re-runs that repeat, so the group is bound at
    definition."""
    aux_total = 0.0
    remat = with_remat and cfg.remat in ("full", "dots")
    for gi, g in enumerate(layer_groups(cfg)):
        gp = params["groups"][gi]["blocks"]
        gc = caches[gi]["blocks"] if caches is not None else None

        def superblock(x, r, g=g, gp=gp, gc=gc):
            aux_sb = 0.0
            for pi, _ in enumerate(g.kinds):
                bp, bc = gp[pi], (gc[pi] if gc is not None else None)
                if g.n_repeats > 1:
                    bp = tree_map(lambda a: a[r], bp)
                    if bc is not None:
                        bc = tree_map(lambda a: a[r], bc)
                x, _, aux = block_forward(cfg, bp, x, positions, cache=bc,
                                          pos=pos, decode=decode,
                                          per_sequence=per_sequence)
                aux_sb = aux_sb + aux
            return x, aux_sb

        for r in range(g.n_repeats):
            if remat and g.n_repeats > 1:
                x, aux = checkpoint(superblock, x, r, use_reentrant=False)
            else:
                x, aux = superblock(x, r)
            aux_total = aux_total + aux
    return x, aux_total


def embed_inputs(cfg: ModelConfig, params, tokens):
    return common.embed_tokens(params["embed"], tokens,
                               torch_dtype(cfg.compute_dtype))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ModelConfig, params, tokens, *, with_remat: bool = False,
            with_aux: bool = False):
    """Full forward (train / prefill without cache): (B, S, V) logits in
    ``cfg.logit_dtype``; with ``with_aux`` (training) also the MoE aux
    loss, as the reference's ``forward`` returns ``(logits, aux)``."""
    B, S = tokens.shape[:2]
    x = embed_inputs(cfg, params, tokens)
    x, aux = _run_groups(cfg, params, x, _positions(B, S, tokens.device),
                         with_remat=with_remat)
    x = common.apply_norm(cfg, params["final_norm"], x)
    logits = common.unembed(cfg, params["embed"], x).to(
        torch_dtype(cfg.logit_dtype))
    if not with_aux:
        return logits
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=tokens.device)


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            with_remat: bool = True):
    """Next-token cross entropy + MoE aux — the reference's ``loss_fn``.
    ``batch``: {tokens, (targets, mask)}; without targets, the shifted
    tokens with the last position masked.  Returns ``(loss, {"nll",
    "aux"})``, loss = nll + aux_weight * aux.  The target logit is a
    gather, whose backward (a scatter-add) has a deterministic CUDA
    implementation under ``torch.use_deterministic_algorithms``."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
        ones = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                          device=tokens.device)
        mask = torch.cat([ones, torch.zeros_like(ones[:, :1])], dim=1)
    else:
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
    logits, aux = forward(cfg, params, tokens, with_remat=with_remat,
                          with_aux=True)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, targets[..., None].long(),
                               dim=-1)[..., 0]
    nll = (logz - tgt) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    caches: Any            # list of group cache dicts
    pos: torch.Tensor      # next position to write: scalar or (B,)


def prefill(cfg: ModelConfig, params, tokens, caches):
    """Run the prompt through the model, writing the caches at t = 0.
    Returns (last-token logits (B, V), ServeState)."""
    B, S = tokens.shape[:2]
    x = embed_inputs(cfg, params, tokens)
    x, _ = _run_groups(cfg, params, x, _positions(B, S, tokens.device),
                       caches=caches)
    x = common.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = common.unembed(cfg, params["embed"], x)
    return (logits[:, 0].to(torch_dtype(cfg.logit_dtype)),
            ServeState(caches, torch.tensor(S, dtype=torch.int32,
                                            device=tokens.device)))


def decode_step(cfg: ModelConfig, params, tokens, state: ServeState, *,
                per_sequence: bool = True):
    """One decode step. tokens: (B, 1) int; ``state.pos`` a scalar or one
    position per sequence.  With ``per_sequence`` each sequence's token is
    routed through the MoE on its own (the slot decode); without it the B
    tokens share one routing (the reference's batched ``decode_step``,
    which the static baseline runs).  Returns (logits (B, V), state)."""
    x = embed_inputs(cfg, params, tokens)
    x, _ = _run_groups(cfg, params, x, None, caches=state.caches,
                       pos=state.pos, decode=True, per_sequence=per_sequence)
    x = common.apply_norm(cfg, params["final_norm"], x)
    logits = common.unembed(cfg, params["embed"], x)
    return (logits[:, 0].to(torch_dtype(cfg.logit_dtype)),
            ServeState(state.caches, state.pos + 1))
