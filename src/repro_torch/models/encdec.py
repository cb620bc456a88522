"""Encoder-decoder (Whisper) assembly — the port of ``repro.models.encdec``.

The audio frontend (log-mel + conv) is a STUB, as in the reference: the
caller passes precomputed frame embeddings ``enc_embeds`` (B, enc_seq, D).
Encoder: bidirectional attention, learned positional embeddings.
Decoder: causal self-attention, cross-attention over the encoder output,
then the MLP.  The decoder's positional table holds
``max(448, dec_pos_len)`` rows; a position past it reads its last row
(train / prefill: ``min(arange(S), len - 1)``; decode: ``min(pos, len -
1)``), exactly as the reference clamps.

Layers are stacked on a leading (L,) axis, as in the reference, and a
Python loop over that axis stands in for its ``lax.scan`` (``leaf[l]``
views, no copies).  Under ``with_remat`` with ``cfg.remat == "full"``
each layer runs under ``torch.utils.checkpoint`` (the reference's
``nothing_saveable`` policy: the backward recomputes the layer).

Attention, at train / prefill, is ``kernels.attention.ops.
flash_attention`` three times a decoder layer pair: the encoder's
self-attention (non-causal, enc_seq²), the decoder's (causal), and the
cross-attention (non-causal, S queries over enc_seq keys; the reference
calls its plain ``chunked_attention`` there, the same function).  On the
card that is the hand-written kernel (under autograd with its backward),
on the CPU its plain version.  Decode stays plain, as in the reference:
the self-attention through ``gqa_decode``, the cross-attention through
``chunked_attention`` over the cached cross K / V.

Caches (``EncDecCaches``) are written IN PLACE (the reference donates
them): prefill writes the prompt's self k / v at t = 0 and the whole
cross k / v; decode writes one self position.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.models import attention, common
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import ServeState, _positions
from repro_torch.models.params import ParamDesc, tree_map_descs
from repro_torch.utils.convert import torch_dtype
from repro_torch.utils.tree import tree_map


def _stack(descs, n: int):
    """Always adds the leading layers dim (the decoder slices per-layer
    params even when n == 1, unlike lm.py's singleton groups)."""
    return tree_map_descs(
        lambda p: ParamDesc((n,) + p.shape, ("layers",) + p.logical,
                            dtype=p.dtype, init=p.init,
                            init_scale=p.init_scale), descs)


def _attn_block_descs(cfg: ModelConfig):
    return {"norm1": common.norm_descs(cfg), "attn": attention.gqa_descs(cfg)}


def _dec_block_descs(cfg: ModelConfig):
    return {
        "norm1": common.norm_descs(cfg),
        "self_attn": attention.gqa_descs(cfg),
        "norm_x": common.norm_descs(cfg),
        "cross_attn": attention.gqa_descs(cfg),
        "norm2": common.norm_descs(cfg),
        "mlp": common.mlp_descs(cfg),
    }


def model_descs(cfg: ModelConfig, dec_pos_len: int = 448) -> Dict[str, Any]:
    e = cfg.encdec
    d = cfg.d_model
    enc_block = dict(_attn_block_descs(cfg))
    enc_block.update({"norm2": common.norm_descs(cfg),
                      "mlp": common.mlp_descs(cfg)})
    return {
        "embed": common.embed_descs(cfg),
        "enc_pos": ParamDesc((e.enc_seq, d), (None, "embed"), init_scale=0.02),
        "dec_pos": ParamDesc((max(448, dec_pos_len), d), (None, "embed"),
                             init_scale=0.02),
        "enc_layers": _stack(enc_block, e.n_enc_layers),
        "enc_final_norm": common.norm_descs(cfg),
        "dec_layers": _stack(_dec_block_descs(cfg), cfg.n_layers),
        "dec_final_norm": common.norm_descs(cfg),
    }


class EncDecCaches(NamedTuple):
    self_kv: KVCache       # stacked (L, B, T_max, K, hd)
    cross_kv: KVCache      # stacked (L, B, enc_seq, K, hd)


def cache_descs(cfg: ModelConfig, batch: int, t_max: int):
    e = cfg.encdec
    return EncDecCaches(
        self_kv=_stack(attention.gqa_cache_desc(cfg, batch, t_max),
                       cfg.n_layers),
        cross_kv=_stack(attention.gqa_cache_desc(cfg, batch, e.enc_seq),
                        cfg.n_layers))


def _remat(cfg: ModelConfig, with_remat: bool) -> bool:
    return with_remat and cfg.remat == "full"


def _layer(tree, l: int):
    return tree_map(lambda a: a[l], tree)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params, enc_embeds, *,
           with_remat: bool = False):
    """enc_embeds: (B, enc_seq, D) stubbed frontend output -> (B, enc_seq,
    D) in the compute dtype."""
    B, S, D = enc_embeds.shape
    dtype = torch_dtype(cfg.compute_dtype)
    x = enc_embeds.to(dtype)
    x = x + params["enc_pos"][:S].to(dtype)[None]
    positions = _positions(B, S, x.device)

    def body(x, l):
        p = _layer(params["enc_layers"], l)
        h = common.apply_norm(cfg, p["norm1"], x)
        y = attention.gqa_forward(cfg, p["attn"], h, positions, causal=False)
        x = x + y
        h2 = common.apply_norm(cfg, p["norm2"], x)
        return x + common.apply_mlp(cfg, p["mlp"], h2)

    remat = _remat(cfg, with_remat)
    for l in range(cfg.encdec.n_enc_layers):
        x = (checkpoint(body, x, l, use_reentrant=False) if remat
             else body(x, l))
    return common.apply_norm(cfg, params["enc_final_norm"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_kv(cfg: ModelConfig, p, enc_out):
    """The cross-attention's k, v (B, enc_seq, K, hd) from the encoder
    output: the reference's ``_project_qkv`` without rope (its q is
    discarded there, so it is not computed here)."""
    B, T, D = enc_out.shape
    wk, wv = p["wk"], p["wv"]
    k = (enc_out @ wk.reshape(D, -1)).reshape((B, T) + tuple(wk.shape[1:]))
    v = (enc_out @ wv.reshape(D, -1)).reshape((B, T) + tuple(wv.shape[1:]))
    if cfg.qk_norm:
        k = common.rms_head_norm(k, p["k_norm"])
    return k, v


def _dec_block(cfg: ModelConfig, p, x, positions, enc_out, *,
               self_cache=None, pos=None, decode: bool = False,
               cross_cache=None):
    """One decoder layer.  Returns ``(x, self_cache, cross_kv)``: at decode
    the self cache takes the token at ``pos`` in place and the cross
    attention reads ``cross_cache``; at train / prefill the cross k / v
    are computed from ``enc_out`` (and returned, for prefill to cache),
    and a given self cache takes the prompt's k / v at t = 0."""
    h = common.apply_norm(cfg, p["norm1"], x)
    if decode:
        y, self_cache = attention.gqa_decode(cfg, p["self_attn"], h,
                                             self_cache, pos)
    else:
        q, k, v = attention.project_qkv(cfg, p["self_attn"], h, positions)
        y = attention.gqa_forward(cfg, p["self_attn"], h, positions,
                                  qkv=(q, k, v))
        if self_cache is not None:          # prefill: the prompt at t = 0
            S = k.shape[1]
            self_cache.k[:, :S] = k.to(self_cache.k.dtype)
            self_cache.v[:, :S] = v.to(self_cache.v.dtype)
    x = x + y

    # cross attention (not causal; KV from the encoder output or the cache)
    hx = common.apply_norm(cfg, p["norm_x"], x)
    B, S, D = hx.shape
    wq = p["cross_attn"]["wq"]
    q = (hx @ wq.reshape(D, -1)).reshape((B, S) + tuple(wq.shape[1:]))
    if cross_cache is not None:
        k, v = cross_cache.k, cross_cache.v
        qpos = torch.zeros((B, S), dtype=torch.int32, device=hx.device)
        out = attention.chunked_attention(
            q, (k, v), lambda kv: kv, qpos, 0, causal=False,
            chunk=cfg.attn_chunk)
    else:
        k, v = _cross_kv(cfg, p["cross_attn"], enc_out)
        out = flash_attention(q, k, v, causal=False)
    x = x + attention.out_proj(p["cross_attn"], out)

    h2 = common.apply_norm(cfg, p["norm2"], x)
    x = x + common.apply_mlp(cfg, p["mlp"], h2)
    return x, self_cache, (k, v)


def decode_tokens(cfg: ModelConfig, params, tokens, enc_out, *,
                  caches: EncDecCaches = None, pos=None,
                  decode: bool = False, with_remat: bool = False):
    """Run the decoder stack. tokens: (B, S) int.  With ``caches``: at
    prefill (``decode`` False) each layer writes its self k / v at t = 0
    and its cross k / v whole; at decode (``pos``: a scalar or (B,)) one
    self position, the cross attention reading the cache.  Returns
    ``(x, caches)`` with x after the final norm."""
    B, S = tokens.shape
    dtype = torch_dtype(cfg.compute_dtype)
    x = common.embed_tokens(params["embed"], tokens, dtype)
    ptab = params["dec_pos"]
    last = ptab.shape[0] - 1
    if decode:
        pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
        positions = pos_b[:, None].to(torch.int32)
        x = x + ptab[pos_b.clamp(max=last).long()].to(dtype)[:, None]
    else:
        positions = _positions(B, S, x.device)
        idx = torch.arange(S, device=x.device).clamp(max=last)
        x = x + ptab[idx].to(dtype)[None]

    if caches is not None:
        for l in range(cfg.n_layers):
            cc = _layer(caches.cross_kv, l)
            x, _, (k, v) = _dec_block(
                cfg, _layer(params["dec_layers"], l), x, positions, enc_out,
                self_cache=_layer(caches.self_kv, l), pos=pos,
                decode=decode, cross_cache=(cc if decode else None))
            if not decode:          # prefill: the cross k / v, cached whole
                cc.k.copy_(k.to(cc.k.dtype))
                cc.v.copy_(v.to(cc.v.dtype))
    else:
        def body(x, l):
            return _dec_block(cfg, _layer(params["dec_layers"], l), x,
                              positions, enc_out)[0]

        remat = _remat(cfg, with_remat)
        for l in range(cfg.n_layers):
            x = (checkpoint(body, x, l, use_reentrant=False) if remat
                 else body(x, l))

    x = common.apply_norm(cfg, params["dec_final_norm"], x)
    return x, caches


# ---------------------------------------------------------------------------
# Public API (mirrors models.lm)
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params, batch, *, with_remat: bool = True,
            **_):
    """Next-token cross entropy of the decoder over ``batch["tokens"]``
    given ``batch["enc_embeds"]``: the targets are the shifted tokens with
    the last position masked (``batch["targets"]`` is ignored, as the
    reference ignores it).  Returns ``(loss, {"nll", "aux"})``, aux 0."""
    enc_out = encode(cfg, params, batch["enc_embeds"], with_remat=with_remat)
    tokens = batch["tokens"]
    x, _ = decode_tokens(cfg, params, tokens, enc_out, with_remat=with_remat)
    logits = common.unembed(cfg, params["embed"], x).float()
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    ones = torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                      device=tokens.device)
    mask = torch.cat([ones, torch.zeros_like(ones[:, :1])], dim=1)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, targets[..., None].long(),
                               dim=-1)[..., 0]
    loss = torch.sum((logz - tgt) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)
    return loss, {"nll": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=tokens.device)}


def prefill(cfg: ModelConfig, params, batch, caches: EncDecCaches):
    """Encode ``batch["enc_embeds"]``, run the prompt ``batch["tokens"]``
    through the decoder writing both caches.  Returns (last-token logits
    (B, V), ServeState(caches, S))."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    tokens = batch["tokens"]
    x, caches = decode_tokens(cfg, params, tokens, enc_out, caches=caches)
    logits = common.unembed(cfg, params["embed"], x[:, -1:])
    return (logits[:, 0].to(torch_dtype(cfg.logit_dtype)),
            ServeState(caches, torch.tensor(tokens.shape[1],
                                            dtype=torch.int32,
                                            device=tokens.device)))


def decode_step(cfg: ModelConfig, params, tokens, state: ServeState):
    """tokens: (B, 1).  Cross-attention uses the cached encoder KV.
    Returns (logits (B, V), ServeState(caches, pos + 1))."""
    x, caches = decode_tokens(cfg, params, tokens, None,
                              caches=state.caches, pos=state.pos,
                              decode=True)
    logits = common.unembed(cfg, params["embed"], x)
    return (logits[:, 0].to(torch_dtype(cfg.logit_dtype)),
            ServeState(caches, state.pos + 1))
