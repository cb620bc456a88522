"""Grouped-query attention — the port of ``repro.models.attention`` (GQA,
lines 31-181; the MLA code waits for the deepseek-v2 slice).

Layout as in the reference: q is produced natively grouped as
(B, S, K, G, hd) with K = kv heads and G = q heads per kv head, so GQA
needs no repeat of K / V.

* ``gqa_forward`` (train / prefill): the inner attention is
  ``kernels.attention.ops.flash_attention`` — on the card ALWAYS the
  hand-written Hopper kernel, on the CPU its plain version;
* ``gqa_decode`` (one token per sequence): ``chunked_attention``, plain
  torch, as the reference computes decode attention outside any Pallas
  kernel.  It takes PER-SEQUENCE positions, so a batch of serving slots
  each decodes at its own position (the reference vmaps a scalar-position
  decode over the slots; see ``train.step.make_slot_decode_step``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.models.common import rms_head_norm, rope
from repro_torch.models.params import ParamDesc
from repro_torch.utils.tree import tree_leaves, tree_map

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Core: chunked online-softmax attention (plain torch)
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,                  # (B, S, K, G, hd_k) float
    kv,                               # pytree; each leaf (B, T, ...) on axis 1
    expand_fn: Callable,              # kv_chunk -> (k (B,Tc,K,hd_k), v (B,Tc,K,hd_v))
    q_positions: torch.Tensor,        # (B, S) int
    kv_base: int,                     # kv chunk c covers [kv_base + c*chunk, ...)
    *,
    causal: bool,
    chunk: int,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:                    # (B, S, K, G, hd_v)
    B, S, K, G, hd_k = q.shape
    T = tree_leaves(kv)[0].shape[1]
    chunk = min(chunk, T)
    T_valid = T
    if T % chunk:                      # pad KV to a chunk multiple; padded
        pad = chunk - T % chunk        # positions are masked out below
        kv = tree_map(lambda a: torch.cat(
            [a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], 1), kv)
        T += pad
    n_chunks = T // chunk
    scale = softmax_scale if softmax_scale is not None else hd_k ** -0.5
    dev = q.device

    qf = q.float() * scale
    m = l = acc = None
    for c in range(n_chunks):
        k_c, v_c = expand_fn(tree_map(
            lambda a: a[:, c * chunk:(c + 1) * chunk], kv))
        # scores: (B, K, G, S, Tc)
        s = torch.einsum("bskgh,btkh->bkgst", qf, k_c.float())
        kv_pos = kv_base + c * chunk + torch.arange(chunk, device=dev)
        if causal:
            mask = q_positions[:, None, :] >= kv_pos[None, :, None]  # (B,Tc,S)
            mask = mask.transpose(1, 2)[:, None, None]               # (B,1,1,S,Tc)
            s = torch.where(mask, s, NEG_INF)
        if T_valid != T:               # mask the chunk-padding positions
            s = torch.where(kv_pos < kv_base + T_valid, s, NEG_INF)
        if m is None:
            m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, K, G, S), dtype=torch.float32, device=dev)
            acc = torch.zeros((B, S, K, G, v_c.shape[-1]),
                              dtype=torch.float32, device=dev)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(v_c.dtype), v_c)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    denom = torch.clamp(l.permute(0, 3, 1, 2), min=1e-20)[..., None]
    return (acc / denom).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_descs(cfg: ModelConfig):
    d, K, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // cfg.n_kv_heads
    out = {
        "wq": ParamDesc((d, K, G, hd), ("embed", "kv_heads", "q_per_kv", "head_dim")),
        "wk": ParamDesc((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDesc((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDesc((K, G, hd, d), ("kv_heads", "q_per_kv", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDesc((hd,), ("head_dim",), init="ones")
        out["k_norm"] = ParamDesc((hd,), ("head_dim",), init="ones")
    return out


class KVCache(NamedTuple):
    """Decode-time cache for one attention layer (possibly layer-stacked)."""
    k: torch.Tensor       # (B, T_max, K, hd)
    v: torch.Tensor       # (B, T_max, K, hd)


def gqa_cache_desc(cfg: ModelConfig, batch: int, t_max: int):
    shape = (batch, t_max, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.cache_dtype or cfg.compute_dtype
    return KVCache(
        k=ParamDesc(shape, ("batch", "seq_kv", "kv_heads", "head_dim"), dtype=dt, init="zeros"),
        v=ParamDesc(shape, ("batch", "seq_kv", "kv_heads", "head_dim"), dtype=dt, init="zeros"))


def project_qkv(cfg: ModelConfig, p, x, positions):
    """x (B, S, D) -> q (B,S,K,G,hd), k (B,S,K,hd), v (B,S,K,hd): q and k
    qk-normed (where the config has it) and then roped, as the reference
    orders them."""
    B, S, D = x.shape
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    q = (x @ wq.reshape(D, -1)).reshape((B, S) + tuple(wq.shape[1:]))
    k = (x @ wk.reshape(D, -1)).reshape((B, S) + tuple(wk.shape[1:]))
    v = (x @ wv.reshape(D, -1)).reshape((B, S) + tuple(wv.shape[1:]))
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """(B, S, K, G, hd) @ wo (K, G, hd, D) -> (B, S, D)."""
    B, S = out.shape[:2]
    wo = p["wo"]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def gqa_forward(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True, qkv=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D).  ``qkv``
    passes projections already computed (prefill also writes k, v into
    the cache)."""
    q, k, v = qkv if qkv is not None else project_qkv(cfg, p, x, positions)
    return out_proj(p, flash_attention(q, k, v, causal=causal))


def gqa_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: KVCache,
               pos: torch.Tensor):
    """One-token decode. x: (B, 1, D); pos: (B,) int, each sequence's
    current position (a scalar broadcasts).  Writes the new k / v into
    ``cache`` IN PLACE at ``pos[b]`` (the reference donates its cache) and
    returns ``(y, cache)``."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    positions = pos[:, None].to(torch.int32)
    q, k, v = project_qkv(cfg, p, x, positions)
    # the reference's dynamic_update_slice clamps the start index
    idx = pos.clamp(0, cache.k.shape[1] - 1).long()
    rows = torch.arange(B, device=x.device)
    cache.k[rows, idx] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = v[:, 0].to(cache.v.dtype)
    out = chunked_attention(
        q, (cache.k, cache.v), lambda kv: kv, positions, 0,
        causal=True, chunk=cfg.attn_chunk)
    return out_proj(p, out), cache
