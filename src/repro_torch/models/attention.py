"""Grouped-query attention and multi-head latent attention (MLA,
deepseek-v2) — the port of ``repro.models.attention``.

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
  decode over the slots; see ``train.step.make_slot_decode_step``);
* ``mla_forward`` (train / prefill): K / V up-projected from the latent
  whole (the reference expands them chunk by chunk inside its plain
  attention), then the same flash kernel with q as (B, S, K=H, G=1,
  nope+rope) and v of width v_head_dim;
* ``mla_decode``: the reference's absorbed form (w_uk folded into q, one
  shared latent head of width kv_lora + rope), plain ``chunked_attention``
  at per-sequence positions: its widths (576 / 512 at deepseek-v2) are
  beyond the kernel's 256, and the reference computes it outside Pallas.
  The cache holds the latent: k = ckv (B, T, kv_lora), v = k_rope (B, T,
  rope), both on the logical ``seq_kv`` axis the pager blocks.
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
    k: torch.Tensor       # (B, T_max, K, hd)  |  MLA: ckv (B, T_max, kv_lora)
    v: torch.Tensor       # (B, T_max, K, hd)  |  MLA: k_rope (B, T_max, rope)


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
    """(B, S, K, G, hd) @ wo (K, G, hd, D) -> (B, S, D); MLA's (B, S, H,
    [1,] v) @ wo (H, v, D) alike."""
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


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def mla_descs(cfg: ModelConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDesc((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamDesc((m.q_lora_rank,), ("lora",), init="ones"),
        "w_uq": ParamDesc((m.q_lora_rank, H, qk), ("lora", "heads", "head_dim")),
        "w_dkv": ParamDesc((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "lora")),
        "kv_norm": ParamDesc((m.kv_lora_rank,), ("lora",), init="ones"),
        "w_uk": ParamDesc((m.kv_lora_rank, H, m.qk_nope_head_dim),
                          ("lora", "heads", "head_dim")),
        "w_uv": ParamDesc((m.kv_lora_rank, H, m.v_head_dim),
                          ("lora", "heads", "head_dim")),
        "wo": ParamDesc((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def mla_cache_desc(cfg: ModelConfig, batch: int, t_max: int):
    m = cfg.mla
    dt = cfg.cache_dtype or cfg.compute_dtype
    return KVCache(
        k=ParamDesc((batch, t_max, m.kv_lora_rank),
                    ("batch", "seq_kv", "mla_lora"),
                    dtype=dt, init="zeros"),
        v=ParamDesc((batch, t_max, m.qk_rope_head_dim),
                    ("batch", "seq_kv", "mla_lora"),
                    dtype=dt, init="zeros"))


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, r) @ w (r, H, h) -> (B, S, H, h)."""
    B, S, r = x.shape
    return (x @ w.reshape(r, -1)).reshape((B, S) + tuple(w.shape[1:]))


def _mla_q(cfg: ModelConfig, p, x, positions):
    """x (B, S, D) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope) (roped)."""
    m = cfg.mla
    cq = rms_head_norm(x @ p["w_dq"], p["q_norm"])
    q = _heads(cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(cfg: ModelConfig, p, x, positions):
    """x (B, S, D) -> the latent the cache holds: ckv (B, S, kv_lora)
    (normed) and k_rope (B, S, rope) (roped, one head shared by all)."""
    m = cfg.mla
    ckv_full = x @ p["w_dkv"]
    ckv = rms_head_norm(ckv_full[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                  cfg.rope_theta)
    return ckv, k_rope[..., 0, :]


def mla_forward(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True, ckv=None) -> torch.Tensor:
    """Expanded MLA (train / prefill): K / V up-projected from the latent
    whole and the attention through the flash kernel (q (B,S,K=H,G=1,qk),
    scale qk^-0.5: the kernel's default).  ``ckv`` passes the latent
    already computed (prefill also writes it into the cache)."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    q = torch.cat([q_nope, q_rope], -1)[:, :, :, None, :]
    c, k_rope = ckv if ckv is not None else _mla_ckv(cfg, p, x, positions)
    k_nope = _heads(c, p["w_uk"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        tuple(k_nope.shape[:3]) + (m.qk_rope_head_dim,))], -1)
    v = _heads(c, p["w_uv"])
    out = flash_attention(q, k, v, causal=causal)            # (B,S,H,1,v)
    return out_proj(p, out)


def mla_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: KVCache,
               pos: torch.Tensor):
    """Absorbed MLA decode: attention in latent space, one shared head
    (K=1, G=H).  x: (B, 1, D); pos: (B,) int (a scalar broadcasts).  Writes
    the token's ckv / k_rope into ``cache`` IN PLACE at ``pos[b]`` and
    returns ``(y, cache)``."""
    m = cfg.mla
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    positions = pos[:, None].to(torch.int32)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    # absorb w_uk: q' = q_nope @ w_uk^T -> latent width
    q_lat = torch.einsum("bshq,rhq->bshr", q_nope, p["w_uk"])
    q_cat = torch.cat([q_lat, q_rope], -1)[:, :, None]       # (B,1,1,H,r+rope)
    ckv, k_rope = _mla_ckv(cfg, p, x, positions)
    idx = pos.clamp(0, cache.k.shape[1] - 1).long()
    rows = torch.arange(B, device=x.device)
    cache.k[rows, idx] = ckv[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = k_rope[:, 0].to(cache.v.dtype)

    def expand(kv_c):
        ckv_c, kr_c = kv_c
        k = torch.cat([ckv_c, kr_c], -1)[:, :, None, :]      # (B,Tc,1,r+rope)
        return k, ckv_c[:, :, None, :]                       # v (B,Tc,1,r)

    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    out_lat = chunked_attention(
        q_cat, (cache.k, cache.v), expand, positions, 0,
        causal=True, chunk=cfg.attn_chunk,
        softmax_scale=qk ** -0.5)                            # (B,1,1,H,r)
    out = torch.einsum("bskhr,rhv->bshv", out_lat, p["w_uv"])
    return out_proj(p, out), cache
