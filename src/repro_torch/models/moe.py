"""Mixture-of-Experts, single device — the port of ``repro.models.moe``
(its dense branch, ``parallel=None``, lines 54-135 and 217-220).

Token-choice top-k routing with capacity-factor dropping (GShard-style),
scatter-based as in the reference: route (fp32 softmax, top-k with ties to
the lower expert index, weights renormalised), pack each expert's tokens
into an (E, C, D) capacity buffer in token-major order (later choices past
the capacity are dropped), run the experts as three grouped matmuls
(``kernels.moe_gmm.ops.grouped_matmul``: on the card ALWAYS the
hand-written Hopper kernel, on the CPU its plain version), and gather each
token's k outputs back, weighted.

``per_sequence=True`` routes each batch row on its own: its own capacity
(from its own token count) and its own rows of every expert's buffer (row
b takes C rows [b*cap, (b+1)*cap)).  That is what the reference's
continuous-batching decode computes — a ``vmap`` of single-sequence decode
— in ONE batch of grouped matmuls, so a slot's tokens never depend on what
the other slots hold.  Without it the B*S tokens share one routing, as the
reference's batched forward does.

Shared experts (deepseek-v2) are one wider dense MLP of width ``n_shared
* d_ff_expert`` (plain matmuls, as in the reference), whose output is
added to the routed experts' under either route.  The shard_map
expert-parallel modes (``a2a`` / ``psum``) wait for the multi-GPU port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm.ops import grouped_matmul
from repro_torch.models.common import apply_mlp, mlp_descs
from repro_torch.models.params import ParamDesc


def moe_descs(cfg: ModelConfig):
    m = cfg.moe
    d, E, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    out = {
        "router": ParamDesc((d, E), ("embed_nofsdp", None), dtype="float32",
                            init_scale=0.02),
        "w_up": ParamDesc((E, d, ff), ("expert", "embed", "mlp_e")),
        "w_down": ParamDesc((E, ff, d), ("expert", "mlp_e", "embed")),
    }
    if cfg.glu:
        out["w_gate"] = ParamDesc((E, d, ff), ("expert", "embed", "mlp_e"))
    if m.n_shared:
        out["shared"] = mlp_descs(cfg, d_ff=m.n_shared * ff)
    return out


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, router_w, x_flat, groups: int = 1):
    """x_flat: (T, D) -> (weights (T,k) in x's dtype, idx (T,k) int64,
    aux_loss scalar).  The switch-style load-balance loss is taken over
    each of ``groups`` equal runs of tokens and averaged (one group: the
    reference's)."""
    m = cfg.moe
    E = m.n_experts
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = _top_k(probs, m.top_k)
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, E).float()                      # (T, k, E)
    frac_tokens = onehot.reshape(groups, -1, E).mean(1)     # (G, E)
    frac_probs = probs.reshape(groups, -1, E).mean(1)
    aux = E * torch.sum(frac_tokens * frac_probs, -1) * m.top_k
    return w.to(x_flat.dtype), idx, aux.mean()


def _pack(cfg: ModelConfig, x_flat, idx, capacity: int, groups: int = 1):
    """Scatter tokens into (E, groups*capacity, D) capacity buffers.
    Returns (buf, dest (T, k)); ``dest`` indexes the flattened buffer and
    equals E*groups*capacity for a dropped choice.

    A token's place within its expert is the token-major running count of
    that expert's choices in its group (so the drop order is the
    reference's).  Every kept destination is unique, so the reference's
    ``.at[dest].add`` into zeros is an assignment: here into a buffer with
    one extra row that takes the drops (no atomics, deterministic)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    T, D = x_flat.shape
    dev = x_flat.device
    flat_e = idx.reshape(groups, -1)                           # (G, T_g*k)
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1        # (G, T_g*k, E)
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    group = torch.arange(groups, device=dev)[:, None]
    width = groups * capacity
    dest = torch.where(pos < capacity,
                       flat_e * width + group * capacity + pos, E * width)
    dest = dest.reshape(T, k)
    buf = x_flat.new_zeros((E * width + 1, D))
    buf[dest.reshape(-1)] = x_flat.repeat_interleave(k, dim=0)
    return buf[:-1].view(E, width, D), dest


def _expert_mlp(cfg: ModelConfig, p_up, p_gate, p_down, buf):
    """buf: (E, C, D) -> (E, C, D): the three expert products as grouped
    matmuls."""
    h = grouped_matmul(buf, p_up)
    if p_gate is not None:
        g = grouped_matmul(buf, p_gate)
        h = F.silu(g.float()).to(h.dtype) * h
    return grouped_matmul(h, p_down)


def _combine(out_buf_flat, dest, weights):
    """Gather per-token expert outputs. out_buf_flat: (E*C + 1, D)."""
    picked = out_buf_flat[dest]                                # (T, k, D)
    return torch.einsum("tkd,tk->td", picked, weights.to(picked.dtype))


def _moe_dense(cfg: ModelConfig, p, x_flat, groups: int = 1):
    cap = _capacity(x_flat.shape[0] // groups, cfg)
    w, idx, aux = _route(cfg, p["router"], x_flat, groups)
    buf, dest = _pack(cfg, x_flat, idx, cap, groups)
    out_buf = _expert_mlp(cfg, p["w_up"], p.get("w_gate"), p["w_down"], buf)
    D = x_flat.shape[1]
    out_flat = torch.cat([out_buf.reshape(-1, D),
                          out_buf.new_zeros((1, D))], 0)
    return _combine(out_flat, dest, w), aux


def moe_forward(cfg: ModelConfig, p, x: torch.Tensor, *,
                per_sequence: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    y, aux = _moe_dense(cfg, p, x.reshape(-1, D),
                        groups=B if per_sequence else 1)
    y = y.reshape(B, S, D)
    if cfg.moe.n_shared:
        y = y + apply_mlp(cfg, p["shared"], x)
    return y, aux
