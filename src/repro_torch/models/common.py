"""Shared layers: norms (incl. OLMo non-parametric LN, qk-norm), RoPE,
MLP/SwiGLU,
embedding and the tied unembedding — counterparts of
``repro.models.common`` with the same numerics (fp32 statistics and
angles, casts back to the activation dtype at the same places)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDesc

EPS = 1e-5


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_descs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDesc((d,), ("embed_nofsdp",), init="ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamDesc((d,), ("embed_nofsdp",), init="ones"),
                "bias": ParamDesc((d,), ("embed_nofsdp",), init="zeros")}
    if cfg.norm == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + EPS)
        return (y * p["scale"].float()).to(x.dtype)
    # (non-)parametric layernorm
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + EPS)
    if cfg.norm == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """QK-norm over the trailing head_dim (chameleon / OLMoE): fp32 RMS,
    times the scale, cast back."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + EPS)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (B, S, *rest, hd); positions: (B, S) or (S,).
    Angles in fp32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv_freq = theta ** (-freq / half)
    if positions.ndim == 1:
        ang = positions.float()[:, None] * inv_freq            # (S, half)
        ang = ang.reshape((1,) + tuple(ang.shape))             # (1,S,half)
    else:
        ang = positions.float()[..., None] * inv_freq          # (B,S,half)
    extra = x.ndim - ang.ndim
    ang = ang.reshape(tuple(ang.shape[:-1]) + (1,) * extra + (half,))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or plain)
# ---------------------------------------------------------------------------

def mlp_descs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    out = {"w_up": ParamDesc((d, ff), ("embed", "mlp")),
           "w_down": ParamDesc((ff, d), ("mlp", "embed"))}
    if cfg.glu:
        out["w_gate"] = ParamDesc((d, ff), ("embed", "mlp"))
    return out


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_up"]
    if cfg.glu:
        g = x @ p["w_gate"]
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_descs(cfg: ModelConfig):
    out = {"tok": ParamDesc((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                            init_scale=0.02)}
    if not cfg.tied_embeddings:
        out["unembed"] = ParamDesc((cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), init_scale=0.02)
    return out


def embed_tokens(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["tok"].to(dtype)[tokens]


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (tied: the embedding table, transposed)."""
    w = p.get("unembed", p["tok"])
    return x @ w.to(x.dtype).T
