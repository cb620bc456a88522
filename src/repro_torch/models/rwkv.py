"""RWKV-6 "Finch" block: data-dependent decay time mix + channel mix — the
port of ``repro.models.rwkv``.

Per head h with head size n, state S in R^{n x n}:

    y_t = r_t^T (S_{t-1} + diag(u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), per channel)

The WKV goes through ``kernels.rwkv6.ops.wkv6``: on the card every WKV,
prefill and decode alike, is one launch of the Hopper recurrence
(``csrc/wkv6.cu``), and under autograd its gradient one launch of
``csrc/wkv6_bwd.cu``; on the CPU it is the reference model's own
arithmetic (the chunked closed form for T > 1, the direct recurrence at
T = 1).  Its y stays fp32 into the group norm, as in the reference model.
Token shift uses RWKV-6's data-dependent lerp (ddlerp).

A given cache is updated IN PLACE: the WKV writes the new state over
``cache.S``; the caller (``lm.block_forward``) writes ``last_tm`` /
``last_cm``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6 import ops
from repro_torch.models.params import ParamDesc

MIX_KEYS = ("w", "r", "k", "v", "g")  # decay, receptance, key, value, gate
GN_EPS = 64e-5


class RWKVCache(NamedTuple):
    last_tm: torch.Tensor   # (B, 1, D) last (normed) input of the time mix
    last_cm: torch.Tensor   # (B, 1, D) last input of the channel mix
    S: torch.Tensor         # (B, H, n, n) wkv state, float32


def _dims(cfg: ModelConfig):
    rc = cfg.rwkv
    return rc, cfg.d_model // rc.head_dim, rc.head_dim


def rwkv_descs(cfg: ModelConfig):
    rc, H, n = _dims(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    return {
        # --- time mix ---
        "mu_x": ParamDesc((d,), ("embed_nofsdp",), init="uniform_small"),
        "mu": ParamDesc((5, d), (None, "embed_nofsdp"), init="uniform_small"),
        "tm_w1": ParamDesc((d, 5, rc.mix_lora), ("embed_nofsdp", None, "lora")),
        "tm_w2": ParamDesc((5, rc.mix_lora, d), (None, "lora", "embed_nofsdp")),
        "w_r": ParamDesc((d, H, n), ("embed", "heads", "head_dim")),
        "w_k": ParamDesc((d, H, n), ("embed", "heads", "head_dim")),
        "w_v": ParamDesc((d, H, n), ("embed", "heads", "head_dim")),
        "w_g": ParamDesc((d, H, n), ("embed", "heads", "head_dim")),
        "w_o": ParamDesc((H, n, d), ("heads", "head_dim", "embed")),
        "dec_w1": ParamDesc((d, rc.decay_lora), ("embed_nofsdp", "lora")),
        "dec_w2": ParamDesc((rc.decay_lora, H, n), ("lora", "heads", "head_dim")),
        "dec_bias": ParamDesc((H, n), ("heads", "head_dim"), init="decay_bias"),
        "bonus_u": ParamDesc((H, n), ("heads", "head_dim"),
                             init="uniform_small"),
        "gn_scale": ParamDesc((H, n), ("heads", "head_dim"), init="ones"),
        "gn_bias": ParamDesc((H, n), ("heads", "head_dim"), init="zeros"),
        # --- channel mix ---
        "mu_ck": ParamDesc((d,), ("embed_nofsdp",), init="uniform_small"),
        "mu_cr": ParamDesc((d,), ("embed_nofsdp",), init="uniform_small"),
        "w_ck": ParamDesc((d, ff), ("embed", "mlp")),
        "w_cv": ParamDesc((ff, d), ("mlp", "embed")),
        "w_cr": ParamDesc((d, d), ("embed", "embed_nofsdp")),
    }


def rwkv_cache_desc(cfg: ModelConfig, batch: int):
    rc, H, n = _dims(cfg)
    d = cfg.d_model
    return RWKVCache(
        last_tm=ParamDesc((batch, 1, d), ("batch", None, None),
                          dtype=cfg.compute_dtype, init="zeros"),
        last_cm=ParamDesc((batch, 1, d), ("batch", None, None),
                          dtype=cfg.compute_dtype, init="zeros"),
        S=ParamDesc((batch, H, n, n), ("batch", "heads", None, None),
                    dtype="float32", init="zeros"))


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x_{t-1} stream. x: (B,S,D); last: (B,1,D) value before the window."""
    return torch.cat([last.to(x.dtype), x[:, :-1]], 1)


def _ddlerp(p, x, xx):
    """RWKV-6 data-dependent token-shift mix -> dict of 5 mixed inputs."""
    delta = xx - x
    x_base = x + delta * p["mu_x"].to(x.dtype)
    z = torch.tanh(torch.einsum("bsd,dfm->bsfm", x_base, p["tm_w1"]))
    adj = torch.einsum("bsfm,fmd->bsfd", z, p["tm_w2"]) + p["mu"].to(x.dtype)
    return {k: x + delta * adj[:, :, i] for i, k in enumerate(MIX_KEYS)}


def _heads(x, w):
    """x (B,S,D) @ w (D,H,n) -> (B,S,H,n), contiguous (the kernel's
    layout)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _tm_project(cfg, p, mixed):
    """-> r, k, v (B,S,H,n), g (B,S,H,n) f32 and the log decay logw
    (B,S,H,n) f32, < 0."""
    r = _heads(mixed["r"], p["w_r"])
    k = _heads(mixed["k"], p["w_k"])
    v = _heads(mixed["v"], p["w_v"])
    g = F.silu(_heads(mixed["g"], p["w_g"]).float())
    lora = mixed["w"].float() @ p["dec_w1"].float()
    w_raw = _heads(lora, p["dec_w2"].float()) + p["dec_bias"].float()
    logw = -torch.exp(w_raw)                     # log of decay, < 0
    return r, k, v, g, logw


def _group_norm(p, y):
    """Per-head layer norm of the wkv output. y: (B,S,H,n) float32."""
    mu = torch.mean(y, -1, keepdim=True)
    var = torch.mean(torch.square(y - mu), -1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + GN_EPS)
    return yn * p["gn_scale"].float() + p["gn_bias"].float()


def rwkv_time_mix(cfg: ModelConfig, p, x: torch.Tensor,
                  cache: RWKVCache = None):
    """Time mix of x (B, S, D).  Returns ``(out, (last_tm, S))``: last_tm is
    x[:, -1:] (the next window's token-shift input) and S the final wkv
    state — ``cache.S`` itself, overwritten in place, when a cache is
    given."""
    B, S, D = x.shape
    last = (cache.last_tm if cache is not None
            else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device))
    mixed = _ddlerp(p, x, _shift(x, last))
    r, k, v, g, logw = _tm_project(cfg, p, mixed)
    S0 = cache.S if cache is not None else None
    y, S_last = ops.wkv6(r, k, v, logw, p["bonus_u"].float(), S0,
                         chunk=cfg.ssm_chunk, state_out=S0)
    y = _group_norm(p, y) * g
    out = y.to(x.dtype).flatten(-2) @ p["w_o"].reshape(-1, D)
    return out, (x[:, -1:], S_last)


def rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                     cache: RWKVCache = None):
    """Channel mix of x (B, S, D).  Returns ``(out, last_cm)``."""
    B, S, D = x.shape
    last = (cache.last_cm if cache is not None
            else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device))
    xx = _shift(x, last)
    xk = x + (xx - x) * p["mu_ck"].to(x.dtype)
    xr = x + (xx - x) * p["mu_cr"].to(x.dtype)
    kk = xk @ p["w_ck"]
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = kk @ p["w_cv"]
    rr = torch.sigmoid((xr @ p["w_cr"]).float()).to(x.dtype)
    return rr * vv, x[:, -1:]
