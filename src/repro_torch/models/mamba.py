"""Mamba (S6) selective-scan block for the Jamba hybrid — the port of
``repro.models.mamba``.

Prefill cuts the sequence into ``cfg.ssm_chunk`` chunks, computes each
chunk's dA, dBu and C (``_ssm_inputs``: materialising (B, S, I, N) for a
whole jamba-width sequence would not fit) and runs the recurrence
h_t = dA_t h_{t-1} + dBu_t, y_t = h_t · C_t through
``kernels.mamba.ops.selective_scan``, carrying h from chunk to chunk.  On
the card every chunk, and every decode step, is one launch of the Hopper
scan (``csrc/selective_scan.cu``); on the CPU it is the plain step
recurrence.  The reference solves a chunk with ``jax.lax.associative_scan``
instead (``_chunk_scan``): the same recurrence, other fp32 rounding.

A ragged last chunk is passed unpadded, where the reference pads it with
identity steps (dA = 1, dBu = 0): identity steps leave h exactly as it was
in fp32, so both carry the same h, and the padded y is discarded.

A given cache is updated IN PLACE: the scan writes its final h over
``cache.ssm``, and the conv window over ``cache.conv``.

Under grad (grad mode on and an input or param that requires grad) each
chunk's h is a new tensor, and each chunk's body (``_ssm_inputs`` and the
scan) runs under ``torch.utils.checkpoint``, as the reference checkpoints
its scan body with ``nothing_saveable``: a chunk's (B, Q, I, N) tensors
live only while that chunk runs, in the forward and again in the
backward.  On the card the scan's backward is ``csrc/selective_scan_bwd.cu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba import ops
from repro_torch.models.params import ParamDesc


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, inner) last inputs
    ssm: torch.Tensor    # (B, inner, d_state) float32


def _dims(cfg: ModelConfig):
    mc = cfg.mamba
    inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or cfg.d_model // 16
    return mc, inner, dt_rank


def mamba_descs(cfg: ModelConfig):
    mc, inner, dt_rank = _dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": ParamDesc((d, 2, inner), ("embed", None, "mamba_inner")),
        "conv_w": ParamDesc((mc.d_conv, inner), (None, "mamba_inner"),
                            init="uniform_small"),
        "conv_b": ParamDesc((inner,), ("mamba_inner",), init="zeros"),
        "x_proj": ParamDesc((inner, dt_rank + 2 * mc.d_state),
                            ("mamba_inner", None)),
        "dt_proj": ParamDesc((dt_rank, inner), (None, "mamba_inner"),
                             init_scale=dt_rank ** -0.5),
        "dt_bias": ParamDesc((inner,), ("mamba_inner",), init="decay_bias"),
        "A_log": ParamDesc((inner, mc.d_state), ("mamba_inner", None),
                           init="decay_bias"),
        "D_skip": ParamDesc((inner,), ("mamba_inner",), init="ones"),
        "out_proj": ParamDesc((inner, d), ("mamba_inner", "embed")),
    }


def mamba_cache_desc(cfg: ModelConfig, batch: int):
    mc, inner, _ = _dims(cfg)
    return MambaCache(
        conv=ParamDesc((batch, mc.d_conv - 1, inner),
                       ("batch", None, "mamba_inner"),
                       dtype=cfg.compute_dtype, init="zeros"),
        ssm=ParamDesc((batch, inner, mc.d_state),
                      ("batch", "mamba_inner", None),
                      dtype="float32", init="zeros"))


def _in_proj(p, x: torch.Tensor):
    """x (B, S, D) -> u_raw, z (B, S, inner): the reference's
    ``einsum("bsd,dci->bcsi")`` as one matmul over the (d, 2, inner)
    weight."""
    w = p["in_proj"]
    xz = (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return xz[:, :, 0], xz[:, :, 1]


def _causal_conv(cfg: ModelConfig, p, u: torch.Tensor,
                 prepend: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. u: (B,S,I); prepend: (B,d_conv-1,I).
    fp32 accumulation, then silu, then the input dtype."""
    mc = cfg.mamba
    S = u.shape[1]
    full = torch.cat([prepend.to(u.dtype), u], 1)
    acc = torch.zeros(u.shape, dtype=torch.float32, device=u.device) \
        + p["conv_b"].float()
    for j in range(mc.d_conv):
        acc = acc + p["conv_w"][j].float() * full[:, j:j + S].float()
    return F.silu(acc).to(u.dtype)


def _ssm_inputs(cfg: ModelConfig, p, u: torch.Tensor):
    """u: (B,Q,I) conv'd + silu'd -> dA (B,Q,I,N) f32, dBu f32, C (B,Q,N)
    f32, each contiguous (the scan kernel's layout)."""
    mc, _, dt_rank = _dims(cfg)
    N = mc.d_state
    proj = (u @ p["x_proj"]).float()
    dt_raw = proj[..., :dt_rank]
    B_ = proj[..., dt_rank:dt_rank + N]
    C_ = proj[..., dt_rank + N:].contiguous()
    dt = F.softplus(dt_raw @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                            # (I, N)
    dA = torch.exp_(dt[..., None] * A)                            # (B,Q,I,N)
    dBu = (dt[..., None] * B_[:, :, None, :]).mul_(u.float()[..., None])
    return dA, dBu, C_


def _gate_out(p, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    """y (B,S,I) f32 -> out (B,S,D): skip, silu(z) gate, out_proj."""
    y = y + p["D_skip"].float() * u.float()
    y = y * F.silu(z.float())
    return y.to(dtype) @ p["out_proj"]


def _chunk(cfg: ModelConfig, p, u_c: torch.Tensor, h):
    """One chunk's body under grad: its dA, dBu, C and the scan from h
    (None: zeros) -> (y_c, the chunk's last h)."""
    dA, dBu, C_ = _ssm_inputs(cfg, p, u_c)
    return ops.selective_scan(dA, dBu, C_, h)


def mamba_forward(cfg: ModelConfig, p, x: torch.Tensor, *,
                  initial: MambaCache = None):
    """x: (B, S, D) -> (out (B, S, D), cache).  Full sequence (prefill).
    With ``initial`` the scan starts from its state and conv window, and
    both are overwritten in place; the cache returned is ``initial``."""
    mc, inner, _ = _dims(cfg)
    B, S, _ = x.shape
    u_raw, z = _in_proj(p, x)
    prepend = (initial.conv if initial is not None
               else torch.zeros((B, mc.d_conv - 1, inner), dtype=x.dtype,
                                device=x.device))
    u = _causal_conv(cfg, p, u_raw, prepend)
    conv = torch.cat([prepend.to(x.dtype), u_raw], 1)[:, -(mc.d_conv - 1):]

    Q = min(cfg.ssm_chunk, S)
    h = initial.ssm if initial is not None else None
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *p.values(), *(initial or ())))
    if grad and h is not None:
        h = h.clone()        # the cache is written at the end, in place
    ys = []
    for c0 in range(0, S, Q):
        u_c = u[:, c0:c0 + Q]
        if grad:
            # a new h a chunk, and the chunk's (B, Q, I, N) tensors
            # recomputed in the backward (the reference's nothing_saveable)
            y_c, h = checkpoint(_chunk, cfg, p, u_c, h, use_reentrant=False)
        else:
            dA, dBu, C_ = _ssm_inputs(cfg, p, u_c)
            y_c, h = ops.selective_scan(dA, dBu, C_, h, h_out=h)
            del dA, dBu
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, 1)
    out = _gate_out(p, y, u, z, x.dtype)
    if initial is None:
        return out, MambaCache(conv=conv.contiguous(), ssm=h)
    if grad:
        initial.ssm.copy_(h)
    initial.conv.copy_(conv)
    return out, initial


def mamba_decode(cfg: ModelConfig, p, x: torch.Tensor, cache: MambaCache):
    """One-token decode, x: (B, 1, D): one scan step from ``cache.ssm``
    (at S = 1 the reference's decode arithmetic), the cache updated in
    place.  Returns (out (B, 1, D), cache)."""
    u_raw, z = _in_proj(p, x)
    u = _causal_conv(cfg, p, u_raw, cache.conv)
    dA, dBu, C_ = _ssm_inputs(cfg, p, u)
    y, _ = ops.selective_scan(dA, dBu, C_, cache.ssm, h_out=cache.ssm)
    out = _gate_out(p, y, u, z, x.dtype)
    cache.conv.copy_(torch.cat([cache.conv, u_raw.to(cache.conv.dtype)],
                               1)[:, 1:])
    return out, cache
