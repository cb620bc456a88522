"""Plain PyTorch versions of the RWKV-6 WKV recurrence — the port of
``repro/kernels/rwkv6/ref.py`` (the step-by-step oracle) and of
``repro/models/rwkv.py:_wkv_chunked`` (the chunked closed form the
reference model runs) — and the oracle's backward (``wkv6_bwd_ref``,
what ``csrc/wkv6_bwd.cu`` computes).  The CPU path runs the forwards, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Per head, head size n, state S in R^{n x n} (key-major):

    y_t = (S_{t-1} + diag(u * k_t) v_t^T)^T r_t      (read out)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T              (decay + rank-1 update)

Shapes: r, k, v, logw (B, T, H, n); u (H, n); S0 (B, H, n, n).  All math
fp32; both return y (B, T, H, n) fp32 and the final state (B, H, n, n) fp32.
"""
from __future__ import annotations

from typing import Optional

import torch


def _state0(r, S0: Optional[torch.Tensor]):
    B, _, H, n = r.shape
    if S0 is None:
        return torch.zeros((B, H, n, n), dtype=torch.float32,
                           device=r.device)
    return S0.float()


def wkv6_ref(r, k, v, logw, u, S0=None):
    """The step-by-step oracle; at T = 1 it is the reference model's
    decode (``rwkv_time_mix``'s direct recurrence)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())                  # decay in (0, 1)
    uf = u.float()
    S = _state0(r, S0)
    ys = []
    for t in range(r.shape[1]):
        k_t, v_t = kf[:, t], vf[:, t]
        # bonus: the current token adds diag(u * k) v^T without decay
        S_plus = S + (uf * k_t)[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhij,bhi->bhj", S_plus, rf[:, t]))
        S = wf[:, t, :, :, None] * S + k_t[..., :, None] * v_t[..., None, :]
    return torch.stack(ys, 1), S


def wkv6_bwd_ref(r, k, v, logw, u, S0, dy, dS=None):
    """The plain backward of ``wkv6_ref``: the gradients of a loss whose
    cotangents are ``dy`` (B, T, H, n) on y and ``dS`` (B, H, n, n) on the
    final state (None: zero), from the state ``S0`` (None: zero), step by
    step as ``csrc/wkv6_bwd.cu`` computes them.  Returns dr, dk, dv, dlogw
    (B, T, H, n), du (H, n) summed over B, and dS0 (B, H, n, n), all
    fp32.

    With w_t = exp(logw_t), S_t the state after step t and dS_t its
    gradient (dS_{T-1} = dS):

    * forward sweep: dr0_t = S_{t-1} dy_t;
    * reverse sweep: dk0_t = dS_t v_t, dv0_t = dS_t^T k_t, then
      dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T; dS0 = dS_{-1};
    * the bonus, c_t = v_t . dy_t: dr_t = dr0_t + u k_t c_t, dk_t = dk0_t
      + u r_t c_t, dv_t = dv0_t + (r_t . (u k_t)) dy_t, du = sum_{b,t}
      r_t k_t c_t;
    * the decay without a stored state: D_t = rowsum(dS_t * S_t) obeys
      D_t = dlogw_t + k_t dk0_t and D_{t-1} = dlogw_t + r_t dr0_t, so from
      D_{T-1} = rowsum(dS * S_{T-1}) (0 without dS) the reverse sweep
      gives dlogw_t = D_t - k_t dk0_t, then D_{t-1} = dlogw_t + r_t dr0_t.
    """
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()
    dyf = dy.float()
    T = r.shape[1]
    S = _state0(r, S0)
    dr0 = []
    for t in range(T):                                    # forward sweep
        dr0.append(torch.einsum("bhij,bhj->bhi", S, dyf[:, t]))
        S = (wf[:, t, :, :, None] * S
             + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    if dS is None:
        G = torch.zeros_like(S)
        D = torch.zeros_like(S[..., 0])
    else:
        G = dS.float()
        D = (G * S).sum(-1)
    dr, dk, dv, dlogw = ([None] * T for _ in range(4))
    du = torch.zeros_like(D)
    for t in reversed(range(T)):                          # reverse sweep
        r_t, k_t, v_t, dy_t = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        dk0 = torch.einsum("bhij,bhj->bhi", G, v_t)
        dv0 = torch.einsum("bhij,bhi->bhj", G, k_t)
        G = wf[:, t, :, :, None] * G + r_t[..., :, None] * dy_t[..., None, :]
        c = (v_t * dy_t).sum(-1, keepdim=True)
        a = (r_t * (uf * k_t)).sum(-1, keepdim=True)
        dr[t] = dr0[t] + uf * k_t * c
        dk[t] = dk0 + uf * r_t * c
        dv[t] = dv0 + a * dy_t
        dlogw[t] = D - k_t * dk0
        D = dlogw[t] + r_t * dr0[t]
        du = du + r_t * k_t * c
    return (torch.stack(dr, 1), torch.stack(dk, 1), torch.stack(dv, 1),
            torch.stack(dlogw, 1), du.sum(0), G)


def wkv6_chunked(r, k, v, logw, u, S0=None, *, chunk: int = 256):
    """Chunked closed form (FLA-style), as the reference model computes it:
    within a chunk of Q tokens the cross-token terms are weighted by
    exp(logP_{t-1} - logP_s), s < t (exponents <= 0, so stable), and the
    state is carried from chunk to chunk.  A ragged tail is padded with
    identity decay (logw = 0) and zero r / k / v, so the carried state is
    exact."""
    B, T, H, n = r.shape
    Q = min(chunk, T)
    pad = -T % Q
    rf, kf, vf, lw = (a.float() for a in (r, k, v, logw))
    if pad:
        rf, kf, vf, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (rf, kf, vf, lw))
    uf = u.float()
    causal_lt = torch.ones((Q, Q), dtype=torch.bool,
                           device=r.device).tril(-1)             # s < t
    S_c = _state0(r, S0)
    ys = []
    for c in range(rf.shape[1] // Q):
        sl = slice(c * Q, (c + 1) * Q)
        r_c, k_c, v_c, lw_c = rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl]
        logP = torch.cumsum(lw_c, 1)                              # inclusive
        logPm1 = logP - lw_c                                      # exclusive
        # inter-chunk: r_t decayed against the carried state
        y_inter = torch.einsum("bthi,bhij->bthj", r_c * torch.exp(logPm1),
                               S_c)
        # intra-chunk: A[t,s] = sum_i r_t k_s exp(logPm1_t - logP_s), s < t
        expo = logPm1[:, :, None] - logP[:, None, :]              # (B,t,s,H,n)
        expo = expo.masked_fill(~causal_lt[None, :, :, None, None],
                                float("-inf"))
        A = (r_c[:, :, None] * k_c[:, None] * torch.exp(expo)).sum(-1)
        diag = torch.einsum("bthi,bthi->bth", r_c, uf * k_c)      # bonus
        y_intra = (torch.einsum("btsh,bshj->bthj", A, v_c)
                   + diag[..., None] * v_c)
        # state to the chunk's end
        k_tilde = k_c * torch.exp(logP[:, -1:] - logP)
        S_c = (torch.exp(logP[:, -1])[..., None] * S_c
               + torch.einsum("bshi,bshj->bhij", k_tilde, v_c))
        ys.append(y_inter + y_intra)
    return torch.cat(ys, 1)[:, :T], S_c


def _round_operand(x, operands: Optional[str]):
    """A product operand as the card's tensor cores take it: None keeps
    fp32, "tf32" rounds to TF32 (10 mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits cleared),
    "bf16" rounds to bf16."""
    if operands is None:
        return x
    if operands == "bf16":
        return x.bfloat16().float()
    if operands == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    raise ValueError(f"operands {operands!r}: want None, 'tf32' or 'bf16'")


def _mm(a, b, operands: Optional[str], split: bool):
    """a @ b with the operands rounded as ``operands`` says; ``split``
    adds the products of the rounding remainders (a = a_hi + a_lo: a_hi b_hi
    + a_lo b_hi + a_hi b_lo, the three-pass TF32 product), which leaves
    an error near fp32's."""
    a_hi, b_hi = _round_operand(a, operands), _round_operand(b, operands)
    out = a_hi @ b_hi
    if split and operands is not None:
        out = (out + _round_operand(a - a_hi, operands) @ b_hi
               + a_hi @ _round_operand(b - b_hi, operands))
    return out


def wkv6_subblocks(r, k, v, logw, u, S0=None, *, chunk: int = 64,
                   sub: int = 16, operands: Optional[str] = None,
                   split: bool = False):
    """The decomposition ``csrc/wkv6.cu``'s chunked route computes, in
    plain torch, for the tests: the chunked closed form with each chunk's
    (Q, Q) scores factored by sub-blocks of ``sub`` steps, every exponent
    <= 0.

    Per chunk, with logP the inclusive cumulative log decay from the
    chunk's start (logP_{-1} = 0):

    * y_inter = (r_t exp(logP_{t-1})) S_c, a product;
    * scores of t in sub-block i against s in an earlier sub-block j, a
      product over channels, split at e, the last step of j:
      exp(logP_{t-1} - logP_s) = exp(logP_{t-1} - logP_e) exp(logP_e -
      logP_s), both factors <= 1;
    * scores inside a sub-block (s < t) in fp32 with the decay as the
      running product of w = exp(logw) over s < m < t, and the bonus
      r_t . (u k_t) on the diagonal;
    * y_intra = scores @ v, a product;
    * S_{c+1} = exp(logP_{Q-1}) S_c + (k_s exp(logP_{Q-1} - logP_s))^T v,
      a product and an fp32 update.

    ``operands`` rounds every product's operands as the card's tensor
    cores take them (None, "tf32" or "bf16"), ``split`` adds the
    remainders' products (see ``_mm``).  A ragged tail reads as logw = 0
    and r = k = v = 0.  Returns y (B, T, H, n) and the final state, fp32.
    """
    B, T, H, n = r.shape
    Q, L = chunk, sub
    assert Q % L == 0
    pad = -T % Q
    # (B, H, T, n)
    rf, kf, vf, lw = (a.float().transpose(1, 2) for a in (r, k, v, logw))
    if pad:
        rf, kf, vf, lw = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                          for a in (rf, kf, vf, lw))
    uf = u.float()[None, :, None, :]                       # (1, H, 1, n)
    mm = lambda a, b: _mm(a, b, operands, split)           # noqa: E731
    S = _state0(r, S0).clone()
    ys = []
    for c0 in range(0, rf.shape[2], Q):
        r_c, k_c, v_c, lw_c = (a[:, :, c0:c0 + Q] for a in (rf, kf, vf, lw))
        logP = torch.cumsum(lw_c, 2)                       # inclusive
        logPm1 = torch.nn.functional.pad(logP, (0, 0, 1, 0))[:, :, :Q]
        w = torch.exp(lw_c)
        y = mm(r_c * torch.exp(logPm1), S)
        A = r_c.new_zeros((B, H, Q, Q))
        for i in range(0, Q, L):
            ti = slice(i, i + L)
            for j in range(0, i, L):
                sj = slice(j, j + L)
                e = logP[:, :, j + L - 1:j + L]             # (B, H, 1, n)
                A[:, :, ti, sj] = mm(r_c[:, :, ti] * torch.exp(logPm1[:, :, ti] - e),
                                     (k_c[:, :, sj] * torch.exp(e - logP[:, :, sj]))
                                     .transpose(2, 3))
            # inside the sub-block: running products of w, fp32
            for s in range(i, i + L):
                A[:, :, s, s] = (r_c[:, :, s] * uf[:, :, 0] * k_c[:, :, s]).sum(-1)
                W = torch.ones_like(k_c[:, :, s])
                for t in range(s + 1, i + L):
                    A[:, :, t, s] = (r_c[:, :, t] * k_c[:, :, s] * W).sum(-1)
                    W = W * w[:, :, t]
        y = y + mm(A, v_c)
        k_tilde = k_c * torch.exp(logP[:, :, -1:] - logP)
        S = torch.exp(logP[:, :, -1])[..., None] * S + mm(k_tilde.transpose(2, 3),
                                                          v_c)
        ys.append(y)
    return torch.cat(ys, 2)[:, :, :T].transpose(1, 2), S
