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
    step; ``csrc/wkv6_bwd.cu`` is held to it.  Returns dr, dk, dv, dlogw
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


def _diag_scores(r_c, k_c, w, uf, i, L):
    """Scores inside the sub-block at ``i`` (s < t), in fp32 with the decay
    as the running product of w over s < m < t, and the bonus r_t . (u
    k_t) on the diagonal; (B, H, L, L), zero above the diagonal."""
    sb = slice(i, i + L)
    A = torch.diag_embed((r_c[:, :, sb] * uf * k_c[:, :, sb]).sum(-1))
    W = torch.ones_like(k_c[:, :, sb])              # over s: prod_{s<m<t} w_m
    for t in range(1, L):
        A[:, :, t, :t] = (r_c[:, :, i + t, None] * k_c[:, :, i:i + t]
                          * W[:, :, :t]).sum(-1)
        W[:, :, :t] = W[:, :, :t] * w[:, :, i + t, None]
    return A


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
            A[:, :, ti, ti] = _diag_scores(r_c, k_c, w, uf, i, L)
        y = y + mm(A, v_c)
        k_tilde = k_c * torch.exp(logP[:, :, -1:] - logP)
        S = torch.exp(logP[:, :, -1])[..., None] * S + mm(k_tilde.transpose(2, 3),
                                                          v_c)
        ys.append(y)
    return torch.cat(ys, 2)[:, :, :T].transpose(1, 2), S


def wkv6_bwd_subblocks(r, k, v, logw, u, S0, dy, dS=None, *, chunk: int = 64,
                       sub: int = 16, operands: Optional[str] = None,
                       split: bool = False):
    """The decomposition ``csrc/wkv6_bwd.cu`` computes, in plain torch, for
    the tests: the backward of the chunked closed form (``wkv6_subblocks``)
    over chunks of ``chunk`` steps and sub-blocks of ``sub``, every
    exponent <= 0.  Arguments and results as ``wkv6_bwd_ref``'s.

    Per (b, h), with logP the inclusive cumulative log decay from a chunk's
    start (logP_{-1} = 0), r~_t = r_t exp(logP_{t-1}), k~_s = k_s
    exp(logP_{Q-1} - logP_s), a_c = exp(logP_{Q-1}):

    * chunk start states S_c as the forward's: S_{c+1} = a_c S_c + k~^T V;
    * the state gradient across chunks, G_c that of the state at chunk c's
      end: G_{C-1} = dS (or 0), G_{c-1} = a_c G_c + r~^T dY, dS0 = G_{-1};
    * per chunk, with dA[t][s] = dy_t . v_s (a product, s <= t; its
      diagonal is c_t = v_t . dy_t) and the forward's scores A (each
      sub-block's lower-left 8 x 8 quarter a product split at its 8th
      step):
      dr0 = (dY S_c^T) exp(logP_{t-1}) + intra, dk0 = (V G_c^T)
      exp(logP_{Q-1} - logP_s) + intra, dv = k~ G_c + A^T dY (A's diagonal
      holds the bonus r_t . (u k_t));
    * the intra-chunk terms of dr0 for t in sub-block i against every
      earlier sub-block at once, split at p, the last step before i:
      exp(logP_{t-1} - logP_p) (dA (k_s exp(logP_p - logP_s))); those of dk0
      for s in sub-block j against every later one, split at e, j's last
      step: exp(logP_e - logP_s) (dA^T (r_t exp(logP_{t-1} - logP_e)));
      inside a sub-block in fp32, the decay a running product of w;
    * the bonus: dr = dr0 + u k_t c_t, dk = dk0 + u r_t c_t, du = sum r k c;
    * dlogw_t = D_c + sum_{t' > t in the chunk} (r dr0 - k dk0)_{t'} - k_t
      dk0_t: ``wkv6_bwd_ref``'s reverse sums, restarted at every chunk's end
      from D_c = rowsum(G_c * S_{c+1}) = a_c rowsum(G_c * S_c) + sum_s k_s
      (V G_c^T)[s] exp(logP_{Q-1} - logP_s), the decay gradient's value at
      the chunk's last step, so no sum runs longer than a chunk.

    ``operands`` rounds every product's operands as ``wkv6_subblocks``'s
    does; ``split`` adds the remainders' products to every product but
    those only dv reads (the pair scores, k~ G_c and A^T dY), which take
    one rounding as on the card: dv's limit is 1e-2 and it is written in
    bf16.  A ragged tail reads as logw = 0 and r = k = v = dy = 0."""
    B, T, H, n = r.shape
    Q, L = chunk, sub
    assert Q % L == 0
    pad = -T % Q
    rf, kf, vf, lw, dyf = (a.float().transpose(1, 2)
                           for a in (r, k, v, logw, dy))     # (B, H, T, n)
    if pad:
        rf, kf, vf, lw, dyf = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                               for a in (rf, kf, vf, lw, dyf))
    uf = u.float()[None, :, None, :]
    mm = lambda a, b: _mm(a, b, operands, split)           # noqa: E731
    mm1 = lambda a, b: _mm(a, b, operands, False)          # noqa: E731
    tr = lambda a: a.transpose(2, 3)                       # noqa: E731
    NC = rf.shape[2] // Q
    sl = [slice(c * Q, (c + 1) * Q) for c in range(NC)]
    logP = [torch.cumsum(lw[:, :, s], 2) for s in sl]
    logPm1 = [torch.nn.functional.pad(p, (0, 0, 1, 0))[:, :, :Q] for p in logP]
    S = _state0(r, S0).clone()
    starts = []
    for c in range(NC):                                    # the forward's states
        starts.append(S)
        kt = kf[:, :, sl[c]] * torch.exp(logP[c][:, :, -1:] - logP[c])
        S = torch.exp(logP[c][:, :, -1])[..., None] * S + mm(tr(kt), vf[:, :, sl[c]])
    starts.append(S)
    G = torch.zeros_like(S) if dS is None else dS.float().clone()
    Gs = [None] * NC
    for c in reversed(range(NC)):                          # the state gradient
        Gs[c] = G
        rt = rf[:, :, sl[c]] * torch.exp(logPm1[c])
        G = torch.exp(logP[c][:, :, -1])[..., None] * G + mm(tr(rt), dyf[:, :, sl[c]])
    outs = {name: [] for name in ("dr", "dk", "dv", "dlogw")}
    du = torch.zeros_like(S[..., 0])
    for c in range(NC):
        r_c, k_c, v_c, dy_c = (a[:, :, sl[c]] for a in (rf, kf, vf, dyf))
        lp, lpm1, S_c, G_c = logP[c], logPm1[c], starts[c], Gs[c]
        w = torch.exp(lw[:, :, sl[c]])
        A = r_c.new_zeros((B, H, Q, Q))
        dA = r_c.new_zeros((B, H, Q, Q))
        for i in range(0, Q, L):
            ti = slice(i, i + L)
            for j in range(0, i + L, L):
                sj = slice(j, j + L)
                dA[:, :, ti, sj] = mm(dy_c[:, :, ti], tr(v_c[:, :, sj]))
                if j < i:
                    e = lp[:, :, j + L - 1:j + L]
                    A[:, :, ti, sj] = mm1(r_c[:, :, ti] * torch.exp(lpm1[:, :, ti] - e),
                                          tr(k_c[:, :, sj] * torch.exp(e - lp[:, :, sj])))
            A[:, :, ti, ti] = _diag_scores(r_c, k_c, w, uf, i, L)
            # the sub-block's lower-left quarter as a product, split at its
            # 8th step
            h = i + L // 2
            lo, hi, e = slice(i, h), slice(h, i + L), lp[:, :, h - 1:h]
            A[:, :, hi, lo] = mm1(r_c[:, :, hi] * torch.exp(lpm1[:, :, hi] - e),
                                  tr(k_c[:, :, lo] * torch.exp(e - lp[:, :, lo])))
        cc = torch.diagonal(dA, dim1=2, dim2=3)[..., None]   # v_t . dy_t
        last = lp[:, :, -1:]
        dr0 = torch.exp(lpm1) * mm(dy_c, tr(S_c))
        dk0 = torch.exp(last - lp) * mm(v_c, tr(G_c))
        # D_c = rowsum(G_c * S_{c+1}) = a_c rowsum(G_c * S_c) + rowsum(G_c *
        # k~^T V), the last sum_s k_s dk0's inter part
        D_c = (torch.exp(last[:, :, 0]) * (G_c * S_c).sum(-1)
               + (k_c * dk0).sum(2))
        dv = mm1(k_c * torch.exp(last - lp), G_c)
        for i in range(0, Q, L):
            ti, rest = slice(i, i + L), slice(i, Q)
            if i:
                p = lp[:, :, i - 1:i]
                dr0[:, :, ti] += torch.exp(lpm1[:, :, ti] - p) * mm(
                    dA[:, :, ti, :i], k_c[:, :, :i] * torch.exp(p - lp[:, :, :i]))
            if i + L < Q:
                e, later = lp[:, :, i + L - 1:i + L], slice(i + L, Q)
                dk0[:, :, ti] += torch.exp(e - lp[:, :, ti]) * mm(
                    tr(dA[:, :, later, ti]),
                    r_c[:, :, later] * torch.exp(lpm1[:, :, later] - e))
            dv[:, :, ti] += mm1(tr(A[:, :, rest, ti]), dy_c[:, :, rest])
            W = torch.ones_like(k_c[:, :, ti])           # inside the sub-block
            for t in range(1, L):
                dA_t = dA[:, :, i + t, i:i + t, None]        # over s < t
                dr0[:, :, i + t] += (dA_t * k_c[:, :, i:i + t] * W[:, :, :t]).sum(2)
                dk0[:, :, i:i + t] += dA_t * r_c[:, :, i + t, None] * W[:, :, :t]
                W[:, :, :t] = W[:, :, :t] * w[:, :, i + t, None]
        x = r_c * dr0 - k_c * dk0
        later_sum = torch.flip(torch.cumsum(torch.flip(x, (2,)), 2), (2,)) - x
        outs["dlogw"].append(D_c[:, :, None] + later_sum - k_c * dk0)
        outs["dr"].append(dr0 + uf * k_c * cc)
        outs["dk"].append(dk0 + uf * r_c * cc)
        outs["dv"].append(dv)
        du = du + (r_c * k_c * cc).sum(2)
    dr, dk, dv, dlogw = (torch.cat(outs[name], 2)[:, :, :T].transpose(1, 2)
                         for name in ("dr", "dk", "dv", "dlogw"))
    return dr, dk, dv, dlogw, du.sum(0), G
