"""The xLSTM recurrences (port of the mLSTM and sLSTM parts of
``repro.core.recurrence``): the PackMamba boundary rule, the recurrence's
multiplicative term forced to zero at ``positions == 0``, on both.

* mLSTM keeps a matrix state C (dk×dv) per head with a *scalar* per-head
  decay. ``mlstm`` is the chunkwise-parallel form (inter-chunk state +
  intra-chunk masked decay matrix), stabilised by the max-plus recurrence
  m_t = max(f̃_t + m_{t-1}, ĩ_t). ``mlstm_step`` is one decode token.
* sLSTM is inherently sequential (h_{t-1} feeds the gate preactivations
  through recurrent weights): ``slstm`` loops over time, zeroing (h, c, n)
  and resetting m at segment starts. The JAX package runs it in a
  ``lax.scan`` with no Pallas kernel; this is its plain counterpart.

A reset is encoded as the JAX package encodes it, ``logf = -1e30``. The
JAX stabiliser is an associative scan; here ``m`` is computed segment by
segment instead (``_maxplus``: a cumulative sum of log f from each segment
start, then a segmented running maximum), since a running sum over the
whole row would carry the −1e30 of every earlier reset and swallow the
terms after it. Where gradients are taken, the running sums (the
stabiliser's and each chunk's cumulative decays) are segment by segment
too (``_seg_scan``): then no gradient crosses a reset, exactly, where a
running sum over the row or the chunk, differenced, leaves the rounding
of two cancelling sums in the earlier segment's gradient. Without
gradients (serving, the dry run's prefill) they stay one ``cumsum`` each,
a launch or two in place of 3·log2(L): the same sums to f32 rounding.
Every clip of the JAX code is
kept as it is. Their subgradients differ (torch.clamp passes the
gradient at a bound, jnp.clip splits a tie), but that moves a gradient by
under 1e-5 of its scale, where the port's and the JAX package's gradients
differ by ~1e-4: f32 rounding, which the mLSTM normaliser's
near-cancellation amplifies (tests/test_torch_xlstm_train.py measures
both).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


def _segment_starts(reset: Optional[torch.Tensor], B: int, L: int, device):
    """(B, L) index of the first step of each step's segment: the last
    reset at or before t, 0 when there is none."""
    t = torch.arange(L, device=device).expand(B, L)
    if reset is None:
        return torch.zeros((B, L), dtype=torch.long, device=device)
    return torch.cummax(torch.where(reset, t, 0), dim=1).values


def _seg_scan(v: torch.Tensor, start: torch.Tensor, op) -> torch.Tensor:
    """Inclusive running ``op`` (``torch.maximum`` or ``torch.add``) of v
    (B, L, H) along L that restarts at each segment (``start`` (B, L), the
    first step of each step's segment): log2(L) shifted steps
    (Hillis–Steele), each taken only where the earlier step lies in the
    same segment. A maximum rounds nothing. Nothing reaches a step from
    another segment, in the backward either: its gradient there is exactly
    0, where a running sum over the row, differenced, would leave the
    rounding of two cancelling sums."""
    L = v.shape[1]
    t = torch.arange(L, device=v.device)
    d = 1
    while d < L:
        ok = (t[d:] - d >= start[:, d:])[..., None]           # (B, L-d, 1)
        tail = torch.where(ok, op(v[:, d:], v[:, :-d]), v[:, d:])
        v = torch.cat([v[:, :d], tail], dim=1)
        d *= 2
    return v


def _maxplus(logf, logi, reset, m_in0=None):
    """m_t = max(logf_t + m_{t-1}, logi_t), restarting at each reset, with
    m_{-1} = ``m_in0`` (B, H) for the first segment (−inf when None).
    logf, logi (B, L, H) f32, logf = −1e30 at resets. Within a segment,
    with G_t = Σ logf over (start, t], m_t = G_t + max_{s≤t}(logi_s − G_s);
    the carried m enters the first segment as Σ_{0..t} logf + m_in0."""
    B, L, _ = logf.shape
    start = _segment_starts(reset, B, L, logf.device)
    lf = logf if reset is None else torch.where(reset[..., None], 0.0, logf)
    first = (start == 0)
    if torch.is_grad_enabled():
        S = _seg_scan(lf, start, torch.add)        # Σ lf over [start, t]
        G = S - torch.where(first[..., None], lf[:, :1], 0.0)
    else:                    # S is read only in the first segment
        S = torch.cumsum(lf, dim=1)
        G = S - torch.gather(S, 1, start[..., None].expand_as(S))
    m = G + _seg_scan(logi - G, start, torch.maximum)
    if m_in0 is not None:
        if reset is not None:
            first = first & ~reset[:, :1]
        m = torch.where(first[..., None],
                        torch.maximum(S + m_in0[:, None], m), m)
    return m


def mlstm(q, k, v, logf, logi, positions: Optional[torch.Tensor] = None,
          chunk: int = 256, state: Optional[Tuple] = None,
          return_state: bool = False):
    """Chunked mLSTM. q, k (B, L, H, dk); v (B, L, H, dv); logf, logi
    (B, L, H): the log forget gate (≤ 0 for a sigmoid gate) and the log
    input gate. ``state`` (C (B, H, dk, dv), n (B, H, dk), m (B, H)) is
    carried in (a resumed prompt); padding to a multiple of ``chunk`` is
    by identity steps (f' = 1, i' = 0), so the returned state is the one
    after step L-1. Returns h̃ (B, L, H, dv) in v's dtype [, (C, n, m)]."""
    B, L, H, dk = k.shape
    dv = v.shape[-1]
    dev, out_dtype = k.device, v.dtype
    logf = logf.float()
    logi = logi.float()
    reset = (positions == 0) if positions is not None else None
    if reset is not None:
        logf = torch.where(reset[..., None], NEG, logf)

    # global stabiliser (a scalar state per (B, H))
    if state is not None:
        C_in, n_in, m_in0 = (s.float() for s in state)
        m = _maxplus(logf, logi, reset, m_in0)
    else:
        C_in = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=dev)
        n_in = torch.zeros((B, H, dk), dtype=torch.float32, device=dev)
        m_in0 = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
        m = _maxplus(logf, logi, reset)
    m = torch.clamp(m, min=NEG)                       # keep finite

    # stabilised per-step gates
    m_prev = torch.cat([m_in0[:, None], m[:, :-1]], dim=1)
    logfp = torch.clamp(logf + m_prev - m, -60.0, 0.0)   # log f' ≤ 0
    logip = torch.clamp(logi - m, -60.0, 30.0)           # log i'
    ip = torch.exp(logip)

    # chunking: identity steps pad L to a multiple of the chunk
    pad = (-L) % chunk
    q = q.float() * dk ** -0.5                  # fold the 1/√dk into q
    k, v = k.float(), v.float()
    if reset is None:
        reset = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if pad:
        def padc(t):
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        q, k, v, logfp, ip = map(padc, (q, k, v, logfp, ip))
        reset = F.pad(reset, (0, pad))
    Lp = L + pad
    cumFs = None
    if torch.is_grad_enabled():
        # Σ log f' from the later of the step's segment start and its
        # chunk's start, per step: a chunk's cumulative decays, with no
        # gradient across a reset
        t = torch.arange(Lp, device=dev)
        cstart = torch.maximum(_segment_starts(reset, B, Lp, dev),
                               t - t % chunk)
        cumFs = _seg_scan(logfp, cstart, torch.add)
    tri = torch.arange(chunk, device=dev)
    tri = tri[:, None] >= tri[None]                        # (t, s): s ≤ t
    ys, ns = [], []
    for c0 in range(0, Lp, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, ib, rb = (q[:, sl], k[:, sl], v[:, sl], ip[:, sl],
                              reset[:, sl])
        # from the chunk's start where no gradient is taken: the same
        # differences within a segment
        cumF = torch.cumsum(logfp[:, sl], dim=1) if cumFs is None \
            else cumFs[:, sl]
        # intra-chunk segment id: the carry is valid until the first reset
        seg = torch.cumsum(rb.to(torch.int32), dim=1)
        Pt = torch.exp(cumF) * (seg == 0)[..., None]       # decay from entry
        # D[t, s] = exp(cumF_t − cumF_s) for s ≤ t in one segment, else 0;
        # the clamp keeps a masked entry from overflowing to inf·0 = NaN
        diff = cumF[:, :, None] - cumF[:, None]            # (B, t, s, H)
        ok = (seg[:, :, None] == seg[:, None]) & tri
        D = torch.exp(torch.clamp(diff, max=0.0)) * ok[..., None]
        w = torch.einsum("bthd,bshd->btsh", qb, kb) * D * ib[:, None]
        y_intra = torch.einsum("btsh,bshd->bthd", w, vb)
        # the normaliser accumulates k without q: n_t = Σ_s D[t,s]·i'_s·k_s
        n_intra = torch.einsum("btsh,bshd->bthd", D * ib[:, None], kb)
        y_carry = torch.einsum("bthd,bhde->bthe", qb, C_in) * Pt[..., None]
        n_carry = torch.einsum("bhd,bth->bthd", n_in, Pt)
        ys.append(y_intra + y_carry)
        ns.append(n_intra + n_carry)
        # the state at the chunk's end
        PT = Pt[:, -1]                                     # (B, H)
        decay_to_end = torch.exp(torch.clamp(cumF[:, -1:] - cumF, max=0.0)) \
            * (seg == seg[:, -1:])[..., None]              # (B, chunk, H)
        wk = decay_to_end * ib
        C_in = C_in * PT[..., None, None] + torch.einsum(
            "bthd,bthe->bhde", kb * wk[..., None], vb)
        n_in = n_in * PT[..., None] + torch.einsum("bthd,bth->bhd", kb, wk)
    y = torch.cat(ys, dim=1)[:, :L]
    n = torch.cat(ns, dim=1)[:, :L]
    qn = torch.einsum("blhd,blhd->blh", n, q[:, :L])
    den = torch.maximum(qn.abs(), torch.exp(-torch.clamp(m, -30.0, 30.0)))
    out = (y / torch.clamp(den, min=1e-20)[..., None]).to(out_dtype)
    if return_state:
        return out, (C_in, n_in, m[:, -1])
    return out


def mlstm_step(state: Tuple, q_t, k_t, v_t, logf_t, logi_t,
               reset_t: Optional[torch.Tensor] = None):
    """One decode token. state = (C (B, H, dk, dv), n (B, H, dk), m (B, H));
    q_t, k_t (B, H, dk); v_t (B, H, dv); gates (B, H). Returns (y_t (B, H,
    dv) in v_t's dtype, the new state)."""
    C, n, m = state
    logf_t = logf_t.float()
    logi_t = logi_t.float()
    if reset_t is not None:
        logf_t = torch.where(reset_t[:, None], NEG, logf_t)
    m_new = torch.maximum(logf_t + m, logi_t)
    fp = torch.exp(torch.clamp(logf_t + m - m_new, -60.0, 0.0))
    ip = torch.exp(torch.clamp(logi_t - m_new, -60.0, 30.0))
    kf, vf = k_t.float(), v_t.float()
    C_new = C * fp[..., None, None] + ip[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", kf, vf)
    n_new = n * fp[..., None] + ip[..., None] * kf
    qs = q_t.float() * k_t.shape[-1] ** -0.5
    y = torch.einsum("bhd,bhde->bhe", qs, C_new)
    qn = torch.einsum("bhd,bhd->bh", n_new, qs)
    den = torch.maximum(qn.abs(), torch.exp(-torch.clamp(m_new, -30.0, 30.0)))
    y = (y / torch.clamp(den, min=1e-20)[..., None]).to(v_t.dtype)
    return y, (C_new, n_new, m_new)


def slstm(x_preact, R, positions: Optional[torch.Tensor] = None,
          state: Optional[Tuple] = None, return_state: bool = False,
          valid: Optional[torch.Tensor] = None):
    """Sequential sLSTM. x_preact (B, L, 4, H, dh): the input-driven
    preactivations of the gates (i, f, z, o); R (4, H, dh, dh): per-head
    recurrent weights applied to h_{t-1}. A Python loop over time (about
    thirty small ops a step): a reset zeroes (c, n, h) and sets m to −1e30
    at a segment start; ``valid`` (B, L) freezes the state across invalid
    (padding) steps. ``state`` = (c, n, m, h), each (B, H, dh). Returns
    h (B, L, H, dh) in x_preact's dtype [, the final (c, n, m, h)]."""
    B, L, _, H, dh = x_preact.shape
    dev = x_preact.device
    if state is None:
        z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
        state = (z0, z0, torch.full((B, H, dh), NEG, dtype=torch.float32,
                                    device=dev), z0)
    c, n, m, h = (s.float() for s in state)
    xp = x_preact.float()
    R = R.float()
    reset = (positions == 0) if positions is not None else \
        torch.zeros((B, L), dtype=torch.bool, device=dev)
    ok = valid if valid is not None else \
        torch.ones((B, L), dtype=torch.bool, device=dev)
    keep = (~reset).float()[..., None, None]                  # (B, L, 1, 1)
    rm = reset[..., None, None]
    vm = ok[..., None, None]
    hs = []
    for t in range(L):
        c1, n1, h1 = c * keep[:, t], n * keep[:, t], h * keep[:, t]
        m1 = torch.where(rm[:, t], NEG, m)
        rec = torch.einsum("bhd,ghde->bghe", h1, R)          # (B, 4, H, dh)
        pre = xp[:, t] + rec
        it, ft, zt, ot = pre.unbind(1)
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m1, it)
        fp = torch.exp(torch.clamp(logf + m1 - m_new, -60.0, 0.0))
        ip = torch.exp(torch.clamp(it - m_new, -60.0, 30.0))
        c_new = fp * c1 + ip * torch.tanh(zt)
        n_new = fp * n1 + ip
        h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
        v_t = vm[:, t]
        c = torch.where(v_t, c_new, c)
        n = torch.where(v_t, n_new, n)
        m = torch.where(v_t, m_new, m)
        h = torch.where(v_t, h_new, h)
        hs.append(h_new)
    y = torch.stack(hs, dim=1).to(x_preact.dtype)
    if return_state:
        return y, (c, n, m, h)
    return y
