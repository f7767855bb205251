"""Mamba-1 selective scan with PackMamba segment resets (port of
``repro.core.ssm``, per-channel case).

    Ā[b,l,d,n]  = exp(Δ[b,l,d] · A[d,n])
    B̄x[b,l,d,n] = Δ[b,l,d] · B[b,l,n] · u[b,l,d]
    h_t = Ā_t · h_{t-1} + B̄x_t ;   y[b,l,d] = Σ_n C[b,l,n] · h[b,l,d,n] + D[d] · u[b,l,d]

with Ā→0 wherever ``positions == 0`` (paper §3.4).

Serving handoff (``collect_ends``): resets make the state at a segment's
last token that segment's final state, so the per-segment finals are the
trajectory sampled at ``collect_ends`` (B, S) (−1 = absent → zeros). The
blocked schedule samples them from the in-chunk states it already holds.

Methods: ``sequential`` (reference walk over the full (B, L, D, N)
trajectory) and ``blocked`` (chunks of T, only the (B, D, N) state carried
across chunks; ``intra`` evaluates a chunk either as a log₂T doubling tree
of the combine step, ``assoc``, or as the masked decay contraction,
``matmul``, capped at T = 32). Mamba-2 heads wait for a later slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.scan import (associative_pairs, gather_state_ends,
                                   scan_sequential, scan_step)

_MATMUL_CHUNK_CAP = 32    # blocked/matmul intra: bounds the T²·D·N operand


def _dtype(dt: Union[None, str, torch.dtype], like: torch.dtype) -> torch.dtype:
    if dt is None:
        return torch.promote_types(like, torch.float32)
    return getattr(torch, dt) if isinstance(dt, str) else dt


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   h0: Optional[torch.Tensor] = None,
                   method: str = "blocked", chunk: int = 256,
                   return_state: bool = False,
                   compute_dtype=None, intra: Optional[str] = None,
                   collect_ends: Optional[torch.Tensor] = None):
    """u, delta: (B, L, D); A: (D, N); B, C: (B, L, N); D: (D,).

    positions: (B, L) int (reset where == 0); h0: (B, D, N) initial state;
    compute_dtype: recurrence dtype (default f32); intra: blocked in-chunk
    evaluator ('assoc', the default, | 'matmul'); collect_ends: (B, S)
    segment-end indices. Returns y (B, L, D) [, h_last (B, D, N)]
    [, h_ends (B, S, D, N)].
    """
    cdt = _dtype(compute_dtype, u.dtype)
    if method == "blocked":
        y, h_last, h_ends = _blocked_ssm(u, delta, A, B, C, D, positions, h0,
                                         cdt, chunk, intra, collect_ends)
    elif method == "sequential":
        y, h_last, h_ends = _sequential_ssm(u, delta, A, B, C, D, positions,
                                            h0, cdt, collect_ends)
    else:
        raise ValueError(f"unknown scan method {method!r}; the port has "
                         f"'blocked' and 'sequential'")
    out = (y,)
    if return_state:
        out += (h_last,)
    if collect_ends is not None:
        out += (h_ends,)
    return out[0] if len(out) == 1 else out


def _sequential_ssm(u, delta, A, B, C, D, positions, h0, cdt, collect_ends):
    d32 = delta.to(cdt)
    a = torch.exp(d32[..., None] * A.to(cdt))                      # (B,L,D,N)
    bterm = (d32 * u.to(cdt))[..., None] * B.to(cdt)[:, :, None, :]
    reset = (positions == 0) if positions is not None else None
    h, h_last = scan_sequential(a, bterm, reset=reset,
                                h0=None if h0 is None else h0.to(cdt))
    y = torch.einsum("bldn,bln->bld", h, C.to(cdt))
    if D is not None:
        y = y + D.to(cdt) * u.to(cdt)
    h_ends = gather_state_ends(h, collect_ends) \
        if collect_ends is not None else None
    return y.to(u.dtype), h_last, h_ends


def _blocked_ssm(u, delta, A, B, C, D, positions, h0, cdt, chunk,
                 intra=None, collect_ends=None):
    """Block-parallel schedule: per chunk of length T

        M[i,j] = Π_{j<k≤i} Ā_k = exp(s_i − s_j), masked to j ≤ i and no
                 reset in (j, i]   (s = in-chunk cumsum of Δ·A)
        h_i    = Σ_j M[i,j]·(Δ·B·u)_j + 1[no reset ≤ i]·exp(s_i)·h_in

    and only the (B, D, N) state crosses chunk boundaries."""
    intra = "assoc" if intra is None else intra
    if intra not in ("matmul", "assoc"):
        raise ValueError(f"unknown blocked intra mode {intra!r}")
    Bsz, L, Dm = u.shape
    N = A.shape[-1]
    dev = u.device
    T = min(chunk, L)
    if intra == "matmul":
        T = min(T, _MATMUL_CHUNK_CAP)
    A32 = A.to(cdt)
    reset = (positions == 0) if positions is not None else \
        torch.zeros((Bsz, L), dtype=torch.bool, device=dev)
    pad = (-L) % T
    if pad:
        # Δ=0 ⇒ decay 1 / b-term 0 (state carried), no reset: identity steps
        u, delta, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (u, delta, B, C))
        reset = F.pad(reset, (0, pad))
    nc = u.shape[1] // T
    h = torch.zeros((Bsz, Dm, N), dtype=cdt, device=dev) if h0 is None \
        else h0.to(cdt)
    tril = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    collect = collect_ends is not None
    if collect:
        acc = torch.zeros((Bsz, collect_ends.shape[1], Dm, N), dtype=cdt,
                          device=dev)
        rows = torch.arange(Bsz, device=dev)[:, None]
    ys = []
    for ci in range(nc):
        sl = slice(ci * T, (ci + 1) * T)
        d32 = delta[:, sl].to(cdt)
        rc = reset[:, sl]
        bterm = (d32 * u[:, sl].to(cdt))[..., None] * \
            B[:, sl].to(cdt)[:, :, None, :]                        # (B,T,D,N)
        if intra == "matmul":
            s = torch.cumsum(d32[..., None] * A32, dim=1)          # log decay
            rid = torch.cumsum(rc.int(), dim=1)                    # resets ≤ i
            m = (rid[:, :, None] == rid[:, None, :]) & tril[None]  # (B,T,T)
            mm = m[..., None, None]
            diff = s[:, :, None] - s[:, None, :]                   # (B,T,T,D,N)
            dec = torch.where(mm, torch.exp(torch.where(mm, diff, 0.0)), 0.0)
            hc = torch.einsum("bijdn,bjdn->bidn", dec, bterm)
            cin = torch.where((rid == 0)[..., None, None], torch.exp(s), 0.0)
            hc = hc + cin * h[:, None]
        else:
            a = torch.exp(d32[..., None] * A32)
            a = torch.where(rc[..., None, None], 0.0, a)           # reset
            Acum, Bcum = associative_pairs(a, bterm)
            hc = Acum * h[:, None] + Bcum
        if collect:
            local = collect_ends.long() - ci * T                   # (B, S)
            ok = (local >= 0) & (local < T)
            sel = hc[rows, local.clamp(0, T - 1)]                  # (B,S,D,N)
            acc = acc + torch.where(ok[..., None, None], sel, 0.0)
        ys.append(torch.einsum("bidn,bin->bid", hc, C[:, sl].to(cdt)))
        h = hc[:, -1]
    y = torch.cat(ys, dim=1)[:, :L]
    if D is not None:
        y = y + D.to(cdt) * u[:, :L].to(cdt)
    return y.to(u.dtype), h, (acc if collect else None)


def selective_scan_step(h: torch.Tensor, u_t: torch.Tensor,
                        delta_t: torch.Tensor, A: torch.Tensor,
                        B_t: torch.Tensor, C_t: torch.Tensor,
                        D: Optional[torch.Tensor] = None,
                        reset_t: Optional[torch.Tensor] = None):
    """One Mamba-1 decode step. h: (B, D, N); u_t, delta_t: (B, D);
    B_t, C_t: (B, N); reset_t: (B,) bool. Returns (y_t (B, D) in u_t's
    dtype, h_new (B, D, N) in h's dtype)."""
    cdt = h.dtype
    d32 = delta_t.to(cdt)
    a_t = torch.exp(d32[..., None] * A.to(cdt))
    b_t = (d32 * u_t.to(cdt))[..., None] * B_t.to(cdt)[:, None, :]
    h_new = scan_step(h, a_t, b_t, reset_t)
    y_t = torch.einsum("bdn,bn->bd", h_new, C_t.to(cdt))
    if D is not None:
        y_t = y_t + D.to(cdt) * u_t.to(cdt)
    return y_t.to(u_t.dtype), h_new
