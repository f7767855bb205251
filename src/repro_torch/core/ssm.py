"""Selective scans with PackMamba segment resets (port of
``repro.core.ssm``): the Mamba-1 per-channel case (``selective_scan``) and
the Mamba-2/SSD head-structured case (``selective_scan_heads``).

Mamba-1 (per channel d, state n):

    Ā[b,l,d,n]  = exp(Δ[b,l,d] · A[d,n])
    B̄x[b,l,d,n] = Δ[b,l,d] · B[b,l,n] · u[b,l,d]
    h_t = Ā_t · h_{t-1} + B̄x_t ;   y[b,l,d] = Σ_n C[b,l,n] · h[b,l,d,n] + D[d] · u[b,l,d]

with Ā→0 wherever ``positions == 0`` (paper §3.4).

Serving handoff (``collect_ends``): resets make the state at a segment's
last token that segment's final state, so the per-segment finals are the
trajectory sampled at ``collect_ends`` (B, S) (−1 = absent → zeros). The
blocked schedule samples them from the in-chunk states it already holds.

Methods (the JAX package's five):
  * ``sequential``, ``chunked``, ``associative`` — build the full
    (B, L, D, N) decay and input trajectories and run ``core/scan.py``'s
    schedule of that name over them (``chunked``: chunks of T, the doubling
    tree inside each; ``associative``: one tree over L, for short L);
  * ``fused_seq`` — one walk over time with y = C·h folded in, so the
    (B, L, D, N) trajectory never exists;
  * ``blocked`` — chunks of T, only the (B, D, N) state carried across
    chunks; ``intra`` evaluates a chunk either as a log₂T doubling tree of
    the combine step, ``assoc``, or as the masked decay contraction,
    ``matmul``, capped at T = 32. Under autograd each chunk is checkpointed
    (recomputed in the backward), as the JAX package's ``jax.checkpoint``
    does, so the backward keeps only the chunk-entry states.

``tune=`` ("auto", a cache path or a ``TuneCache``) resolves (method,
chunk, intra) from the shape-keyed tuning cache (``repro_torch.tune``);
a miss, or a winner that is one of the kernels, leaves the explicit
arguments as they are.

Mamba-2 (``selective_scan_heads``): u (B, L, H, dh), a SCALAR decay per
head, exp(Δ[b,l,h]·A[h]), and B, C (B, L, N) shared by every head, so the
state is (B, H, dh, N). Methods ``sequential`` and ``blocked`` (per chunk
one (T, T) masked decay matrix per head; ``intra`` ``quad``, the state
form, or ``dual``, the C·Bᵀ attention-like form).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.scan import (associative_pairs, gather_state_ends,
                                   scan_step, segmented_scan)

_MATMUL_CHUNK_CAP = 32    # blocked/matmul intra: bounds the T²·D·N operand
_HEADS_CHUNK_CAP = 64     # blocked heads (quad): bounds the (T, T, H) decay
#   matrix and the T× FLOP multiplier of the single-contraction step
_HEADS_DUAL_CHUNK_CAP = 128  # dual form: the T² term is only (dh + N) wide


def _dtype(dt: Union[None, str, torch.dtype], like: torch.dtype) -> torch.dtype:
    if dt is None:
        return torch.promote_types(like, torch.float32)
    return getattr(torch, dt) if isinstance(dt, str) else dt


def _tuned_knobs(op, tune, *, B, L, D=0, N=0, H=0, dh=0, dtype, positions,
                 device, objective="fwd"):
    """The measured plain-path knobs for one call site, or {} on a miss.

    ``tune``: "auto" (the process-default cache), a cache path or a
    ``TuneCache``; ``objective``: which sweep's winner ("fwd" | "fwdbwd");
    ``device``: the operands' (entries timed on another device miss).
    A winner that is one of the kernels (``backend`` "pallas") is ignored at
    this level: ``kernels/ops.py`` resolves those."""
    from repro_torch.tune import tuned   # lazy: the tuner imports this module
    kn = tuned(op, cache=None if tune == "auto" else tune,
               B=B, L=L, D=D, N=N, H=H, dh=dh, dtype=dtype,
               reset_density=None if positions is not None else 0.0,
               objective=objective, device=device)
    if not kn or kn.get("backend", "xla") != "xla":
        return {}
    return kn


def _pack_out(y, h_last, h_ends, return_state, collect_ends):
    out = (y,)
    if return_state:
        out += (h_last,)
    if collect_ends is not None:
        out += (h_ends,)
    return out[0] if len(out) == 1 else out


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   h0: Optional[torch.Tensor] = None,
                   method: str = "blocked", chunk: int = 256,
                   return_state: bool = False,
                   compute_dtype=None, intra: Optional[str] = None,
                   collect_ends: Optional[torch.Tensor] = None,
                   tune=None, tune_objective: str = "fwd"):
    """u, delta: (B, L, D); A: (D, N); B, C: (B, L, N); D: (D,).

    positions: (B, L) int (reset where == 0); h0: (B, D, N) initial state;
    method: 'blocked' | 'chunked' | 'fused_seq' | 'sequential' |
    'associative' (module docstring); compute_dtype: recurrence dtype
    (default f32); intra: blocked in-chunk evaluator ('assoc', the default,
    | 'matmul'); collect_ends: (B, S) segment-end indices; tune: None (off)
    | "auto" | cache path | TuneCache, the explicit arguments being the
    miss fallback. Returns y (B, L, D) [, h_last (B, D, N)]
    [, h_ends (B, S, D, N)].
    """
    if tune is not None:
        kn = _tuned_knobs("selective_scan", tune, B=u.shape[0], L=u.shape[1],
                          D=u.shape[2], N=A.shape[-1], dtype=u.dtype,
                          positions=positions, device=u.device,
                          objective=tune_objective)
        method = kn.get("method", method)
        chunk = kn.get("chunk", chunk)
        intra = kn.get("intra", intra)
    cdt = _dtype(compute_dtype, u.dtype)
    if method == "blocked":
        y, h_last, h_ends = _blocked_ssm(u, delta, A, B, C, D, positions, h0,
                                         cdt, chunk, intra, collect_ends)
    elif method == "fused_seq":
        y, h_last, h_ends = _fused_seq_ssm(u, delta, A, B, C, D, positions,
                                           h0, cdt, collect_ends)
    elif method in ("sequential", "chunked", "associative"):
        y, h_last, h_ends = _trajectory_ssm(u, delta, A, B, C, D, positions,
                                            h0, cdt, collect_ends, method,
                                            chunk)
    else:
        raise ValueError(f"unknown scan method {method!r}")
    return _pack_out(y, h_last, h_ends, return_state, collect_ends)


def _trajectory_ssm(u, delta, A, B, C, D, positions, h0, cdt, collect_ends,
                    method, chunk):
    """The (B, L, D, N) trajectories through ``segmented_scan``'s
    ``method``, then y = C·h and the segment-end samples."""
    d32 = delta.to(cdt)
    a = torch.exp(d32[..., None] * A.to(cdt))                      # (B,L,D,N)
    bterm = (d32 * u.to(cdt))[..., None] * B.to(cdt)[:, :, None, :]
    reset = (positions == 0) if positions is not None else None
    h, h_last = segmented_scan(a, bterm, reset=reset,
                               h0=None if h0 is None else h0.to(cdt),
                               method=method, chunk=chunk)
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
    acc = None
    if collect:
        acc = torch.zeros((Bsz, collect_ends.shape[1], Dm, N), dtype=cdt,
                          device=dev)
        rows = torch.arange(Bsz, device=dev)[:, None]

    def chunk_step(h, acc, ci):
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
        return hc[:, -1], acc, torch.einsum("bidn,bin->bid", hc,
                                            C[:, sl].to(cdt))

    if torch.is_grad_enabled():
        # the backward recomputes each chunk from its entry state, so it
        # keeps no (B, T, D, N) intermediate of any chunk
        step = lambda h, acc, ci: checkpoint(chunk_step, h, acc, ci,
                                             use_reentrant=False)
    else:
        step = chunk_step
    ys = []
    for ci in range(nc):
        h, acc, y = step(h, acc, ci)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    if D is not None:
        y = y + D.to(cdt) * u[:, :L].to(cdt)
    return y.to(u.dtype), h, (acc if collect else None)


def _fused_seq_ssm(u, delta, A, B, C, D, positions, h0, cdt,
                   collect_ends=None):
    """One walk over time with y = C·h folded in: only the (B, D, N) state
    is live, the (B, L, D, N) trajectory never exists."""
    Bsz, L, Dm = u.shape
    N = A.shape[-1]
    A32 = A.to(cdt)
    d32 = delta.to(cdt)
    du = d32 * u.to(cdt)                                           # (B,L,D)
    B32, C32 = B.to(cdt), C.to(cdt)
    h = torch.zeros((Bsz, Dm, N), dtype=cdt, device=u.device) if h0 is None \
        else h0.to(cdt)
    collect = collect_ends is not None
    if collect:
        acc = torch.zeros((Bsz, collect_ends.shape[1], Dm, N), dtype=cdt,
                          device=u.device)
    ys = []
    for t in range(L):
        a_t = torch.exp(d32[:, t, :, None] * A32)                  # (B,D,N)
        if positions is not None:
            a_t = torch.where((positions[:, t] == 0)[:, None, None], 0.0,
                              a_t)
        h = a_t * h + du[:, t, :, None] * B32[:, t, None, :]
        if collect:
            acc = acc + torch.where((collect_ends == t)[..., None, None],
                                    h[:, None], 0.0)
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.to(cdt) * u.to(cdt)
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


# ---------------------------------------------------------------------------
# head-structured (scalar per-head decay) scans — Mamba-2 / SSD
# ---------------------------------------------------------------------------

def selective_scan_heads(u: torch.Tensor, delta: torch.Tensor,
                         A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         D: Optional[torch.Tensor] = None,
                         positions: Optional[torch.Tensor] = None,
                         h0: Optional[torch.Tensor] = None,
                         method: str = "blocked", chunk: int = 64,
                         return_state: bool = False,
                         compute_dtype=None, intra: Optional[str] = None,
                         collect_ends: Optional[torch.Tensor] = None,
                         tune=None, tune_objective: str = "fwd"):
    """u: (B, L, H, dh); delta: (B, L, H); A: (H,), the Mamba-2 scalar
    decay per head; B, C: (B, L, N); D: (H,); positions: (B, L) int (reset
    where == 0); h0: (B, H, dh, N); collect_ends: (B, S) segment-end
    indices (−1 = absent). ``method`` 'blocked' (``intra`` 'quad'
    (default) | 'dual') or 'sequential'; ``tune`` as in
    ``selective_scan``. (The JAX function also takes a per-channel A (H, N)
    with dh == 1; here that is ``selective_scan``.)

    Returns y (B, L, H, dh) [, h_last (B, H, dh, N)]
    [, h_ends (B, S, H, dh, N)]."""
    if A.dim() != 1:
        raise ValueError(f"selective_scan_heads takes a scalar decay per "
                         f"head, A (H,); got A{tuple(A.shape)}")
    if tune is not None:
        kn = _tuned_knobs("selective_scan_heads", tune, B=u.shape[0],
                          L=u.shape[1], N=B.shape[-1], H=u.shape[2],
                          dh=u.shape[3], dtype=u.dtype, positions=positions,
                          device=u.device, objective=tune_objective)
        method = kn.get("method", method)
        chunk = kn.get("chunk", chunk)
        intra = kn.get("intra", intra)
    cdt = _dtype(compute_dtype, u.dtype)
    if method == "blocked":
        y, h_last, h_ends = _blocked_ssm_heads(
            u, delta, A, B, C, D, positions, h0, cdt, chunk, collect_ends,
            intra)
    elif method == "sequential":
        y, h_last, h_ends = _seq_scan_heads(
            u, delta, A, B, C, D, positions, h0, cdt, collect_ends)
    else:
        raise ValueError(f"unknown scalar-decay scan method {method!r}")
    return _pack_out(y, h_last, h_ends, return_state, collect_ends)


def _heads_decay(d32, A32, rc, tril):
    """Per chunk: s = cumsum Δ·A (B, T, H); rid = resets ≤ i (B, T);
    dec[b,i,j,h] = exp(s_i − s_j)·[j ≤ i]·[no reset in (j, i]];
    cin[b,i,h] = exp(s_i)·[no reset ≤ i]."""
    s = torch.cumsum(d32 * A32, dim=1)
    rid = torch.cumsum(rc.int(), dim=1)
    m = ((rid[:, :, None] == rid[:, None, :]) & tril[None])[..., None]
    diff = s[:, :, None] - s[:, None, :]
    dec = torch.where(m, torch.exp(torch.where(m, diff, 0.0)), 0.0)
    cin = torch.where((rid == 0)[..., None], torch.exp(s), 0.0)
    return dec, cin


def _blocked_ssm_heads(u, delta, A, B, C, D, positions, h0, cdt, chunk,
                       collect_ends=None, intra=None):
    """Block-parallel schedule, scalar decay per head. Per chunk of T:

        quad:  h[i] = Σ_j dec[i,j]·(Δ·u ⊗ B)[j] + cin_i·h_in,  y = C·h
        dual:  G = dec ⊙ (C·Bᵀ),  y = G·(Δ·u) + cin·(C·h_in),
               h_out = Σ_j dec[T-1,j]·(Δ·u ⊗ B)[j] + cin_{T-1}·h_in

    Only the (B, H, dh, N) state crosses chunks; the (B, L, H, dh, N)
    trajectory never exists. ``collect_ends`` samples the in-chunk states
    (quad) or rebuilds them at the sampled rows only (dual)."""
    if intra not in (None, "quad", "dual"):
        raise ValueError(f"unknown heads blocked intra mode {intra!r}")
    Bsz, L, H, P = u.shape
    N = B.shape[-1]
    dev = u.device
    T = min(chunk, L, _HEADS_DUAL_CHUNK_CAP if intra == "dual"
            else _HEADS_CHUNK_CAP)
    A32 = A.to(cdt)
    reset = (positions == 0) if positions is not None else \
        torch.zeros((Bsz, L), dtype=torch.bool, device=dev)
    pad = (-L) % T
    if pad:
        # Δ=0 ⇒ decay 1 / b-term 0 (state carried), no reset: identity steps
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        delta, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (delta, B, C))
        reset = F.pad(reset, (0, pad))
    nc = u.shape[1] // T
    h = torch.zeros((Bsz, H, P, N), dtype=cdt, device=dev) if h0 is None \
        else h0.to(cdt)
    tril = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    collect = collect_ends is not None
    if collect:
        acc = torch.zeros((Bsz, collect_ends.shape[1], H, P, N), dtype=cdt,
                          device=dev)
        rows = torch.arange(Bsz, device=dev)[:, None]
    ys = []
    for ci in range(nc):
        sl = slice(ci * T, (ci + 1) * T)
        d32 = delta[:, sl].to(cdt)
        B32, C32 = B[:, sl].to(cdt), C[:, sl].to(cdt)
        du = d32[..., None] * u[:, sl].to(cdt)                   # (B,T,H,P)
        dec, cin = _heads_decay(d32, A32, reset[:, sl], tril)
        if collect:
            local = collect_ends.long() - ci * T                 # (B, S)
            ok = (local >= 0) & (local < T)
            lcl = local.clamp(0, T - 1)
        if intra == "dual":
            G = dec * torch.einsum("bin,bjn->bij", C32, B32)[..., None]
            y = torch.einsum("bijh,bjhp->bihp", G, du)
            y = y + cin[..., None] * torch.einsum("bhpn,bin->bihp", h, C32)
            if collect:
                sel = torch.einsum("bsjh,bjhp,bjn->bshpn", dec[rows, lcl],
                                   du, B32) + \
                    cin[rows, lcl][..., None, None] * h[:, None]
                acc = acc + torch.where(ok[..., None, None, None], sel, 0.0)
            h = torch.einsum("bjh,bjhp,bjn->bhpn", dec[:, -1], du, B32) + \
                cin[:, -1][..., None, None] * h
        else:
            bterm = du[..., None] * B32[:, :, None, None, :]     # (B,T,H,P,N)
            hc = torch.einsum("bijh,bjhpn->bihpn", dec, bterm)
            hc = hc + cin[..., None, None] * h[:, None]
            if collect:
                acc = acc + torch.where(ok[..., None, None, None],
                                        hc[rows, lcl], 0.0)
            y = torch.einsum("bihpn,bin->bihp", hc, C32)
            h = hc[:, -1]
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    if D is not None:
        y = y + D.to(cdt)[:, None] * u[:, :L].to(cdt)
    return y.to(u.dtype), h, (acc if collect else None)


def _seq_scan_heads(u, delta, A, B, C, D, positions, h0, cdt,
                    collect_ends=None):
    """Sequential per-head reference (y = C·h fused, scalar decay)."""
    Bsz, L, H, P = u.shape
    N = B.shape[-1]
    A32 = A.to(cdt)
    h = torch.zeros((Bsz, H, P, N), dtype=cdt, device=u.device) \
        if h0 is None else h0.to(cdt)
    collect = collect_ends is not None
    if collect:
        acc = torch.zeros((Bsz, collect_ends.shape[1], H, P, N), dtype=cdt,
                          device=u.device)
    ys = []
    for t in range(L):
        d32 = delta[:, t].to(cdt)                               # (B, H)
        a_t = torch.exp(d32 * A32)
        if positions is not None:
            a_t = torch.where((positions[:, t] == 0)[:, None], 0.0, a_t)
        b_t = (d32[..., None] * u[:, t].to(cdt))[..., None] * \
            B[:, t].to(cdt)[:, None, None, :]                   # (B,H,P,N)
        h = a_t[..., None, None] * h + b_t
        if collect:
            acc = acc + torch.where((collect_ends == t)[..., None, None,
                                                        None],
                                    h[:, None], 0.0)
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t].to(cdt)))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.to(cdt)[:, None] * u.to(cdt)
    return y.to(u.dtype), h, (acc if collect else None)


def selective_scan_heads_step(h: torch.Tensor, u_t: torch.Tensor,
                              delta_t: torch.Tensor, A: torch.Tensor,
                              B_t: torch.Tensor, C_t: torch.Tensor,
                              D: Optional[torch.Tensor] = None,
                              reset_t: Optional[torch.Tensor] = None):
    """One head-structured decode step. h: (B, H, dh, N); u_t: (B, H, dh);
    delta_t: (B, H); A: (H,); B_t, C_t: (B, N); D: (H,); reset_t: (B,)
    bool. Returns (y_t (B, H, dh) in u_t's dtype, h_new in h's dtype)."""
    cdt = h.dtype
    d32 = delta_t.to(cdt)
    a_t = torch.exp(d32 * A.to(cdt))[..., None, None].expand(h.shape)
    b_t = (d32[..., None] * u_t.to(cdt))[..., None] * \
        B_t.to(cdt)[:, None, None, :]
    h_new = scan_step(h, a_t, b_t, reset_t)
    y_t = torch.einsum("bhpn,bn->bhp", h_new, C_t.to(cdt))
    if D is not None:
        y_t = y_t + D.to(cdt)[:, None] * u_t.to(cdt)
    return y_t.to(u_t.dtype), h_new
