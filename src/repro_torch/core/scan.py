"""Generic segmented diagonal linear recurrence (port of ``repro.core.scan``).

    h_t = a_t ⊙ h_{t-1} + b_t

with the PackMamba reset rule: wherever ``reset[t]`` is set (a packed
sequence start, ``positions == 0``), ``a_t → 0`` so no state crosses the
boundary. The combine operator

    (a₁, b₁) ⊕ (a₂, b₂) = (a₂·a₁, a₂·b₁ + b₂)

is associative, and a zero ``a`` kills every composite product that spans
it, so the rule holds for any schedule (``segmented_scan``'s ``method``):

  * ``sequential``  — a walk over time; the reference.
  * ``associative`` — one log₂L doubling tree (``associative_pairs``) over
    the whole L; materializes (B, L, *S) per level, for short L.
  * ``chunked``     — a walk over L/T chunks carrying h, the doubling tree
    inside each chunk (the tree the blocked selective scan also uses).
  * ``blocked``     — per chunk the closed form h = M·b + cp·h_in with
    M[i,j] = Π_{j<k≤i} a_k, built by a cumprod; matmul-shaped, T× the
    operations.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _bcast_reset(reset: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B, L) reset mask to the rank of ``like`` ((B, L, *S))."""
    return reset.reshape(reset.shape + (1,) * (like.dim() - reset.dim()))


def apply_reset(a: torch.Tensor, reset: Optional[torch.Tensor]) -> torch.Tensor:
    """PackMamba boundary rule: Ā→0 at sequence starts."""
    if reset is None:
        return a
    return torch.where(_bcast_reset(reset, a), torch.zeros_like(a), a)


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a2 * a1, a2 * b1 + b2


def associative_pairs(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` along dim 1 by log₂L doubling steps
    (Hillis–Steele): after the step of offset ``s`` position ``t`` holds
    the composite of steps (t-2s, t]. Returns (A_cum, B_cum), the
    composites of steps [0..t]."""
    L = a.shape[1]
    s = 1
    while s < L:
        a_new, b_new = _combine((a[:, :L - s], b[:, :L - s]),
                                (a[:, s:], b[:, s:]))
        a = torch.cat([a[:, :s], a_new], dim=1)
        b = torch.cat([b[:, :s], b_new], dim=1)
        s *= 2
    return a, b


def scan_sequential(a: torch.Tensor, b: torch.Tensor,
                    reset: Optional[torch.Tensor] = None,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time axis = 1. Returns (h_all (B, L, *S), h_last (B, *S))."""
    a = apply_reset(a, reset)
    h = torch.zeros(a.shape[:1] + a.shape[2:], dtype=a.dtype,
                    device=a.device) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def scan_associative(a: torch.Tensor, b: torch.Tensor,
                     reset: Optional[torch.Tensor] = None,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One doubling tree over the whole L; ``h0`` folds in as an extra
    b-term on step 0."""
    a = apply_reset(a, reset)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = associative_pairs(a, b)
    return h, h[:, -1]


def _chunk_scan(a, b, h0, chunk, chunk_body):
    """Shared scaffold of the chunk-carried schedules: pad L to a multiple
    of the chunk with identity steps (a=1, b=0 carry h unchanged), run
    ``chunk_body(h_in, ac, bc) -> h_chunk`` (B, T, *S) over the chunks in
    order, carrying each chunk's last state, and stitch the result back to
    (B, L, *S)."""
    Bsz, L = a.shape[0], a.shape[1]
    T = min(chunk, L)
    pad = (-L) % T
    if pad:
        widths = (0, 0) * (a.dim() - 2) + (0, pad)
        a = F.pad(a, widths, value=1.0)
        b = F.pad(b, widths)
    h = torch.zeros((Bsz,) + a.shape[2:], dtype=a.dtype, device=a.device) \
        if h0 is None else h0
    hs = []
    for c0 in range(0, a.shape[1], T):
        hc = chunk_body(h, a[:, c0:c0 + T], b[:, c0:c0 + T])
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1)[:, :L], h


def scan_chunked(a: torch.Tensor, b: torch.Tensor,
                 reset: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None,
                 chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential across L/chunk, the doubling tree inside a chunk: the
    tree gives each position t the composite (A_t, B_t) of the chunk's
    steps [0..t], so h_t = A_t·h_in + B_t."""
    a = apply_reset(a, reset)

    def body(h_in, ac, bc):
        Acum, Bcum = associative_pairs(ac, bc)
        return Acum * h_in[:, None] + Bcum

    return _chunk_scan(a, b, h0, chunk, body)


def scan_blocked(a: torch.Tensor, b: torch.Tensor,
                 reset: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None,
                 chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-parallel (SSD-style) schedule. Per chunk of length T

        h_i = cp_i · h_in + Σ_{j≤i} M[i,j] · b_j
        M[i,j] = Π_{j<k≤i} a_k        cp_i = Π_{k≤i} a_k

    M comes from a cumprod along i of the broadcast decay (exact for any
    real a), so the reset (a→0) zeroes every product that spans a boundary,
    cp included. Peak intermediate O(B·T²·*S) per chunk."""
    a = apply_reset(a, reset)

    def body(h_in, ac, bc):
        T = ac.shape[1]
        tail = (1,) * (ac.dim() - 2)
        ii = torch.arange(T, device=ac.device)[:, None]
        jj = torch.arange(T, device=ac.device)[None, :]
        strict = (ii > jj).reshape((1, T, T) + tail)
        lower = (ii >= jj).reshape((1, T, T) + tail)
        # amat[b,i,j] = a_i for i > j else 1; its cumprod over i is M[i,j]
        amat = torch.where(strict, ac[:, :, None], torch.ones_like(ac)[:, :1,
                                                                       None])
        M = torch.where(lower, torch.cumprod(amat, dim=1), 0.0)
        h = torch.einsum("bij...,bj...->bi...", M, bc)
        return h + torch.cumprod(ac, dim=1) * h_in[:, None]

    return _chunk_scan(a, b, h0, chunk, body)


_METHODS = {
    "sequential": scan_sequential,
    "associative": scan_associative,
    "chunked": scan_chunked,
    "blocked": scan_blocked,
}


def segmented_scan(a: torch.Tensor, b: torch.Tensor,
                   reset: Optional[torch.Tensor] = None,
                   h0: Optional[torch.Tensor] = None,
                   method: str = "chunked",
                   chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch. a, b: (B, L, *S); reset: (B, L) bool; h0: (B, *S).
    Returns (h_all (B, L, *S), h_last (B, *S))."""
    if a.shape != b.shape:
        raise ValueError(f"a/b shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if method not in _METHODS:
        raise ValueError(f"unknown scan method {method!r}; have "
                         f"{sorted(_METHODS)}")
    fn = _METHODS[method]
    if method in ("chunked", "blocked"):
        return fn(a, b, reset, h0, chunk=chunk)
    return fn(a, b, reset, h0)


def scan_step(h: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
              reset_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single decode step of the recurrence."""
    if reset_t is not None:
        a_t = torch.where(_bcast_reset(reset_t, a_t), torch.zeros_like(a_t),
                          a_t)
    return a_t * h + b_t


def gather_state_ends(h_traj: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Sample a (B, L, *S) state trajectory at per-segment end indices.

    Resets stop state from crossing boundaries, so the state at a segment's
    last token IS that segment's final state — the packed-prefill handoff.
    ``ends`` (B, S) int, −1 = absent segment (→ zeros). Returns (B, S, *S).
    """
    L = h_traj.shape[1]
    idx = ends.long().clamp(0, L - 1)
    rows = torch.arange(h_traj.shape[0], device=h_traj.device)[:, None]
    g = h_traj[rows, idx]
    ok = _bcast_reset(ends >= 0, g)
    return torch.where(ok, g, torch.zeros_like(g))
