"""Generic segmented diagonal linear recurrence (port of ``repro.core.scan``).

    h_t = a_t ⊙ h_{t-1} + b_t

with the PackMamba reset rule: wherever ``reset[t]`` is set (a packed
sequence start, ``positions == 0``), ``a_t → 0`` so no state crosses the
boundary. The combine operator

    (a₁, b₁) ⊕ (a₂, b₂) = (a₂·a₁, a₂·b₁ + b₂)

is associative, and a zero ``a`` kills every composite product that spans
it, so the rule holds for any schedule: the sequential walk here and the
log₂T doubling tree (``associative_pairs``) that the blocked selective scan
uses inside a chunk.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
