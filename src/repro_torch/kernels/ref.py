"""Naive oracles for the kernels (port of ``repro.kernels.ref``).

The most direct sequential formulation — Python loops over single
timesteps, all math f32 — so they are independent of both the kernels and
the schedules in ``core``.
"""
from __future__ import annotations

from typing import Optional

import torch


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       D: Optional[torch.Tensor] = None,
                       positions: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """u, delta: (Bz, L, Dm) | A: (Dm, N) | B, C: (Bz, L, N) | D: (Dm,).

    h_t = exp(Δ_t A)·h_{t-1} + (Δ_t B_t)·u_t ;  y_t = C_t·h_t + D·u_t
    with Ā→0 where positions == 0."""
    Bz, L, Dm = u.shape
    f = torch.float32
    u32, d32 = u.to(f), delta.to(f)
    A32, B32, C32 = A.to(f), B.to(f), C.to(f)
    h = torch.zeros((Bz, Dm, A.shape[-1]), dtype=f, device=u.device)
    ys = []
    for t in range(L):
        a_t = torch.exp(d32[:, t, :, None] * A32)
        if positions is not None:
            a_t = torch.where((positions[:, t] == 0)[:, None, None], 0.0, a_t)
        h = a_t * h + (d32[:, t] * u32[:, t])[..., None] * B32[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.to(f) * u32
    return y.to(u.dtype)


def conv1d_pack_ref(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (Bz, L, Dm) | weight: (W, Dm) | bias: (Dm,) | positions: (Bz, L).

    Causal depthwise conv; the tap reaching back k is dropped when
    k > positions[t] (Algorithm 1)."""
    Bz, L, Dm = x.shape
    W = weight.shape[0]
    f = torch.float32
    x32 = x.to(f)
    y = torch.zeros((Bz, L, Dm), dtype=f, device=x.device)
    for t in range(L):
        acc = torch.zeros((Bz, Dm), dtype=f, device=x.device)
        for k in range(W):
            src = t - k
            if src < 0:
                continue
            tap = x32[:, src] * weight[W - 1 - k].to(f)
            if positions is not None:
                tap = torch.where((positions[:, t] >= k)[:, None], tap, 0.0)
            acc = acc + tap
        y[:, t] = acc
    if bias is not None:
        y = y + bias.to(f)
    return y.to(x.dtype)
