"""Public wrappers of the kernels (port of ``repro.kernels.ops``), wired for
autograd as the JAX package wires ``custom_vjp`` (``_conv_padded``,
``_scan_padded``, ``_scan_heads_padded``).

The JAX package picks a backend by name; here the device of the tensors
picks it: a CUDA tensor goes to the hand-written kernels, a CPU tensor to
their plain versions (``kernels/conv1d_pack.py``,
``kernels/selective_scan.py``, ``kernels/selective_scan_heads.py``).
Nothing is padded and nothing is transposed: the kernels mask a ragged L
and D themselves and read the public layouts through their strides.

* ``conv1d_pack``: forward kernel #1; backward dx from kernel #2, dweight
  and dbias as plain PyTorch sums.
* ``selective_scan`` (Mamba-1), by ``schedule`` as the JAX wrapper takes
  it: ``"blocked"``, forward kernel #4 (y plus the chunk-entry states) and
  backward kernel #6; ``"step"``, forward kernel #3 and backward kernel #5.
  The schedule is carried from forward to backward. Both backwards give
  dB/dC partials per block of channels (32 for #6, 16 for #5) and dA/dD
  partials per row; they are summed here over a fixed axis in a fixed
  order, whatever the block width.
* ``selective_scan_heads`` (Mamba-2): forward kernel #7
  (``schedule="blocked_heads"``) or #8 (``"blocked_heads_dual"``),
  backward kernel #9 for both; its per-slice partials of dΔ, dB, dC, dA
  and dD are summed here the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import conv1d_pack as conv_k
from repro_torch.kernels import selective_scan as scan_k
from repro_torch.kernels import selective_scan_heads as heads_k

SCAN_CHUNK = 64        # checkpoint interval of the scan kernels (a multiple
#                        of scan_k.TILE_T, and scan_k.STEP_TILE_T itself);
#                        the TPU kernels' default is 256
HEADS_CHUNK = 256      # checkpoint interval of the heads kernels: the TPU
#                        kernels' default; a chunk's (P, N) f32 checkpoint
#                        is as large as 128 tokens of bf16 u at P = N = 64


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, positions):
        ctx.save_for_backward(x, weight, positions)
        return conv_k.conv1d_pack(x, weight, bias, positions)

    @staticmethod
    def backward(ctx, dy):
        x, weight, positions = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv_k.conv1d_pack_bwd_dx(dy, weight, positions)
        dw, db = conv_k.conv1d_pack_bwd_params(x, dy, positions,
                                               weight.shape[0])
        # bias has x's dtype (the kernel wrapper checks it)
        return dx.to(x.dtype), dw.to(x.dtype), db.to(x.dtype), None


def _positions(positions, B, L, device):
    if positions is None:
        return torch.arange(L, dtype=torch.int32, device=device).expand(B, L)
    return positions.to(torch.int32)


def conv1d_pack(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segmented causal depthwise conv. x (B, L, D) | weight (W, D) |
    bias (D,) or None | positions (B, L) or None (= one segment per row)."""
    B, L, D = x.shape
    if bias is None:
        bias = torch.zeros(D, dtype=x.dtype, device=x.device)
    return _Conv.apply(x, weight, bias, _positions(positions, B, L, x.device))


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, Bm, Cm, D, positions, chunk, schedule):
        At = A.float().t().contiguous()
        Dp = D.float().contiguous()
        y, ckpts = scan_k.selective_scan_fwd(u, delta, At, Bm, Cm, Dp,
                                             positions, chunk, schedule)
        ctx.save_for_backward(u, delta, At, Bm, Cm, Dp, positions, ckpts)
        ctx.chunk, ctx.schedule = chunk, schedule
        ctx.dtypes = (A.dtype, D.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, At, Bm, Cm, Dp, positions, ckpts = ctx.saved_tensors
        du, ddt, dB_p, dC_p, dA_p, dD_p = scan_k.selective_scan_bwd(
            u, delta, At, Bm, Cm, Dp, positions, ckpts,
            dy.to(u.dtype).contiguous(), ctx.chunk, ctx.schedule)
        a_dt, d_dt = ctx.dtypes
        return (du.to(u.dtype), ddt.to(delta.dtype),
                dA_p.sum(0).t().to(a_dt), dB_p.sum(1).to(Bm.dtype),
                dC_p.sum(1).to(Cm.dtype), dD_p.sum(0).to(d_dt), None, None,
                None)


def selective_scan(u, delta, A, B, C, D=None, positions=None, *,
                   chunk: int = SCAN_CHUNK, schedule: str = "blocked"):
    """Segmented selective scan, y only, differentiable. u, delta
    (B, L, Dm) | A (Dm, N) | B, C (B, L, N), any batch/row strides (the
    kernels read ``split`` views of x_proj's output as they are) |
    D (Dm,) or None | positions (B, L) or None (= one segment per row).
    ``schedule``: 'blocked' (kernels #4/#6) | 'step' (kernels #3/#5)."""
    scan_k.check_schedule(schedule)
    Bz, L, Dm = u.shape
    if D is None:
        D = torch.zeros(Dm, dtype=torch.float32, device=u.device)
    return _Scan.apply(u.contiguous(), delta.contiguous(), A, B, C, D,
                       _positions(positions, Bz, L, u.device), chunk,
                       schedule)


class _ScanHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, Bm, Cm, D, positions, chunk, schedule):
        Ah = A.float().contiguous()
        Dp = D.float().contiguous()
        y, ckpts = heads_k.selective_scan_heads_fwd(
            u, delta, Ah, Bm, Cm, Dp, positions, chunk, schedule)
        ctx.save_for_backward(u, delta, Ah, Bm, Cm, Dp, positions, ckpts)
        ctx.chunk = chunk
        ctx.dtypes = (A.dtype, D.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        # one backward (#9) serves both forward schedules: the checkpoint
        # contract is the same and the adjoint does not depend on the form
        u, delta, Ah, Bm, Cm, Dp, positions, ckpts = ctx.saved_tensors
        du, ddt_p, dB_p, dC_p, dA_p, dD_p = heads_k.selective_scan_heads_bwd(
            u, delta, Ah, Bm, Cm, Dp, positions, ckpts,
            dy.to(u.dtype).contiguous(), ctx.chunk)
        a_dt, d_dt = ctx.dtypes
        return (du.to(u.dtype), ddt_p.sum(-1).to(delta.dtype),
                dA_p.sum((0, 2)).to(a_dt), dB_p.sum(1).to(Bm.dtype),
                dC_p.sum(1).to(Cm.dtype), dD_p.sum((0, 2)).to(d_dt),
                None, None, None)


def selective_scan_heads(u, delta, A, B, C, D=None, positions=None, *,
                         chunk: int = HEADS_CHUNK,
                         schedule: str = "blocked_heads"):
    """Head-structured segmented selective scan (scalar decay per head),
    y only, differentiable. u (B, L, H, P) | delta (B, L, H) | A (H,) |
    B, C (B, L, N), any batch/row strides (the kernels read ``split``
    views of bc_proj's output as they are) | D (H,) or None | positions
    (B, L) or None (= one segment per row). ``schedule``: 'blocked_heads'
    (kernel #7) | 'blocked_heads_dual' (kernel #8). The chunk is clipped
    to L, as the JAX wrapper clips it."""
    if schedule not in heads_k.SCHEDULES:
        raise ValueError(f"unknown heads schedule {schedule!r}")
    Bz, L, H, _ = u.shape
    if D is None:
        D = torch.zeros(H, dtype=torch.float32, device=u.device)
    return _ScanHeads.apply(u.contiguous(), delta.contiguous(), A, B, C, D,
                            _positions(positions, Bz, L, u.device),
                            max(1, min(chunk, L)), schedule)
