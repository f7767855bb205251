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

Both scans take ``backend`` as the JAX wrappers do: ``"pallas"`` (the
default here) is the kernels, ``"xla"`` the plain scans of ``core/ssm.py``
(``xla_method``, ``xla_chunk``, ``xla_intra``), differentiated by
autograd. ``tune=`` ("auto", a cache path or a ``TuneCache``) resolves
every knob, backend included, from the shape-keyed tuning cache
(``repro_torch.tune``); a kernel winner's schedule and chunk reach the
``autograd.Function``, so the backward runs the winner's kernel. The JAX
package resolves once, when it traces; these wrappers resolve at every
call, which the cache's per-key memo keeps to a dictionary lookup.

Each kernel call is marked for the step counter (``_counted``): while one
counts (``roofline/counter.py``), the call is charged by its kernel's model
and the ops inside it are not tallied, so a step counts the same work on
the card, on the CPU and on the meta device. The mark, the counter's tally
and the launch counters (``read_launches``, ``zero_launches``) name each
kernel as ``LAUNCH_COUNTERS`` does.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import ssm as core_ssm
from repro_torch.kernels import conv1d_pack as conv_k
from repro_torch.kernels import selective_scan as scan_k
from repro_torch.kernels import selective_scan_heads as heads_k

SCAN_CHUNK = 64        # checkpoint interval of the scan kernels (a multiple
#                        of scan_k.TILE_T, and scan_k.STEP_TILE_T itself);
#                        the TPU kernels' default is 256
HEADS_CHUNK = 256      # checkpoint interval of the heads kernels: the TPU
#                        kernels' default; a chunk's (P, N) f32 checkpoint
#                        is as large as 128 tokens of bf16 u at P = N = 64
WORK_COUNTER = None    # the step counter counting now
#                        (roofline/counter.py), or None

# Every kernel by the name of its launch counter: the kernel module and the
# counter there, which its wrapper adds one to where it launches the kernel.
# The step counter tallies a call under the same name, and kernel_model's
# KERNEL_WORK charges it.
LAUNCH_COUNTERS = {
    "conv1d_pack_fwd": (conv_k, "LAUNCHES"),
    "conv1d_pack_bwd_dx": (conv_k, "LAUNCHES_DX"),
    "selective_scan_fwd": (scan_k, "LAUNCHES_FWD"),
    "selective_scan_bwd": (scan_k, "LAUNCHES_BWD"),
    "selective_scan_fwd_step": (scan_k, "LAUNCHES_FWD_STEP"),
    "selective_scan_bwd_step": (scan_k, "LAUNCHES_BWD_STEP"),
    "selective_scan_heads_fwd": (heads_k, "LAUNCHES_FWD"),
    "selective_scan_heads_fwd_dual": (heads_k, "LAUNCHES_DUAL"),
    "selective_scan_heads_bwd": (heads_k, "LAUNCHES_BWD")}
# the conv's and each scan schedule's (forward, backward) kernel
CONV_KERNELS = ("conv1d_pack_fwd", "conv1d_pack_bwd_dx")
SCAN_KERNELS = {
    "blocked": ("selective_scan_fwd", "selective_scan_bwd"),
    "step": ("selective_scan_fwd_step", "selective_scan_bwd_step")}
HEADS_KERNELS = {
    "blocked_heads": ("selective_scan_heads_fwd", "selective_scan_heads_bwd"),
    "blocked_heads_dual": ("selective_scan_heads_fwd_dual",
                           "selective_scan_heads_bwd")}


def read_launches():
    """Every launch counter, by kernel name."""
    return {name: getattr(m, attr)
            for name, (m, attr) in LAUNCH_COUNTERS.items()}


def zero_launches():
    for m, attr in LAUNCH_COUNTERS.values():
        setattr(m, attr, 0)


def _counted(name, *args):
    """Marks one kernel call: an active step counter charges it by
    ``name``'s model (``roofline/kernel_model.py``, from ``args``) and
    tallies none of the ops the call issues."""
    c = WORK_COUNTER
    return contextlib.nullcontext() if c is None else c.kernel(name, *args)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, positions):
        ctx.save_for_backward(x, weight, positions)
        with _counted(CONV_KERNELS[0], x, weight.shape[0]):
            return conv_k.conv1d_pack(x, weight, bias, positions)

    @staticmethod
    def backward(ctx, dy):
        x, weight, positions = ctx.saved_tensors
        dy = dy.contiguous()
        with _counted(CONV_KERNELS[1], dy, weight.shape[0]):
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
        with _counted(SCAN_KERNELS[schedule][0], u, At.shape[0], chunk):
            y, ckpts = scan_k.selective_scan_fwd(u, delta, At, Bm, Cm, Dp,
                                                 positions, chunk, schedule)
        ctx.save_for_backward(u, delta, At, Bm, Cm, Dp, positions, ckpts)
        ctx.chunk, ctx.schedule = chunk, schedule
        ctx.dtypes = (A.dtype, D.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, At, Bm, Cm, Dp, positions, ckpts = ctx.saved_tensors
        dy = dy.to(u.dtype).contiguous()
        with _counted(SCAN_KERNELS[ctx.schedule][1], u, At.shape[0],
                      ctx.chunk):
            du, ddt, dB_p, dC_p, dA_p, dD_p = scan_k.selective_scan_bwd(
                u, delta, At, Bm, Cm, Dp, positions, ckpts, dy, ctx.chunk,
                ctx.schedule)
        a_dt, d_dt = ctx.dtypes
        return (du.to(u.dtype), ddt.to(delta.dtype),
                dA_p.sum(0).t().to(a_dt), dB_p.sum(1).to(Bm.dtype),
                dC_p.sum(1).to(Cm.dtype), dD_p.sum(0).to(d_dt), None, None,
                None)


def _resolve_tune(op, tune, *, B, L, D=0, N=0, H=0, dh=0, dtype, positions,
                  device, objective="fwd"):
    """The measured winner for one call site on ``device``, or {} on a miss
    (the caller's arguments stand). Unlike the plain-only resolver in
    ``core/ssm.py``, this level owns the backend: a kernel winner carries
    (schedule, pchunk), a plain one (method, chunk, intra). On the card a
    plain winner is taken only from a sweep that timed the kernel
    candidates; any other raises, so the kernels never give way to the
    plain scans unmeasured."""
    # lazy: the tuner imports this module
    from repro_torch.tune import candidate_name, tuned_entry
    rec = tuned_entry(op, cache=None if tune == "auto" else tune,
                      B=B, L=L, D=D, N=N, H=H, dh=dh, dtype=dtype,
                      reset_density=None if positions is not None else 0.0,
                      objective=objective, device=device)
    if rec is None:
        return {}
    kn = rec["knobs"]
    if device.type == "cuda" and kn.get("backend") != "pallas" and \
            not rec.get("kernels"):
        raise RuntimeError(
            f"the tuning cache's winner for this {op} call, "
            f"{candidate_name(kn)}, comes from a sweep without the kernel "
            f"candidates; re-tune on the card (python -m "
            f"repro_torch.tune.runner --force)")
    return kn


def _apply_knobs(kn, backend, schedule, chunk, xla_method, xla_chunk,
                 xla_intra):
    backend = kn.get("backend", backend)
    if backend == "pallas":
        return (backend, kn.get("schedule", schedule),
                kn.get("pchunk", chunk), xla_method, xla_chunk, xla_intra)
    return (backend, schedule, chunk, kn.get("method", xla_method),
            kn.get("chunk", xla_chunk), kn.get("intra", xla_intra))


def selective_scan(u, delta, A, B, C, D=None, positions=None, *,
                   backend: str = "pallas", chunk: int = SCAN_CHUNK,
                   schedule: str = "blocked", xla_chunk: int = 256,
                   xla_method: str = "blocked", xla_intra=None, tune=None,
                   tune_objective: str = "fwd"):
    """Segmented selective scan, y only, differentiable. u, delta
    (B, L, Dm) | A (Dm, N) | B, C (B, L, N), any batch/row strides (the
    kernels read ``split`` views of x_proj's output as they are) |
    D (Dm,) or None | positions (B, L) or None (= one segment per row).
    ``schedule``: 'blocked' (kernels #4/#6) | 'step' (kernels #3/#5);
    ``backend``, ``xla_*`` and ``tune``: the module docstring."""
    if tune is not None:
        kn = _resolve_tune("selective_scan", tune, B=u.shape[0],
                           L=u.shape[1], D=u.shape[2], N=A.shape[-1],
                           dtype=u.dtype, positions=positions,
                           device=u.device, objective=tune_objective)
        backend, schedule, chunk, xla_method, xla_chunk, xla_intra = \
            _apply_knobs(kn, backend, schedule, chunk, xla_method, xla_chunk,
                         xla_intra)
    if backend == "xla":
        return core_ssm.selective_scan(u, delta, A, B, C, D,
                                       positions=positions,
                                       method=xla_method, chunk=xla_chunk,
                                       intra=xla_intra)
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")
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
        with _counted(HEADS_KERNELS[schedule][0], u, Bm.shape[-1], chunk):
            y, ckpts = heads_k.selective_scan_heads_fwd(
                u, delta, Ah, Bm, Cm, Dp, positions, chunk, schedule)
        ctx.save_for_backward(u, delta, Ah, Bm, Cm, Dp, positions, ckpts)
        ctx.chunk, ctx.schedule = chunk, schedule
        ctx.dtypes = (A.dtype, D.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        # one backward (#9) serves both forward schedules: the checkpoint
        # contract is the same and the adjoint does not depend on the form
        u, delta, Ah, Bm, Cm, Dp, positions, ckpts = ctx.saved_tensors
        dy = dy.to(u.dtype).contiguous()
        with _counted(HEADS_KERNELS[ctx.schedule][1], u, Bm.shape[-1],
                      ctx.chunk):
            du, ddt_p, dB_p, dC_p, dA_p, dD_p = \
                heads_k.selective_scan_heads_bwd(u, delta, Ah, Bm, Cm, Dp,
                                                 positions, ckpts, dy,
                                                 ctx.chunk)
        a_dt, d_dt = ctx.dtypes
        return (du.to(u.dtype), ddt_p.sum(-1).to(delta.dtype),
                dA_p.sum((0, 2)).to(a_dt), dB_p.sum(1).to(Bm.dtype),
                dC_p.sum(1).to(Cm.dtype), dD_p.sum((0, 2)).to(d_dt),
                None, None, None)


def selective_scan_heads(u, delta, A, B, C, D=None, positions=None, *,
                         backend: str = "pallas", chunk: int = HEADS_CHUNK,
                         schedule: str = "blocked_heads", xla_chunk: int = 64,
                         xla_method: str = "blocked", xla_intra=None,
                         tune=None, tune_objective: str = "fwd"):
    """Head-structured segmented selective scan (scalar decay per head),
    y only, differentiable. u (B, L, H, P) | delta (B, L, H) | A (H,) |
    B, C (B, L, N), any batch/row strides (the kernels read ``split``
    views of bc_proj's output as they are) | D (H,) or None | positions
    (B, L) or None (= one segment per row). ``schedule``: 'blocked_heads'
    (kernel #7) | 'blocked_heads_dual' (kernel #8). The chunk is clipped
    to L, as the JAX wrapper clips it. ``backend``, ``xla_*`` and
    ``tune``: the module docstring."""
    if tune is not None:
        kn = _resolve_tune("selective_scan_heads", tune, B=u.shape[0],
                           L=u.shape[1], N=B.shape[-1], H=u.shape[2],
                           dh=u.shape[3], dtype=u.dtype, positions=positions,
                           device=u.device, objective=tune_objective)
        backend, schedule, chunk, xla_method, xla_chunk, xla_intra = \
            _apply_knobs(kn, backend, schedule, chunk, xla_method, xla_chunk,
                         xla_intra)
    if backend == "xla":
        return core_ssm.selective_scan_heads(u, delta, A, B, C, D,
                                             positions=positions,
                                             method=xla_method,
                                             chunk=xla_chunk,
                                             intra=xla_intra)
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")
    if schedule not in heads_k.SCHEDULES:
        raise ValueError(f"unknown heads schedule {schedule!r}")
    Bz, L, H, _ = u.shape
    if D is None:
        D = torch.zeros(H, dtype=torch.float32, device=u.device)
    return _ScanHeads.apply(u.contiguous(), delta.contiguous(), A, B, C, D,
                            _positions(positions, Bz, L, u.device),
                            max(1, min(chunk, L)), schedule)
