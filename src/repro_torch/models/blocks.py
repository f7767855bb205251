"""The Mamba-1 and Mamba-2 blocks (port of the ``mamba`` and ``mamba2``
parts of ``repro.models.blocks``).

``init_mamba``/``init_mamba2`` make a block's parameters,
``apply_mamba``/``apply_mamba2`` run it over a packed (B, L) buffer and
``step_mamba``/``step_mamba2`` over one decode token. Parameter
names and layouts are the JAX package's: dense weights are (din, dout) and
applied as ``x @ W`` (the transpose of ``nn.Linear.weight``), and every
weight is cast to the activation dtype at use.

State handoff (serving), selected by ``collect`` and ``collect_ends``:
  * per ROW (``collect_ends=None``) — one right-padded sequence per row;
    the state is frozen across the padding and the row's final state is
    handed off (``LM.prefill``);
  * per SEGMENT (``collect_ends`` (B, S), −1 = absent) — a packed row holds
    several prompts; the reset rule makes the state at each segment's last
    token that segment's final state (``LM.prefill_packed``). State leaves
    gain a (B, S, …) leading pair.

Chunked prefill (``chunk_mamba``/``chunk_mamba2``, ``CHUNK``) resumes a long
prompt from its carried decode-layout state, one slab at a time
(``LM.prefill_chunk``); ``sample_from_logits`` is the serving engine's
batched sampler, on counter-based noise (its section below).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ssm as core_ssm
from repro_torch.core.conv import conv1d_pack_update
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    positions: Optional[torch.Tensor] = None      # (B, L) intra-seq positions
    segment_ids: Optional[torch.Tensor] = None    # (B, L)
    reset_t: Optional[torch.Tensor] = None        # (B,) new-sequence flag


def _norm(scale, x, eps):
    """RMSNorm in f32, cast back to x's dtype."""
    x32 = x.float()
    v = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(v + eps) * scale.float()).to(x.dtype)


def _randn(generator, shape, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def init_mamba(cfg: ArchConfig, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """One block's f32 parameters, from the distributions of the JAX
    package's ``init_mamba`` (not its random bits)."""
    d, di, N, W, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, \
        cfg.dtr
    s = mamba_param_shapes(cfg)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "norm": torch.ones(s["norm"], device=device),
        "in_proj": _randn(generator, s["in_proj"], device) * d ** -0.5,
        "conv_w": _randn(generator, s["conv_w"], device) * W ** -0.5,
        "conv_b": torch.zeros(s["conv_b"], device=device),
        "x_proj": _randn(generator, s["x_proj"], device) * di ** -0.5,
        "dt_w": _randn(generator, s["dt_w"], device) * dtr ** -0.5,
        "dt_b": torch.full(s["dt_b"], -4.6, device=device),  # softplus⁻¹(0.01)
        "A_log": torch.log(A).expand(s["A_log"]).clone(),
        "D": torch.ones(s["D"], device=device),
        "out_proj": _randn(generator, s["out_proj"], device) * di ** -0.5,
    }


def mamba_param_shapes(cfg: ArchConfig):
    d, di, N, W, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, \
        cfg.dtr
    return {"norm": (d,), "in_proj": (d, 2 * di), "conv_w": (W, di),
            "conv_b": (di,), "x_proj": (di, dtr + 2 * N), "dt_w": (dtr, di),
            "dt_b": (di,), "A_log": (di, N), "D": (di,),
            "out_proj": (di, d)}


def _rows(x):
    return torch.arange(x.shape[0], device=x.device)


def _conv_tail(x_in, lens, W):
    """Last W-1 *valid* inputs per row → decode conv state (B, W-1, D)."""
    L = x_in.shape[1]
    j = torch.arange(W - 1, device=x_in.device)[None, :]
    t = lens.long()[:, None] - (W - 1) + j                   # (B, W-1)
    g = x_in[_rows(x_in)[:, None], t.clamp(0, L - 1)]
    return torch.where((t >= 0)[..., None], g, torch.zeros_like(g))


def _valid(ctx: Ctx, x):
    if ctx.segment_ids is None:
        return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return ctx.segment_ids != 0


def _ends_lens(ctx: Ctx, ends):
    """Per-segment length at each end index: positions[end] + 1 (0 = absent).
    ends: (B, S), −1 = absent. Returns (B, S) int32."""
    L = ctx.positions.shape[1]
    p = torch.gather(ctx.positions, 1, ends.long().clamp(0, L - 1))
    return torch.where(ends >= 0, p + 1, 0).to(torch.int32)


def _conv_tail_ends(x_in, ends, lens, W):
    """Last W-1 in-SEGMENT inputs per segment end → (B, S, W-1, D), zeros
    where the segment is shorter than W-1."""
    L = x_in.shape[1]
    j = torch.arange(W - 1, device=x_in.device)[None, None, :]
    e = ends.long()[..., None]
    t = e - (W - 1) + 1 + j                                  # (B, S, W-1)
    ok = (lens.long()[..., None] - (W - 1) + j >= 0) & (e >= 0)
    g = x_in[_rows(x_in)[:, None, None], t.clamp(0, L - 1)]
    return torch.where(ok[..., None], g, torch.zeros_like(g))


def _tune_kw(cfg: ArchConfig):
    """The scans' tuning kwargs: ``tune`` from ``cfg.scan_tune`` (None when
    "off": the tuner is never consulted) and which sweep objective's
    winners to resolve (training configs set tune_objective="fwdbwd")."""
    return {"tune": None if cfg.scan_tune == "off" else cfg.scan_tune,
            "tune_objective": cfg.tune_objective}


def apply_mamba(p, x, ctx: Ctx, cfg: ArchConfig, collect: bool = False,
                collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]. The conv is the
    ``conv1d_pack`` kernel on the card; the scan is the scan kernel without
    ``collect`` and the plain ``core/ssm.py`` with it (the kernels hand off
    no per-segment states)."""
    di, N, dtr = cfg.d_inner, cfg.d_state, cfg.dtr
    h = _norm(p["norm"], x, cfg.norm_eps)
    xz = h @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)                 # strided views of xz
    x_c = kops.conv1d_pack(x_in, p["conv_w"].to(h.dtype),
                           p["conv_b"].to(h.dtype), ctx.positions)
    x_c = F.silu(x_c)
    dbl = x_c @ p["x_proj"].to(h.dtype)
    dt_low, Bm, Cm = dbl.split([dtr, N, N], dim=-1)
    delta = F.softplus(dt_low @ p["dt_w"].to(h.dtype) + p["dt_b"].to(h.dtype))
    A = -torch.exp(p["A_log"])
    scan_kw = dict(method=cfg.scan_impl, chunk=cfg.scan_chunk,
                   intra=cfg.scan_intra, **_tune_kw(cfg))
    if collect and collect_ends is not None:
        # per-SEGMENT handoff: resets already isolate segments, so the state
        # sampled at each segment end IS its final state
        y, h_ends = core_ssm.selective_scan(
            x_c, delta, A, Bm, Cm, p["D"], positions=ctx.positions,
            collect_ends=collect_ends, **scan_kw)
        state = {"conv": _conv_tail_ends(x_in, collect_ends,
                                         _ends_lens(ctx, collect_ends),
                                         cfg.d_conv),
                 "ssm": h_ends}
        return x + (y * F.silu(z)) @ p["out_proj"].to(x.dtype), state
    if collect:
        # freeze the state across right-padding: Δ=0 ⇒ Ā=1, B̄x=0, and the
        # padding's positions (0) must not trigger the reset there
        valid = _valid(ctx, x)
        delta = delta * valid[..., None].to(delta.dtype)
        pos_nz = torch.where(valid, ctx.positions, 1)
        y, h_last = core_ssm.selective_scan(
            x_c, delta, A, Bm, Cm, p["D"], positions=pos_nz,
            return_state=True, **scan_kw)
        state = {"conv": _conv_tail(x_in, valid.sum(-1), cfg.d_conv),
                 "ssm": h_last}
        return x + (y * F.silu(z)) @ p["out_proj"].to(x.dtype), state
    # training / plain forward: the scan kernels (differentiable) of the
    # config's schedule, as the JAX package's backend="pallas" path, or
    # the tuner's winner with scan_tune on
    y = kops.selective_scan(x_c, delta, A, Bm, Cm, p["D"],
                            positions=ctx.positions,
                            schedule=cfg.pallas_schedule,
                            xla_chunk=cfg.scan_chunk,
                            xla_method=cfg.scan_impl,
                            xla_intra=cfg.scan_intra, **_tune_kw(cfg))
    return x + (y * F.silu(z)) @ p["out_proj"].to(x.dtype)


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device):
    di, N, W = cfg.d_inner, cfg.d_state, cfg.d_conv
    return {"conv": torch.zeros((batch, W - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, N), dtype=torch.float32,
                               device=device)}


def step_mamba(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d); cache {"conv": (B, W-1, di), "ssm": (B, di, N)}.
    Returns (x_t + block(x_t), new cache)."""
    N, dtr = cfg.d_state, cfg.dtr
    h = _norm(p["norm"], x_t, cfg.norm_eps)
    xz = h[:, 0] @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, conv_state = conv1d_pack_update(
        x_in, cache["conv"], p["conv_w"].to(h.dtype),
        p["conv_b"].to(h.dtype), ctx.reset_t)
    x_c = F.silu(x_c)
    dbl = x_c @ p["x_proj"].to(h.dtype)
    dt_low, Bm, Cm = dbl.split([dtr, N, N], dim=-1)
    delta = F.softplus(dt_low @ p["dt_w"].to(h.dtype) + p["dt_b"].to(h.dtype))
    A = -torch.exp(p["A_log"])
    y, ssm = core_ssm.selective_scan_step(
        cache["ssm"], x_c, delta, A, Bm, Cm, p["D"], reset_t=ctx.reset_t)
    out = (y * F.silu(z)) @ p["out_proj"].to(x_t.dtype)
    return x_t + out[:, None], {"conv": conv_state, "ssm": ssm}


# ===========================================================================
# Mamba-2 block (SSD: scalar per-head decay, head-structured state)
# ===========================================================================

def init_mamba2(cfg: ArchConfig, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """One block's f32 parameters, from the distributions of the JAX
    package's ``init_mamba2`` (A ~ U[1, 16] per head; not its random
    bits)."""
    d, di, W = cfg.d_model, cfg.d_inner, cfg.d_conv
    s = mamba2_param_shapes(cfg)
    A = torch.rand(s["A_log"], generator=generator, device=device,
                   dtype=torch.float32) * 15.0 + 1.0
    out = {
        "norm": torch.ones(s["norm"], device=device),
        "in_proj": _randn(generator, s["in_proj"], device) * d ** -0.5,
        "conv_w": _randn(generator, s["conv_w"], device) * W ** -0.5,
        "conv_b": torch.zeros(s["conv_b"], device=device),
        "bc_proj": _randn(generator, s["bc_proj"], device) * di ** -0.5,
        "dt_proj": _randn(generator, s["dt_proj"], device) * di ** -0.5,
        "dt_b": torch.full(s["dt_b"], -4.6, device=device),  # softplus⁻¹(0.01)
        "A_log": torch.log(A),
        "D": torch.ones(s["D"], device=device),
        "out_proj": _randn(generator, s["out_proj"], device) * di ** -0.5,
    }
    if "ssm_norm_w" in s:
        out["ssm_norm_w"] = torch.ones(s["ssm_norm_w"], device=device)
    return out


def mamba2_param_shapes(cfg: ArchConfig):
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    H = cfg.n_ssm_heads
    out = {"norm": (d,), "in_proj": (d, 2 * di), "conv_w": (W, di),
           "conv_b": (di,), "bc_proj": (di, 2 * N), "dt_proj": (di, H),
           "dt_b": (H,), "A_log": (H,), "D": (H,), "out_proj": (di, d)}
    if cfg.ssm_norm == "rms_gate":
        out["ssm_norm_w"] = (di,)
    return out


def _mamba2_gates(p, x_c, cfg: ArchConfig):
    """Shared projection head: x_c (..., di) → (Δ (..., H), B, C (..., N));
    B and C are strided views of bc_proj's output (no copy)."""
    bc = x_c @ p["bc_proj"].to(x_c.dtype)
    Bm, Cm = bc.chunk(2, dim=-1)
    delta = F.softplus(x_c @ p["dt_proj"].to(x_c.dtype) +
                       p["dt_b"].to(x_c.dtype))
    return delta, Bm, Cm


def _mamba2_gate_out(p, y, z, cfg: ArchConfig):
    """y·silu(z), RMS-normalised with a learned (d_inner,) scale when
    ``ssm_norm="rms_gate"``."""
    g = y * F.silu(z)
    if "ssm_norm_w" in p:
        g = _norm(p["ssm_norm_w"], g, cfg.norm_eps)
    return g


def apply_mamba2(p, x, ctx: Ctx, cfg: ArchConfig, collect: bool = False,
                 collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]. The conv is the
    ``conv1d_pack`` kernel on the card; the scan is the heads scan kernels
    (#7 forward, #9 backward) without ``collect`` and the plain
    ``core/ssm.selective_scan_heads`` with it, as in the JAX package."""
    Bz, L, _ = x.shape
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_hd
    h = _norm(p["norm"], x, cfg.norm_eps)
    xz = h @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)                 # strided views of xz
    x_c = kops.conv1d_pack(x_in, p["conv_w"].to(h.dtype),
                           p["conv_b"].to(h.dtype), ctx.positions)
    x_c = F.silu(x_c)
    delta, Bm, Cm = _mamba2_gates(p, x_c, cfg)
    A = -torch.exp(p["A_log"])
    u_h = x_c.reshape(Bz, L, H, P)
    scan_kw = dict(method="blocked", chunk=cfg.scan_chunk,
                   intra=cfg.scan_intra, **_tune_kw(cfg))
    if collect and collect_ends is not None:
        # per-SEGMENT handoff, as apply_mamba: resets isolate segments
        y, h_ends = core_ssm.selective_scan_heads(
            u_h, delta, A, Bm, Cm, p["D"], positions=ctx.positions,
            collect_ends=collect_ends, **scan_kw)
        state = {"conv": _conv_tail_ends(x_in, collect_ends,
                                         _ends_lens(ctx, collect_ends),
                                         cfg.d_conv),
                 "ssm": h_ends}
        y = _mamba2_gate_out(p, y.reshape(Bz, L, di), z, cfg)
        return x + y @ p["out_proj"].to(x.dtype), state
    if collect:
        # freeze the state across right-padding (Δ=0) and keep the
        # padding's positions from firing the reset, as apply_mamba
        valid = _valid(ctx, x)
        delta = delta * valid[..., None].to(delta.dtype)
        pos_nz = torch.where(valid, ctx.positions, 1)
        y, h_last = core_ssm.selective_scan_heads(
            u_h, delta, A, Bm, Cm, p["D"], positions=pos_nz,
            return_state=True, **scan_kw)
        state = {"conv": _conv_tail(x_in, valid.sum(-1), cfg.d_conv),
                 "ssm": h_last}
        y = _mamba2_gate_out(p, y.reshape(Bz, L, di), z, cfg)
        return x + y @ p["out_proj"].to(x.dtype), state
    y = kops.selective_scan_heads(u_h, delta, A, Bm, Cm, p["D"],
                                  positions=ctx.positions,
                                  xla_chunk=cfg.scan_chunk,
                                  xla_intra=cfg.scan_intra, **_tune_kw(cfg))
    y = _mamba2_gate_out(p, y.reshape(Bz, L, di), z, cfg)
    return x + y @ p["out_proj"].to(x.dtype)


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype, device):
    di, N, W = cfg.d_inner, cfg.d_state, cfg.d_conv
    H, P = cfg.n_ssm_heads, cfg.ssm_hd
    return {"conv": torch.zeros((batch, W - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}


def step_mamba2(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d); cache {"conv": (B, W-1, di), "ssm": (B, H, P, N)}.
    Returns (x_t + block(x_t), new cache)."""
    Bz = x_t.shape[0]
    di, H, P = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_hd
    h = _norm(p["norm"], x_t, cfg.norm_eps)
    xz = h[:, 0] @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, conv_state = conv1d_pack_update(
        x_in, cache["conv"], p["conv_w"].to(h.dtype),
        p["conv_b"].to(h.dtype), ctx.reset_t)
    x_c = F.silu(x_c)
    delta, Bm, Cm = _mamba2_gates(p, x_c, cfg)
    A = -torch.exp(p["A_log"])
    y, ssm = core_ssm.selective_scan_heads_step(
        cache["ssm"], x_c.reshape(Bz, H, P), delta, A, Bm, Cm, p["D"],
        reset_t=ctx.reset_t)
    y = _mamba2_gate_out(p, y.reshape(Bz, di), z, cfg)
    out = y @ p["out_proj"].to(x_t.dtype)
    return x_t + out[:, None], {"conv": conv_state, "ssm": ssm}


# ===========================================================================
# chunk-resume prefill steps
# ===========================================================================
# ``chunk_<kind>(p, x, cache, ctx, cfg) -> (x, state)`` consumes a (B, T, d)
# slab of a LONG prompt and returns the block's output and the DECODE-layout
# state after it (the caller writes it into the cache). Protocol:
#   ctx.positions    (B, T) GLOBAL intra-sequence positions (off + t);
#                    padding slots hold anything (they are neutralised)
#   ctx.segment_ids  (B, T) 1 = real token, 0 = trailing padding (one
#                    request per chunk row, never packed)
# Rows whose slab is all padding are exact state no-ops (Δ=0 ⇒ Ā=1, B̄x=0,
# the trick of the per-row collect paths).


def _conv_resume(x_in, conv_cache, w, b, positions):
    """Causal conv over a resumed chunk: prepend the cached (W-1)-tail, run
    ``conv1d_pack`` (kernel #1 on the card) and drop the warm-up outputs.
    The kernel's taps test ``positions[t] >= k`` on the OUTPUT position
    only, so W-1 leading zero positions leave every kept output exact.
    Returns (x_c (B, T, D), the extended input (B, W-1+T, D))."""
    Bz = x_in.shape[0]
    W = w.shape[0]
    ext = torch.cat([conv_cache.to(x_in.dtype), x_in], dim=1)
    pos_ext = torch.cat([torch.zeros((Bz, W - 1), dtype=positions.dtype,
                                     device=positions.device), positions],
                        dim=1)
    x_c = kops.conv1d_pack(ext, w, b, pos_ext)[:, W - 1:]
    return x_c, ext


def _chunk_gates(ctx: Ctx, x, delta):
    """Freeze the state across the slab's padding: Δ=0 there, and the
    padding's positions must not fire the reset. Returns (Δ, positions,
    valid counts (B,))."""
    valid = _valid(ctx, x)
    delta = delta * valid[..., None].to(delta.dtype)
    return delta, torch.where(valid, ctx.positions, 1), valid.sum(-1)


def chunk_mamba(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One Mamba-1 block over a resumed slab; the scan is the plain
    ``core/ssm.py`` scan from ``h0 = cache["ssm"]``, as the JAX package's
    ``chunk_mamba`` runs XLA's."""
    N, dtr, W = cfg.d_state, cfg.dtr, cfg.d_conv
    h = _norm(p["norm"], x, cfg.norm_eps)
    xz = h @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, ext = _conv_resume(x_in, cache["conv"], p["conv_w"].to(h.dtype),
                            p["conv_b"].to(h.dtype), ctx.positions)
    x_c = F.silu(x_c)
    dbl = x_c @ p["x_proj"].to(h.dtype)
    dt_low, Bm, Cm = dbl.split([dtr, N, N], dim=-1)
    delta = F.softplus(dt_low @ p["dt_w"].to(h.dtype) + p["dt_b"].to(h.dtype))
    A = -torch.exp(p["A_log"])
    delta, pos_nz, nvalid = _chunk_gates(ctx, x, delta)
    y, h_last = core_ssm.selective_scan(
        x_c, delta, A, Bm, Cm, p["D"], positions=pos_nz,
        method=cfg.scan_impl, chunk=cfg.scan_chunk, return_state=True,
        h0=cache["ssm"], intra=cfg.scan_intra, **_tune_kw(cfg))
    state = {"conv": _conv_tail(ext, (W - 1) + nvalid, W), "ssm": h_last}
    return x + (y * F.silu(z)) @ p["out_proj"].to(x.dtype), state


def chunk_mamba2(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One Mamba-2 block over a resumed slab; the plain heads scan from
    ``h0 = cache["ssm"]``, as the JAX package's ``chunk_mamba2``."""
    Bz, T, _ = x.shape
    di, H, P, W = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_hd, cfg.d_conv
    h = _norm(p["norm"], x, cfg.norm_eps)
    xz = h @ p["in_proj"].to(h.dtype)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, ext = _conv_resume(x_in, cache["conv"], p["conv_w"].to(h.dtype),
                            p["conv_b"].to(h.dtype), ctx.positions)
    x_c = F.silu(x_c)
    delta, Bm, Cm = _mamba2_gates(p, x_c, cfg)
    A = -torch.exp(p["A_log"])
    delta, pos_nz, nvalid = _chunk_gates(ctx, x, delta)
    y, h_last = core_ssm.selective_scan_heads(
        x_c.reshape(Bz, T, H, P), delta, A, Bm, Cm, p["D"],
        positions=pos_nz, method="blocked", chunk=cfg.scan_chunk,
        return_state=True, h0=cache["ssm"], intra=cfg.scan_intra,
        **_tune_kw(cfg))
    state = {"conv": _conv_tail(ext, (W - 1) + nvalid, W), "ssm": h_last}
    y = _mamba2_gate_out(p, y.reshape(Bz, T, di), z, cfg)
    return x + y @ p["out_proj"].to(x.dtype), state


CHUNK = {"mamba": chunk_mamba, "mamba2": chunk_mamba2}


# Per layer kind: (init, parameter shapes, apply, decode cache, decode step)
KINDS = {
    "mamba": (init_mamba, mamba_param_shapes, apply_mamba, init_mamba_cache,
              step_mamba),
    "mamba2": (init_mamba2, mamba2_param_shapes, apply_mamba2,
               init_mamba2_cache, step_mamba2),
}


def kind_of(cfg: ArchConfig):
    """The block functions of ``cfg``'s layer kind; raises on a kind the
    port does not have."""
    kind = cfg.unit[0]
    if cfg.family != "mamba" or len(cfg.unit) != 1 or kind not in KINDS:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, unit {cfg.unit}; the port "
            f"has the Mamba-1 and Mamba-2 blocks only")
    return KINDS[kind]


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick: the first maximum along the vocab, as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ===========================================================================
# batched sampling (serving decode)
# ===========================================================================
# The JAX package keys ``jax.random`` by (seed, rid) and splits the key once
# a token; torch cannot reproduce those bits. The port draws counter-based
# noise instead: each uniform is an integer hash of (stream, token index,
# vocab index), where a request's stream is a hash of (seed, rid). The hash
# is 32-bit integer arithmetic in int64 tensors, masked to 32 bits after
# every multiply, so the CPU and the card compute the same bits; a slot
# carries its request's stream and token counter in place of a key, and a
# request samples identically whatever its slot, its admission round or
# the engine's schedule. A per-request ``torch.Generator`` would give the
# same independence but one draw call per slot a step, not one batched
# fixed-shape step, and a different stream on the CPU than on the card.

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x · c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c: two
    16-bit halves, so no product leaves int64 (or int) range. Works on
    Python ints, numpy int64 arrays and torch int64 tensors alike."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit integer finaliser (xorshift-multiply, two rounds): a
    bijection on [0, 2^32) with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_streams(seed: int, rids) -> np.ndarray:
    """Per-request noise streams: a hash of (seed, rid). rids (K,) →
    (K,) int64 in [0, 2^32)."""
    r = np.asarray(rids, np.int64) & _M32
    return _mix32(_mix32(np.int64(seed & _M32)) ^ r)


def sample_uniforms(stream: torch.Tensor, ctr: torch.Tensor,
                    V: int) -> torch.Tensor:
    """Uniforms in (0, 1) for token index ``ctr`` of ``stream``, one per
    vocab entry: stream, ctr (B,) int64 → (B, V) f32. The top 24 bits of
    the hash over 2^24, offset by half a step, are exact in f32."""
    row = _mix32(stream ^ _mix32(ctr & _M32))
    col = _mix32(torch.arange(V, dtype=torch.int64, device=stream.device))
    h = _mix32(row[:, None] ^ col[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def sample_from_logits(logits, stream, ctr, temperature, top_k, top_p):
    """Fixed-shape batched sampling over decode slots (port of the JAX
    ``sample_from_logits``, its threshold rules exactly).

    logits (B, V) f32; stream, ctr (B,) int64: each slot's noise stream
    and the index of the token being drawn; temperature (B,) f32 —
    ``<= 0`` means GREEDY (argmax; its counter still advances); top_k (B,)
    int — keep the logits ``>=`` the k-th largest (``<= 0`` disables);
    top_p (B,) f32 — keep the logits ``>=`` the last of the smallest
    sorted prefix whose mass before it is < top_p (``>= 1`` disables).
    Gumbel-max over the kept logits divided by the temperature. Returns
    (tokens (B,) int32, ctr + 1)."""
    V = logits.shape[-1]
    lg = logits.float()
    greedy_tok = torch.argmax(lg, dim=-1)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, V).long()
    kth = torch.gather(sorted_lg, -1, (k - 1).clamp(0, V - 1)[:, None])
    masked = torch.where(lg >= kth, lg, -torch.inf)
    probs = torch.softmax(sorted_lg, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    nkeep = (before < top_p.clamp(0.0, 1.0)[:, None]).sum(-1)
    pth = torch.gather(sorted_lg, -1, (nkeep - 1).clamp(0, V - 1)[:, None])
    masked = torch.where(lg >= pth, masked, -torch.inf)
    u = sample_uniforms(stream, ctr, V)
    gumbel = -torch.log(-torch.log(u))
    temp = temperature.clamp(min=1e-6)[:, None]
    sampled = torch.argmax(masked / temp + gumbel, dim=-1)
    tok = torch.where(temperature > 0.0, sampled, greedy_tok)
    return tok.to(torch.int32), ctr + 1
