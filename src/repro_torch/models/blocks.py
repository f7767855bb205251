"""The Mamba-1, Mamba-2, mLSTM, sLSTM, RG-LRU and attention blocks (local
in the hybrid, full causal in the dense family) and the gated MLP (port of
the ``mamba``, ``mamba2``, ``mlstm``, ``slstm``, ``rec``, ``attn`` and
``mlp`` parts of ``repro.models.blocks``).

``init_<kind>`` makes a block's parameters, ``apply_<kind>`` runs it over
a packed (B, L) buffer and ``step_<kind>`` over one decode token
(``KINDS`` holds them by kind, ``layer_kinds`` gives each layer's,
``unit_layout`` the JAX sub-block names of one pattern unit). Every
decode state is O(1) in the context but the attention's: a K/V ring of S
slots (``init_attn_cache``, ``ring_size``), slot ``t % S`` holding token
t, written at ``Ctx.cache_len``; S = min(max_len, attn_window) for a
local attention and max_len without a window, where the ring never wraps
and is the JAX package's linear cache.
Parameter names and layouts are the JAX package's: dense weights are (din,
dout) and applied as ``x @ W`` (the transpose of ``nn.Linear.weight``),
and every weight is cast to the activation dtype at use.

State handoff (serving), selected by ``collect`` and ``collect_ends``:
  * per ROW (``collect_ends=None``) — one right-padded sequence per row;
    the state is frozen across the padding and the row's final state is
    handed off (``LM.prefill``);
  * per SEGMENT (``collect_ends`` (B, S), −1 = absent) — a packed row holds
    several prompts; the reset rule makes the state at each segment's last
    token that segment's final state (``LM.prefill_packed``). State leaves
    gain a (B, S, …) leading pair.

Chunked prefill (``chunk_<kind>``, ``CHUNK``) resumes a long prompt from
its carried decode-layout state, one slab at a time
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
from repro_torch.core.attention import (NEG_INF, _gqa_scores,
                                         attention, decode_attention,
                                         rope)
from repro_torch.core.conv import conv1d_pack_update
from repro_torch.core.recurrence import (NEG, RGLRU_C, mlstm, mlstm_step,
                                         rglru, rglru_step, slstm)
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    positions: Optional[torch.Tensor] = None      # (B, L) intra-seq positions
    segment_ids: Optional[torch.Tensor] = None    # (B, L)
    reset_t: Optional[torch.Tensor] = None        # (B,) new-sequence flag
    cache_len: Optional[torch.Tensor] = None      # (B,) tokens consumed


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


# ===========================================================================
# xLSTM blocks
# ===========================================================================
# The mLSTM block's conv is ``conv1d_pack`` (kernel #1 on the card) in a
# packed prefill and a chunk slab; its recurrence and the whole sLSTM block
# are plain PyTorch (``core/recurrence.py``), as the JAX package runs them
# in XLA with no Pallas kernel.

def mlstm_param_shapes(cfg: ArchConfig):
    d, H, W = cfg.d_model, cfg.n_heads, cfg.conv_width
    pf = int(cfg.proj_factor * d)
    return {"norm": (d,), "w_upx": (d, pf), "w_upz": (d, pf),
            "conv_w": (W, pf), "conv_b": (pf,), "wq": (pf, pf),
            "wk": (pf, pf), "wv": (pf, pf), "w_if": (pf, 2 * H),
            "b_if": (2 * H,), "w_down": (pf, d)}


def init_mlstm(cfg: ArchConfig, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """One block's f32 parameters, from the distributions of the JAX
    package's ``init_mlstm`` (forget-gate bias 3, input-gate bias 0)."""
    d, H, W = cfg.d_model, cfg.n_heads, cfg.conv_width
    s = mlstm_param_shapes(cfg)
    pf = s["w_upx"][1]

    def dense(k, din):
        return _randn(generator, s[k], device) * din ** -0.5

    return {
        "norm": torch.ones(s["norm"], device=device),
        "w_upx": dense("w_upx", d), "w_upz": dense("w_upz", d),
        "conv_w": _randn(generator, s["conv_w"], device) * W ** -0.5,
        "conv_b": torch.zeros(s["conv_b"], device=device),
        "wq": dense("wq", pf), "wk": dense("wk", pf), "wv": dense("wv", pf),
        "w_if": dense("w_if", pf),
        "b_if": torch.cat([torch.zeros(H, device=device),
                           torch.full((H,), 3.0, device=device)]),
        "w_down": dense("w_down", pf),
    }


def _mlstm_heads(p, x_in, x_c, cfg: ArchConfig):
    """q, k from the conv's output, v from its input, and the log gates:
    (…, pf) → q, k, v (…, H, dh), log f = log σ(f̃) and log i (…, H) f32."""
    H = cfg.n_heads
    lead, dt = x_in.shape[:-1], x_in.dtype
    dh = x_in.shape[-1] // H
    q = (x_c @ p["wq"].to(dt)).reshape(*lead, H, dh)
    k = (x_c @ p["wk"].to(dt)).reshape(*lead, H, dh)
    v = (x_in @ p["wv"].to(dt)).reshape(*lead, H, dh)
    g = x_c @ p["w_if"].to(dt) + p["b_if"].to(dt)
    logi, f_pre = g.chunk(2, dim=-1)
    return q, k, v, F.logsigmoid(f_pre.float()), logi.float()


def _mlstm_out(p, x, y, z):
    y = y.reshape(z.shape) * F.silu(z)
    return x + (y @ p["w_down"].to(x.dtype)).reshape(x.shape)


def _fold_segments(t, S):
    """(B, …) → (B·S, …): each row repeated once per segment, so one call
    runs every segment's freeze run (the JAX package's vmap over segment
    ids)."""
    return t[:, None].expand(t.shape[0], S, *t.shape[1:]).reshape(
        t.shape[0] * S, *t.shape[1:])


def _segment_masks(ctx: Ctx, S: int):
    """(B, S, L) bool: token t is in segment s + 1."""
    sid = torch.arange(1, S + 1, device=ctx.segment_ids.device)
    return ctx.segment_ids[:, None] == sid[None, :, None]


def apply_mlstm(p, x, ctx: Ctx, cfg: ArchConfig, collect: bool = False,
                collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]. The conv is ``conv1d_pack``
    (kernel #1 on the card), the recurrence ``core.recurrence.mlstm``."""
    Bz, L, _ = x.shape
    W = cfg.conv_width
    hin = _norm(p["norm"], x, cfg.norm_eps)
    x_in = hin @ p["w_upx"].to(hin.dtype)
    z = hin @ p["w_upz"].to(hin.dtype)
    x_c = F.silu(kops.conv1d_pack(x_in, p["conv_w"].to(hin.dtype),
                                  p["conv_b"].to(hin.dtype), ctx.positions))
    q, k, v, logf, logi = _mlstm_heads(p, x_in, x_c, cfg)
    y = None
    if collect and collect_ends is not None:
        # per-SEGMENT handoff: the matrix-state trajectory is never
        # materialised, so each segment's final state comes from a run with
        # the gates outside it made identity (f' = 1, i' = 0), whose final
        # state is the state at the segment's last token. The segments are
        # folded into the batch axis: (B·S, L, …), one call.
        y = mlstm(q, k, v, logf, logi, positions=ctx.positions,
                  chunk=cfg.scan_chunk)
        S = collect_ends.shape[1]
        msk = _segment_masks(ctx, S)
        mf = msk.reshape(Bz * S, L)[..., None]
        _, (C, n, m) = mlstm(
            *(_fold_segments(t, S) for t in (q, k, v)),
            torch.where(mf, _fold_segments(logf, S), 0.0),
            torch.where(mf, _fold_segments(logi, S), NEG),
            positions=torch.where(msk, ctx.positions[:, None], 1).reshape(
                Bz * S, L),
            chunk=cfg.scan_chunk, return_state=True)
        state = {"conv": _conv_tail_ends(x_in, collect_ends,
                                         _ends_lens(ctx, collect_ends), W),
                 "C": C.reshape(Bz, S, *C.shape[1:]),
                 "n": n.reshape(Bz, S, *n.shape[1:]),
                 "m": m.reshape(Bz, S, *m.shape[1:])}
        return _mlstm_out(p, x, y, z), state
    if collect:
        # freeze across right-padding: f' = 1 (log f = 0), i' = 0 (log i =
        # −1e30), and the padding's positions must not fire the reset
        valid = _valid(ctx, x)
        logf = torch.where(valid[..., None], logf, 0.0)
        logi = torch.where(valid[..., None], logi, NEG)
        y, (C, n, m) = mlstm(q, k, v, logf, logi,
                             positions=torch.where(valid, ctx.positions, 1),
                             chunk=cfg.scan_chunk, return_state=True)
        state = {"conv": _conv_tail(x_in, valid.sum(-1), W),
                 "C": C, "n": n, "m": m}
        return _mlstm_out(p, x, y, z), state
    y = mlstm(q, k, v, logf, logi, positions=ctx.positions,
              chunk=cfg.scan_chunk)
    return _mlstm_out(p, x, y, z)


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device):
    """conv (B, W-1, pf) in the activation dtype; C (B, H, dh, dh), n (B,
    H, dh) and the stabiliser m (B, H) in f32, m empty at −1e30."""
    H = cfg.n_heads
    pf = int(cfg.proj_factor * cfg.d_model)
    dh = pf // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, pf),
                                dtype=dtype, device=device),
            "C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), NEG, **f32)}


def step_mlstm(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d); the conv is ``conv1d_pack_update`` (plain, as in the
    JAX package). Returns (x_t + block(x_t), new cache)."""
    hin = _norm(p["norm"], x_t, cfg.norm_eps)
    x_in = hin[:, 0] @ p["w_upx"].to(hin.dtype)
    z = hin[:, 0] @ p["w_upz"].to(hin.dtype)
    x_c, conv_state = conv1d_pack_update(
        x_in, cache["conv"], p["conv_w"].to(hin.dtype),
        p["conv_b"].to(hin.dtype), ctx.reset_t)
    q, k, v, logf, logi = _mlstm_heads(p, x_in, F.silu(x_c), cfg)
    y, (C, n, m) = mlstm_step((cache["C"], cache["n"], cache["m"]),
                              q, k, v, logf, logi, ctx.reset_t)
    return _mlstm_out(p, x_t, y, z), {"conv": conv_state, "C": C, "n": n,
                                      "m": m}


def chunk_mlstm(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One mLSTM block over a resumed slab: #1 through ``_conv_resume``,
    the recurrence from the carried (C, n, m)."""
    W = cfg.conv_width
    hin = _norm(p["norm"], x, cfg.norm_eps)
    x_in = hin @ p["w_upx"].to(hin.dtype)
    z = hin @ p["w_upz"].to(hin.dtype)
    x_c, ext = _conv_resume(x_in, cache["conv"], p["conv_w"].to(hin.dtype),
                            p["conv_b"].to(hin.dtype), ctx.positions)
    q, k, v, logf, logi = _mlstm_heads(p, x_in, F.silu(x_c), cfg)
    valid = _valid(ctx, x)
    logf = torch.where(valid[..., None], logf, 0.0)
    logi = torch.where(valid[..., None], logi, NEG)
    y, (C, n, m) = mlstm(q, k, v, logf, logi,
                         positions=torch.where(valid, ctx.positions, 1),
                         chunk=cfg.scan_chunk,
                         state=(cache["C"], cache["n"], cache["m"]),
                         return_state=True)
    state = {"conv": _conv_tail(ext, (W - 1) + valid.sum(-1), W),
             "C": C, "n": n, "m": m}
    return _mlstm_out(p, x, y, z), state


def slstm_param_shapes(cfg: ArchConfig):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    return {"norm": (d,), "w_pre": (d, 4 * d), "R": (4, H, dh, dh),
            "w_out": (d, d)}


def init_slstm(cfg: ArchConfig, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """One block's f32 parameters, from the distributions of the JAX
    package's ``init_slstm``."""
    d = cfg.d_model
    s = slstm_param_shapes(cfg)
    dh = s["R"][2]
    return {
        "norm": torch.ones(s["norm"], device=device),
        "w_pre": _randn(generator, s["w_pre"], device) * d ** -0.5,
        "R": _randn(generator, s["R"], device) * dh ** -0.5 * 0.3,
        "w_out": _randn(generator, s["w_out"], device) * d ** -0.5,
    }


def _slstm_pre(p, x, cfg: ArchConfig):
    """The gates' input preactivations (B, T, 4, H, dh)."""
    Bz, T, d = x.shape
    h = _norm(p["norm"], x, cfg.norm_eps)
    return (h @ p["w_pre"].to(h.dtype)).reshape(
        Bz, T, 4, cfg.n_heads, d // cfg.n_heads)


def _slstm_out(p, x, y):
    return x + y.reshape(x.shape) @ p["w_out"].to(x.dtype)


def apply_slstm(p, x, ctx: Ctx, cfg: ArchConfig, collect: bool = False,
                collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]: ``core.recurrence.slstm``, a
    loop over time."""
    Bz, L, _ = x.shape
    pre = _slstm_pre(p, x, cfg)
    if collect and collect_ends is not None:
        # per-SEGMENT handoff: the valid-freeze run of every segment (state
        # frozen outside it, so the row's final state is the one at its
        # last token) and the plain run for the output, folded into one
        # batch of B·(S+1) rows: one loop over time for all of them
        S = collect_ends.shape[1]
        msk = _segment_masks(ctx, S)
        pos = torch.cat([ctx.positions[:, None],
                         torch.where(msk, ctx.positions[:, None], 1)], dim=1)
        valid = torch.cat([torch.ones_like(msk[:, :1]), msk], dim=1)
        y, st = slstm(_fold_segments(pre, S + 1), p["R"],
                      positions=pos.reshape(Bz * (S + 1), L),
                      valid=valid.reshape(Bz * (S + 1), L),
                      return_state=True)
        y = y.reshape(Bz, S + 1, *y.shape[1:])[:, 0]
        c, n, m, hh = (t.reshape(Bz, S + 1, *t.shape[1:])[:, 1:]
                       for t in st)
        return _slstm_out(p, x, y), {"c": c, "n": n, "m": m, "h": hh}
    if collect:
        y, (c, n, m, hh) = slstm(pre, p["R"], positions=ctx.positions,
                                 valid=_valid(ctx, x), return_state=True)
        return _slstm_out(p, x, y), {"c": c, "n": n, "m": m, "h": hh}
    return _slstm_out(p, x, slstm(pre, p["R"], positions=ctx.positions))


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device):
    """c, n, h zero and m empty at −1e30, each (B, H, dh) f32."""
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, NEG, **f32),
            "h": torch.zeros(shape, **f32)}


def _slstm_state(cache):
    return tuple(cache[k] for k in ("c", "n", "m", "h"))


def step_slstm(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d): one step of the sLSTM loop from the cached state; a
    reset is position 0. Returns (x_t + block(x_t), new cache)."""
    pos = None
    if ctx.reset_t is not None:
        pos = torch.where(ctx.reset_t, 0, 1)[:, None]
    y, (c, n, m, hh) = slstm(_slstm_pre(p, x_t, cfg), p["R"], positions=pos,
                             state=_slstm_state(cache), return_state=True)
    return _slstm_out(p, x_t, y), {"c": c, "n": n, "m": m, "h": hh}


def chunk_slstm(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One sLSTM block over a resumed slab, from the carried state; the
    slab's padding freezes it."""
    y, (c, n, m, hh) = slstm(_slstm_pre(p, x, cfg), p["R"],
                             positions=ctx.positions,
                             state=_slstm_state(cache), valid=_valid(ctx, x),
                             return_state=True)
    return _slstm_out(p, x, y), {"c": c, "n": n, "m": m, "h": hh}


# ===========================================================================
# hybrid (RecurrentGemma) and dense blocks: RG-LRU, attention (local or
# full causal), gated MLP
# ===========================================================================
# The RG-LRU block's conv is ``conv1d_pack`` (kernels #1 and #2 on the
# card) in training, a packed prefill and a chunk slab; its decode step's
# conv is ``conv1d_pack_update`` (plain, as in the JAX package). Its scan,
# the attention and the MLP are plain PyTorch, as the JAX package runs
# them in XLA with no Pallas kernel: a dense layer launches no kernel of
# the port's own.


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return _gelu if name == "geglu" else F.silu


def mlp_param_shapes(cfg: ArchConfig):
    d, ff = cfg.d_model, cfg.d_ff
    return {"norm": (d,), "w_gate": (d, ff), "w_up": (d, ff),
            "w_down": (ff, d)}


def init_mlp(cfg: ArchConfig, generator: torch.Generator,
             device) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    s = mlp_param_shapes(cfg)
    return {"norm": torch.ones(s["norm"], device=device),
            "w_gate": _randn(generator, s["w_gate"], device) * d ** -0.5,
            "w_up": _randn(generator, s["w_up"], device) * d ** -0.5,
            "w_down": _randn(generator, s["w_down"], device) * ff ** -0.5}


def apply_mlp(p, x, ctx: Ctx, cfg: ArchConfig):
    """x + W_down(act(h W_gate) ⊙ h W_up), h the RMS-normed x."""
    h = _norm(p["norm"], x, cfg.norm_eps)
    g = _act(cfg.act)(h @ p["w_gate"].to(h.dtype))
    u = h @ p["w_up"].to(h.dtype)
    return x + (g * u) @ p["w_down"].to(x.dtype)


def rec_param_shapes(cfg: ArchConfig):
    d, W, nb = cfg.d_model, cfg.conv_width, cfg.lru_gate_blocks
    lw = cfg.lru_width or d
    if lw % nb:
        raise ValueError(f"lru_width {lw} % gate blocks {nb} != 0")
    c = lw // nb
    return {"norm": (d,), "w_x": (d, lw), "w_y": (d, lw), "conv_w": (W, lw),
            "conv_b": (lw,), "w_r": (nb, c, c), "w_i": (nb, c, c),
            "a_param": (lw,), "wo": (lw, d)}


def init_rec(cfg: ArchConfig, generator: torch.Generator,
             device) -> Dict[str, torch.Tensor]:
    """One block's f32 parameters, from the distributions of the JAX
    package's ``init_rec``: Λ such that a = exp(−c·softplus(Λ)) lies in
    [0.9, 0.999]."""
    d, W = cfg.d_model, cfg.conv_width
    s = rec_param_shapes(cfg)
    lw, c = s["w_x"][1], s["w_r"][1]
    u = 0.9 + 0.099 * torch.rand(s["a_param"], generator=generator,
                                 device=device)
    return {
        "norm": torch.ones(s["norm"], device=device),
        "w_x": _randn(generator, s["w_x"], device) * d ** -0.5,
        "w_y": _randn(generator, s["w_y"], device) * d ** -0.5,
        "conv_w": _randn(generator, s["conv_w"], device) * W ** -0.5,
        "conv_b": torch.zeros(s["conv_b"], device=device),
        "w_r": _randn(generator, s["w_r"], device) * c ** -0.5,
        "w_i": _randn(generator, s["w_i"], device) * c ** -0.5,
        "a_param": torch.log(torch.expm1(-torch.log(u) / RGLRU_C)),
        "wo": _randn(generator, s["wo"], device) * lw ** -0.5,
    }


def _gate_blockdiag(x_c, w, nb):
    """x_c (B, L, lw) → its block-diagonal projection by w (nb, c, c)."""
    Bz, L, lw = x_c.shape
    xb = x_c.reshape(Bz, L, nb, lw // nb)
    return torch.einsum("blnc,ncd->blnd", xb, w).reshape(Bz, L, lw)


def apply_rec(p, x, ctx: Ctx, cfg: ArchConfig, collect: int = 0,
              collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]: the RG-LRU over the conv of
    the x branch, gated by the tanh-GeLU y branch. The conv is
    ``conv1d_pack`` (#1 forward, #2 dx backward on the card), the scan
    ``core.recurrence.rglru`` (chunked, chunk ``scan_chunk``). With
    ``collect`` the decode state {"conv": the x branch's last W-1 inputs,
    "h": the f32 RG-LRU state} is handed off per row (frozen across the
    padding: r = i = 0 there, so a = 1 and b = 0, and the padding's
    positions never fire the reset) or, with ``collect_ends``, per segment
    (a gather of the f32 trajectory at each segment end)."""
    nb, dt = cfg.lru_gate_blocks, x.dtype
    h = _norm(p["norm"], x, cfg.norm_eps)
    y_branch = _gelu(h @ p["w_y"].to(dt))
    x_branch = h @ p["w_x"].to(dt)
    x_c = kops.conv1d_pack(x_branch, p["conv_w"].to(dt), p["conv_b"].to(dt),
                           ctx.positions)
    r = torch.sigmoid(_gate_blockdiag(x_c, p["w_r"].to(dt), nb))
    i = torch.sigmoid(_gate_blockdiag(x_c, p["w_i"].to(dt), nb))
    if collect and collect_ends is not None:
        lru, _, h_ends = rglru(x_c, r, i, p["a_param"], ctx.positions,
                               chunk=cfg.scan_chunk,
                               collect_ends=collect_ends)
        state = {"conv": _conv_tail_ends(x_branch, collect_ends,
                                         _ends_lens(ctx, collect_ends),
                                         cfg.conv_width),
                 "h": h_ends}
        return x + (lru * y_branch) @ p["wo"].to(dt), state
    pos = ctx.positions
    if collect:
        vmask = _valid(ctx, x)
        valid = vmask[..., None].to(r.dtype)
        r, i = r * valid, i * valid
        pos = torch.where(vmask, ctx.positions, 1)
    lru, h_last = rglru(x_c, r, i, p["a_param"], pos, chunk=cfg.scan_chunk)
    out = x + (lru * y_branch) @ p["wo"].to(dt)
    if collect:
        return out, {"conv": _conv_tail(x_branch, _valid(ctx, x).sum(-1),
                                        cfg.conv_width),
                     "h": h_last}
    return out


def init_rec_cache(cfg: ArchConfig, batch: int, dtype, device):
    """conv (B, W-1, lru_width) in the activation dtype, h (B, lru_width)
    f32."""
    lw = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, lw), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, lw), dtype=torch.float32,
                             device=device)}


def step_rec(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d); the conv is ``conv1d_pack_update`` (plain, as in the
    JAX package). Returns (x_t + block(x_t), new cache)."""
    nb, dt = cfg.lru_gate_blocks, x_t.dtype
    h = _norm(p["norm"], x_t, cfg.norm_eps)
    y_branch = _gelu(h[:, 0] @ p["w_y"].to(dt))
    x_branch = h[:, 0] @ p["w_x"].to(dt)
    x_c, conv_state = conv1d_pack_update(
        x_branch, cache["conv"], p["conv_w"].to(dt), p["conv_b"].to(dt),
        ctx.reset_t)
    r = torch.sigmoid(_gate_blockdiag(x_c[:, None], p["w_r"].to(dt),
                                      nb)[:, 0])
    i = torch.sigmoid(_gate_blockdiag(x_c[:, None], p["w_i"].to(dt),
                                      nb)[:, 0])
    y, hn = rglru_step(cache["h"], x_c, r, i, p["a_param"], ctx.reset_t)
    out = (y * y_branch) @ p["wo"].to(dt)
    return x_t + out[:, None], {"conv": conv_state, "h": hn}


def chunk_rec(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One RG-LRU block over a resumed slab: #1 through ``_conv_resume``
    (the carried tail at W-1 leading zero positions), the scan from
    ``h0 = cache["h"]``, frozen across the slab's padding."""
    nb, dt, W = cfg.lru_gate_blocks, x.dtype, cfg.conv_width
    h = _norm(p["norm"], x, cfg.norm_eps)
    y_branch = _gelu(h @ p["w_y"].to(dt))
    x_branch = h @ p["w_x"].to(dt)
    x_c, ext = _conv_resume(x_branch, cache["conv"], p["conv_w"].to(dt),
                            p["conv_b"].to(dt), ctx.positions)
    r = torch.sigmoid(_gate_blockdiag(x_c, p["w_r"].to(dt), nb))
    i = torch.sigmoid(_gate_blockdiag(x_c, p["w_i"].to(dt), nb))
    vmask = _valid(ctx, x)
    valid = vmask[..., None].to(r.dtype)
    lru, h_last = rglru(x_c, r * valid, i * valid, p["a_param"],
                        torch.where(vmask, ctx.positions, 1), h0=cache["h"],
                        chunk=cfg.scan_chunk)
    state = {"conv": _conv_tail(ext, (W - 1) + vmask.sum(-1), W),
             "h": h_last}
    return x + (lru * y_branch) @ p["wo"].to(dt), state


def attn_param_shapes(cfg: ArchConfig):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"norm": (d,), "wq": (d, H * hd), "wkv": (d, 2 * Hkv * hd),
            "wo": (H * hd, d)}


def init_attn(cfg: ArchConfig, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    s = attn_param_shapes(cfg)
    return {"norm": torch.ones(s["norm"], device=device),
            "wq": _randn(generator, s["wq"], device) * d ** -0.5,
            "wkv": _randn(generator, s["wkv"], device) * d ** -0.5,
            "wo": _randn(generator, s["wo"], device) * (H * hd) ** -0.5}


def _apply_rope(cfg: ArchConfig, q, k, ctx: Ctx):
    """Plain RoPE over the intra-sequence positions (M-RoPE is 5e's)."""
    if ctx.positions is not None:
        q = rope(q, ctx.positions, cfg.rope_theta)
        k = rope(k, ctx.positions, cfg.rope_theta)
    return q, k


def _attn_qkv(p, x, ctx: Ctx, cfg: ArchConfig):
    """q (B, L, H, hd) and k, v (B, L, Hkv, hd), RoPE on q and k."""
    Bz, L, _ = x.shape
    H, Hkv, hd, dt = cfg.n_heads, cfg.n_kv_heads, cfg.hd, x.dtype
    h = _norm(p["norm"], x, cfg.norm_eps)
    q = (h @ p["wq"].to(dt)).reshape(Bz, L, H, hd)
    kv = (h @ p["wkv"].to(dt)).reshape(Bz, L, 2, Hkv, hd)
    q, k = _apply_rope(cfg, q, kv[:, :, 0], ctx)
    return q, k, kv[:, :, 1]


def ring_size(cfg: ArchConfig, max_len: int) -> int:
    """The K/V ring's slots: the window bounds the decode state; without
    one it is ``max_len``, the whole context (a dense layer)."""
    return max_len if cfg.attn_window is None else \
        min(max_len, cfg.attn_window)


def apply_attn(p, x, ctx: Ctx, cfg: ArchConfig, collect: int = 0,
               collect_ends=None):
    """x (B, L, d) → x + block(x) [, state]: causal attention under the
    segment mask, within ``attn_window`` keys when the config has one
    (the hybrid's local attention) and over the whole segment without (a
    dense layer), RoPE on intra-sequence positions. ``collect`` is the
    cache's ``max_len``: the post-RoPE K/V are laid into a ring of
    ``ring_size`` slots per row (``_ring_fill``) or, with
    ``collect_ends``, per segment (``_ring_fill_ends``); without a window
    S = max_len, so slot t holds token t."""
    Bz, L, _ = x.shape
    q, k, v = _attn_qkv(p, x, ctx, cfg)
    chunk = cfg.attn_chunk
    if chunk is None and L > 4096:
        chunk = 1024                       # online softmax for long rows
    o = attention(q, k, v, segment_ids_q=ctx.segment_ids,
                  segment_ids_kv=ctx.segment_ids, causal=True,
                  window=cfg.attn_window, chunk_kv=chunk)
    out = x + o.reshape(Bz, L, -1) @ p["wo"].to(x.dtype)
    if not collect:
        return out
    S = ring_size(cfg, collect)
    if collect_ends is not None:
        return out, _ring_fill_ends(k, v, collect_ends,
                                    _ends_lens(ctx, collect_ends), S)
    return out, _ring_fill(k, v, _valid(ctx, x).sum(-1), S)


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device):
    """k, v (B, S, Hkv, hd) in the activation dtype, S = ``ring_size``."""
    shape = (batch, ring_size(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ring_slots(nb, S):
    """For a prefix of ``nb`` tokens (…, 1): the token t ≡ s (mod S) each
    ring slot s holds (the last such t < nb), and whether it holds one."""
    s = torch.arange(S, device=nb.device)
    t = s + torch.div(nb - 1 - s, S, rounding_mode="floor") * S
    return t, (s < nb) & (t >= 0)


def _ring_fill(k, v, lens, S):
    """A prefill's K/V (B, L, Hkv, hd) in the ring layout ``step_attn``
    uses: slot s holds the last token t < len with t ≡ s (mod S); slots
    that hold none are zero."""
    L = k.shape[1]
    t, ok = _ring_slots(lens.long()[:, None], S)           # (B, S)
    rows = _rows(k)[:, None]
    tcl = t.clamp(0, L - 1)
    m = ok[..., None, None]
    return {"k": torch.where(m, k[rows, tcl], 0.0),
            "v": torch.where(m, v[rows, tcl], 0.0)}


def _ring_fill_ends(k, v, ends, lens, S):
    """Per SEGMENT ring fill: slot s of segment (b, g) holds that segment's
    last token whose intra-segment position is ≡ s (mod S); zeros where it
    has none and for absent segments (``ends`` −1). Returns K/V (B, Sg, S,
    Hkv, hd)."""
    L = k.shape[1]
    nb = lens.long()[..., None]                            # (B, Sg, 1)
    pos, ok = _ring_slots(nb, S)                           # (B, Sg, S)
    e = ends.long()[..., None]
    ok = ok & (e >= 0)
    t = (e - (nb - 1) + pos).clamp(0, L - 1)               # buffer index
    rows = _rows(k)[:, None, None]
    m = ok[..., None, None]
    return {"k": torch.where(m, k[rows, t], 0.0),
            "v": torch.where(m, v[rows, t], 0.0)}


def step_attn(p, x_t, cache, ctx: Ctx, cfg: ArchConfig):
    """x_t (B, 1, d); cache {"k", "v"} (B, S, Hkv, hd). RoPE at
    ``ctx.cache_len``, the token's K/V written into slot cache_len % S of
    the given cache (in place), then attention over the ring
    (``_ring_decode``; ``core.attention.decode_attention`` without a
    window). Returns (x_t + block(x_t), the cache)."""
    Bz = x_t.shape[0]
    q, k, v = _attn_qkv(p, x_t, Ctx(positions=ctx.cache_len[:, None]), cfg)
    kc, vc = cache["k"], cache["v"]
    rows = _rows(x_t)
    slot = ctx.cache_len.long() % kc.shape[1]
    kc[rows, slot] = k[:, 0]
    vc[rows, slot] = v[:, 0]
    if cfg.attn_window is not None:
        o = _ring_decode(q[:, 0], kc, vc, ctx.cache_len, cfg.attn_window)
    else:
        o = decode_attention(q[:, 0], kc, vc, ctx.cache_len)
    o = o.reshape(Bz, 1, -1) @ p["wo"].to(x_t.dtype)
    return x_t + o, {"k": kc, "v": vc}


def _ring_decode(q_t, kc, vc, cur, window):
    """Decode attention over a ring of S slots: slot s is ``(cur % S − s)
    % S`` tokens old and valid when that age is under the window and at
    most ``cur`` (so the slots a fill left empty, or a fresh tenant's, are
    masked whatever they hold); masked scores are −1e30, as JAX's."""
    Bz, S, Hkv, hd = kc.shape
    H = q_t.shape[1]
    cur = cur.long()[:, None]
    idx = torch.arange(S, device=q_t.device)[None, :]
    age = torch.remainder(torch.remainder(cur, S) - idx, S)
    valid = (age < window) & (age <= cur)
    s = _gqa_scores(q_t.reshape(Bz, 1, Hkv, H // Hkv, hd), kc,
                    hd ** -0.5)[:, :, :, 0]                # (B,Hkv,G,S)
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(vc.dtype), vc)
    return o.reshape(Bz, H, hd)


def chunk_attn(p, x, cache, ctx: Ctx, cfg: ArchConfig):
    """One attention block over a resumed slab (B, T): one joint softmax
    over the cached prefix ring and the slab's causal keys, THEN the slab's
    post-RoPE K/V written into their ring slots (the write may evict
    prefix slots the slab itself still attends to, so the order matters).
    Valid tokens land at position % S (distinct, since T ≤ S); padding is
    never written. Raises when T > S."""
    Bz, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = cache["k"].shape[1]
    if T > S:
        raise ValueError(f"chunk length {T} exceeds attention cache/window "
                         f"{S} — use a chunk size ≤ the attention window")
    q, k, v = _attn_qkv(p, x, ctx, cfg)
    valid = _valid(ctx, x)
    pos = ctx.positions.long()
    t_s, pref_ok = _ring_slots(ctx.cache_len.long()[:, None], S)  # (B, S)
    qr = q.reshape(Bz, T, Hkv, H // Hkv, hd)
    scale = hd ** -0.5
    sc_pre = torch.einsum("btkgd,bskd->btkgs", qr.float(),
                          cache["k"].float()) * scale
    m_pre = pref_ok[:, None, :]                            # (B, 1, S)
    if cfg.attn_window is not None:
        m_pre = m_pre & (t_s[:, None, :] > pos[:, :, None] - cfg.attn_window)
    sc_pre = torch.where(m_pre[:, :, None, None, :], sc_pre, NEG_INF)
    sc_in = torch.einsum("btkgd,bjkd->btkgj", qr.float(), k.float()) * scale
    ar = torch.arange(T, device=x.device)
    m_in = (pos[:, :, None] >= pos[:, None, :]) & valid[:, None, :] & \
        (ar[None, :, None] >= ar[None, None, :])
    if cfg.attn_window is not None:
        m_in = m_in & (pos[:, None, :] > pos[:, :, None] - cfg.attn_window)
    sc_in = torch.where(m_in[:, :, None, None, :], sc_in, NEG_INF)
    pr = torch.softmax(torch.cat([sc_pre, sc_in], dim=-1),
                       dim=-1).to(v.dtype)
    o = torch.einsum("btkgs,bskd->btkgd", pr[..., :S], cache["v"]) + \
        torch.einsum("btkgj,bjkd->btkgd", pr[..., S:], v)
    out = x + o.reshape(Bz, T, H * hd) @ p["wo"].to(x.dtype)
    # the write, after attending: slot s takes the slab token that lands
    # there (src[b, s], −1 for none); padding goes to the dropped column S
    slot = torch.where(valid, pos % S, S)
    src = torch.full((Bz, S + 1), -1, dtype=torch.long, device=x.device)
    src.scatter_(1, slot, ar.expand(Bz, T).contiguous())
    src = src[:, :S]
    m = (src >= 0)[..., None, None]
    rows = _rows(x)[:, None]
    take = src.clamp(min=0)
    return out, {"k": torch.where(m, k[rows, take], cache["k"]),
                 "v": torch.where(m, v[rows, take], cache["v"])}


CHUNK = {"mamba": chunk_mamba, "mamba2": chunk_mamba2, "mlstm": chunk_mlstm,
         "slstm": chunk_slstm, "rec": chunk_rec, "attn": chunk_attn}


# Per layer kind: (init, parameter shapes, apply, decode cache, decode
# step); the attention's decode cache (local or full) also takes
# ``max_len`` (``init_attn_cache``)
KINDS = {
    "mamba": (init_mamba, mamba_param_shapes, apply_mamba, init_mamba_cache,
              step_mamba),
    "mamba2": (init_mamba2, mamba2_param_shapes, apply_mamba2,
               init_mamba2_cache, step_mamba2),
    "mlstm": (init_mlstm, mlstm_param_shapes, apply_mlstm, init_mlstm_cache,
              step_mlstm),
    "slstm": (init_slstm, slstm_param_shapes, apply_slstm, init_slstm_cache,
              step_slstm),
    "rec": (init_rec, rec_param_shapes, apply_rec, init_rec_cache, step_rec),
    "attn": (init_attn, attn_param_shapes, apply_attn, init_attn_cache,
             step_attn),
}
# the MLP sub-block that follows each hybrid or dense layer's block when
# d_ff > 0: (init, parameter shapes, apply)
MLP = (init_mlp, mlp_param_shapes, apply_mlp)
# the layer kinds of each family the port has
FAMILY_KINDS = {"mamba": {"mamba", "mamba2"}, "xlstm": {"mlstm", "slstm"},
                "hybrid": {"rec", "attn"}, "dense": {"attn"}}


def layer_kinds(cfg: ArchConfig):
    """Each layer's kind: layer ``i`` is ``cfg.unit[i % len(cfg.unit)]`` (the
    JAX layout: whole units, then tail layers that reuse the unit's
    prefix). Raises on a family or kind the port does not have."""
    unit = cfg.unit
    if not set(unit) <= FAMILY_KINDS.get(cfg.family, set()):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}, unit {unit}; the port has "
            f"the Mamba-1 and Mamba-2 blocks, the xLSTM (mLSTM, sLSTM) "
            f"blocks, the hybrid (RG-LRU, local attention) blocks and the "
            f"dense (full attention) block only: no MoE, audio or VLM")
    if cfg.family == "xlstm" and cfg.d_ff:
        raise NotImplementedError(
            f"{cfg.name}: d_ff = {cfg.d_ff} on an xLSTM unit; the port has "
            f"no MLP wired for that family yet")
    return tuple(unit[i % len(unit)] for i in range(cfg.n_layers))


def has_mlp(cfg: ArchConfig) -> bool:
    """True when every layer ends in the gated MLP: a hybrid or dense
    config with d_ff (the JAX rule for its ``rec`` and ``attn`` layers; an
    xLSTM unit with d_ff is refused by ``layer_kinds``)."""
    return cfg.family in ("hybrid", "dense") and cfg.d_ff > 0


def unit_layout(cfg: ArchConfig):
    """(param_name, kind) pairs of one pattern unit, the JAX package's
    ``unit_layout``: ``<j>_<kind>`` for the block at unit position j, then
    ``<j>_ffn`` (kind ``mlp``) when the layer has an MLP."""
    out = []
    for j, kind in enumerate(cfg.unit):
        out.append((f"{j}_{kind}", kind))
        if has_mlp(cfg):
            out.append((f"{j}_ffn", "mlp"))
    return tuple(out)


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
