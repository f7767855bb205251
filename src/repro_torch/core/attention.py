"""Packed (segment-masked) attention (port of ``rope_freqs``, ``rope``,
``_pair_mask``, ``_gqa_scores``, ``attention`` and ``decode_attention`` of
``repro.core.attention``).

For attention the paper's technique is the block-diagonal mask: sequences
packed back to back, and the causal mask replaced by ``causal ∧ same
segment ∧ segment ≠ 0`` (with a sliding window, on buffer indices).
``attention`` is GQA/MQA/MHA over either materialised scores or an
online-softmax walk over KV chunks (the Rabe–Staats/Flash recurrence),
each step the JAX einsum's arithmetic in plain PyTorch: no library
attention kernel, so the CPU tests hold the arithmetic the card runs. The
JAX package runs it in XLA, with no Pallas kernel.

Layouts: q (B, Lq, H, Dh); k, v (B, Lkv, Hkv, Dh) with H % Hkv == 0.
``decode_attention`` is one query token over a (B, S, Hkv, Dh) K/V cache.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps online softmax NaN-free


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x (B, L, H, Dh); positions (B, L) int — intra-sequence positions
    (buffer positions would break packing invariance)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    ang = positions.float()[..., None] * freqs                # (B, L, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _pair_mask(q_idx, kv_idx, seg_q, seg_kv, causal, window):
    """Boolean (…, Lq, Lkv) allow-mask from index and segment tensors."""
    qi = q_idx[..., :, None]
    ki = kv_idx[..., None, :]
    m = torch.ones(q_idx.shape[:-1] + (q_idx.shape[-1], kv_idx.shape[-1]),
                   dtype=torch.bool, device=q_idx.device)
    if causal:
        m = m & (ki <= qi)
    if window is not None:
        m = m & ((qi - ki) < window)
        if not causal:
            m = m & ((ki - qi) < window)
    if seg_q is not None:
        sq = seg_q[..., :, None]
        sk = seg_kv[..., None, :]
        m = m & (sq == sk) & (sq != 0)
    return m


def _gqa_scores(q, k, scale):
    """q (B, Lq, Hkv, G, Dh); k (B, T, Hkv, Dh) → (B, Hkv, G, Lq, T) f32:
    the product in f32, as the JAX einsum's ``preferred_element_type``
    keeps it (bf16 scores would round before the softmax)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              segment_ids_q: Optional[torch.Tensor] = None,
              segment_ids_kv: Optional[torch.Tensor] = None,
              causal: bool = True, window: Optional[int] = None,
              chunk_kv: Optional[int] = None) -> torch.Tensor:
    """Segment-masked attention. Returns (B, Lq, H, Dh) in q's dtype.

    ``chunk_kv``: if set and shorter than Lkv, the online-softmax
    recurrence over KV chunks of this size (Lkv must be a multiple of it);
    peak memory O(Lq · chunk) in place of O(Lq · Lkv). A query row whose
    every key is masked (padding) gives exactly 0, and no gradient."""
    B, Lq, H, Dh = q.shape
    Lkv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} not divisible by Hkv={Hkv}")
    G = H // Hkv
    scale = Dh ** -0.5
    qg = q.reshape(B, Lq, Hkv, G, Dh)
    q_idx = torch.arange(Lq, device=q.device).expand(B, Lq)
    if segment_ids_q is None or segment_ids_kv is None:
        segment_ids_q = segment_ids_kv = None
    if chunk_kv is None or Lkv <= chunk_kv:
        kv_idx = torch.arange(Lkv, device=q.device).expand(B, Lkv)
        mask = _pair_mask(q_idx, kv_idx, segment_ids_q, segment_ids_kv,
                          causal, window)[:, None, None]   # (B,1,1,Lq,Lkv)
        s = torch.where(mask, _gqa_scores(qg, k, scale), NEG_INF)
        p = torch.softmax(s, dim=-1)
        # all-masked rows (padding queries): exactly 0
        p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
        return o.reshape(B, Lq, H, Dh)

    # ---- online softmax over KV chunks (the flash recurrence) ----
    if Lkv % chunk_kv:
        raise ValueError(f"Lkv={Lkv} not divisible by chunk_kv={chunk_kv}")
    m = torch.full((B, Hkv, G, Lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Lq, Dh), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Lkv, chunk_kv):
        kb, vb = k[:, c0:c0 + chunk_kv], v[:, c0:c0 + chunk_kv]
        kv_idx = c0 + torch.arange(chunk_kv, device=q.device).expand(
            B, chunk_kv)
        sb = (segment_ids_kv[:, c0:c0 + chunk_kv]
              if segment_ids_kv is not None else None)
        mask = _pair_mask(q_idx, kv_idx, segment_ids_q, sb, causal,
                          window)[:, None, None]           # (B,1,1,Lq,chunk)
        s = torch.where(mask, _gqa_scores(qg, kb, scale), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vb.to(p.dtype))
        m = m_new
    o = torch.where(l[..., None] > 0, acc / torch.clamp(l[..., None],
                                                        min=1e-20), 0.0)
    o = o.movedim(-2, 1)                                   # (B,Lq,Hkv,G,Dh)
    return o.reshape(B, Lq, H, Dh).to(q.dtype)


def decode_attention(q_t: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode over a linear cache. q_t (B, H, Dh); caches (B, S,
    Hkv, Dh); cache_len (B,) the new token's index (entries 0..cache_len
    are valid, the last ``window`` of them with a window). QKᵀ in f32 from
    the caches' dtype, the softmax in f32, P cast to V's dtype before PV,
    as the JAX einsums. Returns (B, H, Dh)."""
    B, S, Hkv, Dh = k_cache.shape
    H = q_t.shape[1]
    s = _gqa_scores(q_t.reshape(B, 1, Hkv, H // Hkv, Dh), k_cache,
                    Dh ** -0.5)[:, :, :, 0]                # (B,Hkv,G,S)
    idx = torch.arange(S, device=q_t.device)[None, :]
    cur = cache_len.long()[:, None]
    valid = idx <= cur
    if window is not None:
        valid = valid & ((cur - idx) < window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, Dh)
