"""The Mamba language model (port of ``repro.models.lm`` for family
``mamba``): embedding → ``n_layers`` Mamba-1 or Mamba-2 blocks (the
config's ``unit``) → RMSNorm → head.

``LM`` is an ``nn.Module`` that holds its parameters under the JAX
package's names (``embed``, ``layers.<i>.<block leaf>``, ``final_norm``,
``head``); ``interop.params_from_jax`` maps a JAX tree onto them.

Training: ``loss`` is the packed next-token cross-entropy; the parameters
track gradients, ``remat="unit"`` recomputes each layer in the backward
(``torch.utils.checkpoint``) and the vocab logits exist one L-chunk at a
time. Serving: ``forward``, ``prefill``, ``prefill_packed``,
``prefill_chunk`` (resumable prefill of a long prompt, slab by slab),
``decode_step``, ``decode_step_sample`` / ``sample_tokens`` (batched
sampling), their guarded forms with the finiteness probes
(``decode_step_sample_guarded``, ``decode_step_greedy_guarded``,
``prefill_probe``, ``chunk_probe``), ``scatter_into_cache`` and
``reset_cache_rows`` run under ``torch.no_grad()``, so they build no
autograd graph.

Caches and harvested states keep the JAX package's stacked layout with the
layer axis first: a decode cache is ``{"conv": (n_layers, slots, W-1, di),
"ssm": (n_layers, slots, di, N)}`` (Mamba-1) or ``"ssm": (n_layers, slots,
H, P, N)`` (Mamba-2), and a packed prefill's states carry
``(n_layers, B, S, …)``. ``decode_step``, ``prefill_chunk``,
``reset_cache_rows`` and ``scatter_into_cache`` update the cache in place
(JAX's versions return a new one), so the engine holds one cache's worth of
device memory.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models.blocks import Ctx


class LM(nn.Module):
    """Built on ``device`` (default ``cuda``; raises when there is no card).
    The parameters are allocated, not initialised: call ``init(generator)``
    or ``load_state_dict(interop.params_from_jax(...))``. Every layer is of
    ``cfg.unit``'s kind (``mamba`` or ``mamba2``); any other raises."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        (self._init_block, shapes_of, self._apply_block, self._cache_block,
         self._step_block) = B.kind_of(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        pdt = getattr(torch, cfg.param_dtype)

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=pdt,
                                            device=self.device))

        shapes = shapes_of(cfg)
        self.embed = param((cfg.vocab, cfg.d_model))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: param(s) for k, s in shapes.items()})
            for _ in range(cfg.n_layers))
        self.final_norm = param((cfg.d_model,))
        self.head = param((cfg.d_model, cfg.vocab))

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights from the JAX package's distributions. The
        generator must live on the model's device."""
        cfg, dev = self.cfg, self.device
        self.embed.copy_(B._randn(generator, self.embed.shape, dev) * 0.02)
        for layer in self.layers:
            for k, v in self._init_block(cfg, generator, dev).items():
                layer[k].copy_(v)
        self.final_norm.fill_(1.0)
        self.head.copy_(B._randn(generator, self.head.shape, dev)
                        * cfg.d_model ** -0.5)
        return self

    # ------------------------------------------------------------- embedding
    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v, device=self.device)
                for k, v in batch.items()}

    def _embed(self, tokens) -> torch.Tensor:
        return self.embed[tokens.long()].to(getattr(torch, self.cfg.dtype))

    def _ctx(self, batch) -> Ctx:
        return Ctx(positions=batch.get("positions"),
                   segment_ids=batch.get("segment_ids"))

    def _logits(self, x) -> torch.Tensor:
        return (x @ self.head.to(x.dtype)).float()

    # ----------------------------------------------------------- forward
    def _stack(self, x, ctx) -> torch.Tensor:
        remat = self.cfg.remat == "unit" and torch.is_grad_enabled()
        for p in self.layers:
            if remat:
                x = checkpoint(self._apply_block, p, x, ctx, self.cfg,
                               use_reentrant=False)
            else:
                x = self._apply_block(p, x, ctx, self.cfg)
        return B._norm(self.final_norm, x, self.cfg.norm_eps)

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        """Full logits (B, L, V) f32 — small models and tests only."""
        batch = self._batch(batch)
        x = self._stack(self._embed(batch["tokens"]), self._ctx(batch))
        return self._logits(x)

    # ----------------------------------------------------------- loss
    def _chunk_ce(self, xc, lc):
        logits = self._logits(xc)                          # (B, C, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum()

    def loss(self, batch, loss_chunk: int = 512):
        """Packed next-token CE (port of the JAX ``LM.loss``): a token's
        label is the next token of its segment (−1, masked, at a segment's
        last token and on padding). The (B, L, V) f32 logits never exist
        whole: each L-chunk's CE is checkpointed, so its logits are
        recomputed in the backward. Returns (loss, {"ce", "tokens"})."""
        batch = self._batch(batch)
        x = self._stack(self._embed(batch["tokens"]), self._ctx(batch))
        seg, tok = batch["segment_ids"], batch["tokens"].long()
        nxt_same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
        labels = torch.where(nxt_same, tok[:, 1:], -1)
        labels = torch.cat([labels, torch.full_like(labels[:, :1], -1)],
                           dim=1)
        L = x.shape[1]
        nchunk = max(1, L // min(loss_chunk, L))
        if L % nchunk:
            nchunk = 1
        C = L // nchunk
        tot = cnt = 0.0
        for i in range(nchunk):
            sl = slice(i * C, (i + 1) * C)
            t, c = checkpoint(self._chunk_ce, x[:, sl], labels[:, sl],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        loss = tot / cnt.clamp(min=1.0)
        return loss, {"ce": loss.detach(), "tokens": cnt}

    def _collect(self, x, ctx, ends=None):
        convs, ssms = [], []
        for p in self.layers:
            x, st = self._apply_block(p, x, ctx, self.cfg, collect=True,
                                      collect_ends=ends)
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        return x, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}

    @torch.no_grad()
    def prefill(self, batch):
        """Serving prefill of left-aligned prompts, one per row
        (segment_ids mark validity): one forward that also hands off every
        layer's decode cache. Returns (last_logits (B, V), cache,
        cache_len (B,))."""
        batch = self._batch(batch)
        lens = (batch["segment_ids"] > 0).sum(-1).to(torch.int32)
        x, cache = self._collect(self._embed(batch["tokens"]),
                                 self._ctx(batch))
        xlast = x[torch.arange(x.shape[0], device=x.device),
                  (lens.long() - 1).clamp(min=0)]
        return self._logits(xlast), cache, lens

    @torch.no_grad()
    def prefill_packed(self, batch, ends):
        """Packed multi-prompt prefill: ONE forward over packed rows that
        hands off a decode state for every segment. ``ends`` (B, S) is each
        segment's last-token index in its row (−1 = absent).

        Returns (logits (B, S, V) at segment ends, zeros where absent;
        states {"conv": (n_layers, B, S, W-1, di), "ssm": (n_layers, B, S,
        di, N) or (n_layers, B, S, H, P, N)}; seg_lens (B, S) int32, 0 where
        absent)."""
        batch = self._batch(batch)
        ends = torch.as_tensor(ends, device=self.device)
        ctx = self._ctx(batch)
        x, states = self._collect(self._embed(batch["tokens"]), ctx, ends)
        L = x.shape[1]
        xe = x[torch.arange(x.shape[0], device=x.device)[:, None],
               ends.long().clamp(0, L - 1)]
        logits = torch.where((ends >= 0)[..., None], self._logits(xe), 0.0)
        return logits, states, B._ends_lens(ctx, ends)

    @torch.no_grad()
    def scatter_into_cache(self, cache, states, src, dst):
        """Land harvested per-segment states in decode slots, in place.

        states: from ``prefill_packed``; src (M,) flat indices into the B·S
        segment axis; dst (M,) target slots. Entries with dst outside
        [0, n_slots) are dropped (n_slots is the engine's sentinel).
        Returns the cache."""
        src = torch.as_tensor(src, device=self.device).long()
        dst = torch.as_tensor(dst, device=self.device).long()
        n_slots = cache["ssm"].shape[1]
        keep = (dst >= 0) & (dst < n_slots)
        src, dst = src[keep], dst[keep]
        for k, c in cache.items():
            s = states[k]
            flat = s.reshape((s.shape[0], -1) + tuple(s.shape[3:]))
            c[:, dst] = flat[:, src].to(c.dtype)
        return cache

    # ----------------------------------------------------------- decode
    def init_cache(self, batch_size: int) -> Dict[str, torch.Tensor]:
        one = self._cache_block(self.cfg, batch_size,
                                getattr(torch, self.cfg.dtype), self.device)
        return {k: v[None].repeat((self.cfg.n_layers,) + (1,) * v.dim())
                for k, v in one.items()}

    @torch.no_grad()
    def decode_step(self, cache, tokens_t, reset: Optional[torch.Tensor] = None):
        """tokens_t (B, 1); reset (B,) bool or None. Advances every layer's
        cache in place; returns (logits (B, V) f32, cache)."""
        tokens_t = torch.as_tensor(tokens_t, device=self.device)
        x = self._embed(tokens_t)
        ctx = Ctx(reset_t=reset)
        for i, p in enumerate(self.layers):
            x, st = self._step_block(
                p, x, {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
                ctx, self.cfg)
            cache["conv"][i].copy_(st["conv"])
            cache["ssm"][i].copy_(st["ssm"])
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        return self._logits(x[:, 0]), cache

    @torch.no_grad()
    def decode_step_sample(self, cache, tokens_t, stream, ctr, temperature,
                           top_k, top_p, reset: Optional[torch.Tensor] = None):
        """One decode + batched-sampling step over all slots: the sampled
        token never goes to the host between the forward and the sample.
        stream, ctr (B,) int64 per-slot noise stream and token counter;
        temperature/top_k/top_p (B,) per-slot knobs (``blocks.
        sample_from_logits``). Returns (tokens (B,) int32, logits (B, V)
        f32, cache, ctr + 1)."""
        logits, cache = self.decode_step(cache, tokens_t, reset)
        tok, ctr = B.sample_from_logits(logits, stream, ctr, temperature,
                                        top_k, top_p)
        return tok, logits, cache, ctr

    @torch.no_grad()
    def decode_step_sample_guarded(self, cache, tokens_t, stream, ctr,
                                   temperature, top_k, top_p, poison,
                                   reset: Optional[torch.Tensor] = None):
        """``decode_step_sample`` with the engine's guard rail: a per-slot
        finiteness probe of the decode logits (one (B, V) ``isfinite`` and
        an all-reduce a row), so a slot is caught the step it goes bad.
        ``poison`` (B,) f32 is the fault-injection seam, added to the
        logits before the probe and the sampler: all zeros in production,
        a bitwise no-op on every finite logit, so guarded streams equal
        unguarded ones. Returns (tokens (B,) int32, logits (B, V) f32,
        cache, ctr + 1, finite (B,) bool)."""
        logits, cache = self.decode_step(cache, tokens_t, reset)
        logits = logits + poison[:, None]
        finite = torch.isfinite(logits).all(-1)
        tok, ctr = B.sample_from_logits(logits, stream, ctr, temperature,
                                        top_k, top_p)
        return tok, logits, cache, ctr, finite

    @torch.no_grad()
    def decode_step_greedy_guarded(self, cache, tokens_t, poison,
                                   reset: Optional[torch.Tensor] = None):
        """The plain argmax step with the same guard rail and poison seam
        (the JAX engine's ``greedy_step_guarded``). Returns (tokens (B,)
        int32, cache, finite (B,) bool)."""
        logits, cache = self.decode_step(cache, tokens_t, reset)
        logits = logits + poison[:, None]
        return (B.greedy_tokens(logits), cache,
                torch.isfinite(logits).all(-1))

    @torch.no_grad()
    def prefill_probe(self, states, logits):
        """Per-segment finiteness of a packed prefill's harvest: True at
        (b, s) iff every state leaf of that segment, in every layer, and
        its end logits are finite. ``states`` from ``prefill_packed``
        ((n_layers, B, S, …) leaves), ``logits`` (B, S, V). Absent
        segments (zero states, zero logits) probe True."""
        ok = torch.isfinite(logits).all(-1)
        for a in states.values():
            if a.is_floating_point():
                ok = ok & torch.isfinite(a).all(0).flatten(2).all(-1)
        return ok

    def chunk_probe(self, cache, logits):
        """The chunk lane's handoff probe: ``prefill_probe`` over a chunk
        cache viewed as one-segment harvests (``expand_chunk_states``) and
        its rows' end logits (R, V). Returns (R,) bool."""
        return self.prefill_probe(self.expand_chunk_states(cache),
                                  logits[:, None])[:, 0]

    @torch.no_grad()
    def sample_tokens(self, logits, stream, ctr, temperature, top_k, top_p):
        """Sample one token per row of already computed logits (a packed
        prefill's flattened (K, V) segment-end logits, or a chunk round's).
        Returns (tokens (K,) int32, ctr + 1)."""
        return B.sample_from_logits(logits, stream, ctr, temperature, top_k,
                                    top_p)

    # -------------------------------------------------- chunk-resume prefill
    @property
    def supports_chunked_prefill(self) -> bool:
        """True when every layer kind has a chunk-resume step
        (``blocks.CHUNK``): the serve engine's gate for prompts longer
        than its largest prefill bucket."""
        return all(kind in B.CHUNK for kind in self.cfg.unit)

    @torch.no_grad()
    def prefill_chunk(self, cache, batch, cache_len):
        """Advance a DECODE-layout cache by one (B, T) slab of long prompts,
        in place: resumable prefill from the carried O(1) state. ``batch``
        holds the slab's tokens/positions/segment_ids (positions GLOBAL,
        segment_ids 0 marks trailing padding; an all-padding row is an
        exact no-op); ``cache_len`` (B,) counts the tokens consumed before.
        Returns (logits (B, V) f32 at each row's last valid slab token,
        cache, cache_len + the slab's valid tokens)."""
        batch = self._batch(batch)
        x = self._embed(batch["tokens"])
        ctx = self._ctx(batch)
        chunk = B.CHUNK[self.cfg.unit[0]]
        for i, p in enumerate(self.layers):
            x, st = chunk(p, x, {"conv": cache["conv"][i],
                                 "ssm": cache["ssm"][i]}, ctx, self.cfg)
            cache["conv"][i].copy_(st["conv"])
            cache["ssm"][i].copy_(st["ssm"])
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        nvalid = (batch["segment_ids"] > 0).sum(-1)
        xlast = x[torch.arange(x.shape[0], device=x.device),
                  (nvalid - 1).clamp(min=0)]
        cache_len = torch.as_tensor(cache_len, device=self.device)
        return (self._logits(xlast), cache,
                (cache_len + nvalid).to(torch.int32))

    @torch.no_grad()
    def reset_cache_rows(self, cache, fresh):
        """Zero the rows ``fresh`` (B,) bool of a decode-layout cache back
        to their ``init_cache`` values, in place (the engine claims a chunk
        row for a new request: no stale conv tail or state leaks across
        tenants). Returns the cache."""
        fresh = torch.as_tensor(fresh, device=self.device)
        for c in cache.values():
            m = fresh.reshape((1, -1) + (1,) * (c.dim() - 2))
            c.masked_fill_(m, 0)
        return cache

    @staticmethod
    def expand_chunk_states(cache):
        """View a chunk cache ((n_layers, B, …) leaves) as a one-segment
        packed harvest ((n_layers, B, 1, …)), so ``scatter_into_cache``
        lands a finished chunk row in its decode slot unchanged."""
        return {k: v.unsqueeze(2) for k, v in cache.items()}
