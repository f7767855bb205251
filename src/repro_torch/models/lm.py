"""The language model (port of ``repro.models.lm`` for the families
``mamba``, ``xlstm``, ``hybrid`` and ``dense``): embedding → ``n_layers``
blocks → RMSNorm → head. Layer ``i`` is of kind ``cfg.unit[i %
len(cfg.unit)]`` (``blocks.layer_kinds``): every layer a Mamba-1 or a
Mamba-2 block, xLSTM's pattern unit of five mLSTM layers and one sLSTM,
RecurrentGemma's (rec, rec, attn) unit, or a dense stack's unit of one
full causal ``attn`` layer; each hybrid or dense layer is its block and
then a gated MLP, as in the JAX package (whole units, then tail layers
that reuse the unit's prefix).

``LM`` is an ``nn.Module`` that holds its parameters under the JAX
package's names (``embed``, ``layers.<i>.<block leaf>``, a hybrid or
dense layer's MLP as ``ffns.<i>.<leaf>``, ``final_norm``, and ``head``
unless the embedding is tied: then the head is ``embed.T`` and the
embedding is scaled by √d_model); ``interop.params_from_jax`` maps a JAX
tree onto them. Every family trains and serves; on each serving path a
hybrid or dense layer runs its block and then its MLP (``_mlp``), as in
training.

Training: ``loss`` is the packed next-token cross-entropy; the parameters
track gradients, ``remat="unit"`` recomputes each layer in the backward
(``torch.utils.checkpoint``) and the vocab logits exist one L-chunk at a
time. Serving: ``forward``, ``prefill_logits``, ``prefill``,
``prefill_packed``, ``prefill_chunk`` (resumable prefill of a long prompt,
slab by slab), ``decode_step``, ``decode_step_sample`` / ``sample_tokens``
(batched sampling), their guarded forms with the finiteness probes
(``decode_step_sample_guarded``, ``decode_step_greedy_guarded``,
``prefill_probe``, ``chunk_probe``), speculative decode's
``decode_verify`` and ``spec_rollback``, ``scatter_into_cache`` and
``reset_cache_rows`` run under ``torch.no_grad()``, so they build no
autograd graph.

Caches and harvested states are one flat dict whose every leaf has the
layer axis first and the row axis second: a Mamba decode cache is
``{"conv": (n_layers, slots, W-1, di), "ssm": (n_layers, slots, di, N)}``
(Mamba-1) or ``"ssm": (n_layers, slots, H, P, N)`` (Mamba-2), and a packed
prefill's states carry ``(n_layers, B, S, …)``. Every other family keeps
one group per unit position ``j``: ``"<j>_<kind>.<leaf>"`` holds layers
j, j + len(unit), … (tail layers included), e.g. xlstm-125m's
``"0_mlstm.C"`` (2, slots, H, dh, dh) and ``"5_slstm.h"`` (2, slots, H,
dh); recurrentgemma-2b's are ``"0_rec.conv"`` (9, slots, W-1, lru_width)
and ``"0_rec.h"`` (9, slots, lru_width) f32, ``"1_rec.conv"`` and
``"1_rec.h"`` (9, …), and ``"2_attn.k"``, ``"2_attn.v"`` (8, slots, S,
Hkv, hd): the local attention's K/V ring of S = min(max_len, attn_window)
slots, the one decode state that grows with the context (up to the
window). A dense stack's cache is ``"0_attn.k"`` and ``"0_attn.v"``
(n_layers, slots, max_len, Hkv, hd): a ring of S = max_len slots that
never wraps (slot t holds token t, the JAX linear cache), so a slot's row
grows with the whole context: stablelm-1.6b's is 24 × 2 × max_len × 32 ×
64 bf16 values, 480 MiB at max_len 2560. Leaves named ``m`` are
log-domain stabilisers, empty at −1e30.

The ring needs the cache's ``max_len`` (``init_cache``, ``prefill``,
``prefill_packed``) and each row's ``cache_len``, the tokens it has
consumed (``decode_step`` and its variants, ``decode_verify``;
``prefill_chunk`` takes it already): RoPE is applied at it and the token
written at slot ``cache_len % S``. A family with ``attn`` layers raises
where one is missing; the others take and ignore them, so their results
do not depend on them.
``decode_step``, ``prefill_chunk``, ``reset_cache_rows``,
``scatter_into_cache`` and ``spec_rollback`` update the cache in place
(JAX's versions return a new one), so the engine holds one cache's worth
of device memory.
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
    or ``load_state_dict(interop.params_from_jax(...))``. Each layer is of
    its ``blocks.layer_kinds`` kind; a family the port lacks raises."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.kinds = B.layer_kinds(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        pdt = getattr(torch, cfg.param_dtype)

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=pdt,
                                            device=self.device))

        # the cache groups: one per unit position j, holding layers j,
        # j + U, …; keys unprefixed for a Mamba stack, the JAX sub-block
        # name ("<j>_<kind>.") for every other family
        U = len(cfg.unit)
        named = cfg.family != "mamba"
        self._groups = [(f"{j}_{kind}." if named else "", kind)
                        for j, kind in enumerate(cfg.unit[:cfg.n_layers])]
        self._where = [(self._groups[i % U][0], i // U)
                       for i in range(cfg.n_layers)]
        self.embed = param((cfg.vocab, cfg.d_model))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: param(s) for k, s in
                              B.KINDS[kind][1](cfg).items()})
            for kind in self.kinds)
        self.ffns = nn.ModuleList(
            nn.ParameterDict({k: param(s) for k, s in
                              B.MLP[1](cfg).items()})
            for _ in self.kinds) if B.has_mlp(cfg) else None
        self.final_norm = param((cfg.d_model,))
        self.head = (None if cfg.tie_embeddings
                     else param((cfg.d_model, cfg.vocab)))

    # ------------------------------------------------------- layer views
    def _layer_state(self, tree, i):
        """Layer ``i``'s leaves of a cache-layout dict, by leaf name: views
        of entry ``r`` of its group's stacked leaves."""
        prefix, r = self._where[i]
        return {k[len(prefix):]: v[r] for k, v in tree.items()
                if k.startswith(prefix)}

    def _store(self, cache, i, state, given):
        """Write layer ``i``'s new state into ``cache``, in place. A leaf
        that is the very tensor the step was given (``given``: the layer's
        views, which ``step_attn`` writes its ring slot into) is there
        already."""
        prefix, r = self._where[i]
        for k, v in state.items():
            if v is not given[k]:
                cache[prefix + k][r].copy_(v)

    def _stack_states(self, per_layer):
        """Per-layer state dicts → the flat dict, each group's leaves
        stacked over its layers in depth order."""
        out = {}
        for prefix, _ in self._groups:
            layers = [st for (pf, _), st in zip(self._where, per_layer)
                      if pf == prefix]
            for k in layers[0]:
                out[prefix + k] = torch.stack([st[k] for st in layers])
        return out

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights from the JAX package's distributions. The
        generator must live on the model's device."""
        cfg, dev = self.cfg, self.device
        self.embed.copy_(B._randn(generator, self.embed.shape, dev) * 0.02)
        for i, (kind, layer) in enumerate(zip(self.kinds, self.layers)):
            for k, v in B.KINDS[kind][0](cfg, generator, dev).items():
                layer[k].copy_(v)
            if self.ffns is not None:
                for k, v in B.MLP[0](cfg, generator, dev).items():
                    self.ffns[i][k].copy_(v)
        self.final_norm.fill_(1.0)
        if self.head is not None:
            self.head.copy_(B._randn(generator, self.head.shape, dev)
                            * cfg.d_model ** -0.5)
        return self

    @property
    def has_ring(self) -> bool:
        """True when a layer keeps a K/V ring (an ``attn`` layer)."""
        return "attn" in self.kinds

    def ring_size(self, max_len: int) -> Optional[int]:
        """The K/V ring's slots at ``max_len``, None without a ring."""
        return B.ring_size(self.cfg, max_len) if self.has_ring else None

    def _needs(self, **args):
        """Raise where the K/V ring needs an argument the caller left out."""
        missing = [k for k, v in args.items() if v is None]
        if self.has_ring and missing:
            raise ValueError(f"{self.cfg.name}: {', '.join(missing)} is "
                             f"required: its attention layers keep a K/V "
                             f"ring")

    # ------------------------------------------------------------- embedding
    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v, device=self.device)
                for k, v in batch.items()}

    def _embed(self, tokens) -> torch.Tensor:
        dt = getattr(torch, self.cfg.dtype)
        x = self.embed[tokens.long()].to(dt)
        if self.cfg.tie_embeddings:
            # the scale rounded to the compute dtype first, as JAX's
            # jnp.asarray(d ** 0.5, dt): 50.5 in bf16 at d = 2560
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=dt,
                                 device=x.device)
        return x

    def _ctx(self, batch) -> Ctx:
        return Ctx(positions=batch.get("positions"),
                   segment_ids=batch.get("segment_ids"))

    def _logits(self, x) -> torch.Tensor:
        w = self.embed.t() if self.head is None else self.head
        return (x @ w.to(x.dtype)).float()

    # ----------------------------------------------------------- forward
    def _mlp(self, i, x, ctx):
        """Layer ``i``'s MLP after its block, where it has one: every path
        (training, the prefills, a chunk slab, a decode step) runs it."""
        if self.ffns is None:
            return x
        return B.MLP[2](self.ffns[i], x, ctx, self.cfg)

    def _layer(self, i):
        """Layer ``i``'s forward ``(x, ctx) -> x``: its block, then its MLP
        when it has one."""
        cfg, p = self.cfg, self.layers[i]
        apply = B.KINDS[self.kinds[i]][2]
        return lambda x, ctx: self._mlp(i, apply(p, x, ctx, cfg), ctx)

    def _stack(self, x, ctx) -> torch.Tensor:
        remat = self.cfg.remat == "unit" and torch.is_grad_enabled()
        for i in range(len(self.kinds)):
            layer = self._layer(i)
            if remat:
                x = checkpoint(layer, x, ctx, use_reentrant=False)
            else:
                x = layer(x, ctx)
        return B._norm(self.final_norm, x, self.cfg.norm_eps)

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        """Full logits (B, L, V) f32 — small models and tests only."""
        batch = self._batch(batch)
        x = self._stack(self._embed(batch["tokens"]), self._ctx(batch))
        return self._logits(x)

    @torch.no_grad()
    def prefill_logits(self, batch) -> torch.Tensor:
        """Serving prefill to the logits at each row's last valid position
        (B, V) f32, handing off no cache: the dry run's prefill cell (the
        JAX ``LM.prefill_logits``)."""
        batch = self._batch(batch)
        x = self._stack(self._embed(batch["tokens"]), self._ctx(batch))
        lens = (batch["segment_ids"] > 0).sum(-1)
        xlast = x[torch.arange(x.shape[0], device=x.device),
                  (lens - 1).clamp(min=0)]
        return self._logits(xlast)

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

    def _collect(self, x, ctx, max_len, ends=None):
        """Every layer's forward, its block handing off its state (``collect``
        is ``max_len``: the attention's ring size comes from it)."""
        self._needs(max_len=max_len)
        states = []
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            x, st = B.KINDS[kind][2](p, x, ctx, self.cfg,
                                     collect=max_len or True,
                                     collect_ends=ends)
            x = self._mlp(i, x, ctx)
            states.append(st)
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        return x, self._stack_states(states)

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        """Serving prefill of left-aligned prompts, one per row
        (segment_ids mark validity): one forward that also hands off every
        layer's decode cache (``max_len``: the cache's, which sizes the K/V
        ring). Returns (last_logits (B, V), cache, cache_len (B,))."""
        batch = self._batch(batch)
        lens = (batch["segment_ids"] > 0).sum(-1).to(torch.int32)
        x, cache = self._collect(self._embed(batch["tokens"]),
                                 self._ctx(batch), max_len)
        xlast = x[torch.arange(x.shape[0], device=x.device),
                  (lens.long() - 1).clamp(min=0)]
        return self._logits(xlast), cache, lens

    @torch.no_grad()
    def prefill_packed(self, batch, ends, max_len: Optional[int] = None):
        """Packed multi-prompt prefill: ONE forward over packed rows that
        hands off a decode state for every segment. ``ends`` (B, S) is each
        segment's last-token index in its row (−1 = absent); ``max_len``
        the decode cache's (the K/V ring's size).

        Returns (logits (B, S, V) at segment ends, zeros where absent;
        states in the cache layout with (B, S) in place of the slot axis,
        e.g. {"conv": (n_layers, B, S, W-1, di), "ssm": (n_layers, B, S,
        di, N)} for Mamba-1; seg_lens (B, S) int32, 0 where absent)."""
        batch = self._batch(batch)
        ends = torch.as_tensor(ends, device=self.device)
        ctx = self._ctx(batch)
        x, states = self._collect(self._embed(batch["tokens"]), ctx, max_len,
                                  ends)
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
        n_slots = next(iter(cache.values())).shape[1]
        keep = (dst >= 0) & (dst < n_slots)
        src, dst = src[keep], dst[keep]
        for k, c in cache.items():
            s = states[k]
            flat = s.reshape((s.shape[0], -1) + tuple(s.shape[3:]))
            c[:, dst] = flat[:, src].to(c.dtype)
        return cache

    # ----------------------------------------------------------- decode
    def init_cache(self, batch_size: int,
                   max_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The empty decode cache of ``batch_size`` rows (``max_len``: the
        longest context a row holds, which sizes the K/V ring)."""
        self._needs(max_len=max_len)
        dt = getattr(torch, self.cfg.dtype)
        out = {}
        for j, (prefix, kind) in enumerate(self._groups):
            n = len(range(j, self.cfg.n_layers, len(self.cfg.unit)))
            if kind == "attn":
                one = B.init_attn_cache(self.cfg, batch_size, max_len, dt,
                                        self.device)
            else:
                one = B.KINDS[kind][3](self.cfg, batch_size, dt, self.device)
            out.update({prefix + k: v[None].repeat((n,) + (1,) * v.dim())
                        for k, v in one.items()})
        return out

    @torch.no_grad()
    def decode_step(self, cache, tokens_t, reset: Optional[torch.Tensor] = None,
                    *, cache_len=None):
        """tokens_t (B, 1); reset (B,) bool or None; cache_len (B,) int,
        the tokens each row has consumed (the new token's position).
        Advances every layer's cache in place; returns (logits (B, V) f32,
        cache)."""
        self._needs(cache_len=cache_len)
        tokens_t = torch.as_tensor(tokens_t, device=self.device)
        x = self._embed(tokens_t)
        ctx = Ctx(reset_t=reset, cache_len=None if cache_len is None else
                  torch.as_tensor(cache_len, device=self.device))
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            given = self._layer_state(cache, i)
            x, st = B.KINDS[kind][4](p, x, given, ctx, self.cfg)
            x = self._mlp(i, x, ctx)
            self._store(cache, i, st, given)
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        return self._logits(x[:, 0]), cache

    @torch.no_grad()
    def decode_step_sample(self, cache, tokens_t, stream, ctr, temperature,
                           top_k, top_p, reset: Optional[torch.Tensor] = None,
                           *, cache_len=None):
        """One decode + batched-sampling step over all slots: the sampled
        token never goes to the host between the forward and the sample.
        stream, ctr (B,) int64 per-slot noise stream and token counter;
        temperature/top_k/top_p (B,) per-slot knobs (``blocks.
        sample_from_logits``); cache_len as ``decode_step``'s. Returns
        (tokens (B,) int32, logits (B, V) f32, cache, ctr + 1)."""
        logits, cache = self.decode_step(cache, tokens_t, reset,
                                         cache_len=cache_len)
        tok, ctr = B.sample_from_logits(logits, stream, ctr, temperature,
                                        top_k, top_p)
        return tok, logits, cache, ctr

    @torch.no_grad()
    def decode_step_sample_guarded(self, cache, tokens_t, stream, ctr,
                                   temperature, top_k, top_p, poison,
                                   reset: Optional[torch.Tensor] = None, *,
                                   cache_len=None):
        """``decode_step_sample`` with the engine's guard rail: a per-slot
        finiteness probe of the decode logits (one (B, V) ``isfinite`` and
        an all-reduce a row), so a slot is caught the step it goes bad.
        ``poison`` (B,) f32 is the fault-injection seam, added to the
        logits before the probe and the sampler: all zeros in production,
        a bitwise no-op on every finite logit, so guarded streams equal
        unguarded ones. Returns (tokens (B,) int32, logits (B, V) f32,
        cache, ctr + 1, finite (B,) bool)."""
        logits, cache = self.decode_step(cache, tokens_t, reset,
                                         cache_len=cache_len)
        logits = logits + poison[:, None]
        finite = torch.isfinite(logits).all(-1)
        tok, ctr = B.sample_from_logits(logits, stream, ctr, temperature,
                                        top_k, top_p)
        return tok, logits, cache, ctr, finite

    @torch.no_grad()
    def decode_step_greedy_guarded(self, cache, tokens_t, poison,
                                   reset: Optional[torch.Tensor] = None, *,
                                   cache_len=None):
        """The plain argmax step with the same guard rail and poison seam
        (the JAX engine's ``greedy_step_guarded``). Returns (tokens (B,)
        int32, cache, finite (B,) bool)."""
        logits, cache = self.decode_step(cache, tokens_t, reset,
                                         cache_len=cache_len)
        logits = logits + poison[:, None]
        return (B.greedy_tokens(logits), cache,
                torch.isfinite(logits).all(-1))

    # ------------------------------------------------- speculative decode
    @torch.no_grad()
    def decode_verify(self, cache, tokens_t, draft, *, cache_len=None):
        """Score K draft tokens with K+1 chained greedy decode steps,
        keeping the cache after each step for rollback.

        ``tokens_t`` (B, 1) is each slot's last committed token, ``draft``
        (B, K) the proposed continuation, ``cache_len`` (B,) as
        ``decode_step``'s. Step j feeds input j of [tokens_t, draft] at
        position ``cache_len + j`` and takes the argmax: exactly what K+1
        sequential ``decode_step`` + ``greedy_tokens`` compute, so a draft
        token is accepted iff it equals the argmax before it and the
        committed stream is the plain greedy one bit for bit. ``cache`` is
        read, not advanced: the steps run on the trajectory's own
        buffers.

        Returns (tokens (B, K+1) int32, finite (B, K+1) bool: the guard's
        per-step probe of the logits, traj: the cache's leaves with a
        leading (K+1,) axis, entry j the cache after j+1 inputs; with a
        K/V ring, K+1 copies of it)."""
        self._needs(cache_len=cache_len)
        inputs = torch.cat([torch.as_tensor(tokens_t, device=self.device),
                            torch.as_tensor(draft, device=self.device)
                            .to(torch.int32)], dim=1)        # (B, K+1)
        steps = inputs.shape[1]
        traj = {k: torch.empty((steps,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device) for k, v in cache.items()}
        toks, fins = [], []
        for j in range(steps):
            for k, v in traj.items():
                v[j].copy_(cache[k] if j == 0 else v[j - 1])
            logits, _ = self.decode_step(
                {k: v[j] for k, v in traj.items()}, inputs[:, j:j + 1],
                cache_len=None if cache_len is None else cache_len + j)
            toks.append(B.greedy_tokens(logits))
            fins.append(torch.isfinite(logits).all(-1))
        return torch.stack(toks, 1), torch.stack(fins, 1), traj

    @torch.no_grad()
    def spec_rollback(self, cache, traj, idx):
        """Per-row rollback over a verify trajectory, in place: row ``b`` of
        ``cache`` becomes row ``b`` of ``traj`` entry ``idx[b]`` (idx (B,)
        in [0, K]). Rejecting draft tokens is a select, not a replay (with
        a K/V ring, a select of one of its K+1 copies); writing INTO
        ``cache`` keeps every holder of its tensors (an in-flight
        prefill's landing, a snapshot) current. Returns the cache."""
        idx = torch.as_tensor(idx, device=self.device).long()
        rows = torch.arange(idx.shape[0], device=self.device)
        for k, c in cache.items():
            c.copy_(traj[k][idx, :, rows].movedim(0, 1))
        return cache

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
        return all(kind in B.CHUNK for kind in self.kinds)

    @torch.no_grad()
    def prefill_chunk(self, cache, batch, cache_len):
        """Advance a DECODE-layout cache by one (B, T) slab of long prompts,
        in place: resumable prefill from the carried decode state. ``batch``
        holds the slab's tokens/positions/segment_ids (positions GLOBAL,
        segment_ids 0 marks trailing padding; an all-padding row is an
        exact no-op); ``cache_len`` (B,) counts the tokens consumed before.
        Returns (logits (B, V) f32 at each row's last valid slab token,
        cache, cache_len + the slab's valid tokens)."""
        batch = self._batch(batch)
        x = self._embed(batch["tokens"])
        cache_len = torch.as_tensor(cache_len, device=self.device)
        ctx = Ctx(positions=batch.get("positions"),
                  segment_ids=batch.get("segment_ids"), cache_len=cache_len)
        for i, (kind, p) in enumerate(zip(self.kinds, self.layers)):
            given = self._layer_state(cache, i)
            x, st = B.CHUNK[kind](p, x, given, ctx, self.cfg)
            x = self._mlp(i, x, ctx)
            self._store(cache, i, st, given)
        x = B._norm(self.final_norm, x, self.cfg.norm_eps)
        nvalid = (batch["segment_ids"] > 0).sum(-1)
        xlast = x[torch.arange(x.shape[0], device=x.device),
                  (nvalid - 1).clamp(min=0)]
        return (self._logits(xlast), cache,
                (cache_len + nvalid).to(torch.int32))

    @torch.no_grad()
    def reset_cache_rows(self, cache, fresh):
        """Set the rows ``fresh`` (B,) bool of a decode-layout cache back
        to their ``init_cache`` values, in place (the engine claims a chunk
        row for a new request: no stale conv tail, state or K/V ring leaks
        across tenants): 0, and −1e30 on the stabilisers (leaves named
        ``m``). Returns the cache."""
        fresh = torch.as_tensor(fresh, device=self.device)
        for k, c in cache.items():
            m = fresh.reshape((1, -1) + (1,) * (c.dim() - 2))
            c.masked_fill_(m, B.NEG if k.rsplit(".", 1)[-1] == "m" else 0)
        return cache

    @staticmethod
    def expand_chunk_states(cache):
        """View a chunk cache ((n_layers, B, …) leaves) as a one-segment
        packed harvest ((n_layers, B, 1, …)), so ``scatter_into_cache``
        lands a finished chunk row in its decode slot unchanged."""
        return {k: v.unsqueeze(2) for k, v in cache.items()}
