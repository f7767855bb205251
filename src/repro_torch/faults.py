"""Deterministic fault injection for the serve engine (port of
``repro.faults``; its own copy, so the port never imports ``repro``).

A production engine meets failures its tests never wrote: a packed prefill
dies (device OOM, preemption), a decode step emits NaN/Inf logits (a bad
weight load, an overflowed accumulator), the process is killed mid-flight.
``FaultPlan`` makes each of them a deterministic, replayable event: the
``ServeEngine`` consults the plan at its seams — the packed prefill
(``fails_prefill``, ``prefill_poison``), the in-flight readiness probe
(``prefill_not_ready``), the chunk lane (``fails_chunk``,
``chunk_poison``) and the decode step (``decode_poison``, ``kills``).

The plan is pure: every query is a function of (plan, index), never of
call order, so an engine that replays the same admission trace meets the
same faults, which is what makes kill-and-restore provable.
``FaultPlan.random(seed)`` draws a seeded plan for the chaos tests: the
same seed gives the same plan, the reference's plan for that seed too.

The cache seams (``drop_cache``, ``poison_cache_hit``) belong to the
prefix state cache, which the port's engine does not have yet; the plan
keeps them so ``random`` draws the reference's plans field for field.

Poison values are NaN or ±Inf: both are non-finite, and the engine's
guard rails (``torch.isfinite``) catch either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class EngineKilled(RuntimeError):
    """Simulated process death: the engine loses everything its last
    ``snapshot()`` did not persist. Raised before the indexed decode step,
    so the device state sits at a clean step boundary."""


class PrefillFault(RuntimeError):
    """Injected failure of a packed prefill (stands in for a device OOM or
    preemption on the packed forward)."""


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault schedule, handed to ``ServeEngine(faults=)``.

    fail_prefill     index of the packed prefill that fails (0-based over
                     ``stats.prefills``); its requests fail, the engine
                     keeps serving.
    delay_prefill    {prefill index: n}: the readiness probe reports
                     not-ready for that prefill's first n probes.
    poison_prefill   {prefill index: [(row, seg), …]}: a non-finite value
                     in those packed segments' harvested states
                     (``poison_states``).
    poison_decode    {decode step: [slot, …]}: a non-finite value added to
                     those slots' logits inside the guarded decode step.
    fail_chunk       index of the chunked-prefill round that fails (0-based
                     over ``stats.chunk_rounds``); its rows' requests fail.
    poison_chunk     {chunk round: [row, …]}: a non-finite value in those
                     chunk rows' carried state after the round
                     (``poison_cache_rows``).
    drop_cache       index of the prefix-cache lookup before which the
                     cache is cleared (0-based over hits + misses).
    poison_cache_hit [hit index, …]: a non-finite value in the restored
                     state of those cache hits.
    poison_value     what the poison injects (NaN by default; ±Inf too).
    kill_at_step     raise ``EngineKilled`` before this decode step.
    """
    fail_prefill: Optional[int] = None
    delay_prefill: Dict[int, int] = dataclasses.field(default_factory=dict)
    poison_prefill: Dict[int, List[Tuple[int, int]]] = \
        dataclasses.field(default_factory=dict)
    poison_decode: Dict[int, List[int]] = \
        dataclasses.field(default_factory=dict)
    fail_chunk: Optional[int] = None
    poison_chunk: Dict[int, List[int]] = \
        dataclasses.field(default_factory=dict)
    drop_cache: Optional[int] = None
    poison_cache_hit: List[int] = dataclasses.field(default_factory=list)
    poison_value: float = float("nan")
    kill_at_step: Optional[int] = None

    # ------------------------------------------------------------- queries
    def fails_prefill(self, pidx: int) -> bool:
        return self.fail_prefill is not None and pidx == self.fail_prefill

    def prefill_not_ready(self, pidx: int, probes: int) -> bool:
        """True while the plan still delays prefill ``pidx`` (the engine
        counts the probes it has made)."""
        return probes < self.delay_prefill.get(pidx, 0)

    def prefill_poison(self, pidx: int) -> Optional[List[Tuple[int, int]]]:
        return self.poison_prefill.get(pidx)

    def decode_poison(self, step: int, num_slots: int) \
            -> Optional[np.ndarray]:
        """(num_slots,) float32 additive poison for this decode step, or
        None when the step is clean. Unpoisoned slots get 0.0: adding it is
        a bitwise no-op on their logits."""
        slots = self.poison_decode.get(step)
        if not slots:
            return None
        v = np.zeros(num_slots, np.float32)
        for s in slots:
            v[s] = self.poison_value
        return v

    def fails_chunk(self, cidx: int) -> bool:
        return self.fail_chunk is not None and cidx == self.fail_chunk

    def chunk_poison(self, cidx: int) -> Optional[List[int]]:
        return self.poison_chunk.get(cidx)

    def drops_cache(self, lidx: int) -> bool:
        return self.drop_cache is not None and lidx == self.drop_cache

    def cache_hit_poison(self, hidx: int) -> bool:
        return hidx in self.poison_cache_hit

    def kills(self, step: int) -> bool:
        return self.kill_at_step is not None and step == self.kill_at_step

    def needs_guard(self) -> bool:
        """Whether the plan poisons numerics that only the engine's
        finiteness probes can see (the engine turns its guard on)."""
        return bool(self.poison_prefill or self.poison_decode
                    or self.poison_chunk or self.poison_cache_hit)

    def empty(self) -> bool:
        return (self.fail_prefill is None and not self.delay_prefill
                and not self.poison_prefill and not self.poison_decode
                and self.fail_chunk is None and not self.poison_chunk
                and self.drop_cache is None and not self.poison_cache_hit
                and self.kill_at_step is None)

    # ---------------------------------------------------------- generation
    @classmethod
    def random(cls, seed: int, *, max_prefills: int = 4,
               max_steps: int = 30, num_slots: int = 4,
               prefill_rows: int = 2, max_segments: int = 2,
               chunk_rows: int = 0, cache_lookups: int = 0,
               allow_kill: bool = False) -> "FaultPlan":
        """A seeded plan for the chaos tests: each fault category fires
        with probability 1/2, placed uniformly inside the given envelope.
        The draws are the reference's, in its order: ``chunk_rows`` and
        ``cache_lookups`` > 0 open the chunk and cache seams, and
        ``allow_kill`` a kill (the caller must snapshot and restore
        around it)."""
        rng = np.random.default_rng(seed)
        plan = cls()
        if rng.random() < 0.5:
            plan.fail_prefill = int(rng.integers(0, max_prefills))
        if rng.random() < 0.5:
            plan.delay_prefill = {int(rng.integers(0, max_prefills)):
                                  int(rng.integers(1, 5))}
        if rng.random() < 0.5:
            plan.poison_prefill = {
                int(rng.integers(0, max_prefills)):
                [(int(rng.integers(0, prefill_rows)),
                  int(rng.integers(0, max_segments)))]}
        if rng.random() < 0.5:
            plan.poison_decode = {int(rng.integers(1, max_steps)):
                                  [int(rng.integers(0, num_slots))]}
        if chunk_rows > 0 and rng.random() < 0.5:
            plan.fail_chunk = int(rng.integers(0, max_prefills))
        if chunk_rows > 0 and rng.random() < 0.5:
            plan.poison_chunk = {int(rng.integers(0, max_prefills)):
                                 [int(rng.integers(0, chunk_rows))]}
        if cache_lookups > 0 and rng.random() < 0.5:
            plan.drop_cache = int(rng.integers(0, cache_lookups))
        if cache_lookups > 0 and rng.random() < 0.5:
            plan.poison_cache_hit = [int(rng.integers(0, cache_lookups))]
        if rng.random() < 0.5:
            plan.poison_value = float(rng.choice([np.nan, np.inf, -np.inf]))
        if allow_kill and rng.random() < 0.5:
            plan.kill_at_step = int(rng.integers(2, max_steps))
        return plan


def _masked(leaf: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``leaf`` times a broadcast f32 mask, back in the leaf's dtype (a 1
    leaves a value bitwise as it was). Integer leaves cannot hold a NaN and
    pass through."""
    if not leaf.is_floating_point():
        return leaf
    mask = mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))
    return (leaf.float() * mask).to(leaf.dtype)


def poison_states(states, rows_segs, value: float = float("nan")):
    """A non-finite value in the harvested states of the given packed
    segments. ``states`` is ``LM.prefill_packed``'s dict: leaves of shape
    (n_layers, B, S, …); ``rows_segs`` lists (row, seg) targets. A (B, S)
    multiplicative mask (1 everywhere, ``value`` at the targets), built on
    the leaves' device, poisons every layer's state of a segment: what a
    corrupted packed forward would leave. Returns a new dict."""
    out = {}
    for k, leaf in states.items():
        m = torch.ones(leaf.shape[1:3], dtype=torch.float32,
                       device=leaf.device)
        for r, s in rows_segs:
            m[r, s] = value
        out[k] = _masked(leaf, m[None])
    return out


def poison_cache_rows(cache, rows, value: float = float("nan")):
    """A non-finite value in whole rows of a decode-layout cache
    (``LM.init_cache``'s dict: leaves of shape (n_layers, B, …)), in every
    layer: the chunk lane's counterpart of ``poison_states``, a corrupted
    chunk forward. Returns a new dict."""
    out = {}
    for k, leaf in cache.items():
        m = torch.ones(leaf.shape[1], dtype=torch.float32,
                       device=leaf.device)
        for r in rows:
            m[r] = value
        out[k] = _masked(leaf, m[None])
    return out
