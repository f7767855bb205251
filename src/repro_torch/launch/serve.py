"""Continuous-batching serve engine with scheduler v2: overlapped packed
prefill, chunked prefill of long prompts, and per-request batched sampling.

Port of ``repro.launch.serve.ServeEngine``'s scheduler. Queued prompts are
packed back to back into a (prefill_rows, bucket) buffer
(``core/packing.py``); ONE forward (``LM.prefill_packed``) harvests every
segment's final conv/SSM state at its segment end, the states land in
per-request decode slots (``LM.scatter_into_cache``), and decode runs one
step over all slots per token. A slot that emits its EOS or spends its
budget is released and refilled mid-flight.

* **Overlap** (``overlap=True``, the default): on the card each packed
  prefill — its copies to the card, its forward and its first-token
  sample — is issued on a side ``torch.cuda.Stream`` after a wait on the
  current stream, and an event is recorded after it. Its target slots are
  only *reserved* while it runs; decode keeps stepping on the current
  stream, whose per-step host sync (``tok.cpu()``) waits on that stream
  alone. ``_prefill_ready`` is ``event.query()``; landing makes the current
  stream wait on the event and ``record_stream``s every tensor it reads, so
  the caching allocator does not hand a side-stream block back to the side
  stream while the current stream still reads it. On the CPU the dispatch
  is synchronous and a prefill is ready at once (the pool logic is the
  same, so tests script ``_prefill_ready``). There is no fallback: a failed
  launch raises.
* **Multi-prefill pipeline** (``max_inflight_prefills``): up to that many
  prefills in flight, each landing when its event has fired.
* **Latency-aware admission** (``target_ttft_ms``): admit below the
  ``refill_threshold`` once the oldest packable request has waited longer
  than the target.
* **TTFT bucket policy** (``bucket_policy="ttft"``): take a larger bucket
  when it admits strictly more requests and the head's wait is inside the
  allowance (``target_ttft_ms``, else the measured TTFT p50).
* **Chunked prefill** (``chunk_rows`` / ``chunk_size``): a prompt longer
  than the largest bucket is consumed in (chunk_rows, ≤ chunk_size) slabs
  on a side cache (``LM.prefill_chunk``, kernel #1 over the slab with the
  carried conv tail in front), then handed to its reserved decode slot;
  short requests keep decoding through every round.
* **Batched sampling** (per-request ``temperature``/``top_k``/``top_p``):
  one fixed-shape step (``LM.decode_step_sample``) decodes and samples
  every slot; a step where no active request samples runs the plain
  argmax (the JAX engine's ``greedy_step``). Noise is counter-based
  (``blocks.sample_uniforms``): a hash of (``sample_seed``, rid) names the
  request's stream and the token's index within the request is the
  counter, so a request's tokens do not depend on its slot, its admission
  round, overlap or the pipeline (the JAX engine keys ``jax.random`` by
  (seed, rid), which torch cannot reproduce: streams differ from the JAX
  engine's, distributions agree).
* **Telemetry**: ``ServeStats`` is a view over the ``obs`` registry
  (``serve.*``); with ``Obs.on()`` the engine records spans
  ``serve.step``, ``prefill_dispatch``, ``prefill_land``, ``chunk_slab``
  and ``decode_step`` on the ``engine`` track and each request's
  queued → prefill | chunk → decode track.
* **Request lifecycle**: ``submit(..., deadline_ms=)`` bounds submit to
  completion; a request over its budget is expired while queued, at
  landing, during a chunked prefill or after any decode step (its tokens
  so far are kept). ``cancel(rid)`` revokes a request wherever it is:
  queued, reserved by an in-flight prefill (its slot comes back free when
  the prefill lands), on a chunk row or decoding. ``submit`` sheds a
  request (``ShedError``) when the queue holds ``max_queue`` requests or
  its head is older than ``max_queue_age_ms``. ``status[rid]`` goes
  queued → active → done | failed | expired | cancelled, and
  ``errors[rid]`` holds the diagnostic.
* **Guard rails** (``guard=True``, or on by itself for a plan that
  poisons): a finiteness probe of every decode step's logits
  (``LM.decode_step_sample_guarded`` / ``decode_step_greedy_guarded``),
  of each packed prefill's harvest (``LM.prefill_probe``, computed in the
  dispatch and read at landing) and of each chunk handoff
  (``LM.chunk_probe``). A non-finite request is quarantined: failed with
  a diagnostic, its slot left free (a refill overwrites the row); every
  other slot's stream is bitwise that of an unguarded run. On the card the
  decode probe comes back to the host in the same copy as the step's
  tokens.
* **Fault injection** (``faults=FaultPlan(...)``, ``repro_torch.faults``):
  fail or delay a packed prefill, fail a chunk round, poison prefill
  states, chunk rows or decode logits, kill the engine before a decode
  step. Only these seams fail a request; a real launch or kernel error
  propagates.
* **Snapshot and restore**: ``snapshot(manager)`` lands every in-flight
  prefill, then saves the slots' states and sampling streams and counters
  (``checkpoint.CheckpointManager``) with the queue, chunk rows, outputs,
  statuses and deadline budgets left in its manifest; ``restore(manager)``
  on a fresh engine resumes every request, and each finishes with the
  tokens, greedy or sampled, of an uninterrupted run.
* **Padded-wave baseline** (``decode_batch``): the paper's padding regime
  on the serving path, for comparison.

Left out, a later slice: the prefix state cache and speculative decode
(slice 5c).

  python -m repro_torch.launch.serve --arch mamba-1.4b
  python -m repro_torch.launch.serve --arch mamba2-370m --temperature 0.8
  python -m repro_torch.launch.serve --arch mamba-110m --tiny --device cpu
  python -m repro_torch.launch.serve --arch mamba-1.4b --scan-tune auto
  python -m repro_torch.launch.serve --arch mamba-1.4b --guard \
      --deadline-ms 60000 --max-queue 64
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import packing
from repro_torch.faults import (EngineKilled, FaultPlan, poison_cache_rows,
                                poison_states)
from repro_torch.models import blocks as B
from repro_torch.models.lm import LM
from repro_torch.obs import MetricsRegistry, Obs, percentiles, \
    profiler_session


class ShedError(RuntimeError):
    """A request refused at admission (load shedding). ``reason`` says which
    bound tripped; the request was never queued and has no rid."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray         # 1-D int32 prompt
    max_new: int
    eos: int = -1              # -1 = never matches (runs to budget)
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = full vocab
    top_p: float = 1.0         # 1 = full mass
    submit_t: float = 0.0      # engine clock at submit()
    deadline_ms: Optional[float] = None   # budget from submit_t


class _HistList(list):
    """Per-sample latency list that also feeds a registry histogram."""

    def __init__(self, hist):
        super().__init__()
        self.hist = hist

    def append(self, v):
        super().append(v)
        self.hist.observe(v)


# histogram bounds (ms) of the registry view of TTFT and ITL
_TTFT_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)
_ITL_BUCKETS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500)


class ServeStats:
    """Engine counters and latencies as a view over a ``MetricsRegistry``:
    ``engine.stats.prefills`` and the registry's ``serve.prefills`` are the
    same number. ``ServeStats()`` owns a registry; the engine passes its
    ``obs.metrics``. ``st.x += 1`` works, ``st.buckets`` is a set,
    ``st.ttft_ms`` / ``st.itl_ms`` are lists that feed histograms.

    Counters:
      prefills            packed prefill rounds issued
      prefill_tokens      real prompt tokens prefilled
      decode_steps        all-slot decode steps
      generated           tokens handed back to requests
      midflight_refills   prefills issued while slots were decoding
      overlapped_prefills prefills in flight across ≥ 1 decode step
      early_admits        admissions forced by the TTFT target
      shed                submits refused by load shedding
      expired             requests ended by their deadline
      cancelled           requests revoked by cancel()
      quarantined         requests failed by a finiteness probe
      prefill_faults      packed prefills and chunk rounds that failed
      chunk_rounds        chunked-prefill forwards issued
      chunk_tokens        prompt tokens consumed by chunk rounds
      chunked_prefills    requests whose prompt landed through chunks
      bucket_upgrades     the TTFT policy took a bigger bucket than fits
      deferred_upgrades   upgrade declined: the head had waited too long
    Gauges:
      queue_depth_max     deepest the admission queue got
      prefill_ms / chunk_ms / decode_ms
                          host wall time of each engine phase
      host_ms             the rest of ``run()``'s wall
    """

    _counters = ("prefills", "prefill_tokens", "decode_steps", "generated",
                 "midflight_refills", "overlapped_prefills", "early_admits",
                 "shed", "expired", "cancelled", "quarantined",
                 "prefill_faults", "chunk_rounds", "chunk_tokens",
                 "chunked_prefills", "bucket_upgrades", "deferred_upgrades")
    _gauges = ("queue_depth_max", "prefill_ms", "chunk_ms", "decode_ms",
               "host_ms")

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        d = self.__dict__          # bypass __setattr__ until _m exists
        d["registry"] = registry if registry is not None \
            else MetricsRegistry()
        d["_m"] = {n: d["registry"].counter(f"serve.{n}")
                   for n in self._counters}
        d["_m"].update({n: d["registry"].gauge(f"serve.{n}")
                        for n in self._gauges})
        d["buckets"] = set()       # distinct (rows, L) prefill shapes used
        d["ttft_ms"] = _HistList(
            d["registry"].histogram("serve.ttft_ms", _TTFT_BUCKETS,
                                    help="submit to first token, ms"))
        d["itl_ms"] = _HistList(
            d["registry"].histogram("serve.itl_ms", _ITL_BUCKETS,
                                    help="inter-token latency, ms"))

    def __getattr__(self, name):
        m = self.__dict__.get("_m", {})
        if name in m:
            return m[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        m = self.__dict__.get("_m", {})
        if name in m:
            m[name].set(value)
        else:
            object.__setattr__(self, name, value)

    def __repr__(self):
        fields = ", ".join(f"{n}={self._m[n].value}"
                           for n in self._counters + self._gauges)
        return (f"ServeStats({fields}, buckets={self.buckets}, "
                f"ttft_n={len(self.ttft_ms)}, itl_n={len(self.itl_ms)})")

    def ttft_percentiles(self) -> Dict[str, float]:
        """{'p50': ms, 'p95': ms} over recorded TTFTs ({} when none)."""
        return percentiles(self.ttft_ms, (50, 95))

    def itl_percentiles(self) -> Dict[str, float]:
        """{'p50': ms, 'p95': ms} over inter-token latencies ({} = none)."""
        return percentiles(self.itl_ms, (50, 95))


class ServeEngine:
    """Slot-based continuous batching on one model.

    * ``submit()`` enqueues a request (its own budget, EOS and sampling
      knobs); ``run()`` drives admission, chunk rounds and decode until
      everything drains (``step()`` is one iteration).
    * Admission packs queued prompts FIFO into a (prefill_rows, bucket)
      buffer (``_choose_bucket``), capped by free slots and
      ``max_segments`` per row; prompts over the largest bucket wait for
      the chunk lane and never block it.
    * Decode is one step over ALL slots (idle slots ride along; their
      state is overwritten at refill). A slot is released the moment its
      request emits ``eos`` or spends ``max_new`` (the EOS is kept).
    * The lifecycle, guard rails, fault seams and snapshot/restore are the
      module docstring's.
    """

    def __init__(self, model: LM, num_slots: int, max_len: int, *,
                 prefill_rows: int = 2, buckets=(64, 128, 256),
                 max_segments: int = 4, policy: str = "first_fit",
                 eos: int = -1, refill_threshold: Optional[int] = None,
                 overlap: bool = True,
                 target_ttft_ms: Optional[float] = None,
                 sample_seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None,
                 max_queue_age_ms: Optional[float] = None,
                 guard: bool = False,
                 faults: Optional[FaultPlan] = None,
                 max_inflight_prefills: int = 1,
                 bucket_policy: str = "smallest_fit",
                 chunk_rows: int = 1,
                 chunk_size: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 obs: Optional[Obs] = None):
        if bucket_policy not in ("smallest_fit", "ttft"):
            raise ValueError(f"bucket_policy must be 'smallest_fit' or "
                             f"'ttft', got {bucket_policy!r}")
        self.model = model
        self.device = model.device
        # metrics are always on; spans record only under Obs.on()
        self.obs = obs if obs is not None else Obs.off()
        self._tr = self.obs.tracer
        self._req_spans: Dict[int, Optional[int]] = {}
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_rows = prefill_rows
        self.buckets = tuple(sorted(buckets))
        self.max_segments = max_segments
        self.policy = policy
        self.eos = eos
        self.overlap = overlap
        self.target_ttft_ms = target_ttft_ms
        self.sample_seed = sample_seed
        self._clock = clock
        self.max_queue = max_queue
        self.max_queue_age_ms = max_queue_age_ms
        self.faults = faults
        # a poison is seen only through the finiteness probes, so a plan
        # that injects one turns the guard on by itself
        self.guard = guard or (faults is not None and faults.needs_guard())
        self.max_inflight_prefills = max(1, int(max_inflight_prefills))
        self.bucket_policy = bucket_policy
        self.max_prompt_len = max_prompt_len
        self.chunk_rows = max(1, int(chunk_rows))
        self.chunk_size = int(chunk_size) if chunk_size is not None \
            else self.buckets[-1]
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_enabled = chunk_rows > 0 and model.supports_chunked_prefill
        # A decode step costs the same whether a slot is active or idle, so
        # single-slot refills waste a prefill: refill once this many slots
        # are free (or nothing is decoding), unless the TTFT target fires.
        self.refill_threshold = max(1, num_slots // 2) \
            if refill_threshold is None else refill_threshold
        # packed prefills go to a side stream on the card (module docstring)
        self._side = torch.cuda.Stream(device=self.device) \
            if overlap and self.device.type == "cuda" else None
        if model.cfg.scan_tune != "off":
            # warm the scan tuning cache for every prefill shape the engine
            # runs, the chunk lane's slab widths too, as the JAX engine
            # does. Both run the plain scans, whose resolver serves only
            # plain winners: where a kernel wins, the config's knobs stand.
            from repro_torch.tune import warm_for_config
            shapes = [(prefill_rows, b) for b in self.buckets]
            if self.chunk_enabled:
                shapes += [(self.chunk_rows, w) for w in sorted(
                    {b for b in self.buckets if b <= self.chunk_size}
                    | {self.chunk_size})]
            warm_for_config(model.cfg, shapes, device=model.device)

        dev = self.device
        self.cache = model.init_cache(num_slots)
        self.cache_len = torch.zeros(num_slots, dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((num_slots, 1), dtype=torch.int32,
                                   device=dev)
        # per-slot sampling state, landed with the cache rows
        self.slot_stream = torch.zeros(num_slots, dtype=torch.int64,
                                       device=dev)
        self.slot_ctr = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self.slot_temp = torch.zeros(num_slots, dtype=torch.float32,
                                     device=dev)
        self.slot_topk = torch.zeros(num_slots, dtype=torch.int64, device=dev)
        self.slot_topp = torch.ones(num_slots, dtype=torch.float32, device=dev)
        self._poison0 = torch.zeros(num_slots, dtype=torch.float32,
                                    device=dev)
        # the chunk lane: a side cache of chunk_rows long prompts; the main
        # cache cannot host a partial prompt (decode would advance it)
        if self.chunk_enabled:
            self.chunk_cache = model.init_cache(self.chunk_rows)
            self.chunk_clen = torch.zeros(self.chunk_rows, dtype=torch.int32,
                                          device=dev)
        self.chunk_req: List[Optional[Request]] = [None] * self.chunk_rows
        self.chunk_off = [0] * self.chunk_rows    # prompt tokens consumed
        self.chunk_slot = [-1] * self.chunk_rows  # reserved decode slot

        self.queue: collections.deque = collections.deque()
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        self.slot_remaining = [0] * num_slots
        self.slot_pending = [False] * num_slots   # reserved by a prefill
        self.slot_last_t = [0.0] * num_slots      # last token host-observed
        self._prefill_pool: List[dict] = []       # dispatched, not landed
        self.outputs: Dict[int, List[int]] = {}
        # queued → active → done | failed | expired | cancelled
        self.status: Dict[int, str] = {}
        self.errors: Dict[int, str] = {}          # rid → diagnostic
        self.resumed: set = set()                 # rids restored by restore()
        self.stats = ServeStats(self.obs.metrics)
        self._next_rid = 0

    def _h2d(self, a) -> torch.Tensor:
        """A host array on the engine's device without a host sync: on the
        card through pinned memory and a non-blocking copy on the current
        stream (a pageable copy would wait for the stream's queued work)."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @property
    def _inflight(self) -> Optional[dict]:
        """Oldest pending prefill (None when the pool is empty)."""
        return self._prefill_pool[0] if self._prefill_pool else None

    # ------------------------------------------------------------ admission
    def submit(self, tokens, max_new: int, eos: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, deadline_ms: Optional[float] = None,
               rid: Optional[int] = None) -> int:
        """Enqueue one request; returns its rid. Prompts longer than the
        largest prefill bucket go to the chunk lane (``max_prompt_len`` is
        the explicit length bound when set). ``deadline_ms`` bounds submit
        to completion (status "expired" past it, tokens so far kept).
        ``rid`` pins the request's id (its sampling stream is a hash of
        (``sample_seed``, rid)); a rid already known is refused. Raises
        ``ShedError``, without queueing, when the queue is at ``max_queue``
        or its head is older than ``max_queue_age_ms``."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or len(tokens) == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D token array, got shape "
                f"{tokens.shape} — every request needs ≥ 1 prompt token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new} — a "
                             f"request must generate at least one token")
        if self.max_prompt_len is not None and \
                len(tokens) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds max_prompt_len "
                f"{self.max_prompt_len} — raise the engine's bound or "
                f"truncate the prompt")
        if packing.needs_chunking(len(tokens), self.buckets) and \
                not self.chunk_enabled:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds largest prefill "
                f"bucket {self.buckets[-1]} and chunked prefill is "
                f"unavailable (chunk_rows=0, or the model has no "
                f"chunk-resume step) — enable chunking, split the prompt, "
                f"or configure a larger bucket")
        if len(tokens) + max_new > self.max_len:
            raise ValueError(f"prompt {len(tokens)} + max_new {max_new} "
                             f"exceeds slot capacity {self.max_len}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocab), "
                             f"got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        if rid is not None:
            if rid < 0:
                raise ValueError(f"rid must be >= 0, got {rid}")
            if rid in self.outputs:
                raise ValueError(
                    f"duplicate request id {rid} (status "
                    f"{self.status.get(rid)!r}) — rids identify output "
                    f"streams and may never be reused")
        now = self._clock()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats.shed += 1
            self._tr.instant("shed", track="engine", reason="max_queue")
            raise ShedError(f"shed: admission queue depth {len(self.queue)} "
                            f">= max_queue {self.max_queue}")
        if self.max_queue_age_ms is not None and self.queue:
            age_ms = (now - self.queue[0].submit_t) * 1e3
            if age_ms > self.max_queue_age_ms:
                self.stats.shed += 1
                self._tr.instant("shed", track="engine",
                                 reason="max_queue_age_ms")
                raise ShedError(
                    f"shed: head-of-line request has waited {age_ms:.0f}ms "
                    f"> max_queue_age_ms {self.max_queue_age_ms} — the "
                    f"engine is not keeping up")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        self.queue.append(Request(rid, tokens, max_new,
                                  self.eos if eos is None else eos,
                                  temperature, int(top_k), top_p, now,
                                  deadline_ms))
        self.outputs[rid] = []
        self.status[rid] = "queued"
        self._span_to(rid, "queued", prompt=len(tokens), max_new=max_new)
        self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                         len(self.queue))
        return rid

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is None and not self.slot_pending[i]]

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _finish_token(self, slot: int, tok: int):
        """Record one generated token; release the slot on EOS / budget."""
        req = self.slot_req[slot]
        self.outputs[req.rid].append(tok)
        self.stats.generated += 1
        self.slot_remaining[slot] -= 1
        if tok == req.eos or self.slot_remaining[slot] <= 0:
            self.slot_req[slot] = None
            self.status[req.rid] = "done"
            self._span_end(req.rid, "done",
                           tokens=len(self.outputs[req.rid]))

    def _activate(self, slot: int, req: Request, now: float, first: int):
        """A landed request's first token: the slot starts decoding."""
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new
        self.slot_last_t[slot] = now
        self.stats.ttft_ms.append((now - req.submit_t) * 1e3)
        self._span_to(req.rid, "decode", slot=slot)
        self._tr.instant("first_token", track=f"req{req.rid}", rid=req.rid)
        self._finish_token(slot, first)

    def _span_to(self, rid: int, name: str, **attrs):
        """Advance a request's lifecycle span (queued → prefill/chunk →
        decode) on its own trace track."""
        self._tr.finish(self._req_spans.pop(rid, None))
        self._req_spans[rid] = self._tr.start(name, track=f"req{rid}",
                                              rid=rid, **attrs)

    def _span_end(self, rid: int, status: str, **attrs):
        """Close a request's span and mark its terminal status."""
        self._tr.finish(self._req_spans.pop(rid, None))
        self._tr.instant(status, track=f"req{rid}", rid=rid, **attrs)

    # ------------------------------------------------------------ lifecycle
    def _terminate(self, rid: int, status: str, reason: str):
        """Move a request to a terminal status with its diagnostic."""
        self.status[rid] = status
        self.errors[rid] = reason
        if status == "expired":
            self.stats.expired += 1
        elif status == "cancelled":
            self.stats.cancelled += 1
        self._span_end(rid, status, reason=reason)

    def _quarantine(self, rid: int, reason: str):
        """Fail a request whose probe found a non-finite value."""
        self.stats.quarantined += 1
        self._tr.instant("quarantined", track=f"req{rid}", rid=rid)
        self._terminate(rid, "failed", reason)

    def _deadline_over(self, req: Request, now: float) -> bool:
        return req.deadline_ms is not None and \
            (now - req.submit_t) * 1e3 >= req.deadline_ms

    def _expire(self, req: Request, where: str):
        self._terminate(req.rid, "expired", f"deadline {req.deadline_ms:.0f}"
                        f"ms exceeded {where}")

    def _expire_queued(self):
        """Drop queued requests whose budget has run out: a prefill for
        them would be a forward nobody waits for."""
        if not any(r.deadline_ms is not None for r in self.queue):
            return
        now = self._clock()
        kept = collections.deque()
        for r in self.queue:
            if self._deadline_over(r, now):
                self._expire(r, "while queued")
            else:
                kept.append(r)
        self.queue = kept

    def _expire_active(self, now: float):
        """Per-step deadline enforcement over the decoding slots."""
        for i in self._active_slots():
            req = self.slot_req[i]
            if self._deadline_over(req, now):
                self.slot_req[i] = None
                self._expire(req, f"mid-decode (kept "
                                  f"{len(self.outputs[req.rid])} tokens)")

    def cancel(self, rid: int) -> bool:
        """Revoke a request wherever it is: queued (dequeued now), reserved
        by an in-flight prefill (its slot comes back free when the prefill
        lands), on a chunk row (freed at the next chunk round) or decoding
        (slot freed now). Tokens so far stay in ``outputs[rid]``. Returns
        False for unknown rids and requests already terminal."""
        st = self.status.get(rid)
        if st == "queued":
            self.queue = collections.deque(
                r for r in self.queue if r.rid != rid)
            self._terminate(rid, "cancelled", "cancelled while queued")
            return True
        if st == "active":
            for i, r in enumerate(self.slot_req):
                if r is not None and r.rid == rid:
                    self.slot_req[i] = None
                    self._terminate(rid, "cancelled", "cancelled mid-decode")
                    return True
            self._terminate(rid, "cancelled", "cancelled during prefill")
            return True
        return False

    def _packable(self) -> List[Request]:
        """Queued requests the packed prefill serves, FIFO; longer prompts
        stay queued for the chunk lane and never block these."""
        return [r for r in self.queue
                if not packing.needs_chunking(len(r.tokens), self.buckets)]

    def _admission_due(self, free: List[int],
                       head: Optional[Request]) -> bool:
        """Throughput rule (enough free slots, or nothing decoding) with a
        latency override: admit below the threshold once the oldest
        packable request has waited ``target_ttft_ms``."""
        if not free or head is None or \
                len(self._prefill_pool) >= self.max_inflight_prefills:
            return False
        if not self._active_slots():
            return True
        if len(free) >= self.refill_threshold:
            return True
        if self.target_ttft_ms is not None:
            wait_ms = (self._clock() - head.submit_t) * 1e3
            if wait_ms >= self.target_ttft_ms:
                self.stats.early_admits += 1
                return True
        return False

    def _admit_count(self, packq: List[Request], L: int,
                     nfree: int) -> int:
        """How many head-of-queue packable requests one (prefill_rows, L)
        round admits: the longest prefix that fits the free slots, L, the
        row count and the segment cap."""
        lens: List[int] = []
        for req in packq:
            if len(req.tokens) > L or len(lens) == nfree:
                break
            plan = packing.plan_packing(lens + [len(req.tokens)], L,
                                        self.policy)
            if len(plan) > self.prefill_rows or \
                    any(len(row) > self.max_segments for row in plan):
                break
            lens.append(len(req.tokens))
        return len(lens)

    def _choose_bucket(self, head: Request, packq: List[Request],
                       free: List[int]) -> int:
        """The round's bucket: ``smallest_fit`` takes the smallest that
        holds the head; ``ttft`` upgrades to a larger one when it admits
        strictly more requests AND the head's wait is inside the allowance
        (``target_ttft_ms``, else the measured p50) — a late head is
        admitted small at once."""
        fits = [b for b in self.buckets if b >= len(head.tokens)]
        L = fits[0]
        if self.bucket_policy != "ttft" or len(fits) == 1:
            return L
        allowance = self.target_ttft_ms
        if allowance is None:
            allowance = self.stats.ttft_percentiles().get("p50")
        if allowance is None or allowance <= 0:
            return L                 # no latency signal yet: stay small
        best_n, best_L = self._admit_count(packq, L, len(free)), L
        if best_n >= min(len(packq), len(free)):
            return L                 # no bucket can admit strictly more
        for b in fits[1:]:
            n = self._admit_count(packq, b, len(free))
            if n > best_n:
                best_n, best_L = n, b
        if best_L == L:
            return L
        wait_ms = (self._clock() - head.submit_t) * 1e3
        if wait_ms < allowance:
            self.stats.bucket_upgrades += 1
            return best_L
        self.stats.deferred_upgrades += 1
        return L

    def _on_side(self, fn):
        """Run ``fn`` on the side stream after everything queued on the
        current one; returns (its result, an event recorded after it).
        Without a side stream (overlap off, or the CPU): (fn(), None)."""
        if self._side is None:
            return fn(), None
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            out = fn()
            event = torch.cuda.Event()
            event.record(self._side)
        return out, event

    def _try_refill(self) -> bool:
        """Admit queued prompts into free slots through one packed prefill.
        The prefill is dispatched (on the side stream on the card); with
        ``overlap`` on and other slots decoding it joins the in-flight pool,
        else it lands at once. Returns True when a prefill was issued."""
        packq = self._packable()
        head = packq[0] if packq else None
        free = self._free_slots()
        if not self._admission_due(free, head):
            return False
        L = self._choose_bucket(head, packq, free)
        admitted = packq[:self._admit_count(packq, L, len(free))]
        lens = [len(r.tokens) for r in admitted]
        if not admitted:
            return False
        if self._active_slots():
            self.stats.midflight_refills += 1
        adm = {r.rid for r in admitted}
        self.queue = collections.deque(
            r for r in self.queue if r.rid not in adm)
        for req in admitted:
            self.status[req.rid] = "active"
            self._span_to(req.rid, "prefill", bucket=L)
        pidx = self.stats.prefills
        dsid = self._tr.start("prefill_dispatch", track="engine", bucket=L,
                              rows=self.prefill_rows, admitted=len(admitted),
                              pidx=pidx)
        if self.faults is not None and self.faults.fails_prefill(pidx):
            # the packed forward died (the plan's stand-in for a device OOM
            # or preemption), before any launch: the round's requests fail,
            # no slot was reserved, the decoding slots never notice
            self.stats.prefills += 1
            self.stats.prefill_faults += 1
            for req in admitted:
                self._terminate(req.rid, "failed",
                                f"prefill dispatch {pidx} failed "
                                f"(injected fault)")
            self._tr.finish(dsid, fault=True)
            return False
        pb = packing.pack([r.tokens for r in admitted], L,
                          policy=self.policy, num_rows=self.prefill_rows)
        ends = packing.segment_ends(pb, self.max_segments)
        batch = {"tokens": pb.tokens, "positions": pb.positions,
                 "segment_ids": pb.segment_ids}
        # (row, seg) → admitted request → slot; the knobs of the K =
        # rows · max_segments flat segment axis (absent segments greedy)
        K = self.prefill_rows * self.max_segments
        rids = np.zeros(K, np.int64)
        temp = np.zeros(K, np.float32)
        topk = np.zeros(K, np.int64)
        topp = np.ones(K, np.float32)
        slot_of = {}
        for r, ids in enumerate(pb.seq_ids):
            for s, qi in enumerate(ids):
                k = r * self.max_segments + s
                slot_of[qi] = (free[qi], k)
                req = admitted[qi]
                rids[k], temp[k] = req.rid, req.temperature
                topk[k], topp[k] = req.top_k, req.top_p

        poison = None if self.faults is None else \
            self.faults.prefill_poison(pidx)

        def dispatch():
            dev = {name: self._h2d(a) for name, a in (
                ("stream", B.request_streams(self.sample_seed, rids)),
                ("temp", temp), ("topk", topk), ("topp", topp))}
            logits, states, seg_lens = self.model.prefill_packed(
                {k: self._h2d(a) for k, a in batch.items()}, self._h2d(ends))
            if poison:
                states = poison_states(states, poison,
                                       self.faults.poison_value)
            if self.guard:
                # per-segment finiteness of the harvest and its end logits,
                # computed with the prefill, read at landing
                dev["ok"] = self.model.prefill_probe(states,
                                                     logits).reshape(-1)
            dev["states"], dev["seg_lens"] = states, seg_lens.reshape(-1)
            # the first token, sampled per segment with its request's
            # stream at token index 0 — flat (K, V), one shape per engine
            dev["tok"], dev["ctr"] = self.model.sample_tokens(
                logits.reshape(K, -1), dev["stream"],
                torch.zeros(K, dtype=torch.int64, device=self.device),
                dev["temp"], dev["topk"], dev["topp"])
            return dev

        dev, event = self._on_side(dispatch)
        for slot, _ in slot_of.values():          # reserve target slots
            self.slot_pending[slot] = True
        self._prefill_pool.append({
            "dev": dev, "event": event, "admitted": admitted,
            "slot_of": slot_of, "steps_waited": 0, "pidx": pidx,
            "probes": 0})
        self.stats.prefills += 1
        self.stats.prefill_tokens += sum(lens)
        self.stats.buckets.add((self.prefill_rows, L))
        self._tr.finish(dsid, tokens=sum(lens))
        if not self.overlap or not self._active_slots():
            self._land_prefill(block=True)
        return True

    def _prefill_ready(self, inflight: dict) -> bool:
        """Whether an in-flight prefill has finished on the device (split
        out so tests can script the overlap window). A fault plan can hold
        it not-ready for its first probes: a slow device, scripted."""
        if self.faults is not None and self.faults.prefill_not_ready(
                inflight["pidx"], inflight["probes"]):
            inflight["probes"] += 1
            return False
        event = inflight["event"]
        return True if event is None else event.query()

    def _land_prefill(self, block: bool = False) -> bool:
        """Land finished prefills in their reserved slots. ``block=False``
        lands only the ready ones; ``block=True`` drains the pool. Entries
        land in any order: their slots are disjoint and sampling streams
        are per request."""
        landed = False
        for inf in list(self._prefill_pool):
            if not block and not self._prefill_ready(inf):
                continue
            self._prefill_pool.remove(inf)
            self._land_one(inf)
            landed = True
        return landed

    def _land_one(self, inf: dict):
        """Scatter one prefill's states and first tokens into its slots and
        activate them, but for requests cancelled in flight (their slots
        come back free), over their deadline (expired) or whose probe found
        a non-finite value (quarantined: the state was scattered, the slot
        stays free and a refill overwrites it). On the card the current
        stream first waits on the prefill's event, and every side-stream
        tensor it reads is recorded on it (the allocator must not reuse
        those blocks on the side stream before the current stream has read
        them)."""
        lsid = self._tr.start("prefill_land", track="engine",
                              pidx=inf["pidx"],
                              steps_waited=inf["steps_waited"])
        dev = inf["dev"]
        if inf["event"] is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(inf["event"])
            for t in [v for v in dev.values() if torch.is_tensor(v)] + \
                    list(dev["states"].values()):
                t.record_stream(cur)
        pairs = list(inf["slot_of"].values())
        src = self._h2d([k for _, k in pairs])
        dst = self._h2d([s for s, _ in pairs])
        self.model.scatter_into_cache(self.cache, dev["states"], src, dst)
        self._land_slots(dst, src, dev["seg_lens"], dev)
        # host sync: TTFT observed here; the probe in the same copy
        first, ok = self._to_host(dev["tok"], dev.get("ok"))
        now = self._clock()
        for qi, req in enumerate(inf["admitted"]):
            slot, k = inf["slot_of"][qi]
            self.slot_pending[slot] = False
            if self.status.get(req.rid) == "cancelled":
                continue            # revoked while the prefill was in flight
            if self._deadline_over(req, now):
                self._expire(req, "during prefill")
                continue
            if ok is not None and not ok[k]:
                r, s = divmod(k, self.max_segments)
                self._quarantine(req.rid, f"non-finite prefill state for "
                                 f"request {req.rid} (prefill "
                                 f"{inf['pidx']}, row {r}, segment {s}) — "
                                 f"quarantined")
                continue
            self._activate(slot, req, now, int(first[k]))
        if inf["steps_waited"] > 0:
            self.stats.overlapped_prefills += 1
        self._tr.finish(lsid)

    @staticmethod
    def _to_host(tok, ok=None):
        """Tokens, and a probe's flags where there is one, to the host in
        ONE copy (one sync). Returns (tokens, flags or None) as numpy."""
        if ok is None:
            return tok.cpu().numpy(), None
        both = torch.stack((tok, ok.to(torch.int32))).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _land_slots(self, dst, src, lens, dev):
        """Per-slot state of a landing: cache length, the first token as
        the next decode input, the sampling stream, counter and knobs."""
        self.cache_len[dst] = lens[src].to(torch.int32)
        self.cur_tok[dst, 0] = dev["tok"][src]
        for name in ("stream", "ctr", "temp", "topk", "topp"):
            getattr(self, f"slot_{name}")[dst] = dev[name][src]

    # ------------------------------------------------------- chunked prefill
    def _chunk_active(self) -> bool:
        return any(r is not None for r in self.chunk_req)

    def _free_chunk_row(self, row: int):
        """Release a chunk row and the decode slot it reserved."""
        slot = self.chunk_slot[row]
        if slot >= 0:
            self.slot_pending[slot] = False
        self.chunk_req[row] = None
        self.chunk_slot[row] = -1

    def _chunk_claims(self):
        """Assign queued over-bucket prompts to free chunk rows; each also
        reserves the decode slot it will land in."""
        claimed = np.zeros(self.chunk_rows, bool)
        for row in range(self.chunk_rows):
            if self.chunk_req[row] is not None:
                continue
            nxt = next((r for r in self.queue if packing.needs_chunking(
                len(r.tokens), self.buckets)), None)
            if nxt is None:
                break
            free = self._free_slots()
            if not free:
                break
            self.queue = collections.deque(
                r for r in self.queue if r.rid != nxt.rid)
            self.status[nxt.rid] = "active"
            self.slot_pending[free[0]] = True
            self.chunk_req[row] = nxt
            self.chunk_off[row] = 0
            self.chunk_slot[row] = free[0]
            claimed[row] = True
            self._span_to(nxt.rid, "chunk", row=row, slot=free[0],
                          prompt=len(nxt.tokens))
        if claimed.any():
            # claimed rows back to init_cache values: no stale state
            claimed = self._h2d(claimed)
            self.model.reset_cache_rows(self.chunk_cache, claimed)
            self.chunk_clen.masked_fill_(claimed, 0)

    def _chunk_step(self):
        """One chunked-prefill round: claim rows for queued over-bucket
        prompts, free the rows of cancelled and expired requests, advance
        every occupied row by one slab from its carried state, and hand
        finished prompts to their reserved decode slots (first token
        sampled from the request's own stream; with the guard on, the
        handoff probe quarantines a non-finite row)."""
        if not self.chunk_enabled:
            return
        self._chunk_claims()
        rows = [i for i, r in enumerate(self.chunk_req) if r is not None]
        if not rows:
            return
        # lifecycle sweep before a forward is spent on a dead request
        now = self._clock()
        for i in rows:
            req = self.chunk_req[i]
            if self.status.get(req.rid) == "cancelled":
                self._free_chunk_row(i)
            elif self._deadline_over(req, now):
                self._expire(req, "during chunked prefill")
                self._free_chunk_row(i)
        rows = [i for i, r in enumerate(self.chunk_req) if r is not None]
        if not rows:
            return
        cidx = self.stats.chunk_rounds
        if self.faults is not None and self.faults.fails_chunk(cidx):
            # the slab's forward died (the plan's stand-in for a device OOM),
            # before any launch: the rows' requests fail, decode goes on
            self.stats.chunk_rounds += 1
            self.stats.prefill_faults += 1
            for i in rows:
                self._terminate(self.chunk_req[i].rid, "failed",
                                f"chunked-prefill round {cidx} failed "
                                f"(injected fault)")
                self._free_chunk_row(i)
            return
        # the slab width is bucket-quantised to the round's need
        need = max(min(self.chunk_size,
                       len(self.chunk_req[i].tokens) - self.chunk_off[i])
                   for i in rows)
        T = packing.slab_width(need, self.buckets, self.chunk_size)
        took = {i: min(T, len(self.chunk_req[i].tokens) - self.chunk_off[i])
                for i in rows}
        batch = packing.suffix_slab(
            {i: (self.chunk_req[i].tokens, self.chunk_off[i], took[i])
             for i in rows}, self.chunk_rows, T)
        csid = self._tr.start("chunk_slab", track="engine", round=cidx,
                              rows=len(rows), tokens=sum(took.values()))
        logits, self.chunk_cache, self.chunk_clen = self.model.prefill_chunk(
            self.chunk_cache, {k: self._h2d(a) for k, a in batch.items()},
            self.chunk_clen)
        self.stats.chunk_rounds += 1
        self.stats.chunk_tokens += sum(took.values())
        self._tr.finish(csid)
        if self.faults is not None:
            prs = self.faults.chunk_poison(cidx)
            if prs:
                self.chunk_cache = poison_cache_rows(
                    self.chunk_cache, prs, self.faults.poison_value)
        finishing = []
        for i in rows:
            self.chunk_off[i] += took[i]
            if self.chunk_off[i] >= len(self.chunk_req[i].tokens):
                finishing.append(i)
        if not finishing:
            return
        # handoff: each finished prompt's first token from its own stream,
        # then its carried state into the reserved decode slot
        R = self.chunk_rows
        rids = np.zeros(R, np.int64)
        temp = np.zeros(R, np.float32)
        topk = np.zeros(R, np.int64)
        topp = np.ones(R, np.float32)
        for i in finishing:
            req = self.chunk_req[i]
            rids[i], temp[i] = req.rid, req.temperature
            topk[i], topp[i] = req.top_k, req.top_p
        dev = {name: self._h2d(a) for name, a in (
            ("stream", B.request_streams(self.sample_seed, rids)),
            ("temp", temp), ("topk", topk), ("topp", topp))}
        dev["tok"], dev["ctr"] = self.model.sample_tokens(
            logits, dev["stream"],
            torch.zeros(R, dtype=torch.int64, device=self.device),
            dev["temp"], dev["topk"], dev["topp"])
        ok = self.model.chunk_probe(self.chunk_cache, logits) \
            if self.guard else None
        src = self._h2d(finishing)
        dst = self._h2d([self.chunk_slot[i] for i in finishing])
        self.model.scatter_into_cache(
            self.cache, self.model.expand_chunk_states(self.chunk_cache),
            src, dst)
        self._land_slots(dst, src, self.chunk_clen, dev)
        # host sync: TTFT observed here; the probe in the same copy
        first, ok = self._to_host(dev["tok"], ok)
        now = self._clock()
        for i in finishing:
            req, slot = self.chunk_req[i], self.chunk_slot[i]
            self._free_chunk_row(i)
            if self._deadline_over(req, now):
                self._expire(req, "during chunked prefill")
                continue
            if ok is not None and not ok[i]:
                self._quarantine(req.rid, f"non-finite chunked-prefill state "
                                 f"for request {req.rid} (chunk round "
                                 f"{cidx}, row {i}) — quarantined")
                continue
            self.stats.chunked_prefills += 1
            self._activate(slot, req, now, int(first[i]))

    # ----------------------------------------------------------------- decode
    def _decode_step(self):
        """One decode step over every slot — the plain argmax when no active
        request samples, else the fused decode + sample step, each in its
        guarded form with the guard on — then per-slot termination,
        quarantine, inter-token latency and deadline accounting."""
        active = self._active_slots()
        if not active:
            return
        step_idx = self.stats.decode_steps
        if self.faults is not None and self.faults.kills(step_idx):
            # simulated process death at a step boundary: what the last
            # snapshot() did not persist is gone
            raise EngineKilled(f"fault plan killed the engine before "
                               f"decode step {step_idx}")
        dsid = self._tr.start("decode_step", track="engine", step=step_idx,
                              active=len(active))
        act = np.zeros(self.num_slots, np.int32)
        act[active] = 1
        act = self._h2d(act)
        sampling = any(self.slot_req[i].temperature > 0.0 for i in active)
        finite = None
        if self.guard:
            pv = None if self.faults is None else \
                self.faults.decode_poison(step_idx, self.num_slots)
            poison = self._poison0 if pv is None else self._h2d(pv)
            if sampling:
                tok, _, self.cache, self.slot_ctr, finite = \
                    self.model.decode_step_sample_guarded(
                        self.cache, self.cur_tok, self.slot_stream,
                        self.slot_ctr, self.slot_temp, self.slot_topk,
                        self.slot_topp, poison)
            else:
                tok, self.cache, finite = \
                    self.model.decode_step_greedy_guarded(
                        self.cache, self.cur_tok, poison)
        elif sampling:
            tok, _, self.cache, self.slot_ctr = \
                self.model.decode_step_sample(
                    self.cache, self.cur_tok, self.slot_stream,
                    self.slot_ctr, self.slot_temp, self.slot_topk,
                    self.slot_topp)
        else:
            logits, self.cache = self.model.decode_step(self.cache,
                                                        self.cur_tok)
            tok = B.greedy_tokens(logits)
        self.cache_len += act
        self.cur_tok = tok[:, None]
        self.stats.decode_steps += 1
        for inf in self._prefill_pool:
            inf["steps_waited"] += 1
        # syncs the current stream only; the probe in the same copy
        toks, fin = self._to_host(tok, finite)
        now = self._clock()
        for i in active:
            if fin is not None and not fin[i]:
                # never emit the token; the row rides along until a refill
                # overwrites it, and no other row reads its values
                rid = self.slot_req[i].rid
                self.slot_req[i] = None
                self._quarantine(rid, f"non-finite decode logits for "
                                 f"request {rid} at step {step_idx} (slot "
                                 f"{i}) — quarantined")
                continue
            self.stats.itl_ms.append((now - self.slot_last_t[i]) * 1e3)
            self.slot_last_t[i] = now
            self._finish_token(i, int(toks[i]))
        self._expire_active(now)
        self._tr.finish(dsid)

    # ----------------------------------------------------------------- loop
    def step(self) -> bool:
        """One engine iteration: expire overdue queued requests, land
        finished prefills, refill free slots (up to the in-flight bound),
        one chunk round, one decode step. Returns True while work
        remains."""
        ssid = self._tr.start("serve.step", track="engine")
        self._expire_queued()
        t1 = time.perf_counter()
        self._land_prefill(block=False)
        while self._try_refill():
            pass
        if self._prefill_pool and not self._active_slots() \
                and not self._chunk_active():
            self._land_prefill(block=True)    # nothing to overlap with
        t2 = time.perf_counter()
        self._chunk_step()
        t3 = time.perf_counter()
        self._decode_step()
        t4 = time.perf_counter()
        st = self.stats
        st.prefill_ms += (t2 - t1) * 1e3
        st.chunk_ms += (t3 - t2) * 1e3
        st.decode_ms += (t4 - t3) * 1e3
        self._tr.finish(ssid)
        return bool(self.queue or self._active_slots()
                    or self._prefill_pool or self._chunk_active())

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Drive until the queue and all slots drain; returns rid → tokens."""
        st = self.stats
        t0 = time.perf_counter()
        busy = st.prefill_ms + st.chunk_ms + st.decode_ms
        while self.step():
            pass
        wall = (time.perf_counter() - t0) * 1e3
        st.host_ms += wall - (st.prefill_ms + st.chunk_ms + st.decode_ms
                              - busy)
        return self.outputs

    # ------------------------------------------------------- crash recovery
    def _device_state(self) -> Dict[str, object]:
        """The engine's whole device state as one tree: each slot's O(1)
        conv/SSM state and its cursor, next token, sampling stream, counter
        and knobs; the chunk lane's rows when it is on."""
        state = {"cache": self.cache, "cache_len": self.cache_len,
                 "cur_tok": self.cur_tok, "slot_stream": self.slot_stream,
                 "slot_ctr": self.slot_ctr, "slot_temp": self.slot_temp,
                 "slot_topk": self.slot_topk, "slot_topp": self.slot_topp}
        if self.chunk_enabled:
            state["chunk_cache"] = self.chunk_cache
            state["chunk_clen"] = self.chunk_clen
        return state

    def _engine_meta(self) -> Dict[str, object]:
        return {"num_slots": self.num_slots, "max_len": self.max_len,
                "prefill_rows": self.prefill_rows,
                "buckets": list(self.buckets),
                "max_segments": self.max_segments,
                "sample_seed": self.sample_seed,
                "chunk_rows": self.chunk_rows if self.chunk_enabled else 0,
                "chunk_size": self.chunk_size}

    @staticmethod
    def _req_meta(req: Request, now: float) -> Dict[str, object]:
        left = None if req.deadline_ms is None else \
            req.deadline_ms - (now - req.submit_t) * 1e3
        return {"rid": int(req.rid),
                "tokens": [int(t) for t in req.tokens],
                "max_new": int(req.max_new), "eos": int(req.eos),
                "temperature": float(req.temperature),
                "top_k": int(req.top_k), "top_p": float(req.top_p),
                "deadline_left_ms": left}

    @staticmethod
    def _meta_req(m: Dict, now: float) -> Request:
        return Request(m["rid"], np.asarray(m["tokens"], np.int32),
                       m["max_new"], m["eos"], m["temperature"],
                       m["top_k"], m["top_p"], now, m["deadline_left_ms"])

    def snapshot(self, manager, step: int = 0,
                 blocking: bool = False) -> int:
        """Persist the whole engine through a ``CheckpointManager``: the
        device state (``_device_state``) as its arrays, and the queue, the
        slots' and chunk rows' requests, outputs, statuses, errors and each
        deadline's budget LEFT (downtime between a crash and the restore
        expires nothing) in its manifest. Every in-flight prefill lands
        first, so the snapshot sits at a step boundary. The host copy is
        taken now; with ``blocking=False`` the write runs on the manager's
        thread. Returns the step."""
        self._land_prefill(block=True)
        now = self._clock()
        meta = {
            "engine": self._engine_meta(),
            "slots": [None if r is None else
                      dict(self._req_meta(r, now),
                           remaining=int(self.slot_remaining[i]))
                      for i, r in enumerate(self.slot_req)],
            "chunks": [None if r is None else
                       dict(self._req_meta(r, now),
                            off=int(self.chunk_off[i]),
                            slot=int(self.chunk_slot[i]))
                       for i, r in enumerate(self.chunk_req)],
            "queue": [self._req_meta(r, now) for r in self.queue],
            "outputs": {str(rid): [int(t) for t in toks]
                        for rid, toks in self.outputs.items()},
            "status": {str(rid): st for rid, st in self.status.items()},
            "errors": {str(rid): e for rid, e in self.errors.items()},
            "next_rid": int(self._next_rid),
        }
        manager.save(step, self._device_state(), meta=meta,
                     blocking=blocking)
        return step

    def restore(self, manager, step: Optional[int] = None) -> int:
        """Load a ``snapshot()`` into this freshly built, idle engine: each
        decoding request resumes from its slot's state, stream and counter
        and finishes with the tokens an uninterrupted run gives; chunk rows
        resume at their offset (their decode slot reserved again); queued
        requests keep their order. Restored rids are in ``resumed``.
        Returns the step restored."""
        if self.queue or self._active_slots() or any(self.slot_pending) \
                or self._prefill_pool or self._chunk_active():
            raise RuntimeError("restore() requires an idle engine — it "
                               "overwrites every slot; use a freshly "
                               "constructed ServeEngine")
        manager.wait()                 # publish a snapshot still in flight
        step = step if step is not None else manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no snapshot to restore in "
                                    f"{manager.dir}")
        meta = manager.read_meta(step)["meta"]
        if meta.get("engine") != self._engine_meta():
            raise ValueError(
                f"snapshot step {step} was taken by an engine configured "
                f"as {meta.get('engine')} but this engine is "
                f"{self._engine_meta()} — slot shapes would not line up")
        manager.restore(self._device_state(), step=step)   # in place
        now = self._clock()
        self.slot_req = [None if m is None else self._meta_req(m, now)
                         for m in meta["slots"]]
        self.slot_remaining = [0 if m is None else int(m["remaining"])
                               for m in meta["slots"]]
        self.slot_pending = [False] * self.num_slots
        self.slot_last_t = [now] * self.num_slots
        for i, m in enumerate(meta["chunks"]):
            if m is None:
                continue
            self.chunk_req[i] = self._meta_req(m, now)
            self.chunk_off[i] = int(m["off"])
            self.chunk_slot[i] = int(m["slot"])
            self.slot_pending[int(m["slot"])] = True
        self.queue = collections.deque(
            self._meta_req(m, now) for m in meta["queue"])
        self.outputs = {int(rid): list(toks)
                        for rid, toks in meta["outputs"].items()}
        self.status = {int(rid): st for rid, st in meta["status"].items()}
        self.errors = {int(rid): e for rid, e in meta["errors"].items()}
        self._next_rid = int(meta["next_rid"])
        self.resumed |= {r.rid for r in self.slot_req if r is not None}
        self.resumed |= {r.rid for r in self.chunk_req if r is not None}
        self.resumed |= {r.rid for r in self.queue}
        return step

    # ------------------------------------------------- padded-wave baseline
    @torch.no_grad()
    def decode_batch(self, prompts, max_new, eos: int = -1,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0):
        """Padded-wave BASELINE (the paper's padding regime on the serving
        path): ≤ num_slots prompts right-padded to the batch max, one
        prefill, synchronous decode on the same steps as the continuous
        path (uniform sampling knobs across the wave; row b samples from
        stream (``sample_seed``, b)). ``max_new`` is an int or a
        per-prompt list; a row stops at ``eos`` or its budget (the EOS is
        kept), but the WAVE ends only when every row is done."""
        Bz = self.num_slots
        if len(prompts) > Bz:
            raise ValueError(f"{len(prompts)} prompts > {Bz} slots")
        if self._active_slots() or self.queue or self._prefill_pool \
                or self._chunk_active():
            raise RuntimeError("decode_batch would clobber the live slot "
                               "cache; drain the continuous engine first "
                               "(or use a separate ServeEngine)")
        budgets = [max_new] * len(prompts) if isinstance(max_new, int) \
            else list(max_new)
        maxp = max([len(p) for p in prompts] + [1])
        grid = np.zeros((Bz, maxp), np.int32)
        seg = np.zeros((Bz, maxp), np.int32)
        pos = np.zeros((Bz, maxp), np.int32)
        for b, p in enumerate(prompts):
            grid[b, :len(p)] = p
            seg[b, :len(p)] = 1
            pos[b, :len(p)] = np.arange(len(p))
        seg[len(prompts):, 0] = 1              # idle slots: 1-token dummy
        logits, cache, _ = self.model.prefill(
            {"tokens": grid, "positions": pos, "segment_ids": seg})
        for k, c in self.cache.items():
            c.copy_(cache[k])
        del cache
        sampling = temperature > 0.0
        dev = self.device
        temp = torch.full((Bz,), temperature, dtype=torch.float32,
                          device=dev)
        topk = torch.full((Bz,), int(top_k), dtype=torch.int64, device=dev)
        topp = torch.full((Bz,), top_p, dtype=torch.float32, device=dev)
        stream = torch.as_tensor(B.request_streams(self.sample_seed,
                                                   np.arange(Bz)), device=dev)
        ctr = torch.zeros(Bz, dtype=torch.int64, device=dev)
        outs = [[] for _ in range(Bz)]
        done = [b >= len(prompts) for b in range(Bz)]
        if sampling:
            tok, ctr = self.model.sample_tokens(logits, stream, ctr, temp,
                                                topk, topp)
        else:
            tok = B.greedy_tokens(logits)
        for _ in range(max(budgets, default=0)):
            toks = tok.cpu().numpy()
            for b in range(len(prompts)):
                if done[b]:
                    continue
                outs[b].append(int(toks[b]))
                if int(toks[b]) == eos or len(outs[b]) >= budgets[b]:
                    done[b] = True
            if all(done):
                break
            if sampling:
                tok, _, self.cache, ctr = self.model.decode_step_sample(
                    self.cache, tok[:, None], stream, ctr, temp, topk, topp)
            else:
                lg, self.cache = self.model.decode_step(self.cache,
                                                        tok[:, None])
                tok = B.greedy_tokens(lg)
        return outs[:len(prompts)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba-110m")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model for a CPU demo")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--buckets", default="64,128,256",
                    help="comma-separated packed-prefill bucket lengths; "
                         "longer prompts go to the chunk lane")
    ap.add_argument("--policy", default="first_fit",
                    choices=["first_fit", "sequential", "sorted_greedy"])
    ap.add_argument("--no-overlap", action="store_true",
                    help="block on each packed prefill instead of decoding "
                         "through it")
    ap.add_argument("--target-ttft-ms", type=float, default=None,
                    help="admit below the refill threshold once the oldest "
                         "queued request has waited this long")
    ap.add_argument("--max-inflight-prefills", type=int, default=1,
                    help="packed prefills allowed in flight at once")
    ap.add_argument("--bucket-policy", default="smallest_fit",
                    choices=["smallest_fit", "ttft"],
                    help="ttft: upgrade to a bigger prefill bucket when it "
                         "admits more requests and TTFT has slack")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="chunked-prefill slab length (default: largest "
                         "bucket)")
    ap.add_argument("--chunk-rows", type=int, default=1,
                    help="long prompts chunk-prefilling concurrently "
                         "(0 disables chunked prefill)")
    ap.add_argument("--max-prompt-len", type=int, default=None,
                    help="hard bound on accepted prompt length")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request submit-to-completion deadline; overdue "
                         "requests are expired, not served late")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="shed submits once this many requests are queued")
    ap.add_argument("--guard", action="store_true",
                    help="numerical guard rails: per-step finiteness "
                         "probes; non-finite requests are quarantined")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request (0=greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and the "
                         "sampling streams")
    ap.add_argument("--scan-tune", default="off",
                    help="off | auto | <cache path>: shape-keyed scan "
                         "autotuning (the engine warms the cache for its "
                         "prefill buckets and chunk slabs at start-up)")
    ap.add_argument("--obs-trace", default=None, metavar="PATH",
                    help="record request-lifecycle spans and export a "
                         "Chrome trace-event JSON here")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="also capture a torch.profiler trace into this "
                         "directory")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, vocab=512,
                                  dtype="float32", scan_chunk=64)
    if args.scan_tune != "off":
        cfg = dataclasses.replace(cfg, scan_tune=args.scan_tune)
    model = LM(cfg, args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    obs = Obs.on() if args.obs_trace else Obs.off()
    engine = ServeEngine(model, args.slots, args.max_len,
                         buckets=[int(b) for b in args.buckets.split(",")],
                         policy=args.policy, overlap=not args.no_overlap,
                         target_ttft_ms=args.target_ttft_ms,
                         sample_seed=args.seed, max_queue=args.max_queue,
                         guard=args.guard,
                         max_inflight_prefills=args.max_inflight_prefills,
                         bucket_policy=args.bucket_policy,
                         chunk_size=args.chunk_size,
                         chunk_rows=args.chunk_rows,
                         max_prompt_len=args.max_prompt_len, obs=obs)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(5, 40, size=args.requests)
    plen = {}                            # rid → prompt length
    t0 = time.perf_counter()
    with profiler_session(args.profile_dir) as profiling:
        for n in lens:
            try:
                rid = engine.submit(
                    rng.integers(1, cfg.vocab, size=int(n)),
                    args.new_tokens, temperature=args.temperature,
                    top_k=args.top_k, top_p=args.top_p,
                    deadline_ms=args.deadline_ms)
            except ShedError:
                continue                 # counted in stats.shed
            plen[rid] = int(n)
        outs = engine.run()
    dt = time.perf_counter() - t0
    st = engine.stats
    for rid in sorted(outs)[:4]:
        print(f"req{rid}: prompt[{plen[rid]}] -> {outs[rid][:8]}…")
    print(f"lifecycle: {st.shed} shed, {st.expired} expired, "
          f"{st.cancelled} cancelled, {st.quarantined} quarantined, "
          f"{st.prefill_faults} prefill faults (guard "
          f"{'on' if engine.guard else 'off'})")
    pct, ipct = st.ttft_percentiles(), st.itl_percentiles()
    print(f"{len(outs)} requests, {st.generated} tokens in {dt:.2f}s "
          f"({st.generated / dt:.1f} tok/s incl. kernel build) — "
          f"{st.prefills} prefills ({st.midflight_refills} mid-flight, "
          f"{st.overlapped_prefills} overlapped, {st.early_admits} early), "
          f"{st.decode_steps} decode steps, "
          f"{len(st.buckets)} prefill shape(s)")
    if st.chunk_rounds:
        print(f"chunked prefill: {st.chunked_prefills} request(s) over "
              f"{st.chunk_rounds} rounds ({st.chunk_tokens} tokens)")
    print(f"time split: prefill {st.prefill_ms:.0f}ms, chunk "
          f"{st.chunk_ms:.0f}ms, decode {st.decode_ms:.0f}ms, host "
          f"{st.host_ms:.0f}ms; TTFT p50 {pct.get('p50', 0):.1f}ms p95 "
          f"{pct.get('p95', 0):.1f}ms; ITL p50 {ipct.get('p50', 0):.2f}ms")
    if args.obs_trace:
        obs.export(args.obs_trace)
        print(f"obs: wrote {len(obs.tracer.chrome_events())} trace events "
              f"to {args.obs_trace}")
    if args.profile_dir and profiling:
        print(f"obs: torch.profiler trace under {args.profile_dir}")
    print(json.dumps({"device": str(model.device), "arch": cfg.name,
                      "requests": len(outs), "generated": st.generated,
                      "chunk_rounds": st.chunk_rounds,
                      **{k: getattr(st, k) for k in (
                          "shed", "expired", "cancelled", "quarantined",
                          "prefill_faults")},
                      "guard": engine.guard, "seconds": dt}))


if __name__ == "__main__":
    main()
