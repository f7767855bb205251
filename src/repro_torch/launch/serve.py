"""Continuous-batching serve engine: packed prefill → per-slot greedy decode.

Port of the core of ``repro.launch.serve.ServeEngine`` as it runs with
``overlap=False, chunk_rows=0, bucket_policy="smallest_fit", guard=False``
and greedy requests. Queued prompts are packed back to back into a
(prefill_rows, bucket) buffer (``core/packing.py``); ONE forward
(``LM.prefill_packed``) harvests every segment's final conv/SSM state at its
segment end, the states are scattered into per-request decode slots
(``LM.scatter_into_cache``), and decode runs one step over all slots per
token. A slot that emits its EOS or spends its budget is released and
refilled mid-flight, so the decode batch stays full without draining a
wave.

Left out of this slice, each a ROADMAP item: overlapped and pipelined
prefills, chunked prefill of over-bucket prompts, sampling, the TTFT bucket
policy, deadlines/cancel/shedding, guard rails and fault injection,
snapshot/restore, the prefix state cache, speculative decode and telemetry.

  python -m repro_torch.launch.serve --arch mamba-1.4b
  python -m repro_torch.launch.serve --arch mamba2-370m
  python -m repro_torch.launch.serve --arch mamba-110m --tiny --device cpu
  python -m repro_torch.launch.serve --arch mamba-1.4b --scan-tune auto
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import packing
from repro_torch.models.blocks import greedy_tokens
from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray         # 1-D int32 prompt
    max_new: int
    eos: int = -1              # -1 = never matches (runs to budget)
    submit_t: float = 0.0      # engine clock at submit()


@dataclasses.dataclass
class ServeStats:
    """Engine counters and host-clock latencies.

      prefills            packed prefill rounds issued
      prefill_tokens      real prompt tokens prefilled
      midflight_refills   prefills issued while slots were decoding
      decode_steps        all-slot decode steps
      generated           tokens handed back to requests
      buckets             distinct (rows, L) prefill shapes used
      ttft_ms / itl_ms    per-request submit→first token, per-token gaps
      prefill_ms / decode_ms / host_ms   wall time per engine phase
    """
    prefills: int = 0
    prefill_tokens: int = 0
    midflight_refills: int = 0
    decode_steps: int = 0
    generated: int = 0
    buckets: set = dataclasses.field(default_factory=set)
    ttft_ms: List[float] = dataclasses.field(default_factory=list)
    itl_ms: List[float] = dataclasses.field(default_factory=list)
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    host_ms: float = 0.0

    def ttft_percentiles(self) -> Dict[str, float]:
        """{'p50': ms, 'p95': ms} over recorded TTFTs ({} when none)."""
        if not self.ttft_ms:
            return {}
        return {f"p{q}": float(np.percentile(self.ttft_ms, q))
                for q in (50, 95)}


class ServeEngine:
    """Slot-based continuous batching on one model.

    * ``submit()`` enqueues a greedy request; ``run()`` drives admission and
      decode until everything drains (``step()`` is one iteration).
    * Admission packs queued prompts FIFO into a (prefill_rows, bucket)
      buffer — the smallest bucket that holds the head-of-line prompt —
      capped by free slots and ``max_segments`` per row, and lands the
      harvested states before the next decode step.
    * Decode is one ``LM.decode_step`` over ALL slots (idle slots ride
      along; their state is overwritten at refill).
    * A slot is released the moment its request emits ``eos`` or exhausts
      ``max_new`` — the EOS token itself is kept.
    """

    def __init__(self, model: LM, num_slots: int, max_len: int, *,
                 prefill_rows: int = 2, buckets=(64, 128, 256),
                 max_segments: int = 4, policy: str = "first_fit",
                 eos: int = -1, refill_threshold=None):
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_rows = prefill_rows
        self.buckets = tuple(sorted(buckets))
        self.max_segments = max_segments
        self.policy = policy
        self.eos = eos
        # A decode step costs the same whether a slot is active or idle, so
        # single-slot refills waste a prefill: refill once this many slots
        # are free (or nothing is decoding at all).
        self.refill_threshold = max(1, num_slots // 2) \
            if refill_threshold is None else refill_threshold
        if model.cfg.scan_tune != "off":
            # warm the scan tuning cache for every prefill shape the engine
            # runs, as the JAX engine does. Its packed prefill runs the
            # plain scans, whose resolver serves only plain winners: where
            # a kernel wins, the config's knobs stand.
            from repro_torch.tune import warm_for_config
            warm_for_config(model.cfg, [(prefill_rows, b)
                                        for b in self.buckets],
                            device=model.device)
        self.cache = model.init_cache(num_slots)
        self.cache_len = torch.zeros(num_slots, dtype=torch.int32,
                                     device=self.device)
        self.cur_tok = torch.zeros((num_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self.queue: collections.deque = collections.deque()
        self.slot_req: List = [None] * num_slots
        self.slot_remaining = [0] * num_slots
        self.slot_last_t = [0.0] * num_slots
        self.outputs: Dict[int, List[int]] = {}
        self.status: Dict[int, str] = {}
        self.stats = ServeStats()
        self._next_rid = 0

    # ------------------------------------------------------------ admission
    def submit(self, tokens, max_new: int, eos=None,
               temperature: float = 0.0) -> int:
        """Enqueue one greedy request; returns its rid."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or len(tokens) == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {tokens.shape}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(tokens) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds largest prefill "
                f"bucket {self.buckets[-1]} and chunked prefill is not "
                f"ported — split the prompt or configure a larger bucket")
        if len(tokens) + max_new > self.max_len:
            raise ValueError(f"prompt {len(tokens)} + max_new {max_new} "
                             f"exceeds slot capacity {self.max_len}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0.0:
            raise NotImplementedError(
                "sampled decoding is not ported yet (ROADMAP.md, slice 5: "
                "engine features — sampling); submit greedy requests")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, tokens, max_new,
                                  self.eos if eos is None else eos,
                                  time.monotonic()))
        self.outputs[rid] = []
        self.status[rid] = "queued"
        return rid

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

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

    def _admission_due(self, free: List[int]) -> bool:
        if not free or not self.queue:
            return False
        return not self._active_slots() or len(free) >= self.refill_threshold

    def _try_refill(self) -> bool:
        """Admit queued prompts into free slots via one packed prefill and
        land their states. Returns True when a prefill ran."""
        free = self._free_slots()
        if not self._admission_due(free):
            return False
        head = self.queue[0]
        L = next(b for b in self.buckets if b >= len(head.tokens))
        admitted: List[Request] = []
        lens: List[int] = []
        for req in self.queue:
            if len(req.tokens) > L or len(admitted) == len(free):
                break
            plan = packing.plan_packing(lens + [len(req.tokens)], L,
                                        self.policy)
            if len(plan) > self.prefill_rows or \
                    any(len(row) > self.max_segments for row in plan):
                break
            admitted.append(req)
            lens.append(len(req.tokens))
        if self._active_slots():
            self.stats.midflight_refills += 1
        for _ in admitted:
            self.queue.popleft()
        pb = packing.pack([r.tokens for r in admitted], L, policy=self.policy,
                          num_rows=self.prefill_rows)
        ends = packing.segment_ends(pb, self.max_segments)
        batch = {"tokens": pb.tokens, "positions": pb.positions,
                 "segment_ids": pb.segment_ids}
        logits, states, seg_lens = self.model.prefill_packed(batch, ends)
        # (row, seg) → admitted request → slot; a fixed-size scatter whose
        # unused entries carry the num_slots sentinel
        K = self.prefill_rows * self.max_segments
        src = np.zeros(K, np.int64)
        dst = np.full(K, self.num_slots, np.int64)
        slot_of = {}
        for r, ids in enumerate(pb.seq_ids):
            for s, qi in enumerate(ids):
                k = len(slot_of)
                src[k] = r * self.max_segments + s
                dst[k] = free[qi]
                slot_of[qi] = (free[qi], r * self.max_segments + s)
        first = greedy_tokens(logits.reshape(K, -1))
        self.model.scatter_into_cache(self.cache, states, src, dst)
        n = len(slot_of)
        src_t = torch.as_tensor(src[:n], device=self.device)
        dst_t = torch.as_tensor(dst[:n], device=self.device)
        self.cache_len[dst_t] = seg_lens.reshape(-1)[src_t]
        self.cur_tok[dst_t, 0] = first[src_t]
        first = first.cpu().numpy()        # host sync: the first tokens exist
        now = time.monotonic()
        for qi, req in enumerate(admitted):
            slot, k = slot_of[qi]
            self.status[req.rid] = "active"
            self.slot_req[slot] = req
            self.slot_remaining[slot] = req.max_new
            self.slot_last_t[slot] = now
            self.stats.ttft_ms.append((now - req.submit_t) * 1e3)
            self._finish_token(slot, int(first[k]))
        self.stats.prefills += 1
        self.stats.prefill_tokens += sum(lens)
        self.stats.buckets.add((self.prefill_rows, L))
        return True

    # ----------------------------------------------------------------- decode
    def _decode_step(self):
        """One greedy decode step over every slot, then per-slot
        termination and inter-token latency accounting."""
        active = self._active_slots()
        if not active:
            return
        logits, self.cache = self.model.decode_step(self.cache, self.cur_tok)
        tok = greedy_tokens(logits)
        act = torch.zeros(self.num_slots, dtype=torch.int32)
        act[active] = 1
        self.cache_len += act.to(self.device)
        self.cur_tok = tok[:, None]
        self.stats.decode_steps += 1
        toks = tok.cpu().numpy()
        now = time.monotonic()
        for i in active:
            self.stats.itl_ms.append((now - self.slot_last_t[i]) * 1e3)
            self.slot_last_t[i] = now
            self._finish_token(i, int(toks[i]))

    def step(self) -> bool:
        """One engine iteration: refill free slots, then one decode step.
        Returns True while work remains."""
        t0 = time.perf_counter()
        while self._try_refill():
            pass
        t1 = time.perf_counter()
        self._decode_step()
        t2 = time.perf_counter()
        self.stats.prefill_ms += (t1 - t0) * 1e3
        self.stats.decode_ms += (t2 - t1) * 1e3
        return bool(self.queue or self._active_slots())

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Drive until the queue and all slots drain; returns rid → tokens."""
        t0 = time.perf_counter()
        busy = self.stats.prefill_ms + self.stats.decode_ms
        while self.step():
            pass
        wall = (time.perf_counter() - t0) * 1e3
        self.stats.host_ms += wall - (self.stats.prefill_ms
                                      + self.stats.decode_ms - busy)
        return self.outputs


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
    ap.add_argument("--policy", default="first_fit",
                    choices=["first_fit", "sequential", "sorted_greedy"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--scan-tune", default="off",
                    help="off | auto | <cache path>: shape-keyed scan "
                         "autotuning (the engine warms the cache for its "
                         "prefill buckets at start-up)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, vocab=512,
                                  dtype="float32", scan_chunk=64)
    if args.scan_tune != "off":
        cfg = dataclasses.replace(cfg, scan_tune=args.scan_tune)
    model = LM(cfg, args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    engine = ServeEngine(model, args.slots, args.max_len, policy=args.policy)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(5, 40, size=args.requests)
    t0 = time.perf_counter()
    for n in lens:
        engine.submit(rng.integers(1, cfg.vocab, size=int(n)),
                      args.new_tokens)
    outs = engine.run()
    dt = time.perf_counter() - t0
    st = engine.stats
    for rid in sorted(outs)[:4]:
        print(f"req{rid}: prompt[{lens[rid]}] -> {outs[rid][:8]}…")
    pct = st.ttft_percentiles()
    print(f"{len(outs)} requests, {st.generated} tokens in {dt:.2f}s "
          f"({st.generated / dt:.1f} tok/s incl. kernel build) — "
          f"{st.prefills} prefills ({st.midflight_refills} mid-flight), "
          f"{st.decode_steps} decode steps, "
          f"{len(st.buckets)} prefill shape(s)")
    print(f"time split: prefill {st.prefill_ms:.0f}ms, decode "
          f"{st.decode_ms:.0f}ms, host {st.host_ms:.0f}ms; TTFT p50 "
          f"{pct.get('p50', 0):.1f}ms p95 {pct.get('p95', 0):.1f}ms")
    print(json.dumps({"device": str(model.device), "arch": cfg.name,
                      "requests": len(outs), "generated": st.generated,
                      "seconds": dt}))


if __name__ == "__main__":
    main()
