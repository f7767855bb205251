"""Prefix state cache: the serving payoff of a bounded decode state (port
of ``repro.launch.state_cache``; its own copy, so the port never imports
``repro``).

After ``P`` prompt tokens a Mamba or xLSTM model's whole context is one
fixed-size state a layer (the conv tail and the recurrent state), whatever
``P`` is; a hybrid's attention layers add their K/V ring, min(max_len,
attn_window) slots a layer, bounded by the window, not by ``P``: at
recurrentgemma-2b's width and ``max_len`` ≥ 2048 the ring alone is 16 MiB
a row (8 layers × k and v × 2048 × 256 × bf16). A dense model's attention
keeps the whole context, a ring of ``max_len`` slots a layer: at
stablelm-1.6b's width a row is 24 layers × k and v × max_len × 2048 ×
bf16, 480 MiB at ``max_len`` 2560, more than the default budget below
(64 MiB), which refuses any entry larger than itself: a dense prefix cache
needs a ``max_bytes`` of several rows. Either way a prefix cache needs no
paged region: ONE decode-cache row
(every layer's state, in the ``LM.init_cache`` layout that ``snapshot()``
persists) and the end-of-prefix logits are the whole artifact, and
``nbytes`` counts every leaf. A later request whose prompt starts with the
same tokens restores that row (the engine sets its ``cache_len`` to the
prefix's length, where the ring's next slot and RoPE start) and prefills
only its suffix, or, when the whole prompt is stored, starts decoding with
no forward at all.

``StateCache`` is a host-side LRU keyed by a hash of the prefix tokens and
bounded by bytes. It knows nothing of the engine: the ``ServeEngine``
passes single-row trees in and out (``state_row`` / ``cache_row`` /
``load_cache_row`` below), and because it lives on the host a fresh engine
``restore()``d from a snapshot keeps hitting the same cache.

On the card an entry's tensors are in pinned memory: the engine fills them
with non-blocking copies from the device (``host_row``) and a hit's copy
back (``device_state``) is non-blocking too.

Metrics (``cache.*`` in the ``obs`` registry): hits, misses, inserts and
evictions (counters), bytes and entries (gauges).

Layout of one stored row (``LM.init_cache`` with one slot):
``{"conv": (n_layers, 1, W-1, d_inner), "ssm": (n_layers, 1, d_inner, N)}``
(Mamba-1) or ``"ssm": (n_layers, 1, H, P, N)`` (Mamba-2); the other
families' groups, e.g. xlstm-125m's ``"0_mlstm.C"`` (2, 1, H, dh, dh),
recurrentgemma-2b's ``"2_attn.k"`` (8, 1, S, Hkv, hd) or stablelm-1.6b's
``"0_attn.k"`` (24, 1, max_len, Hkv, hd), the same way (layer axis first,
the row second).
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.obs import MetricsRegistry

Row = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# single-row views of the engine's state dicts
# ---------------------------------------------------------------------------

def state_row(states, r: int, s: int) -> Row:
    """Segment (r, s) of a packed harvest (``LM.prefill_packed``'s states,
    leaves (n_layers, B, S, …)) as a single-row tree (n_layers, 1, …). A
    view: copy it before the harvest is reused."""
    return {k: v[:, r, s][:, None] for k, v in states.items()}


def cache_row(cache, r: int) -> Row:
    """Row ``r`` of a decode-layout cache (leaves (n_layers, B, …)) as a
    single-row tree: the chunk lane's carried state at a prefix boundary.
    A view."""
    return {k: v[:, r:r + 1] for k, v in cache.items()}


def load_cache_row(cache, row: Row, idx: int):
    """Write a single-row tree into row ``idx`` of a decode-layout cache, in
    place, cast to the cache's dtype (the decode slots and the chunk rows
    alike). Returns the cache."""
    for k, c in cache.items():
        c[:, idx].copy_(row[k][:, 0])
    return cache


def host_row(row: Row) -> Row:
    """A host copy of a row without a host sync: on the card a non-blocking
    copy into pinned memory on the current stream (complete once that
    stream has been synchronized); on the CPU a clone."""
    out = {}
    for k, v in row.items():
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k] = h.copy_(v, non_blocking=True)
        else:
            out[k] = v.clone()
    return out


def row_finite(row: Row, logits) -> bool:
    """Host-side finiteness of a single-row tree and its logits: the
    insert-side guard (a poisoned state is never cached)."""
    if not bool(torch.isfinite(torch.as_tensor(logits)).all()):
        return False
    return all(bool(torch.isfinite(v).all()) for v in row.values()
               if v.is_floating_point())


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class CacheEntry:
    """One stored prefix: its key and length, the single-row state (host
    tensors, pinned on a machine with a card), the end-of-prefix logits
    (V,) f32 and its byte cost."""

    __slots__ = ("key", "prefix_len", "state", "logits", "nbytes")

    def __init__(self, key, prefix_len, state, logits, nbytes):
        self.key = key
        self.prefix_len = prefix_len
        self.state = state
        self.logits = logits
        self.nbytes = nbytes


def _host(t) -> torch.Tensor:
    """A host tensor: device tensors are copied (pinned, blocking)."""
    t = torch.as_tensor(t)
    if not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


class StateCache:
    """LRU prefix → state cache bounded by bytes.

    ``lookup(tokens)`` returns the entry of the LONGEST stored prefix of
    ``tokens`` (one hash per distinct stored length, longest first) and
    makes it the most recently used; ``insert`` evicts from the LRU end
    until the new entry fits. ``generation`` changes on every change of
    content, so a caller can memoise a miss ("missed at generation G")
    until it changes.

    Pass ``registry`` (the engine's ``obs.metrics``) to put the ``cache.*``
    metrics beside the ``serve.*`` ones."""

    def __init__(self, max_bytes: int = 64 << 20,
                 registry: Optional[MetricsRegistry] = None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._hits = self.registry.counter(
            "cache.hits", help="prefix lookups that found a stored state")
        self._misses = self.registry.counter(
            "cache.misses", help="prefix lookups with no stored prefix")
        self._inserts = self.registry.counter(
            "cache.inserts", help="prefix states stored")
        self._evictions = self.registry.counter(
            "cache.evictions", help="entries evicted (LRU byte budget)")
        self._bytes_g = self.registry.gauge(
            "cache.bytes", help="resident bytes of stored states")
        self._entries_g = self.registry.gauge(
            "cache.entries", help="resident entries")
        self._entries: "collections.OrderedDict[str, CacheEntry]" = \
            collections.OrderedDict()
        self._lens: collections.Counter = collections.Counter()
        self._bytes = 0
        self.generation = 0

    # ------------------------------------------------------------- queries
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def lookups(self) -> int:
        return self._hits.value + self._misses.value

    @property
    def inserts(self) -> int:
        return self._inserts.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(tokens, n: int) -> str:
        t = np.ascontiguousarray(np.asarray(tokens[:n], np.int32))
        return hashlib.blake2b(t.tobytes(), digest_size=16).hexdigest()

    def lookup(self, tokens) -> Optional[CacheEntry]:
        """Longest stored prefix of ``tokens``, or None. One hash per
        DISTINCT stored prefix length ≤ len(tokens), not per entry."""
        n = len(tokens)
        for P in sorted(self._lens, reverse=True):
            if P > n:
                continue
            e = self._entries.get(self._key(tokens, P))
            if e is not None:
                self._entries.move_to_end(e.key)
                self._hits.inc()
                return e
        self._misses.inc()
        return None

    # ------------------------------------------------------------ mutation
    def insert(self, tokens, prefix_len: int, state,
               logits) -> Optional[CacheEntry]:
        """Store ``tokens[:prefix_len]`` → (single-row state, (V,) logits).
        Device tensors are copied to pinned host memory; host tensors are
        kept as given. An entry larger than the whole budget is refused
        (returns None); otherwise LRU entries are evicted until it fits.
        Re-inserting a stored prefix only refreshes its recency."""
        key = self._key(tokens, prefix_len)
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key]
        state = {k: _host(v) for k, v in state.items()}
        logits = _host(logits).float().reshape(-1)
        nbytes = logits.numel() * logits.element_size() + sum(
            v.numel() * v.element_size() for v in state.values())
        if nbytes > self.max_bytes:
            return None
        while self._bytes + nbytes > self.max_bytes and self._entries:
            self._evict_lru()
        e = CacheEntry(key, int(prefix_len), state, logits, nbytes)
        self._entries[key] = e
        self._lens[e.prefix_len] += 1
        self._bytes += nbytes
        self._inserts.inc()
        self.generation += 1
        self._sync_gauges()
        return e

    def _evict_lru(self):
        _, e = self._entries.popitem(last=False)
        self._lens[e.prefix_len] -= 1
        if not self._lens[e.prefix_len]:
            del self._lens[e.prefix_len]
        self._bytes -= e.nbytes
        self._evictions.inc()
        self.generation += 1

    def clear(self):
        """Drop every entry (counted as evictions): the forced-evict fault
        seam and a manual invalidation."""
        while self._entries:
            self._evict_lru()
        self._sync_gauges()

    def _sync_gauges(self):
        self._bytes_g.set(self._bytes)
        self._entries_g.set(len(self._entries))

    @staticmethod
    def device_state(entry: CacheEntry, device) -> Row:
        """The entry's row on ``device`` (what ``load_cache_row`` takes). On
        the card the copies are non-blocking from pinned memory: the
        caller keeps ``entry.state`` alive until its stream is
        synchronized."""
        device = torch.device(device)
        if device.type != "cuda":
            return entry.state
        return {k: v.to(device, non_blocking=True)
                for k, v in entry.state.items()}

    def __repr__(self):
        return (f"StateCache(entries={len(self._entries)}, "
                f"bytes={self._bytes}/{self.max_bytes}, "
                f"hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions})")
