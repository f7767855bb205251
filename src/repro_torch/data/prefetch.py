"""Background-prefetching wrapper for step-keyed loaders (port of
``repro.data.prefetch``).

Host-side packing costs real milliseconds per step; ``PrefetchLoader``
overlaps it with the device step by computing the next ``depth`` batches
on a worker thread while the current one trains.

Determinism: the wrapped loader's ``batch(step)`` must be a pure function
of ``step`` (``PackingLoader``'s is). The wrapper only memoizes those calls,
so ``batch(step)`` is bit-identical to the synchronous loader's, and a
restart (checkpoint at step k, a new loader, resume at k) replays the
same stream.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict

from repro_torch.obs import Obs


class PrefetchLoader:
    """Wrap any loader with ``batch(step)``. Meters through ``obs``
    (``Obs.off()`` when None; pass the Trainer's to share one registry):
    ``hits``/``misses`` — batches served from the buffer / computed on the
    caller's thread — and ``wait_ms`` — the time ``batch()`` blocked — are
    views over ``data.prefetch_hits``, ``data.prefetch_misses`` and
    ``data.prefetch_wait_ms``."""

    def __init__(self, loader: Any, depth: int = 2, obs=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self._lock = threading.Lock()
        self._futures: Dict[int, Future] = {}
        # one worker: the wrapped loader is not assumed thread-safe
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="prefetch")
        self.obs = obs if obs is not None else Obs.off()
        m = self.obs.metrics
        self._c_hits = m.counter(
            "data.prefetch_hits",
            help="batches served from the prefetch buffer")
        self._c_misses = m.counter(
            "data.prefetch_misses",
            help="batches computed on the caller's thread")
        self._g_wait = m.gauge(
            "data.prefetch_wait_ms",
            help="cumulative ms the consumer blocked waiting for a batch")

    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @property
    def wait_ms(self) -> float:
        return self._g_wait.value

    def _schedule(self, step: int) -> None:
        with self._lock:
            if step not in self._futures:
                self._futures[step] = self._pool.submit(
                    self.loader.batch, step)

    def batch(self, step: int):
        with self._lock:
            fut = self._futures.pop(step, None)
        for k in range(step + 1, step + 1 + self.depth):
            self._schedule(k)
        t0 = time.perf_counter()
        if fut is not None:
            self._c_hits.inc()
            out = fut.result()
        else:
            self._c_misses.inc()
            out = self.loader.batch(step)
        self._g_wait.add((time.perf_counter() - t0) * 1e3)
        # a forward-moving loop never asks for these again
        with self._lock:
            for k in [k for k in self._futures if k <= step]:
                self._futures.pop(k)
        return out

    def __getattr__(self, name):
        # passthrough (cfg, corpus, ...) for drop-in use
        return getattr(self.loader, name)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
