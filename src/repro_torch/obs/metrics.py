"""Metrics registry: counters, gauges, fixed-bucket histograms (port of
``repro.obs.metrics``; numpy only, the same code).

One registry is ONE source of numbers for a process: the ``Trainer``'s
token and step metering and the ``PrefetchLoader``'s hit/miss/wait
counters are thin views over metrics registered here, so a log line, a
trace's metric snapshot and a Prometheus scrape can never disagree.
Everything is host-side and cheap — a counter increment is a lock + an
int add — so the registry is always on; only *tracing* (obs/trace.py) has
an explicit off switch.

Thread-safety: the prefetch loader's worker thread and the checkpoint
manager's async saver may observe metrics concurrently with the main
thread — every metric mutation takes the metric's own lock (a bare ``+=``
on a Python int is NOT atomic: the read-add-write interleaves under the
GIL).

``percentiles()`` is THE percentile implementation of the port: histogram
summaries route through it, so the degenerate cases (no samples → {}, a
single sample → every percentile equals it, duplicate values) behave
identically everywhere.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def percentiles(values: Sequence[float],
                pcts: Sequence[float] = (50, 95),
                weights: Optional[Sequence[float]] = None) -> Dict[str, float]:
    """``{"p50": v, ...}`` over ``values`` — the port's one percentile
    implementation (histogram summaries and any latency report).

    Degenerate cases, uniformly: no samples (or all-zero weights) → ``{}``;
    a single sample → every requested percentile equals it; duplicate
    values interpolate exactly like ``np.percentile(..., "linear")``.

    ``weights`` generalizes to weighted samples (a histogram's bucket
    bounds weighted by bucket counts): the result is exactly
    ``np.percentile`` of the multiset where each value appears ``weight``
    times, computed without materializing it.
    """
    vals = np.asarray(values, np.float64)
    if vals.size == 0:
        return {}
    if weights is None:
        w = np.ones(vals.size)
    else:
        w = np.asarray(weights, np.float64)
        if w.shape != vals.shape:
            raise ValueError(f"weights shape {w.shape} != values shape "
                             f"{vals.shape}")
        if (w < 0).any():
            raise ValueError("weights must be non-negative")
    order = np.argsort(vals, kind="stable")
    vals, w = vals[order], w[order]
    keep = w > 0
    vals, w = vals[keep], w[keep]
    total = w.sum()
    if total == 0:
        return {}
    # rank space of the expanded multiset: value i occupies integer ranks
    # [cum_{i-1}, cum_i); np.percentile's "linear" method sits percentile p
    # at fractional rank p/100 * (n - 1)
    cum = np.cumsum(w)
    out = {}
    for p in pcts:
        r = p / 100.0 * (total - 1)
        lo = float(vals[np.searchsorted(cum, np.floor(r), side="right")])
        hi = float(vals[np.searchsorted(cum, np.ceil(r), side="right")])
        frac = r - np.floor(r)
        out[f"p{p:g}"] = lo + (hi - lo) * float(frac)
    return out


class Counter:
    """Monotonic-by-convention integer/float counter. ``set()`` exists so
    stats views can alias it as a plain attribute (``st.shed += 1`` reads
    then writes) and benchmarks can reset between rounds."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def set(self, v):
        with self._lock:
            self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(Counter):
    """A value that goes up and down (queue depth, cumulative phase ms)."""

    kind = "gauge"

    def add(self, v):
        self.inc(v)

    def max_of(self, v):
        with self._lock:
            self._value = max(self._value, v)


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds (an
    implicit +inf bucket catches the tail). ``observe()`` is O(#buckets);
    ``summary()`` estimates percentiles from the bucket counts through the
    shared ``percentiles()`` helper (each bucket contributes its upper
    bound weighted by its count — an upper-bound estimate, exact when
    observations sit on bucket bounds)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float], help: str = ""):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be a non-empty "
                             f"ascending sequence, got {buckets!r}")
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        i = int(np.searchsorted(self.bounds, v, side="left"))
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def summary(self, pcts: Sequence[float] = (50, 95)) -> Dict[str, float]:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        if not total:
            return {}
        # the +inf tail bucket reports as the largest finite bound (there
        # is no upper estimate for it); values/weights feed the shared
        # percentile implementation
        vals = list(self.bounds) + [self.bounds[-1]]
        out = percentiles(vals, pcts, weights=counts)
        out["count"] = total
        out["mean"] = s / total
        return out


class MetricsRegistry:
    """Named metrics with idempotent registration and an injectable clock
    (`clock` stamps the Prometheus export and lets tests freeze time)."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self.clock = clock

    def _get(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), "gauge")

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._get(name, lambda: Histogram(name, buckets, help),
                         "histogram")

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def to_dict(self) -> Dict[str, object]:
        """Plain scalars for JSON export: counters/gauges as numbers,
        histograms as {count, mean, p50, p95} summaries."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            if m.kind == "histogram":
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (counters/gauges as-is, histograms as
        cumulative ``_bucket``/``_sum``/``_count`` series). Metric names
        swap "." for "_" — the registry's dotted names are the catalogue
        (obs/__init__.py), Prometheus wants underscores."""
        lines = []
        with self._lock:
            items = list(self._metrics.items())
        for name, m in sorted(items):
            pn = name.replace(".", "_").replace("-", "_")
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            lines.append(f"# TYPE {pn} {m.kind}")
            if m.kind == "histogram":
                acc = 0
                for b, c in zip(m.bounds, m.counts):
                    acc += c
                    lines.append(f'{pn}_bucket{{le="{b:g}"}} {acc}')
                acc += m.counts[-1]
                lines.append(f'{pn}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{pn}_sum {m.sum:g}")
                lines.append(f"{pn}_count {m.count}")
            else:
                lines.append(f"{pn} {m.value:g}")
        return "\n".join(lines) + "\n"
