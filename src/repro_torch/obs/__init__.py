"""repro_torch.obs — unified telemetry (port of ``repro.obs``): metrics
registry + span tracing.

The ``Obs`` bundle is what instrumented code receives: a (always-on,
cheap) ``MetricsRegistry`` plus a ``Tracer`` that is either recording or
the no-op ``NULL_TRACER``. Construct with:

    obs = Obs.off()                  # default: metrics only, no tracing
    obs = Obs.on()                   # record spans too
    obs = Obs.on(clock=fake_clock)   # deterministic tests

and at the end of a traced run:

    obs.export("trace.json")         # Chrome trace + metric snapshot
    print(obs.tracer.timeline())     # plain-text per-track view
    print(obs.metrics.prometheus_text())

Metric names are dotted; the port's catalogue:

  train.steps, train.real_tokens, train.buffer_tokens, train.compiles
      (counters), train.data_ms, train.step_ms (cumulative gauges),
      train.loss (last loss) — ``train/trainer.py``; spans ``train.data``
      and ``train.step`` (``compile`` mark on a batch shape's first step)
      on the ``train`` track;
  train.emergency_save_s (gauge: the SIGTERM save's seconds);
  ckpt.saves, ckpt.marks (counters), ckpt.wait_s, ckpt.snapshot_ms,
      ckpt.write_s, ckpt.bytes (the last save's gauges) —
      ``checkpoint/checkpoint.py``; spans ``ckpt.save`` (``ckpt.wait``,
      ``ckpt.snapshot`` inside) and ``ckpt.mark`` on the ``ckpt`` track,
      ``ckpt.write`` on ``ckpt.writer``;
  data.prefetch_hits, data.prefetch_misses (counters),
      data.prefetch_wait_ms (gauge) — ``data/prefetch.py``;
  tune.sweeps, tune.candidates (counters) — ``tune/runner.py``; spans
      ``tune.sweep`` (one per key) with nested ``tune.candidate`` on the
      ``tune`` track;
  serve.* (``ServeStats``'s counters and gauges, histograms
      serve.ttft_ms and serve.itl_ms) — ``launch/serve.py``; spans
      ``serve.step``, ``prefill_dispatch``, ``prefill_land``,
      ``chunk_slab`` and ``decode_step`` on the ``engine`` track, and each
      request's ``queued`` → ``prefill`` | ``chunk`` → ``decode`` on its
      ``req<rid>`` track (instants ``first_token`` and ``done``).

obs/metrics.py and obs/trace.py are the pieces; obs/profile.py the
``torch.profiler`` bridge; obs/check.py the trace validator
(``python -m repro_torch.obs.check``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      percentiles)
from .trace import NULL_TRACER, NullTracer, Tracer
from .profile import profile_region, profiler_session, step_region

__all__ = [
    "Obs", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "percentiles", "Tracer", "NullTracer", "NULL_TRACER",
    "profile_region", "step_region", "profiler_session",
]


@dataclasses.dataclass
class Obs:
    """Telemetry bundle handed to the Trainer, loaders and the tuner."""

    metrics: MetricsRegistry
    tracer: Union[Tracer, NullTracer]

    @classmethod
    def off(cls, clock: Callable[[], float] = time.time) -> "Obs":
        """Metrics only (tracing disabled — the default everywhere)."""
        return cls(metrics=MetricsRegistry(clock=clock), tracer=NULL_TRACER)

    @classmethod
    def on(cls, clock: Optional[Callable[[], float]] = None,
           span_clock: Optional[Callable[[], float]] = None,
           max_events: int = 1_000_000) -> "Obs":
        """Metrics + recording tracer. ``clock`` overrides both the
        registry stamp clock and the span clock (scripted-clock tests);
        ``span_clock`` overrides just the tracer's."""
        reg = MetricsRegistry(clock=clock or time.time)
        tr = Tracer(clock=span_clock or clock or time.perf_counter,
                    max_events=max_events)
        return cls(metrics=reg, tracer=tr)

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def export(self, path: str) -> str:
        """Dump the Chrome trace (with the metric snapshot embedded)."""
        return self.tracer.export(path, metrics=self.metrics.to_dict())
