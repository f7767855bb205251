"""Span tracing with Chrome trace-event export (port of
``repro.obs.trace``).

A ``Tracer`` records begin/end ("B"/"E") span events and instant ("i")
annotations onto named *tracks* (Chrome tids): the trainer puts its
``train.data`` / ``train.step`` spans on a ``train`` track and the tuner
its ``tune.sweep`` / ``tune.candidate`` spans on ``tune``, so the exported
JSON opens directly in ``chrome://tracing`` or https://ui.perfetto.dev as
one row per track.

The OFF state is ``NULL_TRACER`` — a no-op object with the full API, so
instrumented code never branches on "is tracing on?" and the disabled cost
is one attribute lookup + an empty method call per site. It never reads
the clock and never synchronizes the device.

Design points:
  * explicit timestamps — ``start()/finish()`` stamp from the injectable
    ``clock``; ``complete(name, t0, t1)`` records a span from timestamps
    the caller already took.
  * spans may cross call boundaries: ``start()`` returns a span id that
    ``finish()`` closes later. Within one track spans must nest (Chrome's
    B/E contract); separate tracks are independent.
  * thread-safe appends — the prefetch worker and the main thread may
    both emit.
  * bounded: past ``max_events`` new events are dropped and counted
    (``dropped``) instead of growing without bound.
  * ``sync(x)`` waits for the card when ``x`` is a CUDA tensor, so a span
    around a step measures device time, not the host's enqueue.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Callable, Dict, List, Optional

# Chrome trace-event constants
_B, _E, _I, _META = "B", "E", "i", "M"


class _SpanCtx:
    """Context manager for ``Tracer.span`` (reused for with-statements)."""

    __slots__ = ("tracer", "name", "track", "args", "sid")

    def __init__(self, tracer, name, track, args):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.sid = None

    def __enter__(self):
        self.sid = self.tracer.start(self.name, track=self.track,
                                     **self.args)
        return self

    def __exit__(self, *exc):
        self.tracer.finish(self.sid)
        return False


class Tracer:
    """Records spans/instants; exports Chrome trace JSON + text timelines."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 pid: int = 1, process_name: str = "repro",
                 max_events: int = 1_000_000):
        self.clock = clock
        self.pid = pid
        self.process_name = process_name
        self.max_events = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}      # track name -> tid
        self._spans: Dict[int, dict] = {}      # open span id -> B event
        self._next_sid = 0

    # ------------------------------------------------------------- plumbing
    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            track = "main"
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
            self._emit({"ph": _META, "name": "thread_name", "ts": 0,
                        "pid": self.pid, "tid": tid,
                        "args": {"name": track}})
        return tid

    def _emit(self, ev: dict):
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    # ------------------------------------------------------------ recording
    def start(self, name: str, track: Optional[str] = None, **args) -> int:
        """Open a span; returns the id ``finish()`` closes. ``args`` become
        the Chrome event's ``args`` payload (attributes)."""
        ts = self.clock() * 1e6
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            ev = {"ph": _B, "name": name, "ts": ts, "pid": self.pid,
                  "tid": self._tid(track), "args": args}
            self._emit(ev)
            self._spans[sid] = ev
        return sid

    def finish(self, sid: Optional[int], **args) -> None:
        """Close a span opened by ``start``. Unknown/None ids are ignored
        (a request may have no open span at a terminal transition)."""
        if sid is None:
            return
        ts = self.clock() * 1e6
        with self._lock:
            b = self._spans.pop(sid, None)
            if b is None:
                return
            self._emit({"ph": _E, "name": b["name"], "ts": max(ts, b["ts"]),
                        "pid": self.pid, "tid": b["tid"], "args": args})

    def span(self, name: str, track: Optional[str] = None,
             **args) -> _SpanCtx:
        """``with tracer.span("serve.decode_step", active=3): ...``"""
        return _SpanCtx(self, name, track, args)

    def complete(self, name: str, t0: float, t1: float,
                 track: Optional[str] = None, **args) -> None:
        """Record a span from caller-measured timestamps (same clock base
        as ``self.clock`` — seconds)."""
        with self._lock:
            tid = self._tid(track)
            self._emit({"ph": _B, "name": name, "ts": t0 * 1e6,
                        "pid": self.pid, "tid": tid, "args": args})
            self._emit({"ph": _E, "name": name, "ts": max(t0, t1) * 1e6,
                        "pid": self.pid, "tid": tid, "args": {}})

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        """A point annotation (shed / expired / quarantined / compile)."""
        ts = self.clock() * 1e6
        with self._lock:
            self._emit({"ph": _I, "name": name, "ts": ts, "pid": self.pid,
                        "tid": self._tid(track), "s": "t", "args": args})

    def sync(self, x) -> None:
        """Wait for the card to finish the work behind ``x`` (a CUDA
        tensor) so the enclosing span measures device time, not dispatch
        time; nothing for a CPU tensor or a host value. No-op on the null
        tracer — so callers can leave the call in place and the OFF path
        never adds a sync."""
        import torch
        if torch.is_tensor(x) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    # ------------------------------------------------------------ exporting
    def chrome_events(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._events]

    def to_chrome(self, metrics: Optional[dict] = None) -> dict:
        """The Chrome trace-event JSON object (load in chrome://tracing or
        Perfetto). ``metrics`` (a ``MetricsRegistry.to_dict()``) rides
        along under an ignored-by-viewers top-level key so one artifact
        carries spans AND the metric snapshot."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "otherData": {"process": self.process_name,
                             "dropped_events": self.dropped}}
        if metrics is not None:
            doc["metrics"] = metrics
        return doc

    def export(self, path: str, metrics: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(metrics), f, indent=1)
        return path

    def timeline(self, track: Optional[str] = None) -> str:
        """Plain-text per-track timeline: one line per span/instant, with
        offsets from the trace start in ms and nesting by depth — the
        no-GUI view of the same events."""
        evs = self.chrome_events()
        evs = [e for e in evs if e["ph"] in (_B, _E, _I)]
        if not evs:
            return "(no events)"
        tid_name = {tid: name for name, tid in self._tracks.items()}
        t0 = min(e["ts"] for e in evs)
        lines = []
        for tname in sorted({tid_name.get(e["tid"], str(e["tid"]))
                             for e in evs}):
            if track is not None and tname != track:
                continue
            lines.append(f"-- {tname}")
            depth = 0
            open_ts: List[float] = []
            for e in sorted((e for e in evs
                             if tid_name.get(e["tid"]) == tname),
                            key=lambda e: (e["ts"], e["ph"] == _B)):
                off = (e["ts"] - t0) / 1e3
                args = ", ".join(f"{k}={v}" for k, v in
                                 e.get("args", {}).items())
                args = f"  [{args}]" if args else ""
                if e["ph"] == _B:
                    lines.append(f"  {off:9.3f}ms {'  ' * depth}"
                                 f"{e['name']}{args}")
                    depth += 1
                    open_ts.append(e["ts"])
                elif e["ph"] == _E:
                    depth = max(0, depth - 1)
                    dur = (e["ts"] - open_ts.pop()) / 1e3 if open_ts else 0.0
                    lines.append(f"  {off:9.3f}ms {'  ' * depth}"
                                 f"/{e['name']} ({dur:.3f}ms){args}")
                else:
                    lines.append(f"  {off:9.3f}ms {'  ' * depth}"
                                 f"* {e['name']}{args}")
        return "\n".join(lines)


class NullTracer(Tracer):
    """The OFF state: full Tracer API, every method a no-op. Instrumented
    code calls it unconditionally; nothing here reads the clock, takes a
    lock, or syncs the device."""

    enabled = False

    def __init__(self):                          # no state at all
        self.dropped = 0

    def start(self, name, track=None, **args):
        return None

    def finish(self, sid=None, **args):
        pass

    def span(self, name, track=None, **args):
        return _NULL_CTX

    def complete(self, name, t0, t1, track=None, **args):
        pass

    def instant(self, name, track=None, **args):
        pass

    def sync(self, x):
        pass

    def chrome_events(self):
        return []

    def to_chrome(self, metrics=None):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export(self, path, metrics=None):
        raise RuntimeError("cannot export a trace from the disabled "
                           "tracer — construct Obs.on() / Tracer() to "
                           "record one")

    def timeline(self, track=None):
        return "(tracing disabled)"


_NULL_CTX = contextlib.nullcontext()
NULL_TRACER = NullTracer()
