"""``torch.profiler`` integration (port of ``repro.obs.profile``, whose
jax.profiler bridge this replaces).

``profile_region(obs, name)`` annotates a region so it shows up in a
``torch.profiler`` trace (``record_function``) AND as a host span in the
obs tracer. ``step_region`` is the per-train-step variant (the step number
rides in the span's args and in the profiler label). When no profiler is
recording, ``record_function`` costs a few µs and the host half is the
NullTracer's no-op when tracing is off — callers never branch.

``profiler_session(dir)`` wraps ``torch.profiler.profile`` (CPU and, where
there is a card, CUDA activities) for ``--profile-dir`` on
launch/train.py: when the block ends, ``tensorboard_trace_handler`` writes
a Chrome trace JSON (``*.pt.trace.json``) under ``dir`` (no TensorBoard
package needed). Two profilers cannot nest: do not open a session around a
region that another ``torch.profiler.profile`` already records.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional


@contextlib.contextmanager
def profile_region(obs, name: str, track: Optional[str] = None,
                   **attrs) -> Iterator[None]:
    """Host span (via ``obs.tracer``) + ``torch.profiler.record_function``.

    ``obs`` is an ``Obs`` bundle (obs/__init__.py); a disabled tracer makes
    the host half free."""
    from torch.profiler import record_function
    with record_function(name), obs.tracer.span(name, track=track, **attrs):
        yield


@contextlib.contextmanager
def step_region(obs, name: str, step: int,
                track: Optional[str] = None, **attrs) -> Iterator[None]:
    """Per-step ``profile_region``: the profiler label carries the step
    number (``name#step``), as the reference's StepTraceAnnotation does."""
    from torch.profiler import record_function
    with record_function(f"{name}#{step}"), \
            obs.tracer.span(name, track=track, step=step, **attrs):
        yield


@contextlib.contextmanager
def profiler_session(profile_dir: Optional[str]) -> Iterator[bool]:
    """Capture a ``torch.profiler`` trace into ``profile_dir`` for the
    duration of the block (the --profile-dir flag). Yields whether a
    capture is running: False when ``profile_dir`` is None."""
    if not profile_dir:
        yield False
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield True
