"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpoint``,
one card: no mesh-elastic restore).

  * **Atomic publish** — arrays + manifest are written to ``step_N.tmp`` and
    os.rename'd to ``step_N`` (rename is atomic on POSIX); a crashed writer
    can never leave a half-readable "latest" checkpoint.
  * **Async save** — ``save()`` copies every leaf to host memory on the
    caller's thread (the device → host copy is the train loop's only
    stall), then a background thread serializes the copies. The copy is a
    real one even for a CPU tensor (``.to("cpu", copy=True)``): the port's
    optimizer updates the parameters, ``m``, ``v`` and the masters in
    place, so a view would let the next step overwrite a checkpoint while
    it is being written. ``wait()`` joins; a failed write is raised there
    or at the next ``save()``.
  * **Keep-K GC** — oldest checkpoints pruned after each successful publish.
  * **Self-describing** — ``manifest.json`` records step, leaf keys,
    shapes, logical dtypes, plus user metadata (data step, an
    ``emergency`` mark). numpy's npz has no bfloat16, so a bf16 leaf is
    stored as its int16 bit pattern (``Tensor.view``) and viewed back on
    load from the logical dtype in the manifest. A Python number is kept
    at 64 bits (float64, int64), so it round-trips exactly.
  * **Marking** — ``mark(step, meta)`` waits for the step's write and
    replaces only its manifest (``os.replace`` of a new file): the
    trainer's emergency save of a step it has just saved writes no
    arrays twice.
  * **Metering** through ``obs`` (``Obs.off()`` when None): counters
    ``ckpt.saves`` and ``ckpt.marks``; gauges of the last save
    ``ckpt.wait_s`` (joining the previous write), ``ckpt.snapshot_ms``
    (the caller's device → host stall), ``ckpt.write_s`` and
    ``ckpt.bytes`` (the published step on disk); spans ``ckpt.save``
    (with ``ckpt.wait`` and ``ckpt.snapshot`` inside) and ``ckpt.mark``
    on the ``ckpt`` track, ``ckpt.write`` on ``ckpt.writer`` (the writer
    thread's, async or not).

A tree is nested dicts and dataclasses (``AdamWState``) over
leaves that are tensors or Python numbers; ``None`` leaves (an optimizer
without masters) are skipped. Leaves are keyed by their path joined with
"/" (``opt/m/layers.0.in_proj``). ``restore(template)`` fills the
template in place, by key: a tensor leaf is ``copy_``'d (cast to its
dtype, on its device), a number leaf is replaced.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import Obs

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
# dtypes numpy cannot hold, stored as a same-width integer view
_VIEWS = {"bfloat16": torch.int16}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _children(node):
    """(key, child) pairs of a container node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for k, v in kids:
        if v is not None:
            flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _snapshot(leaf) -> torch.Tensor:
    """A host copy that shares no storage with ``leaf``."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, (bool, np.bool_)):
        return torch.tensor(bool(leaf))
    if isinstance(leaf, (int, np.integer)):
        return torch.tensor(int(leaf), dtype=torch.int64)
    if isinstance(leaf, (float, np.floating)):
        return torch.tensor(float(leaf), dtype=torch.float64)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _to_storable(t: torch.Tensor) -> np.ndarray:
    view = _VIEWS.get(_dtype_name(t))
    return (t.view(view) if view is not None else t).numpy()


def _from_storable(a: np.ndarray, logical: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if logical in _VIEWS:
        return t.view(getattr(torch, logical))
    return t


class CheckpointManager:
    STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep: int = 3,
                 obs: Optional[Obs] = None):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.obs = obs if obs is not None else Obs.off()
        m = self.obs.metrics
        self._c_saves = m.counter("ckpt.saves", help="snapshots taken")
        self._c_marks = m.counter("ckpt.marks",
                                  help="manifests replaced by mark()")
        self._g_wait = m.gauge("ckpt.wait_s",
                               help="last save's wait on the previous write")
        self._g_snap = m.gauge("ckpt.snapshot_ms",
                               help="last save's device → host copy")
        self._g_write = m.gauge("ckpt.write_s", help="last write's seconds")
        self._g_bytes = m.gauge("ckpt.bytes",
                                help="last published step's bytes on disk")
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, meta: Optional[Dict] = None,
             blocking: bool = False):
        """Snapshot to host memory now; write to disk (a)synchronously."""
        tr = self.obs.tracer
        with tr.span("ckpt.save", track="ckpt", step=int(step),
                     blocking=blocking):
            t0 = time.perf_counter()
            with tr.span("ckpt.wait", track="ckpt"):
                self.wait()
            t1 = time.perf_counter()
            with tr.span("ckpt.snapshot", track="ckpt"):
                host_flat = {k: _snapshot(v)
                             for k, v in _flatten(tree).items()}
            self._c_saves.inc()
            self._g_wait.set(t1 - t0)
            self._g_snap.set((time.perf_counter() - t1) * 1e3)
            meta = dict(meta or {}, step=int(step))

            def _write():
                tw = time.perf_counter()
                with tr.span("ckpt.write", track="ckpt.writer",
                             step=int(step)):
                    tmp = os.path.join(self.dir, f"step_{step}.tmp")
                    final = os.path.join(self.dir, f"step_{step}")
                    if os.path.exists(tmp):
                        shutil.rmtree(tmp)
                    os.makedirs(tmp)
                    np.savez(os.path.join(tmp, ARRAYS),
                             **{f"k{i}": _to_storable(a)
                                for i, a in enumerate(host_flat.values())})
                    manifest = {
                        "step": int(step),
                        "keys": list(host_flat.keys()),
                        "shapes": [list(a.shape)
                                   for a in host_flat.values()],
                        "dtypes": [_dtype_name(a)
                                   for a in host_flat.values()],
                        "meta": meta,
                    }
                    with open(os.path.join(tmp, MANIFEST), "w") as f:
                        json.dump(manifest, f)
                    nbytes = sum(os.path.getsize(os.path.join(tmp, n))
                                 for n in os.listdir(tmp))
                    # a published step of the same number stays in place
                    # until the new one is: set aside, renamed, then removed
                    old = final + ".old"
                    if os.path.exists(final):
                        if os.path.exists(old):
                            shutil.rmtree(old)
                        os.rename(final, old)
                    os.rename(tmp, final)                  # atomic publish
                    shutil.rmtree(old, ignore_errors=True)
                    self._gc()
                self._g_bytes.set(nbytes)
                self._g_write.set(time.perf_counter() - tw)

            def _write_capturing():
                # a daemon thread's exception is otherwise printed and
                # dropped — a checkpoint that silently failed to publish is
                # the one failure mode a fault-tolerant trainer can't
                # afford, so the error is held and re-raised on
                # wait()/the next save()
                try:
                    _write()
                except BaseException as e:
                    self._error = e

            if blocking:
                _write()
            else:
                self._thread = threading.Thread(target=_write_capturing,
                                                daemon=True)
                self._thread.start()

    def mark(self, step: int, meta: Dict):
        """Wait for ``step``'s write (in flight or done), then replace its
        manifest's meta with ``meta`` (``step`` added): a new manifest file
        renamed over the old one, so the step is published throughout."""
        with self.obs.tracer.span("ckpt.mark", track="ckpt", step=int(step)):
            self.wait()
            manifest = self.read_meta(step)
            manifest["meta"] = dict(meta, step=int(step))
            path = os.path.join(self.dir, f"step_{step}", MANIFEST)
            with open(path + ".tmp", "w") as f:
                json.dump(manifest, f)
            os.replace(path + ".tmp", path)
            self._c_marks.inc()

    def wait(self):
        """Join the in-flight async save. Raises if that save failed — the
        caller finds out at the first synchronization point (here or the
        next ``save()``), not after the restore it was counting on."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save to {self.dir} failed: "
                f"{err!r}") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = self.STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> Dict:
        path = os.path.join(self.dir, f"step_{step}", MANIFEST)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint manifest at {path} — step {step} was never "
                f"published (available steps: {self.all_steps()})")
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError as e:
            raise ValueError(f"checkpoint manifest {path} is corrupt and "
                             f"cannot be parsed: {e!r}") from e

    def restore(self, template, step: Optional[int] = None):
        """Fill ``template``'s leaves in place, by key (module docstring),
        from ``step`` (the latest when None); returns the template."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        manifest = self.read_meta(step)
        arrays_path = os.path.join(d, ARRAYS)
        if not os.path.exists(arrays_path):
            raise FileNotFoundError(
                f"checkpoint step {step} has a manifest but no {ARRAYS} "
                f"at {arrays_path} — the checkpoint directory was "
                f"partially deleted")
        try:
            npz = np.load(arrays_path)
            stored = set(npz.files)
        except Exception as e:
            raise ValueError(f"checkpoint leaf file {arrays_path} is "
                             f"corrupt and cannot be read: {e!r}") from e
        index = {k: i for i, k in enumerate(manifest["keys"])}
        missing = set(_flatten(template)) - set(index)
        if missing:
            raise KeyError(f"checkpoint step {step} missing leaves: "
                           f"{sorted(missing)[:5]}…")

        def load(key):
            i = index[key]
            if f"k{i}" not in stored:
                raise ValueError(
                    f"checkpoint step {step} is corrupt: the manifest "
                    f"records leaf '{key}' but {arrays_path} has no entry "
                    f"'k{i}' ({len(stored)} of {len(index)} leaves "
                    f"present)")
            try:
                arr = npz[f"k{i}"]
            except Exception as e:
                raise ValueError(f"checkpoint leaf '{key}' in {arrays_path} "
                                 f"is corrupt: {e!r}") from e
            return _from_storable(arr, manifest["dtypes"][i])

        def fill(node, prefix):
            kids = _children(node)
            for k, v in kids:
                if v is None:
                    continue
                key = f"{prefix}/{k}" if prefix else k
                if _children(v) is not None:
                    fill(v, key)
                    continue
                got = load(key)
                if torch.is_tensor(v):
                    if tuple(got.shape) != tuple(v.shape):
                        raise ValueError(
                            f"checkpoint leaf '{key}' has shape "
                            f"{tuple(got.shape)}, the template "
                            f"{tuple(v.shape)}")
                    with torch.no_grad():
                        v.copy_(got.to(v.dtype))
                    continue
                val = type(v)(got.item())
                if isinstance(node, dict):
                    node[k] = val
                else:
                    setattr(node, k, val)

        if _children(template) is None:
            raise TypeError("restore needs a dict or dataclass template")
        fill(template, "")
        return template
