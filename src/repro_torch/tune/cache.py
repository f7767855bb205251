"""Persistent shape-keyed tuning cache (port of ``repro.tune.cache``).

The cache maps ``ShapeKey`` → the measured-best knob dict. It is
fingerprinted by the device its sweeps ran on (device name, platform) and
the torch and CUDA versions: times taken on one card mean nothing on
another or on a CPU, so a fingerprint mismatch marks entries *stale* —
kept for reporting, never served. A sweep goes only into a cache of its
own device's fingerprint (``runner.tune_key``), so a ``--device cpu``
sweep on a machine with a card writes a CPU-fingerprinted file, stale
for the card's calls. Each entry also records whether the kernel
candidates were in its sweep (``kernels``): on the card,
``kernels/ops.py`` takes a plain winner only from a sweep that timed the
kernels.

Lookup never blocks on an unseen shape: the exact bucketed key first, then
the nearest key of the same operator and objective (a log-distance over
the shape axes, bounded), then ``None`` — the caller's defaults. Tuning is
what launchers do at start-up (``warm_for_config``), never what a scan
call waits on.

A scan call resolves its key on every eager call (the JAX package resolves
once, when it traces), so each ``TuneCache`` memoizes its lookups by key;
``put`` clears the memo, and a cache loaded again is a new object with an
empty one.

The port's cache file is its own: ``TUNE_CACHE_torch.json`` in the working
directory, or ``$REPRO_TORCH_TUNE_CACHE``. (``TUNE_CACHE.json`` belongs to
the JAX package.) Health check:

    PYTHONPATH=src python -m repro_torch.tune --check [path]

exits 0 with an OK or STALE report (stale is the expected state on any
machine but the one that tuned), 1 when the file is missing or unreadable.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

from repro_torch.tune.space import ShapeKey

SCHEMA = 1
DEFAULT_PATH = "TUNE_CACHE_torch.json"
ENV_PATH = "REPRO_TORCH_TUNE_CACHE"


def as_device(device=None):
    """``device`` as a torch.device; None is the card where there is one,
    else the CPU."""
    import torch
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def fingerprint(device=None) -> Dict:
    """What a sweep's times on ``device`` (``as_device``) are valid for."""
    import torch
    dev = as_device(device)
    cuda = dev.type == "cuda"
    return {"schema": SCHEMA,
            "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "platform": dev.type,
            "torch": torch.__version__, "cuda": str(torch.version.cuda)}


def same_device(a: Dict, b: Dict) -> bool:
    """Whether two fingerprints name one device (platform and name)."""
    return (a.get("platform"), a.get("device_kind")) == \
        (b.get("platform"), b.get("device_kind"))


class TuneCache:
    """In-memory view of one tuning-cache file."""

    def __init__(self, fp: Optional[Dict] = None):
        self.fp = dict(fp) if fp is not None else fingerprint()
        self.entries: Dict[str, Dict] = {}     # key.encode() -> record
        self.stale_entries: Dict[str, Dict] = {}
        self.stale_fp: Optional[Dict] = None   # fingerprint of the above
        self.path: Optional[str] = None
        self._memo: Dict[Tuple[ShapeKey, bool, float], Tuple] = {}

    # ------------------------------------------------------------ mutation
    def put(self, key: ShapeKey, knobs: Dict, us: float,
            candidates: int = 0, kernels: bool = False) -> None:
        """``kernels``: whether the kernel candidates were in the sweep."""
        self.entries[key.encode()] = {
            "knobs": dict(knobs), "us": round(float(us), 1),
            "candidates": int(candidates), "kernels": bool(kernels)}
        self._memo.clear()

    # ------------------------------------------------------------- lookup
    def get(self, key: ShapeKey) -> Optional[Dict]:
        rec = self.entries.get(key.encode())
        return dict(rec["knobs"]) if rec else None

    def lookup(self, key: ShapeKey, nearest: bool = True,
               max_distance: float = 4.0
               ) -> Tuple[Optional[Dict], Optional[str]]:
        """Returns (knobs, how) — how ∈ {"exact", "nearest", None}.

        The nearest-key fallback is bounded by ``max_distance``: winners
        are regime-specific (``associative`` is only offered at short L
        because it materializes (B, L, D, N)), so serving one to a distant
        shape could trade a miss for an out-of-memory error. At the default
        weights 4.0 ≈ two octaves of L or four of a secondary axis.
        Memoized per (key, nearest, max_distance) until the next ``put``."""
        rec, how = self.lookup_entry(key, nearest, max_distance)
        return (dict(rec["knobs"]) if rec is not None else None), how

    def lookup_entry(self, key: ShapeKey, nearest: bool = True,
                     max_distance: float = 4.0
                     ) -> Tuple[Optional[Dict], Optional[str]]:
        """``lookup``, returning the whole entry (knobs, us, candidates,
        kernels) in place of its knobs."""
        m = (key, nearest, max_distance)
        if m not in self._memo:
            self._memo[m] = self._find(key, nearest, max_distance)
        rec, how = self._memo[m]
        if rec is None:
            return None, how
        return {**rec, "knobs": dict(rec["knobs"])}, how

    def _find(self, key, nearest, max_distance):
        hit = self.entries.get(key.encode())
        if hit is not None:
            return hit, "exact"
        if not nearest:
            return None, None
        best, best_d = None, math.inf
        for ks, rec in self.entries.items():
            k = ShapeKey.decode(ks)
            # a fwd winner is never served to a fwdbwd query (the backward
            # can flip the winner): the same hard boundary as the operator
            if k.op != key.op or k.objective != key.objective:
                continue
            d = _distance(key, k)
            if d < best_d:
                best, best_d = rec, d
        if best is None or best_d > max_distance:
            return None, None
        return best, "nearest"

    # ---------------------------------------------------------- persistence
    def save(self, path: Optional[str] = None) -> str:
        """Write the cache. Entries quarantined under another fingerprint
        are written back under a ``stale`` section: saving on machine B
        does not destroy machine A's measurements in a shared file."""
        path = path or self.path or default_path()
        doc = {"fingerprint": self.fp,
               "entries": {k: self.entries[k] for k in sorted(self.entries)}}
        if self.stale_entries:
            doc["stale"] = {"fingerprint": self.stale_fp,
                            "entries": {k: self.stale_entries[k]
                                        for k in sorted(self.stale_entries)}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        self.path = path
        return path

    @property
    def stale(self) -> bool:
        return bool(self.stale_entries)

    @classmethod
    def load(cls, path: str, fp: Optional[Dict] = None) -> "TuneCache":
        """Load ``path``; entries measured under another fingerprint are
        quarantined in ``stale_entries`` (never served, kept by ``save``).
        A ``stale`` section whose fingerprint matches this machine comes
        back as live entries."""
        with open(path) as f:
            doc = json.load(f)
        current = dict(fp) if fp is not None else fingerprint()
        cache = cls(fp=current)
        cache.path = path
        buckets = [(doc.get("fingerprint"), dict(doc.get("entries", {})))]
        st = doc.get("stale")
        if st:
            buckets.append((st.get("fingerprint"),
                            dict(st.get("entries", {}))))
        for bfp, entries in buckets:
            if bfp == current:
                cache.entries.update(entries)
            elif entries:
                cache.stale_entries.update(entries)
                cache.stale_fp = bfp
        return cache


def _distance(a: ShapeKey, b: ShapeKey) -> float:
    """Log-scale shape distance for the nearest-key fallback."""
    def lg(x, y):
        return abs(math.log2(max(x, 1)) - math.log2(max(y, 1)))
    d = 2.0 * lg(a.Lb, b.Lb)            # schedule winners flip fastest in L
    d += lg(a.D, b.D) + lg(a.N, b.N) + lg(a.H, b.H) + lg(a.dh, b.dh)
    d += 0.5 * lg(a.B, b.B)
    if a.resets != b.resets:
        d += 0.5
    if a.dtype != b.dtype:
        d += 0.25
    return d


# ---------------------------------------------------------------------------
# process-wide cache registry (what ``tuned()`` resolves against)
# ---------------------------------------------------------------------------

_CACHES: Dict[Tuple[str, str], TuneCache] = {}


def default_path() -> str:
    return os.environ.get(ENV_PATH, DEFAULT_PATH)


def get_cache(path: Optional[str] = None, device=None) -> TuneCache:
    """Memoized handle for ``path`` (default: $REPRO_TORCH_TUNE_CACHE or
    ./TUNE_CACHE_torch.json) as seen from ``device`` (``as_device``): its
    entries from another device are stale. A missing file yields an
    empty, writable cache of ``device``'s fingerprint."""
    path = path or default_path()
    dev = as_device(device)
    slot = (path, dev.type)
    if slot not in _CACHES:
        fp = fingerprint(dev)
        if os.path.exists(path):
            _CACHES[slot] = TuneCache.load(path, fp=fp)
        else:
            c = TuneCache(fp=fp)
            c.path = path
            _CACHES[slot] = c
    return _CACHES[slot]


def set_cache(cache: TuneCache, path: Optional[str] = None) -> None:
    _CACHES[(path or cache.path or default_path(),
             cache.fp.get("platform"))] = cache


def reset_caches() -> None:
    """Drop all memoized handles (tests)."""
    _CACHES.clear()


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="tune-cache health check")
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    path = args.path or default_path()
    if not os.path.exists(path):
        print(f"# tune-check: MISSING {path} (run `python -m "
              f"repro_torch.tune.runner`)")
        raise SystemExit(1)
    try:
        cache = TuneCache.load(path)
    except (OSError, ValueError, KeyError, TypeError) as e:   # corrupt file
        print(f"# tune-check: UNREADABLE {path}: {e}")
        raise SystemExit(1)
    fp = cache.fp
    where = (f"{fp['platform']}/{fp['device_kind']}/torch-{fp['torch']}/"
             f"cuda-{fp['cuda']}")
    if cache.stale:
        print(f"# tune-check: STALE {path} — {len(cache.stale_entries)} "
              f"entry(ies) measured under a different fingerprint; current "
              f"{where}. Re-tune with `python -m repro_torch.tune.runner` "
              f"to use them here.")
    else:
        print(f"# tune-check: OK {path} — {len(cache.entries)} entry(ies) "
              f"valid for {where}")


if __name__ == "__main__":
    _main()
