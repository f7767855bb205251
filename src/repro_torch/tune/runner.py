"""Measurement sweeps (port of ``repro.tune.runner``): time every candidate
of an operator's space at one shape key, cache the winner.

Timing is interleaved min-of-rounds (``tune/timing.py``). What a sweep
measures is the key's ``objective``: "fwd" times the forward (serving);
"fwdbwd" times forward + backward of a scalar loss over (u, Δ, B, C) (a
training step, where the backward's cost can flip the winner). Winners are
cached under objective-tagged keys and never served across objectives.

The kernel candidates join the sweep only where their times mean
something: a CUDA device is present and the operands are on it. On the CPU
they stay out (their plain versions would be timed), as the JAX runner
keeps interpret mode out. A plain candidate that fails (an out-of-memory
error at a large shape, say) is dropped, as in the JAX runner; a kernel
candidate that fails to build, launch or run stops the sweep with its
error, so no kernel is dropped quietly and a plain method cannot win by
default. Where the kernels are in the sweep, each candidate's second call
is timed once (its probe) and a plain candidate whose probe is over
``PRUNE_FACTOR`` × the slowest kernel candidate's is *pruned*: reported
with its probe time, not timed in the rounds, since it cannot win. A
sweep's times go only into a cache fingerprinted for its device.

CLI — the bounded default sweep:

    PYTHONPATH=src python -m repro_torch.tune.runner --out TUNE_CACHE_torch.json \\
        [--rounds 3] [--grid small|fig2] [--objective fwd|fwdbwd|both] \\
        [--force] [--device cuda|cpu]

``fig2`` covers the JAX benchmark matrix's shapes (both scan ops at
L ∈ {256…4096}, plus the wide-head cell); ``small`` is a smoke grid.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tune.cache import (TuneCache, fingerprint, get_cache,
                                    same_device)
from repro_torch.tune.space import (ShapeKey, candidate_name, shape_key,
                                    space_for)
from repro_torch.tune.timing import _default_sync, interleaved_min_of_rounds

PRUNE_FACTOR = 10.0     # a plain candidate this many times the slowest
#                         kernel candidate's probe is not timed in rounds


def _pallas_usable(device: torch.device) -> bool:
    """The kernels run (and are worth timing) only on the card."""
    return device.type == "cuda" and torch.cuda.is_available()


# ---------------------------------------------------------------------------
# synthetic operands per shape key
# ---------------------------------------------------------------------------

def synth_positions(rng, B: int, L: int, resets: str, device="cpu"):
    """Packed position ids matching a reset-density band (space.RESET_BANDS):
    segment length ≈ 1/density, boundaries straddling power-of-two chunks.
    (``rng`` is unused, as in the JAX runner: the draws stay in step.)"""
    if resets == "none":
        row = np.arange(L)
    else:
        seg = min({"sparse": 400, "mid": 100, "dense": 12}.get(resets, 100),
                  L)
        lens = [seg] * (L // seg) + ([L % seg] if L % seg else [])
        row = np.concatenate([np.arange(n) for n in lens])
    return torch.as_tensor(np.broadcast_to(row, (B, L)).copy(),
                           dtype=torch.int32, device=device)


def synth_args(key: ShapeKey, seed: int = 0, device="cpu") -> Tuple:
    """Operator inputs for one shape key (at the bucketed L), drawn from
    ``np.random.default_rng(seed)`` in the JAX runner's order, so they are
    its arrays: (u, Δ, A, B, C, D, positions)."""
    rng = np.random.default_rng(seed)
    B, L, N = key.B, key.Lb, key.N
    dt = getattr(torch, key.dtype)

    def cast(x, dtype=dt):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    pos = synth_positions(rng, B, L, key.resets, device)
    Bm = cast(rng.normal(size=(B, L, N)))
    Cm = cast(rng.normal(size=(B, L, N)))
    if key.op == "selective_scan_heads":
        H, P = key.H, key.dh
        u = cast(rng.normal(size=(B, L, H, P)))
        delta = cast(rng.uniform(0.1, 0.5, (B, L, H)))
        A = -torch.exp(cast(rng.normal(size=(H,)), torch.float32))
        Dk = torch.ones((H,), device=device)
    else:
        D = key.D
        u = cast(rng.normal(size=(B, L, D)))
        delta = cast(rng.uniform(0.1, 0.5, (B, L, D)))
        A = -torch.exp(cast(rng.normal(size=(D, key.N)), torch.float32))
        Dk = torch.ones((D,), device=device)
    return u, delta, A, Bm, Cm, Dk, pos


def make_thunk(key: ShapeKey, knobs: Dict, args: Tuple):
    """A zero-argument callable evaluating one candidate at this shape:
    ``kernels/ops.py`` for a kernel candidate, ``core/ssm.py`` for a plain
    one. With ``key.objective == "fwdbwd"`` it returns (loss, grads) of the
    scalar loss mean(y²) over (u, Δ, B, C); otherwise y, without autograd."""
    u, delta, A, Bm, Cm, Dk, pos = args
    heads = key.op == "selective_scan_heads"
    if knobs.get("backend") == "pallas":
        from repro_torch.kernels import ops as kops
        f = kops.selective_scan_heads if heads else kops.selective_scan
        kw = dict(backend="pallas", schedule=knobs["schedule"],
                  chunk=knobs["pchunk"])
    else:
        from repro_torch.core import ssm as core_ssm
        f = core_ssm.selective_scan_heads if heads else \
            core_ssm.selective_scan
        kw = {"method": knobs.get("method", "blocked")}
        for k in ("chunk", "intra"):
            if k in knobs:
                kw[k] = knobs[k]

    def raw(u, d, Bm, Cm):
        return f(u, d, A, Bm, Cm, Dk, pos, **kw)

    if key.objective == "fwdbwd":
        leaves = [t.detach().requires_grad_() for t in (u, delta, Bm, Cm)]

        def thunk():
            loss = raw(*leaves).float().square().mean()
            return loss.detach(), torch.autograd.grad(loss, leaves)
        return thunk

    def thunk():
        with torch.no_grad():
            return raw(u, delta, Bm, Cm)
    return thunk


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def sweep(key: ShapeKey, rounds: int = 3,
          include_pallas: Optional[bool] = None, verbose: bool = False,
          device=None
          ) -> Tuple[List[Tuple[str, Dict, float]], List[Tuple[str, Dict,
                                                             float]]]:
    """Measure the candidate space at ``key`` on ``device`` (the card
    unless the caller asks for the CPU). Returns (ranked, pruned):
    [(name, knobs, best µs)] fastest first, every candidate timed in the
    rounds, and [(name, knobs, probe µs)] of the pruned ones (module
    docstring)."""
    dev = resolve_device(device)
    if include_pallas is None:
        include_pallas = _pallas_usable(dev)
    args = synth_args(key, device=dev)
    cells, by_name = [], {}
    for c in space_for(key, include_pallas=include_pallas):
        name = candidate_name(c)
        thunk = make_thunk(key, c, args)
        if c.get("backend") == "pallas":
            thunk()           # build + launch probe: a failure is an error
        else:
            try:
                thunk()
            except (RuntimeError, ValueError) as e:
                # e.g. torch.cuda.OutOfMemoryError at a large shape
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                if verbose:
                    print(f"#   tune drop {name}: {type(e).__name__}: {e}")
                continue
        cells.append((name, thunk))
        by_name[name] = c
    if not cells:
        raise RuntimeError(f"no viable candidates for {key.encode()}")
    pruned = []
    kernel = [n for n, _ in cells if by_name[n].get("backend") == "pallas"]
    if kernel:
        probe = {}
        for name, thunk in cells:
            t0 = time.perf_counter()
            _default_sync(thunk())
            probe[name] = (time.perf_counter() - t0) * 1e6
        limit = PRUNE_FACTOR * max(probe[n] for n in kernel)
        pruned = sorted(((n, by_name[n], probe[n]) for n, _ in cells
                         if n not in kernel and probe[n] > limit),
                        key=lambda r: r[2])
        cells = [(n, t) for n, t in cells if n in kernel or
                 probe[n] <= limit]
    best_us, _ = interleaved_min_of_rounds(cells, rounds=rounds, warmup=1)
    ranked = sorted(((n, by_name[n], best_us[n]) for n in best_us),
                    key=lambda r: r[2])
    if verbose:
        print(f"# tune {key.encode()}: " +
              "  ".join(f"{n}={us:.0f}us" for n, _, us in ranked[:4]) +
              (f"  (+{len(ranked) - 4} more)" if len(ranked) > 4 else "") +
              (f"  ({len(pruned)} pruned)" if pruned else ""))
    return ranked, pruned


def tune_key(key: ShapeKey, cache: Optional[TuneCache] = None,
             rounds: int = 3, include_pallas: Optional[bool] = None,
             verbose: bool = False, device=None) -> Dict:
    """Measure the candidate space at ``key``, cache and return the
    winner. The cache must be fingerprinted for ``device``."""
    dev = resolve_device(device)
    if cache is not None and not same_device(cache.fp, fingerprint(dev)):
        raise ValueError(
            f"the cache holds times from {cache.fp.get('platform')}/"
            f"{cache.fp.get('device_kind')}; a sweep on {dev} goes into a "
            f"cache of its own (get_cache(path, device))")
    if include_pallas is None:
        include_pallas = _pallas_usable(dev)
    ranked, _ = sweep(key, rounds=rounds, include_pallas=include_pallas,
                      verbose=verbose, device=dev)
    _, knobs, us = ranked[0]
    if cache is not None:
        cache.put(key, knobs, us, candidates=len(ranked),
                  kernels=include_pallas)
    return knobs


def ensure(op: str, *, B: int, L: int, D: int = 0, N: int = 0, H: int = 0,
           dh: int = 0, dtype="float32", reset_density=None,
           objective: str = "fwd", cache: Optional[TuneCache] = None,
           rounds: int = 3, include_pallas: Optional[bool] = None,
           force: bool = False, verbose: bool = False, device=None) -> bool:
    """Tune ``op`` at this shape unless its exact bucketed key is already
    cached. Returns True iff a new measurement was taken."""
    c = cache if cache is not None else get_cache(device=device)
    key = shape_key(op, dtype=dtype, B=B, L=L, D=D, N=N, H=H, dh=dh,
                    reset_density=reset_density, objective=objective)
    if not force and c.get(key) is not None:
        return False
    tune_key(key, cache=c, rounds=rounds, include_pallas=include_pallas,
             verbose=verbose, device=device)
    return True


# ---------------------------------------------------------------------------
# bounded default sweeps
# ---------------------------------------------------------------------------

def sweep_grid(grid: str) -> List[ShapeKey]:
    """The named bounded sweeps (the JAX runner's). ``fig2`` mirrors the
    JAX benchmark matrix, with the wide-head (dh ≫ T) cell where the dual
    form has a real chance."""
    keys = []
    if grid == "small":
        keys.append(shape_key("selective_scan", B=1, L=128, D=64, N=8))
        keys.append(shape_key("selective_scan_heads", B=1, L=128, H=4,
                              dh=16, N=8))
        return keys
    if grid != "fig2":
        raise ValueError(f"unknown grid {grid!r}")
    for L in (256, 512, 1024, 2048, 4096):
        keys.append(shape_key("selective_scan", B=1, L=L, D=256, N=16))
        keys.append(shape_key("selective_scan_heads", B=1, L=L, H=4,
                              dh=64, N=16))
        keys.append(shape_key("selective_scan_heads", B=1, L=L, H=2,
                              dh=128, N=16))
    return keys


def main(argv=None):
    ap = argparse.ArgumentParser(description="scan-schedule autotune sweep")
    ap.add_argument("--out", default=None,
                    help="cache path (default: $REPRO_TORCH_TUNE_CACHE or "
                         "TUNE_CACHE_torch.json)")
    ap.add_argument("--grid", default="fig2", choices=["small", "fig2"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--force", action="store_true",
                    help="re-measure keys already in the cache")
    ap.add_argument("--objective", default="fwd",
                    choices=["fwd", "fwdbwd", "both"],
                    help="time forward only (serving), forward+backward "
                         "(training), or sweep both")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cache = get_cache(args.out, resolve_device(args.device))
    objectives = ("fwd", "fwdbwd") if args.objective == "both" \
        else (args.objective,)
    n_new = 0
    for base in sweep_grid(args.grid):
        for obj in objectives:
            key = dataclasses.replace(base, objective=obj)
            if not args.force and cache.get(key) is not None:
                continue
            tune_key(key, cache=cache, rounds=args.rounds, verbose=True,
                     device=args.device)
            n_new += 1
    path = cache.save(args.out)
    print(f"# tuned {n_new} new key(s); {len(cache.entries)} total -> {path}")


if __name__ == "__main__":
    main()
