"""Shape-keyed autotuning of the scan hot path (port of ``repro.tune``).

PackMamba's core move is picking the best parallelization for each tensor
shape (paper §4). This package replaces the port's hand-set choices — the
Mamba-1 schedule (``step`` #3/#5 or ``blocked`` #4/#6) and its chunk, the
heads schedule (#7 or #8) and its chunk, the plain scans' method, chunk and
in-chunk evaluator — with measured, cached decisions:

  space.py   the tunable space of each operator, shape-key buckets
  timing.py  interleaved min-of-rounds timing
  runner.py  measurement sweeps per shape key
  cache.py   the persistent cache file (``TUNE_CACHE_torch.json``),
             fingerprinted by device name, platform, torch and CUDA

``tuned()`` is the one resolver every call site goes through
(``core/ssm.py`` and ``kernels/ops.py`` by their ``tune=`` argument; the
models by ``ArchConfig.scan_tune``). A miss falls back to the caller's
arguments and never blocks: measurement happens only in
``warm_for_config`` and the runner.

    cfg = dataclasses.replace(cfg, scan_tune="auto")   # or a cache path
    # launch/train.py and launch/serve.py warm the cache for their shapes
    # at start-up (--scan-tune); python -m repro_torch.tune.runner sweeps.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.tune.space import (OPS, OBJECTIVES, ShapeKey,  # noqa: F401
                                    candidate_name, l_bucket, reset_bucket,
                                    shape_key, space_for)
from repro_torch.tune.cache import (TuneCache, as_device,  # noqa: F401
                                    default_path, fingerprint, get_cache,
                                    reset_caches, set_cache)


def tuned_entry(op: str, *, B: int, L: int, D: int = 0, N: int = 0,
                H: int = 0, dh: int = 0, dtype="float32",
                reset_density: Optional[float] = None,
                objective: str = "fwd", cache=None,
                device=None) -> Optional[Dict]:
    """The cache entry serving one operator call on ``device`` (the card
    where there is one, else the CPU): {knobs, us, candidates, kernels},
    or None on a miss.

    ``cache``: a TuneCache, a path, or None (the process-default cache,
    $REPRO_TORCH_TUNE_CACHE or ./TUNE_CACHE_torch.json). Lookup is exact on
    the bucketed key, then the nearest key of the op *and objective*; a
    stale cache (another fingerprint) always misses, and so does a
    TuneCache measured on another platform than ``device``'s."""
    if isinstance(cache, TuneCache):
        c = cache
        if c.fp.get("platform") != as_device(device).type:
            return None
    else:
        c = get_cache(cache, device)
    key = shape_key(op, dtype=dtype, B=B, L=L, D=D, N=N, H=H, dh=dh,
                    reset_density=reset_density, objective=objective)
    return c.lookup_entry(key)[0]


def tuned(op: str, *, B: int, L: int, D: int = 0, N: int = 0, H: int = 0,
          dh: int = 0, dtype="float32", reset_density: Optional[float] = None,
          objective: str = "fwd", cache=None,
          default: Optional[Dict] = None, device=None) -> Dict:
    """Measured knobs for one operator call (``tuned_entry``), or the
    defaults (``default`` or {}) on a miss."""
    rec = tuned_entry(op, B=B, L=L, D=D, N=N, H=H, dh=dh, dtype=dtype,
                      reset_density=reset_density, objective=objective,
                      cache=cache, device=device)
    if rec is None:
        return dict(default) if default else {}
    return {**(default or {}), **rec["knobs"]}


def config_shape_args(cfg, B: int, L: int) -> Optional[Dict]:
    """Map an ArchConfig's scan operator to ``tuned()`` shape kwargs."""
    kinds = set(cfg.unit)
    if "mamba2" in kinds:
        return dict(op="selective_scan_heads", B=B, L=L, N=cfg.d_state,
                    H=cfg.n_ssm_heads, dh=cfg.ssm_hd, dtype=cfg.dtype)
    if "mamba" in kinds:
        return dict(op="selective_scan", B=B, L=L, D=cfg.d_inner,
                    N=cfg.d_state, dtype=cfg.dtype)
    return None


def tuned_config_overrides(cfg, B: int, L: int, cache=None) -> Dict:
    """The cached winner for ``cfg``'s scan at (B, L) as ArchConfig
    override fields: a Mamba-1 kernel winner sets ``pallas_schedule``, a
    plain winner ``scan_impl``/``scan_chunk``/``scan_intra``. (The port has
    no ``use_pallas``: the tensors' device picks the kernels, and no field
    holds the heads schedule, so a heads kernel winner maps to nothing.)
    {} when nothing is cached."""
    args = config_shape_args(cfg, B, L)
    if args is None:
        return {}
    op = args.pop("op")
    kn = tuned(op, cache=cache, **args)
    if not kn:
        return {}
    out: Dict = {}
    if kn.get("backend") == "pallas":
        if op == "selective_scan" and "schedule" in kn:
            out["pallas_schedule"] = kn["schedule"]
    else:
        if "method" in kn:
            out["scan_impl"] = kn["method"]
        if "chunk" in kn:
            out["scan_chunk"] = kn["chunk"]
        if "intra" in kn:
            out["scan_intra"] = kn["intra"]
    return out


def warm_for_config(cfg, shapes, cache: Optional[TuneCache] = None,
                    rounds: int = 3, save: bool = True, verbose: bool = True,
                    objective: str = "fwd", device=None, obs=None):
    """Warm the tuning cache for a config's scan shapes at launcher start-up.

    ``shapes``: the (rows, seq_len) the launcher will run (the training
    batch, the serving prefill buckets). Shapes whose bucketed key is
    cached are skipped; new winners are measured on ``device`` (the card
    unless the caller asks for the CPU) and saved to the cache file.
    ``objective="fwdbwd"`` times forward + backward — what
    launch/train.py warms. ``obs`` receives the sweeps' ``tune.*`` spans
    and counters (``runner.sweep``). Returns the cache (None when tuning
    is off)."""
    if getattr(cfg, "scan_tune", "off") == "off":
        return None
    from repro_torch.tune import runner
    path = None if cfg.scan_tune == "auto" else cfg.scan_tune
    c = cache if cache is not None else get_cache(path, device)
    touched = False
    for rows, L in shapes:
        args = config_shape_args(cfg, rows, L)
        if args is None:
            return None
        op = args.pop("op")
        touched |= runner.ensure(op, cache=c, rounds=rounds,
                                 verbose=verbose, objective=objective,
                                 device=device, obs=obs, **args)
    if touched and save:
        c.save()
    return c
