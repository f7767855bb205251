"""Time kernel #6 (``csrc/selective_scan_bwd.cu``) under other build knobs.

The source takes three ``-D`` values: ``SCAN_BWD_TT`` (the chunk kernel's
time tile), ``SCAN_BWD_GROUP`` (chunks a block) and ``SCAN_BWD_MIN_BLOCKS``
(its launch bound for bf16 input). This script rebuilds the source once
for each entry of ``VARIANTS``, all ``nvcc`` processes at once, into
``build/repro_torch/sweep/``, and times each build through the usual
wrapper at mamba-1.4b's and mamba-2.8b's training shapes in bf16, chunk
``ops.SCAN_CHUNK``. The variants are timed round-robin and each keeps its
fastest round; each variant's outputs are checked against the default
build's; each reports its chunk kernel's registers, spills and warps an SM.
Then the default build runs under ``torch.profiler`` at both shapes, beside
#5 (the ``step`` backward): device time per kernel, so the carry, combine
and chunk kernels and the partial sums read apart. Prints one JSON object.

    PYTHONPATH=src python3 -m repro_torch.tools.sweep_scan_bwd

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import selective_scan as ksc
from repro_torch.tools.sweep_step_bounds import inputs, time_ms

# (tile, group, min blocks of the bf16 build)
VARIANTS = [(8, 4, 4), (8, 1, 4), (8, 2, 4), (8, 8, 4), (8, 4, 3),
            (8, 4, 5), (16, 4, 2), (4, 4, 4)]
DEFAULT = (8, 4, 4)                               # the source's default
PROFILE_CALLS = 5
SHAPES = [(2, 4096, 4096), (2, 4096, 5120)]
ROUNDS = 3


def name(v):
    return f"tt{v[0]}_group{v[1]}_minblocks{v[2]}"


def profile(args, ck, dy, chunk):
    """Device µs per call of each kernel name under ``torch.profiler``:
    #6 (blocked) and #5 (step), ``PROFILE_CALLS`` calls each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    out = {}
    for sched in ("blocked", "step"):
        fn = lambda: ksc.selective_scan_bwd(*args, ck, dy, chunk, sched)
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_CALLS):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name[:80]] = per.get(e.name[:80], 0.0) + \
                    e.time_range.elapsed_us() / PROFILE_CALLS
        out[sched] = dict(sorted(per.items(), key=lambda kv: -kv[1]))
    return out


def build_variants():
    """variant → library path, one per entry of ``VARIANTS``."""
    out = _build.BUILD_ROOT / "sweep" / _build._key()
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "selective_scan_bwd.cu"
    procs = {}
    for v in VARIANTS:
        lib = out / f"libscan_bwd_{name(v)}.so"
        procs[v] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSCAN_BWD_TT={v[0]}",
             f"-DSCAN_BWD_GROUP={v[1]}", f"-DSCAN_BWD_MIN_BLOCKS={v[2]}",
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def use(lib):
    """Route #6's wrapper to ``lib`` (ctypes entries rebound)."""
    _build._libs[ksc._BWD_LIB] = ctypes.CDLL(str(lib))
    for k in [k for k in ksc._entries
              if k == "bwd_params" or k[:1] == ("bwd",) and k[2] ==
              "blocked"]:
        del ksc._entries[k]


def main():
    if not torch.cuda.is_available():
        print("sweep_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_variants()
    chunk = ops.SCAN_CHUNK
    result = {"device": smi, "chunk": chunk, "variants": {}}
    for v in VARIANTS:
        use(libs[v])
        result["variants"][name(v)] = {
            "resources": {dt: ksc.bwd_resources(getattr(torch, dt),
                                                chunk)["chunk"]
                          for dt in ("bfloat16", "float32")}}
    for shape in SHAPES:
        args, dy = inputs(shape, seed=shape[2])
        ck = ksc.selective_scan_fwd(*args, chunk, "blocked")[1]
        use(libs[DEFAULT])
        g0 = ksc.selective_scan_bwd(*args, ck, dy, chunk, "blocked")
        best = {v: float("inf") for v in VARIANTS}
        err = {}
        for _ in range(ROUNDS):
            for v in VARIANTS:
                use(libs[v])
                bwd = lambda: ksc.selective_scan_bwd(*args, ck, dy, chunk,
                                                     "blocked")
                g = bwd()
                err[v] = max((a - b).abs().max().item() /
                             max(1.0, b.abs().max().item())
                             for a, b in zip(g, g0))
                del g
                best[v] = min(best[v], time_ms(bwd))
        for v in VARIANTS:
            if err[v] > 1e-5:
                raise AssertionError(f"variant {v} differs from the default "
                                     f"build at {shape}: {err[v]}")
            result["variants"][name(v)][str(list(shape))] = {
                "bwd_ms": best[v], "max_rel_diff_vs_default": err[v]}
        use(libs[DEFAULT])
        result.setdefault("profile_us", {})[str(list(shape))] = profile(
            args, ck, dy, chunk)
        del args, dy, ck, g0
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
