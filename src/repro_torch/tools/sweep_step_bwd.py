"""Time kernel #5 (``csrc/selective_scan_step_bwd.cu``) under other build
knobs, with #6 as the control in the same call.

The source takes four ``-D`` values: ``STEP_BWD_R`` (steps a lane),
``STEP_BWD_CH`` (channels a block, the width of its dB/dC partials),
``STEP_BWD_GROUP`` (states between its channel-sum barriers) and
``STEP_BWD_MIN_BLOCKS`` (its launch bound for bf16 input). This script
rebuilds the source once for each entry of ``VARIANTS``, all ``nvcc``
processes at once, into ``build/repro_torch/sweep/``, reports each build's
registers, spills (local bytes) and warps an SM in both builds and its waves
(blocks ÷ (SMs × blocks an SM)) at mamba-2.8b's and mamba-1.4b's training
shapes, then times each build through the usual wrapper at both shapes in
bf16, round-robin with #6, each keeping its fastest round. Every variant's
outputs are checked against the default build's (dB and dC summed over
their partials, whose width a variant may change). Prints one JSON object.

    PYTHONPATH=src python3 -m repro_torch.tools.sweep_step_bwd

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

# (steps a lane, channels a block, group, min blocks of the bf16 build)
VARIANTS = [(8, 16, 8, 5), (8, 16, 4, 5), (8, 16, 8, 4), (8, 16, 16, 3),
            (8, 32, 8, 2), (4, 16, 8, 2)]
DEFAULT = (8, 16, 8, 5)                          # the source's default
SHAPES = [(2, 4096, 5120), (2, 4096, 4096)]
ROUNDS = 3


def name(v):
    return f"r{v[0]}_ch{v[1]}_group{v[2]}_minblocks{v[3]}"


def build_variants():
    """variant → library path, one per entry of ``VARIANTS``."""
    out = _build.BUILD_ROOT / "sweep" / _build._key()
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "selective_scan_step_bwd.cu"
    procs = {}
    for v in VARIANTS:
        lib = out / f"libstep_bwd_{name(v)}.so"
        procs[v] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSTEP_BWD_R={v[0]}",
             f"-DSTEP_BWD_CH={v[1]}", f"-DSTEP_BWD_GROUP={v[2]}",
             f"-DSTEP_BWD_MIN_BLOCKS={v[3]}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def use(lib):
    """Route #5's wrapper to ``lib`` (ctypes entries rebound, the partials'
    width taken from the build)."""
    _build._libs[ksc._STEP_BWD_LIB] = ctypes.CDLL(str(lib))
    for k in [k for k in ksc._entries
              if k == "step_bwd_params" or k[:1] == ("bwd",) and k[2] ==
              "step"]:
        del ksc._entries[k]
    ksc.STEP_BLOCK_D = ksc.step_bwd_params()["block_d"]


def summed(g):
    """#5's outputs with dB and dC summed over their partials."""
    return [x.sum(1) if i in (2, 3) else x for i, x in enumerate(g)]


def main():
    if not torch.cuda.is_available():
        print("sweep_step_bwd: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_variants()
    chunk = ops.SCAN_CHUNK
    result = {"device": smi, "sms": sms, "variants": {}, "control_6": {}}
    for v in VARIANTS:
        use(libs[v])
        res = {dt: ksc.step_bwd_resources(getattr(torch, dt))
               for dt in ("bfloat16", "float32")}
        result["variants"][name(v)] = {
            "params": ksc.step_bwd_params(), "resources": res,
            "waves": {str(list(s)): s[0] * -(-s[2] // v[1]) /
                      (sms * max(1, res["bfloat16"]["blocks_per_sm"]))
                      for s in SHAPES}}
    try:
        for shape in SHAPES:
            args, dy = inputs(shape, seed=shape[2])
            ck = ksc.selective_scan_fwd(*args, chunk, "step")[1]
            use(libs[DEFAULT])
            g0 = summed(ksc.selective_scan_bwd(*args, ck, dy, chunk, "step"))
            best = {v: float("inf") for v in VARIANTS}
            best6, err = float("inf"), {}
            blocked = lambda: ksc.selective_scan_bwd(*args, ck, dy, chunk,
                                                     "blocked")
            for _ in range(ROUNDS):
                best6 = min(best6, time_ms(blocked))
                for v in VARIANTS:
                    use(libs[v])
                    bwd = lambda: ksc.selective_scan_bwd(*args, ck, dy, chunk,
                                                         "step")
                    g = summed(bwd())
                    err[v] = max((a - b).abs().max().item() /
                                 max(1.0, b.abs().max().item())
                                 for a, b in zip(g, g0))
                    del g
                    best[v] = min(best[v], time_ms(bwd))
            for v in VARIANTS:
                if err[v] > 1e-5:
                    raise AssertionError(f"variant {v} differs from the "
                                         f"default build at {shape}: "
                                         f"{err[v]}")
                result["variants"][name(v)][str(list(shape))] = {
                    "bwd_ms": best[v], "max_rel_diff_vs_default": err[v],
                    "vs_6": best[v] / best6}
            result["control_6"][str(list(shape))] = best6
            del args, dy, ck, g0
            torch.cuda.empty_cache()
    finally:
        use(libs[DEFAULT])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
