"""Time the step-schedule scan forward (#3) under other launch bounds.

``csrc/selective_scan_step.cu`` cuts #3's register budget with
``__launch_bounds__(256, MIN_BLOCKS)``. This script rebuilds the source once
for each ``MIN_BLOCKS`` in ``VARIANTS``, all ``nvcc`` processes at once,
into ``build/repro_torch/sweep/``, and times each build's forward through
the usual wrapper at mamba-2.8b's and mamba-1.4b's training shapes in bf16.
The variants are timed round-robin and each keeps its fastest round; each
variant's outputs are checked against the default build's. Prints one JSON
object. (#5, the backward, has its own source and sweep:
``tools/sweep_step_bwd.py``.)

    PYTHONPATH=src python3 -m repro_torch.tools.sweep_step_bounds

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import selective_scan as ksc

VARIANTS = [1, 2, 3, 4]           # blocks an SM of the forward
DEFAULT = 4                       # the source's default
SHAPES = [(2, 4096, 5120), (2, 4096, 4096)]
ROUNDS, ITERS = 3, 20


def build_variants():
    """variant → library path, one per entry of ``VARIANTS``."""
    out = _build.BUILD_ROOT / "sweep" / _build._key()
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "selective_scan_step.cu"
    procs = {}
    for f in VARIANTS:
        lib = out / f"libstep_f{f}.so"
        procs[f] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             f"-DSTEP_FWD_MIN_BLOCKS={f}", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def use(lib):
    """Route the step forward wrapper to ``lib`` (ctypes entry rebound)."""
    _build._libs["selective_scan_step"] = ctypes.CDLL(str(lib))
    for k in [k for k in ksc._entries if k[:1] == ("fwd",) and k[2] ==
              "step"]:
        del ksc._entries[k]


def inputs(shape, seed):
    """bf16 u, Δ, dy; B and C as strided views of one projection; A from
    the model's init; positions of packed sequences of 3..L/4 tokens."""
    B, L, D = shape
    N = ksc.D_STATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    u = torch.randn(shape, generator=g, device="cuda").to(bf)
    dt = torch.rand(shape, generator=g, device="cuda").mul(0.1).add(
        1e-3).to(bf)
    _, Bm, Cm = torch.randn((B, L, 128 + 2 * N), generator=g,
                            device="cuda").to(bf).split([128, N, N], -1)
    At = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda")[
        :, None].repeat(1, D)
    Dp = torch.ones(D, device="cuda")
    lens = torch.randint(3, L // 4, (64,), generator=g, device="cuda")
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < L]
    pos = torch.arange(L, device="cuda")
    reset = torch.zeros(L, dtype=torch.long, device="cuda")
    reset[starts] = starts
    pos = (pos - torch.cummax(reset, 0).values).to(torch.int32)
    pos = pos.expand(B, L).contiguous()
    dy = torch.randn(shape, generator=g, device="cuda").to(bf)
    return (u, dt, At, Bm, Cm, Dp, pos), dy


def time_ms(fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main():
    if not torch.cuda.is_available():
        print("sweep_step_bounds: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_variants()
    chunk = ksc.STEP_TILE_T
    result = {"device": smi, "variants": {}}
    for shape in SHAPES:
        args, _ = inputs(shape, seed=shape[2])
        use(libs[DEFAULT])
        y0, ck0 = ksc.selective_scan_fwd(*args, chunk, "step")
        best = {v: float("inf") for v in VARIANTS}
        err = {}
        for _ in range(ROUNDS):
            for v in VARIANTS:
                use(libs[v])
                fwd = lambda: ksc.selective_scan_fwd(*args, chunk, "step")
                y, ck = fwd()
                err[v] = max((y.float() - y0.float()).abs().max().item(),
                             (ck - ck0).abs().max().item())
                del y, ck
                best[v] = min(best[v], time_ms(fwd))
        for v in VARIANTS:
            if err[v] > 1e-5:
                raise AssertionError(f"variant {v} differs from the default "
                                     f"build at {shape}: {err[v]}")
            result["variants"].setdefault(f"fwd{v}", {})[str(list(shape))] = {
                "fwd_ms": best[v], "max_diff_vs_default": err[v]}
        del args, y0, ck0
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
