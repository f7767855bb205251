"""Time the Mamba-1 scan forward (``csrc/selective_scan.cu``: kernel #4,
and #3, the same kernel under another name) under other build knobs, with
#6 as the control in the same call.

The source takes three ``-D`` values: ``SCAN_LANES_R`` (steps a lane),
``SCAN_LANES_CH`` (channels a block) and ``SCAN_LANES_MIN_BLOCKS`` (the
launch bound of its chunk-64 kernel for bf16 input).
This script rebuilds the source once for each entry of ``VARIANTS``, all
``nvcc`` processes at once, into ``build/repro_torch/sweep/``, reports each
build's registers, spills (local bytes) and warps an SM in both builds and
its waves (blocks ÷ (SMs × blocks an SM)) at each shape, then times each
build through #4's wrapper at chunk 64 at mamba-2.8b's and mamba-1.4b's
training shapes and a ragged one in bf16, round-robin with #6, each keeping
its fastest round. Every variant's outputs are checked against the default
build's: y within two bf16 roundings (a variant may add the steps in
another order), the checkpoints within 1e-4 · (1 + |default|). Prints one
JSON object.

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

# (steps a lane, channels a block, min blocks of the bf16 build)
VARIANTS = [(8, 16, 5), (8, 16, 6), (8, 32, 3), (4, 16, 5), (16, 16, 5),
            (16, 32, 3)]
DEFAULT = (8, 16, 5)                             # the source's default
SHAPES = [(2, 4096, 5120), (2, 4096, 4096), (2, 997, 4104)]
ROUNDS, ITERS = 3, 20


def name(v):
    return f"r{v[0]}_ch{v[1]}_minblocks{v[2]}"


def build_variants():
    """variant → library path, one per entry of ``VARIANTS``."""
    out = _build.BUILD_ROOT / "sweep" / _build._key()
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "selective_scan.cu"
    procs = {}
    for v in VARIANTS:
        lib = out / f"libscan_fwd_{name(v)}.so"
        procs[v] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DSCAN_LANES_R={v[0]}",
             f"-DSCAN_LANES_CH={v[1]}", f"-DSCAN_LANES_MIN_BLOCKS={v[2]}",
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
    """Route the forward's wrappers to ``lib`` (ctypes entries rebound)."""
    _build._libs[ksc._FWD_LIB] = ctypes.CDLL(str(lib))
    for k in [k for k in ksc._entries
              if k == "lanes_fwd_params" or k[:1] == ("fwd",)]:
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


def excess(y, ck, y0, ck0):
    """How far (y, ck) exceed the tolerance against the default build's
    (y0, ck0): <= 0 passes. Returns (excess, max |Δy|, max |Δck|)."""
    y, y0 = y.float(), y0.float()
    ey, eck = (y - y0).abs(), (ck - ck0).abs()
    over_y = ey - (2.0 ** -7 * y0.abs() + 1e-4 * y0.abs().max())
    over_ck = eck - 1e-4 * (1 + ck0.abs())
    return (max(over_y.max().item(), over_ck.max().item()),
            ey.max().item(), eck.max().item())


def main():
    if not torch.cuda.is_available():
        print("sweep_step_bounds: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_variants()
    chunk = ksc.STEP_TILE_T
    result = {"device": smi, "sms": sms, "variants": {}, "control_6": {}}
    for v in VARIANTS:
        use(libs[v])
        res = {dt: ksc.lanes_fwd_resources(getattr(torch, dt))
               for dt in ("bfloat16", "float32")}
        result["variants"][name(v)] = {
            "params": ksc.lanes_fwd_params(), "resources": res,
            "waves": {str(list(s)): s[0] * -(-s[2] // v[1]) /
                      (sms * max(1, res["bfloat16"]["blocks_per_sm"]))
                      for s in SHAPES}}
    try:
        for shape in SHAPES:
            args, dy = inputs(shape, seed=shape[2])
            use(libs[DEFAULT])
            y0, ck0 = ksc.selective_scan_fwd(*args, chunk)
            best = {v: float("inf") for v in VARIANTS}
            best6, err = float("inf"), {}
            bwd = lambda: ksc.selective_scan_bwd(*args, ck0, dy, chunk)
            for _ in range(ROUNDS):
                best6 = min(best6, time_ms(bwd))
                for v in VARIANTS:
                    use(libs[v])
                    fwd = lambda: ksc.selective_scan_fwd(*args, chunk)
                    y, ck = fwd()
                    err[v] = excess(y, ck, y0, ck0)
                    del y, ck
                    best[v] = min(best[v], time_ms(fwd))
            for v in VARIANTS:
                if err[v][0] > 0:
                    raise AssertionError(f"variant {v} differs from the "
                                         f"default build at {shape}: "
                                         f"{err[v]}")
                result["variants"][name(v)][str(list(shape))] = {
                    "fwd_ms": best[v], "max_diff_y": err[v][1],
                    "max_diff_ckpts": err[v][2], "vs_6": best[v] / best6}
            result["control_6"][str(list(shape))] = best6
            del args, dy, y0, ck0
            torch.cuda.empty_cache()
    finally:
        use(libs[DEFAULT])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
