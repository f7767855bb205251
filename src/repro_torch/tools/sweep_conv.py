"""Time the conv kernels #1 (``conv1d_pack``) and #2 (``conv1d_pack_bwd_dx``)
of ``csrc/conv1d_pack.cu`` over the run length (rows a thread walks), a
runtime argument, so one build serves the whole sweep. cuDNN's depthwise ``F.conv1d`` on the same shapes
is the control, timed in the same rounds, and a device-to-device copy of
x's bytes (``copy_`` between two contiguous bf16 tensors) the practical
rate of a kernel that reads and writes as many bytes as #1.

At the serving buckets (2, 64 | 128 | 256, 4096) and the three models'
training shapes, bf16, each run is timed round-robin with the
control, each keeping its fastest round (device time of graph-captured
calls), and its outputs must equal the wrapper's own run's bit for bit
(the FMA chain does not depend on the run). Each shape's row also names
the launch shapes ``conv_params`` picks for both kernels, and their byte
bounds. Prints one JSON object; this is the reading behind ``RUN_MAX`` and
``MIN_BLOCKS_PER_SM`` in ``kernels/conv1d_pack.py``.

    PYTHONPATH=src python3 -m repro_torch.tools.sweep_conv

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv1d_pack as kconv

RUNS = (1, 2, 4, 8, 16, 32, 64)
SHAPES = [(2, 64, 4096), (2, 128, 4096), (2, 256, 4096), (2, 4096, 4096),
          (2, 4096, 5120), (8, 4096, 2048)]
ROUNDS, ITERS = 3, 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet


def graph_ms(fn):
    """Device time of one call: ITERS calls captured in a CUDA graph,
    replayed 3 times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * ITERS)


def inputs(shape, seed):
    """bf16 x as the strided half of an in_proj output, dy, w, bias and
    positions of packed sequences of 3..L/4 tokens."""
    B, L, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(bf)
    x = x.chunk(2, dim=-1)[0]
    dy = torch.randn(shape, generator=g, device="cuda").to(bf)
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(bf)
    b = torch.randn((D,), generator=g, device="cuda").to(bf)
    lens = torch.randint(3, L // 4, (64,), generator=g, device="cuda")
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < L]
    reset = torch.zeros(L, dtype=torch.long, device="cuda")
    reset[starts] = starts
    pos = torch.arange(L, device="cuda") - torch.cummax(reset, 0).values
    return x, dy, w, b, pos.to(torch.int32).expand(B, L).contiguous()


def bound_ms(shape, dx):
    B, L, D = shape
    out = 4 if dx else 2
    return (B * L * D * (2 + out) + B * L * 4 + (4 + (0 if dx else 1)) * D
            * 2) / HBM_BYTES_PER_S * 1e3


def main():
    if not torch.cuda.is_available():
        print("sweep_conv: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"device": smi, "sms": sms, "rounds": ROUNDS, "shapes": {}}
    for shape in SHAPES:
        x, dy, w, b, pos = inputs(shape, seed=shape[1] + shape[2])
        D = shape[2]
        xc = x.transpose(1, 2).contiguous()
        wc = w.t().contiguous()[:, None, :]
        dyc = dy.transpose(1, 2).contiguous()
        wf = w.flip(0).t().contiguous()[:, None, :]
        want_y = kconv.conv1d_pack(x, w, b, pos)
        want_dx = kconv.conv1d_pack_bwd_dx(dy, w, pos)
        src, dst = x.contiguous(), torch.empty_like(x, memory_format=
                                                    torch.contiguous_format)
        fns = {"cudnn_fwd": lambda: F.conv1d(xc, wc, b, padding=3, groups=D),
               "cudnn_dx": lambda: F.conv1d(dyc, wf, padding=3, groups=D),
               "copy": lambda: dst.copy_(src)}
        for run in RUNS:
            y = kconv._launch_fwd(x, w, b, pos, run=run)
            dx = kconv._launch_dx(dy, w, pos, run=run)
            torch.cuda.synchronize()
            if not (torch.equal(y, want_y) and torch.equal(dx, want_dx)):
                raise AssertionError(f"run {run} at {shape} differs from "
                                     f"the wrapper's own run")
            fns[f"fwd run{run}"] = (
                lambda r=run: kconv._launch_fwd(x, w, b, pos, run=r))
            fns[f"dx run{run}"] = (
                lambda r=run: kconv._launch_dx(dy, w, pos, run=r))
        best = {k: float("inf") for k in fns}
        for _ in range(ROUNDS):
            for k, fn in fns.items():
                best[k] = min(best[k], graph_ms(fn))
        result["shapes"][str(list(shape))] = {
            "rule": {k: kconv.conv_params(*shape, torch.bfloat16, k)
                     for k in ("fwd", "bwd_dx")},
            "bound_ms": {"fwd": bound_ms(shape, False),
                         "dx": bound_ms(shape, True)},
            "copy_tb_per_s": 2 * src.numel() * 2 / best["copy"] / 1e9,
            "ms": best}
        del x, dy, xc, dyc, want_y, want_dx, fns, src, dst
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
