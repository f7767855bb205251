"""Where the Mamba-2 scan backward (#9) spends its time, by rebuilding it
without parts of its work.

``csrc/selective_scan_heads_bwd.cu`` runs every product through one device
function, ``mma_tile`` (``csrc/heads_mma.cuh``, which the source includes).
This script writes three variants of the source, the header inlined, into
``build/repro_torch/profile_heads_bwd/`` and builds them beside the source
as it is, all ``nvcc`` processes at once:

* ``no_elision``: the cross products whose lo part is exactly 0 for bf16
  operands are issued all the same (three products everywhere, as for f32);
* ``no_fragment_loads``: ``mma_tile`` multiplies values made in registers
  instead of reading its operands from shared memory (wrong outputs);
* ``no_products``: ``mma_tile`` does nothing (wrong outputs): the time of
  everything else (staging, scans, masks, epilogues, barriers, stores).

Each build is timed through the usual wrapper at mamba2-370m's training
shape in bf16, round-robin, each keeping its fastest round. ``no_elision``
must equal the source's build to 1e-6. Prints one JSON object.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_heads_bwd

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import selective_scan_heads as kh

SHAPE, CHUNK = (8, 4096, 32, 64), 256
ROUNDS, ITERS = 3, 5
SOURCE = "selective_scan_heads_bwd"
HEADER = "heads_mma.cuh"


def _once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE}.cu changed: {old!r} is not there once")
    return text.replace(old, new)


def variants(text):
    """name → source text of each variant."""
    head = "template <bool AT, bool BT, bool AX, bool BX>"
    i = text.index(head)
    j = text.index("__device__ __forceinline__ void zero(")
    body = text[i:j]
    k = body.index("  const int lane = threadIdx.x & 31")
    empty = body[:k] + "  (void)a; (void)b; (void)ks; (void)m0; (void)n0;\n}\n\n"
    regs = body
    for old, new in (
            ("AT ? a[ka * LD + r0] : a[r0 * LD + ka]", "__int_as_float(ka + r0)"),
            ("AT ? a[ka * LD + r1] : a[r1 * LD + ka]", "__int_as_float(ka + r1)"),
            ("AT ? a[kb * LD + r0] : a[r0 * LD + kb]", "__int_as_float(kb + r0)"),
            ("AT ? a[kb * LD + r1] : a[r1 * LD + kb]", "__int_as_float(kb + r1)"),
            ("BT ? b[col * LD + k] : b[k * LD + col]", "__int_as_float(col + k)"),
            ("const float sa = ks[ka], sb = ks[kb];",
             "const float sa = 1.f + ka, sb = 1.f + kb;")):
        regs = _once(regs, old, new)
    return {
        "no_elision": _once(text, "static constexpr bool RAW = sizeof(T) == 2;",
                            "static constexpr bool RAW = false;"),
        "no_fragment_loads": text[:i] + regs + text[j:],
        "no_products": text[:i] + empty + text[j:]}


def build():
    """name → library path: the source's own build and each variant."""
    out = _build.BUILD_ROOT / "profile_heads_bwd" / _build._key()
    out.mkdir(parents=True, exist_ok=True)
    libs = {"kernel": _build.build_all()[SOURCE]}
    procs = {}
    text = _once((_build.CSRC / f"{SOURCE}.cu").read_text(),
                 f'#include "{HEADER}"', (_build.CSRC / HEADER).read_text())
    for name, text in variants(text).items():
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use(lib):
    """Route the backward's wrapper to ``lib`` (its entries rebound)."""
    _build._libs[SOURCE] = ctypes.CDLL(str(lib))
    for k in [k for k in kh._entries if k[0] == "bwd"]:
        del kh._entries[k]


def inputs(seed):
    """bf16 u, Δ, dy; B and C as strided views of one projection; A from
    the model's init; positions of packed sequences of 3..L/4 tokens."""
    B, L, H, P = SHAPE
    N = kh.D_STATE
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    u = torch.randn(SHAPE, generator=g, device="cuda").to(bf)
    dt = torch.rand((B, L, H), generator=g, device="cuda").mul(0.1).add(
        1e-3).to(bf)
    Bm, Cm = torch.randn((B, L, 2 * N), generator=g, device="cuda").to(
        bf).chunk(2, dim=-1)
    A = -(torch.rand(H, generator=g, device="cuda") * 15.0 + 1.0)
    Dp = torch.ones(H, device="cuda")
    lens = torch.randint(3, L // 4, (64,), generator=g, device="cuda")
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < L]
    reset = torch.zeros(L, dtype=torch.long, device="cuda")
    reset[starts] = starts
    pos = torch.arange(L, device="cuda") - torch.cummax(reset, 0).values
    pos = pos.to(torch.int32).expand(B, L).contiguous()
    dy = torch.randn(SHAPE, generator=g, device="cuda").to(bf)
    return (u, dt, A, Bm, Cm, Dp, pos), dy


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
        print("profile_heads_bwd: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build()
    args, dy = inputs(seed=SHAPE[1])
    _, ck = kh.selective_scan_heads_fwd(*args, CHUNK)
    use(libs["kernel"])
    ref = kh.selective_scan_heads_bwd(*args, ck, dy, CHUNK)
    best = {name: float("inf") for name in libs}
    diff = {}
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            use(lib)
            bwd = lambda: kh.selective_scan_heads_bwd(*args, ck, dy, CHUNK)
            out = bwd()
            diff[name] = max(((a - b).abs().max() /
                              b.abs().max().clamp(min=1.0)).item()
                             for a, b in zip(out, ref))
            del out
            best[name] = min(best[name], time_ms(bwd))
    if diff["no_elision"] > 1e-6:
        raise AssertionError(f"no_elision differs from the kernel: "
                             f"{diff['no_elision']}")
    print(json.dumps({"device": smi, "shape": list(SHAPE), "chunk": CHUNK,
                      "dtype": "bfloat16", "ms": best,
                      "max_rel_diff_vs_kernel": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
