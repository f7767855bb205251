#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device   — the card's name; ``nvidia-smi``'s name and power limit on a
              line of their own. No CUDA device: exit 1, no result.
2. build    — every CUDA source in ``src/repro_torch/csrc`` with ``nvcc``
              (one process per source, started together).
3. kernels  — each kernel against its plain PyTorch version at the main
              paths' shapes, in bf16 and f32, timed beside the plain
              version, the library yardstick (where one PyTorch call
              computes the same function) and the least time the card could
              take: #1 conv1d_pack forward (the serving buckets) and #2
              its dx backward, both at the three models' training shapes
              and one element a thread at (2, 997, 4100), twice and
              bitwise equal (their run lengths, blocks, registers and
              spills in their ``kernels`` entries' ``resources``);
              the Mamba-1 selective scan's two schedules, #4 / #6 (blocked;
              #4 is #3's kernel with any chunk, also run at chunks 128
              and 48; #6 chunk-parallel: carry, combine and chunk kernels; the
              build knobs and resources of both in their ``kernels``
              entries) and #3 / #5 (step) forward / backward (each 8 steps
              a lane, its registers, warps an SM and waves in its rows' and
              its entry's ``resources``), at the mamba-1.4b and
              mamba-2.8b training shapes and a ragged one, timed in the same
              call and checked against each other (#3's checkpoints against
              #4's, #5 against #6); #7 / #8 / #9 the head-structured
              (Mamba-2) scan forward (the chunked form on the tensor
              cores), its dual form and their backward. The scan kernels
              and #7 run twice and must agree bitwise.
4. parity   — serving: ``prefill_packed`` end logits and states of 4
              prompts against per-prompt ``prefill`` (f32, full width).
5. engine   — the serving main path: the continuous-batching engine on
              mamba-1.4b (48 layers, bf16, seed 0), 12 greedy requests ×
              16 new tokens; every launch counter set to 0 just before and
              read just after (only the conv forward may run).
6. train_parity — mamba-1.4b at full width, 2 layers, f32 with TF32 off:
              the loss and every parameter's gradient through the kernels
              against autograd through the plain ``core/`` conv and scan.
6b. train_parity_mamba2 — the same for mamba2-370m (2 layers), once with
              the heads scan's ``blocked_heads`` schedule (#7 then #9) and
              once with ``blocked_heads_dual`` (#8 then #9).
7. train    — the training main path: mamba-1.4b at full width and depth,
              bf16 compute, f32 params, random weights from seed 0,
              ``Trainer`` + ``PackingLoader`` (pack, 2 × 4096, paper
              lengths from seed 0): 1 warm-up step, then 4 timed steps with
              every launch counter set to 0 just before and read just after
              (exact counts per step asserted); one more pack step under
              ``torch.profiler`` (device time by kernel, the device's busy
              share; it must name #6's three kernels 3 × 48 times); then 2
              steps in ``pad`` mode for the paper's comparison. Every
              profiled step runs with the launch counters too, which must
              repeat the timed steps' counts, and its trace must name each
              counted kernel as often as it launched: a trace that lost a
              device record is set aside and the step traced again (at
              most 3 traces).
8. Mamba-2 — serving parity and the engine on mamba2-370m (48 layers,
              bf16), then its training main path: 48 layers, 8 × 4096
              packed (``train_mamba2``), launch counts asserted exactly,
              one profiled step (which must name #7 and #9, 96 and 48
              calls), 2 ``pad`` steps.
9. step     — mamba-2.8b with ``pallas_schedule="step"``: full-width parity
              (2 layers, f32, TF32 off; #1, #2, #3, #5 against autograd
              through the plain path), then its training main path
              (``train_step``): 64 layers, d_model 2560, 2 × 4096 packed,
              bf16, 1 warm-up and 4 timed steps with exact launch counts per
              step (#1 128, #2 64, #3 128, #5 64, #4 and #6 0) and one
              profiled step, which must name #3 and #5 128 and 64 times;
              pack only.
10. tune    — the scan autotuner (``repro_torch.tune``) into a cache file in
              a temporary directory: the sweep of mamba-1.4b's layer shape
              (2, 4096, d_inner 4096, N 16, bf16, packed, forward +
              backward) and of mamba2-370m's (8, 4096, 32 heads of 64, N
              64, bf16, forward), every candidate's µs (the probe µs of
              those pruned) and the winner; each kernel candidate must be
              measured. Then ``train`` again with ``scan_tune=<that
              cache>`` (exact launch counts of the winner's kernels,
              nothing else; the host µs of the scans' tune resolution and
              the lookups its memo missed), and the mamba-1.4b engine
              with ``scan_tune`` on (it sweeps its three prefill buckets),
              beside the untuned numbers of this run.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 494.7e12            # H100 SXM dense TF32 on the tensor cores
SFU_PER_SM_CLOCK = 16            # exp2 results per clock per SM (sm_90)
SHAPES = [(2, 64, 4096), (2, 128, 4096), (2, 256, 4096), (2, 4096, 4096)]
MAIN_SHAPE = (2, 256, 4096)      # the largest prefill bucket (serving)
TRAIN_SHAPE = (2, 4096, 4096)    # (rows, L, d_inner): mamba-1.4b training
TRAIN_SHAPE_28 = (2, 4096, 5120)  # mamba-2.8b training
RAGGED_SHAPE = (2, 997, 4096)    # an L that is no multiple of any tile
MAMBA2_CONV_SHAPE = (8, 4096, 2048)  # mamba2-370m training: (rows, L, d_inner)
ONE_WIDE_SHAPE = (2, 997, 4100)  # D no multiple of 8: #1 and #2 one
#                                  element a thread in bf16
CONV_TRAIN_SHAPES = {"mamba-1.4b": TRAIN_SHAPE, "mamba-2.8b": TRAIN_SHAPE_28,
                     "mamba2-370m": MAMBA2_CONV_SHAPE}
SCAN_RAGGED = (2, 997, 4104)     # and a D that is no multiple of a channel
#                                  block (16 or 32)
SCAN_CASES = ((TRAIN_SHAPE, "bfloat16"), (TRAIN_SHAPE_28, "bfloat16"),
              (SCAN_RAGGED, "bfloat16"), (SCAN_RAGGED, "float32"),
              (TRAIN_SHAPE, "float32"))
SCAN_OTHER_CHUNKS = (128, 48)     # #4 off the main path's chunk 64, at
#                                  SCAN_RAGGED (its any-chunk kernel): chunk
#                                  starts on tile edges and inside tiles
SCAN_KERNELS = {"blocked": ("selective_scan_fwd", "selective_scan_bwd"),
                "step": ("selective_scan_fwd_step", "selective_scan_bwd_step")}
HEADS_SHAPE = (8, 4096, 32, 64)  # (rows, L, H, P): mamba2-370m training
HEADS_RAGGED = (8, 997, 32, 64)
HEADS_N = 64                     # mamba2-370m's d_state
PARITY_TOL = 1e-3                # max |Δ| / max(1, max |ref|), 48 f32 layers
TRAIN_PARITY_TOL = 1e-3          # max |Δ| / max |ref| per gradient leaf
BWD_TOL = 1e-3                   # max |Δ| / max(1, max |ref|) per output
TIMED_STEPS = 4
# the tune phase's sweeps: mamba-1.4b's training layer and mamba2-370m's
# layer (forward, where the two heads forms differ; #9 serves both)
TUNE_SWEEPS = (dict(op="selective_scan", B=2, L=4096, D=4096, N=16,
                    dtype="bfloat16", objective="fwdbwd"),
               dict(op="selective_scan_heads", B=8, L=4096, H=32, dh=64,
                    N=64, dtype="bfloat16", objective="fwd"))
TUNE_ROUNDS = 3


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def eager_ms(fn, iters=100, warmup=10):
    """Time of one call in a host loop (host overhead included): CUDA
    events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50, reps=5):
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch
    overhead is out of the number. Inputs stay in L2 between calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def packed_positions(B, L, seed):
    """Row 0 packs prompts of 3..L/4 tokens back to back (resets fall
    inside tiles and chunks); row 1 is a carried row of a split pack
    (positions > 0 at its start). Every other row packs like row 0."""
    import numpy as np
    from repro_torch.core import packing
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, L // 4, size=64)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), L, side="right"))]
    pb = packing.pack([rng.integers(1, 9, size=int(n)) for n in lens], L,
                      policy="sequential", num_rows=B)
    sp = packing.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L)
    pos = np.tile(pb.positions[:1], (B, 1))
    pos[1] = sp.positions[1]
    assert sp.carry_mask[1] and pos[1, 0] > 0
    return pos


def conv_inputs(shape, dtype, seed):
    """x_in as the strided half of an in_proj output; positions from
    ``packed_positions``."""
    import torch
    B, L, D = shape
    pos = packed_positions(B, L, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(dtype)
    x_in = xz.chunk(2, dim=-1)[0]
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(dtype)
    b = torch.randn((D,), generator=g, device="cuda").to(dtype)
    return x_in, w, b, torch.as_tensor(pos, device="cuda")


def bound_ms(nbytes, flops, peak=F32_FLOPS):
    """The least time for the work: bytes over the memory rate or
    operations over ``peak`` (the f32 rate unless given), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def conv_bound_ms(x, w, positions):
    B, L, D = x.shape
    es = x.element_size()
    return bound_ms(2 * B * L * D * es + positions.numel() * 4
                    + (w.numel() + D) * es, 2 * w.shape[0] * B * L * D)


def timing_iters(shape):
    """Graph-captured calls per replay: fewer at training size, where each
    call's outputs are hundreds of MB of the graph's private pool."""
    return 50 if shape[1] <= 256 else 10


def phase_conv_fwd():
    """Kernel #1 at the serving buckets, the three models' training shapes
    and a one-element-wide shape, against ``conv1d_pack_plain``; twice,
    bitwise equal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    rows, worst = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (*SHAPES, TRAIN_SHAPE_28, MAMBA2_CONV_SHAPE,
                      ONE_WIDE_SHAPE):
            x, w, b, pos = conv_inputs(shape, dtype, seed=shape[1])
            y = kconv.conv1d_pack(x, w, b, pos)
            launch = kconv.LAST_LAUNCH
            again = kconv.conv1d_pack(x, w, b, pos)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise AssertionError(f"conv1d_pack kernel is not bitwise "
                                     f"repeatable at {shape} {dtype}")
            want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(),
                                           pos)
            err = (y.float() - want).abs()
            if dtype == torch.float32:
                ok, tol = bool((err <= 1e-5).all()), "1e-5 abs"
            else:      # one bf16 rounding of the f32-accumulated result
                ok = bool((err <= 2.0 ** -8 * want.abs() + 1e-6).all())
                tol = "2^-8 relative (one bf16 rounding)"
            if not ok:
                raise AssertionError(f"conv1d_pack kernel disagrees with its "
                                     f"plain version at {shape} {dtype}: "
                                     f"max err {err.max().item()}")
            worst = max(worst, err.max().item())
            # library yardstick: cuDNN depthwise conv on a reset-free input
            xc = x.transpose(1, 2).contiguous()
            wc = w.t().contiguous()[:, None, :]
            lib = lambda: F.conv1d(xc, wc, b, padding=3, groups=shape[2])
            bound, by = conv_bound_ms(x, w, pos)
            kern = lambda: kconv.conv1d_pack(x, w, b, pos)
            plain = lambda: kconv.conv1d_pack_plain(x, w, b, pos)
            it = timing_iters(shape)
            rows.append({
                "kernel": "conv1d_pack_fwd",
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err.max().item(), "tolerance": tol,
                "bitwise_repeat": True,
                "launch": launch,
                "kernel_ms": graph_ms(kern, it), "plain_ms":
                graph_ms(plain, it), "library_ms": graph_ms(lib, it),
                "bound_ms": bound, "bound_by": by,
                "kernel_eager_ms": eager_ms(kern),
                "plain_eager_ms": eager_ms(plain),
                "library_eager_ms": eager_ms(lib)})
            emit("kernels", **rows[-1])
            del x, y, again, want, err, xc
    return rows, worst


def phase_conv_dx():
    """Kernel #2 at the three models' training shapes, a ragged L and a
    one-element-wide shape, against ``conv1d_pack_bwd_dx_plain``; twice,
    bitwise equal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    rows, worst = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (TRAIN_SHAPE, RAGGED_SHAPE, TRAIN_SHAPE_28,
                      MAMBA2_CONV_SHAPE, ONE_WIDE_SHAPE):
            B, L, D = shape
            pos = torch.as_tensor(packed_positions(B, L, L), device="cuda")
            g = torch.Generator(device="cuda").manual_seed(L + 1)
            dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
            w = torch.randn((4, D), generator=g, device="cuda").mul(
                0.5).to(dtype)
            dx = kconv.conv1d_pack_bwd_dx(dy, w, pos)
            launch = kconv.LAST_LAUNCH
            again = kconv.conv1d_pack_bwd_dx(dy, w, pos)
            torch.cuda.synchronize()
            want = kconv.conv1d_pack_bwd_dx_plain(dy, w, pos)
            err = (dx - want).abs()
            tol = "1e-5 · (1 + |ref|) (f32 on both sides, taps reordered)"
            if not bool((err <= 1e-5 * (1 + want.abs())).all()):
                raise AssertionError(f"conv1d_pack dx kernel disagrees with "
                                     f"its plain version at {shape} {dtype}: "
                                     f"max err {err.max().item()}")
            if not torch.equal(dx, again):
                raise AssertionError("conv1d_pack dx kernel is not bitwise "
                                     "repeatable")
            worst = max(worst, err.max().item())
            # library yardstick: cuDNN depthwise correlation with the flipped
            # weights, right-padded, on a reset-free input
            dyc = dy.transpose(1, 2).contiguous()
            wf = w.flip(0).t().contiguous()[:, None, :]
            lib = lambda: F.conv1d(dyc, wf, padding=3, groups=D)
            es = dy.element_size()
            bound, by = bound_ms(B * L * D * (es + 4) + B * L * 4
                                 + 4 * D * es, 2 * 4 * B * L * D)
            kern = lambda: kconv.conv1d_pack_bwd_dx(dy, w, pos)
            plain = lambda: kconv.conv1d_pack_bwd_dx_plain(dy, w, pos)
            rows.append({
                "kernel": "conv1d_pack_bwd_dx", "shape": list(shape),
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err.max().item(), "tolerance": tol,
                "bitwise_repeat": True,
                "launch": launch,
                "kernel_ms": graph_ms(kern, 10, 3),
                "plain_ms": graph_ms(plain, 10, 3),
                "library_ms": graph_ms(lib, 10, 3), "bound_ms": bound,
                "bound_by": by, "kernel_eager_ms": eager_ms(kern, 20, 3),
                "plain_eager_ms": eager_ms(plain, 5, 1),
                "library_eager_ms": eager_ms(lib, 20, 3)})
            emit("kernels", **rows[-1])
            del dy, dx, again, want, err, dyc
    return rows, worst


def exp_floor_ms(n_exp, sfu_rate):
    """What ``n_exp`` exponentials cost at the special-function unit's
    rate alone."""
    return n_exp / sfu_rate * 1e3


def scan_inputs(shape, dtype, seed):
    """u, Δ, dy (B, L, D) in ``dtype``; B and C as strided views of one
    (B, L, dt_rank + 2N) projection, as the model hands them over; A from
    the model's init (-(1..N)); D = 1; positions from
    ``packed_positions``."""
    import torch
    B, L, D = shape
    N, dtr = 16, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(shape, generator=g, device="cuda").to(dtype)
    delta = torch.rand(shape, generator=g, device="cuda").mul(0.1).add(
        1e-3).to(dtype)
    dbl = torch.randn((B, L, dtr + 2 * N), generator=g,
                      device="cuda").to(dtype)
    _, Bm, Cm = dbl.split([dtr, N, N], dim=-1)
    At = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda")[
        :, None].repeat(1, D)
    Dp = torch.ones(D, device="cuda")
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pos = torch.as_tensor(packed_positions(B, L, seed), device="cuda")
    return u, delta, At, Bm, Cm, Dp, pos, dy


def once_ms(fn):
    """One call between CUDA events (host overhead included): for the
    plain scans, whose Python step loops are too long to graph-capture."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def scan_bounds(shape, es, n_chunk):
    """Least times of the Mamba-1 scan's forward and backward (the same
    for both schedules): bytes of each input read once and each output
    written once — du, dΔ (B, L, D) f32, dB and dC as the function's
    (B, L, N) f32, dA (N, D) and dD (D,) f32; the kernels' per-block and
    per-row partials are their own overhead and not counted — and f32
    operations per state and step, forward 6, backward 17."""
    B, L, D = shape
    N = 16
    io = 2 * B * L * N * es + B * L * 4 + N * D * 4 + D * 4
    ck = B * n_chunk * N * D * 4
    fwd = bound_ms(3 * B * L * D * es + io + ck, 6 * B * L * D * N)
    bwd = bound_ms(3 * B * L * D * es + io + ck + 2 * B * L * D * 4
                   + 2 * B * L * N * 4 + N * D * 4 + D * 4,
                   17 * B * L * D * N)
    return fwd, bwd


def blocked_bwd_exps(L, chunk):
    """Exponentials per (b, d, n) of #6 on a row of L steps: the carry pass
    and the tile recompute take every step, the walk to the tile entries
    every step of a chunk but its last tile's."""
    from repro_torch.kernels import selective_scan as ksc
    tt = ksc.bwd_params()["tile"]
    walk = sum((-(-(min(L, c0 + chunk) - c0) // tt) - 1) * tt
               for c0 in range(0, L, chunk))
    return 2 * L + walk


def pair_partials(p, nblk):
    """Per-16-channel dB/dC partials (B, n16, L, N) summed in pairs into
    per-32-channel ones (B, nblk, L, N)."""
    import torch
    pad = 2 * nblk - p.shape[1]
    if pad:
        p = torch.cat([p, p.new_zeros((p.shape[0], pad) + p.shape[2:])], 1)
    return p.reshape(p.shape[0], nblk, 2, *p.shape[2:]).sum(2)


def scan_resources(kind, dtype, shape, sms, chunk=64):
    """The forward's (``kind`` "fwd": #3's and #4's kernel that ``chunk``
    takes) or #5's ("step_bwd") registers, spills, warps an SM and waves
    (its B·⌈D/channels a block⌉ blocks over the SMs' block slots) at
    ``shape``."""
    from repro_torch.kernels import selective_scan as ksc
    if kind == "fwd":
        r, width = (ksc.lanes_fwd_resources(dtype, chunk),
                    ksc.lanes_fwd_params()["block_d"])
    else:
        r, width = ksc.step_bwd_resources(dtype), ksc.STEP_BLOCK_D
    blocks = shape[0] * -(-shape[2] // width)
    return {**r, "blocks": blocks,
            "waves": blocks / (sms * max(1, r["blocks_per_sm"]))}


def phase_scan(sfu_rate, sms):
    """The Mamba-1 scan's two schedules at each shape of ``SCAN_CASES``,
    timed in one call: #4/#6 (``blocked``) and #3/#5 (``step``), each
    against the plain versions (one forward and one backward per case,
    the backward fed #4's checkpoints, as every kernel backward is); every
    kernel twice, bitwise equal; and the two schedules against each other
    — #3's checkpoints against #4's, #5 against #6. Then #4 at the chunks
    of ``SCAN_OTHER_CHUNKS`` (``phase_scan_chunks``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ksc
    chunk = ops.SCAN_CHUNK
    rows = []
    worst = {k: 0.0 for pair in SCAN_KERNELS.values() for k in pair}
    for shape, dtn in SCAN_CASES:
        dtype = getattr(torch, dtn)
        B, L, D = shape
        N, es = 16, torch.tensor([], dtype=dtype).element_size()
        args = scan_inputs(shape, dtype, seed=L)
        dy = args[7]
        fa = args[:7]
        (wy, wck), plain_fwd_ms = once_ms(
            lambda: ksc.selective_scan_fwd_plain(*fa, chunk))
        wy32 = wy.float()
        scale = wy32.abs().max().item()
        ck4 = ksc.selective_scan_fwd(*fa, chunk, "blocked")[1]
        want16, plain_bwd_ms = once_ms(
            lambda: ksc.selective_scan_bwd_plain(*fa, ck4, dy, chunk,
                                                 ksc.STEP_BLOCK_D))
        nblk32 = -(-D // ksc.BLOCK_D)
        want = {"step": want16,
                "blocked": (*want16[:2], pair_partials(want16[2], nblk32),
                            pair_partials(want16[3], nblk32), *want16[4:])}
        got, ckpts, times = {}, {}, {}
        for sched in ("blocked", "step"):
            kf, kb = SCAN_KERNELS[sched]
            fwd = functools.partial(ksc.selective_scan_fwd, *fa, chunk, sched)
            y, ck = fwd()
            y2, ck2 = fwd()
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
                raise AssertionError(f"{kf} is not bitwise repeatable at "
                                     f"{shape} {dtype}")
            del y2, ck2
            ckpts[sched] = ck
            y32 = y.float()
            err_y = (y32 - wy32).abs()
            if dtype == torch.float32:
                ok = bool((err_y <= 1e-4 * (1 + wy32.abs())).all())
                tol = "y 1e-4 · (1 + |ref|); ckpts 1e-4 · (1 + |ref|)"
            else:       # each side rounds its f32 result to bf16 once
                ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                           + 1e-4 * scale).all())
                tol = ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                       "roundings); ckpts 1e-4 · (1 + |ref|)")
            err_ck = (ck - wck).abs()
            ok = ok and bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
            if not ok:
                raise AssertionError(
                    f"{kf} kernel disagrees with its plain version at "
                    f"{shape} {dtype}: y {err_y.max().item()}, ckpts "
                    f"{err_ck.max().item()}")
            e_fwd = max(err_y.max().item(), err_ck.max().item())
            worst[kf] = max(worst[kf], e_fwd)
            del y, y32, err_y, err_ck
            (bnd_f, by_f), (bnd_b, by_b) = scan_bounds(shape, es,
                                                       ck.shape[1])
            kern_f = graph_ms(fwd, 10, 3)
            rows.append({
                "kernel": kf, "schedule": sched, "shape": list(shape),
                "dtype": dtn, "chunk": chunk, "max_abs_err": e_fwd,
                "tolerance": tol, "bitwise_repeat": True, "kernel_ms": kern_f,
                "kernel_eager_ms": eager_ms(fwd, 10, 2),
                "plain_ms": plain_fwd_ms, "library_ms": None,
                "bound_ms": bnd_f, "bound_by": by_f,
                "exp_floor_ms": exp_floor_ms(B * L * D * N, sfu_rate),
                "resources": scan_resources("fwd", dtype, shape, sms)})
            emit("kernels", **rows[-1])
            bwd = functools.partial(ksc.selective_scan_bwd, *fa, ck4, dy,
                                    chunk, sched)
            outs, again = bwd(), bwd()
            torch.cuda.synchronize()
            errs = {}
            for name, g, ref, rep in zip(
                    ("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                    want[sched], again):
                e = (g - ref).abs().max().item()
                errs[name] = e
                if e > BWD_TOL * max(1.0, ref.abs().max().item()):
                    raise AssertionError(
                        f"{kb} kernel disagrees with its plain version at "
                        f"{shape} {dtype}: {name} max err {e}")
                if not torch.equal(g, rep):
                    raise AssertionError(f"{kb} {name} is not bitwise "
                                         f"repeatable")
            worst[kb] = max(worst[kb], max(errs.values()))
            got[sched] = outs
            del again
            # #6 computes each decay up to three times (its carry pass, the
            # walk to its tile entries, the tile recompute), #5 once
            n_exp = (blocked_bwd_exps(L, chunk) if sched == "blocked"
                     else L) * B * D * N
            extra = ({"resources": scan_resources("step_bwd", dtype, shape,
                                                  sms)}
                     if sched == "step" else {})
            rows.append({
                "kernel": kb, "schedule": sched, "shape": list(shape),
                "dtype": dtn, "chunk": chunk,
                "max_abs_err": max(errs.values()), "errors": errs,
                "tolerance": f"{BWD_TOL} · max(1, max|ref|) per output",
                "bitwise_repeat": True,
                "kernel_ms": graph_ms(bwd, 10, 3),
                "kernel_eager_ms": eager_ms(bwd, 10, 2),
                "plain_ms": plain_bwd_ms, "library_ms": None,
                "bound_ms": bnd_b, "bound_by": by_b,
                "exp_floor_ms": exp_floor_ms(n_exp, sfu_rate), **extra})
            emit("kernels", **rows[-1])
            times[sched] = (kern_f, rows[-1]["kernel_ms"])
        # the two schedules on one card
        e_ck = (ckpts["step"] - ckpts["blocked"]).abs()
        ck_ok = bool((e_ck <= 1e-4 * (1 + ckpts["blocked"].abs())).all())
        errs = {}
        for i, name in enumerate(("du", "ddelta", "dB", "dC", "dA", "dD")):
            a, b = got["step"][i], got["blocked"][i]
            if name in ("dB", "dC"):
                a, b = a.sum(1), b.sum(1)
            errs[name] = (a - b).abs().max().item()
            if errs[name] > BWD_TOL * max(1.0, b.abs().max().item()):
                raise AssertionError(f"#5 and #6 disagree at {shape} "
                                     f"{dtype}: {name} {errs[name]}")
        if not ck_ok:
            raise AssertionError(f"#3's checkpoints differ from #4's at "
                                 f"{shape} {dtype}: {e_ck.max().item()}")
        emit("scan_schedules", shape=list(shape), dtype=dtn,
             ckpt_step_vs_blocked=e_ck.max().item(),
             ckpt_tolerance="1e-4 · (1 + |#4|)", bwd_step_vs_blocked=errs,
             bwd_tolerance=f"{BWD_TOL} · max(1, max|#6|) (dB, dC summed "
                           f"over blocks)",
             fwd_ms={s: t[0] for s, t in times.items()},
             bwd_ms={s: t[1] for s, t in times.items()})
        del args, fa, dy, wy, wck, wy32, ck4, want16, want, got, ckpts
        del outs, e_ck
        gc.collect()
        torch.cuda.empty_cache()
    rows += phase_scan_chunks(sfu_rate, sms, worst)
    return rows, worst


def phase_scan_chunks(sfu_rate, sms, worst):
    """#4 at each chunk of ``SCAN_OTHER_CHUNKS`` at ``SCAN_RAGGED`` bf16:
    against the plain version (the forward tolerances of ``phase_scan``),
    twice, bitwise equal, timed beside #4 at chunk 64 in the same call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ksc
    shape, dtype = SCAN_RAGGED, torch.bfloat16
    B, L, D = shape
    N, es = 16, 2
    fa = scan_inputs(shape, dtype, seed=L)[:7]
    at64 = graph_ms(functools.partial(ksc.selective_scan_fwd, *fa,
                                      ops.SCAN_CHUNK), 10, 3)
    rows = []
    for chunk in SCAN_OTHER_CHUNKS:
        (wy, wck), plain_ms = once_ms(
            lambda: ksc.selective_scan_fwd_plain(*fa, chunk))
        fwd = functools.partial(ksc.selective_scan_fwd, *fa, chunk)
        y, ck = fwd()
        y2, ck2 = fwd()
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
            raise AssertionError(f"#4 at chunk {chunk} is not bitwise "
                                 f"repeatable")
        wy32 = wy.float()
        err_y = (y.float() - wy32).abs()
        err_ck = (ck - wck).abs()
        ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                   + 1e-4 * wy32.abs().max().item()).all()) and \
            ck.shape == wck.shape and \
            bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
        if not ok:
            raise AssertionError(
                f"#4 at chunk {chunk} disagrees with its plain version at "
                f"{shape}: y {err_y.max().item()}, ckpts "
                f"{err_ck.max().item()}")
        e = max(err_y.max().item(), err_ck.max().item())
        worst["selective_scan_fwd"] = max(worst["selective_scan_fwd"], e)
        bnd, by = scan_bounds(shape, es, ck.shape[1])[0]
        rows.append({
            "kernel": "selective_scan_fwd", "schedule": "blocked",
            "shape": list(shape), "dtype": "bfloat16", "chunk": chunk,
            "max_abs_err": e,
            "tolerance": ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                          "roundings); ckpts 1e-4 · (1 + |ref|)"),
            "bitwise_repeat": True, "kernel_ms": graph_ms(fwd, 10, 3),
            "kernel_ms_chunk_64_same_call": at64,
            "kernel_eager_ms": eager_ms(fwd, 10, 2), "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "exp_floor_ms": exp_floor_ms(B * L * D * N, sfu_rate),
            "resources": scan_resources("fwd", dtype, shape, sms, chunk)})
        emit("kernels", **rows[-1])
        del wy, wck, y, ck, y2, ck2, wy32, err_y, err_ck
    del fa
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def heads_inputs(shape, dtype, seed):
    """u, dy (B, L, H, P) and Δ (B, L, H) in ``dtype`` (Δ in the range the
    init's softplus gives); B and C as strided views of one (B, L, 2N)
    projection, as bc_proj hands them over; A = -U[1, 16] per head, as the
    init draws it; D = 1; positions from ``packed_positions``."""
    import torch
    B, L, H, P = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(shape, generator=g, device="cuda").to(dtype)
    delta = torch.rand((B, L, H), generator=g, device="cuda").mul(0.1).add(
        1e-3).to(dtype)
    bc = torch.randn((B, L, 2 * HEADS_N), generator=g, device="cuda").to(
        dtype)
    Bm, Cm = bc.chunk(2, dim=-1)
    A = -(torch.rand(H, generator=g, device="cuda") * 15.0 + 1.0)
    Dp = torch.ones(H, device="cuda")
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pos = torch.as_tensor(packed_positions(B, L, seed), device="cuda")
    return u, delta, A, Bm, Cm, Dp, pos, dy


def heads_bounds(shape, es, chunk):
    """Least times of the heads scan's forward (#7 and #8 share it) and
    backward (#9): the larger of the bytes over the memory rate (each input
    read once, each output written once; dB and dC as the function's
    (B, L, N), dA and dD (H,); the kernel's per-head partials are its own
    overhead and not counted) and the products of the chunked (SSD) form
    over the dense TF32 peak: the form #9 runs on the tensor cores and #8
    writes out. Per (b, head) and sub-chunk of n ≤ Q = ``BWD_SUB_T`` steps
    inside each chunk: forward C·Bᵀ, (dec∘CBᵀ)·X, C·h_inᵀ and the exit
    state, 2n²(N + P) + 4nPN; backward S = C·Bᵀ, R = dY·Xᵀ, dX, dC and dB
    (two products each) and dh, 2n²(3N + 2P) + 8nPN, and the exit state of
    every sub-chunk but a chunk's last (pass 1), 2nPN. At mamba2-370m's
    training shape both are bound by bytes."""
    from repro_torch.kernels import selective_scan_heads as kh
    B, L, H, P = shape
    N = HEADS_N
    f_ops = b_ops = 0
    for c0 in range(0, L, chunk):
        t1 = min(L, c0 + chunk)
        ns = [min(kh.BWD_SUB_T, t1 - t) for t in range(c0, t1,
                                                        kh.BWD_SUB_T)]
        for n in ns:
            f_ops += 2 * n * n * (N + P) + 4 * n * P * N
            b_ops += 2 * n * n * (3 * N + 2 * P) + 8 * n * P * N
        b_ops += sum(2 * n * P * N for n in ns[:-1])
    n_chunk = -(-L // chunk)
    io = 2 * B * L * N * es + B * L * 4 + 2 * H * 4 + B * L * H * es
    ck = B * H * n_chunk * P * N * 4
    fwd = bound_ms(2 * B * L * H * P * es + io + ck, B * H * f_ops,
                   TF32_FLOPS)
    bwd = bound_ms(2 * B * L * H * P * es + io + ck + B * L * H * P * 4
                   + B * L * H * 4 + 2 * B * L * N * 4 + 2 * H * 4,
                   B * H * b_ops, TF32_FLOPS)
    return fwd, bwd


def phase_heads():
    """Kernels #7, #8 and #9 at mamba2-370m's training shape and at a
    ragged L, in bf16 and f32, against their plain versions; #7 and #9
    twice, bitwise equal; #7's resources (blocks an SM, registers, spills,
    shared bytes) per dtype."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan_heads as kh
    rows = []
    worst = {"selective_scan_heads_fwd": 0.0,
             "selective_scan_heads_fwd_dual": 0.0,
             "selective_scan_heads_bwd": 0.0}
    forms = (("selective_scan_heads_fwd", "blocked_heads",
              kh.selective_scan_heads_fwd_plain),
             ("selective_scan_heads_fwd_dual", "blocked_heads_dual",
              kh.selective_scan_heads_fwd_dual_plain))
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (HEADS_SHAPE, HEADS_RAGGED):
            B, L, H, P = shape
            es = torch.tensor([], dtype=dtype).element_size()
            *fa, dy = heads_inputs(shape, dtype, seed=L + 1)
            T = min(ops.HEADS_CHUNK, L)
            (bnd_f, by_f), (bnd_b, by_b) = heads_bounds(shape, es, T)
            dtn = str(dtype).split(".")[-1]
            for name, sched, plain in forms:
                fwd = functools.partial(kh.selective_scan_heads_fwd, *fa, T,
                                        sched)
                y, ck = fwd()
                if sched == "blocked_heads":
                    y2, ck2 = fwd()
                    if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
                        raise AssertionError(f"{name} is not bitwise "
                                             f"repeatable at {shape} {dtype}")
                    del y2, ck2
                torch.cuda.synchronize()
                (wy, wck), plain_ms = once_ms(lambda: plain(*fa, T))
                y32, wy32 = y.float(), wy.float()
                err_y = (y32 - wy32).abs()
                if dtype == torch.float32:
                    ok = bool((err_y <= 1e-4 * (1 + wy32.abs())).all())
                    tol = "y 1e-4 · (1 + |ref|); ckpts 1e-4 · (1 + |ref|)"
                else:       # each side rounds its f32 result to bf16 once
                    ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                               + 1e-4 * wy32.abs().max()).all())
                    tol = ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                           "roundings); ckpts 1e-4 · (1 + |ref|)")
                err_ck = (ck - wck).abs()
                ok = ok and bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
                e = max(err_y.max().item(), err_ck.max().item())
                if not ok:
                    raise AssertionError(
                        f"{name} kernel disagrees with its plain version at "
                        f"{shape} {dtype}: y {err_y.max().item()}, ckpts "
                        f"{err_ck.max().item()}")
                worst[name] = max(worst[name], e)
                del wy, wck, y32, wy32, err_y, err_ck
                rows.append({
                    "kernel": name, "shape": list(shape), "dtype": dtn,
                    "chunk": T, "max_abs_err": e, "tolerance": tol,
                    "kernel_ms": graph_ms(fwd, 10, 3),
                    "kernel_eager_ms": eager_ms(fwd, 10, 2),
                    "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bnd_f, "bound_by": by_f})
                if sched == "blocked_heads":
                    rows[-1].update(bitwise_repeat=True,
                                    resources=kh.fwd_resources(dtype))
                    ck_main = ck
                emit("kernels", **rows[-1])
                del y, ck
            bwd = functools.partial(kh.selective_scan_heads_bwd, *fa,
                                    ck_main, dy, T)
            outs, again = bwd(), bwd()
            torch.cuda.synchronize()
            want, plain_ms = once_ms(
                lambda: kh.selective_scan_heads_bwd_plain(*fa, ck_main, dy, T))
            errs = {}
            for name, got, ref, rep in zip(
                    ("du", "ddelta", "dB", "dC", "dA", "dD"), outs, want,
                    again):
                e = (got - ref).abs().max().item()
                errs[name] = e
                if e > BWD_TOL * max(1.0, ref.abs().max().item()):
                    raise AssertionError(
                        f"selective_scan_heads backward kernel disagrees "
                        f"with its plain version at {shape} {dtype}: {name} "
                        f"max err {e}")
                if not torch.equal(got, rep):
                    raise AssertionError(f"selective_scan_heads backward "
                                         f"{name} is not bitwise repeatable")
            worst["selective_scan_heads_bwd"] = max(
                worst["selective_scan_heads_bwd"], max(errs.values()))
            partial_bytes = sum(t.numel() * 4 for t in outs[1:])
            del outs, again, want
            torch.cuda.empty_cache()
            rows.append({
                "kernel": "selective_scan_heads_bwd", "shape": list(shape),
                "dtype": dtn, "chunk": T, "max_abs_err": max(errs.values()),
                "errors": errs,
                "tolerance": f"{BWD_TOL} · max(1, max|ref|) per output",
                "bitwise_repeat": True, "partials_bytes": partial_bytes,
                "kernel_ms": graph_ms(bwd, 4, 3),
                "kernel_eager_ms": eager_ms(bwd, 4, 2),
                "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bnd_b, "bound_by": by_b})
            emit("kernels", **rows[-1])
            del fa, dy, ck_main, bwd
            gc.collect()
            torch.cuda.empty_cache()
    return rows, worst


LAUNCH_COUNTERS = (("conv1d_pack_fwd", "conv1d_pack", "LAUNCHES"),
                   ("conv1d_pack_bwd_dx", "conv1d_pack", "LAUNCHES_DX"),
                   ("selective_scan_fwd", "selective_scan", "LAUNCHES_FWD"),
                   ("selective_scan_bwd", "selective_scan", "LAUNCHES_BWD"),
                   ("selective_scan_fwd_step", "selective_scan",
                    "LAUNCHES_FWD_STEP"),
                   ("selective_scan_bwd_step", "selective_scan",
                    "LAUNCHES_BWD_STEP"),
                   ("selective_scan_heads_fwd", "selective_scan_heads",
                    "LAUNCHES_FWD"),
                   ("selective_scan_heads_fwd_dual", "selective_scan_heads",
                    "LAUNCHES_DUAL"),
                   ("selective_scan_heads_bwd", "selective_scan_heads",
                    "LAUNCHES_BWD"))
# the kernels of each layer kind's training path: conv forward, conv dx,
# scan forward, scan backward
PATH_KERNELS = {"mamba": ("conv1d_pack_fwd", "conv1d_pack_bwd_dx",
                          "selective_scan_fwd", "selective_scan_bwd"),
                "mamba2": ("conv1d_pack_fwd", "conv1d_pack_bwd_dx",
                           "selective_scan_heads_fwd",
                           "selective_scan_heads_bwd")}


def path_kernels(cfg, schedule=None, rows=2):
    """The kernels ``cfg``'s training path runs: the Mamba-1 scan's by
    ``cfg.pallas_schedule``, the Mamba-2 scan's forward by ``schedule``;
    with ``cfg.scan_tune`` on, by the cached winner at (``rows``, 4096):
    a plain winner runs no scan kernel (None in their places)."""
    ks = list(PATH_KERNELS[cfg.unit[0]])
    if cfg.scan_tune != "off":
        from repro_torch.tune import config_shape_args, tuned
        args = config_shape_args(cfg, rows, 4096)
        kn = tuned(args.pop("op"), objective=cfg.tune_objective,
                   cache=None if cfg.scan_tune == "auto" else cfg.scan_tune,
                   **args)
        if kn.get("backend") != "pallas":
            return ks[:2] + [None, None]
        schedule = kn["schedule"]
        if cfg.unit[0] == "mamba":
            cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
    if cfg.unit[0] == "mamba":
        ks[2:] = SCAN_KERNELS[cfg.pallas_schedule]
    if schedule == "blocked_heads_dual":
        ks[2] = "selective_scan_heads_fwd_dual"
    return ks


def _counter_modules():
    from repro_torch.kernels import (conv1d_pack, selective_scan,
                                     selective_scan_heads)
    return {"conv1d_pack": conv1d_pack, "selective_scan": selective_scan,
            "selective_scan_heads": selective_scan_heads}


def read_launches():
    mods = _counter_modules()
    return {name: getattr(mods[m], attr)
            for name, m, attr in LAUNCH_COUNTERS}


def zero_launches():
    mods = _counter_modules()
    for _, m, attr in LAUNCH_COUNTERS:
        setattr(mods[m], attr, 0)


@contextlib.contextmanager
def plain_path():
    """The model's blocks call the plain ``core/`` conv and scans (plain
    PyTorch, differentiated by autograd) instead of the kernel wrappers:
    the reference of the training parity phases."""
    from repro_torch.core import conv as core_conv
    from repro_torch.core import ssm as core_ssm
    from repro_torch.models import blocks
    saved = blocks.kops
    blocks.kops = types.SimpleNamespace(
        conv1d_pack=core_conv.conv1d_pack,
        selective_scan=lambda u, dt, A, B, C, D, positions, **_: (
            core_ssm.selective_scan(u, dt, A, B, C, D, positions=positions,
                                    method="blocked", chunk=64)),
        selective_scan_heads=lambda u, dt, A, B, C, D, positions, **_: (
            core_ssm.selective_scan_heads(u, dt, A, B, C, D,
                                          positions=positions,
                                          method="blocked", chunk=64)))
    try:
        yield
    finally:
        blocks.kops = saved


@contextlib.contextmanager
def heads_schedule(schedule):
    """The model's Mamba-2 blocks run the heads scan with ``schedule``
    (``None`` or ``blocked_heads``: the default #7; ``blocked_heads_dual``:
    #8), as the JAX package's ``schedule=`` argument reaches it."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    if schedule in (None, "blocked_heads"):
        yield
        return
    saved = blocks.kops
    blocks.kops = types.SimpleNamespace(
        conv1d_pack=ops.conv1d_pack, selective_scan=ops.selective_scan,
        selective_scan_heads=functools.partial(ops.selective_scan_heads,
                                               schedule=schedule))
    try:
        yield
    finally:
        blocks.kops = saved


def train_loader(cfg, mode, seq_len=4096, rows=2, seed=0):
    from repro_torch.data.dataset import (PAPER_LEN_MAX, CorpusConfig,
                                          SyntheticCorpus)
    from repro_torch.data.packing_loader import LoaderConfig, PackingLoader
    corpus = SyntheticCorpus(CorpusConfig(
        vocab=cfg.vocab, seed=seed, len_max=min(PAPER_LEN_MAX, seq_len)))
    return PackingLoader(corpus, LoaderConfig(rows=rows, seq_len=seq_len,
                                              mode=mode))


def phase_train_parity(arch="mamba-1.4b", schedule=None, layers=2,
                       seq_len=2048):
    """Full-width ``arch``, ``layers`` deep, f32 (TF32 off): loss and every
    gradient through the kernels (the Mamba-1 scan's ``pallas_schedule``
    or the heads scan's schedule set to ``schedule``) against the plain
    path. Counters set to 0 before each path: the kernel path must launch
    exactly its kernels, the plain path none."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    if cfg.unit[0] == "mamba" and schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
        schedule = None
    model = LM(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(1))
    batch = train_loader(cfg, "pack", seq_len).batch(0)
    params = dict(model.named_parameters())

    def loss_and_grads():
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    zero_launches()
    with heads_schedule(schedule):
        k_loss, k_grads = loss_and_grads()
    torch.cuda.synchronize()
    ran = read_launches()
    expected = path_kernels(cfg, schedule)
    if any(ran[k] == 0 for k in expected) or \
            any(v for k, v in ran.items() if k not in expected):
        raise AssertionError(f"the kernel path ran {ran}, expected exactly "
                             f"{expected}")
    zero_launches()
    with plain_path():
        p_loss, p_grads = loss_and_grads()
    if any(read_launches().values()):
        raise AssertionError("the plain path launched a kernel")
    loss_err = abs(k_loss.item() - p_loss.item()) / abs(p_loss.item())
    worst, worst_leaf = 0.0, None
    for k, ref in p_grads.items():
        scale = ref.abs().max().item()
        e = (k_grads[k] - ref).abs().max().item() / max(scale, 1e-30)
        if e > worst:
            worst, worst_leaf = e, k
    del model, params, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()
    if loss_err > 1e-5 or worst > TRAIN_PARITY_TOL:
        raise AssertionError(f"kernel-path training differs from the plain "
                             f"path: loss {loss_err}, gradient {worst} at "
                             f"{worst_leaf}")
    return {"arch": cfg.name, "schedule": schedule,
            "pallas_schedule": cfg.pallas_schedule, "layers": layers,
            "rows": 2,
            "seq_len": seq_len, "dtype": "float32", "tf32": "off",
            "loss_kernel": k_loss.item(), "loss_plain": p_loss.item(),
            "loss_rel_err": loss_err, "loss_tolerance": 1e-5,
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_leaf,
            "grad_tolerance": f"{TRAIN_PARITY_TOL} · max|ref| per leaf",
            "launches_kernel_path": ran}


KERNEL_GROUPS = (("scan_step_bwd_kernel", "scan bwd step #5"),
                 ("scan_step_fwd_kernel", "scan fwd step #3"),
                 ("heads_bwd_kernel", "heads scan bwd #9"),
                 ("heads_fwd_chunked_kernel", "heads scan fwd #7"),
                 ("heads_dual_kernel", "heads scan fwd dual #8"),
                 ("scan_bwd_", "scan bwd #6"),     # carry, combine, chunk
                 ("scan_fwd_kernel", "scan fwd #4"),
                 ("conv1d_pack_bwd_dx", "conv dx #2"),
                 ("conv1d_pack_fwd", "conv fwd #1"),
                 ("gemm", "matmul"), ("nvjet", "matmul"),
                 ("xmma", "matmul"), ("cutlass", "matmul"),
                 ("reduce", "reductions"), ("index", "index/gather"),
                 ("scatter", "index/gather"), ("gather", "index/gather"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"),
                 ("copy", "copies"))


def kernel_group(name):
    low = name.lower()
    return next((g for key, g in KERNEL_GROUPS if key in low), "other")


# a launch of each counted kernel leaves this many device records in a trace,
# under this group (#6 runs its carry, combine and chunk kernels)
RECORDS_PER_LAUNCH = {"conv1d_pack_fwd": ("conv fwd #1", 1),
                      "conv1d_pack_bwd_dx": ("conv dx #2", 1),
                      "selective_scan_fwd": ("scan fwd #4", 1),
                      "selective_scan_bwd": ("scan bwd #6", 3),
                      "selective_scan_fwd_step": ("scan fwd step #3", 1),
                      "selective_scan_bwd_step": ("scan bwd step #5", 1),
                      "selective_scan_heads_fwd": ("heads scan fwd #7", 1),
                      "selective_scan_heads_fwd_dual":
                          ("heads scan fwd dual #8", 1),
                      "selective_scan_heads_bwd": ("heads scan bwd #9", 1)}
PROFILE_TRACES = 3   # traces taken at most until one holds every launch


def trace_step(step_fn, state, batch):
    """One train step under ``torch.profiler``: the step's wall time on the
    host's clock and its device events (kernels, copies, sets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return state, wall_ms, kernels


def profile_step(step_fn, state, batch, launches_per_step):
    """One train step under ``torch.profiler``: device time by kernel group
    and by kernel (the trace's CUDA events), and the device's busy share —
    the union of kernel intervals over the step's host-clock wall time,
    which the profiler's own host overhead lengthens.

    The launch counters run through the traced step and must equal
    ``launches_per_step`` (the timed steps' counts). The trace must then
    name each counted kernel as often as it launched. The profiler can
    lose a few device records of a step (on an H100 one mamba2-370m step's
    trace held 18609 to 18629 device events between runs of the same
    program, and once one #7 launch too few), so a trace that
    lacks a launch the counters saw is set aside, with what it lacked,
    and the step traced again, up to ``PROFILE_TRACES`` times; the caller
    then holds the trace that is reported to its exact counts."""
    set_aside = []
    for _ in range(PROFILE_TRACES):
        zero_launches()
        state, wall_ms, kernels = trace_step(step_fn, state, batch)
        launches = read_launches()
        if launches != launches_per_step:
            raise AssertionError(f"the profiled step launched {launches}, "
                                 f"the timed steps {launches_per_step} "
                                 f"a step")
        if not kernels:
            return state, {"measured": False,
                           "why": "the trace holds no device events"}
        named = {}
        for e in kernels:
            g = kernel_group(e.name)
            named[g] = named.get(g, 0) + 1
        lacks = {g: n * launches[k] - named.get(g, 0)
                 for k, (g, n) in RECORDS_PER_LAUNCH.items()
                 if launches[k] and named.get(g, 0) != n * launches[k]}
        if not lacks:
            break
        set_aside.append({"kernels": len(kernels), "lacks": lacks})
    by_name, by_group, calls = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        calls[g] = calls.get(g, 0) + 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return state, {
        "measured": True, "wall_ms": wall_ms,
        "kernel_ms_sum": sum(v[0] for v in by_name.values()) / 1e3,
        "busy_ms": busy / 1e3, "busy_share_of_wall": busy / 1e3 / wall_ms,
        "busy_share_of_kernel_window": busy / max(window, 1e-9),
        "kernels": len(kernels),
        "traces_set_aside": set_aside,
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "by_group_calls": calls,
        "top_kernels": [[name[:90], us / 1e3, n] for name, (us, n) in top]}


@contextlib.contextmanager
def resolver_clock(on):
    """While ``on``: the host seconds and calls of the scan wrappers' tune
    resolution (``kernels/ops.py`` ``_resolve_tune``) and the cache
    lookups its per-key memo did not answer (``TuneCache._find``)."""
    got = {"calls": 0, "s": 0.0, "uncached": 0}
    if not on:
        yield got
        return
    from repro_torch.kernels import ops as kops
    from repro_torch.tune.cache import TuneCache
    resolve, find = kops._resolve_tune, TuneCache._find

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return resolve(*a, **k)
        finally:
            got["s"] += time.perf_counter() - t
            got["calls"] += 1

    def counted(self, *a, **k):
        got["uncached"] += 1
        return find(self, *a, **k)

    kops._resolve_tune, TuneCache._find = timed, counted
    try:
        yield got
    finally:
        kops._resolve_tune, TuneCache._find = resolve, find


def phase_train(arch="mamba-1.4b", rows=2, steps=TIMED_STEPS, schedule=None,
                pad=True, tune=None):
    """The training main path at ``arch``'s full width and depth, ``rows``
    × 4096 packed, the Mamba-1 scan on ``schedule`` (the config's
    ``pallas_schedule`` when None), or on the winner of the tuning cache
    ``tune`` (forward + backward sweeps, as the training launcher sets);
    with ``pad``, 2 steps in ``pad`` mode after the pack steps."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
    if tune is not None:
        cfg = dataclasses.replace(cfg, scan_tune=tune,
                                  tune_objective="fwdbwd")
    model = LM(cfg)
    opt = AdamW(cosine_schedule(3e-4, warmup=1, total=steps + 3))
    trainer = Trainer(model, opt, train_loader(cfg, "pack", rows=rows),
                      TrainerConfig(steps=1))
    state, warm = trainer.train(
        torch.Generator(device="cuda").manual_seed(0), verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    trainer.cfg.steps = 1 + steps
    with resolver_clock(tune is not None) as resolver:
        t0 = time.perf_counter()
        state, hist = trainer.train(state=state, start_step=1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.n_layers
    conv, dx, fwd, bwd = path_kernels(cfg, rows=rows)
    want = {k: 0 for k in launches}
    want.update({conv: 2 * L * steps,               # forward + recompute
                 dx: L * steps, fwd: 2 * L * steps, bwd: L * steps})
    want.pop(None, None)                            # a plain tuned winner
    if launches != want:
        raise AssertionError(f"training launched {launches}, remat='unit' "
                             f"over {L} layers × {steps} steps implies "
                             f"{want}")
    losses = [warm[0]["loss"]] + [h["loss"] for h in hist]
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    step_ms = sum(h["step_ms"] for h in hist)
    real = sum(h["real_tokens"] for h in hist)
    buf = sum(h["buffer_tokens"] for h in hist)
    state, profiled = profile_step(
        trainer.step_fn, state, trainer.loader.batch(1 + steps),
        {k: v // steps for k, v in launches.items()})
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "remat": cfg.remat, "pallas_schedule": cfg.pallas_schedule,
           "scan_tune": "off" if tune is None else "cache",
           "scan_kernels": [fwd, bwd],
           "rows": rows, "seq_len": 4096, "mode": "pack",
           "warmup_steps": 1, "timed_steps": steps, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "ms_per_step": step_ms / steps,
           "step_ms": [h["step_ms"] for h in hist],
           "data_ms_per_step": sum(h["data_ms"] for h in hist) / steps,
           "real_tok_per_s": real / step_ms * 1e3,
           "buffer_tok_per_s": buf / step_ms * 1e3,
           "real_fraction": real / buf, "timed_wall_s": wall,
           "max_memory_allocated_gib": peak, "launches": launches,
           "launches_per_step": {k: v // steps for k, v in
                                 launches.items()},
           "profile": profiled}
    if tune is not None:
        out["tune_resolver"] = {
            "resolves_per_step": resolver["calls"] / steps,
            "host_us_per_step": resolver["s"] * 1e6 / steps,
            "host_us_per_resolve": resolver["s"] * 1e6 /
            max(1, resolver["calls"]),
            "uncached_lookups": resolver["uncached"]}
    if pad:
        # the paper's comparison (a smoke reading): one sequence per row
        padt = Trainer(model, opt, train_loader(cfg, "pad", rows=rows),
                       TrainerConfig(steps=2))
        state, phist = padt.train(state=state, verbose=False)
        pad_ms = sum(h["step_ms"] for h in phist)
        out.update({
            "pad_losses": [h["loss"] for h in phist],
            "pad_ms_per_step": pad_ms / len(phist),
            "pad_real_tok_per_s": sum(h["real_tokens"] for h in phist)
            / pad_ms * 1e3,
            "pad_real_fraction": sum(h["real_tokens"] for h in phist)
            / sum(h["buffer_tokens"] for h in phist)})
        del padt
    del state, trainer, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def phase_parity(model_bf16, cfg):
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.models.lm import LM
    f32 = LM(dataclasses.replace(cfg, dtype="float32"))
    f32.load_state_dict(model_bf16.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (37, 90, 18, 61)]
    pb = packing.pack(prompts, 128, policy="first_fit", num_rows=2)
    ends = packing.segment_ends(pb, 4)
    logits, states, seg_lens = f32.prefill_packed(
        {"tokens": pb.tokens, "positions": pb.positions,
         "segment_ids": pb.segment_ids}, ends)
    worst = {"logits": 0.0, "conv": 0.0, "ssm": 0.0}
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            n = len(prompts[i])
            assert int(seg_lens[r, s]) == n
            lg, cache, _ = f32.prefill(
                {"tokens": prompts[i][None],
                 "positions": np.arange(n, dtype=np.int32)[None],
                 "segment_ids": np.ones((1, n), np.int32)})
            pairs = [("logits", logits[r, s], lg[0]),
                     ("conv", states["conv"][:, r, s], cache["conv"][:, 0]),
                     ("ssm", states["ssm"][:, r, s], cache["ssm"][:, 0])]
            for k, got, ref in pairs:
                e = ((got - ref).abs().max() /
                     ref.abs().max().clamp(min=1.0)).item()
                worst[k] = max(worst[k], e)
    assert torch.isfinite(logits).all()
    del f32
    torch.cuda.empty_cache()
    if max(worst.values()) > PARITY_TOL:
        raise AssertionError(f"packed prefill differs from per-prompt "
                             f"prefill: {worst} > {PARITY_TOL}")
    return worst


def phase_engine(model, cfg, n_requests=12, new_tokens=16, seed=0):
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    finite = []
    prefill_packed, decode_step = model.prefill_packed, model.decode_step

    def checked_prefill(*a, **k):
        logits, states, lens = prefill_packed(*a, **k)
        finite.append(torch.isfinite(logits).all())
        return logits, states, lens

    def checked_decode(*a, **k):
        logits, cache = decode_step(*a, **k)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    model.prefill_packed, model.decode_step = checked_prefill, checked_decode
    kw = dict(num_slots=8, max_len=512, buckets=(64, 128, 256),
              prefill_rows=2, max_segments=4)
    rng = np.random.default_rng(seed)
    warm = ServeEngine(model, **kw)               # cuBLAS and allocator warm-up
    for n in (20, 150):
        warm.submit(rng.integers(1, cfg.vocab, size=n), 2)
    warm.run()
    del warm
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 201, size=n_requests)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in lens]
    engine = ServeEngine(model, **kw)
    for p in prompts:
        engine.submit(p, new_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    zero_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts.pop("conv1d_pack_fwd")
    if any(counts.values()):
        raise AssertionError(f"serving launched training kernels: {counts}")
    st = engine.stats
    assert all(engine.status[r] == "done" for r in outs), engine.status
    assert [len(outs[r]) for r in sorted(outs)] == [new_tokens] * n_requests
    assert bool(torch.stack(finite).all()), "non-finite logits"
    if launches == 0 or launches != cfg.n_layers * st.prefills:
        raise AssertionError(f"conv1d_pack launched {launches} times for "
                             f"{st.prefills} prefills × {cfg.n_layers} "
                             f"layers")
    return {"requests": n_requests, "prompt_lens": [int(n) for n in lens],
            "generated": st.generated, "wall_s": wall,
            "tok_per_s": st.generated / wall,
            "ttft_p50_ms": st.ttft_percentiles()["p50"],
            "prefills": st.prefills, "midflight_refills":
            st.midflight_refills, "decode_steps": st.decode_steps,
            "prefill_ms_per_prefill": st.prefill_ms / st.prefills,
            "decode_ms_per_step": st.decode_ms / st.decode_steps,
            "host_ms": st.host_ms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "conv1d_pack_launches": launches}


def phase_tune_sweep(cache, spec):
    """One sweep of the tuner (``runner.sweep``, the launchers' timing) at
    the key ``spec`` on the card, its winner put in ``cache``: every
    candidate's best µs, and the probe µs of those pruned; every kernel
    candidate must have been measured."""
    from repro_torch.tune import runner, space
    t0 = time.perf_counter()
    import torch
    spec = dict(spec)
    k = space.shape_key(spec.pop("op"), **spec)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    ranked, pruned = runner.sweep(k, rounds=TUNE_ROUNDS, verbose=True)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    ran = [n for n, _, _ in ranked]
    kernel = [space.candidate_name(c) for c in space.kernel_candidates(k)]
    if not kernel or any(n not in ran for n in kernel):
        raise AssertionError(f"the sweep at {k.encode()} measured {ran}; "
                             f"its kernel candidates are {kernel}")
    name, knobs, us = ranked[0]
    cache.put(k, knobs, us, candidates=len(ranked), kernels=True)
    seen = set(ran) | {n for n, _, _ in pruned}
    return {"key": k.encode(), "rounds": TUNE_ROUNDS,
            "candidates_us": {n: t for n, _, t in ranked},
            "pruned_probe_us": {n: t for n, _, t in pruned},
            "prune_factor": runner.PRUNE_FACTOR,
            "dropped": [space.candidate_name(c)
                        for c in space.space_for(k, include_pallas=True)
                        if space.candidate_name(c) not in seen],
            "kernel_candidates": kernel, "winner": name,
            "winner_knobs": knobs, "winner_us": us,
            "alloc_retries": retries, "seconds": time.perf_counter() - t0}


def phase_tune(tr, eng):
    """Sweep both models' layer shapes into a cache file in a temporary
    directory, train mamba-1.4b with ``scan_tune=<that file>``, and serve
    it with tuning on (the engine sweeps its prefill buckets); ``tr`` and
    ``eng`` are the untuned ``train`` and ``engine`` results of this run."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.tune import cache as tcache
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "TUNE_CACHE_torch.json")
        cache = tcache.get_cache(path)
        sweeps = []
        for spec in TUNE_SWEEPS:
            sweeps.append(phase_tune_sweep(cache, spec))
            emit("tune_sweep", **sweeps[-1])
        cache.save()
        win = sweeps[0]["winner_knobs"]
        want = list(SCAN_KERNELS[win["schedule"]]) \
            if win["backend"] == "pallas" else [None, None]
        tt = phase_train(tune=path, pad=False)
        prof = tt.pop("profile")
        if tt["scan_kernels"] != want:
            raise AssertionError(f"the tuned step ran {tt['scan_kernels']}, "
                                 f"the winner's kernels are {want}")
        emit("train_tuned", **tt,
             untuned={"ms_per_step": tr["ms_per_step"],
                      "real_tok_per_s": tr["real_tok_per_s"],
                      "pallas_schedule": tr["pallas_schedule"]})
        emit("train_tuned_profile", **prof)
        cfg = dataclasses.replace(get_config("mamba-1.4b"), scan_tune=path)
        model = LM(cfg)
        model.init(torch.Generator(device=model.device).manual_seed(0))
        t1 = time.perf_counter()
        et = phase_engine(model, cfg)
        serve_keys = sorted(k for k in cache.entries
                            if k.startswith("selective_scan|") and
                            not k.endswith("fwdbwd") and "|L4096|" not in k)
        emit("engine_tuned", arch=cfg.name, dtype=cfg.dtype,
             layers=cfg.n_layers, **et,
             seconds_with_sweeps=time.perf_counter() - t1,
             bucket_winners={k: cache.entries[k] for k in serve_keys},
             untuned={"ttft_p50_ms": eng["ttft_p50_ms"],
                      "tok_per_s": eng["tok_per_s"],
                      "prefill_ms_per_prefill":
                          eng["prefill_ms_per_prefill"]})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return tt, time.perf_counter() - t0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import selective_scan as ksc
    from repro_torch.models.lm import LM

    t_start = time.perf_counter()
    # every f32 number here is full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t,
         per_source=_build.build_seconds, libraries=sorted(libs))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    sfu_rate = sms * SFU_PER_SM_CLOCK * clock_mhz * 1e6      # exp / s
    emit("sfu", sms=sms, max_sm_clock_mhz=clock_mhz, exp_per_s=sfu_rate)

    conv_rows, conv_worst = phase_conv_fwd()
    dx_rows, dx_worst = phase_conv_dx()
    scan_rows, scan_worst = phase_scan(sfu_rate, sms)
    heads_rows, heads_worst = phase_heads()

    # serving first, from the same state as before training existed
    cfg = get_config("mamba-1.4b")
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    parity = phase_parity(model, cfg)
    emit("parity", arch=cfg.name, dtype="float32", tf32="off",
         tolerance=PARITY_TOL, max_rel_err=parity)

    eng = phase_engine(model, cfg)
    emit("engine", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, **eng)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    tp = phase_train_parity()
    emit("train_parity", **tp)
    tr = phase_train()
    prof = tr.pop("profile")
    named6 = prof.get("by_group_calls", {}).get("scan bwd #6", 0)
    if named6 != 3 * cfg.n_layers:
        raise AssertionError(f"the profiled mamba-1.4b step names #6's carry, "
                             f"combine and chunk kernels {named6} times, "
                             f"expected 3 × {cfg.n_layers}")
    emit("train", **tr)
    emit("train_profile", **prof)

    # Mamba-2: serving, training parity for both forward schedules, and
    # the training main path
    cfg2 = get_config("mamba2-370m")
    model = LM(cfg2)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    parity2 = phase_parity(model, cfg2)
    emit("parity_mamba2", arch=cfg2.name, dtype="float32", tf32="off",
         tolerance=PARITY_TOL, max_rel_err=parity2)
    eng2 = phase_engine(model, cfg2)
    emit("engine_mamba2", arch=cfg2.name, dtype=cfg2.dtype,
         layers=cfg2.n_layers, d_model=cfg2.d_model, **eng2)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tp2 = {s: phase_train_parity("mamba2-370m", s)
           for s in ("blocked_heads", "blocked_heads_dual")}
    for v in tp2.values():
        emit("train_parity_mamba2", **v)
    tr2 = phase_train("mamba2-370m", rows=8)
    prof2 = tr2.pop("profile")
    named = {g: prof2.get("by_group_calls", {}).get(g, 0)
             for g in ("heads scan fwd #7", "heads scan bwd #9")}
    if named != {"heads scan fwd #7": 2 * cfg2.n_layers,
                 "heads scan bwd #9": cfg2.n_layers}:
        raise AssertionError(f"the profiled mamba2-370m step names the heads "
                             f"kernels {named} times, expected "
                             f"{2 * cfg2.n_layers} and {cfg2.n_layers}")
    emit("train_mamba2", **tr2)
    emit("train_mamba2_profile", **prof2)

    # mamba-2.8b through the step schedule (#3 then #5): full-width parity,
    # then the training main path at full width and depth
    tp3 = phase_train_parity("mamba-2.8b", "step")
    emit("train_parity_step", **tp3)
    tr3 = phase_train("mamba-2.8b", schedule="step", pad=False)
    prof3 = tr3.pop("profile")
    named3 = {g: prof3.get("by_group_calls", {}).get(g, 0)
              for g in ("scan fwd step #3", "scan bwd step #5")}
    layers3 = tr3["layers"]
    if named3 != {"scan fwd step #3": 2 * layers3,
                  "scan bwd step #5": layers3}:
        raise AssertionError(f"the profiled mamba-2.8b step names the step "
                             f"kernels {named3} times, expected "
                             f"{2 * layers3} and {layers3}")
    emit("train_step", **tr3)
    emit("train_step_profile", **prof3)

    # the tuner: both layer shapes swept, mamba-1.4b trained and served
    # with the cache, beside the untuned numbers above
    tt, tune_s = phase_tune(tr, eng)
    emit("tune", seconds=tune_s)

    def main_row(rows, shape):
        return next(r for r in rows if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16")

    def entry(name, src, replaces, row, launches, worst, **extra):
        extra.setdefault("launches_train_tuned", launches_t[name])
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": row["kernel_ms"],
                "kernel_ms": row["kernel_ms"],
                "kernel_eager_ms": row["kernel_eager_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "at": {"shape": row["shape"], "dtype": row["dtype"]},
                **extra}

    def conv_resources(kind, rows):
        """#1's or #2's registers, spills and blocks an SM (both dtypes,
        both widths), and the run and blocks each timed shape took."""
        from repro_torch.kernels import conv1d_pack as kconv
        return {"kernels": {
            f"{dt}{'_one_wide' if ow else ''}": kconv.conv_resources(
                kind, getattr(torch, dt), ow)
            for dt in ("bfloat16", "float32") for ow in (False, True)},
            "shapes": {f"{r['dtype']} {tuple(r['shape'])}": r["launch"]
                       for r in rows}}

    def conv_train_ms(rows):
        return {arch: main_row(rows, shape)["kernel_ms"]
                for arch, shape in CONV_TRAIN_SHAPES.items()}

    def heads_row(name):
        return main_row([r for r in heads_rows if r["kernel"] == name],
                        HEADS_SHAPE)

    def scan_row(name, shape):
        return main_row([r for r in scan_rows if r["kernel"] == name
                         and r["chunk"] == ops.SCAN_CHUNK], shape)

    launches, launches2 = tr["launches"], tr2["launches"]
    launches3, launches_t = tr3["launches"], tt["launches"]
    dual_path = tp2["blocked_heads_dual"]["launches_kernel_path"]
    fwd_row = scan_row("selective_scan_fwd", TRAIN_SHAPE)
    bwd_row = scan_row("selective_scan_bwd", TRAIN_SHAPE)
    step_fwd_row = scan_row("selective_scan_fwd_step", TRAIN_SHAPE_28)
    step_bwd_row = scan_row("selective_scan_bwd_step", TRAIN_SHAPE_28)
    print(json.dumps({"kernels": [
        entry("conv1d_pack_fwd", "conv1d_pack.cu",
              "src/repro/kernels/conv1d_pack.py:36",
              main_row(conv_rows, MAIN_SHAPE), eng["conv1d_pack_launches"],
              conv_worst, launches_per_prefill=cfg.n_layers,
              launches_train=launches["conv1d_pack_fwd"],
              launches_train_step=launches3["conv1d_pack_fwd"],
              launches_train_mamba2=launches2["conv1d_pack_fwd"],
              resources=conv_resources("fwd", conv_rows),
              train_ms=conv_train_ms(conv_rows)),
        entry("conv1d_pack_bwd_dx", "conv1d_pack.cu",
              "src/repro/kernels/conv1d_pack.py:83",
              main_row(dx_rows, TRAIN_SHAPE),
              launches["conv1d_pack_bwd_dx"], dx_worst,
              launches_train_step=launches3["conv1d_pack_bwd_dx"],
              launches_train_mamba2=launches2["conv1d_pack_bwd_dx"],
              resources=conv_resources("bwd_dx", dx_rows),
              train_ms=conv_train_ms(dx_rows)),
        entry("selective_scan_fwd_step", "selective_scan.cu",
              "src/repro/kernels/selective_scan.py:116", step_fwd_row,
              launches3["selective_scan_fwd_step"],
              scan_worst["selective_scan_fwd_step"], path="train_step",
              exp_floor_ms=step_fwd_row["exp_floor_ms"],
              build=ksc.lanes_fwd_params(),
              resources={dt: scan_resources("fwd", getattr(torch, dt),
                                            TRAIN_SHAPE_28, sms)
                         for dt in ("bfloat16", "float32")},
              blocked_same_call_ms=scan_row("selective_scan_fwd",
                                            TRAIN_SHAPE_28)["kernel_ms"]),
        entry("selective_scan_fwd", "selective_scan.cu",
              "src/repro/kernels/selective_scan.py:153", fwd_row,
              launches["selective_scan_fwd"],
              scan_worst["selective_scan_fwd"],
              exp_floor_ms=fwd_row["exp_floor_ms"],
              step_same_call_ms=scan_row("selective_scan_fwd_step",
                                         TRAIN_SHAPE)["kernel_ms"],
              ms_28=scan_row("selective_scan_fwd", TRAIN_SHAPE_28)[
                  "kernel_ms"],
              build=ksc.lanes_fwd_params(),
              resources={dt: scan_resources("fwd", getattr(torch, dt),
                                            TRAIN_SHAPE, sms)
                         for dt in ("bfloat16", "float32")},
              other_chunks_ms={
                  r["chunk"]: r["kernel_ms"] for r in scan_rows
                  if r["kernel"] == "selective_scan_fwd"
                  and r["chunk"] != ops.SCAN_CHUNK}),
        entry("selective_scan_bwd_step", "selective_scan_step_bwd.cu",
              "src/repro/kernels/selective_scan.py:441", step_bwd_row,
              launches3["selective_scan_bwd_step"],
              scan_worst["selective_scan_bwd_step"], path="train_step",
              exp_floor_ms=step_bwd_row["exp_floor_ms"],
              build=ksc.step_bwd_params(),
              resources={dt: scan_resources("step_bwd", getattr(torch, dt),
                                            TRAIN_SHAPE_28, sms)
                         for dt in ("bfloat16", "float32")},
              blocked_same_call_ms=scan_row("selective_scan_bwd",
                                            TRAIN_SHAPE_28)["kernel_ms"]),
        entry("selective_scan_bwd", "selective_scan_bwd.cu",
              "src/repro/kernels/selective_scan.py:525", bwd_row,
              launches["selective_scan_bwd"],
              scan_worst["selective_scan_bwd"],
              exp_floor_ms=bwd_row["exp_floor_ms"],
              step_same_call_ms=scan_row("selective_scan_bwd_step",
                                         TRAIN_SHAPE)["kernel_ms"],
              ms_28=scan_row("selective_scan_bwd", TRAIN_SHAPE_28)[
                  "kernel_ms"],
              step_same_call_ms_28=step_bwd_row["kernel_ms"],
              build=ksc.bwd_params(),
              resources={dt: ksc.bwd_resources(getattr(torch, dt),
                                               ops.SCAN_CHUNK)
                         for dt in ("bfloat16", "float32")}),
        entry("selective_scan_heads_fwd", "selective_scan_heads_fwd.cu",
              "src/repro/kernels/selective_scan.py:212",
              heads_row("selective_scan_heads_fwd"),
              launches2["selective_scan_heads_fwd"],
              heads_worst["selective_scan_heads_fwd"], path="train_mamba2",
              resources=heads_row("selective_scan_heads_fwd")["resources"]),
        entry("selective_scan_heads_fwd_dual", "selective_scan_heads.cu",
              "src/repro/kernels/selective_scan.py:272",
              heads_row("selective_scan_heads_fwd_dual"),
              dual_path["selective_scan_heads_fwd_dual"],
              heads_worst["selective_scan_heads_fwd_dual"],
              path="train_parity_mamba2 (schedule=blocked_heads_dual)",
              launches_train_mamba2=launches2[
                  "selective_scan_heads_fwd_dual"]),
        entry("selective_scan_heads_bwd", "selective_scan_heads_bwd.cu",
              "src/repro/kernels/selective_scan.py:634",
              heads_row("selective_scan_heads_bwd"),
              launches2["selective_scan_heads_bwd"],
              heads_worst["selective_scan_heads_bwd"], path="train_mamba2",
              partials_bytes=heads_row(
                  "selective_scan_heads_bwd")["partials_bytes"])]}),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
