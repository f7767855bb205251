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
11. checkpoint — kill and resume on the card: mamba-1.4b at full width
              (d_model 2048, d_inner 4096, N 16, vocab 50280) with 4 layers,
              bf16 compute, f32 params, random weights from seed 0,
              ``PackingLoader`` pack 2 × 4096 at seed 0, ``Obs.on()``. Run A
              takes 6 steps straight. Run B saves every 2 steps (keep 2)
              and its loader sends this process SIGTERM as step 3's batch
              is fetched: the trainer's handler sets its flag and the
              trainer makes its blocking emergency save at step 4 and
              stops (the process's SIGTERM/SIGINT handlers are put back
              after). Step 4 was just saved periodically, so the
              emergency save waits for that write and marks its manifest:
              two snapshots, one mark, and no longer than that write
              plus 0.5 s. Run C, a fresh trainer on the same directory,
              restores step 4 (parameters, m, v and step bitwise those at
              the emergency save) and takes steps 4 and 5, whose losses
              must equal run A's bitwise. The trace of the three runs
              passes ``obs.check`` with ``train.step``/``train.data`` and
              the ``ckpt.*`` spans required and ``train.steps`` = 12. Printed beside the card's
              name and power limit: the checkpoint's bytes, the snapshot
              ms (the loop's device → host stall), the async write, the
              emergency save and the restore seconds, each run's ms/step.
              Then ``python -m repro_torch.launch.train --tiny --steps 3
              --ckpt-dir D --ckpt-every 1 --obs-trace T --profile-dir P``
              as a subprocess on the card: it must exit 0, D must hold
              steps 1–3, T pass ``obs.check`` and P hold a trace naming a
              ``conv1d_pack`` kernel.

12. serve   — the serving engine's scheduler v2 on the card: #1 at the
              chunk lane's slab (1, 3 + 256, 4096) bf16 (the carried conv
              tail at three leading zero positions) against its plain
              version, twice bitwise, timed; an f32 copy of mamba-1.4b
              (48 layers) prefills one 700-token prompt whole and in
              256-token slabs (``prefill_chunk``: end logits and states
              within ``PARITY_TOL``), and of mamba2-370m the same; then
              the engine on mamba-1.4b (48 layers, bf16, seed 0), 24
              slots: 12 greedy and 4 sampled (T 0.8, top-k 40, top-p 0.95)
              prompts of 16–200 tokens and one of 1500 (6 chunk rounds),
              16 new tokens each, the TTFT bucket policy; overlap on (two
              prefills in flight on a side stream) and off, every launch
              counter set to 0 just before each and read just after (#1
              exactly n_layers × (prefills + chunk rounds), nothing else),
              the two runs' streams bitwise equal, every sampled stream
              equal to its replay through the model's calls; the padded
              wave (``decode_batch``) against the continuous engine on 8
              prompts; one profiled decode step (greedy, sampled), one
              profiled prefill round, an overlapped run's first steps
              profiled (each stream's kernels, the time two streams ran
              at once). Then ``python -m repro_torch.launch.serve --tiny
              --temperature 0.8 --top-k 40 --buckets 16,32 --obs-trace T
              --profile-dir P`` as a subprocess: exit 0 with chunk rounds,
              T passes ``obs.check`` with the serve spans, P names a
              ``conv1d_pack`` kernel; with ``--guard --deadline-ms 60000
              --max-queue 64`` its lifecycle counters must read 0.
13. lifecycle — phase 12's engine and mix (mamba-1.4b, 48 layers, bf16, 24
              slots, overlap on, two prefills in flight): the guard off,
              on, on, off with an empty ``FaultPlan`` (streams bitwise
              equal, decode ms/step of each) and one greedy decode step
              profiled with the guard off, on, on, off (device busy ms,
              kernels); a plan that poisons one
              decode slot, one prefill segment and one chunk row and fails
              one prefill (those requests fail, every other stream is the
              clean run's bitwise, #1 launched exactly n_layers × the
              forwards that ran); a kill before decode step 6 with a
              blocking snapshot every 4 steps, then a fresh engine restoring
              the last one (the long prompt mid-chunk) finishes every
              stream, sampled too, bitwise as the clean run (the snapshot's
              bytes and ms and the restore's ms beside the card's name and
              power limit); a cancel of a request whose prefill is in flight
              on the side stream (its slot comes back free).

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
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
# the checkpoint phase: 4 layers keep a checkpoint (weights, m and v in
# f32) at ≈ 3.7 GB, where 48 would write ≈ 17.7 GB twice
CKPT_LAYERS = 4
CKPT_STEPS = 6
CKPT_KILL_AT = 3             # SIGTERM as this step's batch is fetched
# phase 12 (serve): the scheduler-v2 engine on mamba-1.4b
SERVE_SLOTS = 24                 # more slots than requests: both runs pack
#                                  the same rounds (phase_serve's docstring)
SERVE_NEW = 16                   # new tokens a request
SERVE_LONG = 1500                # the over-bucket prompt: 6 chunk rounds
SERVE_CHUNK = 256                # chunk slab = the largest bucket
SERVE_TTFT_MS = 20000.0          # the TTFT target: above every wait of
#                                  this mix, so no time rule fires
SERVE_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
# phase 13 (lifecycle): phase 12's engine under a fault plan, killed and
# restored, and a cancel in flight
LIFE_PLAN = dict(poison_decode={3: [0]}, poison_prefill={1: [(0, 0)]},
                 poison_chunk={2: [0]}, fail_prefill=2)
LIFE_KILL_AT = 6                 # decode step; snapshots every 4 steps, so
#                                  the last one holds the long prompt mid-chunk
LIFE_SNAP_EVERY = 4
CHUNK_PARITY_LEN = 700           # one prompt, whole against 3 slabs
CHUNK_SLAB_SHAPE = (1, 3 + SERVE_CHUNK, 4096)   # #1 over a slab: W-1 + T


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


def merge_spans(spans):
    """The union of (start, end) intervals as sorted disjoint ones."""
    spans = sorted(spans)
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a > merged[-1][1]:
            merged.append([a, b])
        else:
            merged[-1][1] = max(merged[-1][1], b)
    return merged


def overlap_us(x, y):
    """Time two unions of intervals both cover."""
    i = j = 0
    tot = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        tot += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def trace_call(fn):
    """``fn()`` under ``torch.profiler``: its result, its wall time on the
    host's clock (ending in a device sync) and its device events (kernels,
    copies, sets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, wall_ms, kernels


def profile_call(fn, launches_per_call, setup=None):
    """``fn()`` under ``torch.profiler``: device time by kernel group and by
    kernel (the trace's CUDA events), and the device's busy share — the
    union of kernel intervals over the call's host-clock wall time, which
    the profiler's own host overhead lengthens. Where the events lie on
    more than one CUDA stream, each stream's kernels and busy time, and
    the time kernels of the two busiest streams ran at once.

    ``setup()``, where given, runs before each trace, outside it. The
    launch counters run through the traced call and must equal
    ``launches_per_call`` (a dict, or a function of ``fn``'s result that
    gives it). The trace must then name each counted kernel as often as it
    launched. The profiler can lose a few device records of a call (on an
    H100 one mamba2-370m step's trace held 18609 to 18629 device events
    between runs of the same program, and once one #7 launch too few), so
    a trace that lacks a launch the counters saw is set aside, with what
    it lacked, and the call traced again, up to ``PROFILE_TRACES`` times;
    the caller then holds the trace that is reported to its exact counts.
    Returns (``fn``'s last result, the profile)."""
    set_aside = []
    for _ in range(PROFILE_TRACES):
        if setup is not None:
            setup()
        zero_launches()
        out, wall_ms, kernels = trace_call(fn)
        launches = read_launches()
        want = launches_per_call(out) if callable(launches_per_call) \
            else launches_per_call
        if launches != want:
            raise AssertionError(f"the profiled call launched {launches}, "
                                 f"where {want} were due")
        if not kernels:
            return out, {"measured": False,
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
    by_name, by_group, calls, by_stream = {}, {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        calls[g] = calls.get(g, 0) + 1
        sid = getattr(e, "device_resource_id", None)
        by_stream.setdefault(e.thread if sid is None else sid, []).append(
            (e.time_range.start, e.time_range.end))
    merged = merge_spans(sum(by_stream.values(), []))
    busy = sum(b - a for a, b in merged)
    window = merged[-1][1] - merged[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    prof = {
        "measured": True, "wall_ms": wall_ms,
        "kernel_ms_sum": sum(v[0] for v in by_name.values()) / 1e3,
        "busy_ms": busy / 1e3, "busy_share_of_wall": busy / 1e3 / wall_ms,
        "busy_share_of_kernel_window": busy / max(window, 1e-9),
        "kernels": len(kernels), "launches": launches,
        "traces_set_aside": set_aside,
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "by_group_calls": calls,
        "top_kernels": [[name[:90], us / 1e3, n] for name, (us, n) in top]}
    if len(by_stream) > 1:
        streams = sorted(((sid, len(sp), merge_spans(sp))
                          for sid, sp in by_stream.items()),
                         key=lambda t: -t[1])
        prof["streams"] = {str(sid): {"kernels": n, "busy_ms": sum(
            b - a for a, b in m) / 1e3} for sid, n, m in streams}
        prof["two_stream_overlap_ms"] = overlap_us(streams[0][2],
                                                   streams[1][2]) / 1e3
    return out, prof


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
    batch = trainer.loader.batch(1 + steps)

    def one_step():
        nonlocal state
        state, metrics = trainer.step_fn(state, batch)
        float(metrics["loss"])

    _, profiled = profile_call(one_step, {k: v // steps
                                          for k, v in launches.items()})
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


def phase_checkpoint(smi, arch="mamba-1.4b", layers=CKPT_LAYERS,
                     seq_len=4096, device="cuda"):
    """Kill and resume (phase 11 of the module docstring): runs A
    (straight), B (SIGTERM, emergency save) and C (restore, finish); raises
    unless the emergency save is marked, the restored state is bitwise the
    saved one, C's losses are bitwise A's and the trace validates."""
    import signal
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.obs import Obs
    from repro_torch.obs.check import check_trace
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    obs = Obs.on()

    def trainer(loader=None, ckpt_dir=None, every=0):
        opt = AdamW(cosine_schedule(3e-4, warmup=1, total=CKPT_STEPS))
        return Trainer(LM(cfg, device), opt,
                       loader or train_loader(cfg, "pack", seq_len),
                       TrainerConfig(steps=CKPT_STEPS, ckpt_every=every,
                                     ckpt_dir=ckpt_dir, keep_ckpts=2),
                       obs=obs)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    class KillAt:
        """The loader, sending this process SIGTERM as it fetches one
        step's batch."""

        def __init__(self, loader, step):
            self.loader, self.step, self.sent = loader, step, False

        def batch(self, step):
            if step == self.step:
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            return self.loader.batch(step)

    def ms_per_step(hist):
        return sum(h["step_ms"] for h in hist) / len(hist)

    with tempfile.TemporaryDirectory() as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        ckpt_dir = os.path.join(tmp, "ckpt")
        ta = trainer()
        n_params = sum(p.numel() for p in ta.model.parameters())
        _, hist_a = ta.train(gen(0), verbose=False)
        del ta
        handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        kill = KillAt(train_loader(cfg, "pack", seq_len), CKPT_KILL_AT)
        tb = trainer(kill, ckpt_dir, every=2)
        try:
            state_b, hist_b = tb.train(gen(0), verbose=False)
        finally:
            for s, h in handlers.items():
                signal.signal(s, h)
        ckpt = tb.ckpt
        steps = ckpt.all_steps()
        meta = ckpt.read_meta(CKPT_KILL_AT + 1)["meta"]
        if not kill.sent or len(hist_b) != CKPT_KILL_AT + 1 or \
                steps != [2, CKPT_KILL_AT + 1] or \
                meta != {"step": CKPT_KILL_AT + 1, "emergency": True}:
            raise AssertionError(
                f"SIGTERM at step {CKPT_KILL_AT} (sent: {kill.sent}): run B "
                f"took {len(hist_b)} steps, published {steps}, the last "
                f"manifest's meta {meta}")
        # the ckpt.* gauges hold the last save's, step 4's periodic one
        met = obs.metrics
        saves, marks = (met.counter(n).value
                        for n in ("ckpt.saves", "ckpt.marks"))
        snapshot_ms, write_s, wait_s, nbytes, emergency_s = (
            met.gauge(n).value for n in (
                "ckpt.snapshot_ms", "ckpt.write_s", "ckpt.wait_s",
                "ckpt.bytes", "train.emergency_save_s"))
        if saves != 2 or marks != 1 or emergency_s > write_s + 0.5:
            raise AssertionError(
                f"run B took {saves} snapshots and {marks} marks (want 2, "
                f"1); its emergency save took {emergency_s} s against the "
                f"last write's {write_s} s")
        tc = trainer(ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_c, step_c = tc.restore_or_init(gen(1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = [f"{part}/{k}" for part, a, b in (
            ("params", state_c["params"], state_b["params"]),
            ("m", state_c["opt"].m, state_b["opt"].m),
            ("v", state_c["opt"].v, state_b["opt"].v))
            for k in b if not torch.equal(a[k], b[k])]
        if step_c != CKPT_KILL_AT + 1 or \
                state_c["opt"].step != state_b["opt"].step or differ or \
                (state_c["opt"].master is None) != \
                (state_b["opt"].master is None):
            raise AssertionError(f"the restore of step {step_c} differs "
                                 f"from the saved state: {differ[:5]}, "
                                 f"opt step {state_c['opt'].step} against "
                                 f"{state_b['opt'].step}")
        del state_b, tb
        _, hist_c = tc.train(state=state_c, start_step=step_c, verbose=False)
        losses_a = [h["loss"] for h in hist_a]
        losses_c = [h["loss"] for h in hist_c]
        if losses_c != losses_a[CKPT_KILL_AT + 1:]:
            raise AssertionError(f"the resumed losses {losses_c} differ "
                                 f"from the straight run's "
                                 f"{losses_a[CKPT_KILL_AT + 1:]}")
        trace = os.path.join(tmp, "trace.json")
        obs.export(trace)
        errs = check_trace(trace, require=["train.steps", "ckpt.bytes"],
                           require_spans=["train.step", "train.data",
                                          "ckpt.save", "ckpt.snapshot",
                                          "ckpt.write", "ckpt.mark"])
        taken = len(hist_a) + len(hist_b) + len(hist_c)
        if errs or tc.steps != taken:
            raise AssertionError(f"the trace fails obs.check ({errs}) or "
                                 f"train.steps {tc.steps} != {taken}")
        del state_c, tc
        gc.collect()
        torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
            "d_inner": cfg.d_inner, "d_state": cfg.d_state,
            "vocab": cfg.vocab, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "rows": 2, "seq_len": seq_len,
            "parameters": n_params, "nvidia_smi": smi,
            "ckpt_bytes": nbytes, "tmp_free_gb_before": free_gb,
            "published_steps": steps, "emergency_meta": meta,
            "snapshot_ms": snapshot_ms, "async_write_s": write_s,
            "periodic_wait_s": wait_s, "emergency_save_s": emergency_s,
            "snapshots": saves, "marks": marks,
            "restore_s": restore_s,
            "ms_per_step": {"A": ms_per_step(hist_a),
                            "B": ms_per_step(hist_b),
                            "C": ms_per_step(hist_c)},
            "step_ms": {"A": [h["step_ms"] for h in hist_a],
                        "B": [h["step_ms"] for h in hist_b],
                        "C": [h["step_ms"] for h in hist_c]},
            "losses_a": losses_a, "losses_c": losses_c,
            "resumed_losses_bitwise": True,
            "trace_events": len(obs.tracer.chrome_events()),
            "train_steps_metric": taken,
            "phase_wall_s": time.perf_counter() - t_phase}


def phase_launcher():
    """The training launcher with checkpoints, an obs trace and a
    ``torch.profiler`` capture, as a subprocess: it must exit 0, publish
    steps 1–3, write a trace that passes ``obs.check`` and a profile that
    names a ``conv1d_pack`` kernel."""
    from repro_torch.obs.check import check_trace
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, trace, prof = (os.path.join(tmp, n)
                             for n in ("ckpt", "trace.json", "prof"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
               "--steps", "3", "--rows", "2", "--seq-len", "256",
               "--ckpt-dir", ckpt, "--ckpt-every", "1", "--obs-trace",
               trace, "--profile-dir", prof]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"the launcher exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        steps = sorted(os.listdir(ckpt))
        errs = check_trace(trace, require=["train.steps"],
                           require_spans=["train.step", "train.data"])
        files = [os.path.join(prof, n) for n in os.listdir(prof)
                 if n.endswith(".pt.trace.json")]
        kernels = []
        for f in files:
            with open(f) as fh:
                kernels += [e["name"] for e in json.load(fh)["traceEvents"]
                            if e.get("cat") == "kernel"]
        conv = [k for k in kernels if "conv1d_pack" in k]
        if steps != ["step_1", "step_2", "step_3"] or errs or not conv:
            raise AssertionError(f"the launcher published {steps}; its "
                                 f"trace: {errs}; its profile's kernels "
                                 f"naming conv1d_pack: {len(conv)} of "
                                 f"{len(kernels)} in {len(files)} file(s)")
    return {"cmd": " ".join(cmd[1:]), "published_steps": steps,
            "trace_ok": True, "profile_files": len(files),
            "profile_kernels": len(kernels),
            "profile_conv1d_pack_kernels": len(conv),
            "stdout_tail": out.stdout.strip().splitlines()[-3:],
            "seconds": time.perf_counter() - t0}


def serve_mix(cfg, seed=0):
    """Phase 12's requests, in submit order: 16 prompts of 16–200 tokens
    (every fourth sampled at ``SERVE_SAMPLED``, the rest greedy) and one
    greedy prompt of ``SERVE_LONG`` tokens after the eighth."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 201, size=16)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in lens]
    long = rng.integers(1, cfg.vocab, size=SERVE_LONG)
    mix = []
    for i, p in enumerate(prompts):
        mix.append((p, dict(SERVE_SAMPLED) if i % 4 == 3 else {}))
        if i == 7:
            mix.append((long, {}))
    return mix


def phase_conv_slab():
    """#1 at the chunk lane's slab (``CHUNK_SLAB_SHAPE``, bf16): the carried
    conv tail at W-1 leading zero positions, then a mid-prompt slab at
    global positions 512.. (``blocks._conv_resume``); against the plain
    version, twice bitwise, timed beside it, cuDNN and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    B, L, D = CHUNK_SLAB_SHAPE
    g = torch.Generator(device="cuda").manual_seed(L)
    x = torch.randn((B, L, D), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(
        torch.bfloat16)
    b = torch.randn((D,), generator=g, device="cuda").to(torch.bfloat16)
    pos = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    pos[:, 3:] = torch.arange(512, 512 + L - 3, dtype=torch.int32)
    y = kconv.conv1d_pack(x, w, b, pos)
    again = kconv.conv1d_pack(x, w, b, pos)
    want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
    torch.cuda.synchronize()
    err = (y.float() - want).abs()
    if not torch.equal(y, again) or not bool(
            (err <= 2.0 ** -8 * want.abs() + 1e-6).all()):
        raise AssertionError(f"conv1d_pack at the chunk slab: bitwise "
                             f"repeat {torch.equal(y, again)}, max err "
                             f"{err.max().item()}")
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    lib = lambda: F.conv1d(xc, wc, b, padding=3, groups=D)
    kern = lambda: kconv.conv1d_pack(x, w, b, pos)
    plain = lambda: kconv.conv1d_pack_plain(x, w, b, pos)
    bound, by = conv_bound_ms(x, w, pos)
    return {"kernel": "conv1d_pack_fwd", "shape": list(CHUNK_SLAB_SHAPE),
            "dtype": "bfloat16", "max_abs_err": err.max().item(),
            "tolerance": "2^-8 relative (one bf16 rounding)",
            "bitwise_repeat": True, "launch": kconv.LAST_LAUNCH,
            "kernel_ms": graph_ms(kern), "plain_ms": graph_ms(plain),
            "library_ms": graph_ms(lib), "bound_ms": bound, "bound_by": by,
            "kernel_eager_ms": eager_ms(kern)}


def phase_chunk_parity(model_bf16, cfg):
    """An f32 copy prefills one ``CHUNK_PARITY_LEN``-token prompt whole
    (``prefill``) and in ``SERVE_CHUNK``-token slabs (``prefill_chunk``):
    end logits and conv/SSM states within ``PARITY_TOL``; the slabs
    launch #1 once a layer each and no other kernel."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.models.lm import LM
    f32 = LM(dataclasses.replace(cfg, dtype="float32"))
    f32.load_state_dict(model_bf16.state_dict())
    n = CHUNK_PARITY_LEN
    p = np.random.default_rng(2).integers(1, cfg.vocab, size=n).astype(
        np.int32)
    lg, whole, _ = f32.prefill(
        {"tokens": p[None], "positions": np.arange(n, dtype=np.int32)[None],
         "segment_ids": np.ones((1, n), np.int32)})
    cache = f32.init_cache(1)
    clen = torch.zeros(1, dtype=torch.int32, device=f32.device)
    spans = packing.chunk_spans(n, SERVE_CHUNK)
    zero_launches()
    for off, take in spans:
        batch = packing.suffix_slab({0: (p, off, take)}, 1, SERVE_CHUNK)
        lg_c, cache, clen = f32.prefill_chunk(cache, batch, clen)
    torch.cuda.synchronize()
    counts = read_launches()
    conv = counts.pop("conv1d_pack_fwd")
    worst = {}
    for k, got, ref in (("logits", lg_c[0], lg[0]),
                        ("conv", cache["conv"], whole["conv"]),
                        ("ssm", cache["ssm"], whole["ssm"])):
        worst[k] = ((got - ref).abs().max()
                    / ref.abs().max().clamp(min=1.0)).item()
    del f32, cache, whole
    torch.cuda.empty_cache()
    if conv != cfg.n_layers * len(spans) or any(counts.values()) or \
            int(clen[0]) != n or max(worst.values()) > PARITY_TOL:
        raise AssertionError(f"{cfg.name} chunked prefill: {worst} (bar "
                             f"{PARITY_TOL}), #1 {conv} launches for "
                             f"{len(spans)} slabs, others {counts}, "
                             f"consumed {int(clen[0])}")
    return {"arch": cfg.name, "dtype": "float32", "tf32": "off",
            "prompt": n, "slab": SERVE_CHUNK, "slabs": len(spans),
            "tolerance": PARITY_TOL, "max_rel_err": worst,
            "conv1d_pack_launches": conv,
            "conv1d_pack_launches_per_slab": conv // len(spans)}


def sampled_reference(model, record, prompt, rid, slot, knobs, n_slots):
    """A sampled request replayed through the model's own calls: its
    packed round again (``prefill_packed`` on the recorded batch: the same
    inputs, so the same logits and states), its first token drawn from its
    segment's logits with its stream (``sample_tokens``), its state in a
    fresh cache of ``n_slots`` rows at the slot the engine gave it, and
    ``SERVE_NEW`` - 1 steps of ``decode_step_sample``. Returns its tokens;
    None when the recorded round does not hold the prompt."""
    import numpy as np
    import torch
    from repro_torch.models import blocks as B
    batch = {k: torch.as_tensor(v).cpu().numpy() for k, v in record[0].items()}
    ends = torch.as_tensor(record[1]).cpu().numpy()
    S = ends.shape[1]
    k = None
    for r, s in zip(*np.nonzero(ends >= 0)):
        e = int(ends[r, s])
        a = e - len(prompt) + 1
        if a >= 0 and batch["positions"][r, a] == 0 and np.array_equal(
                batch["tokens"][r, a:e + 1], prompt):
            k = int(r) * S + int(s)
    if k is None:
        return None
    dev = model.device

    def knob_rows(n, i):
        arrs = (np.zeros(n, np.int64), np.zeros(n, np.float32),
                np.zeros(n, np.int64), np.ones(n, np.float32))
        for a, v in zip(arrs, (B.request_streams(0, [rid])[0],
                               knobs["temperature"], knobs["top_k"],
                               knobs["top_p"])):
            a[i] = v
        return [torch.as_tensor(a, device=dev) for a in arrs]

    logits, states, _ = model.prefill_packed(batch, ends)
    K = ends.size
    stream, temp, topk, topp = knob_rows(K, k)
    tok, _ = model.sample_tokens(
        logits.reshape(K, -1), stream,
        torch.zeros(K, dtype=torch.int64, device=dev), temp, topk, topp)
    out = [int(tok[k])]
    cache = model.init_cache(n_slots)
    model.scatter_into_cache(cache, states, [k], [slot])
    stream, temp, topk, topp = knob_rows(n_slots, slot)
    ctr = torch.ones(n_slots, dtype=torch.int64, device=dev)
    cur = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
    cur[slot, 0] = tok[k]
    for _ in range(SERVE_NEW - 1):
        t, _, cache, ctr = model.decode_step_sample(cache, cur, stream, ctr,
                                                    temp, topk, topp)
        out.append(int(t[slot]))
        cur = t[:, None]
    return out


def phase_serve(model, cfg):
    """Phase 12: the scheduler-v2 engine on ``cfg`` at full width and depth
    (bf16): ``serve_mix``'s 17 requests on ``SERVE_SLOTS`` slots, buckets
    (64, 128, 256), 2 × 4 segments a round, the TTFT bucket policy at
    ``SERVE_TTFT_MS``, one chunk row of ``SERVE_CHUNK``.

    A warm-up run, then overlap on (two prefills in flight on the side
    stream) and overlap off (one, synchronous), each with the launch
    counters set to 0 just before and read just after. A round's numerics
    depend on its layout (the packed scan's chunks, the matmuls' shapes),
    so the two runs must pack the same rounds for their streams to be
    compared bitwise: with more slots than requests every round admits
    the FIFO prefix that fits whatever the free count, and with the target
    above every wait no time rule picks a bucket or admits early (asserted:
    no early admit, no deferred upgrade). Each sampled stream is then
    replayed (``sampled_reference``) at the slot the engine gave it. Then
    the padded wave (``decode_batch``) against the continuous engine on 8
    of the prompts, one profiled decode step (greedy and sampled), one
    profiled prefill round, and the first steps of an overlapped run
    profiled for prefill and decode kernels on two streams at once."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    mix = serve_mix(cfg)
    kw = dict(num_slots=SERVE_SLOTS, max_len=2048, buckets=(64, 128, 256),
              prefill_rows=2, max_segments=4, bucket_policy="ttft",
              target_ttft_ms=SERVE_TTFT_MS, chunk_size=SERVE_CHUNK)
    finite, records, slot_of, landings = [], [], {}, []
    calls = {n: getattr(model, n) for n in ("prefill_packed", "decode_step",
                                            "prefill_chunk")}

    def checked(name):
        def fn(*a, **k):
            out = calls[name](*a, **k)
            finite.append(torch.isfinite(out[0]).all())
            if name == "prefill_packed":
                records.append((a[0], a[1]))
            return out
        return fn

    for n in calls:
        setattr(model, n, checked(n))

    def engine(**over):
        """An engine that records each request's slot, and for each packed
        prefill the decode steps it waited and its host ms from dispatch
        to landing (where its first tokens are observed)."""
        eng = ServeEngine(model, **dict(kw, **over))
        act, refill, land = eng._activate, eng._try_refill, eng._land_one
        sent = {}

        def activate(slot, req, now, first):
            slot_of[req.rid] = slot
            act(slot, req, now, first)

        def try_refill():
            sent[eng.stats.prefills] = time.perf_counter()
            return refill()

        def land_one(inf):
            land(inf)
            landings.append((inf["steps_waited"], (
                time.perf_counter() - sent[inf["pidx"]]) * 1e3))

        eng._activate, eng._try_refill = activate, try_refill
        eng._land_one = land_one
        return eng

    def timed(overlap, inflight):
        eng = engine(overlap=overlap, max_inflight_prefills=inflight)
        for p, knobs in mix:
            eng.submit(p, SERVE_NEW, **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        finite.clear()
        records.clear()
        slot_of.clear()
        landings.clear()
        zero_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        st = eng.stats
        conv = counts.pop("conv1d_pack_fwd")
        bad = [r for r in outs if eng.status[r] != "done"
               or len(outs[r]) != SERVE_NEW]
        if bad or not bool(torch.stack(finite).all()) or \
                any(counts.values()) or \
                conv != cfg.n_layers * (st.prefills + st.chunk_rounds) or \
                st.chunk_rounds != -(-SERVE_LONG // SERVE_CHUNK) or \
                st.early_admits or st.deferred_upgrades:
            raise AssertionError(
                f"serve (overlap={overlap}): unfinished {bad}, #1 {conv} "
                f"for {st.prefills} prefills + {st.chunk_rounds} chunk "
                f"rounds × {cfg.n_layers}, others {counts}; {st!r}")
        pct, ipct = st.ttft_percentiles(), st.itl_percentiles()
        return outs, list(records), dict(slot_of), {
            "overlap": overlap, "max_inflight_prefills": inflight,
            "wall_s": wall, "generated": st.generated,
            "tok_per_s": st.generated / wall,
            "ttft_p50_ms": pct["p50"], "ttft_p95_ms": pct["p95"],
            "itl_p50_ms": ipct["p50"], "itl_p95_ms": ipct["p95"],
            "decode_ms_per_step": st.decode_ms / st.decode_steps,
            "prefill_ms_per_round": st.prefill_ms / st.prefills,
            "chunk_ms_per_round": st.chunk_ms / st.chunk_rounds,
            "host_ms": st.host_ms, "prefills": st.prefills,
            "decode_steps": st.decode_steps,
            "midflight_refills": st.midflight_refills,
            "overlapped_prefills": st.overlapped_prefills,
            "bucket_upgrades": st.bucket_upgrades,
            "chunk_rounds": st.chunk_rounds,
            "chunked_prefills": st.chunked_prefills,
            "buckets": sorted(st.buckets),
            "prefill_steps_waited": [w for w, _ in landings],
            "prefill_dispatch_to_land_ms": [ms for _, ms in landings],
            "conv1d_pack_launches": conv,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}

    try:
        timed(True, 2)                            # warm-up
        on_outs, on_records, on_slots, on = timed(True, 2)
        off_outs, _, _, off = timed(False, 1)
        if on["overlapped_prefills"] == 0:
            raise AssertionError("no prefill stayed in flight across a "
                                 "decode step")
        differ = [r for r in on_outs if on_outs[r] != off_outs[r]]
        if differ:
            raise AssertionError(f"overlap on and off give different "
                                 f"streams for requests {differ}")
        refs = {}
        for rid, (p, knobs) in enumerate(mix):
            if not knobs:
                continue
            ref = next(filter(None, (
                sampled_reference(model, rec, p, rid, on_slots[rid], knobs,
                                  SERVE_SLOTS) for rec in on_records)))
            refs[rid] = ref == on_outs[rid]
            if not refs[rid]:
                raise AssertionError(f"sampled request {rid}: engine "
                                     f"{on_outs[rid]} != replay {ref}")
    finally:
        for n, fn in calls.items():
            setattr(model, n, fn)

    # the padded wave against the continuous engine, on 8 greedy prompts
    eight = [p for p, knobs in mix if not knobs and len(p) <= 256][:8]
    wave_cont = {"wave": [], "continuous": []}
    for kind in ("continuous", "wave", "wave", "continuous"):
        eng = ServeEngine(model, num_slots=8, max_len=512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "wave":
            outs = eng.decode_batch(eight, SERVE_NEW)
        else:
            for p in eight:
                eng.submit(p, SERVE_NEW)
            outs = list(eng.run().values())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert [len(o) for o in outs] == [SERVE_NEW] * 8
        wave_cont[kind].append(8 * SERVE_NEW / wall)

    # profiles: one decode step (greedy; sampled), one prefill round, and
    # an overlapped run's first steps (prefills in flight beside decode);
    # the counters hold each to the kernels it launched (decode: none)
    none = {k: 0 for k in read_launches()}
    held = []

    def fresh(**kw_eng):
        def setup():
            while held:
                held.pop().run()          # drain a set-aside trace's engine
            held.append(ServeEngine(model, **kw_eng))
        return setup

    def decode_setup(sampled):
        def setup():
            fresh(num_slots=SERVE_SLOTS, max_len=512, overlap=False,
                  refill_threshold=1)()
            for p, knobs in mix:
                if len(p) <= 256:
                    held[0].submit(p, SERVE_NEW,
                                   **(knobs if sampled else {}))
            while held[0].queue:
                held[0].step()
        return setup

    profiles = {}
    for name, sampled in (("decode_step_greedy", False),
                          ("decode_step_sampled", True)):
        _, prof_d = profile_call(lambda: held[0]._decode_step(), none,
                                 setup=decode_setup(sampled))
        profiles[name] = dict(prof_d, active=len(held[0]._active_slots()),
                              slots=SERVE_SLOTS)

    def prefill_setup():
        fresh(num_slots=8, max_len=512, overlap=False)()
        for p in eight:
            held[0].submit(p, SERVE_NEW)

    _, prof_p = profile_call(lambda: held[0]._try_refill(),
                             dict(none, conv1d_pack_fwd=cfg.n_layers),
                             setup=prefill_setup)
    profiles["prefill_round"] = dict(
        prof_p, prompts=held[0].stats.prefill_tokens, rows=2,
        bucket=sorted(held[0].stats.buckets))

    def overlap_setup():
        fresh(**dict(kw, overlap=True, max_inflight_prefills=2))()
        for p, knobs in mix:
            held[0].submit(p, SERVE_NEW, **knobs)

    def first_steps(n=8):
        st = held[0].stats
        before = st.prefills + st.chunk_rounds
        for _ in range(n):
            held[0].step()
        return st.prefills + st.chunk_rounds - before

    _, prof_o = profile_call(
        first_steps,
        lambda rounds: dict(none, conv1d_pack_fwd=cfg.n_layers * rounds),
        setup=overlap_setup)
    eng = held.pop()
    profiles["overlapped_steps"] = dict(
        prof_o, steps=8,
        side_stream=None if eng._side is None else eng._side.stream_id)
    eng.run()
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "slots": SERVE_SLOTS,
            "requests": len(mix),
            "prompt_lens": [len(p) for p, _ in mix],
            "sampled": [r for r, (_, k) in enumerate(mix) if k],
            "target_ttft_ms": SERVE_TTFT_MS, "on": on, "off": off,
            "streams_bitwise_equal": True, "sampled_replays_equal": refs,
            "padded_wave_tok_per_s": wave_cont["wave"],
            "continuous_tok_per_s": wave_cont["continuous"],
            "profiles": profiles}


def phase_lifecycle(model, cfg, smi):
    """Phase 13: the request lifecycle on phase 12's engine and mix (module
    docstring). Every run has the launch counters set to 0 just before it
    and read just after: #1 n_layers × (packed prefills that ran + chunk
    rounds), nothing else."""
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.faults import EngineKilled, FaultPlan
    from repro_torch.launch.serve import ServeEngine
    t_phase = time.perf_counter()
    mix = serve_mix(cfg)
    kw = dict(num_slots=SERVE_SLOTS, max_len=2048, buckets=(64, 128, 256),
              prefill_rows=2, max_segments=4, bucket_policy="ttft",
              target_ttft_ms=SERVE_TTFT_MS, chunk_size=SERVE_CHUNK,
              overlap=True, max_inflight_prefills=2)

    def engine(**over):
        eng = ServeEngine(model, **dict(kw, **over))
        for p, knobs in mix:
            eng.submit(p, SERVE_NEW, **knobs)
        torch.cuda.synchronize()
        zero_launches()
        return eng

    def launches(eng):
        torch.cuda.synchronize()
        counts = read_launches()
        conv = counts.pop("conv1d_pack_fwd")
        st = eng.stats
        ran = st.prefills - st.prefill_faults + st.chunk_rounds
        if any(counts.values()) or conv != cfg.n_layers * ran:
            raise AssertionError(f"lifecycle: #1 {conv} for {ran} forwards "
                                 f"× {cfg.n_layers}, others {counts}")
        return conv

    def timed(**over):
        eng = engine(**over)
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats
        return eng, outs, {
            "guard": eng.guard, "wall_s": wall, "tok_per_s":
            st.generated / wall, "decode_ms_per_step":
            st.decode_ms / st.decode_steps, "decode_steps": st.decode_steps,
            "ttft_p50_ms": st.ttft_percentiles()["p50"],
            "conv1d_pack_launches": launches(eng)}

    # the guard off and on, empty plan: the same streams
    guard_runs, clean = [], None
    for guard in (False, True, True, False):
        eng, outs, row = timed(guard=guard, faults=FaultPlan())
        if any(eng.status[r] != "done" or len(outs[r]) != SERVE_NEW
               for r in outs):
            raise AssertionError(f"lifecycle guard={guard}: {eng.status}")
        if clean is None:
            clean = outs
        elif outs != clean:
            raise AssertionError(f"lifecycle: guard={guard} changed streams "
                                 f"{[r for r in outs if outs[r] != clean[r]]}")
        guard_runs.append(row)

    # one greedy decode step profiled with the guard off and on (16 of 24
    # slots active, as phase 12's profile): the guard's device cost, which
    # the host-bound step's wall hides; the counters hold each to no launch
    # of the nine kernels
    held, guard_profiles = [], []

    def decode_setup(guard):
        def setup():
            while held:
                held.pop().run()
            eng = ServeEngine(model, num_slots=SERVE_SLOTS, max_len=512,
                              overlap=False, refill_threshold=1, guard=guard)
            for p, _ in mix:
                if len(p) <= 256:
                    eng.submit(p, SERVE_NEW)
            while eng.queue:
                eng.step()
            held.append(eng)
        return setup

    none = {k: 0 for k in read_launches()}
    for guard in (False, True, True, False):
        _, prof = profile_call(lambda: held[0]._decode_step(), none,
                               setup=decode_setup(guard))
        guard_profiles.append(dict(
            {k: prof.get(k) for k in ("busy_ms", "kernels", "wall_ms",
                                      "traces_set_aside")},
            guard=guard, active=len(held[0]._active_slots())))
    while held:
        held.pop().run()

    # one decode slot, one prefill segment and one chunk row poisoned, one
    # prefill failed: those requests fail, every other stream is clean's
    eng, outs, fault_row = timed(faults=FaultPlan(**LIFE_PLAN))
    st = eng.stats
    kinds = {"non-finite decode logits": 0, "non-finite prefill state": 0,
             "non-finite chunked-prefill state": 0,
             "prefill dispatch 2 failed": 0}
    for r, e in eng.errors.items():
        kinds[next(k for k in kinds if k in e)] += 1
    failed = sorted(r for r, s in eng.status.items() if s == "failed")
    differ = [r for r in outs if r not in failed and outs[r] != clean[r]]
    if not eng.guard or differ or st.quarantined != 3 or \
            st.prefill_faults != 1 or min(kinds.values()) < 1 or \
            len(failed) != sum(kinds.values()) or \
            any(eng.status[r] != "done" for r in outs if r not in failed):
        raise AssertionError(f"lifecycle faults: failed {failed}, kinds "
                             f"{kinds}, streams differ {differ}; {st!r}")
    fault_row.update(failed=failed, errors=kinds, quarantined=st.quarantined,
                     prefill_faults=st.prefill_faults,
                     prefills=st.prefills, chunk_rounds=st.chunk_rounds)

    # kill before decode step LIFE_KILL_AT, snapshots every 4 steps, restore
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        eng = engine(faults=FaultPlan(kill_at_step=LIFE_KILL_AT))
        snaps, steps = [], 0
        try:
            while True:
                if steps % LIFE_SNAP_EVERY == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.snapshot(mgr, step=steps, blocking=True)
                    snaps.append({
                        "step": steps,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "device_to_host_ms": mgr._g_snap.value,
                        "write_s": mgr._g_write.value,
                        "bytes": mgr._g_bytes.value})
                steps += 1
                if not eng.step():
                    raise AssertionError("lifecycle: the kill never fired")
        except EngineKilled:
            pass
        state_bytes = sum(t.numel() * t.element_size() for t in [
            v for v in eng._device_state().values() if torch.is_tensor(v)]
            + list(eng.cache.values()) + list(eng.chunk_cache.values()))
        del eng
        meta = mgr.read_meta(mgr.latest_step())["meta"]
        fresh = ServeEngine(model, **kw)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        restored = fresh.restore(mgr)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        outs = fresh.run()
        resumed_conv = launches(fresh)
    mid_chunk = meta["chunks"][0]
    if outs != clean or mid_chunk is None or \
            not 0 < mid_chunk["off"] < SERVE_LONG:
        raise AssertionError(
            f"lifecycle restore of step {restored}: streams differ for "
            f"{[r for r in clean if outs.get(r) != clean[r]]}; chunk row "
            f"{mid_chunk and mid_chunk['off']}")
    kill = {"kill_at_step": LIFE_KILL_AT, "snapshots": snaps,
            "restored_step": restored, "restore_ms": restore_ms,
            "resumed": len(fresh.resumed),
            "chunk_row_off_at_snapshot": mid_chunk["off"],
            "device_state_bytes": state_bytes,
            "conv1d_pack_launches_after_restore": resumed_conv,
            "streams_bitwise_equal": True}

    # cancel a request whose prefill is in flight on the side stream: at
    # the first pooled dispatch whose event has not fired yet; a second run
    # takes the first pooled one if no event was still pending (the host
    # can take as long to issue a prefill as the card to run it)
    for pending_only in (True, False):
        eng = engine()
        refill, picked = eng._try_refill, {}

        def try_refill():
            issued = refill()
            if issued and "rid" not in picked and eng._prefill_pool:
                inf = eng._prefill_pool[-1]
                pending = inf["event"] is not None and \
                    not inf["event"].query()
                if pending or not pending_only:
                    picked.update(inf=inf, slot=inf["slot_of"][0][0],
                                  pending=pending,
                                  rid=inf["admitted"][0].rid)
                    eng.cancel(picked["rid"])
            return issued

        eng._try_refill = try_refill
        while eng.step():
            inf = picked.get("inf")
            if inf is not None and \
                    all(x is not inf for x in eng._prefill_pool):
                holder = eng.slot_req[picked["slot"]]
                if holder is not None and holder.rid == picked["rid"]:
                    raise AssertionError("lifecycle: a cancelled request "
                                         "took its slot at landing")
                picked["inf"] = None
        if "rid" in picked:
            break
    target = (picked["rid"], picked["slot"])
    event_pending = picked["pending"]
    launches(eng)
    rid = target[0]
    differ = [r for r in clean if r != rid and eng.outputs[r] != clean[r]]
    if eng.status[rid] != "cancelled" or eng.outputs[rid] or differ or \
            eng.stats.cancelled != 1:
        raise AssertionError(f"lifecycle cancel of {rid}: "
                             f"{eng.status[rid]}, differ {differ}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "slots": SERVE_SLOTS, "requests": len(mix), "card": smi,
            "guard_runs": guard_runs, "guard_streams_bitwise_equal": True,
            "guard_decode_profiles": guard_profiles,
            "faults": dict(fault_row, plan=repr(FaultPlan(**LIFE_PLAN))),
            "kill_restore": kill,
            "cancel_in_flight": {"rid": rid, "slot": target[1],
                                 "event_pending_at_cancel": event_pending,
                                 "others_bitwise_equal": True},
            "phase_wall_s": time.perf_counter() - t_phase}


def phase_serve_launcher():
    """The serve launcher as a subprocess on the card: ``--tiny``, sampled,
    buckets (16, 32) so prompts of up to 39 tokens meet the chunk lane,
    ``--obs-trace`` and ``--profile-dir``. It must exit 0 with chunk rounds,
    its trace pass ``obs.check`` with the serve spans required and its
    profile name a ``conv1d_pack`` kernel."""
    from repro_torch.obs.check import check_trace
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace, prof = (os.path.join(tmp, n) for n in ("trace.json", "prof"))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
               "--requests", "12", "--slots", "4", "--max-len", "96",
               "--buckets", "16,32", "--temperature", "0.8", "--top-k", "40",
               "--max-inflight-prefills", "2", "--guard", "--deadline-ms",
               "60000", "--max-queue", "64", "--obs-trace", trace,
               "--profile-dir", prof]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"the serve launcher exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        last = json.loads(out.stdout.strip().splitlines()[-1])
        errs = check_trace(
            trace, require=["serve.prefills", "serve.decode_steps",
                            "serve.chunk_rounds", "serve.ttft_ms"],
            require_spans=["serve.step", "prefill_dispatch", "prefill_land",
                           "chunk_slab", "decode_step", "queued", "prefill",
                           "chunk", "decode"])
        files = [os.path.join(prof, n) for n in os.listdir(prof)
                 if n.endswith(".pt.trace.json")]
        kernels = []
        for f in files:
            with open(f) as fh:
                kernels += [e["name"] for e in json.load(fh)["traceEvents"]
                            if e.get("cat") == "kernel"]
        conv = [k for k in kernels if "conv1d_pack" in k]
        lifecycle = [last[k] for k in ("shed", "expired", "cancelled",
                                       "quarantined", "prefill_faults")]
        if errs or not conv or not last["chunk_rounds"] or \
                not last["guard"] or any(lifecycle):
            raise AssertionError(f"the serve launcher's trace: {errs}; its "
                                 f"profile's conv1d_pack kernels: "
                                 f"{len(conv)} of {len(kernels)}; {last}")
    return {"cmd": " ".join(cmd[1:]), "trace_ok": True,
            "profile_files": len(files), "profile_kernels": len(kernels),
            "profile_conv1d_pack_kernels": len(conv), "result": last,
            "seconds": time.perf_counter() - t0}


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

    # kill and resume: SIGTERM, the emergency save, the restore; then the
    # launcher's checkpoint, trace and profile flags
    emit("checkpoint", **phase_checkpoint(smi))
    emit("launcher", **phase_launcher())

    # the serving engine's scheduler v2: #1 at the chunk slab, chunked
    # prefill against whole prefill on both models, the engine (overlap,
    # the pipeline, the TTFT policy, sampling, the chunk lane) on
    # mamba-1.4b, the padded wave, profiles; then the serve launcher
    slab = phase_conv_slab()
    emit("kernels", **slab)
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    chunk_par = phase_chunk_parity(model, cfg)
    emit("chunk_parity", **chunk_par)
    sv = phase_serve(model, cfg)
    for pname, prof_s in sv.pop("profiles").items():
        emit("serve_profile", name=pname, **prof_s)
    emit("serve", **sv)
    # the request lifecycle on the same engine: guard, faults, kill and
    # restore, a cancel in flight
    emit("lifecycle", **phase_lifecycle(model, cfg, smi))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = LM(cfg2)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    emit("chunk_parity_mamba2", **phase_chunk_parity(model, cfg2))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_launcher", **phase_serve_launcher())

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
    per_prefill = eng["conv1d_pack_launches"] // eng["prefills"]
    print(json.dumps({"kernels": [
        entry("conv1d_pack_fwd", "conv1d_pack.cu",
              "src/repro/kernels/conv1d_pack.py:36",
              main_row(conv_rows, MAIN_SHAPE), eng["conv1d_pack_launches"],
              conv_worst, launches_per_prefill=per_prefill,
              launches_train=launches["conv1d_pack_fwd"],
              launches_train_step=launches3["conv1d_pack_fwd"],
              launches_train_mamba2=launches2["conv1d_pack_fwd"],
              resources=conv_resources("fwd", conv_rows),
              train_ms=conv_train_ms(conv_rows),
              launches_serve=sv["on"]["conv1d_pack_launches"],
              launches_per_chunk_round=chunk_par[
                  "conv1d_pack_launches_per_slab"],
              chunk_slab={k: slab[k] for k in (
                  "shape", "kernel_ms", "kernel_eager_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err")}),
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
