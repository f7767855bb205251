#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — the card's name; ``nvidia-smi``'s name and power limit on a
             line of their own. No CUDA device: exit 1, no result.
2. build   — every CUDA source in ``src/repro_torch/csrc`` with ``nvcc``
             (one process per source, started together).
3. kernels — each kernel against its plain PyTorch version at the main
             path's shapes, and timed beside the plain version, the
             library yardstick and the least time the card could take.
4. parity  — mamba-1.4b at full width in f32 (TF32 off for matmuls and
             convolutions): ``prefill_packed`` end logits and states of 4
             prompts against per-prompt ``prefill``.
5. engine  — the main path: the continuous-batching engine serving
             mamba-1.4b at full width in bf16 (48 layers, random weights
             from seed 0), 12 greedy requests × 16 new tokens. Every
             kernel launch counter is set to 0 just before and read just
             after; each kernel of the path must have launched.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
SHAPES = [(2, 64, 4096), (2, 128, 4096), (2, 256, 4096)]   # (rows, L, di)
MAIN_SHAPE = (2, 256, 4096)      # the largest prefill bucket
PARITY_TOL = 1e-3                # max |Δ| / max(1, max |ref|), 48 f32 layers


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


def conv_inputs(shape, dtype, seed):
    """x_in as the strided half of an in_proj output; row 0 packs prompts
    with resets, row 1 is a carried row of a split pack (positions > 0 at
    its start)."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    B, L, D = shape
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, L // 4, size=16)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), L, side="right"))]
    pb = packing.pack([rng.integers(1, 9, size=int(n)) for n in lens], L,
                      policy="sequential", num_rows=B)
    sp = packing.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L)
    pos = pb.positions.copy()
    pos[1] = sp.positions[1]
    assert sp.carry_mask[1] and pos[1, 0] > 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(dtype)
    x_in = xz.chunk(2, dim=-1)[0]
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(dtype)
    b = torch.randn((D,), generator=g, device="cuda").to(dtype)
    return x_in, w, b, torch.as_tensor(pos, device="cuda")


def conv_bound_ms(x, w, positions):
    B, L, D = x.shape
    es = x.element_size()
    nbytes = 2 * B * L * D * es + positions.numel() * 4 + (w.numel() + D) * es
    flops = 2 * w.shape[0] * B * L * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    rows, worst = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            x, w, b, pos = conv_inputs(shape, dtype, seed=shape[1])
            y = kconv.conv1d_pack(x, w, b, pos)
            torch.cuda.synchronize()
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
            rows.append({
                "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err.max().item(), "tolerance": tol,
                "kernel_ms": graph_ms(kern), "plain_ms": graph_ms(plain),
                "library_ms": graph_ms(lib), "bound_ms": bound,
                "bound_by": by, "kernel_eager_ms": eager_ms(kern),
                "plain_eager_ms": eager_ms(plain),
                "library_eager_ms": eager_ms(lib)})
            emit("kernels", **rows[-1])
    return rows, worst


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
    from repro_torch.kernels import conv1d_pack as kconv
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
    kconv.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kconv.LAUNCHES
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
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

    rows, worst = phase_kernels()

    cfg = get_config("mamba-1.4b")
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    parity = phase_parity(model, cfg)
    emit("parity", arch=cfg.name, dtype="float32", tf32="off",
         tolerance=PARITY_TOL, max_rel_err=parity)

    eng = phase_engine(model, cfg)
    emit("engine", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, **eng)

    main_row = next(r for r in rows if r["shape"] == list(MAIN_SHAPE)
                    and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "conv1d_pack_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/conv1d_pack.cu",
        "replaces": "src/repro/kernels/conv1d_pack.py:36",
        "launches": eng["conv1d_pack_launches"],
        "launches_per_prefill": cfg.n_layers,
        "max_abs_err": worst,
        "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "at": {"shape": main_row["shape"], "dtype": main_row["dtype"]}}]}),
        flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
