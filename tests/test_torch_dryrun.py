"""The port's dry run (``repro_torch.launch.shapes``, ``launch/dryrun.py``,
``roofline/counter.py``, ``roofline/report.py``) on the CPU, held against
the JAX package where it has a counterpart:

* ``SHAPES`` and ``cell_supported`` equal the JAX ones on the four Mamba
  configs; a record's model FLOPs equal the JAX ``model_flops_per_step``;
  ``LM.prefill_logits`` (the prefill cell's function) equals the JAX one on
  the same weights (1e-5 abs + rel, f32);
* the kernel entries' shape-only path on the meta device gives the plain
  versions' shapes and dtypes, and raises on a tensor of another device;
* a reduced-config step counted on the CPU, through the plain kernels,
  equals its meta dry run exactly in FLOPs by unit, bytes, traffic by op
  and kernel tally; a full-width mamba-1.4b ``train_4k`` dry run takes
  seconds (it never reaches a plain step loop);
* records: ``ok`` in the JAX schema, ``skip`` for a JAX ``ASSIGNED`` arch,
  an unknown card raises; ``report`` renders them.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from repro_torch.kernels import selective_scan_heads as kh  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    CONV_KERNELS, HEADS_KERNELS, SCAN_KERNELS)
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.counter import count_call  # noqa: E402
from repro_torch.roofline.kernel_model import kernel_work  # noqa: E402

PAPER = ["mamba-110m", "mamba-1.4b", "mamba-2.8b", "mamba2-370m"]
H100 = "NVIDIA H100 80GB HBM3"
EXACT = ("flops", "flops_by_unit", "bytes", "traffic_by_op", "kernels")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: one intra-op thread keeps them from spinning
    on the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_and_cell_supported_match_jax():
    assert shapes.SHAPES == jshapes.SHAPES
    for arch in PAPER:
        for s in shapes.SHAPES:
            assert shapes.cell_supported(get_config(arch), s) == \
                jshapes.cell_supported(jget_config(arch), s)


def test_input_specs_are_meta_and_shaped():
    cfg = get_config("mamba-1.4b")
    tr = shapes.input_specs(cfg, "train_4k")
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in tr.items()} == {
        k: ((256, 4096), torch.int32, "meta")
        for k in ("tokens", "positions", "segment_ids")}
    dec = shapes.input_specs(cfg, "decode_32k")
    assert tuple(dec["tokens_t"].shape) == (128, 1)
    assert {k: tuple(v.shape) for k, v in dec["cache"].items()} == {
        "conv": (48, 128, 3, 4096), "ssm": (48, 128, 4096, 16)}
    assert dec["cache"]["ssm"].device.type == "meta"


def test_resolve_device_takes_meta_only_by_name():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def _meta(*ts):
    return [t.to("meta") if torch.is_tensor(t) else t for t in ts]


def _sig(out):
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_entries_meta_path_gives_plain_shapes(dtype):
    g = torch.Generator().manual_seed(0)
    B, L, D, N = 2, 40, 48, 16
    pos = torch.as_tensor(np.tile(np.r_[np.arange(13), np.arange(27)],
                                  (B, 1)), dtype=torch.int32)
    x = torch.randn((B, L, D), generator=g).to(dtype)
    w = torch.randn((4, D), generator=g).to(dtype)
    b = torch.randn((D,), generator=g).to(dtype)
    y = kconv.conv1d_pack(*_meta(x, w, b, pos))
    assert _sig([y]) == _sig([kconv.conv1d_pack(x, w, b, pos)])
    dx = kconv.conv1d_pack_bwd_dx(*_meta(x, w, pos))
    assert _sig([dx]) == _sig([kconv.conv1d_pack_bwd_dx(x, w, pos)])
    u, dl, dy = (torch.rand((B, L, D), generator=g).to(dtype)
                 for _ in range(3))
    Bm, Cm = (torch.randn((B, L, N), generator=g).to(dtype) for _ in "BC")
    At = -torch.rand((N, D), generator=g)
    Dp = torch.ones(D)
    for sched in ksc.SCHEDULES:
        args = (u, dl, At, Bm, Cm, Dp, pos)
        fwd = ksc.selective_scan_fwd(*args, 64, sched)
        assert _sig(ksc.selective_scan_fwd(*_meta(*args), 64, sched)) == \
            _sig(fwd)
        bwd = ksc.selective_scan_bwd(*args, fwd[1], dy, 64, sched)
        assert _sig(ksc.selective_scan_bwd(*_meta(*args, fwd[1], dy), 64,
                                           sched)) == _sig(bwd)
    H, P, Nh = 2, 16, 64
    uh, dyh = (torch.randn((B, L, H, P), generator=g).to(dtype)
               for _ in range(2))
    dh = torch.rand((B, L, H), generator=g).to(dtype)
    Bh, Ch = (torch.randn((B, L, Nh), generator=g).to(dtype) for _ in "BC")
    A, Dh = -torch.rand(H, generator=g), torch.ones(H)
    hargs = (uh, dh, A, Bh, Ch, Dh, pos)
    for sched in kh.SCHEDULES:
        fwd = kh.selective_scan_heads_fwd(*hargs, 16, sched)
        assert _sig(kh.selective_scan_heads_fwd(*_meta(*hargs), 16,
                                                sched)) == _sig(fwd)
    bwd = kh.selective_scan_heads_bwd(*hargs, fwd[1], dyh, 16)
    assert _sig(kh.selective_scan_heads_bwd(*_meta(*hargs, fwd[1], dyh),
                                            16)) == _sig(bwd)
    # a meta path that meets a tensor of another device raises
    with pytest.raises(ValueError, match="several devices"):
        kconv.conv1d_pack(*_meta(x, w, b), pos)
    with pytest.raises(ValueError, match="several devices"):
        ksc.selective_scan_bwd(*_meta(*args, fwd[1].new_zeros(
            (B, 1, N, D))), dy, 64, "blocked")
    with pytest.raises(ValueError, match="several devices"):
        kh.selective_scan_heads_bwd(*_meta(*hargs, fwd[1]), dyh, 16)


def _fill(cell, cfg, kind, seed=0):
    """Real values in a CPU cell: weights from the port's init, a packed
    batch (two segments a row) or a zero cache and valid tokens."""
    cell.model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    if kind == "decode":
        for v in cell.args[0].values():
            v.zero_()
        cell.args[1].copy_(torch.as_tensor(
            rng.integers(1, cfg.vocab, cell.args[1].shape)))
        return
    batch = cell.args[-1]
    B, L = batch["tokens"].shape
    cut = L // 3
    batch["tokens"].copy_(torch.as_tensor(rng.integers(1, cfg.vocab, (B, L))))
    batch["positions"].copy_(torch.as_tensor(
        np.tile(np.r_[np.arange(cut), np.arange(L - cut)], (B, 1))))
    batch["segment_ids"].copy_(torch.as_tensor(
        np.tile(np.r_[np.ones(cut), np.full(L - cut - 5, 2), np.zeros(5)],
                (B, 1))))


@pytest.mark.parametrize("arch,kind,schedule", [
    ("mamba-110m", "train", "blocked"), ("mamba-110m", "train", "step"),
    ("mamba2-370m", "train", None), ("mamba-110m", "prefill", "blocked"),
    ("mamba2-370m", "prefill", None), ("mamba-110m", "decode", "blocked"),
    ("mamba2-370m", "decode", None)])
def test_cpu_step_count_equals_its_meta_dry_run(arch, kind, schedule):
    cfg = get_config(arch).reduced()
    if schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
    B, L = (3, 64) if kind == "decode" else (2, 64)
    meta = shapes.make_cell(cfg, kind, B, L, "meta")
    _, want = count_call(meta.fn, *meta.args, device="meta")
    cpu = shapes.make_cell(cfg, kind, B, L, "cpu")
    _fill(cpu, cfg, kind)
    out, got = count_call(cpu.fn, *cpu.args, device="cpu")
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    n = cfg.n_layers
    conv, dx = CONV_KERNELS
    fwd, bwd = SCAN_KERNELS[schedule] if schedule else \
        HEADS_KERNELS["blocked_heads"]
    tally = {"train": {conv: 2 * n, dx: n, fwd: 2 * n, bwd: n},
             "prefill": {conv: n, fwd: n},
             "decode": {}}[kind]
    assert want["kernels"] == tally
    assert want["flops_by_unit"]["bf16"] > 0 and want["bytes"] > 0
    if kind == "train":
        assert np.isfinite(out[1]["loss"].item())


@pytest.mark.parametrize("knobs,kernels,chunk", [
    ({"backend": "pallas", "schedule": "step", "pchunk": 64},
     SCAN_KERNELS["step"], 64),
    ({"backend": "pallas", "schedule": "blocked", "pchunk": 32},
     SCAN_KERNELS["blocked"], 32)])
def test_train_cell_takes_a_tuning_winner(knobs, kernels, chunk):
    """A winner's knobs reach the scans through their ``tune=`` path: its
    schedule's kernels run, charged at its chunk, on the meta device and
    the CPU alike, where the config says ``blocked`` at chunk 64."""
    cfg = dataclasses.replace(get_config("mamba-110m").reduced(),
                              pallas_schedule="blocked")
    B, L = 2, 64
    meta = shapes.make_cell(cfg, "train", B, L, "meta", knobs)
    _, want = count_call(meta.fn, *meta.args, device="meta")
    cpu = shapes.make_cell(cfg, "train", B, L, "cpu", knobs)
    _fill(cpu, cfg, "train")
    _, got = count_call(cpu.fn, *cpu.args, device="cpu")
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    fwd, bwd = kernels
    n = cfg.n_layers
    assert {k: v for k, v in want["kernels"].items()
            if k not in CONV_KERNELS} == {fwd: 2 * n, bwd: n}
    u = torch.empty((B, L, cfg.d_inner), dtype=torch.bfloat16, device="meta")
    assert want["traffic_by_op"][fwd] == 2 * n * kernel_work(
        fwd, u, cfg.d_state, chunk).bytes
    with pytest.raises(ValueError, match="train cell only"):
        shapes.make_cell(cfg, "prefill", B, L, "meta", knobs)


def test_build_cell_is_make_cell_at_the_shape():
    cell = shapes.build_cell(get_config("mamba-1.4b"), "decode_32k")
    assert cell.meta["kind"] == "decode" and cell.meta["batch"] == 128
    assert cell.meta["fn_name"] == "serve_step"
    assert cell.model.device.type == "meta"


def test_full_width_train_dry_run_takes_seconds():
    t0 = time.perf_counter()
    rec = dryrun.count_step(get_config("mamba-1.4b"), "train", 256, 4096,
                            dryrun.peaks_for(H100))
    assert time.perf_counter() - t0 < 60
    assert rec["kernels"] == {"conv1d_pack_fwd": 96, "conv1d_pack_bwd_dx": 48,
                              "selective_scan_fwd": 96,
                              "selective_scan_bwd": 48}
    rl = rec["roofline"]
    assert rl["model_flops"] == jan.model_flops_per_step(
        jget_config("mamba-1.4b"), "train", 256, 4096)
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0
    assert rl["t_collective_s"] == 0.0
    assert rec["memory"]["argument_size_in_bytes"] == (
        3 * 4 * jan.active_params(jget_config("mamba-1.4b"))
        + 3 * 4 * 256 * 4096)


def test_records_and_report(tmp_path):
    out = str(tmp_path)
    ok = dryrun.run_cell("mamba2-370m", "train_4k", out,
                         overrides={"n_layers": 2}, card=H100)
    assert ok["status"] == "ok", ok.get("trace")
    for k in ("arch", "shape", "mesh", "chips", "flops_per_device",
              "bytes_per_device", "traffic_by_op", "memory", "roofline",
              "build_s", "count_s"):
        assert k in ok, k
    assert ok["mesh"] == "1xH100" and ok["chips"] == 1
    assert set(ok["memory"]) == {"argument_size_in_bytes",
                                 "temp_size_in_bytes"}
    jcfg = dataclasses.replace(jget_config("mamba2-370m"), n_layers=2)
    assert ok["roofline"]["model_flops"] == jan.model_flops_per_step(
        jcfg, "train", 256, 4096)
    assert set(ok["traffic_by_op"]) == {
        "matmul", "other", "conv1d_pack_fwd", "conv1d_pack_bwd_dx",
        "selective_scan_heads_fwd", "selective_scan_heads_bwd"}
    skip = dryrun.run_cell("mixtral-8x22b", "train_4k", out, card=H100)
    assert skip["status"] == "skip" and "queue 1 item 5" in skip["reason"]
    assert sorted(os.listdir(out)) == [
        "mamba2-370m__train_4k__1xH100.json",
        "mixtral-8x22b__train_4k__1xH100.json"]
    with open(os.path.join(out, "mamba2-370m__train_4k__1xH100.json")) as f:
        assert json.load(f)["status"] == "ok"
    with pytest.raises(KeyError, match="no peaks"):
        dryrun.run_cell("mamba-110m", "train_4k", None,
                        card="NVIDIA A100-SXM4-80GB")
    table = report.baseline(out).splitlines()
    assert len(table) == 3 and table[2].startswith(
        "| mamba2-370m | train_4k | memory |")
    assert table[2].endswith("| **NO** |")      # 256 × 4096 needs > 80 GB
    assert "mixtral-8x22b" in report.skips(out)
    kt = report.kernel(out).splitlines()
    assert len(kt) == 3 and kt[2].startswith("| mamba2-370m |")


def test_cli_lists_and_names_no_mesh(capsys):
    dryrun.main(["--paper", "--list", "--shape", "train_4k", "long_500k"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * 14
    # the four paper configs and xlstm-125m run; the other nine are skips
    assert sum("RUN" in ln for ln in lines) == 2 * 5
    assert sum(ln.startswith("xlstm-125m") and "RUN" in ln
               for ln in lines) == 2
    with pytest.raises(SystemExit):
        dryrun.main(["--help"])
    assert "--mesh has no counterpart" in " ".join(
        capsys.readouterr().out.split())


def test_prefill_logits_match_jax():
    jcfg = jget_config("mamba-110m").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    rng = np.random.default_rng(3)
    B, L = 2, 32
    seg = np.zeros((B, L), np.int32)
    seg[0, :20], seg[1, :32] = 1, 1
    pos = np.where(seg > 0, np.arange(L)[None], 0).astype(np.int32)
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, L)).astype(np.int32)
             * (seg > 0), "positions": pos, "segment_ids": seg}
    want = np.asarray(jmodel.prefill_logits(jparams, batch))
    got = model.prefill_logits(batch).numpy()
    assert got.shape == want.shape == (B, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
