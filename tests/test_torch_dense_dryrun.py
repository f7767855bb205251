"""The dry run on the dense family (``launch/shapes.py``,
``launch/dryrun.py``, ``roofline/counter.py``) on the CPU:

* a reduced stablelm-1.6b train, prefill and decode step counted on the
  CPU equals its meta dry run exactly (FLOPs by unit, bytes, traffic by
  op) and launches no kernel of the port's own: a dense layer is plain
  PyTorch;
* ``cell_supported`` is the JAX rule on the four dense configs: train_4k,
  prefill_32k and decode_32k run, long_500k is skipped as quadratic;
* one full-width cell's record: stablelm-1.6b's decode_32k, its cache the
  whole 32768-token context of 128 rows on the meta device (never
  allocated), model FLOPs equal to JAX's and a report row that does not
  fit the card; its long_500k a ``skip`` record with JAX's reason.

Full-size deepseek-* cells are not counted here (a minute or more each on
the meta device); ``python -m repro_torch.launch.dryrun --arch
deepseek-67b`` counts them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _dense import DENSE  # noqa: E402
from _threads import one_thread  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.counter import count_call  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

H100 = "NVIDIA H100 80GB HBM3"
EXACT = ("flops", "flops_by_unit", "bytes", "traffic_by_op", "kernels")


def _fill(cell, cfg, kind):
    """Real values in a CPU cell: weights from the port's init; two
    segments a row and 5 padding tokens (train, prefill); a zero cache,
    tokens and cache_len 7 (decode)."""
    cell.model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    if kind == "decode":
        for v in cell.args[0].values():
            v.zero_()
        cell.args[1].copy_(torch.as_tensor(
            rng.integers(1, cfg.vocab, cell.args[1].shape)))
        cell.args[2].fill_(7)
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


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cpu_step_count_equals_its_meta_dry_run(kind):
    cfg = get_config("stablelm-1.6b").reduced()
    B, L = (3, 64) if kind == "decode" else (2, 64)
    meta = shapes.make_cell(cfg, kind, B, L, "meta")
    _, want = count_call(meta.fn, *meta.args, device="meta")
    cpu = shapes.make_cell(cfg, kind, B, L, "cpu")
    _fill(cpu, cfg, kind)
    out, got = count_call(cpu.fn, *cpu.args, device="cpu")
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    assert want["kernels"] == {}
    assert want["flops_by_unit"]["bf16"] > 0 and want["bytes"] > 0
    if kind == "train":
        assert np.isfinite(out[1]["loss"].item())
    else:
        logits = out if kind == "prefill" else out[0]
        assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
    if kind == "decode":
        assert tuple(cpu.args[0]["0_attn.k"].shape[:3]) == (2, B, L)


@pytest.mark.parametrize("arch", DENSE)
def test_cell_supported_is_the_jax_rule(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for s in shapes.SHAPES:
        assert shapes.cell_supported(cfg, s) == \
            jshapes.cell_supported(jcfg, s)
        assert dryrun._supported(arch, s)[0] == (s != "long_500k")
    assert dryrun.skip_reason(arch) is None


def test_full_width_decode_cell_record(tmp_path):
    out = str(tmp_path)
    rec = dryrun.run_cell("stablelm-1.6b", "decode_32k", out, card=H100)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["kernels"] == {} and rec["fn"] == "serve_step"
    jcfg = jget_config("stablelm-1.6b")
    assert rec["roofline"]["model_flops"] == jan.model_flops_per_step(
        jcfg, "decode", 128, 32768)
    # the cache: 128 rows × 24 layers × k, v × 32768 × 32 × 64 bf16
    cache = 128 * 24 * 2 * 32768 * 32 * 64 * 2
    assert rec["memory"]["argument_size_in_bytes"] > cache
    assert rec["roofline"]["dominant"] == "memory"
    skip = dryrun.run_cell("stablelm-1.6b", "long_500k", out, card=H100)
    assert skip["status"] == "skip" and "quadratic" in skip["reason"]
    table = report.baseline(out).splitlines()
    assert len(table) == 3 and table[2].startswith(
        "| stablelm-1.6b | decode_32k | memory |")
    assert table[2].endswith("| **NO** |")
    assert "stablelm-1.6b" in report.skips(out)
    small = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=1)
    one = dryrun.count_step(small, "decode", 2, 256,
                            dryrun.peaks_for(H100))
    assert one["kernels"] == {} and one["bytes_per_device"] > 0
