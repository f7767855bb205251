"""The port's xLSTM training on the CPU beyond the JAX parity files
(slice 7b), with nothing of JAX compiled:

* the subgradient conventions are not the gradient gap to JAX: the
  recurrences' clamps in jnp.clip's tie-splitting form move the port's
  gradient by under 1e-5 of a leaf's scale, where the port and the JAX
  package differ by ~1e-4 (``tests/test_torch_xlstm_train.py``);
* no gradient crosses a reset: the loss of a row's second segment has a
  gradient of exactly 0 (≤ 1e-7) with respect to its first segment's
  inputs, through an mLSTM block, an sLSTM block and the whole 12-layer
  stack under ``remat="unit"``, and every one is finite;
* kill and resume on the xLSTM tree (8 layers: one unit and 2 tail
  layers): 4 straight steps equal 2 steps, a checkpoint, a new trainer
  (another init seed) that restores it and 2 more, every loss and the
  final parameters, m, v and step bitwise; the checkpoint names each
  layer's leaves (``params/layers.<i>.<leaf>``, ``opt/m/…``);
* the dry run's count of an xLSTM train cell: xlstm-125m.reduced() (12
  layers) at 2 × 32 counted on the meta device equals the same step
  counted on the CPU through the plain kernels, in FLOPs by unit, bytes,
  traffic by op and kernel tally, and the tally is #1 twice (forward and
  ``remat`` recompute) and #2 once per mLSTM layer;
* the launcher: ``--arch xlstm-125m --tiny`` trains on the CPU, its layers
  those the JAX launcher's ``--tiny`` builds (4 layers, fewer than the
  6-layer unit: 4 tail mLSTM layers, no sLSTM), and ``--scan-tune`` is a
  no-op, as the JAX ``warm_for_config`` is for a config with no scan.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from _xlstm_train import (LAYERS, configs, leaf_gaps, one_thread,  # noqa
                          packed_batch, port_model)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.kernels.ops import CONV_KERNELS  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.roofline.counter import count_call  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
EXACT = ("flops", "flops_by_unit", "bytes", "traffic_by_op", "kernels")


def _trainer(ckpt_dir, steps, every):
    cfg, _ = configs(LAYERS["unit_plus_tail"])
    loader = PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                           LoaderConfig(rows=2, seq_len=64, mode="pack"))
    return Trainer(LM(cfg, "cpu"),
                   adamw.AdamW(adamw.cosine_schedule(1e-3, 1, 4)), loader,
                   TrainerConfig(steps=steps, log_every=100,
                                 ckpt_every=every, ckpt_dir=ckpt_dir))


def test_resume_is_bitwise_the_straight_run(tmp_path):
    state_a, hist_a = _trainer(None, 4, 0).train(
        torch.Generator().manual_seed(7), verbose=False)
    d = str(tmp_path)
    _trainer(d, 2, 2).train(torch.Generator().manual_seed(7), verbose=False)
    with open(os.path.join(d, "step_2", "manifest.json")) as f:
        names = json.dumps(json.load(f))
    for leaf in ("params/layers.7.w_if", "opt/m/layers.5.R",
                 "opt/v/layers.0.conv_w"):
        assert leaf in names, leaf
    state_b, hist_b = _trainer(d, 4, 0).train(
        torch.Generator().manual_seed(999), verbose=False)
    assert [h["loss"] for h in hist_a[2:]] == [h["loss"] for h in hist_b]
    pa, pb = state_a["params"], state_b["params"]
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    oa, ob = state_a["opt"], state_b["opt"]
    assert oa.step == ob.step == 4
    for x, y in ((oa.m, ob.m), (oa.v, ob.v)):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_cpu_train_count_equals_its_meta_dry_run():
    cfg = get_config("xlstm-125m").reduced()
    B, L = 2, 32
    meta = shapes.make_cell(cfg, "train", B, L, "meta")
    _, want = count_call(meta.fn, *meta.args, device="meta")
    cpu = shapes.make_cell(cfg, "train", B, L, "cpu")
    cpu.model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = cpu.args[-1]
    batch["tokens"].copy_(torch.as_tensor(rng.integers(1, cfg.vocab,
                                                       (B, L))))
    batch["positions"].copy_(torch.as_tensor(
        np.tile(np.r_[np.arange(12), np.arange(L - 12)], (B, 1))))
    batch["segment_ids"].copy_(torch.as_tensor(
        np.tile(np.r_[np.ones(12), np.full(L - 15, 2), np.zeros(3)],
                (B, 1))))
    out, got = count_call(cpu.fn, *cpu.args, device="cpu")
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    n_mlstm = sum(k == "mlstm" for k in cpu.model.kinds)
    assert n_mlstm == 10
    assert want["kernels"] == dict(zip(CONV_KERNELS, (2 * n_mlstm, n_mlstm)))
    assert np.isfinite(out[1]["loss"].item())


def test_cli_tiny_xlstm_trains_with_the_jax_tiny_layers(capsys, tmp_path):
    from repro.configs.base import get_config as jget_config
    from repro.models.lm import build_model
    tiny = dict(d_model=128, n_layers=4, vocab=512, dtype="float32",
                scan_chunk=64)
    jm = build_model(dataclasses.replace(jget_config("xlstm-125m"), **tiny))
    assert (jm.n_units, jm.n_tail) == (0, 4)
    assert LM(dataclasses.replace(get_config("xlstm-125m"), **tiny),
              "meta").kinds == tuple(k for _, k in jm.tail_layout) == \
        ("mlstm",) * 4
    cache = tmp_path / "tune.json"
    hist = ttrain.main(["--arch", "xlstm-125m", "--tiny", "--device", "cpu",
                        "--steps", "2", "--rows", "2", "--seq-len", "64",
                        "--scan-tune", str(cache)])
    out = capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert '"arch": "xlstm-125m"' in out and not cache.exists()


def _jnp_clip(x, min=None, max=None):
    """jnp.clip's form, min(max(x, lo), hi): a tie at a bound splits the
    gradient, where torch.clamp passes all of it."""
    if min is not None:
        x = torch.maximum(x, torch.full_like(x, min))
    if max is not None:
        x = torch.minimum(x, torch.full_like(x, max))
    return x


def test_the_clip_subgradient_is_not_the_gap(monkeypatch):
    """The recurrences' clamps (the only ``torch.clamp`` calls on the
    training path) in jnp.clip's form move the port's gradient by under
    1e-5 of each leaf's scale (the largest printed), where the port and
    the JAX package differ by ~1e-4 and the JAX package differs from
    itself by as much between scan chunks: the gap is f32 rounding, not a
    subgradient convention."""
    cfg, _ = configs(LAYERS["units"])
    model = port_model(cfg, 0)
    batch = packed_batch(0)
    params = dict(model.named_parameters())

    def grads():
        loss, _ = model.loss(batch)
        return {k: g.numpy() for k, g in zip(params, torch.autograd.grad(
            loss, list(params.values())))}

    ours = grads()
    monkeypatch.setattr(torch, "clamp", _jnp_clip)
    gap = leaf_gaps(grads(), ours)
    worst = max(gap, key=gap.get)
    print(f"jnp.clip's subgradient against torch.clamp's: {gap[worst]:.3e} "
          f"of max |g| at {worst}")
    assert gap[worst] <= 1e-5


def _segment_loss(out, batch, s, row_weights):
    """A loss on segment ``s``'s outputs alone."""
    keep = torch.as_tensor(batch["segment_ids"] == s)[..., None]
    return (out * row_weights * keep).sum()


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "stack"])
def test_no_gradient_crosses_a_reset(kind):
    """d(loss of segment 2) / d(inputs of segment 1) is exactly 0: through
    one block of each kind (their recurrences and, for the mLSTM, #1's
    plain version on the CPU) and through the 12-layer stack under
    ``remat="unit"`` with the next-token loss of segment 2."""
    cfg, _ = configs(LAYERS["units"])
    batch = packed_batch(seed=5)
    ctx = blocks.Ctx(positions=torch.as_tensor(batch["positions"]),
                     segment_ids=torch.as_tensor(batch["segment_ids"]))
    g = torch.Generator().manual_seed(5)
    if kind == "stack":
        model = port_model(cfg, 5)
        x = model._embed(torch.as_tensor(batch["tokens"])).detach()
        x.requires_grad_(True)
        h = model._stack(x, ctx)
        tok = torch.as_tensor(batch["tokens"]).long()
        seg = torch.as_tensor(batch["segment_ids"])
        nxt = (seg[:, 1:] == 2) & (seg[:, :-1] == 2)
        labels = torch.where(nxt, tok[:, 1:], -1)
        loss = F.cross_entropy(model._logits(h[:, :-1]).transpose(1, 2),
                               labels, ignore_index=-1, reduction="sum")
    else:
        p = blocks.KINDS[kind][0](cfg, g, "cpu")
        x = torch.randn((2, 64, cfg.d_model), generator=g,
                        requires_grad=True)
        out = blocks.KINDS[kind][2](p, x, ctx, cfg)
        loss = _segment_loss(out, batch, 2, torch.randn(
            out.shape[1:], generator=g))
    (dx,) = torch.autograd.grad(loss, x)
    assert bool(torch.isfinite(dx).all())
    seg = torch.as_tensor(batch["segment_ids"])
    assert dx[seg == 1].abs().max().item() <= 1e-7
    assert dx[seg == 2].abs().max().item() > 0
