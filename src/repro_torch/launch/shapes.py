"""Input shapes × the port's configs for the dry run (port of
``repro.launch.shapes``): meta tensors in place of ShapeDtypeStructs, and
the step function of every cell.

Shapes (per assignment):
  train_4k     seq 4,096   global_batch 256   → train_step
  prefill_32k  seq 32,768  global_batch 32    → prefill (packed fwd → logits)
  decode_32k   seq 32,768  global_batch 128   → serve_step (1 token)
  long_500k    seq 524,288 global_batch 1     → serve_step (sub-quadratic only)

Skip rules (the JAX ``cell_supported``): encoder-only archs have no
decode; long_500k runs only for sub-quadratic archs, whose decode state
is O(1) in the context or bounded by an attention window. The Mamba and
xLSTM configs are recurrent and recurrentgemma-2b's attention is windowed
at 2048, so each of the four shapes runs on each of them; the dense
configs' full attention is quadratic, so their long_500k is skipped and
the other three shapes run.

The cells run through the port's own entry points: train through
``train.trainer.make_train_step`` and ``AdamW``, prefill through
``LM.prefill_logits``, decode through ``LM.decode_step`` on
``LM.init_cache(batch, seq)`` with a ``cache_len`` (B,) of zeros, as the
JAX ``serve_step`` (a hybrid's K/V ring is min(seq, attn_window) slots,
a dense model's ``seq``: deepseek-67b's decode_32k cache is 128 rows × 95
layers × k and v × 32768 × 8 × 128 bf16, 1.9 TiB, never allocated on the
meta device; the other kinds' states do not depend on ``seq``).
Gradient accumulation is not counted: ``make_train_step``'s ``accum`` > 1
splits the batch through numpy, which a meta tensor cannot enter, so a
train cell's step takes ``accum`` = 1, the JAX ``run_cell``'s default.
A train cell can take a tuning winner's scan knobs (``knobs``), as a tuned
step on the card takes them from its cache.

No counterpart here: the shardings (``_ns``, ``_resolve_act_pspec``, the
in/out shardings of a ``Cell``), since the port runs on one card; and the
audio and VLM batch leaves, which wait for slice 7 (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import AdamW, constant_schedule
from repro_torch.train.trainer import make_train_step
from repro_torch.tune import (TuneCache, config_shape_args, fingerprint,
                              shape_key)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
# layer kinds whose decode state is O(1) in the context length
RECURRENT_KINDS = {"mamba", "mamba2", "rec", "mlstm", "slstm"}


def sub_quadratic(cfg: ArchConfig) -> bool:
    """The JAX ``ArchConfig.sub_quadratic``: every kind recurrent, or the
    attention windowed."""
    return set(cfg.unit) <= RECURRENT_KINDS or cfg.attn_window is not None


def cell_supported(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    s = SHAPES[shape_name]
    if s["kind"] == "decode" and shape_name == "long_500k" and \
            not sub_quadratic(cfg):
        return False, "full attention: 500k decode is quadratic-regime"
    return True, ""


# ---------------------------------------------------------------------------
# input specs (meta tensors — never allocated)
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ArchConfig, batch: int, seq: int,
                      device="meta") -> Dict[str, torch.Tensor]:
    def i32():
        return torch.empty((batch, seq), dtype=torch.int32, device=device)
    return {"tokens": i32(), "positions": i32(), "segment_ids": i32()}


def _serving(cfg: ArchConfig) -> ArchConfig:
    """Serving runs bf16 activations on bf16 weights."""
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")


def input_specs(cfg: ArchConfig, shape_name: str,
                device="meta") -> Dict[str, Any]:
    """Meta stand-ins for every model input of the given cell."""
    s = SHAPES[shape_name]
    if s["kind"] in ("train", "prefill"):
        return train_batch_specs(cfg, s["batch"], s["seq"], device)
    return _decode_inputs(LM(_serving(cfg), device), s["batch"], s["seq"])


def _decode_inputs(model: LM, batch: int, seq: int) -> Dict[str, Any]:
    return {"cache": model.init_cache(batch, seq),
            "tokens_t": torch.empty((batch, 1), dtype=torch.int32,
                                    device=model.device),
            "cache_len": torch.zeros((batch,), dtype=torch.int32,
                                     device=model.device)}


# ---------------------------------------------------------------------------
# cell builders: (fn, example_args, meta)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    fn: Any
    args: Tuple
    meta: Dict[str, Any]
    model: Optional[LM] = None       # the LM ``fn`` runs


def _argument_bytes(args) -> int:
    """Bytes of every tensor in ``args``, each storage once."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if torch.is_tensor(x):
            key = x.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(args)
    return total


def _winner_cache(cfg: ArchConfig, batch: int, seq: int, knobs,
                  device) -> TuneCache:
    """A tuning cache of ``device`` that holds one entry, ``knobs``, at
    ``cfg``'s scan call at ``batch`` × ``seq`` (its dtype and
    ``tune_objective``; the batch's positions are given)."""
    args = config_shape_args(cfg, batch, seq)
    cache = TuneCache(fp=fingerprint(device))
    cache.put(shape_key(args.pop("op"), objective=cfg.tune_objective,
                        **args), knobs, 0.0, kernels=True)
    return cache


def train_cell(cfg: ArchConfig, batch: int, seq: int, device="meta",
               knobs: Optional[Dict] = None) -> Cell:
    """One training step at ``cfg`` (bf16 activations on its param dtype),
    ``batch`` × ``seq`` packed, with the step's whole state as arguments:
    the parameters, AdamW's m, v (and f32 masters when the parameters are
    stored in less) and the batch. ``knobs``: a tuning winner's scan knobs
    (``tune.tuned``'s result at this shape), which the scans then resolve
    through their ``tune=`` path (``cfg.scan_tune``) as on the card; None
    keeps ``cfg``'s own."""
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if knobs is not None:
        cfg = dataclasses.replace(cfg, scan_tune=_winner_cache(
            cfg, batch, seq, knobs, device))
    model = LM(cfg, device)
    opt = AdamW(constant_schedule(1e-4))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    args = (state, train_batch_specs(cfg, batch, seq, device))
    return Cell(fn=make_train_step(model, opt), args=args,
                meta={"kind": "train", "batch": batch, "seq": seq,
                      "fn_name": "train_step",
                      "argument_bytes": _argument_bytes(args)}, model=model)


def prefill_cell(cfg: ArchConfig, batch: int, seq: int,
                 device="meta") -> Cell:
    model = LM(_serving(cfg), device)
    args = (train_batch_specs(cfg, batch, seq, device),)
    return Cell(fn=model.prefill_logits, args=args,
                meta={"kind": "prefill", "batch": batch, "seq": seq,
                      "fn_name": "prefill",
                      "argument_bytes": _argument_bytes(
                          (dict(model.named_parameters()), args))},
                model=model)


def decode_cell(cfg: ArchConfig, batch: int, seq: int,
                device="meta") -> Cell:
    model = LM(_serving(cfg), device)
    ins = _decode_inputs(model, batch, seq)
    args = (ins["cache"], ins["tokens_t"], ins["cache_len"])

    def serve_step(cache, tokens_t, cache_len):
        return model.decode_step(cache, tokens_t, cache_len=cache_len)

    return Cell(fn=serve_step, args=args,
                meta={"kind": "decode", "batch": batch, "seq": seq,
                      "fn_name": "serve_step",
                      "argument_bytes": _argument_bytes(
                          (dict(model.named_parameters()), args))},
                model=model)


def make_cell(cfg: ArchConfig, kind: str, batch: int, seq: int,
              device="meta", knobs: Optional[Dict] = None) -> Cell:
    """The cell of ``kind`` ("train" | "prefill" | "decode") at any
    ``batch`` × ``seq``; ``knobs``: ``train_cell``'s."""
    if kind == "train":
        return train_cell(cfg, batch, seq, device, knobs)
    if knobs is not None:
        raise ValueError("scan knobs are taken by the train cell only")
    if kind == "prefill":
        return prefill_cell(cfg, batch, seq, device)
    if kind == "decode":
        return decode_cell(cfg, batch, seq, device)
    raise ValueError(f"unknown cell kind {kind!r}")


def build_cell(cfg: ArchConfig, shape_name: str, device="meta") -> Cell:
    s = SHAPES[shape_name]
    return make_cell(cfg, s["kind"], s["batch"], s["seq"], device)
