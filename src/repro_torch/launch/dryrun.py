"""Dry run of the port on one card: build every (architecture × shape)
cell on the meta device, run its step once under the step counter, and
write the JAX dry run's record for it (port of the single-card part of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba-1.4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --paper
  PYTHONPATH=src python -m repro_torch.launch.dryrun --paper --list

Nothing is allocated and no card is needed: the cell's tensors live on the
meta device, where every kernel wrapper returns outputs of the right
shapes and computes nothing. The step counter (``roofline/counter.py``)
tallies the step's aten ops and charges each kernel call by its model
(``roofline/kernel_model.py``), so the count is the one the same step
gives on the card. The record (``status``, ``arch``, ``shape``, ``mesh``,
``chips``, ``flops_per_device``, ``bytes_per_device``, ``traffic_by_op``,
``memory``, ``roofline``, the timings) is read against the peaks of the
card named by ``--card`` (default: the card this process sees; with none,
name one), and ``mesh`` is that card's short name, ``1xH100``.

``memory``: ``argument_size_in_bytes`` is exact from the shapes (the
parameters, AdamW's m and v, and the batch for a train step; the
parameters and the inputs otherwise); ``temp_size_in_bytes`` is the peak of
the live bytes the step creates, as the counter tracks them.

The JAX ``ASSIGNED`` configs the port lacks wait for slice 7 (ROADMAP
queue 1 item 5): their cells get a ``skip`` record, not an error. The one
it has, xlstm-125m, is counted like the Mamba configs. Its sLSTM is a
Python loop over time, and the meta device runs each of its ops through
Python, so its train and prefill cells take minutes of host time, where
a Mamba cell takes seconds. Unlike the JAX module, this one sets no
``XLA_FLAGS`` and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs import load_all
from repro_torch.configs.base import REGISTRY, get_config
from repro_torch.launch.shapes import SHAPES, cell_supported, make_cell
from repro_torch.roofline.analysis import (SHORT_NAMES, Roofline,
                                           model_flops_per_step, peaks_for)
from repro_torch.roofline.counter import count_call

ASSIGNED = [
    "recurrentgemma-2b", "stablelm-1.6b", "deepseek-coder-33b", "gemma-7b",
    "deepseek-67b", "hubert-xlarge", "mixtral-8x22b", "moonshot-v1-16b-a3b",
    "qwen2-vl-2b", "xlstm-125m",
]
PAPER = ["mamba-110m", "mamba-1.4b", "mamba-2.8b", "mamba2-370m"]
NOT_PORTED = ("not in the port: the non-Mamba block kinds and their configs "
              "wait for slice 7 (ROADMAP queue 1 item 5)")


def skip_reason(arch: str) -> Optional[str]:
    """Why ``arch``'s cells are skipped whatever the shape, or None when
    they run: a config the port registers runs, anything else is not in
    the port."""
    if arch in PAPER:
        return None
    load_all()
    return None if arch in REGISTRY else NOT_PORTED


def card_name(card: Optional[str] = None) -> str:
    """``card``, else the name of the card this process sees; raises with
    neither (the dry run reads no card's peaks in place of another's)."""
    if card is not None:
        return card
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no card to read the peaks of: name one "
                           "(--card / card=), e.g. 'NVIDIA H100 80GB HBM3'")
    return torch.cuda.get_device_name(0)


def mesh_name(card: str) -> str:
    peaks_for(card)                       # an unknown card raises here
    return f"1x{SHORT_NAMES[card]}"


def count_step(cfg, kind: str, batch: int, seq: int, peaks,
               knobs=None) -> dict:
    """The core of a cell: build ``kind``'s step for ``cfg`` at ``batch``
    × ``seq`` on the meta device (a train step with the tuning winner
    ``knobs``, when given: ``shapes.train_cell``), run it once under the
    step counter and read the count against ``peaks``. Returns the
    record's measured part."""
    t0 = time.perf_counter()
    cell = make_cell(cfg, kind, batch, seq, "meta", knobs)
    t_build = time.perf_counter() - t0
    _, tot = count_call(cell.fn, *cell.args, device="meta")
    t_count = time.perf_counter() - t0 - t_build
    rl = Roofline(flops=tot["flops"], hbm_bytes=tot["bytes"], coll_bytes=0.0,
                  chips=1, peaks=peaks,
                  model_flops=model_flops_per_step(cfg, kind, batch, seq),
                  flops_by_unit=tot["flops_by_unit"])
    return {"fn": cell.meta["fn_name"], "chips": 1,
            "build_s": round(t_build, 3), "count_s": round(t_count, 3),
            "flops_per_device": tot["flops"],
            "flops_by_unit": tot["flops_by_unit"],
            "bytes_per_device": tot["bytes"],
            "traffic_by_op": tot["traffic_by_op"],
            "kernels": tot["kernels"],
            "memory": {"argument_size_in_bytes": cell.meta["argument_bytes"],
                       "temp_size_in_bytes": tot["peak_bytes"]},
            "roofline": rl.to_dict()}


def run_cell(arch: str, shape: str, out_dir: Optional[str],
             overrides=None, card: Optional[str] = None) -> dict:
    card = card_name(card)
    mesh = mesh_name(card)
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "card": card,
           "status": "skip", "reason": skip_reason(arch)}
    if rec["reason"] is None:
        cfg = get_config(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        ok, why = cell_supported(cfg, shape)
        rec["reason"] = why
        if ok:
            t0 = time.perf_counter()
            s = SHAPES[shape]
            try:
                rec.update(status="ok", **count_step(
                    cfg, s["kind"], s["batch"], s["seq"], peaks_for(card)))
                del rec["reason"]
            except Exception as e:             # noqa: BLE001 — sweep robust
                rec.update(status="error", error=f"{type(e).__name__}: {e}",
                           trace=traceback.format_exc()[-2000:],
                           elapsed_s=round(time.perf_counter() - t0, 1))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def _supported(arch, shape):
    why = skip_reason(arch)
    if why is not None:
        return False, why
    return cell_supported(get_config(arch), shape)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run of the port's cells on the meta device.",
        epilog="The JAX dry run's --mesh has no counterpart: the port runs "
               "on one card, and a record's mesh is that card (1xH100).")
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs (+ paper mamba sizes)")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--card", default=None,
                    help="the card whose peaks the records are read "
                         "against, by torch.cuda.get_device_name() (default: "
                         "the card present)")
    args = ap.parse_args(argv)

    archs = args.arch or (ASSIGNED + (PAPER if args.paper else [])
                          if args.all or args.arch is None else [])
    if args.list:
        for a in archs:
            for s in args.shape:
                ok, why = _supported(a, s)
                print(f"{a:24s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return
    card = card_name(args.card)
    mesh = mesh_name(card)
    for a in archs:
        for s in args.shape:
            path = os.path.join(args.out, f"{a}__{s}__{mesh}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip-existing] {a} {s} {mesh}")
                continue
            rec = run_cell(a, s, args.out, card=card)
            if rec["status"] == "ok":
                rl = rec["roofline"]
                print(f"[ok] {a} {s} {mesh}: count {rec['count_s']}s "
                      f"dom={rl['dominant']} "
                      f"frac={rl['roofline_fraction']:.3f} "
                      f"mem={rec['memory']['temp_size_in_bytes'] / 2**30:.2f}"
                      f"GiB")
            elif rec["status"] == "skip":
                print(f"[skip] {a} {s} {mesh}: {rec['reason']}")
            else:
                print(f"[ERR] {a} {s} {mesh}: {rec['error']}")


if __name__ == "__main__":
    main()
