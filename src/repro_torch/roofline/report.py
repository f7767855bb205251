"""Render the port's dry-run tables from its records (port of
``repro.roofline.report``).

  PYTHONPATH=src python -m repro_torch.roofline.report baseline [DIR]
  PYTHONPATH=src python -m repro_torch.roofline.report skips [DIR]
  PYTHONPATH=src python -m repro_torch.roofline.report kernel [DIR]

DIR defaults to ``experiments/dryrun_torch`` (``launch/dryrun.py --out``).

* ``baseline``: one row per ``ok`` record. ``fits`` is temp + argument
  bytes below the memory of the record's card (``analysis.PEAKS``), not the
  v5e's 16 GiB.
* ``skips``: the skipped cells and why.
* ``kernel``: for each Mamba config at ``train_4k``, the bytes the dry run
  charged to the kernels (``kernel_model``, by kernel name) and their
  ``t_memory`` on the card, beside the analytic scan-path traffic
  (``mamba_scan_traffic_per_device``; Mamba-1's formula, so none for the
  Mamba-2 config) and the whole step's ``t_memory``. There is no XLA-scan
  projection, as the JAX table has: the port already runs the kernels.

``opt`` and ``multipod`` need ``launch/perf.py`` and the multi-pod mesh;
they stay with slice 8 (ROADMAP queue 1 item 6).
"""
import json
import os
import sys

from repro_torch.roofline.analysis import peaks_for
from repro_torch.roofline.kernel_model import (
    KERNEL_WORK, mamba_scan_traffic_per_device)

DEFAULT_DIR = "experiments/dryrun_torch"


def _load(d):
    out = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                rec = json.load(f)
            out[(rec["arch"], rec["shape"], rec.get("mesh", ""))] = rec
    return out


def _fmt_row(rec):
    rl = rec["roofline"]
    mem = rec["memory"]
    temp = mem["temp_size_in_bytes"]
    need = temp + mem["argument_size_in_bytes"]
    fits = need < peaks_for(rec["card"])["hbm_bytes"]
    cols = [rec["arch"], rec["shape"], rl["dominant"],
            f"{rl['t_compute_s'] * 1e3:.1f}",
            f"{rl['t_memory_s'] * 1e3:.1f}",
            f"{rl['t_collective_s'] * 1e3:.1f}",
            f"{(rl['useful_flops_ratio'] or 0):.2f}",
            f"{rl['roofline_fraction']:.4f}",
            f"{temp / 2 ** 30:.1f}", f"{need / 2 ** 30:.1f}",
            "yes" if fits else "**NO**"]
    return "| " + " | ".join(str(c) for c in cols) + " |"


def baseline(d=DEFAULT_DIR) -> str:
    """The roofline of every ``ok`` record."""
    recs = _load(d)
    lines = ["| arch | shape | dominant | comp ms | mem ms | coll ms | "
             "useful | frac | tempGiB | temp+arg GiB | fits |",
             "|---|---|---|---:|---:|---:|---:|---:|---:|---:|---|"]
    for key in sorted(recs):
        rec = recs[key]
        if rec.get("status") == "ok":
            lines.append(_fmt_row(rec))
    return "\n".join(lines)


def skips(d=DEFAULT_DIR) -> str:
    recs = _load(d)
    return "\n".join(f"| {r['arch']} | {r['shape']} | {r['reason']} |"
                     for _, r in sorted(recs.items())
                     if r.get("status") == "skip")


def kernel(d=DEFAULT_DIR) -> str:
    """The kernel path's bytes at ``train_4k`` (module docstring)."""
    from repro_torch.configs.base import get_config
    recs = _load(d)
    lines = ["| arch | kernel GB | kernel mem ms | analytic scan-path GB | "
             "analytic mem ms | step mem ms | kernel share |",
             "|---|---:|---:|---:|---:|---:|---:|"]
    for key in sorted(recs):
        rec = recs[key]
        if key[1] != "train_4k" or rec.get("status") != "ok":
            continue
        bw = peaks_for(rec["card"])["hbm_bw"]
        by = rec["traffic_by_op"]
        kb = sum(v for k, v in by.items() if k in KERNEL_WORK)
        cfg = get_config(rec["arch"])
        if cfg.unit[0] == "mamba":
            a = mamba_scan_traffic_per_device(cfg, 256, 4096,
                                              peaks=peaks_for(rec["card"]))
            ana = (f"{a['total_bytes'] / 1e9:.1f}",
                   f"{a['t_memory_s'] * 1e3:.1f}")
        else:
            ana = ("—", "—")
        lines.append(f"| {rec['arch']} | {kb / 1e9:.1f} | "
                     f"{kb / bw * 1e3:.1f} | {ana[0]} | {ana[1]} | "
                     f"{rec['roofline']['t_memory_s'] * 1e3:.1f} | "
                     f"{kb / rec['bytes_per_device']:.2f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "baseline"
    print({"baseline": baseline, "skips": skips, "kernel": kernel}[what](
        *sys.argv[2:3]))
