"""Three-term roofline of one step on one card (port of
``repro.roofline.analysis``).

  compute    = Σ_unit FLOPs_unit / (chips × the unit's peak)
  memory     = bytes             / (chips × HBM rate)
  collective = collective bytes  / (chips × link rate)      (0 on one card)

The peaks are the card's own, looked up by ``torch.cuda.get_device_name()``
in ``PEAKS`` (``peaks_for``); a name that is not in the table raises. A
Hopper card has three compute rates where the TPU has one, so ``Roofline``
takes its FLOPs split by unit (``UNITS``): bf16 products on the tensor
cores, TF32 products on the tensor cores, and f32 operations outside them.

The FLOPs and bytes come from ``roofline/counter.py``, which counts an
eager step op by op (the stand-in for XLA's ``compiled.cost_analysis()``).
The JAX module's ``collective_bytes`` and its ``hlo_static.py`` have no
counterpart: they read XLA HLO text, and the while-loop trip-count
correction they make is not needed here, because an eager step runs every
loop iteration it counts.

MODEL_FLOPS = 6·N·D (train) / 2·N·D (forward only), ratioed against the
counted FLOPs, exposes recomputation and redundant work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

UNITS = ("bf16", "tf32", "f32")

# Device peaks by ``torch.cuda.get_device_name()``: dense FLOP/s a unit,
# HBM bytes/s and bytes, NVLink bytes/s a direction.
PEAKS = {
    # H100 SXM5 80 GB, NVIDIA H100 Tensor Core GPU data sheet
    "NVIDIA H100 80GB HBM3": dict(
        bf16_flops=989.4e12, tf32_flops=494.7e12, f32_flops=67e12,
        hbm_bw=3.35e12, hbm_bytes=80e9, link_bw=450e9),
}
SHORT_NAMES = {"NVIDIA H100 80GB HBM3": "H100"}    # a dry-run record's mesh


def peaks_for(name: str) -> Dict[str, float]:
    """The peaks of the card called ``name``; raises on a name that is not
    in ``PEAKS`` (no card's figures stand in for another's)."""
    if name not in PEAKS:
        raise KeyError(f"no peaks for the card {name!r}; have "
                       f"{sorted(PEAKS)}: add its data-sheet figures to "
                       f"repro_torch.roofline.analysis.PEAKS")
    return dict(PEAKS[name])


@dataclasses.dataclass
class Roofline:
    flops: float                 # the step's FLOPs, all units
    hbm_bytes: float             # the step's bytes moved
    coll_bytes: float            # collective operand bytes (0 on one card)
    chips: int
    peaks: Dict[str, float]      # a ``PEAKS`` entry (``peaks_for``)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: Optional[float] = None
    flops_by_unit: Optional[Dict[str, float]] = None   # None: all bf16

    def __post_init__(self):
        by = self.flops_by_unit or {"bf16": self.flops}
        self.t_compute = sum(f / (self.chips * self.peaks[f"{u}_flops"])
                             for u, f in by.items() if f)
        self.t_memory = self.hbm_bytes / (self.chips * self.peaks["hbm_bw"])
        self.t_collective = self.coll_bytes / (self.chips *
                                               self.peaks["link_bw"])

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound time that is useful compute: the model
        FLOPs at the bf16 peak over ``bound_time``."""
        if not self.model_flops:
            return 0.0
        t_useful = self.model_flops / (self.chips * self.peaks["bf16_flops"])
        return t_useful / max(self.bound_time, 1e-30)

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "flops_by_unit": self.flops_by_unit,
        }


def mfu(model_flops: float, step_s: float, peaks: Dict[str, float],
        chips: int = 1) -> float:
    """Model FLOP utilisation: model FLOPs over (step time × bf16 peak)."""
    return model_flops / (step_s * chips * peaks["bf16_flops"])


def model_flops_per_step(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N·D (train) / 2·N·D (forward only) with N = active params; a
    decode step is one token a row."""
    n_active = active_params(cfg)
    tokens = batch * seq if kind != "decode" else batch * 1
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Parameter count from each layer's sub-blocks' shapes
    (``models/blocks.py`` ``layer_kinds``, ``KINDS``, and ``MLP`` where
    the layer has one) plus the embedding, the final norm and the head (a
    tied embedding counted once): no device, no allocation. A hybrid or
    dense layer counts its block and its MLP (``blocks.has_mlp``). The
    JAX version also scales expert weights to the top-k active set; the
    port has no experts until the MoE slice (ROADMAP queue 1 item 5d-ii),
    and that scaling belongs here when they come."""
    from repro_torch.models import blocks

    def count(shapes):
        return sum(math.prod(s) for s in shapes(cfg).values())
    per_kind = {k: count(blocks.KINDS[k][1]) for k in set(cfg.unit)}
    mlp = count(blocks.MLP[1]) if blocks.has_mlp(cfg) else 0
    embed = (1 if cfg.tie_embeddings else 2) * cfg.vocab * cfg.d_model
    return float(sum(per_kind[k] + mlp for k in blocks.layer_kinds(cfg))
                 + embed + cfg.d_model)
