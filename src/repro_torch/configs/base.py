"""ArchConfig for the port: the Mamba-1 and Mamba-2 fields of
``repro.configs.base``.

A copy, not an import: the port runs where JAX is not installed. Only what
the serving and training slices read is kept. There is no ``use_pallas``:
the device of the tensor picks the kernel (CUDA) or its plain version
(CPU). ``pallas_schedule`` has the JAX field's name and default and picks
the Mamba-1 training scan's kernels: ``"blocked"`` (#4/#6) or ``"step"``
(#3/#5). The Mamba-2 scan runs ``blocked_heads`` (``blocked_heads_dual``
through ``kernels.ops.selective_scan_heads(schedule=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REGISTRY = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # "mamba" only (Mamba-1 and Mamba-2)
    n_layers: int
    d_model: int
    vocab: int
    norm_eps: float = 1e-6
    # Mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model / 16)
    ssm_variant: str = "mamba1"       # mamba1 (per-channel decay) | mamba2
    #                                   (SSD: scalar per-head decay)
    ssm_heads: Optional[int] = None   # mamba2: #heads (default d_inner/hd)
    ssm_head_dim: Optional[int] = None  # mamba2: head dim dh (default 64)
    ssm_norm: str = "none"            # mamba2 output gate: "none" |
    #                                   "rms_gate" (RMSNorm of y·silu(z)
    #                                   with a learned (d_inner,) scale)
    # execution
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    pallas_schedule: str = "blocked"  # step | blocked: the Mamba-1 training
    #                                   scan's kernels (#3/#5 | #4/#6)
    scan_chunk: int = 256             # chunk length of the plain blocked
    #                                   scan (serving's state handoff)
    scan_impl: str = "blocked"        # blocked | sequential
    scan_intra: Optional[str] = None  # blocked in-chunk evaluator: None =
    #                                   "assoc" | "matmul" (mamba1), None =
    #                                   "quad" | "dual" (mamba2)
    remat: str = "unit"               # none | unit (checkpoint each layer)

    @property
    def dtr(self) -> int:
        if self.dt_rank is not None:
            return self.dt_rank
        return -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_hd(self) -> int:
        """Mamba-2 head dim dh; enforces d_inner = ssm_heads · ssm_hd."""
        hd = self.ssm_head_dim
        if hd is None:
            hd = (self.d_inner // self.ssm_heads) if self.ssm_heads else 64
        if self.ssm_heads:
            if self.ssm_heads * hd != self.d_inner:
                raise ValueError(
                    f"ssm_heads ({self.ssm_heads}) × head dim ({hd}) != "
                    f"d_inner ({self.d_inner})")
        elif self.d_inner % hd:
            raise ValueError(
                f"d_inner {self.d_inner} not divisible by ssm_head_dim {hd}")
        return hd

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_hd

    @property
    def unit(self) -> Tuple[str, ...]:
        """The layer kind (the JAX package's one-layer pattern unit)."""
        return ("mamba2",) if self.ssm_variant == "mamba2" else ("mamba",)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the JAX package's
        ``reduced()`` restricted to the fields kept here)."""
        k = {}
        if self.ssm_variant == "mamba2":
            k["ssm_head_dim"] = 16             # 8 heads at d_inner = 128
            k["ssm_heads"] = None
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=2, d_model=64,
            vocab=128, dtype="float32", scan_chunk=8, **k)


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c
    _c.load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
