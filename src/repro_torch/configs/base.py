"""ArchConfig for the port: the Mamba-1 fields of ``repro.configs.base``.

A copy, not an import: the port runs where JAX is not installed. Only what
the serving and training slices read is kept. There is no ``use_pallas``
or ``pallas_schedule``: the device of the tensor picks the kernel (CUDA) or
its plain version (CPU), and the scan kernels are the ``blocked``
schedule's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

REGISTRY = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # "mamba" only in this slice
    n_layers: int
    d_model: int
    vocab: int
    norm_eps: float = 1e-6
    # Mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model / 16)
    # execution
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    scan_chunk: int = 256             # chunk length of the plain blocked
    #                                   scan (serving's state handoff)
    scan_impl: str = "blocked"        # blocked | sequential
    scan_intra: Optional[str] = None  # blocked in-chunk evaluator: None =
    #                                   "assoc" | "matmul"
    remat: str = "unit"               # none | unit (checkpoint each layer)

    @property
    def dtr(self) -> int:
        if self.dt_rank is not None:
            return self.dt_rank
        return -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the JAX package's
        ``reduced()`` restricted to the fields kept here)."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=2, d_model=64,
            vocab=128, dtype="float32", scan_chunk=8)


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c
    _c.load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
