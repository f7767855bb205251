"""ArchConfig for the port: the Mamba-1, Mamba-2, xLSTM, hybrid
(RecurrentGemma) and dense (llama-style decoder) fields of
``repro.configs.base``.

A copy, not an import: the port runs where JAX is not installed. Only what
the serving and training slices read is kept. There is no ``use_pallas``:
the device of the tensor picks the kernel (CUDA) or its plain version
(CPU). ``pallas_schedule`` has the JAX field's name and default and picks
the Mamba-1 training scan's kernels: ``"blocked"`` (#4/#6) or ``"step"``
(#3/#5). The Mamba-2 scan runs ``blocked_heads`` (``blocked_heads_dual``
through ``kernels.ops.selective_scan_heads(schedule=...)``). With
``scan_tune`` on, the tuner's measured winner replaces both choices.

A heterogeneous stack is a repeating pattern unit (``pattern``, e.g.
xLSTM's five ``mlstm`` layers and one ``slstm``, RecurrentGemma's ``rec,
rec, attn``): layer ``i`` is of kind ``unit[i % len(unit)]``, so layers
past the last whole unit reuse the unit's prefix, as in the JAX package.
A dense config has no pattern: its unit is ``("attn",)``, every layer a
full causal attention block. With ``d_ff > 0`` a hybrid or dense layer
runs its block, then a gated MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

REGISTRY = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # "mamba" (Mamba-1 and Mamba-2) |
    #                                   "xlstm" (mLSTM and sLSTM) | "hybrid"
    #                                   (RG-LRU and local attention) |
    #                                   "dense" (full causal attention)
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 1                  # xlstm: mLSTM / sLSTM heads; hybrid,
    #                                   dense: attention query heads
    #                                   (unused by the Mamba blocks)
    n_kv_heads: int = 1               # hybrid, dense: attention K/V heads
    #                                   (JAX requires it; 1 = MQA)
    d_ff: int = 0                     # MLP width (hybrid, dense: each
    #                                   layer's gated MLP); > 0 on an
    #                                   xLSTM unit raises (no MLP wired
    #                                   there yet)
    head_dim: Optional[int] = None    # default d_model // n_heads
    act: str = "swiglu"               # MLP gate: swiglu | geglu (tanh GeLU)
    attn_window: Optional[int] = None  # sliding-window size (None = full)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False      # head = embed.T, embedding × √d_model
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
    # hybrid / xlstm layer pattern: one entry per layer in the unit
    pattern: Tuple[str, ...] = ()     # e.g. 5 × "mlstm" + "slstm", or
    #                                   ("rec", "rec", "attn"); () =
    #                                   homogeneous (the Mamba rule)
    lru_width: Optional[int] = None   # hybrid recurrent width (default
    #                                   d_model)
    lru_gate_blocks: int = 16         # block-diagonal RG-LRU gates
    conv_width: int = 4               # hybrid/xlstm temporal conv width
    proj_factor: float = 2.0          # xlstm mLSTM up-projection factor
    # execution
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    pallas_schedule: str = "blocked"  # step | blocked: the Mamba-1 training
    #                                   scan's kernels (#3/#5 | #4/#6)
    scan_chunk: int = 256             # chunk length of the plain blocked
    #                                   scan (serving's state handoff)
    scan_impl: str = "blocked"        # blocked | chunked | fused_seq |
    #                                   sequential | associative (mamba1)
    scan_intra: Optional[str] = None  # blocked in-chunk evaluator: None =
    #                                   "assoc" | "matmul" (mamba1), None =
    #                                   "quad" | "dual" (mamba2)
    scan_tune: str = "off"            # shape-keyed autotuning
    #                                   (repro_torch.tune): "off" = the knobs
    #                                   above stand as they are (the scans
    #                                   never consult the tuner); "auto" =
    #                                   resolve measured winners from the
    #                                   process-default TUNE_CACHE_torch.json;
    #                                   a path = from that cache file; a
    #                                   tune.TuneCache = from it.
    #                                   launch/train.py and launch/serve.py
    #                                   warm the cache for their shapes.
    tune_objective: str = "fwd"       # which sweep's winners scan_tune
    #                                   resolves: "fwd" (forward only —
    #                                   serving) | "fwdbwd" (forward +
    #                                   backward — what launch/train.py sets)
    attn_chunk: Optional[int] = None  # online-softmax KV chunk (None =
    #                                   materialised scores up to L = 4096,
    #                                   chunks of 1024 beyond)
    remat: str = "unit"               # none | unit (checkpoint each layer)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

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
        """The repeating layer-pattern unit, the JAX rule: ``pattern`` when
        set, else the Mamba kind of ``ssm_variant``, ``("moe_attn",)`` for
        the MoE family (which the blocks refuse: the port has no experts
        yet) and ``("attn",)`` otherwise (a dense stack)."""
        if self.pattern:
            return self.pattern
        if self.family == "mamba":
            return ("mamba2",) if self.ssm_variant == "mamba2" else ("mamba",)
        if self.family == "moe":
            return ("moe_attn",)
        return ("attn",)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the JAX package's
        ``reduced()`` restricted to the fields kept here). Two whole units
        deep: 2 layers for Mamba and dense, 12 for xLSTM's six-layer unit,
        6 for the hybrid's three-layer unit. An attention family keeps at
        most 2 K/V heads (a dense MHA config becomes GQA, 4 on 2) of 16."""
        k = {}
        if self.ssm_variant == "mamba2":
            k["ssm_head_dim"] = 16             # 8 heads at d_inner = 128
            k["ssm_heads"] = None
        if self.family != "mamba":
            k["n_heads"] = 4
            k["d_ff"] = 128 if self.d_ff else 0
        if self.family in ("hybrid", "dense"):
            k.update(n_kv_heads=max(1, min(self.n_kv_heads, 2)), head_dim=16,
                     attn_chunk=None)
        if self.family == "hybrid":
            k.update(lru_width=64 if self.lru_width else None,
                     lru_gate_blocks=4)
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=max(len(self.unit) * 2, 2), d_model=64, vocab=128,
            dtype="float32", scan_chunk=8, **k)


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _c
    _c.load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
