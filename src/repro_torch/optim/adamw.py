"""AdamW with decoupled weight decay, global-norm clipping and LR schedules
(port of ``repro.optim.adamw``: the same state and arithmetic leaf for
leaf, on a dict of named tensors instead of a pytree).

State: f32 ``m`` and ``v`` per parameter, an integer step, and f32
``master`` copies when any parameter is stored in less than 32 bits; then
the update reads and accumulates into the master and re-rounds the
parameter each step, so bf16's 8-bit mantissa never swallows an update.
Weight decay applies where ``decay(name, param)`` holds: by default to
parameters of rank ≥ 2 (norm scales, biases and Mamba's D are excluded;
A_log and conv_w are decayed).

Unlike the JAX version, which returns new trees, ``update`` writes the
parameters, ``m``, ``v`` and the masters in place: one copy of each lives
in device memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

Named = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    step: int
    m: Named                       # f32, like params
    v: Named                       # f32, like params
    master: Optional[Named] = None  # f32 copies of low-precision params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * min(step / max(warmup, 1), 1.0)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (final_frac + (1 - final_frac) * 0.5 *
                          (1 + math.cos(math.pi * t)))
    return lr


def constant_schedule(base_lr: float) -> Callable[[int], float]:
    return lambda step: base_lr


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (one f32 scalar
    on the leaves' device)."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tensors]).sum())


def clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [x.float() * scale for x in tensors], norm


def rank_decay(name: str, p: torch.Tensor) -> bool:
    """The default decay rule: parameters of rank ≥ 2."""
    return p.dim() >= 2


class AdamW:
    def __init__(self, lr_fn: Callable[[int], float],
                 cfg: AdamWConfig = AdamWConfig(),
                 decay: Callable[[str, torch.Tensor], bool] = rank_decay):
        self.lr_fn = lr_fn
        self.cfg = cfg
        self.decay = decay

    @torch.no_grad()
    def init(self, params: Named) -> AdamWState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        low = any(p.is_floating_point() and p.element_size() < 4
                  for p in params.values())
        master = ({k: p.detach().float().clone() for k, p in params.items()}
                  if low else None)
        return AdamWState(step=0, m=zeros,
                          v={k: torch.zeros_like(z) for k, z in
                             zeros.items()},
                          master=master)

    @torch.no_grad()
    def update(self, grads: Named, state: AdamWState, params: Named
               ) -> Tuple[Named, AdamWState, Dict[str, object]]:
        """One step, in place. Returns (params, state, {"grad_norm"
        (tensor), "lr"})."""
        c = self.cfg
        names = list(params)
        gl = [grads[k] for k in names]
        if c.clip_norm is not None:
            gl, gnorm = clip_by_global_norm(gl, c.clip_norm)
        else:
            gl = [g.float() for g in gl]
            gnorm = global_norm(gl)
        step = state.step + 1
        lr = self.lr_fn(step)
        b1, b2 = c.b1, c.b2
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        masters = state.master if state.master is not None else params
        for k, g in zip(names, gl):
            p, m, v = params[k], state.m[k], state.v[k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            delta = (m / bc1) / ((v / bc2).sqrt() + c.eps)
            w32 = masters[k].float()
            if c.weight_decay and self.decay(k, p):
                delta = delta + c.weight_decay * w32
            new_w = w32 - lr * delta
            if state.master is not None:
                state.master[k].copy_(new_w)
            p.copy_(new_w.to(p.dtype))
        state.step = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
