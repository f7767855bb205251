"""Training loop (port of ``repro.train.trainer``): gradient accumulation,
mixed precision through the optimizer's f32 masters, deterministic data
replay, throughput metering.

``make_train_step`` builds ``step_fn(state, batch) -> (state, metrics)``
with ``state = {"params": {name: Parameter}, "opt": AdamWState}``; the
parameters and the optimizer state are updated in place (see
``optim/adamw.py``). The JAX version's checkpoint/restart and SIGTERM
options wait for ``checkpoint/checkpoint.py`` in a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    accum: int = 1                       # gradient-accumulation microbatches
    log_every: int = 10


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def make_train_step(model, opt: AdamW, accum: int = 1) -> Callable:
    """Returns step_fn(state, batch) -> (state, metrics). Batch leaves have
    a leading row axis divisible by ``accum``; with ``accum`` > 1 the rows
    are split into ``accum`` contiguous microbatches, their gradients
    summed in f32 and averaged, as the JAX step does."""

    def step_fn(state, batch):
        params = state["params"]
        names = list(params)
        plist = [params[k] for k in names]
        if accum <= 1:
            loss, metrics = model.loss(batch)
            grads = _grads(loss, plist)
            loss = loss.detach()
        else:
            mbs = [{k: np.asarray(v).reshape(
                        (accum, np.shape(v)[0] // accum) + np.shape(v)[1:])[i]
                    for k, v in batch.items()} for i in range(accum)]
            gacc, lsum, mets = None, 0.0, []
            for mb in mbs:
                l, met = model.loss(mb)
                g = _grads(l, plist)
                gacc = [x.float() for x in g] if gacc is None else \
                    [a + b.float() for a, b in zip(gacc, g)]
                lsum = lsum + l.detach()
                mets.append(met)
            grads = [g / accum for g in gacc]
            loss = lsum / accum
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        _, new_opt, stats = opt.update(dict(zip(names, grads)), state["opt"],
                                       params)
        metrics = dict(metrics, loss=loss, **stats)
        return {"params": params, "opt": new_opt}, metrics

    return step_fn


class Trainer:
    """Counters (plain numbers): ``steps``, ``real_tokens`` (non-padding
    tokens trained on), ``buffer_tokens`` (padding included), ``data_ms``
    (waiting on the loader) and ``step_ms`` (the train step, ended by the
    host reading the loss, i.e. device time included)."""

    def __init__(self, model, opt: AdamW, loader, cfg: TrainerConfig,
                 step_fn: Optional[Callable] = None):
        self.model = model
        self.opt = opt
        self.loader = loader
        self.cfg = cfg
        self.step_fn = step_fn or make_train_step(model, opt, cfg.accum)
        self.steps = 0
        self.real_tokens = 0
        self.buffer_tokens = 0
        self.data_ms = 0.0
        self.step_ms = 0.0

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        """Random weights from ``generator`` (on the model's device) when
        given, else the model's current weights; a fresh optimizer state."""
        if generator is not None:
            self.model.init(generator)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": self.opt.init(params)}

    def train(self, generator: Optional[torch.Generator] = None,
              state=None, start_step: int = 0, verbose: bool = True):
        """Steps ``start_step`` .. ``cfg.steps - 1``. Returns (state,
        history), one row of floats per step."""
        if state is None:
            state = self.init_state(generator)
        history = []
        t_last = time.perf_counter()
        real_mark, buf_mark = self.real_tokens, self.buffer_tokens
        for step in range(start_step, self.cfg.steps):
            t0 = time.perf_counter()
            batch = self.loader.batch(step)
            t1 = time.perf_counter()
            seg = batch.get("segment_ids")
            real = int((np.asarray(seg) > 0).sum()) if seg is not None \
                else int(np.size(batch["tokens"]))
            buf = int(np.size(batch["tokens"]))
            state, metrics = self.step_fn(state, batch)
            row = {k: float(v) for k, v in metrics.items()
                   if not torch.is_tensor(v) or v.dim() == 0}
            t2 = time.perf_counter()        # float() waited for the device
            self.steps += 1
            self.real_tokens += real
            self.buffer_tokens += buf
            self.data_ms += (t1 - t0) * 1e3
            self.step_ms += (t2 - t1) * 1e3
            row.update(real_tokens=float(real), buffer_tokens=float(buf),
                       step_ms=(t2 - t1) * 1e3, data_ms=(t1 - t0) * 1e3)
            history.append(row)
            if verbose and (step + 1) % self.cfg.log_every == 0:
                dt = time.perf_counter() - t_last
                real_since = self.real_tokens - real_mark
                buf_since = self.buffer_tokens - buf_mark
                print(f"step {step + 1:5d} loss {row['loss']:.4f} "
                      f"gnorm {row['grad_norm']:.3f} "
                      f"tok/s {real_since / max(dt, 1e-9):,.0f} "
                      f"(buffer {buf_since / max(dt, 1e-9):,.0f}, "
                      f"{real_since / max(buf_since, 1):.0%} real)",
                      flush=True)
                t_last = time.perf_counter()
                real_mark, buf_mark = self.real_tokens, self.buffer_tokens
        return state, history
