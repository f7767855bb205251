"""Training loop (port of ``repro.train.trainer``): gradient accumulation
(in f32 or bf16, ``grad_accum_dtype``), mixed precision through the
optimizer's f32 masters, checkpoint/restart with a SIGTERM-safe emergency
save, deterministic data replay, throughput metering through ``obs``.

``make_train_step`` builds ``step_fn(state, batch) -> (state, metrics)``
with ``state = {"params": {name: Parameter}, "opt": AdamWState}``; the
parameters and the optimizer state are updated in place (see
``optim/adamw.py``). A checkpoint holds that tree: the parameters and
``AdamWState``'s ``m``, ``v``, ``master`` (when present) and ``step``;
its manifest's ``meta["step"]`` is the data step to resume at (the
loader's ``batch(step)`` is a pure function of the step, so a restart
replays the same stream). On SIGTERM/SIGINT the loop ends the step it is
in and makes a blocking emergency save marked ``"emergency": True``;
where that step was just saved periodically, it waits for that write and
marks its manifest (``CheckpointManager.mark``) instead of writing the
same state twice.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.obs import Obs
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    accum: int = 1                       # gradient-accumulation microbatches
    grad_accum_dtype: Optional[str] = None   # "bfloat16" halves accum memory
    log_every: int = 10
    ckpt_every: int = 0                  # 0 = no periodic checkpoints
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3


def _grads(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def make_train_step(model, opt: AdamW, accum: int = 1,
                    grad_accum_dtype: Optional[str] = None) -> Callable:
    """Returns step_fn(state, batch) -> (state, metrics). Batch leaves have
    a leading row axis divisible by ``accum``; with ``accum`` > 1 the rows
    are split into ``accum`` contiguous microbatches whose gradients are
    summed in ``grad_accum_dtype`` (f32 when None), averaged in it and
    handed to the optimizer in f32, as the JAX step does."""
    adt = getattr(torch, grad_accum_dtype) if grad_accum_dtype else \
        torch.float32

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
            gacc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                    for p in plist]
            lsum, mets = 0.0, []
            for mb in mbs:
                l, met = model.loss(mb)
                g = _grads(l, plist)
                gacc = [a + b.to(adt) for a, b in zip(gacc, g)]
                lsum = lsum + l.detach()
                mets.append(met)
            grads = [(g / accum).float() for g in gacc]
            loss = lsum / accum
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        _, new_opt, stats = opt.update(dict(zip(names, grads)), state["opt"],
                                       params)
        metrics = dict(metrics, loss=loss, **stats)
        return {"params": params, "opt": new_opt}, metrics

    return step_fn


class Trainer:
    """Meters through ``obs`` (``Obs.off()`` when None): the ``train.*``
    counters and gauges are THE cumulative step/token/time metering, and
    ``steps``, ``real_tokens`` (non-padding tokens trained on),
    ``buffer_tokens`` (padding included), ``data_ms`` (waiting on the
    loader) and ``step_ms`` (the train step, ended by the host reading the
    loss, i.e. device time included) are views over them. The spans
    ``train.data`` and ``train.step`` record only under ``Obs.on()``; the
    step span then waits for the card (``tracer.sync``), a no-op when
    tracing is off. The checkpoint manager meters through the same
    ``obs`` (``ckpt.*``); ``train.emergency_save_s`` is the emergency
    save's seconds."""

    def __init__(self, model, opt: AdamW, loader, cfg: TrainerConfig,
                 step_fn: Optional[Callable] = None,
                 obs: Optional[Obs] = None):
        self.model = model
        self.opt = opt
        self.loader = loader
        self.cfg = cfg
        self.step_fn = step_fn or make_train_step(model, opt, cfg.accum,
                                                  cfg.grad_accum_dtype)
        self._interrupted = False
        self.obs = obs if obs is not None else Obs.off()
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts,
                                      obs=self.obs) if cfg.ckpt_dir else None
        m = self.obs.metrics
        self._c_steps = m.counter("train.steps",
                                  help="optimizer steps completed")
        self._c_real = m.counter("train.real_tokens",
                                 help="non-padding tokens trained on")
        self._c_buf = m.counter("train.buffer_tokens",
                                help="buffer tokens incl. padding")
        self._c_compiles = m.counter(
            "train.compiles", help="distinct batch token-shapes seen "
                                   "(first call at a shape)")
        self._g_data = m.gauge("train.data_ms",
                               help="cumulative ms waiting on the loader")
        self._g_step = m.gauge("train.step_ms",
                               help="cumulative ms in the train step")
        self._g_loss = m.gauge("train.loss", help="last step's loss")
        self._g_emergency = m.gauge(
            "train.emergency_save_s",
            help="seconds from the interrupt's step end to its checkpoint")
        self._shapes_seen = set()

    # views over the train.* registry metrics
    @property
    def steps(self) -> int:
        return self._c_steps.value

    @property
    def real_tokens(self) -> int:
        return self._c_real.value

    @property
    def buffer_tokens(self) -> int:
        return self._c_buf.value

    @property
    def data_ms(self) -> float:
        return self._g_data.value

    @property
    def step_ms(self) -> float:
        return self._g_step.value

    # ----------------------------------------------------------- lifecycle
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, object]:
        """Random weights from ``generator`` (on the model's device) when
        given, else the model's current weights; a fresh optimizer state."""
        if generator is not None:
            self.model.init(generator)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": self.opt.init(params)}

    def restore_or_init(self, generator: Optional[torch.Generator] = None
                        ) -> Tuple[Dict[str, object], int]:
        """A fresh state, overwritten in place by the latest checkpoint
        when ``cfg.ckpt_dir`` holds one; and the step to resume at."""
        state = self.init_state(generator)
        if self.ckpt and self.ckpt.latest_step() is not None:
            step = self.ckpt.latest_step()
            self.ckpt.restore(state, step)
            return state, int(self.ckpt.read_meta(step)["meta"]["step"])
        return state, 0

    def _install_signal_handlers(self) -> Dict[int, object]:
        """SIGTERM/SIGINT set the interrupt flag (the loop then makes its
        emergency save and stops). Only the main thread may install
        handlers; returns the ones replaced."""
        self._interrupted = False
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            self._interrupted = True
        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    # ----------------------------------------------------------- train loop
    def train(self, generator: Optional[torch.Generator] = None,
              state=None, start_step: Optional[int] = None,
              verbose: bool = True):
        """Steps from the resume point (the latest checkpoint's, 0 without
        one; ``start_step`` overrides it) to ``cfg.steps - 1``. ``state``:
        train it as given instead of restoring or initializing. Returns
        (state, history), one row of floats per step."""
        saved = self._install_signal_handlers()
        try:
            return self._train(generator, state, start_step, verbose)
        finally:
            for sig, h in saved.items():
                if h is not None:       # None: not installed from Python
                    signal.signal(sig, h)

    def _train(self, generator, state, start_step, verbose):
        if state is None:
            state, step0 = self.restore_or_init(generator)
        else:
            step0 = 0
        if start_step is not None:
            step0 = start_step
        history = []
        tr = self.obs.tracer
        t_last = time.perf_counter()
        real_mark, buf_mark = self.real_tokens, self.buffer_tokens
        for step in range(step0, self.cfg.steps):
            t0 = time.perf_counter()
            with tr.span("train.data", track="train", step=step):
                batch = self.loader.batch(step)
            t1 = time.perf_counter()
            seg = batch.get("segment_ids")
            real = int((np.asarray(seg) > 0).sum()) if seg is not None \
                else int(np.size(batch["tokens"]))
            buf = int(np.size(batch["tokens"]))
            shape = tuple(np.shape(batch["tokens"]))
            first = shape not in self._shapes_seen
            if first:
                self._shapes_seen.add(shape)
                self._c_compiles.inc()
            sid = tr.start("train.step", track="train", step=step,
                           compile=first)
            state, metrics = self.step_fn(state, batch)
            tr.sync(metrics["loss"])
            tr.finish(sid)
            row = {k: float(v) for k, v in metrics.items()
                   if not torch.is_tensor(v) or v.dim() == 0}
            t2 = time.perf_counter()        # float() waited for the device
            self._c_steps.inc()
            self._c_real.inc(real)
            self._c_buf.inc(buf)
            self._g_data.add((t1 - t0) * 1e3)
            self._g_step.add((t2 - t1) * 1e3)
            self._g_loss.set(row["loss"])
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
            saved = bool(self.ckpt and self.cfg.ckpt_every and
                         (step + 1) % self.cfg.ckpt_every == 0)
            if saved:
                self.ckpt.save(step + 1, state, meta={"step": step + 1})
            if self._interrupted:
                if self.ckpt:        # emergency checkpoint on SIGTERM
                    te = time.perf_counter()
                    meta = {"step": step + 1, "emergency": True}
                    if saved:        # this state is being written: mark it
                        self.ckpt.mark(step + 1, meta)
                    else:
                        self.ckpt.save(step + 1, state, meta=meta,
                                       blocking=True)
                    self._g_emergency.set(time.perf_counter() - te)
                break
        if self.ckpt:
            self.ckpt.wait()
        return state, history
