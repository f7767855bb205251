"""Training launcher of the port (``repro.launch.train`` on one card):
packed training of a Mamba-1 or Mamba-2 model with the scan and conv
kernels, of xlstm-125m (the conv kernels in its mLSTM layers; its mLSTM
and sLSTM recurrences are plain PyTorch), of recurrentgemma-2b (the
conv kernels in its RG-LRU layers; the RG-LRU scan, the local attention
and the MLPs are plain PyTorch), or of a dense model such as
stablelm-1.6b (full causal attention and a gated MLP every layer, all
plain PyTorch: no kernel of the port's own runs).

  python -m repro_torch.launch.train --arch mamba-1.4b --rows 2 --seq-len 4096
  python -m repro_torch.launch.train --arch mamba2-370m --rows 8 --seq-len 4096
  python -m repro_torch.launch.train --arch xlstm-125m --rows 2 --seq-len 4096
  python -m repro_torch.launch.train --arch recurrentgemma-2b --rows 2 --seq-len 4096
  python -m repro_torch.launch.train --arch stablelm-1.6b --rows 2 --seq-len 4096
  python -m repro_torch.launch.train --arch stablelm-1.6b --tiny --device cpu \\
      --steps 3 --rows 2 --seq-len 128
  python -m repro_torch.launch.train --tiny --device cpu --steps 3 \\
      --rows 2 --seq-len 256 --ckpt-dir /tmp/ckpt --ckpt-every 1 \\
      --obs-trace /tmp/train_trace.json

Runs on ``cuda`` unless ``--device cpu`` is given. ``--tiny`` is the JAX
launcher's: 4 layers of d_model 128, so for xlstm-125m 4 tail mLSTM
layers (fewer than its 6-layer unit) and no sLSTM, for
recurrentgemma-2b one unit and a tail rec layer (its head, MLP and
recurrent widths stand), and for a dense model 4 attention layers whose
head count, MLP width and head_dim stand (stablelm-1.6b: 32 heads of 4).
``--scan-tune auto``
(the process-default ``TUNE_CACHE_torch.json``) or ``--scan-tune <path>``
sweeps the scan's schedules forward + backward at the run's (rows,
seq-len) before the first step, unless the cache holds that key, and the
model then runs the measured winner; a config with no selective scan
(xLSTM, the hybrid, a dense model) has nothing to sweep, and the flag
does nothing, as in the JAX launcher.

``--ckpt-dir`` saves every ``--ckpt-every`` steps (default 50) and, on
SIGTERM or SIGINT, once more before stopping; a launch whose directory
holds a checkpoint resumes from its latest step. ``--obs-trace PATH``
records the ``train.data`` / ``train.step`` spans (and the prefetch and
tuner telemetry) and writes a Chrome trace with the metric snapshot
(check it with ``python -m repro_torch.obs.check PATH``);
``--profile-dir DIR`` captures a ``torch.profiler`` trace of the training
loop into DIR. Left for a later slice (ROADMAP): ``--model-axis`` and
``--dry-run``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.dataset import (PAPER_LEN_MAX, CorpusConfig,
                                     SyntheticCorpus)
from repro_torch.data.packing_loader import LoaderConfig, PackingLoader
from repro_torch.data.prefetch import PrefetchLoader
from repro_torch.models.lm import LM
from repro_torch.obs import Obs, profiler_session
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba-110m")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model for a CPU demo / smoke run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (width "
                         "stands; whole units first, as the config's "
                         "own depth)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--mode", default="pack",
                    choices=["pack", "pad", "single"])
    ap.add_argument("--policy", default="sequential",
                    choices=["sequential", "sorted_greedy", "first_fit",
                             "first_fit_decreasing"])
    ap.add_argument("--dtype", default=None,
                    help="activation/compute dtype override (e.g. bfloat16)")
    ap.add_argument("--param-dtype", default=None,
                    help="parameter storage dtype (bfloat16 keeps f32 "
                         "master weights in the optimizer)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host-side batches packed ahead of the device "
                         "step (0 = synchronous loader)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the corpus")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scan-tune", default="off",
                    help="off | auto | <cache path>: shape-keyed scan "
                         "autotuning (repro_torch.tune); the cache is warmed "
                         "for the training shape before the first step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (resumes from its latest "
                         "step)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--obs-trace", default=None, metavar="PATH",
                    help="record per-step train spans (data wait / step / "
                         "first-shape marks) and export a Chrome "
                         "trace-event JSON here")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (Chrome JSON) of "
                         "the training loop into this directory")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:               # the JAX launcher's --tiny config
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, vocab=512,
                                  dtype="float32", scan_chunk=64)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype or args.param_dtype:
        cfg = dataclasses.replace(
            cfg, dtype=args.dtype or cfg.dtype,
            param_dtype=args.param_dtype or cfg.param_dtype)
    if args.scan_tune != "off":
        # measure or load the scan winners for this run's shape bucket
        # before the first step; a training launcher times forward +
        # backward and the step resolves those winners
        cfg = dataclasses.replace(cfg, scan_tune=args.scan_tune,
                                  tune_objective="fwdbwd")
    model = LM(cfg, args.device)
    obs = Obs.on() if args.obs_trace else Obs.off()
    if args.scan_tune != "off":
        from repro_torch.tune import warm_for_config
        warm_for_config(cfg, [(args.rows, args.seq_len)],
                        objective="fwdbwd", device=model.device, obs=obs)
    # the paper's lengths (57..2048); a buffer shorter than 2048 clips them
    # to its own length, where the JAX launcher would fail to pack
    corpus = SyntheticCorpus(CorpusConfig(
        vocab=cfg.vocab, seed=args.seed,
        len_max=min(PAPER_LEN_MAX, args.seq_len)))
    loader = PackingLoader(corpus, LoaderConfig(
        rows=args.rows, seq_len=args.seq_len, mode=args.mode,
        policy=args.policy))
    if args.prefetch > 0:
        loader = PrefetchLoader(loader, depth=args.prefetch, obs=obs)
    opt = AdamW(cosine_schedule(args.lr, warmup=max(1, args.steps // 20),
                                total=args.steps),
                AdamWConfig(weight_decay=0.1, clip_norm=1.0))
    trainer = Trainer(model, opt, loader, TrainerConfig(
        steps=args.steps, accum=args.accum, log_every=10,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir), obs=obs)
    print(f"training {cfg.name}: {args.steps} steps, mode={args.mode}, "
          f"rows={args.rows}x{args.seq_len}, device={model.device}",
          flush=True)
    t0 = time.perf_counter()
    with profiler_session(args.profile_dir) as profiling:
        _, hist = trainer.train(
            torch.Generator(device=model.device).manual_seed(args.seed))
    wall = time.perf_counter() - t0
    if isinstance(loader, PrefetchLoader):
        loader.close()
    if hist:                    # empty when a checkpoint ends the run
        print(f"done; final loss {hist[-1]['loss']:.4f}")
    if args.obs_trace:
        obs.export(args.obs_trace)
        print(f"obs: wrote {len(obs.tracer.chrome_events())} trace events "
              f"to {args.obs_trace} (open in chrome://tracing or "
              f"ui.perfetto.dev)")
    if profiling:
        print(f"obs: torch.profiler trace captured under {args.profile_dir}")
    print(json.dumps({
        "device": str(model.device), "arch": cfg.name, "steps": len(hist),
        "losses": [h["loss"] for h in hist], "seconds": wall,
        "real_tok_per_s": trainer.real_tokens / max(trainer.step_ms, 1e-9)
        * 1e3}))
    return hist


if __name__ == "__main__":
    main()
