"""Training launcher of the port (``repro.launch.train`` on one card):
packed Mamba-1 or Mamba-2 training with the scan and conv kernels.

  python -m repro_torch.launch.train --arch mamba-1.4b --rows 2 --seq-len 4096
  python -m repro_torch.launch.train --arch mamba2-370m --rows 8 --seq-len 4096
  python -m repro_torch.launch.train --tiny --device cpu --steps 3 \\
      --rows 2 --seq-len 256

Runs on ``cuda`` unless ``--device cpu`` is given. Left for later slices
(ROADMAP): ``--ckpt-dir``/``--ckpt-every``, ``--scan-tune``,
``--model-axis``, ``--obs-trace``, ``--profile-dir`` and ``--dry-run``.
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
from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba-110m")
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model for a CPU demo / smoke run")
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:               # the JAX launcher's --tiny config
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, vocab=512,
                                  dtype="float32", scan_chunk=64)
    if args.dtype or args.param_dtype:
        cfg = dataclasses.replace(
            cfg, dtype=args.dtype or cfg.dtype,
            param_dtype=args.param_dtype or cfg.param_dtype)
    model = LM(cfg, args.device)
    # the paper's lengths (57..2048); a buffer shorter than 2048 clips them
    # to its own length, where the JAX launcher would fail to pack
    corpus = SyntheticCorpus(CorpusConfig(
        vocab=cfg.vocab, seed=args.seed,
        len_max=min(PAPER_LEN_MAX, args.seq_len)))
    loader = PackingLoader(corpus, LoaderConfig(
        rows=args.rows, seq_len=args.seq_len, mode=args.mode,
        policy=args.policy))
    if args.prefetch > 0:
        loader = PrefetchLoader(loader, depth=args.prefetch)
    opt = AdamW(cosine_schedule(args.lr, warmup=max(1, args.steps // 20),
                                total=args.steps),
                AdamWConfig(weight_decay=0.1, clip_norm=1.0))
    trainer = Trainer(model, opt, loader, TrainerConfig(
        steps=args.steps, accum=args.accum, log_every=10))
    print(f"training {cfg.name}: {args.steps} steps, mode={args.mode}, "
          f"rows={args.rows}x{args.seq_len}, device={model.device}",
          flush=True)
    t0 = time.perf_counter()
    _, hist = trainer.train(
        torch.Generator(device=model.device).manual_seed(args.seed))
    wall = time.perf_counter() - t0
    if isinstance(loader, PrefetchLoader):
        loader.close()
    print(f"done; final loss {hist[-1]['loss']:.4f}")
    print(json.dumps({
        "device": str(model.device), "arch": cfg.name, "steps": len(hist),
        "losses": [h["loss"] for h in hist], "seconds": wall,
        "real_tok_per_s": trainer.real_tokens / max(trainer.step_ms, 1e-9)
        * 1e3}))
    return hist


if __name__ == "__main__":
    main()
