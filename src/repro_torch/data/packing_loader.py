"""Batch producers for the paper's three training regimes (port of
``repro.data.packing_loader``; numpy only, buffers bit-identical to the JAX
loader's at every step).

  * ``pack``   — PackMamba: variable-length sequences packed into fixed
                 (rows, seq_len) buffers with position/segment side tensors.
  * ``pad``    — baseline 2: one sequence per row, zero-padded to seq_len.
  * ``single`` — baseline 1: one sequence per step, padded up to the next
                 power of two.

Every batch is a pure function of ``step`` (see ``data/dataset.py``), so a
restart replays the stream exactly. ``balance_shards`` snake-orders packed
rows so each contiguous group of rows (one data-parallel shard's slice)
carries about the same real-token load.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.packing import pack, pad_to_max, plan_packing
from repro_torch.data.dataset import SyntheticCorpus


@dataclasses.dataclass
class LoaderConfig:
    rows: int                   # global batch rows (packed buffers per step)
    seq_len: int                # packed buffer capacity (paper: 4096 = 2^12)
    mode: str = "pack"          # pack | pad | single
    policy: str = "sequential"  # packing policy (paper default)
    oversample: float = 1.15    # draw margin so `rows` buffers always fill
    balance_shards: int = 0     # >0: reorder rows so each contiguous group
    #                             of rows/balance_shards carries ~equal load


class PackingLoader:
    def __init__(self, corpus: SyntheticCorpus, cfg: LoaderConfig):
        if cfg.mode not in ("pack", "pad", "single"):
            raise ValueError(f"unknown loader mode {cfg.mode!r}")
        if cfg.balance_shards > 1 and cfg.rows % cfg.balance_shards:
            raise ValueError(
                f"balance_shards={cfg.balance_shards} must divide "
                f"rows={cfg.rows}: shard balancing permutes rows into "
                f"contiguous per-shard slices of rows/balance_shards. Pick "
                f"rows as a multiple of balance_shards (e.g. rows="
                f"{cfg.rows + (-cfg.rows) % cfg.balance_shards}) or set "
                f"balance_shards=0.")
        self.corpus = corpus
        self.cfg = cfg
        self._mean = corpus.mean_length(probe_steps=20, per_step=64)

    def _n_draw(self) -> int:
        c = self.cfg
        if c.mode == "pad":
            return c.rows
        if c.mode == "single":
            return 1
        return max(1, int(c.rows * c.seq_len / self._mean / c.oversample))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens", "positions", "segment_ids"}: int32 (rows, seq_len)
        (``single``: (1, next power of two ≥ the sequence))."""
        c = self.cfg
        seqs = self.corpus.batch_of_sequences(step, self._n_draw())
        if c.mode == "pad":
            pb = pad_to_max(seqs, c.seq_len)
        elif c.mode == "single":
            n = len(seqs[0])
            cap = 1 << (n - 1).bit_length()          # next power of two
            pb = pad_to_max(seqs[:1], cap)
        else:
            # drop sequences that would need a row beyond `rows`
            plan = plan_packing([len(s) for s in seqs], c.seq_len, c.policy)
            keep_ids = [i for row in plan[:c.rows] for i in row]
            pb = pack([seqs[i] for i in keep_ids], c.seq_len,
                      policy=c.policy, num_rows=c.rows)
        out = {"tokens": pb.tokens, "positions": pb.positions,
               "segment_ids": pb.segment_ids}
        if c.balance_shards > 1 and c.mode == "pack":
            out = self._balance(out, c.balance_shards)
        return out

    @staticmethod
    def _balance(batch, n_shards):
        """Snake-order rows by real token count so each shard's contiguous
        row slice carries about equal load."""
        seg = np.asarray(batch["segment_ids"])
        rows = seg.shape[0]
        if rows % n_shards:
            raise ValueError(f"_balance: {rows} rows not divisible by "
                             f"{n_shards} shards")
        load = (seg > 0).sum(axis=1)
        order = np.argsort(-load, kind="stable")
        fill = [[] for _ in range(n_shards)]
        for i, row in enumerate(order):
            rnd, pos = divmod(i, n_shards)
            shard = pos if rnd % 2 == 0 else n_shards - 1 - pos  # snake
            fill[shard].append(int(row))
        perm = np.concatenate([np.asarray(f, np.int64) for f in fill])
        return {k: np.asarray(v)[perm] for k, v in batch.items()}

    def stats(self, step: int) -> Dict[str, float]:
        c = self.cfg
        seqs = self.corpus.batch_of_sequences(step, self._n_draw())
        lens = [len(s) for s in seqs]
        plan = plan_packing(lens, c.seq_len, c.policy)
        used = sum(lens[i] for row in plan[:c.rows] for i in row)
        return {"padding_rate": 1.0 - used / (c.rows * c.seq_len),
                "n_seqs": float(len(lens)),
                "dropped_rows": float(max(0, len(plan) - c.rows)),
                "balanced": bool(c.balance_shards > 1 and c.mode == "pack")}
