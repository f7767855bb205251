"""Synthetic variable-length corpus matching the paper's data statistics
(a copy of ``repro.data.dataset``: numpy only, same numbers from the same
seed).

Paper §4: "sequences ranging in length from 57 to 2048, with an average
length of 646" (InternLM-derived). We sample lengths from a clipped
lognormal calibrated to that mean and range, and fill tokens with a
learnable per-sequence process (affine stride mod vocab) so integration
tests can assert loss decrease.

Everything is *stateless and step-indexed*: ``batch_lengths(step)`` and
``sequence(seq_id)`` are pure functions of (seed, step/seq_id), which is
what makes checkpoint-resume deterministic (the trainer just stores the
step; the pipeline replays identically, including after elastic restarts).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

PAPER_LEN_MIN = 57
PAPER_LEN_MAX = 2048
PAPER_LEN_MEAN = 646


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab: int = 50280
    seed: int = 0
    len_min: int = PAPER_LEN_MIN
    len_max: int = PAPER_LEN_MAX
    # lognormal(mu, sigma) clipped to [len_min, len_max]; defaults calibrated
    # so the clipped mean ≈ 646 (paper's InternLM statistics)
    mu: float = 6.17
    sigma: float = 0.75


class SyntheticCorpus:
    def __init__(self, cfg: CorpusConfig = CorpusConfig()):
        self.cfg = cfg

    def _rng(self, *salt: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, *salt]))

    def lengths(self, step: int, n: int) -> np.ndarray:
        r = self._rng(0xB0B, step)
        ln = np.exp(r.normal(self.cfg.mu, self.cfg.sigma, size=n))
        return np.clip(ln, self.cfg.len_min, self.cfg.len_max).astype(np.int64)

    def sequence(self, step: int, idx: int, length: int) -> np.ndarray:
        """Learnable structure: token_{t+1} = (token_t + stride) % (vocab-1) + 1
        (0 is reserved for padding)."""
        r = self._rng(0x5E9, step, idx)
        start = int(r.integers(1, self.cfg.vocab))
        stride = int(r.integers(1, 64))
        toks = (start + stride * np.arange(length, dtype=np.int64)) % \
            (self.cfg.vocab - 1) + 1
        return toks.astype(np.int32)

    def batch_of_sequences(self, step: int, n: int) -> List[np.ndarray]:
        lens = self.lengths(step, n)
        return [self.sequence(step, i, int(L)) for i, L in enumerate(lens)]

    def mean_length(self, probe_steps: int = 50, per_step: int = 64) -> float:
        tot = [self.lengths(s, per_step) for s in range(probe_steps)]
        return float(np.mean(np.concatenate(tot)))
