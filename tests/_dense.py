"""Shared parts of the dense family's files (``tests/test_torch_dense*.py``):
the port's and the JAX package's reduced dense configs (stablelm-1.6b's:
GQA, 4 query heads on 2 K/V heads, SwiGLU, untied; gemma-7b's: GeGLU, a
tied embedding), packed rows of 3–4 segments with trailing padding and
their segment ends. The weights are carried from the port's ``init`` into
the JAX tree and caches between the two layouts by ``tests/_hybrid.py``'s
helpers, which this module re-exports. Not a test module (no ``test_``
prefix)."""
import dataclasses

import numpy as np

from _hybrid import flat, jax_params, port_model, tree  # noqa: F401
from repro.configs.base import get_config as jget_config
from repro_torch.configs.base import get_config

ARCHS = ("stablelm-1.6b", "gemma-7b")
DENSE = ("stablelm-1.6b", "gemma-7b", "deepseek-coder-33b", "deepseek-67b")
# 2 rows of 48: 3 and 4 segments, then padding (segment 0)
SEGMENTS = ((11, 20, 9), (5, 14, 7, 12))
ROW = 48


def configs(arch, **kw):
    """The port's and the JAX package's ``arch.reduced()``, with ``kw``."""
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def packed_rows(seed=0, segments=SEGMENTS, L=ROW, vocab=128):
    """Rows of back-to-back segments of the given lengths, the rest of each
    row padding. Returns (batch, ends (B, max segments) int32, −1 where a
    row has fewer)."""
    rng = np.random.default_rng(seed)
    B, S = len(segments), max(map(len, segments))
    tok = np.zeros((B, L), np.int32)
    pos = np.zeros((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    ends = np.full((B, S), -1, np.int32)
    for r, lens in enumerate(segments):
        t = 0
        for i, n in enumerate(lens):
            tok[r, t:t + n] = rng.integers(1, vocab, size=n)
            pos[r, t:t + n] = np.arange(n)
            seg[r, t:t + n] = i + 1
            ends[r, i] = t + n - 1
            t += n
    return {"tokens": tok, "positions": pos, "segment_ids": seg}, ends
