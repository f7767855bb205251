"""Sequence packing: the paper's pack()/unpack() and packing policies.

A numpy copy of ``repro.core.packing`` (which imports JAX): the same plans
and the same buffers, bit for bit. A *packed batch* is a fixed-shape
(B, L) buffer holding several variable-length sequences back to back, with

  * ``positions``   (B, L) int32 — offset of each token inside its own
    sequence; ``positions == 0`` marks a sequence start (conv tap
    truncation, scan Ā→0 reset);
  * ``segment_ids`` (B, L) int32 — 1-based sequence id, 0 for padding.

Callers move the buffers to their device with ``torch.as_tensor``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    """One packed batch. All arrays shaped (B, L) unless noted."""

    tokens: np.ndarray         # int32 token ids (0 in padding)
    positions: np.ndarray      # int32 intra-sequence positions
    segment_ids: np.ndarray    # int32, 1-based per sequence, 0 = padding
    seq_lens: Optional[List[List[int]]] = None   # per row: lengths in order
    seq_ids: Optional[List[List[int]]] = None    # per row: input indices

    def padding_rate(self) -> float:
        return float(np.mean(self.segment_ids == 0))


def _plan_sequential(lengths: Sequence[int], capacity: int) -> List[List[int]]:
    """Paper default: arrival order, seal buffer when next seq does not fit."""
    rows: List[List[int]] = []
    cur: List[int] = []
    used = 0
    for i, n in enumerate(lengths):
        if n > capacity:
            raise ValueError(f"sequence {i} length {n} exceeds capacity {capacity}")
        if used + n > capacity:
            rows.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += n
    if cur:
        rows.append(cur)
    return rows


def _plan_sorted_greedy(lengths: Sequence[int], capacity: int,
                        window: int = 0) -> List[List[int]]:
    """Paper §5 local greedy: sort (a window of) sequences desc, first-fit."""
    order = list(range(len(lengths)))
    if window and window < len(order):
        chunks = [order[i:i + window] for i in range(0, len(order), window)]
        order = [j for ch in chunks
                 for j in sorted(ch, key=lambda k: -lengths[k])]
    else:
        order.sort(key=lambda k: -lengths[k])
    return _plan_first_fit(lengths, capacity, order)


def _plan_first_fit(lengths: Sequence[int], capacity: int,
                    order: Optional[Sequence[int]] = None) -> List[List[int]]:
    rows: List[List[int]] = []
    space: List[int] = []
    for i in (order if order is not None else range(len(lengths))):
        n = lengths[i]
        if n > capacity:
            raise ValueError(f"sequence {i} length {n} exceeds capacity {capacity}")
        for r, s in enumerate(space):
            if s >= n:
                rows[r].append(i)
                space[r] -= n
                break
        else:
            rows.append([i])
            space.append(capacity - n)
    return rows


def _plan_first_fit_decreasing(lengths: Sequence[int],
                               capacity: int) -> List[List[int]]:
    """Classic FFD bin packing: first-fit over lengths sorted descending."""
    order = sorted(range(len(lengths)), key=lambda k: -lengths[k])
    return _plan_first_fit(lengths, capacity, order)


_POLICIES = {
    "sequential": _plan_sequential,
    "sorted_greedy": _plan_sorted_greedy,
    "first_fit": _plan_first_fit,
    "first_fit_decreasing": _plan_first_fit_decreasing,
}


def plan_packing(lengths: Sequence[int], capacity: int,
                 policy: str = "sequential", **kw) -> List[List[int]]:
    """Return list of rows; each row is a list of sequence indices."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown packing policy {policy!r}; have {list(_POLICIES)}")
    return _POLICIES[policy](lengths, capacity, **kw)


def pack(sequences: Sequence[np.ndarray], capacity: int,
         policy: str = "sequential", num_rows: Optional[int] = None,
         **kw) -> PackedBatch:
    """Pack 1-D int token sequences into a (B, L=capacity) PackedBatch.
    ``num_rows`` fixes B; extra rows are all padding."""
    lengths = [int(s.shape[0]) for s in sequences]
    rows = plan_packing(lengths, capacity, policy, **kw)
    B = num_rows if num_rows is not None else len(rows)
    if len(rows) > B:
        raise ValueError(f"packing plan needs {len(rows)} rows > num_rows={B}")
    tokens = np.zeros((B, capacity), dtype=np.int32)
    positions = np.zeros((B, capacity), dtype=np.int32)
    segment_ids = np.zeros((B, capacity), dtype=np.int32)
    seq_lens: List[List[int]] = [[] for _ in range(B)]
    seq_ids: List[List[int]] = [[] for _ in range(B)]
    for r, row in enumerate(rows):
        off = 0
        for seg, i in enumerate(row, start=1):
            n = lengths[i]
            tokens[r, off:off + n] = np.asarray(sequences[i], dtype=np.int32)
            positions[r, off:off + n] = np.arange(n, dtype=np.int32)
            segment_ids[r, off:off + n] = seg
            seq_lens[r].append(n)
            seq_ids[r].append(i)
            off += n
    return PackedBatch(tokens, positions, segment_ids, seq_lens, seq_ids)


def unpack(batch_values, packed: PackedBatch) -> List[np.ndarray]:
    """Inverse of pack(): split a (B, L, ...) value array back into per-
    sequence arrays, in input order."""
    if packed.seq_lens is None or packed.seq_ids is None:
        raise ValueError("PackedBatch lacks unpack bookkeeping")
    vals = np.asarray(batch_values)
    pieces: dict[int, list] = {}
    for r, (lens, ids) in enumerate(zip(packed.seq_lens, packed.seq_ids)):
        off = 0
        for n, i in zip(lens, ids):
            pieces.setdefault(i, []).append(vals[r, off:off + n])
            off += n
    return [np.concatenate(pieces[i], axis=0) for i in sorted(pieces)]


def segment_ends(packed: PackedBatch, max_segments: int) -> np.ndarray:
    """Last-token index of each packed segment, −1-padded to
    (B, max_segments) — the ``ends`` input of ``LM.prefill_packed``."""
    if packed.seq_lens is None:
        raise ValueError("PackedBatch lacks seq_lens bookkeeping")
    B = packed.tokens.shape[0]
    ends = np.full((B, max_segments), -1, np.int32)
    for r, lens in enumerate(packed.seq_lens):
        if len(lens) > max_segments:
            raise ValueError(f"row {r} holds {len(lens)} segments "
                             f"> max_segments={max_segments}")
        off = 0
        for s, n in enumerate(lens):
            off += n
            ends[r, s] = off - 1
    return ends


# ---------------------------------------------------------------------------
# chunk-aware planning (serving: chunked prefill of over-bucket prompts)
# ---------------------------------------------------------------------------

def chunk_spans(length: int, chunk: int) -> List[tuple]:
    """Fixed-size chunk plan for one long sequence: [(offset, n), …] with
    n == chunk everywhere but a possibly short final span; each span is one
    ``LM.prefill_chunk`` resuming from the carried state."""
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return [(off, min(chunk, length - off))
            for off in range(0, length, chunk)]


def needs_chunking(length: int, buckets: Sequence[int]) -> bool:
    """True when a prompt cannot ride the packed-prefill bucket lane and
    must be consumed by the chunked-prefill lane instead."""
    return length > max(buckets)


def slab_width(need: int, buckets: Sequence[int], chunk_size: int) -> int:
    """Width of the next chunked-prefill slab: the smallest candidate ≥
    ``need`` (tokens the hungriest chunk row wants this round), capped at
    ``chunk_size``. Candidates are the prefill buckets ≤ chunk_size plus
    chunk_size itself, so the slab shapes stay bounded by the bucket list."""
    cands = sorted({b for b in buckets if b <= chunk_size} | {chunk_size})
    for c in cands:
        if c >= need:
            return c
    return chunk_size


def suffix_slab(entries, num_rows: int, width: int):
    """One fixed-shape (num_rows, width) chunk-lane slab: ``entries`` maps
    row → (tokens, offset, take), and that row carries
    ``tokens[offset : offset + take]`` at GLOBAL positions. Unoccupied rows
    and the tail beyond ``take`` are segment_ids-0 padding (exact state
    no-ops in ``LM.prefill_chunk``). Returns the tokens/positions/
    segment_ids batch dict of numpy arrays."""
    toks = np.zeros((num_rows, width), np.int32)
    pos = np.zeros((num_rows, width), np.int32)
    seg = np.zeros((num_rows, width), np.int32)
    for i, (tokens, off, take) in entries.items():
        if not 0 <= take <= width:
            raise ValueError(f"row {i}: take {take} outside slab width "
                             f"{width}")
        toks[i, :take] = tokens[off:off + take]
        pos[i, :take] = np.arange(off, off + take)
        seg[i, :take] = 1
    return {"tokens": toks, "positions": pos, "segment_ids": seg}


@dataclasses.dataclass
class SplitPackedBatch(PackedBatch):
    """Packing with boundary splitting (paper §5 future work): a sequence
    may be cut at a row boundary. ``carry_mask`` (B,) marks rows whose
    first token continues a sequence cut in the previous row — such a row
    starts with ``positions > 0``."""
    carry_mask: Optional[np.ndarray] = None


def pack_with_split(sequences: Sequence[np.ndarray], capacity: int,
                    num_rows: Optional[int] = None) -> SplitPackedBatch:
    stream = np.concatenate([np.asarray(s, np.int32) for s in sequences])
    lengths = [int(s.shape[0]) for s in sequences]
    pos = np.concatenate([np.arange(n, dtype=np.int32) for n in lengths])
    seg = np.concatenate([np.full(n, i + 1, dtype=np.int32)
                          for i, n in enumerate(lengths)])
    total = stream.shape[0]
    B = int(np.ceil(total / capacity)) if num_rows is None else num_rows
    pad = B * capacity - total
    if pad < 0:
        raise ValueError(f"num_rows={num_rows} too small for {total} tokens")
    tokens = np.pad(stream, (0, pad)).reshape(B, capacity)
    positions = np.pad(pos, (0, pad)).reshape(B, capacity)
    segment_ids = np.pad(seg, (0, pad)).reshape(B, capacity)
    carry = (positions[:, 0] > 0) & (segment_ids[:, 0] > 0)
    seq_lens: List[List[int]] = []
    seq_ids: List[List[int]] = []
    for r in range(B):
        row_ids, row_lens = [], []
        for s in np.unique(segment_ids[r]):
            if s == 0:
                continue
            row_ids.append(int(s) - 1)
            row_lens.append(int((segment_ids[r] == s).sum()))
        seq_lens.append(row_lens)
        seq_ids.append(row_ids)
    return SplitPackedBatch(tokens, positions, segment_ids, seq_lens, seq_ids,
                            carry_mask=carry)


def pad_to_max(sequences: Sequence[np.ndarray], max_len: int) -> PackedBatch:
    """Paper baseline: one sequence per row, zero-padded to max_len."""
    B = len(sequences)
    tokens = np.zeros((B, max_len), dtype=np.int32)
    positions = np.zeros((B, max_len), dtype=np.int32)
    segment_ids = np.zeros((B, max_len), dtype=np.int32)
    seq_lens, seq_ids = [], []
    for r, s in enumerate(sequences):
        n = min(int(s.shape[0]), max_len)
        tokens[r, :n] = np.asarray(s[:n], np.int32)
        positions[r, :n] = np.arange(n, dtype=np.int32)
        segment_ids[r, :n] = 1
        seq_lens.append([n])
        seq_ids.append([r])
    return PackedBatch(tokens, positions, segment_ids, seq_lens, seq_ids)
