"""Wall-clock measurement for the tuner: *interleaved min-of-rounds* (the
port's own copy of the JAX package's ``benchmarks/timing.py`` helper).

Every candidate cell is warmed first, then timed round-robin — each round
times every cell once — and each cell keeps its best round. Interleaving
puts a drift of the machine's load on every cell of a round instead of on
whichever cell owned a contiguous block; the minimum drops the drifting
rounds. ``clock`` and ``sync`` are injectable, so tests drive the loop
with a fake clock and no device work.

One addition to the JAX protocol: each timed call directly follows an
untimed call of the same cell. On an H100 a kernel candidate's call right
after a slow plain candidate's ran slower than its next call (the cause is
not measured; the allocator made no cudaMalloc or cudaFree in it), and in
a round of the JAX protocol it always runs there: that was enough to flip
the Mamba-1 winner between ``step`` and ``blocked`` (PERF.md §6, PR 23).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Sequence, Tuple


def _first_tensor(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _default_sync(x):
    """Wait for the card when the result lives on it; on the CPU the result
    is ready when the call returns."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        import torch
        torch.cuda.synchronize(t.device)
    return x


def interleaved_min_of_rounds(
        cells: Sequence[Tuple[str, Callable[[], object]]],
        rounds: int = 7, warmup: int = 1,
        clock: Callable[[], float] = time.perf_counter,
        sync: Callable[[object], object] = _default_sync,
) -> Tuple[Dict[str, float], Dict[str, object]]:
    """Time ``cells`` — (name, thunk) pairs — under the protocol above.

    Each thunk runs one whole measurement unit (one scan call, one forward
    and backward); ``sync`` waits for its result before the clock stops.
    Returns (best_us, last_result): each cell's best round in microseconds
    and its last synced result.
    """
    best: Dict[str, float] = {}
    last: Dict[str, object] = {}
    for name, thunk in cells:               # build / allocator warm-up
        for _ in range(warmup):
            last[name] = sync(thunk())
        best[name] = float("inf")
    for _ in range(rounds):
        for name, thunk in cells:
            sync(thunk())                   # the untimed re-warm
            t0 = clock()
            r = thunk()
            sync(r)
            best[name] = min(best[name], (clock() - t0) * 1e6)
            last[name] = r
    return best, last
