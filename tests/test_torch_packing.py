"""Port parity: repro_torch.core.packing (numpy only) builds the same plans
and the same buffers, bit for bit, as repro.core.packing."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _threads import one_thread  # noqa: E402
from repro.core import packing as jpk  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

POLICIES = ["sequential", "sorted_greedy", "first_fit",
            "first_fit_decreasing"]


def _seqs(seed, n=23, lo=1, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _same_batch(a, b):
    for f in ("tokens", "positions", "segment_ids"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.seq_lens == b.seq_lens and a.seq_ids == b.seq_ids


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_pack_ends_unpack_identical(policy, seed):
    seqs = _seqs(seed)
    lens = [len(s) for s in seqs]
    assert tpk.plan_packing(lens, 64, policy) == \
        jpk.plan_packing(lens, 64, policy)
    rows = len(jpk.plan_packing(lens, 64, policy)) + 2
    jb = jpk.pack(seqs, 64, policy=policy, num_rows=rows)
    tb = tpk.pack(seqs, 64, policy=policy, num_rows=rows)
    _same_batch(jb, tb)
    assert tb.padding_rate() == pytest.approx(jb.padding_rate())
    maxseg = max(len(r) for r in tb.seq_lens)
    assert np.array_equal(tpk.segment_ends(tb, maxseg),
                          jpk.segment_ends(jb, maxseg))
    vals = np.random.default_rng(seed).normal(size=(rows, 64, 3))
    for a, b in zip(tpk.unpack(vals, tb), jpk.unpack(vals, jb)):
        assert np.array_equal(a, b)


def test_sorted_greedy_window_and_errors():
    lens = [len(s) for s in _seqs(3)]
    assert tpk.plan_packing(lens, 64, "sorted_greedy", window=5) == \
        jpk.plan_packing(lens, 64, "sorted_greedy", window=5)
    with pytest.raises(ValueError):
        tpk.plan_packing([70], 64)
    with pytest.raises(ValueError):
        tpk.plan_packing([3], 64, "nope")
    tb = tpk.pack(_seqs(4, n=6, lo=1, hi=5), 64)
    with pytest.raises(ValueError):
        tpk.segment_ends(tb, 1)


def test_split_and_pad_to_max_identical():
    seqs = _seqs(5, n=9)
    jb = jpk.pack_with_split(seqs, 32)
    tb = tpk.pack_with_split(seqs, 32)
    _same_batch(jb, tb)
    assert np.array_equal(np.asarray(jb.carry_mask), tb.carry_mask)
    assert tb.carry_mask.any()              # the case the conv must survive
    _same_batch(jpk.pad_to_max(seqs, 30), tpk.pad_to_max(seqs, 30))
