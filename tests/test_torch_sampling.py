"""The port's batched sampler (``blocks.sample_from_logits``) against the
JAX package's.

The JAX sampler draws its Gumbel noise from ``jax.random`` keys folded from
(seed, rid); the port draws it from a counter-based integer hash of
(seed, rid, token index, vocab index), so single draws differ and the
distributions must agree: a two-sample chi-square of 4096 port draws
against 4096 JAX draws per case (fixed seeds, so the test is deterministic),
and both against the exact probabilities of the kept set. The threshold
rules (top-k and top-p keep every logit ``>=`` their threshold) are held
exactly: ties at a threshold stay in. Also the JAX sanity cases, the hash
arithmetic and its uniforms.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.models import blocks as JB  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

DRAWS = 4096
P_MIN = 1e-3            # chi-square p-value bar (deterministic seeds)


def _port(logits, seed, temp, top_k, top_p, ctr=0):
    n = logits.shape[0]
    tok, ctr1 = B.sample_from_logits(
        torch.as_tensor(logits),
        torch.as_tensor(B.request_streams(seed, np.arange(n))),
        torch.full((n,), ctr, dtype=torch.int64),
        torch.full((n,), temp, dtype=torch.float32),
        torch.full((n,), top_k, dtype=torch.int64),
        torch.full((n,), top_p, dtype=torch.float32))
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(ctr1.numpy(), ctr + 1)
    return tok.numpy()


def _jax(logits, seed, temp, top_k, top_p):
    n = logits.shape[0]
    tok, _ = JB.sample_from_logits(
        jnp.asarray(logits), JB.request_keys(seed, np.arange(n)),
        jnp.full((n,), temp, jnp.float32), jnp.full((n,), top_k, jnp.int32),
        jnp.full((n,), top_p, jnp.float32))
    return np.asarray(tok)


def _kept_probs(lg, temp, top_k, top_p):
    """The rule in numpy, float64: keep logits >= the k-th largest and >=
    the last of the smallest sorted prefix whose mass before it < top_p;
    then softmax(kept / temp)."""
    lg = lg.astype(np.float64)
    s = np.sort(lg)[::-1]
    keep = np.ones_like(lg, bool)
    if top_k > 0:
        keep &= lg >= s[top_k - 1]
    p = np.exp(s - s.max())
    p /= p.sum()
    before = np.cumsum(p) - p
    nkeep = int((before < top_p).sum())
    keep &= lg >= s[max(nkeep, 1) - 1]
    z = np.where(keep, lg / temp, -np.inf)
    e = np.exp(z - z.max())
    return e / e.sum()


def _binned(counts_a, counts_b, expected=None, min_count=10):
    """Merge the vocab bins whose joint count is under ``min_count`` into
    one (dropped when it is empty), so every chi-square cell has a usable
    expectation."""
    small = counts_a + counts_b < min_count
    cols = [counts_a[~small], counts_b[~small]]
    e = None if expected is None else expected[~small]
    if counts_a[small].sum() + counts_b[small].sum() > 0:
        cols = [np.append(c, x[small].sum())
                for c, x in zip(cols, (counts_a, counts_b))]
        if e is not None:
            e = np.append(e, expected[small].sum())
    return cols if expected is None else (cols, e)


CASES = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.8, 40, 0.95)]


@pytest.mark.parametrize("temp,top_k,top_p", CASES)
def test_distribution_matches_jax_chi_square(temp, top_k, top_p):
    V = 64
    rng = np.random.default_rng(11)
    row = (rng.normal(size=V) * 1.5).astype(np.float32)
    logits = np.tile(row, (DRAWS, 1))
    t = np.bincount(_port(logits, 5, temp, top_k, top_p), minlength=V)
    j = np.bincount(_jax(logits, 5, temp, top_k, top_p), minlength=V)
    probs = _kept_probs(row, temp, top_k, top_p)
    assert not t[probs == 0].any() and not j[probs == 0].any()
    table = _binned(t, j)
    assert stats.chi2_contingency(np.stack(table))[1] > P_MIN
    for counts in (t, j):
        (obs, _), exp = _binned(counts, counts, probs * DRAWS, min_count=20)
        assert stats.chisquare(obs, exp * obs.sum() / exp.sum())[1] > P_MIN


def test_threshold_ties_are_kept():
    """top-k and top-p keep every logit equal to their threshold (``>=``):
    three logits tie at the 2nd place, so top_k=2 keeps four tokens, and so
    does a top_p whose prefix ends on the tie."""
    row = np.array([5.0, 4.0, 4.0, 4.0, 1.0, 0.0, -3.0], np.float32)
    logits = np.tile(row, (DRAWS, 1))
    for k, p in ((2, 1.0), (0, 0.5)):
        probs = _kept_probs(row, 1.0, k, p)
        assert set(np.flatnonzero(probs)) == {0, 1, 2, 3}
        for draws in (_port(logits, 1, 1.0, k, p), _jax(logits, 1, 1.0, k,
                                                         p)):
            assert set(draws.tolist()) == {0, 1, 2, 3}


def test_sampling_distribution_sanity():
    """The JAX test's unit contract: greedy at temperature 0; top-k=1 and a
    tiny top-p collapse to the argmax; hot top-k=3 stays in the top-3 set
    and spreads over more than one token."""
    logits = np.tile(np.array([4.0, 3.5, 3.0, -1.0, -2.0, -30.0],
                              np.float32), (64, 1))
    np.testing.assert_array_equal(_port(logits, 3, 0.0, 0, 1.0), 0)
    np.testing.assert_array_equal(_port(logits, 3, 2.0, 1, 1.0), 0)
    np.testing.assert_array_equal(_port(logits, 3, 2.0, 0, 1e-4), 0)
    t = _port(logits, 3, 2.0, 3, 1.0)
    assert set(t.tolist()) <= {0, 1, 2} and len(set(t.tolist())) > 1
    # the token index moves the draw: the same rows at counter 7 differ
    assert not np.array_equal(t, _port(logits, 3, 2.0, 3, 1.0, ctr=7))


def test_hash_arithmetic():
    """``_mul32`` is the exact product mod 2^32 on Python ints, numpy int64
    and torch int64 alike; ``_mix32`` agrees across the three."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 2 ** 32, size=2000, dtype=np.int64)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF, 1):
        ref = np.array([(int(x) * c) % 2 ** 32 for x in xs], np.int64)
        np.testing.assert_array_equal(B._mul32(xs, c), ref)
        np.testing.assert_array_equal(B._mul32(torch.as_tensor(xs), c)
                                      .numpy(), ref)
    mixed = B._mix32(xs)
    np.testing.assert_array_equal(B._mix32(torch.as_tensor(xs)).numpy(),
                                  mixed)
    assert [B._mix32(int(x)) for x in xs[:20]] == mixed[:20].tolist()
    assert len(np.unique(mixed)) == len(np.unique(xs))     # a bijection


def test_uniforms_and_streams():
    streams = B.request_streams(0, np.arange(4096))
    assert streams.dtype == np.int64 and len(np.unique(streams)) == 4096
    assert ((streams >= 0) & (streams < 2 ** 32)).all()
    np.testing.assert_array_equal(B.request_streams(0, [7]), streams[7:8])
    assert B.request_streams(1, [7])[0] != streams[7]
    st = torch.as_tensor(streams[:64])
    u = B.sample_uniforms(st, torch.zeros(64, dtype=torch.int64), 512)
    assert u.dtype == torch.float32 and u.shape == (64, 512)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005                # 32768 draws
    assert abs(float(u.var()) - 1 / 12) < 0.002
    again = B.sample_uniforms(st, torch.zeros(64, dtype=torch.int64), 512)
    assert torch.equal(u, again)
    nxt = B.sample_uniforms(st, torch.ones(64, dtype=torch.int64), 512)
    assert not torch.equal(u, nxt)
    # neighbouring counters and vocab entries are uncorrelated
    r = np.corrcoef(u.numpy().ravel(), nxt.numpy().ravel())[0, 1]
    assert abs(r) < 0.02
    r = np.corrcoef(u[:, :-1].numpy().ravel(), u[:, 1:].numpy().ravel())[0, 1]
    assert abs(r) < 0.02


def test_decode_step_sample_greedy_rows_are_argmax():
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(3)
    toks = torch.tensor([[5], [9], [11]], dtype=torch.int32)
    stream = torch.as_tensor(B.request_streams(0, [0, 1, 2]))
    ctr = torch.tensor([0, 4, 2])
    temp = torch.tensor([0.0, 0.9, 0.0])
    tok, logits, _, ctr1 = model.decode_step_sample(
        cache, toks, stream, ctr, temp, torch.tensor([0, 8, 0]),
        torch.tensor([1.0, 0.9, 1.0]))
    ref, _ = model.decode_step(model.init_cache(3), toks)
    assert torch.equal(logits, ref)
    np.testing.assert_array_equal(tok[[0, 2]].numpy(),
                                  ref.argmax(-1)[[0, 2]].numpy())
    np.testing.assert_array_equal(ctr1.numpy(), [1, 5, 3])
    t2, _ = model.sample_tokens(logits, stream, ctr, temp,
                                torch.tensor([0, 8, 0]),
                                torch.tensor([1.0, 0.9, 1.0]))
    assert torch.equal(t2, tok)
