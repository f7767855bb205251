"""Serving parity of the hybrid LM: recurrentgemma-2b.reduced() with the
attention window at 8, at 6 layers (two units) and at 8 (two units and the
two tail ``rec`` layers), the port's ``LM`` against the JAX LM on the same
weights (the port's ``init``, carried into the JAX tree). The cache's
``max_len`` is 64, so the K/V ring has min(64, 8) = 8 slots and every
prompt here longer than 8 tokens wraps it.

* ``prefill_packed`` (end logits and every state leaf, the K/V rings
  included), ``prefill``, 12 chained ``decode_step``s from a 13-token
  prompt (the ring wraps; row 1 restarts at step 5, its ``cache_len`` back
  to 0), ``prefill_chunk`` slab by slab (T = 6 < S = 8) and
  ``reset_cache_rows``, against the JAX model: max |Δ| ≤ 1e-4 ·
  max(1, max |ref|), f32.
* the port's packed prefill against its per-prompt ``prefill`` at 1e-5 of
  the same measure (the JAX package's own bar, tests/test_serve.py).
* greedy tokens equal JAX's wherever JAX's top-2 logit margin exceeds 10×
  the tolerance.
* the serving entries take ``max_len`` / ``cache_len`` and refuse the
  family without them.

The JAX side runs jitted, its conv on the XLA path (the plain reference of
the Pallas kernel #1, which tests/test_torch_conv*.py hold the port's #1
to).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _hybrid import LAYERS, configs, flat, jax_params, port_model, tree  # noqa: E402,E501
from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.core import packing  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

TOL = 1e-4
PACKED_TOL = 1e-5
MAX_LEN = 64
RING = 8


class Pair:
    """The port's model and the JAX model's jitted serving entries on the
    same weights."""

    def __init__(self, n_layers):
        self.cfg, jcfg = configs(n_layers)
        self.model = port_model(self.cfg, n_layers)
        self.jparams = jax_params(self.model, self.cfg)
        self.jmodel = jm = build_model(jcfg)
        self.prefill_packed = jax.jit(jm.prefill_packed, static_argnums=2,
                                      **JIT)
        self.prefill = jax.jit(jm.prefill, static_argnums=2, **JIT)
        self.decode_step = jax.jit(jm.decode_step, **JIT)
        self.prefill_chunk = jax.jit(jm.prefill_chunk, **JIT)
        self.init_cache = jax.jit(jm.init_cache, static_argnums=(0, 1),
                                  **JIT)
        self.reset_cache_rows = jax.jit(jm.reset_cache_rows, **JIT)


@pytest.fixture(scope="module", params=sorted(LAYERS))
def pair(request):
    return Pair(LAYERS[request.param])


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def _close_tree(got, ref, tol=TOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], tol)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _one(prompt):
    n = len(prompt)
    return {"tokens": prompt[None],
            "positions": np.arange(n, dtype=np.int32)[None],
            "segment_ids": np.ones((1, n), np.int32)}


def _greedy_agrees(got, ref, tol=TOL):
    """Argmax equal wherever the reference's top-2 margin exceeds 10× the
    tolerance of its row; returns how many rows were decided."""
    got, ref = np.asarray(got), np.asarray(ref)
    top2 = np.sort(ref, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > \
        10 * tol * np.maximum(1.0, np.abs(ref).max(-1))
    assert (got.argmax(-1) == ref.argmax(-1))[sure].all()
    return int(sure.sum())


def test_cache_layout_and_ring():
    cfg, _ = configs(LAYERS["units_plus_tail"])
    model = port_model(cfg, 0)
    cache = model.init_cache(3, MAX_LEN)
    lw, W = cfg.lru_width, cfg.conv_width
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "0_rec.conv": ((3, 3, W - 1, lw), torch.float32),
        "0_rec.h": ((3, 3, lw), torch.float32),
        "1_rec.conv": ((3, 3, W - 1, lw), torch.float32),
        "1_rec.h": ((3, 3, lw), torch.float32),
        "2_attn.k": ((2, 3, RING, cfg.n_kv_heads, cfg.hd), torch.float32),
        "2_attn.v": ((2, 3, RING, cfg.n_kv_heads, cfg.hd), torch.float32)}
    assert model.ring_size(4) == 4 and model.ring_size(MAX_LEN) == RING
    assert model.supports_chunked_prefill


def test_prefill_packed_matches_jax_and_per_prompt(pair):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, pair.cfg.vocab, size=n).astype(np.int32)
               for n in (11, 20, 5, 9, 14)]
    pb = packing.pack(prompts, 32, policy="first_fit", num_rows=2)
    ends = packing.segment_ends(pb, 3)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    logits, states, lens = pair.model.prefill_packed(batch, ends, MAX_LEN)
    jl, js, jlens = pair.prefill_packed(pair.jparams, _jnp(batch), MAX_LEN,
                                        jnp.asarray(ends))
    _close(logits, jl)
    _close_tree(states, flat(js))
    assert states["2_attn.k"].shape[2:4] == (3, RING)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    assert (ends == -1).any()                      # an absent segment
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            lg, cache, n = pair.model.prefill(_one(prompts[i]), MAX_LEN)
            assert int(n[0]) == int(lens[r, s]) == len(prompts[i])
            _close(logits[r, s], lg[0], PACKED_TOL)
            _close_tree({k: v[:, r, s] for k, v in states.items()},
                        {k: v[:, 0] for k, v in cache.items()}, PACKED_TOL)
        for s in range(len(ids), ends.shape[1]):    # absent: zero states
            assert all(bool((v[:, r, s] == 0).all())
                       for v in states.values())


def _rows_batch(rng, cfg, lens):
    L = max(lens)
    toks = np.zeros((len(lens), L), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(1, cfg.vocab, size=n)
    return {"tokens": toks,
            "positions": np.broadcast_to(np.arange(L, dtype=np.int32),
                                         toks.shape).copy(),
            "segment_ids": (np.arange(L)[None] < np.asarray(lens)[:, None])
            .astype(np.int32)}


def test_prefill_and_decode_steps_match_jax(pair):
    """Per-row prefill of two prompts (13 and 5 tokens: the first wraps
    the 8-slot ring, the second leaves it short), against JAX's; then 12
    chained steps on both models on the JAX model's greedy tokens, each
    row at its own ``cache_len``; row 1 restarts at step 5 (``reset``,
    its cache_len back to 0)."""
    rng = np.random.default_rng(2)
    batch = _rows_batch(rng, pair.cfg, (13, 5))
    lg, cache, clen = pair.model.prefill(batch, MAX_LEN)
    jlg, jcache, jclen = pair.prefill(pair.jparams, _jnp(batch), MAX_LEN)
    _close(lg, jlg)
    _close_tree(cache, flat(jcache))
    np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
    jcache = tree(cache, pair.cfg)
    cl = clen.numpy().astype(np.int32)
    decided = 0
    for step in range(12):
        tok = np.array(jnp.argmax(jlg, -1), np.int32)[:, None]
        reset = np.array([False, step == 5])
        cl = np.where(reset, 0, cl).astype(np.int32)
        lg, cache = pair.model.decode_step(
            cache, torch.as_tensor(tok), torch.as_tensor(reset),
            cache_len=torch.as_tensor(cl))
        jlg, jcache = pair.decode_step(pair.jparams, jcache, jnp.asarray(tok),
                                       jnp.asarray(cl), jnp.asarray(reset))
        _close(lg, jlg)
        decided += _greedy_agrees(lg, jlg)
        cl = cl + 1
    _close_tree(cache, flat(jcache))
    assert cl[0] == 25 and decided > 0


def test_prefill_chunk_matches_jax(pair):
    """Two long prompts (17 and 10 tokens) in slabs of 6 < the ring's 8:
    the carried conv tail, the RG-LRU state and the ring (attended first,
    written after) slab by slab; row 1's last slab is all padding."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, pair.cfg.vocab, size=n).astype(np.int32)
               for n in (17, 10)]
    cache = pair.model.init_cache(2, MAX_LEN)
    jcache = pair.init_cache(2, MAX_LEN)
    _close_tree(cache, flat(jcache), 0.0)
    clen = torch.zeros(2, dtype=torch.int32)
    jclen = jnp.zeros((2,), jnp.int32)
    for off, _ in packing.chunk_spans(17, 6):
        entries = {i: (p, off, max(0, min(6, len(p) - off)))
                   for i, p in enumerate(prompts)}
        batch = packing.suffix_slab(entries, 2, 6)
        lg, cache, clen = pair.model.prefill_chunk(cache, batch, clen)
        jlg, jcache, jclen = pair.prefill_chunk(pair.jparams, jcache,
                                                _jnp(batch), jclen)
        _close(lg[0], jlg[0])
        _close_tree(cache, flat(jcache))
    np.testing.assert_array_equal(clen.numpy(), [17, 10])


def test_reset_cache_rows_matches_jax(pair):
    rng = np.random.default_rng(4)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)),
        jax.eval_shape(lambda: pair.jmodel.init_cache(3, MAX_LEN)))
    cache = {k: torch.as_tensor(v.copy()) for k, v in flat(jc).items()}
    fresh = np.array([True, False, True])
    out = pair.model.reset_cache_rows(cache, fresh)
    assert out is cache                              # in place
    _close_tree(cache, flat(pair.reset_cache_rows(jc, jnp.asarray(fresh))),
                0.0)
    for k, v in cache.items():                       # the rings too
        assert bool((v[:, fresh] == 0).all()), k
        assert not bool((v[:, 1] == 0).any()), k


def test_serving_entries_need_max_len_and_cache_len():
    cfg, _ = configs(LAYERS["units"])
    model = port_model(cfg, 5)
    b = _one(np.arange(1, 6, dtype=np.int32))
    cache = model.init_cache(1, MAX_LEN)
    calls = {"max_len": [lambda: model.init_cache(1),
                         lambda: model.prefill(b),
                         lambda: model.prefill_packed(
                             b, np.array([[4]], np.int32))],
             "cache_len": [lambda: model.decode_step(cache, b["tokens"][:, :1]),
                           lambda: model.decode_verify(
                               cache, b["tokens"][:, :1], b["tokens"][:, 1:3])]}
    for name, fns in calls.items():
        for call in fns:
            with pytest.raises(ValueError, match=name):
                call()
