"""Serving parity of the dense LM: stablelm-1.6b.reduced() (GQA 4 on 2,
SwiGLU) and gemma-7b.reduced() (GeGLU, tied), 2 layers, the port's ``LM``
against the JAX LM on the same weights (the port's ``init``, carried into
the JAX tree). The cache's ``max_len`` is 64: each layer's K/V keeps 64
slots, slot t holding token t (no window, so nothing wraps).

* ``prefill_packed`` (end logits and every segment's K/V), ``prefill``,
  20 chained ``decode_step``s (row 1 restarts at step 7, its
  ``cache_len`` back to 0), ``prefill_chunk`` over 3 slabs,
  ``decode_verify`` (K 3: its tokens and every trajectory entry) and
  ``spec_rollback``, and ``reset_cache_rows``, against the JAX model:
  max |Δ| ≤ 1e-5 · max(1, max |ref|), f32.
* the port's packed prefill against its per-prompt ``prefill`` at the
  same bar; greedy tokens equal JAX's wherever JAX's top-2 logit margin
  exceeds 10× the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _dense import ARCHS, configs, flat, jax_params, port_model, tree  # noqa: E402,E501
from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.core import packing  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

TOL = 1e-5
MAX_LEN = 64


class Pair:
    """The port's model and the JAX model's jitted serving entries on the
    same weights."""

    def __init__(self, arch):
        self.cfg, jcfg = configs(arch)
        self.model = port_model(self.cfg, 1)
        self.jparams = jax_params(self.model, self.cfg)
        self.jmodel = jm = build_model(jcfg)
        self.prefill_packed = jax.jit(jm.prefill_packed, static_argnums=2,
                                      **JIT)
        self.prefill = jax.jit(jm.prefill, static_argnums=2, **JIT)
        self.decode_step = jax.jit(jm.decode_step, **JIT)
        self.prefill_chunk = jax.jit(jm.prefill_chunk, **JIT)
        self.decode_verify = jax.jit(jm.decode_verify, **JIT)
        self.spec_rollback = jax.jit(jm.spec_rollback, **JIT)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


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


def test_cache_layout():
    cfg, _ = configs("stablelm-1.6b")
    model = port_model(cfg, 0)
    cache = model.init_cache(3, MAX_LEN)
    shape = (2, 3, MAX_LEN, cfg.n_kv_heads, cfg.hd)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "0_attn.k": (shape, torch.float32), "0_attn.v": (shape, torch.float32)}
    assert model.ring_size(MAX_LEN) == MAX_LEN and model.has_ring
    assert model.supports_chunked_prefill


def test_prefill_packed_matches_jax_and_per_prompt(pair):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, pair.cfg.vocab, size=n).astype(np.int32)
               for n in (11, 20, 5, 9, 14, 7, 3)]
    pb = packing.pack(prompts, 32, policy="first_fit", num_rows=3)
    ends = packing.segment_ends(pb, 4)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    logits, states, lens = pair.model.prefill_packed(batch, ends, MAX_LEN)
    jl, js, jlens = pair.prefill_packed(pair.jparams, _jnp(batch), MAX_LEN,
                                        jnp.asarray(ends))
    _close(logits, jl)
    _close_tree(states, flat(js))
    assert states["0_attn.k"].shape[:4] == (2, 3, 4, MAX_LEN)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    assert max(map(len, pb.seq_ids)) >= 3 and (ends == -1).any()
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            lg, cache, n = pair.model.prefill(_one(prompts[i]), MAX_LEN)
            assert int(n[0]) == int(lens[r, s]) == len(prompts[i])
            _close(logits[r, s], lg[0])
            _close_tree({k: v[:, r, s] for k, v in states.items()},
                        {k: v[:, 0] for k, v in cache.items()})
        for s in range(len(ids), ends.shape[1]):    # absent: zero states
            assert all(bool((v[:, r, s] == 0).all())
                       for v in states.values())


def test_prefill_and_decode_steps_match_jax(pair):
    """Per-row prefill of two prompts (13 and 5 tokens) against JAX's;
    then 20 chained steps on both models on the JAX model's greedy
    tokens, each row at its own ``cache_len``; row 1 restarts at step 7
    (``reset``, its cache_len back to 0, the slots it wrote before left
    as they are: the mask ``idx ≤ cache_len`` hides them)."""
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
    for step in range(20):
        tok = np.array(jnp.argmax(jlg, -1), np.int32)[:, None]
        reset = np.array([False, step == 7])
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
    assert cl.tolist() == [33, 13] and decided > 0


def test_prefill_chunk_matches_jax(pair):
    """Two long prompts (17 and 10 tokens) in 3 slabs of 6: each slab
    attends to the cached prefix and its own causal keys, then writes its
    K/V at slots cache_len + t; row 1's last slab is all padding."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, pair.cfg.vocab, size=n).astype(np.int32)
               for n in (17, 10)]
    cache = pair.model.init_cache(2, MAX_LEN)
    jcache = pair.jmodel.init_cache(2, MAX_LEN)
    _close_tree(cache, flat(jcache), 0.0)
    clen = torch.zeros(2, dtype=torch.int32)
    jclen = jnp.zeros((2,), jnp.int32)
    spans = list(packing.chunk_spans(17, 6))
    assert len(spans) == 3
    for off, _ in spans:
        entries = {i: (p, off, max(0, min(6, len(p) - off)))
                   for i, p in enumerate(prompts)}
        batch = packing.suffix_slab(entries, 2, 6)
        lg, cache, clen = pair.model.prefill_chunk(cache, batch, clen)
        jlg, jcache, jclen = pair.prefill_chunk(pair.jparams, jcache,
                                                _jnp(batch), jclen)
        _close(lg[0], jlg[0])
        _close_tree(cache, flat(jcache))
    np.testing.assert_array_equal(clen.numpy(), [17, 10])
    # the whole prompt's prefill gives the same cache and last logits
    lg, whole, _ = pair.model.prefill(_one(prompts[0]), MAX_LEN)
    _close_tree({k: v[:, :1] for k, v in cache.items()}, whole)


def test_decode_verify_and_spec_rollback_match_jax(pair):
    """``decode_verify`` at K 3 from a prefilled cache (rows at
    ``cache_len`` 13 and 5): its argmax tokens and every entry of the
    trajectory (K+1 copies of the cache) equal JAX's; ``spec_rollback``
    to entries (2, 0) equals JAX's select, written into the cache."""
    rng = np.random.default_rng(4)
    batch = _rows_batch(rng, pair.cfg, (13, 5))
    lg, cache, clen = pair.model.prefill(batch, MAX_LEN)
    jcache = tree(cache, pair.cfg)
    tok = np.array(torch.argmax(lg, -1), np.int32)[:, None]
    draft = rng.integers(1, pair.cfg.vocab, size=(2, 3)).astype(np.int32)
    toks, fins, traj = pair.model.decode_verify(
        cache, torch.as_tensor(tok), torch.as_tensor(draft), cache_len=clen)
    jtoks, jfins, jtraj = pair.decode_verify(
        pair.jparams, jcache, jnp.asarray(tok), jnp.asarray(clen.numpy()),
        jnp.asarray(draft))
    assert toks.shape == (2, 4) and bool(fins.all()) and bool(
        np.asarray(jfins).all())
    jflat = flat({"units": {n: {k: jnp.moveaxis(v, 0, 1)
                                for k, v in leaves.items()}
                            for n, leaves in jtraj["units"].items()}})
    for k, v in traj.items():                        # (K+1, layers, B, …)
        _close(v.movedim(0, 1), jflat[k])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    idx = np.array([2, 0], np.int32)
    out = pair.model.spec_rollback(cache, traj, torch.as_tensor(idx))
    assert out is cache
    _close_tree(cache, flat(pair.spec_rollback(jtraj, jnp.asarray(idx))))


def test_reset_cache_rows_matches_jax(pair):
    rng = np.random.default_rng(5)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)),
        jax.eval_shape(lambda: pair.jmodel.init_cache(3, MAX_LEN)))
    cache = {k: torch.as_tensor(v.copy()) for k, v in flat(jc).items()}
    fresh = np.array([True, False, True])
    out = pair.model.reset_cache_rows(cache, fresh)
    assert out is cache
    _close_tree(cache, flat(pair.jmodel.reset_cache_rows(
        jc, jnp.asarray(fresh))), 0.0)
    for k, v in cache.items():
        assert bool((v[:, fresh] == 0).all()), k
        assert not bool((v[:, 1] == 0).any()), k
