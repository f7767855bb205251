"""Port parity of chunked prefill: ``LM.prefill_chunk`` against the JAX
model's, slab by slab, for mamba-110m.reduced() and mamba2-370m.reduced()
(JAX side with use_pallas=True: its conv is the Pallas kernel in interpret
mode), at chunks 8 and 7 with a second, shorter row whose later slabs are
part or all padding; the chunk-lane packing helpers, ``reset_cache_rows``
and ``expand_chunk_states`` against the JAX package's.

Tolerance: logits and states at 1e-5 abs + 1e-4 rel (the bar of the
port's packed-equals-per-prompt check, tests/test_torch_model.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

ATOL, RTOL = 1e-5, 1e-4
LENS = (37, 20)             # row 1 runs out of tokens two slabs early
MAX_LEN = 64


def _pair(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    cfg = get_config(arch).reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jmodel, jparams, model


@pytest.fixture(scope="module", params=["mamba-110m", "mamba2-370m"])
def pair(request):
    return (request.param,) + _pair(request.param)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=ATOL,
                               rtol=RTOL)


def _kind(arch):
    return "mamba2" if arch.startswith("mamba2") else "mamba"


@pytest.mark.parametrize("chunk", [8, 7])
def test_prefill_chunk_matches_jax(pair, chunk):
    arch, jmodel, jparams, model = pair
    rng = np.random.default_rng(chunk)
    prompts = [rng.integers(1, model.cfg.vocab, size=n).astype(np.int32)
               for n in LENS]
    jcache = jmodel.init_cache(2, MAX_LEN)
    jclen = jnp.zeros((2,), jnp.int32)
    cache = model.init_cache(2)
    clen = torch.zeros(2, dtype=torch.int32)
    key = f"0_{_kind(arch)}"
    for off, _ in packing.chunk_spans(max(LENS), chunk):
        entries = {i: (p, off, max(0, min(chunk, len(p) - off)))
                   for i, p in enumerate(prompts)}
        batch = packing.suffix_slab(entries, 2, chunk)
        jlg, jcache, jclen = jmodel.prefill_chunk(
            jparams, jcache, {k: jnp.asarray(v) for k, v in batch.items()},
            jclen)
        lg, cache, clen = model.prefill_chunk(cache, batch, clen)
        _close(lg, jlg)
        np.testing.assert_array_equal(clen.numpy(), np.asarray(jclen))
        for k in ("conv", "ssm"):
            _close(cache[k], jcache["units"][key][k])
    np.testing.assert_array_equal(clen.numpy(), LENS)
    # the carried state equals one whole-prompt prefill of each row
    for i, p in enumerate(prompts):
        n = len(p)
        whole_lg, whole, _ = model.prefill(
            {"tokens": p[None],
             "positions": np.arange(n, dtype=np.int32)[None],
             "segment_ids": np.ones((1, n), np.int32)})
        for k in ("conv", "ssm"):
            _close(cache[k][:, i], whole[k][:, 0])
        if i == 0:                       # row 0's last slab ends the prompt
            _close(lg[0], whole_lg[0])


def test_reset_and_expand_match_jax(pair):
    arch, jmodel, jparams, model = pair
    rng = np.random.default_rng(5)
    key = f"0_{_kind(arch)}"
    jc = jmodel.init_cache(3, MAX_LEN)
    tree = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in jc["units"][key].items()}
    jc = {"units": {key: {k: jnp.asarray(v) for k, v in tree.items()}}}
    cache = {k: torch.as_tensor(v) for k, v in tree.items()}
    fresh = np.array([True, False, True])
    jr = jmodel.reset_cache_rows(jc, jnp.asarray(fresh))
    out = model.reset_cache_rows(cache, fresh)
    assert out is cache                  # in place
    jx = jmodel.expand_chunk_states(jr)
    tx = model.expand_chunk_states(cache)
    for k in tree:
        np.testing.assert_array_equal(cache[k].numpy(),
                                      np.asarray(jr["units"][key][k]))
        np.testing.assert_array_equal(tx[k].numpy(),
                                      np.asarray(jx["units"][key][k]))
    assert model.supports_chunked_prefill and jmodel.supports_chunked_prefill


@pytest.mark.parametrize("length,chunk", [(1, 1), (37, 8), (64, 16), (5, 9)])
def test_chunk_spans_match_jax(length, chunk):
    assert packing.chunk_spans(length, chunk) == \
        jpacking.chunk_spans(length, chunk)
    for bad in ((0, chunk), (length, 0)):
        with pytest.raises(ValueError):
            packing.chunk_spans(*bad)


@pytest.mark.parametrize("need", [1, 8, 9, 16, 17, 31, 32, 40])
def test_slab_width_and_needs_chunking_match_jax(need):
    for buckets, size in (((8, 16, 32), 32), ((8, 16, 32), 12),
                          ((64,), 16)):
        assert packing.slab_width(need, buckets, size) == \
            jpacking.slab_width(need, buckets, size)
        assert packing.needs_chunking(need, buckets) == \
            jpacking.needs_chunking(need, buckets)


def test_suffix_slab_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(1, 50, size=30).astype(np.int32)
    b = rng.integers(1, 50, size=9).astype(np.int32)
    entries = {0: (a, 16, 8), 2: (b, 4, 5)}
    got = packing.suffix_slab(entries, 3, 8)
    ref = jpacking.suffix_slab(entries, 3, 8)
    for k in ("tokens", "positions", "segment_ids"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    with pytest.raises(ValueError):
        packing.suffix_slab({0: (a, 0, 9)}, 1, 8)
