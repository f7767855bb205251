"""Port parity of the Mamba LM at mamba-110m.reduced(): with the JAX
package's weights (``params_from_jax``), forward, prefill, prefill_packed,
scatter_into_cache and decode_step match the JAX model run with
``use_pallas=True`` (its conv is the Pallas kernel in interpret mode).

Tolerance 1e-4 on logits and states: two layers of matmuls summed in a
different order. The packed-equals-per-prompt check inside the port keeps
the JAX test's own bar (1e-5 abs, 1e-4 rel).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

ATOL = 1e-4
PLENS = (9, 14, 5, 11)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba-110m").reduced(),
                               use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in PLENS]
    return jmodel, jparams, model, prompts


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _packed(prompts, rows=2, cap=24, max_segments=3):
    pb = packing.pack(prompts, cap, policy="first_fit", num_rows=rows)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    return pb, batch, packing.segment_ends(pb, max_segments)


def _jcache(tree):
    return tree["units"]["0_mamba"]


def test_forward_matches_jax(pair):
    jmodel, jparams, model, prompts = pair
    _, batch, _ = _packed(prompts)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _close(model.forward(batch), jmodel.forward(jparams, jb))


def test_prefill_matches_jax(pair):
    jmodel, jparams, model, prompts = pair
    pb = packing.pad_to_max(prompts, 16)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    jl, jc, jlen = jmodel.prefill(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 32)
    tl, tc, tlen = model.prefill(batch)
    _close(tl, jl)
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))
    for k in ("conv", "ssm"):
        _close(tc[k], _jcache(jc)[k])


def test_prefill_packed_scatter_decode_match_jax(pair):
    jmodel, jparams, model, prompts = pair
    _, batch, ends = _packed(prompts)
    jl, js, jlens = jmodel.prefill_packed(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 32,
        jnp.asarray(ends))
    tl, ts, tlens = model.prefill_packed(batch, ends)
    _close(tl, jl)
    assert np.array_equal(tlens.numpy(), np.asarray(jlens))
    for k in ("conv", "ssm"):
        assert tuple(ts[k].shape) == _jcache(js)[k].shape
        _close(ts[k], _jcache(js)[k])
    # land every present segment in a slot; the sentinel entries drop
    slots = 5
    src = np.array([0, 1, 3, 4, 2], np.int32)        # (row, seg) flat
    dst = np.array([4, 0, 2, slots, slots], np.int32)
    jcache = jmodel.scatter_into_cache(jmodel.init_cache(slots, 32), js,
                                       jnp.asarray(src), jnp.asarray(dst))
    tcache = model.scatter_into_cache(model.init_cache(slots), ts, src, dst)
    for k in ("conv", "ssm"):
        _close(tcache[k], _jcache(jcache)[k])
    tok = np.array([[3], [7], [1], [9], [4]], np.int32)
    clen = jnp.zeros((slots,), jnp.int32)
    for step in range(3):
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                         clen + step)
        tlg, tcache = model.decode_step(tcache, torch.as_tensor(tok))
        _close(tlg, jlg)
        for k in ("conv", "ssm"):
            _close(tcache[k], _jcache(jcache)[k])
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)


def test_packed_prefill_matches_per_prompt(pair):
    """The port's own PUI check: one packed prefill hands off the same end
    logits and states as per-prompt prefills."""
    _, _, model, prompts = pair
    pb, batch, ends = _packed(prompts)
    logits, states, seg_lens = model.prefill_packed(batch, ends)
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            n = len(prompts[i])
            assert int(seg_lens[r, s]) == n
            lg, cache, _ = model.prefill(
                {"tokens": prompts[i][None],
                 "positions": np.arange(n, dtype=np.int32)[None],
                 "segment_ids": np.ones((1, n), np.int32)})
            _close(logits[r, s], lg[0], atol=1e-5, rtol=1e-4)
            for k in ("conv", "ssm"):
                _close(states[k][:, r, s], cache[k][:, 0], atol=1e-5,
                       rtol=1e-4)
    assert not logits[1, 2].any() and not states["ssm"][:, 1, 2].any()


def test_init_distributions():
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    p = model.layers[0]
    assert torch.equal(p["A_log"][3], torch.log(torch.arange(1., 17.)))
    assert torch.all(p["dt_b"] == -4.6) and torch.all(p["D"] == 1)
    assert torch.all(p["conv_b"] == 0) and torch.all(model.final_norm == 1)
    assert abs(float(p["in_proj"].std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(model.embed.std()) - 0.02) < 0.005
    again = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again.head, model.head)
