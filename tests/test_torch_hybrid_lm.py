"""Port parity of the hybrid LM (slice 5c-i): recurrentgemma-2b.reduced()
with the attention window at 8, the port's ``LM`` against the JAX LM on
the same weights (the port's ``init``, carried into the JAX tree) and the
same packed batch.

* ``LM.loss`` within 1e-5 of JAX's and every gradient leaf within 1e-4 abs
  + 1e-3 rel, at 6 layers (two units) and at 8 (two units and the two
  tail ``rec`` layers, which reuse the unit's prefix); a leaf that misses
  is named with its layer.
* No gradient crosses a reset: the stack's output on a row's second
  segment has a gradient of exactly 0 on every input of its first.
* Packing invariance of the whole model (tests/test_pui.py's
  ``test_pui_whole_model_logits``): packed logits equal per-sequence
  logits at 5e-3 abs / 1e-3 rel.
* The tied embedding: no ``head``; the √d_model scale rounded to the
  compute dtype first (50.5 in bf16 at d = 2560), as the JAX ``_embed``;
  its gradient the gather's part plus the head's.
* The layout: ``unit_layout`` names, units and tail (the JAX
  ``tests/test_models.py::test_pattern_units``), and the interop round
  trip both ways.
* The serving entries (and ``ServeEngine``) serve the family
  (tests/test_torch_hybrid_serve.py and tests/test_torch_hybrid_engine.py
  hold them to the JAX LM and to per-request references).
* The launcher's ``--tiny`` hybrid trains on the CPU, its depth cut by
  ``--layers``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _hybrid import LAYERS, configs, jax_params, port_model  # noqa: E402
from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT, packed_batch  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.blocks import Ctx  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("layout", sorted(LAYERS))
def test_loss_and_every_gradient_match_jax(layout):
    cfg, jcfg = configs(LAYERS[layout])
    model = port_model(cfg, 0)
    batch = packed_batch(0)
    loss, met = model.loss(batch)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    step = jax.jit(jax.value_and_grad(build_model(jcfg).loss, has_aux=True),
                   **JIT)
    (jloss, jmet), jg = step(jax_params(model, cfg),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["tokens"]) == float(jmet["tokens"])
    ref = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert sorted(ref) == sorted(grads)
    assert "head" not in grads
    missed = {}
    for k, g in grads.items():
        g, r = g.numpy(), ref[k].numpy()
        excess = np.abs(g - r) - (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                  * np.abs(r))
        if excess.max() > 0:
            missed[k] = float(np.abs(g - r).max())
    assert not missed, missed


def test_no_gradient_crosses_a_reset():
    cfg, _ = configs(LAYERS["units_plus_tail"])
    model = port_model(cfg, 1)
    b = {k: torch.as_tensor(v) for k, v in packed_batch(1).items()}
    x = model._embed(b["tokens"]).detach().requires_grad_()
    y = model._stack(x, Ctx(positions=b["positions"],
                            segment_ids=b["segment_ids"]))
    second = (b["segment_ids"] == 2)[..., None]
    (y * second).sum().backward()
    first = (b["segment_ids"] == 1)
    assert torch.all(x.grad[first] == 0.0)
    assert torch.all(x.grad[second[..., 0]].abs().sum(-1) > 0)


def test_packed_logits_equal_per_sequence_logits():
    rng = np.random.default_rng(11)
    cfg = get_config("recurrentgemma-2b").reduced()
    model = port_model(cfg, 0)
    lens, cap = [7, 12, 5], 32
    toks = [rng.integers(1, cfg.vocab, size=(n,)).astype(np.int32)
            for n in lens]
    buf = np.zeros((1, cap), np.int32)
    pos = np.zeros((1, cap), np.int32)
    seg = np.zeros((1, cap), np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for s, (t, off) in enumerate(zip(toks, offs), 1):
        buf[0, off:off + len(t)] = t
        pos[0, off:off + len(t)] = np.arange(len(t))
        seg[0, off:off + len(t)] = s
    logits = model.forward({"tokens": buf, "positions": pos,
                            "segment_ids": seg}).numpy()
    for t, off in zip(toks, offs):
        n = len(t)
        ref = model.forward({"tokens": t[None],
                             "positions": np.arange(n)[None],
                             "segment_ids": np.ones((1, n), np.int32)})
        np.testing.assert_allclose(logits[0, off:off + n], ref[0].numpy(),
                                   atol=5e-3, rtol=1e-3)


def test_tied_embedding_scale_and_gradient():
    jcfg = dataclasses.replace(jget_config("recurrentgemma-2b"),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              d_model=2560, n_layers=0, vocab=16,
                              dtype="bfloat16")
    model = LM(cfg, "cpu").init(torch.Generator().manual_seed(2))
    assert model.head is None
    tok = torch.tensor([[1, 5, 9]])
    x = model._embed(tok)
    e = model.embed[tok].to(torch.bfloat16)
    assert torch.equal(x, e * torch.tensor(50.5, dtype=torch.bfloat16))
    jx = build_model(jcfg)._embed({"embed": jnp.asarray(
        model.embed.detach().numpy())}, {"tokens": jnp.asarray(tok.numpy())})
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)),
                                  x.detach().float().numpy())
    # the gradient: the gather's part plus the head's
    cfg = configs(3)[0]
    model = port_model(cfg, 3)
    batch = packed_batch(3)
    embed = model.embed

    def embed_grad():
        loss, _ = model.loss(batch)
        return torch.autograd.grad(loss, embed)[0]
    full = embed_grad()
    model._logits = lambda x: (x @ embed.detach().t()).float()
    gather = embed_grad()
    del model._logits
    model._embed = lambda t: embed.detach()[t.long()] * cfg.d_model ** 0.5
    head = embed_grad()
    assert gather.abs().sum() > 0 and head.abs().sum() > 0
    torch.testing.assert_close(full, gather + head, atol=1e-6, rtol=1e-5)


def test_layout_and_interop_round_trip():
    cfg = get_config("recurrentgemma-2b")
    assert [k for k, _ in blocks.unit_layout(cfg)] == [
        "0_rec", "0_ffn", "1_rec", "1_ffn", "2_attn", "2_ffn"]
    kinds = blocks.layer_kinds(cfg)
    assert kinds.count("rec") == 18 and kinds.count("attn") == 8
    assert kinds[24:] == ("rec", "rec")             # 26 = 8 × 3 + 2
    jmodel = build_model(jget_config("recurrentgemma-2b"))
    assert jmodel.n_units == 8 and jmodel.n_tail == 2
    # the JAX init's tree (shapes only: no compile) is the port's, and
    # port → JAX tree → port is the identity
    cfg, jcfg = configs(LAYERS["units_plus_tail"])
    shapes = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    model = port_model(cfg, 4)
    named = {k: p.detach() for k, p in model.named_parameters()}
    tree = to_jax_tree(named, cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(shapes)]
    assert sorted(tree["tail"]) == ["0_ffn", "0_rec", "1_ffn", "1_rec"]
    assert "head" not in tree
    back = params_from_jax(tree, cfg, "cpu")
    assert sorted(back) == sorted(named)
    for k, v in named.items():
        assert torch.equal(back[k], v), k
    LM(cfg, "cpu").load_state_dict(back)


def test_serving_entries_refuse_naming_5c_ii():
    """The seven serving entries that refused the family before its
    serving path (ROADMAP 5c-ii) was ported now serve it: each returns
    finite values of the expected shapes, and the chunk lane is on."""
    cfg = get_config("recurrentgemma-2b").reduced()
    model = port_model(cfg, 0)
    b = packed_batch(0)
    ends = np.array([[19, 49], [4, 44]], np.int32)      # segment ends
    lg, cache, clen = model.prefill(b, 64)
    assert lg.shape == (2, cfg.vocab) and clen.tolist() == [64, 64]
    assert model.prefill_logits(b).shape == (2, cfg.vocab)
    plg, states, lens = model.prefill_packed(b, ends, 64)
    assert plg.shape == (2, 2, cfg.vocab) and lens.tolist() == [[20, 30],
                                                                [5, 40]]
    assert sorted(model.init_cache(2, 64)) == sorted(cache) == \
        sorted(states)
    dlg, cache = model.decode_step(cache, np.ones((2, 1), np.int32),
                                   cache_len=clen)
    chunk = model.init_cache(2, 64)
    clg, chunk, cl = model.prefill_chunk(
        chunk, {k: v[:, :8] for k, v in b.items()}, np.zeros(2, np.int32))
    assert cl.tolist() == [8, 8]
    for t in (lg, plg, dlg, clg, *cache.values(), *states.values()):
        assert torch.isfinite(t).all()
    eng = ServeEngine(model, 2, 64, buckets=(16, 32), chunk_size=16)
    assert eng.chunk_enabled and model.supports_chunked_prefill


@pytest.mark.parametrize("layers", [None, 3])
def test_cli_tiny_hybrid_trains_on_the_cpu(capsys, monkeypatch, layers):
    """``--arch recurrentgemma-2b --tiny --device cpu``: one unit and a
    tail rec layer at d_model 128 (``--layers 3``: the unit alone) train
    2 steps to finite losses, through the plain conv (no launch on the
    CPU)."""
    import json

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    built = []
    monkeypatch.setattr(ltrain, "LM", lambda cfg, device: built.append(
        cfg) or LM(cfg, device))
    kops.zero_launches()
    cut = ["--layers", str(layers)] if layers else []
    hist = ltrain.main(["--arch", "recurrentgemma-2b", "--tiny", "--device",
                        "cpu", "--steps", "2", "--rows", "2", "--seq-len",
                        "64", "--prefetch", "0", *cut])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["arch"] == "recurrentgemma-2b" and last["steps"] == 2
    assert [(c.n_layers, c.d_model) for c in built] == [(layers or 4, 128)]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert not any(kops.read_launches().values())
