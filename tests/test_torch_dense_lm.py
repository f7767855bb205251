"""Port parity of the dense LM: stablelm-1.6b.reduced() (2 layers, GQA 4
on 2, SwiGLU, untied) and gemma-7b.reduced() (GeGLU, tied embedding) at 2
and 4 layers, and the two deepseek configs' reduced() (GQA 4 on 2), the
port's ``LM`` against the JAX LM on the same weights
(the port's ``init``, carried into the JAX tree) and the same packed
batch (2 × 64, three segments a row).

* ``LM.loss`` within 1e-5 of JAX's and every gradient leaf within 1e-4
  abs + 1e-3 rel; a leaf that misses is named.
* Packing invariance: the packed loss is the token-weighted mean of each
  sequence's own loss (1e-5), and packed logits equal per-sequence
  logits (1e-5 of the scale).
* The layout: ``unit_layout`` is ``0_attn``, ``0_ffn``; the JAX init's
  tree (shapes only) is the port's, with no ``tail`` and, tied, no
  ``head``; port → JAX tree → port is the identity.
* The launcher's ``--tiny`` dense model trains on the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _dense import configs, jax_params, port_model  # noqa: E402
from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT, packed_batch  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
CASES = {"stablelm": ("stablelm-1.6b", 2), "gemma": ("gemma-7b", 2),
         "gemma_4_layers": ("gemma-7b", 4),
         "deepseek_coder": ("deepseek-coder-33b", 2),
         "deepseek": ("deepseek-67b", 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_jax(case):
    arch, n_layers = CASES[case]
    cfg, jcfg = configs(arch, n_layers=n_layers)
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
    assert ("head" in grads) != cfg.tie_embeddings
    missed = {}
    for k, g in grads.items():
        g, r = g.numpy(), ref[k].numpy()
        excess = np.abs(g - r) - (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                  * np.abs(r))
        if excess.max() > 0:
            missed[k] = float(np.abs(g - r).max())
    assert not missed, missed


def _one(t):
    n = len(t)
    return {"tokens": t[None], "positions": np.arange(n, dtype=np.int32)[None],
            "segment_ids": np.ones((1, n), np.int32)}


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-7b"])
def test_packed_loss_and_logits_equal_per_sequence(arch):
    cfg, _ = configs(arch)
    model = port_model(cfg, 1)
    batch = packed_batch(1)
    with torch.no_grad():
        loss, met = model.loss(batch)
        logits = model.forward(batch).numpy()
    tot = cnt = 0.0
    for r in range(batch["tokens"].shape[0]):
        seg = batch["segment_ids"][r]
        for s in range(1, seg.max() + 1):
            idx = np.flatnonzero(seg == s)
            t = batch["tokens"][r, idx]
            with torch.no_grad():
                one, m = model.loss(_one(t))
                ref = model.forward(_one(t))[0].numpy()
            tot += float(one) * float(m["tokens"])
            cnt += float(m["tokens"])
            err = np.abs(logits[r, idx] - ref).max()
            assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (r, s, err)
    assert cnt == float(met["tokens"])
    np.testing.assert_allclose(float(loss), tot / cnt, rtol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma-7b"])
def test_layout_and_interop_round_trip(arch):
    cfg, jcfg = configs(arch, n_layers=3)
    assert [k for k, _ in blocks.unit_layout(cfg)] == ["0_attn", "0_ffn"]
    jmodel = build_model(jcfg)
    assert jmodel.n_units == 3 and jmodel.n_tail == 0
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = port_model(cfg, 4)
    named = {k: p.detach() for k, p in model.named_parameters()}
    tree = to_jax_tree(named, cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(shapes)]
    assert sorted(tree["units"]) == ["0_attn", "0_ffn"]
    assert "tail" not in tree
    assert ("head" not in tree) == cfg.tie_embeddings
    back = params_from_jax(tree, cfg, "cpu")
    assert sorted(back) == sorted(named)
    for k, v in named.items():
        assert torch.equal(back[k], v), k
    LM(cfg, "cpu").load_state_dict(back)


def test_cli_tiny_dense_trains_on_the_cpu(capsys, monkeypatch):
    """``--arch stablelm-1.6b --tiny --device cpu``: the JAX launcher's
    tiny shape (4 layers of d_model 128; 32 heads of 4, d_ff 5632 and
    the 100352-entry vocabulary cut to 512) trains 2 steps to finite
    losses; no kernel of the port's own runs."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as ltrain
    built = []
    monkeypatch.setattr(ltrain, "LM", lambda cfg, device: built.append(
        cfg) or LM(cfg, device))
    kops.zero_launches()
    hist = ltrain.main(["--arch", "stablelm-1.6b", "--tiny", "--device",
                        "cpu", "--steps", "2", "--rows", "2", "--seq-len",
                        "64", "--prefetch", "0"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["arch"] == "stablelm-1.6b" and last["steps"] == 2
    assert [(c.n_layers, c.d_model, c.hd, c.vocab) for c in built] == \
        [(4, 128, 4, 512)]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert not any(kops.read_launches().values())
