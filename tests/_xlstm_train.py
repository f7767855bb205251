"""Shared parts of the xLSTM training parity files
(``tests/test_torch_xlstm_train*.py``): the two configs, the packed batch,
the JAX side's compile options, the reference's effective decay rule and
the per-leaf measure; the hybrid's files (``tests/test_torch_hybrid*.py``)
take the batch, the compile options, the decay rule and the measure too.
Not a test module (no ``test_`` prefix)."""
import dataclasses

import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro_torch.configs.base import get_config

# xlstm-125m.reduced() (two whole units) and one unit plus 2 tail layers
LAYERS = {"units": 12, "unit_plus_tail": 8}
# XLA's cheapest compile: the JAX side's cost here is its compiles
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})
# max |Δ| / max |ref| per gradient leaf (chip_smoke.py's TRAIN_PARITY_TOL)
GRAD_TOL = 1e-3
# 2 × 64, three segments a row (a reset inside every 8-step scan chunk)
SEGMENTS = ((20, 30, 14), (5, 40, 19))




def configs(n_layers, chunk=8):
    """The port's and the JAX package's xlstm-125m.reduced() at
    ``n_layers`` and scan chunk ``chunk``."""
    kw = dict(n_layers=n_layers, scan_chunk=chunk)
    return (dataclasses.replace(get_config("xlstm-125m").reduced(), **kw),
            dataclasses.replace(jget_config("xlstm-125m").reduced(), **kw))


def packed_batch(seed=0, segments=SEGMENTS, vocab=128):
    """Rows of back-to-back segments of the given lengths."""
    rng = np.random.default_rng(seed)
    L = sum(segments[0])
    tok = rng.integers(1, vocab, size=(len(segments), L)).astype(np.int32)
    pos = np.zeros_like(tok)
    seg = np.zeros_like(tok)
    for r, lens in enumerate(segments):
        ends = np.cumsum(lens)
        for i, (a, b) in enumerate(zip(ends - lens, ends)):
            pos[r, a:b] = np.arange(b - a)
            seg[r, a:b] = i + 1
    return {"tokens": tok, "positions": pos, "segment_ids": seg}


def jax_decay(cfg):
    """The JAX AdamW's rule as it acts on the JAX tree (ROADMAP §3): the
    leaves of whole units are stacked (n_units, …), so every one has rank
    ≥ 2 and is decayed; a tail leaf keeps its own rank. A layer's blocks
    are ``layers.<i>`` and, in the hybrid, its MLP ``ffns.<i>``."""
    in_units = cfg.n_layers // len(cfg.unit) * len(cfg.unit)

    def decay(name, p):
        if name.startswith(("layers.", "ffns.")):
            return int(name.split(".")[1]) < in_units or p.dim() >= 2
        return p.dim() >= 2
    return decay


def leaf_gaps(got, ref):
    """max |got − ref| / max |ref| for each leaf of two dicts of arrays."""
    assert sorted(got) == sorted(ref)
    out = {}
    for k in ref:
        g = np.asarray(got[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        out[k] = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
    return out


def port_model(cfg, seed):
    from repro_torch.models.lm import LM
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(seed))
    return model


def check_loss_and_grads(n_layers, seed=0):
    """``LM.loss`` and every gradient of the port's model against the JAX
    LM's ``value_and_grad`` on the same weights (the port's ``init``,
    carried into the JAX tree) and the same packed batch; and the JAX
    package's own gradient at scan chunk 16 against its chunk 8. Returns
    the per-leaf measures (port, JAX chunk 16), each against JAX chunk 8,
    printed side by side, worst port leaf first."""
    import jax
    import jax.numpy as jnp

    from repro.models.lm import build_model
    from repro_torch.interop import params_from_jax, to_jax_tree
    cfg, _ = configs(n_layers)
    model = port_model(cfg, seed)
    batch = packed_batch(seed)
    loss, met = model.loss(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    port = {k: g.numpy() for k, g in zip(params, grads)}
    assert all(np.isfinite(g).all() for g in port.values())
    jparams = jax.tree.map(jnp.asarray, to_jax_tree(
        {k: p.detach() for k, p in params.items()}, cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {}
    for chunk in (8, 16):
        _, jcfg = configs(n_layers, chunk)
        step = jax.jit(jax.value_and_grad(build_model(jcfg).loss,
                                          has_aux=True), **JIT)
        (jloss, jmet), jg = step(jparams, jbatch)
        ref[chunk] = (float(jloss), float(jmet["tokens"]), {
            k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, jg), cfg, "cpu").items()})
    np.testing.assert_allclose(float(loss.detach()), ref[8][0], rtol=1e-5)
    assert float(met["tokens"]) == ref[8][1]
    gap = leaf_gaps(port, ref[8][2])
    spread = leaf_gaps(ref[16][2], ref[8][2])
    print(f"loss: port {float(loss.detach())!r}, JAX chunk 8 {ref[8][0]!r}, "
          f"chunk 16 {ref[16][0]!r}")
    print(f"{'leaf':28s} {'port':>10s} {'JAX c16':>10s}  (max |Δ| / max "
          f"|JAX c8|)")
    for k in sorted(gap, key=lambda k: -gap[k]):
        print(f"{k:28s} {gap[k]:10.3e} {spread[k]:10.3e}")
    assert max(spread.values()) <= GRAD_TOL
    bad = {k: v for k, v in gap.items() if v > GRAD_TOL}
    assert not bad, bad
    return gap, spread
