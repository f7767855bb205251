"""Port parity of the xLSTM training step (slice 7b) on a 7-layer unit +
tail variant of xlstm-125m.reduced() (one unit of 5 mLSTM + 1 sLSTM, then
1 tail mLSTM layer; d_model 64, scan chunk 8, ``remat="unit"``): 3
``Trainer`` steps of AdamW (constant lr 1e-3, clip 1.0, weight decay 0.1)
over the packing loader (pack, 2 × 64) against the JAX package's jitted
``make_train_step`` over its loader, from the same weights.

* The decay rule: the port's is ``rank_decay``; here it takes the
  reference's effective rule (``_xlstm_train.jax_decay``: every leaf of a
  whole unit, a tail leaf by its own rank).
* Adam's eps is 1e-2 on both sides, not 1e-8. After clipping, the mLSTM
  normaliser leaves ~1e-4 of a leaf's scale of f32 rounding in every
  gradient; at eps 1e-8 Adam turns an element whose gradient lies under
  that into a step of ±lr, and the JAX package at scan chunk 16 leaves its
  own chunk-8 trajectory by about a third of the parameters' whole change
  in three steps. At eps 1e-2 the step is near linear in the gradient, so
  the rounding stays rounding.
* The losses at rtol 1e-4.
* The parameters, per leaf: max |port − JAX chunk 8| ≤ ``TRAJ_TOL`` ·
  max |JAX chunk 8 − initial|, the leaf's own change over the three
  steps, and the JAX package's own chunk-16 trajectory held to the same
  bound (printed beside the port's with ``-s``; at this seed 3.6e-4 and
  8.6e-4). A wrong step moves some leaf by a large share of its change: a
  skipped update about a third, no decay on the unit's leaves about 1×,
  decay on the tail's rank-1 leaves (``final_norm``, the tail layer's
  ``norm`` and ``b_if``) 3–40×.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT, configs, jax_decay, port_model  # noqa: E402
from repro.data.dataset import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.data.dataset import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data.packing_loader import LoaderConfig as JLoaderConfig  # noqa
from repro.data.packing_loader import PackingLoader as JLoader  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import make_train_step as jmake_step  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
LR = 1e-3
EPS = 1e-2
STEPS = 3
N_LAYERS = 7        # one unit and a tail layer: both decay rules at work
TRAJ_TOL = 5e-3     # max |Δ| per leaf over the leaf's own change


def _loaders(rows=2, seq_len=64):
    lc = dict(rows=rows, seq_len=seq_len, mode="pack")
    return (PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)),
            JLoader(JCorpus(JCorpusConfig(**SMALL)), JLoaderConfig(**lc)))


def _jax_run(jparams, n_layers, chunk, jl):
    """``STEPS`` jitted JAX train steps from ``jparams``: (losses, the
    final parameters under the port's names)."""
    cfg, jcfg = configs(n_layers, chunk)
    jopt = jadamw.AdamW(jadamw.constant_schedule(LR),
                        jadamw.AdamWConfig(eps=EPS))
    step = jax.jit(jmake_step(build_model(jcfg), jopt), **JIT)
    state = {"params": jparams, "opt": jopt.init(jparams)}
    losses = []
    for i in range(STEPS):
        state, met = step(state, {k: jnp.asarray(v)
                                  for k, v in jl.batch(i).items()})
        losses.append(float(met["loss"]))
    return losses, {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state["params"]), cfg, "cpu").items()}


def test_three_trainer_steps_match_the_jax_train_step():
    n = N_LAYERS
    cfg, _ = configs(n)
    model = port_model(cfg, 2)
    # copies: the port's steps write its parameters in place
    jparams = jax.tree.map(jnp.array, to_jax_tree(
        {k: p.detach() for k, p in model.named_parameters()}, cfg))
    tl, jl = _loaders()
    init = {k: p.detach().numpy().copy()
            for k, p in model.named_parameters()}
    opt = adamw.AdamW(adamw.constant_schedule(LR), adamw.AdamWConfig(eps=EPS),
                      decay=jax_decay(cfg))
    state, hist = Trainer(model, opt, tl, TrainerConfig(steps=STEPS)).train(
        verbose=False)
    ref = {chunk: _jax_run(jparams, n, chunk, jl) for chunk in (8, 16)}
    losses = [h["loss"] for h in hist]
    print(f"losses: port {losses}, JAX chunk 8 {ref[8][0]}, chunk 16 "
          f"{ref[16][0]}")
    np.testing.assert_allclose(losses, ref[8][0], rtol=1e-4)
    got = {k: v.detach().numpy() for k, v in state["params"].items()}
    change = {k: np.abs(w - init[k]).max() for k, w in ref[8][1].items()}
    gap = {k: np.abs(got[k] - w).max() / change[k]
           for k, w in ref[8][1].items()}
    spread = {k: np.abs(ref[16][1][k] - w).max() / change[k]
              for k, w in ref[8][1].items()}
    print(f"{'leaf':28s} {'change':>10s} {'port':>10s} {'JAX c16':>10s}  "
          f"(max |Δ| against JAX c8 / the leaf's change)")
    for k in sorted(gap, key=lambda k: -gap[k]):
        print(f"{k:28s} {change[k]:10.3e} {gap[k]:10.3e} {spread[k]:10.3e}")
    assert min(change.values()) > 0
    assert max(spread.values()) <= TRAJ_TOL
    bad = {k: v for k, v in gap.items() if v > TRAJ_TOL}
    assert not bad, bad
