"""Port parity of the dense training step: stablelm-1.6b.reduced() (2
layers, GQA 4 on 2, SwiGLU, untied) and gemma-7b.reduced() (GeGLU, tied)
at 3 layers, ``remat="unit"``: 3 ``Trainer`` steps of AdamW (constant lr
1e-3, clip 1.0, weight decay 0.1) over the packing loader (pack, 2 × 64)
against the JAX package's jitted ``make_train_step`` over its loader,
from the same weights. The xLSTM trajectory's recipe
(tests/test_torch_xlstm_train_steps.py): the reference's effective decay
rule (``_xlstm_train.jax_decay``: a dense stack is whole units, every
leaf stacked and decayed), Adam's eps 1e-2 on both sides, the losses at
rtol 1e-4 and each parameter leaf within ``TRAJ_TOL`` of its own change
over the three steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _dense import configs, jax_params, port_model  # noqa: E402
from _threads import one_thread  # noqa: E402
from _xlstm_train import JIT, jax_decay  # noqa: E402
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
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
LR = 1e-3
EPS = 1e-2
STEPS = 3
TRAJ_TOL = 5e-3     # max |Δ| per leaf over the leaf's own change
LAYERS = {"stablelm-1.6b": 2, "gemma-7b": 3}


def _loaders(rows=2, seq_len=64):
    lc = dict(rows=rows, seq_len=seq_len, mode="pack")
    return (PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)),
            JLoader(JCorpus(JCorpusConfig(**SMALL)), JLoaderConfig(**lc)))


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_three_trainer_steps_match_the_jax_train_step(arch):
    cfg, jcfg = configs(arch, n_layers=LAYERS[arch])
    assert cfg.remat == "unit"
    model = port_model(cfg, 2)
    jparams = jax_params(model, cfg)
    init = {k: p.detach().numpy().copy()
            for k, p in model.named_parameters()}
    tl, jl = _loaders()
    opt = adamw.AdamW(adamw.constant_schedule(LR), adamw.AdamWConfig(eps=EPS),
                      decay=jax_decay(cfg))
    state, hist = Trainer(model, opt, tl, TrainerConfig(steps=STEPS)).train(
        verbose=False)

    jopt = jadamw.AdamW(jadamw.constant_schedule(LR),
                        jadamw.AdamWConfig(eps=EPS))
    step = jax.jit(jmake_step(build_model(jcfg), jopt), **JIT)
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jlosses = []
    for i in range(STEPS):
        jstate, met = step(jstate, {k: jnp.asarray(v)
                                    for k, v in jl.batch(i).items()})
        jlosses.append(float(met["loss"]))
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, rtol=1e-4)

    ref = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, "cpu").items()}
    got = {k: v.detach().numpy() for k, v in state["params"].items()}
    change = {k: np.abs(w - init[k]).max() for k, w in ref.items()}
    gap = {k: np.abs(got[k] - w).max() / change[k] for k, w in ref.items()}
    for k in sorted(gap, key=lambda k: -gap[k]):
        print(f"{k:28s} {change[k]:10.3e} {gap[k]:10.3e}")
    assert sorted(got) == sorted(ref)
    assert min(change.values()) > 0
    bad = {k: v for k, v in gap.items() if v > TRAJ_TOL}
    assert not bad, bad
