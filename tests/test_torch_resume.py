"""Checkpoint/restart and bf16 gradient accumulation of the port's training
loop at mamba-110m.reduced() on the CPU:

* train N straight == train k, checkpoint, restart, train N − k (the JAX
  ``tests/test_trainer.py`` resume cases), with and without the
  ``PrefetchLoader``: bitwise, since a CPU run repeats exactly and the
  checkpoint holds the bits; the SIGTERM emergency save ends a run at the
  step it was caught in and the restart continues bitwise too;
* a run the JAX trainer checkpointed at step 2, restored with the JAX
  ``CheckpointManager`` and carried across by ``params_from_jax`` +
  ``opt_state_from_jax``, continues in the port to the JAX trainer's
  uninterrupted trajectory: losses at 1e-4 relative, parameters at 5e-5
  abs, the tolerances of ``test_five_step_trajectory_matches_jax`` (the
  JAX model on its plain XLA path, as ``tests/test_trainer.py`` runs it);
* ``accum=2, grad_accum_dtype="bfloat16"`` against the JAX step on the
  same batch: the loss at 1e-5 relative and every gradient within 2 bf16
  ulps of the JAX one. Both round each microbatch's f32 gradient to bf16,
  sum in bf16 and halve; the f32 microbatch gradients differ by float
  association (≈ 1e-6), which can move each rounding to the neighbouring
  bf16 value. So the bound is 2 ulps at half the larger microbatch
  gradient's magnitude (the scale of the mean; an ulp of bf16 at |x| is
  at most 2⁻⁷ |x|). A plain 2⁻⁷ relative bound on the result fails where
  the two microbatch gradients cancel (2 of 81 856 elements here);
* the launcher with ``--ckpt-dir --ckpt-every 1 --obs-trace``, then a
  second launch that resumes from the last step.
"""
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpoint import CheckpointManager as JCkpt  # noqa
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.data.dataset import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.data.dataset import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data.packing_loader import LoaderConfig as JLoaderConfig  # noqa
from repro.data.packing_loader import PackingLoader as JLoader  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro.train.trainer import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.data.prefetch import PrefetchLoader  # noqa: E402
from repro_torch.interop import (opt_state_from_jax,  # noqa: E402
                                 opt_state_to_jax, params_from_jax,
                                 to_jax_tree)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.obs.check import check_trace  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
LR = 1e-3


def _loaders(rows=2, seq_len=64):
    lc = dict(rows=rows, seq_len=seq_len, mode="pack")
    return (PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)),
            JLoader(JCorpus(JCorpusConfig(**SMALL)), JLoaderConfig(**lc)))


def _jax_decay(name, p):
    """The JAX AdamW's effective rule on the stacked JAX tree (every block
    leaf has rank ≥ 2 there; ROADMAP §3)."""
    return p.dim() >= 2 or name.startswith("layers.")


def _port_trainer(ckpt_dir, steps, every, prefetch=False, loader=None):
    cfg = get_config("mamba-110m").reduced()
    tl = loader or _loaders()[0]
    if prefetch:
        tl = PrefetchLoader(tl, depth=2)
    return Trainer(LM(cfg, "cpu"),
                   adamw.AdamW(adamw.cosine_schedule(LR, 1, 6)), tl,
                   TrainerConfig(steps=steps, log_every=100,
                                 ckpt_every=every, ckpt_dir=ckpt_dir,
                                 keep_ckpts=5))


def _state_equal(a, b):
    pa, pb = a["params"], b["params"]
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    oa, ob = a["opt"], b["opt"]
    assert oa.step == ob.step
    for x, y in ((oa.m, ob.m), (oa.v, ob.v)):
        assert all(torch.equal(x[k], y[k]) for k in x)


# ------------------------------------------------------------ port resume

@pytest.mark.parametrize("prefetch", [False, True])
def test_resume_is_bitwise_the_straight_run(tmp_path, prefetch):
    """6 straight == 3, checkpoint, a new trainer (other init seed),
    restore, 3 more — every loss and the final state bitwise."""
    t_a = _port_trainer(None, 6, 0)
    state_a, hist_a = t_a.train(torch.Generator().manual_seed(7),
                                verbose=False)
    d = str(tmp_path / "b")
    t_b1 = _port_trainer(d, 3, 3, prefetch)
    t_b1.train(torch.Generator().manual_seed(7), verbose=False)
    t_b2 = _port_trainer(d, 6, 0, prefetch)
    state_b, hist_b = t_b2.train(torch.Generator().manual_seed(999),
                                 verbose=False)
    for t in (t_b1, t_b2):
        if prefetch:
            t.loader.close()
    assert t_b1.ckpt.all_steps() == [3]
    assert len(hist_b) == 3 and t_b2.steps == 3    # resumed at step 3
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist_a[3:]]
    _state_equal(state_b, state_a)


def test_sigterm_makes_the_emergency_save_and_the_restart_continues(
        tmp_path):
    """SIGTERM while step 3's batch is fetched: the real handler sets the
    flag, the periodic save at 4 publishes and the emergency save waits
    for that write and marks its manifest (no second snapshot or write,
    so it takes no longer than that write plus a manifest's rewrite),
    training stops; the handlers are put back; a restart runs steps 4 and
    5 bitwise as the straight run does."""
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    _, hist_a = _port_trainer(None, 6, 0).train(
        torch.Generator().manual_seed(7), verbose=False)
    base = _loaders()[0]

    class Killer:
        def batch(self, step):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return base.batch(step)

    d = str(tmp_path / "c")
    t_b = _port_trainer(d, 6, 2, loader=Killer())
    state_b, hist_b = t_b.train(torch.Generator().manual_seed(7),
                                verbose=False)
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(hist_b) == 4 and t_b.ckpt.all_steps() == [2, 4]
    assert t_b.ckpt.read_meta(4)["meta"] == {"step": 4, "emergency": True}
    met = t_b.obs.metrics
    assert met.counter("ckpt.saves").value == 2
    assert met.counter("ckpt.marks").value == 1
    assert met.gauge("train.emergency_save_s").value <= \
        met.gauge("ckpt.write_s").value + 0.5
    t_c = _port_trainer(d, 6, 0)
    state_c, step = t_c.restore_or_init(torch.Generator().manual_seed(1))
    assert step == 4
    _state_equal(state_c, state_b)
    _, hist_c = t_c.train(state=state_c, start_step=step, verbose=False)
    assert [h["loss"] for h in hist_c] == [h["loss"] for h in hist_a[4:]]


# ------------------------------------------------- JAX checkpoint → the port

def test_jax_checkpoint_continues_in_the_port(tmp_path):
    jcfg = jget_config("mamba-110m").reduced()
    cfg = get_config("mamba-110m").reduced()
    tl, jl = _loaders()
    jmodel = build_model(jcfg)
    d = str(tmp_path / "jax")
    jtrainer = JTrainer(jmodel, jadamw.AdamW(jadamw.cosine_schedule(LR, 1,
                                                                    5)),
                        jl, JTrainerConfig(steps=5, log_every=100,
                                           ckpt_every=2, ckpt_dir=d,
                                           keep_ckpts=5))
    jstate, jhist = jtrainer.train(jax.random.PRNGKey(3), verbose=False)
    template = jtrainer.init_state(jax.random.PRNGKey(0))
    restored = JCkpt(d, async_save=False).restore(template, step=2)
    assert int(restored["opt"].step) == 2

    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, restored["params"]), cfg, "cpu"))
    ostate = opt_state_from_jax(jax.tree.map(np.asarray, restored["opt"]),
                                cfg, "cpu")
    assert ostate.step == 2 and ostate.master is None
    back = opt_state_to_jax(ostate, cfg)        # the inverse, exactly
    assert back["master"] is None and int(back["step"]) == 2
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[k]),
                        jax.tree.leaves(getattr(restored["opt"], k))):
            np.testing.assert_array_equal(a, np.asarray(b))
    topt = adamw.AdamW(adamw.cosine_schedule(LR, 1, 5), decay=_jax_decay)
    trainer = Trainer(model, topt, tl, TrainerConfig(steps=5))
    state, hist = trainer.train(
        state={"params": dict(model.named_parameters()), "opt": ostate},
        start_step=2, verbose=False)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist[2:]], rtol=1e-4)
    got = to_jax_tree(state["params"], cfg)
    want = jax.tree.map(np.asarray, jstate["params"])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, atol=5e-5, rtol=0,
                                   err_msg=str(path))


# ------------------------------------------------- bf16 gradient accumulation

class _GradSink:
    """An optimizer stand-in that keeps the gradients it is handed."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state, {}


def test_bf16_grad_accum_matches_jax():
    jcfg = jget_config("mamba-110m").reduced()
    cfg = get_config("mamba-110m").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    tl, jl = _loaders(rows=4)
    batch = tl.batch(1)
    jsink = _GradSink()
    _, jmet = jmake_step(jmodel, jsink, accum=2,
                         grad_accum_dtype="bfloat16")(
        {"params": jparams, "opt": None},
        {k: jnp.asarray(v) for k, v in jl.batch(1).items()})
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    params = dict(model.named_parameters())
    sink = _GradSink()
    _, met = make_train_step(model, sink, accum=2,
                             grad_accum_dtype="bfloat16")(
        {"params": params, "opt": None}, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    # the magnitudes the two roundings and the bf16 sum act on
    mags = [to_jax_tree(dict(zip(params, torch.autograd.grad(
        model.loss({k: v[i:i + 2] for k, v in batch.items()})[0],
        list(params.values())))), cfg) for i in (0, 2)]
    assert all(g.dtype == torch.float32 for g in sink.grads.values())
    got = jax.tree_util.tree_flatten_with_path(to_jax_tree(sink.grads,
                                                           cfg))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jsink.grads))[0])
    m0 = dict(jax.tree_util.tree_flatten_with_path(mags[0])[0])
    m1 = dict(jax.tree_util.tree_flatten_with_path(mags[1])[0])
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        assert w.dtype == np.float32
        ulp_scale = np.maximum(np.abs(m0[path]), np.abs(m1[path])) / 2
        bad = np.abs(g - w) > 2 * 2.0 ** -7 * ulp_scale
        assert not bad.any(), (path, np.abs(g - w).max())
        # and the accumulation really was in bf16: each value is a bf16
        # number halved
        g2 = torch.as_tensor(g * 2)
        assert torch.equal(g2.to(torch.bfloat16).float(), g2), path


# ----------------------------------------------------------------- launcher

def test_launcher_checkpoints_traces_and_resumes(tmp_path, capsys):
    d, t = str(tmp_path / "ckpt"), str(tmp_path / "trace.json")
    common = ["--tiny", "--device", "cpu", "--rows", "2", "--seq-len",
              "128", "--ckpt-dir", d, "--ckpt-every", "1"]
    hist = ttrain.main(common + ["--steps", "2", "--obs-trace", t])
    assert len(hist) == 2 and sorted(os.listdir(d)) == ["step_1", "step_2"]
    assert "obs: wrote" in capsys.readouterr().out
    assert check_trace(t, require=["train.steps", "train.real_tokens",
                                   "data.prefetch_misses"],
                       require_spans=["train.step", "train.data"]) == []
    hist2 = ttrain.main(common + ["--steps", "3"])
    assert len(hist2) == 1                     # resumed at step 2
    assert sorted(os.listdir(d)) == ["step_1", "step_2", "step_3"]
    assert np.isfinite(hist2[0]["loss"])
