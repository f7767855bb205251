"""Port parity of the training slice at mamba-110m.reduced(): the loader,
``LM.loss`` and every parameter's gradient, AdamW, a 5-step trajectory of
``make_train_step``, gradient accumulation, the CLI, and serving staying
gradient-free now that the parameters train. The JAX side runs with
``use_pallas=True`` (its kernels in interpret mode) from the same weights
(``params_from_jax``) and the same numpy batches.

Tolerances (f32 throughout):
* loss 1e-5 relative; gradients 1e-4 abs + 1e-3 rel: two layers, the
  scan's sums over L and channels taken in another order.
* 5-step trajectory: losses 1e-4 relative, parameters 5e-5 abs. Adam
  divides each update by its own RMS, so a gradient element near zero
  turns its rounding difference into an update difference of up to ~lr;
  5 steps at lr 1e-3 could move a parameter by 5e-3, the bar is 1% of that.
* AdamW alone on one tree: 1e-6 (the same arithmetic).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.data.dataset import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.data.dataset import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data.packing_loader import LoaderConfig as JLoaderConfig  # noqa
from repro.data.packing_loader import PackingLoader as JLoader  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.data.prefetch import PrefetchLoader  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
LR = 1e-3


def _loaders(mode="pack", rows=2, seq_len=64, balance=0):
    lc = dict(rows=rows, seq_len=seq_len, mode=mode, balance_shards=balance)
    return (PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)),
            JLoader(JCorpus(JCorpusConfig(**SMALL)), JLoaderConfig(**lc)))


def _jax_decay(name, p):
    """The JAX AdamW's rule as it acts on the JAX tree: block leaves are
    stacked (n_layers, …), so every one of them has rank ≥ 2."""
    return p.dim() >= 2 or name.startswith("layers.")


def _port(jparams, cfg):
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return model


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba-110m").reduced(),
                               use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    cfg = get_config("mamba-110m").reduced()
    return jmodel, jparams, cfg


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    def counts():
        return (kconv.LAUNCHES, kconv.LAUNCHES_DX, ksc.LAUNCHES_FWD,
                ksc.LAUNCHES_BWD)
    before = counts()
    yield
    assert counts() == before


def _close_trees(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, err_msg=str(path), **tol)


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("mode,balance", [("pack", 0), ("pad", 0),
                                          ("single", 0), ("pack", 2)])
def test_loader_buffers_equal_jax(mode, balance):
    tl, jl = _loaders(mode, rows=4, balance=balance)
    for step in (0, 3):
        got, want = tl.batch(step), jl.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert tl.stats(2) == jl.stats(2)
    with PrefetchLoader(tl, depth=2) as pf:
        for step in range(3):
            assert all(np.array_equal(pf.batch(step)[k], tl.batch(step)[k])
                       for k in ("tokens", "positions", "segment_ids"))
        assert pf.hits >= 1


# ---------------------------------------------------------- loss and grads

def test_loss_and_every_gradient_match_jax(pair):
    jmodel, jparams, cfg = pair
    tl, jl = _loaders()
    batch = tl.batch(1)
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in jl.batch(1).items()})
    model = _port(jparams, cfg)
    loss, met = model.loss(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["tokens"]) == float(jmet["tokens"])
    _close_trees(to_jax_tree(dict(zip(params, grads)), cfg), jgrads,
                 atol=1e-4, rtol=1e-3)


def test_packed_loss_equals_concat_loss(pair):
    """Packed CE == CE over the sequences one by one (same tokens, same
    mask) — the training-level PUI consequence, as the JAX test_pui."""
    _, jparams, cfg = pair
    model = _port(jparams, cfg)
    rng = np.random.default_rng(13)
    toks = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
            for n in (6, 9, 4)]
    buf = np.zeros((1, 32), np.int32)
    pos, seg = np.zeros_like(buf), np.zeros_like(buf)
    t = 0
    for i, s in enumerate(toks):
        buf[0, t:t + len(s)], pos[0, t:t + len(s)] = s, np.arange(len(s))
        seg[0, t:t + len(s)] = i + 1
        t += len(s)
    with torch.no_grad():
        packed, _ = model.loss({"tokens": buf, "positions": pos,
                                "segment_ids": seg})
        tot = cnt = 0.0
        for s in toks:
            n = len(s)
            li, mi = model.loss({"tokens": s[None],
                                 "positions": np.arange(n)[None],
                                 "segment_ids": np.ones((1, n), np.int32)})
            tot += float(li) * float(mi["tokens"])
            cnt += float(mi["tokens"])
    np.testing.assert_allclose(float(packed), tot / cnt, rtol=2e-5)


# ------------------------------------------------------------------ AdamW

@pytest.mark.parametrize("lane", ["float32", "bfloat16"])
def test_adamw_matches_jax_on_a_random_tree(lane):
    """Clipping active, decay only on rank ≥ 2, and in the bf16 lane the
    f32 masters: params, m, v and masters after 5 updates."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "A_log": (5, 4), "conv_w": (4, 5), "b": (5,),
              "D": (5,)}
    tree = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    jdt, tdt = jnp.dtype(lane), getattr(torch, lane)
    jp = {k: jnp.asarray(v, jdt) for k, v in tree.items()}
    tp = {k: torch.as_tensor(v).to(tdt) for k, v in tree.items()}
    sched = (jadamw.cosine_schedule(1e-2, 2, 5),
             adamw.cosine_schedule(1e-2, 2, 5))
    jopt = jadamw.AdamW(sched[0], jadamw.AdamWConfig(clip_norm=0.5))
    topt = adamw.AdamW(sched[1], adamw.AdamWConfig(clip_norm=0.5))
    js, ts = jopt.init(jp), topt.init(tp)
    assert (js.master is None) == (ts.master is None) == (lane == "float32")
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) * 3
             for k, s in shapes.items()}
        jp, js, jst = jopt.update({k: jnp.asarray(v, jdt)
                                   for k, v in g.items()}, js, jp)
        tp, ts, tst = topt.update({k: torch.as_tensor(v).to(tdt)
                                   for k, v in g.items()}, ts, tp)
        np.testing.assert_allclose(float(tst["grad_norm"]),
                                   float(jst["grad_norm"]), rtol=1e-6)
        assert float(jst["grad_norm"]) > 0.5          # clipping acted
    np.testing.assert_allclose(tst["lr"], float(jst["lr"]), rtol=1e-6)
    got = {"p": {k: v.float().numpy() for k, v in tp.items()},
           "m": {k: v.numpy() for k, v in ts.m.items()},
           "v": {k: v.numpy() for k, v in ts.v.items()}}
    want = {"p": jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
            "m": js.m, "v": js.v}
    if lane == "bfloat16":
        got["master"] = {k: v.numpy() for k, v in ts.master.items()}
        want["master"] = js.master
    _close_trees(got, want, atol=1e-6, rtol=1e-6)
    assert not adamw.rank_decay("D", tp["D"]) and \
        adamw.rank_decay("A_log", tp["A_log"])


# ---------------------------------------------------- train-step trajectory

def test_five_step_trajectory_matches_jax(pair):
    jmodel, jparams, cfg = pair
    tl, jl = _loaders()
    jopt = jadamw.AdamW(jadamw.cosine_schedule(LR, 1, 5))
    jstep = jax.jit(jmake_step(jmodel, jopt))
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    model = _port(jparams, cfg)
    topt = adamw.AdamW(adamw.cosine_schedule(LR, 1, 5), decay=_jax_decay)
    trainer = Trainer(model, topt, tl, TrainerConfig(steps=5))
    tstate, hist = trainer.train(verbose=False)
    jlosses = []
    for step in range(5):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in jl.batch(step).items()})
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, rtol=1e-4)
    assert trainer.real_tokens == sum(int((tl.batch(s)["segment_ids"] > 0)
                                          .sum()) for s in range(5))
    _close_trees(to_jax_tree(tstate["params"], cfg), jstate["params"],
                 atol=5e-5, rtol=0)


def test_accum_2_equals_accum_1(pair):
    """Two microbatches with equal token counts: averaging their means is
    the mean over both, so the two steps agree up to float association."""
    _, jparams, cfg = pair
    rng = np.random.default_rng(8)
    pos = np.tile(np.concatenate([np.arange(20), np.arange(12)]), (2, 1))
    seg = np.tile(np.repeat([1, 2], [20, 12]), (2, 1)).astype(np.int32)
    batch = {"tokens": rng.integers(1, cfg.vocab, size=(2, 32)).astype(
                 np.int32), "positions": pos.astype(np.int32),
             "segment_ids": seg}
    out = []
    for accum in (1, 2):
        model = _port(jparams, cfg)
        opt = adamw.AdamW(adamw.constant_schedule(LR))
        params = dict(model.named_parameters())
        state, met = make_train_step(model, opt, accum)(
            {"params": params, "opt": opt.init(params)}, batch)
        out.append((float(met["loss"]), {k: v.detach().clone()
                                         for k, v in params.items()}))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], atol=1e-6,
                                   rtol=0)


# ------------------------------------------------------------ CLI, serving

def test_cli_tiny_on_cpu_takes_3_steps(capsys):
    hist = ttrain.main(["--tiny", "--device", "cpu", "--steps", "3",
                        "--rows", "2", "--seq-len", "128"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert '"steps": 3' in out and "final loss" in out


def test_serving_stays_gradient_free(pair):
    """Trainable parameters: no serving output or cache tracks a gradient,
    and the engine's token streams are those of a frozen copy."""
    _, jparams, cfg = pair
    model = _port(jparams, cfg)
    assert all(p.requires_grad for p in model.parameters())
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (9, 14, 5, 11)]
    kw = dict(num_slots=3, max_len=48, prefill_rows=2, buckets=(16, 32),
              max_segments=2)
    runs = []
    for m in (model, _port(jparams, cfg).requires_grad_(False)):
        eng = tserve.ServeEngine(m, **kw)
        for p in prompts:
            eng.submit(p, 5)
        runs.append(eng.run())
        assert not any(t.requires_grad for t in eng.cache.values())
    assert runs[0] == runs[1]
    pb_tokens = np.stack([np.pad(p, (0, 16 - len(p))) for p in prompts])
    batch = {"tokens": pb_tokens,
             "positions": np.tile(np.arange(16, dtype=np.int32), (4, 1)),
             "segment_ids": (pb_tokens > 0).astype(np.int32)}
    logits, cache, _ = model.prefill(batch)
    assert not logits.requires_grad and not model.forward(batch).requires_grad
    assert not any(t.requires_grad for t in cache.values())
    lg, cache = model.decode_step(cache, torch.ones((4, 1), dtype=torch.int32))
    assert not lg.requires_grad and not any(t.requires_grad
                                            for t in cache.values())
