"""Port parity of the Mamba-2 slice at mamba2-370m.reduced() (8 heads of
dh 16, N 64): ``apply_mamba2`` in its three collect modes, ``step_mamba2``
against ``apply_mamba2``, ``LM.loss`` and every gradient, a 5-step
training trajectory, the serving entry points and the engine's greedy
streams, all against the JAX package run with ``use_pallas=True`` (its
heads scan kernels #7/#9 and conv kernel in interpret mode) from the same
weights (``params_from_jax``) and the same numpy inputs.

Tolerances (f32): block outputs and states 1e-4 (matmuls and the scan's
sums in another order); step vs apply 2e-5 abs / 1e-4 rel, the JAX
``test_mamba2_step_matches_apply`` bar; loss 1e-5 relative and gradients
1e-4 abs + 1e-3 rel, the trajectory 1e-4 / 5e-5, as the Mamba-1 training
tests (``tests/test_torch_train.py``) and for the same reasons.
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
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.kernels import selective_scan_heads as kh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ATOL = 1e-4
SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)
LR = 1e-3
PLENS = (9, 14, 5, 11)


def _jax_decay(name, p):
    """The JAX AdamW's rule on the stacked JAX tree (ROADMAP §3)."""
    return p.dim() >= 2 or name.startswith("layers.")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba2-370m").reduced(),
                               use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    cfg = get_config("mamba2-370m").reduced()
    return jcfg, jmodel, jparams, cfg


def _port(jparams, cfg):
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return model


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    def counts():
        return (kh.LAUNCHES_FWD, kh.LAUNCHES_DUAL, kh.LAUNCHES_BWD)
    before = counts()
    yield
    assert counts() == before


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


def _close_trees(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, err_msg=str(path), **tol)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
            for n in PLENS]


def _packed(prompts, rows=2, cap=24, max_segments=3):
    pb = packing.pack(prompts, cap, policy="first_fit", num_rows=rows)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    return pb, batch, packing.segment_ends(pb, max_segments)


# ------------------------------------------------------------------ config

def test_config_matches_jax():
    cfg, jcfg = get_config("mamba2-370m"), jget_config("mamba2-370m")
    for k in ("n_layers", "d_model", "d_inner", "d_state", "vocab", "ssm_hd",
              "n_ssm_heads", "unit", "ssm_variant", "ssm_norm"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    r, jr = cfg.reduced(), jcfg.reduced()
    assert (r.n_ssm_heads, r.ssm_hd, r.d_inner) == \
        (jr.n_ssm_heads, jr.ssm_hd, jr.d_inner) == (8, 16, 128)
    with pytest.raises(ValueError, match="d_inner"):
        dataclasses.replace(cfg, ssm_heads=5).ssm_hd
    with pytest.raises(NotImplementedError, match="Mamba-1 and Mamba-2"):
        LM(dataclasses.replace(cfg, family="dense"), "cpu")


# ------------------------------------------------------------------- block

@pytest.mark.parametrize("mode", ["train", "row", "segment"])
@pytest.mark.parametrize("rms_gate", [False, True])
def test_apply_mamba2_matches_jax(pair, mode, rms_gate):
    """One block on a packed buffer: the training form (the scan kernels'
    plain versions through autograd's Function), the per-row handoff
    (right padding frozen) and the per-segment handoff."""
    jcfg, _, jparams, cfg = pair
    if rms_gate:
        jcfg = dataclasses.replace(jcfg, ssm_norm="rms_gate")
        cfg = dataclasses.replace(cfg, ssm_norm="rms_gate")
    jp = jax.tree.map(lambda v: np.asarray(v[0]),
                      jparams["units"]["0_mamba2"])
    rng = np.random.default_rng(7)
    if rms_gate:
        jp["ssm_norm_w"] = rng.uniform(0.5, 1.5, cfg.d_inner).astype(
            np.float32)
    pb, batch, ends = _packed(_prompts(cfg), cap=24)
    if mode == "row":
        pb = packing.pad_to_max(_prompts(cfg), 16)
        batch = {"tokens": pb.tokens, "positions": pb.positions,
                 "segment_ids": pb.segment_ids}
    x = rng.normal(size=batch["tokens"].shape + (cfg.d_model,)).astype(
        np.float32)
    jctx = jblocks.Ctx(positions=jnp.asarray(batch["positions"]),
                       segment_ids=jnp.asarray(batch["segment_ids"]))
    tctx = blocks.Ctx(positions=torch.as_tensor(batch["positions"]),
                      segment_ids=torch.as_tensor(batch["segment_ids"]))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    jpj = {k: jnp.asarray(v) for k, v in jp.items()}
    if mode == "train":
        _close(blocks.apply_mamba2(tp, torch.as_tensor(x), tctx, cfg),
               jblocks.apply_mamba2(jpj, jnp.asarray(x), jctx, jcfg))
        return
    cends = jnp.asarray(ends) if mode == "segment" else None
    jy, jst = jblocks.apply_mamba2(jpj, jnp.asarray(x), jctx, jcfg,
                                   collect=32, collect_ends=cends)
    ty, tst = blocks.apply_mamba2(
        tp, torch.as_tensor(x), tctx, cfg, collect=True,
        collect_ends=None if cends is None else torch.as_tensor(ends))
    _close(ty, jy)
    for k in ("conv", "ssm"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k])


def test_step_mamba2_matches_apply(pair):
    """Decode token by token from a zero cache == the block over the whole
    sequence (the JAX test's 2e-5 / 1e-4 bar), a reset at step 0."""
    _, _, jparams, cfg = pair
    tp = {k: torch.as_tensor(np.asarray(v[0]))
          for k, v in jparams["units"]["0_mamba2"].items()}
    rng = np.random.default_rng(9)
    L = 12
    x = torch.as_tensor(rng.normal(size=(2, L, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(L, dtype=torch.int32).expand(2, L)
    full = blocks.apply_mamba2(tp, x, blocks.Ctx(positions=pos), cfg)
    cache = blocks.init_mamba2_cache(cfg, 2, torch.float32, "cpu")
    assert tuple(cache["ssm"].shape) == (2, cfg.n_ssm_heads, cfg.ssm_hd,
                                         cfg.d_state)
    for t in range(L):
        y, cache = blocks.step_mamba2(
            tp, x[:, t:t + 1], cache,
            blocks.Ctx(reset_t=torch.full((2,), t == 0)), cfg)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=2e-5,
                                   rtol=1e-4)


# ---------------------------------------------------------- loss and grads

def _loaders(rows=2, seq_len=64):
    lc = dict(rows=rows, seq_len=seq_len, mode="pack")
    return (PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)),
            JLoader(JCorpus(JCorpusConfig(**SMALL)), JLoaderConfig(**lc)))


def test_loss_and_every_gradient_match_jax(pair):
    _, jmodel, jparams, cfg = pair
    tl, jl = _loaders()
    (jloss, jmet), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in jl.batch(1).items()})
    model = _port(jparams, cfg)
    loss, met = model.loss(tl.batch(1))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["tokens"]) == float(jmet["tokens"])
    _close_trees(to_jax_tree(dict(zip(params, grads)), cfg), jgrads,
                 atol=1e-4, rtol=1e-3)


def test_five_step_trajectory_matches_jax(pair):
    _, jmodel, jparams, cfg = pair
    tl, jl = _loaders()
    jopt = jadamw.AdamW(jadamw.cosine_schedule(LR, 1, 5))
    jstep = jax.jit(jmake_step(jmodel, jopt))
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    model = _port(jparams, cfg)
    topt = adamw.AdamW(adamw.cosine_schedule(LR, 1, 5), decay=_jax_decay)
    tstate, hist = Trainer(model, topt, tl, TrainerConfig(steps=5)).train(
        verbose=False)
    jlosses = []
    for step in range(5):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in jl.batch(step).items()})
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose([h["loss"] for h in hist], jlosses, rtol=1e-4)
    _close_trees(to_jax_tree(tstate["params"], cfg), jstate["params"],
                 atol=5e-5, rtol=0)


@pytest.mark.parametrize("arch", ["mamba-110m", "mamba2-370m"])
def test_interop_round_trip(arch):
    """params_from_jax ∘ to_jax_tree is the identity, under the config's
    own unit key."""
    cfg = get_config(arch).reduced()
    model = LM(cfg, "cpu").init(torch.Generator().manual_seed(2))
    named = dict(model.named_parameters())
    tree = to_jax_tree(named, cfg)
    assert list(tree["units"]) == [f"0_{cfg.unit[0]}"]
    back = params_from_jax(tree, cfg, "cpu")
    assert sorted(back) == sorted(named)
    for k, v in named.items():
        assert torch.equal(back[k], v.detach()), k


def test_init_distributions():
    cfg = get_config("mamba2-370m").reduced()
    model = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    p = model.layers[0]
    A = torch.exp(p["A_log"])
    assert p["A_log"].shape == (cfg.n_ssm_heads,)
    assert bool(((A >= 1) & (A <= 16)).all())
    assert torch.all(p["dt_b"] == -4.6) and torch.all(p["D"] == 1)
    assert tuple(p["bc_proj"].shape) == (cfg.d_inner, 2 * cfg.d_state)


def test_cli_tiny_on_cpu_takes_2_steps(capsys):
    hist = ttrain.main(["--arch", "mamba2-370m", "--tiny", "--device", "cpu",
                        "--steps", "2", "--rows", "2", "--seq-len", "64"])
    out = capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert '"arch": "mamba2-370m"' in out


# ----------------------------------------------------------------- serving

def test_prefill_packed_scatter_decode_match_jax(pair):
    _, jmodel, jparams, cfg = pair
    model = _port(jparams, cfg)
    _, batch, ends = _packed(_prompts(cfg))
    jl, js, jlens = jmodel.prefill_packed(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 32,
        jnp.asarray(ends))
    tl, ts, tlens = model.prefill_packed(batch, ends)
    _close(tl, jl)
    assert np.array_equal(tlens.numpy(), np.asarray(jlens))
    jst = js["units"]["0_mamba2"]
    for k in ("conv", "ssm"):
        assert tuple(ts[k].shape) == jst[k].shape
        _close(ts[k], jst[k])
    slots = 5
    src = np.array([0, 1, 3, 4, 2], np.int32)
    dst = np.array([4, 0, 2, slots, slots], np.int32)
    jcache = jmodel.scatter_into_cache(jmodel.init_cache(slots, 32), js,
                                       jnp.asarray(src), jnp.asarray(dst))
    tcache = model.scatter_into_cache(model.init_cache(slots), ts, src, dst)
    tok = np.array([[3], [7], [1], [9], [4]], np.int32)
    clen = jnp.zeros((slots,), jnp.int32)
    for step in range(3):
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                         clen + step)
        tlg, tcache = model.decode_step(tcache, torch.as_tensor(tok))
        _close(tlg, jlg)
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache["units"]["0_mamba2"][k])
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)


def test_engine_streams_match_jax(pair):
    """Greedy engine streams, mid-flight refills included, equal to the JAX
    engine's (overlap off, no chunked prefill)."""
    _, jmodel, jparams, cfg = pair
    model = _port(jparams, cfg)
    kw = dict(num_slots=3, max_len=64, prefill_rows=2, buckets=(16, 32),
              max_segments=2, refill_threshold=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 30, size=6)]
    outs = []
    for eng in (JEngine(jmodel, jparams, overlap=False, chunk_rows=0, **kw),
                ServeEngine(model, overlap=False, chunk_rows=0, **kw)):
        for p in prompts:
            eng.submit(p, 5)
        outs.append((eng.run(), eng.stats))
    (j_outs, jst), (t_outs, tst) = outs
    assert t_outs == j_outs
    assert tst.midflight_refills > 0
    assert (tst.prefills, tst.decode_steps) == (jst.prefills,
                                                jst.decode_steps)
