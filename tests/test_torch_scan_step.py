"""Port parity of the ``step`` schedule of the Mamba-1 selective scan,
kernels #3 (forward, ``_fwd_kernel``) and #5 (backward, ``_bwd_kernel``):
the port's plain versions (the CUDA kernels' functions on the CPU) against
the JAX package's ``selective_scan_fwd_pallas`` /
``selective_scan_bwd_pallas`` with ``schedule="step"`` in interpret mode;
the autograd wiring that carries the schedule from forward to backward
against ``jax.grad`` of ``selective_scan(..., backend="pallas",
schedule="step")``; ``pallas_schedule`` from the config to the scan call;
and the slice as a whole, ``mamba-2.8b`` reduced with
``pallas_schedule="step"``, loss and every gradient against the JAX model
run with ``use_pallas=True``.

Tolerances: forward 1e-5 (the per-step walks of both sides, the same
products in the same order but for XLA's fusions); backward and gradients
1e-4 abs / 1e-3 rel (sums over L and over channels in another order). No
gradient crosses a reset: exactly 0 (1e-7). Model loss 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.data.dataset import CorpusConfig as JCorpusConfig  # noqa: E402
from repro.data.dataset import SyntheticCorpus as JCorpus  # noqa: E402
from repro.data.packing_loader import LoaderConfig as JLoaderConfig  # noqa
from repro.data.packing_loader import PackingLoader as JLoader  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import selective_scan as jsk  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_config  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus  # noqa
from repro_torch.data.packing_loader import LoaderConfig  # noqa: E402
from repro_torch.data.packing_loader import PackingLoader  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-3)
CHUNK, BLOCK_D = 16, 8
SMALL = dict(vocab=128, seed=0, len_min=5, len_max=40, mu=3.0, sigma=0.5)


def _inputs(Bz, L, Dm, N, seed):
    """Row 0: packed sequences with resets (one mid-chunk); row 1: a
    carried row of a split pack (first position > 0)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, (Bz, L, Dm)).astype(np.float32)
    A = -np.exp(rng.normal(size=(Dm, N))).astype(np.float32)
    Bm = rng.normal(size=(Bz, L, N)).astype(np.float32)
    Cm = rng.normal(size=(Bz, L, N)).astype(np.float32)
    Dk = rng.normal(size=(Dm,)).astype(np.float32)
    pos = np.zeros((Bz, L), np.int32)
    cuts = [0, 5, 21, L]
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    sp = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 2, L)], L)
    assert sp.positions[1, 0] > 0
    pos[1:] = sp.positions[1]
    dy = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    return u, dt, A, Bm, Cm, Dk, pos, dy


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _launches():
    return (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD, ksc.LAUNCHES_FWD_STEP,
            ksc.LAUNCHES_BWD_STEP)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = _launches()
    yield
    assert _launches() == before


@pytest.fixture(scope="module", params=[(2, 32, 16, 16), (2, 48, 24, 4)],
                ids=lambda s: "x".join(map(str, s)))
def pallas_step(request):
    """Inputs and the JAX step kernels' outputs (fwd and bwd), shared by
    the forward and backward tests of one shape."""
    Bz, L, Dm, N = request.param
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(Bz, L, Dm, N, L + Dm + 1)
    j = [jnp.asarray(a) for a in (u, dt, A.T, Bm, Cm, Dk[None], pos)]
    y, ck = jsk.selective_scan_fwd_pallas(*j, block_d=BLOCK_D, chunk=CHUNK,
                                          schedule="step")
    bwd = jsk.selective_scan_bwd_pallas(*j, ck, jnp.asarray(dy),
                                        block_d=BLOCK_D, chunk=CHUNK,
                                        schedule="step")
    return ((u, dt, A, Bm, Cm, Dk, pos, dy),
            [np.asarray(a) for a in (y, ck)], [np.asarray(a) for a in bwd])


def test_fwd_plain_matches_pallas_step(pallas_step):
    (u, dt, A, Bm, Cm, Dk, pos, _), (y, ck), _ = pallas_step
    got_y, got_ck = ksc.selective_scan_fwd(*_t(u, dt, A.T, Bm, Cm, Dk, pos),
                                           chunk=CHUNK, schedule="step")
    np.testing.assert_allclose(got_y.numpy(), y, **FWD_TOL)
    assert tuple(got_ck.shape) == ck.shape
    np.testing.assert_allclose(got_ck.numpy(), ck, **FWD_TOL)


def test_bwd_plain_matches_pallas_step(pallas_step):
    (u, dt, A, Bm, Cm, Dk, pos, dy), (_, ck), want = pallas_step
    args = _t(u, dt, A.T, Bm, Cm, Dk, pos)
    got = ksc.selective_scan_bwd_plain(*args, *_t(ck, dy), chunk=CHUNK,
                                       block_d=BLOCK_D)
    want[5] = want[5][:, 0]                          # dD (B, 1, D) → (B, D)
    for name, g, w in zip(("du", "ddelta", "dB partials", "dC partials",
                           "dA partials", "dD partials"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


def test_bwd_wrapper_gives_step_partials(pallas_step):
    """The wrapper's CPU route with ``schedule="step"`` is the same function,
    its dB/dC partials per ``STEP_BLOCK_D`` channels as #5 writes them; over
    the block axis they sum to the JAX kernel's."""
    (u, dt, A, Bm, Cm, Dk, pos, dy), (_, ck), want = pallas_step
    args = _t(u, dt, A.T, Bm, Cm, Dk, pos)
    got = ksc.selective_scan_bwd(*args, *_t(ck, dy), chunk=CHUNK,
                                 schedule="step")
    nblk = -(-u.shape[2] // ksc.STEP_BLOCK_D)
    assert ksc.block_d("step") == ksc.STEP_BLOCK_D == 16
    for i, name in ((2, "dB"), (3, "dC")):
        assert got[i].shape[1] == nblk, name
        np.testing.assert_allclose(got[i].sum(1).numpy(), want[i].sum(1),
                                   err_msg=name, **BWD_TOL)
    for i in (0, 1, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i], **BWD_TOL)


@pytest.mark.parametrize("Bz,L,Dm,N", [(2, 37, 12, 16), (2, 70, 20, 16)],
                         ids=["37x12", "70x20"])
def test_step_autograd_matches_jax_grad(Bz, L, Dm, N):
    """Ragged L and D (the JAX wrapper pads to its tiles, the port's kernels
    mask the edge), L over several chunks, carried rows."""
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(Bz, L, Dm, N, L)

    def jscan(*a):
        return jops.selective_scan(*a, jnp.asarray(pos), backend="pallas",
                                   block_d=BLOCK_D, chunk=CHUNK,
                                   schedule="step")

    jargs = [jnp.asarray(a) for a in (u, dt, A, Bm, Cm, Dk)]
    want_y = jscan(*jargs)
    want = jax.grad(lambda *a: (jscan(*a) * jnp.asarray(dy)).sum(),
                    argnums=tuple(range(6)))(*jargs)
    args = [a.requires_grad_() for a in _t(u, dt, A, Bm, Cm, Dk)]
    y = tops.selective_scan(*args, positions=torch.as_tensor(pos),
                            chunk=CHUNK, schedule="step")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **FWD_TOL)
    got = torch.autograd.grad(y, args, torch.as_tensor(dy))
    for name, g, w in zip(("u", "delta", "A", "B", "C", "D"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"grad {name}", **BWD_TOL)


@pytest.mark.parametrize("boundary", [16, 8, 15],
                         ids=["chunk_edge", "mid_chunk", "before_edge"])
def test_step_no_gradient_crosses_a_reset(boundary):
    """With a reset at ``boundary`` (a chunk edge, inside a chunk, or the
    last step of one: the adjoint's gate sits one step after the
    forward's), the loss on the second sequence has no gradient on the
    first."""
    u, dt, A, Bm, Cm, Dk, _, _ = _inputs(1, 32, 8, 16, 6)
    pos = np.concatenate([np.arange(boundary),
                          np.arange(32 - boundary)])[None].astype(np.int32)
    args = [a.requires_grad_() for a in _t(u, dt, A, Bm, Cm, Dk)]
    y = tops.selective_scan(*args, positions=torch.as_tensor(pos),
                            chunk=CHUNK, schedule="step")
    (y[:, boundary:] ** 2).sum().backward()
    for name, a in (("u", args[0]), ("delta", args[1]), ("B", args[3]),
                    ("C", args[4])):
        np.testing.assert_allclose(a.grad[:, :boundary].numpy(), 0.0,
                                   atol=1e-7, err_msg=name)
        assert float(a.grad[:, boundary:].abs().max()) > 0


def test_unknown_schedule_raises_in_both_packages():
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(2, 32, 8, 4, 1)
    j = [jnp.asarray(a) for a in (u, dt, A.T, Bm, Cm, Dk[None], pos)]
    with pytest.raises(ValueError, match="schedule"):
        jsk.selective_scan_fwd_pallas(*j, block_d=BLOCK_D, chunk=CHUNK,
                                      schedule="walk")
    with pytest.raises(ValueError, match="schedule"):
        jops.selective_scan(*(jnp.asarray(a) for a in (u, dt, A, Bm, Cm,
                                                        Dk)),
                            jnp.asarray(pos), backend="pallas",
                            block_d=BLOCK_D, chunk=CHUNK, schedule="walk")
    args = _t(u, dt, A.T, Bm, Cm, Dk, pos)
    with pytest.raises(ValueError, match="schedule"):
        ksc.selective_scan_fwd(*args, chunk=CHUNK, schedule="walk")
    with pytest.raises(ValueError, match="schedule"):
        ksc.selective_scan_bwd(*args, *_t(np.zeros((2, 2, 4, 8), np.float32),
                                          dy), chunk=CHUNK, schedule="walk")
    with pytest.raises(ValueError, match="schedule"):
        tops.selective_scan(*_t(u, dt, A, Bm, Cm, Dk),
                            positions=torch.as_tensor(pos), schedule="walk")


def test_config_schedule_field_matches_jax():
    """Same name, default and registered value in both packages, so
    ``dataclasses.replace(cfg, pallas_schedule="step")`` reads the same."""
    f = {k.name: k for k in dataclasses.fields(ArchConfig)}
    jf = {k.name: k for k in dataclasses.fields(JArchConfig)}
    assert f["pallas_schedule"].default == jf["pallas_schedule"].default \
        == "blocked"
    for name in ("mamba-110m", "mamba-1.4b", "mamba-2.8b"):
        cfg = dataclasses.replace(get_config(name), pallas_schedule="step")
        jcfg = dataclasses.replace(jget_config(name), pallas_schedule="step")
        assert get_config(name).pallas_schedule == \
            jget_config(name).pallas_schedule
        assert cfg.pallas_schedule == jcfg.pallas_schedule == "step"
        assert cfg.reduced().pallas_schedule == "step"


@pytest.mark.parametrize("schedule", ["blocked", "step"])
def test_apply_mamba_hands_the_config_schedule_to_the_scan(monkeypatch,
                                                            schedule):
    seen = []
    real = tops.selective_scan

    def spy(*a, **k):
        seen.append(k.get("schedule"))
        return real(*a, **k)

    monkeypatch.setattr(blocks.kops, "selective_scan", spy)
    cfg = dataclasses.replace(get_config("mamba-110m").reduced(),
                              pallas_schedule=schedule)
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, 24))
    pos = np.tile(np.arange(24) % 9, (2, 1)).astype(np.int32)
    model.loss({"tokens": toks.astype(np.int32), "positions": pos,
                "segment_ids": np.ones((2, 24), np.int32)})[0].backward()
    assert cfg.remat == "unit"          # each layer's forward runs again
    assert seen == [schedule] * (2 * cfg.n_layers)


# --------------------------------------------------------------- the slice

def _close_trees(got, want, **tol):
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, err_msg=str(path), **tol)


def test_mamba_2_8b_step_loss_and_every_gradient_match_jax():
    """``mamba-2.8b`` reduced with ``pallas_schedule="step"``: the JAX model
    (its step kernels in interpret mode) and the port (kernels' plain
    versions on the CPU) from the same weights and the same packed batch."""
    jcfg = dataclasses.replace(jget_config("mamba-2.8b").reduced(),
                               use_pallas=True, pallas_schedule="step")
    cfg = dataclasses.replace(get_config("mamba-2.8b").reduced(),
                              pallas_schedule="step")
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    lc = dict(rows=2, seq_len=64, mode="pack")
    batch = PackingLoader(SyntheticCorpus(CorpusConfig(**SMALL)),
                          LoaderConfig(**lc)).batch(2)
    jbatch = JLoader(JCorpus(JCorpusConfig(**SMALL)),
                     JLoaderConfig(**lc)).batch(2)
    assert int((batch["positions"] == 0).sum()) > 2   # resets inside rows
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()})
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    loss, _ = model.loss(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _close_trees(to_jax_tree(dict(zip(params, grads)), cfg), jgrads,
                 **BWD_TOL)
