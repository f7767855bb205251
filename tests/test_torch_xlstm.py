"""Port parity of the xLSTM recurrences and blocks: ``repro_torch.core.
recurrence`` against ``repro.core.recurrence``, and the port's ``mlstm`` /
``slstm`` blocks against the JAX blocks with the same weights, on the same
numpy inputs.

* ``mlstm`` with and without a carried state, resets inside chunks and on
  chunk edges, L no multiple of the chunk (chunks 8, 16 and one longer
  than L); ``mlstm_step``; ``slstm`` with
  the ``valid`` freeze and a carried state; the max-plus stabiliser after
  a reset late in a long row against a float64 sequential reference.
* each block's apply (plain, the per-row and the per-segment handoff),
  decode step and chunk step, on xlstm-125m.reduced() (the JAX side's
  conv on its XLA path, the plain reference of the Pallas kernel #1;
  tests/test_torch_conv*.py hold the port's #1 to the kernel itself).

Tolerance: f32, max |Δ| ≤ 1e-5 · max(1, max |ref|) for the recurrences
and 1e-4 · max(1, max |ref|) for the blocks (the measure of
chip_smoke.py's parity checks). The mLSTM normaliser max(|n·q|, e^−m)
divides by a dot product that can nearly cancel, so the JAX package
disagrees with itself by ~1e-4 of the output's scale between scan chunks
8 and 16 on the reduced model; the block inputs here are the model's own
scale. At one chunk of 64 over these inputs both packages sit 5e-6 and
8e-6 of the scale from a float64 evaluation of the same algorithm, so
their gap (1.3e-5) is f32 rounding in the in-chunk sums, not a fault;
the chunk longer than L here is 40.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import recurrence as jrec  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core import recurrence as rec  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

# the JAX side jitted: op by op, its first calls compile for seconds each
j_mlstm = jax.jit(jrec.mlstm, static_argnames=("chunk", "return_state"))
j_mlstm_step = jax.jit(jrec.mlstm_step)
j_slstm = jax.jit(jrec.slstm, static_argnames=("return_state",))

REC_TOL = 1e-5
BLOCK_TOL = 1e-4
B, L, H, DK = 2, 37, 3, 8
# row 0: resets at 0, 8 (a chunk edge at chunk 8), 19 and 32 (an edge at
# chunk 16 is 32); row 1: a carried row (positions > 0 at its start)
POS = np.stack([np.concatenate([np.arange(8), np.arange(11), np.arange(13),
                                np.arange(5)]),
                np.concatenate([np.arange(6, 6 + 16), np.arange(21)])]
               ).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The sLSTM loop runs thousands of tiny ops: one intra-op thread
    keeps them from spinning on the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def _t(a):
    return torch.as_tensor(np.array(a))


def _mlstm_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, H, DK)).astype(np.float32) * 0.5
               for _ in range(3))
    logf = -np.log1p(np.exp(-(rng.normal(size=(B, L, H)) + 3.0)))
    logi = rng.normal(size=(B, L, H))
    state = (rng.normal(size=(B, H, DK, DK)).astype(np.float32),
             rng.normal(size=(B, H, DK)).astype(np.float32),
             rng.normal(size=(B, H)).astype(np.float32))
    return (q, k, v, logf.astype(np.float32), logi.astype(np.float32)), state


@pytest.mark.parametrize("chunk", [8, 16, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_matches_jax(chunk, carried):
    args, state = _mlstm_inputs(chunk)
    kw = dict(chunk=chunk, return_state=True)
    jy, jst = j_mlstm(*map(jnp.asarray, args), positions=jnp.asarray(POS),
                         state=tuple(map(jnp.asarray, state)) if carried
                         else None, **kw)
    y, st = rec.mlstm(*map(_t, args), positions=_t(POS),
                      state=tuple(map(_t, state)) if carried else None, **kw)
    _close(y, jy, REC_TOL)
    for a, b in zip(st, jst):
        _close(a, b, REC_TOL)
    # the carried state reaches the carried row only (row 0 starts with a
    # reset)
    y0 = rec.mlstm(*map(_t, args), positions=_t(POS), chunk=chunk)
    assert torch.equal(y[0], y0[0]) and (carried != torch.equal(y[1], y0[1]))


def test_mlstm_without_positions_matches_jax():
    args, _ = _mlstm_inputs(3)
    _close(rec.mlstm(*map(_t, args), chunk=16),
           j_mlstm(*map(jnp.asarray, args), chunk=16), REC_TOL)


def test_maxplus_restarts_after_a_late_reset():
    """m after a reset 900 steps into a row equals the float64 sequential
    recurrence: a running sum over the row would hold the −1e30 of the
    reset and swallow every later term."""
    rng = np.random.default_rng(7)
    Lr = 1200
    logf = np.log(1.0 / (1.0 + np.exp(-(rng.normal(size=(1, Lr, 2)) + 3.0))))
    logi = rng.normal(size=(1, Lr, 2)) * 3.0
    reset = np.zeros((1, Lr), bool)
    reset[0, [0, 900, 901, 1100]] = True
    m_in0 = np.array([[4.0, -1e30]])
    for carried in (None, m_in0):
        want = np.zeros((1, Lr, 2))
        m = np.full((1, 2), -np.inf) if carried is None else carried.copy()
        for t in range(Lr):
            lf = -np.inf if reset[0, t] else logf[:, t]
            m = np.maximum(lf + m, logi[:, t])
            want[:, t] = m
        lf32 = np.where(reset[..., None], -1e30, logf).astype(np.float32)
        got = rec._maxplus(_t(lf32), _t(logi.astype(np.float32)), _t(reset),
                           None if carried is None
                           else _t(carried.astype(np.float32)))
        _close(got, want, REC_TOL)


@pytest.mark.parametrize("with_reset", [False, True])
def test_mlstm_step_matches_jax(with_reset):
    args, state = _mlstm_inputs(11)
    q, k, v, logf, logi = (a[:, 0] for a in args)
    reset = np.array([True, False]) if with_reset else None
    jy, jst = j_mlstm_step(tuple(map(jnp.asarray, state)), q, k, v, logf,
                              logi, None if reset is None
                              else jnp.asarray(reset))
    y, st = rec.mlstm_step(tuple(map(_t, state)), *map(_t, (q, k, v, logf,
                                                            logi)),
                           None if reset is None else _t(reset))
    _close(y, jy, REC_TOL)
    for a, b in zip(st, jst):
        _close(a, b, REC_TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_matches_jax(carried):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, L, 4, H, DK)).astype(np.float32)
    R = (rng.normal(size=(4, H, DK, DK)) * DK ** -0.5 * 0.3).astype(
        np.float32)
    valid = np.ones((B, L), bool)
    valid[1, 30:] = False                        # row 1's trailing padding
    state = tuple(rng.normal(size=(B, H, DK)).astype(np.float32)
                  for _ in range(4)) if carried else None
    jy, jst = j_slstm(jnp.asarray(x), jnp.asarray(R),
                         positions=jnp.asarray(POS), return_state=True,
                         valid=jnp.asarray(valid),
                         state=None if state is None
                         else tuple(map(jnp.asarray, state)))
    y, st = rec.slstm(_t(x), _t(R), positions=_t(POS), return_state=True,
                      valid=_t(valid),
                      state=None if state is None else tuple(map(_t, state)))
    _close(y, jy, REC_TOL)
    for a, b in zip(st, jst):
        _close(a, b, REC_TOL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

PROMPTS = (11, 6, 9, 3, 5)
ROW = 20


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("xlstm-125m").reduced()
    cfg = get_config("xlstm-125m").reduced()
    rng = np.random.default_rng(0)
    prompts = [np.zeros(n, np.int32) for n in PROMPTS]
    pb = packing.pack(prompts, ROW, policy="first_fit", num_rows=2)
    ends = packing.segment_ends(pb, 3)
    x = rng.normal(size=(2, ROW, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, pb, ends, x


def _params(jcfg, kind, seed):
    jp = jblocks.INIT[kind](jax.random.PRNGKey(seed), jcfg)
    if kind == "mlstm":                 # a conv bias that is not zero
        jp = dict(jp, conv_b=jax.random.normal(jax.random.PRNGKey(seed + 1),
                                               jp["conv_b"].shape) * 0.1)
    return jp, {k: _t(v) for k, v in jp.items()}


@functools.lru_cache(maxsize=None)
def _jblock(fn, jcfg, **kw):
    """A JAX block function jitted over (params, x, state, positions,
    segment_ids, reset) with its config and handoff mode fixed."""
    def call(p, x, state, pos, seg, reset):
        ctx = jblocks.Ctx(positions=pos, segment_ids=seg, reset_t=reset)
        if state is None:
            return fn(p, x, ctx, jcfg, **kw)
        return fn(p, x, state, ctx, jcfg)
    return jax.jit(call)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["plain", "row", "segments"])
def test_block_apply_matches_jax(setup, kind, mode):
    jcfg, cfg, pb, ends, x = setup
    jp, p = _params(jcfg, kind, 1)
    ctx = blocks.Ctx(positions=_t(pb.positions),
                     segment_ids=_t(pb.segment_ids))
    kw = {"plain": {}, "row": dict(collect=True),
          "segments": dict(collect=True, collect_ends=_t(ends))}[mode]
    jfn = getattr(jblocks, f"apply_{kind}")
    if mode == "segments":
        jfn = functools.partial(jfn, collect_ends=jnp.asarray(ends))
    jout = _jblock(jfn, jcfg, **(dict(collect=64) if kw else {}))(
        jp, jnp.asarray(x), None, jnp.asarray(pb.positions),
        jnp.asarray(pb.segment_ids), None)
    out = blocks.KINDS[kind][2](p, _t(x), ctx, cfg, **kw)
    if mode == "plain":
        _close(out, jout, BLOCK_TOL)
        return
    _close(out[0], jout[0], BLOCK_TOL)
    assert sorted(out[1]) == sorted(jout[1])
    for k in jout[1]:
        _close(out[1][k], jout[1][k], BLOCK_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_step_matches_jax(setup, kind):
    jcfg, cfg, _, _, x = setup
    jp, p = _params(jcfg, kind, 2)
    rng = np.random.default_rng(3)
    jc = jblocks.CACHE_INIT[kind](jcfg, 2, jnp.float32)
    state = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in jc.items()}
    reset = np.array([False, True])
    jy, jst = _jblock(jblocks.STEP[kind], jcfg)(
        jp, jnp.asarray(x[:, :1]), {k: jnp.asarray(v) for k, v in
                                    state.items()}, None, None,
        jnp.asarray(reset))
    y, st = blocks.KINDS[kind][4](
        p, _t(x[:, :1]), {k: _t(v) for k, v in state.items()},
        blocks.Ctx(reset_t=_t(reset)), cfg)
    _close(y, jy, BLOCK_TOL)
    for k in jst:
        _close(st[k], jst[k], BLOCK_TOL)
    # the empty cache is the JAX one: zeros, the stabilisers at −1e30
    empty = blocks.KINDS[kind][3](cfg, 2, torch.float32, "cpu")
    assert sorted(empty) == sorted(jc)
    for k in jc:
        np.testing.assert_array_equal(empty[k].numpy(), np.asarray(jc[k]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_chunk_matches_jax(setup, kind):
    """Two slabs of 7 from a carried state; row 1 ends after 10 tokens, so
    its second slab is mostly padding."""
    jcfg, cfg, _, _, x = setup
    jp, p = _params(jcfg, kind, 4)
    rng = np.random.default_rng(9)
    jc = jblocks.CACHE_INIT[kind](jcfg, 2, jnp.float32)
    cache = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in jc.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    cache = {k: _t(v) for k, v in cache.items()}
    lens = np.array([14, 10])
    for off in (0, 7):
        t = off + np.arange(7)
        pos = np.broadcast_to(5 + t, (2, 7)).astype(np.int32)
        seg = (t[None] < lens[:, None]).astype(np.int32)
        xs = x[:, off:off + 7]
        jy, jcache = _jblock(jblocks.CHUNK[kind], jcfg)(
            jp, jnp.asarray(xs), jcache, jnp.asarray(pos), jnp.asarray(seg),
            None)
        y, cache = blocks.CHUNK[kind](
            p, _t(xs), cache, blocks.Ctx(positions=_t(pos),
                                         segment_ids=_t(seg)), cfg)
        _close(y[seg > 0], np.asarray(jy)[seg > 0], BLOCK_TOL)
        for k in jcache:
            _close(cache[k], jcache[k], BLOCK_TOL)


def test_d_ff_on_an_xlstm_unit_raises():
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(), d_ff=128)
    with pytest.raises(NotImplementedError, match="MLP"):
        LM(cfg, "cpu")
