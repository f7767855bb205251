"""Port parity of the head-structured scan kernels #7 (``blocked_heads``
forward), #8 (``blocked_heads_dual`` forward) and #9 (their backward): the
plain versions (the CUDA kernels' functions on the CPU) against the JAX
package's ``selective_scan_heads_fwd_pallas`` /
``selective_scan_heads_bwd_pallas`` in interpret mode — y, the chunk-entry
checkpoints and every backward partial — and the port's autograd wiring
(``ops.selective_scan_heads``) against ``jax.grad`` of
``kops.selective_scan_heads(..., backend="pallas")`` for both schedules;
also the plain model-path reference ``core/ssm.selective_scan_heads`` and
its decode step against ``repro.core.ssm``; and the chunked (SSD)
arithmetic that the CUDA kernels #7 and #9 evaluate
(``selective_scan_heads_fwd_dual_plain`` at ``tile=q``,
``selective_scan_heads_bwd_chunked_plain``), against the TPU kernels and
the per-step plain versions where sub-chunks meet resets, chunk ends and
L.

Inputs from numpy with a seed: row 0 packed with resets (one inside a
subtile), row 1 a carried row of a split pack (first position > 0), B and
C as strided views of one projection, and a ragged L (37) beside a whole
one. Tolerances are the reference's own (``tests/test_mamba2.py``):
forward 1e-4, gradients 1e-4 abs / 1e-3 rel, and exactly 0 (1e-7) across
a reset.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import selective_scan as jsk  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan_heads as kh  # noqa: E402

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
BWD_TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    Bz = 2
    u = rng.normal(size=(Bz, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, (Bz, L, H)).astype(np.float32)
    A = -rng.uniform(1.0, 4.0, (H,)).astype(np.float32)
    bc = rng.normal(size=(Bz, L, 3 + 2 * N)).astype(np.float32)
    Dk = rng.normal(size=(H,)).astype(np.float32)
    pos = np.zeros((Bz, L), np.int32)
    cuts = sorted({0, min(5, L), min(21, L), L})  # 5, 21: inside subtiles
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    sp = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 2, L)], L)
    assert sp.positions[1, 0] > 0
    pos[1] = sp.positions[1]
    dy = rng.normal(size=(Bz, L, H, P)).astype(np.float32)
    return u, dt, A, bc, Dk, pos, dy


def _split(bc, N):
    """B and C as strided views of one projection (B, L, 3 + 2N)."""
    return bc[..., 3:3 + N], bc[..., 3 + N:]


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    def counts():
        return (kh.LAUNCHES_FWD, kh.LAUNCHES_DUAL, kh.LAUNCHES_BWD)
    before = counts()
    yield
    assert counts() == before


# (L, H, P, N, chunk): L = 37 is ragged (the JAX side pads it with
# pos = 1, Δ = 0)
SHAPES = [(40, 2, 32, 8, 16), (37, 3, 16, 4, 8)]


def _padL(x, axis, chunk, value=0):
    """x with axis L padded to a multiple of ``chunk``."""
    w = [(0, 0)] * x.ndim
    w[axis] = (0, (-x.shape[axis]) % chunk)
    return np.pad(x, w, constant_values=value)


def _pallas_fwd(u, dt, A, Bm, Cm, Dk, pos, chunk, schedules=kh.SCHEDULES):
    """The JAX forward kernels' inputs (head-major, L padded to the chunk
    as ``kops.selective_scan_heads`` pads it: pos = 1, Δ = 0) and their
    y and ckpts for each of ``schedules``."""
    L = u.shape[1]
    j = [jnp.asarray(a) for a in (
        _padL(np.moveaxis(u, 2, 1), 2, chunk),
        _padL(np.moveaxis(dt, 2, 1), 2, chunk), A[:, None],
        _padL(Bm, 1, chunk), _padL(Cm, 1, chunk), Dk[:, None],
        _padL(pos, 1, chunk, value=1))]
    fwd = {}
    for sched in schedules:
        y, ck = jsk.selective_scan_heads_fwd_pallas(*j, chunk=chunk,
                                                    schedule=sched)
        fwd[sched] = (np.moveaxis(np.asarray(y), 1, 2)[:, :L],
                      np.asarray(ck))
    return j, fwd


def _pallas(u, dt, A, Bm, Cm, Dk, pos, dy, chunk):
    """The JAX kernels' outputs on these inputs: y and ckpts of both
    forward schedules, the backward's outputs."""
    j, fwd = _pallas_fwd(u, dt, A, Bm, Cm, Dk, pos, chunk)
    bwd = jsk.selective_scan_heads_bwd_pallas(
        *j, jnp.asarray(fwd[kh.SCHEDULES[-1]][1]),
        jnp.asarray(_padL(np.moveaxis(dy, 2, 1), 2, chunk)), chunk=chunk)
    return fwd, [np.asarray(a) for a in bwd]


@pytest.fixture(scope="module", params=SHAPES,
                ids=lambda s: "x".join(map(str, s)))
def pallas(request):
    """Inputs and the JAX kernels' outputs (``_pallas``)."""
    L, H, P, N, chunk = request.param
    u, dt, A, bc, Dk, pos, dy = _inputs(L, H, P, N, L * H)
    Bm, Cm = _split(bc, N)
    fwd, bwd = _pallas(u, dt, A, Bm, Cm, Dk, pos, dy, chunk)
    return (L, H, P, N, chunk), (u, dt, A, Bm, Cm, Dk, pos, dy), fwd, bwd


@pytest.mark.parametrize("schedule", kh.SCHEDULES)
def test_forward_plain_matches_pallas(pallas, schedule):
    (L, H, P, N, chunk), (u, dt, A, Bm, Cm, Dk, pos, _), fwd, _ = pallas
    plain = {"blocked_heads": kh.selective_scan_heads_fwd_plain,
             "blocked_heads_dual": kh.selective_scan_heads_fwd_dual_plain}
    y, ck = plain[schedule](*_t(u, dt, A, Bm, Cm, Dk, pos), chunk)
    wy, wck = fwd[schedule]
    assert tuple(ck.shape) == wck.shape == (2, H, -(-L // chunk), P, N)
    np.testing.assert_allclose(y.numpy(), wy, **FWD_TOL)
    np.testing.assert_allclose(ck.numpy(), wck, **FWD_TOL)
    # the wrapper on CPU tensors takes the same plain version
    y2, _ = kh.selective_scan_heads_fwd(*_t(u, dt, A, Bm, Cm, Dk, pos),
                                        chunk, schedule)
    assert torch.equal(y, y2)


def test_backward_plain_matches_pallas(pallas):
    """Every output of #9 partial by partial: the plain version's
    per-slice partials summed over the slices against the TPU kernel's
    per-head ones."""
    (L, H, P, N, chunk), args, fwd, want = pallas
    u, dt, A, Bm, Cm, Dk, pos, dy = args
    nps = kh.n_slices(P)
    ck = torch.as_tensor(np.array(fwd["blocked_heads"][1]))
    du, ddt, dB, dC, dA, dD = kh.selective_scan_heads_bwd(
        *_t(u, dt, A, Bm, Cm, Dk, pos), ck, torch.as_tensor(dy), chunk)
    assert tuple(ddt.shape) == (2, L, H, nps)
    assert tuple(dB.shape) == tuple(dC.shape) == (2, H * nps, L, N)
    assert tuple(dA.shape) == tuple(dD.shape) == (2, H, nps)
    jdu, jddt, jdB, jdC, jdA, jdD = want
    got = {"du": du.numpy(), "ddelta": ddt.sum(-1).numpy(),
           "dB": dB.reshape(2, H, nps, L, N).sum(2).numpy(),
           "dC": dC.reshape(2, H, nps, L, N).sum(2).numpy(),
           "dA": dA.sum(-1).numpy(), "dD": dD.sum(-1).numpy()}
    ref = {"du": np.moveaxis(jdu, 1, 2)[:, :L],
           "ddelta": np.moveaxis(jddt, 1, 2)[:, :L], "dB": jdB[:, :, :L],
           "dC": jdC[:, :, :L], "dA": jdA[..., 0], "dD": jdD[..., 0]}
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **BWD_TOL)


def _subchunk_positions(L, chunk, q, seed):
    """Row 0: resets on the first and on the last step of sub-chunks
    (q steps inside each chunk), on a chunk's first step, and a few at
    random; row 1: a carried row of a split pack (first position > 0)."""
    rng = np.random.default_rng(seed)
    cuts = {0, q, 2 * q - 1, chunk, chunk + q - 1, chunk + min(q, chunk) - 1}
    cuts |= set(rng.integers(1, L, size=3).tolist())
    cuts = sorted(c for c in cuts if c < L) + [L]
    pos = np.zeros((2, L), np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    pos[1] = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 2, L)], L).positions[1]
    assert pos[1, 0] > 0
    return pos


# (L, H, P, N, chunk, q): ragged L; a chunk that is no multiple of q (96,
# 64); a chunk shorter than q (40, 64); a chunk longer than L; P 16, 48 and
# 80 (a short last slice of the partials)
CHUNKED = [(150, 2, 16, 8, 64, 16), (200, 2, 48, 8, 96, 64),
           (300, 1, 16, 8, 256, 64), (97, 2, 80, 4, 40, 64),
           (130, 1, 48, 8, 256, 16), (70, 1, 16, 4, 96, 16)]


@pytest.mark.parametrize("case", CHUNKED, ids=lambda c: "x".join(map(str, c)))
def test_chunked_forward_matches_pallas_and_per_step(case):
    """#7's chunked (SSD) arithmetic, the form its CUDA kernel evaluates
    (``selective_scan_heads_fwd_dual_plain`` at ``tile=q``; the kernel's q
    is ``FWD_SUB_T``), against the TPU kernel #7 in interpret mode and the
    per-step plain version: y and the chunk-entry checkpoints; the wrapper
    on CPU tensors takes the per-step version."""
    L, H, P, N, chunk, q = case
    u, dt, A, bc, Dk, _, _ = _inputs(L, H, P, N, L + q)
    pos = _subchunk_positions(L, chunk, q, L)
    Bm, Cm = _split(bc, N)
    _, fwd = _pallas_fwd(u, dt, A, Bm, Cm, Dk, pos, chunk,
                         ("blocked_heads",))
    wy, wck = fwd["blocked_heads"]
    args = _t(u, dt, A, Bm, Cm, Dk, pos)
    y, ck = kh.selective_scan_heads_fwd_dual_plain(*args, chunk, tile=q)
    sy, sck = kh.selective_scan_heads_fwd_plain(*args, chunk)
    assert tuple(ck.shape) == tuple(sck.shape) == wck.shape == \
        (2, H, -(-L // chunk), P, N)
    for got, step, want in ((y, sy, wy), (ck, sck, wck)):
        np.testing.assert_allclose(got.numpy(), step.numpy(), **FWD_TOL)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    wrapped = kh.selective_scan_heads_fwd(*args, chunk)
    assert torch.equal(wrapped[0], sy) and torch.equal(wrapped[1], sck)


@pytest.mark.parametrize("case", CHUNKED, ids=lambda c: "x".join(map(str, c)))
def test_chunked_backward_matches_pallas_and_per_step(case):
    """#9's chunked (SSD) arithmetic, the form its CUDA kernel evaluates,
    against the TPU kernel in interpret mode (partials summed over the
    slices of P) and against the per-step plain version partial by
    partial; the wrapper on CPU tensors takes the per-step version."""
    L, H, P, N, chunk, q = case
    u, dt, A, bc, Dk, _, dy = _inputs(L, H, P, N, L + q)
    pos = _subchunk_positions(L, chunk, q, L)
    Bm, Cm = _split(bc, N)
    fwd, want = _pallas(u, dt, A, Bm, Cm, Dk, pos, dy, chunk)
    args = _t(u, dt, A, Bm, Cm, Dk, pos)
    ck = torch.as_tensor(np.array(fwd["blocked_heads"][1]))
    dyt = torch.as_tensor(dy)
    got = kh.selective_scan_heads_bwd_chunked_plain(*args, ck, dyt, chunk, q)
    step = kh.selective_scan_heads_bwd_plain(*args, ck, dyt, chunk)
    nps = kh.n_slices(P)
    shapes = [(2, L, H, P), (2, L, H, nps), (2, H * nps, L, N),
              (2, H * nps, L, N), (2, H, nps), (2, H, nps)]
    names = ("du", "ddelta", "dB", "dC", "dA", "dD")
    for name, g, w, shape in zip(names, got, step, shapes):
        assert tuple(g.shape) == tuple(w.shape) == shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **BWD_TOL)
    du, ddt, dB, dC, dA, dD = got
    jdu, jddt, jdB, jdC, jdA, jdD = want
    summed = {"du": du.numpy(), "ddelta": ddt.sum(-1).numpy(),
              "dB": dB.reshape(2, H, nps, L, N).sum(2).numpy(),
              "dC": dC.reshape(2, H, nps, L, N).sum(2).numpy(),
              "dA": dA.sum(-1).numpy(), "dD": dD.sum(-1).numpy()}
    ref = {"du": np.moveaxis(jdu, 1, 2)[:, :L],
           "ddelta": np.moveaxis(jddt, 1, 2)[:, :L], "dB": jdB[:, :, :L],
           "dC": jdC[:, :, :L], "dA": jdA[..., 0], "dD": jdD[..., 0]}
    for k in summed:
        np.testing.assert_allclose(summed[k], ref[k], err_msg=k, **BWD_TOL)
    wrapped = kh.selective_scan_heads_bwd(*args, ck, dyt, chunk)
    for g, w in zip(wrapped, step):
        assert torch.equal(g, w)


@pytest.mark.parametrize("schedule", kh.SCHEDULES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ops_gradients_match_jax(shape, schedule):
    """``ops.selective_scan_heads`` (the autograd Function over the plain
    #7/#8 and #9 with the partials summed in a fixed order) against
    ``jax.grad`` of the JAX wrapper with backend="pallas"."""
    L, H, P, N, chunk = shape
    u, dt, A, bc, Dk, pos, dy = _inputs(L, H, P, N, 11 * L)

    def jloss(u, dt, A, bc, Dk):
        Bm, Cm = _split(bc, N)
        y = jops.selective_scan_heads(u, dt, A, Bm, Cm, Dk,
                                      positions=jnp.asarray(pos),
                                      backend="pallas", chunk=chunk,
                                      schedule=schedule)
        return (y * dy).sum(), y

    (jl, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                      has_aux=True)(
        *[jnp.asarray(a) for a in (u, dt, A, bc, Dk)])
    leaves = [t.requires_grad_() for t in _t(u, dt, A, bc, Dk)]
    tu, tdt, tA, tbc, tD = leaves
    Bm, Cm = _split(tbc, N)
    ty = tops.selective_scan_heads(tu, tdt, tA, Bm, Cm, tD,
                                   positions=torch.as_tensor(pos),
                                   chunk=chunk, schedule=schedule)
    tg = torch.autograd.grad((ty * torch.as_tensor(dy)).sum(), leaves)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **FWD_TOL)
    for name, g, w in zip(("u", "delta", "A", "B|C", "D"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


@pytest.mark.parametrize("schedule", kh.SCHEDULES)
def test_gradient_does_not_cross_a_reset(schedule):
    """Backward PUI (paper §3.4): a loss on the second segment gives the
    first exactly zero gradient, with the reset inside a subtile."""
    L, H, P, N = 24, 2, 16, 4
    u, dt, A, bc, Dk, _, _ = _inputs(L, H, P, N, 5)
    pos = np.tile(np.concatenate([np.arange(11), np.arange(13)]),
                  (2, 1)).astype(np.int32)
    tu = torch.as_tensor(u).requires_grad_()
    Bm, Cm = _split(torch.as_tensor(bc), N)
    y = tops.selective_scan_heads(tu, *_t(dt, A), Bm, Cm,
                                  torch.as_tensor(Dk),
                                  positions=torch.as_tensor(pos), chunk=8,
                                  schedule=schedule)
    (g,) = torch.autograd.grad(y[:, 11:].square().sum(), [tu])
    np.testing.assert_allclose(g[:, :11].numpy(), 0.0, atol=1e-7)
    assert float(g[:, 11:].abs().max()) > 0


def test_carried_row_starts_from_the_checkpoint_not_zero():
    """Fault watch (a): a carried row's first position is > 0, so no reset
    fires at the buffer start; the scan of the carried half alone with
    h0 from the first half equals the whole row's tail."""
    L, H, P, N = 32, 2, 16, 4
    u, dt, A, bc, Dk, _, _ = _inputs(L, H, P, N, 8)
    Bm, Cm = _split(bc, N)
    pos = np.tile(np.arange(7, 7 + L), (2, 1)).astype(np.int32)
    args = _t(u, dt, A, Bm, Cm, Dk, pos)
    y, ck = kh.selective_scan_heads_fwd(*args, 16)
    assert float(ck[:, :, 1].abs().max()) > 0      # chunk 1 enters non-zero
    from repro_torch.core import ssm as core_ssm
    y_ref = core_ssm.selective_scan_heads(
        *args[:6], positions=args[6], method="sequential")
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **FWD_TOL)


HEADS_METHODS = [("sequential", None), ("blocked", "quad"),
                 ("blocked", "dual")]


@pytest.mark.parametrize("method,intra", HEADS_METHODS)
@pytest.mark.parametrize("chunk", [8, 256])
def test_core_scan_heads_matches_jax(method, intra, chunk):
    """``core/ssm.selective_scan_heads`` (the plain model-path reference:
    h0, return_state, collect_ends; the chunk clamped at the JAX caps)
    against ``repro.core.ssm.selective_scan_heads``."""
    from repro.core import ssm as jssm
    from repro_torch.core import ssm as tssm
    L, H, P, N = 29, 3, 4, 5
    u, dt, A, bc, Dk, pos, _ = _inputs(L, H, P, N, chunk)
    Bm, Cm = _split(bc, N)
    h0 = np.random.default_rng(chunk).normal(size=(2, H, P, N)).astype(
        np.float32)
    ends = np.array([[4, 20, L - 1], [L - 1, -1, -1]], np.int32)
    kw = dict(method=method, chunk=chunk, intra=intra, return_state=True)
    jy, jh, je = jssm.selective_scan_heads(
        u, dt, A, Bm, Cm, Dk, positions=pos, h0=h0,
        collect_ends=jnp.asarray(ends), **kw)
    ty, th, te = tssm.selective_scan_heads(
        *_t(u, dt, A, Bm, Cm, Dk), positions=torch.as_tensor(pos),
        h0=torch.as_tensor(h0), collect_ends=torch.as_tensor(ends), **kw)
    for got, want in ((ty, jy), (th, jh), (te, je)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_core_scan_heads_step_matches_jax():
    from repro.core import ssm as jssm
    from repro_torch.core import ssm as tssm
    H, P, N = 3, 4, 5
    u, dt, A, bc, Dk, _, _ = _inputs(4, H, P, N, 4)
    Bm, Cm = _split(bc, N)
    h = np.random.default_rng(4).normal(size=(2, H, P, N)).astype(np.float32)
    reset = np.array([True, False])
    jy, jh = jssm.selective_scan_heads_step(
        h, u[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], Dk, reset_t=reset)
    ty, th = tssm.selective_scan_heads_step(
        *_t(h, u[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], Dk),
        reset_t=torch.as_tensor(reset))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FWD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)


def test_wrapper_validation():
    u, dt, A, bc, Dk, pos, dy = _inputs(8, 2, 16, 4, 1)
    Bm, Cm = _split(bc, 4)
    args = _t(u, dt, A, Bm, Cm, Dk, pos)
    with pytest.raises(ValueError, match="unknown heads schedule"):
        tops.selective_scan_heads(*args[:6], positions=args[6],
                                  schedule="step")
    with pytest.raises(ValueError, match="unknown heads schedule"):
        kh.selective_scan_heads_fwd(*args, 8, "blocked")
    with pytest.raises(TypeError, match="u's dtype"):
        kh.selective_scan_heads_fwd(args[0], args[1].double(), *args[2:], 8)
    with pytest.raises(ValueError, match="do not agree"):
        kh.selective_scan_heads_fwd(args[0], args[1], args[2][:1],
                                    *args[3:], 8)
    with pytest.raises(ValueError, match="ckpts"):
        kh.selective_scan_heads_bwd(*args, torch.zeros(1),
                                    torch.as_tensor(dy), 8)
    from repro_torch.core import ssm as tssm
    with pytest.raises(ValueError, match="scalar decay per head"):
        tssm.selective_scan_heads(*args[:2], args[2][:, None], *args[3:6],
                                  positions=args[6])
    assert kh.n_slices(64) == 1 and kh.n_slices(16) == 1 and \
        kh.n_slices(24) == 1 and kh.n_slices(80) == 2 and \
        kh.n_slices(128) == 2
