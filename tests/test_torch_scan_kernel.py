"""Port parity of the selective-scan kernels #4 (blocked forward) and #6
(blocked backward): their plain versions (the CUDA kernels' functions on the
CPU) against the JAX package's ``selective_scan_fwd_pallas`` /
``selective_scan_bwd_pallas`` with ``schedule="blocked"`` in interpret mode
— y, the chunk-entry checkpoints, and every backward output partial by
partial — and the port's autograd wiring against ``jax.grad`` of
``selective_scan(..., backend="pallas")``.

Tolerances: forward 1e-5 (the per-step walk against the TPU kernel's
subtile contraction: the same products in another order); backward and
gradients 1e-4 abs / 1e-3 rel (sums over L and over channels in another
order). No gradient crosses a reset: exactly 0 (1e-7).
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
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-3)
CHUNK, BLOCK_D = 16, 8


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


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD)
    yield
    assert (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD) == before


@pytest.fixture(scope="module", params=[(2, 32, 16, 16), (2, 48, 24, 4)],
            ids=lambda s: "x".join(map(str, s)))
def pallas(request):
    """Inputs and the JAX kernels' outputs (fwd and bwd), shared by the
    forward and backward tests of one shape."""
    Bz, L, Dm, N = request.param
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(Bz, L, Dm, N, L + Dm)
    j = [jnp.asarray(a) for a in (u, dt, A.T, Bm, Cm, Dk[None], pos)]
    y, ck = jsk.selective_scan_fwd_pallas(*j, block_d=BLOCK_D, chunk=CHUNK,
                                          schedule="blocked")
    bwd = jsk.selective_scan_bwd_pallas(*j, ck, jnp.asarray(dy),
                                        block_d=BLOCK_D, chunk=CHUNK,
                                        schedule="blocked")
    return ((u, dt, A, Bm, Cm, Dk, pos, dy),
            [np.asarray(a) for a in (y, ck)], [np.asarray(a) for a in bwd])


def test_fwd_plain_matches_pallas_blocked(pallas):
    (u, dt, A, Bm, Cm, Dk, pos, _), (y, ck), _ = pallas
    got_y, got_ck = ksc.selective_scan_fwd(*_t(u, dt, A.T, Bm, Cm, Dk, pos),
                                           chunk=CHUNK)
    np.testing.assert_allclose(got_y.numpy(), y, **FWD_TOL)
    assert tuple(got_ck.shape) == ck.shape
    np.testing.assert_allclose(got_ck.numpy(), ck, **FWD_TOL)


def test_bwd_plain_matches_pallas_blocked(pallas):
    (u, dt, A, Bm, Cm, Dk, pos, dy), (_, ck), want = pallas
    args = _t(u, dt, A.T, Bm, Cm, Dk, pos)
    got = ksc.selective_scan_bwd_plain(*args, *_t(ck, dy), chunk=CHUNK,
                                       block_d=BLOCK_D)
    want[5] = want[5][:, 0]                          # dD (B, 1, D) → (B, D)
    for name, g, w in zip(("du", "ddelta", "dB partials", "dC partials",
                           "dA partials", "dD partials"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)
    # the wrapper's CPU route is the same function (one partial per BLOCK_D)
    du, *_ = ksc.selective_scan_bwd(*args, *_t(ck, dy), chunk=CHUNK)
    assert torch.equal(du, got[0])


@pytest.mark.parametrize("Bz,L,Dm,N", [(2, 37, 12, 16)])
def test_scan_autograd_matches_jax_grad(Bz, L, Dm, N):
    """Ragged L and D: the JAX wrapper pads to its tiles, the port's
    kernels mask the edge."""
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(Bz, L, Dm, N, 7)

    def jloss(*a):
        y = jops.selective_scan(*a, jnp.asarray(pos), backend="pallas",
                                block_d=BLOCK_D, chunk=CHUNK,
                                schedule="blocked")
        return (y * jnp.asarray(dy)).sum()

    want_y = jops.selective_scan(*(jnp.asarray(a) for a in
                                   (u, dt, A, Bm, Cm, Dk)), jnp.asarray(pos),
                                 backend="pallas", block_d=BLOCK_D,
                                 chunk=CHUNK, schedule="blocked")
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (u, dt, A, Bm, Cm, Dk)))
    args = [a.requires_grad_() for a in _t(u, dt, A, Bm, Cm, Dk)]
    y = tops.selective_scan(*args, positions=torch.as_tensor(pos),
                            chunk=CHUNK)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **FWD_TOL)
    got = torch.autograd.grad(y, args, torch.as_tensor(dy))
    for name, g, w in zip(("u", "delta", "A", "B", "C", "D"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"grad {name}", **BWD_TOL)


@pytest.mark.parametrize("boundary", [16, 8], ids=["chunk_edge",
                                                   "mid_chunk"])
def test_no_gradient_crosses_a_reset(boundary):
    """The paper's backward claim on the port: with a reset at
    ``boundary`` (a chunk edge, or inside a chunk), the loss on the second
    sequence has no gradient on the first."""
    u, dt, A, Bm, Cm, Dk, _, _ = _inputs(1, 32, 8, 16, 6)
    pos = np.concatenate([np.arange(boundary),
                          np.arange(32 - boundary)])[None].astype(np.int32)
    args = [a.requires_grad_() for a in _t(u, dt, A, Bm, Cm, Dk)]
    y = tops.selective_scan(*args, positions=torch.as_tensor(pos),
                            chunk=CHUNK)
    (y[:, boundary:] ** 2).sum().backward()
    for name, a in (("u", args[0]), ("delta", args[1]), ("B", args[3]),
                    ("C", args[4])):
        np.testing.assert_allclose(a.grad[:, :boundary].numpy(), 0.0,
                                   atol=1e-7, err_msg=name)
        assert float(a.grad[:, boundary:].abs().max()) > 0


def test_bf16_grads_keep_dtypes_and_strided_B_C():
    """B and C arrive as ``split`` views of x_proj's output; bf16 inputs
    give bf16 gradients (f32 arithmetic inside)."""
    u, dt, A, Bm, Cm, Dk, pos, dy = _inputs(2, 24, 8, 16, 3)
    bf = torch.bfloat16
    dbl = torch.as_tensor(np.concatenate([np.zeros((2, 24, 5), np.float32),
                                          Bm, Cm], -1)).to(bf)
    dbl.requires_grad_()
    _, Bv, Cv = dbl.split([5, 16, 16], dim=-1)
    uu, dd = (torch.as_tensor(a).to(bf).requires_grad_() for a in (u, dt))
    At = torch.as_tensor(A).requires_grad_()
    y = tops.selective_scan(uu, dd, At, Bv, Cv, torch.as_tensor(Dk),
                            positions=torch.as_tensor(pos), chunk=CHUNK)
    assert y.dtype == bf
    y.backward(torch.as_tensor(dy).to(bf))
    assert uu.grad.dtype == bf and dbl.grad.dtype == bf
    assert At.grad.dtype == torch.float32
    assert not dbl.grad[..., :5].any() and dbl.grad[..., 5:].any()

