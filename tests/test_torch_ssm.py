"""Port parity: repro_torch.core.ssm (sequential, blocked/assoc,
blocked/matmul; h0, return_state, collect_ends) and the decode step
against repro.core.ssm and the repro.kernels.ref oracle.

Tolerance 1e-5 in f32: the same recurrence with products and sums taken
in another order (the doubling tree is not JAX's associative_scan).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ssm as jssm  # noqa: E402
from repro.core import scan as jscan  # noqa: E402
from repro.kernels.ref import selective_scan_ref as jref  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.core import ssm as tssm  # noqa: E402
from repro_torch.kernels.ref import selective_scan_ref as tref  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

ATOL = 1e-5
METHODS = [("sequential", None), ("blocked", "assoc"), ("blocked", "matmul")]


def _inputs(seed, Bz=2, L=29, Dm=6, N=4):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    delta = (np.log1p(np.exp(rng.normal(size=(Bz, L, Dm)))) * 0.5
             ).astype(np.float32)
    A = -np.exp(rng.normal(size=(Dm, N))).astype(np.float32)
    B = rng.normal(size=(Bz, L, N)).astype(np.float32)
    C = rng.normal(size=(Bz, L, N)).astype(np.float32)
    D = rng.normal(size=(Dm,)).astype(np.float32)
    pos = np.stack([np.concatenate([np.arange(11), np.arange(L - 11)]),
                    np.concatenate([np.arange(4), np.arange(9),
                                    np.arange(L - 13)])]).astype(np.int32)
    h0 = rng.normal(size=(Bz, Dm, N)).astype(np.float32)
    ends = np.array([[10, L - 1, -1], [3, 12, L - 1]], np.int32)
    return u, delta, A, B, C, D, pos, h0, ends


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("method,intra", METHODS)
@pytest.mark.parametrize("chunk", [8, 32])
def test_selective_scan_matches_jax(method, intra, chunk):
    u, delta, A, B, C, D, pos, h0, ends = _inputs(chunk)
    j = jssm.selective_scan(u, delta, A, B, C, D, positions=pos, h0=h0,
                            method=method, chunk=chunk, intra=intra,
                            return_state=True, collect_ends=jnp.asarray(ends))
    t = tssm.selective_scan(*_t(u, delta, A, B, C, D), positions=_t(pos)[0],
                            h0=_t(h0)[0], method=method, chunk=chunk,
                            intra=intra, return_state=True,
                            collect_ends=_t(ends)[0])
    assert len(t) == 3
    for a, b in zip(t, j):
        _close(a, b)
    assert not t[2][0, 2].any()                # absent segment → zeros


@pytest.mark.parametrize("method,intra", METHODS)
def test_selective_scan_matches_oracles(method, intra):
    u, delta, A, B, C, D, pos, _, _ = _inputs(3)
    y = tssm.selective_scan(*_t(u, delta, A, B, C, D), positions=_t(pos)[0],
                            method=method, chunk=8, intra=intra)
    y_ref = jref(u, delta, A, B, C, D, positions=pos)
    _close(y, y_ref)
    _close(tref(*_t(u, delta, A, B, C, D), positions=_t(pos)[0]), y_ref)
    # no positions: one segment per row, no reset anywhere
    y1 = tssm.selective_scan(*_t(u, delta, A, B, C, D), method=method,
                             chunk=8, intra=intra)
    _close(y1, jref(u, delta, A, B, C, D))


def test_selective_scan_bf16_compute_and_bad_method():
    u, delta, A, B, C, D, pos, _, _ = _inputs(4)
    y = tssm.selective_scan(*_t(u, delta, A, B, C, D), positions=_t(pos)[0],
                            compute_dtype="bfloat16", chunk=8)
    assert y.dtype == torch.float32
    _close(y, jref(u, delta, A, B, C, D, positions=pos), atol=0.1)
    with pytest.raises(ValueError):
        tssm.selective_scan(*_t(u, delta, A, B, C, D), method="scanned")
    with pytest.raises(ValueError):
        tssm.selective_scan(*_t(u, delta, A, B, C, D), intra="quad")


def test_selective_scan_step_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.normal(size=(3, 6, 4)).astype(np.float32)
    u, d = (rng.normal(size=(3, 6)).astype(np.float32) for _ in range(2))
    d = np.abs(d)
    A = -np.exp(rng.normal(size=(6, 4))).astype(np.float32)
    Bt, Ct = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(6,)).astype(np.float32)
    reset = np.array([False, True, False])
    for r in (None, reset):
        jy, jh = jssm.selective_scan_step(h, u, d, A, Bt, Ct, D,
                                          None if r is None else
                                          jnp.asarray(r))
        ty, th = tssm.selective_scan_step(*_t(h, u, d, A, Bt, Ct, D),
                                          None if r is None else _t(r)[0])
        _close(ty, jy)
        _close(th, jh)


def test_scan_primitives_match_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0.2, 1.0, size=(2, 13, 3)).astype(np.float32)
    b = rng.normal(size=(2, 13, 3)).astype(np.float32)
    reset = rng.uniform(size=(2, 13)) < 0.2
    h0 = rng.normal(size=(2, 3)).astype(np.float32)
    for got, want in zip(tscan.scan_sequential(*_t(a, b, reset, h0)),
                         jscan.scan_sequential(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(reset),
                                               jnp.asarray(h0))):
        _close(got, want)
    # the doubling tree's composites end in the sequential walk's states
    A, Bc = tscan.associative_pairs(*_t(np.where(reset[..., None], 0.0, a)
                                        .astype(np.float32), b))
    _close(Bc + A * _t(h0)[0][:, None],
           jscan.scan_sequential(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(reset), jnp.asarray(h0))[0])
    _close(tscan.scan_step(*_t(h0, a[:, 0], b[:, 0], reset[:, 0])),
           jscan.scan_step(h0, a[:, 0], b[:, 0], jnp.asarray(reset[:, 0])))
    ends = np.array([[0, 12, -1], [5, -1, 7]], np.int32)
    traj = rng.normal(size=(2, 13, 3)).astype(np.float32)
    _close(tscan.gather_state_ends(*_t(traj, ends)),
           jscan.gather_state_ends(traj, jnp.asarray(ends)))
