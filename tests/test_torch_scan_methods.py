"""Port parity: the plain scan schedules the tuner chooses among —
``repro_torch.core.scan``'s ``segmented_scan`` methods and
``repro_torch.core.ssm.selective_scan``'s ``chunked``, ``fused_seq`` and
``associative`` (and ``blocked``, whose chunks are checkpointed under
autograd) — against ``repro.core.scan`` / ``repro.core.ssm`` on the same
numpy inputs.

Tolerances are the reference tests': f32 forward 1e-5; gradients 1e-4
atol / 1e-3 rtol; gradients across a reset exactly 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scan as jscan  # noqa: E402
from repro.core import ssm as jssm  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.core import ssm as tssm  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
METHODS = [("chunked", None, 8), ("chunked", None, 256), ("fused_seq", None, 0),
           ("associative", None, 0), ("sequential", None, 0),
           ("blocked", "assoc", 8), ("blocked", "matmul", 8)]


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


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("method,intra,chunk", METHODS)
def test_methods_match_jax_with_state_and_ends(method, intra, chunk):
    u, delta, A, B, C, D, pos, h0, ends = _inputs(len(method) + chunk)
    kw = dict(method=method, intra=intra, return_state=True)
    if chunk:
        kw["chunk"] = chunk
    j = jssm.selective_scan(*map(jnp.asarray, (u, delta, A, B, C, D)),
                            positions=jnp.asarray(pos), h0=jnp.asarray(h0),
                            collect_ends=jnp.asarray(ends), **kw)
    t = tssm.selective_scan(*_t(u, delta, A, B, C, D), positions=_t(pos)[0],
                            h0=_t(h0)[0], collect_ends=_t(ends)[0], **kw)
    assert len(t) == 3
    for a, b in zip(t, j):                         # y, h_last, h_ends
        _close(a, b)
    assert not t[2][0, 2].any()                    # absent segment → zeros
    # no positions, no h0, y only
    y = tssm.selective_scan(*_t(u, delta, A, B, C, D), method=method,
                            intra=intra, **({"chunk": chunk} if chunk else {}))
    _close(y, jssm.selective_scan(u, delta, A, B, C, D, method=method,
                                  intra=intra,
                                  **({"chunk": chunk} if chunk else {})))


@pytest.mark.parametrize("method,intra,chunk", METHODS)
def test_methods_gradients_match_jax(method, intra, chunk):
    u, delta, A, B, C, D, pos, h0, _ = _inputs(7)
    w = np.random.default_rng(8).normal(size=u.shape).astype(np.float32)
    kw = dict(method=method, intra=intra)
    if chunk:
        kw["chunk"] = chunk

    def jloss(u, delta, A, B, C, D, h0):
        y, h = jssm.selective_scan(u, delta, A, B, C, D, positions=pos,
                                   h0=h0, return_state=True, **kw)
        return (y * w).sum() + (h ** 2).sum()

    jg = jax.grad(jloss, argnums=tuple(range(7)))(u, delta, A, B, C, D, h0)
    leaves = [x.requires_grad_() for x in _t(u, delta, A, B, C, D, h0)]
    y, h = tssm.selective_scan(*leaves[:6], positions=_t(pos)[0],
                               h0=leaves[6], return_state=True, **kw)
    loss = (y * torch.as_tensor(w)).sum() + (h ** 2).sum()
    tg = torch.autograd.grad(loss, leaves)
    for a, b in zip(tg, jg):
        _close(a, b, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("method,intra,chunk",
                         [m for m in METHODS if m[1] != "matmul"])
def test_gradients_across_a_reset_are_exactly_zero(method, intra, chunk):
    """Row 0 restarts at t = 11: nothing at or after it depends on the
    tokens before it, so their gradients are exactly 0. (Not blocked/matmul:
    its masked log-decay differences s_i − s_j cancel the pre-reset terms
    only in exact arithmetic — the JAX function leaks 2.9e-7 into dΔ at
    these inputs too.)"""
    u, delta, A, B, C, D, pos, h0, _ = _inputs(9)
    kw = dict(method=method, intra=intra)
    if chunk:
        kw["chunk"] = chunk
    leaves = [x.requires_grad_() for x in _t(u, delta, B, C)]
    y = tssm.selective_scan(leaves[0], leaves[1], torch.as_tensor(A),
                            leaves[2], leaves[3], torch.as_tensor(D),
                            positions=_t(pos)[0], h0=_t(h0)[0], **kw)
    du, ddelta, dB, dC = torch.autograd.grad(y[0, 11:].sum(), leaves)
    for g in (du, ddelta, dB, dC):
        assert torch.count_nonzero(g[0, :11]) == 0
        assert torch.count_nonzero(g[1]) == 0      # another row
    assert torch.count_nonzero(du[0, 11:]) > 0


@pytest.mark.parametrize("method,chunk", [("sequential", 256),
                                          ("associative", 256),
                                          ("chunked", 5), ("chunked", 64),
                                          ("blocked", 4), ("blocked", 32)])
def test_segmented_scan_matches_jax(method, chunk):
    rng = np.random.default_rng(chunk)
    a = rng.uniform(0.5, 1.0, size=(2, 13, 3, 2)).astype(np.float32)
    b = rng.normal(size=(2, 13, 3, 2)).astype(np.float32)
    reset = np.zeros((2, 13), bool)
    reset[0, 5] = reset[1, 0] = reset[1, 9] = True
    h0 = rng.normal(size=(2, 3, 2)).astype(np.float32)
    for r, h in ((reset, h0), (None, None)):
        jh, jl = jscan.segmented_scan(
            jnp.asarray(a), jnp.asarray(b), None if r is None else
            jnp.asarray(r), None if h is None else jnp.asarray(h),
            method=method, chunk=chunk)
        th, tl = tscan.segmented_scan(
            *_t(a, b), None if r is None else torch.as_tensor(r),
            None if h is None else torch.as_tensor(h), method=method,
            chunk=chunk)
        _close(th, jh)
        _close(tl, jl)
    with pytest.raises(ValueError):
        tscan.segmented_scan(*_t(a, b), method="tree")


@pytest.mark.parametrize("intra", ["assoc", "matmul"])
@pytest.mark.parametrize("ends", [False, True])
def test_blocked_checkpoint_leaves_gradients_bitwise(monkeypatch, intra,
                                                     ends):
    """``blocked`` recomputes each chunk in the backward under autograd;
    its y, h_last, h_ends and gradients are bitwise those of the same
    method with every chunk's intermediates kept (the checkpoint replaced
    by a plain call)."""
    u, delta, A, B, C, D, pos, h0, e = _inputs(7)
    kw = dict(method="blocked", intra=intra, chunk=8, return_state=True,
              collect_ends=_t(e)[0] if ends else None)
    got = []
    for keep in (False, True):
        if keep:
            monkeypatch.setattr(tssm, "checkpoint",
                                lambda f, *a, **k: f(*a))
        leaves = [x.requires_grad_() for x in _t(u, delta, A, B, C, D, h0)]
        out = tssm.selective_scan(*leaves[:6], positions=_t(pos)[0],
                                  h0=leaves[6], **kw)
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(out))
        got.append(list(out) + list(torch.autograd.grad(loss, leaves)))
    assert len(got[0]) == (3 if ends else 2) + 7
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_unknown_method_raises():
    u, delta, A, B, C, D, *_ = _inputs(1)
    with pytest.raises(ValueError):
        tssm.selective_scan(*_t(u, delta, A, B, C, D), method="scanned")
