"""Port parity of the conv1d_pack backward: kernel #2's plain version (the
CUDA kernel's function on the CPU) against the JAX package's
``conv1d_pack_bwd_dx_pallas`` (interpret mode), and the port's autograd
wiring against ``jax.grad`` of ``conv1d_pack(..., backend="pallas")`` for
dx, dweight and dbias — packed resets, a carried row and an L that is no
multiple of any tile included.

Tolerance 1e-5 (abs and rel) in f32: the same taps summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import conv1d_pack as jck  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _positions(Bz, L, seed):
    """Row 0 packs several sequences; row 1 is a carried row of a split
    pack (its first position > 0) whose last sequence runs off the end."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((Bz, L), np.int32)
    lens = [3, L // 3, L]
    t = 0
    for n in lens:
        n = min(n, L - t)
        pos[0, t:t + n] = np.arange(n)
        t += n
        if t == L:
            break
    if Bz > 1:
        sp = tpk.pack_with_split(
            [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L)
        assert sp.carry_mask[1] and sp.positions[1, 0] > 0
        pos[1] = sp.positions[1]
    return pos


def _inputs(Bz, L, Dm, W, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    w = rng.normal(size=(W, Dm)).astype(np.float32)
    b = rng.normal(size=(Dm,)).astype(np.float32)
    dy = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    return x, w, b, dy, _positions(Bz, L, seed)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = (kconv.LAUNCHES, kconv.LAUNCHES_DX)
    yield
    assert (kconv.LAUNCHES, kconv.LAUNCHES_DX) == before


@pytest.mark.parametrize("Bz,L,Dm,W", [(2, 32, 16, 4), (2, 37, 12, 4),
                                       (1, 16, 8, 3)])
def test_dx_plain_matches_pallas_kernel(Bz, L, Dm, W):
    x, w, b, dy, pos = _inputs(Bz, L, Dm, W, L + Dm)
    T = 16 if L % 16 == 0 else L      # the Pallas kernel needs L % T == 0
    want = jck.conv1d_pack_bwd_dx_pallas(jnp.asarray(dy), jnp.asarray(w),
                                         jnp.asarray(pos), block_d=Dm if
                                         Dm % 8 else 8, chunk=T)
    got = kconv.conv1d_pack_bwd_dx(torch.as_tensor(dy), torch.as_tensor(w),
                                   torch.as_tensor(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Bz,L,Dm,W", [(2, 32, 16, 4), (2, 37, 12, 4)])
def test_conv_autograd_matches_jax_grad(Bz, L, Dm, W):
    x, w, b, dy, pos = _inputs(Bz, L, Dm, W, 3 * L)

    def jloss(x, w, b):
        y = jops.conv1d_pack(x, w, b, jnp.asarray(pos), backend="pallas",
                             block_d=8, chunk=16)
        return (y * jnp.asarray(dy)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    args = [torch.as_tensor(a).requires_grad_() for a in (x, w, b)]
    y = tops.conv1d_pack(*args, torch.as_tensor(pos))
    got = torch.autograd.grad(y, args, torch.as_tensor(dy))
    for name, g, j in zip(("dx", "dweight", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)


def test_dx_stops_at_the_buffer_end_not_at_the_mask():
    """A row whose positions never reset up to its end: dy past L must not
    be read, whatever the positions say."""
    L, Dm = 9, 4
    rng = np.random.default_rng(5)
    dy = torch.as_tensor(rng.normal(size=(1, L, Dm)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(4, Dm)).astype(np.float32))
    pos = torch.arange(100, 100 + L, dtype=torch.int32)[None]
    dx = kconv.conv1d_pack_bwd_dx(dy, w, pos)
    want = sum(w[3 - k] * torch.cat([dy[:, k:], torch.zeros(1, k, Dm)], 1)
               for k in range(4))
    np.testing.assert_allclose(dx.numpy(), want.numpy(), **TOL)


def test_bf16_conv_grads_keep_dtypes():
    x, w, b, dy, pos = _inputs(2, 24, 8, 4, 1)
    args = [torch.as_tensor(a).to(torch.bfloat16).requires_grad_()
            for a in (x, w, b)]
    y = tops.conv1d_pack(*args, torch.as_tensor(pos))
    got = torch.autograd.grad(y, args, torch.as_tensor(dy).to(torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    dx32 = kconv.conv1d_pack_bwd_dx(torch.as_tensor(dy).to(torch.bfloat16),
                                    args[1].detach(), torch.as_tensor(pos))
    assert torch.equal(got[0], dx32.to(torch.bfloat16))

