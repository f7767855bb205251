"""Port parity: the conv1d_pack forward (plain version on the CPU, CUDA
kernel on the card) against the JAX package's Pallas kernel (interpret
mode), its XLA path and its oracle.

Tolerances: f32 1e-5 (the same taps summed in another order). bf16: each
output within one bf16 rounding (2⁻⁸ relative) of the f32-accumulated
result on the same bf16 inputs — both packages accumulate in f32 and
round once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import conv1d_pack_ref as jref  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import conv1d_pack_ref as tref  # noqa: E402

CONV_SHAPES = [(1, 8, 4, 2), (2, 24, 10, 4), (1, 64, 16, 4), (3, 17, 5, 3)]
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(Bz, L, Dm, W, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(Bz, L, Dm)).astype(np.float32)
    w = rng.normal(size=(W, Dm)).astype(np.float32)
    b = rng.normal(size=(Dm,)).astype(np.float32)
    pos = np.tile(np.concatenate([np.arange(L // 2), np.arange(L - L // 2)]),
                  (Bz, 1)).astype(np.int32)
    return x, w, b, pos


def _np(a):
    if torch.is_tensor(a):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


def _check(got, want32, dtype):
    got, want32 = _np(got), _np(want32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, atol=1e-5, rtol=0)
    else:
        err = np.abs(got - want32)
        assert (err <= 2.0 ** -8 * np.abs(want32) + 1e-6).all(), err.max()


def _both(x, w, b, pos, dtype):
    """(port output, JAX Pallas output, f32-accumulated result) on the same
    inputs rounded to ``dtype``."""
    tdt, jdt = DT[dtype]
    xt, wt, bt = (torch.as_tensor(a).to(tdt) for a in (x, w, b))
    pt = torch.as_tensor(pos)
    y_port = tops.conv1d_pack(xt, wt, bt, pt)
    y_jax = jops.conv1d_pack(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(b, jdt), jnp.asarray(pos),
                             backend="pallas", block_d=8, chunk=8)
    want = kconv.conv1d_pack_plain(xt.float(), wt.float(), bt.float(), pt)
    return y_port, y_jax, want


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """A CPU call never launches the kernel."""
    before = kconv.LAUNCHES
    yield
    assert kconv.LAUNCHES == before


@pytest.mark.parametrize("Bz,L,Dm,W", CONV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_matches_pallas_and_xla(Bz, L, Dm, W, dtype):
    x, w, b, pos = _inputs(Bz, L, Dm, W, Bz * 31 + L)
    y_port, y_jax, want = _both(x, w, b, pos, dtype)
    assert y_port.dtype == DT[dtype][0] and y_port.shape == (Bz, L, Dm)
    _check(y_port, want, dtype)
    _check(y_jax, want, dtype)
    if dtype == "float32":
        _check(y_port, jref(x, w, b, pos), dtype)
        _check(y_port, jconv.conv1d_pack(x, w, b, pos), dtype)
        _check(tconv.conv1d_pack(*(torch.as_tensor(a)
                                   for a in (x, w, b, pos))), want, dtype)
        _check(tref(*(torch.as_tensor(a) for a in (x, w, b, pos))), want,
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_carry_rows_from_split_packing(dtype):
    """Rows of a split pack start mid-sequence (positions > 0): the taps
    that would reach before the row must still be dropped."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(1, 50, size=n) for n in (13, 29, 7, 22)]
    pb = tpk.pack_with_split(seqs, 16)
    assert pb.carry_mask.any() and (pb.positions[:, 0] > 0).any()
    Bz, L = pb.positions.shape
    x = rng.normal(size=(Bz, L, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    y_port, y_jax, want = _both(x, w, b, pb.positions, dtype)
    _check(y_port, want, dtype)
    _check(y_jax, want, dtype)
    if dtype == "float32":
        _check(want, jref(x, w, b, pb.positions), dtype)


def test_conv_strided_input_and_defaults():
    """The x half of in_proj's output is a strided view; positions=None is
    one segment per row; bias=None is zero."""
    rng = np.random.default_rng(12)
    xz = torch.as_tensor(rng.normal(size=(2, 24, 20)).astype(np.float32))
    x_in, _ = xz.chunk(2, dim=-1)
    assert not x_in.is_contiguous()
    w = torch.as_tensor(rng.normal(size=(4, 10)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(10,)).astype(np.float32))
    pos = torch.as_tensor(np.tile(np.arange(24), (2, 1)).astype(np.int32))
    want = tops.conv1d_pack(x_in.contiguous(), w, b, pos)
    _check(tops.conv1d_pack(x_in, w, b, pos), want, "float32")
    _check(tops.conv1d_pack(x_in, w, b), want, "float32")
    _check(tops.conv1d_pack(x_in, w, None, pos) + b, want, "float32")


def test_conv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 8)
    w, b = torch.zeros(4, 8), torch.zeros(8)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kconv.conv1d_pack(x, w.double(), b, pos)
    with pytest.raises(TypeError):
        kconv.conv1d_pack(x.half(), w.half(), b.half(), pos)
    with pytest.raises(ValueError):
        kconv.conv1d_pack(x, torch.zeros(5, 8), b, pos)
    with pytest.raises(ValueError):
        kconv.conv1d_pack(x, w, b, pos.long())


def test_conv1d_pack_update_matches_jax():
    rng = np.random.default_rng(13)
    x_t = rng.normal(size=(3, 6)).astype(np.float32)
    st = rng.normal(size=(3, 3, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    reset = np.array([False, True, False])
    for r in (None, reset):
        jy, js = jconv.conv1d_pack_update(
            x_t, st, w, b, None if r is None else jnp.asarray(r))
        ty, ts = tconv.conv1d_pack_update(
            *(torch.as_tensor(a) for a in (x_t, st, w, b)),
            None if r is None else torch.as_tensor(r))
        _check(ty, jy, "float32")
        _check(ts, js, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    tdt = DT[dtype][0]
    x, w, b, pos = _inputs(2, 256, 4096, 4, 7)
    rng = np.random.default_rng(14)
    pos[1] = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (300, 200)], 256).positions[1]
    dev = torch.device("cuda")
    xz = torch.as_tensor(np.concatenate([x, x], -1)).to(dev, tdt)
    x_in = xz.chunk(2, dim=-1)[0]
    wt, bt = (torch.as_tensor(a).to(dev, tdt) for a in (w, b))
    pt = torch.as_tensor(pos).to(dev)
    n0 = kconv.LAUNCHES
    y = kconv.conv1d_pack(x_in, wt, bt, pt)
    torch.cuda.synchronize()
    assert kconv.LAUNCHES == n0 + 1
    want = kconv.conv1d_pack_plain(x_in.float(), wt.float(), bt.float(), pt)
    _check(y, want, dtype)
    kconv.LAUNCHES = n0
