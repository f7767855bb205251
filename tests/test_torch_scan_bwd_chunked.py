"""Kernel #6's chunk-parallel arithmetic on the CPU:
``selective_scan_bwd_chunked_plain`` (a carry pass for each chunk's adjoint
with zero carry-in and its decay product, a fixed-order combine, then every
chunk from its checkpoint) against two references on the same numpy inputs:

* the JAX package's ``selective_scan_bwd_pallas(..., schedule="blocked")`` in
  interpret mode, fed the same checkpoints (L padded to whole chunks with
  identity steps and D to whole channel blocks with dead channels, as the
  JAX wrapper pads; the padding sliced off again);
* the port's per-step ``selective_scan_bwd_plain``.

Cases: chunk 16 and 64; one segment over every chunk (the carry crosses the
whole row); resets on a chunk's first and last steps; a ragged L and an L
shorter than the chunk; D no multiple of 32; f32 and bf16 inputs.

Tolerances are the reference's: 1e-4 abs / 1e-3 rel (sums over L and over
channels in another order); no gradient crosses a reset: exactly 0 (1e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import selective_scan as jsk  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402

BWD_TOL = dict(atol=1e-4, rtol=1e-3)
N = 16
NAMES = ("du", "ddelta", "dB partials", "dC partials", "dA", "dD")

# (id, chunk, B, L, D, positions, dtype)
CASES = [
    ("packed_chunk16", 16, 2, 64, 16, "packed", "float32"),
    ("packed_chunk64", 64, 2, 128, 16, "packed", "float32"),
    ("one_segment_spans_every_chunk", 16, 2, 80, 16, "one", "float32"),
    ("resets_on_chunk_first_and_last_steps", 16, 2, 64, 16, "edges",
     "float32"),
    ("ragged_L", 16, 2, 37, 16, "packed", "float32"),
    ("L_below_chunk", 64, 2, 10, 16, "packed", "float32"),
    ("D_not_multiple_of_32", 16, 2, 48, 40, "packed", "float32"),
    ("bf16", 16, 2, 64, 16, "packed", "bfloat16"),
    ("bf16_chunk64_ragged_L_and_D", 64, 2, 100, 40, "edges", "bfloat16"),
]


def _positions(kind, Bz, L, chunk, rng):
    """``packed``: row 0 packs sequences back to back (resets inside
    chunks); ``one``: row 0 one segment over the whole row; ``edges``:
    resets on the first and on the last step of chunks. Every other row is
    a carried row of a split pack (first position > 0, no reset)."""
    cuts = {"packed": [0, 5, 21], "one": [0],
            "edges": [0, chunk, 2 * chunk - 1, 3 * chunk]}[kind]
    cuts = sorted({c for c in cuts if c < L}) + [L]
    pos = np.zeros((Bz, L), np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    sp = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 2, L)], L)
    assert sp.positions[1, 0] > 0
    pos[1:] = sp.positions[1]
    return pos


def _inputs(chunk, Bz, L, D, kind, dtype, seed):
    """numpy f32 inputs (rounded to bf16 first for a bf16 case, so both
    sides see the same values) and the torch tensors of the case's dtype."""
    rng = np.random.default_rng(seed)
    arrs = dict(u=rng.normal(size=(Bz, L, D)),
                dt=rng.uniform(0.05, 0.5, (Bz, L, D)),
                A=-np.exp(rng.normal(size=(D, N))),
                Bm=rng.normal(size=(Bz, L, N)), Cm=rng.normal(size=(Bz, L, N)),
                Dk=rng.normal(size=(D,)), dy=rng.normal(size=(Bz, L, D)))
    tdt = getattr(torch, dtype)
    t = {}
    for k, v in arrs.items():
        x = torch.as_tensor(v.astype(np.float32))
        if k in ("u", "dt", "Bm", "Cm", "dy"):
            x = x.to(tdt)
        t[k] = x
        arrs[k] = x.float().numpy()
    pos = _positions(kind, Bz, L, chunk, rng)
    return arrs, t, pos


def _port_args(t, pos):
    return (t["u"], t["dt"], t["A"].t().contiguous(), t["Bm"], t["Cm"],
            t["Dk"], torch.as_tensor(pos))


def _jax_bwd(arrs, pos, ckpts, chunk, block_d):
    """The TPU kernel's backward in interpret mode on ``ckpts``, L padded to
    whole chunks (u, Δ, dy, B, C = 0, position 1: identity steps) and D to
    whole channel blocks (A = 0 and zeros: dead channels, state 0), then
    sliced back."""
    Bz, L, D = arrs["u"].shape
    pl = -L % chunk
    pd = -D % block_d

    def pad(x, lp=0, dp=0, v=0):
        w = [(0, 0)] * x.ndim
        if lp:
            w[1] = (0, lp)
        if dp:
            w[-1] = (0, dp)
        return np.pad(x, w, constant_values=v)

    u, dt, dy = (pad(arrs[k], pl, pd) for k in ("u", "dt", "dy"))
    Bm, Cm = (pad(arrs[k], pl) for k in ("Bm", "Cm"))
    At = pad(arrs["A"].T, dp=pd)
    Dk = pad(arrs["Dk"][None], dp=pd)
    p = pad(pos, pl, v=1)
    j = [jnp.asarray(a) for a in (u, dt, At, Bm, Cm, Dk, p)]
    ck = jnp.asarray(pad(ckpts, dp=pd))
    out = [np.asarray(a) for a in jsk.selective_scan_bwd_pallas(
        *j, ck, jnp.asarray(dy), block_d=block_d, chunk=chunk,
        schedule="blocked")]
    return [out[0][:, :L, :D], out[1][:, :L, :D], out[2][:, :, :L],
            out[3][:, :, :L], out[4][:, :, :D], out[5][:, 0, :D]]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = ksc.LAUNCHES_BWD
    yield
    assert ksc.LAUNCHES_BWD == before


@pytest.mark.parametrize("chunk,Bz,L,D,kind,dtype",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_chunked_backward_matches_pallas_and_per_step(chunk, Bz, L, D, kind,
                                                      dtype):
    arrs, t, pos = _inputs(chunk, Bz, L, D, kind, dtype, seed=L + D + chunk)
    args = _port_args(t, pos)
    _, ck = ksc.selective_scan_fwd_plain(*args, chunk)
    got = ksc.selective_scan_bwd_chunked_plain(*args, ck, t["dy"], chunk)
    step = ksc.selective_scan_bwd_plain(*args, ck, t["dy"], chunk)
    want = _jax_bwd(arrs, pos, ck.numpy(), chunk, ksc.BLOCK_D)
    nblk = -(-D // ksc.BLOCK_D)
    shapes = [(Bz, L, D), (Bz, L, D), (Bz, nblk, L, N), (Bz, nblk, L, N),
              (Bz, N, D), (Bz, D)]
    for name, g, s, w, shape in zip(NAMES, got, step, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"{name} vs JAX",
                                   **BWD_TOL)
        np.testing.assert_allclose(g.numpy(), s.numpy(),
                                   err_msg=f"{name} vs per-step", **BWD_TOL)


@pytest.mark.parametrize("chunk,at", [(16, "first"), (16, "last"),
                                      (64, "first")])
def test_no_gradient_crosses_a_reset_between_chunks(chunk, at):
    """One segment over several chunks, then a reset on a chunk's first
    step (its P_c is exactly 0) or last step; the loss on the second
    segment only. Every per-step gradient of the first segment is 0."""
    L = 4 * chunk
    boundary = 2 * chunk if at == "first" else 2 * chunk - 1
    _, t, _ = _inputs(chunk, 1, L, 24, "one", "float32", seed=chunk)
    pos = np.concatenate([np.arange(boundary),
                          np.arange(L - boundary)])[None].astype(np.int32)
    dy = t["dy"].clone()
    dy[:, :boundary] = 0.0
    args = _port_args(t, pos)
    _, ck = ksc.selective_scan_fwd_plain(*args, chunk)
    got = ksc.selective_scan_bwd_chunked_plain(*args, ck, dy, chunk)
    for name, g in zip(NAMES[:4], got[:4]):
        first = g[:, :boundary] if g.dim() == 3 else g[:, :, :boundary]
        rest = g[:, boundary:] if g.dim() == 3 else g[:, :, boundary:]
        np.testing.assert_allclose(first.numpy(), 0.0, atol=1e-7,
                                   err_msg=name)
        assert float(rest.abs().max()) > 0, name
    want = ksc.selective_scan_bwd_plain(*args, ck, dy, chunk)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **BWD_TOL)
