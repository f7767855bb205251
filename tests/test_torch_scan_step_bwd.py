"""Kernel #5's lane arithmetic on the CPU:
``selective_scan_bwd_step_lanes_plain`` (each 64-step tile of a channel split
over lanes of R consecutive steps: per-lane folds, a log-depth combine over
the lanes with the tile's checkpoint in lane 0 and the later tile's carry in
the last lane, the replays, the channel sums in the kernel's order) against
two references on the same numpy inputs:

* the JAX package's ``selective_scan_bwd_pallas(..., schedule="step")`` in
  interpret mode, fed the same checkpoints (L padded to whole chunks with
  identity steps and D to whole channel blocks with dead channels, as the
  JAX wrapper pads; the padding sliced off again);
* the port's per-step ``selective_scan_bwd_plain``.

Cases: R = 4 and 8 steps a lane (16 and 8 lanes); resets on a lane's first
and last steps, in lane 0 and in the last lane, and on a tile edge; one
segment over every tile; a ragged L (997) and an L shorter than a tile; D no
multiple of 16; f32 and bf16 inputs.

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
N, TL = 16, 64
NAMES = ("du", "ddelta", "dB partials", "dC partials", "dA", "dD")

# (id, steps a lane, B, L, D, positions, dtype)
CASES = [
    ("packed_R8", 8, 2, 128, 16, "packed", "float32"),
    ("packed_R4", 4, 2, 128, 16, "packed", "float32"),
    ("resets_on_lane_edges_R8", 8, 2, 192, 16, "lanes", "float32"),
    ("resets_on_lane_edges_R4", 4, 2, 192, 16, "lanes", "float32"),
    ("one_segment_spans_every_tile", 8, 2, 256, 16, "one", "float32"),
    ("ragged_L_997", 8, 2, 997, 16, "packed", "float32"),
    ("L_below_tile", 8, 2, 10, 16, "packed", "float32"),
    ("D_not_multiple_of_16", 8, 2, 128, 40, "packed", "float32"),
    ("bf16", 8, 2, 128, 16, "packed", "bfloat16"),
    ("bf16_R4_ragged_L_and_D", 4, 2, 100, 24, "lanes", "bfloat16"),
]


def _lane_edges(steps):
    """Resets on the first and last steps of lane 0 and of the last lane
    of a tile, and on tile edges."""
    return [steps - 1, TL - steps, TL - 1, TL, TL + steps - 1, 2 * TL - steps,
            2 * TL]


def _positions(kind, Bz, L, steps, rng):
    """``packed``: row 0 packs sequences back to back (resets inside
    lanes); ``one``: row 0 one segment over the whole row; ``lanes``:
    resets on lane and tile edges. Every other row is a carried row of a
    split pack (first position > 0, no reset)."""
    cuts = {"packed": [0, 5, 21, 77], "one": [0],
            "lanes": [0] + _lane_edges(steps)}[kind]
    cuts = sorted({c for c in cuts if c < L}) + [L]
    pos = np.zeros((Bz, L), np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    sp = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 2, L)], L)
    assert sp.positions[1, 0] > 0
    pos[1:] = sp.positions[1]
    return pos


def _inputs(Bz, L, D, kind, dtype, steps, seed):
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
    return arrs, t, _positions(kind, Bz, L, steps, rng)


def _port_args(t, pos):
    return (t["u"], t["dt"], t["A"].t().contiguous(), t["Bm"], t["Cm"],
            t["Dk"], torch.as_tensor(pos))


def _jax_step_bwd(arrs, pos, ckpts, block_d):
    """The TPU #5 in interpret mode on ``ckpts``, L padded to whole chunks
    (u, Δ, dy, B, C = 0, position 1: identity steps) and D to whole channel
    blocks (A = 0 and zeros: dead channels, state 0), then sliced back."""
    Bz, L, D = arrs["u"].shape
    pl = -L % TL
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
        *j, ck, jnp.asarray(dy), block_d=block_d, chunk=TL,
        schedule="step")]
    return [out[0][:, :L, :D], out[1][:, :L, :D], out[2][:, :, :L],
            out[3][:, :, :L], out[4][:, :, :D], out[5][:, 0, :D]]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = ksc.LAUNCHES_BWD_STEP
    yield
    assert ksc.LAUNCHES_BWD_STEP == before


@pytest.mark.parametrize("steps,Bz,L,D,kind,dtype", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_step_lanes_backward_matches_pallas_and_per_step(steps, Bz, L, D,
                                                         kind, dtype):
    arrs, t, pos = _inputs(Bz, L, D, kind, dtype, steps, seed=L + D + steps)
    args = _port_args(t, pos)
    _, ck = ksc.selective_scan_fwd_plain(*args, TL)
    got = ksc.selective_scan_bwd_step_lanes_plain(
        *args, ck, t["dy"], lanes=TL // steps, steps=steps)
    step = ksc.selective_scan_bwd_plain(*args, ck, t["dy"], TL,
                                        ksc.STEP_BLOCK_D)
    want = _jax_step_bwd(arrs, pos, ck.numpy(), ksc.STEP_BLOCK_D)
    nblk = -(-D // ksc.STEP_BLOCK_D)
    shapes = [(Bz, L, D), (Bz, L, D), (Bz, nblk, L, N), (Bz, nblk, L, N),
              (Bz, N, D), (Bz, D)]
    for name, g, s, w, shape in zip(NAMES, got, step, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"{name} vs JAX",
                                   **BWD_TOL)
        np.testing.assert_allclose(g.numpy(), s.numpy(),
                                   err_msg=f"{name} vs per-step", **BWD_TOL)


@pytest.mark.parametrize("steps", [4, 8])
@pytest.mark.parametrize("at", ["lane_first", "lane_last", "tile_edge"])
def test_no_gradient_crosses_a_reset_on_a_lane_edge(steps, at):
    """One segment over a tile and a half, then a reset on the first or
    last step of a lane inside the second tile or on a tile edge; the loss
    on the second segment only. Every per-step gradient of the first
    segment is 0: the adjoint carry stops at the reset across lanes and
    tiles."""
    L = 3 * TL
    boundary = {"lane_first": TL + 3 * steps, "lane_last": TL + 3 * steps - 1,
                "tile_edge": 2 * TL}[at]
    _, t, _ = _inputs(1, L, 24, "one", "float32", steps, seed=steps)
    pos = np.concatenate([np.arange(boundary),
                          np.arange(L - boundary)])[None].astype(np.int32)
    dy = t["dy"].clone()
    dy[:, :boundary] = 0.0
    args = _port_args(t, pos)
    _, ck = ksc.selective_scan_fwd_plain(*args, TL)
    got = ksc.selective_scan_bwd_step_lanes_plain(
        *args, ck, dy, lanes=TL // steps, steps=steps)
    for name, g in zip(NAMES[:4], got[:4]):
        first = g[:, :boundary] if g.dim() == 3 else g[:, :, :boundary]
        rest = g[:, boundary:] if g.dim() == 3 else g[:, :, boundary:]
        np.testing.assert_allclose(first.numpy(), 0.0, atol=1e-7,
                                   err_msg=name)
        assert float(rest.abs().max()) > 0, name
    want = ksc.selective_scan_bwd_plain(*args, ck, dy, TL, ksc.STEP_BLOCK_D)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **BWD_TOL)


def test_step_lanes_refuses_a_width_its_warps_do_not_divide():
    """32 / lanes channels share a warp's channel sums; a block of
    channels that is no multiple of them is refused."""
    _, t, pos = _inputs(1, 64, 16, "packed", "float32", 8, seed=0)
    args = _port_args(t, pos)
    _, ck = ksc.selective_scan_fwd_plain(*args, TL)
    with pytest.raises(ValueError, match="block_d"):
        ksc.selective_scan_bwd_step_lanes_plain(*args, ck, t["dy"], lanes=8,
                                                steps=8, block_d=6)
