"""Kernel #3's lane arithmetic on the CPU:
``selective_scan_fwd_step_lanes_plain`` (each 64-step tile of a channel split
over lanes of R consecutive steps: per-lane folds, a log-depth combine over
the lanes with zero carry-in, the tile's entry state applied after it, the
replay, and y's sum over the states in the kernel's order) against two
references on the same numpy inputs:

* the JAX package's ``selective_scan_fwd_pallas(..., schedule="step")`` in
  interpret mode (L padded to whole chunks with identity steps and D to
  whole channel blocks with dead channels, as the JAX wrapper pads; the
  padding sliced off again);
* the port's per-step ``selective_scan_fwd_plain``.

Cases: R = 4, 8 and 16 steps a lane (16, 8 and 4 lanes); resets on a lane's
first and last steps, in lane 0 and in the last lane, and on a tile edge;
one segment over every tile; a ragged L (997) and an L shorter than a tile;
D no multiple of 16; f32 and bf16 inputs. The inputs and positions are
``tests/test_torch_scan_step_bwd.py``'s.

Tolerances: f32 1e-5 abs and 1e-5 rel, the reference's kernel-forward
tolerance (the lanes reorder the products). bf16: the checkpoints are f32 on
both sides (1e-5); y is rounded to bf16 by each side once, so within two
bf16 roundings, 2^-7 · |ref| + 1e-4 · max|ref|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import selective_scan as jsk  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from tests.test_torch_scan_step_bwd import N, TL, _inputs  # noqa: E402
from tests.test_torch_scan_step_bwd import _port_args  # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_D = 16

# (id, steps a lane, B, L, D, positions, dtype)
CASES = [
    ("packed_R8", 8, 2, 128, 16, "packed", "float32"),
    ("packed_R4", 4, 2, 128, 16, "packed", "float32"),
    ("packed_R16", 16, 2, 128, 16, "packed", "float32"),
    ("resets_on_lane_edges_R4", 4, 2, 192, 16, "lanes", "float32"),
    ("resets_on_lane_edges_R8", 8, 2, 192, 16, "lanes", "float32"),
    ("resets_on_lane_edges_R16", 16, 2, 192, 16, "lanes", "float32"),
    ("one_segment_spans_every_tile", 8, 2, 256, 16, "one", "float32"),
    ("ragged_L_997", 8, 2, 997, 16, "packed", "float32"),
    ("L_below_tile", 8, 2, 10, 16, "packed", "float32"),
    ("D_not_multiple_of_16", 8, 2, 128, 40, "packed", "float32"),
    ("bf16", 8, 2, 128, 16, "packed", "bfloat16"),
    ("bf16_R4_ragged_L_and_D", 4, 2, 100, 24, "lanes", "bfloat16"),
    ("bf16_R16_lanes", 16, 2, 192, 16, "lanes", "bfloat16"),
]


def _jax_step_fwd(arrs, pos, dtype):
    """The TPU #3 in interpret mode, L padded to whole chunks (u, Δ, B, C =
    0, position 1: identity steps) and D to whole channel blocks (A = 0 and
    zeros: dead channels), in the case's dtype; then sliced back. Returns
    (y as f32, ckpts)."""
    Bz, L, D = arrs["u"].shape
    pl = -L % TL
    pd = -D % BLOCK_D

    def pad(x, lp=0, dp=0, v=0):
        w = [(0, 0)] * x.ndim
        if lp:
            w[1] = (0, lp)
        if dp:
            w[-1] = (0, dp)
        return np.pad(x, w, constant_values=v)

    jdt = getattr(jnp, dtype)
    u, dt = (jnp.asarray(pad(arrs[k], pl, pd), jdt) for k in ("u", "dt"))
    Bm, Cm = (jnp.asarray(pad(arrs[k], pl), jdt) for k in ("Bm", "Cm"))
    At = jnp.asarray(pad(arrs["A"].T, dp=pd))
    Dk = jnp.asarray(pad(arrs["Dk"][None], dp=pd))
    p = jnp.asarray(pad(pos, pl, v=1))
    y, ck = jsk.selective_scan_fwd_pallas(u, dt, At, Bm, Cm, Dk, p,
                                          block_d=BLOCK_D, chunk=TL,
                                          schedule="step")
    return (np.asarray(y.astype(jnp.float32))[:, :L, :D],
            np.asarray(ck)[..., :D])


def _close_y(got, want, dtype, err_msg):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **FWD_TOL)
    else:       # each side rounds its f32 y to bf16 once
        bound = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
        err = np.abs(got - want)
        assert (err <= bound).all(), (err_msg, float((err - bound).max()))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = ksc.LAUNCHES_FWD_STEP
    yield
    assert ksc.LAUNCHES_FWD_STEP == before


@pytest.mark.parametrize("steps,Bz,L,D,kind,dtype", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_step_lanes_forward_matches_pallas_and_per_step(steps, Bz, L, D,
                                                        kind, dtype):
    arrs, t, pos = _inputs(Bz, L, D, kind, dtype, steps, seed=L + D + steps)
    args = _port_args(t, pos)
    y, ck = ksc.selective_scan_fwd_step_lanes_plain(*args, steps=steps,
                                                    block_d=BLOCK_D)
    nC = -(-L // TL)
    assert y.dtype == t["u"].dtype and tuple(y.shape) == (Bz, L, D)
    assert ck.dtype == torch.float32 and tuple(ck.shape) == (Bz, nC, N, D)
    wy, wck = ksc.selective_scan_fwd_plain(*args, TL)
    jy, jck = _jax_step_fwd(arrs, pos, dtype)
    for name, want in (("JAX", jy), ("per-step", wy.float().numpy())):
        _close_y(y.float().numpy(), want, dtype, f"y vs {name}")
    for name, want in (("JAX", jck), ("per-step", wck.numpy())):
        np.testing.assert_allclose(ck.numpy(), want,
                                   err_msg=f"ckpts vs {name}", **FWD_TOL)


@pytest.mark.parametrize("steps", [4, 8, 16])
@pytest.mark.parametrize("at", ["lane_first", "lane_last", "tile_edge"])
def test_no_state_crosses_a_reset_on_a_lane_edge(steps, at):
    """One segment over a tile and a half, then a reset on the first or
    last step of a lane inside the second tile or on a tile edge. Zeroing
    every input of the first segment changes nothing from the reset on: the
    carry applied after the lanes' combine stops at the reset, across lanes
    and tiles."""
    L = 3 * TL
    boundary = {"lane_first": TL + 3 * steps, "lane_last": TL + 3 * steps - 1,
                "tile_edge": 2 * TL}[at]
    _, t, _ = _inputs(1, L, 24, "one", "float32", steps, seed=steps)
    pos = np.concatenate([np.arange(boundary),
                          np.arange(L - boundary)])[None].astype(np.int32)
    args = _port_args(t, pos)
    y, _ = ksc.selective_scan_fwd_step_lanes_plain(*args, steps=steps)
    cut = dict(t)
    for k in ("u", "dt", "Bm", "Cm"):
        cut[k] = t[k].clone()
        cut[k][:, :boundary] = 0.0
    y0, _ = ksc.selective_scan_fwd_step_lanes_plain(*_port_args(cut, pos),
                                                    steps=steps)
    assert torch.equal(y[:, boundary:], y0[:, boundary:])
    assert float((y[:, :boundary] - y0[:, :boundary]).abs().max()) > 0
    want, _ = ksc.selective_scan_fwd_plain(*args, TL)
    np.testing.assert_allclose(y.numpy(), want.numpy(), **FWD_TOL)


def test_step_lanes_refuses_a_lane_count_that_is_no_power_of_two():
    """A tile of 64 steps splits over a power of two of lanes; 3 steps a
    lane do not divide it, 32 leave 2 lanes (allowed), 64 one."""
    _, t, pos = _inputs(1, 64, 16, "packed", "float32", 8, seed=0)
    args = _port_args(t, pos)
    with pytest.raises(ValueError, match="steps"):
        ksc.selective_scan_fwd_step_lanes_plain(*args, steps=3)
    for steps in (32, 64):
        y, _ = ksc.selective_scan_fwd_step_lanes_plain(*args, steps=steps)
        want, _ = ksc.selective_scan_fwd_plain(*args, TL)
        np.testing.assert_allclose(y.numpy(), want.numpy(), **FWD_TOL)
