"""Kernel #4's arithmetic on the CPU: ``selective_scan_fwd_step_lanes_plain``
with its ``chunk`` (#3's lanes over 64-step tiles, the checkpoint chunk
decoupled from the tile as #4 decouples it: at chunk 64 the tiles' entry
states, at any other chunk the state before each chunk's first step as its
lane holds it in the replay) against two references on the same numpy
inputs:

* the JAX package's ``selective_scan_fwd_pallas(..., schedule="blocked")``
  in interpret mode, the TPU #4 (L padded to whole chunks with identity
  steps and D to whole channel blocks with dead channels, as the JAX
  wrapper pads; the padding sliced off again);
* the port's per-step ``selective_scan_fwd_plain``.

Cases: chunk 1, 16, 48, 64, 128 and one longer than L; R = 8 and 16 steps a
lane; resets on a lane's first and last steps, on tile edges and on chunks'
first steps; a carried row (every row but the first starts at a position >
0); one segment over every chunk; a ragged L (997) and an L shorter than a
tile; D no multiple of 16; f32 and bf16 inputs. The inputs are
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
from tests.test_torch_scan_step_bwd import _lane_edges  # noqa: E402
from tests.test_torch_scan_step_bwd import _port_args  # noqa: E402
from tests.test_torch_scan_step_fwd import _close_y  # noqa: E402

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_D = 16

# (id, chunk, steps a lane, B, L, D, positions, dtype)
CASES = [
    ("chunk1", 1, 8, 2, 40, 16, "packed", "float32"),
    ("chunk16_edges_R8", 16, 8, 2, 192, 16, "edges", "float32"),
    ("chunk16_edges_R16", 16, 16, 2, 192, 16, "edges", "float32"),
    ("chunk48_edges_R8", 48, 8, 2, 240, 16, "edges", "float32"),
    ("chunk48_edges_R16", 48, 16, 2, 240, 16, "edges", "float32"),
    ("chunk64_edges_R8", 64, 8, 2, 192, 16, "edges", "float32"),
    ("chunk64_edges_R16", 64, 16, 2, 192, 16, "edges", "float32"),
    ("chunk128_edges_R8", 128, 8, 2, 384, 16, "edges", "float32"),
    ("chunk128_edges_R16", 128, 16, 2, 384, 16, "edges", "float32"),
    ("chunk_longer_than_L", 256, 8, 2, 100, 16, "packed", "float32"),
    ("one_segment_spans_every_chunk", 48, 8, 2, 256, 16, "one", "float32"),
    ("ragged_L_997_chunk48", 48, 8, 2, 997, 16, "packed", "float32"),
    ("ragged_L_997_chunk128", 128, 8, 2, 997, 16, "packed", "float32"),
    ("L_below_tile_chunk16", 16, 8, 2, 10, 16, "packed", "float32"),
    ("D_not_multiple_of_16_chunk48", 48, 8, 2, 128, 40, "edges", "float32"),
    ("bf16_chunk16", 16, 8, 2, 128, 16, "edges", "bfloat16"),
    ("bf16_chunk64", 64, 8, 2, 128, 16, "packed", "bfloat16"),
    ("bf16_R16_chunk128_ragged_L_and_D", 128, 16, 2, 300, 24, "edges",
     "bfloat16"),
]


def _case_inputs(Bz, L, D, kind, dtype, steps, chunk, seed):
    """``_inputs``' arrays; for ``edges``, row 0 resets on the first and
    last steps of a tile's first and last lanes, on tile edges and on the
    first steps of the first three chunks. Every other row is a carried row
    of a split pack (first position > 0)."""
    arrs, t, pos = _inputs(Bz, L, D, "packed" if kind == "edges" else kind,
                           dtype, steps, seed)
    if kind == "edges":
        cuts = {0, *_lane_edges(steps), chunk, 2 * chunk, 3 * chunk}
        cuts = sorted(c for c in cuts if c < L) + [L]
        for a, b in zip(cuts[:-1], cuts[1:]):
            pos[0, a:b] = np.arange(b - a)
    assert Bz < 2 or pos[1, 0] > 0
    return arrs, t, pos


def _jax_blocked_fwd(arrs, pos, dtype, chunk):
    """The TPU #4 in interpret mode, L padded to whole chunks (u, Δ, B, C =
    0, position 1: identity steps) and D to whole channel blocks (A = 0 and
    zeros: dead channels), in the case's dtype; then sliced back. Returns
    (y as f32, ckpts)."""
    Bz, L, D = arrs["u"].shape
    pl = -L % chunk
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
                                          block_d=BLOCK_D, chunk=chunk,
                                          schedule="blocked")
    return (np.asarray(y.astype(jnp.float32))[:, :L, :D],
            np.asarray(ck)[..., :D])


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = ksc.LAUNCHES_FWD
    yield
    assert ksc.LAUNCHES_FWD == before


@pytest.mark.parametrize("chunk,steps,Bz,L,D,kind,dtype",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_blocked_lanes_forward_matches_pallas_and_per_step(chunk, steps, Bz,
                                                           L, D, kind,
                                                           dtype):
    arrs, t, pos = _case_inputs(Bz, L, D, kind, dtype, steps, chunk,
                                seed=L + D + steps + chunk)
    args = _port_args(t, pos)
    y, ck = ksc.selective_scan_fwd_step_lanes_plain(
        *args, steps=steps, block_d=BLOCK_D, chunk=chunk)
    nC = -(-L // chunk)
    assert y.dtype == t["u"].dtype and tuple(y.shape) == (Bz, L, D)
    assert ck.dtype == torch.float32 and tuple(ck.shape) == (Bz, nC, N, D)
    wy, wck = ksc.selective_scan_fwd_plain(*args, chunk)
    jy, jck = _jax_blocked_fwd(arrs, pos, dtype, chunk)
    for name, want in (("JAX", jy), ("per-step", wy.float().numpy())):
        _close_y(y.float().numpy(), want, dtype, f"y vs {name}")
    for name, want in (("JAX", jck), ("per-step", wck.numpy())):
        np.testing.assert_allclose(ck.numpy(), want,
                                   err_msg=f"ckpts vs {name}", **FWD_TOL)


@pytest.mark.parametrize("chunk", [16, 48, 128])
def test_checkpoints_are_the_tiles_states_where_chunks_meet_tiles(chunk):
    """y does not depend on the chunk, bitwise; where a chunk starts on a
    tile edge its checkpoint is #3's (chunk 64) checkpoint of that tile,
    bitwise, whichever path wrote it (a tile's entry state or a lane's
    replay registers)."""
    L = 5 * TL + 7
    _, t, pos = _case_inputs(2, L, 24, "edges", "float32", 8, chunk, seed=3)
    args = _port_args(t, pos)
    y64, ck64 = ksc.selective_scan_fwd_step_lanes_plain(*args)
    y, ck = ksc.selective_scan_fwd_step_lanes_plain(*args, chunk=chunk)
    assert torch.equal(y, y64)
    for c in range(ck.shape[1]):
        if c * chunk % TL == 0:
            assert torch.equal(ck[:, c], ck64[:, c * chunk // TL]), c


def test_blocked_lanes_refuses_a_chunk_below_one():
    _, t, pos = _inputs(1, 64, 16, "packed", "float32", 8, seed=0)
    with pytest.raises(ValueError, match="chunk"):
        ksc.selective_scan_fwd_step_lanes_plain(*_port_args(t, pos), chunk=0)
