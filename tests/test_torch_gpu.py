"""The port's CUDA kernels on the card, each against its plain version on the
same inputs, and their gradients bitwise equal across two runs. Every test
is ``gpu``-marked and skips on a machine without an NVIDIA card; the file
imports no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 outputs 1e-4 abs + rel (the plain versions sum in another
order; the kernels use ``__expf``); bf16 outputs (y) within 2^-7 relative
plus 1e-2 abs (two bf16 roundings of values up to ~10); backward outputs
are f32 whatever the input dtype, 1e-3 abs + rel (sums over L). The two
Mamba-1 schedules against each other: checkpoints 1e-4 · (1 + |ref|), y
within two bf16 roundings, backward outputs 1e-3 abs + rel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from repro_torch.kernels import selective_scan_heads as kh  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _positions(Bz, L, seed):
    """Row 0 packed with resets (some inside a tile); row 1 a carried row
    of a split pack (first position > 0)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((Bz, L), np.int32)
    t = 0
    while t < L:
        n = int(min(rng.integers(3, L // 3), L - t))
        pos[0, t:t + n] = np.arange(n)
        t += n
    pos[1] = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L).positions[1]
    assert pos[1, 0] > 0
    return pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_dx_kernel_matches_plain_and_repeats(cuda, dtype):
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    L, D = 1000 - 3, 4096
    dy = torch.as_tensor(rng.normal(size=(2, L, D))).to(cuda, tdt)
    w = torch.as_tensor(rng.normal(size=(4, D))).to(cuda, tdt)
    pos = torch.as_tensor(_positions(2, L, 1)).to(cuda)
    n0 = kconv.LAUNCHES_DX
    dx, again = (kconv.conv1d_pack_bwd_dx(dy, w, pos) for _ in range(2))
    torch.cuda.synchronize()
    assert kconv.LAUNCHES_DX == n0 + 2
    torch.testing.assert_close(dx, kconv.conv1d_pack_bwd_dx_plain(dy, w, pos),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(dx, again)


def _run_edge_positions(Bz, L, seed):
    """Row 0: a reset near every 16th row, on it or 1 before, 1 or 2 after
    (on a run's first row and within W-1 rows of a run edge for runs 1, 4
    and 16); the other rows: carried rows of a split pack (first position
    > 0), or constant 7 where L = 1."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((Bz, L), np.int32)
    starts = sorted({0} | {e + (0, 1, -1, 2)[(e // 16) % 4]
                           for e in range(16, L, 16) if e + 2 < L})
    for a, b in zip(starts, starts[1:] + [L]):
        pos[0, a:b] = np.arange(b - a)
    pos[1:] = 7 if L == 1 else tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L).positions[1]
    return pos


def _conv_case(cuda, tdt, Bz, L, D, W, one_wide, seed):
    """x, w, b, dy, pos on the card. The 16-byte path: x the strided half
    of an xz buffer, dy contiguous. The one-element path: x and dy one
    element past an aligned start."""
    rng = np.random.default_rng(seed)
    f = dict(device=cuda, dtype=tdt)
    w = torch.as_tensor(rng.normal(size=(W, D))).to(**f)
    b = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    if one_wide:
        x = torch.as_tensor(rng.normal(size=(Bz, L, D + 1))).to(**f)[..., 1:]
        dy = torch.as_tensor(rng.normal(size=Bz * L * D + 1)).to(**f)[1:]
        dy = dy.view(Bz, L, D)
    else:
        x = torch.as_tensor(rng.normal(size=(Bz, L, 2 * D))).to(**f)
        x = x.chunk(2, dim=-1)[0]
        dy = torch.as_tensor(rng.normal(size=(Bz, L, D))).to(**f)
    pos = torch.as_tensor(_run_edge_positions(Bz, L, seed)).to(cuda)
    assert kconv.vector_path(x, w, b, strides=x.stride()[:2], D=D) == \
        (not one_wide)
    assert kconv.vector_path(dy, w, D=D) == (not one_wide)
    return x, w, b, dy, pos


# (B, L, D, W, one element a thread): L 997, L < run, L = 1; W 1-4; D no
# multiple of a vector (3, 33, 100, 4100) on the one-element path
CONV_RUN_CASES = [(2, 997, 104, 4, False), (2, 45, 104, 2, False),
                  (2, 1, 8, 4, False), (2, 130, 16, 1, False),
                  (2, 997, 24, 3, False), (2, 997, 33, 4, True),
                  (2, 45, 3, 3, True), (2, 300, 4100, 4, True),
                  (2, 130, 100, 2, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,L,D,W,one_wide", CONV_RUN_CASES)
def test_conv_kernels_match_plain_on_every_run(cuda, Bz, L, D, W, one_wide,
                                               dtype):
    """#1 and #2 at runs 1, 4, 16, 64 and one longer than L against their
    plain versions: #1 f32 1e-5, bf16 one rounding of the f32 sum; #2
    1e-5 · (1 + |ref|); both the same bits at every run (the FMA chain does
    not depend on the run). Each launch reports the run it was given and
    the channels a thread of its path."""
    tdt = getattr(torch, dtype)
    x, w, b, dy, pos = _conv_case(cuda, tdt, Bz, L, D, W, one_wide, L + D)
    want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
    want_dx = kconv.conv1d_pack_bwd_dx_plain(dy, w, pos)
    first = None
    n0 = (kconv.LAUNCHES, kconv.LAUNCHES_DX)
    width = 1 if one_wide else 16 // x.element_size()
    for run in (1, 4, 16, 64, L + 5):
        y = kconv._launch_fwd(x, w, b, pos, run=run)
        assert kconv.LAST_LAUNCH["run"] == run
        assert kconv.LAST_LAUNCH["width"] == width
        dx = kconv._launch_dx(dy, w, pos, run=run)
        torch.cuda.synchronize()
        err = (y.float() - want).abs()
        if dtype == "float32":
            assert bool((err <= 1e-5).all()), (run, err.max())
        else:
            assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6).all()), \
                (run, err.max())
        assert bool(((dx - want_dx).abs()
                     <= 1e-5 * (1 + want_dx.abs())).all()), run
        if first is None:
            first = (y, dx)
        assert torch.equal(y, first[0]) and torch.equal(dx, first[1]), run
    assert (kconv.LAUNCHES, kconv.LAUNCHES_DX) == (n0[0] + 5, n0[1] + 5)


@pytest.mark.parametrize("kind", ["fwd", "bwd_dx"])
def test_conv_kernels_take_any_length(cuda, kind):
    """A buffer of 1.1 M rows at the wrappers' own run (16 for #1, 4 for
    #2) puts more than 65535 runs, so more than 65535 blocks, on grid.x;
    the output matches the plain version over the whole buffer."""
    Bz, L, D = 1, 1_100_000, 8
    rng = np.random.default_rng(4)
    f = dict(device=cuda, dtype=torch.bfloat16)
    x = torch.as_tensor(rng.normal(size=(Bz, L, D))).to(**f)
    w = torch.as_tensor(rng.normal(size=(4, D))).to(**f)
    b = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    # a carried row (first position 7), then a reset every 997 rows
    pos = torch.as_tensor((np.arange(L) + 7) % 997, dtype=torch.int32)
    pos = pos[None].to(cuda)
    if kind == "fwd":
        got = kconv.conv1d_pack(x, w, b, pos)
        want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
        tol = 2.0 ** -8 * want.abs() + 1e-6
    else:
        got = kconv.conv1d_pack_bwd_dx(x, w, pos)
        want = kconv.conv1d_pack_bwd_dx_plain(x, w, pos)
        tol = 1e-5 * (1 + want.abs())
    torch.cuda.synchronize()
    grid = kconv.LAST_LAUNCH["grid"]
    assert kconv.LAST_LAUNCH["kind"] == kind and grid[0] > 65535, grid
    assert grid[0] * kconv.LAST_LAUNCH["run"] >= L
    assert bool(((got.float() - want).abs() <= tol).all())


@pytest.mark.parametrize("one_wide", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_kernels_keep_masked_nan_and_inf_out(cuda, dtype, one_wide):
    """NaN and inf in rows of another segment, where every tap that reaches
    them is masked, leave every output finite: #1 reads back across a reset
    into the segment before, #2 forward across it into the segment after."""
    tdt = getattr(torch, dtype)
    Bz, L, D, W = 2, 200, 40, 4
    x, w, b, dy, _ = _conv_case(cuda, tdt, Bz, L, D, W, one_wide, 5)
    pos = torch.as_tensor(np.tile(np.concatenate(
        [np.arange(70), np.arange(130)]), (Bz, 1)).astype(np.int32)).to(cuda)
    x[:, 60:70] = float("nan")
    x[:, 64:66, ::3] = float("inf")
    dy[:, 70:80] = float("nan")
    dy[:, 71:73, ::3] = -float("inf")
    y = kconv.conv1d_pack(x, w, b, pos)
    dx = kconv.conv1d_pack_bwd_dx(dy, w, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y[:, 70:]).all())
    assert bool(torch.isfinite(dx[:, :70]).all())
    want = kconv.conv1d_pack_plain(x[:, 70:].float(), w.float(), b.float(),
                                   pos[:, 70:])
    torch.testing.assert_close(y[:, 70:].float(), want.float(),
                               atol=1e-5, rtol=2.0 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_fwd_kernel_repeats_bitwise(cuda, dtype):
    """#1 twice at mamba-1.4b's width on a packed, ragged L: y bitwise
    equal."""
    tdt = getattr(torch, dtype)
    x, w, b, _, pos = _conv_case(cuda, tdt, 2, 997, 4096, 4, False, 9)
    y, again = (kconv.conv1d_pack(x, w, b, pos) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(y, again)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("one_wide", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fwd", "bwd_dx"])
def test_conv_kernels_do_not_spill(cuda, kind, dtype, one_wide, W):
    """#1 and #2 keep their taps and row windows in registers (no local
    memory) at every conv width the wrappers take, both channel widths and
    both dtypes."""
    r = kconv.conv_resources(kind, dtype, one_wide, W)
    assert r["local_bytes"] == 0, r
    assert 0 < r["registers"] <= 255 and r["blocks_per_sm"] >= 2, r


def test_conv_serving_bucket_puts_two_blocks_on_every_sm(cuda):
    """At (2, 256, 4096) bf16, the largest serving bucket, the run rule's
    grid has at least two blocks for each SM, and two fit an SM at once."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lp = kconv.conv_params(2, 256, 4096, torch.bfloat16)
    assert lp["blocks"] >= 2 * sms, (lp, sms)
    for kind in ("fwd", "bwd_dx"):
        assert kconv.conv_resources(kind, torch.bfloat16)[
            "blocks_per_sm"] >= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_scan_kernels_match_plain_and_repeat(cuda, dtype, chunk):
    """Ragged L (not a tile multiple) and D (not a channel-block multiple);
    B and C as strided views of one projection."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    Bz, L, D, N = 2, 300, 100, 16
    u, dy = (torch.as_tensor(rng.normal(size=(Bz, L, D))).to(cuda, tdt)
             for _ in range(2))
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, D))).to(cuda, tdt)
    dbl = torch.as_tensor(rng.normal(size=(Bz, L, 8 + 2 * N))).to(cuda, tdt)
    _, Bm, Cm = dbl.split([8, N, N], dim=-1)
    At = -torch.as_tensor(np.exp(rng.normal(size=(N, D)))).to(
        cuda, torch.float32)
    Dp = torch.as_tensor(rng.normal(size=(D,))).to(cuda, torch.float32)
    pos = torch.as_tensor(_positions(Bz, L, 2)).to(cuda)
    n0 = (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD)
    y, ck = ksc.selective_scan_fwd(u, dt, At, Bm, Cm, Dp, pos, chunk)
    outs = ksc.selective_scan_bwd(u, dt, At, Bm, Cm, Dp, pos, ck, dy, chunk)
    again = ksc.selective_scan_bwd(u, dt, At, Bm, Cm, Dp, pos, ck, dy, chunk)
    torch.cuda.synchronize()
    assert (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD) == (n0[0] + 1, n0[1] + 2)
    wy, wck = ksc.selective_scan_fwd_plain(u, dt, At, Bm, Cm, Dp, pos, chunk)
    torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    if dtype == "float32":
        torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    else:
        err = (y.float() - wy.float()).abs()
        assert bool((err <= 2.0 ** -7 * wy.float().abs() + 1e-2).all())
    want = ksc.selective_scan_bwd_plain(u, dt, At, Bm, Cm, Dp, pos, ck, dy,
                                        chunk)
    for name, g, w, r in zip(("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                             want, again):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        assert torch.equal(g, r), name


@pytest.mark.parametrize("Bz,L,D", [(1, 1, 3), (1, 5, 33), (3, 17, 64)])
def test_kernels_on_edge_shapes(cuda, Bz, L, D):
    """One step, fewer channels than a block, an odd batch: each kernel
    against its plain version (f32)."""
    rng = np.random.default_rng(L)
    N, f = 16, dict(device=cuda, dtype=torch.float32)
    u, dy, x = (torch.as_tensor(rng.normal(size=(Bz, L, D))).to(**f)
                for _ in range(3))
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, D))).to(**f)
    Bm, Cm = (torch.as_tensor(rng.normal(size=(Bz, L, N))).to(**f)
              for _ in range(2))
    At = -torch.as_tensor(np.exp(rng.normal(size=(N, D)))).to(**f)
    Dp = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    w = torch.as_tensor(rng.normal(size=(4, D))).to(**f)
    pos = torch.as_tensor(np.tile(np.arange(L) % 4, (Bz, 1)).astype(
        np.int32)).to(cuda)
    args = (u, dt, At, Bm, Cm, Dp, pos)
    y, ck = ksc.selective_scan_fwd(*args, 16)
    wy, wck = ksc.selective_scan_fwd_plain(*args, 16)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    for g, w_ in zip(ksc.selective_scan_bwd(*args, ck, dy, 16),
                     ksc.selective_scan_bwd_plain(*args, ck, dy, 16)):
        torch.testing.assert_close(g, w_, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(kconv.conv1d_pack_bwd_dx(dy, w, pos),
                               kconv.conv1d_pack_bwd_dx_plain(dy, w, pos),
                               atol=1e-5, rtol=1e-5)
    b = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    torch.testing.assert_close(kconv.conv1d_pack(x, w, b, pos),
                               kconv.conv1d_pack_plain(x, w, b, pos),
                               atol=1e-5, rtol=1e-5)


def test_autograd_through_the_kernels_repeats_bitwise(cuda):
    """The wired backward (kernels #2 and #6 plus the fixed-order sums of
    their partials) gives bitwise-equal gradients run after run."""
    rng = np.random.default_rng(3)
    Bz, L, D, N = 2, 256, 256, 16
    f = dict(device=cuda, dtype=torch.bfloat16)
    x = torch.as_tensor(rng.normal(size=(Bz, L, D))).to(**f)
    w = torch.as_tensor(rng.normal(size=(4, D))).to(**f)
    dbl = torch.as_tensor(rng.normal(size=(Bz, L, 2 * N))).to(**f)
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, D))).to(**f)
    A = -torch.as_tensor(np.exp(rng.normal(size=(D, N)))).to(
        cuda, torch.float32)
    pos = torch.as_tensor(_positions(Bz, L, 3)).to(cuda)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, w, dbl, dt, A)]
        xl, wl, dl, tl, al = leaves
        xc = tops.conv1d_pack(xl, wl, None, pos)
        Bm, Cm = dl.split([N, N], dim=-1)
        y = tops.selective_scan(xc, tl, al, Bm, Cm, None, positions=pos)
        grads.append(torch.autograd.grad(y.float().square().sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _heads_inputs(cuda, tdt, Bz, L, H, P, seed):
    """u, dy (B, L, H, P), Δ (B, L, H) in ``tdt``; B and C as strided
    views of one (B, L, 8 + 2N) projection; A from the Mamba-2 init
    (-U[1, 16]); D random; positions from ``_positions`` (row 0 packed,
    row 1 carried)."""
    rng = np.random.default_rng(seed)
    N = kh.D_STATE
    u, dy = (torch.as_tensor(rng.normal(size=(Bz, L, H, P))).to(cuda, tdt)
             for _ in range(2))
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, H))).to(cuda, tdt)
    bc = torch.as_tensor(rng.normal(size=(Bz, L, 8 + 2 * N))).to(cuda, tdt)
    _, Bm, Cm = bc.split([8, N, N], dim=-1)
    A = -torch.as_tensor(rng.uniform(1, 16, (H,))).to(cuda, torch.float32)
    Dp = torch.as_tensor(rng.normal(size=(H,))).to(cuda, torch.float32)
    pos = np.tile(np.arange(L) % 5, (Bz, 1)).astype(np.int32) if Bz < 2 \
        else _positions(Bz, L, seed)
    return (u, dt, A, Bm, Cm, Dp, torch.as_tensor(pos).to(cuda)), dy


def _assert_forward_close(y, ck, wy, wck, dtype):
    """A forward kernel's (y, ckpts) against the plain version's."""
    torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    if dtype == "float32":
        torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    else:
        err = (y.float() - wy.float()).abs()
        assert bool((err <= 2.0 ** -7 * wy.float().abs() + 1e-2).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_heads_kernels_match_plain_and_repeat(cuda, dtype, chunk):
    """#7, #8 and #9 against their plain versions: a ragged L (no tile or
    chunk multiple), two slices of P; #9 twice, bitwise equal."""
    tdt = getattr(torch, dtype)
    args, dy = _heads_inputs(cuda, tdt, 2, 300, 3, 32, 4)
    n0 = (kh.LAUNCHES_FWD, kh.LAUNCHES_DUAL, kh.LAUNCHES_BWD)
    y, ck = kh.selective_scan_heads_fwd(*args, chunk)
    yd, ckd = kh.selective_scan_heads_fwd(*args, chunk, "blocked_heads_dual")
    outs = kh.selective_scan_heads_bwd(*args, ck, dy, chunk)
    again = kh.selective_scan_heads_bwd(*args, ck, dy, chunk)
    torch.cuda.synchronize()
    assert (kh.LAUNCHES_FWD, kh.LAUNCHES_DUAL, kh.LAUNCHES_BWD) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 2)
    wy, wck = kh.selective_scan_heads_fwd_plain(*args, chunk)
    for got_y, got_ck in ((y, ck), (yd, ckd)):
        _assert_forward_close(got_y, got_ck, wy, wck, dtype)
    want = kh.selective_scan_heads_bwd_plain(*args, ck, dy, chunk)
    for name, g, w, r in zip(("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                             want, again):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        assert torch.equal(g, r), name


@pytest.mark.parametrize("Bz,L,H,P", [(1, 1, 1, 16), (1, 5, 2, 16),
                                      (3, 17, 2, 48)])
def test_heads_kernels_on_edge_shapes(cuda, Bz, L, H, P):
    """One step, a chunk longer than L, an odd batch: #7, #8, #9 against
    their plain versions (f32)."""
    args, dy = _heads_inputs(cuda, torch.float32, Bz, L, H, P, L)
    for sched in kh.SCHEDULES:
        y, ck = kh.selective_scan_heads_fwd(*args, 256, sched)
        wy, wck = kh.selective_scan_heads_fwd_plain(*args, 256)
        torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    for g, w in zip(kh.selective_scan_heads_bwd(*args, ck, dy, 256),
                    kh.selective_scan_heads_bwd_plain(*args, ck, dy, 256)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _subchunk_positions(L, chunk, q, seed):
    """Row 0: resets on the first and on the last step of the sub-chunks
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


# (L, H, P, chunk): ragged L; a chunk that is no multiple of #7's and #9's
# sub-chunk (96); a chunk shorter than it (40); a chunk longer than L; P 16,
# 48, 80 (a short last slice of a block's rows) and 64 (one slice a head)
SUBCHUNK_CASES = [(150, 2, 16, 64), (200, 2, 48, 96), (300, 1, 16, 256),
                  (97, 2, 80, 40), (130, 1, 48, 256), (256, 3, 64, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SUBCHUNK_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_heads_forward_on_subchunk_edges(cuda, case, dtype):
    """#7 against the per-step plain version where its sub-chunks meet
    resets, chunk ends and L, its blocks' rows of P past P masked; twice,
    bitwise equal."""
    L, H, P, chunk = case
    args, _ = _heads_inputs(cuda, getattr(torch, dtype), 2, L, H, P, L)
    pos = _subchunk_positions(L, chunk, kh.FWD_SUB_T, L)
    args = (*args[:6], torch.as_tensor(pos).to(cuda))
    n0 = kh.LAUNCHES_FWD
    y, ck = kh.selective_scan_heads_fwd(*args, chunk)
    y2, ck2 = kh.selective_scan_heads_fwd(*args, chunk)
    torch.cuda.synchronize()
    assert kh.LAUNCHES_FWD == n0 + 2
    _assert_forward_close(y, ck, *kh.selective_scan_heads_fwd_plain(
        *args, chunk), dtype)
    assert torch.equal(y, y2) and torch.equal(ck, ck2)


def _unaligned_heads_inputs(cuda):
    """f32 inputs whose B and C are views of one projection at an odd
    offset, and whose u lies at an address that is no multiple of 16."""
    args, dy = _heads_inputs(cuda, torch.float32, 2, 150, 2, 16, 3)
    u, dt, A, Bm, Cm, Dp, pos = args
    N = kh.D_STATE
    bc = torch.empty((2, 150, 3 + 2 * N), device=cuda)
    bc[..., 3:3 + N], bc[..., 3 + N:] = Bm, Cm
    B2, C2 = bc[..., 3:3 + N], bc[..., 3 + N:]
    u2 = torch.empty(u.numel() + 1, device=cuda)[1:].view(u.shape).copy_(u)
    assert B2.data_ptr() % 16 and u2.data_ptr() % 16
    return (u2, dt, A, B2, C2, Dp, pos), dy


def test_heads_forward_takes_unaligned_operands(cuda):
    """#7 copies its operands 16 bytes at a time: unaligned u, B and C
    still give the plain version's outputs."""
    args, _ = _unaligned_heads_inputs(cuda)
    _assert_forward_close(*kh.selective_scan_heads_fwd(*args, 64),
                          *kh.selective_scan_heads_fwd_plain(*args, 64),
                          "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SUBCHUNK_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_heads_backward_on_subchunk_edges(cuda, case, dtype):
    """#9 against its plain version where its sub-chunks meet resets, chunk
    ends and L; its partials one per ``BWD_P_SLICE`` rows of P (per head at
    P = 64); twice, bitwise equal."""
    L, H, P, chunk = case
    tdt = getattr(torch, dtype)
    args, dy = _heads_inputs(cuda, tdt, 2, L, H, P, L)
    pos = _subchunk_positions(L, chunk, kh.BWD_SUB_T, L)
    args = (*args[:6], torch.as_tensor(pos).to(cuda))
    _, ck = kh.selective_scan_heads_fwd(*args, chunk)
    outs = kh.selective_scan_heads_bwd(*args, ck, dy, chunk)
    again = kh.selective_scan_heads_bwd(*args, ck, dy, chunk)
    torch.cuda.synchronize()
    nps = -(-P // 64)
    assert kh.n_slices(P) == nps
    shapes = [(2, L, H, P), (2, L, H, nps), (2, H * nps, L, kh.D_STATE),
              (2, H * nps, L, kh.D_STATE), (2, H, nps), (2, H, nps)]
    want = kh.selective_scan_heads_bwd_plain(*args, ck, dy, chunk)
    for name, g, w, r, shape in zip(("du", "ddelta", "dB", "dC", "dA", "dD"),
                                    outs, want, again, shapes):
        assert tuple(g.shape) == shape, name
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        assert torch.equal(g, r), name


def test_heads_backward_takes_unaligned_operands(cuda):
    """#9 copies its operands 16 bytes at a time: B and C as views of one
    projection at an odd offset, and u at an address that is no multiple of
    16, still give the plain version's outputs."""
    args, dy = _unaligned_heads_inputs(cuda)
    _, ck = kh.selective_scan_heads_fwd(*args, 64)
    for name, g, w in zip(("du", "ddelta", "dB", "dC", "dA", "dD"),
                          kh.selective_scan_heads_bwd(*args, ck, dy, 64),
                          kh.selective_scan_heads_bwd_plain(*args, ck, dy,
                                                            64)):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)


def test_heads_kernels_refuse_other_widths(cuda):
    args, _ = _heads_inputs(cuda, torch.float32, 1, 8, 1, 24, 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        kh.selective_scan_heads_fwd(*args, 8)


@pytest.mark.parametrize("schedule", ["blocked_heads", "blocked_heads_dual"])
def test_autograd_through_the_heads_kernels_repeats_bitwise(cuda, schedule):
    """The wired backward (#9 plus the fixed-order sums of its partials)
    gives bitwise-equal gradients run after run."""
    args, _ = _heads_inputs(cuda, torch.bfloat16, 2, 256, 4, 64, 5)
    u, dt, A, Bm, Cm, Dp, pos = args
    bc = torch.cat([Bm, Cm], dim=-1)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (u, dt, A, bc, Dp)]
        lu, ldt, lA, lbc, lD = leaves
        B2, C2 = lbc.chunk(2, dim=-1)
        y = tops.selective_scan_heads(lu, ldt, lA, B2, C2, lD, positions=pos,
                                      schedule=schedule)
        grads.append(torch.autograd.grad(y.float().square().sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ------------------------------------------------ the step schedule (#3, #5)

def _scan_inputs(cuda, tdt, Bz, L, D, seed):
    """u, dy (B, L, D) and Δ in ``tdt``; B and C as strided views of one
    (B, L, 8 + 2N) projection; A random (N, D) f32; positions from
    ``_positions`` (row 0 packed, row 1 carried) or, for one row, resets
    every 7 steps."""
    rng = np.random.default_rng(seed)
    N = ksc.D_STATE
    u, dy = (torch.as_tensor(rng.normal(size=(Bz, L, D))).to(cuda, tdt)
             for _ in range(2))
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, D))).to(cuda, tdt)
    dbl = torch.as_tensor(rng.normal(size=(Bz, L, 8 + 2 * N))).to(cuda, tdt)
    _, Bm, Cm = dbl.split([8, N, N], dim=-1)
    At = -torch.as_tensor(np.exp(rng.normal(size=(N, D)))).to(
        cuda, torch.float32)
    Dp = torch.as_tensor(rng.normal(size=(D,))).to(cuda, torch.float32)
    pos = np.tile(np.arange(L) % 7, (Bz, 1)).astype(np.int32) if Bz < 2 \
        else _positions(Bz, L, seed)
    return (u, dt, At, Bm, Cm, Dp, torch.as_tensor(pos).to(cuda)), dy


def _step_counts():
    return (ksc.LAUNCHES_FWD, ksc.LAUNCHES_BWD, ksc.LAUNCHES_FWD_STEP,
            ksc.LAUNCHES_BWD_STEP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_kernels_match_plain_and_repeat(cuda, dtype):
    """#3 and #5 against their plain versions: a ragged L (no tile multiple)
    and D (no channel-block multiple), a carried row, B and C strided; #5
    twice, bitwise equal; only the step counters move."""
    tdt, chunk = getattr(torch, dtype), ksc.STEP_TILE_T
    args, dy = _scan_inputs(cuda, tdt, 2, 300, 100, 2)
    n0 = _step_counts()
    y, ck = ksc.selective_scan_fwd(*args, chunk, "step")
    outs = ksc.selective_scan_bwd(*args, ck, dy, chunk, "step")
    again = ksc.selective_scan_bwd(*args, ck, dy, chunk, "step")
    torch.cuda.synchronize()
    assert _step_counts() == (n0[0], n0[1], n0[2] + 1, n0[3] + 2)
    wy, wck = ksc.selective_scan_fwd_plain(*args, chunk)
    torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    if dtype == "float32":
        torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    else:
        err = (y.float() - wy.float()).abs()
        assert bool((err <= 2.0 ** -7 * wy.float().abs() + 1e-2).all())
    want = ksc.selective_scan_bwd_plain(*args, ck, dy, chunk,
                                        ksc.STEP_BLOCK_D)
    for name, g, w, r in zip(("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                             want, again):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        assert torch.equal(g, r), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_and_blocked_kernels_agree(cuda, dtype):
    """The two schedules on one card: #3's checkpoints equal #4's, and #5
    fed #4's checkpoints equals #6 (dB/dC summed over their blocks, 16 and
    32 channels wide)."""
    args, dy = _scan_inputs(cuda, getattr(torch, dtype), 2, 700, 200, 6)
    y3, ck3 = ksc.selective_scan_fwd(*args, 64, "step")
    y4, ck4 = ksc.selective_scan_fwd(*args, 64, "blocked")
    err = (ck3 - ck4).abs()
    assert bool((err <= 1e-4 * (1 + ck4.abs())).all()), err.max()
    torch.testing.assert_close(y3.float(), y4.float(), atol=2e-2, rtol=1e-2)
    g5 = list(ksc.selective_scan_bwd(*args, ck4, dy, 64, "step"))
    g6 = list(ksc.selective_scan_bwd(*args, ck4, dy, 64, "blocked"))
    for i in (2, 3):
        g5[i], g6[i] = g5[i].sum(1), g6[i].sum(1)
    for name, a, b in zip(("du", "ddelta", "dB", "dC", "dA", "dD"), g5, g6):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3, msg=name)


def _lane_edge_positions(Bz, L, steps):
    """Row 0: resets on the first and last steps of a tile's first and
    last lanes, for lanes of each of ``steps`` steps (#3's and #5's lanes),
    and on tile edges; the other rows one segment each, carried in (first
    position > 0)."""
    cuts = [0, 63, 64, 128]
    for r in steps:
        cuts += [r - 1, 64 - r, 64 + r - 1, 128 - r]
    cuts = sorted({c for c in cuts if c < L}) + [L]
    pos = np.tile(np.arange(L) + 3, (Bz, 1)).astype(np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    return pos


# (B, L, D, resets): one step, fewer channels than a block, an odd batch,
# exactly one tile, one step past a tile; then resets on #3's and #5's lane
# edges and on tile edges, at a ragged L and D
STEP_EDGE_CASES = [(1, 1, 3, None), (1, 5, 33, None), (3, 17, 64, None),
                   (2, 64, 16, None), (1, 65, 17, None),
                   (2, 130, 17, "lane_edges"), (3, 200, 48, "lane_edges"),
                   (2, 256, 40, "lane_edges")]


def _step_lane_steps():
    """Steps a lane of the built #3 and #5."""
    return (ksc.lanes_fwd_params()["steps"], ksc.step_bwd_params()["steps"])


@pytest.mark.parametrize(
    "Bz,L,D,resets", STEP_EDGE_CASES,
    ids=[f"{b}-{l}-{d}" + (f"-{r}" if r else "")
         for b, l, d, r in STEP_EDGE_CASES])
def test_step_kernels_on_edge_shapes(cuda, Bz, L, D, resets):
    """#3 and #5 against their plain versions (f32) at the edge shapes and
    resets of ``STEP_EDGE_CASES``."""
    args, dy = _scan_inputs(cuda, torch.float32, Bz, L, D, L + D)
    if resets:
        args = (*args[:6], torch.as_tensor(_lane_edge_positions(
            Bz, L, _step_lane_steps())).to(cuda))
    y, ck = ksc.selective_scan_fwd(*args, 64, "step")
    wy, wck = ksc.selective_scan_fwd_plain(*args, 64)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ck, wck, atol=1e-4, rtol=1e-4)
    for g, w in zip(ksc.selective_scan_bwd(*args, ck, dy, 64, "step"),
                    ksc.selective_scan_bwd_plain(*args, ck, dy, 64,
                                                 ksc.STEP_BLOCK_D)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_fwd_kernel_repeats_bitwise(cuda, dtype):
    """#3 twice on the same inputs (resets on its lane edges, a ragged L
    and D, B and C strided): y and the checkpoints bitwise equal."""
    args, _ = _scan_inputs(cuda, getattr(torch, dtype), 2, 700, 200, 4)
    args = (*args[:6], torch.as_tensor(_lane_edge_positions(
        2, 700, _step_lane_steps())).to(cuda))
    y, ck = ksc.selective_scan_fwd(*args, 64, "step")
    y2, ck2 = ksc.selective_scan_fwd(*args, 64, "step")
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(ck, ck2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_fwd_kernel_does_not_spill(cuda, dtype):
    """#3 keeps its arrays in registers (no local memory) in both builds."""
    r = ksc.lanes_fwd_resources(dtype)
    assert r["local_bytes"] == 0, r
    assert r["blocks_per_sm"] >= 1, r


def test_step_fwd_grid_is_one_wave_at_mamba_2_8b(cuda):
    """At mamba-2.8b's training shape (2, 4096, 5120) bf16, #3's blocks fit
    the card's block slots at once: blocks an SM × SMs ≥ grid."""
    r = ksc.lanes_fwd_resources(torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    grid = 2 * -(-5120 // ksc.lanes_fwd_params()["block_d"])
    assert r["blocks_per_sm"] * sms >= grid, (r, sms, grid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_bwd_kernel_does_not_spill(cuda, dtype):
    """#5 keeps its arrays in registers (no local memory) in both builds,
    and for bf16 input (the training path) holds more than the 16 warps an
    SM of the design it replaced."""
    r = ksc.step_bwd_resources(dtype)
    assert r["local_bytes"] == 0, r
    assert r["blocks_per_sm"] >= 1, r
    if dtype == torch.bfloat16:
        assert r["warps_per_sm"] > 16, r


@pytest.mark.parametrize("chunk", [32, 128])
def test_step_kernels_refuse_other_chunks(cuda, chunk):
    args, dy = _scan_inputs(cuda, torch.float32, 1, 40, 16, 0)
    with pytest.raises(ValueError, match="chunk == 64"):
        ksc.selective_scan_fwd(*args, chunk, "step")
    ck = torch.zeros((1, -(-40 // chunk), 16, 16), device=cuda)
    with pytest.raises(ValueError, match="chunk == 64"):
        ksc.selective_scan_bwd(*args, ck, dy, chunk, "step")


@pytest.mark.parametrize("schedule", ["blocked", "step"])
def test_autograd_through_the_scan_kernels_repeats_and_counts(cuda,
                                                              schedule):
    """``ops.selective_scan(schedule=...)`` launches that schedule's two
    kernels and no other scan kernel; its gradients repeat bitwise."""
    args, _ = _scan_inputs(cuda, torch.bfloat16, 2, 256, 96, 9)
    u, dt, At, Bm, Cm, Dp, pos = args
    bc = torch.cat([Bm, Cm], dim=-1)
    A = At.t().contiguous()
    grads = []
    n0 = _step_counts()
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (u, dt, A, bc, Dp)]
        lu, ldt, lA, lbc, lD = leaves
        B2, C2 = lbc.chunk(2, dim=-1)
        y = tops.selective_scan(lu, ldt, lA, B2, C2, lD, positions=pos,
                                schedule=schedule)
        grads.append(torch.autograd.grad(y.float().square().sum(), leaves))
    moved = [b - a for a, b in zip(n0, _step_counts())]
    assert moved == ([0, 0, 2, 2] if schedule == "step" else [2, 2, 0, 0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# Kernel #6 (chunk-parallel, ``csrc/selective_scan_bwd.cu``) on the cases of
# tests/test_torch_scan_bwd_chunked.py, scaled to each chunk: (id, rows, L as
# a function of the chunk, D, positions, dtype, offset of B and C in their
# projection: 8 keeps every row 16-byte aligned (cp.async staging), 5 does
# not (plain loads)).
CHUNKED_CASES = [
    ("packed", 2, lambda c: 4 * c, 64, "packed", "float32", 8),
    ("one_segment_spans_every_chunk", 2, lambda c: 5 * c, 64, "one",
     "float32", 8),
    ("resets_on_chunk_first_and_last_steps", 2, lambda c: 4 * c, 64,
     "edges", "float32", 8),
    ("ragged_L", 2, lambda c: 2 * c + 5, 64, "packed", "float32", 8),
    ("L_below_chunk", 2, lambda c: c - 6, 64, "packed", "float32", 8),
    ("D_not_multiple_of_32", 2, lambda c: 3 * c, 40, "packed", "float32", 8),
    ("bf16", 2, lambda c: 4 * c, 64, "packed", "bfloat16", 8),
    ("bf16_ragged_L_and_D_unaligned", 2, lambda c: 3 * c + 7, 100, "edges",
     "bfloat16", 5),
]


def _chunked_case_inputs(cuda, Bz, L, D, kind, dtype, off, chunk, seed):
    """As ``_scan_inputs``, with row 0's positions of ``kind``: ``packed``
    (resets at 5 and 21), ``one`` (one segment over the row), ``edges``
    (resets on a chunk's first and on another's last step); row 1 a
    carried row of a split pack."""
    rng = np.random.default_rng(seed)
    N, tdt = ksc.D_STATE, getattr(torch, dtype)
    u, dy = (torch.as_tensor(rng.normal(size=(Bz, L, D))).to(cuda, tdt)
             for _ in range(2))
    dt = torch.as_tensor(rng.uniform(0.01, 0.3, (Bz, L, D))).to(cuda, tdt)
    dbl = torch.as_tensor(rng.normal(size=(Bz, L, off + 2 * N))).to(cuda,
                                                                    tdt)
    _, Bm, Cm = dbl.split([off, N, N], dim=-1)
    At = -torch.as_tensor(np.exp(rng.normal(size=(N, D)))).to(
        cuda, torch.float32)
    Dp = torch.as_tensor(rng.normal(size=(D,))).to(cuda, torch.float32)
    cuts = {"packed": [0, 5, 21], "one": [0],
            "edges": [0, chunk, 2 * chunk - 1, 3 * chunk]}[kind]
    cuts = sorted({c for c in cuts if c < L}) + [L]
    pos = np.zeros((Bz, L), np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    pos[1] = tpk.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L).positions[1]
    return (u, dt, At, Bm, Cm, Dp, torch.as_tensor(pos).to(cuda)), dy


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("Bz,Lf,D,kind,dtype,off",
                         [c[1:] for c in CHUNKED_CASES],
                         ids=[c[0] for c in CHUNKED_CASES])
def test_chunked_bwd_kernel_matches_plain_and_repeats(cuda, Bz, Lf, D, kind,
                                                      dtype, off, chunk):
    """#6 against ``selective_scan_bwd_plain`` on the checkpoints of #4;
    twice, bitwise equal; one launch counted per call."""
    L = Lf(chunk)
    args, dy = _chunked_case_inputs(cuda, Bz, L, D, kind, dtype, off, chunk,
                                    L + D + chunk)
    _, ck = ksc.selective_scan_fwd(*args, chunk)
    n0 = ksc.LAUNCHES_BWD
    outs = ksc.selective_scan_bwd(*args, ck, dy, chunk)
    again = ksc.selective_scan_bwd(*args, ck, dy, chunk)
    torch.cuda.synchronize()
    assert ksc.LAUNCHES_BWD == n0 + 2
    want = ksc.selective_scan_bwd_plain(*args, ck, dy, chunk)
    for name, g, w, r in zip(("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                             want, again):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
        assert torch.equal(g, r), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_bwd_kernels_do_not_spill(cuda, dtype):
    """#6's three kernels keep their arrays in registers (no local memory)
    in both builds; the chunk kernel holds more than the 8 warps an SM of
    the design it replaced for bf16 input (the training path), and no
    fewer for f32."""
    res = ksc.bwd_resources(dtype, 64)
    for name, r in res.items():
        assert r["local_bytes"] == 0, (name, r)
        assert r["blocks_per_sm"] >= 1, (name, r)
    if dtype == torch.bfloat16:
        assert res["chunk"]["warps_per_sm"] > 8, res["chunk"]
    else:
        assert res["chunk"]["warps_per_sm"] >= 8, res["chunk"]


# ------------------------------------------------- the blocked forward (#4)

# chunk 64 is the main path's (#3's kernel: every tile's entry state); the
# others take the any-chunk kernel (the state before each chunk start, from
# a lane's registers): 16 and 48 start inside tiles, 128 on every other
# tile edge, 512 is longer than every L below
BLOCKED_FWD_CHUNKS = [16, 48, 64, 128, 512]

# (id, rows, L, D, dtype, offset of B and C in their projection: 8 keeps
# every row 16-byte aligned (cp.async staging), 5 and 3 do not (plain
# loads))
BLOCKED_FWD_CASES = [
    ("ragged_L_and_D", 2, 300, 100, "float32", 8),
    ("one_step_past_a_tile", 2, 65, 17, "float32", 8),
    ("L_below_tile_odd_batch", 3, 17, 64, "float32", 8),
    ("bf16_ragged_L_and_D", 2, 300, 100, "bfloat16", 8),
    ("bf16_B_C_unaligned", 2, 203, 48, "bfloat16", 5),
    ("f32_B_C_unaligned", 2, 130, 40, "float32", 3),
]


def _blocked_fwd_inputs(cuda, Bz, L, D, dtype, off, chunk, seed):
    """``_chunked_case_inputs``' operands; row 0 resets on the first and
    last steps of a tile's first and last lanes (#4's steps a lane), on tile
    edges and on the first steps of the first three chunks; the other rows
    carried (first position > 0)."""
    args, _ = _chunked_case_inputs(cuda, Bz, L, D, "packed", dtype, off,
                                   chunk, seed)
    r = ksc.lanes_fwd_params()["steps"]
    cuts = {0, r - 1, 64 - r, 63, 64, 64 + r - 1, 128 - r, 128, chunk,
            2 * chunk, 3 * chunk}
    cuts = sorted(c for c in cuts if c < L) + [L]
    pos = np.tile(np.arange(L) + 3, (Bz, 1)).astype(np.int32)
    for a, b in zip(cuts[:-1], cuts[1:]):
        pos[0, a:b] = np.arange(b - a)
    return (*args[:6], torch.as_tensor(pos).to(cuda))


@pytest.mark.parametrize("chunk", BLOCKED_FWD_CHUNKS)
@pytest.mark.parametrize("Bz,L,D,dtype,off",
                         [c[1:] for c in BLOCKED_FWD_CASES],
                         ids=[c[0] for c in BLOCKED_FWD_CASES])
def test_blocked_fwd_kernel_matches_plain_and_repeats(cuda, Bz, L, D, dtype,
                                                      off, chunk):
    """#4 against ``selective_scan_fwd_plain`` at each chunk, on resets at
    lane, tile and chunk edges; twice, bitwise equal; one launch counted
    per call."""
    args = _blocked_fwd_inputs(cuda, Bz, L, D, dtype, off, chunk,
                               L + D + chunk)
    n0 = ksc.LAUNCHES_FWD
    y, ck = ksc.selective_scan_fwd(*args, chunk)
    y2, ck2 = ksc.selective_scan_fwd(*args, chunk)
    torch.cuda.synchronize()
    assert ksc.LAUNCHES_FWD == n0 + 2
    assert ck.shape == (Bz, -(-L // chunk), ksc.D_STATE, D)
    _assert_forward_close(y, ck, *ksc.selective_scan_fwd_plain(*args, chunk),
                          dtype)
    assert torch.equal(y, y2) and torch.equal(ck, ck2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_fwd_kernels_do_not_spill(cuda, dtype):
    """#4's any-chunk kernel keeps its arrays and its chunk-start mask in
    registers (no local memory) in both builds (its chunk-64 kernel is #3's:
    ``test_step_fwd_kernel_does_not_spill``)."""
    r = ksc.lanes_fwd_resources(dtype, 48)
    assert r["local_bytes"] == 0, r
    assert 0 < r["registers"] <= 255, r
    assert r["blocks_per_sm"] >= 1, r


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_and_blocked_forwards_agree_on_lane_edges(cuda, dtype):
    """#3 and #4 at chunk 64 on resets at lane and tile edges: one kernel
    under two names, so y and the checkpoints bitwise equal."""
    args = _blocked_fwd_inputs(cuda, 2, 700, 200, dtype, 8, 64, 5)
    y3, ck3 = ksc.selective_scan_fwd(*args, 64, "step")
    y4, ck4 = ksc.selective_scan_fwd(*args, 64, "blocked")
    torch.cuda.synchronize()
    assert torch.equal(y3, y4) and torch.equal(ck3, ck4)


# ------------------------------------------------------------- the tuner

TUNE_KEYS = [("selective_scan", dict(B=1, L=256, D=64, N=16), "fwdbwd"),
             ("selective_scan_heads", dict(B=1, L=256, H=2, dh=64, N=64),
              "fwd")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,shape,objective", TUNE_KEYS)
def test_tune_sweep_measures_every_kernel_candidate(cuda, op, shape,
                                                    objective, dtype):
    """On the card the sweep adds the kernel candidates, runs each and drops
    none; each agrees with the plain blocked scan on the sweep's own
    operands (forward 1e-4 abs + rel in f32, two bf16 roundings in bf16;
    loss 1e-3 relative; each gradient within 1e-3 (f32) or 2e-2 (bf16:
    dy and the outputs rounded to bf16) of its largest magnitude)."""
    from repro_torch.tune import runner as trunner
    from repro_torch.tune import space as tspace
    k = tspace.shape_key(op, dtype=dtype, objective=objective, **shape)
    kern = tspace.kernel_candidates(k)
    assert kern
    ranked, pruned = trunner.sweep(k, rounds=1)
    names = {n for n, _, _ in ranked}
    assert {tspace.candidate_name(c) for c in kern} <= names
    assert all(kn.get("backend") != "pallas" for _, kn, _ in pruned)
    assert all(us > 0 for _, _, us in ranked)
    args = trunner.synth_args(k, device=cuda)
    ref = trunner.make_thunk(k, {"backend": "xla", "method": "blocked",
                                 "chunk": 16}, args)()
    for c in kern:
        got = trunner.make_thunk(k, c, args)()
        if objective == "fwd":
            tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-4
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=1e-2 if tol > 1e-4 else 1e-4)
        else:
            torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=0.0)
            tol = 2e-2 if dtype == "bfloat16" else 1e-3
            for a, b in zip(got[1], ref[1]):
                scale = b.float().abs().max().item()
                assert (a.float() - b.float()).abs().max().item() <= \
                    tol * scale, (tspace.candidate_name(c), scale)


@pytest.mark.parametrize("op,knobs,counter", [
    ("selective_scan", {"backend": "pallas", "schedule": "step",
                        "pchunk": 64}, ("LAUNCHES_FWD_STEP",
                                        "LAUNCHES_BWD_STEP")),
    ("selective_scan", {"backend": "pallas", "schedule": "blocked",
                        "pchunk": 128}, ("LAUNCHES_FWD", "LAUNCHES_BWD")),
    ("selective_scan_heads", {"backend": "pallas",
                              "schedule": "blocked_heads_dual",
                              "pchunk": 128}, ("LAUNCHES_DUAL",
                                               "LAUNCHES_BWD"))])
def test_tuned_kernel_winner_launches_its_own_kernels(cuda, op, knobs,
                                                      counter):
    """A kernel winner in the cache, resolved by ``kernels/ops.py`` from a
    call asking for the plain backend, launches exactly the winner's
    forward and backward kernels."""
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import runner as trunner
    from repro_torch.tune import space as tspace
    shape = dict(TUNE_KEYS[0][1] if op == "selective_scan" else
                 TUNE_KEYS[1][1])
    k = tspace.shape_key(op, objective="fwdbwd", **shape)
    c = tcache.TuneCache()
    c.put(k, knobs, 1.0)
    u, delta, A, Bm, Cm, Dk, pos = trunner.synth_args(k, device=cuda)
    mod = kh if op == "selective_scan_heads" else ksc
    names = ("LAUNCHES_FWD", "LAUNCHES_BWD", "LAUNCHES_FWD_STEP",
             "LAUNCHES_BWD_STEP", "LAUNCHES_DUAL")
    before = {n: getattr(mod, n) for n in names if hasattr(mod, n)}
    leaves = [t.requires_grad_() for t in (u, delta, Bm, Cm)]
    y = getattr(tops, op)(leaves[0], leaves[1], A, leaves[2], leaves[3],
                          Dk, pos, backend="xla", tune=c,
                          tune_objective="fwdbwd")
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    ran = {n: getattr(mod, n) - v for n, v in before.items()}
    assert ran == {n: int(n in counter) for n in before}


@pytest.mark.parametrize("off", [0, 512])
def test_conv_fwd_on_the_chunk_slab(cuda, off):
    """#1 over a chunk-lane slab as ``blocks._conv_resume`` hands it over:
    (1, 3 + 256, 4096) bf16, the carried conv tail at three leading zero
    positions, then the slab at global positions from ``off`` (0: the
    prompt's first slab, where the tail must not reach) with 40 rows of
    trailing padding. Against the plain version (one bf16 rounding of the
    f32 sum), bitwise equal on two runs and to ``_conv_resume``'s kept
    outputs."""
    rng = np.random.default_rng(off + 1)
    D, T, W, pad = 4096, 256, 4, 40
    f = dict(device=cuda, dtype=torch.bfloat16)
    x_in = torch.as_tensor(rng.normal(size=(1, T, 2 * D))).to(**f)
    x_in = x_in.chunk(2, dim=-1)[0]                # a strided view, as xz's
    tail = torch.as_tensor(rng.normal(size=(1, W - 1, D))).to(**f)
    w = torch.as_tensor(rng.normal(size=(W, D)) / 2).to(**f)
    b = torch.as_tensor(rng.normal(size=D) / 4).to(**f)
    pos = np.zeros((1, T), np.int32)
    pos[0, :T - pad] = np.arange(off, off + T - pad)
    pos = torch.as_tensor(pos).to(cuda)
    ext = torch.cat([tail, x_in], dim=1)
    pos_ext = torch.cat([torch.zeros((1, W - 1), dtype=torch.int32,
                                     device=cuda), pos], dim=1)
    assert tuple(ext.shape) == (1, 259, 4096)
    want = kconv.conv1d_pack_plain(ext.float(), w.float(), b.float(),
                                   pos_ext)
    n0 = kconv.LAUNCHES
    y, again = (kconv.conv1d_pack(ext, w, b, pos_ext) for _ in range(2))
    x_c, ext2 = B._conv_resume(x_in, tail, w, b, pos)
    torch.cuda.synchronize()
    assert kconv.LAUNCHES == n0 + 3
    err = (y.float() - want).abs()
    assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6).all()), err.max()
    assert torch.equal(y, again) and torch.equal(ext2, ext)
    assert torch.equal(x_c, y[:, W - 1:])
    if off == 0:         # position 0 resets: the slab ignores the tail
        alone = kconv.conv1d_pack(x_in.contiguous(), w, b, pos)
        assert torch.equal(x_c[:, :T - pad], alone[:, :T - pad])


def test_sampling_uniforms_on_the_card_equal_the_cpu(cuda):
    """The counter-based noise is integer arithmetic: the card's uniforms
    are the CPU's, bit for bit, at mamba-1.4b's vocab."""
    stream = torch.as_tensor(B.request_streams(7, np.arange(24)))
    ctr = torch.arange(24, dtype=torch.int64) * 3
    u_cpu = B.sample_uniforms(stream, ctr, 50280)
    u_card = B.sample_uniforms(stream.to(cuda), ctr.to(cuda), 50280)
    assert torch.equal(u_cpu, u_card.cpu())


def test_overlap_identity_at_reduced_size(cuda):
    """The engine with packed prefills on a side stream (two in flight)
    gives the synchronous engine's streams bit for bit, greedy and sampled,
    and a long prompt through the chunk lane; #1 launches once a layer for
    each prefill and chunk round. Slots outnumber requests, so both runs
    pack the same rounds (their numerics depend on the layout)."""
    cfg = dataclasses.replace(get_config("mamba-110m").reduced(),
                              d_model=256, n_layers=4, vocab=512,
                              dtype="bfloat16")
    model = LM(cfg, cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(9)
    lens = [5, 40, 9, 13, 26, 7, 11, 30, 12, 6]
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in lens]
    temps = [0.0, 0.7, 0.0, 0.9, 0.0, 0.8, 0.0, 0.6, 0.0, 1.0]

    def run(**kw):
        eng = ServeEngine(model, num_slots=12, max_len=64, buckets=(16, 32),
                          max_segments=2, sample_seed=3, **kw)
        for p, tp in zip(prompts, temps):
            eng.submit(p, 8, temperature=tp, top_k=20, top_p=0.9)
        n0 = kconv.LAUNCHES
        outs = eng.run()
        torch.cuda.synchronize()
        assert kconv.LAUNCHES - n0 == cfg.n_layers * (
            eng.stats.prefills + eng.stats.chunk_rounds)
        return [outs[r] for r in sorted(outs)], eng

    base, beng = run(overlap=False)
    for _ in range(2):
        got, eng = run(overlap=True, max_inflight_prefills=2)
        assert eng._side is not None and beng._side is None
        assert got == base
        assert eng.stats.overlapped_prefills > 0
        assert eng.stats.chunked_prefills == 1


def _lifecycle_model(dev):
    cfg = dataclasses.replace(get_config("mamba-110m").reduced(),
                              d_model=256, n_layers=4, vocab=512,
                              dtype="bfloat16")
    model = LM(cfg, dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, size=n)
               for n in (5, 14, 9, 12, 7, 11)]
    knobs = [dict(temperature=t, top_k=20, top_p=0.9)
             for t in (0.0, 0.8, 0.0, 1.1, 0.0, 0.7)]
    return model, prompts, knobs


def test_guarded_decode_step_copies_to_the_host_once(cuda):
    """With the guard on, a decode step's tokens and its finiteness flags
    reach the host in ONE copy, greedy and sampled: the step synchronizes
    with the card once, as the unguarded step does, and calls
    ``Tensor.cpu`` once. Three steps are read a configuration; the first
    may carry a one-time sync of the process (seen once on an unguarded
    greedy step), so the last two are held."""
    import warnings
    from repro_torch.faults import FaultPlan
    model, prompts, knobs = _lifecycle_model(cuda)
    calls = {"cpu": 0}
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        calls["cpu"] += 1
        return cpu(self, *a, **k)

    def one_step(eng):
        torch.cuda.synchronize()
        calls["cpu"] = 0
        torch.Tensor.cpu = counted
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng._decode_step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            torch.Tensor.cpu = cpu
        return sum("synchronizing" in str(x.message) for x in w), \
            calls["cpu"]

    seen = {}
    for sampled in (False, True):
        for guard in (False, True):
            eng = ServeEngine(model, num_slots=8, max_len=64,
                              buckets=(16, 32), max_segments=4,
                              guard=guard, faults=FaultPlan())
            for p, k in zip(prompts, knobs):
                eng.submit(p, 12, **(k if sampled else {}))
            while eng.queue or eng._prefill_pool or eng.stats.decode_steps < 2:
                eng.step()
            seen[(sampled, guard)] = [one_step(eng) for _ in range(3)]
            eng.run()
    assert all(v[1:] == [(1, 1), (1, 1)] for v in seen.values()), seen


def test_nan_slot_rides_along_without_touching_other_rows(cuda):
    """A poisoned prefill segment is quarantined but its NaN state is
    scattered into its slot, which stays free and rides along in every
    decode step (all requests land in one round, so no refill overwrites
    it): after 8 and more steps the slot's state is still non-finite, the
    others' finite, and every other stream, greedy and sampled, is bitwise
    the clean run's, guard on or off."""
    from repro_torch.faults import FaultPlan
    model, prompts, knobs = _lifecycle_model(cuda)

    def run(**kw):
        eng = ServeEngine(model, num_slots=8, max_len=64, buckets=(32,),
                          max_segments=4, sample_seed=3, **kw)
        rids = [eng.submit(p, 12, **k) for p, k in zip(prompts, knobs)]
        eng.step()                       # one round admits all six
        assert eng.stats.prefills == 1 and not eng.queue
        return eng, rids

    clean = {}
    for guard in (False, True):
        eng, rids = run(guard=guard)
        clean[guard] = eng.run()
    assert clean[False] == clean[True]
    eng, rids = run(faults=FaultPlan(poison_prefill={0: [(0, 1)]}))
    bad = [r for r in rids if eng.status[r] == "failed"]
    assert len(bad) == 1 and eng.stats.quarantined == 1
    slot = next(i for i in range(8)
                if i not in eng._active_slots() and
                not torch.isfinite(eng.cache["ssm"][:, i]).all())
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    assert eng.stats.decode_steps >= 9 and eng.slot_req[slot] is None
    for i in range(8):
        finite = bool(torch.isfinite(eng.cache["ssm"][:, i]).all())
        assert finite == (i != slot), i
    out = eng.run()
    assert eng.stats.quarantined == 1
    for r in rids:
        if r not in bad:
            assert out[r] == clean[False][r], r


def _cache_model(dev, dtype="bfloat16"):
    cfg = dataclasses.replace(get_config("mamba-110m").reduced(),
                              d_model=256, n_layers=4, vocab=512,
                              dtype=dtype)
    model = LM(cfg, dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    return model


PREFIX_KW = dict(num_slots=8, max_len=160, buckets=(16, 32), chunk_size=32,
                 max_segments=2, overlap=True, max_inflight_prefills=2)


def _prefix_prompts(vocab, n=5, prefix=64, seed=13):
    """A 64-token system prompt (two 32-token slabs) and 5–20 token
    suffixes: cold and warm runs cut the same slabs."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=prefix)
    return [np.concatenate([shared, rng.integers(1, vocab, size=k)])
            for k in (5, 20, 9, 14, 17)[:n]]


def _prefix_run(model, prompts, sc=None, **kw):
    eng = ServeEngine(model, state_cache=sc, **dict(PREFIX_KW, **kw))
    for p in prompts:
        eng.submit(p, 8, prefix_len=64)
    n0 = kconv.LAUNCHES
    outs = eng.run()
    torch.cuda.synchronize()
    assert kconv.LAUNCHES - n0 == model.cfg.n_layers * (
        eng.stats.prefills + eng.stats.chunk_rounds)
    return outs, eng


def test_prefix_hit_is_the_cold_prefill_bitwise(cuda):
    """On the card, bf16: a warm run (the prefix stored by the first
    request, restored by the others through pinned memory) and a rerun
    (whole-prompt hits, no forward) give the cold run's streams bit for
    bit; the rerun launches no #1."""
    from repro_torch.launch.state_cache import StateCache
    model = _cache_model(cuda)
    prompts = _prefix_prompts(model.cfg.vocab)
    cold, _ = _prefix_run(model, prompts)
    sc = StateCache(1 << 26)
    warm, weng = _prefix_run(model, prompts, sc)
    assert warm == cold and weng.stats.prefills == 0
    assert sc.hits == len(prompts) - 1
    entry = sc.lookup(prompts[0][:64])
    assert all(t.is_pinned() for t in entry.state.values())
    assert entry.logits.is_pinned()
    rerun, reng = _prefix_run(model, prompts, sc)
    assert rerun == cold
    assert reng.stats.prefills == reng.stats.chunk_rounds == 0


def test_packed_harvest_seeds_a_chunk_row_on_the_card(cuda):
    """Cross-lane on the card (f32): a prompt that lands through the packed
    lane is stored whole and seeds the chunk row of a longer prompt that
    extends it; its stored conv tail matches the chunk lane's carried tail
    for the same prompt, and the longer prompt's stream is the cold one.
    A 2-token declared prefix stores zeros in front of its tail."""
    from repro_torch.launch.state_cache import StateCache
    model = _cache_model(cuda, "float32")
    rng = np.random.default_rng(17)
    a = rng.integers(1, 512, size=9)
    b = np.concatenate([a, rng.integers(1, 512, size=30)])
    sc = StateCache(1 << 24)
    eng = ServeEngine(model, state_cache=sc, **PREFIX_KW)
    eng.submit(a, 6)
    eng.run()
    rb = eng.submit(b, 6)
    out = eng.run()
    assert sc.hits == 1 and eng.stats.chunk_tokens == 30
    cold = ServeEngine(model, **PREFIX_KW)
    cb = cold.submit(b, 6)
    assert out[rb] == cold.run()[cb]
    chunk = model.init_cache(1)
    model.prefill_chunk(chunk, {"tokens": a[None].astype(np.int32),
                                "positions": np.arange(9)[None],
                                "segment_ids": np.ones((1, 9), np.int32)},
                        np.zeros(1, np.int32))
    stored = sc.lookup(a).state
    for k in ("conv", "ssm"):
        torch.testing.assert_close(stored[k], chunk[k].cpu(), atol=1e-4,
                                   rtol=1e-4)
    short = [np.concatenate([a[:2], rng.integers(1, 512, size=n)])
             for n in (6, 11)]
    sc2 = StateCache(1 << 24)
    eng = ServeEngine(model, state_cache=sc2, **PREFIX_KW)
    for p in short:
        eng.submit(p, 6, prefix_len=2)
    got = eng.run()
    ref = ServeEngine(model, **PREFIX_KW)
    for p in short:
        ref.submit(p, 6)
    assert got == ref.run()
    conv = sc2.lookup(a[:2]).state["conv"]
    W = model.cfg.d_conv
    assert conv[:, :, :W - 3].abs().max() == 0
    assert conv[:, :, W - 3:].abs().min() > 0


def test_eviction_right_behind_a_hit(cuda):
    """A partial hit's copy to the card reads the entry's pinned memory
    while it is still queued behind other work (a ~0.1 s spin on the
    stream). Right behind it, before the stream syncs, the cache is
    cleared and new pinned buffers of the entry's sizes are filled with
    NaN (what a reused block would hold). The engine holds the entry until
    its stream syncs: every stream is still the cold run's."""
    import gc
    from repro_torch.launch.state_cache import StateCache
    model = _cache_model(cuda)
    sc = StateCache(1 << 26)
    _prefix_run(model, _prefix_prompts(model.cfg.vocab), sc)  # stores it
    prompts = _prefix_prompts(model.cfg.vocab, seed=14)
    prompts = [np.concatenate([_prefix_prompts(model.cfg.vocab)[0][:64],
                               p[64:]]) for p in prompts]
    cold, _ = _prefix_run(model, prompts)
    real = StateCache.device_state
    queued, junk = [], []

    def behind(entry, device):
        if not queued:
            torch.cuda._sleep(200_000_000)
            queued.append([(t.shape, t.dtype) for t in
                           list(entry.state.values()) + [entry.logits]])
        return real(entry, device)

    eng = ServeEngine(model, state_cache=sc, **PREFIX_KW)
    refill = eng._try_refill

    def try_refill():
        if queued and not junk:
            sc.clear()
            gc.collect()
            for shape, dtype in queued[0] * 4:
                junk.append(torch.full(shape, float("nan"), dtype=dtype,
                                       pin_memory=True))
        return refill()

    eng._try_refill = try_refill
    for p in prompts:
        eng.submit(p, 8, prefix_len=64)
    StateCache.device_state = staticmethod(behind)
    try:
        got = eng.run()
    finally:
        StateCache.device_state = staticmethod(real)
    assert queued and junk and sc.evictions >= 1
    assert got == cold and eng.stats.quarantined == 0


def test_spec_is_plain_bitwise_with_overlap_and_a_prefill_in_flight(cuda):
    """Speculative decode (K 3) on the card, overlap on with prefills in
    flight on the side stream while verify rounds run: every stream is the
    plain engine's bit for bit, with the n-gram drafts and with drafts
    taken from the plain run's streams (every odd request's second draft
    token changed), so rounds accept whole drafts, accept a prefix and roll
    back, and reject. Slots outnumber requests, so both runs pack the same
    rounds."""
    model = _cache_model(cuda)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 512, size=n) for n in (6, 13, 9, 25)]
    prompts += [np.tile(rng.integers(1, 512, size=n), 3) for n in (4, 7, 9)]

    def run(k, oracle=None):
        eng = ServeEngine(model, num_slots=12, max_len=96, buckets=(16, 32),
                          max_segments=2, overlap=True,
                          max_inflight_prefills=2, spec_k=k)
        in_flight = []
        verify = eng._spec_round

        def spec_round(active, step_idx):
            in_flight.append(bool(eng._prefill_pool))
            return verify(active, step_idx)

        def drafts():
            d = np.zeros((eng.num_slots, k), np.int32)
            for i in eng._active_slots():
                rid = eng.slot_req[i].rid
                nxt = oracle[rid][len(eng.outputs[rid]):][:k]
                d[i, :len(nxt)] = nxt
                if rid % 2 and k > 1:
                    d[i, 1] = (d[i, 1] + 1) % 512
            return d, np.ones(eng.num_slots, bool)

        eng._spec_round = spec_round
        if oracle is not None:
            eng._spec_draft = drafts
        for p in prompts:
            eng.submit(p, 20)
        outs = eng.run()
        return outs, eng, in_flight

    plain, _, _ = run(0)
    for oracle in (None, plain):
        got, eng, in_flight = run(3, oracle)
        assert got == plain
        assert eng._spec_rounds.value > 0 and any(in_flight)
        assert eng.stats.overlapped_prefills > 0
    rate = eng.spec_accept_rate
    assert 0.3 < rate < 1.0, rate


def _card_step_and_its_dry_run(cfg, kind, knobs=None):
    """One step of ``cfg``'s ``kind`` cell on the card at (2, 512), counted
    by ``roofline/counter.py``, held to its meta dry run: FLOPs by unit,
    bytes and traffic by op equal exactly, the kernel tally equal to the
    launch counters. Returns the tally."""
    from repro_torch.launch import shapes
    from repro_torch.roofline.counter import count_call
    Bz, L = 2, 512
    meta = shapes.make_cell(cfg, kind, Bz, L, "meta", knobs)
    _, want = count_call(meta.fn, *meta.args, device="meta")
    cell = shapes.make_cell(cfg, kind, Bz, L, "cuda", knobs)
    cell.model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    if kind == "decode":
        cell.args[1].copy_(torch.as_tensor(rng.integers(1, cfg.vocab,
                                                        (Bz, 1))))
    else:
        batch = cell.args[-1]
        pos = _positions(Bz, L, 0)
        batch["positions"].copy_(torch.as_tensor(pos))
        batch["segment_ids"].copy_(torch.as_tensor(
            np.cumsum(pos == 0, axis=1) + 1))
        batch["tokens"].copy_(torch.as_tensor(rng.integers(1, cfg.vocab,
                                                           (Bz, L))))
    tops.zero_launches()
    out, got = count_call(cell.fn, *cell.args, device="cuda")
    torch.cuda.synchronize()
    launched = tops.read_launches()
    for k in ("flops", "flops_by_unit", "bytes", "traffic_by_op",
              "kernels"):
        assert got[k] == want[k], k
    assert {k: v for k, v in launched.items() if v} == got["kernels"]
    if kind == "train":
        assert torch.isfinite(out[1]["loss"]).item()
    return got["kernels"]


@pytest.mark.parametrize("arch,schedule,kind", [
    ("mamba-110m", "blocked", "train"), ("mamba-110m", "step", "train"),
    ("mamba2-370m", None, "train"), ("mamba-110m", "blocked", "prefill"),
    ("mamba2-370m", None, "decode")])
def test_counted_card_step_equals_its_meta_dry_run(cuda, arch, schedule,
                                                   kind):
    """One step on the card at a reduced width, bf16 (the cells' dtype),
    counted by ``roofline/counter.py``: FLOPs by unit, bytes and traffic
    by op equal the meta dry run's exactly, and the kernel tally equals
    the launch counters."""
    cfg = get_config(arch).reduced()
    if schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
    _card_step_and_its_dry_run(cfg, kind)


def test_counted_card_step_with_a_tuning_winner(cuda):
    """A train cell given a winner's knobs (``step``, where the config says
    ``blocked``) launches the winner's kernels on the card and counts as
    its meta dry run."""
    cfg = get_config("mamba-110m").reduced()
    tally = _card_step_and_its_dry_run(cfg, "train", {
        "backend": "pallas", "schedule": "step", "pchunk": 64})
    n = cfg.n_layers
    assert tally == {"conv1d_pack_fwd": 2 * n, "conv1d_pack_bwd_dx": n,
                     "selective_scan_fwd_step": 2 * n,
                     "selective_scan_bwd_step": n}


# ---------------------------------------------------------------------------
# xLSTM (xlstm-125m's mLSTM layers run #1)
# ---------------------------------------------------------------------------

def _conv_fwd_at_serving_shape(cuda, shape, dtype):
    """#1 at a packed prefill's rows (Bz 2: packed, one carried) or a chunk
    slab (Bz 1: the carried tail at three leading zero positions, then
    global positions 512..), on a contiguous input: the plain version's
    output within one rounding of the dtype, and twice bitwise equal."""
    tdt = getattr(torch, dtype)
    Bz, L, D = shape
    rng = np.random.default_rng(L)
    f = dict(device=cuda, dtype=tdt)
    x = torch.as_tensor(rng.normal(size=shape)).to(**f)
    w = torch.as_tensor(rng.normal(size=(4, D)) * 0.5).to(**f)
    b = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    if Bz == 2:
        pos = _positions(Bz, L, L)
    else:
        pos = np.zeros((Bz, L), np.int32)
        pos[:, 3:] = np.arange(512, 512 + L - 3)
    pos = torch.as_tensor(pos, device=cuda)
    assert kconv.vector_path(x, w, b, strides=x.stride()[:2], D=D)
    y, again = (kconv.conv1d_pack(x, w, b, pos) for _ in range(2))
    want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    torch.testing.assert_close(
        y.float(), want, atol=1e-5,
        rtol=1e-5 if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 1536), (1, 259, 1536)])
def test_conv_fwd_kernel_at_the_xlstm_shapes(cuda, shape, dtype):
    """#1 at xlstm-125m's packed prefill (2, 256, 1536) and chunk slab (1,
    259, 1536), on the mLSTM's contiguous up-projection
    (``_conv_fwd_at_serving_shape``)."""
    _conv_fwd_at_serving_shape(cuda, shape, dtype)


def test_xlstm_engine_streams_cold_equal_warm(cuda):
    """xlstm-125m.reduced() in bf16 on the card behind a 64-token shared
    prompt: a warm run (the prefix stored by the first request, restored
    by the others) and a rerun (whole-prompt hits, no forward) give the
    cold run's streams bit for bit; #1 runs once per mLSTM layer (10 of
    the 12) and forward."""
    from repro_torch.launch.state_cache import StateCache
    cfg = dataclasses.replace(get_config("xlstm-125m").reduced(),
                              dtype="bfloat16")
    model = LM(cfg, cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    mlstm_layers = sum(k == "mlstm" for k in model.kinds)
    assert mlstm_layers == 10
    prompts = _prefix_prompts(cfg.vocab)

    def run(sc):
        eng = ServeEngine(model, state_cache=sc, **PREFIX_KW)
        for p in prompts:
            eng.submit(p, 8, prefix_len=64)
        n0 = kconv.LAUNCHES
        outs = eng.run()
        torch.cuda.synchronize()
        assert kconv.LAUNCHES - n0 == mlstm_layers * (
            eng.stats.prefills + eng.stats.chunk_rounds)
        return outs, eng

    cold, _ = run(None)
    sc = StateCache(1 << 26)
    warm, weng = run(sc)
    assert warm == cold and weng.stats.prefills == 0
    assert sc.hits == len(prompts) - 1
    rerun, reng = run(sc)
    assert rerun == cold
    assert reng.stats.prefills == reng.stats.chunk_rounds == 0


# ---------------------------------------------------------------------------
# xLSTM training (#1 forward and recompute, #2 backward in its mLSTM layers)
# ---------------------------------------------------------------------------

XLSTM_TRAIN_SHAPE = (2, 4096, 1536)     # xlstm-125m's training step


def _conv_kernels_at(cuda, shape, kernel, dtype):
    """#1 or #2 at ``shape`` on packed rows (one carried): the plain
    version's output within one bf16 rounding (#1; 1e-5 in f32) or 1e-5 ·
    (1 + |ref|) (#2, f32 on both sides), and twice bitwise equal."""
    Bz, L, D = shape
    rng = np.random.default_rng(L)
    f = dict(device=cuda, dtype=dtype)
    x = torch.as_tensor(rng.normal(size=shape)).to(**f)
    w = torch.as_tensor(rng.normal(size=(4, D)) * 0.5).to(**f)
    b = torch.as_tensor(rng.normal(size=(D,))).to(**f)
    pos = torch.as_tensor(_positions(Bz, L, L), device=cuda)
    if kernel == "fwd":
        out, again = (kconv.conv1d_pack(x, w, b, pos) for _ in range(2))
        want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
        tol = dict(atol=1e-5, rtol=2.0 ** -8 if dtype == torch.bfloat16
                   else 1e-5)
    else:
        out, again = (kconv.conv1d_pack_bwd_dx(x, w, pos) for _ in range(2))
        want = kconv.conv1d_pack_bwd_dx_plain(x, w, pos)
        tol = dict(atol=1e-5, rtol=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), want, **tol)


@pytest.mark.parametrize("kernel", ["fwd", "dx"])
def test_conv_kernels_at_the_xlstm_training_shape(cuda, kernel):
    """#1 and #2 at xlstm-125m's training shape (2, 4096, 1536) in bf16
    (``_conv_kernels_at``)."""
    _conv_kernels_at(cuda, XLSTM_TRAIN_SHAPE, kernel, torch.bfloat16)


def _train_parity(cuda, monkeypatch, cfg, seq, want):
    """``cfg`` in f32 at 2 × ``seq`` with resets and a carried row: the
    loss within 1e-5 and every gradient leaf within 1e-3 · max |ref|
    (chip_smoke.py's ``TRAIN_PARITY_TOL``) of the plain path's (autograd
    through the plain conv), the kernel path's launches exactly ``want``,
    the plain path's none."""
    import types

    from repro_torch.core import conv as core_conv
    model = LM(cfg, cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(9)
    pos = _positions(2, seq, 9)
    batch = {"tokens": rng.integers(1, cfg.vocab, (2, seq)).astype(np.int32),
             "positions": pos,
             "segment_ids": (np.cumsum(pos == 0, axis=1) + 1).astype(
                 np.int32)}
    params = dict(model.named_parameters())

    def loss_and_grads():
        tops.zero_launches()
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return loss.item(), dict(zip(params, grads)), {
            k: v for k, v in tops.read_launches().items() if v}

    k_loss, k_grads, k_ran = loss_and_grads()
    assert k_ran == want
    monkeypatch.setattr(B, "kops", types.SimpleNamespace(
        conv1d_pack=core_conv.conv1d_pack))
    p_loss, p_grads, p_ran = loss_and_grads()
    assert p_ran == {}
    assert abs(k_loss - p_loss) <= 1e-5 * abs(p_loss)
    for k, ref in p_grads.items():
        assert torch.isfinite(k_grads[k]).all(), k
        err = (k_grads[k] - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item(), (k, err)


def test_xlstm_train_step_kernels_against_the_plain_path(cuda, monkeypatch):
    """xlstm-125m.reduced() (12 layers: 10 mLSTM, 2 sLSTM) in f32 at 2 × 256
    (``_train_parity``): #1 launched exactly 20 times (forward and
    ``remat`` recompute) and #2 10, nothing else."""
    _train_parity(cuda, monkeypatch, get_config("xlstm-125m").reduced(), 256,
                  {"conv1d_pack_fwd": 20, "conv1d_pack_bwd_dx": 10})


# ---------------------------------------------------------------------------
# hybrid training (#1 forward and recompute, #2 backward in its RG-LRU
# layers)
# ---------------------------------------------------------------------------

HYBRID_TRAIN_SHAPE = (2, 4096, 2560)    # recurrentgemma-2b's training step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fwd", "dx"])
def test_conv_kernels_at_the_hybrid_training_shape(cuda, kernel, dtype):
    """#1 and #2 at recurrentgemma-2b's training shape (2, 4096, 2560)
    (``_conv_kernels_at``)."""
    _conv_kernels_at(cuda, HYBRID_TRAIN_SHAPE, kernel, dtype)


def test_hybrid_unit_train_step_kernels_against_the_plain_path(
        cuda, monkeypatch):
    """One whole unit of recurrentgemma-2b (rec, rec, attn, each with its
    GeGLU MLP) at full width, f32 at 2 × 256 (``_train_parity``): #1
    launched exactly 4 times (2 RG-LRU layers, forward and recompute) and
    #2 2, nothing else."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=3,
                              dtype="float32")
    _train_parity(cuda, monkeypatch, cfg, 256,
                  {"conv1d_pack_fwd": 4, "conv1d_pack_bwd_dx": 2})



# ---------------------------------------------------------------------------
# hybrid serving (#1 in its RG-LRU layers' packed prefills and chunk slabs;
# the attention's K/V ring)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 2560), (1, 259, 2560)])
def test_conv_fwd_kernel_at_the_hybrid_serving_shapes(cuda, shape, dtype):
    """#1 at recurrentgemma-2b's packed prefill (2, 256, 2560) and chunk
    slab (1, 259, 2560) (``_conv_fwd_at_serving_shape``)."""
    _conv_fwd_at_serving_shape(cuda, shape, dtype)


def test_hybrid_packed_prefill_equals_per_prompt(cuda):
    """Two units of recurrentgemma-2b (rec, rec, attn, each with its GeGLU
    MLP) at full width in f32: a packed prefill's end logits and every
    state leaf (the K/V rings too) against each prompt's own ``prefill``
    within 1e-5 of max(1, max |ref|), the CPU tests' bar; #1 once per
    RG-LRU layer and forward."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=6,
                              dtype="float32")
    model = LM(cfg, cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (37, 90, 18, 61)]
    pb = tpk.pack(prompts, 128, policy="first_fit", num_rows=2)
    ends = tpk.segment_ends(pb, 4)
    n0 = kconv.LAUNCHES
    logits, states, _ = model.prefill_packed(
        {"tokens": pb.tokens, "positions": pb.positions,
         "segment_ids": pb.segment_ids}, ends, 128)
    torch.cuda.synchronize()
    assert kconv.LAUNCHES - n0 == 4
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            n = len(prompts[i])
            lg, cache, _ = model.prefill(
                {"tokens": prompts[i][None],
                 "positions": np.arange(n, dtype=np.int32)[None],
                 "segment_ids": np.ones((1, n), np.int32)}, 128)
            pairs = [(logits[r, s], lg[0])] + [
                (v[:, r, s], cache[k][:, 0]) for k, v in states.items()]
            for got, ref in pairs:
                err = (got - ref).abs().max().item()
                assert err <= 1e-5 * max(1.0, ref.abs().max().item())


def test_hybrid_engine_wraps_the_ring(cuda):
    """recurrentgemma-2b.reduced() (two units and the tail) with the
    window at 8, f32 on the card: a 37-token prompt through the chunk
    lane in slabs of 8 and short prompts through the packed lane wrap
    every slot's 8-slot ring; each stream equals the request's greedy
    ``prefill`` + ``decode_step`` alone, and #1 runs once per RG-LRU layer
    and forward."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              n_layers=8, attn_window=8)
    model = LM(cfg, cuda)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 12, 30, 9, 37, 17)]
    eng = ServeEngine(model, num_slots=4, max_len=96, prefill_rows=2,
                      buckets=(16, 32), max_segments=2, chunk_size=8)
    for p in prompts:
        eng.submit(p, 6)
    n0 = kconv.LAUNCHES
    outs = eng.run()
    torch.cuda.synchronize()
    assert eng.stats.chunk_rounds == 5
    assert kconv.LAUNCHES - n0 == 6 * (eng.stats.prefills
                                       + eng.stats.chunk_rounds)
    for rid, p in enumerate(prompts):
        lg, cache, clen = model.prefill(
            {"tokens": p[None], "positions": np.arange(
                len(p), dtype=np.int32)[None],
             "segment_ids": np.ones((1, len(p)), np.int32)}, 96)
        ref = []
        for _ in range(6):
            ref.append(int(torch.argmax(lg[0])))
            lg, cache = model.decode_step(
                cache, torch.tensor([[ref[-1]]], dtype=torch.int32,
                                    device=cuda), cache_len=clen)
            clen = clen + 1
        assert outs[rid] == ref, rid


# ---------------------------------------------------------------------------
# the dense family (full causal attention on a max_len K/V cache, a gated
# MLP every layer: plain PyTorch, no kernel of the port's own)
# ---------------------------------------------------------------------------

def _dense_pair(cuda):
    """stablelm-1.6b.reduced() (2 layers, GQA 4 on 2, f32) with the same
    weights on the card and on the CPU."""
    cfg = get_config("stablelm-1.6b").reduced()
    cpu = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, card, cpu


def _dense_close(got, ref):
    got, ref = got.detach().cpu().double(), ref.detach().double()
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= \
        1e-4 * max(1.0, ref.abs().max().item())


def test_dense_lm_on_the_card_equals_the_cpu(cuda):
    """A reduced dense LM's packed prefill, per-row prefill, 12 decode
    steps and 3 chunk slabs on the card against the same model on the
    CPU, f32: logits and every K/V leaf within 1e-4 of max(1, max |ref|);
    no launch counter moves."""
    cfg, card, cpu = _dense_pair(cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (11, 20, 5, 9, 14, 3)]
    pb = tpk.pack(prompts, 32, policy="first_fit", num_rows=2)
    ends = tpk.segment_ends(pb, 4)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    tops.zero_launches()
    outs = [m.prefill_packed(batch, ends, 64) for m in (card, cpu)]
    _dense_close(outs[0][0], outs[1][0])
    for k in outs[1][1]:
        _dense_close(outs[0][1][k], outs[1][1][k])
    rows = {"tokens": np.zeros((2, 20), np.int32),
            "positions": np.tile(np.arange(20, dtype=np.int32), (2, 1)),
            "segment_ids": np.zeros((2, 20), np.int32)}
    for r, p in enumerate(prompts[:2]):
        rows["tokens"][r, :len(p)] = p
        rows["segment_ids"][r, :len(p)] = 1
    (lg, cache, clen), (rlg, rcache, rclen) = (m.prefill(rows, 64)
                                               for m in (card, cpu))
    _dense_close(lg, rlg)
    for step in range(12):
        tok = torch.argmax(rlg, -1).to(torch.int32)[:, None]
        lg, cache = card.decode_step(cache, tok.to(cuda),
                                     cache_len=clen)
        rlg, rcache = cpu.decode_step(rcache, tok, cache_len=rclen)
        _dense_close(lg, rlg)
        clen, rclen = clen + 1, rclen + 1
    for k in rcache:
        _dense_close(cache[k], rcache[k])
    caches = [m.init_cache(2, 64) for m in (card, cpu)]
    clens = [torch.zeros(2, dtype=torch.int32, device=d)
             for d in (cuda, "cpu")]
    for off in (0, 6, 12):
        entries = {i: (p, off, max(0, min(6, len(p) - off)))
                   for i, p in enumerate(prompts[:2])}
        slab = tpk.suffix_slab(entries, 2, 6)
        got = [m.prefill_chunk(c, slab, n)
               for m, c, n in zip((card, cpu), caches, clens)]
        _dense_close(got[0][0], got[1][0])
        clens = [got[0][2], got[1][2]]
    for k in caches[1]:
        _dense_close(caches[0][k], caches[1][k])
    torch.cuda.synchronize()
    assert not any(tops.read_launches().values())


def test_dense_engine_streams_on_the_card(cuda):
    """The engine on the card (4 slots of 96, a 37-token prompt through
    the chunk lane in slabs of 8): each greedy stream equals the request's
    own ``prefill`` + ``decode_step`` on the card, bitwise, and no launch
    counter moves."""
    cfg, card, _ = _dense_pair(cuda)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 12, 30, 9, 37, 17)]
    eng = ServeEngine(card, num_slots=4, max_len=96, prefill_rows=2,
                      buckets=(16, 32), max_segments=2, chunk_size=8)
    for p in prompts:
        eng.submit(p, 6)
    tops.zero_launches()
    outs = eng.run()
    torch.cuda.synchronize()
    assert not any(tops.read_launches().values())
    assert eng.stats.chunk_rounds == 5
    for rid, p in enumerate(prompts):
        lg, cache, clen = card.prefill(
            {"tokens": p[None], "positions": np.arange(
                len(p), dtype=np.int32)[None],
             "segment_ids": np.ones((1, len(p)), np.int32)}, 96)
        ref = []
        for _ in range(6):
            ref.append(int(torch.argmax(lg[0])))
            lg, cache = card.decode_step(
                cache, torch.tensor([[ref[-1]]], dtype=torch.int32,
                                    device=cuda), cache_len=clen)
            clen = clen + 1
        assert outs[rid] == ref, rid


def test_dense_stablelm_row_bytes_on_the_card(cuda):
    """stablelm-1.6b at full width and depth, bf16: one slot's cache at
    max_len 2560 on the card is every layer's K and V, 24 × 2 × 2560 × 32
    × 64 × 2 bytes = 480 MiB."""
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              param_dtype="bfloat16")
    model = LM(cfg, cuda)
    row = model.init_cache(1, 2560)
    assert sorted(row) == ["0_attn.k", "0_attn.v"]
    assert all(t.device.type == "cuda" and t.dtype == torch.bfloat16
               for t in row.values())
    nbytes = sum(t.numel() * t.element_size() for t in row.values())
    assert nbytes == cfg.n_layers * 2 * 2560 * cfg.n_kv_heads * cfg.hd * 2
    assert nbytes == 480 * 2 ** 20
