"""The conv kernels' run-by-run arithmetic on the CPU: #1's and #2's twins
(``runs_plain``, ``dx_runs_plain`` below: a run of rows a thread, the W-1
halo rows before the run for #1 and after it for #2, taken only inside the
buffer) against the JAX package's
``conv1d_pack_fwd_pallas`` / ``conv1d_pack_bwd_dx_pallas`` in interpret
mode (through ``repro.kernels.ops.conv1d_pack(..., backend="pallas")`` and
``jax.vjp``), and against the port's plain versions exactly: the same sums
in the same order, whatever the run.

The Pallas kernels need W ≥ 2 (their halo is a slice of W-1 rows) and a
chunk of at least W-1 rows, so W = 1 is held against the JAX package's
XLA path instead (in f32 on the same values: that path computes in x's
dtype and would round bf16 twice), and the reference sees L = 1 padded after its end to 8
rows (exact: the forward is causal, and dy = 0 there adds nothing to dx).

Cases: runs 1, 4, 16, 64 and one longer than L; W 1-4; resets on a run's
first row and within W-1 rows of a run edge; a carried row (first position
> 0); L 997, L < run and L = 1; D 3 and 100; f32 and bf16.

Tolerances, as ``tests/test_torch_conv.py`` and ``test_torch_conv_bwd.py``:
f32 1e-5 (the same taps summed in another order); bf16 within one bf16
rounding (2^-8 relative) of the f32-accumulated result on the same bf16
inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import packing as tpk  # noqa: E402
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

# (B, L, D, W): L 997, L shorter than the 64-row run, L = 1
CASES = [(2, 997, 100, 4), (2, 997, 3, 3), (2, 45, 100, 2), (2, 1, 3, 4),
         (2, 130, 3, 1)]
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _runs(L):
    return (1, 4, 16, 64, L + 5)


def _run_rows(L, run):
    """Run starts (nR, 1) and the rows of each run (nR, run)."""
    t0 = torch.arange(0, L, run)[:, None]
    return t0, t0 + torch.arange(run)[None]


def runs_plain(x, weight, bias, positions, run):
    """#1's arithmetic as the kernel walks it: each run of ``run`` rows
    with the W-1 rows before it as its halo, a halo row taken only where
    t0-j ≥ 0 (zero before the buffer), the taps masked by t-k ≥ 0 and
    pos[t] ≥ k, bias first and the taps in k order in f32."""
    B, L, D = x.shape
    W = weight.shape[0]
    t0, t = _run_rows(L, run)
    nR = t0.shape[0]
    x32, w32 = x.float(), weight.float()
    xp = x32.new_zeros((B, W - 1 + nR * run, D))     # halo of run 0: zero
    xp[:, W - 1:W - 1 + L] = x32
    window = xp[:, t0 + torch.arange(W - 1 + run)[None]]  # (B, nR, W-1+run, D)
    pp = positions.new_zeros((B, nR * run))
    pp[:, :L] = positions
    pp = pp.view(B, nR, run)
    acc = bias.float().expand(B, nR, run, D)
    for k in range(W):
        seg = window[:, :, W - 1 - k:W - 1 - k + run]
        if k > 0:
            ok = (t - k >= 0)[None] & (pp >= k)
            seg = torch.where(ok[..., None], seg, 0.0)
        acc = acc + w32[W - 1 - k] * seg
    return acc.reshape(B, nR * run, D)[:, :L].to(x.dtype)


def dx_runs_plain(dy, weight, positions, run):
    """#2's arithmetic as the kernel walks it: each run of ``run`` rows
    with the W-1 rows after it as its halo, a row taken only where t+k < L,
    the taps masked by t+k < L and pos[t+k] ≥ k, in k order in f32."""
    B, L, D = dy.shape
    W = weight.shape[0]
    t0, _ = _run_rows(L, run)
    nR = t0.shape[0]
    dy32, w32 = dy.float(), weight.float()
    rows = t0 + torch.arange(run + W - 1)[None]      # (nR, run+W-1)
    inside = rows < L
    rows = rows.clamp(max=L - 1)
    window = torch.where(inside[None, ..., None], dy32[:, rows], 0.0)
    pw = positions[:, rows]                          # (B, nR, run+W-1)
    acc = dy32.new_zeros((B, nR, run, D))
    for k in range(W):
        ok = inside[None, :, k:k + run] & (pw[:, :, k:k + run] >= k)
        seg = torch.where(ok[..., None], window[:, :, k:k + run], 0.0)
        acc = acc + w32[W - 1 - k] * seg
    return acc.reshape(B, nR * run, D)[:, :L]


def _positions(Bz, L, seed):
    """Row 0: a reset near every 16th row, on it (a run's first row for
    runs 1, 4 and 16) or 1 before, 1 or 2 after it (within W-1 rows of a
    run edge). Row 1: a carried row of a split pack (first position > 0)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((Bz, L), np.int32)
    starts = sorted({0} | {e + (0, 1, -1, 2)[(e // 16) % 4]
                           for e in range(16, L, 16) if e + 2 < L})
    for a, b in zip(starts, starts[1:] + [L]):
        pos[0, a:b] = np.arange(b - a)
    if L == 1:
        pos[1] = 7
    else:
        sp = tpk.pack_with_split(
            [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L)
        pos[1] = sp.positions[1]
    assert pos[1, 0] > 0
    return pos


def _inputs(Bz, L, Dm, W, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((Bz, L, Dm), (W, Dm), (Dm,), (Bz, L, Dm))]
    if dtype == "bfloat16":    # the same bf16 values on both sides
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return (*arrs, _positions(Bz, L, seed))


def _jax_conv(x, w, b, pos, jdt):
    """The JAX package's conv1d_pack (the Pallas kernel in interpret mode;
    the XLA path in f32 for W = 1) on inputs padded after L to at least 8
    rows."""
    L = x.shape[1]
    jdt = jnp.float32 if w.shape[0] == 1 else jdt
    pad = max(8 - L, 0)
    xj = jnp.pad(jnp.asarray(x, jdt), ((0, 0), (0, pad), (0, 0)))
    pj = jnp.pad(jnp.asarray(pos), ((0, 0), (0, pad)), constant_values=1)
    kw = (dict(backend="xla") if w.shape[0] == 1 else
          dict(backend="pallas", block_d=128, chunk=256))
    fn = lambda x_: jops.conv1d_pack(x_, jnp.asarray(w, jdt),
                                     jnp.asarray(b, jdt), pj, **kw)
    return fn, xj, pad


def _close(got, want32, dtype):
    got = got.float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want32 = want32.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(got - want32)
        assert (err <= 2.0 ** -8 * np.abs(want32) + 1e-6).all(), err.max()


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    before = (kconv.LAUNCHES, kconv.LAUNCHES_DX)
    yield
    assert (kconv.LAUNCHES, kconv.LAUNCHES_DX) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,L,Dm,W", CASES)
def test_forward_runs_match_pallas_and_plain(Bz, L, Dm, W, dtype):
    x, w, b, _, pos = _inputs(Bz, L, Dm, W, dtype, L + W)
    tdt, jdt = DT[dtype]
    fn, xj, _ = _jax_conv(x, w, b, pos, jdt)
    want = fn(xj)[:, :L]
    xt, wt, bt = (torch.as_tensor(a).to(tdt) for a in (x, w, b))
    pt = torch.as_tensor(pos)
    plain = kconv.conv1d_pack_plain(xt, wt, bt, pt)
    want32 = kconv.conv1d_pack_plain(xt.float(), wt.float(), bt.float(), pt)
    _close(want, want32, dtype)
    for run in _runs(L):
        got = runs_plain(xt, wt, bt, pt, run)
        assert got.dtype == tdt and torch.equal(got, plain), run
        _close(got, want32, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,L,Dm,W", CASES)
def test_dx_runs_match_pallas_and_plain(Bz, L, Dm, W, dtype):
    x, w, b, dy, pos = _inputs(Bz, L, Dm, W, dtype, 3 * L + W)
    tdt, jdt = DT[dtype]
    fn, xj, pad = _jax_conv(x, w, b, pos, jdt)
    _, vjp = jax.vjp(fn, xj)
    (want,) = vjp(jnp.pad(jnp.asarray(dy, xj.dtype),
                          ((0, 0), (0, pad), (0, 0))))
    want = want[:, :L]
    dyt, wt = torch.as_tensor(dy).to(tdt), torch.as_tensor(w).to(tdt)
    pt = torch.as_tensor(pos)
    plain = kconv.conv1d_pack_bwd_dx_plain(dyt, wt, pt)
    _close(want, plain, dtype)
    for run in _runs(L):
        got = dx_runs_plain(dyt, wt, pt, run)
        assert got.dtype == torch.float32 and torch.equal(got, plain), run
        _close(got, plain, dtype)


@pytest.mark.parametrize("kind", ["fwd", "bwd_dx"])
def test_run_rule_fills_the_card_at_every_shape(kind):
    """``conv_params`` on a 132-SM card: the training shapes of the three
    models take RUN_MAX[kind] rows a thread; every serving bucket at D 4096
    still puts MIN_BLOCKS_PER_SM blocks on every SM, with the longest run
    that does."""
    sms, run_max = 132, kconv.RUN_MAX[kind]
    for shape in ((2, 4096, 4096), (2, 4096, 5120), (8, 4096, 2048)):
        for dt in (torch.bfloat16, torch.float32):
            lp = kconv.conv_params(*shape, dt, kind, sms=sms)
            assert lp["run"] == run_max, (shape, lp)
    for L in (64, 128, 256):
        lp = kconv.conv_params(2, L, 4096, torch.bfloat16, kind, sms=sms)
        assert lp["blocks"] >= kconv.MIN_BLOCKS_PER_SM * sms, (L, lp)
        assert kconv.conv_params(2, L, 4096, torch.bfloat16, kind,
                                 sms=1)["run"] == run_max
        if lp["run"] < run_max:           # twice the run falls short
            cb = -(-4096 // (lp["width"] * lp["threads"]))
            assert 2 * cb * -(-L // (2 * lp["run"])) < \
                kconv.MIN_BLOCKS_PER_SM * sms
