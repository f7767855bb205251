"""Port parity: ``repro_torch.tune`` (the shape-keyed scan autotuner)
against ``repro.tune`` on the same inputs, and its threading through the
port's scans, models and launchers.

Covers: shape keys and buckets (torch dtypes against the JAX names); the
plain candidate spaces and names at every ``fig2`` key and L 16–8192; the
port's own kernel candidates, each accepted by the kernels' argument
checks; cache lookup (exact, nearest, bounded, never across objectives),
``_distance``, stale quarantine of a JAX-fingerprinted file; the timing
protocol under a fake clock; the sweep's operands, and each plain
candidate's output and "fwdbwd" gradients; resolution through
``kernels/ops.py`` (a plain winner as the JAX wrapper resolves it, a kernel
winner's schedule and chunk reaching the backward); ``scan_tune="off"``
never consulting the tuner; one uncached lookup per key; and the launcher
and engine on the CPU.

Tolerances: outputs 1e-5, gradients 1e-4 atol / 1e-3 rtol (the reference
tests'); operands and keys exactly.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.tune import cache as jcache  # noqa: E402
from repro.tune import runner as jrunner  # noqa: E402
from repro.tune import space as jspace  # noqa: E402
from repro_torch import tune as ttune  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import selective_scan as ksc  # noqa: E402
from repro_torch.kernels import selective_scan_heads as kh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import runner as trunner  # noqa: E402
from repro_torch.tune import space as tspace  # noqa: E402
from repro_torch.tune.timing import interleaved_min_of_rounds  # noqa: E402

FP_JAX = {"schema": 1, "device_kind": "cpu", "platform": "cpu", "jax": "1"}
FP_A = {"schema": 1, "device_kind": "cpu", "platform": "cpu",
        "torch": "1", "cuda": "None"}
ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _fresh_registries():
    tcache.reset_caches()
    jcache.reset_caches()
    yield
    tcache.reset_caches()
    jcache.reset_caches()


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# keys, buckets, spaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 15, 16, 17, 100, 256, 300, 4096, 4097])
def test_l_bucket_matches_jax(L):
    assert tspace.l_bucket(L) == jspace.l_bucket(L)


@pytest.mark.parametrize("density", [None, 0.0, 1e-3, 1 / 256, 0.01,
                                     1 / 32, 0.5, 1.0, 3.0])
def test_reset_bucket_matches_jax(density):
    assert tspace.reset_bucket(density) == jspace.reset_bucket(density)


KEY_CASES = [
    ("selective_scan", dict(B=2, L=4096, D=4096, N=16), "bfloat16",
     torch.bfloat16, None, "fwdbwd"),
    ("selective_scan", dict(B=1, L=300, D=64, N=8), "float32",
     torch.float32, 0.0, "fwd"),
    ("selective_scan_heads", dict(B=8, L=4096, H=32, dh=64, N=64),
     "bfloat16", "bfloat16", None, "fwd"),
    ("selective_scan_heads", dict(B=2, L=100, H=4, dh=16, N=8), "float16",
     torch.float16, 0.5, "fwdbwd"),
    ("selective_scan", dict(B=3, L=17, D=5, N=4), None, None, 1e-3, "fwd"),
]


@pytest.mark.parametrize("op,shape,jdt,tdt,density,objective", KEY_CASES)
def test_shape_key_encode_and_decode_match_jax(op, shape, jdt, tdt, density,
                                               objective):
    jk = jspace.shape_key(op, dtype=jdt, reset_density=density,
                          objective=objective, **shape)
    tk = tspace.shape_key(op, dtype=tdt, reset_density=density,
                          objective=objective, **shape)
    assert tk.encode() == jk.encode()
    assert dataclasses.asdict(tspace.ShapeKey.decode(jk.encode())) == \
        dataclasses.asdict(jk)
    # the launcher warms with cfg.dtype (a string), a scan call resolves
    # with u.dtype (a torch dtype): one key either way
    if tdt is not None:
        name = str(tdt).replace("torch.", "")
        assert tspace.shape_key(op, dtype=name, reset_density=density,
                                objective=objective, **shape) == tk


def test_legacy_nine_field_key_decodes_as_fwd():
    s = "selective_scan|float32|B1|L256|D64|N8|H0|dh0|mid"
    assert tspace.ShapeKey.decode(s).objective == "fwd"
    assert tspace.ShapeKey.decode(s).encode() == s
    with pytest.raises(ValueError):
        tspace.shape_key("selective_scan", B=1, L=8, objective="bwd")
    with pytest.raises(ValueError):
        tspace.shape_key("conv1d_pack", B=1, L=8)


def _space_keys():
    keys = [k for k in jrunner.sweep_grid("fig2")]
    for L in (16, 32, 64, 128, 512, 1024, 2048, 8192):
        keys.append(jspace.shape_key("selective_scan", B=2, L=L, D=4096,
                                     N=16, dtype="bfloat16"))
        keys.append(jspace.shape_key("selective_scan_heads", B=8, L=L, H=32,
                                     dh=64, N=64, dtype="bfloat16"))
    return keys


@pytest.mark.parametrize("jk", _space_keys(), ids=lambda k: k.encode())
def test_plain_space_and_names_match_jax(jk):
    tk = tspace.ShapeKey.decode(jk.encode())
    want = jspace.space_for(jk, include_pallas=False)
    assert tspace.space_for(tk, include_pallas=False) == want
    assert [tspace.candidate_name(c) for c in want] == \
        [jspace.candidate_name(c) for c in want]


KERNEL_SPACES = [
    (dict(op="selective_scan", B=2, L=4096, D=4096, N=16,
          dtype="bfloat16"),
     ["pallas/step/T64", "pallas/blocked/T64", "pallas/blocked/T128",
      "pallas/blocked/T256"]),
    (dict(op="selective_scan", B=1, L=100, D=8, N=16, dtype="float32"),
     ["pallas/step/T64", "pallas/blocked/T64", "pallas/blocked/T128"]),
    (dict(op="selective_scan", B=1, L=16, D=8, N=16, dtype="float32"),
     ["pallas/step/T64", "pallas/blocked/T16"]),
    (dict(op="selective_scan_heads", B=8, L=4096, H=32, dh=64, N=64,
          dtype="bfloat16"),
     ["pallas/blocked_heads/T128", "pallas/blocked_heads/T256",
      "pallas/blocked_heads_dual/T128", "pallas/blocked_heads_dual/T256"]),
    (dict(op="selective_scan_heads", B=1, L=100, H=2, dh=16, N=64,
          dtype="float32"),
     ["pallas/blocked_heads/T128", "pallas/blocked_heads_dual/T128"]),
    # shapes the kernels do not take: no kernel candidate
    (dict(op="selective_scan", B=1, L=256, D=256, N=8), []),
    (dict(op="selective_scan", B=1, L=256, D=256, N=16, dtype="float16"),
     []),
    (dict(op="selective_scan_heads", B=1, L=256, H=4, dh=64, N=16), []),
    (dict(op="selective_scan_heads", B=1, L=256, H=4, dh=24, N=64), []),
]


@pytest.mark.parametrize("spec,names", KERNEL_SPACES)
def test_kernel_candidates_listed_exactly(spec, names):
    spec = dict(spec)
    k = tspace.shape_key(spec.pop("op"), **spec)
    plain = tspace.space_for(k)
    full = tspace.space_for(k, include_pallas=True)
    assert full[:len(plain)] == plain
    assert [tspace.candidate_name(c) for c in full[len(plain):]] == names
    assert all(c["backend"] == "pallas" for c in full[len(plain):])


def _kernel_args_accepted(k, c):
    """The kernels' own argument checks (``_check``, and the shape rules of
    ``_check_cuda`` and the launch functions) on operands of key ``k``."""
    u, delta, A, Bm, Cm, Dk, pos = trunner.synth_args(k)
    chunk = c["pchunk"]
    if k.op == "selective_scan_heads":
        T = max(1, min(chunk, k.Lb))
        kh._check(u, delta, A.float(), Bm, Cm, Dk, pos, T)
        assert c["schedule"] in kh.SCHEDULES
        assert k.N == kh.D_STATE and k.dh % kh.P_SLICE == 0
        return
    ksc.check_schedule(c["schedule"])
    ksc._check(u, delta, A.t().contiguous(), Bm, Cm, Dk, pos, chunk)
    ksc._check_step_chunk(c["schedule"], chunk)
    assert chunk % ksc.TILE_T == 0 and k.N == ksc.D_STATE


@pytest.mark.parametrize("spec,names", KERNEL_SPACES[:5])
def test_every_kernel_candidate_passes_the_kernel_checks(spec, names):
    spec = dict(spec, B=1)
    if spec["op"] == "selective_scan":
        spec.update(D=8)
    else:
        spec.update(H=2)
    k = tspace.shape_key(spec.pop("op"), **spec)
    for c in tspace.kernel_candidates(k):
        _kernel_args_accepted(k, c)


@pytest.mark.parametrize("op", ["selective_scan", "selective_scan_heads"])
def test_kernel_candidates_run_through_the_wrappers(op):
    """Each kernel candidate's thunk runs ``kernels/ops.py`` with its knobs
    (here on their plain versions, the operands being on the CPU), forward
    and forward + backward, and agrees with the plain blocked scan."""
    shape = dict(B=1, L=80, D=8, N=16) if op == "selective_scan" else \
        dict(B=1, L=80, H=2, dh=16, N=64)
    for obj in ("fwd", "fwdbwd"):
        k = tspace.shape_key(op, objective=obj, **shape)
        args = trunner.synth_args(k)
        ref = trunner.make_thunk(k, {"backend": "xla", "method": "blocked",
                                     "chunk": 16}, args)()
        for c in tspace.kernel_candidates(k):
            got = trunner.make_thunk(k, c, args)()
            if obj == "fwd":
                _close(got, ref, 1e-4)
            else:
                _close(got[0], ref[0], 1e-4)
                for a, b in zip(got[1], ref[1]):
                    _close(a, b, GRAD_ATOL, GRAD_RTOL)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

ENTRIES = [
    (("selective_scan", dict(B=1, L=512, D=256, N=16), "fwd"),
     {"backend": "xla", "method": "associative"}),
    (("selective_scan", dict(B=1, L=4096, D=256, N=16), "fwd"),
     {"backend": "xla", "method": "blocked", "chunk": 128,
      "intra": "assoc"}),
    (("selective_scan", dict(B=2, L=4096, D=4096, N=16), "fwdbwd"),
     {"backend": "pallas", "schedule": "step", "pchunk": 64}),
    (("selective_scan_heads", dict(B=8, L=4096, H=32, dh=64, N=64), "fwd"),
     {"backend": "pallas", "schedule": "blocked_heads", "pchunk": 256}),
    (("selective_scan_heads", dict(B=1, L=256, H=4, dh=16, N=8), "fwdbwd"),
     {"backend": "xla", "method": "blocked", "chunk": 32, "intra": "dual"}),
]
QUERIES = [
    ("selective_scan", dict(B=1, L=512, D=256, N=16), "fwd"),     # exact
    ("selective_scan", dict(B=1, L=600, D=256, N=16), "fwd"),     # nearest
    ("selective_scan", dict(B=1, L=3000, D=512, N=16), "fwd"),
    ("selective_scan", dict(B=1, L=600, D=256, N=16), "fwdbwd"),
    ("selective_scan", dict(B=2, L=2048, D=4096, N=16), "fwdbwd"),
    ("selective_scan", dict(B=2, L=4000, D=4096, N=16), "fwd"),
    ("selective_scan", dict(B=1, L=32768, D=256, N=16), "fwd"),   # too far
    ("selective_scan_heads", dict(B=8, L=2048, H=32, dh=64, N=64), "fwd"),
    ("selective_scan_heads", dict(B=8, L=4096, H=32, dh=64, N=64),
     "fwdbwd"),
    ("selective_scan_heads", dict(B=1, L=200, H=4, dh=16, N=8), "fwdbwd"),
]


def _both_caches():
    j, t = jcache.TuneCache(fp=FP_JAX), tcache.TuneCache(fp=FP_A)
    for us, ((op, shape, obj), knobs) in enumerate(ENTRIES):
        j.put(jspace.shape_key(op, objective=obj, **shape), knobs, us)
        t.put(tspace.shape_key(op, objective=obj, **shape), knobs, us)
    return j, t


@pytest.mark.parametrize("op,shape,obj", QUERIES)
def test_lookup_matches_jax(op, shape, obj):
    j, t = _both_caches()
    jk = jspace.shape_key(op, objective=obj, **shape)
    tk = tspace.shape_key(op, objective=obj, **shape)
    for kw in ({}, {"nearest": False}, {"max_distance": 1.0}):
        assert t.lookup(tk, **kw) == j.lookup(jk, **kw)
    assert ttune.tuned(op, cache=t, objective=obj, default={"chunk": 8},
                       **shape) == \
        jtune.tuned(op, cache=j, objective=obj, default={"chunk": 8},
                    **shape)


def test_distance_matches_jax():
    keys = [spec for spec, _ in ENTRIES] + QUERIES
    for a in keys:
        for b in keys:
            ja = jspace.shape_key(a[0], objective=a[2], **a[1])
            jb = jspace.shape_key(b[0], objective=b[2], **b[1])
            ta = tspace.shape_key(a[0], objective=a[2], **a[1])
            tb = tspace.shape_key(b[0], objective=b[2], **b[1])
            assert tcache._distance(ta, tb) == jcache._distance(ja, jb)


def test_nearest_never_crosses_objectives():
    _, t = _both_caches()
    near = tspace.shape_key("selective_scan", B=1, L=600, D=256, N=16,
                            objective="fwdbwd")
    assert t.lookup(near) == (None, None)
    t.put(tspace.shape_key("selective_scan", B=1, L=512, D=256, N=16,
                           objective="fwdbwd"),
          {"backend": "xla", "method": "fused_seq"}, 1.0)
    assert t.lookup(near) == ({"backend": "xla", "method": "fused_seq"},
                              "nearest")
    assert t.lookup(dataclasses.replace(near, objective="fwd"))[0] == \
        {"backend": "xla", "method": "associative"}


def test_jax_fingerprinted_file_is_stale_and_save_keeps_it(tmp_path):
    p = str(tmp_path / "tc.json")
    j, _ = _both_caches()
    j.save(p)
    t = tcache.TuneCache.load(p, fp=FP_A)
    assert t.stale and not t.entries and len(t.stale_entries) == len(ENTRIES)
    for (op, shape, obj), _ in ENTRIES:
        assert t.lookup(tspace.shape_key(op, objective=obj, **shape)) == \
            (None, None)
    k = tspace.shape_key("selective_scan", B=1, L=64, D=8, N=4)
    t.put(k, {"backend": "xla", "method": "fused_seq"}, 3.0)
    t.save(p)
    doc = json.load(open(p))
    assert doc["fingerprint"] == FP_A
    assert doc["stale"]["fingerprint"] == FP_JAX
    assert set(doc["stale"]["entries"]) == set(j.entries)
    # and the JAX package, loading the port's save, gets its own back
    j2 = jcache.TuneCache.load(p, fp=FP_JAX)
    assert j2.entries == j.entries
    assert k.encode() in j2.stale_entries


def test_roundtrip_memo_and_check_cli(tmp_path, capsys):
    p = str(tmp_path / "tc.json")
    c = tcache.TuneCache()
    k = tspace.shape_key("selective_scan", B=1, L=200, D=64, N=8)
    assert c.lookup(k) == (None, None)
    c.put(k, {"backend": "xla", "method": "blocked", "chunk": 32}, 12.34)
    assert c.lookup(k) == ({"backend": "xla", "method": "blocked",
                            "chunk": 32}, "exact")   # put clears the memo
    c.save(p)
    c2 = tcache.TuneCache.load(p)
    assert c2.entries == c.entries and c2.entries[k.encode()]["us"] == 12.3
    assert tcache.fingerprint()["platform"] == "cpu"
    tcache._main([p, "--check"])
    assert "OK" in capsys.readouterr().out
    with open(p, "w") as f:
        json.dump({"fingerprint": FP_JAX, "entries": c.entries}, f)
    tcache._main([p, "--check"])
    assert "STALE" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcache._main([str(tmp_path / "missing.json"), "--check"])
    with open(p, "w") as f:
        f.write("{not json")
    with pytest.raises(SystemExit):
        tcache._main([p, "--check"])


def test_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tcache.ENV_PATH, raising=False)
    assert tcache.default_path() == "TUNE_CACHE_torch.json"
    assert tcache.default_path() != jcache.DEFAULT_PATH
    monkeypatch.setenv(tcache.ENV_PATH, str(tmp_path / "x.json"))
    assert tcache.get_cache().path == str(tmp_path / "x.json")


# ---------------------------------------------------------------------------
# timing, sweep operands and thunks
# ---------------------------------------------------------------------------

def test_interleaved_min_of_rounds_matches_jax_under_a_fake_clock():
    """The same timed calls give JAX's ``best_us`` (to float rounding of
    the fake clock) and last results; the port's untimed re-warm call
    before each timed one costs a fake 1 ms that no best round may see."""
    jtiming = jrunner._timing()
    timed = [10e-6, 5e-6, 30e-6, 25e-6, 10e-6, 5e-6, 7e-6, 9e-6, 12e-6,
             1e-6]
    rewarmed = timed[:2] + [c for x in timed[2:] for c in (1e-3, x)]
    results = []
    for fn, seq in ((jtiming, timed), (interleaved_min_of_rounds, rewarmed)):
        t = [0.0]
        costs = iter(seq)

        def mk(name):
            def thunk():
                t[0] += next(costs)
                return name
            return thunk

        results.append(fn([("a", mk("a")), ("b", mk("b"))], rounds=4,
                          warmup=1, clock=lambda: t[0], sync=lambda x: x))
        assert next(costs, None) is None           # every cost was spent
    (jbest, jlast), (best, last) = results
    assert last == jlast
    assert best == {n: pytest.approx(us, abs=1e-6) for n, us in jbest.items()}
    assert results[1][0] == {"a": pytest.approx(7.0),
                             "b": pytest.approx(1.0)}


def test_rewarm_times_each_call_after_one_of_the_same_cell():
    """The port's default: every timed call directly follows an untimed
    call of the same cell, so what the previous cell left cached is not in
    the timed call; the clock still reads only the timed ones."""
    t, order, reads = [0.0], [], []

    def mk(name, us):
        def thunk():
            order.append(name)
            t[0] += us * 1e-6
            return name
        return thunk

    def clock():
        reads.append(order[-1] if order else None)
        return t[0]

    best, last = interleaved_min_of_rounds(
        [("a", mk("a", 3.0)), ("b", mk("b", 2.0))], rounds=2, warmup=1,
        clock=clock, sync=lambda x: x)
    assert order == ["a", "b"] + ["a", "a", "b", "b"] * 2
    assert best == {"a": pytest.approx(3.0), "b": pytest.approx(2.0)}
    # each timed call starts right after an untimed call of its own cell
    assert reads[::2] == ["a", "b", "a", "b"]


def test_default_sync_waits_on_nested_results():
    from repro_torch.tune.timing import _default_sync
    x = (torch.zeros(2), [torch.ones(1)])
    assert _default_sync(x) is x
    assert _default_sync(None) is None


@pytest.mark.parametrize("resets", ["none", "sparse", "mid", "dense"])
@pytest.mark.parametrize("L", [16, 100, 1024])
def test_synth_positions_match_jax(resets, L):
    rng = np.random.default_rng(0)
    want = np.asarray(jrunner.synth_positions(rng, 3, L, resets))
    got = trunner.synth_positions(np.random.default_rng(0), 3, L, resets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,shape", [
    ("selective_scan", dict(B=2, L=100, D=8, N=4)),
    ("selective_scan_heads", dict(B=2, L=100, H=3, dh=4, N=4))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synth_args_match_jax(op, shape, dtype):
    jk = jspace.shape_key(op, dtype=dtype, **shape)
    tk = tspace.shape_key(op, dtype=dtype, **shape)
    jargs = jrunner.synth_args(jk)
    targs = trunner.synth_args(tk)
    for name, j, t in zip(("u", "delta", "A", "B", "C", "D", "positions"),
                          jargs, targs):
        assert tuple(t.shape) == tuple(j.shape), name
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
        if name == "A":         # exp of the same f32 draws
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
        else:
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32),
                                          err_msg=name)


def _thunk_cases():
    cases = []
    for op, shape in (("selective_scan", dict(B=1, L=64, D=8, N=4)),
                      ("selective_scan_heads", dict(B=1, L=64, H=2, dh=4,
                                                    N=4))):
        k = jspace.shape_key(op, **shape)
        for c in jspace.space_for(k):
            cases.append((op, shape, c))
    return cases


@pytest.mark.parametrize("op,shape,knobs", _thunk_cases(),
                         ids=[f"{op}-{jspace.candidate_name(c)}"
                              for op, _, c in _thunk_cases()])
def test_plain_candidate_thunks_match_jax(op, shape, knobs):
    for obj in ("fwd", "fwdbwd"):
        jk = jspace.shape_key(op, objective=obj, **shape)
        tk = tspace.shape_key(op, objective=obj, **shape)
        want = jrunner.make_thunk(jk, knobs, jrunner.synth_args(jk))()
        got = trunner.make_thunk(tk, knobs, trunner.synth_args(tk))()
        if obj == "fwd":
            assert not got.requires_grad
            _close(got, want)
        else:
            _close(got[0], want[0])
            assert len(got[1]) == len(want[1]) == 4
            for a, b in zip(got[1], want[1]):
                _close(a, b, GRAD_ATOL, GRAD_RTOL)


def test_sweep_drops_a_failing_plain_candidate(monkeypatch):
    monkeypatch.setattr(
        trunner, "space_for",
        lambda key, include_pallas=False: [
            {"backend": "xla", "method": "blocked", "chunk": 16},
            {"backend": "xla", "method": "fused_seq"},
            {"backend": "xla", "method": "not-a-method"}])
    c = tcache.TuneCache(fp=FP_A)
    k = tspace.shape_key("selective_scan", B=1, L=64, D=8, N=4)
    knobs = trunner.tune_key(k, cache=c, rounds=1, device="cpu")
    assert knobs["method"] in ("blocked", "fused_seq")
    assert c.entries[k.encode()]["candidates"] == 2
    assert trunner.ensure("selective_scan", B=1, L=64, D=8, N=4, cache=c,
                          device="cpu") is False


def test_a_failing_kernel_candidate_stops_the_sweep(monkeypatch):
    """A kernel candidate that fails to build, launch or run is an error,
    never dropped so that a plain method wins by default."""
    real = trunner.make_thunk

    def broken(key, knobs, args):
        if knobs.get("backend") == "pallas":
            def thunk():
                raise RuntimeError("kernel launch failed: cudaError 700")
            return thunk
        return real(key, knobs, args)

    monkeypatch.setattr(trunner, "make_thunk", broken)
    k = tspace.shape_key("selective_scan", B=1, L=64, D=8, N=16)
    with pytest.raises(RuntimeError, match="cudaError"):
        trunner.sweep(k, rounds=1, include_pallas=True, device="cpu")


def test_sweep_on_the_cpu_leaves_the_kernels_out():
    k = tspace.shape_key("selective_scan", B=1, L=32, D=8, N=16,
                         objective="fwdbwd")
    ranked, pruned = trunner.sweep(k, rounds=1, device="cpu")
    assert {n for n, _, _ in ranked} == \
        {tspace.candidate_name(c) for c in tspace.space_for(k)}
    assert [us for _, _, us in ranked] == sorted(us for _, _, us in ranked)
    assert pruned == []                 # nothing to prune against


def test_sweep_prunes_plain_candidates_far_slower_than_the_kernels(
        monkeypatch):
    """With the kernels in the sweep, a plain candidate whose probe is over
    PRUNE_FACTOR × the slowest kernel candidate's is reported as pruned
    with its probe µs and not timed in the rounds; the rest are."""
    import time
    space = [{"backend": "pallas", "schedule": "step", "pchunk": 64},
             {"backend": "pallas", "schedule": "blocked", "pchunk": 64},
             {"backend": "xla", "method": "fused_seq"},
             {"backend": "xla", "method": "blocked", "chunk": 16}]
    cost = {"pallas/step/T64": 2e-3, "pallas/blocked/T64": 3e-3,
            "xla/fused_seq": 2e-3, "xla/blocked/T16": 0.2}
    calls = {n: 0 for n in cost}

    def thunk_for(key, knobs, args):
        name = tspace.candidate_name(knobs)

        def thunk():
            calls[name] += 1
            time.sleep(cost[name])
            return torch.zeros(1)
        return thunk

    monkeypatch.setattr(trunner, "space_for",
                        lambda key, include_pallas=False: space)
    monkeypatch.setattr(trunner, "make_thunk", thunk_for)
    k = tspace.shape_key("selective_scan", B=1, L=64, D=8, N=16)
    ranked, pruned = trunner.sweep(k, rounds=2, include_pallas=True,
                                   device="cpu")
    assert {n for n, _, _ in ranked} == {"pallas/step/T64",
                                         "pallas/blocked/T64",
                                         "xla/fused_seq"}
    assert [(n, kn) for n, kn, _ in pruned] == [("xla/blocked/T16",
                                                 space[3])]
    assert pruned[0][2] >= 0.2e6
    # probe + timed probe; the others: + warm-up + 2 rounds of 2 calls
    assert calls == {"pallas/step/T64": 7, "pallas/blocked/T64": 7,
                     "xla/fused_seq": 7, "xla/blocked/T16": 2}


# ---------------------------------------------------------------------------
# resolution through the wrappers, the models and the launchers
# ---------------------------------------------------------------------------

def _scan_inputs(seed, B=2, L=40, Dm=8, N=16):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, Dm)).astype(np.float32)
    delta = rng.uniform(0.05, 0.5, size=(B, L, Dm)).astype(np.float32)
    A = -np.exp(rng.normal(size=(Dm, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    D = rng.normal(size=(Dm,)).astype(np.float32)
    pos = np.tile(np.arange(L) % 13, (B, 1)).astype(np.int32)
    return u, delta, A, Bm, Cm, D, pos


def _heads_inputs(seed, B=2, L=40, H=2, P=16, N=64):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, H, P)).astype(np.float32)
    delta = rng.uniform(0.05, 0.5, size=(B, L, H)).astype(np.float32)
    A = -rng.uniform(1.0, 4.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    pos = np.tile(np.arange(L) % 13, (B, 1)).astype(np.int32)
    return u, delta, A, Bm, Cm, D, pos


PLAIN_WINNERS = [
    ("selective_scan", {"backend": "xla", "method": "fused_seq"}),
    ("selective_scan", {"backend": "xla", "method": "chunked",
                        "chunk": 16}),
    ("selective_scan", {"backend": "xla", "method": "blocked", "chunk": 8,
                        "intra": "matmul"}),
    ("selective_scan_heads", {"backend": "xla", "method": "blocked",
                              "chunk": 16, "intra": "dual"}),
    ("selective_scan_heads", {"backend": "xla", "method": "sequential"}),
]


@pytest.mark.parametrize("op,knobs", PLAIN_WINNERS)
def test_plain_winner_resolves_as_the_jax_wrapper(op, knobs):
    args = _scan_inputs(1) if op == "selective_scan" else _heads_inputs(1)
    u = args[0]
    shape = dict(B=u.shape[0], L=u.shape[1], N=args[3].shape[-1])
    shape.update(D=u.shape[2]) if op == "selective_scan" else \
        shape.update(H=u.shape[2], dh=u.shape[3])
    j, t = jcache.TuneCache(fp=FP_JAX), tcache.TuneCache(fp=FP_A)
    j.put(jspace.shape_key(op, **shape), knobs, 1.0)
    t.put(tspace.shape_key(op, **shape), knobs, 1.0)
    jf, tf = getattr(jops, op), getattr(tops, op)
    want = jf(*map(jnp.asarray, args[:6]), positions=jnp.asarray(args[6]),
              tune=j)
    got = tf(*map(torch.as_tensor, args[:6]),
             positions=torch.as_tensor(args[6]), tune=t)
    _close(got, want)
    # a miss leaves the wrappers' own arguments standing
    miss = tf(*map(torch.as_tensor, args[:6]),
              positions=torch.as_tensor(args[6]),
              tune=tcache.TuneCache(fp=FP_A))
    base = tf(*map(torch.as_tensor, args[:6]),
              positions=torch.as_tensor(args[6]))
    assert torch.equal(miss, base)


@pytest.mark.parametrize("op,knobs,want", [
    ("selective_scan", {"backend": "pallas", "schedule": "step",
                        "pchunk": 64}, ("step", 64)),
    ("selective_scan", {"backend": "pallas", "schedule": "blocked",
                        "pchunk": 128}, ("blocked", 128)),
    ("selective_scan_heads", {"backend": "pallas",
                              "schedule": "blocked_heads_dual",
                              "pchunk": 128}, ("blocked_heads_dual", 40)),
])
def test_kernel_winner_reaches_the_backward(monkeypatch, op, knobs, want):
    heads = op == "selective_scan_heads"
    mod = kh if heads else ksc
    fwd_name = "selective_scan_heads_fwd" if heads else "selective_scan_fwd"
    bwd_name = "selective_scan_heads_bwd" if heads else "selective_scan_bwd"
    seen = []
    real_f, real_b = getattr(mod, fwd_name), getattr(mod, bwd_name)

    def spy_f(*a):
        seen.append(("fwd", a[8], a[7]))
        return real_f(*a)

    def spy_b(*a):
        if heads:      # the heads backward serves both forward forms
            seen.append(("bwd", None, a[9]))
        else:
            seen.append(("bwd", a[10], a[9]))
        return real_b(*a)

    monkeypatch.setattr(mod, fwd_name, spy_f)
    monkeypatch.setattr(mod, bwd_name, spy_b)
    args = _heads_inputs(2) if heads else _scan_inputs(2)
    u = args[0]
    shape = dict(B=u.shape[0], L=u.shape[1], N=args[3].shape[-1])
    shape.update(H=u.shape[2], dh=u.shape[3]) if heads else \
        shape.update(D=u.shape[2])
    c = tcache.TuneCache(fp=FP_A)
    c.put(tspace.shape_key(op, objective="fwdbwd", **shape), knobs, 1.0)
    leaves = [torch.as_tensor(x).requires_grad_() for x in args[:6]]
    y = getattr(tops, op)(*leaves, positions=torch.as_tensor(args[6]),
                          backend="xla", tune=c, tune_objective="fwdbwd")
    y.square().sum().backward()
    sched, chunk = want
    assert seen == [("fwd", sched, chunk),
                    ("bwd", None if heads else sched, chunk)]
    # the fwd objective has no entry: the call-site arguments stand
    seen.clear()
    getattr(tops, op)(*map(torch.as_tensor, args[:6]),
                      positions=torch.as_tensor(args[6]), tune=c)
    assert seen == [("fwd", "blocked_heads" if heads else "blocked",
                     min(tops.HEADS_CHUNK, 40) if heads else tops.SCAN_CHUNK)]


def _tiny_cfg(variant="mamba", **kw):
    name = "mamba2-370m" if variant == "mamba2" else "mamba-110m"
    return dataclasses.replace(get_config(name).reduced(), **kw)


def _batch(cfg, B=2, L=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (B, L)).astype(np.int32),
            "positions": np.tile(np.arange(L) % 9, (B, 1)).astype(np.int32),
            "segment_ids": np.ones((B, L), np.int32)}


@pytest.mark.parametrize("variant", ["mamba", "mamba2"])
def test_scan_tune_off_never_consults_the_tuner(monkeypatch, variant):
    def boom(*a, **k):
        raise AssertionError("the tuner was consulted with scan_tune='off'")

    monkeypatch.setattr(ttune, "tuned", boom)
    monkeypatch.setattr(ttune, "tuned_entry", boom)
    cfg = _tiny_cfg(variant)
    assert cfg.scan_tune == "off" and cfg.tune_objective == "fwd"
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    loss, _ = model.loss(_batch(cfg))
    loss.backward()
    ends = np.array([[10, 23], [5, 23]], np.int32)
    model.prefill_packed(_batch(cfg), ends)
    model.prefill(_batch(cfg))


@pytest.mark.parametrize("variant", ["mamba", "mamba2"])
def test_a_model_step_looks_up_each_key_once(monkeypatch, variant):
    cfg = _tiny_cfg(variant)
    c = tcache.TuneCache()
    args = ttune.config_shape_args(cfg, 2, 24)
    op = args.pop("op")
    c.put(tspace.shape_key(op, objective="fwdbwd", **args),
          {"backend": "xla", "method": "blocked", "chunk": 8}, 1.0)
    tcache.set_cache(c, "tuned.json")
    found = []
    real = tcache.TuneCache._find

    def spy(self, key, *a):
        found.append(key)
        return real(self, key, *a)

    monkeypatch.setattr(tcache.TuneCache, "_find", spy)
    cfg = dataclasses.replace(cfg, scan_tune="tuned.json",
                              tune_objective="fwdbwd")
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    for _ in range(2):
        loss, _ = model.loss(_batch(cfg))
        loss.backward()
    assert len(found) == 1 and found[0].objective == "fwdbwd"
    # a new entry clears the memo: the next call looks the key up again
    c.put(tspace.shape_key(op, **args), {"backend": "xla",
                                         "method": "blocked"}, 1.0)
    model.loss(_batch(cfg))
    assert len(found) == 2


FP_H100 = {"schema": 1, "device_kind": "NVIDIA H100 80GB HBM3",
           "platform": "cuda", "torch": "1", "cuda": "12"}


def _resolve_on(device, cache, seed=1):
    args = _scan_inputs(seed)
    u = torch.as_tensor(args[0])
    return tops._resolve_tune(
        "selective_scan", cache, B=u.shape[0], L=u.shape[1], D=u.shape[2],
        N=args[3].shape[-1], dtype=u.dtype, positions=args[6],
        device=torch.device(device))


def _key_of_scan_inputs(seed=1, **kw):
    args = _scan_inputs(seed)
    return tspace.shape_key("selective_scan", B=args[0].shape[0],
                            L=args[0].shape[1], D=args[0].shape[2],
                            N=args[3].shape[-1], **kw)


def test_a_cpu_sweep_is_stale_for_the_card(tmp_path):
    """``runner --device cpu`` writes a CPU-fingerprinted file whose
    entries record that no kernel was timed; seen from the card the file
    is stale and every call misses, so the kernels' defaults stand."""
    p = str(tmp_path / "tc.json")
    trunner.main(["--grid", "small", "--device", "cpu", "--rounds", "1",
                  "--out", p])
    doc = json.load(open(p))
    assert doc["fingerprint"]["platform"] == "cpu"
    assert doc["fingerprint"]["device_kind"] == "cpu"
    assert doc["entries"] and \
        all(e["kernels"] is False for e in doc["entries"].values())
    card = tcache.TuneCache.load(p, fp=FP_H100)
    assert card.stale and not card.entries
    for ks in doc["entries"]:
        assert card.lookup(tspace.ShapeKey.decode(ks)) == (None, None)
    # and a CPU-fingerprinted cache handed to a call on the card misses
    cpu = tcache.TuneCache.load(p, fp=tcache.fingerprint("cpu"))
    cpu.put(_key_of_scan_inputs(), {"backend": "xla", "method": "fused_seq"},
            1.0)
    assert _resolve_on("cpu", cpu) == {"backend": "xla",
                                       "method": "fused_seq"}
    assert _resolve_on("cuda", cpu) == {}
    assert _resolve_on("cuda", card) == {}


def test_tune_key_refuses_a_cache_of_another_device():
    c = tcache.TuneCache(fp=FP_H100)
    k = tspace.shape_key("selective_scan", B=1, L=32, D=8, N=4)
    with pytest.raises(ValueError, match="a sweep on cpu"):
        trunner.tune_key(k, cache=c, rounds=1, device="cpu")
    assert not c.entries


@pytest.mark.parametrize("knobs,kernels,ok", [
    ({"backend": "xla", "method": "fused_seq"}, False, False),
    ({"backend": "xla", "method": "fused_seq"}, True, True),
    ({"backend": "pallas", "schedule": "step", "pchunk": 64}, False, True),
])
def test_the_card_takes_a_plain_winner_only_from_a_sweep_with_kernels(
        knobs, kernels, ok):
    """On the card ``kernels/ops.py`` refuses a plain winner whose sweep
    did not time the kernel candidates, rather than give the kernels way
    to the plain scans unmeasured."""
    c = tcache.TuneCache(fp=FP_H100)
    c.put(_key_of_scan_inputs(), knobs, 1.0, kernels=kernels)
    if ok:
        assert _resolve_on("cuda", c) == knobs
    else:
        with pytest.raises(RuntimeError, match="without the kernel"):
            _resolve_on("cuda", c)
    assert _resolve_on("cpu", c) == {}          # timed on another platform


def test_tuned_config_overrides_and_warm_off():
    c = tcache.TuneCache(fp=FP_A)
    cfg2 = _tiny_cfg("mamba2")
    c.put(tspace.shape_key("selective_scan_heads", B=8, L=512,
                           H=cfg2.n_ssm_heads, dh=cfg2.ssm_hd,
                           N=cfg2.d_state, dtype=cfg2.dtype),
          {"backend": "xla", "method": "blocked", "chunk": 32,
           "intra": "dual"}, 4.2)
    assert ttune.tuned_config_overrides(cfg2, B=8, L=512, cache=c) == \
        {"scan_impl": "blocked", "scan_chunk": 32, "scan_intra": "dual"}
    cfg1 = _tiny_cfg()
    c.put(tspace.shape_key("selective_scan", B=8, L=512, D=cfg1.d_inner,
                           N=cfg1.d_state, dtype=cfg1.dtype),
          {"backend": "pallas", "schedule": "step", "pchunk": 64}, 3.0)
    assert ttune.tuned_config_overrides(cfg1, B=8, L=512, cache=c) == \
        {"pallas_schedule": "step"}
    assert ttune.tuned_config_overrides(cfg1, B=8, L=64, cache=c) == {}
    assert ttune.warm_for_config(cfg1, [(2, 64)]) is None


def test_train_launcher_writes_the_jax_key_and_hits_it(monkeypatch,
                                                       tmp_path):
    from repro_torch.launch import train as ltrain
    path = str(tmp_path / "tc.json")
    hits = []
    real = tcache.TuneCache._find

    def spy(self, key, *a):
        out = real(self, key, *a)
        hits.append((key.encode(), out[1]))
        return out

    monkeypatch.setattr(tcache.TuneCache, "_find", spy)
    ltrain.main(["--tiny", "--device", "cpu", "--steps", "1", "--rows", "2",
                 "--seq-len", "64", "--prefetch", "0", "--scan-tune", path])
    jcfg = dataclasses.replace(jget_config("mamba-110m"), d_model=128,
                               n_layers=4, vocab=512, dtype="float32",
                               scan_chunk=64)
    args = jtune.config_shape_args(jcfg, 2, 64)
    want = jspace.shape_key(args.pop("op"), objective="fwdbwd",
                            **args).encode()
    doc = json.load(open(path))
    assert list(doc["entries"]) == [want]
    assert doc["entries"][want]["knobs"]["backend"] == "xla"   # CPU sweep
    assert hits and all(h == (want, "exact") for h in hits)


def test_engine_with_tuning_gives_the_same_greedy_tokens(tmp_path):
    from repro_torch.launch.serve import ServeEngine
    outs = []
    for tune in ("off", str(tmp_path / "tc.json")):
        cfg = _tiny_cfg(scan_tune=tune)
        model = LM(cfg, "cpu")
        model.init(torch.Generator().manual_seed(3))
        eng = ServeEngine(model, 4, 96, buckets=(32, 64), prefill_rows=2)
        rng = np.random.default_rng(4)
        for n in (5, 30, 17, 50, 9, 22):
            eng.submit(rng.integers(1, cfg.vocab, size=n), 6)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    doc = json.load(open(tmp_path / "tc.json"))
    # the packed prefill's (2, bucket) shapes and the chunk lane's
    # (1, slab width) ones, slab widths the buckets up to chunk_size (64)
    assert sorted(doc["entries"]) == sorted(
        tspace.shape_key("selective_scan", B=rows, L=b, D=cfg.d_inner,
                         N=cfg.d_state, dtype=cfg.dtype).encode()
        for rows in (1, 2) for b in (32, 64))
