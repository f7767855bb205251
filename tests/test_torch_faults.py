"""The port's fault injection and guard rails against the JAX engine's, on
the CPU, at tests/test_faults.py's config: mamba-110m.reduced() with the
JAX package's weights, 4 slots, buckets (16, 32), 2 × 2 segments a round.

* ``repro_torch.faults.FaultPlan`` answers every query as the reference's
  plan does, and ``FaultPlan.random`` draws the reference's plan, field for
  field, for 64 seeds in every envelope; ``poison_states`` and
  ``poison_cache_rows`` give the reference's arrays bitwise.
* The port's engine and the JAX engine, under the same ``FaultPlan`` and
  the device readiness taken out of the JAX side (its ``is_ready`` depends
  on the CPU's timing; the port's CPU prefill is ready at once), give the
  same greedy outputs, statuses, error strings and counters in each
  scenario of the reference's tests: the guard with no fault (bitwise the
  guard off), decode poison with NaN and ±Inf, prefill poison, a failed and
  a poisoned chunk round, a prefill failing mid-overlap, a delayed
  prefill, and three chaos seeds (``FAULT_CHAOS_SEED`` as the reference
  test reads it). Every comparison is exact: both sides are.

Each JAX engine runs once, in the module's ``jax_run`` cache.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

KW = dict(num_slots=4, max_len=64, prefill_rows=2, buckets=(16, 32),
          max_segments=2)
COUNTERS = ("shed", "expired", "cancelled", "quarantined", "prefill_faults",
            "prefills", "chunk_rounds", "decode_steps", "generated")


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config("mamba-110m").reduced()
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jmodel, jparams, model


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=n).tolist() for n in lens]


# the reference tests' workloads: four short prompts; six with staggered
# budgets so slots free one by one; the four and one over the 32 bucket
SHORT = _prompts((5, 9, 7, 12), 0)
SIX = _prompts((5, 9, 7, 12, 6, 10), 1)
SIX_BUDGETS = [4, 10, 6, 12, 5, 7]
LONG = SHORT + _prompts((40,), 2)
CHAOS = _prompts((5, 9, 7, 12, 6, 40), 3)


def _summary(eng):
    return {"outputs": {r: list(map(int, o)) for r, o in eng.outputs.items()},
            "status": dict(eng.status), "errors": dict(eng.errors),
            "counters": {k: getattr(eng.stats, k) for k in COUNTERS}}


def _steady(jeng):
    """The JAX engine with its device readiness taken out: a prefill is
    ready once its tokens are (the plan's delay still applies first)."""
    ready = jeng._prefill_ready

    def steady(inf):
        jax.block_until_ready(inf["tok"])
        return ready(inf)

    jeng._prefill_ready = steady
    return jeng


def _drain(eng, prompts, budgets, limit=500):
    for p, b in zip(prompts, budgets):
        eng.submit(p, b)
    steps = 0
    while eng.step():
        steps += 1
        assert steps < limit, "the engine failed to drain"
    return eng


def _port(pair, prompts, budgets, plan=None, **kw):
    eng = ServeEngine(pair[2], faults=None if plan is None
                      else faults.FaultPlan(**plan), **dict(KW, **kw))
    return _drain(eng, prompts, budgets)


@pytest.fixture(scope="module")
def jax_run(pair):
    """name → the JAX engine's summary on that scenario, each run once."""
    jmodel, jparams, _ = pair
    done = {}

    def run(name, prompts, budgets, plan=None, **kw):
        if name not in done:
            eng = _steady(JEngine(
                jmodel, jparams, faults=None if plan is None
                else jfaults.FaultPlan(**plan), **dict(KW, **kw)))
            done[name] = _summary(_drain(eng, prompts, budgets))
        return done[name]

    return run


def _same_as_jax(jax_run, name, teng, prompts, budgets, plan=None, **kw):
    got = _summary(teng)
    assert got == jax_run(name, prompts, budgets, plan, **kw)
    return got


# ---------------------------------------------------------------------------
# FaultPlan and the poison helpers against the reference's
# ---------------------------------------------------------------------------

def test_fault_plan_queries_match_reference():
    kw = dict(fail_prefill=2, delay_prefill={1: 3},
              poison_prefill={0: [(1, 0)]}, poison_decode={5: [0, 2]},
              fail_chunk=1, poison_chunk={2: [0]}, drop_cache=3,
              poison_cache_hit=[1], kill_at_step=9)
    for sub in ({}, kw, {"fail_prefill": 0}, {"poison_chunk": {1: [0]}},
                {"drop_cache": 0}, {"kill_at_step": 4}):
        a, b = faults.FaultPlan(**sub), jfaults.FaultPlan(**sub)
        assert (a.needs_guard(), a.empty()) == (b.needs_guard(), b.empty())
        for i in range(12):
            assert a.fails_prefill(i) == b.fails_prefill(i)
            assert a.prefill_poison(i) == b.prefill_poison(i)
            assert a.fails_chunk(i) == b.fails_chunk(i)
            assert a.chunk_poison(i) == b.chunk_poison(i)
            assert a.drops_cache(i) == b.drops_cache(i)
            assert a.cache_hit_poison(i) == b.cache_hit_poison(i)
            assert a.kills(i) == b.kills(i)
            for n in range(5):
                assert a.prefill_not_ready(i, n) == b.prefill_not_ready(i, n)
            va, vb = a.decode_poison(i, 4), b.decode_poison(i, 4)
            assert (va is None) == (vb is None)
            if va is not None:
                np.testing.assert_array_equal(va, vb)
                assert va.dtype == vb.dtype == np.float32
    plan = faults.FaultPlan(**kw)
    assert [plan.prefill_not_ready(1, k) for k in range(5)] == \
        [True, True, True, False, False]
    v = plan.decode_poison(5, 4)
    assert np.isnan(v[[0, 2]]).all() and (v[[1, 3]] == 0.0).all()
    assert faults.FaultPlan().empty()
    assert not faults.FaultPlan(fail_chunk=0).needs_guard()
    assert issubclass(faults.EngineKilled, RuntimeError)
    assert issubclass(faults.PrefillFault, RuntimeError)


def _fields(plan):
    d = dataclasses.asdict(plan)
    v = d.pop("poison_value")
    return d, ("nan" if math.isnan(v) else v)


@pytest.mark.parametrize("envelope", [
    {}, {"chunk_rows": 1}, {"cache_lookups": 6}, {"allow_kill": True},
    {"chunk_rows": 2, "cache_lookups": 5, "allow_kill": True,
     "max_prefills": 3, "max_steps": 20, "num_slots": 6,
     "prefill_rows": 3, "max_segments": 4}],
    ids=["plain", "chunk", "cache", "kill", "all"])
def test_fault_plan_random_matches_reference(envelope):
    plans = []
    for seed in range(64):
        a = faults.FaultPlan.random(seed, **envelope)
        assert _fields(a) == _fields(jfaults.FaultPlan.random(
            seed, **envelope)), seed
        assert _fields(a) == _fields(faults.FaultPlan.random(seed,
                                                             **envelope))
        plans.append(a)
    assert any(not p.empty() for p in plans)
    assert len({repr(_fields(p)) for p in plans}) > 32


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   -float("inf")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_poison_helpers_match_reference(value, dtype):
    """Both helpers on the same numpy arrays: the port's (n_layers, B, S,
    …) and (n_layers, B, …) leaves against the reference's unit-stacked
    leaves, bitwise; untouched rows keep their bits, integer leaves pass."""
    rng = np.random.default_rng(9)
    conv = rng.standard_normal((3, 2, 3, 4, 5)).astype(np.float32)
    ssm = rng.standard_normal((3, 2, 3, 5, 6)).astype(np.float32)
    lens = np.arange(3 * 2 * 3, dtype=np.int32).reshape(3, 2, 3)
    tdt = getattr(torch, dtype)

    def port(a):
        t = torch.from_numpy(a)
        return t.to(tdt) if t.is_floating_point() else t

    def ref(a):
        j = jnp.asarray(a)
        return j.astype(jnp.bfloat16) if dtype == "bfloat16" and \
            j.dtype == jnp.float32 else j

    def same(t, j):
        t = t.float().numpy() if t.is_floating_point() else t.numpy()
        j = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16
                       else j)
        np.testing.assert_array_equal(t, j)     # NaN where NaN, else equal

    leaves = {"conv": conv, "ssm": ssm, "lens": lens}
    got = faults.poison_states({k: port(a) for k, a in leaves.items()},
                               [(1, 2), (0, 0)], value)
    want = jfaults.poison_states(
        {"units": {k: ref(a) for k, a in leaves.items()}},
        [(1, 2), (0, 0)], value)["units"]
    for k in leaves:
        assert got[k].dtype == port(leaves[k]).dtype
        same(got[k], want[k])
    c = got["conv"].float()
    assert not torch.isfinite(c[:, 1, 2]).any()
    assert torch.equal(c[:, 1, :2], port(conv)[:, 1, :2].float())

    rows = {"conv": conv[:, :, 0], "ssm": ssm[:, :, 0], "lens": lens[:, :, 0]}
    got = faults.poison_cache_rows({k: port(a) for k, a in rows.items()},
                                   [1], value)
    want = jfaults.poison_cache_rows(
        {"units": {k: ref(a) for k, a in rows.items()}}, [1],
        value)["units"]
    for k in rows:
        same(got[k], want[k])
    assert torch.equal(got["ssm"][:, 0], port(rows["ssm"])[:, 0])
    assert torch.equal(got["lens"], port(rows["lens"]))


def test_guarded_model_calls_are_the_plain_ones_plus_a_probe(pair):
    """The guarded decode steps with a zero poison give the plain steps'
    tokens, logits, cache and counters bitwise; the probes flag exactly the
    poisoned slot, segment and chunk row."""
    model = pair[2]
    torch.manual_seed(0)
    toks = torch.randint(1, 128, (4, 1), dtype=torch.int32)
    stream = torch.arange(4, dtype=torch.int64) * 977
    ctr = torch.arange(4, dtype=torch.int64)
    temp = torch.tensor([0.0, 0.8, 1.2, 0.5])
    topk = torch.tensor([0, 5, 0, 20])
    topp = torch.tensor([1.0, 0.9, 0.95, 1.0])
    zero = torch.zeros(4)
    c0 = model.init_cache(4)
    for v in c0.values():
        v.normal_()
    runs = []
    for guarded in (False, True):
        cache = {k: v.clone() for k, v in c0.items()}
        if guarded:
            tok, lg, cache, c1, fin = model.decode_step_sample_guarded(
                cache, toks, stream, ctr, temp, topk, topp, zero)
            assert fin.all()
        else:
            tok, lg, cache, c1 = model.decode_step_sample(
                cache, toks, stream, ctr, temp, topk, topp)
        runs.append((tok, lg, cache, c1))
    (t0, l0, k0, n0), (t1, l1, k1, n1) = runs
    assert torch.equal(t0, t1) and torch.equal(l0, l1)
    assert torch.equal(n0, n1) and all(torch.equal(k0[k], k1[k]) for k in k0)
    cache = {k: v.clone() for k, v in c0.items()}
    g, _, fin = model.decode_step_greedy_guarded(
        cache, toks, torch.tensor([0.0, float("nan"), 0.0, float("inf")]))
    assert fin.tolist() == [True, False, True, False]
    assert torch.equal(g[[0, 2]], model.decode_step(
        {k: v.clone() for k, v in c0.items()}, toks)[0].argmax(-1)[[0, 2]]
        .to(torch.int32))
    logits, states, _ = model.prefill_packed(
        {"tokens": np.array([[5, 6, 7, 8], [9, 10, 11, 0]], np.int32),
         "positions": np.array([[0, 1, 0, 1], [0, 1, 2, 0]], np.int32),
         "segment_ids": np.array([[1, 1, 2, 2], [1, 1, 1, 0]], np.int32)},
        np.array([[1, 3], [2, -1]], np.int32))
    assert model.prefill_probe(states, logits).all()
    bad = faults.poison_states(states, [(0, 1)])
    assert model.prefill_probe(bad, logits).tolist() == \
        [[True, False], [True, True]]
    chunk = faults.poison_cache_rows(model.init_cache(3), [2], float("inf"))
    assert model.chunk_probe(chunk, torch.zeros(3, 128)).tolist() == \
        [True, True, False]


# ---------------------------------------------------------------------------
# guard rails and quarantine, port against JAX
# ---------------------------------------------------------------------------

def test_guard_on_no_faults_is_bitwise_the_guard_off(pair, jax_run):
    off = _same_as_jax(jax_run, "clean", _port(pair, SHORT, [8] * 4),
                       SHORT, [8] * 4)
    eng = _port(pair, SHORT, [8] * 4, guard=True)
    on = _same_as_jax(jax_run, "guard", eng, SHORT, [8] * 4, guard=True)
    assert eng.guard and on == off
    assert on["counters"]["quarantined"] == 0
    assert set(on["status"].values()) == {"done"}
    empty = _port(pair, SHORT, [8] * 4, plan={})
    assert not empty.guard and _summary(empty) == off


@pytest.mark.parametrize("value,step,slot", [
    (float("nan"), 2, 1), (float("inf"), 1, 0), (-float("inf"), 3, 2)],
    ids=["nan", "inf", "-inf"])
def test_decode_poison_quarantines_the_slot_only(pair, jax_run, value, step,
                                                 slot):
    plan = dict(poison_decode={step: [slot]}, poison_value=value)
    eng = _port(pair, SHORT, [8] * 4, plan=plan)
    got = _same_as_jax(jax_run, f"decode_poison_{value}", eng, SHORT,
                       [8] * 4, plan)
    ref = jax_run("clean", SHORT, [8] * 4)
    assert eng.guard
    failed = [r for r, s in got["status"].items() if s == "failed"]
    assert len(failed) == 1 and got["counters"]["quarantined"] == 1
    assert "non-finite decode logits" in got["errors"][failed[0]]
    assert f"at step {step} (slot {slot})" in got["errors"][failed[0]]
    assert len(got["outputs"][failed[0]]) < len(ref["outputs"][failed[0]])
    for r in ref["outputs"]:
        if r not in failed:
            assert got["outputs"][r] == ref["outputs"][r]


def test_prefill_poison_quarantines_before_activation(pair, jax_run):
    plan = dict(poison_prefill={0: [(0, 1)]})
    eng = _port(pair, SHORT, [8] * 4, plan=plan)
    got = _same_as_jax(jax_run, "prefill_poison", eng, SHORT, [8] * 4, plan)
    ref = jax_run("clean", SHORT, [8] * 4)
    failed = [r for r, s in got["status"].items() if s == "failed"]
    assert len(failed) == 1 and got["counters"]["quarantined"] == 1
    assert "non-finite prefill state" in got["errors"][failed[0]]
    assert "prefill 0, row 0, segment 1" in got["errors"][failed[0]]
    assert got["outputs"][failed[0]] == []
    for r in ref["outputs"]:
        if r not in failed:
            assert got["outputs"][r] == ref["outputs"][r]
    # the quarantined segment's state was scattered into a slot left free;
    # a later refill overwrote it, and the engine drained
    assert not eng._active_slots() and not any(eng.slot_pending)


# ---------------------------------------------------------------------------
# the chunk lane's seams
# ---------------------------------------------------------------------------

def test_chunk_round_failure_keeps_serving(pair, jax_run):
    long_rid = len(LONG) - 1
    ref = _same_as_jax(jax_run, "clean_long", _port(pair, LONG, [8] * 5),
                       LONG, [8] * 5)
    assert ref["outputs"][long_rid]
    plan = dict(fail_chunk=1)
    eng = _port(pair, LONG, [8] * 5, plan=plan)
    got = _same_as_jax(jax_run, "fail_chunk", eng, LONG, [8] * 5, plan)
    assert got["status"][long_rid] == "failed"
    assert "chunked-prefill round 1 failed" in got["errors"][long_rid]
    assert got["outputs"][long_rid] == []
    assert got["counters"]["prefill_faults"] == 1
    assert eng.stats.chunked_prefills == 0
    for r in range(long_rid):
        assert got["outputs"][r] == ref["outputs"][r]


def test_chunk_poison_quarantined_at_handoff(pair, jax_run):
    long_rid = len(LONG) - 1
    ref = jax_run("clean_long", LONG, [8] * 5)
    plan = dict(poison_chunk={0: [0]})
    eng = _port(pair, LONG, [8] * 5, plan=plan)
    got = _same_as_jax(jax_run, "poison_chunk", eng, LONG, [8] * 5, plan)
    assert eng.guard and got["status"][long_rid] == "failed"
    assert "non-finite chunked-prefill state" in got["errors"][long_rid]
    assert got["counters"]["quarantined"] == 1
    assert got["outputs"][long_rid] == []
    for r in range(long_rid):
        assert got["outputs"][r] == ref["outputs"][r]


# ---------------------------------------------------------------------------
# the packed prefill's seams in the overlap window
# ---------------------------------------------------------------------------

def test_prefill_failure_mid_overlap(pair, jax_run):
    """The second prefill, issued while the first round decodes, fails:
    its requests fail explicitly, the first round never notices."""
    ref = _same_as_jax(jax_run, "clean_six",
                       _port(pair, SIX, SIX_BUDGETS), SIX, SIX_BUDGETS)
    plan = dict(fail_prefill=1)
    eng = _port(pair, SIX, SIX_BUDGETS, plan=plan)
    got = _same_as_jax(jax_run, "fail_prefill", eng, SIX, SIX_BUDGETS, plan)
    assert got["counters"]["prefill_faults"] == 1
    assert eng.stats.midflight_refills >= 1
    failed = sorted(r for r, s in got["status"].items() if s == "failed")
    assert failed
    for r in failed:
        assert "prefill dispatch 1 failed" in got["errors"][r]
        assert got["outputs"][r] == []
    for r in ref["outputs"]:
        if r not in failed:
            assert got["outputs"][r] == ref["outputs"][r]
    assert set(got["status"].values()) <= {"done", "failed"}


def test_prefill_delay_lands_late_and_right(pair, jax_run):
    ref = jax_run("clean_six", SIX, SIX_BUDGETS)
    plan = dict(delay_prefill={1: 3})
    eng = _port(pair, SIX, SIX_BUDGETS, plan=plan)
    got = _same_as_jax(jax_run, "delay_prefill", eng, SIX, SIX_BUDGETS, plan)
    assert got["outputs"] == ref["outputs"]
    assert set(got["status"].values()) == {"done"}
    assert eng.stats.overlapped_prefills >= 1
    assert got["counters"]["decode_steps"] > ref["counters"]["decode_steps"]


# ---------------------------------------------------------------------------
# chaos: seeded random plans, every request terminates, port == JAX
# ---------------------------------------------------------------------------

def test_chaos_seeds_match_jax_and_terminate(pair, jax_run):
    base_seed = int(os.environ.get("FAULT_CHAOS_SEED", "0"))
    budgets = SIX_BUDGETS
    ref = _same_as_jax(jax_run, "chaos_clean", _port(pair, CHAOS, budgets),
                       CHAOS, budgets)
    for seed in range(base_seed, base_seed + 3):
        plan = dataclasses.asdict(faults.FaultPlan.random(
            seed, max_prefills=3, max_steps=20, num_slots=KW["num_slots"],
            prefill_rows=KW["prefill_rows"],
            max_segments=KW["max_segments"], chunk_rows=1))
        eng = _port(pair, CHAOS, budgets, plan=plan)
        got = _same_as_jax(jax_run, f"chaos_{seed}", eng, CHAOS, budgets,
                           plan)
        statuses = got["status"]
        assert set(statuses.values()) <= {"done", "failed"}, (seed, statuses)
        accounted = sum(
            "prefill dispatch" in got["errors"].get(r, "")
            or "chunked-prefill round" in got["errors"].get(r, "")
            for r, s in statuses.items() if s == "failed")
        assert sum(s == "failed" for s in statuses.values()) == \
            got["counters"]["quarantined"] + accounted, seed
        for r, s in statuses.items():
            if s == "failed":
                assert got["errors"][r]
        if eng.faults.empty():
            assert got["outputs"] == ref["outputs"]
