"""The port's request lifecycle against the JAX engine's, on the CPU, at
tests/test_faults.py's config (mamba-110m.reduced() with the JAX package's
weights, 4 slots, buckets (16, 32), 2 × 2 segments a round).

* One script drives both engines under the same scripted clock, with the
  JAX side's device readiness taken out (a prefill is ready once its tokens
  are): deadlines that run out while queued, during a packed prefill in
  flight, during a chunked prefill and mid-decode; shedding by queue depth
  and by the head's age; cancel while queued, on a chunk row, decoding and
  during an in-flight prefill; duplicate rids. Greedy outputs, statuses,
  error strings and the counters are equal; every comparison is exact.
* Kill and restore (port only, against an uninterrupted port run): a
  snapshot at every step boundary, ``EngineKilled`` before decode step 1,
  3 or 6, and in the middle of a chunked prefill, then a fresh engine
  restores the last snapshot; every stream, greedy and sampled, ends
  bitwise as the uninterrupted run's (and the greedy ones as the JAX
  engine's). ``restore`` refuses a busy or differently configured engine
  with the reference's messages, and a deadline keeps its budget left.
* The launcher's ``--guard``, ``--deadline-ms`` and ``--max-queue`` through
  ``--device cpu``.

Each JAX engine runs once, in the module's ``jax_play`` cache.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.faults import EngineKilled, FaultPlan  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import ServeEngine, ShedError, main  # noqa
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


SHORT = _prompts((5, 9, 7, 12), 0)
MORE = _prompts((6, 10), 4)
LONG = _prompts((40,), 2)[0]            # over the 32 bucket: the chunk lane


def _summary(eng, extra=None):
    return {"outputs": {r: list(map(int, o)) for r, o in eng.outputs.items()},
            "status": dict(eng.status), "errors": dict(eng.errors),
            "counters": {k: getattr(eng.stats, k) for k in COUNTERS},
            "extra": extra}


def _play(make, script, **kw):
    t = {"now": 0.0}
    eng = make(clock=lambda: t["now"], **dict(KW, **kw))
    return eng, _summary(eng, script(eng, t))


@pytest.fixture(scope="module")
def jax_play(pair):
    """name → the JAX engine's summary under ``script``, each run once."""
    jmodel, jparams, _ = pair
    done = {}

    def make(**kw):
        eng = JEngine(jmodel, jparams, **kw)
        ready = eng._prefill_ready

        def steady(inf):
            jax.block_until_ready(inf["tok"])
            return ready(inf)

        eng._prefill_ready = steady
        return eng

    def play(name, script, **kw):
        if name not in done:
            done[name] = _play(make, script, **kw)[1]
        return done[name]

    return play


def _both(pair, jax_play, name, script, **kw):
    eng, got = _play(lambda **k: ServeEngine(pair[2], **k), script, **kw)
    assert got == jax_play(name, script, **kw)
    return eng, got


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def _deadline_queued(eng, t):
    a = eng.submit(SHORT[0], 8, deadline_ms=50)
    b = eng.submit(SHORT[1], 8)
    t["now"] = 0.2                       # 200 ms > the 50 ms budget
    eng.run()
    return [a, b]


def _deadline_in_flight(eng, t):
    a, b = eng.submit(SHORT[0], 6), eng.submit(SHORT[1], 6)
    eng.step()                           # nothing decoding: lands at once
    c = eng.submit(SHORT[2], 6, deadline_ms=50)
    d = eng.submit(SHORT[3], 6)
    eng.step()                           # c, d dispatched beside a, b
    assert {r.rid for r in eng._inflight["admitted"]} == {c, d}
    t["now"] = 0.2
    eng.run()
    return [a, b, c, d]


def _deadline_chunking(eng, t):
    a = eng.submit(SHORT[0], 6)
    long = eng.submit(LONG, 6, deadline_ms=50)
    eng.step()                           # the chunk row takes 32 of 40
    assert eng.chunk_req[0].rid == long and eng.chunk_off[0] == 32
    t["now"] = 0.2
    eng.run()
    return [a, long]


def _deadline_decoding(eng, t):
    a = eng.submit(SHORT[0], 16, deadline_ms=50)
    b = eng.submit(SHORT[1], 16)
    for _ in range(4):
        eng.step()
    t["now"] = 0.2
    eng.run()
    return [a, b]


@pytest.mark.parametrize("script,where", [
    (_deadline_queued, "while queued"),
    (_deadline_in_flight, "during prefill"),
    (_deadline_chunking, "during chunked prefill"),
    (_deadline_decoding, "mid-decode")],
    ids=["queued", "in_flight_prefill", "chunked_prefill", "mid_decode"])
def test_deadlines_match_jax(pair, jax_play, script, where):
    eng, got = _both(pair, jax_play, script.__name__, script)
    rids = got["extra"]
    expired = [r for r in rids if got["status"][r] == "expired"]
    assert len(expired) == 1 and got["counters"]["expired"] == 1
    r = expired[0]
    assert where in got["errors"][r]
    n = len(got["outputs"][r])
    assert (0 < n < 16) if where == "mid-decode" else n == 0
    assert all(got["status"][x] == "done" for x in rids if x != r)
    assert not eng._active_slots() and not any(eng.slot_pending)


# ---------------------------------------------------------------------------
# shedding, duplicate rids
# ---------------------------------------------------------------------------

def _shed(eng, t):
    msgs = []
    for p in SHORT[:3]:
        try:
            eng.submit(p, 4)
        except RuntimeError as e:
            msgs.append((type(e).__name__, e.reason, str(e)))
    t["now"] = 0.5                       # the head is 500 ms old
    try:
        eng.submit(SHORT[3], 4)
    except RuntimeError as e:
        msgs.append((type(e).__name__, e.reason, str(e)))
    eng.run()
    return msgs


@pytest.mark.parametrize("bounds", [dict(max_queue=2),
                                    dict(max_queue_age_ms=100.0)],
                         ids=["depth", "age"])
def test_shedding_matches_jax(pair, jax_play, bounds):
    eng, got = _both(pair, jax_play, f"shed_{sorted(bounds)}", _shed,
                     **bounds)
    msgs = got["extra"]
    if "max_queue" in bounds:
        assert [m[2] for m in msgs] == [
            "shed: admission queue depth 2 >= max_queue 2"] * 2
    else:
        assert len(msgs) == 1 and "max_queue_age_ms" in msgs[0][2]
        assert "waited 500ms" in msgs[0][2]
    assert all(m[0] == "ShedError" for m in msgs)
    assert got["counters"]["shed"] == len(msgs) == eng.stats.shed
    assert sorted(got["outputs"]) == list(range(4 - len(msgs)))
    assert all(len(o) == 4 for o in got["outputs"].values())
    with pytest.raises(ShedError) as e:
        ServeEngine(pair[2], max_queue=0, **KW).submit(SHORT[0], 4)
    assert isinstance(e.value, RuntimeError) and "max_queue 0" in \
        e.value.reason


def _duplicates(eng, t):
    msgs = []
    eng.submit(SHORT[0], 4, rid=5)
    for call in (lambda: eng.submit(SHORT[1], 4, rid=5),
                 lambda: eng.submit(SHORT[1], 4, deadline_ms=0)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    msgs.append(eng.submit(SHORT[1], 4))       # auto rids go past pinned
    eng.run()
    try:
        eng.submit(SHORT[2], 4, rid=6)         # known even when done
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def test_duplicate_rids_match_jax(pair, jax_play):
    _, got = _both(pair, jax_play, "duplicates", _duplicates)
    dup, bad_deadline, auto, done = got["extra"]
    assert "duplicate request id 5 (status 'queued')" in dup
    assert "deadline_ms must be > 0" in bad_deadline
    assert auto == 6 and "duplicate request id 6 (status 'done')" in done
    nochunk = ServeEngine(pair[2], chunk_rows=0, **KW)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        nochunk.submit(LONG, 4)


# ---------------------------------------------------------------------------
# cancel in every stage
# ---------------------------------------------------------------------------

def _cancels(eng, t):
    r = [eng.submit(p, 8) for p in SHORT[:3]]
    queued = eng.submit(SHORT[3], 8)
    long = eng.submit(LONG, 8)
    got = [eng.cancel(queued)]
    eng.step()             # r land at once; the long prompt takes row 0
    assert eng.chunk_req[0].rid == long and len(eng._active_slots()) == 3
    got += [eng.cancel(long), eng.cancel(r[0])]
    late = [eng.submit(p, 8) for p in MORE]
    eng.step()             # the chunk row and its slot come back free
    assert eng.chunk_req[0] is None
    eng.step()             # `late` dispatched beside r[1], r[2]
    assert {x.rid for x in eng._inflight["admitted"]} == set(late)
    got.append(eng.cancel(late[0]))
    eng.run()
    got += [eng.cancel(r[1]), eng.cancel(queued), eng.cancel(999)]
    return got


def test_cancel_in_every_stage_matches_jax(pair, jax_play):
    eng, got = _both(pair, jax_play, "cancels", _cancels)
    assert got["extra"] == [True] * 4 + [False] * 3
    errors = {r: e for r, e in got["errors"].items()}
    assert sorted(errors.values()) == sorted([
        "cancelled while queued", "cancelled during prefill",
        "cancelled mid-decode", "cancelled during prefill"])
    assert got["counters"]["cancelled"] == 4
    assert got["outputs"][3] == [] and got["outputs"][4] == []
    assert got["outputs"][5] == [] and 0 < len(got["outputs"][0]) < 8
    assert [got["status"][r] for r in (1, 2, 6)] == ["done"] * 3
    assert not eng._active_slots() and not any(eng.slot_pending)


# ---------------------------------------------------------------------------
# snapshot and restore
# ---------------------------------------------------------------------------

SAMPLED = [dict(temperature=0.0), dict(temperature=0.8, top_k=20),
           dict(temperature=0.0), dict(temperature=1.1, top_p=0.9),
           dict(temperature=0.7, top_k=7, top_p=0.95)]


def _submit_mix(eng, prompts, sampled):
    for i, p in enumerate(prompts):
        eng.submit(p, 8, **(SAMPLED[i] if sampled else {}))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kill_at,long", [(1, False), (3, False),
                                          (6, False), (1, True)],
                         ids=["step1", "step3", "step6", "mid_chunk"])
def test_kill_and_restore_finishes_bitwise(pair, jax_play, tmp_path,
                                           kill_at, long, sampled):
    model = pair[2]
    prompts = SHORT + [LONG] if long else SHORT
    ref_eng = ServeEngine(model, sample_seed=5, **KW)
    _submit_mix(ref_eng, prompts, sampled)
    ref = ref_eng.run()
    if not sampled:

        def clean(e, t):
            for p in prompts:
                e.submit(p, 8)
            e.run()

        assert ref == jax_play(f"clean_{long}", clean)["outputs"]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    eng = ServeEngine(model, sample_seed=5,
                      faults=FaultPlan(kill_at_step=kill_at), **KW)
    _submit_mix(eng, prompts, sampled)
    snap = 0
    with pytest.raises(EngineKilled, match=f"decode step {kill_at}"):
        while True:
            eng.snapshot(mgr, step=snap)   # every step boundary
            snap += 1
            assert eng.step(), "the fault plan never fired"
    meta = mgr.read_meta(mgr.latest_step())["meta"]
    if long:
        row = meta["chunks"][0]
        assert row is not None and 0 < row["off"] < len(LONG)
    fresh = ServeEngine(model, sample_seed=5, **KW)
    assert fresh.restore(mgr) == mgr.latest_step() == snap - 1
    live = {r for r, s in meta["status"].items() if s != "done"}
    assert fresh.resumed == {int(r) for r in live} and fresh.resumed
    out = fresh.run()
    assert out == ref
    assert all(fresh.status[r] == "done" for r in ref)


def test_restore_refuses_busy_or_other_engines(pair, tmp_path):
    model = pair[2]
    mgr = CheckpointManager(str(tmp_path / "a"))
    eng = ServeEngine(model, **KW)
    eng.submit(SHORT[0], 4)
    eng.snapshot(mgr, step=0, blocking=True)
    for other in (dict(KW, num_slots=2), dict(KW, buckets=(16, 64)),
                  dict(KW, chunk_rows=0), dict(KW, sample_seed=1)):
        with pytest.raises(ValueError, match="slot shapes would not line up"):
            ServeEngine(model, **other).restore(mgr)
    busy = ServeEngine(model, **KW)
    busy.submit(SHORT[1], 4)
    with pytest.raises(RuntimeError, match="requires an idle engine"):
        busy.restore(mgr)
    with pytest.raises(FileNotFoundError, match="no snapshot to restore"):
        ServeEngine(model, **KW).restore(CheckpointManager(
            str(tmp_path / "none")))
    ok = ServeEngine(model, **KW)
    assert ok.restore(mgr) == 0 and ok.resumed == {0}
    ref = ServeEngine(model, **KW)
    ref.submit(SHORT[0], 4)
    assert ok.run() == ref.run()


def test_snapshot_keeps_the_deadline_budget_left(pair, tmp_path):
    """Deadlines are saved as the budget left: downtime between the crash
    and the restore expires nothing that had time left; a request whose
    budget was spent at the snapshot expires at once after it."""
    model = pair[2]
    t = {"now": 0.0}
    mgr = CheckpointManager(str(tmp_path))
    eng = ServeEngine(model, clock=lambda: t["now"], **KW)
    a = eng.submit(SHORT[0], 4, deadline_ms=1000)
    b = eng.submit(SHORT[1], 4, deadline_ms=300)
    t["now"] = 0.4                       # a has 600 ms left, b is over
    eng.snapshot(mgr, step=0, blocking=True)
    meta = mgr.read_meta(0)["meta"]
    left = {m["rid"]: m["deadline_left_ms"] for m in meta["queue"]}
    assert left[a] == pytest.approx(600.0) and left[b] < 0
    t["now"] = 100.0                     # 100 s of downtime
    fresh = ServeEngine(model, clock=lambda: t["now"], **KW)
    fresh.restore(mgr)
    out = fresh.run()                    # the clock stands still
    assert fresh.status[a] == "done" and len(out[a]) == 4
    assert fresh.status[b] == "expired" and out[b] == []
    again = ServeEngine(model, clock=lambda: t["now"], **KW)
    again.restore(mgr)
    t["now"] = 100.7                     # 700 ms after the restore
    again.run()
    assert again.status[a] == "expired" and "while queued" in again.errors[a]


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------

def test_cli_lifecycle_flags_on_cpu(capsys):
    base = ["--arch", "mamba-110m", "--tiny", "--device", "cpu",
            "--requests", "6", "--slots", "3", "--new-tokens", "3",
            "--max-len", "64"]
    main(base + ["--guard", "--deadline-ms", "60000", "--max-queue", "4"])
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["guard"] is True and last["shed"] == 2
    assert last["requests"] == 4 and last["generated"] == 12
    assert last["expired"] == last["quarantined"] == 0
    assert "lifecycle: 2 shed, 0 expired" in out
    main(base + ["--deadline-ms", "0.001"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["guard"] is False and last["expired"] == 6
    assert last["generated"] == 0
