"""The port's prefix state cache against the JAX package's, on the CPU, at
tests/test_state_cache.py's config (mamba-110m.reduced() with the JAX
package's weights, 4 slots, max_len 96, buckets (16, 32), 2 × 2 segments a
round).

* ``StateCache`` on the port's layout: the longest stored prefix wins, LRU
  at the byte budget, ``generation``, the row views; its key is the
  reference's blake2b-16 of the int32 prefix.
* The engine against the JAX engine, each script run once a side: the warm
  declared-prefix run and a rerun with no forward at all, an LRU budget of
  two entries a side (each engine's own entry bytes), the undeclared
  whole-prompt hit, the hit after ``restore``, a poisoned hit quarantined,
  ``drop_cache`` falling back cold. Greedy streams, statuses, error texts,
  the ``serve.*`` counters and the ``cache.*`` counters are equal exactly.
* Port only: the cross-lane partial hit (a packed harvest seeds a chunk
  row), prefixes of 1 and 2 tokens (zeros in the conv tail), sampled
  streams bitwise with the cache on and off, and mamba2-370m warm against
  cold.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.checkpoint import CheckpointManager as JManager  # noqa
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.faults import FaultPlan as JPlan  # noqa: E402
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.launch.state_cache import StateCache as JCache  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.launch.state_cache import (StateCache, cache_row,  # noqa
                                            load_cache_row, row_finite,
                                            state_row)
from repro_torch.models.lm import LM  # noqa: E402

KW = dict(num_slots=4, max_len=96, prefill_rows=2, buckets=(16, 32),
          max_segments=2)
COUNTERS = ("prefills", "chunk_rounds", "chunk_tokens", "chunked_prefills",
            "decode_steps", "generated", "quarantined")
PREFIX = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engines here run thousands of tiny ops: one intra-op thread
    keeps them from spinning on the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# unit level, on the port's layout
# ---------------------------------------------------------------------------

def _fake_state(fill=0.0, layers=2, width=8):
    return {"conv": torch.full((layers, 1, 3, width), fill),
            "ssm": torch.full((layers, 1, width, 4), fill)}


def _fake_logits(v=16):
    return torch.zeros(v)


def _nbytes(state, logits):
    return sum(t.numel() * t.element_size() for t in state.values()) + \
        logits.numel() * logits.element_size()


def test_lookup_longest_prefix_wins():
    sc = StateCache(1 << 20)
    toks = np.arange(1, 40, dtype=np.int32)
    sc.insert(toks, 8, _fake_state(1.0), _fake_logits())
    sc.insert(toks, 24, _fake_state(2.0), _fake_logits())
    e = sc.lookup(toks)
    assert e.prefix_len == 24 and e.state["ssm"][0, 0, 0, 0] == 2.0
    assert sc.lookup(toks[:10]).prefix_len == 8    # only the shorter fits
    other = toks.copy()
    other[3] = 999
    assert sc.lookup(other) is None
    assert sc.hits == 2 and sc.misses == 1 and sc.lookups == 3
    assert sc.registry.counter("cache.hits").value == 2
    assert "hits=2, misses=1" in repr(sc)


def test_lru_eviction_at_byte_budget():
    nbytes = _nbytes(_fake_state(), _fake_logits())
    sc = StateCache(3 * nbytes)
    prompts = [np.arange(i, i + 10, dtype=np.int32) * 7 for i in range(4)]
    for p in prompts[:3]:
        assert sc.insert(p, 10, _fake_state(), _fake_logits()) is not None
    assert len(sc) == 3 and sc.nbytes == 3 * nbytes
    assert sc.registry.gauge("cache.bytes").value == 3 * nbytes
    sc.lookup(prompts[0])                       # 1 is now the LRU entry
    sc.insert(prompts[3], 10, _fake_state(), _fake_logits())
    assert len(sc) == 3 and sc.evictions == 1
    assert sc.lookup(prompts[1]) is None
    assert sc.lookup(prompts[0]) is not None
    again = sc.insert(prompts[0], 10, _fake_state(5.0), _fake_logits())
    assert again.state["ssm"].max() == 0.0 and sc.inserts == 4  # refresh
    tiny = StateCache(nbytes - 1)               # bigger than the budget
    assert tiny.insert(prompts[0], 10, _fake_state(),
                       _fake_logits()) is None
    assert len(tiny) == 0 and tiny.evictions == 0


def test_generation_tracks_content_changes():
    sc = StateCache(1 << 20)
    g0 = sc.generation
    p = np.arange(1, 20, dtype=np.int32)
    sc.insert(p, 19, _fake_state(), _fake_logits())
    assert sc.generation != g0
    g1 = sc.generation
    sc.lookup(p)
    assert sc.generation == g1
    sc.clear()
    assert sc.generation != g1 and len(sc) == 0 and sc.evictions == 1


def test_row_views_round_trip():
    """state_row / cache_row give (n_layers, 1, …); load_cache_row writes a
    row back in place, cast to the cache's dtype; row_finite sees a NaN in
    a leaf or in the logits."""
    states = {"conv": torch.arange(2 * 3 * 2 * 3 * 5, dtype=torch.float32)
              .reshape(2, 3, 2, 3, 5),
              "ssm": torch.arange(2 * 3 * 2 * 5 * 4, dtype=torch.float32)
              .reshape(2, 3, 2, 5, 4)}               # (layers, B=3, S=2, …)
    row = state_row(states, 1, 0)
    assert row["conv"].shape == (2, 1, 3, 5) and row["ssm"].shape == \
        (2, 1, 5, 4)
    assert torch.equal(row["ssm"][:, 0], states["ssm"][:, 1, 0])
    cache = {"conv": torch.zeros(2, 4, 3, 5, dtype=torch.bfloat16),
             "ssm": torch.zeros(2, 4, 5, 4)}
    load_cache_row(cache, row, 2)
    assert torch.equal(cache["conv"][:, 2],
                       row["conv"][:, 0].to(torch.bfloat16))
    assert cache["ssm"][:, [0, 1, 3]].abs().sum() == 0
    cr = cache_row(cache, 2)
    assert cr["ssm"].shape == (2, 1, 5, 4)
    assert torch.equal(cr["ssm"], row["ssm"])
    assert row_finite(cr, torch.zeros(7))
    assert not row_finite(cr, torch.tensor([0.0, float("nan")]))
    cache["ssm"][1, 2, 0, 0] = float("inf")
    assert not row_finite(cache_row(cache, 2), torch.zeros(7))


@pytest.mark.parametrize("n", [1, 7, 33])
def test_key_is_the_references(n):
    toks = np.random.default_rng(n).integers(1, 50280, size=40)
    for P in (1, n, 40):
        assert StateCache._key(toks, P) == JCache._key(toks, P)
    assert StateCache._key(toks.astype(np.int64), n) == \
        JCache._key(toks.astype(np.int32), n)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

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


def _shared_prompts(n=5, tail=5, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 128, size=PREFIX)
    return [np.concatenate([shared, rng.integers(1, 128, size=tail)])
            .astype(np.int32) for _ in range(n)]


class Side:
    """One package's engine, cache, plan and checkpoint classes."""

    def __init__(self, make, cache, plan, manager, entry_bytes):
        self.make, self.Cache, self.Plan = make, cache, plan
        self.Manager, self.entry_bytes = manager, entry_bytes


def _jax_side(pair):
    jmodel, jparams, _ = pair

    def make(**kw):
        eng = JEngine(jmodel, jparams, **dict(KW, **kw))
        ready = eng._prefill_ready

        def steady(inf):                # the plan alone shapes the schedule
            jax.block_until_ready(inf["tok"])
            return ready(inf)

        eng._prefill_ready = steady
        return eng

    one = jmodel.init_cache(1, KW["max_len"])
    nbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(one)) + \
        jmodel.cfg.vocab * 4
    return Side(make, JCache, JPlan,
                lambda d: JManager(d, async_save=False), nbytes)


def _port_side(pair):
    model = pair[2]
    one = model.init_cache(1)
    nbytes = sum(t.numel() * t.element_size() for t in one.values()) + \
        model.cfg.vocab * 4
    return Side(lambda **kw: ServeEngine(model, **dict(KW, **kw)),
                StateCache, FaultPlan, CheckpointManager, nbytes)


def _summary(eng, sc):
    return {"outputs": {r: list(map(int, o)) for r, o in eng.outputs.items()},
            "status": dict(eng.status), "errors": dict(eng.errors),
            "counters": {k: getattr(eng.stats, k) for k in COUNTERS},
            "cache": {"hits": sc.hits, "misses": sc.misses,
                      "inserts": sc.inserts, "evictions": sc.evictions,
                      "entries": len(sc)}}


def _warm(side, tmp, entries=64):
    prompts = _shared_prompts()
    sc = side.Cache(entries * side.entry_bytes)
    out = []
    for _ in range(2):                  # warm, then the rerun
        eng = side.make(state_cache=sc)
        for p in prompts:
            eng.submit(p, 6, prefix_len=PREFIX)
        eng.run()
        out.append(_summary(eng, sc))
    return out


def _undeclared(side, tmp):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=9).astype(np.int32)
               for _ in range(4)]
    sc = side.Cache(64 * side.entry_bytes)
    out = []
    for _ in range(2):
        eng = side.make(state_cache=sc)
        for p in prompts:
            eng.submit(p, 6)
        eng.run()
        out.append(_summary(eng, sc))
    return out


def _restore(side, tmp):
    prompts = _shared_prompts(n=3, seed=1)
    sc = side.Cache(64 * side.entry_bytes)
    e1 = side.make(state_cache=sc)
    for p in prompts:
        e1.submit(p, 5, prefix_len=PREFIX)
    e1.run()
    first = _summary(e1, sc)
    mgr = side.Manager(str(tmp))
    e1.snapshot(mgr, blocking=True)
    e2 = side.make(state_cache=sc)
    e2.restore(mgr)
    for i, p in enumerate(prompts):
        e2.submit(p, 5, prefix_len=PREFIX, rid=100 + i)
    e2.run()
    return [first, _summary(e2, sc)]


def _faulted(plan_kw):
    def script(side, tmp):
        sc = side.Cache(64 * side.entry_bytes)
        eng = side.make(state_cache=sc, faults=side.Plan(**plan_kw))
        for p in _shared_prompts(n=4, seed=2):
            eng.submit(p, 5, prefix_len=PREFIX)
        eng.run()
        return [dict(_summary(eng, sc), guard=eng.guard)]
    return script


SCRIPTS = {"warm": _warm,
           "lru_two_entries": lambda side, tmp: _warm(side, tmp, entries=2),
           "undeclared": _undeclared, "restore": _restore,
           "poison_hit": _faulted(dict(poison_cache_hit=[0])),
           "drop_cache": _faulted(dict(drop_cache=1))}


def _runs(side, tmp_path_factory):
    """name → ``side``'s summaries under that script, each run once."""
    done = {}

    def run(name):
        if name not in done:
            done[name] = SCRIPTS[name](side, tmp_path_factory.mktemp(name))
        return done[name]

    return run


@pytest.fixture(scope="module")
def jax_runs(pair, tmp_path_factory):
    return _runs(_jax_side(pair), tmp_path_factory)


@pytest.fixture(scope="module")
def port_runs(pair, tmp_path_factory):
    return _runs(_port_side(pair), tmp_path_factory)


def _cold(pair, prompts, budget):
    eng = ServeEngine(pair[2], **KW)
    for p in prompts:
        eng.submit(p, budget)
    return eng.run()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_engine_matches_jax(jax_runs, port_runs, name):
    assert port_runs(name) == jax_runs(name)


def test_warm_hit_is_the_cold_stream_and_the_rerun_runs_no_forward(
        pair, port_runs):
    warm, rerun = port_runs("warm")
    prompts = _shared_prompts()
    assert warm["outputs"] == _cold(pair, prompts, 6)
    assert warm["cache"]["hits"] >= len(prompts) - 1
    assert warm["counters"]["chunk_tokens"] < sum(map(len, prompts))
    assert warm["counters"]["prefills"] == 0
    assert rerun["outputs"] == warm["outputs"]
    assert rerun["counters"]["prefills"] == 0
    assert rerun["counters"]["chunk_rounds"] == 0
    two = port_runs("lru_two_entries")
    assert two[1]["outputs"] == warm["outputs"]
    assert two[1]["cache"]["evictions"] > 0 and \
        two[1]["cache"]["entries"] == 2


def test_fault_seams_fail_only_their_request(pair, port_runs):
    poisoned, = port_runs("poison_hit")
    ref = _cold(pair, _shared_prompts(n=4, seed=2), 5)
    failed = [r for r, s in poisoned["status"].items() if s == "failed"]
    assert poisoned["guard"] and len(failed) == 1
    assert poisoned["counters"]["quarantined"] == 1
    assert "quarantined" in poisoned["errors"][failed[0]]
    for r, s in poisoned["status"].items():
        if s == "done":
            assert poisoned["outputs"][r] == ref[r]
    dropped, = port_runs("drop_cache")
    assert dropped["outputs"] == ref and dropped["cache"]["evictions"] >= 1


def test_hit_after_restore_runs_no_forward(port_runs):
    e1, e2 = port_runs("restore")
    assert [e2["outputs"][100 + i] for i in range(3)] == \
        [e1["outputs"][i] for i in range(3)]
    assert e2["cache"]["hits"] > e1["cache"]["hits"]
    assert e2["counters"]["prefills"] == e2["counters"]["chunk_rounds"] == 0


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

def test_packed_harvest_seeds_a_chunk_row(pair):
    """Cross-lane: a 9-token prompt lands through the packed lane and is
    stored whole; a 15-token prompt that extends it hits it and prefills
    only its 6-token suffix on a chunk row seeded from the packed harvest.
    The stored conv tail equals the chunk lane's carried tail for the same
    prompt, and the stream is the cold one."""
    model = pair[2]
    rng = np.random.default_rng(5)
    a = rng.integers(1, 128, size=9).astype(np.int32)
    b = np.concatenate([a, rng.integers(1, 128, size=6)]).astype(np.int32)
    sc = StateCache(1 << 20)
    eng = ServeEngine(model, state_cache=sc, **KW)
    ra = eng.submit(a, 4)
    eng.run()
    assert eng.stats.prefills == 1 and sc.inserts == 1
    rb = eng.submit(b, 4)
    out = eng.run()
    assert sc.hits == 1 and eng.stats.chunk_tokens == 6
    assert eng.stats.prefills == 1 and eng.stats.chunked_prefills == 1
    assert out[rb] == _cold(pair, [b], 4)[0]
    assert out[ra] == _cold(pair, [a], 4)[0]
    stored = sc.lookup(a).state
    chunk = model.init_cache(1)
    model.prefill_chunk(chunk, {"tokens": a[None],
                                "positions": np.arange(9)[None],
                                "segment_ids": np.ones((1, 9), np.int32)},
                        np.zeros(1, np.int32))
    for k in ("conv", "ssm"):
        torch.testing.assert_close(stored[k], chunk[k], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("prefix", [1, 2])
def test_prefix_shorter_than_the_conv_leaves_zeros(pair, prefix):
    """A declared prefix shorter than d_conv − 1 stores a conv tail with
    zeros in front of its tokens' inputs; the warm streams and the rerun's
    are the cold ones."""
    model = pair[2]
    W = model.cfg.d_conv
    rng = np.random.default_rng(prefix)
    head = rng.integers(1, 128, size=prefix)
    prompts = [np.concatenate([head, rng.integers(1, 128, size=n)])
               .astype(np.int32) for n in (4, 7, 5)]
    ref = _cold(pair, prompts, 5)
    sc = StateCache(1 << 20)
    for _ in range(2):
        eng = ServeEngine(model, state_cache=sc, **KW)
        for p in prompts:
            eng.submit(p, 5, prefix_len=prefix)
        assert eng.run() == ref
    conv = sc.lookup(head).state["conv"]
    assert sc.lookup(head).prefix_len == prefix
    assert conv[:, :, :W - 1 - prefix].abs().max() == 0
    assert conv[:, :, W - 1 - prefix:].abs().min() > 0


def test_sampled_streams_bitwise_with_the_cache_on_and_off(pair):
    """A request's first token on a whole-prompt hit is drawn from the
    stored logits at counter 0 of (sample_seed, rid), as a cold landing
    draws it: sampled streams are bitwise equal cold, warm and rerun."""
    model = pair[2]
    prompts = _shared_prompts(n=4, seed=7)
    knobs = [dict(temperature=0.8, top_k=20), dict(temperature=1.1),
             dict(temperature=0.0), dict(temperature=0.7, top_p=0.9)]

    def run(sc, **kw):
        eng = ServeEngine(model, sample_seed=3, state_cache=sc, **KW)
        for p, k in zip(prompts, knobs):
            eng.submit(p, 6, **k, **kw)
        return eng.run(), eng

    cold, _ = run(None)
    sc = StateCache(1 << 20)
    warm, _ = run(sc, prefix_len=PREFIX)
    rerun, eng = run(sc, prefix_len=PREFIX)
    assert warm == cold and rerun == cold
    assert eng.stats.prefills == eng.stats.chunk_rounds == 0


def test_mamba2_warm_equals_cold():
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(),
                              dtype="float32")
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    shared = rng.integers(1, cfg.vocab, size=PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab, size=n)])
               .astype(np.int32) for n in (3, 6, 4, 5)]

    def run(sc, **kw):
        eng = ServeEngine(model, state_cache=sc, **KW)
        for p in prompts:
            eng.submit(p, 5, **kw)
        return eng.run(), eng

    cold, _ = run(None)
    sc = StateCache(1 << 22)
    warm, weng = run(sc, prefix_len=PREFIX)
    rerun, reng = run(sc, prefix_len=PREFIX)
    assert warm == cold and rerun == cold
    assert sc.hits >= 3 + 4 and weng.stats.prefills == 0
    assert reng.stats.prefills == reng.stats.chunk_rounds == 0
