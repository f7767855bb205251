"""Speculative decode in the port against the JAX package's, on the CPU, at
tests/test_state_cache.py's config (mamba-110m.reduced() with the JAX
package's weights, 4 slots, max_len 96, buckets (16, 32)).

* ``LM.decode_verify`` is K+1 plain ``decode_step``s bit for bit (tokens,
  finiteness, every trajectory entry) and leaves the cache it read as it
  was; ``LM.spec_rollback`` selects each row's entry in place.
* The engine with ``spec_k`` 2 and 4 against the JAX engine's: greedy
  streams, statuses and the ``spec.rounds`` / ``spec.proposed`` /
  ``spec.accepted`` counters equal exactly, and the streams are the plain
  engine's. Each JAX engine runs once.
* EOS and budget cuts of an accepted draft; a sampled request keeps every
  step plain while it is active; the launcher's ``--cache-mb``,
  ``--shared-prefix`` and ``--spec-k`` through ``--device cpu``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import ServeEngine, main  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

KW = dict(num_slots=4, max_len=96, prefill_rows=2, buckets=(16, 32),
          max_segments=2)
SPEC = ("rounds", "proposed", "accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engines here run thousands of tiny ops: one intra-op thread
    keeps them from spinning on the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _prompts():
    """Three random prompts and two made of a repeated block (drafts the
    n-gram copy can get right)."""
    rng = np.random.default_rng(0)
    out = [rng.integers(1, 128, size=8).astype(np.int32) for _ in range(3)]
    for n in (5, 7):
        block = rng.integers(1, 128, size=n)
        out.append(np.tile(block, 3).astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# the model calls
# ---------------------------------------------------------------------------

def _filled_cache(model, n, seed):
    g = torch.Generator().manual_seed(seed)
    cache = model.init_cache(n)
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=g).to(v.dtype))
    return cache


@pytest.mark.parametrize("K", [1, 3])
def test_decode_verify_is_k_plus_one_plain_steps(pair, K):
    model = pair[2]
    cache = _filled_cache(model, 3, K)
    before = {k: v.clone() for k, v in cache.items()}
    rng = np.random.default_rng(K)
    tok0 = torch.as_tensor(rng.integers(1, 128, size=(3, 1)),
                           dtype=torch.int32)
    draft = torch.as_tensor(rng.integers(1, 128, size=(3, K)),
                            dtype=torch.int32)
    toks, fins, traj = model.decode_verify(cache, tok0, draft)
    for k in cache:
        assert torch.equal(cache[k], before[k])     # read, not advanced
    plain = {k: v.clone() for k, v in before.items()}
    inputs = torch.cat([tok0, draft], 1)
    for j in range(K + 1):
        logits, plain = model.decode_step(plain, inputs[:, j:j + 1])
        assert torch.equal(toks[:, j], B.greedy_tokens(logits))
        assert fins[:, j].all()
        for k in plain:
            assert torch.equal(traj[k][j], plain[k]), (j, k)
    assert toks.shape == fins.shape == (3, K + 1)


def test_spec_rollback_selects_each_row(pair):
    model = pair[2]
    cache = _filled_cache(model, 4, 0)
    draft = torch.ones((4, 3), dtype=torch.int32)
    _, _, traj = model.decode_verify(cache, torch.ones((4, 1),
                                                       dtype=torch.int32),
                                     draft)
    held = {k: v for k, v in cache.items()}
    idx = torch.tensor([2, 0, 3, 1])
    out = model.spec_rollback(cache, traj, idx)
    assert out is cache and all(held[k] is cache[k] for k in cache)
    for b, j in enumerate(idx.tolist()):
        for k in cache:
            assert torch.equal(cache[k][:, b], traj[k][j][:, b]), (b, k)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _summary(eng, spec):
    return {"outputs": {r: list(map(int, o)) for r, o in eng.outputs.items()},
            "status": dict(eng.status),
            "decode_steps": eng.stats.decode_steps,
            "spec": {k: spec[k].value for k in SPEC}}


def _jax_run(pair, k):
    jmodel, jparams, _ = pair
    eng = JEngine(jmodel, jparams, spec_k=k, **KW)
    ready = eng._prefill_ready

    def steady(inf):
        jax.block_until_ready(inf["tok"])
        return ready(inf)

    eng._prefill_ready = steady
    for p in _prompts():
        eng.submit(p, 24)
    eng.run()
    return _summary(eng, {"rounds": eng._spec_rounds, "proposed":
                          eng._spec_proposed, "accepted":
                          eng._spec_accepted})


def _port_run(model, k, **kw):
    eng = ServeEngine(model, spec_k=k, **dict(KW, **kw))
    for p in _prompts():
        eng.submit(p, 24)
    eng.run()
    reg = eng.obs.metrics
    return _summary(eng, {n: reg.counter(f"spec.{n}") for n in SPEC}), eng


def _once(run):
    done = {}

    def get(*key):
        if key not in done:
            done[key] = run(*key)
        return done[key]

    return get


@pytest.fixture(scope="module")
def jax_spec(pair):
    return _once(lambda k: _jax_run(pair, k))


@pytest.fixture(scope="module")
def port_spec(pair):
    """(k, guard) → the port's summary and engine, each run once."""
    return _once(lambda k, guard: _port_run(pair[2], k, guard=guard))


@pytest.mark.parametrize("k", [2, 4])
def test_engine_spec_matches_jax(jax_spec, port_spec, k):
    got, eng = port_spec(k, False)
    assert got == jax_spec(k)
    plain, _ = port_spec(0, False)
    assert got["outputs"] == plain["outputs"]
    assert got["spec"]["rounds"] > 0 and got["spec"]["accepted"] > 0
    # a round commits ≥ 1 token a slot: never more steps than plain
    assert got["decode_steps"] <= plain["decode_steps"]
    assert eng.spec_accept_rate == pytest.approx(
        got["spec"]["accepted"] / got["spec"]["proposed"])
    assert eng.obs.metrics.gauge("spec.accept_rate").value == \
        pytest.approx(eng.spec_accept_rate)


def test_spec_with_the_guard_is_bitwise_the_unguarded(port_spec):
    off, _ = port_spec(2, False)
    on, eng = port_spec(2, True)
    assert eng.guard and on == off


def test_spec_respects_eos_and_budget(pair):
    """A draft token beyond EOS or the slot's budget is never committed,
    even when the verify accepted it."""
    model = pair[2]
    prompt = _prompts()[3]
    eng = ServeEngine(model, **KW)
    rid = eng.submit(prompt, 16)
    ref = eng.run()[rid]
    eos = ref[4]
    want = ref[:ref.index(eos) + 1]
    for k in (2, 5):
        eng = ServeEngine(model, spec_k=k, **KW)
        rid = eng.submit(prompt, 16, eos=int(eos))
        assert eng.run()[rid] == want, f"spec_k={k}"
        for budget in (1, 3, 7):
            eng = ServeEngine(model, spec_k=k, **KW)
            rid = eng.submit(prompt, budget)
            assert eng.run()[rid] == ref[:budget], (k, budget)


def test_a_sampled_request_forces_the_plain_step(pair):
    """While a sampled request is active every step is the plain one (no
    verify round); streams, sampled and greedy, equal the engine's without
    speculation bit for bit."""
    model = pair[2]
    prompts = _prompts()

    def run(k):
        eng = ServeEngine(model, spec_k=k, sample_seed=4,
                          **dict(KW, num_slots=6))
        rounds = []
        verify = eng._spec_round

        def spec_round(active, step_idx):
            assert all(eng.slot_req[i].temperature == 0.0 for i in active)
            ran = verify(active, step_idx)
            rounds.append(ran)
            return ran

        eng._spec_round = spec_round
        for i, p in enumerate(prompts):
            eng.submit(p, 6 if i == 0 else 20,
                       temperature=0.9 if i == 0 else 0.0, top_k=30)
        return eng.run(), eng, rounds

    plain, _, _ = run(0)
    got, eng, rounds = run(4)
    assert got == plain
    assert any(rounds) and eng._spec_rounds.value == sum(rounds)
    eng = ServeEngine(model, spec_k=4, **KW)
    for p in prompts[:2]:
        eng.submit(p, 8, temperature=0.7)
    eng.run()
    assert eng._spec_rounds.value == 0


# ---------------------------------------------------------------------------
# the launcher's flags
# ---------------------------------------------------------------------------

def test_cli_cache_and_spec_flags_on_cpu(capsys):
    main(["--arch", "mamba-110m", "--tiny", "--device", "cpu",
          "--requests", "6", "--slots", "3", "--new-tokens", "6",
          "--max-len", "128", "--buckets", "16,32", "--cache-mb", "64",
          "--shared-prefix", "20", "--spec-k", "3"])
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert "prefix cache: StateCache(" in out
    assert "speculative decode: accept rate" in out
    assert last["cache"]["hits"] == 5 and last["cache"]["misses"] == 1
    assert last["cache"]["inserts"] == 7
    assert last["spec"]["rounds"] > 0 and last["generated"] == 36
