"""The port's scheduler v2 against the JAX engine's, on the CPU, at
mamba-110m.reduced() with the JAX package's weights (its side with
use_pallas=True: the conv is the Pallas kernel in interpret mode).

* A prompt 4× the largest bucket goes through the chunk lane while short
  requests keep decoding: greedy streams equal the JAX engine's
  (``overlap=False, chunk_rows=1``) but where the JAX logits' top-2 gap at
  the step is below 1e-5 (a tie the packages may break apart), and the
  counters (prefills, chunk rounds and tokens, chunked prefills, decode
  steps, buckets) are equal.
* The TTFT admission rule and the TTFT bucket policy under a scripted
  clock give the JAX engine's counters on the same trace.
* Overlap (the device readiness scripted to lag) and the prefill pipeline
  give the synchronous run's streams; sampled streams do not depend on the
  slot count, overlap or the pipeline.
* ``decode_batch`` (the padded wave) against the JAX one; ``ServeStats`` as
  a view of the registry; the CLI's ``--obs-trace`` passing ``obs.check``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch.serve import ServeEngine as JEngine  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import ServeEngine, ServeStats, main  # noqa
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs.check import check_trace  # noqa: E402

TIE_GAP = 1e-5
COUNTERS = ("prefills", "chunk_rounds", "chunk_tokens", "chunked_prefills",
            "decode_steps", "midflight_refills", "generated",
            "prefill_tokens")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba-110m").reduced(),
                               use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    return jmodel, jparams, model


def _top2_gap(jmodel, jparams, prompt, prefix, max_len):
    """The JAX logits' top-2 gap where ``prompt`` + ``prefix`` emits its
    next token."""
    n = len(prompt)
    lg, cache, clen = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt)[None],
                  "positions": jnp.arange(n, dtype=jnp.int32)[None],
                  "segment_ids": jnp.ones((1, n), jnp.int32)}, max_len)
    for t, tok in enumerate(prefix):
        lg, cache = jmodel.decode_step(
            jparams, cache, jnp.asarray([[tok]], jnp.int32), clen + t)
    top = np.sort(np.asarray(lg[0]))[-2:]
    return float(top[1] - top[0])


def _assert_streams_agree(pair, prompts, j_outs, t_outs, max_len):
    jmodel, jparams, _ = pair
    assert sorted(j_outs) == sorted(t_outs)
    for rid in j_outs:
        a, b = j_outs[rid], t_outs[rid]
        if a == b:
            continue
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = _top2_gap(jmodel, jparams, prompts[rid], a[:i], max_len)
        assert gap < TIE_GAP, (rid, i, gap)


def _counts(st):
    return {k: getattr(st, k) for k in COUNTERS}


def test_long_prompt_chunks_alongside_decode_match_jax(pair):
    """A 64-token prompt (4× the 16-token bucket) in 4 chunk rounds while
    four short requests decode, against the JAX engine."""
    jmodel, jparams, model = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, model.cfg.vocab, size=64).astype(np.int32)]
    prompts += [rng.integers(1, model.cfg.vocab, size=int(n)).astype(
        np.int32) for n in rng.integers(4, 14, size=4)]
    budgets = [5, 3, 4, 3, 6]
    kw = dict(num_slots=3, max_len=96, prefill_rows=2, buckets=(16,),
              max_segments=2, refill_threshold=1, chunk_size=16,
              overlap=False, chunk_rows=1)
    jeng = JEngine(jmodel, jparams, **kw)
    teng = ServeEngine(model, **kw)
    for eng in (jeng, teng):
        for p, b in zip(prompts, budgets):
            eng.submit(p, b)
    saw_decode_mid_chunk, prev = False, 0
    while teng.step():
        if teng._chunk_active() and teng.stats.decode_steps > prev:
            saw_decode_mid_chunk = True
        prev = teng.stats.decode_steps
    j_outs = jeng.run()
    assert saw_decode_mid_chunk
    _assert_streams_agree(pair, prompts, j_outs, teng.outputs, 96)
    assert _counts(teng.stats) == _counts(jeng.stats)
    assert teng.stats.buckets == jeng.stats.buckets == {(2, 16)}
    assert teng.stats.chunk_rounds == 4 and teng.stats.chunk_tokens == 64
    assert teng.stats.chunked_prefills == 1
    assert all(teng.status[r] == "done" for r in teng.outputs)
    assert [len(teng.outputs[r]) for r in range(5)] == budgets


def test_latency_aware_admission_scripted_clock_matches_jax(pair):
    """tests/test_serve.py's scripted trace on both engines: with a 50 ms
    target the second request is admitted below the refill threshold once
    its wait passes the target; without one it waits for the drain."""
    jmodel, jparams, model = pair
    rng = np.random.default_rng(5)
    a = rng.integers(1, model.cfg.vocab, size=7).astype(np.int32)
    b = rng.integers(1, model.cfg.vocab, size=9).astype(np.int32)
    t = {"now": 0.0}
    kw = dict(num_slots=2, max_len=64, prefill_rows=1, buckets=(16,),
              max_segments=1, refill_threshold=2, overlap=False,
              clock=lambda: t["now"])
    for target in (50.0, None):
        runs = {}
        for name, mk in (("jax", lambda **k: JEngine(jmodel, jparams, **k)),
                         ("port", lambda **k: ServeEngine(model, **k))):
            t["now"] = 0.0
            eng = mk(target_ttft_ms=target, **kw)
            eng.submit(a, 6)
            eng.step()                   # a admitted: nothing was decoding
            eng.submit(b, 3)
            eng.step()                   # b's wait 0 ms: stays queued
            t["now"] = 0.2               # 200 ms > the 50 ms target
            eng.step()
            mid = (eng.stats.prefills, eng.stats.early_admits,
                   len(eng.queue))
            outs = eng.run()
            runs[name] = (mid, _counts(eng.stats), eng.stats.early_admits,
                          list(eng.stats.ttft_ms), outs)
        assert runs["port"][:4] == runs["jax"][:4]
        _assert_streams_agree(pair, [a, b], runs["jax"][4], runs["port"][4],
                              64)
        if target is not None:
            assert runs["port"][0] == (2, 1, 0)
            assert runs["port"][3] == pytest.approx([0.0, 200.0])
        else:
            assert runs["port"][0] == (1, 0, 1)


def test_ttft_bucket_policy_scripted_clock_matches_jax(pair):
    """tests/test_serve.py's bucket-policy trace on both engines: with
    slack the round upgrades to the 32 bucket that admits all four
    requests; with the head already 120 ms late against a 100 ms allowance
    every round stays at the smallest fit."""
    jmodel, jparams, model = pair
    t = {"now": 0.0}
    kw = dict(num_slots=4, max_len=64, prefill_rows=1, buckets=(8, 32),
              max_segments=4, overlap=False, refill_threshold=4,
              bucket_policy="ttft", target_ttft_ms=100.0,
              clock=lambda: t["now"])
    keys = ("bucket_upgrades", "deferred_upgrades", "early_admits",
            "prefills", "queue_depth_max")
    for late in (0.0, 0.12):
        rng = np.random.default_rng(6)
        prompts = [rng.integers(1, model.cfg.vocab, size=8).astype(np.int32)
                   for _ in range(4)]
        runs = {}
        for name, mk in (("jax", lambda **k: JEngine(jmodel, jparams, **k)),
                         ("port", lambda **k: ServeEngine(model, **k))):
            t["now"] = 0.0
            eng = mk(**kw)
            for p in prompts:
                eng.submit(p, 2)
            t["now"] = late
            eng.step()
            first = {k: getattr(eng.stats, k) for k in keys}
            first["buckets"] = set(eng.stats.buckets)
            outs = eng.run()
            runs[name] = (first, _counts(eng.stats), eng.stats.buckets,
                          outs)
        assert runs["port"][:3] == runs["jax"][:3]
        _assert_streams_agree(pair, prompts, runs["jax"][3], runs["port"][3],
                              64)
        first = runs["port"][0]
        if late == 0.0:
            assert first["bucket_upgrades"] == 1 and first["prefills"] == 1
            assert first["buckets"] == {(1, 32)}
        else:
            assert first["deferred_upgrades"] == 3
            assert first["bucket_upgrades"] == 0 and first["prefills"] == 4
            assert first["buckets"] == {(1, 8)} and first["early_admits"] >= 1


def _mixed_run(model, prompts, budgets, temps, scripted_lag=False, **kw):
    eng = ServeEngine(model, max_len=64, prefill_rows=2, buckets=(16,),
                      max_segments=2, refill_threshold=1, sample_seed=11,
                      **kw)
    if scripted_lag:                     # not ready for the first 3 probes
        ready, probes = eng._prefill_ready, {"n": 0}

        def slow_device(inflight):
            probes["n"] += 1
            return probes["n"] % 4 == 0 and ready(inflight)

        eng._prefill_ready = slow_device
    rids = [eng.submit(p, b, temperature=tp, top_k=7, top_p=0.95)
            for p, b, tp in zip(prompts, budgets, temps)]
    outs = eng.run()
    return [outs[r] for r in rids], eng


def _mix(model):
    rng = np.random.default_rng(7)
    lens = [5, 40, 9, 13, 26, 7, 11, 33]     # 40/26/33 > the largest bucket
    prompts = [rng.integers(1, model.cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    budgets = [int(b) for b in rng.integers(3, 7, size=len(lens))]
    temps = [0.0, 0.7, 0.0, 0.9, 0.0, 0.8, 0.0, 0.6]
    return prompts, budgets, temps


def test_overlap_and_pipeline_identical_to_synchronous(pair):
    """The JAX engine's pipelined-engine acceptance on the port: overlap
    on with the device readiness lagging three probes, three prefills in
    flight and two chunk rows give the blocking single-prefill engine's
    streams, greedy and sampled, bit for bit."""
    _, _, model = pair
    prompts, budgets, temps = _mix(model)
    base, beng = _mixed_run(model, prompts, budgets, temps, num_slots=3,
                            overlap=False, max_inflight_prefills=1)
    for inflight in (2, 3):
        pipe, eng = _mixed_run(model, prompts, budgets, temps, num_slots=3,
                               overlap=True, max_inflight_prefills=inflight,
                               chunk_rows=2, scripted_lag=True)
        assert pipe == base
        assert eng.stats.overlapped_prefills > 0
        assert eng.stats.chunked_prefills == beng.stats.chunked_prefills == 3
        assert eng._inflight is None and not eng._active_slots()
    assert [len(o) for o in base] == budgets


def test_sampled_streams_slot_and_schedule_independent(pair):
    """A request's sampled tokens depend on (sample_seed, rid) and the
    token index only: 3 slots against 5, overlap off and on, the same
    streams; another sample_seed changes them."""
    _, _, model = pair
    prompts, budgets, temps = _mix(model)
    runs = [_mixed_run(model, prompts, budgets, temps, num_slots=s,
                       overlap=ov, scripted_lag=ov)[0]
            for s in (3, 5) for ov in (False, True)]
    assert all(r == runs[0] for r in runs[1:])
    eng = ServeEngine(model, num_slots=3, max_len=64, buckets=(16,),
                      sample_seed=12)
    rids = [eng.submit(p, b, temperature=tp, top_k=7, top_p=0.95)
            for p, b, tp in zip(prompts, budgets, temps)]
    other = eng.run()
    sampled = [i for i, tp in enumerate(temps) if tp > 0]
    assert any(other[rids[i]] != runs[0][i] for i in sampled)
    assert all(other[rids[i]] == runs[0][i] for i, tp in enumerate(temps)
               if tp == 0)


def test_decode_batch_matches_jax(pair):
    """The padded wave: greedy streams against the JAX engine's
    ``decode_batch`` (per-prompt budgets and an EOS), and equal to the
    continuous engine's on the same prompts."""
    jmodel, jparams, model = pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, model.cfg.vocab, size=n).astype(np.int32)
               for n in (8, 15, 4)]
    jw = JEngine(jmodel, jparams, num_slots=4, max_len=64).decode_batch(
        prompts, [6, 3, 5])
    tw = ServeEngine(model, num_slots=4, max_len=64).decode_batch(
        prompts, [6, 3, 5])
    _assert_streams_agree(pair, prompts, dict(enumerate(jw)),
                          dict(enumerate(tw)), 64)
    assert [len(o) for o in tw] == [6, 3, 5]
    eos = tw[0][2]
    cut = ServeEngine(model, num_slots=4, max_len=64).decode_batch(
        prompts, 6, eos=eos)
    assert cut[0] == tw[0][:tw[0].index(eos) + 1]
    eng = ServeEngine(model, num_slots=3, max_len=64, buckets=(16, 32),
                      max_segments=2)
    rids = [eng.submit(p, 6) for p in prompts]
    outs = eng.run()
    wave = eng.decode_batch(prompts, 6)          # drained: the same engine
    assert [outs[r] for r in rids] == wave
    hot = eng.decode_batch(prompts, 6, temperature=0.9, top_k=20)
    assert hot == eng.decode_batch(prompts, 6, temperature=0.9, top_k=20)
    assert [len(o) for o in hot] == [6, 6, 6]


def test_stats_are_a_view_of_the_registry(pair):
    _, _, model = pair
    obs = Obs.off()
    prompts, budgets, temps = _mix(model)
    eng = ServeEngine(model, num_slots=3, max_len=64, buckets=(16,),
                      max_segments=2, refill_threshold=1, obs=obs)
    for p, b, tp in zip(prompts, budgets, temps):
        eng.submit(p, b, temperature=tp)
    eng.run()
    snap = obs.metrics.to_dict()
    st = eng.stats
    for name in ServeStats._counters + ServeStats._gauges:
        assert snap[f"serve.{name}"] == getattr(st, name), name
    assert st.generated == sum(budgets) and st.chunk_rounds > 0
    assert snap["serve.ttft_ms"]["count"] == len(st.ttft_ms) == len(prompts)
    assert snap["serve.itl_ms"]["count"] == len(st.itl_ms) == \
        sum(budgets) - len(prompts)
    st.prefills += 1
    assert obs.metrics.to_dict()["serve.prefills"] == st.prefills
    fresh = ServeStats()
    assert fresh.ttft_percentiles() == {} and fresh.buckets == set()
    assert fresh.prefills == 0 and "prefills=0" in repr(fresh)


def test_cli_obs_trace_and_profile(tmp_path, capsys):
    """The launcher on the CPU with a prompt over the largest bucket,
    sampling, an obs trace and a torch.profiler capture."""
    trace, prof = str(tmp_path / "t.json"), str(tmp_path / "prof")
    main(["--arch", "mamba-110m", "--tiny", "--device", "cpu",
          "--requests", "6", "--slots", "3", "--new-tokens", "3",
          "--max-len", "96", "--buckets", "16,32", "--temperature", "0.8",
          "--top-k", "40", "--top-p", "0.95", "--max-inflight-prefills",
          "2", "--bucket-policy", "ttft", "--target-ttft-ms", "50",
          "--obs-trace", trace, "--profile-dir", prof])
    out = capsys.readouterr().out
    assert '"requests": 6' in out and '"generated": 18' in out
    assert '"chunk_rounds": 0' not in out          # a prompt over 32
    errs = check_trace(
        trace, require=["serve.prefills", "serve.decode_steps",
                        "serve.chunk_rounds", "serve.ttft_ms"],
        require_spans=["serve.step", "prefill_dispatch", "prefill_land",
                       "chunk_slab", "decode_step", "queued", "prefill",
                       "chunk", "decode"])
    assert errs == []
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(prof))
