"""The port's telemetry (``repro_torch.obs``): the registry, tracer,
checker and bundle cases of ``tests/test_obs.py``, run on the port's
copies (and the percentile, Prometheus and Chrome outputs held equal to
``repro.obs``'s on the same inputs), plus the instrumentation contracts of
the port: the Trainer meters through the registry, the PrefetchLoader's
``data.*`` metrics, the tuner's ``tune.sweep`` / ``tune.candidate`` spans
on a CPU sweep, and ``Tracer.sync`` / the ``torch.profiler`` bridge.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro_torch.obs import (NULL_TRACER, Counter, Gauge, Histogram,  # noqa
                             MetricsRegistry, NullTracer, Obs, Tracer,
                             percentiles, profiler_session, step_region)
from repro_torch.obs.check import check_trace  # noqa: E402
from repro_torch.obs.check import main as check_main  # noqa: E402
from _threads import one_thread  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


# ---------------------------------------------------------------- percentiles

def test_percentiles_empty_and_single():
    assert percentiles([]) == {}
    out = percentiles([42.0], (50, 95, 99))
    assert out == {"p50": 42.0, "p95": 42.0, "p99": 42.0}


@pytest.mark.parametrize("n", [2, 3, 7, 100])
def test_percentiles_match_numpy_and_the_reference(rng, n):
    vals = rng.normal(size=n)
    w = rng.integers(0, 4, size=n)
    pcts = (0, 10, 50, 90, 95, 100)
    got = percentiles(vals, pcts)
    for p in pcts:
        np.testing.assert_allclose(got[f"p{p:g}"], np.percentile(vals, p),
                                   rtol=1e-12)
    assert got == jobs.percentiles(vals, pcts)
    assert percentiles(vals, pcts, weights=w) == \
        jobs.percentiles(vals, pcts, weights=w)


def test_percentiles_duplicates_and_weights():
    vals = [3.0, 1.0, 3.0, 3.0, 2.0, 1.0]
    got = percentiles(vals, (25, 50, 75))
    for p in (25, 50, 75):
        np.testing.assert_allclose(got[f"p{p:g}"], np.percentile(vals, p))
    expanded = [1.0, 1.0, 1.0, 5.0, 10.0, 10.0]
    got = percentiles([1.0, 5.0, 10.0], (50, 90, 95), weights=[3, 1, 2])
    for p in (50, 90, 95):
        np.testing.assert_allclose(got[f"p{p:g}"],
                                   np.percentile(expanded, p), rtol=1e-12)
    assert percentiles([1.0, 2.0], weights=[0, 0]) == {}
    with pytest.raises(ValueError):
        percentiles([1.0, 2.0], weights=[1.0])       # shape mismatch
    with pytest.raises(ValueError):
        percentiles([1.0, 2.0], weights=[1.0, -1.0])


# ------------------------------------------------------------------- registry

def test_registry_idempotent_and_kind_checked():
    m = MetricsRegistry()
    c = m.counter("a.x", help="first")
    assert m.counter("a.x") is c                     # idempotent handle
    with pytest.raises(ValueError, match="already registered"):
        m.gauge("a.x")
    assert m.names() == ["a.x"]


def test_registry_concurrent_increments_lose_nothing():
    m = MetricsRegistry()
    c = m.counter("hot")
    g = m.gauge("warm")
    n_threads, n_inc = 8, 2000

    def work():
        for _ in range(n_inc):
            c.inc()
            g.add(2)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == n_threads * n_inc
    assert g.value == 2 * n_threads * n_inc


def test_gauge_max_of_and_counter_set():
    g = Gauge("g")
    g.max_of(5)
    g.max_of(3)
    assert g.value == 5
    c = Counter("c")
    c.inc(7)
    c.set(0)
    assert c.value == 0


def test_histogram_summary_routes_through_percentiles():
    h = Histogram("h", buckets=(1, 2, 5, 10))
    assert h.summary() == {}                         # no observations
    for v in (0.5, 1.5, 1.5, 4.0, 20.0):             # 20 -> +inf tail
        h.observe(v)
    s = h.summary((50, 95))
    assert s["count"] == 5
    np.testing.assert_allclose(s["mean"], (0.5 + 1.5 + 1.5 + 4 + 20) / 5)
    expect = percentiles([1, 2, 5, 10, 10], (50, 95),
                         weights=[1, 2, 1, 0, 1])
    assert s["p50"] == expect["p50"] and s["p95"] == expect["p95"]
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(5, 1))             # not ascending


def test_prometheus_text_and_dict_equal_the_reference():
    out = []
    for mod in (jobs, __import__("repro_torch.obs", fromlist=["x"])):
        m = mod.MetricsRegistry()
        m.counter("train.steps", help="steps").inc(3)
        m.gauge("train.step_ms").add(12.5)
        h = m.histogram("serve.ttft_ms", (10, 100))
        h.observe(5)
        h.observe(500)
        out.append((m.prometheus_text(), m.to_dict()))
    assert out[0] == out[1]
    txt = out[1][0]
    assert "# TYPE train_steps counter" in txt and "train_steps 3" in txt
    assert 'serve_ttft_ms_bucket{le="10"} 1' in txt
    assert 'serve_ttft_ms_bucket{le="+Inf"} 2' in txt
    assert "serve_ttft_ms_count 2" in txt


# --------------------------------------------------------------------- tracer

def _scripted_clock(start=100.0, step=0.25):
    t = {"now": start}

    def clock():
        t["now"] += step
        return t["now"]

    return clock


def test_tracer_nesting_under_scripted_clock():
    tr = Tracer(clock=_scripted_clock())
    a = tr.start("outer", track="t", k=1)
    b = tr.start("inner", track="t")
    tr.finish(b)
    tr.finish(a, done=True)
    tr.instant("mark", track="t")
    evs = [e for e in tr.chrome_events() if e["ph"] != "M"]
    assert [(e["ph"], e["name"]) for e in evs] == [
        ("B", "outer"), ("B", "inner"), ("E", "inner"), ("E", "outer"),
        ("i", "mark")]
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    assert evs[0]["args"] == {"k": 1}
    assert evs[3]["args"] == {"done": True}
    assert evs[4]["s"] == "t"                        # thread-scoped instant
    # the same calls on the reference tracer give the same events
    jt = jobs.Tracer(clock=_scripted_clock())
    a = jt.start("outer", track="t", k=1)
    b = jt.start("inner", track="t")
    jt.finish(b)
    jt.finish(a, done=True)
    jt.instant("mark", track="t")
    assert jt.chrome_events() == tr.chrome_events()


def test_tracer_finish_is_tolerant_and_clamped():
    tr = Tracer(clock=_scripted_clock())
    tr.finish(None)                                  # no-op, never raises
    tr.finish(12345)                                 # unknown id ignored
    assert [e for e in tr.chrome_events() if e["ph"] != "M"] == []
    tr.complete("back", t0=2.0, t1=1.0, track="t")   # end clamps to start
    b, e = [ev for ev in tr.chrome_events() if ev["ph"] in "BE"]
    assert e["ts"] >= b["ts"]


def test_tracer_span_ctx_and_tracks():
    tr = Tracer(clock=_scripted_clock())
    with tr.span("a", track="x"):
        with tr.span("b", track="y"):                # other track: no nest
            pass
    evs = tr.chrome_events()
    tids = {e["name"]: e["tid"] for e in evs if e["ph"] == "B"}
    assert tids["a"] != tids["b"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {m["args"]["name"] for m in meta} == {"x", "y"}


def test_tracer_bounded_events():
    tr = Tracer(clock=_scripted_clock(), max_events=3)
    for i in range(5):
        tr.instant(f"e{i}")
    assert len(tr.chrome_events()) == 3              # incl. track metadata
    assert tr.dropped == 3
    assert tr.to_chrome()["otherData"]["dropped_events"] == 3


def test_tracer_sync_waits_only_for_the_card(monkeypatch):
    """``sync`` synchronizes the tensor's CUDA device and does nothing for
    a CPU tensor or a host value; the null tracer never syncs."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    tr = Tracer()
    tr.sync(torch.zeros(2))
    tr.sync(3.0)
    assert calls == []

    class FakeCuda:                     # a CUDA tensor without a card
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch, "is_tensor", lambda x: True)
    tr.sync(FakeCuda())
    NULL_TRACER.sync(FakeCuda())
    assert calls == [torch.device("cuda", 1)]


def test_chrome_export_schema_via_checker(tmp_path):
    obs = Obs.on(clock=_scripted_clock())
    with obs.tracer.span("train.step", track="train"):
        with obs.tracer.span("inner", track="train", step=0):
            obs.metrics.counter("train.steps").inc()
    obs.tracer.instant("shed", track="train")
    path = tmp_path / "trace.json"
    obs.export(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["metrics"]["train.steps"] == 1
    assert check_trace(str(path), require=["train.steps"],
                       require_spans=["train.step"]) == []
    assert any("never opens" in e for e in check_trace(
        str(path), require_spans=["train.data"]))
    assert any("missing from snapshot" in e for e in check_trace(
        str(path), require=["train.loss"]))
    # the checker flags real damage: drop an E and it reports imbalance
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if not (e["ph"] == "E" and e["name"] == "inner")]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    errs = check_trace(str(bad))
    assert any("unclosed" in e or "unbalanced" in e for e in errs)
    assert check_main([str(path), "--require", "train.steps",
                       "--require-span", "train.step"]) == 0
    assert check_main([str(bad)]) == 1


def test_checker_rejects_misnested_spans(tmp_path):
    evs = [{"ph": "B", "name": "a", "ts": 0, "pid": 1, "tid": 0},
           {"ph": "B", "name": "b", "ts": 1, "pid": 1, "tid": 0},
           {"ph": "E", "name": "a", "ts": 2, "pid": 1, "tid": 0},
           {"ph": "E", "name": "b", "ts": 3, "pid": 1, "tid": 0}]
    p = tmp_path / "cross.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    assert any("innermost" in e for e in check_trace(str(p)))
    from repro.obs.check import check_trace as jcheck
    assert check_trace(str(p)) == jcheck(str(p))


def test_timeline_text_view():
    tr = Tracer(clock=_scripted_clock())
    with tr.span("outer", track="t"):
        with tr.span("inner", track="t"):
            pass
    txt = tr.timeline("t")
    assert "-- t" in txt and "outer" in txt and "/inner" in txt
    outer_line = next(ln for ln in txt.splitlines() if ln.endswith("outer"))
    inner_line = next(ln for ln in txt.splitlines() if ln.endswith("inner"))
    assert inner_line.index("inner") > outer_line.index("outer")


def test_null_tracer_is_inert():
    nt = NULL_TRACER
    assert isinstance(nt, NullTracer) and not nt.enabled
    assert nt.start("x") is None
    nt.finish(None)
    nt.complete("x", 0, 1)
    nt.instant("x")
    nt.sync(object())
    with nt.span("x"):
        pass
    assert nt.chrome_events() == []
    assert nt.timeline() == "(tracing disabled)"
    with pytest.raises(RuntimeError):
        nt.export("/dev/null")


def test_obs_bundle_on_off():
    off = Obs.off()
    assert not off.enabled and off.tracer is NULL_TRACER
    on = Obs.on(clock=_scripted_clock())
    assert on.enabled and isinstance(on.tracer, Tracer)
    assert on.metrics.clock is on.tracer.clock


def test_profiler_bridge_on_the_cpu(tmp_path):
    """``profiler_session(None)`` captures nothing; with a directory it
    writes a Chrome trace there, which holds the ``step_region`` label."""
    with profiler_session(None) as on:
        assert on is False
    obs = Obs.on()
    with profiler_session(str(tmp_path)) as on:
        assert on is True
        with step_region(obs, "train.step", 3, track="train"):
            torch.ones(4).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "train.step#3" in names
    spans = [e for e in obs.tracer.chrome_events() if e["ph"] == "B"]
    assert [(e["name"], e["args"]) for e in spans] == [("train.step",
                                                        {"step": 3})]


# ------------------------------------------------- instrumentation contracts

def _tiny_trainer(obs, steps=3, prefetch=False):
    from repro_torch.configs.base import get_config
    from repro_torch.data.dataset import CorpusConfig, SyntheticCorpus
    from repro_torch.data.packing_loader import LoaderConfig, PackingLoader
    from repro_torch.data.prefetch import PrefetchLoader
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, constant_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, seed=0,
                                          len_min=4, len_max=48,
                                          mu=2.6, sigma=0.4))
    loader = PackingLoader(corpus, LoaderConfig(rows=2, seq_len=64,
                                                mode="pack"))
    if prefetch:
        loader = PrefetchLoader(loader, depth=2, obs=obs)
    return Trainer(model, AdamW(constant_schedule(1e-3)), loader,
                   TrainerConfig(steps=steps, log_every=10), obs=obs)


def test_trainer_metering_through_registry():
    obs = Obs.on()
    tr = _tiny_trainer(obs, prefetch=True)
    _, hist = tr.train(torch.Generator().manual_seed(0), verbose=False)
    tr.loader.close()
    assert len(hist) == 3
    m = obs.metrics
    assert m.counter("train.steps").value == 3 == tr.steps
    assert m.counter("train.real_tokens").value == tr.real_tokens == \
        sum(int(r["real_tokens"]) for r in hist)
    assert m.counter("train.buffer_tokens").value == tr.buffer_tokens == \
        3 * 2 * 64
    assert m.counter("train.compiles").value == 1    # one batch shape
    assert m.gauge("train.step_ms").value == tr.step_ms == \
        pytest.approx(sum(r["step_ms"] for r in hist))
    assert m.gauge("train.data_ms").value == tr.data_ms > 0
    assert m.gauge("train.loss").value == hist[-1]["loss"]
    # the loader shares the registry: data.* beside train.*
    assert m.counter("data.prefetch_hits").value == tr.loader.hits
    assert tr.loader.hits + tr.loader.misses == 3 and tr.loader.misses >= 1
    assert m.gauge("data.prefetch_wait_ms").value == tr.loader.wait_ms
    # per-step spans landed on the train track with the compile mark
    evs = obs.tracer.chrome_events()
    spans = [e for e in evs if e["ph"] == "B" and e["name"] == "train.step"]
    assert len(spans) == 3
    assert [s["args"]["compile"] for s in spans] == [True, False, False]
    assert len([e for e in evs if e["ph"] == "B"
                and e["name"] == "train.data"]) == 3


def test_trainer_off_records_nothing_and_equals_on():
    """Tracing may never perturb training: Obs.off() and Obs.on() give
    bitwise equal losses, and the off tracer records nothing."""
    runs = []
    for obs in (Obs.off(), Obs.on()):
        tr = _tiny_trainer(obs, steps=2)
        _, hist = tr.train(torch.Generator().manual_seed(0), verbose=False)
        runs.append([h["loss"] for h in hist])
        assert tr.steps == 2
    assert runs[0] == runs[1]
    assert Obs.off().tracer.chrome_events() == []


def test_prefetch_data_metrics_are_views():
    """Hits, misses and the blocked time live in the data.* metrics; a
    standalone loader meters into its own registry."""
    import time
    from repro_torch.data.prefetch import PrefetchLoader

    class SlowLoader:
        def batch(self, step):
            time.sleep(0.02)
            return {"step": step}

    obs = Obs.off()
    with PrefetchLoader(SlowLoader(), depth=1, obs=obs) as pf:
        assert pf.batch(0) == {"step": 0}            # miss: full 20ms wait
        time.sleep(0.05)
        assert pf.batch(1) == {"step": 1}            # hit
    m = obs.metrics
    assert (pf.hits, pf.misses) == (1, 1)
    assert m.counter("data.prefetch_hits").value == 1
    assert m.counter("data.prefetch_misses").value == 1
    assert m.gauge("data.prefetch_wait_ms").value == pf.wait_ms >= 15.0
    with PrefetchLoader(SlowLoader(), depth=1) as alone:
        alone.batch(0)
    assert alone.misses == 1 and alone.obs.metrics is not m


def test_tuner_sweep_spans_on_the_cpu():
    """One ``tune.sweep`` span per key with a ``tune.candidate`` span per
    candidate nested in it, the winner on the sweep's end, and the
    ``tune.sweeps`` / ``tune.candidates`` counters (the JAX runner's)."""
    from repro_torch.tune import runner as trunner
    from repro_torch.tune import space as tspace
    k = tspace.shape_key("selective_scan", B=1, L=16, D=8, N=16)
    obs = Obs.on()
    ranked, _ = trunner.sweep(k, rounds=1, device="cpu", obs=obs)
    n = len(tspace.space_for(k))
    evs = [e for e in obs.tracer.chrome_events() if e["ph"] in "BE"]
    assert evs[0]["name"] == "tune.sweep" and evs[-1]["name"] == \
        "tune.sweep"
    assert evs[0]["args"] == {"key": k.encode(), "candidates": n}
    assert evs[-1]["args"]["winner"] == ranked[0][0]
    assert evs[-1]["args"]["viable"] == n
    cands = [e["args"]["cand"] for e in evs if e["ph"] == "B"
             and e["name"] == "tune.candidate"]
    assert cands == [tspace.candidate_name(c) for c in tspace.space_for(k)]
    assert obs.metrics.counter("tune.sweeps").value == 1
    assert obs.metrics.counter("tune.candidates").value == n
