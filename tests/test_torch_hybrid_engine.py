"""The port's serving engine on the hybrid family: recurrentgemma-2b.reduced()
at 8 layers (two units and the two tail ``rec`` layers) with the attention
window at 8, so every slot's K/V ring has 8 slots and every prompt here
wraps it. Each lane's greedy streams equal greedy ``prefill`` +
``decode_step`` of each request alone, bitwise:

* the packed lane (prompts of 5–30 tokens in 16- and 32-token buckets);
* the chunk lane: a 37-token prompt in slabs of 4 and of 8 (the ring's
  size; a ``chunk_size`` above it is refused at construction);
* a warm ``StateCache`` (a declared 20-token prefix, stored once and
  restored with its ring and its ``cache_len``), then a rerun on it;
* speculative decode at ``spec_k = 3`` (the verify's K+1 copies of the
  ring, rolled back by a select);
* a kill before decode step 3 and a restore of the last snapshot into a
  fresh engine (the ring carried through the checkpoint unchanged).

Also the ``--tiny`` serve CLI on ``--arch recurrentgemma-2b``. Nothing of
JAX is compiled here: tests/test_torch_hybrid_serve.py holds the model's
serving entries to the JAX LM.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hybrid import LAYERS, configs, port_model  # noqa: E402
from _threads import one_thread  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.faults import EngineKilled, FaultPlan  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.launch.state_cache import StateCache  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

KW = dict(num_slots=4, max_len=96, prefill_rows=2, buckets=(16, 32),
          max_segments=2, chunk_size=8)
NEW = 6
PREFIX = 20
LONG = 37


@pytest.fixture(scope="module")
def served():
    return port_model(configs(LAYERS["units_plus_tail"])[0], 0)


def _one(prompt):
    n = len(prompt)
    return {"tokens": prompt[None],
            "positions": np.arange(n, dtype=np.int32)[None],
            "segment_ids": np.ones((1, n), np.int32)}


def _reference(model, prompt, n):
    """Greedy ``prefill`` + ``decode_step`` of one request alone."""
    lg, cache, clen = model.prefill(_one(prompt), KW["max_len"])
    out = []
    for _ in range(n):
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
        lg, cache = model.decode_step(
            cache, torch.tensor([[tok]], dtype=torch.int32), cache_len=clen)
        clen = clen + 1
    return out


def _run(model, prompts, **kw):
    eng = ServeEngine(model, **dict(KW, **kw.pop("engine", {})))
    for p in prompts:
        eng.submit(p, NEW, **kw)
    return eng.run(), eng


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("chunk", [4, 8])
def test_packed_and_chunk_lanes_equal_the_reference(served, chunk):
    prompts = _prompts(6, (5, 12, 30, 9, LONG, 17))
    outs, eng = _run(served, prompts, engine=dict(chunk_size=chunk))
    assert eng.stats.prefills > 0
    assert eng.stats.chunk_rounds == -(-LONG // chunk)
    assert [outs[r] for r in sorted(outs)] == [
        _reference(served, p, NEW) for p in prompts]


def test_chunk_size_above_the_ring_is_refused(served):
    with pytest.raises(ValueError, match="K/V ring of 8 slots"):
        ServeEngine(served, **dict(KW, chunk_size=9))
    # without a chunk lane there is no slab to refuse
    ServeEngine(served, **dict(KW, chunk_size=9, chunk_rows=0))


def test_warm_state_cache_and_spec_decode_equal_the_reference(served):
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, size=PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, 128, size=n)])
               .astype(np.int32) for n in (3, 6, 4)]
    block = rng.integers(1, 128, size=5)
    prompts.append(np.tile(block, 5).astype(np.int32))   # drafts can hit
    ref = [_reference(served, p, NEW) for p in prompts]
    sc = StateCache(1 << 24)
    warm, _ = _run(served, prompts, prefix_len=PREFIX,
                   engine=dict(state_cache=sc))
    assert sc.hits >= 2 and [warm[r] for r in sorted(warm)] == ref
    # a row carries the ring: 2 attention layers × k and v × 8 slots
    ring = 2 * 2 * 8 * served.cfg.n_kv_heads * served.cfg.hd * 4
    entry = next(iter(sc._entries.values()))
    assert entry.nbytes >= ring
    assert entry.state["2_attn.k"].shape[2] == 8
    rerun, reng = _run(served, prompts[:3], prefix_len=PREFIX,
                       engine=dict(state_cache=sc))
    assert reng.stats.prefills == reng.stats.chunk_rounds == 0
    assert [rerun[r] for r in sorted(rerun)] == ref[:3]
    spec, seng = _run(served, prompts, engine=dict(spec_k=3))
    assert seng._spec_rounds.value > 0
    assert [spec[r] for r in sorted(spec)] == ref


def test_kill_and_restore_carries_the_ring(served, tmp_path):
    prompts = _prompts(8, (14, 9, LONG, 21))
    ref = {i: _reference(served, p, NEW) for i, p in enumerate(prompts)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    eng = ServeEngine(served, faults=FaultPlan(kill_at_step=3), **KW)
    for p in prompts:
        eng.submit(p, NEW)
    snap = 0
    with pytest.raises(EngineKilled, match="decode step 3"):
        while True:
            eng.snapshot(mgr, step=snap)
            snap += 1
            assert eng.step(), "the fault plan never fired"
    mgr.wait()
    fresh = ServeEngine(served, **KW)
    assert fresh.restore(mgr) == snap - 1
    assert fresh.resumed
    assert fresh.run() == ref


def test_serve_cli_on_the_hybrid(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "recurrentgemma-2b", "--tiny", "--device", "cpu",
          "--requests", "5", "--slots", "3", "--new-tokens", "3",
          "--buckets", "16,32", "--max-len", "64", "--cache-mb", "64",
          "--shared-prefix", "20", "--spec-k", "3"])
    out = capsys.readouterr().out
    assert '"arch": "recurrentgemma-2b"' in out and '"generated": 15' in out
    assert '"chunk_rounds": 0' not in out            # a prompt over 32
