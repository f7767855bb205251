"""The port's serving engine on the dense family: stablelm-1.6b.reduced()
(2 layers, GQA 4 on 2) at 4 layers, f32, slots of max_len 96, so every
slot's K/V holds 96 tokens, slot t holding token t. Each lane's greedy
streams equal greedy ``prefill`` + ``decode_step`` of each request alone,
bitwise:

* the packed lane (prompts of 5–30 tokens in 16- and 32-token buckets);
* the chunk lane: a 37-token prompt in slabs of 4 and of 8;
* the prefix cache: a declared 20-token prefix stored once and restored
  into a slot with its K/V and its ``cache_len`` (a partial hit: the
  suffix is prefilled after it), then a rerun on the warm cache (full
  hits: no forward at all);
* speculative decode at ``spec_k = 3`` (the verify's K+1 copies of every
  row's K/V, rolled back by a select).

Also the ``--tiny`` serve CLI on ``--arch stablelm-1.6b``. Nothing of JAX
is compiled here: tests/test_torch_dense_serve.py holds the model's
serving entries to the JAX LM.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _dense import configs, port_model  # noqa: E402
from _threads import one_thread  # noqa: E402
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
    return port_model(configs("stablelm-1.6b", n_layers=4)[0], 0)


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


def test_prefix_cache_and_spec_decode_equal_the_reference(served):
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, size=PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, 128, size=n)])
               .astype(np.int32) for n in (3, 6, 4)]
    block = rng.integers(1, 128, size=5)
    prompts.append(np.tile(block, 5).astype(np.int32))   # drafts can hit
    ref = [_reference(served, p, NEW) for p in prompts]
    # a row is every layer's K and V at max_len: 4 × 2 × 96 × 2 × 16 × 4 B
    cfg = served.cfg
    row = cfg.n_layers * 2 * KW["max_len"] * cfg.n_kv_heads * cfg.hd * 4
    sc = StateCache(16 * row)
    warm, weng = _run(served, prompts, prefix_len=PREFIX,
                      engine=dict(state_cache=sc))
    assert sc.hits >= 2 and [warm[r] for r in sorted(warm)] == ref
    entry = next(iter(sc._entries.values()))
    assert entry.nbytes == row + cfg.vocab * 4
    assert entry.state["0_attn.k"].shape == (cfg.n_layers, 1, KW["max_len"],
                                             cfg.n_kv_heads, cfg.hd)
    rerun, reng = _run(served, prompts[:3], prefix_len=PREFIX,
                       engine=dict(state_cache=sc))
    assert reng.stats.prefills == reng.stats.chunk_rounds == 0
    assert [rerun[r] for r in sorted(rerun)] == ref[:3]
    # a budget under one row stores nothing and serves the same streams
    small = StateCache(row // 2)
    cold, _ = _run(served, prompts, prefix_len=PREFIX,
                   engine=dict(state_cache=small))
    assert len(small) == 0 and small.inserts == 0
    assert [cold[r] for r in sorted(cold)] == ref
    spec, seng = _run(served, prompts, engine=dict(spec_k=3))
    assert seng._spec_rounds.value > 0 and seng._spec_accepted.value > 0
    assert [spec[r] for r in sorted(spec)] == ref


def test_serve_cli_on_a_dense_model(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "stablelm-1.6b", "--tiny", "--device", "cpu",
          "--requests", "5", "--slots", "3", "--new-tokens", "3",
          "--buckets", "16,32", "--max-len", "96", "--cache-mb", "64",
          "--shared-prefix", "20", "--spec-k", "3"])
    out = capsys.readouterr().out
    assert '"arch": "stablelm-1.6b"' in out and '"generated": 15' in out
    assert '"chunk_rounds": 0' not in out            # a prompt over 32
