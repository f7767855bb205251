"""Port parity of the serve engine: the port's ServeEngine and the JAX
ServeEngine, both with overlap=False, chunk_rows=0, give the same greedy
token streams — mid-flight refills and EOS included — and the same counts,
from the same weights (mamba-110m.reduced(), JAX side with use_pallas=True).

A stream may leave the JAX one only where that step's top-2 logit gap is
below 1e-5 (a tie the two packages may break apart). Also: the port's
device rule and its independence from JAX.
"""
import dataclasses
import os
import subprocess
import sys

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
from repro_torch.kernels import conv1d_pack as kconv  # noqa: E402
from repro_torch.launch.serve import ServeEngine, main  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ENGINE_KW = dict(num_slots=3, max_len=64, prefill_rows=2, buckets=(16, 32),
                 max_segments=2, refill_threshold=1)
TIE_GAP = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba-110m").reduced(),
                               use_pallas=True)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("mamba-110m").reduced()
    model = LM(cfg, "cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 30, size=9)]
    budgets = [int(b) for b in rng.integers(3, 9, size=9)]
    return jmodel, jparams, model, prompts, budgets


def _run(engine, prompts, budgets, eos):
    for p, b in zip(prompts, budgets):
        engine.submit(p, b, eos=eos)
    return engine.run(), engine.stats


def _top2_gap(jmodel, jparams, prompt, prefix):
    """JAX logits' top-2 gap at the step that emits ``len(prefix)``-th
    token after ``prompt`` followed by ``prefix``."""
    n = len(prompt)
    lg, cache, clen = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(prompt)[None],
                  "positions": jnp.arange(n, dtype=jnp.int32)[None],
                  "segment_ids": jnp.ones((1, n), jnp.int32)}, 64)
    for t, tok in enumerate(prefix):
        lg, cache = jmodel.decode_step(
            jparams, cache, jnp.asarray([[tok]], jnp.int32), clen + t)
    top = np.sort(np.asarray(lg[0]))[-2:]
    return float(top[1] - top[0])


def _assert_streams_agree(pair, j_outs, t_outs):
    jmodel, jparams, _, prompts, _ = pair
    assert sorted(j_outs) == sorted(t_outs)
    for rid in j_outs:
        a, b = j_outs[rid], t_outs[rid]
        if a == b:
            continue
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = _top2_gap(jmodel, jparams, prompts[rid], a[:i])
        assert gap < TIE_GAP, (rid, i, gap)


@pytest.mark.parametrize("eos_mode", ["budget", "eos"])
def test_engine_streams_and_counts_match_jax(pair, eos_mode):
    jmodel, jparams, model, prompts, budgets = pair
    eos = -1
    if eos_mode == "eos":
        free, _ = _run(JEngine(jmodel, jparams, overlap=False, chunk_rows=0,
                               **ENGINE_KW), prompts, budgets, -1)
        eos = free[0][2]                  # a token greedy decode emits
    j_outs, jst = _run(JEngine(jmodel, jparams, overlap=False, chunk_rows=0,
                               **ENGINE_KW), prompts, budgets, eos)
    t_outs, tst = _run(ServeEngine(model, overlap=False, chunk_rows=0,
                                   **ENGINE_KW), prompts, budgets, eos)
    _assert_streams_agree(pair, j_outs, t_outs)
    assert (tst.prefills, tst.decode_steps, tst.midflight_refills) == \
        (jst.prefills, jst.decode_steps, jst.midflight_refills)
    assert tst.midflight_refills > 0
    assert tst.buckets == jst.buckets
    assert tst.generated == sum(len(o) for o in t_outs.values())
    assert len(tst.ttft_ms) == len(prompts)
    if eos_mode == "eos":
        assert any(o and o[-1] == eos and len(o) < b
                   for o, b in zip(t_outs.values(), budgets))
    else:
        assert [len(t_outs[i]) for i in range(len(prompts))] == budgets
    assert kconv.LAUNCHES == 0            # the CPU path never launches


def test_submit_validation(pair):
    """The JAX engine's checks: an over-bucket prompt is refused only with
    the chunk lane off (chunk_rows=0); max_prompt_len bounds the prompt;
    top_k and top_p are range-checked; bucket_policy is named."""
    _, _, model, prompts, _ = pair
    eng = ServeEngine(model, **ENGINE_KW)
    long_rid = eng.submit(np.arange(1, 40), 2)    # the chunk lane takes it
    with pytest.raises(ValueError):
        eng.submit(prompts[0], 64)                # over the slot capacity
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit([], 2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(prompts[0], 0)
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(prompts[0], 2, temperature=-0.5)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(prompts[0], 2, top_k=-5)
    for p in (0.0, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            eng.submit(prompts[0], 2, top_p=p)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(prompts[0], 2, rid=long_rid)
    eng.submit(prompts[0], 2, temperature=0.7, top_k=3, top_p=0.9)
    with pytest.raises(RuntimeError):             # would clobber slots
        eng.decode_batch([prompts[0]], 2)
    outs = eng.run()
    assert eng.status[long_rid] == "done" and len(outs[long_rid]) == 2
    assert eng.stats.chunked_prefills == 1
    unchunked = ServeEngine(model, chunk_rows=0, **ENGINE_KW)
    with pytest.raises(ValueError, match="chunked prefill is unavailable"):
        unchunked.submit(np.arange(1, 40), 2)
    bounded = ServeEngine(model, max_prompt_len=16, **ENGINE_KW)
    with pytest.raises(ValueError, match="max_prompt_len"):
        bounded.submit(np.arange(1, 18), 2)
    bounded.submit(np.arange(1, 17), 2)           # at the bound: fine
    with pytest.raises(ValueError, match="bucket_policy"):
        ServeEngine(model, bucket_policy="widest", **ENGINE_KW)


def test_lm_device_rule():
    cfg = get_config("mamba-110m").reduced()
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(cfg)
        with pytest.raises(RuntimeError):
            main(["--arch", "mamba-110m", "--tiny"])


def test_cli_tiny_on_cpu(capsys):
    main(["--arch", "mamba-110m", "--tiny", "--device", "cpu",
          "--requests", "5", "--slots", "3", "--new-tokens", "3",
          "--max-len", "64"])
    out = capsys.readouterr().out
    assert '"requests": 5' in out and '"generated": 15' in out


def test_port_imports_without_jax_or_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'repro') and sys.modules[m] is not None]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
