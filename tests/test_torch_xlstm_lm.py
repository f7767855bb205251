"""Port parity of the xLSTM language model and its serving: the port's
``LM`` on the pattern-unit stack against the JAX ``LM`` with the same
weights, on xlstm-125m.reduced() (two whole units: 12 layers) and on a
variant of 8 layers (one unit plus 2 tail layers that reuse its prefix);
the port's engine on that model against its own per-request reference.

* ``forward``, ``prefill_packed`` (end logits and every state), 8 chained
  ``decode_step``s from one cache (the port's ``prefill``, carried into
  the JAX tree; a reset on the way) and ``prefill_chunk`` slab by slab,
  against the JAX model: max |Δ| ≤ 1e-4 ·
  max(1, max |ref|) (chip_smoke.py's measure; the mLSTM normaliser makes
  the JAX package differ from itself by ~5e-5 of the scale between scan
  chunks 8 and 16 here); the port's packed prefill against its
  per-prompt ``prefill`` at 5e-4 of the same measure.
* the interop map (units + tail) both ways; a Mamba config's cache keys,
  shapes and parameter names as they were; ``reset_cache_rows`` giving
  −1e30 on the stabilisers, as the JAX one.
* the engine's greedy streams equal to greedy ``prefill`` + ``decode_step``
  of each request alone: on the packed lane, the chunk lane (prompts
  longer than the largest bucket), a warm ``StateCache`` and speculative
  decode with ``spec_k = 3``.

The JAX side runs jitted, its conv on the XLA path (the plain reference of
the Pallas kernel #1, which tests/test_torch_conv*.py hold the port's #1
to).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.interop import params_from_jax, to_jax_tree  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.launch.state_cache import StateCache  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

TOL = 1e-4
PACKED_TOL = 5e-4
MAX_LEN = 64
LAYERS = {"units": 12, "unit_plus_tail": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The sLSTM loop and the engines run thousands of tiny ops: one
    intra-op thread keeps them from spinning on the cores of the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# XLA's cheapest compile: the JAX side's cost here is its compiles
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_llvm_disable_expensive_passes": True})


class Pair:
    """The two models on the same weights. The weights are the port's
    ``init`` (the JAX init's distributions), carried into the JAX tree by
    ``to_jax_tree``; ``test_interop_round_trip`` holds that tree's layout
    to the JAX init's."""

    def __init__(self, n_layers):
        jcfg = dataclasses.replace(jget_config("xlstm-125m").reduced(),
                                   n_layers=n_layers)
        self.cfg = dataclasses.replace(get_config("xlstm-125m").reduced(),
                                       n_layers=n_layers)
        self.jmodel = build_model(jcfg)
        self.model = LM(self.cfg, "cpu")
        self.model.init(torch.Generator().manual_seed(n_layers))
        self.jparams = jax.tree.map(jnp.asarray, to_jax_tree(
            dict(self.model.named_parameters()), self.cfg))
        jm = self.jmodel
        self.forward = jax.jit(jm.forward, **JIT)
        self.prefill_packed = jax.jit(jm.prefill_packed, static_argnums=2,
                                      **JIT)
        self.decode_step = jax.jit(jm.decode_step, **JIT)
        self.prefill_chunk = jax.jit(jm.prefill_chunk, **JIT)
        self.init_cache = jax.jit(jm.init_cache, static_argnums=(0, 1),
                                  **JIT)
        self.reset_cache_rows = jax.jit(jm.reset_cache_rows, **JIT)

    def flat(self, tree):
        """A JAX cache or packed harvest ({"units": {name: {leaf: (n_units,
        …)}}, "tail": {name: {leaf: …}}}) in the port's flat layout:
        ``name.leaf`` with the unit's and the tail's layers stacked."""
        out = {}
        for name in tree.get("units", {}):
            for k, v in tree["units"][name].items():
                out[f"{name}.{k}"] = np.asarray(v)
        for name in tree.get("tail", {}):
            for k, v in tree["tail"][name].items():
                key = f"{name}.{k}"
                v = np.asarray(v)[None]
                out[key] = np.concatenate([out[key], v]) if key in out else v
        return out

    def tree(self, flat):
        """The inverse of ``flat`` for a decode cache: the port's flat
        cache as the JAX model's ``init_cache`` tree (copies: the port
        updates its cache in place, and JAX may alias numpy memory)."""
        n_units = self.cfg.n_layers // len(self.cfg.unit)
        like = jax.eval_shape(lambda: self.jmodel.init_cache(1, MAX_LEN))
        out = {}
        if "units" in like:
            out["units"] = {name: {k: jnp.array(flat[f"{name}.{k}"]
                                                [:n_units].numpy())
                                   for k in leaves}
                            for name, leaves in like["units"].items()}
        if "tail" in like:
            out["tail"] = {name: {k: jnp.array(flat[f"{name}.{k}"]
                                               [n_units].numpy())
                                  for k in leaves}
                           for name, leaves in like["tail"].items()}
        return out


@pytest.fixture(scope="module", params=list(LAYERS))
def pair(request):
    return Pair(LAYERS[request.param])


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def _close_tree(got, ref, tol=TOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], tol)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _packed(cfg, seed=0, lens=(11, 20, 5, 9, 14), row=32, segs=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    pb = packing.pack(prompts, row, policy="first_fit", num_rows=2)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    return prompts, pb, batch, packing.segment_ends(pb, segs)


def _one(prompt):
    n = len(prompt)
    return {"tokens": prompt[None],
            "positions": np.arange(n, dtype=np.int32)[None],
            "segment_ids": np.ones((1, n), np.int32)}


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    _, _, batch, _ = _packed(pair.cfg)
    _close(pair.model.forward(batch),
           pair.forward(pair.jparams, _jnp(batch)))


def test_prefill_packed_matches_jax_and_per_prompt(pair):
    prompts, pb, batch, ends = _packed(pair.cfg, seed=1)
    logits, states, lens = pair.model.prefill_packed(batch, ends)
    jl, js, jlens = pair.prefill_packed(pair.jparams, _jnp(batch), MAX_LEN,
                                        jnp.asarray(ends))
    _close(logits, jl)
    _close_tree(states, pair.flat(js))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            lg, cache, n = pair.model.prefill(_one(prompts[i]))
            assert int(n[0]) == int(lens[r, s]) == len(prompts[i])
            _close(logits[r, s], lg[0], PACKED_TOL)
            _close_tree({k: v[:, r, s] for k, v in states.items()},
                        {k: v[:, 0] for k, v in cache.items()}, PACKED_TOL)


def test_decode_steps_match_jax(pair):
    """The port's per-row prefill of two prompts of different lengths (its
    per-row handoff is held to the JAX blocks' in test_torch_xlstm.py, and
    to the packed one here), its cache carried into the JAX tree, then 8
    chained steps on both models on the JAX model's greedy tokens; row 1
    restarts at step 4."""
    rng = np.random.default_rng(2)
    lens = np.array([13, 7])
    toks = np.zeros((2, 13), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(1, pair.cfg.vocab, size=n)
    batch = {"tokens": toks,
             "positions": np.broadcast_to(np.arange(13, dtype=np.int32),
                                          (2, 13)).copy(),
             "segment_ids": (np.arange(13)[None] < lens[:, None]).astype(
                 np.int32)}
    lg, cache, clen = pair.model.prefill(batch)
    jlg, jcache = jnp.array(lg.numpy()), pair.tree(cache)
    jclen = jnp.array(clen.numpy())
    _close_tree(cache, pair.flat(jcache), 0.0)
    for step in range(8):
        tok = np.array(jnp.argmax(jlg, -1), np.int32)[:, None]
        reset = np.array([False, step == 4])
        lg, cache = pair.model.decode_step(cache, torch.as_tensor(tok),
                                           torch.as_tensor(reset))
        jlg, jcache = pair.decode_step(pair.jparams, jcache, jnp.asarray(tok),
                                       jclen + step, jnp.asarray(reset))
        _close(lg, jlg)
    _close_tree(cache, pair.flat(jcache))


def test_prefill_chunk_matches_jax(pair):
    """Two long prompts (17 and 10 tokens) in slabs of 7: row 1's last
    slab is all padding, an exact no-op."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, pair.cfg.vocab, size=n).astype(np.int32)
               for n in (17, 10)]
    cache = pair.model.init_cache(2)
    jcache = pair.init_cache(2, MAX_LEN)
    _close_tree(cache, pair.flat(jcache), 0.0)
    clen = torch.zeros(2, dtype=torch.int32)
    jclen = jnp.zeros((2,), jnp.int32)
    for off, _ in packing.chunk_spans(17, 7):
        entries = {i: (p, off, max(0, min(7, len(p) - off)))
                   for i, p in enumerate(prompts)}
        batch = packing.suffix_slab(entries, 2, 7)
        lg, cache, clen = pair.model.prefill_chunk(cache, batch, clen)
        jlg, jcache, jclen = pair.prefill_chunk(pair.jparams, jcache,
                                                _jnp(batch), jclen)
        _close(lg[0], jlg[0])
        _close_tree(cache, pair.flat(jcache))
    np.testing.assert_array_equal(clen.numpy(), [17, 10])


def test_interop_round_trip(pair):
    """The JAX init's tree (its shapes, from ``jax.eval_shape``) is the
    layout ``to_jax_tree`` writes and ``params_from_jax`` reads."""
    back = to_jax_tree(dict(pair.model.named_parameters()), pair.cfg)
    shapes = jax.eval_shape(pair.jmodel.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(back) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    U = len(pair.cfg.unit)
    assert pair.model.kinds == tuple(pair.cfg.unit[i % U]
                                     for i in range(pair.cfg.n_layers))
    again = params_from_jax(back, pair.cfg, "cpu")
    for k, v in pair.model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_reset_cache_rows_matches_jax(pair):
    rng = np.random.default_rng(4)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)),
        jax.eval_shape(lambda: pair.jmodel.init_cache(3, MAX_LEN)))
    cache = {k: torch.as_tensor(v.copy()) for k, v in pair.flat(jc).items()}
    fresh = np.array([True, False, True])
    out = pair.model.reset_cache_rows(cache, fresh)
    assert out is cache                              # in place
    _close_tree(cache, pair.flat(pair.reset_cache_rows(
        jc, jnp.asarray(fresh))), 0.0)
    for k, v in cache.items():
        empty = -1e30 if k.endswith(".m") else 0.0
        assert bool((v[:, fresh] == empty).all()), k
        assert not bool((v[:, 1] == empty).any()), k


@pytest.mark.parametrize("arch,leaves", [
    ("mamba-110m", {"conv": (2, 3, 3, 128), "ssm": (2, 3, 128, 16)}),
    ("mamba2-370m", {"conv": (2, 3, 3, 128), "ssm": (2, 3, 8, 16, 64)})])
def test_mamba_layout_is_unchanged(arch, leaves):
    cfg = get_config(arch).reduced()
    assert cfg.n_layers == 2 and cfg.unit in (("mamba",), ("mamba2",))
    model = LM(cfg, "cpu")
    cache = model.init_cache(3)
    assert {k: tuple(v.shape) for k, v in cache.items()} == leaves
    leaf_names = {"mamba": ["A_log", "D", "conv_b", "conv_w", "dt_b", "dt_w",
                            "in_proj", "norm", "out_proj", "x_proj"],
                  "mamba2": ["A_log", "D", "bc_proj", "conv_b", "conv_w",
                             "dt_b", "dt_proj", "in_proj", "norm",
                             "out_proj"]}[cfg.unit[0]]
    assert sorted(k for k, _ in model.named_parameters()) == sorted(
        ["embed", "final_norm", "head"]
        + [f"layers.{i}.{n}" for i in range(2) for n in leaf_names])
    model.init(torch.Generator().manual_seed(0))
    _, _, batch, ends = _packed(cfg, lens=(5, 9, 7), row=16, segs=2)
    _, states, _ = model.prefill_packed(batch, ends)
    assert {k: tuple(v.shape) for k, v in states.items()} == {
        k: s[:1] + (2, 2) + s[2:] for k, s in leaves.items()}


def test_counts_and_dry_run_cells_match_jax():
    """``active_params`` and model FLOPs equal the JAX package's for
    xlstm-125m (the JAX count walks its init's shapes); the dry run's cells
    are the JAX ones and each gives a ``skip`` record naming slice 7b."""
    from repro.launch import shapes as jshapes
    from repro.roofline import analysis as jan
    from repro_torch.launch import dryrun, shapes
    from repro_torch.roofline import analysis as an
    for cfg, jcfg in ((get_config("xlstm-125m"), jget_config("xlstm-125m")),
                      (dataclasses.replace(get_config("xlstm-125m")
                                           .reduced(), n_layers=8),
                       dataclasses.replace(jget_config("xlstm-125m")
                                           .reduced(), n_layers=8))):
        assert an.active_params(cfg) == jan.active_params(jcfg)
        assert an.model_flops_per_step(cfg, "prefill", 32, 32768) == \
            jan.model_flops_per_step(jcfg, "prefill", 32, 32768)
    for s in shapes.SHAPES:
        assert shapes.cell_supported(get_config("xlstm-125m"), s) == \
            jshapes.cell_supported(jget_config("xlstm-125m"), s)
        rec = dryrun.run_cell("xlstm-125m", s, None,
                              card="NVIDIA H100 80GB HBM3")
        assert rec["status"] == "skip" and "slice 7b" in rec["reason"]


def test_serve_cli_on_xlstm(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "xlstm-125m", "--tiny", "--device", "cpu",
          "--requests", "5", "--slots", "3", "--new-tokens", "3",
          "--buckets", "16,32", "--max-len", "64"])
    out = capsys.readouterr().out
    assert '"arch": "xlstm-125m"' in out and '"generated": 15' in out
    assert '"chunk_rounds": 0' not in out            # a prompt over 32


# ---------------------------------------------------------------------------
# the port's engine against its own per-request reference
# ---------------------------------------------------------------------------

KW = dict(num_slots=4, max_len=96, prefill_rows=2, buckets=(16, 32),
          max_segments=2)
NEW = 5
PREFIX = 20


@pytest.fixture(scope="module")
def served():
    cfg = get_config("xlstm-125m").reduced()
    model = LM(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    return model


def _reference(model, prompt, n):
    """Greedy ``prefill`` + ``decode_step`` of one request alone."""
    lg, cache, _ = model.prefill(_one(prompt))
    out = []
    for _ in range(n):
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
        lg, cache = model.decode_step(cache, torch.tensor([[tok]],
                                                          dtype=torch.int32))
    return out


def _run(model, prompts, **kw):
    eng = ServeEngine(model, **dict(KW, **kw.pop("engine", {})))
    for p in prompts:
        eng.submit(p, NEW, **kw)
    return eng.run(), eng


def test_engine_lanes_equal_the_per_request_reference(served):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (5, 12, 30, 9, 45, 70, 17)]   # 45 and 70: chunk lane
    outs, eng = _run(served, prompts)
    assert eng.stats.prefills > 0 and eng.stats.chunk_rounds > 0
    assert [outs[r] for r in sorted(outs)] == [
        _reference(served, p, NEW) for p in prompts]


def test_warm_state_cache_and_spec_decode_equal_the_reference(served):
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 128, size=PREFIX)
    prompts = [np.concatenate([shared, rng.integers(1, 128, size=n)])
               .astype(np.int32) for n in (3, 6, 4)]
    block = rng.integers(1, 128, size=5)
    prompts.append(np.tile(block, 5).astype(np.int32))   # drafts can hit
    ref = [_reference(served, p, NEW) for p in prompts]
    sc = StateCache(1 << 24)
    warm, weng = _run(served, prompts, prefix_len=PREFIX,
                      engine=dict(state_cache=sc))
    assert sc.hits >= 2 and [warm[r] for r in sorted(warm)] == ref
    spec, seng = _run(served, prompts, engine=dict(spec_k=3))
    assert seng._spec_rounds.value > 0
    assert [spec[r] for r in sorted(spec)] == ref
