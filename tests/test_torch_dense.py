"""Port parity of the dense family's configs and blocks: the four configs
against ``repro.configs`` and ``repro.roofline``, and the port's ``attn``
block without a window (full causal attention) and gated MLP against the
JAX blocks with the same weights, on the same numpy inputs (f32).

* Configs: every field the port keeps, ``unit``, ``hd``, the long_500k
  rule (``shapes.sub_quadratic``) and ``reduced()`` equal JAX's for
  stablelm-1.6b, gemma-7b, deepseek-coder-33b and deepseek-67b;
  ``active_params`` and ``model_flops_per_step`` at full size equal
  JAX's, from shapes alone; ``LM`` builds each at ``reduced()``.
* ``apply_attn`` on stablelm-1.6b.reduced() (GQA, 4 on 2) and
  gemma-7b.reduced() (head_dim 16 of a 64-wide model), packed rows of 3
  and 4 segments with padding: the forward within 1e-5 and every
  parameter's gradient within 1e-4 abs + 1e-3 rel; the per-row
  (``collect``) and per-segment (``collect_ends``) K/V handoff into a
  cache of S = max_len slots (no window: slot t holds token t), 1e-5.
* ``step_attn`` at ``cache_len`` 0, 5, 37 and 63 (the cache's last slot)
  on a filled cache: the output and the cache written at slot
  ``cache_len``; ``chunk_attn`` over a prefix of the cache (rows at
  ``cache_len`` 10, 0 and 30, one slab padded), 1e-5.
* ``apply_mlp`` with ``swiglu`` and ``geglu``, forward and gradients.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _dense import ARCHS, DENSE, configs, packed_rows  # noqa: E402
from _threads import one_thread  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.roofline import analysis as an  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

FWD_TOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
MAX_LEN = 64


def _close(got, ref, tol=FWD_TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def _params(kind, cfg, seed):
    init = blocks.KINDS[kind][0] if kind != "mlp" else blocks.MLP[0]
    p = init(cfg, torch.Generator().manual_seed(seed), "cpu")
    for k, v in p.items():          # norm scales off 1, so they are tested
        if k == "norm":
            v.add_(torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(seed + 1)) * 0.1)
    return p


def _jp(p):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}


def _ctxs(batch, **kw):
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    tk = {k: torch.as_tensor(v) for k, v in kw.items()}
    jk = {k: jnp.asarray(v) for k, v in kw.items()}
    return (blocks.Ctx(positions=t.get("positions"),
                       segment_ids=t.get("segment_ids"), **tk),
            jblocks.Ctx(positions=j.get("positions"),
                        segment_ids=j.get("segment_ids"), **jk))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", DENSE)
def test_config_and_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.family == "dense" and cfg.unit == jcfg.unit == ("attn",)
    assert cfg.hd == jcfg.hd
    assert shapes.sub_quadratic(cfg) is jcfg.sub_quadratic is False
    r, jr = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(r):
        assert getattr(r, f.name) == getattr(jr, f.name), f.name
    assert (r.n_layers, r.d_model, r.n_heads, r.hd, r.d_ff, r.vocab) == \
        (2, 64, 4, 16, 128, 128)
    assert r.n_kv_heads == min(cfg.n_kv_heads, 2)
    assert an.active_params(cfg) == jan.active_params(jcfg)
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                       ("decode", 128, 32768), ("train", 2, 4096)):
        assert an.model_flops_per_step(cfg, kind, b, s) == \
            jan.model_flops_per_step(jcfg, kind, b, s)
    model = LM(r, "cpu")
    assert model.kinds == ("attn",) * 2 and len(model.ffns) == 2
    assert (model.head is None) == cfg.tie_embeddings
    assert blocks.has_mlp(cfg) and blocks.layer_kinds(cfg) == \
        ("attn",) * cfg.n_layers


def test_stablelm_has_its_published_width():
    cfg = get_config("stablelm-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.act, cfg.tie_embeddings,
            cfg.attn_window) == (24, 2048, 32, 32, 64, 5632, 100352,
                                 "swiglu", False, None)
    # one slot's K/V at max_len 2560: 24 layers × k, v × 2560 × 32 × 64
    # bf16 values = 480 MiB
    model = LM(dataclasses.replace(cfg, dtype="bfloat16"), "meta")
    row = model.init_cache(1, 2560)
    assert sorted(row) == ["0_attn.k", "0_attn.v"]
    assert tuple(row["0_attn.k"].shape) == (24, 1, 2560, 32, 64)
    assert sum(t.numel() * t.element_size() for t in row.values()) == \
        480 * 2 ** 20


# ------------------------------------------------------------------- blocks

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_attn_forward_and_gradients_match_jax(arch):
    cfg, jcfg = configs(arch)
    assert cfg.attn_window is None
    p = _params("attn", cfg, 1)
    batch, _ = packed_rows(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=batch["tokens"].shape + (cfg.d_model,)) \
        .astype(np.float32)
    ctx, jctx = _ctxs(batch)
    xt = torch.tensor(x, requires_grad=True)
    for v in p.values():
        v.requires_grad_()
    y = blocks.apply_attn(p, xt, ctx, cfg)
    cot = rng.normal(size=y.shape).astype(np.float32)
    (y * torch.as_tensor(cot)).sum().backward()

    def jloss(jp, jx):
        out = jblocks.apply_attn(jp, jx, jctx, jcfg)
        return (out * cot).sum(), out
    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(_jp(p),
                                                          jnp.asarray(x))
    _close(y.detach(), jy)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for k, v in p.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_attn_handoff_per_row_and_per_segment(arch):
    """``collect`` = max_len: the K/V laid into S = max_len slots, per row
    (frozen at the row's valid length) and per segment (slot t of
    segment g its intra-segment token t; absent segments zero)."""
    cfg, jcfg = configs(arch)
    assert blocks.ring_size(cfg, MAX_LEN) == MAX_LEN
    p = _params("attn", cfg, 3)
    batch, ends = packed_rows(3)
    x = np.random.default_rng(4).normal(
        size=batch["tokens"].shape + (cfg.d_model,)).astype(np.float32)
    ctx, jctx = _ctxs(batch)
    with torch.no_grad():
        y, st = blocks.apply_attn(p, torch.as_tensor(x), ctx, cfg,
                                  collect=MAX_LEN)
        ys, sts = blocks.apply_attn(p, torch.as_tensor(x), ctx, cfg,
                                    collect=MAX_LEN,
                                    collect_ends=torch.as_tensor(ends))
    jy, jst = jblocks.apply_attn(_jp(p), jnp.asarray(x), jctx, jcfg,
                                 collect=MAX_LEN)
    jys, jsts = jblocks.apply_attn(_jp(p), jnp.asarray(x), jctx, jcfg,
                                   collect=MAX_LEN,
                                   collect_ends=jnp.asarray(ends))
    _close(y, jy)
    _close(ys, jys)
    for k in ("k", "v"):
        assert tuple(st[k].shape) == (2, MAX_LEN, cfg.n_kv_heads, cfg.hd)
        assert tuple(sts[k].shape) == (2, 4, MAX_LEN, cfg.n_kv_heads,
                                       cfg.hd)
        _close(st[k], jst[k])
        _close(sts[k], jsts[k])
    # segment (0, 1) (20 tokens at 11..30): slot t holds its token t
    lens = (batch["segment_ids"] > 0).sum(-1)
    assert bool((st["k"][0, lens[0]:] == 0).all())
    assert bool((sts["k"][0, 1, 20:] == 0).all())
    assert bool((sts["k"][0, 3] == 0).all())        # absent segment
    assert bool((sts["k"][0, 1, :20] != 0).any(-1).any(-1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_step_attn_matches_jax_at_several_cache_lens(arch):
    cfg, jcfg = configs(arch)
    p = _params("attn", cfg, 5)
    rng = np.random.default_rng(6)
    cache = {k: rng.normal(size=(4, MAX_LEN, cfg.n_kv_heads, cfg.hd))
             .astype(np.float32) for k in ("k", "v")}
    x = rng.normal(size=(4, 1, cfg.d_model)).astype(np.float32)
    clen = np.array([0, 5, 37, MAX_LEN - 1], np.int32)
    ctx = blocks.Ctx(cache_len=torch.as_tensor(clen))
    jctx = jblocks.Ctx(cache_len=jnp.asarray(clen))
    given = {k: torch.tensor(v) for k, v in cache.items()}
    with torch.no_grad():
        y, st = blocks.step_attn(p, torch.as_tensor(x), given, ctx, cfg)
    jy, jst = jblocks.step_attn(_jp(p), jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in cache.items()},
                                jctx, jcfg)
    _close(y, jy)
    for k in ("k", "v"):
        assert st[k] is given[k]                    # written in place
        _close(st[k], jst[k])
        rows = np.arange(4)
        keep = np.ones((4, MAX_LEN), bool)
        keep[rows, clen] = False                    # only slot cache_len
        np.testing.assert_array_equal(st[k].numpy()[keep], cache[k][keep])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_attn_over_a_prefix_matches_jax(arch):
    """A slab of 8 after a cached prefix of 10, 0 and 30 tokens (row 2's
    slab 5 valid tokens, then padding): one softmax over the prefix and
    the slab's causal keys, then the slab's K/V at slots cache_len + t."""
    cfg, jcfg = configs(arch)
    p = _params("attn", cfg, 7)
    rng = np.random.default_rng(8)
    cache = {k: rng.normal(size=(3, MAX_LEN, cfg.n_kv_heads, cfg.hd))
             .astype(np.float32) for k in ("k", "v")}
    T = 8
    clen = np.array([10, 0, 30], np.int32)
    pos = (clen[:, None] + np.arange(T)[None]).astype(np.int32)
    seg = np.ones((3, T), np.int32)
    seg[2, 5:] = 0
    pos[2, 5:] = 0
    batch = {"positions": pos, "segment_ids": seg}
    x = rng.normal(size=(3, T, cfg.d_model)).astype(np.float32)
    ctx, jctx = _ctxs(batch, cache_len=clen)
    with torch.no_grad():
        y, st = blocks.chunk_attn(p, torch.as_tensor(x),
                                  {k: torch.tensor(v)
                                   for k, v in cache.items()}, ctx, cfg)
    jy, jst = jblocks.chunk_attn(_jp(p), jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in cache.items()},
                                 jctx, jcfg)
    _close(y[seg > 0], np.asarray(jy)[seg > 0])
    for k in ("k", "v"):
        _close(st[k], jst[k])
    # the padding is never written
    np.testing.assert_array_equal(st["k"].numpy()[2, 35:], cache["k"][2, 35:])


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_apply_mlp_matches_jax(act):
    arch = "stablelm-1.6b" if act == "swiglu" else "gemma-7b"
    cfg, jcfg = configs(arch)
    assert cfg.act == act
    p = _params("mlp", cfg, 9)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    for v in p.values():
        v.requires_grad_()
    y = blocks.apply_mlp(p, xt, blocks.Ctx(), cfg)
    cot = rng.normal(size=y.shape).astype(np.float32)
    (y * torch.as_tensor(cot)).sum().backward()

    def jloss(jp, jx):
        out = jblocks.apply_mlp(jp, jx, jblocks.Ctx(), jcfg)
        return (out * cot).sum(), out
    (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(_jp(p),
                                                          jnp.asarray(x))
    _close(y.detach(), jy)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for k, v in p.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)
