"""Port parity of the hybrid family's parts: ``repro_torch.core.recurrence.
rglru`` and ``repro_torch.core.attention`` against ``repro.core``, and the
port's ``rec``, ``attn`` and ``mlp`` blocks against the JAX blocks with the
same weights, on the same numpy inputs (f32).

* ``rglru``: chunks 8 and 256, with and without ``h0``, resets inside a
  chunk and on chunk edges, a carried row (positions > 0 at its start:
  no reset at t = 0). Forward within 1e-5, gradients within 1e-4 abs +
  1e-3 rel; the gradient across a reset is exactly 0; near a = 1 (where
  the normaliser's derivative a/√(1−a²) is large) the gradient stays
  finite and equals JAX's, and at a = 1 in f32 both are −inf alike (the
  JAX package's arithmetic, kept as it is).
* ``rope``; ``attention`` on both branches (materialised scores and the
  online softmax over KV chunks): MQA and GQA, a window of 8 on L 32, the
  segment mask, padding query rows (exactly 0 out, no gradient), and an
  Lkv no multiple of the KV chunk refused as JAX refuses it.
* ``apply_rec``, ``apply_attn`` and ``apply_mlp`` on
  recurrentgemma-2b.reduced() with the window at 8, forward within 1e-5
  and every parameter's gradient within 1e-4 abs + 1e-3 rel; the GeLU is
  the tanh form (``jax.nn.gelu``'s default), not torch's erf default.

The JAX side's conv is its XLA path, which tests/test_torch_conv*.py hold
against the Pallas kernels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _threads import one_thread  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.attention import attention as j_attention  # noqa: E402
from repro.core.attention import rope as j_rope  # noqa: E402
from repro.core import recurrence as jrec  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import attention as attn  # noqa: E402
from repro_torch.core import recurrence as rec  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)

FWD_TOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
B, L, D = 2, 37, 12
# row 0: resets at 0, 8 (a chunk edge at chunk 8), 19 and 32; row 1: a
# carried row (positions > 0 at its start), one reset at 16 (an edge)
POS = np.stack([np.concatenate([np.arange(8), np.arange(11), np.arange(13),
                                np.arange(5)]),
                np.concatenate([np.arange(6, 6 + 16), np.arange(21)])]
               ).astype(np.int32)


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def _close(got, ref, atol, rtol=0.0):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def _rglru_inputs(seed, scale_r=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    r = (1 / (1 + np.exp(-scale_r * rng.normal(size=(B, L, D))))
         ).astype(np.float32)
    i = (1 / (1 + np.exp(-rng.normal(size=(B, L, D))))).astype(np.float32)
    u = rng.uniform(0.9, 0.999, size=(D,))
    a_param = np.log(np.expm1(-np.log(u) / rec.RGLRU_C)).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    w = rng.normal(size=(B, L, D)).astype(np.float32)     # output cotangent
    return x, r, i, a_param, h0, w


def _jax_rglru(x, r, i, a_param, pos, h0, w, chunk):
    def f(x, r, i, a, h0):
        h, h_last = jrec.rglru(x, r, i, a, pos, h0=h0, chunk=chunk)
        return (h * w).sum() + h_last.sum(), (h, h_last)
    (_, (h, h_last)), g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *(jnp.asarray(v) for v in (x, r, i, a_param, h0)))
    return np.asarray(h), np.asarray(h_last), [np.asarray(v) for v in g]


def _port_rglru(x, r, i, a_param, pos, h0, w, chunk):
    ts = [_t(v, True) for v in (x, r, i, a_param, h0)]
    h, h_last = rec.rglru(*ts[:4], _t(pos), h0=ts[4], chunk=chunk)
    ((h * _t(w)).sum() + h_last.sum()).backward()
    return h.detach().numpy(), h_last.detach().numpy(), \
        [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_forward_and_gradients_match_jax(chunk, with_h0):
    x, r, i, a_param, h0, w = _rglru_inputs(0)
    if not with_h0:
        h0 = np.zeros_like(h0)
    ref = _jax_rglru(x, r, i, a_param, POS, h0, w, chunk)
    got = _port_rglru(x, r, i, a_param, POS, h0, w, chunk)
    _close(got[0], ref[0], FWD_TOL)
    _close(got[1], ref[1], FWD_TOL)
    for g, gr in zip(got[2], ref[2]):
        _close(g, gr, **GRAD_TOL)


def test_rglru_carried_row_keeps_h0_and_resets_cut_it():
    """Row 1 starts mid-sequence (no reset at t = 0): h0 reaches its first
    segment; row 0 resets at t = 0: h0 reaches nothing (its gradient is
    exactly 0)."""
    x, r, i, a_param, h0, w = _rglru_inputs(1)
    _, _, g = _port_rglru(x, r, i, a_param, POS, h0, w, 8)
    assert np.all(g[4][0] == 0.0)
    assert np.abs(g[4][1]).min() > 0.0


@pytest.mark.parametrize("chunk", [8, 256])
def test_rglru_no_gradient_crosses_a_reset(chunk):
    """The loss reads only the last segment of each row: every input
    before its reset gets a gradient of exactly 0."""
    x, r, i, a_param, h0, _ = _rglru_inputs(2)
    w = np.zeros((B, L, D), np.float32)
    w[0, 32:] = 1.0                    # row 0's last segment: 32..36
    w[1, 16:] = 1.0                    # row 1's: 16..36
    ts = [_t(v, True) for v in (x, r, i)]
    h, _ = rec.rglru(*ts, _t(a_param), _t(POS), h0=_t(h0), chunk=chunk)
    (h * _t(w)).sum().backward()
    for t in ts:
        assert torch.all(t.grad[0, :32] == 0.0)
        assert torch.all(t.grad[1, :16] == 0.0)
        assert torch.all(t.grad[0, 32:] != 0.0)


def test_rglru_gradient_near_a_equal_1():
    """r tiny: log a within 1e-4..1e-3 of 0, where d√(1−a²)/da =
    −a/√(1−a²) is ~22–70. The port's gradients are finite and equal JAX's.
    Closer to 1 the reference itself is ill-conditioned: XLA's exp differs
    from torch's by one ulp (6e-8) on ~3.5% of elements and it fuses
    1 − a·a into an FMA, and one ulp of a moves 1 − a² by 6e-8 / (2|log
    a|) relative, 3e-3 at |log a| = 1e-5. Where a rounds to 1 in f32 (r =
    0 here) both packages give −inf in the same places, the clamp and the
    sqrt being the same."""
    x, r, i, a_param, h0, w = _rglru_inputs(3)
    sp = np.log1p(np.exp(a_param.astype(np.float64)))
    # log a = −c·softplus(Λ)·r in [−1e-3, −1e-4]
    r = (np.random.default_rng(4).uniform(1e-4, 1e-3, size=(B, L, D))
         / (rec.RGLRU_C * sp)).astype(np.float32)
    ref = _jax_rglru(x, r, i, a_param, POS, h0, w, 8)
    got = _port_rglru(x, r, i, a_param, POS, h0, w, 8)
    for g, gr in zip(got[2], ref[2]):
        assert np.isfinite(g).all()
        _close(g, gr, **GRAD_TOL)
    r[0, 3, 5] = 0.0                               # a = 1 exactly
    ref = _jax_rglru(x, r, i, a_param, POS, h0, w, 8)
    got = _port_rglru(x, r, i, a_param, POS, h0, w, 8)
    assert np.isneginf(ref[2][1][0, 3, 5]) and np.isneginf(got[2][1][0, 3, 5])
    np.testing.assert_array_equal(np.isfinite(got[2][1]),
                                  np.isfinite(ref[2][1]))


# ---------------------------------------------------------------------------
# rope and attention
# ---------------------------------------------------------------------------

def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, L, 3, 16)).astype(np.float32)
    got = attn.rope(_t(x), _t(POS), 10000.0).numpy()
    ref = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(POS), 10000.0))
    _close(got, ref, FWD_TOL)


AL = 32                          # the attention tests' L; window 8 binds


def _attn_inputs(seed, H, Hkv, Dh=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, AL, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, AL, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, AL, Hkv, Dh)).astype(np.float32)
    # row 0: segments of 12, 15, then 5 padding; row 1: 20 + 12
    seg = np.stack([np.repeat([1, 2, 0], [12, 15, 5]),
                    np.repeat([1, 2], [20, 12])]).astype(np.int32)
    w = rng.normal(size=(B, AL, H, Dh)).astype(np.float32)
    return q, k, v, seg, w


@pytest.mark.parametrize("chunk_kv", [None, 8])
@pytest.mark.parametrize("H,Hkv", [(4, 1), (4, 2)])
@pytest.mark.parametrize("window", [None, 8])
def test_attention_matches_jax(chunk_kv, H, Hkv, window):
    q, k, v, seg, w = _attn_inputs(6, H, Hkv)
    kw = dict(causal=True, window=window, chunk_kv=chunk_kv)

    def jf(q, k, v):
        o = j_attention(q, k, v, segment_ids_q=jnp.asarray(seg),
                            segment_ids_kv=jnp.asarray(seg), **kw)
        return (o * w).sum(), o
    (_, ro), rg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [_t(a, True) for a in (q, k, v)]
    o = attn.attention(*ts, segment_ids_q=_t(seg), segment_ids_kv=_t(seg),
                       **kw)
    (o * _t(w)).sum().backward()
    _close(o.detach().numpy(), np.asarray(ro), FWD_TOL)
    for t, g in zip(ts, rg):
        _close(t.grad.numpy(), np.asarray(g), **GRAD_TOL)
    # padding query rows: exactly 0 out, and no gradient into them
    assert torch.all(o[0, 27:] == 0.0)
    assert torch.all(ts[0].grad[0, 27:] == 0.0)


def test_attention_refuses_a_kv_length_no_multiple_of_the_chunk():
    q, k, v, seg, _ = _attn_inputs(7, 4, 1)
    with pytest.raises(ValueError, match="not divisible by chunk_kv"):
        j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        chunk_kv=12)
    with pytest.raises(ValueError, match="not divisible by chunk_kv"):
        attn.attention(_t(q), _t(k), _t(v), chunk_kv=12)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _configs():
    kw = dict(attn_window=8)
    return (dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                                **kw),
            dataclasses.replace(jget_config("recurrentgemma-2b").reduced(),
                                **kw))


BPOS = np.stack([np.concatenate([np.arange(9), np.arange(14),
                                 np.arange(9)]),
                 np.concatenate([np.arange(5, 5 + 20), np.arange(12)])]
                ).astype(np.int32)
BSEG = np.stack([np.repeat([1, 2, 3], [9, 14, 9]),
                 np.repeat([1, 2], [20, 12])]).astype(np.int32)


@pytest.mark.parametrize("kind", ["rec", "attn", "mlp"])
def test_block_forward_and_gradients_match_jax(kind):
    cfg, jcfg = _configs()
    init, _, apply = blocks.MLP if kind == "mlp" else blocks.KINDS[kind][:3]
    params = {k: v.requires_grad_() for k, v in
              init(cfg, torch.Generator().manual_seed(8), "cpu").items()}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, AL, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    japply = {"rec": jblocks.apply_rec, "attn": jblocks.apply_attn,
              "mlp": jblocks.apply_mlp}[kind]
    jctx = jblocks.Ctx(positions=jnp.asarray(BPOS),
                       segment_ids=jnp.asarray(BSEG))

    def jf(p, x):
        y = japply(p, x, jctx, jcfg)
        return (y * w).sum(), y
    (_, ry), (rgp, rgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()},
        jnp.asarray(x))
    xt = _t(x, True)
    y = apply(params, xt, blocks.Ctx(positions=_t(BPOS),
                                     segment_ids=_t(BSEG)), cfg)
    (y * _t(w)).sum().backward()
    _close(y.detach().numpy(), np.asarray(ry), FWD_TOL)
    _close(xt.grad.numpy(), np.asarray(rgx), **GRAD_TOL)
    assert sorted(rgp) == sorted(params)
    for k, p in params.items():
        _close(p.grad.numpy(), np.asarray(rgp[k]), **GRAD_TOL)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = blocks._gelu(_t(x)).numpy()
    _close(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), 1e-6)
    assert np.abs(got - torch.nn.functional.gelu(_t(x)).numpy()).max() > 1e-4
