"""The port's roofline (``repro_torch.roofline``) against the JAX package's
on the same inputs, on the CPU: ``Roofline`` (given the v5e's peaks as a
dict here), ``active_params``, ``model_flops_per_step`` and the scan-path
traffic model; the H100's peaks by card name; the kernels' bounds against
the values PERF.md §6 prints; and the step counter's units.

Tolerances: every comparison with the JAX package is exact but for
``t_*`` seconds, which are held at 1e-12 relative (one division by a rate
each side); the bounds are held at PERF.md's printed digits.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro.roofline import kernel_model as jkm  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.roofline import analysis as an  # noqa: E402
from repro_torch.roofline import counter  # noqa: E402
from repro_torch.roofline import kernel_model as km  # noqa: E402

V5E = dict(bf16_flops=197e12, hbm_bw=819e9, link_bw=50e9)
H100 = an.peaks_for("NVIDIA H100 80GB HBM3")
PAPER = ["mamba-110m", "mamba-1.4b", "mamba-2.8b", "mamba2-370m"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of tiny ops: one intra-op thread keeps them from spinning
    on the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flops,hbm,coll,chips,model", [
    (3.2e15, 1.1e13, 0.0, 1, 2.9e15),
    (3.2e15, 9.9e14, 4.0e12, 256, 1.0e15),
    (1.0e12, 1.0e9, 8.0e13, 512, None),
    (0.0, 5.0e9, 0.0, 1, 3.0e9),
    (7.7e14, 2.0e11, 1.0e10, 16, 7.7e14),
])
def test_roofline_matches_jax_given_its_peaks(flops, hbm, coll, chips, model):
    want = jan.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                        chips=chips, model_flops=model).to_dict()
    got = an.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                      chips=chips, peaks=V5E, model_flops=model).to_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        if isinstance(v, float) and k.startswith("t_"):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        elif isinstance(v, float) and k == "roofline_fraction":
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert got[k] == v, k


def test_roofline_splits_compute_by_unit():
    p = H100
    by = {"bf16": 4e14, "tf32": 2e13, "f32": 1e12}
    rl = an.Roofline(flops=sum(by.values()), hbm_bytes=1e12, coll_bytes=0.0,
                     chips=1, peaks=p, model_flops=3e14, flops_by_unit=by)
    want = 4e14 / 989.4e12 + 2e13 / 494.7e12 + 1e12 / 67e12
    assert rl.t_compute == pytest.approx(want, rel=1e-15)
    assert rl.t_memory == 1e12 / 3.35e12 and rl.t_collective == 0.0
    assert rl.dominant == "compute" and rl.bound_time == rl.t_compute
    assert rl.roofline_fraction == pytest.approx(
        3e14 / 989.4e12 / rl.t_compute, rel=1e-15)
    assert an.mfu(3e14, 0.5, p) == 3e14 / (0.5 * 989.4e12)


def test_h100_peaks_by_card_name_and_unknown_card_raises():
    p = an.peaks_for("NVIDIA H100 80GB HBM3")
    assert p == dict(bf16_flops=989.4e12, tf32_flops=494.7e12,
                     f32_flops=67e12, hbm_bw=3.35e12, hbm_bytes=80e9,
                     link_bw=450e9)
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e", ""):
        with pytest.raises(KeyError, match="no peaks"):
            an.peaks_for(name)


def test_bounds_have_no_default_card():
    """Every bound is read against the peaks it is given: none falls back
    to the H100's."""
    w = km.conv_work(2, 4096, 4096, 4, 2)
    for fn, args in ((km.bound_ms, (w.bytes, w.flops, w.unit)),
                     (km.work_bound_ms, (w,)),
                     (km.scan_bounds, ((2, 4096, 4096), 2, 64)),
                     (km.heads_bounds, ((8, 4096, 32, 64), 2, 256)),
                     (km.mamba_scan_traffic_per_device,
                      (get_config("mamba-1.4b"), 2, 4096))):
        with pytest.raises(TypeError):
            fn(*args)
    slow = dict(H100, hbm_bw=H100["hbm_bw"] / 2)
    assert km.work_bound_ms(w, slow)[0] == pytest.approx(
        2 * km.work_bound_ms(w, H100)[0], rel=1e-15)


@pytest.mark.parametrize("arch", PAPER)
def test_active_params_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert an.active_params(cfg) == jan.active_params(jcfg)
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                       ("decode", 128, 32768), ("decode", 1, 524288),
                       ("train", 2, 4096)):
        assert an.model_flops_per_step(cfg, kind, b, s) == \
            jan.model_flops_per_step(jcfg, kind, b, s)


@pytest.mark.parametrize("arch", ["mamba-110m", "mamba-1.4b", "mamba-2.8b"])
@pytest.mark.parametrize("shards", [(1, 1), (16, 16)])
def test_scan_traffic_matches_jax_over_the_h100_rate(arch, shards):
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = jkm.mamba_scan_traffic_per_device(jcfg, 256, 4096, *shards)
    got = km.mamba_scan_traffic_per_device(cfg, 256, 4096, *shards,
                                           peaks=H100)
    assert got["per_layer_bytes"] == want["per_layer_bytes"]
    assert got["total_bytes"] == want["total_bytes"]
    assert got["t_memory_s"] / want["t_memory_s"] == pytest.approx(
        819e9 / 3.35e12, rel=1e-12)
    jc = jkm.compare_scan_paths(jcfg, 256, 4096, *shards,
                                measured_xla_scan_share=0.8,
                                measured_t_memory_s=2.5)
    c = km.compare_scan_paths(cfg, 256, 4096, *shards,
                              measured_xla_scan_share=0.8,
                              measured_t_memory_s=2.5, peaks=H100)
    assert c["total_bytes"] == jc["total_bytes"]
    assert c["projected_t_memory_s"] == pytest.approx(
        2.5 * 0.2 + got["t_memory_s"], rel=1e-12)


# PERF.md §6's "bound µs" column: (shape, dtype bytes, value, digits)
CONV_BOUNDS = [((2, 256, 4096), 2, 2.52, 2), ((2, 4096, 4096), 2, 40.09, 2),
               ((2, 4096, 5120), 2, 50.11, 2), ((8, 4096, 2048), 2, 80.18, 2),
               ((2, 997, 4100), 2, 9.78, 2), ((1, 259, 4096), 2, 1.28, 2),
               ((1, 67, 4096), 2, 0.34, 2), ((1, 131, 4096), 2, 0.65, 2),
               ((2, 256, 1536), 2, 0.944, 3), ((1, 259, 1536), 2, 0.480, 3),
               ((2, 4096, 1536), 2, 15.04, 2)]
DX_BOUNDS = [((2, 4096, 4096), 2, 60.12, 2), ((2, 4096, 5120), 2, 75.14, 2),
             ((8, 4096, 2048), 2, 120.24, 2), ((2, 997, 4100), 2, 14.65, 2),
             ((2, 4096, 1536), 2, 22.55, 2)]


@pytest.mark.parametrize("shape,es,want,digits", CONV_BOUNDS)
def test_conv_fwd_bound_is_perf_md(shape, es, want, digits):
    D = shape[2]
    dt = torch.bfloat16
    x = torch.empty(shape, dtype=dt, device="meta")
    w = torch.empty((4, D), dtype=dt, device="meta")
    ms, by = km.conv_bound_ms(x, w, H100)
    assert (round(ms * 1e3, digits), by) == (want, "bytes")


@pytest.mark.parametrize("shape,es,want,digits", DX_BOUNDS)
def test_conv_dx_bound_is_perf_md(shape, es, want, digits):
    D = shape[2]
    dy = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    w = torch.empty((4, D), dtype=torch.bfloat16, device="meta")
    ms, by = km.conv_dx_bound_ms(dy, w, H100)
    assert (round(ms * 1e3, digits), by) == (want, "bytes")


@pytest.mark.parametrize("shape,chunk,fwd,bwd", [
    ((2, 4096, 4096), 64, 70.4, 150.9),        # #4 / #6 (and #3 / #5)
    ((2, 4096, 5120), 64, 87.9, 188.5),        # #3 / #5 (and #4 / #6)
    ((2, 997, 4104), 128, 16.0, None),         # #4 at its other chunks
    ((2, 997, 4104), 48, 18.1, None)])
def test_scan_bounds_are_perf_md(shape, chunk, fwd, bwd):
    (f, fb), (b, bb) = km.scan_bounds(shape, 2, -(-shape[1] // chunk), H100)
    assert (round(f * 1e3, 1), fb) == (fwd, "bytes")
    if bwd is not None:
        assert (round(b * 1e3, 1), bb) == (bwd, "bytes")


@pytest.mark.parametrize("shape,es,fwd,bwd", [
    ((8, 4096, 32, 64), 2, 103.3, 189.7),      # #7 and #8 / #9
    ((8, 4096, 32, 64), 4, 186.6, None),       # #7 in f32
    ((8, 997, 32, 64), 2, 25.3, None)])        # #7 at a ragged L
def test_heads_bounds_are_perf_md(shape, es, fwd, bwd):
    (f, fb), (b, bb) = km.heads_bounds(shape, es, min(256, shape[1]), H100)
    assert (round(f * 1e3, 1), fb) == (fwd, "bytes")
    if bwd is not None:
        assert (round(b * 1e3, 1), bb) == (bwd, "bytes")
    # the products PERF.md §6 names beside the table, at the full shape
    fw, bw = km.heads_work(*shape, 64, es, 256)
    if shape[1] == 4096 and es == 2:
        assert (f"{fw.flops:.1e}", f"{bw.flops:.1e}") == ("3.4e+10",
                                                           "8.4e+10")
        assert fw.unit == bw.unit == "tf32"


def test_kernel_work_names_are_the_launch_counters():
    from repro_torch.kernels import ops
    assert set(km.KERNEL_WORK) == set(ops.LAUNCH_COUNTERS) == {
        *ops.CONV_KERNELS, *(k for t in ops.SCAN_KERNELS.values() for k in t),
        *(k for t in ops.HEADS_KERNELS.values() for k in t)}
    assert len(ops.LAUNCH_COUNTERS) == 9
    u = torch.empty((2, 4096, 4096), dtype=torch.bfloat16, device="meta")
    assert km.kernel_work("selective_scan_fwd", u, 16, 64) == \
        km.kernel_work("selective_scan_fwd_step", u, 16, 64) == \
        km.scan_work(2, 4096, 4096, 16, 2, 64)[0]
    assert km.exp_floor_ms(2e9, 1e12) == 2.0


@pytest.mark.parametrize("tf32", [False, True])
def test_counter_takes_a_products_unit_from_its_operands(tf32):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        a32, b32 = torch.ones((8, 16)), torch.ones((16, 4))
        b16 = b32.bfloat16()
        with counter.StepCounter("cpu") as c:
            y32 = a32 @ b32
            y16 = a32.bfloat16() @ b16      # the cast dies after the product
            a32.view(2, 64)
            e = torch.empty((1000,))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    f32 = 2 * 8 * 16 * 4
    assert c.flops == {"bf16": f32, "tf32": f32 if tf32 else 0,
                       "f32": 0 if tf32 else f32}
    # mm: (8·16 + 16·4 + 8·4)·4 bytes in f32, half in bf16; the cast
    # reads 8·16·4 and writes 8·16·2; the view and the allocation move
    # nothing
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.bytes == mm + mm // 2 + 8 * 16 * 6
    assert c.traffic_by_op == {"matmul": mm + mm // 2, "other": 8 * 16 * 6}
    # the peak is at the end, y32, y16 and e live (the bf16 cast of a32 is
    # freed after its product, while the live bytes are still below it)
    assert c.peak_bytes == y32.nbytes + y16.nbytes + e.nbytes == \
        8 * 4 * 4 + 8 * 4 * 2 + 1000 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_charges_no_log_sigmoid_buffer(device):
    """``F.logsigmoid`` keeps a buffer of its input's size on the CPU and
    the meta device and an empty one on the card: the count charges it
    nowhere, so a step that runs it (the xLSTM gates) counts the card's
    bytes on every device. Forward: the input read, the output written;
    backward: the gradient and the input read, the input's gradient
    written."""
    x = torch.ones((2, 100), device=device, requires_grad=True)
    g = torch.ones((2, 100), device=device)
    with counter.StepCounter(device) as c:
        y = torch.nn.functional.logsigmoid(x)
        torch.autograd.grad(y, x, grad_outputs=g)
    assert c.bytes == 5 * x.nbytes
