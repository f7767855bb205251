"""conv1d_pack forward and dx backward: the CUDA kernels
(``csrc/conv1d_pack.cu``), their plain PyTorch versions, and the wrappers
that pick one by the tensor's device.

Replaces the Pallas TPU kernels of ``repro.kernels.conv1d_pack``:

* ``_fwd_kernel`` / ``conv1d_pack_fwd_pallas`` (#1):

    y[b,t,d] = bias[d] + Σ_k w[W-1-k,d]·x[b,t-k,d]·[k==0 or (t-k ≥ 0 and pos[b,t] ≥ k)]

  accumulated in f32 (bias first, taps in k order), cast to x's dtype;
* ``_bwd_dx_kernel`` / ``conv1d_pack_bwd_dx_pallas`` (#2):

    dx[b,t,d] = Σ_k w[W-1-k,d]·dy[b,t+k,d]·[t+k < L and pos[b,t+k] ≥ k]

  accumulated in f32 in k order, returned as f32.

Both kernels are bound by bytes. A thread owns one 16-byte vector of
channels and walks a run of consecutive rows with the taps in registers and
a sliding window of rows (``conv_params`` picks the run length from the
shape); the window's W-1 halo rows lie before the run (#1) or after it
(#2). The FMA chain is the plain versions', so the outputs do not depend
on the run. dweight and dbias are plain reductions
(``conv1d_pack_bwd_params``), as the JAX package leaves them to XLA.

* A CPU tensor takes the plain version.
* A meta tensor gets an output of the right shape and dtype and nothing
  is computed: the dry run's shape-only path (``launch/dryrun.py``).
* A CUDA tensor launches the kernel or raises; there is no fallback. Where
  the pointers, strides or D do not allow 16-byte access, the same kernel
  runs one element wide.
* ``LAUNCHES`` (forward) and ``LAUNCHES_DX`` count kernel launches and
  nothing else, so a run can show that its main path went through them;
  ``LAST_LAUNCH`` holds the launch shape the last one took, as the C entry
  reports it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0                      # forward kernel launches
LAUNCHES_DX = 0                   # dx kernel launches
LAST_LAUNCH = None                # the last launch's shape (``_record``)
MAX_WIDTH = 4                     # the kernel instantiates W = 1..4
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_entries = {}                     # (kind, dtype) → C entry, bound at first use
_sms = {}                         # CUDA device index → its SM count

# The launch rule (``conv_params``), read off ``tools/sweep_conv.py`` on the
# H100 (PERF.md §6): a thread walks RUN_MAX[kind] rows (#1 16, #2 4:
# at the three models' training shapes the fastest run, or within 0.5% of
# it); the W-1 halo rows it re-reads mostly hit L2. A shorter buffer halves
# the run until the grid puts MIN_BLOCKS_PER_SM blocks on every SM, so a
# serving bucket still fills the card. THREADS threads a block lie across
# channels, the kernels' constant (``csrc/conv1d_pack.cu``).
RUN_MAX = {"fwd": 16, "bwd_dx": 4}
MIN_BLOCKS_PER_SM = 2
THREADS = 128


def conv1d_pack_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, positions: torch.Tensor
                      ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: f32 accumulation, bias first,
    taps in k order, the sequence start masked by t-k ≥ 0 on its own."""
    L = x.shape[1]
    W = weight.shape[0]
    x32, w32 = x.float(), weight.float()
    acc = bias.float().expand(x.shape)
    for k in range(W):
        if k == 0:
            seg = x32
        else:
            seg = torch.zeros_like(x32)
            seg[:, k:] = x32[:, :max(L - k, 0)]
            seg = torch.where((positions >= k)[..., None], seg, 0.0)
        acc = acc + w32[W - 1 - k] * seg
    return acc.to(x.dtype)


def conv1d_pack_bwd_dx_plain(dy: torch.Tensor, weight: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """The dx kernel's arithmetic in PyTorch: f32, taps in k order, the
    buffer's end masked by t+k < L on its own."""
    L = dy.shape[1]
    W = weight.shape[0]
    dy32, w32 = dy.float(), weight.float()
    acc = torch.zeros_like(dy32)
    for k in range(W):
        seg = torch.zeros_like(dy32)
        seg[:, :max(L - k, 0)] = dy32[:, k:]
        ok = torch.zeros_like(positions, dtype=torch.bool)
        ok[:, :max(L - k, 0)] = positions[:, k:] >= k
        acc = acc + w32[W - 1 - k] * torch.where(ok[..., None], seg, 0.0)
    return acc


def conv1d_pack_bwd_params(x: torch.Tensor, dy: torch.Tensor,
                           positions: torch.Tensor, width: int):
    """dweight (W, D) and dbias (D,) in f32: the forward's taps reduced over
    (b, t) by plain PyTorch sums (no matmul, no atomics), as
    ``_conv_bwd_rule`` leaves them to XLA."""
    L = x.shape[1]
    x32, dy32 = x.float(), dy.float()
    dws = []
    for k in range(width):                  # weight row W-1-k ↔ back-off k
        shifted = torch.zeros_like(x32)
        shifted[:, k:] = x32[:, :max(L - k, 0)]
        masked = torch.where((positions >= k)[..., None], shifted, 0.0)
        dws.append((dy32 * masked).sum((0, 1)))
    return torch.stack(dws[::-1]), dy32.sum((0, 1))


def _entry(kind, dtype):
    """The C entry ``conv1d_pack_<kind>_<dtype>``, its ctypes signature
    declared."""
    fn = _entries.get((kind, dtype))
    if fn is None:
        fn = getattr(_build.load("conv1d_pack"),
                     f"conv1d_pack_{kind}_{_DTYPES[dtype]}")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = ([vp, i64, i64, vp, vp, vp, i64, vp] if kind == "fwd"
                       else [vp, vp, vp, i64, vp]) + [i32] * 6 + [vp, vp]
        fn.restype = i32
        _entries[(kind, dtype)] = fn
    return fn


def _sm_count() -> int:
    dev = torch.cuda.current_device()
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def conv_params(B: int, L: int, D: int, dtype, kind: str = "fwd",
                sms: int = None) -> dict:
    """Launch shape of #1 (``kind`` "fwd") or #2 ("bwd_dx") at (B, L, D)
    for ``dtype`` input: ``run`` (rows a thread walks), ``threads`` (a
    block's), ``width`` (channels a thread on the 16-byte path) and
    ``blocks`` (the grid on that path). The run is RUN_MAX[kind], halved
    while the grid has fewer than MIN_BLOCKS_PER_SM blocks for each of
    ``sms`` SMs (default: the current CUDA device's)."""
    width = 16 // dtype.itemsize
    channel_blocks = -(-D // (width * THREADS))
    sms = _sm_count() if sms is None else sms
    run = RUN_MAX[kind]
    while run > 1 and B * channel_blocks * -(-L // run) < \
            MIN_BLOCKS_PER_SM * sms:
        run //= 2
    return {"run": run, "threads": THREADS, "width": width,
            "blocks": B * channel_blocks * -(-L // run)}


def conv_resources(kind: str, dtype, one_wide: bool = False,
                   W: int = MAX_WIDTH) -> dict:
    """#1 (``kind`` "fwd") or #2 ("bwd_dx") of width ``W`` on the current
    CUDA device for ``dtype`` input, 16-byte or ``one_wide``, at a run of
    RUN_MAX[kind]: blocks and warps an SM, registers and local (spill)
    bytes a thread, shared bytes a block."""
    out = (ctypes.c_int * 5)()
    err = _build.load("conv1d_pack").conv1d_pack_occupancy(
        int(kind == "bwd_dx"), int(dtype == torch.bfloat16), int(not one_wide),
        W, RUN_MAX[kind], out)
    if err != 0:
        raise RuntimeError(f"conv1d_pack_occupancy failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "warps_per_sm", "registers",
                     "local_bytes", "shared_bytes"), out))


def vector_path(*tensors, strides=(), D: int) -> bool:
    """Whether the kernels take 16-byte channel vectors: every pointer
    16-byte aligned, and D and the given strides (elements) multiples of a
    vector."""
    width = 16 // tensors[0].element_size()
    return all(t.data_ptr() % 16 == 0 for t in tensors) and \
        all(s % width == 0 for s in (D, *strides))


def _check(x, weight, bias, positions):
    """Shapes, dtypes and devices both kernels take (bias None: dx)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got shape {tuple(x.shape)}")
    B, L, D = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (f32 or bf16)")
    if weight.dtype != x.dtype or (bias is not None and
                                   bias.dtype != x.dtype):
        raise TypeError(f"weight {weight.dtype} and bias "
                        f"{None if bias is None else bias.dtype} must have "
                        f"x's dtype {x.dtype}")
    if weight.dim() != 2 or weight.shape[1] != D or \
            not 1 <= weight.shape[0] <= MAX_WIDTH:
        raise ValueError(f"weight must be (W, {D}) with 1 <= W <= "
                         f"{MAX_WIDTH}, got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (D,):
        raise ValueError(f"bias must be ({D},), got {tuple(bias.shape)}")
    if tuple(positions.shape) != (B, L) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 ({B}, {L}), got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    devs = {t.device for t in (x, weight, bias, positions) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"conv1d_pack operands on several devices: {devs}")


def _check_cuda(name, x, positions):
    """What both kernels need of a tensor the wrapper will launch on."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if positions.stride(1) != 1:
        raise ValueError(f"positions needs contiguous rows, got strides "
                         f"{positions.stride()}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands are on {x.device}, the current "
                         f"CUDA device is cuda:{torch.cuda.current_device()}")


def _record(kind, run, launched):
    """Keep the launch shape the C entry reports in ``LAST_LAUNCH``."""
    global LAST_LAUNCH
    width, threads, *grid = launched
    LAST_LAUNCH = {"kind": kind, "run": run, "width": width,
                   "threads": threads, "grid": grid,
                   "blocks": grid[0] * grid[1] * grid[2]}


def conv1d_pack(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) f32|bf16 (channels contiguous; batch and row strides are
    free, so a ``chunk``/``split`` view is taken as is) | weight (W, D) |
    bias (D,) | positions (B, L) int32 → y (B, L, D) in x's dtype."""
    _check(x, weight, bias, positions)
    if x.device.type == "cpu":
        return conv1d_pack_plain(x, weight, bias, positions)
    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return _launch_fwd(x, weight, bias, positions)


def _launch_fwd(x, weight, bias, positions, run=None):
    """#1 on checked CUDA operands, at ``conv_params``'s run or ``run``
    (the sweep and the tests force one; y does not depend on it)."""
    global LAUNCHES
    _check_cuda("conv1d_pack", x, positions)
    if x.stride(2) != 1:
        raise ValueError(f"x needs contiguous channels, got strides "
                         f"{x.stride()}")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("weight and bias must be contiguous")
    B, L, D = x.shape
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if run is None:
        run = conv_params(B, L, D, x.dtype, "fwd")["run"]
    vec = vector_path(x, weight, bias, y, strides=x.stride()[:2], D=D)
    launched = (ctypes.c_int * 5)()
    err = _entry("fwd", x.dtype)(
        x.data_ptr(), x.stride(0), x.stride(1), weight.data_ptr(),
        bias.data_ptr(), positions.data_ptr(), positions.stride(0),
        y.data_ptr(), B, L, D, weight.shape[0], run, int(vec), launched,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1d_pack kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    _record("fwd", run, launched)
    return y


def conv1d_pack_bwd_dx(dy: torch.Tensor, weight: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """dy (B, L, D) f32|bf16 contiguous | weight (W, D) of dy's dtype |
    positions (B, L) int32 → dx (B, L, D) f32."""
    _check(dy, weight, None, positions)
    if dy.device.type == "cpu":
        return conv1d_pack_bwd_dx_plain(dy, weight, positions)
    if dy.device.type == "meta":
        return torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    return _launch_dx(dy, weight, positions)


def _launch_dx(dy, weight, positions, run=None):
    """#2 on checked CUDA operands, at ``conv_params``'s run or ``run``, as
    ``_launch_fwd``."""
    global LAUNCHES_DX
    _check_cuda("conv1d_pack_bwd_dx", dy, positions)
    if not (dy.is_contiguous() and weight.is_contiguous()):
        raise ValueError("dy and weight must be contiguous")
    B, L, D = dy.shape
    dx = torch.empty((B, L, D), dtype=torch.float32, device=dy.device)
    if dx.numel() == 0:
        return dx
    if run is None:
        run = conv_params(B, L, D, dy.dtype, "bwd_dx")["run"]
    vec = vector_path(dy, weight, dx, D=D)
    launched = (ctypes.c_int * 5)()
    err = _entry("bwd_dx", dy.dtype)(
        dy.data_ptr(), weight.data_ptr(), positions.data_ptr(),
        positions.stride(0), dx.data_ptr(), B, L, D, weight.shape[0], run,
        int(vec), launched, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1d_pack dx kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES_DX += 1
    _record("bwd_dx", run, launched)
    return dx
