"""conv1d_pack forward: the CUDA kernel (``csrc/conv1d_pack.cu``), its plain
PyTorch version, and the wrapper that picks one by the tensor's device.

Replaces the Pallas TPU kernel ``_fwd_kernel`` / ``conv1d_pack_fwd_pallas``
of ``repro.kernels.conv1d_pack``:

    y[b,t,d] = bias[d] + Σ_k w[W-1-k,d]·x[b,t-k,d]·[k==0 or (t-k ≥ 0 and pos[b,t] ≥ k)]

accumulated in f32 (bias first, taps in k order) and cast to x's dtype.

* A CPU tensor takes ``conv1d_pack_plain``.
* A CUDA tensor launches the kernel or raises; there is no fallback.
* ``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
  that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
MAX_WIDTH = 4                     # the kernel instantiates W = 1..4
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_entries = {}                     # dtype → bound C entry, filled at first use


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


def _entry(dtype):
    """The C entry for ``dtype``, with its ctypes signature declared."""
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(_build.load("conv1d_pack"),
                     f"conv1d_pack_fwd_{_DTYPES[dtype]}")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [vp, i64, i64, vp, vp, vp, i64, vp, i32, i32, i32, i32,
                       vp]
        fn.restype = i32
        _entries[dtype] = fn
    return fn


def _check(x, weight, bias, positions):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, D), got shape {tuple(x.shape)}")
    B, L, D = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (f32 or bf16)")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"weight {weight.dtype} and bias {bias.dtype} must "
                        f"have x's dtype {x.dtype}")
    if weight.dim() != 2 or weight.shape[1] != D or \
            not 1 <= weight.shape[0] <= MAX_WIDTH:
        raise ValueError(f"weight must be (W, {D}) with 1 <= W <= "
                         f"{MAX_WIDTH}, got {tuple(weight.shape)}")
    if tuple(bias.shape) != (D,):
        raise ValueError(f"bias must be ({D},), got {tuple(bias.shape)}")
    if tuple(positions.shape) != (B, L) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 ({B}, {L}), got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    devs = {t.device for t in (x, weight, bias, positions)}
    if len(devs) != 1:
        raise ValueError(f"conv1d_pack operands on several devices: {devs}")


def conv1d_pack(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x (B, L, D) f32|bf16 (channels contiguous; batch and row strides are
    free, so a ``chunk``/``split`` view is taken as is) | weight (W, D) |
    bias (D,) | positions (B, L) int32 → y (B, L, D) in x's dtype."""
    global LAUNCHES
    _check(x, weight, bias, positions)
    if x.device.type == "cpu":
        return conv1d_pack_plain(x, weight, bias, positions)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_pack runs on cuda or cpu, not {x.device}")
    if x.stride(2) != 1:
        raise ValueError(f"x needs contiguous channels, got strides "
                         f"{x.stride()}")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("weight and bias must be contiguous")
    if positions.stride(1) != 1:
        raise ValueError(f"positions needs contiguous rows, got strides "
                         f"{positions.stride()}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    B, L, D = x.shape
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = _entry(x.dtype)(
        x.data_ptr(), x.stride(0), x.stride(1), weight.data_ptr(),
        bias.data_ptr(), positions.data_ptr(), positions.stride(0),
        y.data_ptr(), B, L, D, weight.shape[0],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv1d_pack kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return y
