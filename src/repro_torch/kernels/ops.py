"""Public wrappers of the kernels (port of ``repro.kernels.ops``).

The JAX package picks a backend by name; here the device of the tensors
picks it: a CUDA tensor goes to the hand-written kernel, a CPU tensor to
its plain version (``kernels/conv1d_pack.py``). The selective scan has no
kernel in this slice and runs the plain ``core/ssm.py`` schedules on either
device; its Hopper kernels come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import ssm as core_ssm
from repro_torch.kernels import conv1d_pack as conv_k


def conv1d_pack(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segmented causal depthwise conv. x (B, L, D) | weight (W, D) |
    bias (D,) or None | positions (B, L) or None (= one segment per row)."""
    B, L, D = x.shape
    if bias is None:
        bias = torch.zeros(D, dtype=x.dtype, device=x.device)
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32,
                                 device=x.device).expand(B, L)
    return conv_k.conv1d_pack(x, weight, bias, positions.to(torch.int32))


def selective_scan(u, delta, A, B, C, D=None, positions=None, *,
                   method: str = "blocked", chunk: int = 256,
                   intra: Optional[str] = None):
    """Segmented selective scan, y only. See ``core/ssm.py``."""
    return core_ssm.selective_scan(u, delta, A, B, C, D, positions=positions,
                                   method=method, chunk=chunk, intra=intra)
