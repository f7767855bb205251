"""Segmented causal depthwise conv1d — the paper's conv1d_pack (Algorithm 1).

Port of ``repro.core.conv``. Width-W depthwise causal convolution along the
sequence; in a packed buffer the tap that reaches back ``k`` positions
contributes iff ``k <= positions[t]`` (the source token lies inside the
same sequence). Layout: x (B, L, D); weight (W, D); bias (D,).

``conv1d_pack`` here is the algorithm in x's own dtype, as the JAX
package's XLA path writes it. The serving path calls
``kernels.ops.conv1d_pack``, whose CUDA kernel and plain twin accumulate in
f32 (``kernels/conv1d_pack.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d_pack(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor],
                positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Causal depthwise conv with boundary truncation.

    positions: (B, L) int intra-sequence positions, or None (one segment).
    Returns (B, L, D).
    """
    L = x.shape[1]
    W = weight.shape[0]
    y = x * weight[W - 1]                         # k = 0 tap (current token)
    for k in range(1, W):                         # tap reaching back k
        shifted = F.pad(x[:, :max(L - k, 0)], (0, 0, min(k, L), 0))
        if positions is not None:
            shifted = torch.where((positions >= k)[..., None], shifted,
                                  torch.zeros_like(shifted))
        y = y + shifted * weight[W - 1 - k]
    if bias is not None:
        y = y + bias
    return y


def conv1d_pack_update(x_t: torch.Tensor, conv_state: torch.Tensor,
                       weight: torch.Tensor, bias: Optional[torch.Tensor],
                       reset_t: Optional[torch.Tensor] = None):
    """Single decode step. conv_state: (B, W-1, D) trailing inputs.

    reset_t: (B,) bool — start of a new sequence (clear the window).
    Returns (y_t (B, D), new_state (B, W-1, D)).
    """
    if reset_t is not None:
        conv_state = torch.where(reset_t[:, None, None],
                                 torch.zeros_like(conv_state), conv_state)
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, W, D)
    y_t = torch.einsum("bwd,wd->bd", window, weight)
    if bias is not None:
        y_t = y_t + bias
    return y_t, window[:, 1:]
