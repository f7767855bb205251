"""PackMamba in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

The port of the JAX package ``repro`` — which stays the reference — module
by module under the same names. Ported: the serving path (packed prefill
into decode slots, overlapped on a side stream, chunked prefill of long
prompts, greedy and sampled decode, deadlines, cancel, load shedding,
guard rails with quarantine, fault injection and snapshot/restore:
``launch/serve.py``, ``faults.py``), the packed
training loop (loader →
``LM.loss`` → backward → AdamW, gradient accumulation in f32 or bf16,
checkpoint/restart with the SIGTERM emergency save: ``train/``,
``checkpoint/``, ``data/``, ``optim/``), Mamba-1 and Mamba-2 blocks, the
scan autotuner (``tune/``) and the telemetry they report through
(``obs/``). Their TPU kernels are CUDA C++ kernels in ``csrc/``: the
``conv1d_pack`` forward and dx backward, and the selective scans' forward
and backward (Mamba-1 ``step`` and ``blocked``, Mamba-2 heads).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``resolve_device``); on the CPU every kernel wrapper takes its plain
PyTorch version. ``device="meta"`` builds shapes only: every kernel
wrapper returns outputs of the right shapes and dtypes and computes
nothing, which is how the dry run (``launch/dryrun.py``) counts a step's
work (``roofline/``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card; ``cpu`` and ``meta`` are taken only when
    named. Raises when the card is asked for and there is none: the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
