"""The kernels' work: bytes and operations of each hand-written kernel, the
least time the card could take for it, and the analytic scan-path traffic
of a whole step (port of ``repro.roofline.kernel_model``).

``mamba_scan_traffic_per_device`` and ``compare_scan_paths`` keep the JAX
module's byte formulas, over the card's HBM rate:

  fwd : read u, Δ (2·B·L·D·s) + B, C (2·B·L·N·s) + pos (B·L·4)
        write y (B·L·D·s) + checkpoints (B·(L/T)·N·D·4)
  bwd : read everything fwd reads + dy (B·L·D·s) + checkpoints
        write du, dΔ (2·B·L·D·4) + dB, dC partials (2·B·nD·L·N·4)
  conv: 3 passes (fwd, dx, dw) of 2·B·L·D·s + B·L·4

(s = activation byte width, 2 for bf16.)

Each kernel's own work (``*_work``) is what its bound counts: each input
read once, each output written once, and the operations the function needs
on these inputs, in the unit they run in (``analysis.UNITS``). The same
numbers give ``chip_smoke.py``'s ``bound_ms`` column (PERF.md §6) and the
charge the step counter (``roofline/counter.py``) makes for a kernel call
in place of the ops its code issues (``kernel_work``), so a step's count
does not depend on which code computed the kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class Work(NamedTuple):
    bytes: float       # each input read once, each output written once
    flops: float       # operations the function needs
    unit: str          # the unit they run in (analysis.UNITS)


def bound_ms(nbytes, flops, unit: str, peaks: Dict[str, float]):
    """The least time for the work on the card of ``peaks``
    (``analysis.peaks_for``): bytes over the memory rate or operations over
    ``unit``'s peak, whichever is larger. Returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / peaks["hbm_bw"] * 1e3
    t_ops = flops / peaks[f"{unit}_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def work_bound_ms(work: Work, peaks: Dict[str, float]):
    return bound_ms(work.bytes, work.flops, work.unit, peaks)


def exp_floor_ms(n_exp, sfu_rate):
    """What ``n_exp`` exponentials cost at the special-function unit's
    rate alone."""
    return n_exp / sfu_rate * 1e3


# ------------------------------------------------------------- the kernels

def conv_work(B, L, D, W, es) -> Work:
    """#1: x read and y written (B, L, D), positions, weight and bias; two
    f32 operations a tap."""
    return Work(2 * B * L * D * es + B * L * 4 + (W * D + D) * es,
                2 * W * B * L * D, "f32")


def conv_dx_work(B, L, D, W, es) -> Work:
    """#2: dy read (B, L, D), dx written in f32, positions and weight; two
    f32 operations a tap."""
    return Work(B * L * D * (es + 4) + B * L * 4 + W * D * es,
                2 * W * B * L * D, "f32")


def scan_work(B, L, D, N, es, n_chunk):
    """The Mamba-1 scan's forward and backward (the same for both
    schedules): bytes of each input read once and each output written once
    — du, dΔ (B, L, D) f32, dB and dC as the function's (B, L, N) f32, dA
    (N, D) and dD (D,) f32; the kernels' per-block and per-row partials are
    their own overhead and not counted — and f32 operations per state and
    step, forward 6, backward 17."""
    io = 2 * B * L * N * es + B * L * 4 + N * D * 4 + D * 4
    ck = B * n_chunk * N * D * 4
    fwd = Work(3 * B * L * D * es + io + ck, 6 * B * L * D * N, "f32")
    bwd = Work(3 * B * L * D * es + io + ck + 2 * B * L * D * 4
               + 2 * B * L * N * 4 + N * D * 4 + D * 4,
               17 * B * L * D * N, "f32")
    return fwd, bwd


def heads_work(B, L, H, P, N, es, chunk):
    """The heads scan's forward (#7 and #8 share it) and backward (#9):
    bytes of each input read once and each output written once (dB and dC
    as the function's (B, L, N), dA and dD (H,); the kernel's per-head
    partials are its own overhead and not counted) and the products of the
    chunked (SSD) form, in TF32 on the tensor cores: the form #9 runs there
    and #8 writes out. Per (b, head) and sub-chunk of n ≤ Q =
    ``BWD_SUB_T`` steps inside each chunk: forward C·Bᵀ, (dec∘CBᵀ)·X,
    C·h_inᵀ and the exit state, 2n²(N + P) + 4nPN; backward S = C·Bᵀ,
    R = dY·Xᵀ, dX, dC and dB (two products each) and dh, 2n²(3N + 2P) +
    8nPN, and the exit state of every sub-chunk but a chunk's last (pass
    1), 2nPN. At mamba2-370m's training shape both are bound by bytes."""
    from repro_torch.kernels import selective_scan_heads as kh
    f_ops = b_ops = 0
    for c0 in range(0, L, chunk):
        t1 = min(L, c0 + chunk)
        ns = [min(kh.BWD_SUB_T, t1 - t) for t in range(c0, t1,
                                                        kh.BWD_SUB_T)]
        for n in ns:
            f_ops += 2 * n * n * (N + P) + 4 * n * P * N
            b_ops += 2 * n * n * (3 * N + 2 * P) + 8 * n * P * N
        b_ops += sum(2 * n * P * N for n in ns[:-1])
    n_chunk = -(-L // chunk)
    io = 2 * B * L * N * es + B * L * 4 + 2 * H * 4 + B * L * H * es
    ck = B * H * n_chunk * P * N * 4
    fwd = Work(2 * B * L * H * P * es + io + ck, B * H * f_ops, "tf32")
    bwd = Work(2 * B * L * H * P * es + io + ck + B * L * H * P * 4
               + B * L * H * 4 + 2 * B * L * N * 4 + 2 * H * 4,
               B * H * b_ops, "tf32")
    return fwd, bwd


def conv_bound_ms(x, w, peaks):
    """#1's bound at the call's tensors."""
    B, L, D = x.shape
    return work_bound_ms(conv_work(B, L, D, w.shape[0], x.element_size()),
                         peaks)


def conv_dx_bound_ms(dy, w, peaks):
    """#2's bound at the call's tensors."""
    B, L, D = dy.shape
    return work_bound_ms(conv_dx_work(B, L, D, w.shape[0],
                                      dy.element_size()), peaks)


def scan_bounds(shape, es, n_chunk, peaks, N=16):
    """Least times of the Mamba-1 scan's forward and backward at (B, L, D)
    (``scan_work``): ((ms, by), (ms, by))."""
    return tuple(work_bound_ms(w, peaks)
                 for w in scan_work(*shape, N, es, n_chunk))


def heads_bounds(shape, es, chunk, peaks, N=64):
    """Least times of the heads scan's forward and backward at
    (B, L, H, P) (``heads_work``): ((ms, by), (ms, by))."""
    return tuple(work_bound_ms(w, peaks)
                 for w in heads_work(*shape, N, es, chunk))


def _scan_call(u, N, chunk):
    from repro_torch.kernels.selective_scan import n_chunks
    B, L, D = u.shape
    return scan_work(B, L, D, N, u.element_size(), n_chunks(L, chunk))


def _heads_call(u, N, chunk):
    return heads_work(*u.shape, N, u.element_size(), chunk)


# The charge of one call of each kernel, by the name of its launch counter
# (``kernels.ops.LAUNCH_COUNTERS``), from the arguments
# ``kernels/ops.py`` hands the step counter: (x, W) for the conv kernels,
# (u, N, chunk) for the scans.
KERNEL_WORK = {
    "conv1d_pack_fwd": lambda x, W: conv_work(*x.shape, W, x.element_size()),
    "conv1d_pack_bwd_dx": lambda dy, W: conv_dx_work(*dy.shape, W,
                                                     dy.element_size()),
    "selective_scan_fwd": lambda *a: _scan_call(*a)[0],
    "selective_scan_bwd": lambda *a: _scan_call(*a)[1],
    "selective_scan_fwd_step": lambda *a: _scan_call(*a)[0],
    "selective_scan_bwd_step": lambda *a: _scan_call(*a)[1],
    "selective_scan_heads_fwd": lambda *a: _heads_call(*a)[0],
    "selective_scan_heads_fwd_dual": lambda *a: _heads_call(*a)[0],
    "selective_scan_heads_bwd": lambda *a: _heads_call(*a)[1],
}


def kernel_work(name: str, *args) -> Work:
    return KERNEL_WORK[name](*args)


# ------------------------------------------------- a step's scan traffic

def mamba_scan_traffic_per_device(cfg, batch: int, seq: int,
                                  data_shards: int = 1,
                                  model_shards: int = 1,
                                  act_bytes: int = 2, chunk: int = 256,
                                  block_d: int = 128, *,
                                  peaks: Dict[str, float]
                                  ) -> Dict[str, float]:
    """Per-device bytes for ALL mamba blocks of one train step (fwd+bwd),
    and their time at ``peaks``' HBM rate. One card: the shards are 1."""
    B = batch / data_shards                 # rows per device
    L = seq
    D = cfg.d_inner / model_shards          # channels per device
    N = cfg.d_state
    nD = max(1, D // block_d)
    s = act_bytes
    fwd = (2 * B * L * D * s          # u, Δ in
           + 2 * B * L * N * s        # B, C in
           + B * L * 4                # positions
           + B * L * D * s            # y out
           + B * (L / chunk) * N * D * 4)   # checkpoints
    bwd = (fwd                        # recompute reads ≈ fwd reads
           + B * L * D * s            # dy in
           + 2 * B * L * D * 4        # du, dΔ out (f32)
           + 2 * B * nD * L * N * 4)  # dB, dC partials
    conv = 3 * (2 * B * L * D * s + B * L * 4)   # fwd + dx + dw passes
    per_layer = fwd + bwd + conv
    total = per_layer * cfg.n_layers
    return {"per_layer_bytes": per_layer, "total_bytes": total,
            "t_memory_s": total / peaks["hbm_bw"]}


def compare_scan_paths(cfg, batch: int, seq: int, data_shards: int = 1,
                       model_shards: int = 1,
                       measured_xla_scan_share: float = 0.9,
                       measured_t_memory_s: Optional[float] = None, *,
                       peaks: Dict[str, float]) -> Dict[str, float]:
    """Kernel-path projection: replace ~``measured_xla_scan_share`` of a
    measured memory term (the scan's share) with the analytic kernel
    traffic."""
    k = mamba_scan_traffic_per_device(cfg, batch, seq, data_shards,
                                      model_shards, peaks=peaks)
    out = dict(k)
    if measured_t_memory_s is not None:
        rest = measured_t_memory_s * (1 - measured_xla_scan_share)
        out["projected_t_memory_s"] = rest + k["t_memory_s"]
        out["speedup_vs_xla"] = measured_t_memory_s / \
            out["projected_t_memory_s"]
    return out
