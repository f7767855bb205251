"""Selective scan forward and backward: the CUDA kernels of both
schedules, their plain PyTorch versions, and the wrappers that pick one by
the tensor's device.

Replaces the four Pallas TPU kernels of ``repro.kernels.selective_scan``
behind its entries ``selective_scan_fwd_pallas`` /
``selective_scan_bwd_pallas``, picked as there by ``schedule``:

* ``"blocked"``: ``_fwd_kernel_blocked`` (#4) → ``csrc/selective_scan.cu``:
  a block walks a row's whole L, one step at a time, for ``BLOCK_D``
  channels; ``_bwd_kernel_blocked`` (#6) → ``csrc/selective_scan_bwd.cu``:
  chunk-parallel — a carry pass gives each chunk's adjoint with zero carry-in
  and its decay product, a fixed-order combine hands every chunk its carry,
  then every chunk runs at once from its checkpoint
  (``selective_scan_bwd_chunked_plain`` is that arithmetic in PyTorch);
* ``"step"``: ``_fwd_kernel`` (#3) and ``_bwd_kernel`` (#5) →
  ``csrc/selective_scan_step.cu``: a block walks the row in tiles of
  ``STEP_TILE_T`` steps for ``STEP_BLOCK_D`` channels, each tile a
  segmented associative scan over time (parallel inside the block).

Both schedules compute one function and keep the TPU kernels' contract:

* forward: u, delta (B, L, D) f32|bf16; At (N, D) f32; Bm, Cm (B, L, N) of
  u's dtype; Dp (D,) f32; positions (B, L) int32 → y (B, L, D) in u's dtype
  and ckpts (B, ceil(L/chunk), N, D) f32, the state at each chunk's entry;
* backward: the same inputs, ckpts and dy → du, ddelta (B, L, D) f32; dB
  and dC partials (B, nblk, L, N) f32, one per block of ``block_d(schedule)``
  channels (32 for #6, 16 for #5); dA partial (B, N, D) f32; dD partial
  (B, D) f32. The caller sums the partials (``kernels/ops.py``) in a fixed
  order, whatever the block width. (#6 writes dA and dD per group of chunks;
  the wrapper sums that axis in a fixed order before it returns.)

The checkpoints are the same for both schedules, so a forward of one feeds
the backward of the other. None pads: a ragged L and D are masked inside.
``chunk``: #4 takes any length, #6 a multiple of ``TILE_T``, #3 and #5
exactly ``STEP_TILE_T`` (their tile is the chunk; ``ops.SCAN_CHUNK``).

* A CPU tensor takes the plain version (the same for both schedules, as the
  JAX package's one XLA twin serves both); a CUDA tensor launches the
  schedule's kernel or raises.
* ``LAUNCHES_FWD`` / ``LAUNCHES_BWD`` count launches of #4 / #6, and
  ``LAUNCHES_FWD_STEP`` / ``LAUNCHES_BWD_STEP`` of #3 / #5, and nothing
  else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES_FWD = 0                  # #4 (blocked)
LAUNCHES_BWD = 0                  # #6 (blocked)
LAUNCHES_FWD_STEP = 0             # #3 (step)
LAUNCHES_BWD_STEP = 0             # #5 (step)
SCHEDULES = ("blocked", "step")
BLOCK_D = 32                      # #4/#6 channels per block (dB/dC partials)
TILE_T = 16                       # #4's time tile; #6's chunk unit
STEP_BLOCK_D = 16                 # #3/#5 channels per block (dB/dC partials)
STEP_TILE_T = 64                  # #3/#5 time tile = their one chunk
D_STATE = 16                      # the kernels instantiate N = 16
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_entries = {}                     # (kind, dtype, schedule) → C entry, bound
#                                   at first use


def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; have {SCHEDULES}")


def block_d(schedule: str) -> int:
    """Channels per dB/dC partial of ``schedule``'s backward kernel."""
    check_schedule(schedule)
    return STEP_BLOCK_D if schedule == "step" else BLOCK_D


def n_chunks(L: int, chunk: int) -> int:
    return -(-L // chunk)


# ------------------------------------------------------------------ plain

def _decay(d32_t, A, pos_t):
    """a_t (B, D, N): exp(Δ_t·A), 0 where the position resets."""
    a = torch.exp(d32_t[..., None] * A)
    return torch.where((pos_t == 0)[:, None, None], 0.0, a)


def selective_scan_fwd_plain(u, delta, At, Bm, Cm, Dp, positions,
                             chunk: int):
    """The forward kernel's function as a per-step walk in f32: returns
    (y in u's dtype, ckpts (B, nC, N, D) f32)."""
    Bz, L, Dm = u.shape
    N = At.shape[0]
    u32, d32 = u.float(), delta.float()
    B32, C32 = Bm.float(), Cm.float()
    A = At.float().t()                                       # (D, N)
    h = torch.zeros((Bz, Dm, N), dtype=torch.float32, device=u.device)
    ckpts = torch.empty((Bz, n_chunks(L, chunk), N, Dm), dtype=torch.float32,
                        device=u.device)
    y = torch.empty((Bz, L, Dm), dtype=torch.float32, device=u.device)
    for t in range(L):
        if t % chunk == 0:
            ckpts[:, t // chunk] = h.transpose(1, 2)
        a = _decay(d32[:, t], A, positions[:, t])
        h = a * h + B32[:, t, None, :] * (d32[:, t] * u32[:, t])[..., None]
        y[:, t] = (h * C32[:, t, None, :]).sum(-1) + Dp.float() * u32[:, t]
    return y.to(u.dtype), ckpts


def _block_sum(x, block_d):
    """(B, D, N) → (B, ceil(D/block_d), N): channel sums per block."""
    Bz, Dm, N = x.shape
    pad = (-Dm) % block_d
    if pad:
        x = torch.cat([x, x.new_zeros((Bz, pad, N))], dim=1)
    return x.reshape(Bz, -1, block_d, N).sum(2)


def selective_scan_bwd_plain(u, delta, At, Bm, Cm, Dp, positions, ckpts, dy,
                             chunk: int, block_d: int = BLOCK_D):
    """The backward kernel's function, written out (not autograd): per
    chunk, the states recomputed from its checkpoint, then the reverse walk

        g_t = C_t·dy_t + a_{t+1}·g_{t+1}      (0 carried across a reset)
        du  = Δ·Σ_n g·B + D·dy                dΔ = Σ_n g·h_{t-1}·a·A + u·Σ_n g·B
        dB_t = Σ_d g·Δ·u     dC_t = Σ_d h_t·dy     dA = Σ_t g·h_{t-1}·a·Δ     dD = Σ_t dy·u

    Returns the kernel's outputs, dB/dC as per-``block_d`` partials."""
    Bz, L, Dm = u.shape
    N = At.shape[0]
    dev = u.device
    u32, d32, dy32 = u.float(), delta.float(), dy.float()
    B32, C32 = Bm.float(), Cm.float()
    A = At.float().t()                                       # (D, N)
    Dv = Dp.float()
    nblk = -(-Dm // block_d)
    du = torch.empty((Bz, L, Dm), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(du)
    dB = torch.empty((Bz, nblk, L, N), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.zeros((Bz, Dm, N), dtype=torch.float32, device=dev)
    dD = torch.zeros((Bz, Dm), dtype=torch.float32, device=dev)
    gc = torch.zeros((Bz, Dm, N), dtype=torch.float32, device=dev)
    for ci in reversed(range(n_chunks(L, chunk))):
        t0, t1 = ci * chunk, min(L, (ci + 1) * chunk)
        hs = [ckpts[:, ci].transpose(1, 2).float()]          # h_{t0-1}
        for t in range(t0, t1):
            a = _decay(d32[:, t], A, positions[:, t])
            hs.append(a * hs[-1] + B32[:, t, None, :] *
                      (d32[:, t] * u32[:, t])[..., None])
        for t in reversed(range(t0, t1)):
            a = _decay(d32[:, t], A, positions[:, t])
            g = C32[:, t, None, :] * dy32[:, t, :, None] + gc
            da = g * hs[t - t0]
            gB = (g * B32[:, t, None, :]).sum(-1)
            du[:, t] = d32[:, t] * gB + Dv * dy32[:, t]
            ddt[:, t] = (da * a * A).sum(-1) + u32[:, t] * gB
            dB[:, :, t] = _block_sum(g * (d32[:, t] * u32[:, t])[..., None],
                                     block_d)
            dC[:, :, t] = _block_sum(hs[t - t0 + 1] * dy32[:, t, :, None],
                                     block_d)
            dA += da * a * d32[:, t, :, None]
            dD += dy32[:, t] * u32[:, t]
            gc = a * g
    return du, ddt, dB, dC, dA.transpose(1, 2), dD


def selective_scan_bwd_chunked_plain(u, delta, At, Bm, Cm, Dp, positions,
                                     ckpts, dy, chunk: int,
                                     block_d: int = BLOCK_D):
    """#6's arithmetic in PyTorch, every chunk at once (f32). For one
    (b, d, n), chunk c covers [t0, t1); its adjoint is
    g_t = g^loc_t + Φ_t·G_c (g^loc: the chunk's adjoint with zero carry-in,
    Φ_t = Π_{s=t+1}^{t1-1} a_s, G_c = a_{t1}·g_{t1} the carry from chunk
    c+1), so

        G_{c-1} = E_c + P_c·G_c,  E_c = a_{t0}·g^loc_{t0},  P_c = Π_{s∈c} a_s.

    1. carry: (E_c, P_c) for every chunk, one reverse walk vectorised over
       the chunks; 2. combine: G_c from the last chunk down; 3. each chunk's
       backward from (checkpoint, G_c). L is padded to whole chunks with
       identity steps (a = 1, dy = 0). Returns ``selective_scan_bwd_plain``'s
       outputs."""
    Bz, L, Dm = u.shape
    N = At.shape[0]
    nC = n_chunks(L, chunk)
    pad = nC * chunk - L

    def chunked(x, fill):            # (B, L, ...) → (B, nC, chunk, ...)
        if pad:
            x = torch.cat([x, x.new_full((Bz, pad) + x.shape[2:], fill)], 1)
        return x.reshape(Bz, nC, chunk, *x.shape[2:])

    u32, d32 = chunked(u.float(), 0.0), chunked(delta.float(), 0.0)
    dy32 = chunked(dy.float(), 0.0)
    B32, C32 = chunked(Bm.float(), 0.0), chunked(Cm.float(), 0.0)
    pos = chunked(positions, 1)
    A = At.float().t()                                       # (D, N)
    a = torch.exp(d32[..., None] * A)                        # (B,nC,T,D,N)
    a = torch.where((pos == 0)[..., None, None], 0.0, a)
    bdu = B32[:, :, :, None, :] * (d32 * u32)[..., None]
    cdy = C32[:, :, :, None, :] * dy32[..., None]
    # 1. carry pass
    cg = torch.zeros((Bz, nC, Dm, N), dtype=torch.float32, device=u.device)
    P = torch.ones_like(cg)
    for s in reversed(range(chunk)):
        cg = a[:, :, s] * (cdy[:, :, s] + cg)
        P = P * a[:, :, s]
    # 2. combine, in a fixed order
    Gc = torch.empty_like(cg)
    G = torch.zeros_like(cg[:, 0])
    for c in reversed(range(nC)):
        Gc[:, c] = G
        G = cg[:, c] + P[:, c] * G
    # 3. every chunk from its checkpoint and carry
    hs = [ckpts.transpose(2, 3).float()]                     # (B,nC,D,N)
    for s in range(chunk):
        hs.append(a[:, :, s] * hs[-1] + bdu[:, :, s])
    gc = Gc
    shape = (Bz, nC, chunk, Dm)
    du, ddt = u32.new_empty(shape), u32.new_empty(shape)
    gdu, hdy = a.new_empty(a.shape), a.new_empty(a.shape)
    dA = torch.zeros_like(cg)
    Dv = Dp.float()
    for s in reversed(range(chunk)):
        g = cdy[:, :, s] + gc
        daa = g * hs[s] * a[:, :, s]
        gB = (g * B32[:, :, s, None, :]).sum(-1)
        du[:, :, s] = d32[:, :, s] * gB + Dv * dy32[:, :, s]
        ddt[:, :, s] = (daa * A).sum(-1) + u32[:, :, s] * gB
        gdu[:, :, s] = g * (d32 * u32)[:, :, s, :, None]
        hdy[:, :, s] = hs[s + 1] * dy32[:, :, s, :, None]
        dA += daa * d32[:, :, s, :, None]
        gc = a[:, :, s] * g

    def rows(x):                     # (B, nC, chunk, ...) → (B, L, ...)
        return x.reshape(Bz, nC * chunk, *x.shape[3:])[:, :L]

    def partials(x):                 # (B,nC,T,D,N) → (B, nblk, L, N)
        x = rows(x)
        return _block_sum(x.reshape(Bz * L, Dm, N), block_d).reshape(
            Bz, L, -1, N).transpose(1, 2)

    dD = (rows(dy32) * rows(u32)).sum(1)
    return (rows(du), rows(ddt), partials(gdu), partials(hdy),
            dA.sum(1).transpose(1, 2), dD)


# ------------------------------------------------------------------ kernels

_BWD_LIB = "selective_scan_bwd"   # #6's library


def _entry(kind, dtype, schedule):
    """The C entry ``selective_scan_fwd_<dtype>`` (#4, library
    ``selective_scan``), ``selective_scan_bwd_<dtype>`` (#6, library
    ``selective_scan_bwd``) or ``selective_scan_step_<kind>_<dtype>``
    (#3/#5), its ctypes signature declared."""
    fn = _entries.get((kind, dtype, schedule))
    if fn is None:
        step = schedule == "step"
        lib = "selective_scan_step" if step else \
            _BWD_LIB if kind == "bwd" else "selective_scan"
        name = f"{lib}_{kind}" if step else f"selective_scan_{kind}"
        fn = getattr(_build.load(lib), f"{name}_{_DTYPES[dtype]}")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        head = [vp, vp, vp, vp, vp, i64, i64, vp, vp, i64]
        outs = 2 if kind == "fwd" else 8 if step else 12
        fn.argtypes = head + [vp] * outs + [i32, i32, i32, i32, vp]
        fn.restype = i32
        _entries[(kind, dtype, schedule)] = fn
    return fn


def bwd_params() -> dict:
    """#6's build knobs: ``tile`` (its time tile), ``group`` (chunks a
    block of its chunk kernel), ``min_blocks`` (that kernel's launch
    bound)."""
    got = _entries.get("bwd_params")
    if got is None:
        out = (ctypes.c_int * 3)()
        _build.load(_BWD_LIB).selective_scan_bwd_params(out)
        got = dict(zip(("tile", "group", "min_blocks"), out))
        _entries["bwd_params"] = got
    return got


def bwd_resources(dtype, chunk: int) -> dict:
    """#6's three kernels on the current CUDA device for ``dtype`` input at
    ``chunk``: blocks and warps an SM, registers and local (spill) bytes a
    thread, shared bytes a block."""
    lib = _build.load(_BWD_LIB)
    res = {}
    for which, name in enumerate(("carry", "combine", "chunk")):
        out = (ctypes.c_int * 5)()
        err = lib.selective_scan_bwd_occupancy(
            int(dtype == torch.bfloat16), which, chunk, out)
        if err != 0:
            raise RuntimeError(f"selective_scan_bwd_occupancy failed: "
                               f"cudaError {err}")
        res[name] = dict(zip(("blocks_per_sm", "warps_per_sm", "registers",
                              "local_bytes", "shared_bytes"), out))
    return res


def _check(u, delta, At, Bm, Cm, Dp, positions, chunk):
    if u.dim() != 3:
        raise ValueError(f"u must be (B, L, D), got shape {tuple(u.shape)}")
    Bz, L, Dm = u.shape
    N = At.shape[0]
    if u.dtype not in _DTYPES:
        raise TypeError(f"u dtype {u.dtype} not supported (f32 or bf16)")
    if delta.dtype != u.dtype or Bm.dtype != u.dtype or Cm.dtype != u.dtype:
        raise TypeError(f"delta {delta.dtype}, B {Bm.dtype} and C "
                        f"{Cm.dtype} must have u's dtype {u.dtype}")
    if At.dtype != torch.float32 or Dp.dtype != torch.float32:
        raise TypeError(f"At {At.dtype} and Dp {Dp.dtype} must be float32")
    if tuple(delta.shape) != (Bz, L, Dm) or tuple(At.shape) != (N, Dm) or \
            tuple(Bm.shape) != (Bz, L, N) or tuple(Cm.shape) != (Bz, L, N) \
            or tuple(Dp.shape) != (Dm,):
        raise ValueError(
            f"shapes u {tuple(u.shape)}, delta {tuple(delta.shape)}, At "
            f"{tuple(At.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
            f"Dp {tuple(Dp.shape)} do not agree")
    if tuple(positions.shape) != (Bz, L) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 ({Bz}, {L}), got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    devs = {t.device for t in (u, delta, At, Bm, Cm, Dp, positions)}
    if len(devs) != 1:
        raise ValueError(f"selective_scan operands on several devices: "
                         f"{devs}")


def _check_cuda(u, delta, At, Bm, Cm, Dp, positions):
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, not "
                         f"{u.device}")
    if u.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {u.device}, the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    if At.shape[0] != D_STATE:
        raise ValueError(f"the kernels take d_state {D_STATE}, got "
                         f"{At.shape[0]}")
    if not (u.is_contiguous() and delta.is_contiguous() and
            At.is_contiguous() and Dp.is_contiguous()):
        raise ValueError("u, delta, At and Dp must be contiguous")
    if Bm.stride(2) != 1 or Bm.stride() != Cm.stride():
        raise ValueError(f"B and C need unit stride along N and equal "
                         f"strides, got {Bm.stride()} and {Cm.stride()}")
    if positions.stride(1) != 1:
        raise ValueError(f"positions needs contiguous rows, got strides "
                         f"{positions.stride()}")


def _head(u, delta, At, Bm, Cm, Dp, positions):
    return (u.data_ptr(), delta.data_ptr(), At.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Bm.stride(0), Bm.stride(1), Dp.data_ptr(),
            positions.data_ptr(), positions.stride(0))


def _check_step_chunk(schedule, chunk):
    if schedule == "step" and chunk != STEP_TILE_T:
        raise ValueError(f"the step kernels take chunk == {STEP_TILE_T} "
                         f"(their time tile), got {chunk}")


def selective_scan_fwd(u, delta, At, Bm, Cm, Dp, positions, chunk: int,
                       schedule: str = "blocked"):
    """See the module docstring. Returns (y, ckpts)."""
    global LAUNCHES_FWD, LAUNCHES_FWD_STEP
    check_schedule(schedule)
    _check(u, delta, At, Bm, Cm, Dp, positions, chunk)
    if u.device.type == "cpu":
        return selective_scan_fwd_plain(u, delta, At, Bm, Cm, Dp, positions,
                                        chunk)
    _check_cuda(u, delta, At, Bm, Cm, Dp, positions)
    _check_step_chunk(schedule, chunk)
    Bz, L, Dm = u.shape
    y = torch.empty_like(u)
    ckpts = torch.empty((Bz, n_chunks(L, chunk), D_STATE, Dm),
                        dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y, ckpts
    err = _entry("fwd", u.dtype, schedule)(
        *_head(u, delta, At, Bm, Cm, Dp, positions), y.data_ptr(),
        ckpts.data_ptr(), Bz, L, Dm, chunk,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan forward kernel ({schedule}) "
                           f"launch failed: cudaError {err}")
    if schedule == "step":
        LAUNCHES_FWD_STEP += 1
    else:
        LAUNCHES_FWD += 1
    return y, ckpts


def selective_scan_bwd(u, delta, At, Bm, Cm, Dp, positions, ckpts, dy,
                       chunk: int, schedule: str = "blocked"):
    """See the module docstring. Returns (du, ddelta, dB_partial,
    dC_partial, dA_partial, dD_partial); the dB/dC partials are per
    ``block_d(schedule)`` channels on either device."""
    global LAUNCHES_BWD, LAUNCHES_BWD_STEP
    bd = block_d(schedule)
    _check(u, delta, At, Bm, Cm, Dp, positions, chunk)
    Bz, L, Dm = u.shape
    want = (Bz, n_chunks(L, chunk), At.shape[0], Dm)
    if tuple(ckpts.shape) != want or ckpts.dtype != torch.float32:
        raise ValueError(f"ckpts must be float32 {want}, got {ckpts.dtype} "
                         f"{tuple(ckpts.shape)}")
    if tuple(dy.shape) != (Bz, L, Dm) or dy.dtype != u.dtype:
        raise ValueError(f"dy must be {u.dtype} {(Bz, L, Dm)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, delta, At, Bm, Cm, Dp, positions,
                                        ckpts, dy, chunk, bd)
    _check_cuda(u, delta, At, Bm, Cm, Dp, positions)
    _check_step_chunk(schedule, chunk)
    if chunk % TILE_T:
        raise ValueError(f"the backward kernel takes a chunk that is a "
                         f"multiple of {TILE_T}, got {chunk}")
    if not (ckpts.is_contiguous() and dy.is_contiguous()):
        raise ValueError("ckpts and dy must be contiguous")
    f32 = dict(dtype=torch.float32, device=u.device)
    nblk = -(-Dm // bd)
    du = torch.empty((Bz, L, Dm), **f32)
    ddt = torch.empty((Bz, L, Dm), **f32)
    dB = torch.empty((Bz, nblk, L, D_STATE), **f32)
    dC = torch.empty((Bz, nblk, L, D_STATE), **f32)
    if du.numel() == 0:
        return (du, ddt, dB, dC, torch.zeros((Bz, D_STATE, Dm), **f32),
                torch.zeros((Bz, Dm), **f32))
    if schedule == "step":
        dA = torch.empty((Bz, D_STATE, Dm), **f32)
        dD = torch.empty((Bz, Dm), **f32)
        scratch = []
    else:
        # dA, dD per group of chunks; the carry pass's E, P (E becomes G)
        # and its f32 copies of B, C
        nC = n_chunks(L, chunk)
        ngrp = -(-nC // bwd_params()["group"])
        dA = torch.empty((Bz, ngrp, D_STATE, Dm), **f32)
        dD = torch.empty((Bz, ngrp, Dm), **f32)
        scratch = [torch.empty((Bz, nC, D_STATE, Dm), **f32)
                   for _ in range(2)]
        scratch += [torch.empty((Bz, L, D_STATE), **f32) for _ in range(2)]
    err = _entry("bwd", u.dtype, schedule)(
        *_head(u, delta, At, Bm, Cm, Dp, positions), ckpts.data_ptr(),
        dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), dD.data_ptr(),
        *(t.data_ptr() for t in scratch), Bz, L, Dm,
        chunk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan backward kernel ({schedule}) "
                           f"launch failed: cudaError {err}")
    if schedule == "step":
        LAUNCHES_BWD_STEP += 1
    else:
        LAUNCHES_BWD += 1
        dA, dD = dA.sum(1), dD.sum(1)
    return du, ddt, dB, dC, dA, dD
