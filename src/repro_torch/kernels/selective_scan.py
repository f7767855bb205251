"""Selective scan forward and backward: the CUDA kernels of both
schedules, their plain PyTorch versions, and the wrappers that pick one by
the tensor's device.

Replaces the four Pallas TPU kernels of ``repro.kernels.selective_scan``
behind its entries ``selective_scan_fwd_pallas`` /
``selective_scan_bwd_pallas``, picked as there by ``schedule``:

* ``"blocked"``: ``_fwd_kernel_blocked`` (#4) → ``csrc/selective_scan.cu``
  and ``_bwd_kernel_blocked`` (#6) → ``csrc/selective_scan_bwd.cu``. #4 is
  #3's kernel (below, from ``csrc/scan_fwd_lanes.cuh``) with any chunk: at
  chunk 64 it writes every tile's entry state; at any other chunk each lane
  writes the state before each of its steps that starts a chunk from its
  registers during the replay. #6 is chunk-parallel — a carry pass gives
  each chunk's adjoint with zero carry-in and its decay product, a
  fixed-order combine hands every chunk its carry, then every chunk runs at
  once from its checkpoint (``selective_scan_bwd_chunked_plain`` is that
  arithmetic in PyTorch);
* ``"step"``: ``_fwd_kernel`` (#3) → ``csrc/selective_scan.cu`` (#4's
  chunk-64 kernel under its own name) and ``_bwd_kernel`` (#5) →
  ``csrc/selective_scan_step_bwd.cu``: a block walks the row in tiles of
  ``STEP_TILE_T`` steps for 16 channels (#5's ``STEP_BLOCK_D``; #3's and
  #4's width is their one build knob set, ``lanes_fwd_params()``),
  each tile a segmented associative scan over time (parallel inside the
  block: a channel's tile split over lanes of 8 consecutive steps, combined
  by a log-depth shuffle scan; #3 applies the tile's entry state after the
  combine; #5's dB/dC terms summed over a warp's channels by shuffles before
  the block's warps are added; ``selective_scan_fwd_step_lanes_plain``, for
  #3 and, with its ``chunk``, #4, and ``selective_scan_bwd_step_lanes_plain``
  for #5 are that arithmetic in PyTorch, for the tests).

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
``chunk``: #4 takes any length ≥ 1, #6 a multiple of ``TILE_T``, #3 and #5
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
BLOCK_D = 32                      # #6 channels per block (dB/dC partials)
TILE_T = 16                       # #6's time tile: its chunk is a multiple
STEP_BLOCK_D = 16                 # #5 channels per block (dB/dC partials)
STEP_TILE_T = 64                  # #3/#4/#5 time tile; #3/#5's one chunk
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


def selective_scan_fwd_step_lanes_plain(u, delta, At, Bm, Cm, Dp, positions,
                                        steps: int = 8,
                                        block_d: int = 16,
                                        chunk: int = STEP_TILE_T):
    """#3's and #4's arithmetic in PyTorch (f32). Tiles of T =
    ``STEP_TILE_T`` steps; a channel's tile split over T / ``steps`` lanes
    of ``steps`` consecutive steps. Per tile and state:

    * each lane folds its steps into (Π a, h from 0); a Kogge–Stone combine
      over the lanes (offsets 1, 2, 4, …) with zero carry-in gives each lane
      the map (A_incl, B_incl) from the tile's entry to its exit;
    * the tile's entry state h_in is applied after it: a lane exits at
      A_incl·h_in + B_incl, and enters at the previous lane's exit (h_in for
      lane 0); the last lane's exit is the next tile's h_in, so the tiles'
      chain holds one product and one sum a state;
    * the lane replays its steps; y = D·u plus C_t[n]·h_t[n] for n = 0, 1,
      … in turn, as the kernel adds them.

    The checkpoints, every ``chunk`` steps (nC = ceil(L / chunk)): the state
    before each chunk's first step as its lane holds it in the replay (at
    chunk T the tiles' entry states h_in, as the kernels' chunk-64 path
    writes them from the slots).

    L is padded to whole tiles with identity steps (a = 1, b = 0), D to whole
    blocks of ``block_d`` with dead channels (A = 0). Returns
    ``selective_scan_fwd_plain``'s outputs: (y in u's dtype, ckpts (B, nC,
    N, D) f32)."""
    Bz, L, Dm = u.shape
    N = At.shape[0]
    T, R = STEP_TILE_T, steps
    S = T // R
    if T % R or S & (S - 1):
        raise ValueError(f"steps {steps} must split a tile of {T} over a "
                         f"power of two of lanes")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    nT = n_chunks(L, T)
    pad, dpad = nT * T - L, (-Dm) % block_d
    Dw = Dm + dpad

    def tiles(x, fill, chan):         # (B, L, ...) → (B, nT, S, R, ...)
        if pad:
            x = torch.cat([x, x.new_full((Bz, pad) + x.shape[2:], fill)], 1)
        if chan and dpad:
            x = torch.cat([x, x.new_zeros(x.shape[:2] + (dpad,))], 2)
        return x.reshape(Bz, nT, S, R, *x.shape[2:])

    u32, d32 = tiles(u.float(), 0.0, True), tiles(delta.float(), 0.0, True)
    B32, C32 = tiles(Bm.float(), 0.0, False), tiles(Cm.float(), 0.0, False)
    pos = tiles(positions, 1, False)
    A = torch.cat([At.float(), At.new_zeros((N, dpad))], 1).t()  # (Dw, N)
    Dv = torch.cat([Dp.float(), Dp.new_zeros(dpad)])
    a = torch.exp(d32[..., None] * A)                    # (B,nT,S,R,Dw,N)
    a = torch.where((pos == 0)[..., None, None], 0.0, a)
    bb = B32[..., None, :] * (d32 * u32)[..., None]
    # each lane's fold, then the combine over the lanes, every tile at once
    Af, Bf = a[:, :, :, 0], bb[:, :, :, 0]               # (B, nT, S, Dw, N)
    for r in range(1, R):
        Bf = a[:, :, :, r] * Bf + bb[:, :, :, r]
        Af = Af * a[:, :, :, r]
    lane = torch.arange(S, device=u.device)[:, None, None]
    off = 1
    while off < S:
        Ap, Bp = torch.roll(Af, off, dims=2), torch.roll(Bf, off, dims=2)
        on = lane >= off
        Bf = torch.where(on, Af * Bp + Bf, Bf)
        Af = torch.where(on, Af * Ap, Af)
        off *= 2
    # the tiles' chain: h_in of each tile from the last lane's map
    h_in = [u32.new_zeros((Bz, Dw, N))]
    for k in range(nT - 1):
        h_in.append(Af[:, k, S - 1] * h_in[-1] + Bf[:, k, S - 1])
    h_in = torch.stack(h_in, 1)                          # (B, nT, Dw, N)
    exit_ = Af * h_in[:, :, None] + Bf                   # each lane's exit
    h = torch.cat([h_in[:, :, None], exit_[:, :, :-1]], 2)
    y = u32.new_empty(u32.shape)                         # (B, nT, S, R, Dw)
    before = []                                          # h before step r
    for r in range(R):
        before.append(h)
        h = a[:, :, :, r] * h + bb[:, :, :, r]
        acc = Dv * u32[:, :, :, r]
        for n in range(N):
            acc = acc + C32[:, :, :, r, None, n] * h[..., n]
        y[:, :, :, r] = acc
    y = y.reshape(Bz, nT * T, Dw)[:, :L, :Dm]
    # (B, nT, S, R, Dw, N) by step; at a tile's first step, its h_in
    ck = torch.stack(before, 3).reshape(Bz, nT * T, Dw, N)[:, :L:chunk]
    return y.to(u.dtype), ck.transpose(2, 3)[..., :Dm].contiguous()


def selective_scan_bwd_step_lanes_plain(u, delta, At, Bm, Cm, Dp, positions,
                                        ckpts, dy, lanes: int = 8,
                                        steps: int = 8,
                                        block_d: int = STEP_BLOCK_D):
    """#5's arithmetic in PyTorch (f32). Tiles of T = ``lanes``·``steps``
    steps (the checkpoint chunk), last first; a channel's tile split over
    ``lanes`` lanes of ``steps`` consecutive steps. Per tile and state:

    * recompute: each lane folds its steps into (Π a, h from 0); a
      Kogge–Stone combine over the lanes (offsets 1, 2, 4, …), the tile's
      checkpoint folded into lane 0, gives each lane its entry state; the
      lane replays its steps;
    * adjoint: each lane folds its steps backwards into (Π a, gc from 0),
      the later tile's carry folded into the last lane, the same combine
      from the high lanes; the lane replays g_t = C_t·dy_t + gc_{t+1}
      backwards (``selective_scan_bwd_plain``'s formulas);
    * dB_t, dC_t: summed pairwise over a warp's 32/``lanes`` channels
      (neighbours first, as the kernel's xor reduce-scatter adds them), then
      over the warps of each ``block_d`` channels in order; dA: each lane's
      terms summed backwards over its steps, pairwise over the lanes, added
      tile after tile; dD likewise over the lanes at the end.

    L is padded to whole tiles with identity steps (a = 1, dy = 0), D to
    whole blocks with dead channels. Returns ``selective_scan_bwd_plain``'s
    outputs."""
    Bz, L, Dm = u.shape
    N = At.shape[0]
    S, R, T = lanes, steps, lanes * steps
    cpw = 32 // S
    if 32 % S or block_d % cpw:
        raise ValueError(f"{lanes} lanes a channel give {cpw} channels a "
                         f"warp, which must divide block_d {block_d}")
    nT = n_chunks(L, T)
    if ckpts.shape[1] != nT:
        raise ValueError(f"ckpts hold {ckpts.shape[1]} chunks; tiles of "
                         f"{T} steps need {nT}")
    pad, dpad = nT * T - L, (-Dm) % block_d
    Dw = Dm + dpad

    def tiles(x, fill, chan):         # (B, L, ...) → (B, nT, S, R, ...)
        if pad:
            x = torch.cat([x, x.new_full((Bz, pad) + x.shape[2:], fill)], 1)
        if chan and dpad:
            x = torch.cat([x, x.new_zeros(x.shape[:2] + (dpad,))], 2)
        return x.reshape(Bz, nT, S, R, *x.shape[2:])

    u32, d32 = tiles(u.float(), 0.0, True), tiles(delta.float(), 0.0, True)
    dy32 = tiles(dy.float(), 0.0, True)
    B32, C32 = tiles(Bm.float(), 0.0, False), tiles(Cm.float(), 0.0, False)
    pos = tiles(positions, 1, False)
    A = torch.cat([At.float(), At.new_zeros((N, dpad))], 1).t()  # (Dw, N)
    Dv = torch.cat([Dp.float(), Dp.new_zeros(dpad)])
    ck = torch.cat([ckpts.float(),
                    ckpts.new_zeros(ckpts.shape[:3] + (dpad,))],
                   3).transpose(2, 3)                        # (B, nT, Dw, N)
    du_t = d32 * u32                                         # (B,nT,S,R,Dw)
    lane = torch.arange(S, device=u.device)[:, None, None]   # over (S, Dw, N)

    def shift(x, off, up):            # lane s reads lane s ∓ off (masked)
        return torch.roll(x, off if up else -off, dims=1)

    def lane_tree(x):                 # (B, S, ...) → (B, ...), pairwise
        while x.shape[1] > 1:         # over lanes s ^ m, m = S/2, ..., 1
            h = x.shape[1] // 2
            x = x[:, :h] + x[:, h:]
        return x[:, 0]

    out_shape = (Bz, nT, S, R, Dw)
    du, ddt = u32.new_empty(out_shape), u32.new_empty(out_shape)
    pdB = u32.new_empty(out_shape + (N,))
    pdC = u32.new_empty(out_shape + (N,))
    dA = u32.new_zeros((Bz, Dw, N))
    gc_later = u32.new_zeros((Bz, Dw, N))
    for k in reversed(range(nT)):
        dl, dut, dyv = d32[:, k], du_t[:, k], dy32[:, k]     # (B, S, R, Dw)
        a = torch.exp(dl[..., None] * A)                     # (B,S,R,Dw,N)
        a = torch.where((pos[:, k] == 0)[..., None, None], 0.0, a)
        bb = B32[:, k][:, :, :, None, :] * dut[..., None]
        cc = C32[:, k][:, :, :, None, :] * dyv[..., None]
        # recompute
        Af, Bf = a[:, :, 0], bb[:, :, 0]                     # (B, S, Dw, N)
        for r in range(1, R):
            Bf = a[:, :, r] * Bf + bb[:, :, r]
            Af = Af * a[:, :, r]
        h_in = ck[:, k]
        Bf = torch.cat([(Af[:, 0] * h_in + Bf[:, 0])[:, None], Bf[:, 1:]], 1)
        off = 1
        while off < S:
            Ap, Bp = shift(Af, off, True), shift(Bf, off, True)
            on = lane >= off
            Bf = torch.where(on, Af * Bp + Bf, Bf)
            Af = torch.where(on, Af * Ap, Af)
            off *= 2
        hp = [torch.cat([h_in[:, None], Bf[:, :-1]], 1)]
        for r in range(R):
            hp.append(a[:, :, r] * hp[-1] + bb[:, :, r])
        # adjoint carry
        Ar, Gr = a[:, :, R - 1], a[:, :, R - 1] * cc[:, :, R - 1]
        for r in reversed(range(R - 1)):
            Gr = a[:, :, r] * (cc[:, :, r] + Gr)
            Ar = Ar * a[:, :, r]
        last = Ar[:, -1] * gc_later + Gr[:, -1]
        Gr = torch.cat([Gr[:, :-1], last[:, None]], 1)
        off = 1
        while off < S:
            An, Gn = shift(Ar, off, False), shift(Gr, off, False)
            on = lane + off < S
            Gr = torch.where(on, Ar * Gn + Gr, Gr)
            Ar = torch.where(on, Ar * An, Ar)
            off *= 2
        gc = torch.cat([Gr[:, 1:], gc_later[:, None]], 1)
        gc_later = Gr[:, 0]
        # replay backwards
        gB = u32.new_zeros((Bz, S, R, Dw))
        dda = u32.new_zeros((Bz, S, R, Dw))
        dAn = u32.new_zeros((Bz, S, Dw, N))
        for r in reversed(range(R)):
            g = cc[:, :, r] + gc
            ta = g * hp[r] * a[:, :, r]
            dda[:, :, r] = (ta * A).sum(-1)
            dAn = dAn + ta * dl[:, :, r, :, None]
            gB[:, :, r] = (g * B32[:, k][:, :, r, None, :]).sum(-1)
            pdB[:, k, :, r] = g * dut[:, :, r, :, None]
            pdC[:, k, :, r] = hp[r + 1] * dyv[:, :, r, :, None]
            gc = a[:, :, r] * g
        du[:, k] = dl * gB + Dv * dyv
        ddt[:, k] = dda + u32[:, k] * gB
        dA = dA + lane_tree(dAn)

    def rows(x):                      # (B, nT, S, R, ...) → (B, L, ...)
        return x.reshape(Bz, nT * T, *x.shape[4:])[:, :L]

    def partials(x):                  # (B,nT,S,R,Dw,N) → (B, nblk, L, N)
        x = rows(x).reshape(Bz, L, Dw // block_d, block_d // cpw, cpw, N)
        while x.shape[4] > 1:         # a warp's channels, neighbours first
            x = x[:, :, :, :, 0::2] + x[:, :, :, :, 1::2]
        x = x[:, :, :, :, 0]
        acc = x[:, :, :, 0]
        for w in range(1, x.shape[3]):    # the warps in order
            acc = acc + x[:, :, :, w]
        return acc.transpose(1, 2)

    dD = lane_tree((dy32 * u32).sum((1, 3)))
    return (rows(du)[..., :Dm], rows(ddt)[..., :Dm], partials(pdB),
            partials(pdC), dA[:, :Dm].transpose(1, 2), dD[:, :Dm])


# ------------------------------------------------------------------ kernels

_FWD_LIB = "selective_scan"       # #3's and #4's library
_BWD_LIB = "selective_scan_bwd"   # #6's library
_STEP_BWD_LIB = "selective_scan_step_bwd"   # #5's library
_LIBS = {("fwd", "blocked"): _FWD_LIB, ("bwd", "blocked"): _BWD_LIB,
         ("fwd", "step"): _FWD_LIB, ("bwd", "step"): _STEP_BWD_LIB}


def _entry(kind, dtype, schedule):
    """The C entry ``selective_scan_<kind>_<dtype>`` (#4 from library
    ``selective_scan``, #6 from ``selective_scan_bwd``) or
    ``selective_scan_step_<kind>_<dtype>`` (#3 from ``selective_scan``, #5
    from ``selective_scan_step_bwd``), its ctypes signature declared."""
    fn = _entries.get((kind, dtype, schedule))
    if fn is None:
        step = schedule == "step"
        name = f"selective_scan_step_{kind}" if step else \
            f"selective_scan_{kind}"
        fn = getattr(_build.load(_LIBS[(kind, schedule)]),
                     f"{name}_{_DTYPES[dtype]}")
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


def lanes_fwd_params() -> dict:
    """#3's and #4's build knobs (one set, one kernel): ``steps`` a lane,
    ``block_d`` (channels a block), ``min_blocks`` (the launch bound of the
    chunk-64 kernel for bf16 input)."""
    got = _entries.get("lanes_fwd_params")
    if got is None:
        out = (ctypes.c_int * 3)()
        _build.load(_FWD_LIB).selective_scan_fwd_params(out)
        got = dict(zip(("steps", "block_d", "min_blocks"), out))
        _entries["lanes_fwd_params"] = got
    return got


def lanes_fwd_resources(dtype, chunk: int = STEP_TILE_T) -> dict:
    """The forward kernel that ``chunk`` takes (64: #3's, and #4's on the
    main path; any other chunk: #4's), on the current CUDA device for
    ``dtype`` input: blocks and warps an SM, registers and local (spill)
    bytes a thread, shared bytes a block."""
    out = (ctypes.c_int * 5)()
    err = _build.load(_FWD_LIB).selective_scan_fwd_occupancy(
        int(dtype == torch.bfloat16), int(chunk), out)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd_occupancy failed: "
                           f"cudaError {err}")
    return dict(zip(("blocks_per_sm", "warps_per_sm", "registers",
                     "local_bytes", "shared_bytes"), out))


def step_bwd_params() -> dict:
    """#5's build knobs: ``steps`` a lane, ``block_d`` (channels a block),
    ``group`` (states between its channel-sum barriers), ``min_blocks``
    (its launch bound for bf16 input)."""
    got = _entries.get("step_bwd_params")
    if got is None:
        out = (ctypes.c_int * 4)()
        _build.load(_STEP_BWD_LIB).selective_scan_step_bwd_params(out)
        got = dict(zip(("steps", "block_d", "group", "min_blocks"), out))
        _entries["step_bwd_params"] = got
    return got


def step_bwd_resources(dtype) -> dict:
    """#5 on the current CUDA device for ``dtype`` input: blocks and warps
    an SM, registers and local (spill) bytes a thread, shared bytes a
    block."""
    out = (ctypes.c_int * 5)()
    err = _build.load(_STEP_BWD_LIB).selective_scan_step_bwd_occupancy(
        int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"selective_scan_step_bwd_occupancy failed: "
                           f"cudaError {err}")
    return dict(zip(("blocks_per_sm", "warps_per_sm", "registers",
                     "local_bytes", "shared_bytes"), out))


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
