"""Head-structured selective scan (Mamba-2 / SSD, scalar decay per head),
forward and backward: the CUDA kernels, their plain PyTorch versions, and
the wrappers that pick one by the tensor's device.

Replaces the Pallas TPU kernels of ``repro.kernels.selective_scan`` and
keeps their function and checkpoint contract:

* #7 ``_fwd_kernel_blocked_heads`` (``schedule="blocked_heads"``, the main
  path): ``csrc/selective_scan_heads_fwd.cu``, the chunked (SSD) form on
  the tensor cores, per sub-chunk of ``FWD_SUB_T`` steps
  (``selective_scan_heads_fwd_dual_plain(..., tile=FWD_SUB_T)`` is its
  arithmetic on the CPU);
* #8 ``_fwd_kernel_blocked_heads_dual`` (``"blocked_heads_dual"``):
  ``csrc/selective_scan_heads.cu``, the dual form per tile of ``TILE_T``
  steps on the f32 pipes;
* #9 ``_bwd_kernel_blocked_heads`` (the backward of both):
  ``csrc/selective_scan_heads_bwd.cu``, the chunked form on the tensor
  cores, per sub-chunk of ``BWD_SUB_T`` steps
  (``selective_scan_heads_bwd_chunked_plain`` is its arithmetic on the
  CPU).

#7 and #9 share their tensor-core and staging helpers
(``csrc/heads_mma.cuh``) and run one block per slice of ``BWD_P_SLICE``
rows of P. The per-step walks ``selective_scan_heads_fwd_plain`` and
``selective_scan_heads_bwd_plain`` are the references all are held to.
The layout is the JAX public one, not the TPU kernels' head-major copy:

* forward: u (B, L, H, P) f32|bf16; delta (B, L, H) of u's dtype; A (H,)
  f32; Bm, Cm (B, L, N) of u's dtype, any batch and row strides; Dp (H,)
  f32; positions (B, L) int32 → y (B, L, H, P) in u's dtype and ckpts
  (B, H, ceil(L/chunk), P, N) f32, the state at each chunk's entry;
* backward: the same inputs, ckpts and dy (B, L, H, P) → du (B, L, H, P)
  f32 and partials over slices of ``BWD_P_SLICE`` rows of P (``n_slices``;
  one a head at P = 64): ddelta (B, L, H, nps), dB and dC (B, H·nps, L, N),
  dA and dD (B, H, nps), all f32. The caller sums them
  (``kernels/ops.py``) in a fixed order.

    a_t = exp(Δ_t·A) (0 where pos_t == 0);  h_t = a_t·h_{t-1} + (Δ_t·u_t) ⊗ B_t
    y_t = h_t·C_t + D·u_t

Nothing is padded: a ragged L is masked inside, with the semantics the
reference pads to (pos = 1, Δ = 0 past L). Any chunk ≥ 1.

* A CPU tensor takes the plain version; a CUDA tensor launches the kernel
  or raises. The kernels take N = ``D_STATE`` and P a multiple of
  ``P_SLICE``.
* ``LAUNCHES_FWD`` (#7), ``LAUNCHES_DUAL`` (#8) and ``LAUNCHES_BWD`` (#9)
  count kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ssm import _heads_decay
from repro_torch.kernels import _build

LAUNCHES_FWD = 0
LAUNCHES_DUAL = 0
LAUNCHES_BWD = 0
P_SLICE = 16                      # the kernels take P in multiples of
#                                   it (#8's rows of P per block)
BWD_P_SLICE = 64                  # rows of P per #7 and #9 block (#9's
#                                   partials' unit: one slice a head at 64)
TILE_T = 16                       # #8's time tile (the dual form's Tt)
FWD_SUB_T = 64                    # #7's sub-chunk (the SSD form's Q)
BWD_SUB_T = 64                    # #9's sub-chunk (the SSD form's Q)
D_STATE = 64                      # the kernels instantiate N = 64
SCHEDULES = ("blocked_heads", "blocked_heads_dual")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_entries = {}                     # (kind, dtype) → C entry, bound at first use


def n_chunks(L: int, chunk: int) -> int:
    return -(-L // chunk)


def n_slices(P: int) -> int:
    """Slices of P the backward's partials are split into: one per
    ``BWD_P_SLICE`` rows, the last one short when it does not divide P."""
    return -(-P // BWD_P_SLICE)


def _slices(x, P: int):
    """(B, H, P, …) → (B, H, n_slices(P), BWD_P_SLICE, …), the rows past P
    zero."""
    nps = n_slices(P)
    pad = nps * BWD_P_SLICE - P
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:2] + (pad,) + x.shape[3:])],
                      dim=2)
    return x.reshape(x.shape[:2] + (nps, BWD_P_SLICE) + x.shape[3:])


# ------------------------------------------------------------------ plain

def _decay(d_t, A, pos_t):
    """a_t (B, H): exp(Δ_t·A), 0 where the position resets."""
    return torch.where((pos_t == 0)[:, None], 0.0, torch.exp(d_t * A))


def _step(h, d_t, u_t, A, B_t, pos_t):
    a = _decay(d_t, A, pos_t)
    return a[..., None, None] * h + \
        (d_t[..., None] * u_t)[..., None] * B_t[:, None, None, :]


def selective_scan_heads_fwd_plain(u, delta, A, Bm, Cm, Dp, positions,
                                   chunk: int):
    """Kernel #7's function as a per-step walk in f32: returns (y in u's
    dtype, ckpts (B, H, nC, P, N) f32)."""
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    u32, d32, B32, C32 = u.float(), delta.float(), Bm.float(), Cm.float()
    A32 = A.float()
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=u.device)
    ckpts = torch.empty((Bz, H, n_chunks(L, chunk), P, N),
                        dtype=torch.float32, device=u.device)
    y = torch.empty((Bz, L, H, P), dtype=torch.float32, device=u.device)
    for t in range(L):
        if t % chunk == 0:
            ckpts[:, :, t // chunk] = h
        h = _step(h, d32[:, t], u32[:, t], A32, B32[:, t], positions[:, t])
        y[:, t] = torch.einsum("bhpn,bn->bhp", h, C32[:, t])
    y = y + Dp.float()[:, None] * u32
    return y.to(u.dtype), ckpts


def selective_scan_heads_fwd_dual_plain(u, delta, A, Bm, Cm, Dp, positions,
                                        chunk: int, tile: int = TILE_T):
    """The chunked (dual) form of #7's and #8's function, its arithmetic
    written out: per tile of ``tile`` steps inside each chunk (#7's kernel
    at ``tile=FWD_SUB_T``, #8's at ``TILE_T``)

        G = dec ⊙ (C·Bᵀ);  y = G·(Δ·u) + cin·(C·h_in)
        h_out = Σ_j dec[last, j]·(Δ·u ⊗ B)_j + cin_last·h_in

    Returns (y, ckpts) as the per-step form does."""
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    dev = u.device
    u32, d32, B32, C32 = u.float(), delta.float(), Bm.float(), Cm.float()
    A32 = A.float()
    reset = positions == 0
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=dev)
    ckpts = torch.empty((Bz, H, n_chunks(L, chunk), P, N),
                        dtype=torch.float32, device=dev)
    y = torch.empty((Bz, L, H, P), dtype=torch.float32, device=dev)
    for ci in range(n_chunks(L, chunk)):
        ckpts[:, :, ci] = h
        for t0 in range(ci * chunk, min(L, (ci + 1) * chunk), tile):
            t1 = min(t0 + tile, L, (ci + 1) * chunk)
            n = t1 - t0
            tril = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
            dec, cin = _heads_decay(d32[:, t0:t1], A32, reset[:, t0:t1],
                                    tril)                       # (B,n,n,H)
            du = d32[:, t0:t1, :, None] * u32[:, t0:t1]          # (B,n,H,P)
            G = dec * torch.einsum("bin,bjn->bij", C32[:, t0:t1],
                                   B32[:, t0:t1])[..., None]
            y[:, t0:t1] = torch.einsum("bijh,bjhp->bihp", G, du) + \
                cin[..., None] * torch.einsum("bhpn,bin->bihp", h,
                                              C32[:, t0:t1])
            h = torch.einsum("bjh,bjhp,bjn->bhpn", dec[:, -1], du,
                             B32[:, t0:t1]) + cin[:, -1][..., None, None] * h
    y = y + Dp.float()[:, None] * u32
    return y.to(u.dtype), ckpts


def selective_scan_heads_bwd_plain(u, delta, A, Bm, Cm, Dp, positions, ckpts,
                                   dy, chunk: int, tile: int = 8):
    """Kernel #9's function, written out (not autograd) as a per-step walk:
    per chunk, in reverse, the states at each ``tile``-step entry from the
    chunk's checkpoint; per tile, in reverse, its states recomputed, then
    the reverse walk

        g_t = C_t ⊗ dy_t + a_{t+1}·g_{t+1}   (0 carried across a reset)
        du  = Δ·Σ_n g·B + D·dy              dΔ = a·A·Σ_{p,n} g·h_{t-1} + Σ_p u·Σ_n g·B
        dB_t = Σ_p g·Δ·u   dC_t = Σ_p h_t·dy   dA = Σ_t a·Δ·Σ_{p,n} g·h_{t-1}   dD = Σ dy·u

    with the sums over p split into ``n_slices(P)`` partials. Never holds
    more than one tile's states and a chunk's tile entries. The reference
    of the kernel's chunked form (``selective_scan_heads_bwd_chunked_plain``)."""
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    dev = u.device
    nps = n_slices(P)
    u32, d32, dy32 = u.float(), delta.float(), dy.float()
    B32, C32 = Bm.float(), Cm.float()
    A32, Dv = A.float(), Dp.float()
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((Bz, L, H, P), **f32)
    ddt = torch.empty((Bz, L, H, nps), **f32)
    dB = torch.empty((Bz, H, nps, L, N), **f32)
    dC = torch.empty_like(dB)
    dA = torch.zeros((Bz, H, nps), **f32)
    dD = torch.zeros((Bz, H, nps), **f32)
    gc = torch.zeros((Bz, H, P, N), **f32)

    def slices(x):                       # (B, H, P, …) → (B, H, nps, ps, …)
        return _slices(x, P)

    for ci in reversed(range(n_chunks(L, chunk))):
        tc0, tc1 = ci * chunk, min(L, (ci + 1) * chunk)
        starts = list(range(tc0, tc1, tile))
        entry = [ckpts[:, :, ci].float()]
        for t0 in starts[:-1]:
            h = entry[-1]
            for t in range(t0, t0 + tile):
                h = _step(h, d32[:, t], u32[:, t], A32, B32[:, t],
                          positions[:, t])
            entry.append(h)
        for k in reversed(range(len(starts))):
            t0, t1 = starts[k], min(starts[k] + tile, tc1)
            hs = [entry[k]]
            for t in range(t0, t1):
                hs.append(_step(hs[-1], d32[:, t], u32[:, t], A32,
                                B32[:, t], positions[:, t]))
            for t in reversed(range(t0, t1)):
                a = _decay(d32[:, t], A32, positions[:, t])      # (B, H)
                g = C32[:, t, None, None, :] * dy32[:, t, ..., None] + gc
                gB = (g * B32[:, t, None, None, :]).sum(-1)      # (B,H,P)
                da = slices(g * hs[t - t0]).sum((-1, -2))        # (B,H,nps)
                du[:, t] = d32[:, t, :, None] * gB + Dv[:, None] * dy32[:, t]
                ddt[:, t] = (a * A32)[..., None] * da + \
                    slices(u32[:, t] * gB).sum(-1)
                dut = d32[:, t, :, None] * u32[:, t]
                dB[:, :, :, t] = slices(g * dut[..., None]).sum(3)
                dC[:, :, :, t] = slices(hs[t - t0 + 1] *
                                        dy32[:, t, ..., None]).sum(3)
                dA += da * (a * d32[:, t])[..., None]
                dD += slices(dy32[:, t] * u32[:, t]).sum(-1)
                gc = a[..., None, None] * g
    return (du, ddt, dB.reshape(Bz, H * nps, L, N),
            dC.reshape(Bz, H * nps, L, N), dA, dD)


def selective_scan_heads_bwd_chunked_plain(u, delta, A, Bm, Cm, Dp,
                                           positions, ckpts, dy, chunk: int,
                                           q: int = BWD_SUB_T):
    """Kernel #9's arithmetic, the chunked (SSD) form the CUDA kernel
    evaluates, written out: per slice of ``BWD_P_SLICE`` rows of P (rows
    past P zero) and per sub-chunk of ``q`` steps inside each checkpoint
    chunk (steps past the chunk or L are identity steps: Δ, u, dy, B, C
    0, no reset), with s = cumsum Δ·A, dec, cin as ``_heads_decay`` has
    them, d_j = dec[q-1, j], X = Δ·u, h_in the sub-chunk's entry state
    and dh the gradient of its exit state:

        h_out = (d∘X)ᵀB + cin_{q-1}·h_in          (pass 1, forward)
        S = CBᵀ,  R = dY Xᵀ,  M = (dec∘S)∘R
        dX = (dec∘S)ᵀdY + diag(d)·B dhᵀ
        dC = (dec∘R)B + diag(cin)·dY h_in
        dB = (dec∘R)ᵀC + diag(d)·X dh
        dh ← dYᵀdiag(cin)C + cin_{q-1}·dh         (pass 2, in reverse)
        ds_i = Σ_j M_ij − Σ_k M_ki + cin_i⟨C_i, (dY h_in)_i⟩
               − d_i⟨B_i, (X dh)_i⟩  (+ Σ_j d_j⟨B_j, (X dh)_j⟩
               + cin_{q-1}⟨h_in, dh⟩ at i = q-1)
        dla = reverse cumsum of ds;  du = Δ·dX + D·dy
        dΔ = Σ_p u·dX + A·dla·[no reset],  dA = Σ Δ·dla·[no reset]

    Returns what ``selective_scan_heads_bwd_plain`` returns, the same
    partials."""
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    dev = u.device
    nps, R = n_slices(P), BWD_P_SLICE
    f32 = dict(dtype=torch.float32, device=dev)
    A32, Dv = A.float(), Dp.float()
    du = torch.empty((Bz, H, nps, L, R), **f32)
    ddt = torch.empty((Bz, H, nps, L), **f32)
    dB = torch.empty((Bz, H, nps, L, N), **f32)
    dC = torch.empty_like(dB)
    dA = torch.zeros((Bz, H, nps), **f32)
    dD = torch.zeros((Bz, H, nps), **f32)
    dh = torch.zeros((Bz, H, nps, R, N), **f32)
    tril = torch.ones((q, q), dtype=torch.bool, device=dev).tril()

    def rows(x, t0, t1):        # (B, L, H, P) → (B, H, nps, q, R), padded
        x = _slices(x[:, t0:t1].float().permute(0, 2, 3, 1), P)
        return torch.nn.functional.pad(x, (0, q - (t1 - t0))).transpose(-1,
                                                                         -2)

    def sub(t0, t1):
        """The sub-chunk [t0, t1) padded to q identity steps."""
        n = t1 - t0
        pad = (0, q - n)
        d = torch.nn.functional.pad(delta[:, t0:t1].float().transpose(1, 2),
                                    pad)                         # (B, H, q)
        rc = torch.nn.functional.pad(positions[:, t0:t1] == 0, pad)
        Bs, Cs = (torch.nn.functional.pad(m[:, t0:t1].float(),
                                          (0, 0, 0, q - n))
                  for m in (Bm, Cm))                             # (B, q, N)
        dec, cin = _heads_decay(d.transpose(1, 2), A32, rc, tril)
        dec = dec.permute(0, 3, 1, 2)                            # (B,H,q,q)
        cin = cin.transpose(1, 2)                                # (B, H, q)
        U = rows(u, t0, t1)
        X = d[:, :, None, :, None] * U
        return n, d, rc, Bs, Cs, dec, cin, dec[..., -1, :], U, X

    for ci in reversed(range(n_chunks(L, chunk))):
        tc0, tc1 = ci * chunk, min(L, (ci + 1) * chunk)
        starts = list(range(tc0, tc1, q))
        entry = [_slices(ckpts[:, :, ci].float(), P)]            # pass 1
        for t0 in starts[:-1]:
            _, _, _, Bs, _, _, cin, d, _, X = sub(t0, t0 + q)
            entry.append(torch.einsum("bhsjr,bjn->bhsrn",
                                      d[:, :, None, :, None] * X, Bs) +
                         cin[..., -1, None, None, None] * entry[-1])
        for k in reversed(range(len(starts))):                   # pass 2
            t0 = starts[k]
            t1 = min(t0 + q, tc1)
            n, dl, rc, Bs, Cs, dec, cin, d, U, X = sub(t0, t1)
            hin, DY = entry[k], rows(dy, t0, t1)
            Sd = dec * torch.einsum("bin,bjn->bij", Cs, Bs)[:, None]
            Rm = torch.einsum("bhsir,bhsjr->bhsij", DY, X)
            Rd = dec[:, :, None] * Rm
            M = Sd[:, :, None] * Rm
            G1 = torch.einsum("bhsir,bhsrn->bhsin", DY, hin)
            G2 = torch.einsum("bhsir,bhsrn->bhsin", X, dh)
            dX = torch.einsum("bhij,bhsir->bhsjr", Sd, DY) + \
                d[:, :, None, :, None] * torch.einsum("bjn,bhsrn->bhsjr",
                                                      Bs, dh)
            cin3, d3 = cin[:, :, None], d[:, :, None]
            dCk = torch.einsum("bhsij,bjn->bhsin", Rd, Bs) + \
                cin3[..., None] * G1
            dBk = torch.einsum("bhsij,bin->bhsjn", Rd, Cs) + \
                d3[..., None] * G2
            f = (Cs[:, None, None] * G1).sum(-1)                 # (B,H,S,q)
            e = (Bs[:, None, None] * G2).sum(-1)
            ds = M.sum(-1) - M.sum(-2) + cin3 * f - d3 * e
            ds[..., -1] += (d3 * e).sum(-1) + \
                cin3[..., -1] * (hin * dh).sum((-1, -2))
            dla = ds.flip(-1).cumsum(-1).flip(-1)
            keep = (~rc)[:, None, None].float()                  # (B,1,1,q)
            dl3 = dl[:, :, None]
            dh = torch.einsum("bhsir,bhi,bin->bhsrn", DY, cin, Cs) + \
                cin3[..., -1, None, None] * dh
            du[:, :, :, t0:t1] = (dl3[..., None] * dX + Dv[:, None, None,
                                                           None] * DY)[
                :, :, :, :n]
            ddt[:, :, :, t0:t1] = ((U * dX).sum(-1) + A32[:, None, None] *
                                   keep * dla)[..., :n]
            dB[:, :, :, t0:t1] = dBk[:, :, :, :n]
            dC[:, :, :, t0:t1] = dCk[:, :, :, :n]
            dA += (keep * dl3 * dla).sum(-1)
            dD += (DY * U).sum((-1, -2))
    du = du.permute(0, 3, 1, 2, 4).reshape(Bz, L, H, nps * R)[..., :P]
    return (du.contiguous(), ddt.permute(0, 3, 1, 2).contiguous(),
            dB.reshape(Bz, H * nps, L, N), dC.reshape(Bz, H * nps, L, N),
            dA, dD)


# ------------------------------------------------------------------ kernels

_LIBS = {"fwd": "selective_scan_heads_fwd", "dual": "selective_scan_heads",
         "bwd": "selective_scan_heads_bwd"}     # kind → csrc/<name>.cu


def _entry(kind, dtype):
    """The C entry ``selective_scan_heads_<kind>_<dtype>`` of
    ``csrc/<_LIBS[kind]>.cu``, its ctypes signature declared."""
    fn = _entries.get((kind, dtype))
    if fn is None:
        fn = getattr(_build.load(_LIBS[kind]),
                     f"selective_scan_heads_{kind}_{_DTYPES[dtype]}")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        head = [vp, vp, vp, vp, vp, i64, i64, vp, vp, i64]
        fn.argtypes = head + ([vp, vp, i32, i32, i32, i32, i32, vp]
                              if kind != "bwd" else
                              [vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32,
                               i32, i32, i32, vp])
        fn.restype = i32
        _entries[(kind, dtype)] = fn
    return fn


def fwd_resources(dtype) -> dict:
    """Kernel #7's resources on the current CUDA device for ``dtype``
    input: blocks an SM, registers and local (spill) bytes a thread,
    dynamic shared bytes a block."""
    out = (ctypes.c_int * 4)()
    err = _build.load(_LIBS["fwd"]).selective_scan_heads_fwd_occupancy(
        int(dtype == torch.bfloat16), out)
    if err != 0:
        raise RuntimeError(f"selective_scan_heads_fwd_occupancy failed: "
                           f"cudaError {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "shared_bytes"), out))


def _aligned(u, Bm, Cm, *more):
    """The operands the chunked kernels copy 16 bytes at a time (u, and
    ``more``: whole rows; B and C: rows through their strides), copied
    where an address or a stride is no multiple of 16 bytes."""
    if any(t.data_ptr() % 16 for t in (u, *more)):
        u, more = u.clone(), tuple(t.clone() for t in more)
    es = Bm.element_size()
    if any(x % 16 for x in (Bm.data_ptr(), Cm.data_ptr(), Bm.stride(0) * es,
                            Bm.stride(1) * es)):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    return u, Bm, Cm, more


def _check(u, delta, A, Bm, Cm, Dp, positions, chunk):
    if u.dim() != 4:
        raise ValueError(f"u must be (B, L, H, P), got shape "
                         f"{tuple(u.shape)}")
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    if u.dtype not in _DTYPES:
        raise TypeError(f"u dtype {u.dtype} not supported (f32 or bf16)")
    if delta.dtype != u.dtype or Bm.dtype != u.dtype or Cm.dtype != u.dtype:
        raise TypeError(f"delta {delta.dtype}, B {Bm.dtype} and C "
                        f"{Cm.dtype} must have u's dtype {u.dtype}")
    if A.dtype != torch.float32 or Dp.dtype != torch.float32:
        raise TypeError(f"A {A.dtype} and Dp {Dp.dtype} must be float32")
    if tuple(delta.shape) != (Bz, L, H) or tuple(A.shape) != (H,) or \
            tuple(Bm.shape) != (Bz, L, N) or tuple(Cm.shape) != (Bz, L, N) \
            or tuple(Dp.shape) != (H,):
        raise ValueError(
            f"shapes u {tuple(u.shape)}, delta {tuple(delta.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
            f"Dp {tuple(Dp.shape)} do not agree")
    if tuple(positions.shape) != (Bz, L) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 ({Bz}, {L}), got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    devs = {t.device for t in (u, delta, A, Bm, Cm, Dp, positions)}
    if len(devs) != 1:
        raise ValueError(f"selective_scan_heads operands on several "
                         f"devices: {devs}")


def _check_cuda(u, delta, A, Bm, Cm, Dp, positions):
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan_heads runs on cuda or cpu, not "
                         f"{u.device}")
    if u.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {u.device}, the current CUDA "
                         f"device is cuda:{torch.cuda.current_device()}")
    P, N = u.shape[3], Bm.shape[-1]
    if N != D_STATE or P % P_SLICE:
        raise ValueError(f"the kernels take d_state {D_STATE} and a head "
                         f"dim that is a multiple of {P_SLICE}, got N={N}, "
                         f"P={P}")
    if not (u.is_contiguous() and delta.is_contiguous() and
            A.is_contiguous() and Dp.is_contiguous()):
        raise ValueError("u, delta, A and Dp must be contiguous")
    if Bm.stride(2) != 1 or Bm.stride() != Cm.stride():
        raise ValueError(f"B and C need unit stride along N and equal "
                         f"strides, got {Bm.stride()} and {Cm.stride()}")
    if positions.stride(1) != 1:
        raise ValueError(f"positions needs contiguous rows, got strides "
                         f"{positions.stride()}")


def _head(u, delta, A, Bm, Cm, Dp, positions):
    return (u.data_ptr(), delta.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Bm.stride(0), Bm.stride(1), Dp.data_ptr(),
            positions.data_ptr(), positions.stride(0))


def selective_scan_heads_fwd(u, delta, A, Bm, Cm, Dp, positions, chunk: int,
                             schedule: str = "blocked_heads"):
    """See the module docstring. ``schedule`` picks kernel #7
    (``blocked_heads``, the chunked form on the tensor cores) or #8
    (``blocked_heads_dual``, the dual form per 16-step tile). Returns (y,
    ckpts)."""
    global LAUNCHES_FWD, LAUNCHES_DUAL
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown heads schedule {schedule!r}; have "
                         f"{SCHEDULES}")
    _check(u, delta, A, Bm, Cm, Dp, positions, chunk)
    dual = schedule == "blocked_heads_dual"
    if u.device.type == "cpu":
        plain = selective_scan_heads_fwd_dual_plain if dual else \
            selective_scan_heads_fwd_plain
        return plain(u, delta, A, Bm, Cm, Dp, positions, chunk)
    _check_cuda(u, delta, A, Bm, Cm, Dp, positions)
    Bz, L, H, P = u.shape
    y = torch.empty_like(u)
    ckpts = torch.empty((Bz, H, n_chunks(L, chunk), P, D_STATE),
                        dtype=torch.float32, device=u.device)
    if y.numel() == 0:
        return y, ckpts
    if not dual:
        u, Bm, Cm, _ = _aligned(u, Bm, Cm)
    err = _entry("dual" if dual else "fwd", u.dtype)(
        *_head(u, delta, A, Bm, Cm, Dp, positions), y.data_ptr(),
        ckpts.data_ptr(), Bz, L, H, P, chunk,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_heads forward kernel launch "
                           f"failed: cudaError {err}")
    if dual:
        LAUNCHES_DUAL += 1
    else:
        LAUNCHES_FWD += 1
    return y, ckpts


def selective_scan_heads_bwd(u, delta, A, Bm, Cm, Dp, positions, ckpts, dy,
                             chunk: int):
    """Kernel #9, the backward of both forward schedules. See the module
    docstring. Returns (du, ddelta_partial, dB_partial, dC_partial,
    dA_partial, dD_partial)."""
    global LAUNCHES_BWD
    _check(u, delta, A, Bm, Cm, Dp, positions, chunk)
    Bz, L, H, P = u.shape
    N = Bm.shape[-1]
    want = (Bz, H, n_chunks(L, chunk), P, N)
    if tuple(ckpts.shape) != want or ckpts.dtype != torch.float32:
        raise ValueError(f"ckpts must be float32 {want}, got {ckpts.dtype} "
                         f"{tuple(ckpts.shape)}")
    if tuple(dy.shape) != (Bz, L, H, P) or dy.dtype != u.dtype:
        raise ValueError(f"dy must be {u.dtype} {(Bz, L, H, P)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if u.device.type == "cpu":
        return selective_scan_heads_bwd_plain(u, delta, A, Bm, Cm, Dp,
                                              positions, ckpts, dy, chunk)
    _check_cuda(u, delta, A, Bm, Cm, Dp, positions)
    if not (ckpts.is_contiguous() and dy.is_contiguous()):
        raise ValueError("ckpts and dy must be contiguous")
    u, Bm, Cm, (dy,) = _aligned(u, Bm, Cm, dy)
    nps = n_slices(P)
    f32 = dict(dtype=torch.float32, device=u.device)
    du = torch.empty((Bz, L, H, P), **f32)
    ddt = torch.empty((Bz, L, H, nps), **f32)
    dB = torch.empty((Bz, H * nps, L, N), **f32)
    dC = torch.empty((Bz, H * nps, L, N), **f32)
    dA = torch.empty((Bz, H, nps), **f32)
    dD = torch.empty((Bz, H, nps), **f32)
    if du.numel() == 0:
        return du, ddt, dB, dC, dA.zero_(), dD.zero_()
    # the entry states of the sub-chunks of the chunk each block is in
    hsub = torch.empty((Bz * H * nps, -(-min(chunk, L) // BWD_SUB_T),
                        BWD_P_SLICE * N), **f32)
    err = _entry("bwd", u.dtype)(
        *_head(u, delta, A, Bm, Cm, Dp, positions), ckpts.data_ptr(),
        dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), hsub.data_ptr(), Bz, L,
        H, P, chunk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_heads backward kernel launch "
                           f"failed: cudaError {err}")
    LAUNCHES_BWD += 1
    return du, ddt, dB, dC, dA, dD
