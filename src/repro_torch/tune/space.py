"""The tunable space of each scan operator, and shape-key bucketing (port of
``repro.tune.space``).

The winning schedule of a scan flips with (L, D, N, H, dh), dtype and
device, so each choice the port would otherwise fix by hand is a
*candidate list* the runner measures. A candidate is a JSON-able dict of
knobs, in the JAX package's vocabulary, so a cache entry means the same in
both packages:

  backend   "xla" (the plain scans of ``core/ssm.py``) | "pallas" (the
            port's kernels, through ``kernels/ops.py``)
  method    plain scan schedule ("blocked" | "chunked" | "fused_seq" |
            "sequential" | "associative")
  chunk     plain chunk length T
  intra     blocked in-chunk evaluator — per-channel op: "matmul" | "assoc";
            heads op: "quad" (state form) | "dual" (C·Bᵀ form)
  schedule  kernel schedule ("step" | "blocked" | "blocked_heads" |
            "blocked_heads_dual")
  pchunk    the kernels' checkpoint chunk

The plain candidates are the JAX package's list, dict for dict. The kernel
candidates are the port's own: each is one the kernels' argument checks
accept at that key, and none is listed where the kernels take no such
shape (Mamba-1: N = 16; heads: N = 64 and dh a multiple of 16; f32 or
bf16). Mamba-1: ``step`` at chunk 64 only (#3/#5 take exactly their time
tile), ``blocked`` (#4/#6) at 64, 128 and 256. Heads: ``blocked_heads``
(#7) and ``blocked_heads_dual`` (#8), both with #9 behind them, at 128
and 256. The chunks are clipped to L as the JAX list clips them. The JAX
knob ``sub_t`` (a Pallas in-chunk subtile) has no counterpart: the port's
kernels have fixed tiles.

Shape keys bucket the continuous axes so one measurement serves a
neighbourhood: L to the next power of two, reset density to four named
bands. B, D, N, H, dh and dtype are kept exact; the nearest-key fallback
in ``cache.py`` absorbs the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

OPS = ("selective_scan", "selective_scan_heads")

# what a sweep measures: "fwd" times the forward only (serving); "fwdbwd"
# times forward + backward of a scalar loss (a training step). Winners are
# tagged with their objective and never served across objectives.
OBJECTIVES = ("fwd", "fwdbwd")

# reset-density bands: resets per token. "none" is the unpacked case;
# packed training at the paper's segment lengths lands in "mid".
RESET_BANDS = (("none", 0.0), ("sparse", 1 / 256), ("mid", 1 / 32),
               ("dense", 1.0))

# a key's dtype by name: torch dtypes and their names map to the JAX
# package's names (numpy has no bfloat16, so ``np.dtype`` cannot name it)
_DTYPE_NAMES = {"float32": "float32", "bfloat16": "bfloat16",
                "float16": "float16"}


def l_bucket(L: int) -> int:
    """Next power of two ≥ L (floor 16) — the sequence-length bucket."""
    L = max(int(L), 16)
    return 1 << (L - 1).bit_length()


def reset_bucket(density: Optional[float]) -> str:
    """Map a resets-per-token density to its named band.

    ``None`` means "packed, density unknown" → "mid" (the typical training
    regime); pass 0.0 explicitly for reset-free inputs.
    """
    if density is None:
        return "mid"
    for name, hi in RESET_BANDS:
        if density <= hi:
            return name
    return "dense"


def dtype_name(dtype) -> str:
    """``torch.bfloat16``, ``"bfloat16"`` and ``"torch.bfloat16"`` all name
    "bfloat16" (likewise float32 and float16); a numpy dtype names itself;
    None is "float32"."""
    if dtype is None:
        return "float32"
    name = str(dtype).replace("torch.", "")
    if name in _DTYPE_NAMES:
        return _DTYPE_NAMES[name]
    import numpy as np
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class ShapeKey:
    """Bucketed shape identity of one operator invocation."""
    op: str
    dtype: str
    B: int
    Lb: int          # l_bucket(L)
    D: int           # per-channel width (0 for the heads op)
    N: int           # state size
    H: int           # heads (0 for the per-channel op)
    dh: int          # head dim (0 for the per-channel op)
    resets: str      # reset-density band
    objective: str = "fwd"   # "fwd" | "fwdbwd" — what the sweep timed

    def encode(self) -> str:
        base = (f"{self.op}|{self.dtype}|B{self.B}|L{self.Lb}|D{self.D}|"
                f"N{self.N}|H{self.H}|dh{self.dh}|{self.resets}")
        # a 10th field only for a non-default objective: fwd keys keep the
        # JAX package's 9-field strings
        return base if self.objective == "fwd" else \
            base + f"|{self.objective}"

    @classmethod
    def decode(cls, s: str) -> "ShapeKey":
        parts = s.split("|")
        if len(parts) == 9:
            parts = parts + ["fwd"]
        op, dtype, B, Lb, D, N, H, dh, resets, objective = parts
        return cls(op, dtype, int(B[1:]), int(Lb[1:]), int(D[1:]),
                   int(N[1:]), int(H[1:]), int(dh[2:]), resets, objective)


def shape_key(op: str, *, dtype="float32", B: int, L: int, D: int = 0,
              N: int = 0, H: int = 0, dh: int = 0,
              reset_density: Optional[float] = None,
              objective: str = "fwd") -> ShapeKey:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; have {OPS}")
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; have {OBJECTIVES}")
    return ShapeKey(op, dtype_name(dtype), int(B), l_bucket(L), int(D),
                    int(N), int(H), int(dh), reset_bucket(reset_density),
                    objective)


# ---------------------------------------------------------------------------
# candidate spaces
# ---------------------------------------------------------------------------

def _xla(method, chunk=None, intra=None) -> Dict:
    c = {"backend": "xla", "method": method}
    if chunk is not None:
        c["chunk"] = int(chunk)
    if intra is not None:
        c["intra"] = intra
    return c


def _kernel(schedule, pchunk) -> Dict:
    return {"backend": "pallas", "schedule": schedule, "pchunk": int(pchunk)}


def kernel_candidates(key: ShapeKey) -> List[Dict]:
    """The port's kernel candidates at ``key`` (module docstring); [] where
    the kernels take no such shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as scan_k
    from repro_torch.kernels import selective_scan_heads as heads_k
    if key.dtype not in ("float32", "bfloat16"):
        return []
    L = key.Lb
    if key.op == "selective_scan_heads":
        if key.N != heads_k.D_STATE or key.dh % heads_k.P_SLICE:
            return []
        return [_kernel(sched, min(pchunk, L))
                for sched in heads_k.SCHEDULES for pchunk in (128, 256)]
    if key.N != scan_k.D_STATE:
        return []
    return [_kernel("step", scan_k.STEP_TILE_T)] + \
        [_kernel("blocked", min(pchunk, L))
         for pchunk in (ops.SCAN_CHUNK, 128, 256)]


def space_for(key: ShapeKey, include_pallas: bool = False) -> List[Dict]:
    """Bounded candidate list for one shape key.

    ``include_pallas`` adds the kernel candidates: True only where their
    times mean something (operands on the card) — the runner decides.
    """
    L = key.Lb
    out: List[Dict] = []
    if key.op == "selective_scan_heads":
        # the heads chunk and the quad-vs-dual in-chunk evaluator; chunks
        # stop at each form's cap (core/ssm.py _HEADS_CHUNK_CAP /
        # _HEADS_DUAL_CHUNK_CAP): a larger one would clamp silently and
        # mislabel the cached winner
        for chunk in (16, 32, 64, 128):
            if chunk > max(16, 2 * L):
                continue
            if chunk <= 64:
                out.append(_xla("blocked", chunk, "quad"))
            out.append(_xla("blocked", chunk, "dual"))
        if L <= 128:
            out.append(_xla("sequential"))
    else:
        # per-channel: the matmul-intra chunks (cap 32) against the
        # assoc-tree chunks, plus the whole-trajectory schedules
        for chunk in (8, 16, 32):
            out.append(_xla("blocked", chunk, "matmul"))
        for chunk in (64, 128, 256):
            out.append(_xla("blocked", min(chunk, L), "assoc"))
        out.append(_xla("chunked", min(256, L)))
        out.append(_xla("fused_seq"))
        if L <= 1024:      # materializes (B, L, D, N): only viable when small
            out.append(_xla("associative"))
    if include_pallas:
        out += kernel_candidates(key)
    # dedup (chunk clamping can collide candidates at small L)
    seen, uniq = set(), []
    for c in out:
        k = tuple(sorted(c.items()))
        if k not in seen:
            seen.add(k)
            uniq.append(c)
    return uniq


def candidate_name(c: Dict) -> str:
    if c.get("backend") == "pallas":
        st = c.get("sub_t")
        return f"pallas/{c['schedule']}/T{c['pchunk']}" + \
            (f"/t{st}" if st else "")
    parts = [c["method"]]
    if "chunk" in c:
        parts.append(f"T{c['chunk']}")
    if c.get("intra"):
        parts.append(c["intra"])
    return "xla/" + "/".join(parts)
