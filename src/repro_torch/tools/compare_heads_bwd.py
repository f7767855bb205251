"""Hold the Mamba-2 scan backward (#9) of this checkout against #9 of
another checkout, bitwise: one call each on the same inputs, each package
built from its own sources, in a process of its own.

    PYTHONPATH=src python3 -m repro_torch.tools.compare_heads_bwd OTHER_SRC

``OTHER_SRC`` is the ``src`` directory of the other checkout, for example
an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. The inputs are made on the card from a seed at
mamba2-370m's training shape in bf16: u, Δ, dy, B and C (views of one
projection), packed positions with a carried row, and random f32
checkpoints, so that #9 alone is compared, whatever the forward. Prints
one JSON object and exits 1 unless every output is equal.

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SHAPE, CHUNK, SEED = (8, 4096, 32, 64), 256, 7
NAMES = ("du", "ddelta", "dB", "dC", "dA", "dD")
SRC = Path(__file__).resolve().parents[2]


def run(out_path):
    """#9's outputs on the fixed inputs, saved to ``out_path``, from the
    ``repro_torch`` that is first on the path."""
    import torch
    from repro_torch.kernels import selective_scan_heads as kh
    B, L, H, P = SHAPE
    N = kh.D_STATE
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    u, dy = (torch.randn(SHAPE, generator=g, device="cuda").to(bf)
             for _ in range(2))
    dt = torch.rand((B, L, H), generator=g, device="cuda").mul(0.1).add(
        1e-3).to(bf)
    Bm, Cm = torch.randn((B, L, 2 * N), generator=g, device="cuda").to(
        bf).chunk(2, dim=-1)
    A = -(torch.rand(H, generator=g, device="cuda") * 15.0 + 1.0)
    Dp = torch.ones(H, device="cuda")
    t = torch.arange(L, device="cuda")
    pos = (t % 397).to(torch.int32).expand(B, L).contiguous()
    pos[1] = t + 5                                  # a carried row
    ck = torch.randn((B, H, -(-L // CHUNK), P, N), generator=g,
                     device="cuda")
    outs = kh.selective_scan_heads_bwd(u, dt, A, Bm, Cm, Dp, pos, ck, dy,
                                       CHUNK)
    torch.save([o.cpu() for o in outs], out_path)


def main(argv):
    if len(argv) == 2 and argv[0] == "--run":
        run(argv[1])
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compare_heads_bwd: no CUDA device", file=sys.stderr)
        return 1
    out = SRC.parent / "build" / "compare_heads_bwd"
    out.mkdir(parents=True, exist_ok=True)
    got = {}
    for name, src in (("this", SRC), ("other", Path(argv[0]).resolve())):
        path = out / f"{name}.pt"
        subprocess.run([sys.executable, __file__, "--run", str(path)],
                       env=dict(os.environ, PYTHONPATH=str(src)), check=True)
        got[name] = torch.load(path)
    equal = {n: torch.equal(a, b)
             for n, a, b in zip(NAMES, got["this"], got["other"])}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "shape": list(SHAPE), "chunk": CHUNK,
                      "dtype": "bfloat16", "other": argv[0],
                      "bitwise_equal": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
