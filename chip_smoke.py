#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device   — the card's name and its peaks (``roofline.analysis.peaks_for``:
              an unknown card fails here, before any bound is read);
              ``nvidia-smi``'s name and power limit on a line of their
              own. No CUDA device: exit 1, no result.
2. build    — every CUDA source in ``src/repro_torch/csrc`` with ``nvcc``
              (one process per source, started together).
3. kernels  — each kernel against its plain PyTorch version at the main
              paths' shapes, in bf16 and f32, timed beside the plain
              version, the library yardstick (where one PyTorch call
              computes the same function) and the least time the card could
              take: #1 conv1d_pack forward (the serving buckets) and #2
              its dx backward, both at the three models' training shapes
              and one element a thread at (2, 997, 4100), twice and
              bitwise equal (their run lengths, blocks, registers and
              spills in their ``kernels`` entries' ``resources``);
              the Mamba-1 selective scan's two schedules, #4 / #6 (blocked;
              #4 is #3's kernel with any chunk, also run at chunks 128
              and 48; #6 chunk-parallel: carry, combine and chunk kernels; the
              build knobs and resources of both in their ``kernels``
              entries) and #3 / #5 (step) forward / backward (each 8 steps
              a lane, its registers, warps an SM and waves in its rows' and
              its entry's ``resources``), at the mamba-1.4b and
              mamba-2.8b training shapes and a ragged one, timed in the same
              call and checked against each other (#3's checkpoints against
              #4's, #5 against #6); #7 / #8 / #9 the head-structured
              (Mamba-2) scan forward (the chunked form on the tensor
              cores), its dual form and their backward. The scan kernels
              and #7 run twice and must agree bitwise.
4. parity   — serving: ``prefill_packed`` end logits and states of 4
              prompts against per-prompt ``prefill`` (f32, full width).
5. engine   — the serving main path: the continuous-batching engine on
              mamba-1.4b (48 layers, bf16, seed 0), 12 greedy requests ×
              16 new tokens; every launch counter set to 0 just before and
              read just after (only the conv forward may run, once per
              layer that has a conv (``conv_layers``) and forward).
6. train_parity — mamba-1.4b at full width, 2 layers, f32 with TF32 off:
              the loss and every parameter's gradient through the kernels
              against autograd through the plain ``core/`` conv and scan.
6b. train_parity_mamba2 — the same for mamba2-370m (2 layers), once with
              the heads scan's ``blocked_heads`` schedule (#7 then #9) and
              once with ``blocked_heads_dual`` (#8 then #9).
7. train    — the training main path: mamba-1.4b at full width and depth,
              bf16 compute, f32 params, random weights from seed 0,
              ``Trainer`` + ``PackingLoader`` (pack, 2 × 4096, paper
              lengths from seed 0): 1 warm-up step, then 4 timed steps with
              every launch counter set to 0 just before and read just after
              (exact counts per step asserted); one more pack step under
              ``torch.profiler`` (device time by kernel, the device's busy
              share; it must name #6's three kernels 3 × 48 times); then 2
              steps in ``pad`` mode for the paper's comparison. Every
              profiled step runs with the launch counters too, which must
              repeat the timed steps' counts, and its trace must name each
              counted kernel as often as it launched: a trace that lost a
              device record is set aside and the step traced again (at
              most 3 traces). Then one more pack step counted by the
              port's step counter (``repro_torch.roofline.counter``: FLOPs
              by unit, bytes, the kernel tally) with the launch counters
              set to 0 just before and read just after; phase 10b holds it
              to the meta dry run. Every training path below does the same.
8. Mamba-2 — serving parity and the engine on mamba2-370m (48 layers,
              bf16), then its training main path: 48 layers, 8 × 4096
              packed (``train_mamba2``), launch counts asserted exactly,
              one profiled step (which must name #7 and #9, 96 and 48
              calls), 2 ``pad`` steps.
9. step     — mamba-2.8b with ``pallas_schedule="step"``: full-width parity
              (2 layers, f32, TF32 off; #1, #2, #3, #5 against autograd
              through the plain path), then its training main path
              (``train_step``): 64 layers, d_model 2560, 2 × 4096 packed,
              bf16, 1 warm-up and 4 timed steps with exact launch counts per
              step (#1 128, #2 64, #3 128, #5 64, #4 and #6 0) and one
              profiled step, which must name #3 and #5 128 and 64 times;
              pack only.
10. tune    — the scan autotuner (``repro_torch.tune``) into a cache file in
              a temporary directory: the sweep of mamba-1.4b's layer shape
              (2, 4096, d_inner 4096, N 16, bf16, packed, forward +
              backward) and of mamba2-370m's (8, 4096, 32 heads of 64, N
              64, bf16, forward), every candidate's µs (the probe µs of
              those pruned) and the winner; each kernel candidate must be
              measured. Then ``train`` again with ``scan_tune=<that
              cache>`` (exact launch counts of the winner's kernels,
              nothing else; the host µs of the scans' tune resolution and
              the lookups its memo missed), and the mamba-1.4b engine
              with ``scan_tune`` on (it sweeps its three prefill buckets),
              beside the untuned numbers of this run.
10b. roofline — the port's roofline (``repro_torch.roofline``) of the
              training paths above, from what they measured (no training
              again): the card's name, power limit and peaks; for
              mamba-1.4b on ``blocked`` and on the tuned winner,
              mamba-2.8b on ``step`` and mamba2-370m, the meta dry run of
              the same cell (``launch/dryrun.py``'s ``count_step``, with
              the tuning winner's knobs on the tuned path), whose FLOPs by unit
              and bytes must equal the counted card step's and whose kernel
              tally must equal the launch counters' per-step counts; model
              FLOPs, MFU (model FLOPs over ms/step × the bf16 peak),
              ``t_compute``, ``t_memory``, the bound, ms/step over it, and
              the dry run's temp + argument bytes beside
              ``max_memory_allocated``. Meanwhile ``python -m
              repro_torch.launch.dryrun --arch <the paper's four
              configs>`` over the four shapes into a temporary directory
              (a subprocess that sees no card) and ``report.baseline`` /
              ``report.kernel`` of its records.
11. checkpoint — kill and resume on the card: mamba-1.4b at full width
              (d_model 2048, d_inner 4096, N 16, vocab 50280) with 4 layers,
              bf16 compute, f32 params, random weights from seed 0,
              ``PackingLoader`` pack 2 × 4096 at seed 0, ``Obs.on()``. Run A
              takes 6 steps straight. Run B saves every 2 steps (keep 2)
              and its loader sends this process SIGTERM as step 3's batch
              is fetched: the trainer's handler sets its flag and the
              trainer makes its blocking emergency save at step 4 and
              stops (the process's SIGTERM/SIGINT handlers are put back
              after). Step 4 was just saved periodically, so the
              emergency save waits for that write and marks its manifest:
              two snapshots, one mark, and no longer than that write
              plus 0.5 s. Run C, a fresh trainer on the same directory,
              restores step 4 (parameters, m, v and step bitwise those at
              the emergency save) and takes steps 4 and 5, whose losses
              must equal run A's bitwise. The trace of the three runs
              passes ``obs.check`` with ``train.step``/``train.data`` and
              the ``ckpt.*`` spans required and ``train.steps`` = 12. Printed beside the card's
              name and power limit: the checkpoint's bytes, the snapshot
              ms (the loop's device → host stall), the async write, the
              emergency save and the restore seconds, each run's ms/step.
              ``python -m repro_torch.launch.train --tiny --steps 3
              --ckpt-dir D --ckpt-every 1 --obs-trace T --profile-dir P``
              as a subprocess on the card (``phase_launchers``, after
              phase 14, beside phase 12's two serve launcher runs): it
              must exit 0, D must hold steps 1–3, T pass ``obs.check``
              and P hold a trace naming a ``conv1d_pack`` kernel.

12. serve   — the serving engine's scheduler v2 on the card: #1 at the
              chunk lane's slab (1, 3 + 256, 4096) bf16 (the carried conv
              tail at three leading zero positions) against its plain
              version, twice bitwise, timed; an f32 copy of mamba-1.4b
              (48 layers) prefills one 700-token prompt whole and in
              256-token slabs (``prefill_chunk``: end logits and states
              within ``PARITY_TOL``), and of mamba2-370m the same; then
              the engine on mamba-1.4b (48 layers, bf16, seed 0), 24
              slots: 12 greedy and 4 sampled (T 0.8, top-k 40, top-p 0.95)
              prompts of 16–200 tokens and one of 1500 (6 chunk rounds),
              16 new tokens each, the TTFT bucket policy; overlap on (two
              prefills in flight on a side stream) and off, every launch
              counter set to 0 just before each and read just after (#1
              exactly n_layers × (prefills + chunk rounds), nothing else),
              the two runs' streams bitwise equal, every sampled stream
              equal to its replay through the model's calls; the padded
              wave (``decode_batch``) against the continuous engine on 8
              prompts; one profiled decode step (greedy, sampled), one
              profiled prefill round, an overlapped run's first steps
              profiled (each stream's kernels, the time two streams ran
              at once). ``python -m repro_torch.launch.serve --tiny
              --temperature 0.8 --top-k 40 --buckets 16,32 --obs-trace T
              --profile-dir P`` as a subprocess (after phase 14, beside
              the training launcher's run): exit 0 with chunk rounds,
              T passes ``obs.check`` with the serve spans, P names a
              ``conv1d_pack`` kernel; with ``--guard --deadline-ms 60000
              --max-queue 64`` its lifecycle counters must read 0.
13. lifecycle — phase 12's engine and mix (mamba-1.4b, 48 layers, bf16, 24
              slots, overlap on, two prefills in flight): the guard off,
              on, on, off with an empty ``FaultPlan`` (streams bitwise
              equal, decode ms/step of each) and one greedy decode step
              profiled with the guard off, on, on, off (device busy ms,
              kernels); a plan that poisons one
              decode slot, one prefill segment and one chunk row and fails
              one prefill (those requests fail, every other stream is the
              clean run's bitwise, #1 launched exactly n_layers × the
              forwards that ran); a kill before decode step 6 with a
              blocking snapshot every 4 steps, then a fresh engine restoring
              the last one (the long prompt mid-chunk) finishes every
              stream, sampled too, bitwise as the clean run (the snapshot's
              bytes and ms and the restore's ms beside the card's name and
              power limit); a cancel of a request whose prefill is in flight
              on the side stream (its slot comes back free).
14. prefix_cache / spec_decode — the O(1)-state exploits on phase 12's
              engine (mamba-1.4b, 48 layers, bf16, 24 slots, overlap on):
              16 greedy requests share a declared 1024-token system prompt
              (16–200 token suffixes, 16 new tokens), cold (no cache), warm
              (an empty ``StateCache``: the first request stores the prefix,
              the rest restore it and prefill their suffix) and a rerun on
              the warm cache (whole-prompt hits, no forward); every launch
              counter around each run: the three runs' streams bitwise
              equal, the rerun 0 prefills, 0 chunk rounds and 0 #1
              launches, the warm run #1 48 × its chunk rounds; then, on 4
              of the requests, a budget of 4 entries (evictions),
              ``poison_cache_hit=[1]`` (one quarantined) and
              ``drop_cache``, with streams bitwise the cold ones; TTFT,
              tok/s, chunk tokens, the ``cache.*``
              counters, an entry's bytes, an insert's and a hit's ms.
              Speculative decode: phase 12's greedy prompts and 4 of a
              repeated block, ``spec_k`` 4 against off (streams bitwise
              equal; accept rate, verify rounds, tok/s, ITL, peak memory),
              a verify round beside a plain step, timed and profiled. #1
              at the suffix rounds' slab widths (1, 3 + 64 and 3 + 128,
              4096). On mamba2-370m (after its chunk parity), 4 requests
              cold, warm and rerun. The serve launcher (phase 12) also runs
              ``--cache-mb 64 --shared-prefix 20 --spec-k 3``.
15. xlstm   — xlstm-125m (12 layers: 5 mLSTM + 1 sLSTM, twice; d_model
              768, 4 heads, vocab 50304) at full width and depth, bf16,
              random weights from seed 0: #1 at its packed prefill's (2,
              256, 1536) and its chunk slab's (1, 259, 1536) against the
              plain version, twice bitwise, timed (``kernels`` lines);
              packed against per-prompt prefill in f32 (every state leaf,
              5e-4); phase 5's engine with one 1500-token prompt through
              the chunk lane (#1 exactly 10 mLSTM layers × (prefills +
              chunk rounds), no other kernel, finite logits; tok/s, TTFT,
              decode ms/step, peak memory); one prefill round at 2 × 256
              beside its two sLSTM layers alone (the loop's share of the
              round, its launches a layer); the prefix cache on 4 requests
              behind phase 14's 1024-token prompt, cold, warm and rerun,
              streams bitwise equal. All beside the card's name and power
              limit (``xlstm`` line).
16. xlstm_train — xlstm-125m trained (``phase_xlstm_train``): #1 and #2 at
              its training shape (2, 4096, 1536) bf16 against their plain
              versions, twice bitwise, timed (``kernels`` lines); the
              training parity of one whole unit (6 layers: 5 mLSTM + 1
              sLSTM) at full width, f32, 2 × 512 (#1 exactly 10: forward
              and ``remat`` recompute; #2 5; nothing else); the training
              main path at full width, 6 of its 12 layers (one whole unit:
              the depth cut keeps the whole script within its 1200 s
              budget), bf16 compute, f32 params, pack 2 × 4096,
              through the training launcher (``repro_torch.launch.train.
              main --arch xlstm-125m --layers 6``, in this process:
              ``Trainer``, AdamW): a warm-up run of one step at 2 × 64,
              then a run of 1 timed step (#1 10 and #2 5, nothing
              else; ms/step, real tok/s, MFU, peak memory); one
              step at 2 × 64 (the same 6 layers) profiled
              with each layer's forward, recompute and backward marked
              (``layer_ranges``): the sLSTM and mLSTM layers' host and
              device ms, their shares of the step and their device
              events; one card step at 2 × 64 (6 layers) counted and
              held to the meta dry run of the same cell. All beside the
              card's name and power limit (``xlstm_train`` line).

17. hybrid_train — recurrentgemma-2b trained (``phase_hybrid_train``): #1
              and #2 at its training shape (2, 4096, 2560), bf16 and f32,
              against their plain versions, twice bitwise, timed beside
              cuDNN and their bounds (``kernels`` lines); the training
              parity of one whole unit (rec, rec, attn, each with its
              GeGLU MLP) at full width, f32, 2 × 2048 (#1 exactly 4: two
              RG-LRU layers, forward and ``remat`` recompute; #2 2;
              nothing else); the training main path at full width and
              depth (26 layers, d_model 2560, vocab 256000, tied
              embedding), bf16 compute, f32 params, pack 2 × 4096 on the
              paper's lengths, through the training launcher in this
              process: a warm-up run of one step at 2 × 64, then a run of
              2 timed steps (#1 36 and #2 18 a step, nothing else;
              ms/step, real tok/s, MFU, peak memory); a 2 × 512 step
              profiled with each sub-block marked (``layer_ranges``:
              the rec, attn and mlp kinds' host and device ms); one card
              step at 2 × 128 counted and held to the meta dry run of the
              same cell. All beside the card's name and power limit
              (``hybrid_train`` line).
18. hybrid  — recurrentgemma-2b served (``phase_hybrid``; its 26 layers:
              18 RG-LRU and 8 local attention, each with its GeGLU MLP;
              bf16, random weights from seed 0): #1 at its packed
              prefill's (2, 256, 2560) and its chunk slab's (1, 259,
              2560) against the plain version, twice bitwise, timed
              beside cuDNN and the bound (``kernels`` lines); packed
              against per-prompt prefill on an f32 copy (every state
              leaf, the K/V rings too, and the end logits, within 1e-5
              of max(1, max |ref|); the worst of each layer on a
              ``parity_layers`` line first); phase 5's engine at max_len
              2560 with a 2300-token prompt through the chunk lane, so
              the attention's 2048-slot ring wraps (#1 exactly 18 ×
              (prefills + chunk rounds), nothing else; each stream equal
              to the request's greedy ``prefill`` + ``decode_step``
              alone; tok/s, TTFT, prefill and decode ms, a slot's cache
              row bytes, peak memory); one decode step and one packed
              prefill round profiled with each sub-block kind marked;
              the prefix cache cold, warm and rerun on 4 requests behind
              phase 14's shared prompt; speculative decode at K 3
              against off, streams bitwise equal (``hybrid`` line).
19. dense   — stablelm-1.6b (``phase_dense``; 24 layers of full causal
              attention, 32 heads of 64 on 32 K/V heads, each with its
              SwiGLU MLP; d_model 2048, vocab 100352, untied; random
              weights from seed 0) served and trained at full width and
              depth. No kernel of the port's own lies on this path: every
              launch counter reads 0 after each part. Packed against
              per-prompt prefill on an f32 copy, 2 × 256 with 4 and 3
              segments a row (every K/V leaf and the end logits within
              1e-5 of max(1, max |ref|), the worst of each layer on a
              ``parity_layers`` line first); phase 5's engine at max_len
              2560 (a slot's row: 24 layers × K and V × 2560 × 32 × 64
              bf16, 480 MiB) with a 2300-token prompt through the chunk
              lane, each stream held to the request's greedy ``prefill``
              + ``decode_step`` alone: on an f32 copy (TF32 off) bitwise,
              in bf16 equal but where the reference's top-2 logits lie
              within two bf16 roundings (there the stream takes its
              second choice); the prefix cache cold, warm and
              rerun on 4 requests behind phase 14's shared prompt (a
              budget of 64 rows); speculative decode at K 3 against off
              (its K+1 copies of every row, peak memory); the training
              main path through the launcher in this process (a warm-up
              step at 2 × 64, then 2 timed steps at 2 × 4096, bf16 on f32
              weights: ms/step, MFU, peak memory), a step at 2 × 4096
              profiled by sub-block (``layer_ranges``: attn, mlp),
              one card step at 2 × 512 counted and held to the meta dry
              run of the same cell (``dense`` line).

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the kernels by their launch counters' names, and their bounds (PERF.md
# §6's column) from the port's roofline
from repro_torch.kernels.ops import (  # noqa: E402
    CONV_KERNELS, HEADS_KERNELS, SCAN_KERNELS, read_launches, zero_launches)
from repro_torch.roofline.analysis import peaks_for  # noqa: E402
from repro_torch.roofline.kernel_model import (  # noqa: E402
    conv_bound_ms, conv_dx_bound_ms, exp_floor_ms, heads_bounds,
    scan_bounds)

SFU_PER_SM_CLOCK = 16            # exp2 results per clock per SM (sm_90)
SHAPES = [(2, 64, 4096), (2, 128, 4096), (2, 256, 4096), (2, 4096, 4096)]
MAIN_SHAPE = (2, 256, 4096)      # the largest prefill bucket (serving)
TRAIN_SHAPE = (2, 4096, 4096)    # (rows, L, d_inner): mamba-1.4b training
TRAIN_SHAPE_28 = (2, 4096, 5120)  # mamba-2.8b training
RAGGED_SHAPE = (2, 997, 4096)    # an L that is no multiple of any tile
MAMBA2_CONV_SHAPE = (8, 4096, 2048)  # mamba2-370m training: (rows, L, d_inner)
ONE_WIDE_SHAPE = (2, 997, 4100)  # D no multiple of 8: #1 and #2 one
#                                  element a thread in bf16
CONV_TRAIN_SHAPES = {"mamba-1.4b": TRAIN_SHAPE, "mamba-2.8b": TRAIN_SHAPE_28,
                     "mamba2-370m": MAMBA2_CONV_SHAPE}
SCAN_RAGGED = (2, 997, 4104)     # and a D that is no multiple of a channel
#                                  block (16 or 32)
SCAN_CASES = ((TRAIN_SHAPE, "bfloat16"), (TRAIN_SHAPE_28, "bfloat16"),
              (SCAN_RAGGED, "bfloat16"), (SCAN_RAGGED, "float32"),
              (TRAIN_SHAPE, "float32"))
SCAN_OTHER_CHUNKS = (128, 48)     # #4 off the main path's chunk 64, at
#                                  SCAN_RAGGED (its any-chunk kernel): chunk
#                                  starts on tile edges and inside tiles
HEADS_SHAPE = (8, 4096, 32, 64)  # (rows, L, H, P): mamba2-370m training
HEADS_RAGGED = (8, 997, 32, 64)
HEADS_N = 64                     # mamba2-370m's d_state
PARITY_TOL = 1e-3                # max |Δ| / max(1, max |ref|), 48 f32 layers
TRAIN_PARITY_TOL = 1e-3          # max |Δ| / max |ref| per gradient leaf
BWD_TOL = 1e-3                   # max |Δ| / max(1, max |ref|) per output
TIMED_STEPS = 4
# the tune phase's sweeps: mamba-1.4b's training layer and mamba2-370m's
# layer (forward, where the two heads forms differ; #9 serves both)
TUNE_SWEEPS = (dict(op="selective_scan", B=2, L=4096, D=4096, N=16,
                    dtype="bfloat16", objective="fwdbwd"),
               dict(op="selective_scan_heads", B=8, L=4096, H=32, dh=64,
                    N=64, dtype="bfloat16", objective="fwd"))
TUNE_ROUNDS = 3
# the checkpoint phase: 4 layers keep a checkpoint (weights, m and v in
# f32) at ≈ 3.7 GB, where 48 would write ≈ 17.7 GB twice
CKPT_LAYERS = 4
CKPT_STEPS = 6
CKPT_KILL_AT = 3             # SIGTERM as this step's batch is fetched
# phase 12 (serve): the scheduler-v2 engine on mamba-1.4b
SERVE_SLOTS = 24                 # more slots than requests: both runs pack
#                                  the same rounds (phase_serve's docstring)
SERVE_NEW = 16                   # new tokens a request
SERVE_LONG = 1500                # the over-bucket prompt: 6 chunk rounds
SERVE_CHUNK = 256                # chunk slab = the largest bucket
SERVE_TTFT_MS = 20000.0          # the TTFT target: above every wait of
#                                  this mix, so no time rule fires
SERVE_SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
# phase 13 (lifecycle): phase 12's engine under a fault plan, killed and
# restored, and a cancel in flight
LIFE_PLAN = dict(poison_decode={3: [0]}, poison_prefill={1: [(0, 0)]},
                 poison_chunk={2: [0]}, fail_prefill=2)
LIFE_KILL_AT = 6                 # decode step; snapshots every 4 steps, so
#                                  the last one holds the long prompt mid-chunk
LIFE_SNAP_EVERY = 4
CHUNK_PARITY_LEN = 700           # one prompt, whole against 3 slabs
CHUNK_SLAB_SHAPE = (1, 3 + SERVE_CHUNK, 4096)   # #1 over a slab: W-1 + T
PREFIX_LEN = 1024                # phase 14's declared system prompt
PREFIX_REQUESTS = 16             # each with a 16–200 token suffix
PREFIX_LRU_ENTRIES = 4           # the budget that forces evictions
PREFIX_MAMBA2_REQUESTS = 4
SPEC_K = 4
SUFFIX_SLABS = ((1, 3 + 64, 4096), (1, 3 + 128, 4096))
XLSTM_CONV_SHAPES = ((2, 256, 1536), (1, 3 + SERVE_CHUNK, 1536))  # #1 in
#                                  xlstm-125m's packed prefill and chunk slab
XLSTM_PARITY_TOL = 5e-4          # max |Δ| / max(1, max |ref|), 12 f32 layers
XLSTM_PREFIX_REQUESTS = 4  # #1 at the suffix
#                                  rounds' narrower slab widths
# phase 16 (xlstm_train): xlstm-125m's training step; a 2 × 4096 step
# takes 34–46 s of host time (the sLSTM's loop over time), so the
# warm-up, the profile and the count run shorter rows of the same model
XLSTM_TRAIN_SHAPE = (2, 4096, 1536)  # (rows, L, up-projection): #1 and #2
XLSTM_TRAIN_STEPS = 1    # the timed steps at 2 × 4096: one since phase 19,
#                          whose time this and the parity's shorter rows
#                          take back (a step is 17–23 s on an H100)
XLSTM_PARITY_SEQ = 512   # the unit's training parity rows (f32, kernels
#                          against the plain path; 25 s at 2 × 2048)
XLSTM_TRAIN_LAYERS = 6   # the timed, traced and counted steps' depth: one
#                          whole unit (5 mLSTM + 1 sLSTM) of the 12, so the
#                          script stays within its 1200 s budget with
#                          phases 17 and 18 (a 12-layer step takes 38–64 s
#                          on an H100, the sLSTM loop's; a 12-layer 2 × 64
#                          trace ≈ 33k kernels, ≈ 19 s to read)
XLSTM_SHORT_SEQ = 64     # the warm-up's and the profile's rows (a trace's
#                          post-processing grows with its ≈ 360 events a
#                          time step)
XLSTM_COUNT_SEQ = 64     # the counted step's rows (its meta dry run walks
#                          the sLSTM loop op by op: 6.1 s at 128)
HYBRID_CONV_SHAPE = (2, 4096, 2560)  # (rows, L, lru_width): recurrentgemma-2b
#                                      training, #1 and #2
HYBRID_TRAIN_STEPS = 2
HYBRID_SHORT_SEQ = 64    # the warm-up run's rows
HYBRID_PROFILE_SEQ = 512  # the traced step's rows: on an H100 host, at
#                           4096 the trace's ≈ 91k kernels took 80–141 s
#                           to read, at 1024 its 33k took 71 s over three
#                           traces
HYBRID_COUNT_SEQ = 128
HYBRID_SERVE_SHAPES = ((2, 256, 2560), (1, 3 + SERVE_CHUNK, 2560))  # #1 in
#   a packed prefill's rows and over a chunk slab (the carried tail first)
HYBRID_LONG = 2300       # the chunk lane's prompt: past the attention's
#   2048-slot ring, so the ring wraps in ``chunk_attn`` and in decode
HYBRID_MAX_LEN = 2560    # the engine's slots: a ring of min(2560, 2048)
HYBRID_PARITY_TOL = 1e-5  # max |Δ| / max(1, max |ref|), f32: the bar of the
#   CPU tests (tests/test_torch_hybrid_serve.py, the JAX package's own)
HYBRID_PREFIX_REQUESTS = 4
HYBRID_SPEC_K = 3
DENSE_ARCH = "stablelm-1.6b"
DENSE_PARITY_LENS = (60, 90, 18, 61, 37, 120, 70)  # first fit into 2 × 256:
#   4 segments in row 0, 3 in row 1
DENSE_PARITY_CAP = 256
DENSE_PARITY_TOL = 1e-5  # max |Δ| / max(1, max |ref|), f32, 24 layers: the
#   CPU tests' bar (tests/test_torch_dense_serve.py)
DENSE_TRAIN_SEQ = 4096
DENSE_TRAIN_STEPS = 2
DENSE_SHORT_SEQ = 64     # the warm-up run's rows
DENSE_COUNT_SEQ = 512    # the counted card step's rows
DENSE_LONG = 2300        # the chunk lane's prompt (9 slabs of 256)
DENSE_MAX_LEN = 2560     # the engine's slots: 2560 K/V slots a layer
DENSE_PREFIX_REQUESTS = 4
DENSE_SPEC_K = 3


T_START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def eager_ms(fn, iters=100, warmup=10):
    """Time of one call in a host loop (host overhead included): CUDA
    events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=50, reps=5):
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch
    overhead is out of the number. Inputs stay in L2 between calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def packed_positions(B, L, seed):
    """Row 0 packs prompts of 3..L/4 tokens back to back (resets fall
    inside tiles and chunks); row 1 is a carried row of a split pack
    (positions > 0 at its start). Every other row packs like row 0."""
    import numpy as np
    from repro_torch.core import packing
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, L // 4, size=64)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), L, side="right"))]
    pb = packing.pack([rng.integers(1, 9, size=int(n)) for n in lens], L,
                      policy="sequential", num_rows=B)
    sp = packing.pack_with_split(
        [rng.integers(1, 9, size=n) for n in (L + L // 3, L)], L)
    pos = np.tile(pb.positions[:1], (B, 1))
    pos[1] = sp.positions[1]
    assert sp.carry_mask[1] and pos[1, 0] > 0
    return pos


def conv_inputs(shape, dtype, seed):
    """x_in as the strided half of an in_proj output; positions from
    ``packed_positions``."""
    import torch
    B, L, D = shape
    pos = packed_positions(B, L, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn((B, L, 2 * D), generator=g, device="cuda").to(dtype)
    x_in = xz.chunk(2, dim=-1)[0]
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(dtype)
    b = torch.randn((D,), generator=g, device="cuda").to(dtype)
    return x_in, w, b, torch.as_tensor(pos, device="cuda")


def timing_iters(shape):
    """Graph-captured calls per replay: fewer at training size, where each
    call's outputs are hundreds of MB of the graph's private pool."""
    return 50 if shape[1] <= 256 else 10


def conv_fwd_row(shape, dtype, peaks):
    """Kernel #1 at ``shape`` in ``dtype`` (``conv_inputs``: packed rows and
    a carried row) against ``conv1d_pack_plain``; twice, bitwise equal;
    timed beside the plain version, cuDNN and its bound. Returns its
    ``kernels`` row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    x, w, b, pos = conv_inputs(shape, dtype, seed=shape[1])
    y = kconv.conv1d_pack(x, w, b, pos)
    launch = kconv.LAST_LAUNCH
    again = kconv.conv1d_pack(x, w, b, pos)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"conv1d_pack kernel is not bitwise "
                             f"repeatable at {shape} {dtype}")
    want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
    err = (y.float() - want).abs()
    if dtype == torch.float32:
        ok, tol = bool((err <= 1e-5).all()), "1e-5 abs"
    else:      # one bf16 rounding of the f32-accumulated result
        ok = bool((err <= 2.0 ** -8 * want.abs() + 1e-6).all())
        tol = "2^-8 relative (one bf16 rounding)"
    if not ok:
        raise AssertionError(f"conv1d_pack kernel disagrees with its "
                             f"plain version at {shape} {dtype}: "
                             f"max err {err.max().item()}")
    # library yardstick: cuDNN depthwise conv on a reset-free input
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    lib = lambda: F.conv1d(xc, wc, b, padding=3, groups=shape[2])
    bound, by = conv_bound_ms(x, w, peaks)
    kern = lambda: kconv.conv1d_pack(x, w, b, pos)
    plain = lambda: kconv.conv1d_pack_plain(x, w, b, pos)
    it = timing_iters(shape)
    return {
        "kernel": "conv1d_pack_fwd",
        "shape": list(shape), "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err.max().item(), "tolerance": tol,
        "bitwise_repeat": True,
        "launch": launch,
        "kernel_ms": graph_ms(kern, it), "plain_ms":
        graph_ms(plain, it), "library_ms": graph_ms(lib, it),
        "bound_ms": bound, "bound_by": by,
        "kernel_eager_ms": eager_ms(kern),
        "plain_eager_ms": eager_ms(plain),
        "library_eager_ms": eager_ms(lib)}


def phase_conv_fwd(peaks):
    """Kernel #1 at the serving buckets, the three models' training shapes
    and a one-element-wide shape (``conv_fwd_row``)."""
    import torch
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (*SHAPES, TRAIN_SHAPE_28, MAMBA2_CONV_SHAPE,
                      ONE_WIDE_SHAPE):
            rows.append(conv_fwd_row(shape, dtype, peaks))
            emit("kernels", **rows[-1])
            gc.collect()
    return rows, max(r["max_abs_err"] for r in rows)


def conv_dx_row(shape, dtype, peaks):
    """Kernel #2 at ``shape`` in ``dtype`` (packed positions), against
    ``conv1d_pack_bwd_dx_plain``; twice, bitwise equal; timed beside the
    plain version, cuDNN and its bound. Returns its ``kernels`` row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    B, L, D = shape
    pos = torch.as_tensor(packed_positions(B, L, L), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(L + 1)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(dtype)
    dx = kconv.conv1d_pack_bwd_dx(dy, w, pos)
    launch = kconv.LAST_LAUNCH
    again = kconv.conv1d_pack_bwd_dx(dy, w, pos)
    torch.cuda.synchronize()
    want = kconv.conv1d_pack_bwd_dx_plain(dy, w, pos)
    err = (dx - want).abs()
    tol = "1e-5 · (1 + |ref|) (f32 on both sides, taps reordered)"
    if not bool((err <= 1e-5 * (1 + want.abs())).all()):
        raise AssertionError(f"conv1d_pack dx kernel disagrees with "
                             f"its plain version at {shape} {dtype}: "
                             f"max err {err.max().item()}")
    if not torch.equal(dx, again):
        raise AssertionError("conv1d_pack dx kernel is not bitwise "
                             "repeatable")
    # library yardstick: cuDNN depthwise correlation with the flipped
    # weights, right-padded, on a reset-free input
    dyc = dy.transpose(1, 2).contiguous()
    wf = w.flip(0).t().contiguous()[:, None, :]
    lib = lambda: F.conv1d(dyc, wf, padding=3, groups=D)
    bound, by = conv_dx_bound_ms(dy, w, peaks)
    kern = lambda: kconv.conv1d_pack_bwd_dx(dy, w, pos)
    plain = lambda: kconv.conv1d_pack_bwd_dx_plain(dy, w, pos)
    return {
        "kernel": "conv1d_pack_bwd_dx", "shape": list(shape),
        "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err.max().item(), "tolerance": tol,
        "bitwise_repeat": True,
        "launch": launch,
        "kernel_ms": graph_ms(kern, 10, 3),
        "plain_ms": graph_ms(plain, 10, 3),
        "library_ms": graph_ms(lib, 10, 3), "bound_ms": bound,
        "bound_by": by, "kernel_eager_ms": eager_ms(kern, 20, 3),
        "plain_eager_ms": eager_ms(plain, 5, 1),
        "library_eager_ms": eager_ms(lib, 20, 3)}


def phase_conv_dx(peaks):
    """Kernel #2 at the three models' training shapes, a ragged L and a
    one-element-wide shape (``conv_dx_row``)."""
    import torch
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (TRAIN_SHAPE, RAGGED_SHAPE, TRAIN_SHAPE_28,
                      MAMBA2_CONV_SHAPE, ONE_WIDE_SHAPE):
            rows.append(conv_dx_row(shape, dtype, peaks))
            emit("kernels", **rows[-1])
            gc.collect()
    return rows, max(r["max_abs_err"] for r in rows)


def scan_inputs(shape, dtype, seed):
    """u, Δ, dy (B, L, D) in ``dtype``; B and C as strided views of one
    (B, L, dt_rank + 2N) projection, as the model hands them over; A from
    the model's init (-(1..N)); D = 1; positions from
    ``packed_positions``."""
    import torch
    B, L, D = shape
    N, dtr = 16, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(shape, generator=g, device="cuda").to(dtype)
    delta = torch.rand(shape, generator=g, device="cuda").mul(0.1).add(
        1e-3).to(dtype)
    dbl = torch.randn((B, L, dtr + 2 * N), generator=g,
                      device="cuda").to(dtype)
    _, Bm, Cm = dbl.split([dtr, N, N], dim=-1)
    At = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda")[
        :, None].repeat(1, D)
    Dp = torch.ones(D, device="cuda")
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pos = torch.as_tensor(packed_positions(B, L, seed), device="cuda")
    return u, delta, At, Bm, Cm, Dp, pos, dy


def once_ms(fn):
    """One call between CUDA events (host overhead included): for the
    plain scans, whose Python step loops are too long to graph-capture."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def blocked_bwd_exps(L, chunk):
    """Exponentials per (b, d, n) of #6 on a row of L steps: the carry pass
    and the tile recompute take every step, the walk to the tile entries
    every step of a chunk but its last tile's."""
    from repro_torch.kernels import selective_scan as ksc
    tt = ksc.bwd_params()["tile"]
    walk = sum((-(-(min(L, c0 + chunk) - c0) // tt) - 1) * tt
               for c0 in range(0, L, chunk))
    return 2 * L + walk


def pair_partials(p, nblk):
    """Per-16-channel dB/dC partials (B, n16, L, N) summed in pairs into
    per-32-channel ones (B, nblk, L, N)."""
    import torch
    pad = 2 * nblk - p.shape[1]
    if pad:
        p = torch.cat([p, p.new_zeros((p.shape[0], pad) + p.shape[2:])], 1)
    return p.reshape(p.shape[0], nblk, 2, *p.shape[2:]).sum(2)


def scan_resources(kind, dtype, shape, sms, chunk=64):
    """The forward's (``kind`` "fwd": #3's and #4's kernel that ``chunk``
    takes) or #5's ("step_bwd") registers, spills, warps an SM and waves
    (its B·⌈D/channels a block⌉ blocks over the SMs' block slots) at
    ``shape``."""
    from repro_torch.kernels import selective_scan as ksc
    if kind == "fwd":
        r, width = (ksc.lanes_fwd_resources(dtype, chunk),
                    ksc.lanes_fwd_params()["block_d"])
    else:
        r, width = ksc.step_bwd_resources(dtype), ksc.STEP_BLOCK_D
    blocks = shape[0] * -(-shape[2] // width)
    return {**r, "blocks": blocks,
            "waves": blocks / (sms * max(1, r["blocks_per_sm"]))}


def phase_scan(sfu_rate, sms, peaks):
    """The Mamba-1 scan's two schedules at each shape of ``SCAN_CASES``,
    timed in one call: #4/#6 (``blocked``) and #3/#5 (``step``), each
    against the plain versions (one forward and one backward per case,
    the backward fed #4's checkpoints, as every kernel backward is); every
    kernel twice, bitwise equal; and the two schedules against each other
    — #3's checkpoints against #4's, #5 against #6. Then #4 at the chunks
    of ``SCAN_OTHER_CHUNKS`` (``phase_scan_chunks``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ksc
    chunk = ops.SCAN_CHUNK
    rows = []
    worst = {k: 0.0 for pair in SCAN_KERNELS.values() for k in pair}
    for shape, dtn in SCAN_CASES:
        dtype = getattr(torch, dtn)
        B, L, D = shape
        N, es = 16, torch.tensor([], dtype=dtype).element_size()
        args = scan_inputs(shape, dtype, seed=L)
        dy = args[7]
        fa = args[:7]
        (wy, wck), plain_fwd_ms = once_ms(
            lambda: ksc.selective_scan_fwd_plain(*fa, chunk))
        wy32 = wy.float()
        scale = wy32.abs().max().item()
        ck4 = ksc.selective_scan_fwd(*fa, chunk, "blocked")[1]
        want16, plain_bwd_ms = once_ms(
            lambda: ksc.selective_scan_bwd_plain(*fa, ck4, dy, chunk,
                                                 ksc.STEP_BLOCK_D))
        nblk32 = -(-D // ksc.BLOCK_D)
        want = {"step": want16,
                "blocked": (*want16[:2], pair_partials(want16[2], nblk32),
                            pair_partials(want16[3], nblk32), *want16[4:])}
        got, ckpts, times = {}, {}, {}
        for sched in ("blocked", "step"):
            kf, kb = SCAN_KERNELS[sched]
            fwd = functools.partial(ksc.selective_scan_fwd, *fa, chunk, sched)
            y, ck = fwd()
            y2, ck2 = fwd()
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
                raise AssertionError(f"{kf} is not bitwise repeatable at "
                                     f"{shape} {dtype}")
            del y2, ck2
            ckpts[sched] = ck
            y32 = y.float()
            err_y = (y32 - wy32).abs()
            if dtype == torch.float32:
                ok = bool((err_y <= 1e-4 * (1 + wy32.abs())).all())
                tol = "y 1e-4 · (1 + |ref|); ckpts 1e-4 · (1 + |ref|)"
            else:       # each side rounds its f32 result to bf16 once
                ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                           + 1e-4 * scale).all())
                tol = ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                       "roundings); ckpts 1e-4 · (1 + |ref|)")
            err_ck = (ck - wck).abs()
            ok = ok and bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
            if not ok:
                raise AssertionError(
                    f"{kf} kernel disagrees with its plain version at "
                    f"{shape} {dtype}: y {err_y.max().item()}, ckpts "
                    f"{err_ck.max().item()}")
            e_fwd = max(err_y.max().item(), err_ck.max().item())
            worst[kf] = max(worst[kf], e_fwd)
            del y, y32, err_y, err_ck
            (bnd_f, by_f), (bnd_b, by_b) = scan_bounds(shape, es,
                                                       ck.shape[1], peaks)
            kern_f = graph_ms(fwd, 10, 3)
            rows.append({
                "kernel": kf, "schedule": sched, "shape": list(shape),
                "dtype": dtn, "chunk": chunk, "max_abs_err": e_fwd,
                "tolerance": tol, "bitwise_repeat": True, "kernel_ms": kern_f,
                "kernel_eager_ms": eager_ms(fwd, 10, 2),
                "plain_ms": plain_fwd_ms, "library_ms": None,
                "bound_ms": bnd_f, "bound_by": by_f,
                "exp_floor_ms": exp_floor_ms(B * L * D * N, sfu_rate),
                "resources": scan_resources("fwd", dtype, shape, sms)})
            emit("kernels", **rows[-1])
            bwd = functools.partial(ksc.selective_scan_bwd, *fa, ck4, dy,
                                    chunk, sched)
            outs, again = bwd(), bwd()
            torch.cuda.synchronize()
            errs = {}
            for name, g, ref, rep in zip(
                    ("du", "ddelta", "dB", "dC", "dA", "dD"), outs,
                    want[sched], again):
                e = (g - ref).abs().max().item()
                errs[name] = e
                if e > BWD_TOL * max(1.0, ref.abs().max().item()):
                    raise AssertionError(
                        f"{kb} kernel disagrees with its plain version at "
                        f"{shape} {dtype}: {name} max err {e}")
                if not torch.equal(g, rep):
                    raise AssertionError(f"{kb} {name} is not bitwise "
                                         f"repeatable")
            worst[kb] = max(worst[kb], max(errs.values()))
            got[sched] = outs
            del again
            # #6 computes each decay up to three times (its carry pass, the
            # walk to its tile entries, the tile recompute), #5 once
            n_exp = (blocked_bwd_exps(L, chunk) if sched == "blocked"
                     else L) * B * D * N
            extra = ({"resources": scan_resources("step_bwd", dtype, shape,
                                                  sms)}
                     if sched == "step" else {})
            rows.append({
                "kernel": kb, "schedule": sched, "shape": list(shape),
                "dtype": dtn, "chunk": chunk,
                "max_abs_err": max(errs.values()), "errors": errs,
                "tolerance": f"{BWD_TOL} · max(1, max|ref|) per output",
                "bitwise_repeat": True,
                "kernel_ms": graph_ms(bwd, 10, 3),
                "kernel_eager_ms": eager_ms(bwd, 10, 2),
                "plain_ms": plain_bwd_ms, "library_ms": None,
                "bound_ms": bnd_b, "bound_by": by_b,
                "exp_floor_ms": exp_floor_ms(n_exp, sfu_rate), **extra})
            emit("kernels", **rows[-1])
            times[sched] = (kern_f, rows[-1]["kernel_ms"])
        # the two schedules on one card
        e_ck = (ckpts["step"] - ckpts["blocked"]).abs()
        ck_ok = bool((e_ck <= 1e-4 * (1 + ckpts["blocked"].abs())).all())
        errs = {}
        for i, name in enumerate(("du", "ddelta", "dB", "dC", "dA", "dD")):
            a, b = got["step"][i], got["blocked"][i]
            if name in ("dB", "dC"):
                a, b = a.sum(1), b.sum(1)
            errs[name] = (a - b).abs().max().item()
            if errs[name] > BWD_TOL * max(1.0, b.abs().max().item()):
                raise AssertionError(f"#5 and #6 disagree at {shape} "
                                     f"{dtype}: {name} {errs[name]}")
        if not ck_ok:
            raise AssertionError(f"#3's checkpoints differ from #4's at "
                                 f"{shape} {dtype}: {e_ck.max().item()}")
        emit("scan_schedules", shape=list(shape), dtype=dtn,
             ckpt_step_vs_blocked=e_ck.max().item(),
             ckpt_tolerance="1e-4 · (1 + |#4|)", bwd_step_vs_blocked=errs,
             bwd_tolerance=f"{BWD_TOL} · max(1, max|#6|) (dB, dC summed "
                           f"over blocks)",
             fwd_ms={s: t[0] for s, t in times.items()},
             bwd_ms={s: t[1] for s, t in times.items()})
        del args, fa, dy, wy, wck, wy32, ck4, want16, want, got, ckpts
        del outs, e_ck
        gc.collect()
        torch.cuda.empty_cache()
    rows += phase_scan_chunks(sfu_rate, sms, worst, peaks)
    return rows, worst


def phase_scan_chunks(sfu_rate, sms, worst, peaks):
    """#4 at each chunk of ``SCAN_OTHER_CHUNKS`` at ``SCAN_RAGGED`` bf16:
    against the plain version (the forward tolerances of ``phase_scan``),
    twice, bitwise equal, timed beside #4 at chunk 64 in the same call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ksc
    shape, dtype = SCAN_RAGGED, torch.bfloat16
    B, L, D = shape
    N, es = 16, 2
    fa = scan_inputs(shape, dtype, seed=L)[:7]
    at64 = graph_ms(functools.partial(ksc.selective_scan_fwd, *fa,
                                      ops.SCAN_CHUNK), 10, 3)
    rows = []
    for chunk in SCAN_OTHER_CHUNKS:
        (wy, wck), plain_ms = once_ms(
            lambda: ksc.selective_scan_fwd_plain(*fa, chunk))
        fwd = functools.partial(ksc.selective_scan_fwd, *fa, chunk)
        y, ck = fwd()
        y2, ck2 = fwd()
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
            raise AssertionError(f"#4 at chunk {chunk} is not bitwise "
                                 f"repeatable")
        wy32 = wy.float()
        err_y = (y.float() - wy32).abs()
        err_ck = (ck - wck).abs()
        ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                   + 1e-4 * wy32.abs().max().item()).all()) and \
            ck.shape == wck.shape and \
            bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
        if not ok:
            raise AssertionError(
                f"#4 at chunk {chunk} disagrees with its plain version at "
                f"{shape}: y {err_y.max().item()}, ckpts "
                f"{err_ck.max().item()}")
        e = max(err_y.max().item(), err_ck.max().item())
        worst["selective_scan_fwd"] = max(worst["selective_scan_fwd"], e)
        bnd, by = scan_bounds(shape, es, ck.shape[1], peaks)[0]
        rows.append({
            "kernel": "selective_scan_fwd", "schedule": "blocked",
            "shape": list(shape), "dtype": "bfloat16", "chunk": chunk,
            "max_abs_err": e,
            "tolerance": ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                          "roundings); ckpts 1e-4 · (1 + |ref|)"),
            "bitwise_repeat": True, "kernel_ms": graph_ms(fwd, 10, 3),
            "kernel_ms_chunk_64_same_call": at64,
            "kernel_eager_ms": eager_ms(fwd, 10, 2), "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "exp_floor_ms": exp_floor_ms(B * L * D * N, sfu_rate),
            "resources": scan_resources("fwd", dtype, shape, sms, chunk)})
        emit("kernels", **rows[-1])
        del wy, wck, y, ck, y2, ck2, wy32, err_y, err_ck
    del fa
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def heads_inputs(shape, dtype, seed):
    """u, dy (B, L, H, P) and Δ (B, L, H) in ``dtype`` (Δ in the range the
    init's softplus gives); B and C as strided views of one (B, L, 2N)
    projection, as bc_proj hands them over; A = -U[1, 16] per head, as the
    init draws it; D = 1; positions from ``packed_positions``."""
    import torch
    B, L, H, P = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(shape, generator=g, device="cuda").to(dtype)
    delta = torch.rand((B, L, H), generator=g, device="cuda").mul(0.1).add(
        1e-3).to(dtype)
    bc = torch.randn((B, L, 2 * HEADS_N), generator=g, device="cuda").to(
        dtype)
    Bm, Cm = bc.chunk(2, dim=-1)
    A = -(torch.rand(H, generator=g, device="cuda") * 15.0 + 1.0)
    Dp = torch.ones(H, device="cuda")
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    pos = torch.as_tensor(packed_positions(B, L, seed), device="cuda")
    return u, delta, A, Bm, Cm, Dp, pos, dy


def phase_heads(peaks):
    """Kernels #7, #8 and #9 at mamba2-370m's training shape and at a
    ragged L, in bf16 and f32, against their plain versions; #7 and #9
    twice, bitwise equal; #7's resources (blocks an SM, registers, spills,
    shared bytes) per dtype."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan_heads as kh
    rows = []
    worst = {"selective_scan_heads_fwd": 0.0,
             "selective_scan_heads_fwd_dual": 0.0,
             "selective_scan_heads_bwd": 0.0}
    forms = (("selective_scan_heads_fwd", "blocked_heads",
              kh.selective_scan_heads_fwd_plain),
             ("selective_scan_heads_fwd_dual", "blocked_heads_dual",
              kh.selective_scan_heads_fwd_dual_plain))
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (HEADS_SHAPE, HEADS_RAGGED):
            B, L, H, P = shape
            es = torch.tensor([], dtype=dtype).element_size()
            *fa, dy = heads_inputs(shape, dtype, seed=L + 1)
            T = min(ops.HEADS_CHUNK, L)
            (bnd_f, by_f), (bnd_b, by_b) = heads_bounds(shape, es, T, peaks)
            dtn = str(dtype).split(".")[-1]
            for name, sched, plain in forms:
                fwd = functools.partial(kh.selective_scan_heads_fwd, *fa, T,
                                        sched)
                y, ck = fwd()
                if sched == "blocked_heads":
                    y2, ck2 = fwd()
                    if not (torch.equal(y, y2) and torch.equal(ck, ck2)):
                        raise AssertionError(f"{name} is not bitwise "
                                             f"repeatable at {shape} {dtype}")
                    del y2, ck2
                torch.cuda.synchronize()
                (wy, wck), plain_ms = once_ms(lambda: plain(*fa, T))
                y32, wy32 = y.float(), wy.float()
                err_y = (y32 - wy32).abs()
                if dtype == torch.float32:
                    ok = bool((err_y <= 1e-4 * (1 + wy32.abs())).all())
                    tol = "y 1e-4 · (1 + |ref|); ckpts 1e-4 · (1 + |ref|)"
                else:       # each side rounds its f32 result to bf16 once
                    ok = bool((err_y <= 2.0 ** -7 * wy32.abs()
                               + 1e-4 * wy32.abs().max()).all())
                    tol = ("y 2^-7 · |ref| + 1e-4 · max|ref| (two bf16 "
                           "roundings); ckpts 1e-4 · (1 + |ref|)")
                err_ck = (ck - wck).abs()
                ok = ok and bool((err_ck <= 1e-4 * (1 + wck.abs())).all())
                e = max(err_y.max().item(), err_ck.max().item())
                if not ok:
                    raise AssertionError(
                        f"{name} kernel disagrees with its plain version at "
                        f"{shape} {dtype}: y {err_y.max().item()}, ckpts "
                        f"{err_ck.max().item()}")
                worst[name] = max(worst[name], e)
                del wy, wck, y32, wy32, err_y, err_ck
                rows.append({
                    "kernel": name, "shape": list(shape), "dtype": dtn,
                    "chunk": T, "max_abs_err": e, "tolerance": tol,
                    "kernel_ms": graph_ms(fwd, 10, 3),
                    "kernel_eager_ms": eager_ms(fwd, 10, 2),
                    "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": bnd_f, "bound_by": by_f})
                if sched == "blocked_heads":
                    rows[-1].update(bitwise_repeat=True,
                                    resources=kh.fwd_resources(dtype))
                    ck_main = ck
                emit("kernels", **rows[-1])
                del y, ck
            bwd = functools.partial(kh.selective_scan_heads_bwd, *fa,
                                    ck_main, dy, T)
            outs, again = bwd(), bwd()
            torch.cuda.synchronize()
            want, plain_ms = once_ms(
                lambda: kh.selective_scan_heads_bwd_plain(*fa, ck_main, dy, T))
            errs = {}
            for name, got, ref, rep in zip(
                    ("du", "ddelta", "dB", "dC", "dA", "dD"), outs, want,
                    again):
                e = (got - ref).abs().max().item()
                errs[name] = e
                if e > BWD_TOL * max(1.0, ref.abs().max().item()):
                    raise AssertionError(
                        f"selective_scan_heads backward kernel disagrees "
                        f"with its plain version at {shape} {dtype}: {name} "
                        f"max err {e}")
                if not torch.equal(got, rep):
                    raise AssertionError(f"selective_scan_heads backward "
                                         f"{name} is not bitwise repeatable")
            worst["selective_scan_heads_bwd"] = max(
                worst["selective_scan_heads_bwd"], max(errs.values()))
            partial_bytes = sum(t.numel() * 4 for t in outs[1:])
            del outs, again, want
            torch.cuda.empty_cache()
            rows.append({
                "kernel": "selective_scan_heads_bwd", "shape": list(shape),
                "dtype": dtn, "chunk": T, "max_abs_err": max(errs.values()),
                "errors": errs,
                "tolerance": f"{BWD_TOL} · max(1, max|ref|) per output",
                "bitwise_repeat": True, "partials_bytes": partial_bytes,
                "kernel_ms": graph_ms(bwd, 4, 3),
                "kernel_eager_ms": eager_ms(bwd, 4, 2),
                "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bnd_b, "bound_by": by_b})
            emit("kernels", **rows[-1])
            del fa, dy, ck_main, bwd
            gc.collect()
            torch.cuda.empty_cache()
    return rows, worst


def path_kernels(cfg, schedule=None, rows=2):
    """The kernels ``cfg``'s training path runs: conv forward, conv dx,
    scan forward, scan backward; the Mamba-1 scan's by
    ``cfg.pallas_schedule``, the Mamba-2 scan's by ``schedule``; with
    ``cfg.scan_tune`` on, by the cached winner at (``rows``, 4096): a
    plain winner runs no scan kernel (None in their places). xLSTM and the
    hybrid have no scan kernel: their mLSTM and RG-LRU layers run the
    conv's two, their recurrences and attention are plain."""
    if cfg.family in ("xlstm", "hybrid"):
        return [*CONV_KERNELS, None, None]
    if cfg.scan_tune != "off":
        from repro_torch.tune import config_shape_args, tuned
        args = config_shape_args(cfg, rows, 4096)
        kn = tuned(args.pop("op"), objective=cfg.tune_objective,
                   cache=None if cfg.scan_tune == "auto" else cfg.scan_tune,
                   **args)
        if kn.get("backend") != "pallas":
            return [*CONV_KERNELS, None, None]
        schedule = kn["schedule"]
    elif cfg.unit[0] == "mamba":
        schedule = cfg.pallas_schedule
    if cfg.unit[0] == "mamba":
        return [*CONV_KERNELS, *SCAN_KERNELS[schedule]]
    return [*CONV_KERNELS, *HEADS_KERNELS[schedule or "blocked_heads"]]


@contextlib.contextmanager
def plain_path():
    """The model's blocks call the plain ``core/`` conv and scans (plain
    PyTorch, differentiated by autograd) instead of the kernel wrappers:
    the reference of the training parity phases."""
    from repro_torch.core import conv as core_conv
    from repro_torch.core import ssm as core_ssm
    from repro_torch.models import blocks
    saved = blocks.kops
    blocks.kops = types.SimpleNamespace(
        conv1d_pack=core_conv.conv1d_pack,
        selective_scan=lambda u, dt, A, B, C, D, positions, **_: (
            core_ssm.selective_scan(u, dt, A, B, C, D, positions=positions,
                                    method="blocked", chunk=64)),
        selective_scan_heads=lambda u, dt, A, B, C, D, positions, **_: (
            core_ssm.selective_scan_heads(u, dt, A, B, C, D,
                                          positions=positions,
                                          method="blocked", chunk=64)))
    try:
        yield
    finally:
        blocks.kops = saved


@contextlib.contextmanager
def heads_schedule(schedule):
    """The model's Mamba-2 blocks run the heads scan with ``schedule``
    (``None`` or ``blocked_heads``: the default #7; ``blocked_heads_dual``:
    #8), as the JAX package's ``schedule=`` argument reaches it."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    if schedule in (None, "blocked_heads"):
        yield
        return
    saved = blocks.kops
    blocks.kops = types.SimpleNamespace(
        conv1d_pack=ops.conv1d_pack, selective_scan=ops.selective_scan,
        selective_scan_heads=functools.partial(ops.selective_scan_heads,
                                               schedule=schedule))
    try:
        yield
    finally:
        blocks.kops = saved


def train_loader(cfg, mode, seq_len=4096, rows=2, seed=0):
    from repro_torch.data.dataset import (PAPER_LEN_MAX, CorpusConfig,
                                          SyntheticCorpus)
    from repro_torch.data.packing_loader import LoaderConfig, PackingLoader
    corpus = SyntheticCorpus(CorpusConfig(
        vocab=cfg.vocab, seed=seed, len_max=min(PAPER_LEN_MAX, seq_len)))
    return PackingLoader(corpus, LoaderConfig(rows=rows, seq_len=seq_len,
                                              mode=mode))


def phase_train_parity(arch="mamba-1.4b", schedule=None, layers=2,
                       seq_len=2048):
    """Full-width ``arch``, ``layers`` deep, f32 (TF32 off): loss and every
    gradient through the kernels (the Mamba-1 scan's ``pallas_schedule``
    or the heads scan's schedule set to ``schedule``) against the plain
    path. Counters set to 0 before each path: the kernel path must launch
    exactly its kernels, the plain path none."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    if cfg.unit[0] == "mamba" and schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
        schedule = None
    model = LM(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(1))
    batch = train_loader(cfg, "pack", seq_len).batch(0)
    params = dict(model.named_parameters())

    def loss_and_grads():
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    zero_launches()
    with heads_schedule(schedule):
        k_loss, k_grads = loss_and_grads()
    torch.cuda.synchronize()
    ran = read_launches()
    expected = [k for k in path_kernels(cfg, schedule) if k]
    if any(ran[k] == 0 for k in expected) or \
            any(v for k, v in ran.items() if k not in expected):
        raise AssertionError(f"the kernel path ran {ran}, expected exactly "
                             f"{expected}")
    if cfg.family in ("xlstm", "hybrid") and \
            {k: v for k, v in ran.items() if v} != conv_launches(cfg):
        raise AssertionError(f"the kernel path ran {ran}, expected "
                             f"{conv_launches(cfg)}")
    zero_launches()
    with plain_path():
        p_loss, p_grads = loss_and_grads()
    if any(read_launches().values()):
        raise AssertionError("the plain path launched a kernel")
    loss_err = abs(k_loss.item() - p_loss.item()) / abs(p_loss.item())
    worst, worst_leaf = 0.0, None
    for k, ref in p_grads.items():
        scale = ref.abs().max().item()
        e = (k_grads[k] - ref).abs().max().item() / max(scale, 1e-30)
        if e > worst:
            worst, worst_leaf = e, k
    del model, params, k_grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()
    if loss_err > 1e-5 or worst > TRAIN_PARITY_TOL:
        raise AssertionError(f"kernel-path training differs from the plain "
                             f"path: loss {loss_err}, gradient {worst} at "
                             f"{worst_leaf}")
    return {"arch": cfg.name, "schedule": schedule,
            "pallas_schedule": cfg.pallas_schedule, "layers": layers,
            "rows": 2,
            "seq_len": seq_len, "dtype": "float32", "tf32": "off",
            "loss_kernel": k_loss.item(), "loss_plain": p_loss.item(),
            "loss_rel_err": loss_err, "loss_tolerance": 1e-5,
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_leaf,
            "grad_tolerance": f"{TRAIN_PARITY_TOL} · max|ref| per leaf",
            "launches_kernel_path": ran}


KERNEL_GROUPS = (("scan_step_bwd_kernel", "scan bwd step #5"),
                 ("scan_step_fwd_kernel", "scan fwd step #3"),
                 ("heads_bwd_kernel", "heads scan bwd #9"),
                 ("heads_fwd_chunked_kernel", "heads scan fwd #7"),
                 ("heads_dual_kernel", "heads scan fwd dual #8"),
                 ("scan_bwd_", "scan bwd #6"),     # carry, combine, chunk
                 ("scan_fwd_kernel", "scan fwd #4"),
                 ("conv1d_pack_bwd_dx", "conv dx #2"),
                 ("conv1d_pack_fwd", "conv fwd #1"),
                 ("gemm", "matmul"), ("nvjet", "matmul"),
                 ("xmma", "matmul"), ("cutlass", "matmul"),
                 ("reduce", "reductions"), ("index", "index/gather"),
                 ("scatter", "index/gather"), ("gather", "index/gather"),
                 ("elementwise", "elementwise"), ("vectorized", "elementwise"),
                 ("copy", "copies"))


def kernel_group(name):
    low = name.lower()
    return next((g for key, g in KERNEL_GROUPS if key in low), "other")


# a launch of each counted kernel leaves this many device records in a trace,
# under this group (#6 runs its carry, combine and chunk kernels)
RECORDS_PER_LAUNCH = {"conv1d_pack_fwd": ("conv fwd #1", 1),
                      "conv1d_pack_bwd_dx": ("conv dx #2", 1),
                      "selective_scan_fwd": ("scan fwd #4", 1),
                      "selective_scan_bwd": ("scan bwd #6", 3),
                      "selective_scan_fwd_step": ("scan fwd step #3", 1),
                      "selective_scan_bwd_step": ("scan bwd step #5", 1),
                      "selective_scan_heads_fwd": ("heads scan fwd #7", 1),
                      "selective_scan_heads_fwd_dual":
                          ("heads scan fwd dual #8", 1),
                      "selective_scan_heads_bwd": ("heads scan bwd #9", 1)}
PROFILE_TRACES = 3   # traces taken at most until one holds every launch
LAYER_MARK = "layer:"  # the record_function ranges of ``layer_ranges``


def merge_spans(spans):
    """The union of (start, end) intervals as sorted disjoint ones."""
    spans = sorted(spans)
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a > merged[-1][1]:
            merged.append([a, b])
        else:
            merged[-1][1] = max(merged[-1][1], b)
    return merged


def overlap_us(x, y):
    """Time two unions of intervals both cover."""
    i = j = 0
    tot = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        tot += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tot


def trace_call(fn):
    """``fn()`` under ``torch.profiler``: its result, its wall time on the
    host's clock (ending in a device sync), its device events (kernels,
    copies, sets), and ``marks``: for each kind that ``layer_ranges``
    marked in the call, the host ms its ranges cover (their union) and
    the device ms and count of the events launched inside them, each
    placed by the start of the op the trace links it to (an event linked
    to no op is placed nowhere), and under ``None`` the count of device
    events linked to an op. The marks' own device-side records are not
    device events."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(LAYER_MARK)]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    spans = {}
    for e in ops:
        if e.name.startswith(LAYER_MARK):
            spans.setdefault(e.name[len(LAYER_MARK):], []).append(
                (e.time_range.start, e.time_range.end))
    marks = {}
    if spans:
        spans = {k: merge_spans(v) for k, v in spans.items()}
        marks = {k: {"host_ms": sum(b - a for a, b in m) / 1e3,
                     "device_ms": 0.0, "events": 0} for k, m in spans.items()}
        linked = 0
        for e in ops:
            ks = [x for x in e.kernels if not x.name.startswith(LAYER_MARK)]
            linked += len(ks)
            t = e.time_range.start
            for k, m in spans.items():
                i = bisect.bisect_right(m, [t, float("inf")]) - 1
                if ks and i >= 0 and t <= m[i][1]:
                    marks[k]["device_ms"] += sum(x.duration for x in ks) / 1e3
                    marks[k]["events"] += len(ks)
        marks[None] = linked
    return out, wall_ms, kernels, marks


def profile_call(fn, launches_per_call, setup=None):
    """``fn()`` under ``torch.profiler``: device time by kernel group and by
    kernel (the trace's CUDA events), and the device's busy share — the
    union of kernel intervals over the call's host-clock wall time, which
    the profiler's own host overhead lengthens. Where the events lie on
    more than one CUDA stream, each stream's kernels and busy time, and
    the time kernels of the two busiest streams ran at once.

    ``setup()``, where given, runs before each trace, outside it. The
    launch counters run through the traced call and must equal
    ``launches_per_call`` (a dict, or a function of ``fn``'s result that
    gives it). The trace must then name each counted kernel as often as it
    launched. The profiler can lose a few device records of a call (on an
    H100 one mamba2-370m step's trace held 18609 to 18629 device events
    between runs of the same program, and once one #7 launch too few), so
    a trace that lacks a launch the counters saw is set aside, with what
    it lacked, and the call traced again, up to ``PROFILE_TRACES`` times,
    or until two traces in a row lack the same records (a loss that
    repeats, as the hybrid's and xLSTM's training steps lose one #1
    record in every trace, would repeat in a third);
    ``records_complete`` says whether the trace reported names every
    launch. Where ``fn`` runs in ``layer_ranges``, ``by_layer_kind``
    gives each kind's host and device ms (``trace_call``'s marks) and
    their shares of the call's wall and of its device events' ms.
    Returns (``fn``'s last result, the profile)."""
    set_aside = []
    for _ in range(PROFILE_TRACES):
        if setup is not None:
            setup()
        zero_launches()
        out, wall_ms, kernels, marks = trace_call(fn)
        launches = read_launches()
        want = launches_per_call(out) if callable(launches_per_call) \
            else launches_per_call
        if launches != want:
            raise AssertionError(f"the profiled call launched {launches}, "
                                 f"where {want} were due")
        if not kernels:
            return out, {"measured": False,
                         "why": "the trace holds no device events"}
        named = {}
        for e in kernels:
            g = kernel_group(e.name)
            named[g] = named.get(g, 0) + 1
        lacks = {g: n * launches[k] - named.get(g, 0)
                 for k, (g, n) in RECORDS_PER_LAUNCH.items()
                 if launches[k] and named.get(g, 0) != n * launches[k]}
        if not lacks:
            break
        set_aside.append({"kernels": len(kernels), "lacks": lacks})
        if len(set_aside) > 1 and set_aside[-2]["lacks"] == lacks:
            break          # the same records lost twice: a systematic loss
    by_name, by_group, calls, by_stream = {}, {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + us, c + 1)
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
        calls[g] = calls.get(g, 0) + 1
        sid = getattr(e, "device_resource_id", None)
        by_stream.setdefault(e.thread if sid is None else sid, []).append(
            (e.time_range.start, e.time_range.end))
    merged = merge_spans(sum(by_stream.values(), []))
    busy = sum(b - a for a, b in merged)
    window = merged[-1][1] - merged[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    prof = {
        "measured": True, "wall_ms": wall_ms,
        "kernel_ms_sum": sum(v[0] for v in by_name.values()) / 1e3,
        "busy_ms": busy / 1e3, "busy_share_of_wall": busy / 1e3 / wall_ms,
        "busy_share_of_kernel_window": busy / max(window, 1e-9),
        "kernels": len(kernels), "launches": launches,
        "traces_set_aside": set_aside, "records_complete": not lacks,
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "by_group_calls": calls,
        "top_kernels": [[name[:90], us / 1e3, n] for name, (us, n) in top]}
    if marks:
        device_ms = prof["kernel_ms_sum"]
        prof["events_linked_to_an_op"] = marks.pop(None)
        prof["by_layer_kind"] = {k: dict(
            m, host_share_of_wall=m["host_ms"] / wall_ms,
            device_share=m["device_ms"] / max(device_ms, 1e-9))
            for k, m in marks.items()}
    if len(by_stream) > 1:
        streams = sorted(((sid, len(sp), merge_spans(sp))
                          for sid, sp in by_stream.items()),
                         key=lambda t: -t[1])
        prof["streams"] = {str(sid): {"kernels": n, "busy_ms": sum(
            b - a for a, b in m) / 1e3} for sid, n, m in streams}
        prof["two_stream_overlap_ms"] = overlap_us(streams[0][2],
                                                   streams[1][2]) / 1e3
    return out, prof


@contextlib.contextmanager
def resolver_clock(on):
    """While ``on``: the host seconds and calls of the scan wrappers' tune
    resolution (``kernels/ops.py`` ``_resolve_tune``) and the cache
    lookups its per-key memo did not answer (``TuneCache._find``)."""
    got = {"calls": 0, "s": 0.0, "uncached": 0}
    if not on:
        yield got
        return
    from repro_torch.kernels import ops as kops
    from repro_torch.tune.cache import TuneCache
    resolve, find = kops._resolve_tune, TuneCache._find

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return resolve(*a, **k)
        finally:
            got["s"] += time.perf_counter() - t
            got["calls"] += 1

    def counted(self, *a, **k):
        got["uncached"] += 1
        return find(self, *a, **k)

    kops._resolve_tune, TuneCache._find = timed, counted
    try:
        yield got
    finally:
        kops._resolve_tune, TuneCache._find = resolve, find


def count_card_step(step_fn, state, batch):
    """One more training step under the step counter
    (``repro_torch.roofline.counter``), its batch on the card first, the
    launch counters set to 0 just before and read just after: the
    ``roofline`` phase holds this count to the meta dry run of the same
    cell. Returns the count, its launches and its seconds."""
    import torch
    from repro_torch.roofline.counter import count_call
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    (_, metrics), work = count_call(step_fn, state, dev, device="cuda")
    float(metrics["loss"])
    torch.cuda.synchronize()
    work["seconds"] = time.perf_counter() - t0
    work["launches"] = {k: v for k, v in read_launches().items() if v}
    return work


def phase_train(arch="mamba-1.4b", rows=2, steps=TIMED_STEPS, schedule=None,
                pad=True, tune=None):
    """The training main path at ``arch``'s full width and depth, ``rows``
    × 4096 packed, the Mamba-1 scan on ``schedule`` (the config's
    ``pallas_schedule`` when None), or on the winner of the tuning cache
    ``tune`` (forward + backward sweeps, as the training launcher sets);
    with ``pad``, 2 steps in ``pad`` mode after the pack steps."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if schedule is not None:
        cfg = dataclasses.replace(cfg, pallas_schedule=schedule)
    if tune is not None:
        cfg = dataclasses.replace(cfg, scan_tune=tune,
                                  tune_objective="fwdbwd")
    model = LM(cfg)
    opt = AdamW(cosine_schedule(3e-4, warmup=1, total=steps + 3))
    trainer = Trainer(model, opt, train_loader(cfg, "pack", rows=rows),
                      TrainerConfig(steps=1))
    state, warm = trainer.train(
        torch.Generator(device="cuda").manual_seed(0), verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    trainer.cfg.steps = 1 + steps
    with resolver_clock(tune is not None) as resolver:
        t0 = time.perf_counter()
        state, hist = trainer.train(state=state, start_step=1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.n_layers
    conv, dx, fwd, bwd = path_kernels(cfg, rows=rows)
    want = {k: 0 for k in launches}
    want.update({conv: 2 * L * steps,               # forward + recompute
                 dx: L * steps, fwd: 2 * L * steps, bwd: L * steps})
    want.pop(None, None)                            # a plain tuned winner
    if launches != want:
        raise AssertionError(f"training launched {launches}, remat='unit' "
                             f"over {L} layers × {steps} steps implies "
                             f"{want}")
    losses = [warm[0]["loss"]] + [h["loss"] for h in hist]
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    step_ms = sum(h["step_ms"] for h in hist)
    real = sum(h["real_tokens"] for h in hist)
    buf = sum(h["buffer_tokens"] for h in hist)
    batch = trainer.loader.batch(1 + steps)

    def one_step():
        nonlocal state
        state, metrics = trainer.step_fn(state, batch)
        float(metrics["loss"])

    _, profiled = profile_call(one_step, {k: v // steps
                                          for k, v in launches.items()})
    work = count_card_step(trainer.step_fn, state, batch)
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "remat": cfg.remat, "pallas_schedule": cfg.pallas_schedule,
           "scan_tune": "off" if tune is None else "cache",
           "scan_kernels": [fwd, bwd],
           "rows": rows, "seq_len": 4096, "mode": "pack",
           "warmup_steps": 1, "timed_steps": steps, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "ms_per_step": step_ms / steps,
           "step_ms": [h["step_ms"] for h in hist],
           "data_ms_per_step": sum(h["data_ms"] for h in hist) / steps,
           "real_tok_per_s": real / step_ms * 1e3,
           "buffer_tok_per_s": buf / step_ms * 1e3,
           "real_fraction": real / buf, "timed_wall_s": wall,
           "max_memory_allocated_gib": peak, "launches": launches,
           "launches_per_step": {k: v // steps for k, v in
                                 launches.items()},
           "profile": profiled, "work": work}
    if tune is not None:
        out["tune_resolver"] = {
            "resolves_per_step": resolver["calls"] / steps,
            "host_us_per_step": resolver["s"] * 1e6 / steps,
            "host_us_per_resolve": resolver["s"] * 1e6 /
            max(1, resolver["calls"]),
            "uncached_lookups": resolver["uncached"]}
    if pad:
        # the paper's comparison (a smoke reading): one sequence per row
        padt = Trainer(model, opt, train_loader(cfg, "pad", rows=rows),
                       TrainerConfig(steps=2))
        state, phist = padt.train(state=state, verbose=False)
        pad_ms = sum(h["step_ms"] for h in phist)
        out.update({
            "pad_losses": [h["loss"] for h in phist],
            "pad_ms_per_step": pad_ms / len(phist),
            "pad_real_tok_per_s": sum(h["real_tokens"] for h in phist)
            / pad_ms * 1e3,
            "pad_real_fraction": sum(h["real_tokens"] for h in phist)
            / sum(h["buffer_tokens"] for h in phist)})
        del padt
    del state, trainer, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def phase_parity(model_bf16, cfg, tol=PARITY_TOL, layers=None,
                 lens=(37, 90, 18, 61), cap=128):
    """An f32 copy's ``prefill_packed`` end logits and every state leaf of
    prompts of ``lens`` tokens, packed first fit into 2 rows of ``cap``,
    against per-prompt ``prefill`` (a cache of ``cap`` tokens): the worst
    max |Δ| / max(1, max |ref|) of each, within ``tol``. With ``layers``
    (a dict), each state leaf's worst layer by layer is put in it and
    printed (a ``parity_layers`` line) before the check."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.models.lm import LM
    f32 = LM(dataclasses.replace(cfg, dtype="float32"))
    f32.load_state_dict(model_bf16.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    pb = packing.pack(prompts, cap, policy="first_fit", num_rows=2)
    ends = packing.segment_ends(pb, 4)
    logits, states, seg_lens = f32.prefill_packed(
        {"tokens": pb.tokens, "positions": pb.positions,
         "segment_ids": pb.segment_ids}, ends, cap)
    worst = dict.fromkeys(["logits", *states], 0.0)
    by_layer = {k: [0.0] * len(v) for k, v in states.items()}
    for r, ids in enumerate(pb.seq_ids):
        for s, i in enumerate(ids):
            n = len(prompts[i])
            assert int(seg_lens[r, s]) == n
            lg, cache, _ = f32.prefill(
                {"tokens": prompts[i][None],
                 "positions": np.arange(n, dtype=np.int32)[None],
                 "segment_ids": np.ones((1, n), np.int32)}, cap)
            pairs = [("logits", logits[r, s], lg[0])] + [
                (k, v[:, r, s], cache[k][:, 0]) for k, v in states.items()]
            for k, got, ref in pairs:
                e = ((got - ref).abs().max() /
                     ref.abs().max().clamp(min=1.0)).item()
                worst[k] = max(worst[k], e)
                for j in range(len(by_layer.get(k, ()))):
                    by_layer[k][j] = max(by_layer[k][j], (
                        (got[j] - ref[j]).abs().max()
                        / ref[j].abs().max().clamp(min=1.0)).item())
    assert torch.isfinite(logits).all()
    del f32
    torch.cuda.empty_cache()
    if layers is not None:
        layers.update(by_layer)
        emit("parity_layers", arch=cfg.name, tolerance=tol,
             worst_by_layer=by_layer)
    if max(worst.values()) > tol:
        raise AssertionError(f"packed prefill differs from per-prompt "
                             f"prefill: {worst} > {tol}")
    return worst


def conv_layers(cfg):
    """The layers of ``cfg`` that run #1 in a forward: every Mamba, mLSTM
    and RG-LRU layer (an sLSTM or attention block has no conv)."""
    from repro_torch.models.blocks import layer_kinds
    return sum(k not in ("slstm", "attn") for k in layer_kinds(cfg))


def conv_launches(cfg, steps=1):
    """#1's and #2's launches in ``steps`` training steps of ``cfg``: #1
    once per conv layer, twice under ``remat="unit"`` (the forward and its
    recompute in the backward), #2 once."""
    n = conv_layers(cfg) * steps
    return dict(zip(CONV_KERNELS, ((2 if cfg.remat == "unit" else 1) * n,
                                   n)))


def phase_engine(model, cfg, n_requests=12, new_tokens=16, seed=0, long=0,
                 max_len=None, check=None):
    """The engine on ``n_requests`` greedy prompts of 16–200 tokens (and,
    with ``long``, one of ``long`` tokens after the eighth, through the
    chunk lane), 8 slots of ``max_len`` (by default 2048 with ``long``,
    else 512): #1 exactly ``conv_layers(cfg)`` × (prefills + chunk
    rounds), no other kernel, every logit finite. ``check(prompts,
    outputs)``, where given, runs after and its dict joins the result."""
    import torch
    finite = []

    def checked(name):
        call = getattr(model, name)

        def run(*a, **k):
            out = call(*a, **k)
            finite.append(torch.isfinite(out[0]).all())
            return out
        return run

    # the engine's forwards probed for finite logits, for this phase only
    checks = ("prefill_packed", "prefill_chunk", "decode_step")
    for name in checks:
        setattr(model, name, checked(name))
    try:
        out, prompts, outs = _engine_run(model, cfg, n_requests, new_tokens,
                                         seed, long, max_len, finite)
    finally:
        for name in checks:
            delattr(model, name)
    if check is not None:
        out.update(check(prompts, outs))
    return out


def _engine_run(model, cfg, n_requests, new_tokens, seed, long, max_len,
                finite):
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    kw = dict(num_slots=8, max_len=max_len or (2048 if long else 512),
              buckets=(64, 128, 256), prefill_rows=2, max_segments=4)
    rng = np.random.default_rng(seed)
    warm = ServeEngine(model, **kw)               # cuBLAS and allocator warm-up
    for n in (20, 150) + ((300,) if long else ()):
        warm.submit(rng.integers(1, cfg.vocab, size=n), 2)
    warm.run()
    del warm
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 201, size=n_requests)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in lens]
    if long:
        prompts.insert(8, rng.integers(1, cfg.vocab, size=long))
        lens = np.insert(lens, 8, long)
    engine = ServeEngine(model, **kw)
    for p in prompts:
        engine.submit(p, new_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    zero_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts.pop("conv1d_pack_fwd")
    if any(counts.values()):
        raise AssertionError(f"serving launched training kernels: {counts}")
    st = engine.stats
    assert all(engine.status[r] == "done" for r in outs), engine.status
    assert [len(outs[r]) for r in sorted(outs)] == [new_tokens] * len(lens)
    assert bool(torch.stack(finite).all()), "non-finite logits"
    if bool(long) != bool(st.chunk_rounds):
        raise AssertionError(f"{st.chunk_rounds} chunk rounds with a long "
                             f"prompt of {long}")
    forwards = st.prefills + st.chunk_rounds
    if forwards == 0 or launches != conv_layers(cfg) * forwards:
        raise AssertionError(f"conv1d_pack launched {launches} times for "
                             f"{forwards} forwards × {conv_layers(cfg)} "
                             f"layers")
    return {"requests": len(lens), "max_len": kw["max_len"],
            "prompt_lens": [int(n) for n in lens],
            "generated": st.generated, "wall_s": wall,
            "tok_per_s": st.generated / wall,
            "ttft_p50_ms": st.ttft_percentiles()["p50"],
            "prefills": st.prefills, "midflight_refills":
            st.midflight_refills, "decode_steps": st.decode_steps,
            "chunk_rounds": st.chunk_rounds,
            "prefill_ms_per_prefill": st.prefill_ms / st.prefills,
            "decode_ms_per_step": st.decode_ms / st.decode_steps,
            "host_ms": st.host_ms,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "conv1d_pack_launches": launches}, prompts, outs


def phase_tune_sweep(cache, spec):
    """One sweep of the tuner (``runner.sweep``, the launchers' timing) at
    the key ``spec`` on the card, its winner put in ``cache``: every
    candidate's best µs, and the probe µs of those pruned; every kernel
    candidate must have been measured."""
    from repro_torch.tune import runner, space
    t0 = time.perf_counter()
    import torch
    spec = dict(spec)
    k = space.shape_key(spec.pop("op"), **spec)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    ranked, pruned = runner.sweep(k, rounds=TUNE_ROUNDS, verbose=True)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    ran = [n for n, _, _ in ranked]
    kernel = [space.candidate_name(c) for c in space.kernel_candidates(k)]
    if not kernel or any(n not in ran for n in kernel):
        raise AssertionError(f"the sweep at {k.encode()} measured {ran}; "
                             f"its kernel candidates are {kernel}")
    name, knobs, us = ranked[0]
    cache.put(k, knobs, us, candidates=len(ranked), kernels=True)
    seen = set(ran) | {n for n, _, _ in pruned}
    return {"key": k.encode(), "rounds": TUNE_ROUNDS,
            "candidates_us": {n: t for n, _, t in ranked},
            "pruned_probe_us": {n: t for n, _, t in pruned},
            "prune_factor": runner.PRUNE_FACTOR,
            "dropped": [space.candidate_name(c)
                        for c in space.space_for(k, include_pallas=True)
                        if space.candidate_name(c) not in seen],
            "kernel_candidates": kernel, "winner": name,
            "winner_knobs": knobs, "winner_us": us,
            "alloc_retries": retries, "seconds": time.perf_counter() - t0}


def phase_tune(tr, eng):
    """Sweep both models' layer shapes into a cache file in a temporary
    directory, train mamba-1.4b with ``scan_tune=<that file>``, and serve
    it with tuning on (the engine sweeps its prefill buckets); ``tr`` and
    ``eng`` are the untuned ``train`` and ``engine`` results of this run."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.tune import cache as tcache
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "TUNE_CACHE_torch.json")
        cache = tcache.get_cache(path)
        sweeps = []
        for spec in TUNE_SWEEPS:
            sweeps.append(phase_tune_sweep(cache, spec))
            emit("tune_sweep", **sweeps[-1])
        cache.save()
        win = sweeps[0]["winner_knobs"]
        want = list(SCAN_KERNELS[win["schedule"]]) \
            if win["backend"] == "pallas" else [None, None]
        tt = phase_train(tune=path, pad=False)
        tt["winner_knobs"] = win
        prof = tt.pop("profile")
        if tt["scan_kernels"] != want:
            raise AssertionError(f"the tuned step ran {tt['scan_kernels']}, "
                                 f"the winner's kernels are {want}")
        emit("train_tuned", **tt,
             untuned={"ms_per_step": tr["ms_per_step"],
                      "real_tok_per_s": tr["real_tok_per_s"],
                      "pallas_schedule": tr["pallas_schedule"]})
        emit("train_tuned_profile", **prof)
        cfg = dataclasses.replace(get_config("mamba-1.4b"), scan_tune=path)
        model = LM(cfg)
        model.init(torch.Generator(device=model.device).manual_seed(0))
        t1 = time.perf_counter()
        et = phase_engine(model, cfg)
        serve_keys = sorted(k for k in cache.entries
                            if k.startswith("selective_scan|") and
                            not k.endswith("fwdbwd") and "|L4096|" not in k)
        emit("engine_tuned", arch=cfg.name, dtype=cfg.dtype,
             layers=cfg.n_layers, **et,
             seconds_with_sweeps=time.perf_counter() - t1,
             bucket_winners={k: cache.entries[k] for k in serve_keys},
             untuned={"ttft_p50_ms": eng["ttft_p50_ms"],
                      "tok_per_s": eng["tok_per_s"],
                      "prefill_ms_per_prefill":
                          eng["prefill_ms_per_prefill"]})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return tt, time.perf_counter() - t0


def roofline_path(path, tr, peaks, knobs=None):
    """One training path's roofline: the meta dry run of its cell (the
    config, rows × 4096, the scan's schedule or the tuning winner
    ``knobs``) held to the count of one real step on the card
    (``tr["work"]``, from ``phase_train``): FLOPs by unit and bytes equal,
    the kernel tally equal to the launch counters' per-step counts; then
    MFU, the bound and the memory estimate beside what ``phase_train``
    measured."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.roofline.analysis import mfu
    cfg = dataclasses.replace(get_config(tr["arch"]),
                              pallas_schedule=tr["pallas_schedule"])
    rec = count_step(cfg, "train", tr["rows"], tr["seq_len"], peaks, knobs)
    work = tr["work"]
    dry = {"flops_by_unit": rec["flops_by_unit"],
           "bytes": rec["bytes_per_device"], "kernels": rec["kernels"]}
    card = {k: work[k] for k in dry}
    if dry != card:
        raise AssertionError(f"{path}: the step counted on the card, "
                             f"{card}, is not its meta dry run, {dry}")
    per_step = {k: v for k, v in tr["launches_per_step"].items() if v}
    if not work["kernels"] == work["launches"] == per_step:
        raise AssertionError(f"{path}: the counter's kernel tally "
                             f"{work['kernels']}, the counted step's "
                             f"launches {work['launches']} and the timed "
                             f"steps' {per_step} differ")
    rl = rec["roofline"]
    bound_s = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
    step_s = tr["ms_per_step"] / 1e3
    mem = rec["memory"]
    kernel_bytes = sum(v for k, v in rec["traffic_by_op"].items()
                       if k in per_step)
    return {"path": path, "arch": tr["arch"], "layers": tr["layers"],
            "rows": tr["rows"], "seq_len": tr["seq_len"],
            "scan_kernels": tr["scan_kernels"],
            "model_flops": rl["model_flops"],
            "ms_per_step": tr["ms_per_step"],
            "mfu": mfu(rl["model_flops"], step_s, peaks),
            "flops": rl["flops"], "flops_by_unit": rec["flops_by_unit"],
            "bytes": rec["bytes_per_device"],
            "t_compute_ms": rl["t_compute_s"] * 1e3,
            "t_memory_ms": rl["t_memory_s"] * 1e3,
            "bound_ms": bound_s * 1e3, "dominant": rl["dominant"],
            "measured_over_bound": step_s / bound_s,
            "useful_flops_ratio": rl["useful_flops_ratio"],
            "roofline_fraction": rl["roofline_fraction"],
            "traffic_by_op": rec["traffic_by_op"],
            "kernel_share_of_bytes": kernel_bytes / rec["bytes_per_device"],
            "kernels_per_step": rec["kernels"],
            "dry_run_argument_gib": mem["argument_size_in_bytes"] / 2 ** 30,
            "dry_run_temp_gib": mem["temp_size_in_bytes"] / 2 ** 30,
            "dry_run_temp_plus_argument_gib": (
                mem["argument_size_in_bytes"]
                + mem["temp_size_in_bytes"]) / 2 ** 30,
            "max_memory_allocated_gib": tr["max_memory_allocated_gib"],
            "counted_step_peak_gib": work["peak_bytes"] / 2 ** 30,
            "counted_card_step_s": work["seconds"],
            "dry_run_s": rec["build_s"] + rec["count_s"]}


def phase_roofline(smi, peaks, paths):
    """The roofline of each training path this run measured (``paths``:
    {name: (phase_train's result, tuning winner knobs or None)}), from the
    port's ``roofline`` package, against this card's ``peaks``;
    meanwhile ``python -m repro_torch.launch.dryrun --arch`` over the
    paper's four configs (``dryrun.PAPER``; ``--paper`` would add the
    assigned configs, whose xlstm-125m cells take minutes on the meta
    device) and all four shapes into a temporary directory in a subprocess
    (no card visible to it: the dry run is meta only), and
    ``report.baseline`` and ``report.kernel`` of its records."""
    import torch
    from repro_torch.launch.dryrun import PAPER
    from repro_torch.roofline import report
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    emit("roofline_card", kind=name, smi=smi, peaks=peaks)
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   CUDA_VISIBLE_DEVICES="")
        paper = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             *PAPER, "--out", tmp, "--card", name], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            for path, (tr, knobs) in paths.items():
                emit("roofline", **roofline_path(path, tr, peaks, knobs))
            t_paths = time.perf_counter() - t0
            out, err = paper.communicate(timeout=300)
        finally:
            if paper.poll() is None:
                paper.kill()
                paper.communicate()
        if paper.returncode != 0:
            raise AssertionError(f"the paper configs' dry run exited "
                                 f"{paper.returncode}: {err[-2000:]}")
        recs = []
        for fn in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, fn)) as f:
                recs.append(json.load(f))
        status = {s: sum(r["status"] == s for r in recs)
                  for s in ("ok", "skip", "error")}
        if status["error"] or status["ok"] != 16:
            raise AssertionError(f"the paper configs' dry run records: "
                                 f"{status}; {out[-2000:]}")
        baseline, kernel = report.baseline(tmp), report.kernel(tmp)
    print(baseline, flush=True)
    return {"card": name, "paper_records": status,
            "baseline": baseline.splitlines(),
            "kernel": kernel.splitlines(), "paths_s": t_paths,
            "seconds": time.perf_counter() - t0}


def phase_checkpoint(smi, arch="mamba-1.4b", layers=CKPT_LAYERS,
                     seq_len=4096, device="cuda"):
    """Kill and resume (phase 11 of the module docstring): runs A
    (straight), B (SIGTERM, emergency save) and C (restore, finish); raises
    unless the emergency save is marked, the restored state is bitwise the
    saved one, C's losses are bitwise A's and the trace validates."""
    import signal
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    from repro_torch.obs import Obs
    from repro_torch.obs.check import check_trace
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    obs = Obs.on()

    def trainer(loader=None, ckpt_dir=None, every=0):
        opt = AdamW(cosine_schedule(3e-4, warmup=1, total=CKPT_STEPS))
        return Trainer(LM(cfg, device), opt,
                       loader or train_loader(cfg, "pack", seq_len),
                       TrainerConfig(steps=CKPT_STEPS, ckpt_every=every,
                                     ckpt_dir=ckpt_dir, keep_ckpts=2),
                       obs=obs)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    class KillAt:
        """The loader, sending this process SIGTERM as it fetches one
        step's batch."""

        def __init__(self, loader, step):
            self.loader, self.step, self.sent = loader, step, False

        def batch(self, step):
            if step == self.step:
                self.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            return self.loader.batch(step)

    def ms_per_step(hist):
        return sum(h["step_ms"] for h in hist) / len(hist)

    with tempfile.TemporaryDirectory() as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        ckpt_dir = os.path.join(tmp, "ckpt")
        ta = trainer()
        n_params = sum(p.numel() for p in ta.model.parameters())
        _, hist_a = ta.train(gen(0), verbose=False)
        del ta
        handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        kill = KillAt(train_loader(cfg, "pack", seq_len), CKPT_KILL_AT)
        tb = trainer(kill, ckpt_dir, every=2)
        try:
            state_b, hist_b = tb.train(gen(0), verbose=False)
        finally:
            for s, h in handlers.items():
                signal.signal(s, h)
        ckpt = tb.ckpt
        steps = ckpt.all_steps()
        meta = ckpt.read_meta(CKPT_KILL_AT + 1)["meta"]
        if not kill.sent or len(hist_b) != CKPT_KILL_AT + 1 or \
                steps != [2, CKPT_KILL_AT + 1] or \
                meta != {"step": CKPT_KILL_AT + 1, "emergency": True}:
            raise AssertionError(
                f"SIGTERM at step {CKPT_KILL_AT} (sent: {kill.sent}): run B "
                f"took {len(hist_b)} steps, published {steps}, the last "
                f"manifest's meta {meta}")
        # the ckpt.* gauges hold the last save's, step 4's periodic one
        met = obs.metrics
        saves, marks = (met.counter(n).value
                        for n in ("ckpt.saves", "ckpt.marks"))
        snapshot_ms, write_s, wait_s, nbytes, emergency_s = (
            met.gauge(n).value for n in (
                "ckpt.snapshot_ms", "ckpt.write_s", "ckpt.wait_s",
                "ckpt.bytes", "train.emergency_save_s"))
        if saves != 2 or marks != 1 or emergency_s > write_s + 0.5:
            raise AssertionError(
                f"run B took {saves} snapshots and {marks} marks (want 2, "
                f"1); its emergency save took {emergency_s} s against the "
                f"last write's {write_s} s")
        tc = trainer(ckpt_dir=ckpt_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state_c, step_c = tc.restore_or_init(gen(1))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        differ = [f"{part}/{k}" for part, a, b in (
            ("params", state_c["params"], state_b["params"]),
            ("m", state_c["opt"].m, state_b["opt"].m),
            ("v", state_c["opt"].v, state_b["opt"].v))
            for k in b if not torch.equal(a[k], b[k])]
        if step_c != CKPT_KILL_AT + 1 or \
                state_c["opt"].step != state_b["opt"].step or differ or \
                (state_c["opt"].master is None) != \
                (state_b["opt"].master is None):
            raise AssertionError(f"the restore of step {step_c} differs "
                                 f"from the saved state: {differ[:5]}, "
                                 f"opt step {state_c['opt'].step} against "
                                 f"{state_b['opt'].step}")
        del state_b, tb
        _, hist_c = tc.train(state=state_c, start_step=step_c, verbose=False)
        losses_a = [h["loss"] for h in hist_a]
        losses_c = [h["loss"] for h in hist_c]
        if losses_c != losses_a[CKPT_KILL_AT + 1:]:
            raise AssertionError(f"the resumed losses {losses_c} differ "
                                 f"from the straight run's "
                                 f"{losses_a[CKPT_KILL_AT + 1:]}")
        trace = os.path.join(tmp, "trace.json")
        obs.export(trace)
        errs = check_trace(trace, require=["train.steps", "ckpt.bytes"],
                           require_spans=["train.step", "train.data",
                                          "ckpt.save", "ckpt.snapshot",
                                          "ckpt.write", "ckpt.mark"])
        taken = len(hist_a) + len(hist_b) + len(hist_c)
        if errs or tc.steps != taken:
            raise AssertionError(f"the trace fails obs.check ({errs}) or "
                                 f"train.steps {tc.steps} != {taken}")
        del state_c, tc
        gc.collect()
        torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
            "d_inner": cfg.d_inner, "d_state": cfg.d_state,
            "vocab": cfg.vocab, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "rows": 2, "seq_len": seq_len,
            "parameters": n_params, "nvidia_smi": smi,
            "ckpt_bytes": nbytes, "tmp_free_gb_before": free_gb,
            "published_steps": steps, "emergency_meta": meta,
            "snapshot_ms": snapshot_ms, "async_write_s": write_s,
            "periodic_wait_s": wait_s, "emergency_save_s": emergency_s,
            "snapshots": saves, "marks": marks,
            "restore_s": restore_s,
            "ms_per_step": {"A": ms_per_step(hist_a),
                            "B": ms_per_step(hist_b),
                            "C": ms_per_step(hist_c)},
            "step_ms": {"A": [h["step_ms"] for h in hist_a],
                        "B": [h["step_ms"] for h in hist_b],
                        "C": [h["step_ms"] for h in hist_c]},
            "losses_a": losses_a, "losses_c": losses_c,
            "resumed_losses_bitwise": True,
            "trace_events": len(obs.tracer.chrome_events()),
            "train_steps_metric": taken,
            "phase_wall_s": time.perf_counter() - t_phase}


def start_cli(module, args, tmp):
    """``python -m module args`` as a subprocess on the card, started now,
    its output to files in ``tmp``. Returns ``wait()``: (returncode,
    stdout, stderr) once it has ended; a process still running after 600 s
    is killed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = os.path.join(tmp, f"cli{len(os.listdir(tmp))}")
    out, err = open(base + ".out", "w+"), open(base + ".err", "w+")
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=env, stdout=out, stderr=err, text=True)

    def wait():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out.seek(0)
        err.seek(0)
        text = (proc.returncode, out.read(), err.read())
        out.close()
        err.close()
        return text
    wait.proc = proc
    return wait


def profile_kernels(prof):
    """The kernel names in a ``--profile-dir``'s Chrome traces: (files,
    kernels)."""
    files = [os.path.join(prof, n) for n in os.listdir(prof)
             if n.endswith(".pt.trace.json")]
    kernels = []
    for f in files:
        with open(f) as fh:
            kernels += [e["name"] for e in json.load(fh)["traceEvents"]
                        if e.get("cat") == "kernel"]
    return files, kernels


def phase_launchers():
    """The launchers as subprocesses on the card, all three started at
    once (each a ``--tiny`` model, none timed): the training launcher with
    checkpoints, an obs trace and a ``torch.profiler`` capture must exit
    0, publish steps 1–3, write a trace that passes ``obs.check`` and a
    profile that names a ``conv1d_pack`` kernel (phase 11's ``launcher``
    line); the serve launcher, sampled, buckets (16, 32) so prompts of up
    to 39 tokens meet the chunk lane, ``--obs-trace`` and
    ``--profile-dir``, must exit 0 with chunk rounds, its trace pass
    ``obs.check`` with the serve spans required and its profile name a
    ``conv1d_pack`` kernel; and again with slice 5c's flags, a shared
    20-token prefix through the cache and greedy requests speculated 3
    tokens a round (phase 12's ``serve_launcher`` line). Returns the two
    lines."""
    from repro_torch.obs.check import check_trace
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, trace, prof, strace, sprof = (
            os.path.join(tmp, n) for n in ("ckpt", "trace.json", "prof",
                                           "serve_trace.json", "serve_prof"))
        train_args = ["--tiny", "--steps", "3", "--rows", "2", "--seq-len",
                      "256", "--ckpt-dir", ckpt, "--ckpt-every", "1",
                      "--obs-trace", trace, "--profile-dir", prof]
        serve_args = ["--tiny", "--requests", "12", "--slots", "4",
                      "--max-len", "96", "--buckets", "16,32",
                      "--temperature", "0.8", "--top-k", "40",
                      "--max-inflight-prefills", "2", "--guard",
                      "--deadline-ms", "60000", "--max-queue", "64",
                      "--obs-trace", strace, "--profile-dir", sprof]
        spec_args = ["--tiny", "--requests", "12", "--slots", "4",
                     "--max-len", "128", "--buckets", "16,32", "--cache-mb",
                     "64", "--shared-prefix", "20", "--spec-k", "3"]
        waits = [start_cli("repro_torch.launch.train", train_args, tmp),
                 start_cli("repro_torch.launch.serve", serve_args, tmp),
                 start_cli("repro_torch.launch.serve", spec_args, tmp)]
        try:
            (rc, out, err), (src, sout, serr), (rc2, out2, err2) = \
                [w() for w in waits]
        finally:
            for w in waits:
                if w.proc.poll() is None:
                    w.proc.kill()
                    w.proc.wait()
        wall = time.perf_counter() - t0

        # the training launcher
        if rc != 0:
            raise AssertionError(f"the launcher exited {rc}: {err[-2000:]}")
        steps = sorted(os.listdir(ckpt))
        errs = check_trace(trace, require=["train.steps"],
                           require_spans=["train.step", "train.data"])
        files, kernels = profile_kernels(prof)
        conv = [k for k in kernels if "conv1d_pack" in k]
        if steps != ["step_1", "step_2", "step_3"] or errs or not conv:
            raise AssertionError(f"the launcher published {steps}; its "
                                 f"trace: {errs}; its profile's kernels "
                                 f"naming conv1d_pack: {len(conv)} of "
                                 f"{len(kernels)} in {len(files)} file(s)")
        train_line = {
            "cmd": "repro_torch.launch.train " + " ".join(train_args),
            "published_steps": steps, "trace_ok": True,
            "profile_files": len(files), "profile_kernels": len(kernels),
            "profile_conv1d_pack_kernels": len(conv),
            "stdout_tail": out.strip().splitlines()[-3:],
            "seconds": wall, "beside": "the two serve launcher runs"}

        # the serve launcher
        if src != 0:
            raise AssertionError(f"the serve launcher exited {src}: "
                                 f"{serr[-2000:]}")
        last = json.loads(sout.strip().splitlines()[-1])
        errs = check_trace(
            strace, require=["serve.prefills", "serve.decode_steps",
                             "serve.chunk_rounds", "serve.ttft_ms"],
            require_spans=["serve.step", "prefill_dispatch", "prefill_land",
                           "chunk_slab", "decode_step", "queued", "prefill",
                           "chunk", "decode"])
        sfiles, skernels = profile_kernels(sprof)
        sconv = [k for k in skernels if "conv1d_pack" in k]
        lifecycle = [last[k] for k in ("shed", "expired", "cancelled",
                                       "quarantined", "prefill_faults")]
        if errs or not sconv or not last["chunk_rounds"] or \
                not last["guard"] or any(lifecycle):
            raise AssertionError(f"the serve launcher's trace: {errs}; its "
                                 f"profile's conv1d_pack kernels: "
                                 f"{len(sconv)} of {len(skernels)}; {last}")
        if rc2 != 0:
            raise AssertionError(f"the serve launcher with the cache and "
                                 f"spec flags exited {rc2}: {err2[-2000:]}")
        last2 = json.loads(out2.strip().splitlines()[-1])
        if last2["cache"]["hits"] < 11 or not last2["spec"]["rounds"] or \
                last2["generated"] != 12 * 16 or \
                "prefix cache: StateCache(" not in out2:
            raise AssertionError(f"the serve launcher's cache and spec "
                                 f"flags: {last2}")
    serve_line = {
        "cmd": "repro_torch.launch.serve " + " ".join(serve_args),
        "trace_ok": True, "profile_files": len(sfiles),
        "profile_kernels": len(skernels),
        "profile_conv1d_pack_kernels": len(sconv), "result": last,
        "cmd_cache_spec": "repro_torch.launch.serve " + " ".join(spec_args),
        "result_cache_spec": last2, "seconds": wall,
        "beside": "the training launcher and each other"}
    return train_line, serve_line


def serve_mix(cfg, seed=0):
    """Phase 12's requests, in submit order: 16 prompts of 16–200 tokens
    (every fourth sampled at ``SERVE_SAMPLED``, the rest greedy) and one
    greedy prompt of ``SERVE_LONG`` tokens after the eighth."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 201, size=16)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)) for n in lens]
    long = rng.integers(1, cfg.vocab, size=SERVE_LONG)
    mix = []
    for i, p in enumerate(prompts):
        mix.append((p, dict(SERVE_SAMPLED) if i % 4 == 3 else {}))
        if i == 7:
            mix.append((long, {}))
    return mix


def phase_conv_slab(peaks, shape=CHUNK_SLAB_SHAPE, packed=False):
    """#1 at a chunk lane's slab (``shape``, bf16): the carried conv tail
    at W-1 leading zero positions, then a mid-prompt slab at global
    positions 512.. (``blocks._conv_resume``); with ``packed``, a packed
    prefill's rows (``packed_positions``) instead. Against the plain
    version, twice bitwise, timed beside it, cuDNN and its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d_pack as kconv
    B, L, D = shape
    g = torch.Generator(device="cuda").manual_seed(L)
    x = torch.randn((B, L, D), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((4, D), generator=g, device="cuda").mul(0.5).to(
        torch.bfloat16)
    b = torch.randn((D,), generator=g, device="cuda").to(torch.bfloat16)
    if packed:
        pos = torch.as_tensor(packed_positions(B, L, L), device="cuda")
    else:
        pos = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        pos[:, 3:] = torch.arange(512, 512 + L - 3, dtype=torch.int32)
    y = kconv.conv1d_pack(x, w, b, pos)
    again = kconv.conv1d_pack(x, w, b, pos)
    want = kconv.conv1d_pack_plain(x.float(), w.float(), b.float(), pos)
    torch.cuda.synchronize()
    err = (y.float() - want).abs()
    if not torch.equal(y, again) or not bool(
            (err <= 2.0 ** -8 * want.abs() + 1e-6).all()):
        raise AssertionError(f"conv1d_pack at {shape}: bitwise "
                             f"repeat {torch.equal(y, again)}, max err "
                             f"{err.max().item()}")
    xc = x.transpose(1, 2).contiguous()
    wc = w.t().contiguous()[:, None, :]
    lib = lambda: F.conv1d(xc, wc, b, padding=3, groups=D)
    kern = lambda: kconv.conv1d_pack(x, w, b, pos)
    plain = lambda: kconv.conv1d_pack_plain(x, w, b, pos)
    bound, by = conv_bound_ms(x, w, peaks)
    return {"kernel": "conv1d_pack_fwd", "shape": list(shape),
            "dtype": "bfloat16", "max_abs_err": err.max().item(),
            "tolerance": "2^-8 relative (one bf16 rounding)",
            "bitwise_repeat": True, "launch": kconv.LAST_LAUNCH,
            "kernel_ms": graph_ms(kern), "plain_ms": graph_ms(plain),
            "library_ms": graph_ms(lib), "bound_ms": bound, "bound_by": by,
            "kernel_eager_ms": eager_ms(kern)}


def phase_chunk_parity(model_bf16, cfg):
    """An f32 copy prefills one ``CHUNK_PARITY_LEN``-token prompt whole
    (``prefill``) and in ``SERVE_CHUNK``-token slabs (``prefill_chunk``):
    end logits and conv/SSM states within ``PARITY_TOL``; the slabs
    launch #1 once a layer each and no other kernel."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.models.lm import LM
    f32 = LM(dataclasses.replace(cfg, dtype="float32"))
    f32.load_state_dict(model_bf16.state_dict())
    n = CHUNK_PARITY_LEN
    p = np.random.default_rng(2).integers(1, cfg.vocab, size=n).astype(
        np.int32)
    lg, whole, _ = f32.prefill(
        {"tokens": p[None], "positions": np.arange(n, dtype=np.int32)[None],
         "segment_ids": np.ones((1, n), np.int32)})
    cache = f32.init_cache(1)
    clen = torch.zeros(1, dtype=torch.int32, device=f32.device)
    spans = packing.chunk_spans(n, SERVE_CHUNK)
    zero_launches()
    for off, take in spans:
        batch = packing.suffix_slab({0: (p, off, take)}, 1, SERVE_CHUNK)
        lg_c, cache, clen = f32.prefill_chunk(cache, batch, clen)
    torch.cuda.synchronize()
    counts = read_launches()
    conv = counts.pop("conv1d_pack_fwd")
    worst = {}
    for k, got, ref in (("logits", lg_c[0], lg[0]),
                        ("conv", cache["conv"], whole["conv"]),
                        ("ssm", cache["ssm"], whole["ssm"])):
        worst[k] = ((got - ref).abs().max()
                    / ref.abs().max().clamp(min=1.0)).item()
    del f32, cache, whole
    torch.cuda.empty_cache()
    if conv != cfg.n_layers * len(spans) or any(counts.values()) or \
            int(clen[0]) != n or max(worst.values()) > PARITY_TOL:
        raise AssertionError(f"{cfg.name} chunked prefill: {worst} (bar "
                             f"{PARITY_TOL}), #1 {conv} launches for "
                             f"{len(spans)} slabs, others {counts}, "
                             f"consumed {int(clen[0])}")
    return {"arch": cfg.name, "dtype": "float32", "tf32": "off",
            "prompt": n, "slab": SERVE_CHUNK, "slabs": len(spans),
            "tolerance": PARITY_TOL, "max_rel_err": worst,
            "conv1d_pack_launches": conv,
            "conv1d_pack_launches_per_slab": conv // len(spans)}


def sampled_reference(model, record, prompt, rid, slot, knobs, n_slots):
    """A sampled request replayed through the model's own calls: its
    packed round again (``prefill_packed`` on the recorded batch: the same
    inputs, so the same logits and states), its first token drawn from its
    segment's logits with its stream (``sample_tokens``), its state in a
    fresh cache of ``n_slots`` rows at the slot the engine gave it, and
    ``SERVE_NEW`` - 1 steps of ``decode_step_sample``. Returns its tokens;
    None when the recorded round does not hold the prompt."""
    import numpy as np
    import torch
    from repro_torch.models import blocks as B
    batch = {k: torch.as_tensor(v).cpu().numpy() for k, v in record[0].items()}
    ends = torch.as_tensor(record[1]).cpu().numpy()
    S = ends.shape[1]
    k = None
    for r, s in zip(*np.nonzero(ends >= 0)):
        e = int(ends[r, s])
        a = e - len(prompt) + 1
        if a >= 0 and batch["positions"][r, a] == 0 and np.array_equal(
                batch["tokens"][r, a:e + 1], prompt):
            k = int(r) * S + int(s)
    if k is None:
        return None
    dev = model.device

    def knob_rows(n, i):
        arrs = (np.zeros(n, np.int64), np.zeros(n, np.float32),
                np.zeros(n, np.int64), np.ones(n, np.float32))
        for a, v in zip(arrs, (B.request_streams(0, [rid])[0],
                               knobs["temperature"], knobs["top_k"],
                               knobs["top_p"])):
            a[i] = v
        return [torch.as_tensor(a, device=dev) for a in arrs]

    logits, states, _ = model.prefill_packed(batch, ends)
    K = ends.size
    stream, temp, topk, topp = knob_rows(K, k)
    tok, _ = model.sample_tokens(
        logits.reshape(K, -1), stream,
        torch.zeros(K, dtype=torch.int64, device=dev), temp, topk, topp)
    out = [int(tok[k])]
    cache = model.init_cache(n_slots)
    model.scatter_into_cache(cache, states, [k], [slot])
    stream, temp, topk, topp = knob_rows(n_slots, slot)
    ctr = torch.ones(n_slots, dtype=torch.int64, device=dev)
    cur = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
    cur[slot, 0] = tok[k]
    for _ in range(SERVE_NEW - 1):
        t, _, cache, ctr = model.decode_step_sample(cache, cur, stream, ctr,
                                                    temp, topk, topp)
        out.append(int(t[slot]))
        cur = t[:, None]
    return out


def phase_serve(model, cfg):
    """Phase 12: the scheduler-v2 engine on ``cfg`` at full width and depth
    (bf16): ``serve_mix``'s 17 requests on ``SERVE_SLOTS`` slots, buckets
    (64, 128, 256), 2 × 4 segments a round, the TTFT bucket policy at
    ``SERVE_TTFT_MS``, one chunk row of ``SERVE_CHUNK``.

    A warm-up run, then overlap on (two prefills in flight on the side
    stream) and overlap off (one, synchronous), each with the launch
    counters set to 0 just before and read just after. A round's numerics
    depend on its layout (the packed scan's chunks, the matmuls' shapes),
    so the two runs must pack the same rounds for their streams to be
    compared bitwise: with more slots than requests every round admits
    the FIFO prefix that fits whatever the free count, and with the target
    above every wait no time rule picks a bucket or admits early (asserted:
    no early admit, no deferred upgrade). Each sampled stream is then
    replayed (``sampled_reference``) at the slot the engine gave it. Then
    the padded wave (``decode_batch``) against the continuous engine on 8
    of the prompts, one profiled decode step (greedy and sampled), one
    profiled prefill round, and the first steps of an overlapped run
    profiled for prefill and decode kernels on two streams at once."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    mix = serve_mix(cfg)
    kw = dict(num_slots=SERVE_SLOTS, max_len=2048, buckets=(64, 128, 256),
              prefill_rows=2, max_segments=4, bucket_policy="ttft",
              target_ttft_ms=SERVE_TTFT_MS, chunk_size=SERVE_CHUNK)
    finite, records, slot_of, landings = [], [], {}, []
    calls = {n: getattr(model, n) for n in ("prefill_packed", "decode_step",
                                            "prefill_chunk")}

    def checked(name):
        def fn(*a, **k):
            out = calls[name](*a, **k)
            finite.append(torch.isfinite(out[0]).all())
            if name == "prefill_packed":
                records.append((a[0], a[1]))
            return out
        return fn

    for n in calls:
        setattr(model, n, checked(n))

    def engine(**over):
        """An engine that records each request's slot, and for each packed
        prefill the decode steps it waited and its host ms from dispatch
        to landing (where its first tokens are observed)."""
        eng = ServeEngine(model, **dict(kw, **over))
        act, refill, land = eng._activate, eng._try_refill, eng._land_one
        sent = {}

        def activate(slot, req, now, first):
            slot_of[req.rid] = slot
            act(slot, req, now, first)

        def try_refill():
            sent[eng.stats.prefills] = time.perf_counter()
            return refill()

        def land_one(inf):
            land(inf)
            landings.append((inf["steps_waited"], (
                time.perf_counter() - sent[inf["pidx"]]) * 1e3))

        eng._activate, eng._try_refill = activate, try_refill
        eng._land_one = land_one
        return eng

    def timed(overlap, inflight):
        eng = engine(overlap=overlap, max_inflight_prefills=inflight)
        for p, knobs in mix:
            eng.submit(p, SERVE_NEW, **knobs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        finite.clear()
        records.clear()
        slot_of.clear()
        landings.clear()
        zero_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        st = eng.stats
        conv = counts.pop("conv1d_pack_fwd")
        bad = [r for r in outs if eng.status[r] != "done"
               or len(outs[r]) != SERVE_NEW]
        if bad or not bool(torch.stack(finite).all()) or \
                any(counts.values()) or \
                conv != cfg.n_layers * (st.prefills + st.chunk_rounds) or \
                st.chunk_rounds != -(-SERVE_LONG // SERVE_CHUNK) or \
                st.early_admits or st.deferred_upgrades:
            raise AssertionError(
                f"serve (overlap={overlap}): unfinished {bad}, #1 {conv} "
                f"for {st.prefills} prefills + {st.chunk_rounds} chunk "
                f"rounds × {cfg.n_layers}, others {counts}; {st!r}")
        pct, ipct = st.ttft_percentiles(), st.itl_percentiles()
        return outs, list(records), dict(slot_of), {
            "overlap": overlap, "max_inflight_prefills": inflight,
            "wall_s": wall, "generated": st.generated,
            "tok_per_s": st.generated / wall,
            "ttft_p50_ms": pct["p50"], "ttft_p95_ms": pct["p95"],
            "itl_p50_ms": ipct["p50"], "itl_p95_ms": ipct["p95"],
            "decode_ms_per_step": st.decode_ms / st.decode_steps,
            "prefill_ms_per_round": st.prefill_ms / st.prefills,
            "chunk_ms_per_round": st.chunk_ms / st.chunk_rounds,
            "host_ms": st.host_ms, "prefills": st.prefills,
            "decode_steps": st.decode_steps,
            "midflight_refills": st.midflight_refills,
            "overlapped_prefills": st.overlapped_prefills,
            "bucket_upgrades": st.bucket_upgrades,
            "chunk_rounds": st.chunk_rounds,
            "chunked_prefills": st.chunked_prefills,
            "buckets": sorted(st.buckets),
            "prefill_steps_waited": [w for w, _ in landings],
            "prefill_dispatch_to_land_ms": [ms for _, ms in landings],
            "conv1d_pack_launches": conv,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2 ** 30}

    try:
        timed(True, 2)                            # warm-up
        on_outs, on_records, on_slots, on = timed(True, 2)
        off_outs, _, _, off = timed(False, 1)
        if on["overlapped_prefills"] == 0:
            raise AssertionError("no prefill stayed in flight across a "
                                 "decode step")
        differ = [r for r in on_outs if on_outs[r] != off_outs[r]]
        if differ:
            raise AssertionError(f"overlap on and off give different "
                                 f"streams for requests {differ}")
        refs = {}
        for rid, (p, knobs) in enumerate(mix):
            if not knobs:
                continue
            ref = next(filter(None, (
                sampled_reference(model, rec, p, rid, on_slots[rid], knobs,
                                  SERVE_SLOTS) for rec in on_records)))
            refs[rid] = ref == on_outs[rid]
            if not refs[rid]:
                raise AssertionError(f"sampled request {rid}: engine "
                                     f"{on_outs[rid]} != replay {ref}")
    finally:
        for n, fn in calls.items():
            setattr(model, n, fn)

    # the padded wave against the continuous engine, on 8 greedy prompts
    eight = [p for p, knobs in mix if not knobs and len(p) <= 256][:8]
    wave_cont = {"wave": [], "continuous": []}
    for kind in ("continuous", "wave", "wave", "continuous"):
        eng = ServeEngine(model, num_slots=8, max_len=512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "wave":
            outs = eng.decode_batch(eight, SERVE_NEW)
        else:
            for p in eight:
                eng.submit(p, SERVE_NEW)
            outs = list(eng.run().values())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert [len(o) for o in outs] == [SERVE_NEW] * 8
        wave_cont[kind].append(8 * SERVE_NEW / wall)

    # profiles: one decode step (greedy; sampled), one prefill round, and
    # an overlapped run's first steps (prefills in flight beside decode);
    # the counters hold each to the kernels it launched (decode: none)
    none = {k: 0 for k in read_launches()}
    held = []

    def fresh(**kw_eng):
        def setup():
            while held:
                held.pop().run()          # drain a set-aside trace's engine
            held.append(ServeEngine(model, **kw_eng))
        return setup

    def decode_setup(sampled):
        def setup():
            fresh(num_slots=SERVE_SLOTS, max_len=512, overlap=False,
                  refill_threshold=1)()
            for p, knobs in mix:
                if len(p) <= 256:
                    held[0].submit(p, SERVE_NEW,
                                   **(knobs if sampled else {}))
            while held[0].queue:
                held[0].step()
        return setup

    profiles = {}
    for name, sampled in (("decode_step_greedy", False),
                          ("decode_step_sampled", True)):
        _, prof_d = profile_call(lambda: held[0]._decode_step(), none,
                                 setup=decode_setup(sampled))
        profiles[name] = dict(prof_d, active=len(held[0]._active_slots()),
                              slots=SERVE_SLOTS)

    def prefill_setup():
        fresh(num_slots=8, max_len=512, overlap=False)()
        for p in eight:
            held[0].submit(p, SERVE_NEW)

    _, prof_p = profile_call(lambda: held[0]._try_refill(),
                             dict(none, conv1d_pack_fwd=cfg.n_layers),
                             setup=prefill_setup)
    profiles["prefill_round"] = dict(
        prof_p, prompts=held[0].stats.prefill_tokens, rows=2,
        bucket=sorted(held[0].stats.buckets))

    def overlap_setup():
        fresh(**dict(kw, overlap=True, max_inflight_prefills=2))()
        for p, knobs in mix:
            held[0].submit(p, SERVE_NEW, **knobs)

    def first_steps(n=8):
        st = held[0].stats
        before = st.prefills + st.chunk_rounds
        for _ in range(n):
            held[0].step()
        return st.prefills + st.chunk_rounds - before

    _, prof_o = profile_call(
        first_steps,
        lambda rounds: dict(none, conv1d_pack_fwd=cfg.n_layers * rounds),
        setup=overlap_setup)
    eng = held.pop()
    profiles["overlapped_steps"] = dict(
        prof_o, steps=8,
        side_stream=None if eng._side is None else eng._side.stream_id)
    eng.run()
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "slots": SERVE_SLOTS,
            "requests": len(mix),
            "prompt_lens": [len(p) for p, _ in mix],
            "sampled": [r for r, (_, k) in enumerate(mix) if k],
            "target_ttft_ms": SERVE_TTFT_MS, "on": on, "off": off,
            "streams_bitwise_equal": True, "sampled_replays_equal": refs,
            "padded_wave_tok_per_s": wave_cont["wave"],
            "continuous_tok_per_s": wave_cont["continuous"],
            "profiles": profiles}


def engine_kw():
    """Phase 12's engine settings (overlap on, two prefills in flight)."""
    return dict(num_slots=SERVE_SLOTS, max_len=2048, buckets=(64, 128, 256),
                prefill_rows=2, max_segments=4, bucket_policy="ttft",
                target_ttft_ms=SERVE_TTFT_MS, chunk_size=SERVE_CHUNK,
                overlap=True, max_inflight_prefills=2)


def phase_lifecycle(model, cfg, smi):
    """Phase 13: the request lifecycle on phase 12's engine and mix (module
    docstring). Every run has the launch counters set to 0 just before it
    and read just after: #1 n_layers × (packed prefills that ran + chunk
    rounds), nothing else."""
    import torch
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.faults import EngineKilled, FaultPlan
    from repro_torch.launch.serve import ServeEngine
    t_phase = time.perf_counter()
    mix = serve_mix(cfg)
    kw = engine_kw()

    def engine(**over):
        eng = ServeEngine(model, **dict(kw, **over))
        for p, knobs in mix:
            eng.submit(p, SERVE_NEW, **knobs)
        torch.cuda.synchronize()
        zero_launches()
        return eng

    def launches(eng):
        torch.cuda.synchronize()
        counts = read_launches()
        conv = counts.pop("conv1d_pack_fwd")
        st = eng.stats
        ran = st.prefills - st.prefill_faults + st.chunk_rounds
        if any(counts.values()) or conv != cfg.n_layers * ran:
            raise AssertionError(f"lifecycle: #1 {conv} for {ran} forwards "
                                 f"× {cfg.n_layers}, others {counts}")
        return conv

    def timed(**over):
        eng = engine(**over)
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats
        return eng, outs, {
            "guard": eng.guard, "wall_s": wall, "tok_per_s":
            st.generated / wall, "decode_ms_per_step":
            st.decode_ms / st.decode_steps, "decode_steps": st.decode_steps,
            "ttft_p50_ms": st.ttft_percentiles()["p50"],
            "conv1d_pack_launches": launches(eng)}

    # the guard off and on, empty plan: the same streams
    guard_runs, clean = [], None
    for guard in (False, True, True, False):
        eng, outs, row = timed(guard=guard, faults=FaultPlan())
        if any(eng.status[r] != "done" or len(outs[r]) != SERVE_NEW
               for r in outs):
            raise AssertionError(f"lifecycle guard={guard}: {eng.status}")
        if clean is None:
            clean = outs
        elif outs != clean:
            raise AssertionError(f"lifecycle: guard={guard} changed streams "
                                 f"{[r for r in outs if outs[r] != clean[r]]}")
        guard_runs.append(row)

    # one greedy decode step profiled with the guard off and on (16 of 24
    # slots active, as phase 12's profile): the guard's device cost, which
    # the host-bound step's wall hides; the counters hold each to no launch
    # of the nine kernels
    held, guard_profiles = [], []

    def decode_setup(guard):
        def setup():
            while held:
                held.pop().run()
            eng = ServeEngine(model, num_slots=SERVE_SLOTS, max_len=512,
                              overlap=False, refill_threshold=1, guard=guard)
            for p, _ in mix:
                if len(p) <= 256:
                    eng.submit(p, SERVE_NEW)
            while eng.queue:
                eng.step()
            held.append(eng)
        return setup

    none = {k: 0 for k in read_launches()}
    for guard in (False, True, True, False):
        _, prof = profile_call(lambda: held[0]._decode_step(), none,
                               setup=decode_setup(guard))
        guard_profiles.append(dict(
            {k: prof.get(k) for k in ("busy_ms", "kernels", "wall_ms",
                                      "traces_set_aside")},
            guard=guard, active=len(held[0]._active_slots())))
    while held:
        held.pop().run()

    # one decode slot, one prefill segment and one chunk row poisoned, one
    # prefill failed: those requests fail, every other stream is clean's
    eng, outs, fault_row = timed(faults=FaultPlan(**LIFE_PLAN))
    st = eng.stats
    kinds = {"non-finite decode logits": 0, "non-finite prefill state": 0,
             "non-finite chunked-prefill state": 0,
             "prefill dispatch 2 failed": 0}
    for r, e in eng.errors.items():
        kinds[next(k for k in kinds if k in e)] += 1
    failed = sorted(r for r, s in eng.status.items() if s == "failed")
    differ = [r for r in outs if r not in failed and outs[r] != clean[r]]
    if not eng.guard or differ or st.quarantined != 3 or \
            st.prefill_faults != 1 or min(kinds.values()) < 1 or \
            len(failed) != sum(kinds.values()) or \
            any(eng.status[r] != "done" for r in outs if r not in failed):
        raise AssertionError(f"lifecycle faults: failed {failed}, kinds "
                             f"{kinds}, streams differ {differ}; {st!r}")
    fault_row.update(failed=failed, errors=kinds, quarantined=st.quarantined,
                     prefill_faults=st.prefill_faults,
                     prefills=st.prefills, chunk_rounds=st.chunk_rounds)

    # kill before decode step LIFE_KILL_AT, snapshots every 4 steps, restore
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        eng = engine(faults=FaultPlan(kill_at_step=LIFE_KILL_AT))
        snaps, steps = [], 0
        try:
            while True:
                if steps % LIFE_SNAP_EVERY == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.snapshot(mgr, step=steps, blocking=True)
                    snaps.append({
                        "step": steps,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "device_to_host_ms": mgr._g_snap.value,
                        "write_s": mgr._g_write.value,
                        "bytes": mgr._g_bytes.value})
                steps += 1
                if not eng.step():
                    raise AssertionError("lifecycle: the kill never fired")
        except EngineKilled:
            pass
        state_bytes = sum(t.numel() * t.element_size() for t in [
            v for v in eng._device_state().values() if torch.is_tensor(v)]
            + list(eng.cache.values()) + list(eng.chunk_cache.values()))
        del eng
        meta = mgr.read_meta(mgr.latest_step())["meta"]
        fresh = ServeEngine(model, **kw)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        restored = fresh.restore(mgr)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        outs = fresh.run()
        resumed_conv = launches(fresh)
    mid_chunk = meta["chunks"][0]
    if outs != clean or mid_chunk is None or \
            not 0 < mid_chunk["off"] < SERVE_LONG:
        raise AssertionError(
            f"lifecycle restore of step {restored}: streams differ for "
            f"{[r for r in clean if outs.get(r) != clean[r]]}; chunk row "
            f"{mid_chunk and mid_chunk['off']}")
    kill = {"kill_at_step": LIFE_KILL_AT, "snapshots": snaps,
            "restored_step": restored, "restore_ms": restore_ms,
            "resumed": len(fresh.resumed),
            "chunk_row_off_at_snapshot": mid_chunk["off"],
            "device_state_bytes": state_bytes,
            "conv1d_pack_launches_after_restore": resumed_conv,
            "streams_bitwise_equal": True}

    # cancel a request whose prefill is in flight on the side stream: at
    # the first pooled dispatch whose event has not fired yet; a second run
    # takes the first pooled one if no event was still pending (the host
    # can take as long to issue a prefill as the card to run it)
    for pending_only in (True, False):
        eng = engine()
        refill, picked = eng._try_refill, {}

        def try_refill():
            issued = refill()
            if issued and "rid" not in picked and eng._prefill_pool:
                inf = eng._prefill_pool[-1]
                pending = inf["event"] is not None and \
                    not inf["event"].query()
                if pending or not pending_only:
                    picked.update(inf=inf, slot=inf["slot_of"][0][0],
                                  pending=pending,
                                  rid=inf["admitted"][0].rid)
                    eng.cancel(picked["rid"])
            return issued

        eng._try_refill = try_refill
        while eng.step():
            inf = picked.get("inf")
            if inf is not None and \
                    all(x is not inf for x in eng._prefill_pool):
                holder = eng.slot_req[picked["slot"]]
                if holder is not None and holder.rid == picked["rid"]:
                    raise AssertionError("lifecycle: a cancelled request "
                                         "took its slot at landing")
                picked["inf"] = None
        if "rid" in picked:
            break
    target = (picked["rid"], picked["slot"])
    event_pending = picked["pending"]
    launches(eng)
    rid = target[0]
    differ = [r for r in clean if r != rid and eng.outputs[r] != clean[r]]
    if eng.status[rid] != "cancelled" or eng.outputs[rid] or differ or \
            eng.stats.cancelled != 1:
        raise AssertionError(f"lifecycle cancel of {rid}: "
                             f"{eng.status[rid]}, differ {differ}")
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "slots": SERVE_SLOTS, "requests": len(mix), "card": smi,
            "guard_runs": guard_runs, "guard_streams_bitwise_equal": True,
            "guard_decode_profiles": guard_profiles,
            "faults": dict(fault_row, plan=repr(FaultPlan(**LIFE_PLAN))),
            "kill_restore": kill,
            "cancel_in_flight": {"rid": rid, "slot": target[1],
                                 "event_pending_at_cancel": event_pending,
                                 "others_bitwise_equal": True},
            "phase_wall_s": time.perf_counter() - t_phase}


def prefix_mix(cfg, n=PREFIX_REQUESTS, seed=1):
    """Phase 14's requests: one ``PREFIX_LEN``-token system prompt, then a
    16–200 token suffix each (greedy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab, size=PREFIX_LEN)
    return [np.concatenate([shared, rng.integers(1, cfg.vocab, size=int(k))])
            for k in rng.integers(16, 201, size=n)]


def timed_engine(model, cfg, eng, submit):
    """``submit(eng)``, then ``eng.run()`` with every launch counter set to
    0 just before and read just after: #1 exactly ``conv_layers(cfg)`` ×
    the forwards that ran (packed prefills and chunk rounds), nothing
    else. Returns (outputs, the run's numbers)."""
    import torch
    submit(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    conv = counts.pop("conv1d_pack_fwd")
    st = eng.stats
    ran = st.prefills - st.prefill_faults + st.chunk_rounds
    if any(counts.values()) or conv != conv_layers(cfg) * ran:
        raise AssertionError(f"{cfg.name}: #1 {conv} for {ran} forwards × "
                             f"{conv_layers(cfg)}, others {counts}; {st!r}")
    pct, ipct = st.ttft_percentiles(), st.itl_percentiles()
    return outs, {
        "wall_s": wall, "generated": st.generated,
        "tok_per_s": st.generated / wall, "ttft_p50_ms": pct.get("p50"),
        "ttft_p95_ms": pct.get("p95"), "itl_p50_ms": ipct.get("p50"),
        "prefills": st.prefills, "chunk_rounds": st.chunk_rounds,
        "chunk_tokens": st.chunk_tokens, "decode_steps": st.decode_steps,
        "quarantined": st.quarantined, "conv1d_pack_launches": conv,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_prefix_cache(model, cfg, smi, n=PREFIX_REQUESTS, full=True):
    """Phase 14a: the prefix cache on phase 12's engine. ``n`` greedy
    requests share a declared ``PREFIX_LEN``-token system prompt
    (``prefix_mix``), ``SERVE_NEW`` new tokens each. Cold (no cache),
    warm (an empty cache: the first request stores the prefix, the others
    restore it and prefill their suffix), then a rerun on the warm cache
    (every prompt a whole-prompt hit). Prompts and the prefix are
    multiples of the 256-token slab apart, so the three runs cut the same
    slabs and their streams must be bitwise equal; the rerun runs no
    forward (0 prefills, 0 chunk rounds, 0 #1 launches) and the warm run
    #1 48 × its chunk rounds. With ``full``, on the first quarter of the
    requests: an LRU budget of ``PREFIX_LRU_ENTRIES`` entries (evictions,
    streams bitwise),
    ``poison_cache_hit=[1]`` (one request quarantined, the rest bitwise),
    ``drop_cache`` (streams bitwise), and the host cost of an insert and
    of a hit, timed alone."""
    import torch
    from repro_torch.faults import FaultPlan
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.state_cache import (StateCache, cache_row,
                                                host_row, load_cache_row,
                                                row_finite)
    t_phase = time.perf_counter()
    prompts = prefix_mix(cfg, n)
    one = model.init_cache(1, engine_kw()["max_len"])
    entry_bytes = sum(t.numel() * t.element_size() for t in one.values()) \
        + cfg.vocab * 4
    del one

    def run(sc, ps=prompts, **over):
        def submit(eng):
            for p in ps:
                eng.submit(p, SERVE_NEW, prefix_len=PREFIX_LEN)

        eng = ServeEngine(model, state_cache=sc, **dict(engine_kw(), **over))
        c0 = {} if sc is None else {k: getattr(sc, k) for k in (
            "hits", "misses", "inserts", "evictions")}
        outs, row = timed_engine(model, cfg, eng, submit)
        if sc is not None:
            row["cache"] = dict({k: getattr(sc, k) - v
                                 for k, v in c0.items()},
                                entries=len(sc), bytes=sc.nbytes)
        return eng, outs, row

    def same(name, outs, skip=()):
        differ = [r for r in outs if r not in skip and outs[r] != cold[r]]
        if differ:
            raise AssertionError(f"prefix cache {name}: streams differ from "
                                 f"the cold run for {differ}")

    _, cold, cold_row = run(None)
    if any(len(o) != SERVE_NEW for o in cold.values()):
        raise AssertionError(f"prefix cache cold: {cold}")
    sc = StateCache(64 * entry_bytes)
    weng, warm, warm_row = run(sc)
    same("warm", warm)
    _, rerun, rerun_row = run(sc)
    same("rerun", rerun)
    if warm_row["prefills"] or warm_row["cache"]["hits"] < n - 1 or \
            warm_row["conv1d_pack_launches"] != \
            conv_layers(cfg) * warm_row["chunk_rounds"] or \
            rerun_row["prefills"] or rerun_row["chunk_rounds"] or \
            rerun_row["conv1d_pack_launches"] or \
            rerun_row["cache"]["hits"] != n:
        raise AssertionError(f"prefix cache: warm {warm_row}, rerun "
                             f"{rerun_row}")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "slots": SERVE_SLOTS, "requests": n, "prefix_len": PREFIX_LEN,
           "prompt_lens": [len(p) for p in prompts], "card": smi,
           "entry_bytes": entry_bytes, "cold": cold_row, "warm": warm_row,
           "rerun": rerun_row, "streams_bitwise_equal": True}
    if full:
        # the LRU and fault runs on the first quarter of the requests (rids
        # 0..n/4-1, the same prompts, so the same streams as cold's)
        few = prompts[:n // 4]
        eng, outs, lru = run(StateCache(PREFIX_LRU_ENTRIES * entry_bytes),
                             few)
        same("LRU", outs)
        if not lru["cache"]["evictions"]:
            raise AssertionError(f"prefix cache LRU: no eviction {lru}")
        eng, outs, pois = run(StateCache(64 * entry_bytes), few,
                              faults=FaultPlan(poison_cache_hit=[1]))
        failed = [r for r, st in eng.status.items() if st == "failed"]
        same("poisoned", outs, skip=failed)
        if len(failed) != 1 or pois["quarantined"] != 1 or \
                "quarantined" not in eng.errors[failed[0]]:
            raise AssertionError(f"prefix cache poison: {eng.errors}")
        pois["failed"] = failed
        eng, outs, drop = run(StateCache(64 * entry_bytes), few,
                              faults=FaultPlan(drop_cache=2))
        same("drop_cache", outs)
        if not drop["cache"]["evictions"]:
            raise AssertionError(f"prefix cache drop: {drop}")

        # the host cost of one insert (copy to pinned memory, the sync,
        # the finiteness guard) and of one hit (copy to the card into a
        # slot), each the median of 5 timed alone
        entry = next(iter(sc._entries.values()))
        row = cache_row(weng.cache, 0)

        def ms(fn, reps=5):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)[reps // 2]

        def insert():
            h = host_row(row)
            torch.cuda.current_stream().synchronize()
            if not row_finite(h, entry.logits):
                raise AssertionError("prefix cache: a stored row is not "
                                     "finite")

        def copy_only():
            host_row(row)

        out.update(
            lru=dict(lru, budget_entries=PREFIX_LRU_ENTRIES,
                     requests=len(few)),
            poison_cache_hit=pois, drop_cache=drop,
            insert_ms=ms(insert), insert_copy_ms=ms(copy_only),
            hit_ms=ms(lambda: load_cache_row(
                weng.cache, StateCache.device_state(entry, "cuda"), 0)))
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


def phase_spec_decode(model, cfg, smi):
    """Phase 14b: speculative decode on phase 12's engine: its greedy
    prompts and 4 made of a repeated block (8–32 tokens, 4 times), 16 new
    tokens each, ``spec_k`` = ``SPEC_K`` against off, launch counters
    around each run (#1 only); streams bitwise equal. Then a verify round
    and a plain step on the same 24-slot batch, timed alone (median of 3)
    and profiled (device ms, kernels; none of the nine kernels)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2)
    prompts = [p for p, knobs in serve_mix(cfg) if not knobs] + [
        np.tile(rng.integers(1, cfg.vocab, size=n), 4) for n in (8, 16, 24,
                                                                32)]

    def submit(eng):
        for p in prompts:
            eng.submit(p, SERVE_NEW)

    rows, streams = {}, {}
    for k in (0, SPEC_K):
        eng = ServeEngine(model, spec_k=k, **engine_kw())
        streams[k], rows[k] = timed_engine(model, cfg, eng, submit)
        rows[k].update(spec_k=k, rounds=eng._spec_rounds.value,
                       proposed=eng._spec_proposed.value,
                       accepted=eng._spec_accepted.value,
                       accept_rate=eng.spec_accept_rate)
    differ = [r for r in streams[0] if streams[0][r] != streams[SPEC_K][r]]
    if differ or not rows[SPEC_K]["rounds"]:
        raise AssertionError(f"spec decode: streams differ for {differ}; "
                             f"{rows[SPEC_K]}")

    # verify rounds beside plain steps, on the same batch: the short
    # prompts admitted (16 of 24 slots), then 2 steps; 3 steps timed, the
    # next profiled. A slot's draft is forced where none is found (the
    # verify's cost does not depend on the draft)
    def batch(k):
        eng = ServeEngine(model, num_slots=SERVE_SLOTS, max_len=512,
                          overlap=False, refill_threshold=1, spec_k=k)
        for p in prompts:
            if len(p) <= 256:
                eng.submit(p, SERVE_NEW)
        while eng.queue or eng.stats.decode_steps < 2:
            eng.step()
        if k:
            draft = eng._spec_draft

            def forced():
                d, have = draft()
                have[eng._active_slots()[0]] = True
                return d, have

            eng._spec_draft = forced
        return eng

    none = {name: 0 for name in read_launches()}
    step_rows = {}
    for k in (0, SPEC_K):
        eng, walls = batch(k), []
        active = len(eng._active_slots())
        for _ in range(3):
            r0 = eng._spec_rounds.value
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._decode_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if k and eng._spec_rounds.value != r0 + 1:
                raise AssertionError("spec decode: no verify round ran")
        # the next step of the same batch (a retrace takes the one after)
        _, prof = profile_call(eng._decode_step, none)
        step_rows[k] = {"wall_ms_alone": sorted(walls)[1], "active": active,
                        **{key: prof.get(key) for key in (
                            "wall_ms", "busy_ms", "kernels",
                            "busy_share_of_wall", "traces_set_aside")}}
        del eng
        gc.collect()
    return {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
            "slots": SERVE_SLOTS, "requests": len(prompts), "card": smi,
            "prompt_lens": [len(p) for p in prompts], "spec_k": SPEC_K,
            "off": rows[0], "on": rows[SPEC_K],
            "streams_bitwise_equal": True,
            "plain_step": step_rows[0], "verify_round": step_rows[SPEC_K],
            "phase_wall_s": time.perf_counter() - t_phase}


def xlstm_prefill_round(model, cfg):
    """One packed prefill round of xlstm-125m at the largest bucket (2 ×
    256, 4 prompts a row) beside its two sLSTM layers alone on the same
    shapes: the host-clock ms of each (median of 3, after a warm-up, a
    device sync at the end), the sLSTM loop's share, and the device
    launches of one sLSTM layer (its trace's kernels)."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.models import blocks
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in
               (60, 70, 50, 76, 64, 64, 64, 64)]
    dev = model.device
    pb = packing.pack(prompts, 256, policy="first_fit", num_rows=2)
    ends = torch.as_tensor(packing.segment_ends(pb, 4), device=dev)
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    ctx = blocks.Ctx(positions=torch.as_tensor(pb.positions, device=dev),
                     segment_ids=torch.as_tensor(pb.segment_ids, device=dev))
    x = torch.randn((2, 256, cfg.d_model), device=dev).to(
        getattr(torch, cfg.dtype))
    sl = [p for k, p in zip(model.kinds, model.layers) if k == "slstm"]

    def slstm_layers():
        with torch.no_grad():
            for p in sl:
                blocks.apply_slstm(p, x, ctx, cfg, collect=True,
                                   collect_ends=ends)

    def med(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[1]

    round_ms = med(lambda: model.prefill_packed(batch, ends))
    slstm_ms = med(slstm_layers)
    _, _, events, _ = trace_call(lambda: blocks.apply_slstm(
        sl[0], x, ctx, cfg, collect=True, collect_ends=ends))
    kernels = [e for e in events if not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset")]
    return {"shape": [2, 256], "segments": 8, "round_ms": round_ms,
            "slstm_layers": len(sl), "slstm_ms": slstm_ms,
            "slstm_share": slstm_ms / round_ms,
            "slstm_launches_per_layer": len(kernels),
            "slstm_launches_per_step": len(kernels) / 256}


def phase_xlstm(smi, peaks):
    """Phase 15: xlstm-125m at full width and depth (12 layers, d_model
    768, 4 heads, bf16, random weights from seed 0). #1 at its two shapes
    (the packed prefill's (2, 256, 1536) and the chunk slab's (1, 259,
    1536)) against the plain version, twice bitwise; packed against
    per-prompt prefill (f32, ``XLSTM_PARITY_TOL``); the engine (8 slots,
    12 greedy prompts of 16–200 tokens and one of ``SERVE_LONG`` through
    the chunk lane, 16 new tokens; #1 exactly 10 mLSTM layers × (prefills
    + chunk rounds)); a prefill round and its sLSTM loop's share; the
    prefix cache cold, warm and rerun on ``XLSTM_PREFIX_REQUESTS``
    requests behind phase 14's shared prompt, streams bitwise equal.
    Returns (the phase's line, the two ``kernels`` rows)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    rows = [phase_conv_slab(peaks, shape, packed=shape[0] == 2)
            for shape in XLSTM_CONV_SHAPES]
    cfg = get_config("xlstm-125m")
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    if conv_layers(cfg) != 10:
        raise AssertionError(f"xlstm-125m: {model.kinds}")
    parity = phase_parity(model, cfg, XLSTM_PARITY_TOL)
    eng = phase_engine(model, cfg, long=SERVE_LONG)
    pre = xlstm_prefill_round(model, cfg)
    pc = phase_prefix_cache(model, cfg, smi, n=XLSTM_PREFIX_REQUESTS,
                            full=False)
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "kinds": list(model.kinds),
           "conv_layers": conv_layers(cfg), "card": smi,
           "parity": {"dtype": "float32", "tf32": "off",
                      "tolerance": XLSTM_PARITY_TOL, "max_rel_err": parity},
           "engine": eng, "prefill_round": pre, "prefix_cache": pc,
           "phase_wall_s": time.perf_counter() - t_phase}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


@contextlib.contextmanager
def layer_ranges():
    """While on, a training step marks its layers for ``torch.profiler``
    by kind (``trace_call`` reads the marks; a hybrid layer's MLP as
    ``mlp``), and so do a serving forward (a block's ``collect`` apply)
    and a decode step (its step): each block's forward, its
    ``remat`` recompute included, in a ``record_function`` range
    ``LAYER_MARK`` + kind, and each layer's backward, from the gradient
    reaching its output to its input's, in another of the same name,
    opened and closed by tensor hooks (a layer's input is the layer
    below's output, whose hook closes the range and opens the next; the
    bottom layer's input closes the last). A layer's recompute runs inside
    its own backward range. No device sync: the marks cost a
    ``record_function`` call each, 36 a step of 12 layers."""
    import torch
    from torch.autograd.profiler import record_function
    from repro_torch.models import blocks
    saved = dict(blocks.KINDS)
    bwd = [None]                 # the backward range now open
    outs = []                    # this step's block outputs, hooked

    def edge(kind):
        def hook(grad):
            if bwd[0] is not None:
                bwd[0].__exit__(None, None, None)
            bwd[0] = None if kind is None else \
                record_function(LAYER_MARK + kind)
            if bwd[0] is not None:
                bwd[0].__enter__()
            if kind is None:
                outs.clear()
            return grad
        return hook

    def wrap(kind, apply):
        def marked(p, x, ctx, cfg, *a, **k):
            with record_function(LAYER_MARK + kind):
                out = apply(p, x, ctx, cfg, *a, **k)
            if isinstance(out, tuple):                 # serving: (x, state)
                return out
            if bwd[0] is None and out.requires_grad:   # not a recompute
                if x.requires_grad and not any(x is o for o in outs):
                    x.register_hook(edge(None))        # the bottom input
                out.register_hook(edge(kind))
                outs.append(out)
            return out
        return marked

    for kind, entry in saved.items():
        blocks.KINDS[kind] = (*entry[:2], wrap(kind, entry[2]), entry[3],
                              wrap(kind, entry[4]))
    mlp = blocks.MLP
    blocks.MLP = (*mlp[:2], wrap("mlp", mlp[2]))
    try:
        yield
    finally:
        blocks.KINDS.update(saved)
        blocks.MLP = mlp


def launch_train(*argv):
    """``python -m repro_torch.launch.train`` in this process, on the card:
    its history, and its last printed line (a dict), which must name the
    card, every step and finite losses. What it prints is kept off this
    script's output."""
    import io
    from repro_torch.launch import train as launcher
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist = launcher.main(list(argv))
    last = json.loads(printed.getvalue().strip().splitlines()[-1])
    steps = int(argv[list(argv).index("--steps") + 1])
    if last.get("device") != "cuda" or last.get("steps") != steps or \
            not all(v == v and abs(v) < float("inf")
                    for v in last["losses"]):
        raise AssertionError(f"the launcher ({' '.join(argv)}) gave {last}")
    return hist, last


def phase_xlstm_train(smi, peaks):
    """Phase 16: xLSTM training on the card. (a) #1 and #2 at xlstm-125m's
    training shape ``XLSTM_TRAIN_SHAPE`` (bf16, packed rows) against their
    plain versions, twice bitwise, timed. (b) Training parity: one whole
    unit (5 mLSTM + 1 sLSTM) at full width, f32, 2 × ``XLSTM_PARITY_SEQ``:
    the kernel
    path against the plain path, #1 10 (``remat="unit"``: forward and
    recompute) and #2 5. (c) The training main path, xlstm-125m at full
    width, ``XLSTM_TRAIN_LAYERS`` of its 12 layers, bf16 compute, f32
    params, through the training launcher (``launch_train``: ``Trainer`` +
    AdamW over the packing loader): a warm-up run of one step at 2 ×
    ``XLSTM_SHORT_SEQ`` (the same code and kernels: a 12-layer 2 × 4096
    step takes 38–64 s on an H100), then a run of ``XLSTM_TRAIN_STEPS``
    timed steps at 2 × 4096 with the
    launch counters (exactly ``conv_launches``) and nothing else in them;
    then a model of its own in this process, at the same depth, takes one
    step at 2 × ``XLSTM_SHORT_SEQ`` and profiles the next in
    ``layer_ranges``: the
    sLSTM and mLSTM layers' host and device ms and shares, from that one
    trace. The launch counters over the traced step must equal
    ``conv_launches``; the trace's own records of #1 and #2 are not held
    to them (``records_complete`` says whether it names every launch; a
    lost record of a 2 µs kernel does not move a share). (d) One card
    step at 2 × ``XLSTM_COUNT_SEQ`` counted (``count_card_step``) equal
    to the meta dry run of the same cell in FLOPs by unit and bytes, its
    kernel tally the launch counters'. Returns (the phase's line, the two
    ``kernels`` rows)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.roofline.analysis import mfu, model_flops_per_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    rows = [phase_conv_slab(peaks, XLSTM_TRAIN_SHAPE, packed=True),
            conv_dx_row(XLSTM_TRAIN_SHAPE, torch.bfloat16, peaks)]
    parity = phase_train_parity("xlstm-125m", layers=len(
        get_config("xlstm-125m").unit), seq_len=XLSTM_PARITY_SEQ)
    t_parity = time.perf_counter() - t_phase

    cfg = get_config("xlstm-125m")
    cut = dataclasses.replace(cfg, n_layers=XLSTM_TRAIN_LAYERS)
    B, L, steps = XLSTM_TRAIN_SHAPE[0], XLSTM_TRAIN_SHAPE[1], \
        XLSTM_TRAIN_STEPS
    args = ("--arch", cfg.name, "--rows", str(B), "--layers",
            str(XLSTM_TRAIN_LAYERS))
    whist, _ = launch_train(*args, "--steps", "1", "--seq-len",
                            str(XLSTM_SHORT_SEQ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    hist, last = launch_train(*args, "--steps", str(steps), "--seq-len",
                              str(L))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict({k: 0 for k in launches}, **conv_launches(cut, steps))
    if launches != want:
        raise AssertionError(f"xlstm-125m training launched {launches}, "
                             f"expected {want}")
    losses = [whist[0]["loss"]] + [h["loss"] for h in hist]
    step_ms = sum(h["step_ms"] for h in hist) / steps
    real = sum(h["real_tokens"] for h in hist)
    flops = model_flops_per_step(cut, "train", B, L)

    # the device's view, at a short row: one step of a model of its own
    # (the timed steps' depth), after one untimed step, traced with its
    # layers marked
    model = LM(cut)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, AdamW(cosine_schedule(3e-4, 1, 4)),
                      train_loader(cut, "pack", XLSTM_SHORT_SEQ, B),
                      TrainerConfig(steps=1))
    state, _ = trainer.train(torch.Generator(device="cuda").manual_seed(0),
                             verbose=False)
    pbatch = trainer.loader.batch(1)

    def one_step():
        nonlocal state
        state, metrics = trainer.step_fn(state, pbatch)
        float(metrics["loss"])

    with layer_ranges():
        _, prof = profile_call(one_step, dict(
            {k: 0 for k in launches}, **conv_launches(cut)))
    n_kind = {k: model.kinds.count(k) for k in set(model.kinds)}
    by_kind = prof.get("by_layer_kind", {})
    if sorted(by_kind) != sorted(n_kind):
        raise AssertionError(f"the profiled step marked {sorted(by_kind)}, "
                             f"where the model has {n_kind}")

    # the count of one card step at a short row, held to the meta dry run
    cbatch = train_loader(cut, "pack", XLSTM_COUNT_SEQ, B).batch(0)
    work = count_card_step(trainer.step_fn, state, cbatch)
    dry = count_step(cut, "train", B, XLSTM_COUNT_SEQ, peaks)
    card = {k: work[k] for k in ("flops_by_unit", "bytes", "kernels")}
    meta = {"flops_by_unit": dry["flops_by_unit"],
            "bytes": dry["bytes_per_device"], "kernels": dry["kernels"]}
    if card != meta or not work["kernels"] == work["launches"] == \
            conv_launches(cut):
        raise AssertionError(f"xlstm-125m at {B} × {XLSTM_COUNT_SEQ}: the "
                             f"card step counted {card} with launches "
                             f"{work['launches']}, the meta dry run {meta}")
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "traced_and_counted_layers": cut.n_layers,
        "kinds": n_kind, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "remat": cfg.remat, "card": smi, "kernel_rows": [
            {k: r[k] for k in ("kernel", "shape", "kernel_ms",
                               "kernel_eager_ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by", "max_abs_err")}
            for r in rows],
        "parity": parity, "parity_s": t_parity,
        "launcher": "repro_torch.launch.train " + " ".join(args),
        "timed_layers": XLSTM_TRAIN_LAYERS,
        "rows": B, "seq_len": L, "mode": "pack",
        "warmup": {"seq_len": XLSTM_SHORT_SEQ, "loss": whist[0]["loss"],
                   "step_ms": whist[0]["step_ms"]},
        "timed_steps": steps, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": [h["step_ms"] for h in hist], "ms_per_step": step_ms,
        "real_tok_per_s": real / (step_ms * steps) * 1e3,
        "real_fraction": real / sum(h["buffer_tokens"] for h in hist),
        "timed_wall_s": wall, "launcher_seconds": last["seconds"],
        "model_flops": flops, "mfu": mfu(flops, step_ms / 1e3, peaks),
        "max_memory_allocated_gib": peak,
        "launches_per_step": {k: v // steps for k, v in launches.items()
                              if v},
        "profile_seq_len": XLSTM_SHORT_SEQ, "profile": prof,
        "layers_by_kind": {k: dict(
            by_kind[k], layers=n, events_per_layer_time_step=by_kind[k][
                "events"] / (n * XLSTM_SHORT_SEQ)) for k, n in n_kind.items()},
        "count": {"seq_len": XLSTM_COUNT_SEQ, "card": card,
                  "card_seconds": work["seconds"],
                  "dry_run_s": dry["build_s"] + dry["count_s"],
                  "flops": dry["flops_per_device"],
                  "model_flops": dry["roofline"]["model_flops"]},
        "phase_wall_s": time.perf_counter() - t_phase,
        "phase_budget_s": 150}
    del state, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def phase_hybrid_train(smi, peaks):
    """Phase 17: recurrentgemma-2b trained on the card. (a) #1 and #2 at
    its training shape ``HYBRID_CONV_SHAPE`` (packed rows and a carried
    row), bf16 and f32, against their plain versions, twice bitwise,
    timed beside cuDNN and their bounds. (b) Training parity of one whole
    unit (rec, rec, attn, each with its GeGLU MLP) at full width, f32, 2 ×
    2048: the kernel path against the plain path, #1 exactly 4 (2 rec
    layers, forward and ``remat`` recompute), #2 2. (c) The training main
    path, recurrentgemma-2b at full width and depth (26 layers, d_model
    2560, vocab 256000, tied embedding), bf16 compute, f32 params,
    through the training launcher (``launch_train``): a warm-up run of one
    step at 2 × ``HYBRID_SHORT_SEQ``, then a run of ``HYBRID_TRAIN_STEPS``
    timed steps at 2 × 4096 packed on the paper's lengths, #1 36 and #2
    18 a step and no other kernel; then a model of its own in this
    process takes one step at 2 × ``HYBRID_PROFILE_SEQ`` and profiles the
    next in ``layer_ranges``: device ms by kernel group, the busy share,
    and each sub-block kind's (rec, attn, mlp) host and device ms. (d) One
    card step of that model at 2 × ``HYBRID_COUNT_SEQ`` counted
    (``count_card_step``), equal to the meta dry run of the same cell in
    FLOPs by unit and bytes, its kernel tally the launch counters'.
    Returns (the phase's line, the four ``kernels`` rows)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.roofline.analysis import (active_params, mfu,
                                               model_flops_per_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(conv_fwd_row(HYBRID_CONV_SHAPE, dtype, peaks))
        rows.append(conv_dx_row(HYBRID_CONV_SHAPE, dtype, peaks))
        gc.collect()
    t_rows = time.perf_counter() - t_phase
    cfg = get_config("recurrentgemma-2b")
    parity = phase_train_parity(cfg.name, layers=len(cfg.unit))
    t_parity = time.perf_counter() - t_phase - t_rows

    B, L, steps = HYBRID_CONV_SHAPE[0], HYBRID_CONV_SHAPE[1], \
        HYBRID_TRAIN_STEPS
    args = ("--arch", cfg.name, "--rows", str(B))
    t0 = time.perf_counter()
    whist, _ = launch_train(*args, "--steps", "1", "--seq-len",
                            str(HYBRID_SHORT_SEQ))
    warm_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    hist, last = launch_train(*args, "--steps", str(steps), "--seq-len",
                              str(L))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = dict({k: 0 for k in launches}, **conv_launches(cfg, steps))
    if launches != want:
        raise AssertionError(f"recurrentgemma-2b training launched "
                             f"{launches}, expected {want}")
    losses = [whist[0]["loss"]] + [h["loss"] for h in hist]
    step_ms = sum(h["step_ms"] for h in hist) / steps
    real = sum(h["real_tokens"] for h in hist)
    flops = model_flops_per_step(cfg, "train", B, L)
    gc.collect()
    torch.cuda.empty_cache()

    # the device's view: one step of a model of its own, after one
    # untimed step, traced with its layers marked
    t0 = time.perf_counter()
    model = LM(cfg)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, AdamW(cosine_schedule(3e-4, 1, 4)),
                      train_loader(cfg, "pack", HYBRID_PROFILE_SEQ, B),
                      TrainerConfig(steps=1))
    state, _ = trainer.train(torch.Generator(device="cuda").manual_seed(0),
                             verbose=False)
    pbatch = trainer.loader.batch(1)

    def one_step():
        nonlocal state
        state, metrics = trainer.step_fn(state, pbatch)
        float(metrics["loss"])

    with layer_ranges():
        _, prof = profile_call(one_step, dict(
            {k: 0 for k in launches}, **conv_launches(cfg)))
    n_kind = dict({k: model.kinds.count(k) for k in set(model.kinds)},
                  mlp=cfg.n_layers)
    if sorted(prof.get("by_layer_kind", {})) != sorted(n_kind):
        raise AssertionError(f"the profiled step marked "
                             f"{sorted(prof.get('by_layer_kind', {}))}, "
                             f"where the model has {n_kind}")
    profile_s = time.perf_counter() - t0

    # the count of one card step at a short row, held to the meta dry run
    t0 = time.perf_counter()
    cbatch = train_loader(cfg, "pack", HYBRID_COUNT_SEQ, B).batch(0)
    work = count_card_step(trainer.step_fn, state, cbatch)
    dry = count_step(cfg, "train", B, HYBRID_COUNT_SEQ, peaks)
    card = {k: work[k] for k in ("flops_by_unit", "bytes", "kernels")}
    meta = {"flops_by_unit": dry["flops_by_unit"],
            "bytes": dry["bytes_per_device"], "kernels": dry["kernels"]}
    if card != meta or not work["kernels"] == work["launches"] == \
            conv_launches(cfg):
        raise AssertionError(f"recurrentgemma-2b at {B} × "
                             f"{HYBRID_COUNT_SEQ}: the card step counted "
                             f"{card} with launches {work['launches']}, the "
                             f"meta dry run {meta}")
    count_s = time.perf_counter() - t0
    del state, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "kinds": n_kind, "mlp": cfg.act,
        "tie_embeddings": cfg.tie_embeddings,
        "params": active_params(cfg), "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat, "card": smi,
        "kernel_rows": [
            {k: r[k] for k in ("kernel", "shape", "dtype", "kernel_ms",
                               "kernel_eager_ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by", "max_abs_err")}
            for r in rows],
        "kernel_rows_s": t_rows, "parity": parity, "parity_s": t_parity,
        "launcher": "repro_torch.launch.train " + " ".join(args),
        "rows": B, "seq_len": L, "mode": "pack",
        "warmup": {"seq_len": HYBRID_SHORT_SEQ, "loss": whist[0]["loss"],
                   "step_ms": whist[0]["step_ms"], "run_s": warm_s},
        "timed_steps": steps, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": [h["step_ms"] for h in hist], "ms_per_step": step_ms,
        "real_tok_per_s": real / (step_ms * steps) * 1e3,
        "real_fraction": real / sum(h["buffer_tokens"] for h in hist),
        "timed_wall_s": wall, "launcher_seconds": last["seconds"],
        "model_flops": flops, "mfu": mfu(flops, step_ms / 1e3, peaks),
        "max_memory_allocated_gib": peak,
        "launches_per_step": {k: v // steps for k, v in launches.items()
                              if v},
        "profile_seq_len": HYBRID_PROFILE_SEQ, "profile": prof,
        "profile_s": profile_s,
        "count": {"seq_len": HYBRID_COUNT_SEQ, "card": card,
                  "card_seconds": work["seconds"],
                  "dry_run_s": dry["build_s"] + dry["count_s"],
                  "flops": dry["flops_per_device"],
                  "model_flops": dry["roofline"]["model_flops"],
                  "phase_s": count_s},
        "phase_wall_s": time.perf_counter() - t_phase,
        "phase_budget_s": 150}, rows


def stream_divergences(model, prompts, outs, max_len):
    """Each request's greedy ``prefill`` + ``decode_step`` alone against
    its stream ``outs[r]``: for every stream that leaves its reference,
    the first token that differs, the reference's top-2 logit margin there
    and whether the stream took the reference's second choice. Returns
    (the divergences, the smallest top-2 margin over every reference
    step)."""
    import numpy as np
    import torch
    out, low = [], float("inf")
    for r, p in zip(sorted(outs), prompts):
        m = len(p)
        lg, cache, clen = model.prefill(
            {"tokens": np.asarray(p, np.int32)[None],
             "positions": np.arange(m, dtype=np.int32)[None],
             "segment_ids": np.ones((1, m), np.int32)}, max_len)
        for j, tok in enumerate(outs[r]):
            top = torch.topk(lg[0], 2)
            v, i = top.values.tolist(), top.indices.tolist()
            first = int(torch.argmax(lg[0]))       # the greedy pick
            second = i[1] if i[0] == first else i[0]
            low = min(low, v[0] - v[1])
            if tok != first:
                out.append({"rid": r, "token": j, "ref_margin": v[0] - v[1],
                            "took_second": tok == second,
                            "logit_max_abs": lg[0].abs().max().item()})
                break
            lg, cache = model.decode_step(
                cache, torch.tensor([[tok]], dtype=torch.int32,
                                    device=model.device), cache_len=clen)
            clen = clen + 1
    return out, low


def phase_hybrid(smi, peaks):
    """Phase 18: recurrentgemma-2b served (26 layers: 18 RG-LRU and 8 local
    attention with a K/V ring of min(max_len, 2048) slots, each layer
    with its GeGLU MLP; d_model 2560, vocab 256000 tied; bf16, random
    weights from seed 0). #1 at its packed prefill's (2, 256, 2560) and
    its chunk slab's (1, 259, 2560) against the plain version, twice
    bitwise, timed; packed against per-prompt prefill on an f32 copy
    (every state leaf, the rings too, and the end logits; the worst of
    each layer printed first); the engine (8 slots of ``HYBRID_MAX_LEN``,
    12 greedy prompts of 16–200 tokens and one of ``HYBRID_LONG`` through
    the chunk lane, so the 2048-slot ring wraps; #1 exactly 18 × (prefills
    + chunk rounds), nothing else), each stream equal to the request's
    greedy ``prefill`` + ``decode_step`` alone; one decode step and one
    packed prefill round profiled with each sub-block kind marked
    (``layer_ranges``); the prefix cache cold, warm and rerun on
    ``HYBRID_PREFIX_REQUESTS`` requests behind phase 14's shared prompt,
    streams bitwise equal; speculative decode at ``HYBRID_SPEC_K`` against
    off, streams bitwise equal. Returns (the phase's line, the two
    ``kernels`` rows)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import packing
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.lm import LM
    t_phase = time.perf_counter()
    rows = [phase_conv_slab(peaks, shape, packed=shape[0] == 2)
            for shape in HYBRID_SERVE_SHAPES]
    cfg = get_config("recurrentgemma-2b")
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    if conv_layers(cfg) != 18:
        raise AssertionError(f"recurrentgemma-2b: {model.kinds}")
    t0 = time.perf_counter()
    by_layer = {}
    parity = phase_parity(model, cfg, HYBRID_PARITY_TOL, by_layer)
    parity_s = time.perf_counter() - t0

    def against_reference(prompts, outs):
        differ, low = stream_divergences(model, prompts, outs, HYBRID_MAX_LEN)
        if differ:
            raise AssertionError(f"recurrentgemma-2b: the engine's streams "
                                 f"differ from the per-request reference: "
                                 f"{differ}")
        return {"streams_equal_per_request_reference": True,
                "reference_min_top2_margin": low}

    t0 = time.perf_counter()
    eng = phase_engine(model, cfg, long=HYBRID_LONG, max_len=HYBRID_MAX_LEN,
                       check=against_reference)
    eng["ring_slots"] = model.ring_size(HYBRID_MAX_LEN)
    one = model.init_cache(1, HYBRID_MAX_LEN)
    eng["cache_row_bytes"] = sum(t.numel() * t.element_size()
                                 for t in one.values())
    eng["ring_row_bytes"] = sum(t.numel() * t.element_size()
                                for k, t in one.items() if "attn" in k)
    del one
    engine_s = time.perf_counter() - t0

    # where a decode step's and a prefill round's time goes: one of each,
    # traced with each sub-block kind marked
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    deng = ServeEngine(model, num_slots=8, max_len=HYBRID_MAX_LEN,
                       buckets=(64, 128, 256), overlap=False,
                       refill_threshold=1)
    for n in rng.integers(16, 201, size=8):
        deng.submit(rng.integers(1, cfg.vocab, size=int(n)), 8)
    while deng.queue or deng.stats.decode_steps < 2:
        deng.step()
    none = {name: 0 for name in read_launches()}
    with layer_ranges():
        _, step_prof = profile_call(deng._decode_step, none)
    del deng
    prompts = [rng.integers(1, cfg.vocab, size=n) for n in
               (60, 70, 50, 76, 64, 64, 64, 64)]
    pb = packing.pack(prompts, 256, policy="first_fit", num_rows=2)
    ends = torch.as_tensor(packing.segment_ends(pb, 4), device="cuda")
    batch = {"tokens": pb.tokens, "positions": pb.positions,
             "segment_ids": pb.segment_ids}
    model.prefill_packed(batch, ends, HYBRID_MAX_LEN)          # warm
    with layer_ranges():
        _, round_prof = profile_call(
            lambda: model.prefill_packed(batch, ends, HYBRID_MAX_LEN),
            dict(none, conv1d_pack_fwd=conv_layers(cfg)))
    profile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pc = phase_prefix_cache(model, cfg, smi, n=HYBRID_PREFIX_REQUESTS,
                            full=False)
    prefix_s = time.perf_counter() - t0

    # speculative decode: 6 greedy prompts and 2 of a repeated block,
    # spec_k on against off on the engine of the run above
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    sprompts = [rng.integers(1, cfg.vocab, size=int(n))
                for n in rng.integers(16, 201, size=6)] + [
        np.tile(rng.integers(1, cfg.vocab, size=n), 4) for n in (8, 16)]

    def submit(e):
        for p in sprompts:
            e.submit(p, SERVE_NEW)

    spec, streams = {}, {}
    for k in (0, HYBRID_SPEC_K):
        e = ServeEngine(model, num_slots=8, max_len=HYBRID_MAX_LEN,
                        buckets=(64, 128, 256), spec_k=k)
        streams[k], spec[k] = timed_engine(model, cfg, e, submit)
        spec[k].update(spec_k=k, rounds=e._spec_rounds.value,
                       proposed=e._spec_proposed.value,
                       accepted=e._spec_accepted.value)
        del e
    differ = [r for r in streams[0]
              if streams[0][r] != streams[HYBRID_SPEC_K][r]]
    if differ or not spec[HYBRID_SPEC_K]["rounds"]:
        raise AssertionError(f"recurrentgemma-2b spec decode: streams "
                             f"differ for {differ}; {spec[HYBRID_SPEC_K]}")
    spec_s = time.perf_counter() - t0
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "kinds": {k: model.kinds.count(k) for k in set(model.kinds)},
           "attn_window": cfg.attn_window, "conv_layers": conv_layers(cfg),
           "card": smi,
           "parity": {"dtype": "float32", "tf32": "off",
                      "tolerance": HYBRID_PARITY_TOL, "max_rel_err": parity,
                      "worst_by_layer": by_layer, "seconds": parity_s},
           "engine": eng, "engine_s": engine_s,
           "decode_step_profile": step_prof, "prefill_round_profile":
           round_prof, "profile_s": profile_s,
           "prefix_cache": pc, "prefix_cache_s": prefix_s,
           "spec_decode": {"spec_k": HYBRID_SPEC_K, "off": spec[0],
                           "on": spec[HYBRID_SPEC_K],
                           "streams_bitwise_equal": True, "seconds": spec_s},
           "phase_wall_s": time.perf_counter() - t_phase}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def phase_dense(smi, peaks):
    """Phase 19: stablelm-1.6b (24 layers of full causal attention, each
    with its SwiGLU MLP; d_model 2048, 32 heads of 64 on 32 K/V heads, d_ff
    5632, vocab 100352, untied) served and trained at full width and
    depth, random weights from seed 0. No kernel of the port's own lies on
    this path (the attention, the MLP and the decode step are plain
    PyTorch, as the JAX package runs them in XLA): every launch counter is
    read after each part and must be 0. (a) Packed against per-prompt
    prefill on an f32 copy, 2 × ``DENSE_PARITY_CAP`` with 4 and 3 segments
    a row: every K/V leaf and the end logits within ``DENSE_PARITY_TOL``
    of max(1, max |ref|), the worst of each layer on a ``parity_layers``
    line first. (b) The engine, 8 slots of ``DENSE_MAX_LEN``, 12 greedy
    prompts and one of ``DENSE_LONG`` through the chunk lane, each stream
    held to its request's greedy ``prefill`` + ``decode_step`` alone
    (``stream_divergences``): in bf16 it may leave the reference only at a
    near-tie (``against_reference``), and on an f32 copy it must equal it
    bitwise; the prefix cache (cold, warm, rerun; a budget of 64 rows) on
    ``DENSE_PREFIX_REQUESTS`` requests behind phase 14's shared prompt;
    speculative decode at ``DENSE_SPEC_K`` against off, streams bitwise
    equal. (c) The training main path through the launcher in this
    process (``launch_train``): a warm-up run of one step at 2 ×
    ``DENSE_SHORT_SEQ``, then ``DENSE_TRAIN_STEPS`` timed steps at 2 ×
    ``DENSE_TRAIN_SEQ`` packed on the paper's lengths, bf16 compute on
    f32 weights (ms/step, MFU, peak memory); a model of its own profiles
    its first step at that shape, each sub-block marked (``layer_ranges``:
    attn and mlp); then one card step at 2 ×
    ``DENSE_COUNT_SEQ`` counted, equal to the meta dry run of the same
    cell. Returns the phase's line."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.roofline.analysis import (active_params, mfu,
                                               model_flops_per_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    none = {k: 0 for k in read_launches()}

    def no_launch(where):
        ran = read_launches()
        if ran != none:
            raise AssertionError(f"{cfg.name} {where} launched {ran}")

    zero_launches()
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    if conv_layers(cfg) or model.kinds != ("attn",) * cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {model.kinds}")
    t0 = time.perf_counter()
    by_layer = {}
    parity = phase_parity(model, cfg, DENSE_PARITY_TOL, by_layer,
                          lens=DENSE_PARITY_LENS, cap=DENSE_PARITY_CAP)
    parity_s = time.perf_counter() - t0
    no_launch("parity")

    def against_reference(m, bitwise):
        """Each stream against its request's greedy reference: equal
        (``bitwise``), or leaving it only at a near-tie: where the
        reference's top-2 margin is within two bf16 roundings of its top
        logit (2^-7 of it) and the stream took the reference's second
        choice (bf16 logits over 100352 entries tie outright: the engine's
        other batch shapes round differently there)."""
        def check(prompts, outs):
            differ, low = stream_divergences(m, prompts, outs, DENSE_MAX_LEN)
            bad = [d for d in differ if bitwise or not d["took_second"]
                   or d["ref_margin"] > 2 ** -7 * d["logit_max_abs"]]
            if bad:
                raise AssertionError(f"{cfg.name} ({m.cfg.dtype}): the "
                                     f"engine's streams leave the "
                                     f"per-request reference: {bad}")
            return {"streams": len(outs),
                    "streams_equal_per_request_reference":
                        len(outs) - len(differ),
                    "divergences_at_near_ties": differ,
                    "reference_min_top2_margin": low}
        return check

    # serving: the engine (its own counters checked: nothing launched),
    # in bf16 (streams equal their references but at near-ties), then on
    # an f32 copy (TF32 off), every stream bitwise its reference
    t0 = time.perf_counter()
    eng = phase_engine(model, cfg, long=DENSE_LONG, max_len=DENSE_MAX_LEN,
                       check=against_reference(model, False))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = LM(cfg32)
    m32.load_state_dict(model.state_dict())
    eng32 = phase_engine(m32, cfg32, long=DENSE_LONG, max_len=DENSE_MAX_LEN,
                         check=against_reference(m32, True))
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    one = model.init_cache(1, DENSE_MAX_LEN)
    eng["cache_row_bytes"] = sum(t.numel() * t.element_size()
                                 for t in one.values())
    eng["cache_row_bytes_formula"] = (cfg.n_layers * 2 * DENSE_MAX_LEN
                                      * cfg.n_kv_heads * cfg.hd * 2)
    del one
    if eng["cache_row_bytes"] != eng["cache_row_bytes_formula"]:
        raise AssertionError(f"{cfg.name}: a slot row is "
                             f"{eng['cache_row_bytes']} bytes")
    engine_s = time.perf_counter() - t0
    no_launch("reference decode")

    t0 = time.perf_counter()
    pc = phase_prefix_cache(model, cfg, smi, n=DENSE_PREFIX_REQUESTS,
                            full=False)
    prefix_s = time.perf_counter() - t0

    # speculative decode: 6 greedy prompts and 2 of a repeated block,
    # spec_k on against off (timed_engine: nothing launched)
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    sprompts = [rng.integers(1, cfg.vocab, size=int(n))
                for n in rng.integers(16, 201, size=6)] + [
        np.tile(rng.integers(1, cfg.vocab, size=n), 4) for n in (8, 16)]

    def submit(e):
        for p in sprompts:
            e.submit(p, SERVE_NEW)

    spec, streams = {}, {}
    for k in (0, DENSE_SPEC_K):
        e = ServeEngine(model, num_slots=8, max_len=DENSE_MAX_LEN,
                        buckets=(64, 128, 256), spec_k=k)
        streams[k], spec[k] = timed_engine(model, cfg, e, submit)
        spec[k].update(spec_k=k, rounds=e._spec_rounds.value,
                       proposed=e._spec_proposed.value,
                       accepted=e._spec_accepted.value)
        del e
        gc.collect()
        torch.cuda.empty_cache()
    differ = [r for r in streams[0]
              if streams[0][r] != streams[DENSE_SPEC_K][r]]
    if differ or not spec[DENSE_SPEC_K]["rounds"]:
        raise AssertionError(f"{cfg.name} spec decode: streams differ for "
                             f"{differ}; {spec[DENSE_SPEC_K]}")
    spec_s = time.perf_counter() - t0
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # training: the launcher's warm-up and timed runs
    B, L, steps = 2, DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS
    args = ("--arch", cfg.name, "--rows", str(B))
    t0 = time.perf_counter()
    zero_launches()
    whist, _ = launch_train(*args, "--steps", "1", "--seq-len",
                            str(DENSE_SHORT_SEQ))
    no_launch("the training warm-up")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    hist, last = launch_train(*args, "--steps", str(steps), "--seq-len",
                              str(L))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    no_launch("training")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [whist[0]["loss"]] + [h["loss"] for h in hist]
    step_ms = sum(h["step_ms"] for h in hist) / steps
    real = sum(h["real_tokens"] for h in hist)
    flops = model_flops_per_step(cfg, "train", B, L)
    train_s = time.perf_counter() - t0
    gc.collect()               # the launcher's model, back to the allocator

    # the device's view: the first step of a model of its own at the timed
    # shape (the process is warm from the timed run), traced with its
    # sub-blocks marked; then one card step at 2 × DENSE_COUNT_SEQ counted
    t0 = time.perf_counter()
    model = LM(cfg)
    trainer = Trainer(model, AdamW(cosine_schedule(3e-4, 1, 4)),
                      train_loader(cfg, "pack", L, B), TrainerConfig(steps=1))
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    pbatch = trainer.loader.batch(0)

    def one_step():
        nonlocal state
        state, metrics = trainer.step_fn(state, pbatch)
        float(metrics["loss"])

    with layer_ranges():
        _, prof = profile_call(one_step, none)
    n_kind = {"attn": cfg.n_layers, "mlp": cfg.n_layers}
    if sorted(prof.get("by_layer_kind", {})) != sorted(n_kind):
        raise AssertionError(f"the profiled step marked "
                             f"{sorted(prof.get('by_layer_kind', {}))}, "
                             f"where the model has {n_kind}")
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cbatch = train_loader(cfg, "pack", DENSE_COUNT_SEQ, B).batch(0)
    work = count_card_step(trainer.step_fn, state, cbatch)
    dry = count_step(cfg, "train", B, DENSE_COUNT_SEQ, peaks)
    card = {k: work[k] for k in ("flops_by_unit", "bytes", "kernels")}
    meta = {"flops_by_unit": dry["flops_by_unit"],
            "bytes": dry["bytes_per_device"], "kernels": dry["kernels"]}
    if card != meta or work["kernels"] or work["launches"]:
        raise AssertionError(f"{cfg.name} at {B} × {DENSE_COUNT_SEQ}: the "
                             f"card step counted {card} with launches "
                             f"{work['launches']}, the meta dry run {meta}")
    count_s = time.perf_counter() - t0
    del state, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "mlp": cfg.act, "tie_embeddings": cfg.tie_embeddings,
        "params": active_params(cfg), "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "remat": cfg.remat, "card": smi,
        "launch_counters_zero": True,
        "parity": {"dtype": "float32", "tf32": "off",
                   "rows": [2, DENSE_PARITY_CAP],
                   "prompt_lens": list(DENSE_PARITY_LENS),
                   "tolerance": DENSE_PARITY_TOL, "max_rel_err": parity,
                   "worst_by_layer": by_layer, "seconds": parity_s},
        "engine": eng, "engine_f32": eng32, "engine_s": engine_s,
        "prefix_cache": pc, "prefix_cache_s": prefix_s,
        "spec_decode": {"spec_k": DENSE_SPEC_K, "off": spec[0],
                        "on": spec[DENSE_SPEC_K],
                        "streams_bitwise_equal": True, "seconds": spec_s},
        "train": {
            "launcher": "repro_torch.launch.train " + " ".join(args),
            "rows": B, "seq_len": L, "mode": "pack",
            "warmup": {"seq_len": DENSE_SHORT_SEQ, "loss": whist[0]["loss"],
                       "step_ms": whist[0]["step_ms"]},
            "timed_steps": steps, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": [h["step_ms"] for h in hist], "ms_per_step": step_ms,
            "real_tok_per_s": real / (step_ms * steps) * 1e3,
            "real_fraction": real / sum(h["buffer_tokens"] for h in hist),
            "timed_wall_s": wall, "launcher_seconds": last["seconds"],
            "model_flops": flops, "mfu": mfu(flops, step_ms / 1e3, peaks),
            "max_memory_allocated_gib": peak, "seconds": train_s},
        "profile": prof, "profile_s": profile_s,
        "count": {"seq_len": DENSE_COUNT_SEQ, "card": card,
                  "card_seconds": work["seconds"],
                  "dry_run_s": dry["build_s"] + dry["count_s"],
                  "flops": dry["flops_per_device"],
                  "model_flops": dry["roofline"]["model_flops"],
                  "phase_s": count_s},
        "phase_wall_s": time.perf_counter() - t_phase}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import selective_scan as ksc
    from repro_torch.models.lm import LM

    t_start = time.perf_counter()
    # every f32 number here is full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)          # an unknown card fails here, first
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, peaks=peaks)
    print(smi, flush=True)

    t = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t,
         per_source=_build.build_seconds, libraries=sorted(libs))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    sfu_rate = sms * SFU_PER_SM_CLOCK * clock_mhz * 1e6      # exp / s
    emit("sfu", sms=sms, max_sm_clock_mhz=clock_mhz, exp_per_s=sfu_rate)

    conv_rows, conv_worst = phase_conv_fwd(peaks)
    dx_rows, dx_worst = phase_conv_dx(peaks)
    scan_rows, scan_worst = phase_scan(sfu_rate, sms, peaks)
    heads_rows, heads_worst = phase_heads(peaks)

    # serving first, from the same state as before training existed
    cfg = get_config("mamba-1.4b")
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    parity = phase_parity(model, cfg)
    emit("parity", arch=cfg.name, dtype="float32", tf32="off",
         tolerance=PARITY_TOL, max_rel_err=parity)

    eng = phase_engine(model, cfg)
    emit("engine", arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, **eng)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    tp = phase_train_parity()
    emit("train_parity", **tp)
    tr = phase_train()
    prof = tr.pop("profile")
    named6 = prof.get("by_group_calls", {}).get("scan bwd #6", 0)
    if named6 != 3 * cfg.n_layers:
        raise AssertionError(f"the profiled mamba-1.4b step names #6's carry, "
                             f"combine and chunk kernels {named6} times, "
                             f"expected 3 × {cfg.n_layers}")
    emit("train", **tr)
    emit("train_profile", **prof)

    # Mamba-2: serving, training parity for both forward schedules, and
    # the training main path
    cfg2 = get_config("mamba2-370m")
    model = LM(cfg2)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    parity2 = phase_parity(model, cfg2)
    emit("parity_mamba2", arch=cfg2.name, dtype="float32", tf32="off",
         tolerance=PARITY_TOL, max_rel_err=parity2)
    eng2 = phase_engine(model, cfg2)
    emit("engine_mamba2", arch=cfg2.name, dtype=cfg2.dtype,
         layers=cfg2.n_layers, d_model=cfg2.d_model, **eng2)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tp2 = {s: phase_train_parity("mamba2-370m", s)
           for s in ("blocked_heads", "blocked_heads_dual")}
    for v in tp2.values():
        emit("train_parity_mamba2", **v)
    tr2 = phase_train("mamba2-370m", rows=8)
    prof2 = tr2.pop("profile")
    named = {g: prof2.get("by_group_calls", {}).get(g, 0)
             for g in ("heads scan fwd #7", "heads scan bwd #9")}
    if named != {"heads scan fwd #7": 2 * cfg2.n_layers,
                 "heads scan bwd #9": cfg2.n_layers}:
        raise AssertionError(f"the profiled mamba2-370m step names the heads "
                             f"kernels {named} times, expected "
                             f"{2 * cfg2.n_layers} and {cfg2.n_layers}")
    emit("train_mamba2", **tr2)
    emit("train_mamba2_profile", **prof2)

    # mamba-2.8b through the step schedule (#3 then #5): full-width parity,
    # then the training main path at full width and depth
    tp3 = phase_train_parity("mamba-2.8b", "step")
    emit("train_parity_step", **tp3)
    tr3 = phase_train("mamba-2.8b", schedule="step", pad=False)
    prof3 = tr3.pop("profile")
    named3 = {g: prof3.get("by_group_calls", {}).get(g, 0)
              for g in ("scan fwd step #3", "scan bwd step #5")}
    layers3 = tr3["layers"]
    if named3 != {"scan fwd step #3": 2 * layers3,
                  "scan bwd step #5": layers3}:
        raise AssertionError(f"the profiled mamba-2.8b step names the step "
                             f"kernels {named3} times, expected "
                             f"{2 * layers3} and {layers3}")
    emit("train_step", **tr3)
    emit("train_step_profile", **prof3)

    # the tuner: both layer shapes swept, mamba-1.4b trained and served
    # with the cache, beside the untuned numbers above
    tt, tune_s = phase_tune(tr, eng)
    emit("tune", seconds=tune_s)

    # the roofline of every training path above, its count on the card
    # held to the meta dry run's; the paper configs' dry run and report
    emit("roofline_report", **phase_roofline(smi, peaks, {
        "mamba-1.4b blocked": (tr, None),
        "mamba-1.4b tuned": (tt, tt["winner_knobs"]),
        "mamba-2.8b step": (tr3, None), "mamba2-370m": (tr2, None)}))

    # kill and resume: SIGTERM, the emergency save, the restore; then the
    # launcher's checkpoint, trace and profile flags
    emit("checkpoint", **phase_checkpoint(smi))

    # the serving engine's scheduler v2: #1 at the chunk slab, chunked
    # prefill against whole prefill on both models, the engine (overlap,
    # the pipeline, the TTFT policy, sampling, the chunk lane) on
    # mamba-1.4b, the padded wave, profiles; then the serve launcher
    slab = phase_conv_slab(peaks)
    emit("kernels", **slab)
    model = LM(cfg)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    chunk_par = phase_chunk_parity(model, cfg)
    emit("chunk_parity", **chunk_par)
    sv = phase_serve(model, cfg)
    for pname, prof_s in sv.pop("profiles").items():
        emit("serve_profile", name=pname, **prof_s)
    emit("serve", **sv)
    # the request lifecycle on the same engine: guard, faults, kill and
    # restore, a cancel in flight
    emit("lifecycle", **phase_lifecycle(model, cfg, smi))
    # the O(1)-state exploits on the same engine: the prefix cache, then
    # speculative decode; #1 at the suffix rounds' slab widths
    pc = phase_prefix_cache(model, cfg, smi)
    emit("prefix_cache", **pc)
    emit("spec_decode", **phase_spec_decode(model, cfg, smi))
    suffix_slabs = [phase_conv_slab(peaks, shape) for shape in SUFFIX_SLABS]
    for row in suffix_slabs:
        emit("kernels", **row)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = LM(cfg2)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    emit("chunk_parity_mamba2", **phase_chunk_parity(model, cfg2))
    emit("prefix_cache_mamba2", **phase_prefix_cache(
        model, cfg2, smi, n=PREFIX_MAMBA2_REQUESTS, full=False))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the training and serve launchers' flags, three subprocesses at once
    launcher, serve_launcher = phase_launchers()
    emit("launcher", **launcher)
    emit("serve_launcher", **serve_launcher)

    # xlstm-125m served by the engine: #1 at its shapes, parity, the
    # engine with the chunk lane, a prefill round, the prefix cache
    xl, xl_rows = phase_xlstm(smi, peaks)
    for row in xl_rows:
        emit("kernels", **row)
    emit("xlstm", **xl)

    # xlstm-125m trained: #1 and #2 at its training shape, parity of one
    # unit, the training main path at full width and depth, its count
    xt, xt_rows = phase_xlstm_train(smi, peaks)
    for row in xt_rows:
        emit("kernels", **row)
    emit("xlstm_train", **xt)

    # recurrentgemma-2b trained: #1 and #2 at its training shape, parity
    # of one unit, the training main path at full width and depth, its
    # count
    ht, ht_rows = phase_hybrid_train(smi, peaks)
    for row in ht_rows:
        emit("kernels", **row)
    emit("hybrid_train", **ht)

    # recurrentgemma-2b served: #1 at its shapes, parity, the engine with
    # the chunk lane past the ring, profiles, the prefix cache, speculation
    hs, hs_rows = phase_hybrid(smi, peaks)
    for row in hs_rows:
        emit("kernels", **row)
    emit("hybrid", **hs)

    # stablelm-1.6b served and trained: no kernel of the port's own on its
    # path; parity, the engine with the chunk lane, the prefix cache,
    # speculation, the training main path, its profile and its count
    emit("dense", **phase_dense(smi, peaks))

    def main_row(rows, shape):
        return next(r for r in rows if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16")

    def entry(name, src, replaces, row, launches, worst, **extra):
        extra.setdefault("launches_train_tuned", launches_t[name])
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": row["kernel_ms"],
                "kernel_ms": row["kernel_ms"],
                "kernel_eager_ms": row["kernel_eager_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "at": {"shape": row["shape"], "dtype": row["dtype"]},
                **extra}

    def conv_resources(kind, rows):
        """#1's or #2's registers, spills and blocks an SM (both dtypes,
        both widths), and the run and blocks each timed shape took."""
        from repro_torch.kernels import conv1d_pack as kconv
        return {"kernels": {
            f"{dt}{'_one_wide' if ow else ''}": kconv.conv_resources(
                kind, getattr(torch, dt), ow)
            for dt in ("bfloat16", "float32") for ow in (False, True)},
            "shapes": {f"{r['dtype']} {tuple(r['shape'])}": r["launch"]
                       for r in rows}}

    def conv_train_ms(rows):
        return {arch: main_row(rows, shape)["kernel_ms"]
                for arch, shape in CONV_TRAIN_SHAPES.items()}

    def heads_row(name):
        return main_row([r for r in heads_rows if r["kernel"] == name],
                        HEADS_SHAPE)

    def scan_row(name, shape):
        return main_row([r for r in scan_rows if r["kernel"] == name
                         and r["chunk"] == ops.SCAN_CHUNK], shape)

    launches, launches2 = tr["launches"], tr2["launches"]
    launches3, launches_t = tr3["launches"], tt["launches"]
    dual_path = tp2["blocked_heads_dual"]["launches_kernel_path"]
    fwd_row = scan_row("selective_scan_fwd", TRAIN_SHAPE)
    bwd_row = scan_row("selective_scan_bwd", TRAIN_SHAPE)
    step_fwd_row = scan_row("selective_scan_fwd_step", TRAIN_SHAPE_28)
    step_bwd_row = scan_row("selective_scan_bwd_step", TRAIN_SHAPE_28)
    per_prefill = eng["conv1d_pack_launches"] // eng["prefills"]
    print(json.dumps({"kernels": [
        entry("conv1d_pack_fwd", "conv1d_pack.cu",
              "src/repro/kernels/conv1d_pack.py:36",
              main_row(conv_rows, MAIN_SHAPE), eng["conv1d_pack_launches"],
              conv_worst, launches_per_prefill=per_prefill,
              launches_train=launches["conv1d_pack_fwd"],
              launches_train_step=launches3["conv1d_pack_fwd"],
              launches_train_mamba2=launches2["conv1d_pack_fwd"],
              resources=conv_resources("fwd", conv_rows),
              train_ms=conv_train_ms(conv_rows),
              launches_serve=sv["on"]["conv1d_pack_launches"],
              launches_per_chunk_round=chunk_par[
                  "conv1d_pack_launches_per_slab"],
              launches_prefix_cache=pc["warm"]["conv1d_pack_launches"],
              launches_prefix_cache_rerun=pc["rerun"][
                  "conv1d_pack_launches"],
              chunk_slab={k: slab[k] for k in (
                  "shape", "kernel_ms", "kernel_eager_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err")},
              suffix_slabs=[{k: r[k] for k in (
                  "shape", "kernel_ms", "kernel_eager_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                  for r in suffix_slabs],
              launches_xlstm=xl["engine"]["conv1d_pack_launches"],
              launches_xlstm_prefix_cache=xl["prefix_cache"]["warm"][
                  "conv1d_pack_launches"],
              xlstm_shapes=[{k: r[k] for k in (
                  "shape", "kernel_ms", "kernel_eager_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                  for r in xl_rows],
              launches_xlstm_train=xt["launches_per_step"][
                  "conv1d_pack_fwd"] * xt["timed_steps"],
              xlstm_train_shape=xt["kernel_rows"][0],
              launches_hybrid_train=ht["launches_per_step"][
                  "conv1d_pack_fwd"] * ht["timed_steps"],
              hybrid_train_shape=ht["kernel_rows"][0],
              launches_hybrid=hs["engine"]["conv1d_pack_launches"],
              launches_hybrid_prefix_cache=hs["prefix_cache"]["warm"][
                  "conv1d_pack_launches"],
              hybrid_shapes=[{k: r[k] for k in (
                  "shape", "kernel_ms", "kernel_eager_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                  for r in hs_rows]),
        entry("conv1d_pack_bwd_dx", "conv1d_pack.cu",
              "src/repro/kernels/conv1d_pack.py:83",
              main_row(dx_rows, TRAIN_SHAPE),
              launches["conv1d_pack_bwd_dx"], dx_worst,
              launches_train_step=launches3["conv1d_pack_bwd_dx"],
              launches_train_mamba2=launches2["conv1d_pack_bwd_dx"],
              resources=conv_resources("bwd_dx", dx_rows),
              train_ms=conv_train_ms(dx_rows),
              launches_xlstm_train=xt["launches_per_step"][
                  "conv1d_pack_bwd_dx"] * xt["timed_steps"],
              xlstm_train_shape=xt["kernel_rows"][1],
              launches_hybrid_train=ht["launches_per_step"][
                  "conv1d_pack_bwd_dx"] * ht["timed_steps"],
              hybrid_train_shape=ht["kernel_rows"][1]),
        entry("selective_scan_fwd_step", "selective_scan.cu",
              "src/repro/kernels/selective_scan.py:116", step_fwd_row,
              launches3["selective_scan_fwd_step"],
              scan_worst["selective_scan_fwd_step"], path="train_step",
              exp_floor_ms=step_fwd_row["exp_floor_ms"],
              build=ksc.lanes_fwd_params(),
              resources={dt: scan_resources("fwd", getattr(torch, dt),
                                            TRAIN_SHAPE_28, sms)
                         for dt in ("bfloat16", "float32")},
              blocked_same_call_ms=scan_row("selective_scan_fwd",
                                            TRAIN_SHAPE_28)["kernel_ms"]),
        entry("selective_scan_fwd", "selective_scan.cu",
              "src/repro/kernels/selective_scan.py:153", fwd_row,
              launches["selective_scan_fwd"],
              scan_worst["selective_scan_fwd"],
              exp_floor_ms=fwd_row["exp_floor_ms"],
              step_same_call_ms=scan_row("selective_scan_fwd_step",
                                         TRAIN_SHAPE)["kernel_ms"],
              ms_28=scan_row("selective_scan_fwd", TRAIN_SHAPE_28)[
                  "kernel_ms"],
              build=ksc.lanes_fwd_params(),
              resources={dt: scan_resources("fwd", getattr(torch, dt),
                                            TRAIN_SHAPE, sms)
                         for dt in ("bfloat16", "float32")},
              other_chunks_ms={
                  r["chunk"]: r["kernel_ms"] for r in scan_rows
                  if r["kernel"] == "selective_scan_fwd"
                  and r["chunk"] != ops.SCAN_CHUNK}),
        entry("selective_scan_bwd_step", "selective_scan_step_bwd.cu",
              "src/repro/kernels/selective_scan.py:441", step_bwd_row,
              launches3["selective_scan_bwd_step"],
              scan_worst["selective_scan_bwd_step"], path="train_step",
              exp_floor_ms=step_bwd_row["exp_floor_ms"],
              build=ksc.step_bwd_params(),
              resources={dt: scan_resources("step_bwd", getattr(torch, dt),
                                            TRAIN_SHAPE_28, sms)
                         for dt in ("bfloat16", "float32")},
              blocked_same_call_ms=scan_row("selective_scan_bwd",
                                            TRAIN_SHAPE_28)["kernel_ms"]),
        entry("selective_scan_bwd", "selective_scan_bwd.cu",
              "src/repro/kernels/selective_scan.py:525", bwd_row,
              launches["selective_scan_bwd"],
              scan_worst["selective_scan_bwd"],
              exp_floor_ms=bwd_row["exp_floor_ms"],
              step_same_call_ms=scan_row("selective_scan_bwd_step",
                                         TRAIN_SHAPE)["kernel_ms"],
              ms_28=scan_row("selective_scan_bwd", TRAIN_SHAPE_28)[
                  "kernel_ms"],
              step_same_call_ms_28=step_bwd_row["kernel_ms"],
              build=ksc.bwd_params(),
              resources={dt: ksc.bwd_resources(getattr(torch, dt),
                                               ops.SCAN_CHUNK)
                         for dt in ("bfloat16", "float32")}),
        entry("selective_scan_heads_fwd", "selective_scan_heads_fwd.cu",
              "src/repro/kernels/selective_scan.py:212",
              heads_row("selective_scan_heads_fwd"),
              launches2["selective_scan_heads_fwd"],
              heads_worst["selective_scan_heads_fwd"], path="train_mamba2",
              resources=heads_row("selective_scan_heads_fwd")["resources"]),
        entry("selective_scan_heads_fwd_dual", "selective_scan_heads.cu",
              "src/repro/kernels/selective_scan.py:272",
              heads_row("selective_scan_heads_fwd_dual"),
              dual_path["selective_scan_heads_fwd_dual"],
              heads_worst["selective_scan_heads_fwd_dual"],
              path="train_parity_mamba2 (schedule=blocked_heads_dual)",
              launches_train_mamba2=launches2[
                  "selective_scan_heads_fwd_dual"]),
        entry("selective_scan_heads_bwd", "selective_scan_heads_bwd.cu",
              "src/repro/kernels/selective_scan.py:634",
              heads_row("selective_scan_heads_bwd"),
              launches2["selective_scan_heads_bwd"],
              heads_worst["selective_scan_heads_bwd"], path="train_mamba2",
              partials_bytes=heads_row(
                  "selective_scan_heads_bwd")["partials_bytes"])]}),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
