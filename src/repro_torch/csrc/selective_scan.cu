// Segmented selective scan (PackMamba's ScanOp_pack, Mamba-1 per-channel
// decay), forward, parallel over TIME inside a block, for Hopper (sm_90a):
// kernels #4 (the `blocked` schedule) and #3 (`step`), one kernel under two
// names.
//
// Replaces the Pallas TPU kernels `_fwd_kernel_blocked` (#4) and
// `_fwd_kernel` (#3) of src/repro/kernels/selective_scan.py (entry
// `selective_scan_fwd_pallas`, schedule="blocked" / "step"). Same function,
// same outputs:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   y_t = sum_n C_t[n] * h_t[n] + D * u_t
//
// forward:  u, dt (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//           read through their batch and row strides; Dp (D,) f32;
//           pos (B,L) i32 -> y (B,L,D) in u's type, ckpt (B,nC,N,D) f32 = the
//           state at each chunk's entry (nC = ceil(L / chunk)); #4 takes any
//           chunk >= 1, #3 only 64 (its tile is its chunk).
// Either feeds either backward: #6 (selective_scan_bwd.cu) reads ckpt at any
// chunk that is a multiple of 16, #5 (selective_scan_step_bwd.cu) at 64.
//
// What bounds it on this card: neither the bytes nor the exponentials, but
// the instructions each (t, n, d) issues. At mamba-1.4b's training shape
// (B=2, L=4096, D=4096, N=16) it moves ~0.24 GB (u, dt, y once, the
// checkpoints) = 70 us at 3.35 TB/s and needs B*L*D*N = 5.4e8 exp2 results
// = ~128 us at the special-function unit's 16 a clock per SM; a scan that
// walks L one step at a time is bound instead by its dependent chain (#4's
// design before this one: 32 channels a block, one step after another), and
// a time-parallel one by the ~12 lane instructions a (t, n, d) issues: the
// exponent's FMA and the exp2, B*dt*u, the fold's two, the replay's two, and
// a lane's share of the lane scan's shuffles and of the loads. Shared-memory
// traffic is not the limit: B and C kept in bf16 there (half the bytes, more
// conversions) ran slower.
//
// Design: the TPU's `blocked` kernel evaluates each in-chunk subtile at once
// and carries the state only between subtiles; here a lane's R steps are the
// subtile and a log-depth shuffle scan over the lanes is the carry. The
// layout, arithmetic and staging are in scan_fwd_lanes.cuh: a block owns one
// row and CH channels and walks the row in 64-step tiles, each channel's
// tile over TL / R lanes; the lanes' folds combine with zero carry-in and the
// tile's entry state is applied after the combine; the carried state sits in
// two shared slots by tile parity; one exponential per (t, n, d). R = 8,
// CH = 16 give 128 threads, B*D/16 blocks and 5 blocks an SM, so
// mamba-2.8b's 640 blocks and mamba-1.4b's 512 fit one wave of 660. The
// states' loop runs two states at once: one at a time (more warps, fewer
// registers) ran slower, four at a time spilled.
//
// The checkpoint chunk is decoupled from the tile by the kernel the launch
// picks (the header's modes):
//   * chunk == 64 (the main path, ops.SCAN_CHUNK, and #3's only chunk):
//     CKPT_TILES, every tile's entry state from its slot. #3's
//     scan_step_fwd_kernel is this kernel under its own name, so a profile
//     tells the schedules apart;
//   * any other chunk: CKPT_ANY, each lane writes the state before each of
//     its steps that starts a chunk from its registers during the replay (a
//     mask of its R steps made once a tile). The mask and its pointer are
//     live through the states' loop, so this kernel's launch bound is at most
//     4 blocks an SM (room for them without a spill).
//
// Build-time knobs, one set for both schedules (tools/sweep_step_bounds.py
// times them, #6 the control; the reading is in PERF.md): SCAN_LANES_R the
// steps a lane (4, 8 or 16), SCAN_LANES_CH the channels a block (16 or 32),
// SCAN_LANES_MIN_BLOCKS the launch bound of the chunk-64 kernel for bf16
// input (f32, and other chunks: at most 4, which its shared memory allows).
// The defaults, 8 steps, 16 channels and 5 blocks, put mamba-2.8b's grid in
// one wave with every SM loaded alike (32 channels a block leave its SMs
// unevenly loaded), and hold at a ragged shape too: on an H100 (700 W) 16
// steps a lane ran 1-8% faster at L = 4096 and 18-54% slower at (2, 997,
// 4104), where 163 registers leave 12 warps an SM to hide a short row's
// tiles.

#ifndef SCAN_LANES_R
#define SCAN_LANES_R 8
#endif
#ifndef SCAN_LANES_CH
#define SCAN_LANES_CH 16
#endif
#ifndef SCAN_LANES_MIN_BLOCKS
#define SCAN_LANES_MIN_BLOCKS 5        // bf16 input, chunk 64
#endif

#include "scan_fwd_lanes.cuh"

namespace {

// The launch bound of the kernel for T and CK: SCAN_LANES_MIN_BLOCKS for
// the chunk-64 kernel with bf16 input, at most 4 otherwise.
template <typename T, int CK>
constexpr int min_blocks() {
  return sizeof(T) == 2 && CK == CKPT_TILES
             ? SCAN_LANES_MIN_BLOCKS
             : f32_min_blocks(SCAN_LANES_MIN_BLOCKS);
}

// #4.
template <typename T, int CK>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, CK>()))
scan_fwd_kernel(Operands op, T* __restrict__ y, float* __restrict__ ckpt,
                int aligned, int chunk) {
  scan_lanes_fwd<T, CK>(op, y, ckpt, aligned, chunk);
}

// #3: #4's chunk-64 kernel under its own name.
template <typename T>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, CKPT_TILES>()))
scan_step_fwd_kernel(Operands op, T* __restrict__ y,
                     float* __restrict__ ckpt, int aligned, int chunk) {
  scan_lanes_fwd<T, CKPT_TILES>(op, y, ckpt, aligned, TL);
}

template <auto Kernel, typename T>
int launch(const Operands& op, int B, void* y, void* ckpt, int chunk,
           void* stream) {
  if (int e = prepare<Kernel>(smem_bytes<T>())) return e;
  const dim3 grid((op.D + CH - 1) / CH, B);
  Kernel<<<grid, THREADS, smem_bytes<T>(), (cudaStream_t)stream>>>(
      op, (T*)y, (float*)ckpt, (int)is_aligned<T>(op, y, ckpt), chunk);
  return (int)cudaGetLastError();
}

// step: #3 (chunk must be TL), else #4 (the kernel that `chunk` takes).
template <typename T>
int launch_fwd(const Operands& op, int B, void* y, void* ckpt, int chunk,
               void* stream, bool step) {
  if ((int64_t)B * op.L * op.D == 0) return 0;
  if (chunk < 1 || (step && chunk != TL) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (step)
    return launch<scan_step_fwd_kernel<T>, T>(op, B, y, ckpt, chunk, stream);
  if (chunk == TL)
    return launch<scan_fwd_kernel<T, CKPT_TILES>, T>(op, B, y, ckpt, chunk,
                                                     stream);
  return launch<scan_fwd_kernel<T, CKPT_ANY>, T>(op, B, y, ckpt, chunk,
                                                 stream);
}

template <typename T>
int occupancy(int chunk, int* out) {
  return chunk == TL
             ? resources<scan_fwd_kernel<T, CKPT_TILES>>(smem_bytes<T>(), out)
             : resources<scan_fwd_kernel<T, CKPT_ANY>>(smem_bytes<T>(), out);
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan.py, whose
// STEP_TILE_T and D_STATE are TL and N here): #4 (selective_scan_fwd_*) and
// #3 (selective_scan_step_fwd_*, chunk must be TL). u, dt, y are (B, L, D)
// contiguous; Bm and Cm have unit stride along N and the given batch and row
// strides (elements); At (N, D), Dp (D,), ckpt (B, nC, N, D) are contiguous
// f32. Return the launch's cudaError_t (0 = launched).
#define SCAN_FWD_ENTRY(NAME, T, STEP)                                         \
  extern "C" int NAME(const void* u, const void* dt, const void* At,         \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, void* y, void* ckpt, int B, int L, \
                      int D, int chunk, void* stream) {                       \
    return launch_fwd<T>(make_operands(u, dt, At, Bm, Cm, bc_bstride,         \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       D),                                    \
                         B, y, ckpt, chunk, stream, STEP);                    \
  }

SCAN_FWD_ENTRY(selective_scan_fwd_f32, float, false)
SCAN_FWD_ENTRY(selective_scan_fwd_bf16, __nv_bfloat16, false)
SCAN_FWD_ENTRY(selective_scan_step_fwd_f32, float, true)
SCAN_FWD_ENTRY(selective_scan_step_fwd_bf16, __nv_bfloat16, true)

// The build's knobs: out = {R, CH, MIN_BLOCKS}.
extern "C" int selective_scan_fwd_params(int* out) {
  out[0] = R;
  out[1] = CH;
  out[2] = SCAN_LANES_MIN_BLOCKS;
  return 0;
}

// Resources of the kernel that `chunk` takes (64: #4's main-path kernel,
// #3's code), for bf16 (bf16 != 0) or f32 input: out = {blocks an SM, warps
// an SM, registers a thread, local (spill) bytes a thread, shared bytes a
// block}.
extern "C" int selective_scan_fwd_occupancy(int bf16, int chunk, int* out) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? occupancy<__nv_bfloat16>(chunk, out)
              : occupancy<float>(chunk, out);
}
