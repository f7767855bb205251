// Segmented selective scan backward (PackMamba's ScanOp_pack, Mamba-1
// per-channel decay), the `step` schedule, for Hopper (sm_90a): kernel #5.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// src/repro/kernels/selective_scan.py (entry `selective_scan_bwd_pallas`,
// schedule="step"). Same function and outputs as #6 (selective_scan_bwd.cu)
// and the same checkpoint contract as #3 and #4, whose forward feeds it:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   g_t = C_t * dy_t + a_{t+1} * g_{t+1}                       (dL/dh_t)
//   du = dt * sum_n g * B + D * dy      ddt = sum_n g * h_{t-1} * a * A + u * sum_n g * B
//   dB_t = sum_d g * dt * u     dC_t = sum_d h_t * dy     dA = sum_t g * h_{t-1} * a * dt
//   dD = sum_t dy * u
//
// in: u, dt, dy (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//     read through their batch and row strides; Dp (D,) f32; pos (B,L) i32;
//     ckpt (B,nC,N,D) f32, the state at each chunk's entry (nC =
//     ceil(L / chunk); chunk == TL, so a chunk is a tile).
// out: du, ddt (B,L,D) f32; dB, dC partials (B, ceil(D/CH), L, N) f32, one
//     per block of CH channels (summed over that axis by the caller); dA
//     partial (B,N,D) f32; dD partial (B,D) f32 (summed over B).
//
// What bounds it on this card: the instructions each (t, n, d) issues. The
// exponentials (one per (t, n, d): 6.7e8 at mamba-2.8b's training shape
// (B=2, L=4096, D=5120, N=16), ~160 us at the special-function unit's 16 a
// clock per SM) and the bytes (~0.63 GB, ~188 us at 3.35 TB/s) are both
// below what the ~35 lane instructions per (t, n, d) of a time-parallel scan
// cost (291 a state and lane in the compiled loop, for 8 steps): the
// recompute, the adjoint, the lane scans' shuffles and the sums of dB, dC
// over channels. The design below cuts the instructions and keeps enough
// warps on each SM to hide the latency of their dependent chains.
//
// Design (the paper's ScanOp_pack shape: a segmented associative scan over
// time, one exponential per (t, n)):
//   * A block owns one row b and CH = 16 adjacent channels and walks the row
//     in tiles of TL = 64 steps (the checkpoint chunk), last tile first. A
//     channel's tile is split over S = TL / R neighbouring lanes of one warp,
//     R = 8 consecutive steps each: 128 threads, 4 channels a warp, B*D/16
//     blocks, up to 5 blocks an SM (20 warps), so mamba-2.8b's 640 blocks
//     and mamba-1.4b's 512 fit one wave of 660.
//   * Per state n, each lane forms its R decays (kept in registers from the
//     recompute through the adjoint) and folds its steps; a Kogge-Stone scan
//     over the S lanes (shuffles, log2(S) rounds) with the tile's checkpoint
//     folded into lane 0 gives each lane its entry state, and the lane
//     replays its steps. The adjoint carry gc_t = a_t * (C_t*dy_t +
//     gc_{t+1}) runs as the same scan reversed in time, the later tile's
//     carry folded into lane S-1; a reset at t+1 makes gc_{t+1} exactly 0,
//     across lanes and tiles too. Then the lane replays its steps backwards.
//   * dB_t and dC_t (sums over channels): a lane's R terms of each, for a
//     state, are summed over the warp's 32/S channels by a fixed xor-shuffle
//     reduce-scatter (the dC terms during the forward replay, the dB terms
//     during the backward one; each lane ends with the sums of 2 steps),
//     stored in a per-warp slab of shared memory; every GROUP states a
//     barrier lets the block add the warps' slabs in warp order and write
//     them out, GROUP = 8 states (a whole 32-byte sector) of a step a
//     thread, and a second barrier frees the slabs for the next group.
//   * du and ddt leave through shared memory too (B and C's rows, free at
//     the tile's end), a row of 4 channels a thread, so that a warp writes
//     whole sectors.
//   * dA: a state's terms of a tile are summed over the channel's lanes by
//     an xor butterfly and added by lane 0 into its own slot, tile after
//     tile; dD: each thread's slot, then a butterfly at the row's end. No
//     float atomics; bitwise repeatable.
//   * The forward and backward folds of a lane's steps, and the two scans
//     over the lanes, are independent and run interleaved: two chains of
//     dependent instructions where one would leave the warp waiting.
//   * 5 blocks an SM leave 96 registers a thread, which the states' loop
//     fills. So the per-tile code derives its offsets from a fresh %tid.x
//     (tid_now) instead of holding them through that loop: a value held
//     there spills, and its reload misses the 28 KB of L1 that the blocks'
//     shared memory leaves (a spilling build ran 1.3x slower).
//   * Operands: the next tile's u, dt, dy, B, C, positions and checkpoint
//     are copied with cp.async (16-byte, zero-filled past L and D; plain
//     loads when a row is not 16-byte aligned) into one staging buffer while
//     the current tile computes. The copy is issued after the tile's first
//     group barrier: every read of the staging buffer (the lanes' u, dt, dy,
//     positions; the conversion of B, C and the checkpoint) comes before it.
//     At a tile's start B and C are converted to f32 rows by state, so a lane
//     reads its R steps of a state as float4s; u is kept as loaded (bf16:
//     two a register) for ddt at the tile's end.
//   * Ragged L and D are masked, nothing is padded: steps past L are
//     identity steps (a = 1, b = 0, dy = 0); dead channels have A = 0 and
//     u = dt = 0. A reset is a = 0 exactly; nothing divides by a.
//   * exp is ex2.approx of dt * (A log2 e): the argument is small (|.| < ~10).
//
// Build-time knobs (the defaults cite tools/sweep_step_bwd.py's reading in
// PERF.md): STEP_BWD_R the steps a lane (4, 8 or 16), STEP_BWD_CH the
// channels a block (the dB/dC partials' width), STEP_BWD_GROUP the states
// between the block's channel-sum barriers, STEP_BWD_MIN_BLOCKS the launch
// bound for bf16 input.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef STEP_BWD_R
#define STEP_BWD_R 8
#endif
#ifndef STEP_BWD_CH
#define STEP_BWD_CH 16
#endif
#ifndef STEP_BWD_GROUP
#define STEP_BWD_GROUP 8
#endif
#ifndef STEP_BWD_MIN_BLOCKS
#define STEP_BWD_MIN_BLOCKS 5          // bf16 input
#endif

namespace {

constexpr int N = 16;               // d_state
constexpr int TL = 64;              // time tile = the checkpoint chunk
constexpr int R = STEP_BWD_R;       // consecutive steps a lane
constexpr int S = TL / R;           // lanes a channel
constexpr int CH = STEP_BWD_CH;     // channels a block
constexpr int THREADS = CH * S;
constexpr int WARPS = THREADS / 32;
constexpr int CPW = 32 / S;         // channels a warp
constexpr int G = STEP_BWD_GROUP;   // states between channel-sum barriers
constexpr int TLP = TL + 4;         // a row of TL steps, swizzled (tpos)
constexpr int MIN_BLOCKS_F32 = STEP_BWD_MIN_BLOCKS < 4 ? STEP_BWD_MIN_BLOCKS
                                                       : 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(R == 4 || R == 8 || R == 16, "R must be 4, 8 or 16");
static_assert(CH % CPW == 0 && THREADS % 32 == 0, "whole warps a block");
static_assert(N % G == 0, "GROUP must divide N");
static_assert(R / CPW == 2, "a lane ends the channel sums with 2 steps");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Step t's column in a swizzled row of TLP floats: the steps of lanes
// 4..7 (R = 8) move 4 banks, so a quarter-warp's float4 reads of 8 lanes'
// runs meet no bank twice.
__device__ __forceinline__ int tpos(int t) { return t + ((t >> 5) << 2); }

// threadIdx.x, read anew at each call: what the per-tile code derives from
// it is recomputed where it is used, not held (or spilled) through the
// states' loop, which needs the registers.
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// a_t for one state: x = dt * A * log2(e); exactly 0 at a reset
__device__ __forceinline__ float decay(float x, bool reset) {
  const float e = ex2(x);
  float a;                      // a select, not a branch around the ex2
  asm("{\n .reg .pred p;\n setp.ne.s32 p, %2, 0;\n"
      " selp.f32 %0, 0f00000000, %1, p;\n}" : "=f"(a) : "f"(e),
      "r"((int)reset));
  return a;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));   // bytes < 16: the rest zero-filled
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's R values of u, as loaded, for ddt at the tile's end: bf16 two a
// register (exact), f32 one.
template <typename T> struct UKeep {
  float v[R];
  __device__ __forceinline__ void put(int r, float x) { v[r] = x; }
  __device__ __forceinline__ float operator[](int r) const { return v[r]; }
};
template <> struct UKeep<__nv_bfloat16> {
  uint32_t v[R / 2];
  __device__ __forceinline__ void put(int r, float x) {  // x: a bf16 value
    const uint32_t bits = __float_as_uint(x) >> 16;
    v[r / 2] = r % 2 ? v[r / 2] | (bits << 16) : bits;
  }
  __device__ __forceinline__ float operator[](int r) const {
    return __uint_as_float(r % 2 ? v[r / 2] & 0xffff0000u : v[r / 2] << 16);
  }
};

// v[0, 2K) -> v[0, K): lanes whose bit `m` is set keep the upper half of
// the pairs (v[i], v[K + i]), the others the lower, each adding its partner
// lane's (lane ^ m) copy of the half it keeps.
template <int K>
__device__ __forceinline__ void halve(float* v, bool upper, int m) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float keep = upper ? v[K + i] : v[i];
    const float send = upper ? v[i] : v[K + i];
    v[i] = keep + __shfl_xor_sync(FULL, send, m);
  }
}

// N values of a staged (t, N) row of B or C as f32 (16-byte loads).
__device__ __forceinline__ void load_row(const float* src, float* v) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = ((const float4*)src)[q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* src, float* v) {
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const uint4 x = ((const uint4*)src)[q];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * q + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * q + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// K consecutive f32 values to device memory, 16 bytes a store when K is a
// multiple of 4 (dst is then aligned to 4 K bytes).
template <int K>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      ((float4*)dst)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                      v[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) dst[q] = v[q];
  }
}

struct Operands {
  const void* u; const void* dt; const float* At; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, D;
};

struct Out {
  float* du; float* ddt; float* dB; float* dC; float* dA; float* dD;
};

// Shared memory (f32 unless noted), in this order:
//   sA, sgc, sdA, hin (N, CH)  A; the adjoint carry from the later tile
//                              (lane S-1's); lane 0's dA sums; the tile's
//                              entry state (lane 0's)
//   sdD (THREADS)              each thread's dD sum
//   sB, sC (NC, TLP)           the tile's B, C by state, swizzled (tpos);
//                              at the tile's end its du, ddt by channel
//   sred (WARPS, G, 2, TLP)    each warp's dB / dC sums over its channels,
//                              a group of states
//   staging, in the input type T: u, dt, dy (TL rows of CH, 16 bytes of pad
//   after every R rows: a lane's column reads meet no bank twice), B, C
//   (TL, N), pos (TL) int, ckpt (N, CH) f32
constexpr int NC = N > CH ? N : CH;     // rows of sB, sC
constexpr int ROWS_PAD = S;             // pads in a staged (TL, CH) tile
template <typename T> __host__ __device__ constexpr int stage_len() {  // of one
  return TL * CH + ROWS_PAD * (16 / (int)sizeof(T));
}
template <typename T> constexpr size_t smem_bytes() {
  return (4 * N * CH + THREADS + 2 * NC * TLP + WARPS * G * 2 * TLP) * 4 +
         (3 * stage_len<T>() + 2 * TL * N) * sizeof(T) + TL * 4 + N * CH * 4;
}

template <typename T> struct Smem {
  float *sA, *sgc, *sdA, *hin, *sdD, *sB, *sC, *sred, *sck;
  T *su, *sdt, *sdy, *sBr, *sCr;
  int* spos;
  __device__ __forceinline__ explicit Smem(unsigned char* base) {
    float* f = (float*)base;
    sA = f; sgc = sA + N * CH; sdA = sgc + N * CH; hin = sdA + N * CH;
    sdD = hin + N * CH; sB = sdD + THREADS; sC = sB + NC * TLP;
    sred = sC + NC * TLP;
    sck = sred + WARPS * G * 2 * TLP;
    spos = (int*)(sck + N * CH);
    su = (T*)(spos + TL); sdt = su + stage_len<T>();
    sdy = sdt + stage_len<T>(); sBr = sdy + stage_len<T>();
    sCr = sBr + TL * N;
  }
};

// A lane's R steps of one state's row of sB or sC (16-byte loads).
__device__ __forceinline__ void load_run(const float* row, float* v) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 x = ((const float4*)row)[q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}

// The same, stored.
__device__ __forceinline__ void store_run(float* row, const float* v) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q)
    ((float4*)row)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                    v[4 * q + 3]);
}

// Element offset of (step row, channel) in a staged (TL, CH) tile.
__device__ __forceinline__ int srow(int row, int pade) {
  return row * CH + (row / R) * pade;
}

// Issue the copies of tile k (steps [k TL, k TL + TL)) of row b, channels
// [d0, d0 + CH): u, dt, dy, B, C, pos and the checkpoint (zeros past L and
// D; pos 0 past L, read as no reset). `aligned`: every row and start is
// 16-byte aligned, so cp.async (one group, committed by the caller); else
// plain loads into the same buffers.
template <typename T>
__device__ __forceinline__ void stage(const Operands& op, const T* dy,
                                      const float* ckpt, int b, int d0, int k,
                                      int nT, bool aligned, Smem<T>& sm) {
  const int tid = tid_now(), L = op.L, D = op.D, t0 = k * TL;
  constexpr int E16 = 16 / sizeof(T);      // elements a 16-byte copy
  const T* u = (const T*)op.u;
  const T* dt = (const T*)op.dt;
  const T* Bm = (const T*)op.Bm;
  const T* Cm = (const T*)op.Cm;
  const int64_t row0 = (int64_t)b * L;
  const int64_t ck0 = ((int64_t)b * nT + k) * N;
  if (aligned) {
    constexpr int CPR = CH / E16;          // copies a (t, CH) row
    for (int i = tid; i < 3 * TL * CPR; i += THREADS) {
      const int a = i / (TL * CPR), r = i % (TL * CPR);
      const int row = r / CPR, q = r % CPR, t = t0 + row, d = d0 + q * E16;
      const bool ok = t < L && d < D;
      const T* src = a == 0 ? u : a == 1 ? dt : dy;
      T* dst = a == 0 ? sm.su : a == 1 ? sm.sdt : sm.sdy;
      cp16(dst + srow(row, E16) + q * E16, ok ? src + (row0 + t) * D + d : src,
           ok ? 16 : 0);
    }
    constexpr int NPR = N / E16;           // copies a (t, N) row
    for (int i = tid; i < 2 * TL * NPR; i += THREADS) {
      const int a = i / (TL * NPR), r = i % (TL * NPR);
      const int row = r / NPR, q = r % NPR, t = t0 + row;
      const bool ok = t < L;
      const T* src = a == 0 ? Bm : Cm;
      cp16((a == 0 ? sm.sBr : sm.sCr) + row * N + q * E16,
           ok ? src + b * op.bc_bstride + (int64_t)t * op.bc_lstride + q * E16
              : src, ok ? 16 : 0);
    }
    for (int i = tid; i < N * CH / 4; i += THREADS) {
      const int n = i / (CH / 4), d = d0 + 4 * (i % (CH / 4));
      const bool ok = d < D;
      cp16(sm.sck + 4 * i, ok ? ckpt + (ck0 + n) * D + d : ckpt, ok ? 16 : 0);
    }
    if (tid < TL / 4) {
      const int t = t0 + 4 * tid;
      const int bytes = max(0, min(16, (L - t) * 4));
      cp16(sm.spos + 4 * tid,
           bytes ? op.pos + b * op.pos_bstride + t : op.pos, bytes);
    }
    return;
  }
  for (int i = tid; i < 3 * TL * CH; i += THREADS) {
    const int a = i / (TL * CH), r = i % (TL * CH);
    const int row = r / CH, c = r % CH, t = t0 + row, d = d0 + c;
    const T* src = a == 0 ? u : a == 1 ? dt : dy;
    (a == 0 ? sm.su : a == 1 ? sm.sdt : sm.sdy)[srow(row, E16) + c] =
        t < L && d < D ? src[(row0 + t) * D + d] : zero<T>();
  }
  for (int i = tid; i < 2 * TL * N; i += THREADS) {
    const int a = i / (TL * N), r = i % (TL * N);
    const int row = r / N, n = r % N, t = t0 + row;
    const T* src = a == 0 ? Bm : Cm;
    (a == 0 ? sm.sBr : sm.sCr)[r] =
        t < L ? src[b * op.bc_bstride + (int64_t)t * op.bc_lstride + n]
              : zero<T>();
  }
  for (int i = tid; i < N * CH; i += THREADS) {
    const int d = d0 + i % CH;
    sm.sck[i] = d < D ? ckpt[(ck0 + i / CH) * D + d] : 0.f;
  }
  if (tid < TL) {
    const int t = t0 + tid;
    sm.spos[tid] = t < L ? op.pos[b * op.pos_bstride + t] : 0;
  }
}

// Block (blk, b): channels [CH blk, CH blk + CH) of row b, tiles last first.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2
                                               ? STEP_BWD_MIN_BLOCKS
                                               : MIN_BLOCKS_F32)
scan_step_bwd_kernel(Operands op, const float* __restrict__ ckpt,
                     const T* __restrict__ dy, Out out, int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> sm(smem);
  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / S, s = tid % S;
  const int L = op.L, D = op.D;
  const int nT = (L + TL - 1) / TL;     // tiles = chunks
  constexpr int E16 = 16 / sizeof(T);
  for (int i = tid; i < N * CH; i += THREADS) {
    const int dd = d0 + i % CH;
    sm.sA[i] = dd < D ? op.At[(int64_t)(i / CH) * D + dd] : 0.f;
    sm.sgc[i] = 0.f;
    sm.sdA[i] = 0.f;
  }
  sm.sdD[tid] = 0.f;
  // the first of the 2 steps whose channel sums this lane ends with, from
  // the lane bits that picked its halves (halve below)
  int red_step = s * R;
  if (CPW >= 2 && (lane & S)) red_step += R / 2;
  if (CPW >= 4 && (lane & (2 * S))) red_step += R / 4;
  if (CPW >= 8 && (lane & (4 * S))) red_step += R / 8;

  stage<T>(op, dy, ckpt, b, d0, nT - 1, nT, aligned, sm);
  cp_commit();
#pragma unroll 1
  for (int k = nT - 1; k >= 0; --k) {
    const int t0 = k * TL;
    cp_wait_all();
    __syncthreads();    // tile k landed; every read of the last tile done
    for (int i = tid_now(); i < 2 * TL; i += THREADS) {  // a row of B or C
      const int t = i % TL;                             // a thread
      float v[N];
      load_row((i < TL ? sm.sBr : sm.sCr) + t * N, v);
      float* dst = (i < TL ? sm.sB : sm.sC) + tpos(t);
#pragma unroll
      for (int n = 0; n < N; ++n) dst[n * TLP] = v[n];
    }
    for (int i = tid_now(); i < N * CH; i += THREADS) sm.hin[i] = sm.sck[i];
    __syncthreads();    // B, C, hin in place
    float dl[R], du[R], dyv[R], gB[R], dda[R];
    UKeep<T> uk;
    unsigned reset = 0;
    float dDt = 0.f;
    const int lt = tid_now();            // this lane's staged column,
    const int o0 = srow(lt % S * R, E16) + lt / S;   // derived anew
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = s * R + r, o = o0 + r * CH;
      const float uu = to_f32(sm.su[o]);
      dl[r] = to_f32(sm.sdt[o]);
      dyv[r] = to_f32(sm.sdy[o]);
      du[r] = dl[r] * uu;
      uk.put(r, uu);
      dDt = fmaf(dyv[r], uu, dDt);
      gB[r] = 0.f;
      dda[r] = 0.f;
      if (sm.spos[row] == 0 && t0 + row < L) reset |= 1u << r;
    }
    sm.sdD[tid] += dDt;                  // this thread's own slot
#pragma unroll 1
    for (int g0 = 0; g0 < N; g0 += G) {
#pragma unroll 1
      for (int j = 0; j < G; ++j) {
        const int n = g0 + j;
        const float An = sm.sA[n * CH + c], An2 = An * LOG2E;
        const float h_in = sm.hin[n * CH + c];       // lane 0's
        const float gc_later = sm.sgc[n * CH + c];   // lane S-1's
        const float* Brow = sm.sB + n * TLP + tpos(s * R);
        const float* Crow = sm.sC + n * TLP + tpos(s * R);
        float Bv[R], Cv[R], a[R], hp[R + 1];
        load_run(Brow, Bv);
        load_run(Crow, Cv);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = decay(dl[r] * An2, (reset >> r) & 1);
        // fold this lane's steps both ways at once: forward (Af, Bf) maps the
        // state before the lane's first step to the one after its last;
        // backward (Ar, Gr) maps the carry gc after its last step to gc_t at
        // its first, gc_t = a_t * (C_t dy_t + gc_{t+1})
        float Af = a[0], Bf = Bv[0] * du[0];
        float Ar = a[R - 1], Gr = a[R - 1] * (Cv[R - 1] * dyv[R - 1]);
#pragma unroll
        for (int r = 1; r < R; ++r) {
          Bf = fmaf(a[r], Bf, Bv[r] * du[r]);
          Af *= a[r];
          Gr = a[R - 1 - r] * fmaf(Cv[R - 1 - r], dyv[R - 1 - r], Gr);
          Ar *= a[R - 1 - r];
        }
        // the checkpoint into lane 0, the later tile's carry into lane S-1;
        // both scans over the S lanes at once
        if (s == 0) Bf = fmaf(Af, h_in, Bf);
        if (s == S - 1) Gr = fmaf(Ar, gc_later, Gr);
#pragma unroll
        for (int off = 1; off < S; off *= 2) {
          const float Ap = __shfl_up_sync(FULL, Af, off, S);
          const float Bp = __shfl_up_sync(FULL, Bf, off, S);
          const float An_ = __shfl_down_sync(FULL, Ar, off, S);
          const float Gn = __shfl_down_sync(FULL, Gr, off, S);
          if (s >= off) {
            Bf = fmaf(Af, Bp, Bf);
            Af *= Ap;
          }
          if (s + off < S) {
            Gr = fmaf(Ar, Gn, Gr);
            Ar *= An_;
          }
        }
        hp[0] = __shfl_up_sync(FULL, Bf, 1, S);       // the previous lane's
        if (s == 0) hp[0] = h_in;                      // last state
        float gc = __shfl_down_sync(FULL, Gr, 1, S);   // the next lane's first
        if (s == S - 1) gc = gc_later;                 // step's carry
        const float gc_tile = __shfl_sync(FULL, Gr, 0, S);
        if (s == S - 1)                 // for the earlier tile, by the lane
          sm.sgc[n * CH + c] = gc_tile;  // that reads it
        // replay forwards: h_t, and the dC terms h_t dy_t summed over the
        // warp's CPW channels (lane bits S, 2S, ...) by a reduce-scatter to
        // 2 sums a lane, of 2 consecutive steps
        float pC[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          hp[r + 1] = fmaf(a[r], hp[r], Bv[r] * du[r]);
          pC[r] = hp[r + 1] * dyv[r];
        }
        if constexpr (CPW >= 2) halve<R / 2>(pC, lane & S, S);
        if constexpr (CPW >= 4) halve<R / 4>(pC, lane & (2 * S), 2 * S);
        if constexpr (CPW >= 8) halve<R / 8>(pC, lane & (4 * S), 4 * S);
        // replay backwards: g, the per-step sums over states, and the dB
        // terms g dt u, summed over channels as the dC terms were
        float pB[R], dAn = 0.f;
        load_run(Brow, Bv);         // B and C again: not held through the
        load_run(Crow, Cv);         // scans
#pragma unroll
        for (int r = R - 1; r >= 0; --r) {
          const float g = fmaf(Cv[r], dyv[r], gc);     // dL/dh_t
          const float ta = g * hp[r] * a[r];           // times h_{t-1} a
          dda[r] = fmaf(ta, An, dda[r]);
          dAn = fmaf(ta, dl[r], dAn);
          gB[r] = fmaf(g, Bv[r], gB[r]);
          pB[r] = g * du[r];
          gc = a[r] * g;
        }
        if constexpr (CPW >= 2) halve<R / 2>(pB, lane & S, S);
        if constexpr (CPW >= 4) halve<R / 4>(pB, lane & (2 * S), 2 * S);
        if constexpr (CPW >= 8) halve<R / 8>(pB, lane & (4 * S), 4 * S);
        float* slab = sm.sred + (warp * G + j) * 2 * TLP + tpos(red_step);
        *(float2*)slab = make_float2(pB[0], pB[1]);
        *(float2*)(slab + TLP) = make_float2(pC[0], pC[1]);
        // dA: this tile's terms over the channel's lanes, then into lane 0's
        // slot
#pragma unroll
        for (int m = S / 2; m >= 1; m /= 2)
          dAn += __shfl_xor_sync(FULL, dAn, m, S);
        if (s == 0) sm.sdA[n * CH + c] += dAn;
      }
      __syncthreads();  // the group's slabs written; after the first group
      //                   every read of the staging buffer is done
      if (g0 == 0 && k > 0) {
        stage<T>(op, dy, ckpt, b, d0, k - 1, nT, aligned, sm);
        cp_commit();
      }
      // dB_t, dC_t of the group's states: the warps' sums added in warp
      // order, G states of one step a thread (whole 32-byte sectors out)
      for (int i = tid_now(); i < 2 * TL; i += THREADS) {  // a (kind,
        const int kind = i / TL, t = i % TL;               // step) a thread
        if (t0 + t < L) {
          float acc[G];
#pragma unroll
          for (int j = 0; j < G; ++j)
            acc[j] = sm.sred[(j * 2 + kind) * TLP + tpos(t)];
#pragma unroll
          for (int w = 1; w < WARPS; ++w)
#pragma unroll
            for (int j = 0; j < G; ++j)
              acc[j] += sm.sred[((w * G + j) * 2 + kind) * TLP + tpos(t)];
          float* dst = (kind == 0 ? out.dB : out.dC) +
                       (((int64_t)b * nblk + blk) * L + t0 + t) * N + g0;
          store_row<G>(dst, acc);
        }
      }
      if (g0 + G < N) __syncthreads();   // the slabs read before the next
    }                                    // group writes them
    // du, ddt of this lane's steps, by channel into sB, sC (every read of
    // them ended at the last group's barrier), then out a row of 4
    // channels a thread
    {
      const float Dd = d0 + c < D ? op.Dp[d0 + c] : 0.f;
      float o[R];
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = fmaf(dl[r], gB[r], Dd * dyv[r]);
      store_run(sm.sB + c * TLP + tpos(s * R), o);
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = fmaf(uk[r], gB[r], dda[r]);
      store_run(sm.sC + c * TLP + tpos(s * R), o);
    }
    __syncthreads();
    for (int i = tid_now(); i < 2 * TL * (CH / 4); i += THREADS) {
      const int q = i % (CH / 4), t = (i / (CH / 4)) % TL;
      const int which = i / (TL * (CH / 4)), d4 = d0 + 4 * q;
      if (t0 + t < L && d4 < D) {
        const float* src = (which ? sm.sC : sm.sB) + 4 * q * TLP + tpos(t);
        float* dst = (which ? out.ddt : out.du) + ((int64_t)b * L + t0 + t) *
                     D + d4;
        if (D % 4 == 0) {       // then d4 + 4 <= D, dst 16-byte aligned
          *(float4*)dst = make_float4(src[0], src[TLP], src[2 * TLP],
                                      src[3 * TLP]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d4 + e < D) dst[e] = src[e * TLP];
        }
      }
    }
  }
  // dA from lane 0's slots (its own writes); dD: this thread's slot, then
  // a xor butterfly over the channel's lanes (every lane gets the same
  // bits). The channel is derived anew: nothing is held through the loop.
  const int c_end = tid_now() / S, d_end = d0 + c_end;
  const bool out_end = d_end < D && tid_now() % S == 0;
  if (out_end) {
#pragma unroll 4
    for (int n = 0; n < N; ++n)
      out.dA[((int64_t)b * N + n) * D + d_end] = sm.sdA[n * CH + c_end];
  }
  float dD = sm.sdD[tid_now()];
#pragma unroll
  for (int m = S / 2; m >= 1; m /= 2) dD += __shfl_xor_sync(FULL, dD, m, S);
  if (out_end) out.dD[(int64_t)b * D + d_end] = dD;
}

// ------------------------------------------------------------ launches

Operands make_operands(const void* u, const void* dt, const void* At,
                       const void* Bm, const void* Cm, int64_t bc_bstride,
                       int64_t bc_lstride, const void* Dp, const void* pos,
                       int64_t pos_bstride, int L, int D) {
  return Operands{u, dt, (const float*)At, Bm, Cm, bc_bstride, bc_lstride,
                  (const float*)Dp, (const int32_t*)pos, pos_bstride, L, D};
}

template <typename T>
bool is_aligned(const Operands& op, const void* dy, const void* ckpt) {
  const uintptr_t p = (uintptr_t)op.u | (uintptr_t)op.dt | (uintptr_t)dy |
                      (uintptr_t)op.Bm | (uintptr_t)op.Cm |
                      (uintptr_t)op.pos | (uintptr_t)ckpt;
  const int64_t es = sizeof(T);
  return p % 16 == 0 && op.D * es % 16 == 0 && op.D % 4 == 0 &&
         op.bc_bstride * es % 16 == 0 && op.bc_lstride * es % 16 == 0 &&
         op.pos_bstride % 4 == 0;
}

template <typename T>
int prepare() {
  static bool done = false;     // raised once, outside any graph capture
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      scan_step_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_step_bwd_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <typename T>
int launch_bwd(const Operands& op, int B, const void* ckpt, const void* dy,
               const Out& out, int chunk, void* stream) {
  if ((int64_t)B * op.L * op.D == 0) return 0;
  if (chunk != TL || B > 65535) return (int)cudaErrorInvalidValue;
  if (int e = prepare<T>()) return e;
  const dim3 grid((op.D + CH - 1) / CH, B);
  scan_step_bwd_kernel<T><<<grid, THREADS, smem_bytes<T>(),
                            (cudaStream_t)stream>>>(
      op, (const float*)ckpt, (const T*)dy, out,
      (int)is_aligned<T>(op, dy, ckpt));
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  if (int e = prepare<T>()) return e;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, scan_step_bwd_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], scan_step_bwd_kernel<T>, THREADS, smem_bytes<T>());
  out[1] = out[0] * WARPS;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)(fa.sharedSizeBytes + smem_bytes<T>());
  return (int)e;
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan.py, whose
// STEP_BLOCK_D, STEP_TILE_T and D_STATE are CH, TL and N here). The
// arguments are those of selective_scan_bwd.cu's entry without its scratch;
// chunk must be TL. Return the launch's cudaError_t (0 = launched).
#define STEP_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* u, const void* dt, const void* At,         \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, const void* ckpt, const void* dy,  \
                      void* du, void* ddt, void* dB, void* dC, void* dA,      \
                      void* dD, int B, int L, int D, int chunk,               \
                      void* stream) {                                         \
    return launch_bwd<T>(make_operands(u, dt, At, Bm, Cm, bc_bstride,         \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       D),                                    \
                         B, ckpt, dy,                                         \
                         Out{(float*)du, (float*)ddt, (float*)dB,             \
                             (float*)dC, (float*)dA, (float*)dD},             \
                         chunk, stream);                                      \
  }

STEP_BWD_ENTRY(selective_scan_step_bwd_f32, float)
STEP_BWD_ENTRY(selective_scan_step_bwd_bf16, __nv_bfloat16)

// The build's knobs: out = {R, CH, GROUP, MIN_BLOCKS}.
extern "C" int selective_scan_step_bwd_params(int* out) {
  out[0] = R;
  out[1] = CH;
  out[2] = G;
  out[3] = STEP_BWD_MIN_BLOCKS;
  return 0;
}

// Resources of the kernel for bf16 (bf16 != 0) or f32 input: out = {blocks
// an SM, warps an SM, registers a thread, local (spill) bytes a thread,
// shared bytes a block}.
extern "C" int selective_scan_step_bwd_occupancy(int bf16, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(out) : occupancy<float>(out);
}
