// Segmented selective scan backward (PackMamba's ScanOp_pack, Mamba-1
// per-channel decay), `blocked` schedule, for Hopper (sm_90a): kernel #6.
//
// Replaces the Pallas TPU kernel `_bwd_kernel_blocked` of
// src/repro/kernels/selective_scan.py (entry `selective_scan_bwd_pallas`,
// schedule="blocked"). Same function, same outputs as before:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   g_t = C_t * dy_t + a_{t+1} * g_{t+1}                       (dL/dh_t)
//   du = dt * sum_n g * B + D * dy      ddt = sum_n g * h_{t-1} * a * A + u * sum_n g * B
//   dB_t = sum_d g * dt * u     dC_t = sum_d h_t * dy     dA = sum_t g * h_{t-1} * a * dt
//   dD = sum_t dy * u
//
// in: u, dt, dy (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//     read through their batch and row strides; Dp (D,) f32; pos (B,L) i32;
//     ckpt (B,nC,N,D) f32, the state at each chunk's entry (#4 or #3 wrote
//     it; nC = ceil(L / chunk), chunk a multiple of 16).
// out: du, ddt (B,L,D) f32; dB, dC partials (B, ceil(D/CH), L, N) f32, one per
//     block of CH channels; dA partials (B, nG, N, D) and dD partials
//     (B, nG, D) f32, one per group of GROUP chunks (nG = ceil(nC / GROUP)),
//     summed over nG by the caller in a fixed order.
// scratch: E, P (B,nC,N,D) f32; Bf, Cf (B,L,N) f32.
//
// The arithmetic. For one (b, d, n), chunk c covers steps [t0, t1). Its
// adjoint splits as g_t = g^loc_t + Phi_t * G_c, where g^loc is the chunk's
// adjoint with zero carry-in, Phi_t = prod_{s=t+1}^{t1-1} a_s, and
// G_c = a_{t1} * g_{t1} is the carry handed down from chunk c+1. Hence
//   G_{c-1} = E_c + P_c * G_c,  E_c = a_{t0} * g^loc_{t0},  P_c = prod_{s=t0}^{t1-1} a_s.
// A reset inside the chunk makes P_c exactly 0 (a is exactly 0 there), and
// nothing is divided by a. Every output is a function of g and h, so given
// G_c and the checkpoint each chunk is independent: du, ddt, dA and dB are
// linear in g, dC needs h only.
//
// What bounds it: not bytes. The function moves ~0.45 GB at (2, 4096, 4096)
// bf16 (~0.15 ms at 3.35 TB/s) but is a recurrence over L; one block walking
// a whole row (the design this replaced) left 8 warps an SM each on a
// 3 x 4096-step chain, so latency bound it. Split into chunks, the work is
// bound by the instructions each (t, n, d) issues (the recompute, the
// adjoint, and the sums of dB, dC over channels) and by the registers that
// hold a tile: 128 a thread for 16 warps an SM. The tensor cores do not fit:
// Mamba-1's decay differs for each (n, d), so no step is a shared matrix
// product.
//
// Design: three launches on the caller's stream.
//   1. carry (scan_bwd_carry_kernel): one thread per (b, chunk, d) walks the
//      chunk in reverse with its 16 states in registers, reading only dt,
//      C, dy and pos, and writes (E_c, P_c); P_c as one ex2 of A times the
//      chunk's summed dt (0 if it holds a reset). Steps past L are identity
//      steps (a = 1, dy = 0), so a ragged last chunk hands the right carry
//      down. Its first channel block also writes B and C as f32 (Bf, Cf):
//      every thread of the chunk kernel reads each B_t, C_t, which then
//      need no conversion there.
//   2. combine (scan_bwd_combine_kernel): one thread per (b, n, d) runs
//      G_{c-1} = E_c + P_c * G_c from the last chunk down, in that fixed
//      order, and writes each chunk's G_c over E_c.
//   3. chunks (scan_bwd_chunk_kernel): a block owns (b, CH = 32 channels,
//      GROUP consecutive chunks); each channel's 16 states are split over 4
//      neighbouring threads (4 states each), 128 threads a block. Per chunk
//      (last first), the state enters from the checkpoint and the carry from
//      G_c: a walk forward saves the state at every TT-step tile entry in
//      shared memory (thread-private slots); then, tile by tile in reverse,
//      the thread recomputes the tile's states and decays into registers
//      (unrolled, indexed at compile time) and runs the adjoint back over
//      them. u, dt, dy, B, C and pos of the next tile (and a chunk's
//      checkpoint and carry rows) are staged with cp.async into a double
//      buffer while the current tile computes (aligned operands; else plain
//      loads into the same buffers). dB_t and
//      dC_t are reduced over a warp's 8 channels by an xor-shuffle
//      reduce-scatter (7 shuffles for 8 sums), then over the 4 warps in
//      order through shared memory.
// Exponentials: at most three per (t, n): the carry pass, the walk to the
// tile entries (all but the chunk's last tile) and the tile recompute; the
// adjoint reuses the recompute's decays. 3 - TT/chunk per (t, n) in all,
// and one per (chunk, n) for P_c.
// No float atomics: every sum has a fixed order, results repeat bitwise.
// exp is ex2.approx of dt * log2(e) * A: the argument is small (|.| < ~10).
//
// Build-time knobs (the defaults cite tools/sweep_scan_bwd.py's reading in
// PERF.md): SCAN_BWD_TT the tile length (4, 8 or 16), SCAN_BWD_GROUP the
// chunks a block, SCAN_BWD_MIN_BLOCKS the launch bound of the chunk kernel
// for bf16 input.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef SCAN_BWD_TT
#define SCAN_BWD_TT 8
#endif
#ifndef SCAN_BWD_GROUP
#define SCAN_BWD_GROUP 4
#endif
#ifndef SCAN_BWD_MIN_BLOCKS
#define SCAN_BWD_MIN_BLOCKS 4          // bf16 input
#endif

namespace {

constexpr int N = 16;              // d_state
constexpr int G = 4;               // threads per channel (chunk kernel)
constexpr int NPT = N / G;         // states per thread
constexpr int CH = 32;             // channels per block = dB/dC partial width
constexpr int THREADS = CH * G;    // 128
constexpr int WARPS = THREADS / 32;
constexpr int TT = SCAN_BWD_TT;    // time tile of the chunk kernel
constexpr int GROUP = SCAN_BWD_GROUP;
constexpr int MIN_BLOCKS_F32 = 2;  // f32 input: 3 or 4 spill registers
constexpr int CT = 128;            // channels (threads) per carry block
constexpr int CSUB = 16;           // steps the carry pass stages at a time
constexpr int CHALF = 8;           // of which it holds dt, dy in registers
constexpr int CMB = 256;           // threads per combine block
constexpr int PF = 16;             // chunks the combine loads ahead
constexpr float LOG2E = 1.4426950408889634f;
static_assert(16 % TT == 0 && TT % 4 == 0, "TT must be 4, 8 or 16");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// 4 consecutive f32 values of shared memory (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *(const float4*)p;
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// a_t for one state: dlL = dt * log2(e); exactly 0 at a reset
__device__ __forceinline__ float decay(float dlL, float A, bool reset) {
  const float e = ex2(dlL * A);
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

struct Operands {
  const void* u; const void* dt; const float* At; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, D;
};

struct Out {
  float* du; float* ddt; float* dB; float* dC; float* dA; float* dD;
};

// ------------------------------------------------------------- 1. carry

template <typename T>
__global__ void __launch_bounds__(CT)
scan_bwd_carry_kernel(Operands op, const T* __restrict__ dy,
                      float* __restrict__ E, float* __restrict__ P,
                      float* __restrict__ Bf, float* __restrict__ Cf,
                      int chunk) {
  __shared__ __align__(16) float sC[CSUB * N];
  __shared__ int spos[CSUB];
  const int d = blockIdx.x * CT + threadIdx.x, ci = blockIdx.y;
  const int b = blockIdx.z, nC = gridDim.y;
  const int L = op.L, D = op.D;
  const bool live = d < D;
  const T* dt = (const T*)op.dt;
  const T* Bm = (const T*)op.Bm;
  const T* Cm = (const T*)op.Cm;
  float A[N], cg[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? op.At[n * D + d] : 0.f;
    cg[n] = 0.f;       // a_{t+1} * g^loc_{t+1}
  }
  // P_c = prod_s a_s = 0 after a reset, else ex2(A * sum_s dt_s log2(e))
  float xsum = 0.f;
  bool reset_seen = false;
  const int t0 = ci * chunk, t1 = min(L, t0 + chunk);
  for (int ts = t0 + (t1 - t0 - 1) / CSUB * CSUB; ts >= t0; ts -= CSUB) {
    __syncthreads();                      // the last subtile's readers done
    for (int i = threadIdx.x; i < CSUB * N; i += CT) {
      const int t = ts + i / N;
      const int64_t k =
          b * op.bc_bstride + (int64_t)t * op.bc_lstride + i % N;
      const float cv = t < t1 ? to_f32(Cm[k]) : 0.f;
      sC[i] = cv;
      if (blockIdx.x == 0 && t < t1) {
        const int64_t kf = ((int64_t)b * L + t) * N + i % N;
        Cf[kf] = cv;
        Bf[kf] = to_f32(Bm[k]);
      }
    }
    if (threadIdx.x < CSUB) {
      const int t = ts + threadIdx.x;
      spos[threadIdx.x] = t < t1 ? op.pos[b * op.pos_bstride + t] : 1;
    }
    __syncthreads();
#pragma unroll
    for (int s0 = CSUB - CHALF; s0 >= 0; s0 -= CHALF) {
      float dl[CHALF], dyv[CHALF];
#pragma unroll
      for (int q = 0; q < CHALF; ++q) {
        const int t = ts + s0 + q;
        const bool ok = live && t < t1;
        const int64_t k = ((int64_t)b * L + t) * D + d;
        dl[q] = ok ? to_f32(dt[k]) : 0.f;      // 0 past t1: a = 1
        dyv[q] = ok ? to_f32(dy[k]) : 0.f;
      }
#pragma unroll
      for (int q = CHALF - 1; q >= 0; --q) {
        const float dlL = dl[q] * LOG2E;
        const bool reset = spos[s0 + q] == 0;
        xsum += dlL;
        reset_seen |= reset;
        float Cv[N];
#pragma unroll
        for (int r = 0; r < N / 4; ++r)
          load4(sC + (s0 + q) * N + 4 * r, Cv + 4 * r);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float a = decay(dlL, A[n], reset);
          const float g = fmaf(Cv[n], dyv[q], cg[n]);
          cg[n] = a * g;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int64_t k = (((int64_t)b * nC + ci) * N + n) * D + d;
      E[k] = cg[n];
      P[k] = decay(xsum, A[n], reset_seen);
    }
  }
}

// ----------------------------------------------------------- 2. combine

// E (B, nC, N*D) in: E_c; out: G_c (the carry into chunk c's last step).
__global__ void __launch_bounds__(CMB)
scan_bwd_combine_kernel(float* __restrict__ E, const float* __restrict__ P,
                        int nC, int64_t ND, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * CMB + threadIdx.x;
  if (i >= total) return;
  const int64_t off = i / ND * nC * ND + i % ND;
  float* e = E + off;
  const float* p = P + off;
  float Gc = 0.f;                            // nothing after the last chunk
  for (int c1 = nC; c1 > 0; c1 -= PF) {      // chunks c1-1 down to c1-PF
    float ev[PF], pv[PF];
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int c = c1 - 1 - q;
      ev[q] = c >= 0 ? e[c * ND] : 0.f;
      pv[q] = c >= 0 ? p[c * ND] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int c = c1 - 1 - q;
      if (c >= 0) {
        e[c * ND] = Gc;
        Gc = fmaf(pv[q], Gc, ev[q]);
      }
    }
  }
}

// ------------------------------------------------------------ 3. chunks

// One tile's staged operands, u, dt, dy in the input type, B and C f32;
// for a chunk's first item also its checkpoint and carry (N, CH) f32.
template <typename T> struct __align__(16) Stage {
  T u[TT * CH]; T dt[TT * CH]; T dy[TT * CH];
  float B[TT * N]; float C[TT * N];
  int pos[TT];
  float ck[N * CH]; float G[N * CH];
};

// Shared memory of the chunk kernel, after the two Stage buffers (floats):
//   sred (WARPS, TT, 2N)   each warp's dB_t / dC_t sums over its 8 channels
//   sdu, sddt (TT, CH)     the tile's du, ddt on their way out
//   carry (3 NPT + 1, THREADS)  a thread's walk state, adjoint carry, dA, dD
//   hsub (chunk/TT, NPT, THREADS)  the state at each tile entry, one slot a
//                          thread and state
template <typename T>
__host__ __device__ inline size_t chunk_smem_bytes(int chunk) {
  return 2 * sizeof(Stage<T>) +
         ((size_t)WARPS * TT * 2 * N + 2 * TT * CH + (3 * NPT + 1) * THREADS +
          (size_t)(chunk / TT) * NPT * THREADS) * sizeof(float);
}

// Issue the copies of steps [t0, t0 + TT) of row b, channels [d0, d0 + CH):
// u, dt, B (f32, from Bf) and pos, and with `full` also dy and C (from Cf).
// Past L and D: zeros (pos 0 there is read as no reset by the compute).
// `aligned`: every row and start of u, dt, dy, pos is 16-byte aligned, so
// cp.async (one group, committed by the caller); else plain loads for them.
template <typename T>
__device__ __forceinline__ void stage(const Operands& op, const T* dy,
                                      const float* Bf, const float* Cf, int b,
                                      int d0, int t0, bool full, bool aligned,
                                      Stage<T>& st) {
  const int tid = threadIdx.x, L = op.L, D = op.D;
  const T* u = (const T*)op.u;
  const T* dt = (const T*)op.dt;
  const int na = full ? 3 : 2, nbc = full ? 2 : 1;
  const int64_t row0 = (int64_t)b * L;
  // B and C rows (f32, contiguous, so always aligned)
  for (int i = tid; i < nbc * TT * (N / 4); i += THREADS) {
    const int a = i / (TT * N / 4), r = i % (TT * N / 4);
    const int s = r / (N / 4), q = r % (N / 4), t = t0 + s;
    const bool ok = t < L;
    const float* src = a == 0 ? Bf : Cf;
    cp16((a == 0 ? st.B : st.C) + s * N + 4 * q,
         ok ? src + (row0 + t) * N + 4 * q : src, ok ? 16 : 0);
  }
  if (aligned) {
    constexpr int E16 = 16 / sizeof(T);      // elements a 16-byte copy
    constexpr int CPR = CH / E16;
    for (int i = tid; i < na * TT * CPR; i += THREADS) {
      const int a = i / (TT * CPR), r = i % (TT * CPR);
      const int s = r / CPR, q = r % CPR, t = t0 + s, d = d0 + q * E16;
      const bool ok = t < L && d < D;
      const T* src = a == 0 ? u : a == 1 ? dt : dy;
      T* dst = a == 0 ? st.u : a == 1 ? st.dt : st.dy;
      cp16(dst + s * CH + q * E16, ok ? src + (row0 + t) * D + d : src,
           ok ? 16 : 0);
    }
    if (tid < TT / 4) {
      const int t = t0 + 4 * tid;
      const int bytes = max(0, min(16, (L - t) * 4));
      cp16(st.pos + 4 * tid,
           bytes ? op.pos + b * op.pos_bstride + t : op.pos, bytes);
    }
    return;
  }
  for (int i = tid; i < na * TT * CH; i += THREADS) {
    const int a = i / (TT * CH), r = i % (TT * CH);
    const int t = t0 + r / CH, d = d0 + r % CH;
    const T* src = a == 0 ? u : a == 1 ? dt : dy;
    (a == 0 ? st.u : a == 1 ? st.dt : st.dy)[r] =
        t < L && d < D ? src[(row0 + t) * D + d] : zero<T>();
  }
  if (tid < TT) {
    const int t = t0 + tid;
    st.pos[tid] = t < L ? op.pos[b * op.pos_bstride + t] : 0;
  }
}

// Issue the copies of chunk ci's checkpoint and carry rows (N, CH) f32 for
// channels [d0, d0 + CH) of row b (0 past D).
template <typename T>
__device__ __forceinline__ void stage_entry(const float* ckpt,
                                            const float* Gc, int b, int ci,
                                            int nC, int d0, int D,
                                            bool aligned, Stage<T>& st) {
  const int tid = threadIdx.x;
  const int64_t row0 = ((int64_t)b * nC + ci) * N;
  if (aligned) {
    for (int i = tid; i < 2 * N * CH / 4; i += THREADS) {
      const int a = i / (N * CH / 4), r = i % (N * CH / 4);
      const int n = r / (CH / 4), d = d0 + 4 * (r % (CH / 4));
      const float* src = a == 0 ? ckpt : Gc;
      const bool ok = d < D;
      cp16((a == 0 ? st.ck : st.G) + 4 * r,
           ok ? src + (row0 + n) * D + d : src, ok ? 16 : 0);
    }
    return;
  }
  for (int i = tid; i < 2 * N * CH; i += THREADS) {
    const int a = i / (N * CH), r = i % (N * CH), d = d0 + r % CH;
    (a == 0 ? st.ck : st.G)[r] =
        d < D ? (a == 0 ? ckpt : Gc)[(row0 + r / CH) * D + d] : 0.f;
  }
}

__device__ __forceinline__ int tiles_in(int ci, int chunk, int L) {
  return (min(L, ci * chunk + chunk) - ci * chunk + TT - 1) / TT;
}

// The item after (ci, idx) in a block's order: a chunk's items are the walk
// over tiles 0 .. ns-2, then tiles ns-1 .. 0 in reverse; chunks last first.
__device__ __forceinline__ void advance(int& ci, int& idx, int chunk, int L) {
  if (++idx == 2 * tiles_in(ci, chunk, L) - 1) {
    --ci;
    idx = 0;
  }
}

// Block (blk, grp, b): channels [32 blk, 32 blk + 32) of row b, chunks
// [GROUP grp, GROUP grp + GROUP) ∩ [0, nC), last first. Each chunk is a list
// of items: the walk over tiles 0 .. ns-2, then tiles ns-1 .. 0 in reverse;
// item i+1's operands are in flight while item i computes. What a thread
// carries from item to item (the walk's state, the adjoint's carry, its dA
// and dD sums) waits in its own slots of shared memory, so that registers
// hold one tile's trajectory and decays and little else.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2
                                               ? SCAN_BWD_MIN_BLOCKS
                                               : MIN_BLOCKS_F32)
scan_bwd_chunk_kernel(Operands op, const float* __restrict__ ckpt,
                      const float* __restrict__ Gc, const T* __restrict__ dy,
                      const float* __restrict__ Bf,
                      const float* __restrict__ Cf, Out out, int chunk,
                      int aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T>* st = (Stage<T>*)smem;
  float* sred = (float*)(st + 2);
  float* sdu = sred + WARPS * TT * 2 * N;
  float* sddt = sdu + TT * CH;
  float* carry = sddt + TT * CH;          // h, gc, dA, dD (3 NPT + 1 rows)
  float* hsub = carry + (3 * NPT + 1) * THREADS;

  const int blk = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int nblk = gridDim.x, ngrp = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / G, g = tid % G, d0 = blk * CH, d = d0 + c;
  const int L = op.L, D = op.D;
  const int nC = (L + chunk - 1) / chunk;
  const bool live = d < D;
  // this thread's slot of a (rows, THREADS) buffer
  auto slot = [&](float* buf, int row) -> float& {
    return buf[row * THREADS + tid];
  };
  float* hcar = carry;                    // rows 0 .. NPT-1
  float* gcar = carry + NPT * THREADS;
  float* acar = carry + 2 * NPT * THREADS;
#pragma unroll
  for (int j = 0; j < NPT; ++j) slot(acar, j) = 0.f;
  slot(carry, 3 * NPT) = 0.f;             // dD

  const int c_lo = grp * GROUP, c_hi = min(nC, c_lo + GROUP) - 1;
  // stage item (sci, sidx) into st[sbuf] (one cp.async group)
  auto issue = [&](int sci, int sidx, int sbuf) {
    const int ns = tiles_in(sci, chunk, L);
    const bool rev = sidx >= ns - 1;
    const int k = rev ? 2 * ns - 2 - sidx : sidx;
    stage<T>(op, dy, Bf, Cf, b, d0, sci * chunk + k * TT, rev, aligned,
             st[sbuf]);
    if (sidx == 0)
      stage_entry<T>(ckpt, Gc, b, sci, nC, d0, D, aligned, st[sbuf]);
    cp_commit();
  };
  int ci = c_hi, idx = 0, buf = 0;
  issue(ci, idx, 0);
#pragma unroll 1
  while (ci >= c_lo) {
    const int ns = tiles_in(ci, chunk, L);
    int nci = ci, nidx = idx;
    advance(nci, nidx, chunk, L);
    cp_wait_all();
    __syncthreads();          // this item landed; the last item's readers done
    if (nci >= c_lo)          // the next item, into the last one's buffer
      issue(nci, nidx, buf ^ 1);
    const Stage<T>& S = st[buf];
    float A[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      A[j] = live ? op.At[(g * NPT + j) * D + d] : 0.f;
    if (idx == 0) {           // chunk entry: checkpoint and carry
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float h0 = S.ck[(g * NPT + j) * CH + c];
        slot(hcar, j) = h0;
        slot(hsub, j) = h0;
        slot(gcar, j) = S.G[(g * NPT + j) * CH + c];
      }
    }
    if (idx < ns - 1) {
      // walk tile idx forward; save the next tile's entry state
      const int t0 = ci * chunk + idx * TT;
      float h[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) h[j] = slot(hcar, j);
#pragma unroll
      for (int s = 0; s < TT; ++s) {
        const float dl = to_f32(S.dt[s * CH + c]);
        const float du = dl * to_f32(S.u[s * CH + c]);
        const bool reset = S.pos[s] == 0 && t0 + s < L;
        float Bv[NPT];
        load4(S.B + s * N + g * NPT, Bv);
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          h[j] = fmaf(decay(dl * LOG2E, A[j], reset), h[j], Bv[j] * du);
      }
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        slot(hcar, j) = h[j];
        slot(hsub, (idx + 1) * NPT + j) = h[j];
      }
    } else {
      const int k = 2 * ns - 2 - idx;
      const int t0 = ci * chunk + k * TT;
      // recompute the tile's states and decays into registers
      float hs[TT + 1][NPT], av[TT][NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) hs[0][j] = slot(hsub, k * NPT + j);
#pragma unroll
      for (int s = 0; s < TT; ++s) {
        const float dl = to_f32(S.dt[s * CH + c]);
        const float du = dl * to_f32(S.u[s * CH + c]);
        const bool reset = S.pos[s] == 0 && t0 + s < L;
        float Bv[NPT];
        load4(S.B + s * N + g * NPT, Bv);
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          av[s][j] = decay(dl * LOG2E, A[j], reset);
          hs[s + 1][j] = fmaf(av[s][j], hs[s][j], Bv[j] * du);
        }
      }
      // the adjoint, back over the registers
      const float Dd = live ? op.Dp[d] : 0.f;
      const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1;
      const int b4 = (lane >> 4) & 1;
      float gc[NPT], dA[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        gc[j] = slot(gcar, j);
        dA[j] = slot(acar, j);
      }
      float dD = slot(carry, 3 * NPT);
#pragma unroll
      for (int s = TT - 1; s >= 0; --s) {
        const float dl = to_f32(S.dt[s * CH + c]);
        const float uu = to_f32(S.u[s * CH + c]);
        const float dyv = to_f32(S.dy[s * CH + c]);
        const float du = dl * uu;
        float Bv[NPT], Cv[NPT], v[2 * NPT];
        load4(S.B + s * N + g * NPT, Bv);
        load4(S.C + s * N + g * NPT, Cv);
        float gB = 0.f, dd = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const float gg = fmaf(Cv[j], dyv, gc[j]);      // dL/dh_t
          const float daa = gg * hs[s][j] * av[s][j];    // times h_{t-1} a
          dd = fmaf(daa, A[j], dd);
          gB = fmaf(gg, Bv[j], gB);
          dA[j] = fmaf(daa, dl, dA[j]);
          v[j] = gg * du;                                // dB term
          v[NPT + j] = hs[s + 1][j] * dyv;               // dC term
          gc[j] = av[s][j] * gg;
        }
        // gB and this thread's share of ddt, summed over the channel's 4
        // threads: lanes g = 0, 2 end with gB, g = 1, 3 with ddt
        dd = fmaf(uu, gB, dd);
        float keep = (g & 1) ? dd : gB;
        keep += __shfl_xor_sync(0xffffffffu, (g & 1) ? gB : dd, 1);
        keep += __shfl_xor_sync(0xffffffffu, keep, 2);
        const float o = g == 0 ? fmaf(dl, keep, Dd * dyv) : keep;
        if (g < 2) (g == 0 ? sdu : sddt)[s * CH + c] = o;
        dD = fmaf(dyv, uu, dD);                          // lane g = 0's kept
        // dB / dC terms summed over the warp's 8 channels (lane bits 2-4):
        // a reduce-scatter, each lane ends with v[4 b2 + 2 b3 + b4]
        float v4[4], v2[2];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v4[q] = (b2 ? v[q + 4] : v[q]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? v[q] : v[q + 4], 4);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v2[q] = (b3 ? v4[q + 2] : v4[q]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? v4[q] : v4[q + 2], 8);
        const float r = (b4 ? v2[1] : v2[0]) +
                        __shfl_xor_sync(0xffffffffu, b4 ? v2[0] : v2[1], 16);
        sred[(warp * TT + s) * 2 * N + b2 * N + g * NPT + 2 * b3 + b4] = r;
      }
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        slot(gcar, j) = gc[j];
        slot(acar, j) = dA[j];
      }
      slot(carry, 3 * NPT) = dD;
      __syncthreads();
      // dB_t, dC_t: the warps' sums added in warp order; du, ddt rows
      const int steps = min(TT, L - t0);
      for (int i = tid; i < steps * 2 * N; i += THREADS) {
        const int s = i / (2 * N), r = i % (2 * N);
        float acc = sred[s * 2 * N + r];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) acc += sred[(w * TT + s) * 2 * N + r];
        float* o = r < N ? out.dB : out.dC;
        o[(((int64_t)b * nblk + blk) * L + t0 + s) * N + r % N] = acc;
      }
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int s = i / CH, cc = i % CH;
        if (d0 + cc < D) {
          const int64_t k = ((int64_t)b * L + t0 + s) * D + d0 + cc;
          out.du[k] = sdu[i];
          out.ddt[k] = sddt[i];
        }
      }
    }
    buf ^= 1;
    ci = nci;
    idx = nidx;
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      out.dA[(((int64_t)b * ngrp + grp) * N + g * NPT + j) * D + d] =
          slot(acar, j);
    if (g == 0)
      out.dD[((int64_t)b * ngrp + grp) * D + d] = slot(carry, 3 * NPT);
  }
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
bool is_aligned(const Operands& op, const void* dy, const void* ckpt,
                const void* E) {
  const uintptr_t p = (uintptr_t)op.u | (uintptr_t)op.dt | (uintptr_t)dy |
                      (uintptr_t)op.pos | (uintptr_t)ckpt | (uintptr_t)E;
  const int64_t es = sizeof(T);
  return p % 16 == 0 && op.D * es % 16 == 0 && op.pos_bstride * 4 % 16 == 0;
}

template <typename T>
int prepare(int chunk) {
  static size_t allowed = 48 * 1024;   // raised once per size, outside any
  const size_t bytes = chunk_smem_bytes<T>(chunk);      // capture
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  return 0;
}

template <typename T>
int launch_bwd(const Operands& op, int B, const void* ckpt, const void* dy,
               const Out& out, float* E, float* P, float* Bf, float* Cf,
               int chunk, void* stream) {
  if ((int64_t)B * op.L * op.D == 0) return 0;
  const int nC = (op.L + chunk - 1) / chunk;
  const int ngrp = (nC + GROUP - 1) / GROUP;
  if (chunk < 16 || chunk % 16 || B > 65535 || nC > 65535)
    return (int)cudaErrorInvalidValue;
  if (int e = prepare<T>(chunk)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  scan_bwd_carry_kernel<T><<<dim3((op.D + CT - 1) / CT, nC, B), CT, 0, s>>>(
      op, (const T*)dy, E, P, Bf, Cf, chunk);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int64_t total = (int64_t)B * N * op.D;
  scan_bwd_combine_kernel<<<(unsigned)((total + CMB - 1) / CMB), CMB, 0,
                            s>>>(E, P, nC, (int64_t)N * op.D, total);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  scan_bwd_chunk_kernel<T><<<dim3((op.D + CH - 1) / CH, ngrp, B), THREADS,
                             chunk_smem_bytes<T>(chunk), s>>>(
      op, (const float*)ckpt, E, (const T*)dy, Bf, Cf, out, chunk,
      (int)is_aligned<T>(op, dy, ckpt, E));
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int which, int chunk, int* out) {
  if (int e = prepare<T>(chunk)) return e;
  cudaFuncAttributes fa{};
  cudaError_t e;
  size_t smem = 0;
  int threads;
  if (which == 0) {
    e = cudaFuncGetAttributes(&fa, scan_bwd_carry_kernel<T>);
    threads = CT;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], scan_bwd_carry_kernel<T>, CT, 0);
  } else if (which == 1) {
    e = cudaFuncGetAttributes(&fa, scan_bwd_combine_kernel);
    threads = CMB;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], scan_bwd_combine_kernel, CMB, 0);
  } else {
    e = cudaFuncGetAttributes(&fa, scan_bwd_chunk_kernel<T>);
    threads = THREADS;
    smem = chunk_smem_bytes<T>(chunk);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[0], scan_bwd_chunk_kernel<T>, THREADS, smem);
  }
  out[1] = out[0] * threads / 32;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)(fa.sharedSizeBytes + smem);
  return (int)e;
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan.py, whose
// BLOCK_D and D_STATE are CH and N here). u, dt, dy, du, ddt are (B, L, D)
// contiguous; Bm and Cm have unit stride along N and the given batch and row
// strides (elements); At (N, D), Dp (D,), ckpt and the scratch E, P
// (B, nC, N, D), dB and dC (B, ceil(D/CH), L, N), dA (B, nG, N, D), dD
// (B, nG, D) and the scratch Bf, Cf (B, L, N) are contiguous f32,
// nG = ceil(nC / GROUP). Return the launches' cudaError_t (0 = launched).
#define SCAN_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* u, const void* dt, const void* At,         \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, const void* ckpt, const void* dy,  \
                      void* du, void* ddt, void* dB, void* dC, void* dA,      \
                      void* dD, void* E, void* P, void* Bf, void* Cf, int B,  \
                      int L, int D, int chunk, void* stream) {                \
    return launch_bwd<T>(make_operands(u, dt, At, Bm, Cm, bc_bstride,         \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       D),                                    \
                         B, ckpt, dy,                                         \
                         Out{(float*)du, (float*)ddt, (float*)dB, (float*)dC, \
                             (float*)dA, (float*)dD},                         \
                         (float*)E, (float*)P, (float*)Bf, (float*)Cf, chunk, \
                         stream);                                             \
  }

SCAN_BWD_ENTRY(selective_scan_bwd_f32, float)
SCAN_BWD_ENTRY(selective_scan_bwd_bf16, __nv_bfloat16)

// The build's knobs: out = {TT, GROUP, MIN_BLOCKS}.
extern "C" int selective_scan_bwd_params(int* out) {
  out[0] = TT;
  out[1] = GROUP;
  out[2] = SCAN_BWD_MIN_BLOCKS;
  return 0;
}

// Resources of kernel `which` (0 carry, 1 combine, 2 chunks) for bf16
// (bf16 != 0) or f32 input at `chunk`: out = {blocks an SM, warps an SM,
// registers a thread, local (spill) bytes a thread, shared bytes a block}.
extern "C" int selective_scan_bwd_occupancy(int bf16, int which, int chunk,
                                            int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(which, chunk, out)
              : occupancy<float>(which, chunk, out);
}
