// Segmented selective scan (PackMamba's ScanOp_pack, Mamba-1 per-channel
// decay), the `step` schedule: forward and backward parallel over TIME
// inside a block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (forward, kernel #3) and
// `_bwd_kernel` (backward, kernel #5) of src/repro/kernels/selective_scan.py
// (entries `selective_scan_fwd_pallas` / `selective_scan_bwd_pallas`,
// schedule="step"). Same functions and outputs as the `blocked` kernels of
// selective_scan.cu (#4/#6), same checkpoint contract, so a forward of one
// schedule feeds the backward of the other:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   y_t = sum_n C_t[n] * h_t[n] + D * u_t
//
// forward:  u, dt (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//           read through their batch and row strides; Dp (D,) f32;
//           pos (B,L) i32 -> y (B,L,D) in u's type, ckpt (B,nC,N,D) f32 = the
//           state at each chunk's entry (nC = ceil(L / chunk); chunk ==
//           TL, so a chunk is a tile).
// backward: the forward's inputs, ckpt and dy (B,L,D) -> du, ddt (B,L,D) f32;
//           dB, dC partials (B, ceil(D/CH), L, N) f32, one per block of CH
//           channels (summed over that axis by the caller, as #6's are);
//           dA partial (B,N,D) f32; dD partial (B,D) f32 (summed over B).
//
// What bounds it on this card: the exponentials. At mamba-2.8b's training
// shape (B=2, L=4096, D=5120, N=16) the forward needs B*L*D*N = 6.7e8
// exp2 results; the special-function unit gives 16 a clock per SM, ~160 us
// on 132 SMs at 1.98 GHz. Its bytes (u, dt, y once, the checkpoints) are
// ~0.29 GB = ~88 us at 3.35 TB/s. The backward needs the same exponentials
// once (the decays are reused between the recompute and the adjoint) and
// about twice the bytes. The `blocked` kernels (#4/#6) put one dependent
// chain of L steps in each thread; what bounds them is latency.
//
// Design (the paper's ScanOp_pack shape, as upstream Mamba's
// selective_scan_fwd_kernel: a segmented associative scan over time):
//   * A block owns one row b and CH = 16 adjacent channels; each channel's
//     steps are split over S = 16 neighbouring lanes of one warp, R = 4
//     consecutive steps each: 256 threads, B*D/16 blocks (640 at 2.8b).
//   * The block walks the row in tiles of TL = S*R = 64 steps, the
//     checkpoint chunk, so a tile's entry state is a checkpoint. Per tile
//     u, dt (dy), B, C and pos are staged in shared memory from coalesced
//     loads, transposed to (channel or state, time) rows so that a thread
//     reads its R steps as one float4. The next tile's loads are issued into
//     registers before the current tile is computed.
//   * Per state n: each thread forms its R pairs (a_t, b_t) =
//     (exp(dt_t*A)*[pos_t != 0], B_t*dt_t*u_t) and folds them into one;
//     the S lanes combine the folds with a Kogge-Stone inclusive scan of
//     width 16 (shuffles) under (a1,b1)o(a2,b2) = (a1*a2, a2*b1 + b2), the
//     tile's carried-in state folded into lane 0; each lane then replays its
//     R steps from its exclusive prefix, adding C_t[n]*h_t to y_t in
//     registers. The R decays stay in registers between fold and replay, so
//     each (t, n) is exponentiated once.
//   * Backward, tiles in reverse: per state n, h over the tile is
//     recomputed by the same scan from the tile's entry state, its
//     checkpoint; then the adjoint carry gc_t = a_t * g_t, with
//     g_t = C_t*dy_t + gc_{t+1}, runs as the same scan reversed in time,
//     the later tile's carry folded into lane S-1. A reset at t+1 makes
//     gc_{t+1} exactly 0, so nothing crosses it, across lanes and tiles too.
//   * Ragged L and D are masked, nothing is padded: steps past L are
//     identity steps (a = 1, b = 0, dy = 0); dead channels have A = 0 and
//     u = dt = 0. A reset is a = 0 exactly; nothing divides by a.
//   * No float atomics. dB_t and dC_t (sums over channels): the two channels
//     of a warp are summed with one xor shuffle, each warp's sums go to
//     shared memory and one thread per output adds the 8 warps in order.
//     Each thread keeps its dA terms for the whole row in shared memory (dD
//     in a register); they are summed over the S lanes in a fixed order at
//     the end. The results repeat bitwise.
//   * exp is __expf (ex2.approx): the argument dt*A is small (|.| < ~10).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int N = 16;               // d_state
constexpr int CH = 16;              // channels per block
constexpr int S = 16;               // lanes per channel
constexpr int R = 4;                // consecutive steps per lane
constexpr int TL = S * R;           // time tile (64)
constexpr int TLP = TL + 4;         // padded row: float4-aligned, <= 2-way
//                                     bank conflicts on the transposing stores
constexpr int THREADS = CH * S;     // 256
constexpr int WARPS = THREADS / 32;
constexpr int PER = TL * CH / THREADS;  // elements of a (TL, CH) tile a thread
constexpr unsigned FULL = 0xffffffffu;
// Blocks an SM the register budget is cut to (__launch_bounds__). Picked
// by src/repro_torch/tools/sweep_step_bounds.py, which rebuilds this file
// with other values (-DSTEP_FWD_MIN_BLOCKS=.., -DSTEP_BWD_MIN_BLOCKS=..) and
// times them at mamba-2.8b's and mamba-1.4b's training shapes; its
// readings are in PERF.md. The forward was fastest at 4 at both shapes,
// the backward at 2, which its shared memory allows no more than.
#ifndef STEP_FWD_MIN_BLOCKS
#define STEP_FWD_MIN_BLOCKS 4
#endif
#ifndef STEP_BWD_MIN_BLOCKS
#define STEP_BWD_MIN_BLOCKS 2
#endif
constexpr int FWD_MIN_BLOCKS = STEP_FWD_MIN_BLOCKS;
constexpr int BWD_MIN_BLOCKS = STEP_BWD_MIN_BLOCKS;
static_assert(CH == N, "the staging maps a (TL, CH) and a (TL, N) tile alike");
static_assert(S == 16 && THREADS == 256, "shuffle widths and the dB/dC "
              "pairing assume 16 lanes a channel, 2 channels a warp");
static_assert(N * CH == THREADS, "one checkpoint value a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Operands {
  const void* u; const void* dt; const float* At; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, D;
};

// One tile's operands in flight: this thread's share of u, dt, dy (TL, CH)
// and B, C (TL, N) as f32, one position, one checkpoint value (backward).
struct Prefetch {
  float u[PER], dt[PER], dy[PER], B[PER], C[PER];
  int pos;
  float ck;
};

// Issue the loads of steps [t0, t0 + TL) of row b, channels [d0, d0 + CH):
// u, dt, dy 0 past L or D; B, C 0 past L; pos 1 past L (no reset).
template <typename T>
__device__ __forceinline__ void fetch(const Operands& op, const T* dy, int b,
                                      int d0, int t0, Prefetch& p) {
  const int tid = threadIdx.x;
  const T* u = (const T*)op.u;
  const T* dt = (const T*)op.dt;
  const T* Bm = (const T*)op.Bm;
  const T* Cm = (const T*)op.Cm;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, t = t0 + i / CH, c = i % CH;
    const bool in_t = t < op.L, ok = in_t && d0 + c < op.D;
    const int64_t off = ((int64_t)b * op.L + t) * op.D + d0 + c;
    p.u[k] = ok ? to_f32(u[off]) : 0.f;
    p.dt[k] = ok ? to_f32(dt[off]) : 0.f;
    if (dy != nullptr) p.dy[k] = ok ? to_f32(dy[off]) : 0.f;
    const int64_t kb = b * op.bc_bstride + (int64_t)t * op.bc_lstride + c;
    p.B[k] = in_t ? to_f32(Bm[kb]) : 0.f;
    p.C[k] = in_t ? to_f32(Cm[kb]) : 0.f;
  }
  if (tid < TL) {
    const int t = t0 + tid;
    p.pos = t < op.L ? op.pos[b * op.pos_bstride + t] : 1;
  }
}

// Store a fetched tile into the (column, time) rows of shared memory.
__device__ __forceinline__ void commit(const Prefetch& p, float* su,
                                       float* sdt, float* sdy, float* sB,
                                       float* sC, int* spos, bool with_dy) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, t = i / CH, c = i % CH;
    su[c * TLP + t] = p.u[k];
    sdt[c * TLP + t] = p.dt[k];
    if (with_dy) sdy[c * TLP + t] = p.dy[k];
    sB[c * TLP + t] = p.B[k];
    sC[c * TLP + t] = p.C[k];
  }
  if (tid < TL) spos[tid] = p.pos;
}

__device__ __forceinline__ void load4(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// This lane's R decays and inputs for state n, folded and scanned over the
// S lanes of its channel: returns the state at the entry of the lane's
// first step (h_in for lane 0) and sets `end` to the tile's last state.
__device__ __forceinline__ float scan_entry(const float* a, const float* bb,
                                            float h_in, int s, float& end) {
  float Af = a[0], Bf = bb[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    Bf = a[r] * Bf + bb[r];
    Af *= a[r];
  }
  if (s == 0) Bf = Af * h_in + Bf;
#pragma unroll
  for (int off = 1; off < S; off *= 2) {
    const float Ap = __shfl_up_sync(FULL, Af, off, S);
    const float Bp = __shfl_up_sync(FULL, Bf, off, S);
    if (s >= off) {
      Bf = Af * Bp + Bf;
      Af *= Ap;
    }
  }
  float h = __shfl_up_sync(FULL, Bf, 1, S);
  if (s == 0) h = h_in;
  end = __shfl_sync(FULL, Bf, S - 1, S);
  return h;
}

// This lane's R decays, inputs and positions for one state.
__device__ __forceinline__ void step_terms(const float* dl, const float* du,
                                           const bool* reset, float An,
                                           const float* Bv, float* a,
                                           float* bb) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = reset[r] ? 0.f : __expf(dl[r] * An);
    bb[r] = Bv[r] * du[r];
  }
}

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
scan_step_fwd_kernel(Operands op, T* __restrict__ y, float* __restrict__ ckpt) {
  __shared__ __align__(16) float su[CH * TLP], sdt[CH * TLP], sy[CH * TLP];
  __shared__ __align__(16) float sB[N * TLP], sC[N * TLP];
  __shared__ float sA[N * CH], shc[N * CH];   // A and the carried state
  __shared__ __align__(16) int spos[TL];
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, c = tid / S, s = tid % S, d = d0 + c;
  const bool live = d < op.D;
  const int L = op.L, D = op.D;
  const int nT = (L + TL - 1) / TL;     // tiles = chunks
  {
    const int n = tid / CH, cc = tid % CH;     // one (n, channel) a thread
    sA[tid] = d0 + cc < D ? op.At[(int64_t)n * D + d0 + cc] : 0.f;
    shc[tid] = 0.f;
  }
  __syncthreads();     // the zero state is read by other threads at t = 0
  const float Dd = live ? op.Dp[d] : 0.f;
  Prefetch p;
  fetch<T>(op, nullptr, b, d0, 0, p);
  for (int k = 0; k < nT; ++k) {
    const int t0 = k * TL;
    // the state at the tile's entry, read before the barrier that lets
    // this tile's lane 0 overwrite it
    if (live) ckpt[(((int64_t)b * nT + k) * N + s) * D + d] = shc[s * CH + c];
    commit(p, su, sdt, nullptr, sB, sC, spos, false);
    __syncthreads();
    if (k + 1 < nT) fetch<T>(op, nullptr, b, d0, t0 + TL, p);
    float uu[R], dl[R], du[R], yv[R];
    bool reset[R];
    load4(su + c * TLP + s * R, uu);
    load4(sdt + c * TLP + s * R, dl);
    const int4 pq = *reinterpret_cast<const int4*>(spos + s * R);
    reset[0] = pq.x == 0; reset[1] = pq.y == 0;
    reset[2] = pq.z == 0; reset[3] = pq.w == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      du[r] = dl[r] * uu[r];
      yv[r] = Dd * uu[r];
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float Bv[R], Cv[R], a[R], bb[R], end;
      load4(sB + n * TLP + s * R, Bv);
      load4(sC + n * TLP + s * R, Cv);
      step_terms(dl, du, reset, sA[n * CH + c], Bv, a, bb);
      float h = scan_entry(a, bb, shc[n * CH + c], s, end);
      if (s == 0) shc[n * CH + c] = end;      // the lane that reads it
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h = a[r] * h + bb[r];
        yv[r] += Cv[r] * h;
      }
    }
    store4(sy + c * TLP + s * R, yv);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PER; ++kk) {
      const int i = tid + kk * THREADS, t = i / CH, cc = i % CH;
      if (t0 + t < L && d0 + cc < D)
        y[((int64_t)b * L + t0 + t) * D + d0 + cc] = from_f32<T>(sy[cc * TLP + t]);
    }
  }
}

// ----------------------------------------------------------------- backward

struct BwdOut {
  float* du; float* ddt; float* dB; float* dC; float* dA; float* dD;
};

// Shared-memory layout of the backward (floats unless noted):
//   sred (WARPS, 2, N, TLP)  per-warp channel sums of g*dt*u (dB) and h*dy
//                            (dC) for the current tile
//   su, sdt, sdy (CH, TLP)   the tile's operands; su and sdt then take du, ddt
//   sB, sC (N, TLP)
//   sA, sgc, hin (N, CH)     A, the adjoint carry gc = a*g of the later
//                            tile, and the tile's entry state (checkpoint)
//   sdA (N, THREADS)         each thread's dA terms over the row, by state
//   spos (TL) int
constexpr size_t BWD_SMEM_BYTES =
    ((size_t)WARPS * 2 * N * TLP + 3 * CH * TLP + 2 * N * TLP + 3 * N * CH
     + N * THREADS + TL) * sizeof(float);

// Issue the loads of tile k (operands, dy and its checkpoint).
template <typename T>
__device__ __forceinline__ void fetch_bwd(const Operands& op, const T* dy,
                                          const float* ckpt, int b, int d0,
                                          int k, int nT, Prefetch& p) {
  fetch<T>(op, dy, b, d0, k * TL, p);
  const int n = threadIdx.x / CH, cc = threadIdx.x % CH;
  p.ck = d0 + cc < op.D
      ? ckpt[(((int64_t)b * nT + k) * N + n) * op.D + d0 + cc] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, BWD_MIN_BLOCKS)
scan_step_bwd_kernel(Operands op, const float* __restrict__ ckpt,
                     const T* __restrict__ dy, BwdOut out) {
  extern __shared__ __align__(16) float smem[];
  float* sred = smem;
  float* su = sred + WARPS * 2 * N * TLP;
  float* sdt = su + CH * TLP;
  float* sdy = sdt + CH * TLP;
  float* sB = sdy + CH * TLP;
  float* sC = sB + N * TLP;
  float* sA = sC + N * TLP;
  float* sgc = sA + N * CH;
  float* hin = sgc + N * CH;
  float* sdA = hin + N * CH;
  int* spos = (int*)(sdA + N * THREADS);

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CH;
  const int tid = threadIdx.x, c = tid / S, s = tid % S, d = d0 + c;
  const int warp = tid / 32, half = (tid / S) & 1;
  const bool live = d < op.D;
  const int L = op.L, D = op.D;
  const int nT = (L + TL - 1) / TL;     // tiles = chunks
  {
    const int n = tid / CH, cc = tid % CH;
    sA[tid] = d0 + cc < D ? op.At[(int64_t)n * D + d0 + cc] : 0.f;
    sgc[tid] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) sdA[n * THREADS + tid] = 0.f;
  const float Dd = live ? op.Dp[d] : 0.f;
  float dD = 0.f;

  Prefetch p;
  fetch_bwd<T>(op, dy, ckpt, b, d0, nT - 1, nT, p);
  for (int k = nT - 1; k >= 0; --k) {
    const int t0 = k * TL;
    commit(p, su, sdt, sdy, sB, sC, spos, true);
    hin[tid] = p.ck;                  // (n, channel) = (tid/CH, tid%CH)
    __syncthreads();
    if (k > 0) fetch_bwd<T>(op, dy, ckpt, b, d0, k - 1, nT, p);
    float uu[R], dl[R], du[R];
    bool reset[R];
    load4(su + c * TLP + s * R, uu);
    load4(sdt + c * TLP + s * R, dl);
    const int4 pq = *reinterpret_cast<const int4*>(spos + s * R);
    reset[0] = pq.x == 0; reset[1] = pq.y == 0;
    reset[2] = pq.z == 0; reset[3] = pq.w == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) du[r] = dl[r] * uu[r];

    // recompute h, then the adjoint, one state at a time
    float dyv[R], gB[R], dda[R];
    load4(sdy + c * TLP + s * R, dyv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gB[r] = 0.f;
      dda[r] = 0.f;
      dD += dyv[r] * uu[r];
    }
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      float Bv[R], Cv[R], a[R], bb[R], hp[R + 1], cc[R], end;
      const float An = sA[n * CH + c];
      load4(sB + n * TLP + s * R, Bv);
      load4(sC + n * TLP + s * R, Cv);
      step_terms(dl, du, reset, An, Bv, a, bb);
      hp[0] = scan_entry(a, bb, hin[n * CH + c], s, end);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        hp[r + 1] = a[r] * hp[r] + bb[r];
        cc[r] = Cv[r] * dyv[r];
      }
      // gc_t = a_t * (c_t + gc_{t+1}): fold this lane's steps backwards,
      // the later tile's carry into lane S-1, then scan from the high lanes
      float Ar = a[R - 1], Gr = a[R - 1] * cc[R - 1];
#pragma unroll
      for (int r = R - 2; r >= 0; --r) {
        Gr = a[r] * (cc[r] + Gr);
        Ar *= a[r];
      }
      const float gc_later = sgc[n * CH + c];
      if (s == S - 1) Gr = Ar * gc_later + Gr;
#pragma unroll
      for (int off = 1; off < S; off *= 2) {
        const float An2 = __shfl_down_sync(FULL, Ar, off, S);
        const float Gn = __shfl_down_sync(FULL, Gr, off, S);
        if (s + off < S) {
          Gr = Ar * Gn + Gr;
          Ar *= An2;
        }
      }
      float gc = __shfl_down_sync(FULL, Gr, 1, S);   // gc at the next lane's
      if (s == S - 1) gc = gc_later;                  // first step
      const float gc_tile = __shfl_sync(FULL, Gr, 0, S);
      if (s == S - 1) sgc[n * CH + c] = gc_tile;      // for the earlier tile,
      //                                                 by the lane that reads it
      float pd[R], dAn = 0.f;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const float g = cc[r] + gc;                   // dL/dh_t
        const float da = g * hp[r];                   // times h_{t-1}
        dda[r] += da * a[r] * An;
        gB[r] += g * Bv[r];
        dAn += da * a[r] * dl[r];
        // even channel of the pair sums g*dt*u (dB), odd sums h_t*dy (dC)
        const float pdB = g * du[r], pdC = hp[r + 1] * dyv[r];
        const float mine = half ? pdC : pdB, send = half ? pdB : pdC;
        pd[r] = mine + __shfl_xor_sync(FULL, send, 16);
        gc = a[r] * g;
      }
      store4(sred + ((warp * 2 + half) * N + n) * TLP + s * R, pd);
      sdA[n * THREADS + tid] += dAn;
    }
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = dl[r] * gB[r] + Dd * dyv[r];
    store4(su + c * TLP + s * R, o);              // du (this lane's slots)
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = dda[r] + uu[r] * gB[r];
    store4(sdt + c * TLP + s * R, o);             // ddt
    __syncthreads();
    // dB_t, dC_t: the 8 warps' pair sums added in warp order
#pragma unroll
    for (int kk = 0; kk < 2 * TL * N / THREADS; ++kk) {
      const int i = tid + kk * THREADS, which = i / (TL * N);
      const int t = (i % (TL * N)) / N, n = i % N;
      if (t0 + t < L) {
        float acc = 0.f;
#pragma unroll
        for (int ww = 0; ww < WARPS; ++ww)
          acc += sred[((ww * 2 + which) * N + n) * TLP + t];
        float* dst = which == 0 ? out.dB : out.dC;
        dst[(((int64_t)b * nblk + blk) * L + t0 + t) * N + n] = acc;
      }
    }
#pragma unroll
    for (int kk = 0; kk < PER; ++kk) {
      const int i = tid + kk * THREADS, t = i / CH, cc = i % CH;
      if (t0 + t < L && d0 + cc < D) {
        const int64_t k = ((int64_t)b * L + t0 + t) * D + d0 + cc;
        out.du[k] = su[cc * TLP + t];
        out.ddt[k] = sdt[cc * TLP + t];
      }
    }
    __syncthreads();
  }
  // dA: one (state, channel) a thread, its S lanes' terms added in lane
  // order (the loop above ended on a barrier); dD: a xor butterfly over the
  // channel's lanes (every lane gets the same bits)
  {
    const int n = tid / CH, cc = tid % CH;
    if (d0 + cc < D) {
      float acc = 0.f;
#pragma unroll
      for (int ss = 0; ss < S; ++ss) acc += sdA[n * THREADS + cc * S + ss];
      out.dA[((int64_t)b * N + n) * D + d0 + cc] = acc;
    }
  }
#pragma unroll
  for (int m = S / 2; m >= 1; m /= 2) dD += __shfl_xor_sync(FULL, dD, m, S);
  if (live && s == 0) out.dD[(int64_t)b * D + d] = dD;
}

Operands make_operands(const void* u, const void* dt, const void* At,
                       const void* Bm, const void* Cm, int64_t bc_bstride,
                       int64_t bc_lstride, const void* Dp, const void* pos,
                       int64_t pos_bstride, int L, int D) {
  return Operands{u, dt, (const float*)At, Bm, Cm, bc_bstride, bc_lstride,
                  (const float*)Dp, (const int32_t*)pos, pos_bstride, L, D};
}

template <typename T>
int launch_fwd(const Operands& op, int B, void* y, void* ckpt, int chunk,
               void* stream) {
  if ((int64_t)B * op.L * op.D == 0) return 0;
  if (chunk != TL || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((op.D + CH - 1) / CH, B);
  scan_step_fwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      op, (T*)y, (float*)ckpt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const Operands& op, int B, const void* ckpt, const void* dy,
               const BwdOut& out, int chunk, void* stream) {
  if ((int64_t)B * op.L * op.D == 0) return 0;
  if (chunk != TL || B > 65535) return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // raised once, outside any graph capture
  if (!allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_step_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)BWD_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const dim3 grid((op.D + CH - 1) / CH, B);
  scan_step_bwd_kernel<T><<<grid, THREADS, BWD_SMEM_BYTES,
                            (cudaStream_t)stream>>>(
      op, (const float*)ckpt, (const T*)dy, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan.py, whose
// STEP_BLOCK_D, STEP_TILE_T and D_STATE are CH, TL and N here). The
// arguments are those of selective_scan.cu's entries; chunk must be TL.
// Return the launch's cudaError_t (0 = launched).
#define STEP_FWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* u, const void* dt, const void* At,         \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, void* y, void* ckpt, int B, int L, \
                      int D, int chunk, void* stream) {                       \
    return launch_fwd<T>(make_operands(u, dt, At, Bm, Cm, bc_bstride,         \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       D),                                    \
                         B, y, ckpt, chunk, stream);                          \
  }

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
                         BwdOut{(float*)du, (float*)ddt, (float*)dB,          \
                                (float*)dC, (float*)dA, (float*)dD},          \
                         chunk, stream);                                      \
  }

STEP_FWD_ENTRY(selective_scan_step_fwd_f32, float)
STEP_FWD_ENTRY(selective_scan_step_fwd_bf16, __nv_bfloat16)
STEP_BWD_ENTRY(selective_scan_step_bwd_f32, float)
STEP_BWD_ENTRY(selective_scan_step_bwd_bf16, __nv_bfloat16)
