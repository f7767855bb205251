// Segmented selective scan forward (PackMamba's ScanOp_pack, Mamba-1
// per-channel decay), the `step` schedule: parallel over TIME inside a
// block, for Hopper (sm_90a): kernel #3.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/selective_scan.py (entry `selective_scan_fwd_pallas`,
// schedule="step"). Same function and outputs as the `blocked` forward of
// selective_scan.cu (#4), same checkpoint contract, so either forward feeds
// either backward (#5, selective_scan_step_bwd.cu; #6,
// selective_scan_bwd.cu):
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   y_t = sum_n C_t[n] * h_t[n] + D * u_t
//
// in:  u, dt (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//      read through their batch and row strides; Dp (D,) f32; pos (B,L) i32
// out: y (B,L,D) in u's type, ckpt (B,nC,N,D) f32 = the state at each
//      chunk's entry (nC = ceil(L / chunk); chunk == TL, so a chunk is a
//      tile).
//
// What bounds it on this card: the exponentials. At mamba-2.8b's training
// shape (B=2, L=4096, D=5120, N=16) it needs B*L*D*N = 6.7e8 exp2 results;
// the special-function unit gives 16 a clock per SM, ~160 us on 132 SMs at
// 1.98 GHz. Its bytes (u, dt, y once, the checkpoints) are ~0.29 GB = ~88
// us at 3.35 TB/s.
//
// Design (the paper's ScanOp_pack shape, as upstream Mamba's
// selective_scan_fwd_kernel: a segmented associative scan over time):
//   * A block owns one row b and CH = 16 adjacent channels; each channel's
//     steps are split over S = 16 neighbouring lanes of one warp, R = 4
//     consecutive steps each: 256 threads, B*D/16 blocks (640 at 2.8b).
//   * The block walks the row in tiles of TL = S*R = 64 steps, the
//     checkpoint chunk, so a tile's entry state is a checkpoint. Per tile
//     u, dt, B, C and pos are staged in shared memory from coalesced loads,
//     transposed to (channel or state, time) rows so that a thread reads its
//     R steps as one float4. The next tile's loads are issued into
//     registers before the current tile is computed.
//   * Per state n: each thread forms its R pairs (a_t, b_t) =
//     (exp(dt_t*A)*[pos_t != 0], B_t*dt_t*u_t) and folds them into one;
//     the S lanes combine the folds with a Kogge-Stone inclusive scan of
//     width 16 (shuffles) under (a1,b1)o(a2,b2) = (a1*a2, a2*b1 + b2), the
//     tile's carried-in state folded into lane 0; each lane then replays its
//     R steps from its exclusive prefix, adding C_t[n]*h_t to y_t in
//     registers. The R decays stay in registers between fold and replay, so
//     each (t, n) is exponentiated once.
//   * Ragged L and D are masked, nothing is padded: steps past L are
//     identity steps (a = 1, b = 0); dead channels have A = 0 and
//     u = dt = 0. A reset is a = 0 exactly; nothing divides by a.
//   * exp is __expf (ex2.approx): the argument dt*A is small (|.| < ~10).
//   * The staging helpers (Prefetch, fetch, commit) have a dy slot and a
//     checkpoint value that the forward leaves unused (it passes no dy);
//     they are left as they are so that #3 compiles to the code it had.

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
constexpr int PER = TL * CH / THREADS;  // elements of a (TL, CH) tile a thread
constexpr unsigned FULL = 0xffffffffu;
// Blocks an SM the register budget is cut to (__launch_bounds__). Picked
// by src/repro_torch/tools/sweep_step_bounds.py, which rebuilds this file
// with other values (-DSTEP_FWD_MIN_BLOCKS=..) and times them at
// mamba-2.8b's and mamba-1.4b's training shapes; its readings are in
// PERF.md. The forward was fastest at 4 at both shapes.
#ifndef STEP_FWD_MIN_BLOCKS
#define STEP_FWD_MIN_BLOCKS 4
#endif
constexpr int FWD_MIN_BLOCKS = STEP_FWD_MIN_BLOCKS;
static_assert(CH == N, "the staging maps a (TL, CH) and a (TL, N) tile alike");
static_assert(S == 16 && THREADS == 256, "shuffle widths assume 16 lanes a "
              "channel, 2 channels a warp");
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

STEP_FWD_ENTRY(selective_scan_step_fwd_f32, float)
STEP_FWD_ENTRY(selective_scan_step_fwd_bf16, __nv_bfloat16)
