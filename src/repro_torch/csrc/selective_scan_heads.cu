// Head-structured segmented selective scan (Mamba-2 / SSD: a scalar decay
// per head, B and C shared by every head), forward in the dual form, for
// Hopper (sm_90a). The other forward, #7, is selective_scan_heads_fwd.cu;
// the backward of both, #9, selective_scan_heads_bwd.cu.
//
// Replaces the Pallas TPU kernel #8 of src/repro/kernels/selective_scan.py,
// `_fwd_kernel_blocked_heads_dual` (schedule="blocked_heads_dual"). Same
// function, same chunk-entry checkpoints:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + (dt_t * u_t) (x) B_t
//   y_t = h_t . C_t + D * u_t            (h_t: (P, N) per (b, head))
//
// Layout: the JAX public one, not the TPU kernels' head-major copy.
// u, y (B, L, H, P); dt (B, L, H); A, Dp (H,) f32; Bm, Cm (B, L, N)
// read through their batch and row strides (views of one projection);
// pos (B, L) i32; ckpt (B, H, nC, P, N) f32, nC = ceil(L / chunk).
//
// What bounds it on this card: bytes. At the training shape (B=8, L=4096,
// H=32, P=64, N=64) the function moves ~0.35 GB (0.10 ms at 3.35 TB/s);
// the dual form's products, 3.4e10 operations, would take 0.07 ms on the
// tensor cores. This kernel does them on the f32 pipes, one tile of 16
// steps at a time: it is the simple form, kept for the `blocked_heads_dual`
// schedule, which no main path runs (#7 is the chunked form on the tensor
// cores).
//
// Design:
//   * No carry between blocks: one block walks a row's whole L for one head
//     and PS = 16 rows of P (rows are independent given the head's dt, B, C
//     and positions), which gives B*H*P/16 blocks (1024 at the training
//     shape). 128 threads: thread (rg, ng) holds rows rg, rg+8 and states
//     n = ng, ng+16, ng+32, ng+48 in registers.
//   * Per tile of TT = 16 steps the block stages u (its rows), dt, a_t =
//     exp(dt*A) and pos, and B, C rows in shared memory with coalesced
//     loads, then forms G = dec (.) (C B^T) in shared memory,
//     y = G (dt u) + cin (C h_in^T) and h_out = dec[last] . bterm
//     + cin[last] h_in. y leaves through shared memory. A ragged L is
//     masked, nothing is padded.
//   * No float atomics: every sum runs in a fixed order. Results are
//     bitwise repeatable.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int N = 64;            // d_state
constexpr int NP = N + 1;        // padded row of the staged B and C
constexpr int PS = 16;           // rows of P per block
constexpr int NG = 16;           // thread groups along N: n = ng + NG*j
constexpr int NPT = N / NG;      // states per thread along N
constexpr int RG = 8;            // thread groups along rows: r = rg + RG*k
constexpr int PPT = PS / RG;     // rows per thread
constexpr int THREADS = NG * RG;
constexpr int TT = 16;           // forward tile

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
  const void* u; const void* dt; const float* A; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, H, P;
};

// This block's row b, head h, slice s of P (block = ((b*H)+h)*nps + s).
struct Where { int b, h, s, nps, p0; };

__device__ __forceinline__ Where where_of(const Operands& op) {
  Where w;
  w.nps = op.P / PS;
  const int blk = blockIdx.x;
  w.s = blk % w.nps;
  w.h = (blk / w.nps) % op.H;
  w.b = blk / (w.nps * op.H);
  w.p0 = w.s * PS;
  return w;
}

__device__ __forceinline__ int64_t at_lhp(const Operands& op, const Where& w,
                                          int t, int r) {
  return (((int64_t)w.b * op.L + t) * op.H + w.h) * op.P + w.p0 + r;
}

// One tile's operands on their way from device memory to shared memory,
// each thread's fixed share in registers. Steps at or past t_end (the
// chunk's end or L) are identity steps: u, B, C and dt 0, pos 1 (no reset),
// so a = exp(0) = 1 and nothing is added.
template <typename T, int NT>
struct Tile {
  static constexpr int UE = NT * PS / THREADS;   // u per thread
  static constexpr int BE = NT * N / THREADS;    // B and C per thread
  static_assert(NT * PS % THREADS == 0 && NT * N % THREADS == 0, "tile");
  T u[UE], b[BE], c[BE];
  T d;
  int p;

  __device__ __forceinline__ void fetch(const Operands& op, const Where& w,
                                        int t0, int t_end) {
    const int tid = threadIdx.x;
    const T zero = from_f32<T>(0.f);
    const T* up = (const T*)op.u;
#pragma unroll
    for (int q = 0; q < UE; ++q) {
      const int i = tid + q * THREADS, s = i / PS, r = i % PS, t = t0 + s;
      const bool ok = t < t_end;
      u[q] = ok ? up[at_lhp(op, w, t, r)] : zero;
    }
    const T* Bm = (const T*)op.Bm;
    const T* Cm = (const T*)op.Cm;
#pragma unroll
    for (int q = 0; q < BE; ++q) {
      const int i = tid + q * THREADS, s = i / N, n = i % N, t = t0 + s;
      const bool ok = t < t_end;
      const int64_t k = ok ? w.b * op.bc_bstride + (int64_t)t * op.bc_lstride
                             + n : 0;
      b[q] = ok ? Bm[k] : zero;
      c[q] = ok ? Cm[k] : zero;
    }
    if (tid < NT) {
      const int t = t0 + tid;
      const bool ok = t < t_end;
      const T* dt = (const T*)op.dt;
      d = ok ? dt[((int64_t)w.b * op.L + t) * op.H + w.h] : zero;
      p = ok ? op.pos[w.b * op.pos_bstride + t] : 1;
    }
  }

  // into shared memory as f32, with a = exp(dt*A) (0 at a reset)
  __device__ __forceinline__ void put(float A, float* su, float* sB,
                                      float* sC, float* sdt, float* sa,
                                      int* spos) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < UE; ++q) su[tid + q * THREADS] = to_f32(u[q]);
#pragma unroll
    for (int q = 0; q < BE; ++q) {
      const int i = tid + q * THREADS, s = i / N, n = i % N;
      sB[s * NP + n] = to_f32(b[q]);
      sC[s * NP + n] = to_f32(c[q]);
    }
    if (tid < NT) {
      const float dd = to_f32(d);
      sdt[tid] = dd;
      sa[tid] = p == 0 ? 0.f : expf(dd * A);
      spos[tid] = p;
    }
  }
};

// #8: the dual form per tile of TT steps (see the note at the top).
template <typename T>
__global__ void __launch_bounds__(THREADS)
heads_dual_kernel(Operands op, T* __restrict__ y, float* __restrict__ ckpt,
                  int chunk) {
  __shared__ float su[TT * PS], sy[TT * PS], sB[TT * NP], sC[TT * NP];
  __shared__ float sdt[TT], sa[TT];
  __shared__ int spos[TT];
  __shared__ float sH[PS * NP], sG[TT * TT];
  __shared__ float scum[TT], scin[TT], sdl[TT];
  __shared__ int srid[TT];

  const Where w = where_of(op);
  const int tid = threadIdx.x, ng = tid % NG, rg = tid / NG;
  const int L = op.L, nC = (L + chunk - 1) / chunk;
  const float A = op.A[w.h], Dd = op.Dp[w.h];
  float h[PPT][NPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int j = 0; j < NPT; ++j) h[k][j] = 0.f;

  for (int c = 0; c < nC; ++c) {
    const int tc0 = c * chunk, tc1 = min(L, tc0 + chunk);
    float* ck = ckpt + (((int64_t)w.b * op.H + w.h) * nC + c) * op.P * N
                + (int64_t)w.p0 * N;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
#pragma unroll
      for (int j = 0; j < NPT; ++j)
        ck[(rg + RG * k) * N + ng + NG * j] = h[k][j];
    for (int t0 = tc0; t0 < tc1; t0 += TT) {
      const int steps = min(TT, tc1 - t0);
      {
        Tile<T, TT> tile;
        tile.fetch(op, w, t0, tc1);
        tile.put(A, su, sB, sC, sdt, sa, spos);
      }
      __syncthreads();
      // 1. in-tile log-decay prefix, reset ids, carry-in decays; h_in
      if (tid == 0) {
        float cs = 0.f;
        int rid = 0;
        for (int s = 0; s < steps; ++s) {
          cs += sdt[s] * A;
          rid += spos[s] == 0;
          scum[s] = cs;
          srid[s] = rid;
          scin[s] = rid == 0 ? expf(cs) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          sH[(rg + RG * k) * NP + ng + NG * j] = h[k][j];
      __syncthreads();
      // 2. G = dec (.) (C B^T) and the last row's decays
      for (int o = tid; o < TT * TT; o += THREADS) {
        const int i = o / TT, j = o % TT;
        float g = 0.f;
        if (i < steps && j <= i && srid[i] == srid[j]) {
          const float dec = expf(scum[i] - scum[j]);
          float cb = 0.f;
#pragma unroll 16
          for (int n = 0; n < N; ++n)
            cb = fmaf(sC[i * NP + n], sB[j * NP + n], cb);
          g = dec * cb;
          if (i == steps - 1) sdl[j] = dec;
        } else if (i == steps - 1 && j < steps) {
          sdl[j] = 0.f;
        }
        sG[o] = g;
      }
      __syncthreads();
      // 3. y = G (dt u) + cin (C h_in^T) + D u
      for (int o = tid; o < TT * PS; o += THREADS) {
        const int i = o / PS, r = o % PS;
        if (i < steps) {
          float acc = 0.f;
          for (int j = 0; j <= i; ++j)
            acc = fmaf(sG[i * TT + j], sdt[j] * su[j * PS + r], acc);
          float ch = 0.f;
#pragma unroll 16
          for (int n = 0; n < N; ++n)
            ch = fmaf(sC[i * NP + n], sH[r * NP + n], ch);
          sy[o] = fmaf(Dd, su[o], fmaf(scin[i], ch, acc));
        }
      }
      // 4. h_out = dec[last] . (dt u (x) B) + cin[last] h_in
      const float cl = scin[steps - 1];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int r = rg + RG * k;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          float acc = 0.f;
          for (int jj = 0; jj < steps; ++jj)
            acc = fmaf(sdl[jj] * sdt[jj] * su[jj * PS + r],
                       sB[jj * NP + ng + NG * j], acc);
          h[k][j] = fmaf(cl, h[k][j], acc);
        }
      }
      __syncthreads();
      for (int i = tid; i < steps * PS; i += THREADS)
        y[at_lhp(op, w, t0 + i / PS, i % PS)] = from_f32<T>(sy[i]);
      __syncthreads();
    }
  }
}

Operands make_operands(const void* u, const void* dt, const void* A,
                       const void* Bm, const void* Cm, int64_t bc_bstride,
                       int64_t bc_lstride, const void* Dp, const void* pos,
                       int64_t pos_bstride, int L, int H, int P) {
  return Operands{u, dt, (const float*)A, Bm, Cm, bc_bstride, bc_lstride,
                  (const float*)Dp, (const int32_t*)pos, pos_bstride, L, H,
                  P};
}

int n_blocks(const Operands& op, int B, int64_t* blocks) {
  if (op.P % PS || op.L < 1 || op.H < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  *blocks = (int64_t)B * op.H * (op.P / PS);
  return *blocks > INT_MAX ? (int)cudaErrorInvalidValue : 0;
}

template <typename T>
int launch_dual(const Operands& op, int B, void* y, void* ckpt, int chunk,
                void* stream) {
  if ((int64_t)B * op.L * op.H * op.P == 0) return 0;
  int64_t blocks = 0;
  if (chunk < 1 || n_blocks(op, B, &blocks)) return (int)cudaErrorInvalidValue;
  heads_dual_kernel<T><<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(op, (T*)y, (float*)ckpt,
                                                 chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan_heads.py, whose
// P_SLICE, TILE_T and D_STATE are PS, TT and N here). u, dt, y, pos rows are
// contiguous; Bm and Cm have unit stride along N and the given batch and row
// strides (elements); A, Dp and ckpt are contiguous f32. Return the launch's
// cudaError_t (0 = launched).
#define HEADS_DUAL_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* u, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, void* y, void* ckpt, int B, int L, \
                      int H, int P, int chunk, void* stream) {                \
    return launch_dual<T>(make_operands(u, dt, A, Bm, Cm, bc_bstride,         \
                                        bc_lstride, Dp, pos, pos_bstride, L,  \
                                        H, P),                                \
                          B, y, ckpt, chunk, stream);                         \
  }

HEADS_DUAL_ENTRY(selective_scan_heads_dual_f32, float)
HEADS_DUAL_ENTRY(selective_scan_heads_dual_bf16, __nv_bfloat16)
