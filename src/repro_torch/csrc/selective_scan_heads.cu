// Head-structured segmented selective scan (Mamba-2 / SSD: a scalar decay
// per head, B and C shared by every head), forward, for Hopper (sm_90a). Its
// backward (#9) is selective_scan_heads_bwd.cu.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/selective_scan.py:
//   #7 `_fwd_kernel_blocked_heads`      (schedule="blocked_heads")
//   #8 `_fwd_kernel_blocked_heads_dual` (schedule="blocked_heads_dual")
// Same functions, same chunk-entry checkpoints:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + (dt_t * u_t) (x) B_t
//   y_t = h_t . C_t + D * u_t            (h_t: (P, N) per (b, head))
//
// Layout: the JAX public one, not the TPU kernels' head-major copy.
// u, y (B, L, H, P); dt (B, L, H); A, Dp (H,) f32; Bm, Cm (B, L, N)
// read through their batch and row strides (views of one projection);
// pos (B, L) i32; ckpt (B, H, nC, P, N) f32, nC = ceil(L / chunk).
//
// What bounds it on this card: operations. At the training shape (B=8,
// L=4096, H=32, P=64, N=64) the forward moves ~0.3 GB (0.1 ms at
// 3.35 TB/s) but updates B*L*H*P*N = 4.3e9 states, ~5 f32 operations each
// (0.32 ms at 67 TFLOP/s). The recurrence is
// sequential in t, so latency is the risk, above all the device-memory
// latency of each tile's operands. With a scalar decay the exponentials
// (one per (b, t, head)) cost nothing.
//
// Design:
//   * No carry between blocks: one block walks a row's whole L for one head
//     and PS = 16 rows of P (rows are independent given the head's dt, B, C
//     and positions), which gives B*H*P/16 blocks (1024 at the training
//     shape). 128 threads: thread (rg, ng) holds rows rg, rg+8 and states
//     n = ng, ng+16, ng+32, ng+48 in registers, so each B_t, C_t value read
//     from shared memory serves two rows.
//   * Per time tile the block stages u (its rows), dt, a_t = exp(dt*A) and
//     pos, and B, C rows in shared memory with coalesced loads; each thread
//     loads its share of the next tile into registers while the block
//     computes the current one, which hides that latency. y leaves through
//     shared memory. A ragged L is masked, nothing is padded.
//   * #7 walks step by step; y_t's sum over n is a fixed butterfly of xor
//     shuffles inside each half warp.
//   * #8 keeps the dual form per tile of 16 steps: G = dec (.) (C B^T) in
//     shared memory, y = G (dt u) + cin (C h_in^T), h_out = dec[last] . bterm
//     + cin[last] h_in — the shape a tensor-core kernel will take later.
//   * No float atomics: sums over n go through fixed xor shuffles. Results
//     are bitwise repeatable.

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
constexpr int SPT = PPT * NPT;   // states per thread
constexpr int THREADS = NG * RG;
constexpr int TT = 16;           // forward tile
constexpr unsigned FULL = 0xffffffffu;

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

// Sum of a (row rg, row rg+RG) pair of partials over the 16 lanes of a half
// warp: afterwards lane ng == 0 holds row rg's total, lane ng == 8 row
// rg+RG's. Fixed order.
__device__ __forceinline__ float row_sum2(float v0, float v1, int ng) {
  const bool hi = (ng & 8) != 0;
  float keep = hi ? v1 : v0;
  const float send = hi ? v0 : v1;
  keep += __shfl_xor_sync(FULL, send, 8);
  keep += __shfl_xor_sync(FULL, keep, 4);
  keep += __shfl_xor_sync(FULL, keep, 2);
  keep += __shfl_xor_sync(FULL, keep, 1);
  return keep;
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

// One tile's operands on their way from device memory to shared memory:
// each thread holds a fixed share in registers, so the next tile's loads
// are in flight while the block computes the current one. Steps at or past
// t_end (the chunk's end or L) are identity steps: u, dy, B, C and dt 0,
// pos 1 (no reset), so a = exp(0) = 1 and nothing is added.
template <typename T, int NT>
struct Tile {
  static constexpr int UE = NT * PS / THREADS;   // u (and dy) per thread
  static constexpr int BE = NT * N / THREADS;    // B (and C) per thread
  static_assert(NT * PS % THREADS == 0 && NT * N % THREADS == 0, "tile");
  T u[UE], dy[UE], b[BE], c[BE];
  T d;
  int p;

  // full: also dy (when given) and C
  __device__ __forceinline__ void fetch(const Operands& op, const Where& w,
                                        const T* dyp, int t0, int t_end,
                                        bool full) {
    const int tid = threadIdx.x;
    const T zero = from_f32<T>(0.f);
    const T* up = (const T*)op.u;
#pragma unroll
    for (int q = 0; q < UE; ++q) {
      const int i = tid + q * THREADS, s = i / PS, r = i % PS, t = t0 + s;
      const bool ok = t < t_end;
      const int64_t k = ok ? at_lhp(op, w, t, r) : 0;
      u[q] = ok ? up[k] : zero;
      if (full && dyp != nullptr) dy[q] = ok ? dyp[k] : zero;
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
      if (full) c[q] = ok ? Cm[k] : zero;
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
  __device__ __forceinline__ void put(float A, bool full, float* su,
                                      float* sdy, float* sB, float* sC,
                                      float* sdt, float* sa,
                                      int* spos) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < UE; ++q) {
      su[tid + q * THREADS] = to_f32(u[q]);
      if (full && sdy != nullptr) sdy[tid + q * THREADS] = to_f32(dy[q]);
    }
#pragma unroll
    for (int q = 0; q < BE; ++q) {
      const int i = tid + q * THREADS, s = i / N, n = i % N;
      sB[s * NP + n] = to_f32(b[q]);
      if (full) sC[s * NP + n] = to_f32(c[q]);
    }
    if (tid < NT) {
      const float dd = to_f32(d);
      sdt[tid] = dd;
      sa[tid] = p == 0 ? 0.f : expf(dd * A);
      if (spos != nullptr) spos[tid] = p;
    }
  }
};

// ------------------------------------------------------------------ forward

// #7: per-step walk. Tiles of TT steps run from each chunk's start; the
// next tile's operands load while this one computes (two barriers a tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
heads_fwd_kernel(Operands op, T* __restrict__ y, float* __restrict__ ckpt,
                 int chunk) {
  __shared__ float su[TT * PS], sy[TT * PS], sB[TT * NP], sC[TT * NP];
  __shared__ float sdt[TT], sa[TT];

  const Where w = where_of(op);
  const int tid = threadIdx.x, ng = tid % NG, rg = tid / NG;
  const int L = op.L, nC = (L + chunk - 1) / chunk;
  const float A = op.A[w.h], Dd = op.Dp[w.h];
  float h[PPT][NPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int j = 0; j < NPT; ++j) h[k][j] = 0.f;

  Tile<T, TT> nxt;
  int c = 0, t0 = 0;
  nxt.fetch(op, w, nullptr, 0, min(L, chunk), true);
  while (true) {
    const int tc0 = c * chunk, tc1 = min(L, tc0 + chunk);
    if (t0 == tc0) {             // the state at the chunk's entry
      float* ck = ckpt + (((int64_t)w.b * op.H + w.h) * nC + c) * op.P * N
                  + (int64_t)w.p0 * N;
#pragma unroll
      for (int k = 0; k < PPT; ++k)
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          ck[(rg + RG * k) * N + ng + NG * j] = h[k][j];
    }
    nxt.put(A, true, su, nullptr, sB, sC, sdt, sa, nullptr);
    __syncthreads();
    int nc = c, nt0 = t0 + TT;
    if (nt0 >= tc1) {
      nc = c + 1;
      nt0 = nc * chunk;
    }
    const bool more = nc < nC;
    if (more) nxt.fetch(op, w, nullptr, nt0, min(L, nt0 - nt0 % chunk + chunk),
                        true);
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      const float a = sa[s], dl = sdt[s];
      float du[PPT], yp[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        du[k] = dl * su[s * PS + rg + RG * k];
        yp[k] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float bn = sB[s * NP + ng + NG * j];
        const float cn = sC[s * NP + ng + NG * j];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          h[k][j] = fmaf(du[k], bn, a * h[k][j]);
          yp[k] = fmaf(h[k][j], cn, yp[k]);
        }
      }
      const float v = row_sum2(yp[0], yp[1], ng);
      if ((ng & 7) == 0) {
        const int r = rg + RG * (ng >> 3);
        sy[s * PS + r] = fmaf(Dd, su[s * PS + r], v);
      }
    }
    __syncthreads();
    const int steps = min(TT, tc1 - t0);
    for (int i = tid; i < steps * PS; i += THREADS)
      y[at_lhp(op, w, t0 + i / PS, i % PS)] = from_f32<T>(sy[i]);
    if (!more) break;
    c = nc;
    t0 = nt0;
  }
}

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
        tile.fetch(op, w, nullptr, t0, tc1, true);
        tile.put(A, true, su, nullptr, sB, sC, sdt, sa, spos);
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
int launch_fwd(const Operands& op, int B, void* y, void* ckpt, int chunk,
               int dual, void* stream) {
  if ((int64_t)B * op.L * op.H * op.P == 0) return 0;
  int64_t blocks = 0;
  if (chunk < 1 || n_blocks(op, B, &blocks)) return (int)cudaErrorInvalidValue;
  if (dual)
    heads_dual_kernel<T><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(op, (T*)y, (float*)ckpt,
                                                   chunk);
  else
    heads_fwd_kernel<T><<<(unsigned)blocks, THREADS, 0,
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
#define HEADS_FWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* u, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, void* y, void* ckpt, int B, int L, \
                      int H, int P, int chunk, int dual, void* stream) {      \
    return launch_fwd<T>(make_operands(u, dt, A, Bm, Cm, bc_bstride,          \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       H, P),                                 \
                         B, y, ckpt, chunk, dual, stream);                    \
  }

HEADS_FWD_ENTRY(selective_scan_heads_fwd_f32, float)
HEADS_FWD_ENTRY(selective_scan_heads_fwd_bf16, __nv_bfloat16)
