// Segmented selective scan (PackMamba's ScanOp_pack, Mamba-1 per-channel
// decay), forward, for Hopper (sm_90a): kernel #4.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_blocked` of
// src/repro/kernels/selective_scan.py (entry `selective_scan_fwd_pallas`,
// schedule="blocked"). Same function, same outputs:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   y_t = sum_n C_t[n] * h_t[n] + D * u_t
//
// forward:  u, dt (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//           read through their batch and row strides; Dp (D,) f32;
//           pos (B,L) i32 -> y (B,L,D) in u's type, ckpt (B,nC,N,D) f32 = the
//           state at each chunk's entry (nC = ceil(L / chunk)).
// Its backward (#6) is csrc/selective_scan_bwd.cu, which reads ckpt.
//
// What bounds it on this card: not the bytes. At the training shape
// (B=2, L=4096, D=4096, N=16) the forward moves ~0.24 GB (u, dt, y once,
// the checkpoints) = 70 us at 3.35 TB/s, but needs B*L*D*N = 5.4e8
// exponentials; the special-function unit gives 16 a clock per SM, so
// those alone take ~0.13 ms on 132 SMs. The recurrence is sequential in t,
// so latency, not throughput, is the risk.
//
// Design:
//   * No carry between blocks: Hopper blocks run in no order, so the whole
//     L loop lives in one block. A block owns CH = 32 channels of one row b;
//     each channel's N = 16 states are split over G = 4 neighbouring threads
//     (4 states each, in registers), which gives 128 threads a block and
//     B*D/32 blocks. y is summed over the 4 threads with two xor shuffles
//     (a fixed order).
//   * Per time tile of TT = 16 steps the block stages u, dt for its
//     channels and B, C, pos of the row in shared memory with coalesced
//     loads; y leaves through shared memory the same way. L and D need no
//     padding: the ragged tile and dead channels are masked here.
//   * exp is __expf (ex2.approx): the argument dt*A is small (|.| < ~10).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int N = 16;          // d_state
constexpr int G = 4;           // threads per channel
constexpr int NPT = N / G;     // states per thread
constexpr int CH = 32;         // channels per block
constexpr int TT = 16;         // time tile
constexpr int THREADS = CH * G;

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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

struct Operands {
  const void* u; const void* dt; const float* At; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, D;
};

// Stage steps [t0, t0 + TT) of row b for channels [d0, d0 + CH): u, dt (and
// dy when given) as f32 (0 past L or D), B and C rows (0 past L), pos
// (1 past L: no reset on the dead steps).
template <typename T>
__device__ __forceinline__ void stage(const Operands& op, const T* dy,
                                      int b, int d0, int t0, float* su,
                                      float* sdt, float* sdy, float* sB,
                                      float* sC, int* spos) {
  const int tid = threadIdx.x;
  const T* u = (const T*)op.u;
  const T* dt = (const T*)op.dt;
  const int64_t row0 = (int64_t)b * op.L;
  for (int i = tid; i < TT * CH; i += THREADS) {
    const int s = i / CH, c = i % CH, t = t0 + s, d = d0 + c;
    const bool ok = t < op.L && d < op.D;
    const int64_t k = (row0 + t) * op.D + d;
    su[i] = ok ? to_f32(u[k]) : 0.f;
    sdt[i] = ok ? to_f32(dt[k]) : 0.f;
    if (dy != nullptr) sdy[i] = ok ? to_f32(dy[k]) : 0.f;
  }
  const T* Bm = (const T*)op.Bm;
  const T* Cm = (const T*)op.Cm;
  for (int i = tid; i < TT * N; i += THREADS) {
    const int s = i / N, n = i % N, t = t0 + s;
    const bool ok = t < op.L;
    const int64_t k = b * op.bc_bstride + (int64_t)t * op.bc_lstride + n;
    sB[i] = ok ? to_f32(Bm[k]) : 0.f;
    sC[i] = ok ? to_f32(Cm[k]) : 0.f;
  }
  if (tid < TT) {
    const int t = t0 + tid;
    spos[tid] = t < op.L ? op.pos[b * op.pos_bstride + t] : 1;
  }
}

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_fwd_kernel(Operands op, T* __restrict__ y, float* __restrict__ ckpt,
                int chunk) {
  __shared__ float su[TT * CH], sdt[TT * CH], sy[TT * CH];
  __shared__ float sB[TT * N], sC[TT * N];
  __shared__ int spos[TT];
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / G, g = threadIdx.x % G, d = d0 + c;
  const bool live = d < op.D;
  const int L = op.L, D = op.D;
  const int nC = (L + chunk - 1) / chunk;
  float A[NPT], h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    A[j] = live ? op.At[(g * NPT + j) * D + d] : 0.f;
    h[j] = 0.f;
  }
  const float Dd = live ? op.Dp[d] : 0.f;
  for (int t0 = 0; t0 < L; t0 += TT) {
    stage<T>(op, nullptr, b, d0, t0, su, sdt, nullptr, sB, sC, spos);
    __syncthreads();
    const int steps = min(TT, L - t0);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const int t = t0 + s;
      if (t % chunk == 0 && live) {
        float* ck = ckpt + (((int64_t)b * nC + t / chunk) * N + g * NPT) * D
                    + d;
#pragma unroll
        for (int j = 0; j < NPT; ++j) ck[(int64_t)j * D] = h[j];
      }
      const float dl = sdt[s * CH + c], uu = su[s * CH + c];
      const float du = dl * uu;
      const bool reset = spos[s] == 0;
      const float* Bs = sB + s * N + g * NPT;
      const float* Cs = sC + s * N + g * NPT;
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const float a = reset ? 0.f : __expf(dl * A[j]);
        h[j] = a * h[j] + Bs[j] * du;
        yp += h[j] * Cs[j];
      }
      yp = quad_sum(yp);
      if (g == 0) sy[s * CH + c] = yp + Dd * uu;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * CH; i += THREADS) {
      const int s = i / CH, cc = i % CH;
      if (d0 + cc < D)
        y[((int64_t)b * L + t0 + s) * D + d0 + cc] = from_f32<T>(sy[i]);
    }
    __syncthreads();
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
  if (chunk < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((op.D + CH - 1) / CH, B);
  scan_fwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      op, (T*)y, (float*)ckpt, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan.py, whose
// BLOCK_D, TILE_T and D_STATE are CH, TT and N here). u, dt, y are (B, L, D)
// contiguous; Bm and Cm have unit stride along N and the given batch and row
// strides (elements); At (N, D), Dp (D,), ckpt (B, nC, N, D) are contiguous
// f32. Return the launch's cudaError_t (0 = launched).
#define SCAN_FWD_ENTRY(NAME, T)                                               \
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

SCAN_FWD_ENTRY(selective_scan_fwd_f32, float)
SCAN_FWD_ENTRY(selective_scan_fwd_bf16, __nv_bfloat16)
