// conv1d_pack forward: segmented causal depthwise conv (PackMamba Algorithm 1)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/conv1d_pack.py (entry `conv1d_pack_fwd_pallas`).
//
//   y[b,t,d] = bias[d] + sum_{k=0..W-1} w[W-1-k,d] * x[b,t-k,d]
//                         * [k == 0 or (t-k >= 0 and pos[b,t] >= k)]
//
// accumulated in f32 with the bias first and the taps in k order, then cast
// to x's dtype (f32 or bf16; w and bias have x's dtype, pos is int32).
//
// What bounds it: bytes. Each output reads W inputs and writes one value,
// about 2 flops per tap, so it sits far below the card's
// operations-per-byte ridge; the least time is (x + y + pos + w + b bytes)
// over the memory rate. The design therefore only has to keep the memory
// system busy and read each byte of x from DRAM about once:
//   * one thread per (b, t, d) with d fastest, so a warp reads and writes
//     32 neighbouring channels of one row (coalesced);
//   * the W-1 earlier rows a thread reads are the rows its neighbours in t
//     read as their current tap, so they come from L1/L2, not DRAM; no
//     shared-memory halo is needed;
//   * W is a template parameter, so the tap loop unrolls.
// The TPU kernel's chunk-and-halo scheme (an L-chunk plus the previous
// chunk's last W-1 rows, zeroed at chunk 0) is not needed: any thread reads
// x[t-k] directly. L needs no padding; the sequence start is masked here by
// `t - k >= 0` on its own, because a carried row of a split pack starts
// with pos > 0 and the position test alone would read before the row.
// x is read through its batch and row strides, so the x half of the
// in_proj output (a strided view) is taken without a copy.
//
// conv1d_pack dx backward: replaces `_bwd_dx_kernel` of the same file
// (entry `conv1d_pack_bwd_dx_pallas`):
//
//   dx[b,t,d] = sum_{k=0..W-1} w[W-1-k,d] * dy[b,t+k,d] * [t+k < L and pos[b,t+k] >= k]
//
// accumulated in f32 in k order and written as f32 (dy has x's dtype).
// Bound by bytes as the forward is. The TPU kernel's reverse halo (the next
// chunk's first W-1 rows, zeroed at the last chunk) is not needed: a thread
// reads dy[t+k] directly and stops at the buffer's end by `t+k < L` itself,
// not through the position mask, so a row whose last segment runs off the
// buffer (a carried row of a split pack) is right. Grid: one block row per
// (b, t) and channels across block x, so no thread divides a 64-bit index.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T, int W>
__global__ void conv1d_pack_fwd_kernel(
    const T* __restrict__ x, int64_t x_bstride, int64_t x_lstride,
    const T* __restrict__ w, const T* __restrict__ bias,
    const int32_t* __restrict__ pos, int64_t pos_bstride,
    T* __restrict__ y, int L, int D, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % D);
  const int64_t bt = i / D;
  const int t = (int)(bt % L);
  const int64_t b = bt / L;
  const int p = pos[b * pos_bstride + t];
  const T* xr = x + b * x_bstride + d;
  float acc = to_f32(bias[d]);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k == 0 || (t - k >= 0 && p >= k)) {
      const float xv = to_f32(xr[(int64_t)(t - k) * x_lstride]);
      acc = acc + to_f32(w[(W - 1 - k) * D + d]) * xv;
    }
  }
  y[i] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, int64_t x_bstride, int64_t x_lstride,
           const void* w, const void* bias, const void* pos,
           int64_t pos_bstride, void* y, int B, int L, int D, int W,
           void* stream) {
  const int64_t total = (int64_t)B * L * D;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  const T* bp = (const T*)bias;
  const int32_t* pp = (const int32_t*)pos;
  T* yp = (T*)y;
  switch (W) {
    case 1: conv1d_pack_fwd_kernel<T, 1><<<blocks, threads, 0, s>>>(
        xp, x_bstride, x_lstride, wp, bp, pp, pos_bstride, yp, L, D, total);
      break;
    case 2: conv1d_pack_fwd_kernel<T, 2><<<blocks, threads, 0, s>>>(
        xp, x_bstride, x_lstride, wp, bp, pp, pos_bstride, yp, L, D, total);
      break;
    case 3: conv1d_pack_fwd_kernel<T, 3><<<blocks, threads, 0, s>>>(
        xp, x_bstride, x_lstride, wp, bp, pp, pos_bstride, yp, L, D, total);
      break;
    case 4: conv1d_pack_fwd_kernel<T, 4><<<blocks, threads, 0, s>>>(
        xp, x_bstride, x_lstride, wp, bp, pp, pos_bstride, yp, L, D, total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int W>
__global__ void conv1d_pack_bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ w,
    const int32_t* __restrict__ pos, int64_t pos_bstride,
    float* __restrict__ dx, int L, int D) {
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int bt = blockIdx.x;            // row-major (b, t)
  const int b = bt / L, t = bt - b * L;
  const int32_t* pr = pos + b * pos_bstride;
  const T* dyr = dy + (int64_t)b * L * D + d;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int tk = t + k;
    if (tk < L && pr[tk] >= k)
      acc = acc + to_f32(w[(W - 1 - k) * D + d])
                  * to_f32(dyr[(int64_t)tk * D]);
  }
  dx[(int64_t)bt * D + d] = acc;
}

template <typename T>
int launch_bwd_dx(const void* dy, const void* w, const void* pos,
                  int64_t pos_bstride, void* dx, int B, int L, int D, int W,
                  void* stream) {
  if ((int64_t)B * L * D == 0) return 0;
  if ((int64_t)B * L > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)(B * L), (unsigned)((D + threads - 1) / threads));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const T* dyp = (const T*)dy;
  const T* wp = (const T*)w;
  const int32_t* pp = (const int32_t*)pos;
  float* dxp = (float*)dx;
  switch (W) {
    case 1: conv1d_pack_bwd_dx_kernel<T, 1><<<grid, threads, 0, s>>>(
        dyp, wp, pp, pos_bstride, dxp, L, D);
      break;
    case 2: conv1d_pack_bwd_dx_kernel<T, 2><<<grid, threads, 0, s>>>(
        dyp, wp, pp, pos_bstride, dxp, L, D);
      break;
    case 3: conv1d_pack_bwd_dx_kernel<T, 3><<<grid, threads, 0, s>>>(
        dyp, wp, pp, pos_bstride, dxp, L, D);
      break;
    case 4: conv1d_pack_bwd_dx_kernel<T, 4><<<grid, threads, 0, s>>>(
        dyp, wp, pp, pos_bstride, dxp, L, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dx entries: dy (B, L, D) contiguous in x's dtype, w (W, D) contiguous,
// pos (B, L) with unit row stride, dx (B, L, D) contiguous f32.
extern "C" int conv1d_pack_bwd_dx_f32(
    const void* dy, const void* w, const void* pos, int64_t pos_bstride,
    void* dx, int B, int L, int D, int W, void* stream) {
  return launch_bwd_dx<float>(dy, w, pos, pos_bstride, dx, B, L, D, W,
                              stream);
}

extern "C" int conv1d_pack_bwd_dx_bf16(
    const void* dy, const void* w, const void* pos, int64_t pos_bstride,
    void* dx, int B, int L, int D, int W, void* stream) {
  return launch_bwd_dx<__nv_bfloat16>(dy, w, pos, pos_bstride, dx, B, L, D,
                                      W, stream);
}

// Plain C entries, one per dtype, bound with ctypes. Strides are in
// elements; w is (W, D) and bias (D,) contiguous; y is (B, L, D)
// contiguous. Returns the launch's cudaError_t (0 = launched).
extern "C" int conv1d_pack_fwd_f32(
    const void* x, int64_t x_bstride, int64_t x_lstride, const void* w,
    const void* bias, const void* pos, int64_t pos_bstride, void* y, int B,
    int L, int D, int W, void* stream) {
  return launch<float>(x, x_bstride, x_lstride, w, bias, pos, pos_bstride, y,
                       B, L, D, W, stream);
}

extern "C" int conv1d_pack_fwd_bf16(
    const void* x, int64_t x_bstride, int64_t x_lstride, const void* w,
    const void* bias, const void* pos, int64_t pos_bstride, void* y, int B,
    int L, int D, int W, void* stream) {
  return launch<__nv_bfloat16>(x, x_bstride, x_lstride, w, bias, pos,
                               pos_bstride, y, B, L, D, W, stream);
}
