// conv1d_pack forward (#1) and dx backward (#2): segmented causal depthwise
// conv (PackMamba Algorithm 1) for Hopper (sm_90a).
//
// #1 replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/conv1d_pack.py (entry `conv1d_pack_fwd_pallas`):
//
//   y[b,t,d] = bias[d] + sum_{k=0..W-1} w[W-1-k,d] * x[b,t-k,d]
//                         * [k == 0 or (t-k >= 0 and pos[b,t] >= k)]
//
// accumulated in f32 with the bias first and the taps in k order, then cast
// to x's dtype (f32 or bf16; w and bias have x's dtype, pos is int32).
//
// #2 replaces `_bwd_dx_kernel` of the same file (entry
// `conv1d_pack_bwd_dx_pallas`):
//
//   dx[b,t,d] = sum_{k=0..W-1} w[W-1-k,d] * dy[b,t+k,d]
//                               * [t+k < L and pos[b,t+k] >= k]
//
// accumulated in f32 in k order and written as f32 (dy has x's dtype).
//
// What bounds both: bytes. A tap is one FMA on 2 or 4 bytes, far below the
// card's operations-per-byte ridge, so the least time is (x + y + pos + w +
// bias bytes) over the memory rate (dx: dy + dx + pos + w). The design
// keeps the memory system busy with few instructions a byte and reads each
// input byte from DRAM about once:
//   * a thread owns one 16-byte vector of channels (8 bf16 or 4 f32) and
//     walks a run of `run` consecutive rows of one batch row; a block's
//     threads lie across channels, so a warp moves 512 contiguous bytes of
//     a row in one instruction;
//   * grid (runs × channel blocks, B), THREADS threads a block: grid.x
//     holds up to 2^31-1 blocks, so any L, and its channel block runs
//     fastest, so the blocks resident together read whole rows; offsets
//     are 64-bit products of the block's coordinates and the strides, and
//     no thread divides a 64-bit index;
//   * the W weight rows and the bias sit in registers (f32), loaded once a
//     thread; x (dy) rows slide through a register window, so each row is
//     loaded once a run, plus W-1 halo rows (before the run for #1, after it
//     for #2) that the neighbouring run also reads and mostly hit L2;
//   * rows are loaded U at a time, and the next group's U loads are issued
//     before the current group's FMAs, so each thread keeps U to 2U 16-byte
//     loads in flight (waiting for each group before loading the next left
//     #1 at about 60% of its byte bound on the H100; PERF.md §6);
//   * the run's positions (the same for every thread of a block) are staged
//     in shared memory with one coalesced load a block.
// A masked tap is skipped (a branch uniform over the block: the mask
// depends on (b, t) only), never multiplied by a 0/1 mask, so a NaN or inf
// in another segment's row cannot reach an output. The FMA chain is the one
// of the plain versions (bias, then k = 0..W-1; dx from 0), so outputs do
// not depend on the run length or the width, and repeat bitwise (no
// atomics).
//
// The sequence start is masked by `t-k >= 0` and the buffer end by
// `t+k < L` themselves, not through the position mask: a carried row of a
// split pack starts with pos > 0, and its last segment may run off the
// buffer. L and D are masked, never padded. x is read through its batch
// and row strides, so the x half of an in_proj output (a strided view) is
// taken without a copy.
//
// The 16-byte path needs x, w, bias and y (dy, w) 16-byte aligned and D and
// x's strides multiples of 16 bytes; the wrapper checks that and otherwise
// asks for the same kernel one element wide (`vec` = 0).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int U = 4;               // rows loaded together a thread
constexpr int THREADS = 128;       // a block's, across channels

template <typename T> constexpr int vec_width() { return 16 / sizeof(T); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V values of T as loaded: one 16-byte vector, or one element.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  static_assert(V == 1 || V * sizeof(T) == 16, "a vector is 16 bytes");
  if constexpr (V == 1) return p[0];
  else return __ldg(reinterpret_cast<const uint4*>(p));
}

// One 32-bit word of a vector into f32: one f32, or two bf16 (a bf16 is
// the high half of its f32, so the widening is exact).
template <typename T>
__device__ __forceinline__ void widen_word(uint32_t word, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(word);
  } else {
    out[0] = __uint_as_float(word << 16);
    out[1] = __uint_as_float(word & 0xffff0000u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& r, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(r);
  } else {
    constexpr int per = V / 4;                 // values a 32-bit word
    widen_word<T>(r.x, out);
    widen_word<T>(r.y, out + per);
    widen_word<T>(r.z, out + 2 * per);
    widen_word<T>(r.w, out + 3 * per);
  }
}

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[V]) {
  widen<T, V>(load_raw<T, V>(p), out);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo
  uint32_t bits;
  memcpy(&bits, &h, sizeof(bits));
  return bits;
}

// V f32 values to p as T (f32, or bf16 rounded to nearest even), in 16-byte
// stores when V > 1.
template <typename T, int V>
__device__ __forceinline__ void store_as(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) p[0] = v[0];
    else p[0] = __float2bfloat16_rn(v[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else {
    static_assert(V == 8, "a bf16 vector is 8 values");
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

template <int V>
__device__ __forceinline__ void zero(float (&v)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = 0.f;
}

// The block's (run, channel block) from grid.x = runs × channel blocks,
// the channel block fastest: one 32-bit division a thread.
template <int V>
__device__ __forceinline__ int2 block_coords(int D) {
  const unsigned nb = ((unsigned)D + V * THREADS - 1) / (V * THREADS);
  const unsigned r = blockIdx.x / nb;
  return make_int2((int)r, (int)(blockIdx.x - r * nb));
}

// Positions pos[b, t0 .. t0+n-1] into shared memory, one coalesced load a
// block, then a barrier.
__device__ __forceinline__ void stage_positions(const int32_t* pr, int n,
                                                int32_t* spos) {
  for (int i = threadIdx.x; i < n; i += THREADS) spos[i] = pr[i];
  __syncthreads();
}

// #1. Block (run, channel block; b); thread: V channels from d over the
// run's rows. xs[0..W-2] hold the W-1 rows before the current group of U,
// xs[W-1+u] the group's row u; `next` the group after it, still loading.
template <typename T, int W, int V>
__global__ void __launch_bounds__(THREADS) conv1d_pack_fwd_kernel(
    const T* __restrict__ x, int64_t x_bstride, int64_t x_lstride,
    const T* __restrict__ w, const T* __restrict__ bias,
    const int32_t* __restrict__ pos, int64_t pos_bstride,
    T* __restrict__ y, int L, int D, int run) {
  extern __shared__ int32_t spos[];          // pos of the run's rows
  const int2 rc = block_coords<V>(D);
  const int t0 = rc.x * run;
  const int n = min(run, L - t0);
  const int64_t b = blockIdx.y;
  stage_positions(pos + b * pos_bstride + t0, n, spos);
  const int d = (rc.y * THREADS + threadIdx.x) * V;
  if (d >= D) return;

  float bv[V], wr[W][V];
  load_f32<T, V>(bias + d, bv);
#pragma unroll
  for (int k = 0; k < W; ++k) load_f32<T, V>(w + (int64_t)k * D + d, wr[k]);
  const T* xr = x + b * x_bstride + d;
  T* yr = y + (b * L + t0) * (int64_t)D + d;

  float xs[W - 1 + U][V];
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {          // halo: rows t0-(W-1) .. t0-1
    const int t = t0 - (W - 1) + j;
    if (t >= 0) load_f32<T, V>(xr + (int64_t)t * x_lstride, xs[j]);
    else zero(xs[j]);
  }
  Raw<T, V> next[U];                         // the next group, in flight
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < n) next[u] = load_raw<T, V>(xr + (int64_t)(t0 + u) * x_lstride);
  for (int s = 0; s < n; s += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      widen<T, V>(next[u], xs[W - 1 + u]);
      if (s + U + u < n)
        next[u] = load_raw<T, V>(xr + (int64_t)(t0 + s + U + u) * x_lstride);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u < n) {
        const int t = t0 + s + u;
        const int p = spos[s + u];
        float acc[V];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = bv[c];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (k == 0 || (t - k >= 0 && p >= k)) {
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[c] = acc[c] + wr[W - 1 - k][c] * xs[W - 1 + u - k][c];
          }
        }
        store_as<T, V>(yr + (int64_t)(s + u) * D, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < W - 1; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c) xs[j][c] = xs[U + j][c];
  }
}

// #2. Block (run, channel block; b); thread: V channels from d over the
// run's rows. ys[j] holds dy row t0+s+j: the group's U rows and the W-1
// after them (the halo past the run's end, taken only where < L); `next`
// the U rows after those, still loading.
template <typename T, int W, int V>
__global__ void __launch_bounds__(THREADS) conv1d_pack_bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ w,
    const int32_t* __restrict__ pos, int64_t pos_bstride,
    float* __restrict__ dx, int L, int D, int run) {
  extern __shared__ int32_t spos[];          // pos of the rows read
  const int2 rc = block_coords<V>(D);
  const int t0 = rc.x * run;
  const int n = min(run, L - t0);            // rows written
  const int m = min(run + W - 1, L - t0);    // rows read: r < m ⇔ t0+r < L
  const int64_t b = blockIdx.y;
  stage_positions(pos + b * pos_bstride + t0, m, spos);
  const int d = (rc.y * THREADS + threadIdx.x) * V;
  if (d >= D) return;

  float wr[W][V];
#pragma unroll
  for (int k = 0; k < W; ++k) load_f32<T, V>(w + (int64_t)k * D + d, wr[k]);
  const int64_t row0 = (b * L + t0) * (int64_t)D + d;
  const T* dyr = dy + row0;
  float* dxr = dx + row0;

  float ys[W - 1 + U][V];
#pragma unroll
  for (int j = 0; j < W - 1; ++j)            // rows t0 .. t0+W-2
    if (j < m) load_f32<T, V>(dyr + (int64_t)j * D, ys[j]);
  Raw<T, V> next[U];                         // the next group, in flight
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (W - 1 + u < m)
      next[u] = load_raw<T, V>(dyr + (int64_t)(W - 1 + u) * D);
  for (int s = 0; s < n; s += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      widen<T, V>(next[u], ys[W - 1 + u]);
      const int r = s + U + W - 1 + u;
      if (r < m) next[u] = load_raw<T, V>(dyr + (int64_t)r * D);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u < n) {
        float acc[V];
        zero(acc);
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int r = s + u + k;
          if (r < m && spos[r] >= k) {
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[c] = acc[c] + wr[W - 1 - k][c] * ys[u + k][c];
          }
        }
        store_as<float, V>(dxr + (int64_t)(s + u) * D, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < W - 1; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c) ys[j][c] = ys[U + j][c];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Grid of either kernel: (runs × channel blocks, B), as `block_coords`
// reads it. grid.x takes up to 2^31-1 blocks, grid.y 65535.
bool make_grid(int B, int L, int D, int V, int run, dim3* g) {
  if (run < 1) return false;
  const int64_t runs = (L + (int64_t)run - 1) / run;
  const int64_t blocks = (D + (int64_t)V * THREADS - 1) / (V * THREADS);
  if (runs * blocks > 0x7fffffff || B > 65535) return false;
  *g = dim3((unsigned)(runs * blocks), (unsigned)B);
  return true;
}

// What a launch took, for the caller: {channels a thread, threads a block,
// grid x, y, z}. `launched` may be null.
void record(int* launched, int V, dim3 g) {
  if (!launched) return;
  launched[0] = V;
  launched[1] = THREADS;
  launched[2] = (int)g.x;
  launched[3] = (int)g.y;
  launched[4] = (int)g.z;
}

template <typename T, int V>
int launch_fwd_v(const T* x, int64_t x_bstride, int64_t x_lstride,
                 const T* w, const T* bias, const int32_t* pos,
                 int64_t pos_bstride, T* y, int B, int L, int D, int W,
                 int run, int* launched, cudaStream_t s) {
  dim3 grid;
  if (!make_grid(B, L, D, V, run, &grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)run * sizeof(int32_t);
#define FWD_CASE(WW)                                                      \
  case WW:                                                                \
    conv1d_pack_fwd_kernel<T, WW, V><<<grid, THREADS, smem, s>>>(         \
        x, x_bstride, x_lstride, w, bias, pos, pos_bstride, y, L, D, run); \
    break;
  switch (W) {
    FWD_CASE(1) FWD_CASE(2) FWD_CASE(3) FWD_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_CASE
  record(launched, V, grid);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, int64_t x_bstride, int64_t x_lstride,
               const void* w, const void* bias, const void* pos,
               int64_t pos_bstride, void* y, int B, int L, int D, int W,
               int run, int vec, int* launched, void* stream) {
  if ((int64_t)B * L * D == 0) return 0;
  constexpr int V = vec_width<T>();
  cudaStream_t s = (cudaStream_t)stream;
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  const T* bp = (const T*)bias;
  const int32_t* pp = (const int32_t*)pos;
  T* yp = (T*)y;
  if (!vec)
    return launch_fwd_v<T, 1>(xp, x_bstride, x_lstride, wp, bp, pp,
                              pos_bstride, yp, B, L, D, W, run, launched, s);
  if (!(aligned16(x) && aligned16(w) && aligned16(bias) && aligned16(y)) ||
      x_bstride % V || x_lstride % V || D % V)
    return (int)cudaErrorMisalignedAddress;
  return launch_fwd_v<T, V>(xp, x_bstride, x_lstride, wp, bp, pp,
                            pos_bstride, yp, B, L, D, W, run, launched, s);
}

template <typename T, int V>
int launch_dx_v(const T* dy, const T* w, const int32_t* pos,
                int64_t pos_bstride, float* dx, int B, int L, int D, int W,
                int run, int* launched, cudaStream_t s) {
  dim3 grid;
  if (!make_grid(B, L, D, V, run, &grid)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(run + W - 1) * sizeof(int32_t);
#define DX_CASE(WW)                                                       \
  case WW:                                                                \
    conv1d_pack_bwd_dx_kernel<T, WW, V><<<grid, THREADS, smem, s>>>(      \
        dy, w, pos, pos_bstride, dx, L, D, run);                          \
    break;
  switch (W) {
    DX_CASE(1) DX_CASE(2) DX_CASE(3) DX_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DX_CASE
  record(launched, V, grid);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* dy, const void* w, const void* pos,
              int64_t pos_bstride, void* dx, int B, int L, int D, int W,
              int run, int vec, int* launched, void* stream) {
  if ((int64_t)B * L * D == 0) return 0;
  constexpr int V = vec_width<T>();
  cudaStream_t s = (cudaStream_t)stream;
  const T* dyp = (const T*)dy;
  const T* wp = (const T*)w;
  const int32_t* pp = (const int32_t*)pos;
  float* dxp = (float*)dx;
  if (!vec)
    return launch_dx_v<T, 1>(dyp, wp, pp, pos_bstride, dxp, B, L, D, W, run,
                             launched, s);
  if (!(aligned16(dy) && aligned16(w) && aligned16(dx)) || D % V)
    return (int)cudaErrorMisalignedAddress;
  return launch_dx_v<T, V>(dyp, wp, pp, pos_bstride, dxp, B, L, D, W, run,
                           launched, s);
}

// out = {blocks an SM, warps an SM, registers a thread, local (spill) bytes
// a thread, shared bytes a block} of `kernel` at THREADS threads.
template <typename K>
int resources(K kernel, size_t smem, int* out) {
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                      THREADS, smem);
  out[1] = out[0] * THREADS / 32;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)(fa.sharedSizeBytes + smem);
  return (int)e;
}

template <typename T, int W, int V>
int occupancy_w(int dx, int run, int* out) {
  if (dx)
    return resources(&conv1d_pack_bwd_dx_kernel<T, W, V>,
                     (size_t)(run + W - 1) * sizeof(int32_t), out);
  return resources(&conv1d_pack_fwd_kernel<T, W, V>,
                   (size_t)run * sizeof(int32_t), out);
}

template <typename T, int V>
int occupancy(int dx, int W, int run, int* out) {
  switch (W) {
    case 1: return occupancy_w<T, 1, V>(dx, run, out);
    case 2: return occupancy_w<T, 2, V>(dx, run, out);
    case 3: return occupancy_w<T, 3, V>(dx, run, out);
    case 4: return occupancy_w<T, 4, V>(dx, run, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries, one per dtype, bound with ctypes. Strides are in
// elements; w is (W, D) and bias (D,) contiguous; y is (B, L, D)
// contiguous; pos (B, L) has unit row stride. `run` is the rows a thread
// walks, `vec` 1 for 16-byte channel vectors (needs the alignment above),
// 0 for one element a thread. `launched` (5 ints, or null) receives what
// the launch took: channels a thread, threads a block, grid x, y, z.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int conv1d_pack_fwd_f32(
    const void* x, int64_t x_bstride, int64_t x_lstride, const void* w,
    const void* bias, const void* pos, int64_t pos_bstride, void* y, int B,
    int L, int D, int W, int run, int vec, int* launched, void* stream) {
  return launch_fwd<float>(x, x_bstride, x_lstride, w, bias, pos,
                           pos_bstride, y, B, L, D, W, run, vec, launched,
                           stream);
}

extern "C" int conv1d_pack_fwd_bf16(
    const void* x, int64_t x_bstride, int64_t x_lstride, const void* w,
    const void* bias, const void* pos, int64_t pos_bstride, void* y, int B,
    int L, int D, int W, int run, int vec, int* launched, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, x_bstride, x_lstride, w, bias, pos,
                                   pos_bstride, y, B, L, D, W, run, vec,
                                   launched, stream);
}

// dx entries: dy (B, L, D) contiguous in x's dtype, w (W, D) contiguous,
// pos (B, L) with unit row stride, dx (B, L, D) contiguous f32; `run`,
// `vec` and `launched` as above.
extern "C" int conv1d_pack_bwd_dx_f32(
    const void* dy, const void* w, const void* pos, int64_t pos_bstride,
    void* dx, int B, int L, int D, int W, int run, int vec, int* launched,
    void* stream) {
  return launch_dx<float>(dy, w, pos, pos_bstride, dx, B, L, D, W, run, vec,
                          launched, stream);
}

extern "C" int conv1d_pack_bwd_dx_bf16(
    const void* dy, const void* w, const void* pos, int64_t pos_bstride,
    void* dx, int B, int L, int D, int W, int run, int vec, int* launched,
    void* stream) {
  return launch_dx<__nv_bfloat16>(dy, w, pos, pos_bstride, dx, B, L, D, W,
                                  run, vec, launched, stream);
}

// Resources of the width-W kernel (dx != 0: #2, else #1) for bf16 (bf16 !=
// 0) or f32 input, 16-byte (vec != 0) or one element wide, at a run of
// `run` rows: out as `resources` above.
extern "C" int conv1d_pack_occupancy(int dx, int bf16, int vec, int W,
                                     int run, int* out) {
  if (run < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return vec ? occupancy<__nv_bfloat16, 8>(dx, W, run, out)
               : occupancy<__nv_bfloat16, 1>(dx, W, run, out);
  return vec ? occupancy<float, 4>(dx, W, run, out)
             : occupancy<float, 1>(dx, W, run, out);
}
