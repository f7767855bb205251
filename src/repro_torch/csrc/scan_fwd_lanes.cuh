// The Mamba-1 selective scan forward parallel over TIME inside a block, for
// Hopper (sm_90a): the machinery of kernels #3 (the `step` schedule) and
// #4 (`blocked`), both wrapped in selective_scan.cu. Both compute
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + B_t * dt_t * u_t
//   y_t = sum_n C_t[n] * h_t[n] + D * u_t
//
// in:  u, dt (B,L,D) f32|bf16; At (N,D) f32; Bm, Cm (B,L,N) of u's type,
//      read through their batch and row strides; Dp (D,) f32; pos (B,L) i32
// out: y (B,L,D) in u's type, ckpt (B,nC,N,D) f32 = the state at each
//      chunk's entry (nC = ceil(L / chunk)).
//
// The including source defines SCAN_LANES_R (steps a lane: 4, 8 or 16) and
// SCAN_LANES_CH (channels a block: 16 or 32) first, and wraps
// `scan_lanes_fwd` in a __global__ of its own name and launch bounds.
//
// Layout and arithmetic (the paper's ScanOp_pack shape, as upstream Mamba's
// selective_scan_fwd_kernel: a segmented associative scan over time):
//   * A block owns one row b and CH adjacent channels and walks the row in
//     tiles of TL = 64 steps, first to last. A channel's tile is split over
//     S = TL / R neighbouring lanes of one warp, R consecutive steps each:
//     R = 8, CH = 16 give 128 threads and B*D/16 blocks.
//   * Per state n each lane forms its R pairs (a_t, b_t) = (exp(dt_t*A)
//     *[pos_t != 0], B_t*dt_t*u_t), keeps them in registers and folds them
//     into one; the S lanes combine the folds by a Kogge-Stone inclusive
//     scan (log2(S) rounds of shuffles) under (a1,b1)o(a2,b2) = (a1*a2,
//     a2*b1 + b2) with zero carry-in. The tile's entry state h_in is applied
//     after the scan: a lane's exit state is A_incl*h_in + B_incl (one FMA),
//     its entry the previous lane's exit (one shuffle; h_in for lane 0). So
//     the previous tile is off the scan's chain. The lane then replays its R
//     steps, adding C_t[n]*h_t to y_t in registers: one exponential per
//     (t, n, d), and y's sum over the states in a fixed order.
//   * The carried state lives in two shared slots by tile parity: tile k
//     reads h_in from slot k&1 while the channel's last lane writes the
//     tile's exit state into slot (k+1)&1, so no slot is written in the
//     tile that reads it.
//   * Checkpoints, by the mode the wrapper instantiates:
//     CKPT_TILES (chunk == TL): every tile's entry state, from slot k&1.
//     CKPT_ANY (any other chunk): chunk starts may fall inside tiles. Each
//     lane marks, once a tile, which of its R steps start a chunk (a bit
//     mask; none on a dead channel or past L) and writes h, the state before
//     such a step, from its registers during the replay, before the step's
//     FMA. Never from a slot: the slot holds tile entries only.
//   * The reset is folded into the exponent: a_t = ex2(dt_t*A*log2(e) +
//     r_t), r_t = -inf at a reset (ex2(-inf) = +0 exactly) and 0 elsewhere,
//     so a reset costs no select. A is pre-scaled by log2(e) once a block.
//   * Operands: the next tile's u, dt, B, C and positions are copied with
//     cp.async (16-byte, zero-filled past L and D; plain loads when a row is
//     not 16-byte aligned) into the other of two staging buffers while the
//     current tile computes. At a tile's start B and C are converted to f32
//     rows by state (a lane reads its R steps of a state as float4s); y
//     leaves through a shared tile in u's type, a row of 16 bytes a
//     thread, during the next tile, and the tile checkpoints as float4 rows.
//     Two barriers a tile order every hazard: (A) after tile k landed, before
//     tile k+1's copy into the buffer tile k-1 used, y's write-out of tile
//     k-1 and the conversion; (B) before the lanes read the converted rows.
//   * Ragged L and D are masked, nothing is padded: steps past L are
//     identity steps (a = 1, b = 0); dead channels have A = 0 and
//     u = dt = 0. A reset is a = 0 exactly; nothing divides by a.
//   * Per-tile code derives its offsets from a fresh %tid.x (tid_now), so
//     that nothing is held, or spilled, through the states' loop.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#if !defined(SCAN_LANES_R) || !defined(SCAN_LANES_CH)
#error "define SCAN_LANES_R and SCAN_LANES_CH before including this header"
#endif

namespace {

constexpr int N = 16;               // d_state
constexpr int TL = 64;              // time tile
constexpr int R = SCAN_LANES_R;     // consecutive steps a lane
constexpr int S = TL / R;           // lanes a channel
constexpr int CH = SCAN_LANES_CH;   // channels a block
constexpr int THREADS = CH * S;
constexpr int TLP = TL + 4;         // a row of TL steps, swizzled (tpos)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(R == 4 || R == 8 || R == 16, "R must be 4, 8 or 16");
static_assert(CH == 16 || CH == 32, "CH must be 16 or 32");
static_assert(THREADS % 32 == 0, "whole warps a block");

enum CkptMode { CKPT_TILES, CKPT_ANY };

// The launch bound for f32 input: at most 4 blocks, which its shared
// memory allows.
__host__ __device__ constexpr int f32_min_blocks(int bf16_min_blocks) {
  return bf16_min_blocks < 4 ? bf16_min_blocks : 4;
}

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
template <typename T> __device__ __forceinline__ T zero() {
  return from_f32<T>(0.f);
}

// Step t's column in a swizzled row of TLP floats: the steps from 32 on move
// 4 banks, so a quarter-warp's float4 reads of its lanes' runs meet no bank
// twice.
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

// A lane's R steps of one state's row of sB or sC (16-byte loads).
__device__ __forceinline__ void load_run(const float* row, float* v) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 x = ((const float4*)row)[q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}

struct Operands {
  const void* u; const void* dt; const float* At; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, D;
};

// Shared memory, in this order:
//   sA (N, CH) f32             A * log2(e)
//   hc (2, N, CH) f32          the carried state, one slot by tile parity
//   sB, sC (N, TLP) f32        the tile's B, C by state, swizzled (tpos)
//   spos (2, TL) int           positions, one row a staging buffer
//   two staging buffers in the input type T: u, dt (TL rows of CH, 16 bytes
//   of pad after every R rows: a lane's column reads meet no bank twice), B,
//   C (TL, N)
//   sy in T, laid out as u: the tile's y, out during the next tile
constexpr int ROWS_PAD = S;             // pads in a staged (TL, CH) tile
template <typename T> __host__ __device__ constexpr int stage_len() {  // of one
  return TL * CH + ROWS_PAD * (16 / (int)sizeof(T));
}
// Byte offsets of the regions above (each a multiple of 16).
template <typename T> struct Layout {
  static constexpr int HC = N * CH * 4;
  static constexpr int SB = HC + 2 * N * CH * 4;
  static constexpr int SC = SB + N * TLP * 4;
  static constexpr int POS = SC + N * TLP * 4;
  static constexpr int BUF = POS + 2 * TL * 4;
  static constexpr int BUF_BYTES =
      (2 * stage_len<T>() + 2 * TL * N) * (int)sizeof(T);
  static constexpr int SY = BUF + 2 * BUF_BYTES;
  static constexpr int BYTES = SY + stage_len<T>() * (int)sizeof(T);
};
template <typename T> constexpr size_t smem_bytes() {
  return Layout<T>::BYTES;
}

template <typename T> struct Stage {
  T *u, *dt, *Br, *Cr;
  int* pos;
};

// Staging buffer i (0 or 1).
template <typename T>
__device__ __forceinline__ Stage<T> stage_buf(unsigned char* smem, int i) {
  T* t = (T*)(smem + Layout<T>::BUF + i * Layout<T>::BUF_BYTES);
  return Stage<T>{t, t + stage_len<T>(), t + 2 * stage_len<T>(),
                  t + 2 * stage_len<T>() + TL * N,
                  (int*)(smem + Layout<T>::POS) + i * TL};
}

// Element offset of (step row, channel) in a staged (TL, CH) tile.
__device__ __forceinline__ int srow(int row, int pade) {
  return row * CH + (row / R) * pade;
}

// Issue the copies of tile k (steps [k TL, k TL + TL)) of row b, channels
// [d0, d0 + CH) into `st`: u, dt, B, C and pos (zeros past L and D; pos 0
// past L, read as no reset). `aligned`: every row and start is 16-byte
// aligned, so cp.async (one group, committed by the caller); else plain
// loads into the same buffer.
template <typename T>
__device__ __forceinline__ void stage(const Operands& op, int b, int d0,
                                      int k, bool aligned, const Stage<T>& st) {
  const int tid = tid_now(), L = op.L, D = op.D, t0 = k * TL;
  constexpr int E16 = 16 / sizeof(T);      // elements a 16-byte copy
  const T* u = (const T*)op.u;
  const T* dt = (const T*)op.dt;
  const T* Bm = (const T*)op.Bm;
  const T* Cm = (const T*)op.Cm;
  const int64_t row0 = (int64_t)b * L;
  if (aligned) {
    constexpr int CPR = CH / E16;          // copies a (t, CH) row
    for (int i = tid; i < 2 * TL * CPR; i += THREADS) {
      const int a = i / (TL * CPR), r = i % (TL * CPR);
      const int row = r / CPR, q = r % CPR, t = t0 + row, d = d0 + q * E16;
      const bool ok = t < L && d < D;
      const T* src = a == 0 ? u : dt;
      cp16((a == 0 ? st.u : st.dt) + srow(row, E16) + q * E16,
           ok ? src + (row0 + t) * D + d : src, ok ? 16 : 0);
    }
    constexpr int NPR = N / E16;           // copies a (t, N) row
    for (int i = tid; i < 2 * TL * NPR; i += THREADS) {
      const int a = i / (TL * NPR), r = i % (TL * NPR);
      const int row = r / NPR, q = r % NPR, t = t0 + row;
      const bool ok = t < L;
      const T* src = a == 0 ? Bm : Cm;
      cp16((a == 0 ? st.Br : st.Cr) + row * N + q * E16,
           ok ? src + b * op.bc_bstride + (int64_t)t * op.bc_lstride + q * E16
              : src, ok ? 16 : 0);
    }
    if (tid < TL / 4) {
      const int t = t0 + 4 * tid;
      const int bytes = max(0, min(16, (L - t) * 4));
      cp16(st.pos + 4 * tid,
           bytes ? op.pos + b * op.pos_bstride + t : op.pos, bytes);
    }
    return;
  }
  for (int i = tid; i < 2 * TL * CH; i += THREADS) {
    const int a = i / (TL * CH), r = i % (TL * CH);
    const int row = r / CH, c = r % CH, t = t0 + row, d = d0 + c;
    (a == 0 ? st.u : st.dt)[srow(row, E16) + c] =
        t < L && d < D ? (a == 0 ? u : dt)[(row0 + t) * D + d] : zero<T>();
  }
  for (int i = tid; i < 2 * TL * N; i += THREADS) {
    const int a = i / (TL * N), r = i % (TL * N);
    const int row = r / N, n = r % N, t = t0 + row;
    (a == 0 ? st.Br : st.Cr)[r] =
        t < L ? (a == 0 ? Bm : Cm)[b * op.bc_bstride +
                                   (int64_t)t * op.bc_lstride + n]
              : zero<T>();
  }
  if (tid < TL) {
    const int t = t0 + tid;
    st.pos[tid] = t < L ? op.pos[b * op.pos_bstride + t] : 0;
  }
}

// y of tile k from sy, a 16-byte row piece a thread when aligned.
template <typename T>
__device__ __forceinline__ void write_y(const Operands& op, T* y, int b,
                                        int d0, int k, bool aligned,
                                        const T* sy) {
  constexpr int E16 = 16 / sizeof(T);
  const int L = op.L, D = op.D, t0 = k * TL;
  if (aligned) {
    constexpr int CPR = CH / E16;
    for (int i = tid_now(); i < TL * CPR; i += THREADS) {
      const int row = i / CPR, q = i % CPR, d = d0 + q * E16;
      if (t0 + row < L && d < D)
        *(uint4*)(y + ((int64_t)b * L + t0 + row) * D + d) =
            *(const uint4*)(sy + srow(row, E16) + q * E16);
    }
    return;
  }
  for (int i = tid_now(); i < TL * CH; i += THREADS) {
    const int row = i / CH, c = i % CH;
    if (t0 + row < L && d0 + c < D)
      y[((int64_t)b * L + t0 + row) * D + d0 + c] = sy[srow(row, E16) + c];
  }
}

// The block (blockIdx.x, b): channels [CH blockIdx.x, + CH) of row b.
// CK: the checkpoint mode (see the top); CKPT_TILES ignores `chunk` (TL).
template <typename T, int CK>
__device__ __forceinline__ void scan_lanes_fwd(const Operands& op,
                                               T* __restrict__ y,
                                               float* __restrict__ ckpt,
                                               int aligned, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Lay = Layout<T>;
  float* sA = (float*)smem;
  float* hc = (float*)(smem + Lay::HC);
  float* sB = (float*)(smem + Lay::SB);
  float* sC = (float*)(smem + Lay::SC);
  T* sy = (T*)(smem + Lay::SY);
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int L = op.L, D = op.D;
  const int nT = (L + TL - 1) / TL;     // tiles
  const int nC = CK == CKPT_TILES ? nT : (L + chunk - 1) / chunk;
  constexpr int E16 = 16 / sizeof(T);
  for (int i = tid_now(); i < N * CH; i += THREADS) {
    const int d = d0 + i % CH;
    sA[i] = d < D ? op.At[(int64_t)(i / CH) * D + d] * LOG2E : 0.f;
    hc[i] = 0.f;                        // slot 0: tile 0's entry state
  }
  stage<T>(op, b, d0, 0, aligned, stage_buf<T>(smem, 0));
  cp_commit();
#pragma unroll 1
  for (int k = 0; k < nT; ++k) {
    const int t0 = k * TL;
    const Stage<T> cur = stage_buf<T>(smem, k & 1);
    cp_wait_all();
    __syncthreads();    // (A) tile k landed; every read of tile k-1 done
    if (k + 1 < nT) {
      stage<T>(op, b, d0, k + 1, aligned, stage_buf<T>(smem, (k + 1) & 1));
      cp_commit();
    }
    if (k > 0) write_y<T>(op, y, b, d0, k - 1, aligned, sy);
    if (CK == CKPT_TILES) {
      // the checkpoint: the state at tile k's entry, from slot k&1
      const float* hin = hc + (k & 1) * N * CH;
      float* dst = ckpt + ((int64_t)b * nC + k) * N * D + d0;
      if (aligned) {
        for (int i = tid_now(); i < N * CH / 4; i += THREADS) {
          const int n = i / (CH / 4), c = 4 * (i % (CH / 4));
          if (d0 + c < D)
            *(float4*)(dst + (int64_t)n * D + c) =
                *(const float4*)(hin + 4 * i);
        }
      } else {
        for (int i = tid_now(); i < N * CH; i += THREADS)
          if (d0 + i % CH < D) dst[(int64_t)(i / CH) * D + i % CH] = hin[i];
      }
    }
    for (int i = tid_now(); i < 2 * TL; i += THREADS) {  // a row of B or C
      const int t = i % TL;                             // a thread
      float v[N];
      load_row((i < TL ? cur.Br : cur.Cr) + t * N, v);
      float* dst = (i < TL ? sB : sC) + tpos(t);
#pragma unroll
      for (int n = 0; n < N; ++n) dst[n * TLP] = v[n];
    }
    __syncthreads();    // (B) B, C in place
    const int lt = tid_now(), c = lt / S, s = lt % S;
    const int o0 = srow(s * R, E16) + c;   // this lane's staged column
    float dl[R], du[R], rb[R], yv[R];
    {
      const float Dd = d0 + c < D ? op.Dp[d0 + c] : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = s * R + r, o = o0 + r * CH;
        const float uu = to_f32(cur.u[o]);
        dl[r] = to_f32(cur.dt[o]);
        du[r] = dl[r] * uu;
        yv[r] = Dd * uu;
        rb[r] = cur.pos[row] == 0 && t0 + row < L ? __int_as_float(0xff800000)
                                                   : 0.f;   // -inf
      }
    }
    // CKPT_ANY: bit r of cmask marks step ts + r as a chunk start (none on
    // a dead channel or past L); the j-th marked step is chunk first + j
    unsigned cmask = 0;
    float* ck = ckpt;
    if (CK == CKPT_ANY) {
      const int ts = t0 + s * R;
      const int first = (ts + chunk - 1) / chunk;
      if (d0 + c < D)
        for (int j = first * chunk - ts; j < R && ts + j < L; j += chunk)
          cmask |= 1u << j;
      ck = ckpt + ((int64_t)b * nC + first) * N * D + d0 + c;
    }
    const float* hin = hc + (k & 1) * N * CH + c;
    float* hout = hc + ((k + 1) & 1) * N * CH + c;
#pragma unroll 2
    for (int n = 0; n < N; ++n) {
      const float A2 = sA[n * CH + c];
      float Cv[R], a[R], bb[R];
      {
        float Bv[R];
        load_run(sB + n * TLP + tpos(s * R), Bv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = ex2(fmaf(dl[r], A2, rb[r]));     // exactly 0 at a reset
          bb[r] = Bv[r] * du[r];
        }
      }
      // fold the lane's steps: (Af, Bf) maps the state before its first
      // step to the one after its last; then the inclusive scan over the
      // channel's S lanes with zero carry-in
      float Af = a[0], Bf = bb[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        Bf = fmaf(a[r], Bf, bb[r]);
        Af *= a[r];
      }
#pragma unroll
      for (int off = 1; off < S; off *= 2) {
        const float Ap = __shfl_up_sync(FULL, Af, off, S);
        const float Bp = __shfl_up_sync(FULL, Bf, off, S);
        if (s >= off) {
          Bf = fmaf(Af, Bp, Bf);
          Af *= Ap;
        }
      }
      // the tile's entry state applied after the scan: this lane's exit
      // state; its entry is the previous lane's exit (h_in for lane 0)
      const float h_in = hin[n * CH];
      const float he = fmaf(Af, h_in, Bf);
      float h = __shfl_up_sync(FULL, he, 1, S);
      if (s == 0) h = h_in;
      if (s == S - 1) hout[n * CH] = he;    // the next tile's entry state
      load_run(sC + n * TLP + tpos(s * R), Cv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (CK == CKPT_ANY && (cmask >> r & 1u))   // h: the state before
          ck[((int64_t)__popc(cmask & ((1u << r) - 1u)) * N + n) * D] = h;
        h = fmaf(a[r], h, bb[r]);
        yv[r] = fmaf(Cv[r], h, yv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) sy[o0 + r * CH] = from_f32<T>(yv[r]);
  }
  __syncthreads();      // the last tile's y in sy
  write_y<T>(op, y, b, d0, nT - 1, aligned, sy);
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
bool is_aligned(const Operands& op, const void* y, const void* ckpt) {
  const uintptr_t p = (uintptr_t)op.u | (uintptr_t)op.dt | (uintptr_t)y |
                      (uintptr_t)op.Bm | (uintptr_t)op.Cm |
                      (uintptr_t)op.pos | (uintptr_t)ckpt;
  const int64_t es = sizeof(T);
  return p % 16 == 0 && op.D * es % 16 == 0 && op.D % 4 == 0 &&
         op.bc_bstride * es % 16 == 0 && op.bc_lstride * es % 16 == 0 &&
         op.pos_bstride % 4 == 0;
}

// Raise the kernel's dynamic shared memory limit to `bytes`, once (outside
// any graph capture).
template <auto Kernel>
int prepare(size_t bytes) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// The kernel's resources with `bytes` of dynamic shared memory: out =
// {blocks an SM, warps an SM, registers a thread, local (spill) bytes a
// thread, shared bytes a block}.
template <auto Kernel>
int resources(size_t bytes, int* out) {
  if (int e = prepare<Kernel>(bytes)) return e;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, Kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], Kernel,
                                                      THREADS, bytes);
  out[1] = out[0] * THREADS / 32;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  out[4] = (int)(fa.sharedSizeBytes + bytes);
  return (int)e;
}

}  // namespace
