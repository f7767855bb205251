// Device helpers shared by the head-structured scan's chunked (SSD)
// kernels, the forward #7 (selective_scan_heads_fwd.cu) and the backward #9
// (selective_scan_heads_bwd.cu): their operands, f32 tiles in shared memory
// and the products of two tiles on the tensor cores (mma.sync TF32, each
// operand split hi + lo), cp.async staging, and warp 0's scan of a
// sub-chunk's decays and resets.
//
// Both kernels run one block of THREADS threads per (b, head, slice of PB
// rows of P) and walk each checkpoint chunk in sub-chunks of Q steps; each
// warp owns a 16 x 32 tile of every 64 x 64 product.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int N = 64;            // d_state
constexpr int PB = 64;           // rows of P per block
constexpr int Q = 64;            // steps per sub-chunk
constexpr int LD = 68;           // padded row of a shared-memory tile
constexpr int TILE = 64 * LD;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// the per-step vectors (Q floats each) that Steps::scan writes at the start
// of a kernel's vector area
enum StepVec {
  V_DL,        // dt
  V_KEEP,      // 1 where pos != 0
  V_S,         // s: inclusive cumsum of dt * A
  V_RID,       // rid: inclusive cumsum of resets (as float: exact)
  V_CIN,       // cin_i = exp(s_i) [rid_i == 0]
  V_D,         // d_j = dec[Q-1, j]
  V_DD,        // d * dt
  V_STEPS
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of staged values to f32 at dst (16-byte aligned)
__device__ __forceinline__ void widen(float* dst, const float* src) {
  *(float4*)dst = *(const float4*)src;
}
__device__ __forceinline__ void widen(float* dst, const __nv_bfloat16* src) {
  const uint4 w = *(const uint4*)src;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&w.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&w.y);
  const float2 c = __bfloat1622float2(*(const __nv_bfloat162*)&w.z);
  const float2 d = __bfloat1622float2(*(const __nv_bfloat162*)&w.w);
  *(float4*)dst = make_float4(a.x, a.y, b.x, b.y);
  *(float4*)(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------- the tensor cores

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; hi*hi + hi*lo + lo*hi recovers ~f32 products
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (rows m0..m0+15, columns n0..n0+31 of the result, in mma's
// accumulator layout: acc[nt][q] at row m0 + g + 8*(q/2), column
// n0 + 8*nt + 2*tq + q%2, g = lane/4, tq = lane%4) +=
//   sum_k A(m, k) * ks[k] * B(k, n),  k < 64,
// A(m, k) = AT ? a[k*LD + m] : a[m*LD + k],
// B(k, n) = BT ? b[n*LD + k] : b[k*LD + n],  ks = 1 when null.
// AX (BX): every A (B) value is exact in TF32 — a bf16 input, unscaled — so
// its lo part is 0 and the cross product it would enter is not issued (the
// result is the same to the bit). The cross terms go to their own
// accumulator, added at the end, and the products are issued column tile
// by column tile, so each warp has up to 8 independent chains in flight.
template <bool AT, bool BT, bool AX, bool BX>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const float* __restrict__ ks,
                                         int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = m0 + g, r1 = r0 + 8;
  float cross[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) cross[nt][q] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < 64; k0 += 8) {
    const int ka = k0 + tq, kb = ka + 4;
    float av[4];
    av[0] = AT ? a[ka * LD + r0] : a[r0 * LD + ka];
    av[1] = AT ? a[ka * LD + r1] : a[r1 * LD + ka];
    av[2] = AT ? a[kb * LD + r0] : a[r0 * LD + kb];
    av[3] = AT ? a[kb * LD + r1] : a[r1 * LD + kb];
    if (ks != nullptr) {
      const float sa = ks[ka], sb = ks[kb];
      av[0] *= sa;
      av[1] *= sa;
      av[2] *= sb;
      av[3] *= sb;
    }
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (AX)
        ah[q] = __float_as_uint(av[q]);
      else
        split(av[q], ah[q], al[q]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + 8 * nt + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = e ? kb : ka;
        const float x = BT ? b[col * LD + k] : b[k * LD + col];
        if (BX)
          bh[nt][e] = __float_as_uint(x);
        else
          split(x, bh[nt][e], bl[nt][e]);
      }
    }
    if (!AX) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma8(cross[nt], al, bh[nt][0], bh[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma8(acc[nt], ah, bh[nt][0], bh[nt][1]);
    if (!BX) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma8(cross[nt], ah, bl[nt][0], bl[nt][1]);
    }
  }
  if (!(AX && BX)) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] += cross[nt][q];
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
}

// ------------------------------------------------------------ async copies

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;                 // 0: fill 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --------------------------------------------------------------- operands

// u (B, L, H, P), dt (B, L, H), Bm and Cm (B, L, N) through their batch and
// row strides (elements), pos (B, L) i32 through its batch stride; A and Dp
// (H,) f32
struct Operands {
  const void* u; const void* dt; const float* A; const void* Bm;
  const void* Cm; int64_t bc_bstride, bc_lstride; const float* Dp;
  const int32_t* pos; int64_t pos_bstride; int L, H, P;
};

Operands make_operands(const void* u, const void* dt, const void* A,
                       const void* Bm, const void* Cm, int64_t bc_bstride,
                       int64_t bc_lstride, const void* Dp, const void* pos,
                       int64_t pos_bstride, int L, int H, int P) {
  return Operands{u, dt, (const float*)A, Bm, Cm, bc_bstride, bc_lstride,
                  (const float*)Dp, (const int32_t*)pos, pos_bstride, L, H,
                  P};
}

// dt and pos of steps 2*lane and 2*lane + 1 of a sub-chunk, in warp 0's
// registers; steps at or past t_end are identity steps (dt 0, no reset)
template <typename T>
struct Steps {
  T dt[2];
  int pos[2];

  __device__ __forceinline__ void load(const Operands& op, int b, int h,
                                       int t0, int t_end, int lane) {
    const T* dtp = (const T*)op.dt;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + 2 * lane + e;
      const bool ok = t < t_end;
      dt[e] = ok ? dtp[((int64_t)b * op.L + t) * op.H + h]
                 : from_f32<T>(0.f);
      pos[e] = ok ? op.pos[b * op.pos_bstride + t] : 1;
    }
  }

  // the StepVec vectors at v: inclusive scans over the Q = 64 steps, two a
  // lane, in a fixed order
  __device__ __forceinline__ void scan(float* v, float A, int lane) const {
    float la[2], dl[2];
    int rs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dl[e] = to_f32(dt[e]);
      la[e] = dl[e] * A;
      rs[e] = pos[e] == 0;
    }
    const float s_own = la[0] + la[1];
    const int r_own = rs[0] + rs[1];
    float si = s_own;
    int ri = r_own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float sv = __shfl_up_sync(FULL, si, o);
      const int rv = __shfl_up_sync(FULL, ri, o);
      if (lane >= o) {
        si += sv;
        ri += rv;
      }
    }
    float sx = __shfl_up_sync(FULL, si, 1);     // exclusive prefix
    int rx = __shfl_up_sync(FULL, ri, 1);
    if (lane == 0) {
      sx = 0.f;
      rx = 0;
    }
    float sv[2];
    int rv[2];
    sv[0] = sx + la[0];
    sv[1] = sv[0] + la[1];
    rv[0] = rx + rs[0];
    rv[1] = rv[0] + rs[1];
    const float s_last = __shfl_sync(FULL, sv[1], 31);
    const int r_last = __shfl_sync(FULL, rv[1], 31);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      const float d = rv[e] == r_last ? expf(s_last - sv[e]) : 0.f;
      v[V_DL * Q + i] = dl[e];
      v[V_KEEP * Q + i] = rs[e] ? 0.f : 1.f;
      v[V_S * Q + i] = sv[e];
      v[V_RID * Q + i] = (float)rv[e];
      v[V_CIN * Q + i] = rv[e] == 0 ? expf(sv[e]) : 0.f;
      v[V_D * Q + i] = d;
      v[V_DD * Q + i] = d * dl[e];
    }
  }
};

}  // namespace
