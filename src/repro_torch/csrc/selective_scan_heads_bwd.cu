// Backward of the head-structured segmented selective scan (Mamba-2 / SSD:
// a scalar decay per head, B and C shared by every head), in the chunked
// (SSD) form on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #9 of src/repro/kernels/selective_scan.py,
// `_bwd_kernel_blocked_heads` (entry `selective_scan_heads_bwd_pallas`), the
// backward of both forward schedules (#7 in selective_scan_heads_fwd.cu, #8
// in selective_scan_heads.cu). Same function, same f32 chunk-entry
// checkpoints (ckpt) as its input:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + (dt_t * u_t) (x) B_t
//   y_t = h_t . C_t + D * u_t            (h_t: (P, N) per (b, head))
//
// Layout: the JAX public one. u, dy, du (B, L, H, P); dt (B, L, H); A, Dp
// (H,) f32; Bm, Cm (B, L, N) read through their batch and row strides (views
// of one projection, rows 16-byte aligned); pos (B, L) i32; ckpt
// (B, H, nC, P, N) f32, nC = ceil(L / chunk). Partials, one per slice of
// PB = 64 rows of P (nps = ceil(P / PB), the last slice short when PB does
// not divide P): ddt (B, L, H, nps), dB and dC (B, H*nps, L, N), dA and dD
// (B, H, nps), all f32; the caller sums them in a fixed order.
//
// The math, per block (b, head, slice of P) and per sub-chunk of Q = 64
// steps inside each checkpoint chunk. s = cumsum of dt*A over the
// sub-chunk, rid = cumsum of resets, dec[i,j] = exp(s_i - s_j) [j <= i]
// [rid_i == rid_j], cin_i = exp(s_i) [rid_i == 0], d_j = dec[Q-1, j],
// X = dt*u (Q x P), dY (Q x P), B and C (Q x N), h_in the sub-chunk's entry
// state and dh the gradient of its exit state (P x N). Steps past the
// chunk's end or L are identity steps (dt = u = dy = B = C = 0, no reset),
// so the Q x Q algebra needs no special case, only masked stores:
//
//   pass 1 (forward from the checkpoint): h_out = (d o X)^T B + cin_{Q-1} h_in
//   pass 2 (sub-chunks in reverse):
//     S = C B^T, R = dY X^T, M = (dec o S) o R
//     dX = (dec o S)^T dY + diag(d) B dh^T
//     dC = (dec o R) B + diag(cin) dY h_in
//     dB = (dec o R)^T C + diag(d) X dh
//     dh <- dY^T diag(cin) C + cin_{Q-1} dh
//     ds_i = sum_j M_ij - sum_k M_ki + cin_i <C_i, (dY h_in)_i>
//            - d_i <B_i, (X dh)_i>  (+ sum_j d_j <B_j, (X dh)_j>
//            + cin_{Q-1} <h_in, dh> at i = Q-1)
//     dla = reverse cumsum of ds; du = dt dX + D dy;
//     ddt = sum_p u dX + A dla [no reset]; dA += sum_t dt dla [no reset];
//     dD += sum dy u
//
// What bounds it on this card: at the training shape (B=8, L=4096, H=32,
// P=64, N=64, bf16) the function moves ~0.64 GB (0.19 ms at 3.35 TB/s) and
// its products are ~10 of 64 x 64 x 64 a sub-chunk, 8.6e10 operations
// (0.17 ms at the dense TF32 peak): bytes, closely followed by the products,
// which is why the products run on the tensor cores.
//
// Design:
//   * One block per (b, head, slice of 64 rows of P): one slice a head at
//     P = 64, 256 blocks at the training shape; 256 threads (8 warps). Each
//     warp owns a 16 x 32 tile of every 64 x 64 product.
//   * Every product goes through `mma_tile` (heads_mma.cuh, shared with
//     #7): mma.sync m16n8k8 TF32 with f32 accumulation, each operand split
//     hi + lo and three products (lo*hi + hi*lo + hi*hi), which keeps the
//     products within ~1e-6 of f32 (one TF32 pass would give 3-5e-4 of
//     max|ref|). Operands are f32 tiles in shared memory, rows padded to 68
//     floats; either operand may be read transposed, and a scale along the
//     contraction may be folded into A.
//   * Sub-chunk operands (u, dy, B, C and the staged entry state) come in by
//     cp.async (16 bytes a thread, zero-filled past the chunk, L or P) into a
//     staging area while the previous sub-chunk computes; dt and pos come in
//     through registers of warp 0, which also scans them (s, rid, cin, d).
//     The same code path serves bf16 and f32: staging converts to f32.
//   * Pass 1 keeps the sub-chunks' entry states in block-private scratch
//     (hsub, 16 KB each, at most ceil(chunk / Q) a block); pass 2 carries dh
//     in shared memory across sub-chunks and chunks.
//   * No float atomics: the sums over i, j and p run in a fixed order (xor
//     shuffles, per-warp partials summed in warp order), and the partials over
//     slices of P leave for the caller to sum. Results repeat bitwise.
//
// Shared memory (f32 input; bf16 halves the raw staging): 8 tiles of
// 64 x 68 floats (u, dy, B, C, dec o S, dec o R, h_in, dh) 139,264 B; raw
// staging of u, dy, B, C 65,536 B and of the entry state 16,384 B; vectors
// 4,928 B: 226,112 B, one block an SM.

#include <limits.h>

#include "heads_mma.cuh"

namespace {

// vectors in shared memory (floats), each Q long unless said, after the
// StepVec ones
enum Vec {
  V_ROW = V_STEPS,  // 2 x Q: row sums of M, per column half of the warps
  V_COL = 9,        // 4 x Q: column sums of M, per row quarter
  V_F = 13,         // 2 x Q: <C_i, (dY h_in)_i> partials
  V_E = 15,         // 2 x Q: <B_i, (X dh)_i> partials
  V_UDX = 17,       // 2 x Q: sum_p u dX partials
  V_COUNT = 19
};
constexpr int VEC_FLOATS = V_COUNT * Q + 2 * WARPS;   // + <h_in, dh>, dD

constexpr size_t smem_bytes(size_t es) {
  return (8 * (size_t)TILE + 64 * 64 + VEC_FLOATS) * sizeof(float)
         + 4 * 64 * 64 * es;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// ------------------------------------------------------------------ kernel

struct Out {
  float* du; float* ddt; float* dB; float* dC; float* dA; float* dD;
  float* hsub;
};

// One sub-chunk's work: pass 1 (k < nsub - 1, forward) or pass 2 (reverse).
struct Job {
  int c, j, k, nsub, t0, t_end;
  bool p2;
  const float* hsrc;   // the staged entry state (rows of N floats), or null
};

template <typename T>
struct Kernel {
  // the staged tiles of a bf16 input are exact in TF32
  static constexpr bool RAW = sizeof(T) == 2;
  Operands op;
  const float* ckpt;
  const T* dy;
  Out out;
  int chunk, nC, nsub_max;
  int b, h, s, nps, p0, pr;   // block: row, head, slice, slices, rows
  int tid, lane, warp, m0, n0, g, tq;
  float A, Dd;
  float *sU, *sDY, *sB, *sC, *sS, *sR, *sH, *sG, *stH, *v;
  T *stU, *stDY, *stB, *stC;
  Steps<T> steps;             // warp 0: dt and pos of the staged job

  __device__ int64_t at_lhp(int t, int p) const {
    return (((int64_t)b * op.L + t) * op.H + h) * op.P + p0 + p;
  }
  __device__ float* hsub_of(int k) const {
    return out.hsub + ((int64_t)blockIdx.x * nsub_max + k) * (PB * N);
  }
  __device__ const float* ckpt_of(int c) const {
    return ckpt + ((((int64_t)b * op.H + h) * nC + c) * op.P + p0) * N;
  }

  __device__ Job job_of(int c, int j) const {
    Job jb;
    const int tc0 = c * chunk, tc1 = min(op.L, tc0 + chunk);
    jb.c = c;
    jb.j = j;
    jb.nsub = (tc1 - tc0 + Q - 1) / Q;
    jb.p2 = j >= jb.nsub - 1;
    jb.k = jb.p2 ? 2 * jb.nsub - 2 - j : j;
    jb.t0 = tc0 + jb.k * Q;
    jb.t_end = min(jb.t0 + Q, tc1);
    // the entry state: the checkpoint for sub-chunk 0, scratch for the
    // other pass-2 sub-chunks but the last (whose entry pass 1 left in sH)
    if (jb.k == 0)
      jb.hsrc = ckpt_of(c);
    else
      jb.hsrc = jb.p2 && jb.k < jb.nsub - 1 ? hsub_of(jb.k) : nullptr;
    return jb;
  }

  // the next job after jb; false after the last
  __device__ bool next(const Job& jb, Job* nx) const {
    if (jb.j + 1 < 2 * jb.nsub - 1) {
      *nx = job_of(jb.c, jb.j + 1);
      return true;
    }
    if (jb.c == 0) return false;
    *nx = job_of(jb.c - 1, 0);
    return true;
  }

  // issue the job's copies (asynchronous) and warp 0's loads of dt and pos
  __device__ void stage(const Job& jb) {
    constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte copy
    constexpr int CPR = 64 / EPC;                // copies a 64-element row
    const T* up = (const T*)op.u;
    const T* Bm = (const T*)op.Bm;
    const T* Cm = (const T*)op.Cm;
    for (int i = tid; i < 64 * CPR; i += THREADS) {
      const int r = i / CPR, e0 = (i % CPR) * EPC, t = jb.t0 + r;
      const bool tin = t < jb.t_end, ok = tin && e0 < pr;
      const int64_t k = ok ? at_lhp(t, e0) : 0;
      cp16(stU + r * 64 + e0, up + k, ok);
      if (jb.p2) cp16(stDY + r * 64 + e0, dy + k, ok);
      const int64_t kb = tin ? b * op.bc_bstride + (int64_t)t * op.bc_lstride
                               + e0 : 0;
      cp16(stB + r * 64 + e0, Bm + kb, tin);
      if (jb.p2) cp16(stC + r * 64 + e0, Cm + kb, tin);
    }
    if (jb.hsrc != nullptr) {
      for (int i = tid; i < 64 * 16; i += THREADS) {
        const int r = i / 16, e0 = (i % 16) * 4;
        const bool ok = r < pr;
        cp16(stH + r * 64 + e0, jb.hsrc + (ok ? r * N + e0 : 0), ok);
      }
    }
    cp_commit();
    if (warp == 0) steps.load(op, b, h, jb.t0, jb.t_end, lane);
  }

  // wait for the job's copies; staging -> f32 tiles; warp 0 scans dt, pos
  __device__ void unstage(const Job& jb) {
    cp_wait_all();
    __syncthreads();
    // 16 staged bytes a thread at a time (8 bf16 or 4 f32 values)
    constexpr int EPV = 16 / (int)sizeof(T);
    for (int i = tid * EPV; i < 64 * 64; i += THREADS * EPV) {
      const int o = (i / 64) * LD + i % 64;
      widen(sU + o, stU + i);
      widen(sB + o, stB + i);
      if (jb.p2) {
        widen(sDY + o, stDY + i);
        widen(sC + o, stC + i);
      }
    }
    if (jb.hsrc != nullptr)
      for (int i = tid * 4; i < 64 * 64; i += THREADS * 4)
        widen(sH + (i / 64) * LD + i % 64, stH + i);
    if (warp == 0) steps.scan(v, A, lane);
    __syncthreads();
  }

  // pass 1: h_out = (d o dt o U)^T B + cin_{Q-1} h_in, into sH and (when a
  // later pass-2 sub-chunk needs it) into scratch. Each thread reads and
  // writes sH only at its own positions.
  __device__ void forward(const Job& jb) {
    float acc[4][4];
    const float cl = v[V_CIN * Q + Q - 1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq + (q & 1);
        acc[nt][q] = cl * sH[p * LD + n];
      }
    mma_tile<true, false, false, RAW>(acc, sU, sB, v + V_DD * Q, m0, n0);
    float* hs = jb.k + 1 <= jb.nsub - 2 ? hsub_of(jb.k + 1) : nullptr;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq;
        sH[p * LD + n] = acc[nt][q];
        sH[p * LD + n + 1] = acc[nt][q + 1];
        if (hs != nullptr)
          *(float2*)(hs + p * N + n) = make_float2(acc[nt][q], acc[nt][q + 1]);
      }
  }

  // row sums (over the warp's 32 columns) of a per-thread pair of row
  // partials: afterwards lanes with tq == 0 hold rows g and g+8
  __device__ static void row_reduce(float& r0, float& r1) {
    r0 += __shfl_xor_sync(FULL, r0, 1);
    r1 += __shfl_xor_sync(FULL, r1, 1);
    r0 += __shfl_xor_sync(FULL, r0, 2);
    r1 += __shfl_xor_sync(FULL, r1, 2);
  }

  __device__ void put_rows(int vec, float r0, float r1) {
    row_reduce(r0, r1);
    if (tq == 0) {
      float* dst = v + (vec + (warp >> 2)) * Q;
      dst[m0 + g] = r0;
      dst[m0 + g + 8] = r1;
    }
  }

  // pass 2
  __device__ void backward(const Job& jb, float& dD) {
    const int steps = jb.t_end - jb.t0;
    const float* vd = v + V_D * Q;
    const float* vcin = v + V_CIN * Q;
    const float* vdl = v + V_DL * Q;
    // (a) S = C B^T, R = dY X^T; dec; dec o S, dec o R to shared memory;
    // the row and column sums of M = (dec o S) o R
    {
      float aS[4][4], aR[4][4];
      zero(aS);
      zero(aR);
      mma_tile<false, true, RAW, RAW>(aS, sC, sB, nullptr, m0, n0);
      mma_tile<false, true, RAW, RAW>(aR, sDY, sU, nullptr, m0, n0);
      const float* vs = v + V_S * Q;
      const float* vr = v + V_RID * Q;
      float rsum[2] = {0.f, 0.f}, csum[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        csum[nt][0] = csum[nt][1] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = m0 + g + 8 * (q >> 1);
          const int j = n0 + 8 * nt + 2 * tq + (q & 1);
          const float dec = j <= i && vr[i] == vr[j] ? expf(vs[i] - vs[j])
                                                    : 0.f;
          const float sd = dec * aS[nt][q];
          const float r = aR[nt][q] * vdl[j];
          const float m = sd * r;
          sS[i * LD + j] = sd;
          sR[i * LD + j] = dec * r;
          rsum[q >> 1] += m;
          csum[nt][q & 1] += m;
        }
      }
      put_rows(V_ROW, rsum[0], rsum[1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = csum[nt][e];
          c += __shfl_xor_sync(FULL, c, 4);
          c += __shfl_xor_sync(FULL, c, 8);
          c += __shfl_xor_sync(FULL, c, 16);
          if (g == 0) v[(V_COL + (warp & 3)) * Q + n0 + 8 * nt + 2 * tq + e] = c;
        }
    }
    __syncthreads();
    float acc[4][4];
    // (b) dX = diag(d) B dh^T + (dec o S)^T dY; du, sum_p u dX, dD
    zero(acc);
    mma_tile<false, true, RAW, false>(acc, sB, sG, nullptr, m0, n0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] *= vd[m0 + g + 8 * (q >> 1)];
    mma_tile<true, false, false, RAW>(acc, sS, sDY, nullptr, m0, n0);
    {
      float ru[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const int i = m0 + g + 8 * (q >> 1), p = n0 + 8 * nt + 2 * tq;
          const float u0 = sU[i * LD + p], u1 = sU[i * LD + p + 1];
          const float y0 = sDY[i * LD + p], y1 = sDY[i * LD + p + 1];
          ru[q >> 1] += u0 * acc[nt][q] + u1 * acc[nt][q + 1];
          dD += y0 * u0 + y1 * u1;
          if (jb.t0 + i < jb.t_end && p < pr) {   // pr: a multiple of 16
            const float dl = vdl[i];
            *(float2*)(out.du + at_lhp(jb.t0 + i, p)) =
                make_float2(fmaf(dl, acc[nt][q], Dd * y0),
                            fmaf(dl, acc[nt][q + 1], Dd * y1));
          }
        }
      put_rows(V_UDX, ru[0], ru[1]);
    }
    const int64_t row_bc = ((int64_t)b * op.H + h) * nps + s;
    // (c) dC = diag(cin) dY h_in + (dec o R) B, and <C_i, (dY h_in)_i>
    zero(acc);
    mma_tile<false, false, RAW, false>(acc, sDY, sH, nullptr, m0, n0);
    {
      float rf[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = m0 + g + 8 * (q >> 1);
          const int n = n0 + 8 * nt + 2 * tq + (q & 1);
          rf[q >> 1] += sC[i * LD + n] * acc[nt][q];
          acc[nt][q] *= vcin[i];
        }
      put_rows(V_F, rf[0], rf[1]);
    }
    mma_tile<false, false, false, RAW>(acc, sR, sB, nullptr, m0, n0);
    store_rows(out.dC + (row_bc * op.L + jb.t0) * N, acc, steps);
    // (d) dB = diag(d) X dh + (dec o R)^T C, and <B_i, (X dh)_i>
    zero(acc);
    mma_tile<false, false, RAW, false>(acc, sU, sG, nullptr, m0, n0);
    {
      float re[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = m0 + g + 8 * (q >> 1);
          const int n = n0 + 8 * nt + 2 * tq + (q & 1);
          acc[nt][q] *= vdl[i];                      // X = dt u
          re[q >> 1] += sB[i * LD + n] * acc[nt][q];
          acc[nt][q] *= vd[i];
        }
      put_rows(V_E, re[0], re[1]);
    }
    mma_tile<true, false, false, RAW>(acc, sR, sC, nullptr, m0, n0);
    store_rows(out.dB + (row_bc * op.L + jb.t0) * N, acc, steps);
    // (e) dh <- cin_{Q-1} dh + dY^T diag(cin) C, and <h_in, dh>
    const float cl = vcin[Q - 1];
    float hd = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq + (q & 1);
        const float dh = sG[p * LD + n];
        hd = fmaf(sH[p * LD + n], dh, hd);
        acc[nt][q] = cl * dh;
      }
    mma_tile<true, false, false, RAW>(acc, sDY, sC, vcin, m0, n0);
    hd = warp_sum(hd);
    if (lane == 0) v[V_COUNT * Q + warp] = hd;
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq + (q & 1);
        sG[p * LD + n] = acc[nt][q];
      }
  }

  // rows i < steps of a (Q, N) result at dst (row stride N)
  __device__ void store_rows(float* dst, const float (&acc)[4][4],
                             int steps) const {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int i = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq;
        if (i < steps)
          *(float2*)(dst + (int64_t)i * N + n) =
              make_float2(acc[nt][q], acc[nt][q + 1]);
      }
  }

  // warp 0, after backward(): ds, its reverse cumsum dla, ddt and dA
  __device__ void finish(const Job& jb, float& dA) {
    float ds[2], de = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      const float rs = v[V_ROW * Q + i] + v[(V_ROW + 1) * Q + i];
      const float cs = v[V_COL * Q + i] + v[(V_COL + 1) * Q + i]
                       + v[(V_COL + 2) * Q + i] + v[(V_COL + 3) * Q + i];
      const float f = v[V_F * Q + i] + v[(V_F + 1) * Q + i];
      const float ee = v[V_E * Q + i] + v[(V_E + 1) * Q + i];
      const float d = v[V_D * Q + i];
      ds[e] = rs - cs + v[V_CIN * Q + i] * f - d * ee;
      de = fmaf(d, ee, de);
    }
    de = warp_sum(de);
    if (lane == 31) {
      float hd = 0.f;
      for (int w = 0; w < WARPS; ++w) hd += v[V_COUNT * Q + w];
      ds[1] += de + v[V_CIN * Q + Q - 1] * hd;
    }
    // reverse inclusive cumsum: a suffix scan over lanes, two steps a lane
    const float own = ds[0] + ds[1];
    float suf = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_down_sync(FULL, suf, o);
      if (lane + o < 32) suf += x;
    }
    float after = __shfl_down_sync(FULL, suf, 1);
    if (lane == 31) after = 0.f;
    float dla[2];
    dla[1] = ds[1] + after;
    dla[0] = ds[0] + dla[1];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e, t = jb.t0 + i;
      const float keep = v[V_KEEP * Q + i];
      if (t < jb.t_end)
        out.ddt[(((int64_t)b * op.L + t) * op.H + h) * nps + s] =
            v[V_UDX * Q + i] + v[(V_UDX + 1) * Q + i] + keep * A * dla[e];
      dA = fmaf(keep * v[V_DL * Q + i], dla[e], dA);
    }
  }

  __device__ void run() {
    float dA = 0.f, dD = 0.f;
    for (int i = tid; i < TILE; i += THREADS) sG[i] = 0.f;   // dh after L
    Job cur = job_of(nC - 1, 0);
    stage(cur);
    while (true) {
      unstage(cur);
      Job nx;
      const bool more = next(cur, &nx);
      if (more) stage(nx);
      if (!cur.p2) {
        forward(cur);
      } else {
        backward(cur, dD);
        if (warp == 0) finish(cur, dA);
      }
      if (!more) break;
      cur = nx;
    }
    // the block's dA (warp 0) and dD, in a fixed order
    dD = warp_sum(dD);
    __syncthreads();
    if (lane == 0) v[V_COUNT * Q + WARPS + warp] = dD;
    if (warp == 0) dA = warp_sum(dA);
    __syncthreads();
    if (tid == 0) {
      float d = 0.f;
      for (int w = 0; w < WARPS; ++w) d += v[V_COUNT * Q + WARPS + w];
      out.dA[blockIdx.x] = dA;
      out.dD[blockIdx.x] = d;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
heads_bwd_kernel(Operands op, const float* __restrict__ ckpt,
                 const T* __restrict__ dy, Out out, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int nps = (op.P + PB - 1) / PB;
  const int blk = blockIdx.x;
  Kernel<T> k{op, ckpt, dy, out, chunk};
  k.nC = (op.L + chunk - 1) / chunk;
  k.nsub_max = (min(chunk, op.L) + Q - 1) / Q;
  k.nps = nps;
  k.s = blk % nps;
  k.h = (blk / nps) % op.H;
  k.b = blk / (nps * op.H);
  k.p0 = k.s * PB;
  k.pr = min(PB, op.P - k.p0);
  k.tid = threadIdx.x;
  k.lane = k.tid & 31;
  k.warp = k.tid >> 5;
  k.m0 = 16 * (k.warp & 3);
  k.n0 = 32 * (k.warp >> 2);
  k.g = k.lane >> 2;
  k.tq = k.lane & 3;
  k.A = op.A[k.h];
  k.Dd = op.Dp[k.h];
  k.sU = smem;
  k.sDY = k.sU + TILE;
  k.sB = k.sDY + TILE;
  k.sC = k.sB + TILE;
  k.sS = k.sC + TILE;
  k.sR = k.sS + TILE;
  k.sH = k.sR + TILE;
  k.sG = k.sH + TILE;
  k.stH = k.sG + TILE;
  k.v = k.stH + 64 * 64;
  k.stU = (T*)(k.v + VEC_FLOATS);
  k.stDY = k.stU + 64 * 64;
  k.stB = k.stDY + 64 * 64;
  k.stC = k.stB + 64 * 64;
  k.run();
}

template <typename T>
int launch_bwd(const Operands& op, int B, const void* ckpt, const void* dy,
               const Out& out, int chunk, void* stream) {
  if ((int64_t)B * op.L * op.H * op.P == 0) return 0;
  if (chunk < 1 || op.P % 16 || op.L < 1 || op.H < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * op.H * ((op.P + PB - 1) / PB);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(sizeof(T));
  static bool raised = false;    // once, outside any graph capture
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        heads_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  heads_bwd_kernel<T><<<(unsigned)blocks, THREADS, bytes,
                        (cudaStream_t)stream>>>(op, (const float*)ckpt,
                                                (const T*)dy, out, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan_heads.py, whose
// BWD_P_SLICE, BWD_SUB_T and D_STATE are PB, Q and N here). u, dt, dy, du,
// ddt and pos rows are contiguous; u and dy 16-byte aligned, P a multiple
// of 16; Bm and Cm have unit stride along N and batch and row strides
// (elements) that keep every row 16-byte aligned; A, Dp, ckpt, the partials
// and hsub (blocks, ceil(min(chunk, L) / Q), PB * N) are contiguous f32.
// Return the launch's cudaError_t (0 = launched).
#define HEADS_BWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* u, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, const void* ckpt, const void* dy,  \
                      void* du, void* ddt, void* dB, void* dC, void* dA,      \
                      void* dD, void* hsub, int B, int L, int H, int P,       \
                      int chunk, void* stream) {                              \
    return launch_bwd<T>(make_operands(u, dt, A, Bm, Cm, bc_bstride,          \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       H, P),                                 \
                         B, ckpt, dy,                                         \
                         Out{(float*)du, (float*)ddt, (float*)dB, (float*)dC, \
                             (float*)dA, (float*)dD, (float*)hsub},           \
                         chunk, stream);                                      \
  }

HEADS_BWD_ENTRY(selective_scan_heads_bwd_f32, float)
HEADS_BWD_ENTRY(selective_scan_heads_bwd_bf16, __nv_bfloat16)
