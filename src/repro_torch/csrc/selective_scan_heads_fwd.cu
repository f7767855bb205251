// Forward of the head-structured segmented selective scan (Mamba-2 / SSD: a
// scalar decay per head, B and C shared by every head), in the chunked (SSD)
// form on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #7 of src/repro/kernels/selective_scan.py,
// `_fwd_kernel_blocked_heads` (entry `selective_scan_heads_fwd_pallas`,
// schedule="blocked_heads"). Same function, same f32 chunk-entry
// checkpoints (ckpt), which the backward #9 (selective_scan_heads_bwd.cu)
// reads:
//
//   a_t = exp(dt_t * A) (0 where pos_t == 0),  h_t = a_t * h_{t-1} + (dt_t * u_t) (x) B_t
//   y_t = h_t . C_t + D * u_t            (h_t: (P, N) per (b, head))
//
// Layout: the JAX public one. u, y (B, L, H, P); dt (B, L, H); A, Dp (H,)
// f32; Bm, Cm (B, L, N) read through their batch and row strides (views of
// one projection, rows 16-byte aligned); pos (B, L) i32; ckpt
// (B, H, nC, P, N) f32, nC = ceil(L / chunk), the state at each chunk's
// entry.
//
// The math, per block (b, head, slice of PB = 64 rows of P) and per
// sub-chunk of Q = 64 steps inside each checkpoint chunk, with s, rid, dec,
// cin and d as #9 has them (s = cumsum of dt*A over the sub-chunk, rid =
// cumsum of resets, dec[i,j] = exp(s_i - s_j) [j <= i] [rid_i == rid_j],
// cin_i = exp(s_i) [rid_i == 0], d_j = dec[Q-1, j]), U (Q x P), X = dt*U,
// B and C (Q x N) and h_in the sub-chunk's entry state (P x N). Steps past
// the chunk's end or L are identity steps (dt = u = B = C = 0, no reset),
// so the Q x Q algebra needs no special case, only masked stores:
//
//   G = dec o (C B^T) o dt_j          (X's dt folded into G's columns)
//   Y = G U + diag(cin) C h_in^T + D u
//   h_out = (d o X)^T B + cin_{Q-1} h_in
//
// What bounds it on this card: at the training shape (B=8, L=4096, H=32,
// P=64, N=64, bf16) the function moves ~0.35 GB (0.10 ms at 3.35 TB/s) and
// its four 64 x 64 x 64 products a sub-chunk come to 3.4e10 operations
// (0.07 ms at the dense TF32 peak): bytes, closely followed by the products,
// which is why the products run on the tensor cores.
//
// Design:
//   * One block per (b, head, slice of 64 rows of P): 256 blocks at the
//     training shape, 256 threads (8 warps), two blocks an SM for bf16
//     input, so the 256 blocks take one wave of the 132 SMs. Each warp owns
//     a 16 x 32 tile of every product, through `mma_tile` (heads_mma.cuh,
//     shared with #9): mma.sync TF32 with f32 accumulation, each inexact
//     operand split hi + lo (three products). Raw bf16 u, B and C are exact
//     in TF32, so the cross products of their zero lo parts are not issued.
//   * The running state h (P x N f32) stays in shared memory for the
//     block's whole L. Chunk c's checkpoint leaves from the registers that
//     hold the exit state of chunk c-1's last sub-chunk (zeros for c = 0).
//   * The exit-state product runs after the barrier that follows every
//     other read of h_in (C h_in^T) and reads h_in at a thread's own
//     positions only, so it overwrites h in place: no second state tile.
//   * y leaves from the accumulators, in u's dtype, masked past the chunk,
//     L and P.
//   * cp.async (16 bytes a thread, zero-filled past the chunk, L or P)
//     stages the next sub-chunk's u, B and C while this one computes; dt and
//     pos come in through warp 0's registers, and warp 0 scans them (s, rid,
//     cin, d). The same code serves bf16 and f32: staging widens to f32.
//   * No float atomics: every sum runs in a fixed order. Results repeat
//     bitwise.
//
// Shared memory (bf16 input; f32 doubles the raw staging): 5 tiles of
// 64 x 68 floats (u, B, C, G, h) 87,040 B; raw staging of u, B, C 24,576 B
// (49,152); vectors 1,792 B: 113,408 B, two blocks an SM (137,984 B, one).

#include <limits.h>

#include "heads_mma.cuh"

namespace {

constexpr int VEC_FLOATS = V_STEPS * Q;

constexpr size_t smem_bytes(size_t es) {
  return (5 * (size_t)TILE + VEC_FLOATS) * sizeof(float) + 3 * 64 * 64 * es;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *(float2*)p = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
}

// steps [t0, t_end) of chunk c: its k-th of nsub sub-chunks
struct Sub {
  int c, k, nsub, t0, t_end;
};

template <typename T>
struct Kernel {
  // the staged tiles of a bf16 input are exact in TF32
  static constexpr bool RAW = sizeof(T) == 2;
  Operands op;
  T* y;
  float* ckpt;
  int chunk, nC;
  int b, h, p0, pr;           // block: row, head, first row of P, rows
  int tid, lane, warp, m0, n0, g, tq;
  float A, Dd;
  float *sU, *sB, *sC, *sG, *sH, *v;
  T *stU, *stB, *stC;
  Steps<T> steps;             // warp 0: dt and pos of the staged sub-chunk

  __device__ int64_t at_lhp(int t, int p) const {
    return (((int64_t)b * op.L + t) * op.H + h) * op.P + p0 + p;
  }
  __device__ float* ckpt_of(int c) const {
    return ckpt + ((((int64_t)b * op.H + h) * nC + c) * op.P + p0) * N;
  }

  __device__ Sub sub_of(int c, int k) const {
    Sub s;
    const int tc0 = c * chunk, tc1 = min(op.L, tc0 + chunk);
    s.c = c;
    s.k = k;
    s.nsub = (tc1 - tc0 + Q - 1) / Q;
    s.t0 = tc0 + k * Q;
    s.t_end = min(s.t0 + Q, tc1);
    return s;
  }

  // the sub-chunk after s; false after the last
  __device__ bool next(const Sub& s, Sub* nx) const {
    if (s.k + 1 < s.nsub) {
      *nx = sub_of(s.c, s.k + 1);
      return true;
    }
    if (s.c + 1 >= nC) return false;
    *nx = sub_of(s.c + 1, 0);
    return true;
  }

  // issue the sub-chunk's copies (asynchronous) and warp 0's loads of dt
  // and pos
  __device__ void stage(const Sub& s) {
    constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte copy
    constexpr int CPR = 64 / EPC;                // copies a 64-element row
    const T* up = (const T*)op.u;
    const T* Bm = (const T*)op.Bm;
    const T* Cm = (const T*)op.Cm;
    for (int i = tid; i < 64 * CPR; i += THREADS) {
      const int r = i / CPR, e0 = (i % CPR) * EPC, t = s.t0 + r;
      const bool tin = t < s.t_end, ok = tin && e0 < pr;
      cp16(stU + r * 64 + e0, up + (ok ? at_lhp(t, e0) : 0), ok);
      const int64_t kb = tin ? b * op.bc_bstride + (int64_t)t * op.bc_lstride
                               + e0 : 0;
      cp16(stB + r * 64 + e0, Bm + kb, tin);
      cp16(stC + r * 64 + e0, Cm + kb, tin);
    }
    cp_commit();
    if (warp == 0) steps.load(op, b, h, s.t0, s.t_end, lane);
  }

  // wait for the copies; staging -> f32 tiles; warp 0 scans dt and pos
  __device__ void unstage() {
    cp_wait_all();
    __syncthreads();
    // 16 staged bytes a thread at a time (8 bf16 or 4 f32 values)
    constexpr int EPV = 16 / (int)sizeof(T);
    for (int i = tid * EPV; i < 64 * 64; i += THREADS * EPV) {
      const int o = (i / 64) * LD + i % 64;
      widen(sU + o, stU + i);
      widen(sB + o, stB + i);
      widen(sC + o, stC + i);
    }
    if (warp == 0) steps.scan(v, A, lane);
    __syncthreads();
  }

  __device__ void compute(const Sub& s) {
    const float* vdl = v + V_DL * Q;
    const float* vs = v + V_S * Q;
    const float* vr = v + V_RID * Q;
    const float* vcin = v + V_CIN * Q;
    float acc[4][4];
    // (a) G = dec o (C B^T) o dt_j into shared memory
    zero(acc);
    mma_tile<false, true, RAW, RAW>(acc, sC, sB, nullptr, m0, n0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = m0 + g + 8 * (q >> 1);
        const int j = n0 + 8 * nt + 2 * tq + (q & 1);
        const float dec = j <= i && vr[i] == vr[j] ? expf(vs[i] - vs[j])
                                                  : 0.f;
        sG[i * LD + j] = dec * acc[nt][q] * vdl[j];
      }
    // (b) diag(cin) C h_in^T
    zero(acc);
    mma_tile<false, true, RAW, false>(acc, sC, sH, nullptr, m0, n0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] *= vcin[m0 + g + 8 * (q >> 1)];
    __syncthreads();     // G is whole; the reads of h_in by other warps done
    // (c) y = G U + diag(cin) C h_in^T + D u, from the accumulators
    mma_tile<false, false, false, RAW>(acc, sG, sU, nullptr, m0, n0);
    const int n_steps = s.t_end - s.t0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int i = m0 + g + 8 * (q >> 1), p = n0 + 8 * nt + 2 * tq;
        if (i < n_steps && p < pr)          // pr: a multiple of 16
          store2(y + at_lhp(s.t0 + i, p),
                 fmaf(Dd, sU[i * LD + p], acc[nt][q]),
                 fmaf(Dd, sU[i * LD + p + 1], acc[nt][q + 1]));
      }
    // (d) h_out = cin_{Q-1} h_in + (d o X)^T B, in place: each thread reads
    // and writes h at its own positions only; at a chunk's end it is the
    // next chunk's checkpoint
    const float cl = vcin[Q - 1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq + (q & 1);
        acc[nt][q] = cl * sH[p * LD + n];
      }
    mma_tile<true, false, false, RAW>(acc, sU, sB, v + V_DD * Q, m0, n0);
    float* ck = s.k + 1 == s.nsub && s.c + 1 < nC ? ckpt_of(s.c + 1) : nullptr;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int p = m0 + g + 8 * (q >> 1), n = n0 + 8 * nt + 2 * tq;
        sH[p * LD + n] = acc[nt][q];
        sH[p * LD + n + 1] = acc[nt][q + 1];
        if (ck != nullptr && p < pr)
          *(float2*)(ck + p * N + n) = make_float2(acc[nt][q], acc[nt][q + 1]);
      }
  }

  __device__ void run() {
    for (int i = tid; i < TILE; i += THREADS) sH[i] = 0.f;
    float* ck0 = ckpt_of(0);
    for (int i = tid; i < pr * N; i += THREADS) ck0[i] = 0.f;
    Sub cur = sub_of(0, 0);
    stage(cur);
    while (true) {
      unstage();
      Sub nx;
      const bool more = next(cur, &nx);
      if (more) stage(nx);
      compute(cur);
      if (!more) break;
      cur = nx;
    }
  }
};

// held to the blocks an SM that fit its shared memory: two for bf16 input
// (at most 128 registers a thread), one for f32
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
heads_fwd_chunked_kernel(Operands op, T* __restrict__ y,
                         float* __restrict__ ckpt, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int nps = (op.P + PB - 1) / PB;
  const int blk = blockIdx.x;
  Kernel<T> k{op, y, ckpt, chunk};
  k.nC = (op.L + chunk - 1) / chunk;
  k.h = (blk / nps) % op.H;
  k.b = blk / (nps * op.H);
  k.p0 = (blk % nps) * PB;
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
  k.sB = k.sU + TILE;
  k.sC = k.sB + TILE;
  k.sG = k.sC + TILE;
  k.sH = k.sG + TILE;
  k.v = k.sH + TILE;
  k.stU = (T*)(k.v + VEC_FLOATS);
  k.stB = k.stU + 64 * 64;
  k.stC = k.stB + 64 * 64;
  k.run();
}

// the kernel's dynamic shared memory allowed (once, outside any graph
// capture) and the carveout set to shared memory, so that two blocks fit
template <typename T>
int prepare() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      heads_fwd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(sizeof(T)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(heads_fwd_chunked_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <typename T>
int launch_fwd(const Operands& op, int B, void* y, void* ckpt, int chunk,
               void* stream) {
  if ((int64_t)B * op.L * op.H * op.P == 0) return 0;
  if (chunk < 1 || op.P % 16 || op.L < 1 || op.H < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * op.H * ((op.P + PB - 1) / PB);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (int e = prepare<T>()) return e;
  heads_fwd_chunked_kernel<T><<<(unsigned)blocks, THREADS,
                                smem_bytes(sizeof(T)),
                                (cudaStream_t)stream>>>(op, (T*)y,
                                                        (float*)ckpt, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  if (int e = prepare<T>()) return e;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, heads_fwd_chunked_kernel<T>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], heads_fwd_chunked_kernel<T>, THREADS, smem_bytes(sizeof(T)));
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  out[3] = (int)smem_bytes(sizeof(T));
  return (int)e;
}

}  // namespace

// Plain C entries, bound with ctypes (kernels/selective_scan_heads.py, whose
// BWD_P_SLICE, FWD_SUB_T and D_STATE are PB, Q and N here). u, dt, y and pos
// rows are contiguous; u 16-byte aligned, P a multiple of 16; Bm and Cm
// have unit stride along N and batch and row strides (elements) that keep
// every row 16-byte aligned; A, Dp and ckpt are contiguous f32. Return the
// launch's cudaError_t (0 = launched).
#define HEADS_FWD_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* u, const void* dt, const void* A,          \
                      const void* Bm, const void* Cm, int64_t bc_bstride,     \
                      int64_t bc_lstride, const void* Dp, const void* pos,    \
                      int64_t pos_bstride, void* y, void* ckpt, int B, int L, \
                      int H, int P, int chunk, void* stream) {                \
    return launch_fwd<T>(make_operands(u, dt, A, Bm, Cm, bc_bstride,          \
                                       bc_lstride, Dp, pos, pos_bstride, L,   \
                                       H, P),                                 \
                         B, y, ckpt, chunk, stream);                          \
  }

HEADS_FWD_ENTRY(selective_scan_heads_fwd_f32, float)
HEADS_FWD_ENTRY(selective_scan_heads_fwd_bf16, __nv_bfloat16)

// The kernel's resources on the current device for bf16 (bf16 != 0) or f32
// input: out = {blocks an SM, registers a thread, local (spill) bytes a
// thread, dynamic shared bytes a block}. Returns a cudaError_t.
extern "C" int selective_scan_heads_fwd_occupancy(int bf16, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(out) : occupancy<float>(out);
}
