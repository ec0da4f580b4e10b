// Selective scan (Mamba), forward and backward, for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan (Pallas body
//   _ssm_kernel). The TPU kernel has no backward (JAX differentiates its
//   lax.scan); the backward here is new, so that the SSM training path's
//   gradients run on hand-written kernels too.
//
// Forward, for every batch row b and channel r, over t = 0 .. S-1, with
// h[r, 0:ds] starting at zero:
//   h[s] = exp(dt[b,t,r] * A[r,s]) * h[s] + (dt[b,t,r] * x[b,t,r]) * B[b,t,s]
//   y[b,t,r] = sum_s h[s] * C[b,t,s] + D[r] * x[b,t,r]
// all in float32. The term order (dt*x)*B is the TPU kernel's. The state
// before every chunk of kChunk steps is kept for the backward: hc (Bb,
// ceil(S/kChunk), ds, di).
//
// Backward, with a_t = exp(dt_t * A), gy the cotangent of y and g_t that
// of h_t (g_t = gy_t * C_t + a_{t+1} * g_{t+1}):
//   gx_t  = dt_t * sum_s g_t B_t + D gy_t      gdt_t = sum_s g_t (x_t B_t
//   gB_t  = sum_r g_t dt_t x_t                         + a_t A h_{t-1})
//   gC_t  = sum_r gy_t h_t                     gA = sum_{b,t} g_t a_t dt_t h_{t-1}
//   gD    = sum_{b,t} gy_t x_t
//
// What bounds it on the H100. The forward moves dt, x and y (and the
// checkpoints) once: at falcon-mamba-7b's training shape (Bb 2, S 4096,
// di 8192, ds 16) about 0.87 GB, 0.26 ms at 3.35 TB/s; it evaluates
// Bb*S*di*ds expf, about as long on the SFUs. The backward is bound by
// its instruction stream, not its bytes: at that shape 1.07e9 (state x
// step) elements, each through three exp2 passes (carries, the forward
// to the sub-chunk starts, the recompute; 0.8 ms on the SFUs alone),
// about 25 float32 operations and 3 shuffles, and the index arithmetic
// around them, against about 1.9 GB of traffic (dt, x, gy read twice, gx
// and gdt written, the checkpoints and the carries: 0.6 ms).

// Forward design. The TPU kernel keeps h resident in VMEM across a
// sequential grid of sequence chunks. Blocks on the card run in no
// order, so one thread owns one (b, r) for the whole call and walks t in
// a loop with h[0:ds] and A[r, 0:ds] in registers. B_t and C_t are shared
// by all rows, so a block stages a chunk of them through shared memory;
// each thread also stages its own column of dt and x for the chunk, so
// that a chunk's loads overlap instead of one load's latency being paid
// at every step. The parallelism is only Bb*di threads (16384 for
// falcon-mamba-7b, 4096 for zamba2-1.2b), each a sequential chain: the
// kernel is latency-bound, far from its bound. For mamba2 (zamba2) every
// row of a head has the same decay, so the 64 x 64 exps of a head and
// step are the same number, recomputed here: a known waste. Later work:
// a chunked (parallel-in-time) forward and exps shared per head.
//
// Backward design: the adjoint is linear, so the chunks the forward
// checkpoints run in parallel. Let chunk k cover steps t0..t1 and lam_k
// = a_{t1+1} g_{t1+1} be the cotangent entering it from the right (0 for
// the last chunk). Then g_t = g0_t + (prod_{j=t+1..t1} a_j) lam_k, with
// g0 the chunk's own solution for lam = 0, and lam_{k-1} = c_k + P_k
// lam_k, with c_k = a_{t0} g0_{t0} and P_k = prod_{t0..t1} a_j = exp(A
// sum_{t0..t1} dt). Three phases, all parallel over chunks:
// 1. carries: one thread per (b, k, r) walks its chunk backwards with
//    lam = 0 (dt, gy, C; no h): c_k and the chunk's sum of dt.
// 2. one thread per (b, r, s) runs lam right to left over the nC chunks,
//    in place of c. A P_k that underflows to 0 is exact and harmless.
// 3. one block per (b, k, tile of kTile rows), lanes over states
//    (min(ds, 32) lanes a row, 1 or 2 states a lane): from hc[k] it runs
//    h forward to every kSub-step sub-chunk start (kept in shared
//    memory), then walks the sub-chunks backwards from lam_k, each
//    recomputed into registers first (h_t, a_t). So the tape never goes
//    through device memory, and h is never run backwards by dividing by
//    a_t (exp(dt*A) underflows to 0 as training moves A and dt).
// The ~1 M (b, k, r) chains of 64 steps at falcon's shape (262 k at
// zamba2's) fill the card where Bb*di chains of S steps did not. The
// chunk kernel is bound by its shared-memory and shuffle traffic and its
// index arithmetic, so: dt, x, gy of the next rows are copied into
// shared memory (cp.async) while the block works on these, each row's
// steps contiguous, so that a lane reads 4 steps in one 16-byte load;
// the chunk's B and C likewise, where two blocks an SM still fit (ds <=
// 32; at ds 64 a lane reads its sub-chunk's B and C from device memory
// at once). Sums over states (gx, gdt) are reduce-scatters of a
// sub-chunk's 16 sums at once; sums over rows (gB, gC) go through
// shuffles over a warp's rows, shared memory in warp order (two buffers
// by sub-chunk parity where they fit: one barrier a sub-chunk) and the
// tile's row groups in order, to one partial per (b, t, tile); gA and gD
// to one partial per (b, k). Two small kernels add the partials in a
// fixed order. No atomics: a second backward is bit-identical. With
// mamba2's stride-0 decay (a_cs == 0) every phase evaluates one exp a
// (row, step), not ds. nvcc contracts multiply-adds into FMAs and the
// card's ex2.approx is not the CPU's exp, so the kernels match the plain
// version to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // rows per forward block, one thread a row
constexpr int kChunk = 64;     // steps per checkpoint / B, C staging chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSub = 8;        // steps per backward sub-chunk (recompute)
constexpr int kNSub = kChunk / kSub;
constexpr int kTile = 256;     // rows per chunk block: one gB/gC partial
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kCarryThreads = 128;
// a staged row of dt, x or gy: kChunk steps, padded so that the rows of
// a warp fall in other banks
constexpr int kStageRow = kChunk + 4;

__device__ __forceinline__ void stage_bc(float* sb, float* sc,
                                         const float* __restrict__ Bm,
                                         const float* __restrict__ Cm,
                                         size_t off, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    sb[e] = Bm[off + e];
    sc[e] = Cm[off + e];
  }
}

// This thread's column of a chunk of a (.., di) stream: dst[tt][tid] =
// src[o0 + tt * di]. Every thread reads back only its own column, so no
// barrier is needed; the L loads are independent and overlap.
__device__ __forceinline__ void stage_col(float* dst,
                                          const float* __restrict__ src,
                                          size_t o0, int L, int di) {
  for (int tt = 0; tt < L; ++tt)
    dst[tt * kThreads + threadIdx.x] = src[o0 + (size_t)tt * di];
}

template <int DS>
constexpr size_t fwd_smem() {
  return (2 * kChunk * DS + 2 * kChunk * kThreads) * sizeof(float);
}

template <int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_fwd_kernel(const float* __restrict__ dt,
                    const float* __restrict__ x,
                    const float* __restrict__ A, long long a_rs,
                    long long a_cs, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ D, float* __restrict__ y,
                    float* __restrict__ hc, int S, int di, int nC) {
  extern __shared__ float smem[];
  float* sb = smem;                         // [kChunk][DS]
  float* sc = sb + kChunk * DS;             // [kChunk][DS]
  float* sdt = sc + kChunk * DS;            // [kChunk][kThreads]
  float* sx = sdt + kChunk * kThreads;      // [kChunk][kThreads]
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool has_row = r < di;

  float a[DS], h[DS];
  float dr = 0.f;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = 0.f;
    a[s] = has_row ? A[r * a_rs + s * a_cs] : 0.f;
  }
  if (has_row) dr = D[r];

  for (int k = 0; k < nC; ++k) {
    const int t0 = k * kChunk;
    const int L = min(kChunk, S - t0);
    __syncthreads();                  // the previous chunk is consumed
    stage_bc(sb, sc, Bm, Cm, ((size_t)b * S + t0) * DS, L * DS);
    __syncthreads();
    if (!has_row) continue;
    const size_t o0 = ((size_t)b * S + t0) * di + r;
    stage_col(sdt, dt, o0, L, di);
    stage_col(sx, x, o0, L, di);
    float* dst = hc + ((size_t)b * nC + k) * DS * di + r;
#pragma unroll
    for (int s = 0; s < DS; ++s) dst[(size_t)s * di] = h[s];
    for (int tt = 0; tt < L; ++tt) {
      const float d = sdt[tt * kThreads + threadIdx.x];
      const float xv = sx[tt * kThreads + threadIdx.x];
      const float dx = d * xv;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = expf(d * a[s]) * h[s] + dx * sb[tt * DS + s];
        acc += h[s] * sc[tt * DS + s];
      }
      y[o0 + (size_t)tt * di] = acc + dr * xv;
    }
  }
}

// Reduce-scatter over the lane bits o, o/2, .., omin (powers of two):
// stage by stage each lane keeps half of its n values, adding its
// partner's copy of that half, until one is left; the remaining offsets
// add plainly. Lanes that differ only in those bits end with the sums:
// v[i] holds the sum of value i + sum_m bit_m * N / 2^(m+1), bit_m the
// lane's bit at the m-th halving offset. A template recursion, so that
// every index is a compile-time constant and v stays in registers.
template <int N, int n, int o, int omin>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (o >= omin) {
    if constexpr (n >= 2) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? v[i] : v[i + n / 2];
        const float keep = up ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      reduce_scatter<N, n / 2, o / 2, omin>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      reduce_scatter<N, 1, o / 2, omin>(v, lane);
    }
  }
}

constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
constexpr int imin(int a, int b) { return a < b ? a : b; }

// The chunk kernel's lanes: min(DS, 32) lanes a row, G states a lane
// (s = lane_in_row * G + i), RW rows a warp.
template <int DS>
struct BwdLanes {
  static constexpr int TPR = DS < 32 ? DS : 32;
  static constexpr int LT = ilog2(TPR);
  static constexpr int G = DS / TPR;
  static constexpr int RW = 32 / TPR;
  static constexpr int RB = kBwdWarps * RW;     // rows a block iteration
  static constexpr int NQ = 2 * G;              // gB, gC values a lane-step
  // halving stages of the sum over a warp's rows (offsets 16 .. TPR) and
  // the values a lane keeps; then of the sum over a row's lanes (offsets
  // TPR/2 .. 1) of a sub-chunk's 2 x kSub state sums
  static constexpr int HR = imin(ilog2(RW), ilog2(NQ));
  static constexpr int NK = NQ >> HR;
  static constexpr int HQ = imin(LT, ilog2(2 * kSub));
  static constexpr int NV = (2 * kSub) >> HQ;
  // shared memory: sub-chunk starts [kNSub][RB][DS], the warps' gB/gC
  // sums of a sub-chunk [kSub][kBwdWarps][2 DS], the block's gB/gC sums
  // of the chunk [kChunk][2 DS], the state sums of gx/gdt [2][kSub][RB],
  // two Stages of RB rows' inputs. The warps' sums and the state sums
  // take two buffers, by sub-chunk parity, where two blocks an SM still
  // fit: then one barrier a sub-chunk suffices, not two.
  static constexpr int stage_floats = 3 * kStageRow * RB + RB + 3 * DS * RB;
  static constexpr int sub_floats = kSub * kBwdWarps * 2 * DS + 2 * kSub * RB;
  static constexpr int base_floats =
      kNSub * RB * DS + kChunk * 2 * DS + 2 * stage_floats;
  // the chunk's B and C, [DS][kStageRow] each, where they fit too
  static constexpr int bc_floats = 2 * DS * kStageRow;
  static constexpr bool kStageBC =
      sizeof(float) * (base_floats + bc_floats + sub_floats) <= 112 * 1024;
  static constexpr int fixed_floats =
      base_floats + (kStageBC ? bc_floats : 0);
  static constexpr bool kDouble =
      sizeof(float) * (fixed_floats + 2 * sub_floats) <= 112 * 1024;
  static constexpr int smem_floats =
      fixed_floats + (kDouble ? 2 : 1) * sub_floats;
};

// PTX helpers. 2^x on the SFU in one instruction, results below 2^-126
// flushed to 0 (a decay that small moves no float32 sum; the plain
// version's exp keeps subnormals).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte asynchronous copy from device to shared memory, zero-filled
// (nothing read) when !ok; the copies a thread issued before the last n
// commits are complete after copy_wait<n>().
__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Phase 1, one thread per (b, chunk k >= 1, row r), its DS states in
// registers: the chunk walked backwards with no cotangent entering from
// the right gives c_k = a_{t0} g0_{t0} -> lam (Bb, nC, di, DS), and sum
// dt over the chunk -> dsum (Bb, nC, di), so that P_k = exp(A * sum dt).
// The block's rows share the chunk's C (shared memory); dt and gy come
// kSub steps at a time, their loads in flight together.
template <int DS, bool kRow>
__global__ void __launch_bounds__(kCarryThreads)
ssm_bwd_carry_kernel(const float* __restrict__ dt,
                     const float* __restrict__ A, long long a_rs,
                     long long a_cs, const float* __restrict__ Cm,
                     const float* __restrict__ gy, float* __restrict__ lam,
                     float* __restrict__ dsum, int S, int di, int nC) {
  constexpr int GA = kRow ? 1 : DS;         // distinct decays of the row
  __shared__ __align__(16) float sc[kChunk * DS];
  const int b = blockIdx.z, k = blockIdx.y + 1;
  const int r = blockIdx.x * kCarryThreads + threadIdx.x;
  const int t0 = k * kChunk, L = min(kChunk, S - t0);
  const size_t bs0 = (size_t)b * S + t0;
  for (int e = threadIdx.x; e < L * DS; e += kCarryThreads)
    sc[e] = Cm[bs0 * DS + e];
  __syncthreads();
  if (r >= di) return;
  float A2[GA], gc[DS];
#pragma unroll
  for (int i = 0; i < GA; ++i) A2[i] = A[r * a_rs + i * a_cs] * kLog2e;
#pragma unroll
  for (int s = 0; s < DS; ++s) gc[s] = 0.f;
  float sum = 0.f;
  for (int j = (L - 1) / kSub; j >= 0; --j) {
    float d8[kSub], y8[kSub];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const bool ok = j * kSub + u < L;
      const size_t o = (bs0 + j * kSub + u) * di + r;
      d8[u] = ok ? dt[o] : 0.f;
      y8[u] = ok ? gy[o] : 0.f;
    }
#pragma unroll
    for (int u = kSub - 1; u >= 0; --u) {
      if (j * kSub + u < L) {
        const float4* c4 =
            reinterpret_cast<const float4*>(sc + (j * kSub + u) * DS);
        sum += d8[u];
        const float ar = kRow ? ex2(d8[u] * A2[0]) : 0.f;
#pragma unroll
        for (int s4 = 0; s4 < DS / 4; ++s4) {
          const float4 c = c4[s4];
          const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = 4 * s4 + q;
            const float a = kRow ? ar : ex2(d8[u] * A2[kRow ? 0 : s]);
            gc[s] = a * fmaf(y8[u], cs[q], gc[s]);
          }
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(
      lam + ((size_t)(b * nC + k) * di + r) * DS);
#pragma unroll
  for (int s4 = 0; s4 < DS / 4; ++s4)
    o[s4] = make_float4(gc[4 * s4], gc[4 * s4 + 1], gc[4 * s4 + 2],
                        gc[4 * s4 + 3]);
  dsum[(size_t)(b * nC + k) * di + r] = sum;
}

// Phase 2, one thread per (b, r, s): the carries right to left, lam_k
// written over c_k: lam_{nC-1} = 0, lam_{k-1} = c_k + P_k lam_k. The
// chunks go kBatch at a time, their loads in flight together.
__global__ void __launch_bounds__(256)
ssm_bwd_lambda_kernel(const float* __restrict__ A, long long a_rs,
                      long long a_cs, const float* __restrict__ dsum,
                      float* __restrict__ lam, int Bb, int di, int ds,
                      int nC) {
  constexpr int kBatch = 16;
  const long long per_b = (long long)di * ds;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= Bb * per_b) return;
  const int b = (int)(i / per_b);
  const long long rs = i % per_b;
  const int r = (int)(rs / ds), s = (int)(rs % ds);
  const float A2 = A[r * a_rs + s * a_cs] * kLog2e;
  float l = 0.f;
  for (int k1 = nC - 1; k1 > 0; k1 -= kBatch) {
    float c[kBatch], p[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = k1 - q;
      if (k > 0) {
        c[q] = lam[(size_t)(b * nC + k) * per_b + rs];
        p[q] = ex2(A2 * dsum[(size_t)(b * nC + k) * di + r]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = k1 - q;
      if (k > 0) {
        lam[(size_t)(b * nC + k) * per_b + rs] = l;
        l = fmaf(p[q], l, c[q]);
      }
    }
  }
  lam[(size_t)b * nC * per_b + rs] = l;
}

// What the chunk kernel stages for RB rows of one chunk: dt, x, gy
// [RB][kStageRow] (a row's steps contiguous, read 4 steps at a time), D
// [RB], the stored state hc[k] [DS][RB], lam_k [RB][DS] and A [RB][DS],
// rows past the tile and steps past S zero-filled.
template <int DS>
struct Stage {
  static constexpr int RB = BwdLanes<DS>::RB;
  static constexpr int NS = kStageRow * RB;
  static constexpr int size = BwdLanes<DS>::stage_floats;
  float* dt;
  float* x;
  float* gy;
  float* D;
  float* h0;
  float* lam;
  float* A;
  __device__ explicit Stage(float* p)
      : dt(p), x(p + NS), gy(p + 2 * NS), D(p + 3 * NS), h0(D + RB),
        lam(h0 + DS * RB), A(lam + DS * RB) {}
  // issue the copies of rows r0.. (one commit group)
  __device__ void load(const float* __restrict__ gdt,
                       const float* __restrict__ gx,
                       const float* __restrict__ ggy,
                       const float* __restrict__ gD,
                       const float* __restrict__ ghc,
                       const float* __restrict__ glam,
                       const float* __restrict__ gA, long long a_rs,
                       long long a_cs, size_t bt0, int L, int r0, int r_end,
                       int di, size_t kds, size_t kdi) {
    for (int e = threadIdx.x; e < 3 * kChunk * RB; e += kBwdThreads) {
      const int q = e / (kChunk * RB), tt = e / RB % kChunk, row = e % RB;
      const float* src = q == 0 ? gdt : (q == 1 ? gx : ggy);
      const bool ok = tt < L && r0 + row < r_end;
      copy_async4(dt + q * NS + row * kStageRow + tt,
                  ok ? src + (bt0 + tt) * di + r0 + row : src, ok);
    }
    for (int e = threadIdx.x; e < RB; e += kBwdThreads)
      copy_async4(D + e, r0 + e < r_end ? gD + r0 + e : gD, r0 + e < r_end);
    for (int e = threadIdx.x; e < DS * RB; e += kBwdThreads) {
      const int s = e / RB, row = e % RB;         // h0 [DS][RB]
      const bool ok = r0 + row < r_end;
      copy_async4(h0 + e, ok ? ghc + (kds + s) * di + r0 + row : ghc, ok);
      const int lrow = e / DS, ls = e % DS;       // lam, A [RB][DS]
      const bool lok = r0 + lrow < r_end;
      copy_async4(lam + e, lok ? glam + (kdi + r0) * DS + e : glam, lok);
      copy_async4(A + e, lok ? gA + (r0 + lrow) * a_rs + ls * a_cs : gA,
                  lok);
    }
    copy_commit();
  }
};

// kSub steps from step tt of row row of a staged stream
__device__ __forceinline__ void load_steps(float (&v)[kSub], const float* a,
                                           int row, int tt) {
#pragma unroll
  for (int u = 0; u < kSub; u += 4) {
    const float4 f =
        *reinterpret_cast<const float4*>(a + row * kStageRow + tt + u);
    v[u] = f.x; v[u + 1] = f.y; v[u + 2] = f.z; v[u + 3] = f.w;
  }
}

// B or C of the lane's G states for the n <= kSub steps from step tt of
// the chunk (tj its first in the stream): from the staged [DS][kStageRow]
// copy, 4 steps a load, or from device memory; 0 past the n.
template <int DS, int G, bool kStaged>
__device__ __forceinline__ void load_bc(float (&v)[G][kSub], const float* st,
                                        const float* __restrict__ g,
                                        size_t tj, int s0, int tt, int n) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if constexpr (kStaged) {
      load_steps(v[i], st, s0 + i, tt);
    } else {
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        v[i][u] = u < n ? __ldg(g + (tj + u) * DS + s0 + i) : 0.f;
    }
  }
}

// Phase 3, one block per (tile of kTile rows, chunk k, b); the block
// walks its tile RB rows at a time, the next RB rows' inputs copied into
// shared memory while it works on these. Each lane: h from hc[k] forward
// to every sub-chunk start (shared memory), then the sub-chunks backwards
// from lam_k: recompute the kSub steps' h_t and a_t into registers, walk
// them backwards. gx and gdt need sums over the row's states (a
// reduce-scatter of the sub-chunk's 2 x kSub sums at once, stored
// row-contiguous by the whole block); gB and gC sums over rows (a warp's
// rows by shuffles, the block's warps in warp order, the tile's row
// groups in order in sacc; one partial per (b, t, tile) -> part (Bb, S,
// nT, 2 DS)); gA and gD over steps (one partial per (b, k): gA over
// lam_k's slot, gD -> gD_part (Bb, nC, di)).
template <int DS, bool kRow>
__global__ void __launch_bounds__(kBwdThreads, 2)
ssm_bwd_chunk_kernel(const float* __restrict__ dt,
                     const float* __restrict__ x,
                     const float* __restrict__ A, long long a_rs,
                     long long a_cs, const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ D,
                     const float* __restrict__ hc,
                     const float* __restrict__ gy, float* __restrict__ gdt,
                     float* __restrict__ gx, float* __restrict__ lam,
                     float* __restrict__ gD_part, float* __restrict__ part,
                     int S, int di, int nC, int nT) {
  using Ln = BwdLanes<DS>;
  constexpr int TPR = Ln::TPR, G = Ln::G, RB = Ln::RB, NQ = Ln::NQ;
  constexpr int GA = kRow ? 1 : G;           // decays a lane
  constexpr int W2 = 2 * DS;
  using St = Stage<DS>;
  extern __shared__ float smem[];
  float* sck = smem;                               // [kNSub][RB][DS]
  float* sacc = sck + kNSub * RB * DS;             // [kChunk][W2]
  float* sstage = sacc + kChunk * W2;              // [2][St::size]
  float* sbc = sstage + 2 * St::size;              // B, C [DS][kStageRow]
  // [1 or 2] x (warps' sums [kSub][warps][W2], state sums [2][kSub][RB])
  float* ssub = sbc + (Ln::kStageBC ? Ln::bc_floats : 0);
  const int tile = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane % TPR;                       // lane in its row
  const int rib = warp * Ln::RW + lane / TPR;      // row in the iteration
  const int s0 = lr * G;                           // the lane's states
  const int t0 = k * kChunk, L = min(kChunk, S - t0);
  const int nsub = (L + kSub - 1) / kSub;
  const size_t bs0 = (size_t)b * S;
  const size_t kds = (size_t)(b * nC + k) * DS;
  const size_t kdi = (size_t)(b * nC + k) * di;
  for (int e = tid; e < kChunk * W2; e += kBwdThreads) sacc[e] = 0.f;

  // after the sum over a warp's rows: v[i] is value qbase + i (q * G +
  // state offset), written by one lane of each group of duplicates
  int qbase = 0;
#pragma unroll
  for (int m = 0; m < Ln::HR; ++m)
    qbase += ((lane >> (4 - m)) & 1) * (NQ >> (m + 1));
  const bool bc_writer =
      (lane & (((32 >> Ln::HR) - 1) & ~(TPR - 1))) == 0;
  // after the sum over a row's lanes: vq[i] is the sum over states of
  // value ubase + i (step u < kSub: for gx; kSub + u: the rest of gdt)
  int ubase = 0;
#pragma unroll
  for (int m = 0; m < Ln::HQ; ++m)
    ubase += ((lane >> (Ln::LT - 1 - m)) & 1) * ((2 * kSub) >> (m + 1));
  const bool s_writer =
      (lane & ((TPR >> Ln::HQ) - 1)) == 0 && ubase < kSub;

  const int r_end = min(di, (tile + 1) * kTile);
  if constexpr (Ln::kStageBC) {        // in the first stage's commit group
    for (int e = tid; e < 2 * kChunk * DS; e += kBwdThreads) {
      const int q = e / (kChunk * DS), tt = e / DS % kChunk, st = e % DS;
      const float* src = q ? Cm : Bm;
      const bool ok = tt < L;
      copy_async4(sbc + (q * DS + st) * kStageRow + tt,
                  ok ? src + (bs0 + t0 + tt) * DS + st : src, ok);
    }
  }
  St(sstage).load(dt, x, gy, D, hc, lam, A, a_rs, a_cs, bs0 + t0, L,
                  tile * kTile, r_end, di, kds, kdi);
  int it = 0;
  for (int r0 = tile * kTile; r0 < r_end; r0 += RB, ++it) {
    const St cur(sstage + (it & 1) * St::size);
    if (r0 + RB < r_end)      // the next rows' inputs, while these run
      St(sstage + ((it + 1) & 1) * St::size)
          .load(dt, x, gy, D, hc, lam, A, a_rs, a_cs, bs0 + t0, L, r0 + RB,
                r_end, di, kds, kdi);
    else
      copy_commit();
    copy_wait<1>();
    __syncthreads();
    const int r = r0 + rib;
    const bool has_row = r < r_end;
    float A1[GA], A2[GA], h[G], gc[G], gA[G];
#pragma unroll
    for (int i = 0; i < GA; ++i) {
      A1[i] = cur.A[rib * DS + s0 + i];
      A2[i] = A1[i] * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      h[i] = cur.h0[(s0 + i) * RB + rib];
      gc[i] = cur.lam[rib * DS + s0 + i];
      gA[i] = 0.f;
    }
    // forward to every sub-chunk start (all but the last are whole)
    for (int j = 0; j < nsub; ++j) {
#pragma unroll
      for (int i = 0; i < G; ++i) sck[(j * RB + rib) * DS + s0 + i] = h[i];
      if (j == nsub - 1) break;
      const size_t tj = bs0 + t0 + j * kSub;
      float d8[kSub], x8[kSub], b8[G][kSub];
      load_steps(d8, cur.dt, rib, j * kSub);
      load_steps(x8, cur.x, rib, j * kSub);
      load_bc<DS, G, Ln::kStageBC>(b8, sbc, Bm, tj, s0, j * kSub, kSub);
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const float d = d8[u];
        const float dx = d * x8[u];
        float a[GA];
#pragma unroll
        for (int i = 0; i < GA; ++i) a[i] = ex2(d * A2[i]);
#pragma unroll
        for (int i = 0; i < G; ++i)
          h[i] = fmaf(a[kRow ? 0 : i], h[i], dx * b8[i][u]);
      }
    }
    float gd = 0.f;
    for (int j = nsub - 1; j >= 0; --j) {
      const size_t tj = bs0 + t0 + j * kSub;
      const int n = min(kSub, L - j * kSub);
      float* swarp = ssub + (Ln::kDouble && (j & 1)) * Ln::sub_floats;
      float* ss1 = swarp + kSub * kBwdWarps * W2;
      float* ss2 = ss1 + kSub * RB;
      float d8[kSub], x8[kSub], y8[kSub];
      load_steps(d8, cur.dt, rib, j * kSub);
      load_steps(x8, cur.x, rib, j * kSub);
      load_steps(y8, cur.gy, rib, j * kSub);
      float ck[G], hs[kSub][G], av[kSub][GA], bs[G][kSub], cs[G][kSub];
      load_bc<DS, G, Ln::kStageBC>(bs, sbc, Bm, tj, s0, j * kSub, n);
      load_bc<DS, G, Ln::kStageBC>(cs, sbc + DS * kStageRow, Cm, tj, s0,
                                   j * kSub, n);
#pragma unroll
      for (int i = 0; i < G; ++i) ck[i] = sck[(j * RB + rib) * DS + s0 + i];
      // recompute the sub-chunk's h_t and a_t
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (u < n) {
          const float d = d8[u];
          const float dx = d * x8[u];
#pragma unroll
          for (int i = 0; i < GA; ++i) av[u][i] = ex2(d * A2[i]);
#pragma unroll
          for (int i = 0; i < G; ++i)
            hs[u][i] = fmaf(av[u][kRow ? 0 : i], u ? hs[u - 1][i] : ck[i],
                            dx * bs[i][u]);
        }
      }
      // walk it backwards
      float vq[2 * kSub];
#pragma unroll
      for (int e = 0; e < 2 * kSub; ++e) vq[e] = 0.f;
#pragma unroll
      for (int u = kSub - 1; u >= 0; --u) {
        if (u < n) {
          const float d = d8[u], xv = x8[u], g_y = y8[u];
          const float dx = d * xv;
          float q1 = 0.f, q2 = 0.f, v[NQ];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float prev = u ? hs[u - 1][i] : ck[i];
            const float g = fmaf(g_y, cs[i][u], gc[i]);
            const float gn = av[u][kRow ? 0 : i] * g;
            q1 = fmaf(g, bs[i][u], q1);
            const float th = gn * prev;
            q2 = kRow ? q2 + th : fmaf(A1[kRow ? 0 : i], th, q2);
            gA[i] = fmaf(d, th, gA[i]);
            v[i] = g * dx;                       // gB partial
            v[G + i] = g_y * hs[u][i];           // gC partial
            gc[i] = gn;
          }
          vq[u] = q1;
          vq[kSub + u] = kRow ? A1[0] * q2 : q2;
          gd = fmaf(g_y, xv, gd);
          reduce_scatter<NQ, NQ, 16, TPR>(v, lane);
          if (bc_writer) {
            float* w = swarp + (u * kBwdWarps + warp) * W2;
#pragma unroll
            for (int i = 0; i < Ln::NK; ++i) {
              const int q = (qbase + i) / G, gi = (qbase + i) % G;
              w[q * DS + s0 + gi] = v[i];
            }
          }
        }
      }
      reduce_scatter<2 * kSub, 2 * kSub, TPR / 2, 1>(vq, lane);
#pragma unroll
      for (int i = 0; i < Ln::NV; ++i) {
        const float rest = __shfl_xor_sync(0xffffffffu, vq[i], TPR / 2);
        if (s_writer && ubase + i < n) {
          ss1[(ubase + i) * RB + rib] = vq[i];
          ss2[(ubase + i) * RB + rib] = rest;
        }
      }
      __syncthreads();
      // the warps' gB/gC sums into the block's, in warp order, 4 at once
      for (int e = 4 * tid; e < n * W2; e += 4 * kBwdThreads) {
        const int u = e / W2, o = e % W2;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) {
          const float4 v = *reinterpret_cast<const float4*>(
              swarp + (u * kBwdWarps + w) * W2 + o);
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
        float4* a = reinterpret_cast<float4*>(sacc + (j * kSub + u) * W2 + o);
        const float4 prev = *a;
        *a = make_float4(prev.x + acc.x, prev.y + acc.y, prev.z + acc.z,
                         prev.w + acc.w);
      }
      // gx, gdt of the sub-chunk's rows, row-contiguous
      for (int e = tid; e < n * RB; e += kBwdThreads) {
        const int u = e / RB, row = e % RB;
        if (r0 + row < r_end) {
          const size_t o = (tj + u) * di + r0 + row;
          const int st = row * kStageRow + j * kSub + u;
          const float s1 = ss1[e];
          gx[o] = fmaf(cur.dt[st], s1, cur.D[row] * cur.gy[st]);
          gdt[o] = fmaf(cur.x[st], s1, ss2[e]);
        }
      }
      if constexpr (!Ln::kDouble) __syncthreads();
    }
    // the stage and sub-chunk buffers are free (and sacc complete) only
    // when every thread is past the last fold
    if constexpr (Ln::kDouble) __syncthreads();
    if (has_row) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        lam[((size_t)kdi + r) * DS + s0 + i] = gA[i];
      if (lr == 0) gD_part[kdi + r] = gd;
    }
  }
  // the tile's gB/gC partial (the last fold ended with a barrier)
  for (int e = tid; e < L * W2; e += kBwdThreads) {
    const int tt = e / W2, o = e % W2;
    part[((bs0 + t0 + tt) * nT + tile) * W2 + o] = sacc[e];
  }
}

// gB/gC[b, t, :] = sum over tiles (in order) of part[b, t, tile, :]
__global__ void __launch_bounds__(256)
ssm_bwd_reduce_bc(const float* __restrict__ part, float* __restrict__ gB,
                  float* __restrict__ gC, long long n_bt, int nT, int ds) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const int w2 = 2 * ds;
  if (i >= n_bt * w2) return;
  const long long bt = i / w2;
  const int o = (int)(i % w2);
  const float* p = part + bt * nT * w2 + o;
  float acc = 0.f;
  for (int q = 0; q < nT; ++q) acc += p[(size_t)q * w2];
  if (o < ds)
    gB[bt * ds + o] = acc;
  else
    gC[bt * ds + o - ds] = acc;
}

// gA[r, s] = sum over (b, k) in order of the chunk kernel's partials (in
// lam); gD[r] likewise of gD_part
__global__ void __launch_bounds__(256)
ssm_bwd_reduce_ad(const float* __restrict__ gA_part,
                  const float* __restrict__ gD_part, float* __restrict__ gA,
                  float* __restrict__ gD, int n_bk, int di, int ds) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long n = (long long)di * ds;
  if (i >= n) return;
  float acc = 0.f;
  for (int q = 0; q < n_bk; ++q) acc += gA_part[(size_t)q * n + i];
  gA[i] = acc;
  if (i % ds == 0) {
    const int r = (int)(i / ds);
    float d = 0.f;
    for (int q = 0; q < n_bk; ++q) d += gD_part[(size_t)q * di + r];
    gD[r] = d;
  }
}

template <int DS>
int fwd(const float* dt, const float* x, const float* A, long long a_rs,
        long long a_cs, const float* Bm, const float* Cm, const float* D,
        float* y, float* hc, int Bb, int S, int di, cudaStream_t st) {
  const int nC = (S + kChunk - 1) / kChunk;
  const dim3 grid((di + kThreads - 1) / kThreads, Bb);
  constexpr size_t smem = fwd_smem<DS>();
  const int rc = (int)cudaFuncSetAttribute(
      ssm_scan_fwd_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  ssm_scan_fwd_kernel<DS><<<grid, kThreads, smem, st>>>(
      dt, x, A, a_rs, a_cs, Bm, Cm, D, y, hc, S, di, nC);
  return (int)cudaGetLastError();
}

template <int DS, bool kRow>
int bwd(const float* dt, const float* x, const float* A, long long a_rs,
        long long a_cs, const float* Bm, const float* Cm, const float* D,
        const float* hc, const float* gy, float* gdt, float* gx, float* gB,
        float* gC, float* gA, float* gD, float* lam, float* dsum,
        float* part, float* gD_part, int Bb, int S, int di,
        cudaStream_t st) {
  const int nC = (S + kChunk - 1) / kChunk;
  const int nT = (di + kTile - 1) / kTile;
  int rc;
  if (nC > 1) {
    ssm_bwd_carry_kernel<DS, kRow>
        <<<dim3((di + kCarryThreads - 1) / kCarryThreads, nC - 1, Bb),
           kCarryThreads, 0, st>>>(dt, A, a_rs, a_cs, Cm, gy, lam, dsum, S,
                                   di, nC);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  const long long n_lam = (long long)Bb * di * DS;
  ssm_bwd_lambda_kernel<<<(unsigned)((n_lam + 255) / 256), 256, 0, st>>>(
      A, a_rs, a_cs, dsum, lam, Bb, di, DS, nC);
  if ((rc = (int)cudaGetLastError())) return rc;
  constexpr size_t smem = sizeof(float) * BwdLanes<DS>::smem_floats;
  static const int attr = (int)cudaFuncSetAttribute(
      ssm_bwd_chunk_kernel<DS, kRow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr) return attr;
  ssm_bwd_chunk_kernel<DS, kRow><<<dim3(nT, nC, Bb), kBwdThreads, smem,
                                   st>>>(
      dt, x, A, a_rs, a_cs, Bm, Cm, D, hc, gy, gdt, gx, lam, gD_part, part,
      S, di, nC, nT);
  if ((rc = (int)cudaGetLastError())) return rc;
  const long long n_bt = (long long)Bb * S;
  ssm_bwd_reduce_bc<<<(unsigned)((n_bt * 2 * DS + 255) / 256), 256, 0,
                      st>>>(part, gB, gC, n_bt, nT, DS);
  if ((rc = (int)cudaGetLastError())) return rc;
  ssm_bwd_reduce_ad<<<(unsigned)(((long long)di * DS + 255) / 256), 256, 0,
                      st>>>(lam, gD_part, gA, gD, Bb * nC, di, DS);
  return (int)cudaGetLastError();
}

}  // namespace

// Layouts (float32, contiguous unless noted): dt/x/y/gy/gdt/gx (Bb, S,
// di); A (di, ds) at element strides (a_rs, a_cs) and gA (di, ds)
// contiguous; B/C/gB/gC (Bb, S, ds); D/gD (di,); hc (Bb, nC, ds, di),
// nC = ceil(S/chunk). Scratch for the backward: lam (Bb, nC, di, ds);
// dsum (Bb, nC, di); part (Bb, S, ceil(di/tile), 2 ds); gD_part (Bb, nC,
// di).
// ``chunk`` must equal ssm_scan_chunk() and ``tile`` ssm_scan_tile().
// Each launcher returns cudaGetLastError().
extern "C" int ssm_scan_chunk() { return kChunk; }

extern "C" int ssm_scan_tile() { return kTile; }

#define REPRO_SSM_DISPATCH(CALL)         \
  switch (ds) {                          \
    case 4: return CALL(4);              \
    case 8: return CALL(8);              \
    case 16: return CALL(16);            \
    case 32: return CALL(32);            \
    case 64: return CALL(64);            \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int ssm_scan_fwd_launch(const void* dt, const void* x,
                                   const void* A, long long a_rs,
                                   long long a_cs, const void* Bm,
                                   const void* Cm, const void* D, void* y,
                                   void* hc, int Bb, int S, int di, int ds,
                                   void* stream) {
  if (Bb <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_FWD(DSV)                                                  \
  fwd<DSV>(static_cast<const float*>(dt), static_cast<const float*>(x),    \
           static_cast<const float*>(A), a_rs, a_cs,                       \
           static_cast<const float*>(Bm), static_cast<const float*>(Cm),   \
           static_cast<const float*>(D), static_cast<float*>(y),           \
           static_cast<float*>(hc), Bb, S, di, st)
  REPRO_SSM_DISPATCH(REPRO_SSM_FWD)
#undef REPRO_SSM_FWD
}

extern "C" int ssm_scan_bwd_launch(
    const void* dt, const void* x, const void* A, long long a_rs,
    long long a_cs, const void* Bm, const void* Cm, const void* D,
    const void* hc, const void* gy, void* gdt, void* gx, void* gB, void* gC,
    void* gA, void* gD, void* lam, void* dsum, void* part, void* gD_part,
    int Bb, int S, int di, int ds, void* stream) {
  if (Bb <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // mamba2's decay is one number a row (a stride-0 view): one exp a step
#define REPRO_SSM_BWD_ARGS                                                  \
  static_cast<const float*>(dt), static_cast<const float*>(x),             \
      static_cast<const float*>(A), a_rs, a_cs,                            \
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),        \
      static_cast<const float*>(D), static_cast<const float*>(hc),         \
      static_cast<const float*>(gy), static_cast<float*>(gdt),             \
      static_cast<float*>(gx), static_cast<float*>(gB),                    \
      static_cast<float*>(gC), static_cast<float*>(gA),                    \
      static_cast<float*>(gD), static_cast<float*>(lam),                   \
      static_cast<float*>(dsum), static_cast<float*>(part),                \
      static_cast<float*>(gD_part), Bb, S, di, st
#define REPRO_SSM_BWD(DSV)                                                  \
  (a_cs == 0 ? bwd<DSV, true>(REPRO_SSM_BWD_ARGS)                          \
             : bwd<DSV, false>(REPRO_SSM_BWD_ARGS))
  REPRO_SSM_DISPATCH(REPRO_SSM_BWD)
#undef REPRO_SSM_BWD
#undef REPRO_SSM_BWD_ARGS
}
#undef REPRO_SSM_DISPATCH
