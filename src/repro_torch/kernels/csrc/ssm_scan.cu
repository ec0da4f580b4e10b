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
// The chunks are walked in reverse; inside a chunk h_t is recomputed
// forward from the stored state into a scratch buffer (hs), never run
// backwards by dividing by a_t (exp(dt*A) underflows to 0 as training
// moves A and dt). gB and gC are sums over all di rows, so each warp
// writes its partial sums and a second kernel adds the warps in a fixed
// order; gA and gD are per-thread sums over t, added over b in a fixed
// order. No atomics: a second backward is bit-identical. nvcc contracts
// multiply-adds into FMAs and the card's expf is not the CPU's, so the
// kernels match the plain version to a tolerance, not bit for bit.
//
// What bounds it on the H100. The forward moves dt, x and y (and the
// checkpoints) once: at falcon-mamba-7b's training shape (Bb 2, S 4096,
// di 8192, ds 16) about 0.87 GB, 0.26 ms at 3.35 TB/s; it evaluates
// Bb*S*di*ds expf, about as long on the SFUs. The backward reads dt, x,
// gy and the checkpoints and writes gdt, gx: about the same bytes, twice
// the exps.
//
// Design. The TPU kernel keeps h resident in VMEM across a sequential
// grid of sequence chunks. Blocks on the card run in no order, so one
// thread owns one (b, r) for the whole call and walks t in a loop with
// h[0:ds] and A[r, 0:ds] in registers. B_t and C_t are shared by all
// rows, so a block stages a chunk of them through shared memory; each
// thread also stages its own column of dt and x (and gy) for the chunk,
// so that a chunk's loads overlap instead of one load's latency being
// paid at every step. The parallelism is only
// Bb*di threads (16384 for falcon-mamba-7b, 4096 for zamba2-1.2b), each
// a sequential chain: the kernel is latency-bound, far from its bound.
// For mamba2 (zamba2) every row of a head has the same decay, so the 64
// x 64 exps of a head and step are the same number, recomputed here: a
// known waste. Later work: a chunked (parallel-in-time) formulation,
// exps shared per head, and the h tape of a chunk kept on chip instead
// of in the hs scratch buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // rows per block, one thread per row
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;     // steps per checkpoint / B, C staging chunk

// Reduce-scatter over the warp: stage by stage (offset o = 16, 8, .., 1)
// each lane keeps half of its n values, adding its partner's copy of
// that half, until one is left; the remaining offsets add plainly. After
// it lane l holds, in v[0], the warp's sum of value (l * N) / 32 (N a
// power of two <= 32): N - 1 shuffles instead of 5 N. A template
// recursion, so that every index is a compile-time constant and v stays
// in registers.
template <int N, int n, int o>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N],
                                                    int lane) {
  if constexpr (o > 0) {
    if constexpr (n >= 2) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? v[i] : v[i + n / 2];
        const float keep = up ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      warp_reduce_scatter<N, n / 2, o / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      warp_reduce_scatter<N, 1, o / 2>(v, lane);
    }
  }
}

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
constexpr size_t bwd_smem() {
  return (2 * kChunk * DS + 3 * kChunk * kThreads + DS * kThreads) *
         sizeof(float);
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

// One thread per (b, r); per step each warp writes its partial sums of
// gB and gC into part (Bb, S, nW, 2 ds): group g of kG states holds gB of
// states g*kG .. g*kG+kG-1 then gC of the same states. gA and gD partial
// sums over t go to gA_part (Bb, ds, di) and gD_part (Bb, di). For
// d_state <= 32 h_t is carried in registers from the step above (it is
// that step's h_{t-1}); at 64 states registers run out and it is read
// back from the tape.
template <int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ dt,
                    const float* __restrict__ x,
                    const float* __restrict__ A, long long a_rs,
                    long long a_cs, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ D,
                    const float* __restrict__ hc,
                    const float* __restrict__ gy, float* __restrict__ gdt,
                    float* __restrict__ gx, float* __restrict__ hs,
                    float* __restrict__ part, float* __restrict__ gA_part,
                    float* __restrict__ gD_part, int S, int di, int nC,
                    int nW) {
  constexpr int kG = DS < 16 ? DS : 16;     // states per reduce group
  constexpr int kRep = 32 / (2 * kG);       // lanes holding each sum
  constexpr bool kCarry = DS <= 32;
  extern __shared__ float smem[];
  float* sb = smem;                         // [kChunk][DS]
  float* sc = sb + kChunk * DS;             // [kChunk][DS]
  float* sdt = sc + kChunk * DS;            // [kChunk][kThreads]
  float* sx = sdt + kChunk * kThreads;      // [kChunk][kThreads]
  float* sgy = sx + kChunk * kThreads;      // [kChunk][kThreads]
  float* sga = sgy + kChunk * kThreads;     // [DS][kThreads]: gA sums
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w = blockIdx.x * kWarps + tid / 32;
  const int r = blockIdx.x * kThreads + tid;
  const bool has_row = r < di;

  float a[DS], gc[DS];                      // gc = a_{t+1} * g_{t+1}
  float hn[kCarry ? DS : 1];                // h_t of the current step
  float dr = 0.f, gd = 0.f;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    gc[s] = 0.f;
    a[s] = has_row ? A[r * a_rs + s * a_cs] : 0.f;
    sga[s * kThreads + tid] = 0.f;
  }
  if (has_row) dr = D[r];
  // this thread's tape of the chunk: hs[b][tt][s][r]
  float* tape = hs + (size_t)b * kChunk * DS * di + r;

  for (int k = nC - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int L = min(kChunk, S - t0);
    const size_t o0 = ((size_t)b * S + t0) * di + r;
    __syncthreads();
    stage_bc(sb, sc, Bm, Cm, ((size_t)b * S + t0) * DS, L * DS);
    __syncthreads();
    const float* h0 = hc + ((size_t)b * nC + k) * DS * di + r;
    if (has_row) {                          // recompute h_t of the chunk
      stage_col(sdt, dt, o0, L, di);
      stage_col(sx, x, o0, L, di);
      stage_col(sgy, gy, o0, L, di);
      float h[DS];
#pragma unroll
      for (int s = 0; s < DS; ++s) h[s] = h0[(size_t)s * di];
      for (int tt = 0; tt < L; ++tt) {
        const float d = sdt[tt * kThreads + tid];
        const float dx = d * sx[tt * kThreads + tid];
#pragma unroll
        for (int s = 0; s < DS; ++s) {
          h[s] = expf(d * a[s]) * h[s] + dx * sb[tt * DS + s];
          tape[((size_t)tt * DS + s) * di] = h[s];
        }
      }
      if constexpr (kCarry) {
#pragma unroll
        for (int s = 0; s < DS; ++s) hn[s] = h[s];
      }
    }
    for (int tt = L - 1; tt >= 0; --tt) {   // every lane: shuffles below
      const int t = t0 + tt;
      float d = 0.f, xv = 0.f, g_y = 0.f;
      if (has_row) {
        d = sdt[tt * kThreads + tid];
        xv = sx[tt * kThreads + tid];
        g_y = sgy[tt * kThreads + tid];
      }
      const float dx = d * xv;
      const float* hcur = tape + (size_t)tt * DS * di;
      const float* hprev = tt > 0 ? tape + (size_t)(tt - 1) * DS * di : h0;
      float sum_gb = 0.f, sum_gdt = 0.f;
#pragma unroll
      for (int g0 = 0; g0 < DS; g0 += kG) {
        float v[2 * kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const int s = g0 + i;
          v[i] = 0.f;
          v[kG + i] = 0.f;
          if (has_row) {
            const float bs = sb[tt * DS + s];
            const float hp = hprev[(size_t)s * di];
            float h_t;
            if constexpr (kCarry) {
              h_t = hn[s];
              hn[s] = hp;
            } else {
              h_t = hcur[(size_t)s * di];
            }
            const float g = g_y * sc[tt * DS + s] + gc[s];
            const float da = expf(d * a[s]);
            v[i] = g * dx;                          // gB partial
            v[kG + i] = g_y * h_t;                  // gC partial
            sum_gb += g * bs;
            const float gah = g * da * hp;
            sum_gdt += g * xv * bs + gah * a[s];
            sga[s * kThreads + tid] += gah * d;
            gc[s] = da * g;
          }
        }
        warp_reduce_scatter<2 * kG, 2 * kG, 16>(v, lane);
        if (lane % kRep == 0)                       // index lane / kRep
          part[(((size_t)b * S + t) * nW + w) * 2 * DS + 2 * g0 +
               lane / kRep] = v[0];
      }
      if (has_row) {
        gx[o0 + (size_t)tt * di] = d * sum_gb + dr * g_y;
        gdt[o0 + (size_t)tt * di] = sum_gdt;
        gd += g_y * xv;
      }
    }
  }
  if (has_row) {
#pragma unroll
    for (int s = 0; s < DS; ++s)
      gA_part[((size_t)b * DS + s) * di + r] = sga[s * kThreads + tid];
    gD_part[(size_t)b * di + r] = gd;
  }
}

// gB/gC[b, t, :] = sum over warps w (in order) of part[b, t, w, :]
__global__ void __launch_bounds__(256)
ssm_scan_reduce_bc(const float* __restrict__ part, float* __restrict__ gB,
                   float* __restrict__ gC, long long n_bt, int nW, int ds,
                   int kg) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const int two_ds = 2 * ds;
  if (i >= n_bt * two_ds) return;
  const long long bt = i / two_ds;
  const int j = (int)(i % two_ds);
  const float* p = part + bt * nW * two_ds + j;
  float acc = 0.f;
  for (int w = 0; w < nW; ++w) acc += p[(size_t)w * two_ds];
  const int g = j / (2 * kg), q = j % (2 * kg);
  if (q < kg)
    gB[bt * ds + g * kg + q] = acc;
  else
    gC[bt * ds + g * kg + q - kg] = acc;
}

// gA[r, s] = sum_b gA_part[b, s, r]; gD[r] = sum_b gD_part[b, r]
__global__ void __launch_bounds__(256)
ssm_scan_reduce_ad(const float* __restrict__ gA_part,
                   const float* __restrict__ gD_part, float* __restrict__ gA,
                   float* __restrict__ gD, int Bb, int di, int ds) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)di * ds) return;
  const int s = (int)(i / di), r = (int)(i % di);
  float acc = 0.f;
  for (int b = 0; b < Bb; ++b) acc += gA_part[((size_t)b * ds + s) * di + r];
  gA[(size_t)r * ds + s] = acc;
  if (s == 0) {
    float d = 0.f;
    for (int b = 0; b < Bb; ++b) d += gD_part[(size_t)b * di + r];
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

template <int DS>
int bwd(const float* dt, const float* x, const float* A, long long a_rs,
        long long a_cs, const float* Bm, const float* Cm, const float* D,
        const float* hc, const float* gy, float* gdt, float* gx, float* gB,
        float* gC, float* gA, float* gD, float* hs, float* part,
        float* gA_part, float* gD_part, int Bb, int S, int di,
        cudaStream_t st) {
  const int nC = (S + kChunk - 1) / kChunk;
  const int nblk = (di + kThreads - 1) / kThreads;
  const int nW = nblk * kWarps;
  constexpr size_t smem = bwd_smem<DS>();
  int rc = (int)cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  ssm_scan_bwd_kernel<DS><<<dim3(nblk, Bb), kThreads, smem, st>>>(
      dt, x, A, a_rs, a_cs, Bm, Cm, D, hc, gy, gdt, gx, hs, part, gA_part,
      gD_part, S, di, nC, nW);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long n_bt = (long long)Bb * S;
  const long long n1 = n_bt * 2 * DS;
  ssm_scan_reduce_bc<<<(unsigned)((n1 + 255) / 256), 256, 0, st>>>(
      part, gB, gC, n_bt, nW, DS, DS < 16 ? DS : 16);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long n2 = (long long)di * DS;
  ssm_scan_reduce_ad<<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(
      gA_part, gD_part, gA, gD, Bb, di, DS);
  return (int)cudaGetLastError();
}

}  // namespace

// Layouts (float32, contiguous unless noted): dt/x/y/gy/gdt/gx (Bb, S,
// di); A (di, ds) at element strides (a_rs, a_cs) and gA (di, ds)
// contiguous; B/C/gB/gC (Bb, S, ds); D/gD (di,); hc (Bb, ceil(S/chunk),
// ds, di). Scratch for
// the backward: hs (Bb, chunk, ds, di); part (Bb, S, ssm_scan_warps(di),
// 2 ds); gA_part (Bb, ds, di); gD_part (Bb, di). ``chunk`` must equal
// ssm_scan_chunk(). Each launcher returns cudaGetLastError().
extern "C" int ssm_scan_chunk() { return kChunk; }

extern "C" int ssm_scan_warps(int di) {
  return (di + kThreads - 1) / kThreads * kWarps;
}

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
    void* gA, void* gD, void* hs, void* part, void* gA_part, void* gD_part,
    int Bb, int S, int di, int ds, void* stream) {
  if (Bb <= 0 || S <= 0 || di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSM_BWD(DSV)                                                  \
  bwd<DSV>(static_cast<const float*>(dt), static_cast<const float*>(x),    \
           static_cast<const float*>(A), a_rs, a_cs,                       \
           static_cast<const float*>(Bm), static_cast<const float*>(Cm),   \
           static_cast<const float*>(D), static_cast<const float*>(hc),    \
           static_cast<const float*>(gy), static_cast<float*>(gdt),        \
           static_cast<float*>(gx), static_cast<float*>(gB),               \
           static_cast<float*>(gC), static_cast<float*>(gA),               \
           static_cast<float*>(gD), static_cast<float*>(hs),               \
           static_cast<float*>(part), static_cast<float*>(gA_part),        \
           static_cast<float*>(gD_part), Bb, S, di, st)
  REPRO_SSM_DISPATCH(REPRO_SSM_BWD)
#undef REPRO_SSM_BWD
}
#undef REPRO_SSM_DISPATCH
