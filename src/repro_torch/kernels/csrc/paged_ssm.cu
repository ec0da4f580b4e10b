// Paged SSM update (decode and chunked prefill) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/paged_ssm.py, paged_ssm_update_pallas
//   (Pallas body _paged_ssm_kernel).
//
// Computes, for every slot b and row r (rows layout: mamba1's d_inner
// channels, or mamba2's heads x headdim), over local steps t = 0 .. S-1:
//   h[s] = exp(dt[b,t,r] * A[r,s]) * h[s] + term     while t < n_new[b]
//   term = (dt * B[b,t,s]) * x[b,t,r]  (order "dbx", mamba1)
//        = (dt * x[b,t,r]) * B[b,t,s]  (order "dxb", mamba2)
//   y[b,t,r] = sum_s h[s] * C[b,t,s]   (frozen-state readout at t >= n_new)
// with h starting from pool page read_page[b] (zero when live[b] == 0),
// and writes h after step t_w[b,w] into pool page phys_w[b,w], in place.
// Float32 throughout, expf (no fast math). nvcc contracts the multiply-
// adds into FMAs and its expf is not the CPU's, so results match the
// plain version to a tolerance, not bit for bit.
//
// What bounds it on the H100: bytes. A decode step reads one state page
// row block per live slot and writes one (R x ds x 4 bytes each: 512 KiB
// for falcon-mamba-7b, 1 MiB for zamba2-1.2b, per layer) plus dt, x, y
// (B x S x R x 4 each) and the small B/C streams; the arithmetic is one
// exp and three flops per state element and step — an intensity far
// below one flop per byte, so the bound is those bytes over 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential (B, W) grid, carrying h in
// VMEM from one write window to the next. Blocks on the card run in no
// order, so the window walk becomes the time loop inside the block: a
// block owns kThreads rows of one slot for the whole call, one thread
// per row with its h[0:ds] (and A[r, 0:ds]) in registers. The block
// reads read_page, live, n_new and the slot's plan itself (nothing is
// prefetched). B_t and C_t are shared by all rows of the slot, so they
// are staged through shared memory kSteps steps at a time; dt and x are
// read per step, coalesced across the rows. At each chunk the block
// marks which of its steps end a write window, so the plan is scanned
// once per chunk, not once per step.
//
// Read page == write page: a mid-page decode step reads its state from
// page (lengths-1)/page_size and rewrites the same page. Each block
// reads its h0 rows before it writes any snapshot of them, and no other
// block touches those rows of that slot, so the in-place update is safe
// by construction. Windows routed to scratch page 0 (idle slots,
// unwritten windows) are not written at all: page 0 is never read as
// state.
//
// Later work (making it fast): one warp per row group with the ds
// states spread across lanes (ds = 64 holds 128 floats per thread here),
// vectorised and prefetched dt/x loads, and the decode step fused across
// layers so a wave is not 66 launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // rows per block, one thread per row
constexpr int kSteps = 32;      // B/C steps staged per shared-memory chunk

template <int DS, bool DBX>
__global__ void __launch_bounds__(kThreads)
paged_ssm_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ A, long long a_rs, long long a_cs,
                 float* h_pool, const int* __restrict__ read_page,
                 const int* __restrict__ live,
                 const int* __restrict__ phys_w,
                 const int* __restrict__ t_w, const int* __restrict__ n_new,
                 float* __restrict__ y, int S, int R, int W) {
  __shared__ float sb[kSteps][DS];
  __shared__ float sc[kSteps][DS];
  __shared__ int smark[kSteps];

  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool has_row = r < R;
  const int nn = n_new[b];
  const size_t page_elems = (size_t)R * DS;
  const int* pw = phys_w + (size_t)b * W;
  const int* tw = t_w + (size_t)b * W;

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) h[s] = 0.f;
  if (has_row) {
#pragma unroll
    for (int s = 0; s < DS; ++s) a[s] = A[r * a_rs + s * a_cs];
    if (live[b] != 0) {
      const float4* src = reinterpret_cast<const float4*>(
          h_pool + (size_t)read_page[b] * page_elems + (size_t)r * DS);
#pragma unroll
      for (int s = 0; s < DS / 4; ++s) {
        const float4 v = src[s];
        h[4 * s] = v.x;
        h[4 * s + 1] = v.y;
        h[4 * s + 2] = v.z;
        h[4 * s + 3] = v.w;
      }
    }
  }

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int nt = min(kSteps, S - t0);
    __syncthreads();                  // the previous chunk is consumed
    for (int e = threadIdx.x; e < nt * DS; e += kThreads) {
      const size_t off = ((size_t)b * S + t0) * DS + e;
      sb[e / DS][e % DS] = Bm[off];
      sc[e / DS][e % DS] = Cm[off];
    }
    for (int e = threadIdx.x; e < kSteps; e += kThreads) smark[e] = 0;
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += kThreads) {
      const int t = tw[w];
      if (pw[w] != 0 && t >= t0 && t < t0 + nt) smark[t - t0] = 1;
    }
    __syncthreads();
    if (!has_row) continue;

    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      const size_t o = ((size_t)b * S + t) * R + r;
      if (t < nn) {
        const float d = dt[o];
        const float xv = x[o];
        if (DBX) {
#pragma unroll
          for (int s = 0; s < DS; ++s)
            h[s] = expf(d * a[s]) * h[s] + d * sb[tt][s] * xv;
        } else {
          const float dx = d * xv;
#pragma unroll
          for (int s = 0; s < DS; ++s)
            h[s] = expf(d * a[s]) * h[s] + dx * sb[tt][s];
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) acc += h[s] * sc[tt][s];
      y[o] = acc;
      if (smark[tt]) {
        for (int w = 0; w < W; ++w) {
          const int page = pw[w];
          if (page == 0 || tw[w] != t) continue;
          float4* dst = reinterpret_cast<float4*>(
              h_pool + (size_t)page * page_elems + (size_t)r * DS);
#pragma unroll
          for (int s = 0; s < DS / 4; ++s)
            dst[s] = make_float4(h[4 * s], h[4 * s + 1], h[4 * s + 2],
                                 h[4 * s + 3]);
        }
      }
    }
  }
}

template <int DS>
int launch(bool dbx, const float* dt, const float* x, const float* Bm,
           const float* Cm, const float* A, long long a_rs, long long a_cs,
           float* h_pool, const int* read_page, const int* live,
           const int* phys_w, const int* t_w, const int* n_new, float* y,
           int B, int S, int R, int W, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  if (dbx)
    paged_ssm_kernel<DS, true><<<grid, kThreads, 0, stream>>>(
        dt, x, Bm, Cm, A, a_rs, a_cs, h_pool, read_page, live, phys_w, t_w,
        n_new, y, S, R, W);
  else
    paged_ssm_kernel<DS, false><<<grid, kThreads, 0, stream>>>(
        dt, x, Bm, Cm, A, a_rs, a_cs, h_pool, read_page, live, phys_w, t_w,
        n_new, y, S, R, W);
  return (int)cudaGetLastError();
}

}  // namespace

// order: 0 = "dbx" (mamba1), 1 = "dxb" (mamba2). Layouts (float32,
// contiguous unless noted): dt/x/y (B, S, R); Bm/Cm (B, S, ds); A (R, ds)
// at element strides (a_rs, a_cs); h_pool (N, R, ds), 16-byte aligned,
// updated in place; read_page/live/n_new (B,) int32; phys_w/t_w (B, W)
// int32. Returns cudaGetLastError().
extern "C" int paged_ssm_launch(const void* dt, const void* x,
                                const void* Bm, const void* Cm,
                                const void* A, long long a_rs,
                                long long a_cs, void* h_pool,
                                const void* read_page, const void* live,
                                const void* phys_w, const void* t_w,
                                const void* n_new, void* y, int order,
                                int B, int S, int R, int ds, int W,
                                void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || W < 0 || (order != 0 && order != 1))
    return (int)cudaErrorInvalidValue;
  const bool dbx = order == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PS_LAUNCH(DSV)                                               \
  return launch<DSV>(dbx, static_cast<const float*>(dt),                  \
                     static_cast<const float*>(x),                        \
                     static_cast<const float*>(Bm),                       \
                     static_cast<const float*>(Cm),                       \
                     static_cast<const float*>(A), a_rs, a_cs,            \
                     static_cast<float*>(h_pool),                         \
                     static_cast<const int*>(read_page),                  \
                     static_cast<const int*>(live),                       \
                     static_cast<const int*>(phys_w),                     \
                     static_cast<const int*>(t_w),                        \
                     static_cast<const int*>(n_new), static_cast<float*>(y), \
                     B, S, R, W, st)
  switch (ds) {
    case 4: REPRO_PS_LAUNCH(4);
    case 8: REPRO_PS_LAUNCH(8);
    case 16: REPRO_PS_LAUNCH(16);
    case 32: REPRO_PS_LAUNCH(32);
    case 64: REPRO_PS_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PS_LAUNCH
}
