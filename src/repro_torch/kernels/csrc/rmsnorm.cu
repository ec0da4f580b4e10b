// RMSNorm forward and backward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_2d (Pallas body
//   _rmsnorm_kernel). The TPU kernel has no backward (JAX differentiates
//   the jnp code); the backward here is new, so that the training path's
//   gradients run on hand-written kernels too.
//
// Forward, per row r of x (R, D):  rstd_r = rsqrt(mean(x_r^2) + eps),
//   y_r = x_r * rstd_r * w, all in float32, y cast back to x's dtype;
//   rstd (R,) float32 is kept for the backward.
// Backward, with xhat = x * rstd:
//   dx_r = rstd_r * (w * dy_r - xhat_r * mean(xhat_r * w * dy_r))
//   dw   = sum over rows of dy_r * xhat_r
//
// What bounds it on the H100: bytes. The forward reads x once and writes
// y once (2 x R x D x itemsize); the backward reads x and dy and writes
// dx; a handful of flops per element is far below the tensor-core line.
//
// Design. The TPU kernel tiles (row_block x D) blocks into VMEM; here one
// warp owns one row (lanes stride over the columns, so a warp's loads are
// contiguous) and the row's sums are warp shuffles, no shared memory.
// dw is a sum over all rows: instead of float atomics (whose order, and so
// whose result, changes from run to run) it is reduced in two fixed-order
// passes: a column-parallel pass writes one partial sum per (row chunk,
// column), then one pass adds the chunks in order. The chunk count depends
// only on (R, D), so dw is bit-identical from run to run, which keeps
// MGRIT training runs repeatable. Later work: 16-byte vector loads, fusing
// the dw partials into the dx pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ y, float* __restrict__ rstd, int R, int D,
                   float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= R) return;
  const T* xr = x + (size_t)r * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
  const float rs = rsqrtf(warp_sum(ss) / (float)D + eps);
  T* yr = y + (size_t)r * D;
  for (int c = lane; c < D; c += 32) store(&yr[c], to_f32(xr[c]) * rs * w[c]);
  if (lane == 0) rstd[r] = rs;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx, int R,
                      int D) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= R) return;
  const size_t off = (size_t)r * D;
  const float rs = rstd[r];
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s += to_f32(x[off + c]) * rs * w[c] * to_f32(dy[off + c]);
  const float mean = warp_sum(s) / (float)D;
  for (int c = lane; c < D; c += 32) {
    const float xhat = to_f32(x[off + c]) * rs;
    store(&dx[off + c], rs * (w[c] * to_f32(dy[off + c]) - xhat * mean));
  }
}

// partial[k, c] = sum over rows r of chunk k of dy[r, c] * x[r, c] * rstd[r]
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw_partial_kernel(const T* __restrict__ x,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy,
                              float* __restrict__ partial, int R, int D,
                              int rows_per_chunk) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  if (c >= D) return;
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t off = (size_t)r * D + c;
    acc += to_f32(dy[off]) * (to_f32(x[off]) * rstd[r]);
  }
  partial[(size_t)blockIdx.y * D + c] = acc;
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dw, int D, int n_chunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int k = 0; k < n_chunks; ++k) acc += partial[(size_t)k * D + c];
  dw[c] = acc;
}

template <typename T>
int fwd(const void* x, const float* w, void* y, float* rstd, int R, int D,
        float eps, cudaStream_t st) {
  rmsnorm_fwd_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), rstd, R, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const float* w, const float* rstd, const void* dy,
        void* dx, float* dw, float* partial, int R, int D, int n_chunks,
        cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  rmsnorm_bwd_dx_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      xt, w, rstd, dyt, static_cast<T*>(dx), R, D);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int col_blocks = (D + kThreads - 1) / kThreads;
  const int rows_per_chunk = (R + n_chunks - 1) / n_chunks;
  rmsnorm_bwd_dw_partial_kernel<T>
      <<<dim3(col_blocks, n_chunks), kThreads, 0, st>>>(
          xt, rstd, dyt, partial, R, D, rows_per_chunk);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rmsnorm_bwd_dw_reduce_kernel<<<col_blocks, kThreads, 0, st>>>(
      partial, dw, D, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy, dx). w, rstd, dw and the
// partial buffer are float32. All contiguous: x/y/dy/dx (R, D), w/dw (D,),
// rstd (R,), partial (n_chunks, D). Each returns cudaGetLastError().
extern "C" int rmsnorm_fwd_launch(const void* x, const void* w, void* y,
                                  void* rstd, int dtype, int R, int D,
                                  float eps, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, wf, y, rs, R, D, eps, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, wf, y, rs, R, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* rstd, const void* dy, void* dx,
                                  void* dw, void* partial, int dtype, int R,
                                  int D, int n_chunks, void* stream) {
  if (R <= 0 || D <= 0 || n_chunks <= 0 || n_chunks > R)
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* rs = static_cast<const float*>(rstd);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, wf, rs, dy, dx, dwf, pf, R, D, n_chunks, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, wf, rs, dy, dx, dwf, pf, R, D, n_chunks,
                              st);
  return (int)cudaErrorInvalidValue;
}
