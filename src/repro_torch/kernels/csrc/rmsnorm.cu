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
// Forward design. The TPU kernel tiles (row_block x D) blocks into VMEM;
// here a row is read from device memory once, in 16-byte vectors (8 bf16
// or 4 float32 a thread), kept in registers through the sum of squares
// and the scale, and written back in 16-byte vectors. The threads per row
// follow the width: 8, 16 or 32 lanes for narrow rows (at qk-norm's
// D = 128 in bf16 a 16-lane group owns a row, two rows a warp, sums by
// shuffles inside the group), one warp for rows of up to 256 vectors
// (D = 2048 bf16: 8 vectors a lane), 2 to 8 warps for wider rows (their
// partial sums meet in shared memory in warp order). Blocks walk the rows
// with a grid stride, the grid sized to what the card keeps resident, so
// each thread loads its slice of w (float4) once and keeps it in
// registers for every row it walks. A width that is not a multiple of the
// vector, a base pointer off a 16-byte boundary, or a row wider than 2048
// vectors takes the scalar kernel (one warp a row, x read twice).
//
// Backward design. One warp owns one row (lanes stride over the columns,
// so a warp's loads are contiguous) and the row's sums are warp shuffles.
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

// the scalar forward: one warp a row, x read twice (any D, any alignment)
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

__device__ __forceinline__ void unpack16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// The vector forward: TPR threads own a row, each NV of its 16-byte
// vectors (vector v of a row goes to thread v % TPR); rows advance by a
// grid stride, so every thread of a block runs the same iterations.
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ y, float* __restrict__ rstd, int R,
                       int D, float eps) {
  constexpr int E = 16 / sizeof(T);          // elements per vector
  constexpr int RPB = kThreads / TPR;        // rows a block takes at once
  constexpr int WPR = TPR > 32 ? TPR / 32 : 1;   // warps per row
  __shared__ float part[kWarps];
  const int nvec = D / E;
  const int t = threadIdx.x % TPR, rb = threadIdx.x / TPR;
  float wf[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * TPR;
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < nvec) w4 = *reinterpret_cast<const float4*>(w + v * E + k);
      wf[i][k] = w4.x; wf[i][k + 1] = w4.y;
      wf[i][k + 2] = w4.z; wf[i][k + 3] = w4.w;
    }
  }
  for (int r0 = blockIdx.x * RPB; r0 < R; r0 += gridDim.x * RPB) {
    const int r = r0 + rb;
    const bool live = r < R;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
    uint4 xv[NV];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (live && v < nvec) {
        xv[i] = xr[v];
        float f[E];
        unpack16(xv[i], f, T());
#pragma unroll
        for (int k = 0; k < E; ++k) ss += f[k] * f[k];
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) ss += part[rb * WPR + k];
      __syncthreads();                  // part is rewritten next row
    }
    const float rs = rsqrtf(ss / (float)D + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)r * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (live && v < nvec) {
        float f[E];
        unpack16(xv[i], f, T());
#pragma unroll
        for (int k = 0; k < E; ++k) f[k] = f[k] * rs * wf[i][k];
        yr[v] = pack16(f, T());
      }
    }
    if (live && t == 0) rstd[r] = rs;
  }
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

template <typename T, int TPR, int NV>
int fwd_vec(const T* x, const float* w, T* y, float* rstd, int R, int D,
            float eps, cudaStream_t st) {
  auto kernel = rmsnorm_fwd_vec_kernel<T, TPR, NV>;
  // blocks of this kernel the card keeps resident (asked once: the grid
  // walks the rows with a stride, so any count is correct)
  static const long long room = [] {
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_fwd_vec_kernel<T, TPR, NV>, kThreads, 0);
    return (long long)sms * (per_sm > 0 ? per_sm : 1);
  }();
  constexpr int RPB = kThreads / TPR;
  const long long need = ((long long)R + RPB - 1) / RPB;
  kernel<<<(int)(need < room ? need : room), kThreads, 0, st>>>(
      x, w, y, rstd, R, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* xv, const float* w, void* yv, float* rstd, int R, int D,
        float eps, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int E = 16 / sizeof(T);
  const int nvec = D / E;
  const bool aligned = D % E == 0 &&
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)w) % 16 == 0;
  if (aligned) {
    if (nvec <= 8) return fwd_vec<T, 8, 1>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 16) return fwd_vec<T, 16, 1>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 32) return fwd_vec<T, 32, 1>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 64) return fwd_vec<T, 32, 2>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 128) return fwd_vec<T, 32, 4>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 256) return fwd_vec<T, 32, 8>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 512) return fwd_vec<T, 64, 8>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 1024)
      return fwd_vec<T, 128, 8>(x, w, y, rstd, R, D, eps, st);
    if (nvec <= 2048)
      return fwd_vec<T, 256, 8>(x, w, y, rstd, R, D, eps, st);
  }
  rmsnorm_fwd_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      x, w, y, rstd, R, D, eps);
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
// rstd (R,), partial (n_chunks, D); the forward takes its vector path
// when x, y and w start on 16-byte boundaries and D is a multiple of the
// vector (8 bf16, 4 float32). Each returns cudaGetLastError().
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
