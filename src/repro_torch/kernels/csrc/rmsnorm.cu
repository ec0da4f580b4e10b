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
// Backward design. The backward moves x and dy in and dx out, each once,
// and the dw partials, which stay in registers. It takes the forward's
// vector layout, TPR threads a row (16 lanes at qk-norm's D = 128 bf16,
// 2-8 warps for wider rows), but two warps share a row of 129-256
// vectors (D = 2048 bf16: 4 vectors a thread, not 8), so that x, dy and
// the dw sums fit two blocks an SM instead of one; 16-byte loads of x and
// dy kept in registers through the row sum of xhat * w * dy (shuffles in
// the group, shared memory in warp order across warps) and the dx write
// (16-byte stores). dw is a sum over all rows: each thread owns a fixed
// column slice and adds dy * xhat for it over the rows it walks (grid
// stride, the grid sized to what the card keeps resident) in float32
// registers; at the end the block adds its row groups in a fixed order
// (shuffles, then shared memory in group order) into one partial row,
// and a second kernel adds the blocks' partials in a fixed order. No
// float atomics: the number of partials depends only on (R, D, dtype)
// and the card, so dw is bit-identical from run to run, which keeps
// MGRIT training runs repeatable. Two launches a call. A width off the
// vector or a pointer off 16 bytes takes the scalar path: one warp a
// row for dx, a column-parallel pass of dw partials over fixed row
// chunks, and the same fixed-order sum.

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

// dw[c] = sum over the n partial rows of partial[., c], in a fixed order:
// warp j of a block adds rows j, j + 32, ..; then the warps in order
__global__ void __launch_bounds__(1024)
rmsnorm_bwd_dw_sum_kernel(const float* __restrict__ partial,
                          float* __restrict__ dw, int D, int n) {
  __shared__ float s[32][33];
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < D)
    for (int p = j; p < n; p += 32) acc += partial[(size_t)p * D + c];
  s[j][lane] = acc;
  __syncthreads();
  if (j == 0 && c < D) {
    float tot = 0.f;
    for (int q = 0; q < 32; ++q) tot += s[q][lane];
    dw[c] = tot;
  }
}

// The vector backward: the forward's thread layout (TPR threads a row,
// each NV 16-byte vectors of it); dx a row at a time, dy * xhat summed
// into per-thread column registers over the rows the block walks, then
// the block's row groups added in a fixed order into partial[blockIdx.x].
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ rstd,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int R, int D) {
  constexpr int E = 16 / sizeof(T);          // elements per vector
  constexpr int RPB = kThreads / TPR;        // rows a block takes at once
  constexpr int WPR = TPR > 32 ? TPR / 32 : 1;   // warps per row
  // row groups whose column sums meet in shared memory: a warp's groups
  // are added by shuffles first when TPR < 32
  constexpr int NG = TPR < 32 ? kWarps : RPB;
  __shared__ float part[kWarps];
  extern __shared__ float sdw[];             // D floats when NG > 1
  const int nvec = D / E;
  const int t = threadIdx.x % TPR, rb = threadIdx.x / TPR;
  float acc[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) acc[i][k] = 0.f;
  for (int r0 = blockIdx.x * RPB; r0 < R; r0 += gridDim.x * RPB) {
    const int r = r0 + rb;
    const bool live = r < R;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + (size_t)r * D);
    const float rs = live ? rstd[r] : 0.f;
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (live && v < nvec) {
        xv[i] = xr[v];
        gv[i] = gr[v];
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (live && v < nvec) {
        float xf[E], gf[E];
        unpack16(xv[i], xf, T());
        unpack16(gv[i], gf, T());
        const float4* w4 = reinterpret_cast<const float4*>(w + v * E);
#pragma unroll
        for (int k = 0; k < E; k += 4) {
          const float4 ww = __ldg(w4 + k / 4);
          s += xf[k] * rs * ww.x * gf[k];
          s += xf[k + 1] * rs * ww.y * gf[k + 1];
          s += xf[k + 2] * rs * ww.z * gf[k + 2];
          s += xf[k + 3] * rs * ww.w * gf[k + 3];
        }
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if constexpr (WPR > 1) {
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
      __syncthreads();
      s = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) s += part[rb * WPR + k];
      __syncthreads();                  // part is rewritten next row
    }
    const float mean = s / (float)D;
    uint4* dr = reinterpret_cast<uint4*>(dx + (size_t)r * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (live && v < nvec) {
        float xf[E], gf[E], wf[E];
        unpack16(xv[i], xf, T());
        unpack16(gv[i], gf, T());
        const float4* w4 = reinterpret_cast<const float4*>(w + v * E);
#pragma unroll
        for (int k = 0; k < E; k += 4) {
          const float4 ww = __ldg(w4 + k / 4);
          wf[k] = ww.x; wf[k + 1] = ww.y; wf[k + 2] = ww.z; wf[k + 3] = ww.w;
        }
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float xhat = xf[k] * rs;
          acc[i][k] += gf[k] * xhat;
          xf[k] = rs * (wf[k] * gf[k] - xhat * mean);
        }
        dr[v] = pack16(xf, T());
      }
    }
  }
  // the block's row groups, in a fixed order
  if constexpr (TPR < 32) {
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < E; ++k)
          acc[i][k] += __shfl_xor_sync(0xffffffffu, acc[i][k], o);
  }
  const int grp = TPR < 32 ? threadIdx.x / 32 : rb;
  const bool lead = TPR >= 32 || threadIdx.x % 32 < TPR;
  float* out = partial + (size_t)blockIdx.x * D;
  if constexpr (NG == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * TPR;
      if (v < nvec)
#pragma unroll
        for (int k = 0; k < E; k += 4)
          *reinterpret_cast<float4*>(out + v * E + k) = make_float4(
              acc[i][k], acc[i][k + 1], acc[i][k + 2], acc[i][k + 3]);
    }
  } else {
    for (int g = 0; g < NG; ++g) {
      if (grp == g && lead) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = t + i * TPR;
          if (v < nvec)
#pragma unroll
            for (int k = 0; k < E; ++k)
              sdw[v * E + k] = (g ? sdw[v * E + k] : 0.f) + acc[i][k];
        }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < D; c += kThreads) out[c] = sdw[c];
  }
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

// Shared memory of the vector backward: one float per column when the
// block's row groups meet there (the widest row of the instance)
template <int TPR, int NV, int E>
constexpr size_t bwd_vec_smem() {
  return TPR < kThreads ? sizeof(float) * TPR * NV * E : 0;
}

template <typename T, int TPR, int NV>
int bwd_vec_blocks(int R) {
  // blocks of this kernel the card keeps resident (asked once: the grid
  // walks the rows with a stride, so any count is correct)
  static const long long room = [] {
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_bwd_vec_kernel<T, TPR, NV>, kThreads,
        bwd_vec_smem<TPR, NV, 16 / sizeof(T)>());
    return (long long)sms * (per_sm > 0 ? per_sm : 1);
  }();
  constexpr int RPB = kThreads / TPR;
  const long long need = ((long long)R + RPB - 1) / RPB;
  return (int)(need < room ? need : room);
}

template <typename T, int TPR, int NV>
int bwd_vec(const T* x, const float* w, const float* rstd, const T* dy,
            T* dx, float* partial, int R, int D, int n_part,
            cudaStream_t st) {
  constexpr size_t smem = bwd_vec_smem<TPR, NV, 16 / sizeof(T)>();
  rmsnorm_bwd_vec_kernel<T, TPR, NV><<<n_part, kThreads, smem, st>>>(
      x, w, rstd, dy, dx, partial, R, D);
  return (int)cudaGetLastError();
}

// The backward's plan: CALL(TPR, NV), the vector path's threads a row
// and vectors a thread for this width, or SCALAR off the vector path.
#define REPRO_RMS_BWD_PLAN(CALL, SCALAR)                                  \
  do {                                                                    \
    if (aligned) {                                                        \
      if (nvec <= 8) CALL(8, 1);                                          \
      if (nvec <= 16) CALL(16, 1);                                        \
      if (nvec <= 32) CALL(32, 1);                                        \
      if (nvec <= 64) CALL(32, 2);                                        \
      if (nvec <= 128) CALL(32, 4);                                       \
      if (nvec <= 256) CALL(64, 4);                                       \
      if (nvec <= 512) CALL(64, 8);                                       \
      if (nvec <= 1024) CALL(128, 8);                                     \
      if (nvec <= 2048) CALL(256, 8);                                     \
    }                                                                     \
    SCALAR;                                                               \
  } while (0)

// Row chunks of the scalar path's dw partials: a function of the shape
// alone, so the summation order (and dw's bits) never change
int scalar_chunks(int R, int D) {
  const int col_blocks = (D + kThreads - 1) / kThreads;
  const int n = 1024 / col_blocks;
  return n < 1 ? 1 : (n < R ? n : R);
}

template <typename T>
int bwd_partials(bool aligned, int R, int D) {
  const int nvec = D / (int)(16 / sizeof(T));
#define REPRO_RMS_BLOCKS(TPR, NV) return bwd_vec_blocks<T, TPR, NV>(R)
  REPRO_RMS_BWD_PLAN(REPRO_RMS_BLOCKS, return scalar_chunks(R, D));
#undef REPRO_RMS_BLOCKS
}

// dx and the dw partials: the vector kernel, or the scalar path's two
template <typename T>
int bwd_dx_partials(const T* x, const float* w, const float* rstd,
                    const T* dy, T* dx, float* partial, bool aligned, int R,
                    int D, int n_part, cudaStream_t st) {
  const int nvec = D / (int)(16 / sizeof(T));
#define REPRO_RMS_VEC(TPR, NV) \
  return bwd_vec<T, TPR, NV>(x, w, rstd, dy, dx, partial, R, D, n_part, st)
  REPRO_RMS_BWD_PLAN(REPRO_RMS_VEC, break);
#undef REPRO_RMS_VEC
  rmsnorm_bwd_dx_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      x, w, rstd, dy, dx, R, D);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rmsnorm_bwd_dw_partial_kernel<T>
      <<<dim3((D + kThreads - 1) / kThreads, n_part), kThreads, 0, st>>>(
          x, rstd, dy, partial, R, D, (R + n_part - 1) / n_part);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const float* w, const float* rstd, const void* dy,
        void* dx, float* dw, float* partial, int R, int D, int n_part,
        cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = D % E == 0 &&
      ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx | (uintptr_t)w) % 16 ==
          0;
  if (n_part != bwd_partials<T>(aligned, R, D))
    return (int)cudaErrorInvalidValue;
  const int rc = bwd_dx_partials<T>(
      static_cast<const T*>(x), w, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, aligned, R, D, n_part, st);
  if (rc) return rc;
  rmsnorm_bwd_dw_sum_kernel<<<(D + 31) / 32, 1024, 0, st>>>(partial, dw, D,
                                                             n_part);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dy, dx). w, rstd, dw and the
// partial buffer are float32. All contiguous: x/y/dy/dx (R, D), w/dw (D,),
// rstd (R,), partial (n_part, D) with n_part = rmsnorm_bwd_partials(..)
// for the same pointers and shape. Each path is a vector path when its
// pointers start on 16-byte boundaries and D is a multiple of the vector
// (8 bf16, 4 float32). Each launcher returns cudaGetLastError().
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

extern "C" int rmsnorm_bwd_partials(const void* x, const void* w,
                                    const void* dy, const void* dx,
                                    int dtype, int R, int D) {
  if (R <= 0 || D <= 0) return 0;
  const uintptr_t p =
      (uintptr_t)x | (uintptr_t)w | (uintptr_t)dy | (uintptr_t)dx;
  if (dtype == 0) return bwd_partials<float>(D % 4 == 0 && p % 16 == 0, R, D);
  if (dtype == 1)
    return bwd_partials<__nv_bfloat16>(D % 8 == 0 && p % 16 == 0, R, D);
  return 0;
}

extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* rstd, const void* dy, void* dx,
                                  void* dw, void* partial, int dtype, int R,
                                  int D, int n_part, void* stream) {
  if (R <= 0 || D <= 0 || n_part <= 0) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* rs = static_cast<const float*>(rstd);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, wf, rs, dy, dx, dwf, pf, R, D, n_part, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, wf, rs, dy, dx, dwf, pf, R, D, n_part,
                              st);
  return (int)cudaErrorInvalidValue;
}
