// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attention.py,
//   paged_flash_attention_bhsd (Pallas body _paged_flash_kernel).
//
// Computes, for every slot b, query head h and query row i (absolute
// position lengths[b] + i), softmax attention over the slot's keys
// 0 .. lengths[b] + i read through the page table:
//   key j lives at pool row page_table[b, j / page_size] * page_size
//   + j % page_size of KV head h / (H / Hkv).
// One mask `kpos <= qpos` covers causality and staleness (rows past a
// slot's written length), masked logits are -1e30 (never -inf), m, l and
// acc are float32, and the output is acc / max(l, 1e-30) — the
// reference's numerics.
//
// What bounds it on the H100: at decode (S = 1) the bytes of the live
// K/V pages, B x live tokens x Hkv x hd x 2 (K and V) x itemsize, over
// 3.35 TB/s; the arithmetic is 4 x hd flops per key per query row, far
// below the tensor-core line. At prefill (S = a bucket of up to 512) it
// is the score and value products, which this first version runs on the
// CUDA cores in float32, not on wgmma.
//
// Design. The TPU kernel walks its page axis as a sequential grid
// dimension carrying m/l/acc in VMEM scratch; here that walk is a loop
// inside the block, and blocks run in parallel over (query tile, KV
// head, slot). A block owns up to kRows query rows, which are the
// (position, head) pairs of the g = H / Hkv query heads sharing one KV
// head, so every K/V row is read from device memory once per group, not
// once per query head. Each block reads page_table[b, .] and lengths[b]
// itself (nothing is prefetched) and stops at the last key its own last
// row can see, which is the reference's dead-page skip tightened to the
// tile; masked keys contribute exactly zero, so the result does not
// depend on where the walk stops. Keys are walked in chunks of kKeys
// rows (any page size works: each key resolves its own page), staged in
// shared memory as float32, with the online-softmax fold per chunk.
// Later work: cp.async/TMA staging, wgmma for prefill, split-K over
// pages for long contexts at small batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;   // query rows (position x head) per block
constexpr int kKeys = 16;   // keys per shared-memory chunk
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                       const T* __restrict__ pv,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int S, int H, int Hkv, int page_size, int P,
                       float scale) {
  __shared__ float sq[kRows][HD];
  __shared__ float sk[kKeys][HD + 1];   // +1: score loop reads columns
  __shared__ float sv[kKeys][HD];
  __shared__ float sacc[kRows][HD];
  __shared__ float sp[kRows][kKeys];
  __shared__ float sm[kRows], sl[kRows], scorr[kRows];

  const int b = blockIdx.z;
  const int hkv = blockIdx.y;
  const int g = H / Hkv;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, S * g - row0);
  const int len = lengths[b];
  const int tid = threadIdx.x;
  const int* table = page_table + (size_t)b * P;

  // query rows, pre-scaled like the TPU kernel (q * scale, then q . k)
  for (int e = tid; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int s = (row0 + r) / g, h = hkv * g + (row0 + r) % g;
    sq[r][d] = to_f32(q[((size_t)(b * S + s) * H + h) * HD + d]) * scale;
    sacc[r][d] = 0.f;
  }
  if (tid < kRows) {
    sm[tid] = kMasked;
    sl[tid] = 0.f;
  }
  // keys this tile can see: up to its last row's absolute position
  const int last_qpos = len + (row0 + rows - 1) / g;
  const int n_keys = min(P * page_size, last_qpos + 1);
  __syncthreads();

  for (int j0 = 0; j0 < n_keys; j0 += kKeys) {
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int jj = e / HD, d = e % HD;
      const int j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < n_keys) {
        const size_t row =
            (size_t)table[j / page_size] * page_size + j % page_size;
        const size_t off = (row * Hkv + hkv) * HD + d;
        kv = to_f32(pk[off]);
        vv = to_f32(pv[off]);
      }
      sk[jj][d] = kv;
      sv[jj][d] = vv;
    }
    __syncthreads();

    for (int e = tid; e < rows * kKeys; e += kThreads) {
      const int r = e / kKeys, jj = e % kKeys;
      const int j = j0 + jj;
      const int qpos = len + (row0 + r) / g;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += sq[r][d] * sk[jj][d];
      sp[r][jj] = (j < n_keys && j <= qpos) ? dot : kMasked;
    }
    __syncthreads();

    if (tid < rows) {
      const float m_prev = sm[tid];
      float mx = m_prev;
      for (int jj = 0; jj < kKeys; ++jj) mx = fmaxf(mx, sp[tid][jj]);
      float sum = 0.f;
      for (int jj = 0; jj < kKeys; ++jj) {
        const float p = expf(sp[tid][jj] - mx);
        sp[tid][jj] = p;
        sum += p;
      }
      const float corr = expf(m_prev - mx);
      sl[tid] = sl[tid] * corr + sum;
      sm[tid] = mx;
      scorr[tid] = corr;
    }
    __syncthreads();

    for (int e = tid; e < rows * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      float a = sacc[r][d] * scorr[r];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) a += sp[r][jj] * sv[jj][d];
      sacc[r][d] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int s = (row0 + r) / g, h = hkv * g + (row0 + r) % g;
    store(&out[((size_t)(b * S + s) * H + h) * HD + d],
          sacc[r][d] / fmaxf(sl[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* lengths, void* out, int B, int S, int H, int Hkv,
           int hd, int page_size, int P, float scale, cudaStream_t stream) {
  const dim3 grid((S * (H / Hkv) + kRows - 1) / kRows, Hkv, B);
#define REPRO_PA_LAUNCH(HDV)                                              \
  paged_attention_kernel<T, HDV><<<grid, kThreads, 0, stream>>>(          \
      static_cast<const T*>(q), static_cast<const T*>(pk),                \
      static_cast<const T*>(pv), table, lengths, static_cast<T*>(out), S, \
      H, Hkv, page_size, P, scale)
  switch (hd) {
    case 16: REPRO_PA_LAUNCH(16); break;
    case 32: REPRO_PA_LAUNCH(32); break;
    case 64: REPRO_PA_LAUNCH(64); break;
    case 128: REPRO_PA_LAUNCH(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Layouts (all contiguous):
// q/out (B, S, H, hd); pk/pv (n_pages, page_size, Hkv, hd);
// page_table (B, P) int32; lengths (B,) int32. Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* pk,
                                      const void* pv, const void* page_table,
                                      const void* lengths, void* out,
                                      int dtype, int B, int S, int H, int Hkv,
                                      int hd, int page_size, int P,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      page_size <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pk, pv, table, lens, out, B, S, H, Hkv, hd,
                         page_size, P, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, table, lens, out, B, S, H, Hkv,
                                 hd, page_size, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
