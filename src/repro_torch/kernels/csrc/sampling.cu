// Sort-free top-k / top-p logit mask for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/sampling.py, topk_topp_mask_pallas
//   (Pallas body _sampling_kernel over _mask_rows, _search_kth,
//   _search_nucleus).
//
// Computes, per row: u = sortable uint32 encoding of each float32 logit
// (strictly monotone for finite values); tau_k = the largest threshold
// with count(u >= tau_k) >= k (k <= 0 disables, clipped to [1, V]);
// m = max of the top-k survivors, e = exp(masked - m), p_z = p * sum(e);
// tau_p = the smallest threshold with mass(u > tau_p) < p_z; then keeps
// x where u >= max(tau_k, tau_p), bit-unchanged, and writes -1e30
// elsewhere. The arithmetic is the reference's, step for step,
// including the overflow-free uint32 midpoints.
//
// What bounds it on the H100: one read and one write of B x V x 4 bytes
// over 3.35 TB/s (about 1.5 us for B = 8, V = 151936). This first
// version is far from that: each of the 32 + 32 search steps is a
// block-wide count or mass reduction over the whole row, plus one max
// pass, one sum pass and the masked write, so it reads the row about 66
// times (from L2: a 600 KB row does not fit in shared memory), and it
// runs one block per row, so a batch of 8 rows uses 8 of 132 SMs.
//
// Design. One 1024-thread block per row; each thread strides over the
// row with coalesced loads, reduces in registers, then warp shuffles
// and one shared-memory stage give every thread the block total, so all
// threads take the same branch of the search. The sums are in a fixed
// tree order (deterministic), which is not the vocab order of the
// reference: a token whose cumulative nucleus mass lies within float
// rounding of p can flip — that is the stated kernel-vs-plain tolerance.
// Later work: split each row over a thread-block cluster whose
// distributed shared memory holds the row (4 x 150 KB), and a radix
// select in place of the bitwise binary search.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t sortable(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T* scratch, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                      // scratch may still be read
  if (lane == 0) scratch[w] = v;
  __syncthreads();
  v = scratch[lane];                    // kWarps == 32 == warp size
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

__global__ void __launch_bounds__(kThreads)
topk_topp_mask_kernel(const float* __restrict__ logits,
                      const int* __restrict__ top_ks,
                      const float* __restrict__ top_ps,
                      float* __restrict__ out, int V) {
  __shared__ int si[kWarps];
  __shared__ float sf[kWarps];
  const int b = blockIdx.x;
  const float* x = logits + (size_t)b * V;
  float* o = out + (size_t)b * V;
  const int tid = threadIdx.x;

  const int k = top_ks[b];
  const int k_eff = min(max(k <= 0 ? V : k, 1), V);

  // tau_k: largest threshold keeping >= k_eff values
  uint32_t lo = 0u, hi = 0xFFFFFFFFu;
  for (int it = 0; it < 32; ++it) {
    const uint32_t span = hi - lo;
    const uint32_t mid = lo + (span >> 1) + (span & 1u);
    int cnt = 0;
    for (int i = tid; i < V; i += kThreads) cnt += sortable(x[i]) >= mid;
    cnt = block_reduce(cnt, si, Add());
    if (cnt >= k_eff) lo = mid; else hi = mid - 1u;
  }
  const uint32_t tau_k = lo;

  float m = kMasked;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = x[i];
    m = fmaxf(m, sortable(xi) >= tau_k ? xi : kMasked);
  }
  m = block_reduce(m, sf, Max());
  float z = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float xi = x[i];
    z += expf((sortable(xi) >= tau_k ? xi : kMasked) - m);
  }
  z = block_reduce(z, sf, Add());
  const float p_z = top_ps[b] * z;

  // tau_p: smallest threshold whose strictly-greater mass is < p_z
  lo = 0u;
  hi = 0xFFFFFFFFu;
  for (int it = 0; it < 32; ++it) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    float mass = 0.f;
    for (int i = tid; i < V; i += kThreads) {
      const float xi = x[i];
      const uint32_t u = sortable(xi);
      if (u > mid) mass += expf((u >= tau_k ? xi : kMasked) - m);
    }
    mass = block_reduce(mass, sf, Add());
    if (mass < p_z) hi = mid; else lo = mid + 1u;
  }
  const uint32_t tau = max(tau_k, hi);

  for (int i = tid; i < V; i += kThreads) {
    const float xi = x[i];
    o[i] = sortable(xi) >= tau ? xi : kMasked;
  }
}

}  // namespace

// logits/out (B, V) float32, top_ks (B,) int32, top_ps (B,) float32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int topk_topp_mask_launch(const void* logits, const void* top_ks,
                                     const void* top_ps, void* out, int B,
                                     int V, void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  topk_topp_mask_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(top_ks),
      static_cast<const float*>(top_ps), static_cast<float*>(out), V);
  return (int)cudaGetLastError();
}
