// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd
//   (Pallas body _flash_kernel). The TPU kernel has no backward (JAX
//   differentiates the dense jnp attention); the backward here is new, so
//   that the training path's attention gradients run on hand-written
//   kernels too.
//
// Computes, for batch b, query head h (reading KV head h / (H / Hkv)) and
// query row i, softmax(scale * q_i . K^T) V with scale = 1 / sqrt(hd).
// Causal masking keeps keys j <= i, both counted from position 0 (the
// TPU kernel's top-left alignment, also when Sq != Sk). Masked logits are
// the reference's -1e30 and add exactly zero; m, l and acc are float32;
// the output is acc / max(l, 1e-30) in q's dtype, and the float32
// log-sum-exp lse_i = m_i + log(l_i) is written for the backward.
//
// Backward (FlashAttention-2 order, no atomics):
//   1. row term   delta_i = sum_d dO_id * O_id
//   2. dK/dV      one block per (key tile, KV head, b); it loops over the g
//                 query heads of its KV head and over the query tiles that
//                 can see the tile, recomputes P = exp(scale * Q K^T - lse),
//                 and sums dV = P^T dO and dK = scale * dS^T Q with
//                 dS = P * (dO V^T - delta) in registers. The GQA sum over
//                 the g heads happens inside the block, in a fixed order.
//   3. dQ         one block per (query tile, head, b): dQ = scale * dS K.
// Every sum has a fixed order, so the gradients are bit-identical from run
// to run.
//
// What bounds it on the H100: operations. At the training shape (S = 4096,
// hd = 128) the forward does 4 x Sq x Sk x hd flops per head (halved when
// causal) against a few bytes per element of q, k, v and o; the tensor
// cores' bf16 rate is the bound. This first version computes on the CUDA
// cores in float32 (register-tiled: each thread owns a 4 x 2 tile of the
// score block and a 4 x hd/16 tile of the accumulator), not with wgmma.
//
// Design. The TPU kernel walks key blocks on a sequential grid axis with
// m/l/acc in VMEM scratch; here the walk is a loop inside one block per
// (query tile, head, b), and blocks run in parallel. Tiles are staged in
// shared memory as float32, rows padded by one float so that column walks
// hit distinct banks. Edge tiles are masked (any Sq, Sk > 0 work; rows and
// keys past the end are zero and never stored). Causal blocks skip key
// tiles past their last row, and the grid walks the heaviest query tiles
// first. Later work: bf16 tiles, wgmma with TMA-fed shared-memory rings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reductions over the 16 lanes that share a ty (one half-warp)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + rows) of a (S, heads, HD) slab starting at base
// (position stride heads * HD) into shared memory with row pitch `pitch`,
// times `mul`; rows at or past S read as zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ base,
                                          size_t pos_stride, int row0,
                                          int rows, int S, float mul) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int s = row0 + r;
    dst[r * pitch + d] =
        s < S ? to_f32(base[(size_t)s * pos_stride + d]) * mul : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kFwdBQ = 64;  // query rows per block (4 per ty)
constexpr int kFwdBK = 32;  // keys per tile (2 per tx)

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kFwdBQ * (HD + 1) + kFwdBK * (HD + 1) +
                          kFwdBK * HD + kFwdBQ * (kFwdBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int QP = HD + 1, PP = kFwdBK + 1, kC = HD / 16;
  float* sQ = smem;                 // [kFwdBQ][QP]
  float* sK = sQ + kFwdBQ * QP;     // [kFwdBK][QP]
  float* sV = sK + kFwdBK * QP;     // [kFwdBK][HD]
  float* sP = sV + kFwdBK * HD;     // [kFwdBQ][PP]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdBQ;  // heavy tiles first
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = (size_t)H * HD, ks = (size_t)Hkv * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Sk * Hkv + hk) * HD;
  const T* vb = v + ((size_t)b * Sk * Hkv + hk) * HD;

  // query rows pre-scaled, as the TPU kernel does (q * scale, then q . k)
  load_rows<T, HD>(sQ, QP, qb, qs, q0, kFwdBQ, Sq, scale);

  float acc[4][kC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + kFwdBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += kFwdBK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HD>(sK, QP, kb, ks, k0, kFwdBK, Sk, 1.f);
    load_rows<T, HD>(sV, HD, vb, ks, k0, kFwdBK, Sk, 1.f);
    __syncthreads();

    float s[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[2];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || qpos >= kpos);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      float p[2], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - mx) : 0.f;
        sum += p[j];
      }
      sum = half_sum(sum);
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 2; ++j) sP[(ty * 4 + i) * PP + tx + 16 * j] = p[j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFwdBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = sV[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + ty * 4 + i;
    if (sq >= Sq) continue;
    T* orow = o + (((size_t)b * Sq + sq) * H + h) * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c) store(&orow[tx + 16 * c], acc[i][c] / den);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + sq] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward 1: delta = rowsum(dO * O), one warp per (b, position, head) row
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // r = (b * Sq + s) * H + h
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc += to_f32(dO[(size_t)r * HD + d]) * to_f32(o[(size_t)r * HD + d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const int h = r % H, s = (r / H) % Sq, b = r / (H * Sq);
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// Backward 2: dK, dV
// ---------------------------------------------------------------------------

constexpr int kKvBK = 64;  // keys per block (4 per ty)
constexpr int kKvBQ = 32;  // query rows per inner tile (2 per tx)

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * kKvBK * (HD + 1) + 2 * kKvBQ * (HD + 1) +
                          2 * kKvBK * (kKvBQ + 1) + 2 * kKvBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                      int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int RP = HD + 1, PP = kKvBQ + 1, kC = HD / 16;
  float* sK = smem;                 // [kKvBK][RP]
  float* sV = sK + kKvBK * RP;      // [kKvBK][RP]
  float* sQ = sV + kKvBK * RP;      // [kKvBQ][RP]
  float* sdO = sQ + kKvBQ * RP;     // [kKvBQ][RP]
  float* sP = sdO + kKvBQ * RP;     // [kKvBK][PP]  P^T
  float* sdS = sP + kKvBK * PP;     // [kKvBK][PP]  dS^T
  float* sL = sdS + kKvBK * PP;     // [kKvBQ]
  float* sD = sL + kKvBQ;           // [kKvBQ]

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * kKvBK;
  const int g = H / Hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = (size_t)H * HD, ks = (size_t)Hkv * HD;
  const size_t kvoff = ((size_t)b * Sk * Hkv + hk) * HD;

  load_rows<T, HD>(sK, RP, k + kvoff, ks, k0, kKvBK, Sk, 1.f);
  load_rows<T, HD>(sV, RP, v + kvoff, ks, k0, kKvBK, Sk, 1.f);

  float adk[4][kC], adv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int qt0 = causal ? (k0 / kKvBQ) * kKvBQ : 0;
  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const size_t qoff = ((size_t)b * Sq * H + h) * HD;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* drow = delta + ((size_t)b * H + h) * Sq;
    for (int qt = qt0; qt < Sq; qt += kKvBQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, HD>(sQ, RP, q + qoff, qs, qt, kKvBQ, Sq, 1.f);
      load_rows<T, HD>(sdO, RP, dO + qoff, qs, qt, kKvBQ, Sq, 1.f);
      if (threadIdx.x < kKvBQ) {
        const int sq = qt + threadIdx.x;
        sL[threadIdx.x] = sq < Sq ? lrow[sq] : 0.f;
        sD[threadIdx.x] = sq < Sq ? drow[sq] : 0.f;
      }
      __syncthreads();

      float st[4][2] = {}, dpt[4][2] = {};
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[2], dov[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty * 4 + i) * RP + d];
          vv[i] = sV[(ty * 4 + i) * RP + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = sQ[(tx + 16 * j) * RP + d];
          dov[j] = sdO[(tx + 16 * j) * RP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * dov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qj = tx + 16 * j, qpos = qt + qj;
          const bool ok = kpos < Sk && qpos < Sq && (!causal || qpos >= kpos);
          const float p = ok ? expf(st[i][j] * scale - sL[qj]) : 0.f;
          sP[(ty * 4 + i) * PP + qj] = p;
          sdS[(ty * 4 + i) * PP + qj] = p * (dpt[i][j] - sD[qj]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kKvBQ; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * PP + qq];
          dsv[i] = sdS[(ty * 4 + i) * PP + qq];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float dov = sdO[qq * RP + tx + 16 * c];
          const float qv = sQ[qq * RP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            adv[i][c] += pv[i] * dov;
            adk[i][c] += dsv[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Sk) continue;
    const size_t row = kvoff + (size_t)kpos * ks;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store(&dk[row + tx + 16 * c], adk[i][c] * scale);
      store(&dv[row + tx + 16 * c], adv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 3: dQ
// ---------------------------------------------------------------------------

constexpr int kQBQ = 64;  // query rows per block (4 per ty)
constexpr int kQBK = 32;  // keys per tile (2 per tx)

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kQBQ * (HD + 1) + 2 * kQBK * (HD + 1) +
                          kQBQ * (kQBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, int causal,
                    float scale) {
  extern __shared__ float smem[];
  constexpr int RP = HD + 1, PP = kQBK + 1, kC = HD / 16;
  float* sQ = smem;                 // [kQBQ][RP]
  float* sdO = sQ + kQBQ * RP;      // [kQBQ][RP]
  float* sK = sdO + kQBQ * RP;      // [kQBK][RP]
  float* sV = sK + kQBK * RP;       // [kQBK][RP]
  float* sdS = sV + kQBK * RP;      // [kQBQ][PP]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQBQ;  // heavy tiles first
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = (size_t)H * HD, ks = (size_t)Hkv * HD;
  const size_t qoff = ((size_t)b * Sq * H + h) * HD;
  const size_t kvoff = ((size_t)b * Sk * Hkv + hk) * HD;

  load_rows<T, HD>(sQ, RP, q + qoff, qs, q0, kQBQ, Sq, 1.f);
  load_rows<T, HD>(sdO, RP, dO + qoff, qs, q0, kQBQ, Sq, 1.f);
  float L[4], Dl[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + ty * 4 + i;
    L[i] = sq < Sq ? lse[((size_t)b * H + h) * Sq + sq] : 0.f;
    Dl[i] = sq < Sq ? delta[((size_t)b * H + h) * Sq + sq] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  const int q_last = min(q0 + kQBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += kQBK) {
    __syncthreads();
    load_rows<T, HD>(sK, RP, k + kvoff, ks, k0, kQBK, Sk, 1.f);
    load_rows<T, HD>(sV, RP, v + kvoff, ks, k0, kQBK, Sk, 1.f);
    __syncthreads();

    float s[4][2] = {}, dp[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * RP + d];
        dov[i] = sdO[(ty * 4 + i) * RP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = sK[(tx + 16 * j) * RP + d];
        vv[j] = sV[(tx + 16 * j) * RP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < Sq && kpos < Sk && (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - L[i]) : 0.f;
        sdS[(ty * 4 + i) * PP + tx + 16 * j] = p * (dp[i][j] - Dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kQBK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kv = sK[kk * RP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += dsv[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + ty * 4 + i;
    if (sq >= Sq) continue;
    T* row = dq + qoff + (size_t)sq * qs;
#pragma unroll
    for (int c = 0; c < kC; ++c) store(&row[tx + 16 * c], acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int Sq, int Sk, int H, int Hkv, int causal, float scale,
        cudaStream_t st) {
  constexpr size_t smem = fwd_smem<HD>();
  int rc = prepare(flash_fwd_kernel<T, HD>, smem);
  if (rc) return rc;
  const dim3 grid((Sq + kFwdBQ - 1) / kFwdBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dO, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int Sq, int Sk, int H, int Hkv, int causal,
        float scale, cudaStream_t st) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *dOt = static_cast<const T*>(dO);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T, HD>
      <<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
          static_cast<const T*>(o), dOt, delta, rows, Sq, H);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  constexpr size_t smem_kv = dkdv_smem<HD>();
  rc = prepare(flash_bwd_dkdv_kernel<T, HD>, smem_kv);
  if (rc) return rc;
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3((Sk + kKvBK - 1) / kKvBK, Hkv, B), kThreads, smem_kv, st>>>(
          qt, kt, vt, dOt, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Sk, H, Hkv, causal, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;

  constexpr size_t smem_q = dq_smem<HD>();
  rc = prepare(flash_bwd_dq_kernel<T, HD>, smem_q);
  if (rc) return rc;
  flash_bwd_dq_kernel<T, HD>
      <<<dim3((Sq + kQBQ - 1) / kQBQ, H, B), kThreads, smem_q, st>>>(
          qt, kt, vt, dOt, lse, delta, static_cast<T*>(dq), Sq, Sk, H, Hkv,
          causal, scale);
  return (int)cudaGetLastError();
}

#define REPRO_FA_DISPATCH(FN, ...)                                         \
  switch (hd) {                                                            \
    case 16: return FN<T, 16>(__VA_ARGS__);                                \
    case 32: return FN<T, 32>(__VA_ARGS__);                                \
    case 64: return FN<T, 64>(__VA_ARGS__);                                \
    case 128: return FN<T, 128>(__VA_ARGS__);                              \
    default: return (int)cudaErrorInvalidValue;                            \
  }

template <typename T>
int fwd_hd(int hd, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal,
           float scale, cudaStream_t st) {
  REPRO_FA_DISPATCH(fwd, q, k, v, o, lse, B, Sq, Sk, H, Hkv, causal, scale,
                    st)
}

template <typename T>
int bwd_hd(int hd, const void* q, const void* k, const void* v,
           const void* o, const void* dO, const float* lse, float* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
           int Hkv, int causal, float scale, cudaStream_t st) {
  REPRO_FA_DISPATCH(bwd, q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk,
                    H, Hkv, causal, scale, st)
}
#undef REPRO_FA_DISPATCH

bool bad_shape(int B, int Sq, int Sk, int H, int Hkv) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO, dq, dk, dv). Layouts
// (all contiguous): q/o/dO/dq (B, Sq, H, hd); k/v/dk/dv (B, Sk, Hkv, hd);
// lse/delta (B, H, Sq) float32. hd is one of 16, 32, 64, 128. Each returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int dtype, int B, int Sq, int Sk,
                                          int H, int Hkv, int hd, int causal,
                                          float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_hd<float>(hd, q, k, v, o, l, B, Sq, Sk, H, Hkv, causal, scale,
                         st);
  if (dtype == 1)
    return fwd_hd<__nv_bfloat16>(hd, q, k, v, o, l, B, Sq, Sk, H, Hkv,
                                 causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int Hkv, int hd,
    int causal, float scale, void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_hd<float>(hd, q, k, v, o, dO, l, dl, dq, dk, dv, B, Sq, Sk, H,
                         Hkv, causal, scale, st);
  if (dtype == 1)
    return bwd_hd<__nv_bfloat16>(hd, q, k, v, o, dO, l, dl, dq, dk, dv, B, Sq,
                                 Sk, H, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
