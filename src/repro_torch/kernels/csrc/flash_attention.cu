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
// TPU kernel's top-left alignment, also when Sq != Sk). Masked logits add
// exactly zero (the reference's -1e30); m, l and acc are float32; the
// output is acc / l in q's dtype, and the float32 log-sum-exp
// lse_i = m_i + log(l_i) is written for the backward.
//
// Backward (FlashAttention-2 order, no atomics):
//   1. row term   delta_i = sum_d dO_id * O_id
//   2. dK/dV      one block per (key tile, KV head, b); it loops over the g
//                 query heads of its KV head and over the query tiles that
//                 can see the tile, recomputes P = exp(scale * Q K^T - lse),
//                 and sums dV = P^T dO and dK = scale * dS^T Q with
//                 dS = P * (dO V^T - delta). The GQA sum over the g heads
//                 happens inside the block, in a fixed order.
//   3. dQ         one block per (query tile, head, b): dQ = scale * dS K.
// Every sum has a fixed order, so the gradients are bit-identical from run
// to run.
//
// What bounds it on the H100: operations. At the training shape (S = 4096,
// hd = 128, causal) the forward needs 4 x hd flops per visible (query, key)
// pair and the backward 10 x hd, against a few bytes per element of q, k,
// v, o and their gradients: the bf16 tensor-core rate is the bound, and the
// CUDA cores' float32 rate lies far below it.
//
// Design, by dtype (the launcher dispatches on it; nothing else chooses):
//
// bfloat16 -- the tensor cores (namespace tc). Each kernel runs a producer
//   warpgroup, one thread of which issues the loads, and two consumer
//   warpgroups. Tiles come by TMA straight from the model layout (B, S,
//   heads, hd), read as 4-D tensor maps (hd, heads, S, B) with the 128-byte
//   swizzle, into rings of shared-memory stages guarded by mbarriers; TMA's
//   zero fill covers ragged edges. Consumers multiply with wgmma (bf16 in,
//   float32 accumulators in registers):
//   - forward, one block per (128 query rows, head, b), heavy tiles first,
//     64 rows per warpgroup: S = Q K^T from shared memory, the online
//     softmax in registers (base 2, the scale applied to S in float32),
//     then O += P V with P fed from registers as a bf16 high part and a
//     bf16 remainder (two products: one bf16 rounding of P moves rows that
//     see few keys past the output tolerance) and V read as a transposed
//     operand;
//   - dK/dV, one block per (64 keys, KV head, b): both warpgroups walk the
//     same query tiles; one sums dV += P^T dO, the other dK += dS^T Q, with
//     P^T and dS^T rounded to bf16 in registers as the left operand (both
//     recompute S^T = K Q^T; the dK side also dP^T = V dO^T);
//   - dQ, one block per (128 query rows, head, b): S = Q K^T, dP = dO V^T,
//     dQ += dS K with dS from registers.
//   Causal blocks stop at their last visible tile and mask only the
//   diagonal and ragged tiles element by element. Work done per visible
//   pair, against the 4 x hd (forward) and 10 x hd (backward) of the bound:
//   6 x hd forward (P V twice) and 16 x hd backward (S^T twice and dP^T in
//   dK/dV, S and dP again in dQ).
//
// float32 -- the CUDA cores, the first design of this file, kept because
//   the tensor cores have no full-float32 product (TF32 would break the
//   float32 tolerance): register-tiled (each thread owns a 4 x 2 tile of
//   the score block and a 4 x hd/16 tile of the accumulator), tiles staged
//   in shared memory as float32 with rows padded by one float so that
//   column walks hit distinct banks, edge tiles masked, the heaviest query
//   tiles first.

#include <cuda.h>  // CUtensorMap; the encoder is looked up in the driver
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
// bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// Shared-memory tiles are bf16 in 64-column chunks of 128-byte rows, each
// chunk [rows][64] written by one TMA box with the 128-byte swizzle, so that
// wgmma reads them through descriptors of layout type SWIZZLE_128B:
//   K-major operand (Q, K, dO as the left or the un-transposed right
//     operand): 8-row atoms 1024 bytes apart (SBO), a k16 step moves the
//     start address 32 bytes along the row;
//   MN-major operand (V, K, Q, dO as the transposed right operand): 8-row
//     atoms along the reduction dimension 1024 bytes apart (SBO), 64-column
//     chunks rows x 128 bytes apart (LBO), a k16 step moves 16 rows.
// Head dims below 64 read as 64 (TMA fills the columns past hd with zeros,
// which add nothing to any product; they are never stored).
//
// Every kernel runs a producer warpgroup, one thread of which issues the
// TMA loads, and two consumer warpgroups. The role is read through a
// shuffle, so that the compiler sees it uniform per warpgroup: behind a
// branch it cannot prove so (a lone producer warp), ptxas serialises every
// wgmma. Stages of a ring are guarded by "full" mbarriers (TMA bytes
// arrived) and "empty" mbarriers (all 256 consumer threads done with it).

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1LL << 35;  // seconds: past any launch

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of the given parity to complete. A protocol fault
// would hang the card; after kHangCycles the kernel traps instead, and the
// launch reports an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(a, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// one TMA box of a (B, S, heads, hd) tensor: columns c0.., head, rows r0..
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int head,
                                         int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(head), "r"(r0), "r"(b)
      : "memory");
}

// a rows x HDP tile as HDP / 64 boxes, all completing on one barrier
template <int HDP>
__device__ __forceinline__ void tma_tile(bf16* dst, int rows,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int head, int r0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < HDP / 64; ++c)
    tma_load(dst + c * rows * 64, map, bar, 64 * c, head, r0, b);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major tile chunked [HDP/64][rows][64]: the k16 step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
// MN-major tile chunked [HDP/64][rows][64], reduced over rows: step kk
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows,
                                            int kk) {
  return desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep reads of an accumulator after the wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}
// columns 16 kk .. 16 kk + 15 of an accumulator as the A fragment of a k16
// step (for 16-bit types the two layouts coincide)
template <int N>
__device__ __forceinline__ void a_frag(const float (&d)[N], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack(d[8 * kk + 2 * r],
                                          d[8 * kk + 2 * r + 1]);
}
// the same, split into a bf16 high part and the bf16 of the remainder
template <int N>
__device__ __forceinline__ void a_frag_split(const float (&d)[N], int kk,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x = d[8 * kk + 2 * r], y = d[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack(x - __low2float(h), y - __high2float(h));
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// store a 64 x HDP accumulator (times mul) as bf16 rows of a (.., heads,
// hd) tensor: row r of the tile goes to base + r * row_stride; rows at or
// past n_rows and columns at or past hd are skipped
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, size_t row_stride,
                                           const float (&d)[N], int row0,
                                           int n_rows, int hd, float mul0,
                                           float mul1) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= n_rows) continue;
    const float mul = i ? mul1 : mul0;
    bf16* row = base + (size_t)r * row_stride;
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            d[4 * c + 2 * i] * mul, d[4 * c + 2 * i + 1] * mul);
    }
  }
}

// D(64 x 64) (+)= A(64 x 16, shared, K-major) * B(16 x 64, shared, K-major)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128) (+)= A(64 x 16, shared, K-major) * B(16 x 128, shared, K-major)
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D(64 x 128) += A(64 x 16, registers) * B(16 x 128, shared, MN-major)
__device__ __forceinline__ void mma_rs(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


// ---- forward ---------------------------------------------------------------

template <int HDP>
struct Fwd {
  static constexpr int BM = 128, BN = 128, kStages = 2;
  static constexpr uint32_t kQBytes = BM * HDP * 2, kKVBytes = BN * HDP * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
           float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hd,
           int causal, float scale) {
  using F = Fwd<HDP>;
  constexpr int BM = F::BM, BN = F::BN, kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // [HDP/64][BM][64]
  bf16* sK = sQ + BM * HDP;                     // [stage][HDP/64][BN][64]
  bf16* sV = sK + kStages * BN * HDP;           // [stage][HDP/64][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * BN * HDP);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy tiles first
  const int hk = h / (H / Hkv);
  const int q_last = min(q0 + BM, Sq) - 1;
  const int n_tiles = ((causal ? min(Sk, q_last + 1) : Sk) + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumers / 128) {  // producer warpgroup
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, F::kQBytes);
      tma_tile<HDP>(sQ, BM, &tm_q, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], F::kKVBytes);
        tma_tile<HDP>(sK + s * BN * HDP, BN, &tm_k, &k_full[s], hk, t * BN,
                      b);
        mbar_expect_tx(&v_full[s], F::kKVBytes);
        tma_tile<HDP>(sV + s * BN * HDP, BN, &tm_v, &v_full[s], hk, t * BN,
                      b);
      }
    }
    return;
  }

  const int wg = role;
  const int rw0 = q0 + 64 * wg;                     // the warpgroup's rows
  const int row0 = rw0 + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const uint32_t q_tile = smem_u32(sQ) + wg * 64 * 128;
  const float sl = scale * kLog2e;  // softmax in base 2 on scaled logits
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t ph = (t / kStages) & 1;
    const int k0 = t * BN;
    const uint32_t k_tile = smem_u32(sK + s * BN * HDP);
    const uint32_t v_tile = smem_u32(sV + s * BN * HDP);

    float sc[BN / 2];
    mbar_wait(&k_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      mma_ss(sc, desc_k(q_tile, BM, kk), desc_k(k_tile, BN, kk), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // only the diagonal tile and the ragged last one are masked
    const bool masked = (causal && k0 + BN - 1 > rw0) || k0 + BN > Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = sc[4 * c + 2 * i + j] * sl;
          if (masked) {
            const int col = k0 + 8 * c + 2 * (lane % 4) + j;
            if (col >= Sk || (causal && col > row)) x = -INFINITY;
          }
          sc[4 * c + 2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);  // finite: every row sees key 0 in tile 0
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2f(sc[4 * c + 2 * i + j] - mx);
          sc[4 * c + 2 * i + j] = p;
          sum += p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < HDP / 8; ++c) {
        acc[4 * c + 2 * i] *= corr;
        acc[4 * c + 2 * i + 1] *= corr;
      }
    }

    // O += P V with P as bf16 high part plus bf16 remainder: one bf16
    // rounding of P moves rows that see few keys past the output tolerance
    mbar_wait(&v_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_frag_split(sc, kk, hi, lo);
      const uint64_t dv = desc_mn(v_tile, BN, kk);
      mma_rs(acc, hi, dv, 1);
      mma_rs(acc, lo, dv, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    inv[i] = 1.f / li;
    const int row = row0 + 8 * i;
    if (lane % 4 == 0 && row < Sq)
      lse[((size_t)blockIdx.z * H + h) * Sq + row] =
          (m[i] + log2f(li)) * 0.6931471805599453f;
  }
  store_rows(o + ((size_t)b * Sq * H + h) * hd, (size_t)H * hd, acc, row0,
             Sq, hd, inv[0], inv[1]);
}

// ---- backward: dQ ----------------------------------------------------------

template <int HDP>
struct Dq {
  static constexpr int BM = 128, BN = 64, kStages = 3;
  static constexpr uint32_t kQBytes = 2 * BM * HDP * 2;  // Q and dO
  static constexpr uint32_t kKVBytes = BN * HDP * 2;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, int hd,
          int causal, float scale) {
  using F = Dq<HDP>;
  constexpr int BM = F::BM, BN = F::BN, kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // [HDP/64][BM][64]
  bf16* sdO = sQ + BM * HDP;                    // [HDP/64][BM][64]
  bf16* sK = sdO + BM * HDP;                    // [stage][HDP/64][BN][64]
  bf16* sV = sK + kStages * BN * HDP;           // [stage][HDP/64][BN][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * BN * HDP);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy tiles first
  const int hk = h / (H / Hkv);
  const int q_last = min(q0 + BM, Sq) - 1;
  const int n_tiles = ((causal ? min(Sk, q_last + 1) : Sk) + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumers / 128) {  // producer warpgroup
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, F::kQBytes);
      tma_tile<HDP>(sQ, BM, &tm_q, q_full, h, q0, b);
      tma_tile<HDP>(sdO, BM, &tm_do, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], F::kKVBytes);
        tma_tile<HDP>(sK + s * BN * HDP, BN, &tm_k, &k_full[s], hk, t * BN,
                      b);
        mbar_expect_tx(&v_full[s], F::kKVBytes);
        tma_tile<HDP>(sV + s * BN * HDP, BN, &tm_v, &v_full[s], hk, t * BN,
                      b);
      }
    }
    return;
  }

  const int wg = role;
  const int rw0 = q0 + 64 * wg;
  const int row0 = rw0 + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  const uint32_t q_tile = smem_u32(sQ) + wg * 64 * 128;
  const uint32_t do_tile = smem_u32(sdO) + wg * 64 * 128;
  const float sl = scale * kLog2e;
  float L[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    L[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    D[i] = row < Sq ? delta[at] : 0.f;
  }
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t ph = (t / kStages) & 1;
    const int k0 = t * BN;
    const uint32_t k_tile = smem_u32(sK + s * BN * HDP);
    const uint32_t v_tile = smem_u32(sV + s * BN * HDP);

    float sc[BN / 2], dp[BN / 2];
    mbar_wait(&k_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      mma_ss(sc, desc_k(q_tile, BM, kk), desc_k(k_tile, BN, kk), kk);
    wg_commit();
    mbar_wait(&v_full[s], ph);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      mma_ss(dp, desc_k(do_tile, BM, kk), desc_k(v_tile, BN, kk), kk);
    wg_commit();

    wg_wait<1>();
    fence_regs(sc);
    const bool masked = (causal && k0 + BN - 1 > rw0) || k0 + BN > Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * c + 2 * i + j;
          float p = exp2f(sc[e] * sl - L[i]);
          if (masked) {
            const int col = k0 + 8 * c + 2 * (lane % 4) + j;
            if (col >= Sk || (causal && col > row0 + 8 * i)) p = 0.f;
          }
          sc[e] = p;
        }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * c + 2 * i + j;
          dp[e] = sc[e] * (dp[e] - D[i]);  // dS
        }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a_frag(dp, kk, a);
      mma_rs(acc, a, desc_mn(k_tile, BN, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  store_rows(dq + ((size_t)b * Sq * H + h) * hd, (size_t)H * hd, acc, row0,
             Sq, hd, scale, scale);
}

// ---- backward: dK, dV ------------------------------------------------------
//
// Both warpgroups take the same 64 keys and walk the same query tiles:
// warpgroup 0 sums dV = P^T dO, warpgroup 1 dK = scale dS^T Q. Each holds
// one 64 x hd accumulator; both recompute S^T (the dV side needs P, the dK
// side dS), which costs 2 x hd flops per pair but keeps every thread inside
// the register budget (dK and dV together, 128 of them at hd 128, beside
// S^T and dP^T, do not fit).

template <int HDP>
struct Dkdv {
  static constexpr int BN = 64, BM = 64;  // keys per block, queries a tile
  static constexpr int kStages = 4;
  static constexpr uint32_t kKVBytes = 2 * BN * HDP * 2;  // K and V
  static constexpr uint32_t kQBytes = BM * HDP * 2;       // Q or dO
  static constexpr size_t kSmem = 1024 + kKVBytes + 2 * kStages * kQBytes +
                                  2 * 2 * BM * 4 + 8 * (1 + 3 * kStages);
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
            int H, int Hkv, int hd, int causal, float scale) {
  using F = Dkdv<HDP>;
  constexpr int BN = F::BN, BM = F::BM, kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(align1024(smem_raw));  // [HDP/64][BN][64]
  bf16* sV = sK + BN * HDP;                     // [HDP/64][BN][64]
  bf16* sQ = sV + BN * HDP;                     // [stage][HDP/64][BM][64]
  bf16* sdO = sQ + kStages * BM * HDP;          // [stage][HDP/64][BM][64]
  float* sLD = reinterpret_cast<float*>(sdO + kStages * BM * HDP);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sLD + 2 * 2 * BM);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + kStages;
  uint64_t* empty = do_full + kStages;

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BN;
  const int g = H / Hkv;
  const int n_qt = (Sq + BM - 1) / BM;
  const int qt_begin = causal ? min(k0 / BM, n_qt) : 0;  // first visible
  const int per_head = n_qt - qt_begin;
  const int n_tiles = g * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&do_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumers / 128) {  // producer warpgroup
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, F::kKVBytes);
      tma_tile<HDP>(sK, BN, &tm_k, kv_full, hk, k0, b);
      tma_tile<HDP>(sV, BN, &tm_v, kv_full, hk, k0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int h = hk * g + t / per_head;
        const int qs0 = (qt_begin + t % per_head) * BM;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&q_full[s], F::kQBytes);
        tma_tile<HDP>(sQ + s * BM * HDP, BM, &tm_q, &q_full[s], h, qs0, b);
        mbar_expect_tx(&do_full[s], F::kQBytes);
        tma_tile<HDP>(sdO + s * BM * HDP, BM, &tm_do, &do_full[s], h, qs0,
                      b);
      }
    }
    return;
  }

  const int wg = role, tq = threadIdx.x % 128;
  const int key0 = k0 + 16 * (warp % 4) + lane / 4;  // and key0 + 8
  const uint32_t k_tile = smem_u32(sK), v_tile = smem_u32(sV);
  float* sL = sLD + wg * 2 * BM;  // this warpgroup's lse (base 2), delta
  float* sD = sL + BM;
  const float sl = scale * kLog2e;
  float acc[HDP / 2];  // dV on warpgroup 0, dK / scale on warpgroup 1
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;

  // this thread's share of a tile's lse (base 2) and delta: the global
  // load for the next tile is issued a tile ahead
  auto lse_delta = [&](int t) {
    if (t >= n_tiles || tq >= 2 * BM) return 0.f;
    const int h = hk * g + t / per_head;
    const int q = (qt_begin + t % per_head) * BM + tq % BM;
    const size_t at = ((size_t)b * H + h) * Sq + q;
    return q >= Sq ? 0.f : tq < BM ? lse[at] * kLog2e : delta[at];
  };
  float ld_next = lse_delta(0);

  // One straight loop per side (a branch on the side inside the loop would
  // make ptxas serialise the wgmma pipeline).
  auto run = [&](auto side) {
    constexpr bool kDK = decltype(side)::value;
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int qs0 = (qt_begin + t % per_head) * BM;
      const uint32_t q_tile = smem_u32(sQ + s * BM * HDP);
      const uint32_t do_tile = smem_u32(sdO + s * BM * HDP);

      named_sync(1 + wg);  // the previous tile's readers are done
      if (tq < 2 * BM) (tq < BM ? sL : sD)[tq % BM] = ld_next;
      named_sync(1 + wg);
      ld_next = lse_delta(t + 1);

      float st[BM / 2], dpt[BM / 2];  // S^T, dP^T: rows keys, cols queries
      mbar_wait(&q_full[s], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        mma_ss(st, desc_k(k_tile, BN, kk), desc_k(q_tile, BM, kk), kk);
      wg_commit();
      mbar_wait(&do_full[s], ph);
      if constexpr (kDK) {
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          mma_ss(dpt, desc_k(v_tile, BN, kk), desc_k(do_tile, BM, kk), kk);
        wg_commit();
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(st);
      const bool masked = (causal && qs0 < k0 + BN - 1) || qs0 + BM > Sq;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * c + 2 * (lane % 4) + j;
          const float lc = sL[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * c + 2 * i + j;
            float p = exp2f(st[e] * sl - lc);
            if (masked) {
              const int q = qs0 + col;
              if (q >= Sq || (causal && q < key0 + 8 * i)) p = 0.f;
            }
            st[e] = p;
          }
        }
      if constexpr (kDK) {
        wg_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int c = 0; c < BM / 8; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float dc = sD[8 * c + 2 * (lane % 4) + j];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * c + 2 * i + j;
              dpt[e] = st[e] * (dpt[e] - dc);  // dS^T
            }
          }
      }

      // dK += dS^T Q, or dV += P^T dO, the left operand from registers
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t a[4];
        a_frag(kDK ? dpt : st, kk, a);
        mma_rs(acc, a, desc_mn(kDK ? q_tile : do_tile, BM, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
    const size_t kv = ((size_t)b * Sk * Hkv + hk) * hd;
    if constexpr (kDK)
      store_rows(dk + kv, (size_t)Hkv * hd, acc, key0, Sk, hd, scale, scale);
    else
      store_rows(dv + kv, (size_t)Hkv * hd, acc, key0, Sk, hd, 1.f, 1.f);
  };
  if (wg == 1)
    run(std::true_type{});
  else
    run(std::false_type{});
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

namespace tc {


using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, looked up once (no link against libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A contiguous (B, S, heads, hd) bf16 tensor as the 4-D map (hd, heads, S,
// B); one box is 64 columns x box_rows rows of one head, 128-byte swizzled.
// Columns past hd and rows past S read as zero. Built per call: a few
// microseconds against the kernels' milliseconds.
int make_map(CUtensorMap* map, const void* base, int hd, int heads, int S,
             int B, int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int Sq, int Sk, int H, int Hkv, int hd, int causal,
        float scale, cudaStream_t st) {
  using F = Fwd<HDP>;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, hd, H, Sq, B, F::BM);
  if (!rc) rc = make_map(&mk, k, hd, Hkv, Sk, B, F::BN);
  if (!rc) rc = make_map(&mv, v, hd, Hkv, Sk, B, F::BN);
  if (!rc) rc = prepare(fwd_kernel<HDP>, F::kSmem);
  if (rc) return rc;
  fwd_kernel<HDP>
      <<<dim3((Sq + F::BM - 1) / F::BM, H, B), kThreads, F::kSmem, st>>>(
          mq, mk, mv, static_cast<bf16*>(o), lse, Sq, Sk, H, Hkv, hd, causal,
          scale);
  return (int)cudaGetLastError();
}

// dK/dV, then dQ (delta is already written)
template <int HDP>
int bwd(const void* q, const void* k, const void* v, const void* dO,
        const float* lse, const float* delta, void* dq, void* dk, void* dv,
        int B, int Sq, int Sk, int H, int Hkv, int hd, int causal,
        float scale, cudaStream_t st) {
  using K = Dkdv<HDP>;
  using Q = Dq<HDP>;
  CUtensorMap mq, mdo, mk, mv;
  int rc = make_map(&mq, q, hd, H, Sq, B, K::BM);
  if (!rc) rc = make_map(&mdo, dO, hd, H, Sq, B, K::BM);
  if (!rc) rc = make_map(&mk, k, hd, Hkv, Sk, B, K::BN);
  if (!rc) rc = make_map(&mv, v, hd, Hkv, Sk, B, K::BN);
  if (!rc) rc = prepare(dkdv_kernel<HDP>, K::kSmem);
  if (rc) return rc;
  dkdv_kernel<HDP>
      <<<dim3((Sk + K::BN - 1) / K::BN, Hkv, B), kThreads, K::kSmem, st>>>(
          mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Sk, H, Hkv, hd, causal, scale);
  rc = (int)cudaGetLastError();

  if (!rc) rc = make_map(&mq, q, hd, H, Sq, B, Q::BM);
  if (!rc) rc = make_map(&mdo, dO, hd, H, Sq, B, Q::BM);
  if (!rc) rc = make_map(&mk, k, hd, Hkv, Sk, B, Q::BN);
  if (!rc) rc = make_map(&mv, v, hd, Hkv, Sk, B, Q::BN);
  if (!rc) rc = prepare(dq_kernel<HDP>, Q::kSmem);
  if (rc) return rc;
  dq_kernel<HDP>
      <<<dim3((Sq + Q::BM - 1) / Q::BM, H, B), kThreads, Q::kSmem, st>>>(
          mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dq), Sq, Sk, H,
          Hkv, hd, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// head dims up to 64 run the 64-column tiles, 128 the 128-column ones
template <int HD>
constexpr int kPadded = HD > 64 ? 128 : 64;

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int Sq, int Sk, int H, int Hkv, int causal, float scale,
        cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::fwd<kPadded<HD>>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, HD,
                                causal, scale, st);
  } else {
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::bwd<kPadded<HD>>(q, k, v, dO, lse, delta, dq, dk, dv, B, Sq,
                                Sk, H, Hkv, HD, causal, scale, st);
  } else {
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
