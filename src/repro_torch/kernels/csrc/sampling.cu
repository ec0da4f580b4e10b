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
// elsewhere.
//
// What bounds it on the H100: one read and one write of B x V x 4 bytes
// over 3.35 TB/s (1.45 us for B = 4, V = 151936). The kernel reads the
// row from device memory once and writes it once; everything between
// runs in shared memory, and what it pays above the bound is passes over
// shared memory and the latency of exchanging histograms between CTAs.
//
// Design. One cluster of C = 16 CTAs a row (a non-portable cluster size),
// 1024 threads a CTA; a batch of more clusters than the card holds at
// once runs in waves. Each CTA loads a contiguous slice of ceil(V / C)
// values (rounded up to 4) with 16-byte loads (scalar loads when V or a
// pointer is off 16 bytes) and keeps their u in shared memory; x is
// recovered from u exactly. The load pass also takes the slice's max and
// min of u and, when top-k is on, the histogram of u's top byte.
// Histograms are kept per lane (one column a lane, so a warp's atomics
// never collide) and exchanged between the CTAs with st.async, each store
// counted in bytes on the receiver's mbarrier: no cluster-wide barrier
// after the first (which the load pass hides), and every CTA reads the
// same totals and takes the same step.
//   - tau_k by radix select, 8-bit digits from the top (counts are
//     integers, so tau_k is the reference's bisection result bit for bit,
//     ties included; k off or >= V: tau_k is the row's min). After each
//     digit, once the values from the chosen bucket up (every survivor,
//     and the k-th value's bucket) number at most 255, every CTA mails
//     its candidates to every CTA (its place from the per-CTA
//     histograms), and the rest is pairwise over the candidates, 4
//     threads a candidate: tau_k is the candidate with fewer than k above
//     it and at least k from it up.
//   - m is the row max (k_eff >= 1 keeps the argmax). e = __expf(x - m)
//     enters every sum as 64-bit fixed point, round(e * 2^40): integer
//     sums are exact and order-free, so the result is deterministic and
//     does not depend on how the row is split (at most V x 2^-41 off
//     exact sums against a total >= 1; __expf's 2^-21 relative error is
//     far inside the nucleus tolerance). A survivor more than ~28 nats
//     below m weighs 0, so it drops even at p = 1; the plain version,
//     summing in float32, drops there the tail whose mass its total
//     cannot hold (~6e-8 of it). The two agree in tau_k, and in the
//     nucleus up to such mass.
//   - tau_p = the least threshold whose strictly-greater mass is < p_z.
//     From mailed candidates, pairwise: each survivor's u, and 0, is a
//     threshold. Otherwise at p = 1 (a greedy slot) it is the least u of
//     positive weight, one pass and a min over the cluster; otherwise a
//     radix select on mass over the cluster: per digit each CTA adds
//     weights into 256 bins (after the first digit, a warp stages the
//     values under the prefix and adds them 32 at a time), the bins
//     travel as a reduce-scatter to the CTA that owns them and an
//     all-gather of the owners' totals (2 x 2 KB into a CTA, where
//     all-to-all brings C x 2 KB), and the digit taken is the least whose
//     mass above the prefix, plus the bins above it, is < p_z.
//   - The write pass stores x or -1e30 from shared memory, 16 bytes at a
//     time.
//
// Shared memory bounds the row: 16 slices of at most kMaxSlice values,
// about 394 thousand with 227 KB a CTA, so every vocabulary of the port's
// configs fits, seamless_m4t_v2's 256206 the widest.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kCols = 32;                 // sub-histogram columns: a lane's
constexpr int kCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;
constexpr int kLoBits = 20;               // a weight = hi * 2^20 + lo
constexpr int kSmemLimit = 232448;        // a block's shared memory, opt-in
// sub-histograms: counts (kBins x kCols, 32-bit), or the low and high
// parts of masses (two such arrays); later the candidates' mailbox
constexpr int kSubBytes = 2 * kBins * kCols * 4;
constexpr int kCand = kThreads / 4 - 1;   // candidates, taken pairwise
static_assert(kThreads == 4 * kBins, "the merge gives 4 threads a bin");

struct Shared {
  unsigned long long tot[kBins];          // bins for the select, transposed
  unsigned long long src_above[kCluster];  // per source CTA: values
  unsigned long long src_cand[kCluster];   // above the prefix; candidates
  unsigned long long stat[kCluster];      // every CTA's max and min of u
  unsigned long long low[kCluster];       // every CTA's least u of weight > 0
  uint32_t sent[kCluster];                // every CTA's candidate count
  unsigned long long mbar[2];             // exchange barriers, by parity
  unsigned long long sel_gt, sel_eq, sel_bound, kth_n;
  int sel_d;
  uint32_t umax, umin, ulow, lcount, kth, taup;
};

// a CTA's receive buffers: [parity][source CTA][bin], 64-bit
constexpr int kRecvBytes = 2 * kCluster * kBins * 8;
constexpr int kMaxSlice =
    ((kSmemLimit - (int)sizeof(Shared) - kSubBytes - kRecvBytes) / 4) & ~3;
// a sub-histogram column takes 32 warps x ceil(slice / 1024) values,
// each part <= 2^20, so no 32-bit sum can wrap
static_assert(32 * ((kMaxSlice + kThreads - 1) / kThreads) < 4096,
              "column sums fit 32 bits");

__device__ __forceinline__ uint32_t sortable(float x) {
  const uint32_t u = __float_as_uint(x);
  return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float unsortable(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xFFFFFFFFu));
}

// round(e * 2^40) for e in [0, 1], as hi * 2^20 + lo (lo <= 2^20): e *
// 2^20 and its fraction are exact in float32, so the two 32-bit
// conversions round as one 64-bit one would
struct Weight {
  uint32_t hi, lo;
  __device__ __forceinline__ bool nonzero() const { return (hi | lo) != 0; }
  __device__ __forceinline__ unsigned long long value() const {
    return ((unsigned long long)hi << kLoBits) + lo;
  }
};

__device__ __forceinline__ Weight fixed(float e) {
  const float s = e * (float)(1 << kLoBits);
  const float whole = truncf(s);
  return {(uint32_t)whole,
          __float2uint_rn((s - whole) * (float)(1 << kLoBits))};
}

// mass < p * z, as an integer bound: p = 1 exactly is z itself
__device__ __forceinline__ unsigned long long nucleus_target(
    float p, unsigned long long z) {
  if (!(p > 0.f)) return 0ull;
  if (p == 1.f) return z;
  if (p > 1.f) return ~0ull;
  return (unsigned long long)ceil((double)p * (double)z);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// shared::cluster address of `p` in CTA r of the cluster
__device__ __forceinline__ uint32_t remote(const void* p, int r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_addr(p)), "r"(r));
  return a;
}

// st.async into CTA r's shared memory, counted in bytes on its barrier
__device__ __forceinline__ void send(uint32_t addr, unsigned long long v,
                                     uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, "
      "[%2];" :: "r"(addr), "l"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void send(uint32_t addr, uint32_t v,
                                     uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

// An exchange: every CTA sends its part into every CTA's shared memory
// (each exchange is all-to-all: every CTA sends something to every CTA)
// with st.async, each store counted in bytes on the receiver's barrier of
// this exchange's parity. The receiver arms its barrier for `bytes`
// (its one arrival; bytes may land before it is armed) and waits for the
// phase. Two barriers alternate: a CTA sends for exchange i + 2 only
// after it received everyone's exchange i + 1, which each CTA sends only
// after its own exchange i completed, so no store lands in the wrong
// phase or overwrites a buffer still being read. Ends with __syncthreads.
__device__ __forceinline__ void receive(Shared& sh, int ex, uint32_t bytes) {
  const uint32_t bar = smem_addr(&sh.mbar[ex & 1]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    const uint32_t parity = (ex >> 1) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
  __syncthreads();
}

// f(u) for each value of the slice, 16-byte shared-memory reads
template <typename F>
__device__ __forceinline__ void for_each_u(const uint32_t* su, int n, F f) {
  const uint4* su4 = reinterpret_cast<const uint4*>(su);
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const uint4 q = su4[i];
    f(q.x);
    f(q.y);
    f(q.z);
    f(q.w);
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) f(su[i]);
}

// Sums 8 of a bin's 32 columns (thread t: bin t / 4, in an order that
// puts a warp's 32 reads on 32 banks), zeroes them, and returns the bin's
// total in all 4 threads of the bin.
__device__ __forceinline__ unsigned long long merge_columns(uint32_t* sub) {
  const int bin = threadIdx.x >> 2, q = threadIdx.x & 3;
  unsigned long long s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int idx = bin * kCols + 8 * q + ((j + bin) & 7);
    s += sub[idx];
    sub[idx] = 0;
  }
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  return s;
}

// Source `src`'s row of bins in the receive buffer of exchange ex's
// parity: T = uint32_t for counts, unsigned long long for masses; both
// start at the parity's offset, so that exchanges of the two parities
// never share bytes.
template <typename T>
__device__ __forceinline__ T* bins_of(unsigned long long* recv, int ex,
                                      int src) {
  return reinterpret_cast<T*>(recv + (ex & 1) * kCluster * kBins) +
         src * kBins;
}

// The bin's count, from the first thread of each bin, into every CTA's
// receive buffer of this exchange's parity, at this CTA's row.
__device__ __forceinline__ void send_counts(Shared& sh,
                                            unsigned long long* recv, int ex,
                                            int rank, unsigned long long s) {
  if ((threadIdx.x & 3) == 0) {
    const uint32_t* slot =
        bins_of<uint32_t>(recv, ex, rank) + (threadIdx.x >> 2);
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      send(remote(slot, r), (uint32_t)s, remote(&sh.mbar[ex & 1], r));
  }
}

// sh.tot[b] lives at (b % 8) * 32 + b / 8, so that lane l of warp 0 reads
// its bins 8l..8l+7 without bank conflicts
__device__ __forceinline__ int transposed(int b) {
  return (b & 7) * 32 + (b >> 3);
}

// One warp picks the digit from sh.tot. kMass: the least d whose
// strictly-greater mass A + suf(d + 1) is < bound (with p > 0, the bound
// is p_z of the total, suf(0)); else the largest d whose suffix suf(d)
// holds >= bound values. suf(d) = sum of tot[d..255]. Writes sel_d (-1:
// none), sel_gt = suf(d + 1), sel_eq = tot[d] and sel_bound. Call from
// warp 0; a block barrier must follow.
template <bool kMass>
__device__ __forceinline__ void select_digit(Shared& sh,
                                             unsigned long long bound,
                                             unsigned long long A,
                                             float p = 0.f) {
  const int lane = threadIdx.x;
  unsigned long long v[8], loc[9];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = sh.tot[j * 32 + lane];
  loc[8] = 0;
#pragma unroll
  for (int j = 7; j >= 0; --j) loc[j] = loc[j + 1] + v[j];
  unsigned long long incl = loc[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += y;
  }
  const unsigned long long above = incl - loc[0];
  if (p > 0.f) bound = nucleus_target(p, __shfl_sync(kFull, incl, 0));
  int pick = -1;
  if (kMass) {
#pragma unroll
    for (int j = 7; j >= 0; --j)
      if (A + above + loc[j + 1] < bound) pick = j;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (above + loc[j] >= bound) pick = j;
  }
  const unsigned mask = __ballot_sync(kFull, pick >= 0);
  if (lane == 0) {
    sh.sel_bound = bound;
    if (!mask) sh.sel_d = -1;
  }
  const int h = kMass ? __ffs(mask) - 1 : 31 - __clz(mask);
  if (mask && lane == h) {
    unsigned long long gt = loc[8], eq = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j == pick) {
        gt = loc[j + 1];
        eq = v[j];
      }
    sh.sel_d = 8 * lane + pick;
    sh.sel_gt = above + gt;
    sh.sel_eq = eq;
  }
}

// After an exchange of counts: the cluster's bins, summed over the
// kCluster sources, into sh.tot; then warp 0 selects the digit that holds the
// need-th largest value. Ends with __syncthreads.
__device__ __forceinline__ void cluster_select(Shared& sh,
                                               unsigned long long* recv,
                                               int ex,
                                               unsigned long long need) {
  const int t = threadIdx.x;
  if (t < kBins) {
    unsigned long long s = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      s += bins_of<uint32_t>(recv, ex, r)[t];
    sh.tot[transposed(t)] = s;
  }
  __syncthreads();
  if (t < 32) select_digit<false>(sh, need, 0);
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
topk_topp_mask_kernel(const float* __restrict__ logits,
                      const int* __restrict__ top_ks,
                      const float* __restrict__ top_ps,
                      float* __restrict__ out, int V, int S) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  uint32_t* sub = reinterpret_cast<uint32_t*>(dyn);      // counts / lo
  uint32_t* sub_hi = sub + kBins * kCols;                 // masses' hi
  uint32_t* cand = sub;                                   // the mailbox
  unsigned long long* gw =                                // their weights
      reinterpret_cast<unsigned long long*>(sub + kCand + 1);
  unsigned long long* recv =
      reinterpret_cast<unsigned long long*>(dyn + kSubBytes);
  uint32_t* su = reinterpret_cast<uint32_t*>(dyn + kSubBytes + kRecvBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(rank * S, V);
  const int n = min(S, V - lo);
  const float* x = logits + (size_t)b * V + lo;
  float* o = out + (size_t)b * V + lo;
  const int k = top_ks[b];
  const int k_eff = min(max(k <= 0 ? V : k, 1), V);
  const float p = top_ps[b];
  const bool radix_k = k_eff < V;

  for (int i = tid; i < kSubBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(dyn)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < kCluster) {
    sh.src_above[tid] = 0;
    sh.src_cand[tid] = (unsigned long long)max(min(S, V - tid * S), 0);
  }
  if (tid == 0) {
    sh.umax = 0;
    sh.umin = 0xFFFFFFFFu;
    sh.ulow = 0xFFFFFFFFu;
    sh.taup = 0xFFFFFFFFu;
    sh.lcount = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&sh.mbar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&sh.mbar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // every CTA must run, its barriers initialised, before the first
  // exchange; the load pass hides the wait
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  // -- load: u into shared memory, max / min, the top byte's counts ----
  uint32_t umax = 0, umin = 0xFFFFFFFFu;
  auto take = [&](uint32_t u) {
    umax = max(umax, u);
    umin = min(umin, u);
    if (radix_k) atomicAdd(&sub[(u >> 24) * kCols + lane], 1u);
  };
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uint4* su4 = reinterpret_cast<uint4*>(su);
    const int n4 = n >> 2;                  // n % 4 == 0 on this path
    for (int i0 = tid; i0 < n4; i0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j * kThreads < n4) v[j] = __ldcs(x4 + i0 + j * kThreads);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j * kThreads >= n4) break;
        const uint4 q = make_uint4(sortable(v[j].x), sortable(v[j].y),
                                   sortable(v[j].z), sortable(v[j].w));
        su4[i0 + j * kThreads] = q;
        take(q.x);
        take(q.y);
        take(q.z);
        take(q.w);
      }
    }
  } else {
    for (int i0 = tid; i0 < n; i0 += 4 * kThreads) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j * kThreads < n) v[j] = __ldcs(x + i0 + j * kThreads);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j * kThreads >= n) break;
        const uint32_t u = sortable(v[j]);
        su[i0 + j * kThreads] = u;
        take(u);
      }
    }
  }
  umax = __reduce_max_sync(kFull, umax);
  umin = __reduce_min_sync(kFull, umin);
  if (lane == 0) {
    atomicMax(&sh.umax, umax);
    atomicMin(&sh.umin, umin);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  __syncthreads();

  // -- exchange 0: max / min of u, and the top byte's counts -----------
  int ex = 0;                             // the last exchange; counts on
  constexpr uint32_t kCountBytes = kCluster * kBins * 4;
  if (radix_k)
    send_counts(sh, recv, ex, rank, merge_columns(sub));
  if (tid < kCluster)
    send(remote(&sh.stat[rank], tid),
         (unsigned long long)sh.umax << 32 | sh.umin,
         remote(&sh.mbar[0], tid));
  receive(sh, ex, kCluster * 8 + (radix_k ? kCountBytes : 0));
  uint32_t row_umax = 0, row_umin = 0xFFFFFFFFu;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    row_umax = max(row_umax, (uint32_t)(sh.stat[r] >> 32));
    row_umin = min(row_umin, (uint32_t)sh.stat[r]);
  }

  // -- tau_k: radix select on counts -----------------------------------
  // Digits from the top; each takes the cluster's counts, until the
  // values from the chosen bucket up (the candidates: every survivor, and
  // the k-th value's bucket) fit one CTA's mailbox. Then every CTA mails
  // its candidates to every CTA, and tau_k and tau_p are taken from the
  // candidates alone, pairwise, without further exchanges.
  uint32_t tau_k = row_umin;
  unsigned long long n_k = (unsigned long long)V;
  // the candidates are the values with u >> cshift >= cprefix (a small
  // row without top-k: all of it)
  bool mailed = !radix_k && V <= kCand;
  uint32_t cprefix = 0;
  int cshift = 32, ncand = mailed ? V : 0;
  // every CTA mails its candidates into every CTA's mailbox, at its
  // place after the candidates of the CTAs before it
  // (and its count: every exchange is all-to-all, so that completing one
  // means every CTA has completed the one before)
  auto mail = [&]() {
    ++ex;
    unsigned long long at = 0;
    for (int r = 0; r < rank; ++r) at += sh.src_cand[r];
    if (tid < kCluster)
      send(remote(&sh.sent[rank], tid), (uint32_t)sh.src_cand[rank],
           remote(&sh.mbar[ex & 1], tid));
    for_each_u(su, n, [&](uint32_t u) {
      if (cshift < 32 && (u >> cshift) < cprefix) return;
      const uint32_t slot = (uint32_t)at + atomicAdd(&sh.lcount, 1u);
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        send(remote(cand + slot, r), u, remote(&sh.mbar[ex & 1], r));
    });
    receive(sh, ex, 4 * ((uint32_t)ncand + kCluster));
  };
  if (mailed) mail();
  if (radix_k) {
    uint32_t prefix = 0;
    unsigned long long need = (unsigned long long)k_eff, above = 0;
    for (int pass = 0; pass < 4 && !mailed; ++pass) {
      const int shift = 24 - 8 * pass;
      if (pass > 0) {
        for_each_u(su, n, [&](uint32_t u) {
          if ((u >> (shift + 8)) == prefix)
            atomicAdd(&sub[((u >> shift) & 255) * kCols + lane], 1u);
        });
        __syncthreads();
        ++ex;
        send_counts(sh, recv, ex, rank, merge_columns(sub));
        receive(sh, ex, kCountBytes);
      }
      // the largest digit whose bins from it up hold >= need values
      cluster_select(sh, recv, ex, need);
      const int d = sh.sel_d;
      const unsigned long long gt = sh.sel_gt, eq = sh.sel_eq;
      // every source's count above the prefix, and from the digit up
      if (warp < kCluster) {
        const uint32_t* bins = bins_of<uint32_t>(recv, ex, warp);
        unsigned long long src_gt = 0, src_eq = 0;
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          const int bin = j * 32 + lane;
          if (bin > d) src_gt += bins[bin];
          if (bin == d) src_eq = bins[bin];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          src_gt += __shfl_xor_sync(kFull, src_gt, o);
          src_eq += __shfl_xor_sync(kFull, src_eq, o);
        }
        if (lane == 0) {
          sh.src_cand[warp] = sh.src_above[warp] + src_gt + src_eq;
          sh.src_above[warp] += src_gt;
        }
      }
      __syncthreads();
      const unsigned long long from_d = above + gt + eq;
      need -= gt;
      above += gt;
      prefix = (prefix << 8) | (uint32_t)d;
      if (pass == 3) n_k = above + eq;
      if (from_d <= (unsigned long long)kCand) {
        mailed = true;
        cprefix = prefix;
        cshift = shift;
        ncand = (int)from_d;
        mail();
      }
    }
    tau_k = prefix;
    if (mailed) {
      // tau_k is the candidate with fewer than k_eff candidates above it
      // and at least k_eff from it up (4 threads a candidate); the
      // candidates hold every value from the k-th's bucket up
      const int i = tid >> 2, q = tid & 3;
      const uint32_t c = i < ncand ? cand[i] : 0u;
      uint32_t gt = 0, ge = 0;
      if (i < ncand)
        for (int j = q; j < ncand; j += 4) {
          gt += cand[j] > c;
          ge += cand[j] >= c;
        }
      gt += __shfl_xor_sync(kFull, gt, 1);
      gt += __shfl_xor_sync(kFull, gt, 2);
      ge += __shfl_xor_sync(kFull, ge, 1);
      ge += __shfl_xor_sync(kFull, ge, 2);
      if (q == 0 && i < ncand && gt < (uint32_t)k_eff &&
          (uint32_t)k_eff <= ge) {
        sh.kth = c;                       // ties write the same value
        sh.kth_n = ge;
      }
      __syncthreads();
      tau_k = sh.kth;
      n_k = sh.kth_n;
    }
  }

  const float xmax = unsortable(row_umax);
  const float m = n_k == (unsigned long long)V ? xmax : fmaxf(xmax, kMasked);
  const Weight w_masked = fixed(__expf(kMasked - m));
  auto weight = [&](uint32_t u) {
    return u >= tau_k ? fixed(__expf(unsortable(u) - m)) : w_masked;
  };

  // -- tau_p ------------------------------------------------------------
  uint32_t tau_p = 0xFFFFFFFFu;
  if (mailed && !w_masked.nonzero()) {
    // every survivor's u, and 0, is a candidate threshold: tau_p is the
    // least whose strictly-greater mass is < p_z (4 threads a threshold;
    // thread group ncand takes 0)
    for (int i = tid; i < ncand; i += kThreads)
      gw[i] = cand[i] >= tau_k ? weight(cand[i]).value() : 0ull;
    __syncthreads();
    const int i = tid >> 2, q = tid & 3;
    const uint32_t c = i < ncand ? cand[i] : 0u;
    unsigned long long z = 0, above = 0;
    if (i <= ncand)
      for (int j = q; j < ncand; j += 4) {
        z += gw[j];
        if (cand[j] > c) above += gw[j];
      }
    z += __shfl_xor_sync(kFull, z, 1);
    z += __shfl_xor_sync(kFull, z, 2);
    above += __shfl_xor_sync(kFull, above, 1);
    above += __shfl_xor_sync(kFull, above, 2);
    if (q == 0 && i <= ncand && above < nucleus_target(p, z))
      atomicMin(&sh.taup, c);
    __syncthreads();
    tau_p = sh.taup;
  } else if (p == 1.f) {
    // p_z is the whole mass: tau_p is the least u of positive weight
    // (below m - 30, __expf gives less than 2^-41: weight 0)
    uint32_t low = 0xFFFFFFFFu;
    for_each_u(su, n, [&](uint32_t u) {
      if (u >= tau_k ? unsortable(u) - m < -30.f : !w_masked.nonzero())
        return;
      if (weight(u).nonzero()) low = min(low, u);
    });
    low = __reduce_min_sync(kFull, low);
    if (lane == 0) atomicMin(&sh.ulow, low);
    __syncthreads();
    ++ex;
    if (tid < kCluster)
      send(remote(&sh.low[rank], tid), (unsigned long long)sh.ulow,
           remote(&sh.mbar[ex & 1], tid));
    receive(sh, ex, kCluster * 8);
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      tau_p = min(tau_p, (uint32_t)sh.low[r]);
  } else {
    // radix select on mass over the cluster
    if (mailed) {                 // the mailbox, in use
      for (int i = tid; i < kSubBytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(dyn)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }
    unsigned long long A = 0, T = 0;        // mass above the prefix
    uint32_t prefix = 0;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      // unconditional: a branch around each atomic costs more than adding
      // 0
      auto add = [&](uint32_t u) {
        const Weight w = weight(u);
        const int at = ((u >> shift) & 255) * kCols + lane;
        atomicAdd(&sub[at], w.lo);
        atomicAdd(&sub_hi[at], w.hi);
      };
      if (pass == 0) {
        for_each_u(su, n, add);
      } else {
        // a warp stages the values under the prefix, then adds them 32 at
        // a time, in the receive buffer the last exchange filled (no CTA
        // sends into it before this CTA's next exchange)
        constexpr int kStage = 2 * kCluster * kBins / kWarps;
        uint32_t* stage =
            reinterpret_cast<uint32_t*>(recv + (ex & 1) * kCluster * kBins) +
            warp * kStage;
        int staged = 0;                   // warp-uniform
        auto flush = [&]() {
          __syncwarp();
          for (int i = lane; i < staged; i += 32) add(stage[i]);
          __syncwarp();
          staged = 0;
        };
        auto offer = [&](bool hit, uint32_t u) {
          const unsigned mask = __ballot_sync(kFull, hit);
          if (staged + 32 > kStage) flush();
          if (hit) stage[staged + __popc(mask & ((1u << lane) - 1))] = u;
          staged += __popc(mask);
        };
        const uint4* su4 = reinterpret_cast<const uint4*>(su);
        const int n4 = n >> 2;
        for (int i = tid; i - lane < n4; i += kThreads) {
          const bool valid = i < n4;
          const uint4 q = valid ? su4[i] : make_uint4(0u, 0u, 0u, 0u);
          const bool hx = valid && (q.x >> (shift + 8)) == prefix,
                     hy = valid && (q.y >> (shift + 8)) == prefix,
                     hz = valid && (q.z >> (shift + 8)) == prefix,
                     hw = valid && (q.w >> (shift + 8)) == prefix;
          if (!__any_sync(kFull, hx | hy | hz | hw)) continue;
          offer(hx, q.x);
          offer(hy, q.y);
          offer(hz, q.z);
          offer(hw, q.w);
        }
        for (int i = 4 * n4 + tid; i - lane < n; i += kThreads) {
          const uint32_t u = i < n ? su[i] : 0u;
          offer(i < n && (u >> (shift + 8)) == prefix, u);
        }
        flush();
      }
      __syncthreads();
      ++ex;
      const unsigned long long s_lo = merge_columns(sub);
      const unsigned long long s = s_lo + (merge_columns(sub_hi) << kLoBits);
      // reduce-scatter: CTA r owns bins [r, r + 1) x kOwn and receives
      // every CTA's part of them; then all-gather: each owner sends its
      // bins' totals to every CTA (2 x 2 KB a CTA, where all-to-all moves
      // kCluster x 2 KB)
      constexpr int kOwn = kBins / kCluster;
      if ((tid & 3) == 0) {
        const int bin = tid >> 2, owner = bin / kOwn;
        send(remote(bins_of<unsigned long long>(recv, ex, 0) +
                        rank * kOwn + bin % kOwn, owner),
             s, remote(&sh.mbar[ex & 1], owner));
      }
      receive(sh, ex, kBins * 8);
      ++ex;
      if (tid < kOwn) {
        const unsigned long long* part =
            bins_of<unsigned long long>(recv, ex - 1, 0);
        unsigned long long total = 0;
        for (int r = 0; r < kCluster; ++r) total += part[r * kOwn + tid];
        const unsigned long long* slot =
            bins_of<unsigned long long>(recv, ex, 0) + rank * kOwn + tid;
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          send(remote(slot, r), total, remote(&sh.mbar[ex & 1], r));
      }
      receive(sh, ex, kBins * 8);
      if (tid < kBins)
        sh.tot[transposed(tid)] =
            bins_of<unsigned long long>(recv, ex, 0)[tid];
      __syncthreads();
      // the least digit whose strictly-greater mass is < p_z (the first
      // pass takes p_z from the row's total, spread over its bins)
      if (tid < 32) select_digit<true>(sh, T, A, pass == 0 ? p : 0.f);
      __syncthreads();
      T = sh.sel_bound;
      const int d = sh.sel_d;
      if (d < 0) break;                     // p_z = 0: nothing survives
      A += sh.sel_gt;
      prefix = (prefix << 8) | (uint32_t)d;
      if (pass == 3) tau_p = prefix;
    }
  }

  // -- write ------------------------------------------------------------
  const uint32_t tau = max(tau_k, tau_p);
  if (kVec) {
    const uint4* su4 = reinterpret_cast<const uint4*>(su);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = tid; i < (n >> 2); i += kThreads) {
      const uint4 q = su4[i];
      __stcs(o4 + i, make_float4(q.x >= tau ? unsortable(q.x) : kMasked,
                                 q.y >= tau ? unsortable(q.y) : kMasked,
                                 q.z >= tau ? unsortable(q.z) : kMasked,
                                 q.w >= tau ? unsortable(q.w) : kMasked));
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t u = su[i];
      __stcs(o + i, u >= tau ? unsortable(u) : kMasked);
    }
  }
}

template <bool kVec>
struct Launcher {
  cudaLaunchAttribute dim[1];
  cudaLaunchConfig_t cfg = {};
  int rc = 0;

  Launcher() {
    const auto kernel = topk_topp_mask_kernel<kVec>;
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSubBytes + kRecvBytes + 4 * kMaxSlice);
    if (!rc)                              // 16 CTAs: above the portable 8
      rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    dim[0].id = cudaLaunchAttributeClusterDimension;
    dim[0].val.clusterDim.x = kCluster;
    dim[0].val.clusterDim.y = 1;
    dim[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(kThreads);
    cfg.attrs = dim;
    cfg.numAttrs = 1;
  }

  int operator()(const float* logits, const int* top_ks,
                 const float* top_ps, float* out, int B, int V,
                 cudaStream_t stream) {
    if (rc) return rc;
    const int S = ((V + kCluster - 1) / kCluster + 3) & ~3;
    cfg.gridDim = dim3(B * kCluster);
    cfg.dynamicSmemBytes = kSubBytes + kRecvBytes + 4 * (size_t)S;
    cfg.stream = stream;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, topk_topp_mask_kernel<kVec>, logits, top_ks, top_ps, out, V,
        S);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
};

template <bool kVec>
Launcher<kVec>& launcher() {
  static Launcher<kVec> l;                // one per kernel, on first use
  return l;
}

}  // namespace

// The widest row a cluster holds in its shared memory.
extern "C" int topk_topp_mask_max_vocab() { return kCluster * kMaxSlice; }

// logits/out (B, V) float32, top_ks (B,) int32, top_ps (B,) float32, all
// contiguous on the device. Returns cudaErrorInvalidValue for a shape the
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int topk_topp_mask_launch(const void* logits, const void* top_ks,
                                     const void* top_ps, void* out, int B,
                                     int V, void* stream) {
  if (B <= 0 || V <= 0 || V > topk_topp_mask_max_vocab() ||
      (long long)B * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = V % 4 == 0 && (uintptr_t)logits % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const float* x = static_cast<const float*>(logits);
  const int* ks = static_cast<const int*>(top_ks);
  const float* ps = static_cast<const float*>(top_ps);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launcher<true>()(x, ks, ps, o, B, V, st)
             : launcher<false>()(x, ks, ps, o, B, V, st);
}
