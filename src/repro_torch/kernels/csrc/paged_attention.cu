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
// slot's written length); a masked key adds exactly zero (its p is 0),
// m, l and acc are float32, masked logits are -1e30 (never -inf), and
// the output is acc / max(l, 1e-30) — the reference's numerics.
// A row that sees no key (a rank's sequence slice that starts after the
// query: lengths[b] + i < 0) writes out = 0.
//
// Optionally every design also writes each row's log-sum-exp of its
// scaled logits, lse = m + log(l) in float32 (B, S, H): the weight a
// partial softmax over one slice of the keys carries when the partials of
// several slices are merged (the dense cache cut along the sequence over
// ranks). A row that sees no key has l = 0 and lse = -inf, so it carries
// zero weight. Without the lse pointer nothing else changes.
//
// The rows of one block are (position, head) pairs of the g = H / Hkv
// query heads that share a KV head, so every K/V row is read from device
// memory once per group, not once per query head. Two designs, picked by
// paged_attention_launch from the shape alone:
//
// (a) Split-KV decode, when S x g <= kSplitMaxRows (decode, speculative
//   verify, MQA decode). What bounds it: the bytes of the live K/V pages
//   over 3.35 TB/s, a few MB a call, so in practice the latency of
//   getting them in flight; the arithmetic (4 x hd flops a key and row)
//   is negligible. One block per slot and KV head would leave most of
//   the 132 SMs idle (32 blocks at qwen3_1p7b's decode) and walk ~300
//   keys serially. So the grid is (key split, row tile x KV head, slot):
//   split s covers keys [s, s + 1) x kSplitKeys, fixed offsets from key
//   0. The host cannot read lengths, so grid.x = ceil(P x page_size /
//   kSplitKeys); a block whose split starts past its tile's last visible
//   key writes a neutral partial (m = -1e30, l = 0, acc = 0) and exits.
//   Inside a block each of 4 warps owns kSplitKeys / 4 keys, gathers
//   their K and V rows through the page table with 16-byte cp.async
//   (each 16-byte chunk resolves its own page, so any page_size works;
//   keys past the visible range are zero-filled) in two groups, so the
//   second half is in flight while the first is folded; q sits in
//   registers (a lane holds one 16-byte slice of each row, L lanes cover
//   a head: a half-warp at hd 128 bf16), dot products are shuffle
//   reductions over those L lanes, and each lane group folds its keys
//   with an online softmax in registers. Lane groups merge by shuffles,
//   warps through shared memory, each in a fixed order. A second small
//   kernel (paged_combine_kernel) merges the splits of every row in
//   split order into the output: no float atomics, so a second launch
//   gives the same bits, and since split boundaries do not depend on P
//   and a neutral partial adds exactly +0, the live-bucket table and the
//   full table give the same bits too. The combine costs one more launch
//   per call (34 more per qwen3_1p7b decode wave) and a partial buffer
//   of B x Hkv x rows x splits x (hd + 2) floats, which the wrapper
//   allocates (paged_attention_plan gives its size).
//
// (b) Multi-row (prefill chunks of up to 512 tokens): the score and value
//   products bound it, 4 x hd flops per visible pair. bf16 runs them on
//   the tensor cores (paged_mma_kernel): a block owns 64 query rows
//   (16 per warp) and walks 64-key K/V tiles gathered by cp.async into a
//   two-stage shared-memory ring (the next tile loads while this one is
//   multiplied); S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in,
//   float32 accumulate, fragments by ldmatrix from padded rows, free of
//   bank conflicts), the online softmax runs on the accumulators, and P
//   is rounded once to bf16 for P V — the plain version casts its
//   probabilities to V's dtype before P V as well. Each block stops at
//   the last key its own last row can see. float32 stays on the CUDA
//   cores (paged_rows_kernel: keys staged in shared memory as float32 in
//   16-key chunks), the same dtype rule as flash_attention.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;          // 4 warps in every kernel here

// ---- split-KV decode plan --------------------------------------------
constexpr int kSplitKeys = 64;         // keys per split: fixed offsets
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kSplitKeys / kWarps;   // 16 keys a warp
constexpr int kGroupKeys = kWarpKeys / 2;        // per cp.async group
constexpr int kSplitMaxRows = 64;      // S x g up to this: split path

// keys 0 .. n-1 a block walks: up to its last row's position, at most
// the table's P x page_size rows (64-bit: one page of a dense cache may
// hold 2^19 rows); <= 0 where that position precedes the slice's first key
__device__ __forceinline__ int visible_keys(int P, int page_size,
                                           int last_qpos) {
  const long long cap = (long long)P * page_size;
  return (int)min(cap, (long long)last_qpos + 1);
}

// rows (position x head) of one split block: 1, 2 or 4
__host__ __device__ constexpr int split_rows(int R) {
  return R <= 1 ? 1 : (R == 2 ? 2 : 4);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy to shared memory; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T as float32
__device__ __forceinline__ void unpack16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// One block: split blockIdx.x, row tile x KV head blockIdx.y, slot
// blockIdx.z. Writes the tile's partial (m, l, acc) for this split:
// part_m/part_l[row * n_split + split], part_acc[(row * n_split +
// split) * HD + d], rows numbered ((b * Hkv + hkv) * rows_pad + r).
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                   const T* __restrict__ pv,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int S, int H, int Hkv,
                   int page_size, int P, int n_split, int row_tiles,
                   float scale) {
  constexpr int V = 16 / sizeof(T);      // elements in 16 bytes
  constexpr int L = HD / V;              // lanes covering one head row
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "lanes per row");
  constexpr int KPW = 32 / L;            // keys a warp folds at once
  constexpr int PASSES = (kGroupKeys + KPW - 1) / KPW;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;
  const int tile = blockIdx.y % row_tiles, hkv = blockIdx.y / row_tiles;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = H / Hkv;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, S * g - row0);
  const int len = lengths[b];
  const int n_keys = visible_keys(P, page_size, len + (row0 + rows - 1) / g);
  const int key0 = split * kSplitKeys;
  const size_t prow = ((size_t)(b * Hkv + hkv) * row_tiles * ROWS + row0)
                      * n_split + split;      // + r * n_split for row r

  if (key0 >= n_keys) {                  // neutral partial
    for (int e = tid; e < rows * HD; e += kThreads)
      part_acc[(prow + (size_t)(e / HD) * n_split) * HD + e % HD] = 0.f;
    if (tid < rows) {
      part_m[prow + (size_t)tid * n_split] = kMasked;
      part_l[prow + (size_t)tid * n_split] = 0.f;
    }
    return;
  }

  // gather this warp's keys: two cp.async groups of kGroupKeys rows
  T* sk = reinterpret_cast<T*>(smem) + (size_t)warp * 2 * kWarpKeys * HD;
  T* sv = sk + kWarpKeys * HD;
  const int* table = page_table + (size_t)b * P;
  const int wkey0 = key0 + warp * kWarpKeys;
#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    for (int e = lane; e < kGroupKeys * L; e += 32) {
      const int jj = grp * kGroupKeys + e / L, c = e % L;
      const int j = wkey0 + jj;
      size_t off = 0;
      if (j < n_keys) {
        const size_t row =
            (size_t)table[j / page_size] * page_size + j % page_size;
        off = (row * Hkv + hkv) * HD + c * V;
      }
      const int nb = j < n_keys ? 16 : 0;
      cp_async16(sk + jj * HD + c * V, pk + off, nb);
      cp_async16(sv + jj * HD + c * V, pv + off, nb);
    }
    cp_async_commit();
  }

  // q rows in registers, pre-scaled as the TPU kernel does (q * scale)
  const int kg = lane / L, li = lane % L;
  float qf[ROWS][V];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qpos[r] = -1;                        // padded rows see no key
    if (r < rows) {
      const int s = (row0 + r) / g, h = hkv * g + (row0 + r) % g;
      unpack16(q + ((size_t)(b * S + s) * H + h) * HD + li * V, qf[r]);
#pragma unroll
      for (int e = 0; e < V; ++e) qf[r][e] *= scale;
      qpos[r] = len + s;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qf[r][e] = 0.f;
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  }

#pragma unroll
  for (int grp = 0; grp < 2; ++grp) {
    if (grp == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncwarp();
    float sc[PASSES][ROWS];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int jl = kg + p * KPW;
      const int jj = grp * kGroupKeys + jl;
      const int j = wkey0 + jj;
      float kf[V] = {};
      if (jl < kGroupKeys) unpack16(sk + jj * HD + li * V, kf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) dot += qf[r][e] * kf[e];
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const bool vis = jl < kGroupKeys && j < n_keys && j <= qpos[r];
        sc[p][r] = vis ? dot : kMasked;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float mx = m[r];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) mx = fmaxf(mx, sc[p][r]);
      const float corr = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int jl = kg + p * KPW;
      float vf[V] = {};
      if (jl < kGroupKeys)
        unpack16(sv + (grp * kGroupKeys + jl) * HD + li * V, vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pr = sc[p][r] == kMasked ? 0.f : expf(sc[p][r] - m[r]);
        l[r] += pr;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] += pr * vf[e];
      }
    }
  }

  // merge the lane groups of the warp (xor partners agree bit for bit)
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float c1 = expf(m[r] - mx), c2 = expf(mo - mx);
      l[r] = l[r] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * c1 + ao * c2;
      }
      m[r] = mx;
    }
  }

  // merge the warps in shared memory (reusing the K/V stage), in order
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);            // [kWarps][ROWS]
  float* wl = wm + kWarps * ROWS;
  float* wacc = wl + kWarps * ROWS;                      // [..][ROWS][HD]
  if (lane < L) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e)
        wacc[(warp * ROWS + r) * HD + li * V + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      wm[warp * ROWS + r] = m[r];
      wl[warp * ROWS + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w * ROWS + r] - mx);
      ls += wl[w * ROWS + r] * c;
      a += wacc[(w * ROWS + r) * HD + d] * c;
    }
    const size_t pr = prow + (size_t)r * n_split;
    part_acc[pr * HD + d] = a;
    if (d == 0) {
      part_m[pr] = mx;
      part_l[pr] = ls;
    }
  }
}

// Merges each row's n_split partials in split order: one thread per
// (row, column) of blockIdx.y's KV head and blockIdx.z's slot.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int n_split, int rows_pad) {
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= S * g * HD) return;
  const int r = e / HD, d = e % HD;
  const size_t base = ((size_t)(b * Hkv + hkv) * rows_pad + r) * n_split;
  float mx = kMasked;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[base + s]);
  float ls = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float c = expf(part_m[base + s] - mx);
    ls += part_l[base + s] * c;
    a += part_acc[(base + s) * HD + d] * c;
  }
  const int s = r / g, h = hkv * g + r % g;
  store(&out[((size_t)(b * S + s) * H + h) * HD + d], a / fmaxf(ls, 1e-30f));
  if (lse != nullptr && d == 0)
    lse[(size_t)(b * S + s) * H + h] = mx + logf(ls);
}

// ---- multi-row, bf16: tensor cores -----------------------------------
constexpr int kMmaRows = 64;           // query rows per block, 16 a warp
constexpr int kMmaKeys = 64;           // keys per K/V tile
constexpr int kPad = 8;                // bf16 of padding per smem row

__host__ __device__ constexpr int mma_smem_bytes(int hd) {
  return (kMmaRows + 4 * kMmaKeys) * (hd + kPad) * 2;   // Q + 2 x (K, V)
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ pk,
                 const __nv_bfloat16* __restrict__ pv,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int H, int Hkv, int page_size, int P, float scale) {
  constexpr int LD = HD + kPad;          // smem row stride (elements)
  constexpr int C = HD / 8;              // 16-byte chunks per head row
  constexpr int KT = HD / 16;            // k-steps of Q K^T
  constexpr int NT = HD / 8;             // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = sq + kMmaRows * LD;   // [stage][K | V][key][LD]

  const int b = blockIdx.z, hkv = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = H / Hkv;
  const int row0 = blockIdx.x * kMmaRows;
  const int rows = min(kMmaRows, S * g - row0);
  const int len = lengths[b];
  const int n_keys = visible_keys(P, page_size, len + (row0 + rows - 1) / g);
  const int n_tiles = (n_keys + kMmaKeys - 1) / kMmaKeys;
  const int* table = page_table + (size_t)b * P;

  for (int e = tid; e < kMmaRows * C; e += kThreads) {
    const int r = e / C, c = e % C;
    size_t off = 0;
    if (r < rows) {
      const int s = (row0 + r) / g, h = hkv * g + (row0 + r) % g;
      off = ((size_t)(b * S + s) * H + h) * HD + c * 8;
    }
    cp_async16(sq + r * LD + c * 8, q + off, r < rows ? 16 : 0);
  }
  cp_async_commit();
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* sk = skv + (size_t)stage * 2 * kMmaKeys * LD;
    __nv_bfloat16* sv = sk + kMmaKeys * LD;
    for (int e = tid; e < kMmaKeys * C; e += kThreads) {
      const int jj = e / C, c = e % C;
      const int j = t * kMmaKeys + jj;
      size_t off = 0;
      if (j < n_keys) {
        const size_t row =
            (size_t)table[j / page_size] * page_size + j % page_size;
        off = (row * Hkv + hkv) * HD + c * 8;
      }
      const int nb = j < n_keys ? 16 : 0;
      cp_async16(sk + jj * LD + c * 8, pk + off, nb);
      cp_async16(sv + jj * LD + c * 8, pv + off, nb);
    }
    cp_async_commit();
  };
  load_tile(0, 0);
  if (n_tiles > 1) load_tile(1, 1);

  // this thread's two rows of the warp's 16 (accumulator layout)
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int qpa = ra < rows ? len + (row0 + ra) / g : -1;
  const int qpb = rb < rows ? len + (row0 + rb) / g : -1;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* sk = skv + (size_t)(t % 2) * 2 * kMmaKeys * LD;
    const __nv_bfloat16* sv = sk + kMmaKeys * LD;

    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + (warp * 16 + lane % 16) * LD + kk * 16
                     + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < kMmaKeys / 16; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, sk + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD
                        + kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(s[2 * n2], a, bk[0], bk[1]);
        mma16816(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // mask, scale, online softmax on the accumulators
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
      const int j = t * kMmaKeys + n * 8 + (lane % 4) * 2;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool ok = j + c < n_keys;
        s[n][c] = ok && j + c <= qpa ? s[n][c] * scale : kMasked;
        s[n][2 + c] = ok && j + c <= qpb ? s[n][2 + c] * scale : kMasked;
        mx_a = fmaxf(mx_a, s[n][c]);
        mx_b = fmaxf(mx_b, s[n][2 + c]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float ca = expf(m_a - mx_a), cb = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= ca;
    l_b *= cb;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= ca; o[n][1] *= ca;
      o[n][2] *= cb; o[n][3] *= cb;
    }
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[n][c] = s[n][c] == kMasked ? 0.f : expf(s[n][c] - m_a);
        s[n][2 + c] = s[n][2 + c] == kMasked ? 0.f : expf(s[n][2 + c] - m_b);
        l_a += s[n][c];
        l_b += s[n][2 + c];
      }
    }

    // O += P V, P as bf16 A fragments straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD
                          + n2 * 16 + (lane / 16) * 8);
        mma16816(o[2 * n2], a, bv[0], bv[1]);
        mma16816(o[2 * n2 + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();                     // stage t % 2 is free again
    if (t + 2 < n_tiles) load_tile(t + 2, t % 2);
  }
  cp_async_wait<0>();                    // no tile ran: n_keys <= 0

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const int s_ = (row0 + r) / g, h = hkv * g + (row0 + r) % g;
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)(b * S + s_) * H + h] =
          half ? m_b + logf(l_b) : m_a + logf(l_a);
    __nv_bfloat16* orow = out + ((size_t)(b * S + s_) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + (lane % 4) * 2;
      const float x0 = half ? o[n][2] * ib : o[n][0] * ia;
      const float x1 = half ? o[n][3] * ib : o[n][1] * ia;
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---- multi-row, float32: CUDA cores ----------------------------------
constexpr int kRows = 16;   // query rows (position x head) per block
constexpr int kKeys = 16;   // keys per shared-memory chunk

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_rows_kernel(const T* __restrict__ q, const T* __restrict__ pk,
                  const T* __restrict__ pv,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  float* __restrict__ lse, int S, int H, int Hkv,
                  int page_size, int P, float scale) {
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
  const int n_keys = visible_keys(P, page_size, len + (row0 + rows - 1) / g);
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
        // a row that sees no key keeps p = 0 (out 0, lse -inf); for any
        // other row expf(kMasked - mx) is 0 already
        const float p = sp[tid][jj] == kMasked ? 0.f : expf(sp[tid][jj] - mx);
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
  if (lse != nullptr && tid < rows) {
    const int s = (row0 + tid) / g, h = hkv * g + (row0 + tid) % g;
    lse[(size_t)(b * S + s) * H + h] = sm[tid] + logf(sl[tid]);
  }
}

// ---- launchers --------------------------------------------------------
struct Plan {
  int split;                 // 1: split-KV decode, 0: multi-row
  int rows, row_tiles, n_split;
  long long workspace;       // floats of partials (split path)
};

Plan make_plan(int B, int S, int H, int Hkv, int hd, int page_size, int P) {
  Plan p{};
  const int R = S * (H / Hkv);
  p.split = R <= kSplitMaxRows;
  if (!p.split) return p;
  p.rows = split_rows(R);
  p.row_tiles = (R + p.rows - 1) / p.rows;
  p.n_split = (int)(((long long)P * page_size + kSplitKeys - 1) / kSplitKeys);
  p.workspace = (long long)B * Hkv * p.row_tiles * p.rows * p.n_split
                * (hd + 2);
  return p;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD, int ROWS>
int launch_split(const T* q, const T* pk, const T* pv, const int* table,
                 const int* lens, T* out, float* lse, float* work,
                 const Plan& pl, int B,
                 int S, int H, int Hkv, int page_size, int P, float scale,
                 cudaStream_t st) {
  const int kv = kWarps * 2 * kWarpKeys * HD * (int)sizeof(T);
  const int merge = (2 + HD) * kWarps * ROWS * (int)sizeof(float);
  const int smem = kv > merge ? kv : merge;
  const int attr = allow_smem(paged_split_kernel<T, HD, ROWS>, smem);
  if (attr) return attr;
  const long long np = (long long)B * Hkv * pl.row_tiles * ROWS * pl.n_split;
  float* pm = work;
  float* plv = work + np;
  float* pacc = work + 2 * np;
  paged_split_kernel<T, HD, ROWS>
      <<<dim3(pl.n_split, pl.row_tiles * Hkv, B), kThreads, smem, st>>>(
          q, pk, pv, table, lens, pm, plv, pacc, S, H, Hkv, page_size, P,
          pl.n_split, pl.row_tiles, scale);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int R = S * (H / Hkv);
  paged_combine_kernel<T, HD>
      <<<dim3((R * HD + kThreads - 1) / kThreads, Hkv, B), kThreads, 0, st>>>(
          pm, plv, pacc, out, lse, S, H, Hkv, pl.n_split,
          pl.row_tiles * ROWS);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_hd(const void* q, const void* pk, const void* pv, const int* table,
              const int* lens, void* out, float* lse, float* work,
              const Plan& pl, int B,
              int S, int H, int Hkv, int page_size, int P, float scale,
              cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(pk);
  const T* vt = static_cast<const T*>(pv);
  T* ot = static_cast<T*>(out);
  if (pl.split) {
    if (pl.rows == 1)
      return launch_split<T, HD, 1>(qt, kt, vt, table, lens, ot, lse, work,
                                    pl, B, S, H, Hkv, page_size, P, scale,
                                    st);
    if (pl.rows == 2)
      return launch_split<T, HD, 2>(qt, kt, vt, table, lens, ot, lse, work,
                                    pl, B, S, H, Hkv, page_size, P, scale,
                                    st);
    return launch_split<T, HD, 4>(qt, kt, vt, table, lens, ot, lse, work, pl,
                                  B, S, H, Hkv, page_size, P, scale, st);
  }
  const int R = S * (H / Hkv);
  if constexpr (sizeof(T) == 2) {
    const int smem = mma_smem_bytes(HD);
    const int attr = allow_smem(paged_mma_kernel<HD>, smem);
    if (attr) return attr;
    paged_mma_kernel<HD><<<dim3((R + kMmaRows - 1) / kMmaRows, Hkv, B),
                           kThreads, smem, st>>>(
        qt, kt, vt, table, lens, ot, lse, S, H, Hkv, page_size, P, scale);
  } else {
    paged_rows_kernel<T, HD><<<dim3((R + kRows - 1) / kRows, Hkv, B),
                               kThreads, 0, st>>>(
        qt, kt, vt, table, lens, ot, lse, S, H, Hkv, page_size, P, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const int* table,
           const int* lens, void* out, float* lse, float* work,
           const Plan& pl, int B,
           int S, int H, int Hkv, int hd, int page_size, int P, float scale,
           cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, pk, pv, table, lens, out, lse, work,
                                     pl, B, S, H, Hkv, page_size, P, scale,
                                     st);
    case 32: return launch_hd<T, 32>(q, pk, pv, table, lens, out, lse, work,
                                     pl, B, S, H, Hkv, page_size, P, scale,
                                     st);
    case 64: return launch_hd<T, 64>(q, pk, pv, table, lens, out, lse, work,
                                     pl, B, S, H, Hkv, page_size, P, scale,
                                     st);
    case 128: return launch_hd<T, 128>(q, pk, pv, table, lens, out, lse, work,
                                       pl, B, S, H, Hkv, page_size, P, scale,
                                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int S, int H, int Hkv, int page_size, int P) {
  return B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
         page_size <= 0 || P <= 0;
}

}  // namespace

// The plan of one call (dtype as below): out[0] = 1 for the split-KV
// decode path, 0 for the multi-row path; out[1..3] = the grid of its main
// kernel; out[4] = the floats of workspace the split path needs (0
// otherwise); out[5] = kSplitKeys. Returns 0, or cudaErrorInvalidValue
// for a bad shape.
extern "C" int paged_attention_plan(int dtype, int B, int S, int H, int Hkv,
                                    int hd, int page_size, int P,
                                    long long* out) {
  if (bad_shape(B, S, H, Hkv, page_size, P)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, S, H, Hkv, hd, page_size, P);
  const int R = S * (H / Hkv);
  const int tile = dtype == 1 ? kMmaRows : kRows;
  out[0] = p.split;
  out[1] = p.split ? p.n_split : (R + tile - 1) / tile;
  out[2] = p.split ? (long long)p.row_tiles * Hkv : Hkv;
  out[3] = B;
  out[4] = p.workspace;
  out[5] = kSplitKeys;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Layouts (all contiguous, 16-byte
// aligned): q/out (B, S, H, hd); pk/pv (n_pages, page_size, Hkv, hd);
// page_table (B, P) int32; lengths (B,) int32; lse float32 (B, S, H) or
// null (not written); workspace float32 of workspace_floats >=
// paged_attention_plan's out[4]. Returns cudaGetLastError() after the
// launches.
extern "C" int paged_attention_launch(
    const void* q, const void* pk, const void* pv, const void* page_table,
    const void* lengths, void* out, void* lse, void* workspace,
    long long workspace_floats, int dtype, int B, int S, int H, int Hkv,
    int hd, int page_size, int P, float scale, void* stream) {
  if (bad_shape(B, S, H, Hkv, page_size, P)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)pk | (uintptr_t)pv | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const Plan pl = make_plan(B, S, H, Hkv, hd, page_size, P);
  if (pl.workspace > workspace_floats) return (int)cudaErrorInvalidValue;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  float* work = static_cast<float*>(workspace);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, pk, pv, table, lens, out, lse_f, work, pl, B, S,
                         H, Hkv, hd, page_size, P, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pk, pv, table, lens, out, lse_f, work, pl,
                                 B, S, H, Hkv, hd, page_size, P, scale, st);
  return (int)cudaErrorInvalidValue;
}
