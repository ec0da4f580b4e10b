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
// Float32 throughout; the exp is expf of dt A, the plain version's, so
// the decays agree bit for bit (ex2.approx runs low on average near 1, a
// bias that long memories sum). With nvcc's FMAs the results match the
// plain version to a tolerance, not bit for bit.
//
// What bounds it on the H100: bytes. A decode step reads one state page
// row block per live slot and writes one (R x ds x 4 bytes each: 512 KiB
// for falcon-mamba-7b, 1 MiB for zamba2-1.2b, per layer) plus dt, x, y
// (B x S x R x 4 each) and the small B/C streams; the arithmetic is one
// exp and three flops per state element and step — an intensity far
// below one flop per byte, so the bound is those bytes over 3.35 TB/s. A
// decode call moves 2-4 MB, about a microsecond, so the launch and the
// chain of dependent loads (the slot's read page, then its rows) weigh
// as much.
//
// Design. The TPU kernel walks a sequential (B, W) grid, carrying h in
// VMEM from one write window to the next. Blocks on the card run in no
// order, so the window walk becomes the time loop inside the block, and
// the lanes go over states: ds/G lanes a row, G states a lane (G = 4, 8
// at ds 64), so that a warp's loads of a page's rows and its snapshot
// stores are 16 bytes a lane and contiguous (a slot's (R, ds) page block
// is), and registers do not grow with ds. A block owns RB rows of one slot
// (64 at ds 16, 32 at ds 64: 512 blocks at B = 4 for both models, where
// one thread a row gave 256 / 128) for the whole call. It issues every
// load the first step needs at once (its slot's read page, live flag,
// n_new and plan entries, the first steps' inputs), then its page rows.
// dt and x ([step][row]) and B and C ([step][state]) of the next kSteps
// steps are copied into shared memory (cp.async) while the block works on
// these; a block-wide pass lays out, per row and 4 steps, d and x (d x
// for "dxb"; for a stride-0 decay, a_cs == 0, mamba2, exp(d A) in place
// of d: one exp a row and step, shared by the row's lanes), so that a lane
// reads 4 steps of each in one 16-byte load. The readout sums over a
// row's lanes: each lane keeps its states' h.C for a batch of steps, then
// one reduce-scatter over the row's lanes leaves one step's sum per lane;
// the sums go through shared memory so that y is stored contiguous along
// rows. At each chunk the block notes which page each step's snapshot
// goes to (one ballot marks the steps), so the plan is read once per
// chunk, not once per step. A decode call (S == 1) has nothing to stage:
// the launcher gives it paged_ssm_step_kernel, the same lanes and step
// without shared memory or barriers, each lane reading its inputs itself
// (32 registers where the staged kernel takes up to 128).
//
// Every step runs the same instructions wherever it falls in a call (the
// state update, then the readout: its states' products in a fixed order,
// then the same butterfly over the row's lanes), so a call split in two
// at any step gives the same bits as one call: chunked prefill equals
// serial ingest bit for bit on the card.
//
// Read page == write page: a mid-page decode step reads its state from
// page (lengths-1)/page_size and rewrites the same page. Each lane reads
// its h0 elements before it writes any snapshot of them, and no other
// lane touches those elements of that slot, so the in-place update is
// safe by construction. Windows routed to scratch page 0 (idle slots,
// unwritten windows) are not written at all: page 0 is never read as
// state.
//
// Later work: the decode step fused across layers, so a wave is not 66
// launches; the wrapper's host time (ctypes, argument checks, the plan's
// int32 conversions) is most of a decode call's event time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;      // steps staged per shared-memory chunk
constexpr int kStageRow = kSteps + 4;   // a row's staged steps, padded

constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
constexpr int imin(int a, int b) { return a < b ? a : b; }
constexpr int imax(int a, int b) { return a > b ? a : b; }

// TPR = DS/G lanes a row, G states a lane (s = lane_in_row * G + i; G = 4,
// 8 at DS = 64), RW rows a warp, RB rows a block; the readout sums N >= 4
// steps a batch. After its
// reduce-scatter a lane holds K = N/TPR sums (one where TPR >= N): those
// of steps i + K * ((lane in row) >> SH), i < K; lanes that differ only
// in the low SH bits hold copies.
template <int DS>
struct Lanes {
  static constexpr int G = DS == 64 ? 8 : 4;
  static constexpr int TPR = DS / G;
  static constexpr int LT = ilog2(TPR);
  static constexpr int RW = 32 / TPR;
  static constexpr int RB = imin(64, 8 * RW);
  static constexpr int NT = RB / RW * 32;          // threads a block
  static constexpr int RP = RB + 1;                // [step][row] sums
  static constexpr int N = imax(TPR, 4);
  static constexpr int K = N / TPR > 1 ? N / TPR : 1;
  static constexpr int SH = LT > ilog2(N) ? LT - ilog2(N) : 0;
  // shared memory (floats): dt, x [2][kSteps][RB]; B, C [2 stages][2]
  // [kSteps][DS]; d (or the decay), x (or d x) [2][RB][kStageRow]; the sums
  // of y [kSteps][RP]; A of the rows [RB]
  static constexpr int in_floats = 2 * kSteps * RB;
  static constexpr int bc_floats = 2 * 2 * kSteps * DS;
  static constexpr int q_floats = 2 * RB * kStageRow;
  static constexpr int smem_floats =
      in_floats + bc_floats + q_floats + kSteps * RP + RB;
};

// Reduce-scatter over the lane bits o, o/2, .., omin (powers of two):
// stage by stage each lane keeps half of its n values, adding its
// partner's copy of that half, until one is left; the remaining offsets
// add plainly. Lanes that differ only in those bits end with the sums:
// v[i] holds the sum of value i + sum_m bit_m * N / 2^(m+1), bit_m the
// lane's bit at the m-th halving offset. The sum of every value is taken
// over the lanes in the same order. A template recursion, so that every
// index is a compile-time constant and v stays in registers.
template <int N, int n, int o, int omin>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (o >= omin) {
    if constexpr (n >= 2) {
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? v[i] : v[i + n / 2];
        const float keep = up ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
      reduce_scatter<N, n / 2, o / 2, omin>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      reduce_scatter<N, 1, o / 2, omin>(v, lane);
    }
  }
}

// 4-byte asynchronous copy from device to shared memory, zero-filled
// (nothing read) when !ok
__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// G consecutive floats, G a multiple of 4 (16-byte aligned): G/4 16-byte
// loads / stores
template <int G>
__device__ __forceinline__ void ldv(float (&v)[G], const float* p) {
#pragma unroll
  for (int i = 0; i < G; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
}
template <int G>
__device__ __forceinline__ void stv(float* p, const float (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// One block per (tile of RB rows, slot b), the whole call. kRow: a
// stride-0 decay (one exp a row and step), taken for "dxb" only.
template <int DS, bool DBX, bool kRow>
__global__ void __launch_bounds__(Lanes<DS>::NT)
paged_ssm_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ A, long long a_rs, long long a_cs,
                 float* h_pool, const int* __restrict__ read_page,
                 const int* __restrict__ live,
                 const int* __restrict__ phys_w,
                 const int* __restrict__ t_w, const int* __restrict__ n_new,
                 float* __restrict__ y, int S, int R, int W) {
  using Ln = Lanes<DS>;
  constexpr int TPR = Ln::TPR, RB = Ln::RB, RP = Ln::RP, NT = Ln::NT;
  constexpr int N = Ln::N, K = Ln::K, G = Ln::G, T = kSteps;
  constexpr int GA = kRow ? 1 : G;                 // decays a lane holds
  extern __shared__ __align__(16) float smem[];
  float* sio = smem;                               // [2][T][RB]
  float* sbc = sio + Ln::in_floats;                // [2][2][T][DS]
  float* sq = sbc + Ln::bc_floats;                 // [2][RB][kStageRow]
  float* sy = sq + Ln::q_floats;                   // [T][RP]
  float* sA = sy + T * RP;                         // [RB]
  // the page each step of the chunk ends (0: none); smulti: some step
  // ends two windows (not in a compact plan), then the plan is walked
  __shared__ int spage[kSteps], smulti;

  const int b = blockIdx.y, r0 = blockIdx.x * RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane % TPR, rib = warp * Ln::RW + lane / TPR;
  const int s0 = lr * G, r = r0 + rib;
  const bool has_row = r < R;
  const size_t bs = (size_t)b * S;
  const size_t page_elems = (size_t)R * DS;
  const int* pw = phys_w + (size_t)b * W;
  const int* tw = t_w + (size_t)b * W;

  // the copies of the L steps from step t0 (one commit group): dt and x
  // into the one staging buffer ([step][row], rows past R zero-filled),
  // B and C into stage st; a batch skips its steps past L
  auto load = [&](int t0, int st) {
    const int L = min(T, S - t0);
    for (int e = tid; e < 2 * RB * L; e += NT) {
      const int tt = e / (2 * RB), q = e / RB % 2, row = e % RB;
      const bool ok = r0 + row < R;
      copy_async4(sio + (q * T + tt) * RB + row,
                  ok ? (q ? x : dt) + (bs + t0 + tt) * R + r0 + row : dt, ok);
    }
    float* sb = sbc + st * 2 * T * DS;
    for (int e = tid; e < 2 * DS * L; e += NT) {
      const int tt = e / (2 * DS), q = e / DS % 2, s = e % DS;
      copy_async4(sb + (q * T + tt) * DS + s,
                  (q ? Cm : Bm) + (bs + t0 + tt) * DS + s, true);
    }
    copy_commit();
  };

  load(0, 0);
  // every load the first step depends on goes out before any is waited for
  const int nn = n_new[b], rp = read_page[b];
  const bool lv = live[b] != 0;
  const int tw0 = tid < W ? tw[tid] : -1, pw0 = tid < W ? pw[tid] : 0;
  float h[G], Al[GA];
#pragma unroll
  for (int i = 0; i < G; ++i) h[i] = 0.f;
  if (has_row && lv)
    ldv(h, h_pool + (size_t)rp * page_elems + (size_t)r * DS + s0);
  if constexpr (kRow) {
    for (int e = tid; e < RB; e += NT) sA[e] = r0 + e < R ? A[(r0 + e) * a_rs]
                                                          : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i)
      Al[i] = has_row ? A[r * a_rs + (s0 + i) * a_cs] : 0.f;
  }

  for (int t0 = 0, c = 0; t0 < S; t0 += T, ++c) {
    const int st = c & 1, L = min(T, S - t0);
    const float* qa = sq + rib * kStageRow;                   // d / decay
    const float* qx = sq + (RB + rib) * kStageRow;            // x / d x
    const float* cb = sbc + st * 2 * T * DS;
    copy_wait_all();
    if (tid < T) spage[tid] = 0;
    if (tid == 0) smulti = 0;
    __syncthreads();          // the chunk landed; the last one is written out
    for (int w = tid; w < W; w += NT) {
      const int t = w == tid ? tw0 : tw[w], page = w == tid ? pw0 : pw[w];
      if (page != 0 && t >= t0 && t < t0 + L &&
          atomicExch(&spage[t - t0], page) != 0)
        smulti = 1;
    }
    // per row and 4 steps: d (the decay for a stride-0 A) and x (d x for
    // "dxb"), read down the staged columns (consecutive rows: no bank
    // conflict) and stored 16 bytes at a time
    for (int e = tid; e < (L + 3) / 4 * RB; e += NT) {
      const int row = e % RB, q4 = 4 * (e / RB);
      float dq[4], xq[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = sio[(q4 + k) * RB + row];
        const float xv = sio[(T + q4 + k) * RB + row];
        dq[k] = kRow ? expf(d * sA[row]) : d;
        xq[k] = DBX ? xv : __fmul_rn(d, xv);
      }
      stv(sq + row * kStageRow + q4, dq);
      stv(sq + (RB + row) * kStageRow + q4, xq);
    }
    __syncthreads();
    if (t0 + T < S) load(t0 + T, st ^ 1);
    const unsigned marks = __ballot_sync(0xffffffffu, spage[lane] != 0);
    const bool multi = smulti != 0;
    for (int u0 = 0; u0 < L; u0 += N) {
      float v[N];
#pragma unroll
      for (int g = 0; g < N; g += 4) {
        float a4[4], x4[4];
        ldv(a4, qa + u0 + g);
        ldv(x4, qx + u0 + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = u0 + g + j, t = t0 + u;
          v[g + j] = 0.f;
          if (u >= L) continue;            // past the chunk: not stored
          float bq[G], cq[G];
          ldv(bq, cb + u * DS + s0);
          ldv(cq, cb + (T + u) * DS + s0);
          if (t < nn) {
#pragma unroll
            for (int i = 0; i < G; ++i) {
              float a;
              if constexpr (kRow) a = a4[j];
              else a = expf(a4[j] * Al[i]);
              const float term =
                  DBX ? __fmul_rn(__fmul_rn(a4[j], bq[i]), x4[j])
                      : __fmul_rn(x4[j], bq[i]);
              h[i] = __fmaf_rn(a, h[i], term);
            }
          }
          float p = __fmul_rn(h[0], cq[0]);
#pragma unroll
          for (int i = 1; i < G; ++i) p = __fmaf_rn(h[i], cq[i], p);
          v[g + j] = p;
          if (((marks >> u) & 1u) && has_row) {
            const size_t o = (size_t)r * DS + s0;
            if (!multi) {
              stv(h_pool + (size_t)spage[u] * page_elems + o, h);
            } else {
              for (int w = 0; w < W; ++w)
                if (pw[w] != 0 && tw[w] == t)
                  stv(h_pool + (size_t)pw[w] * page_elems + o, h);
            }
          }
        }
      }
      reduce_scatter<N, N, TPR / 2, 1>(v, lane);
      if ((lr & ((1 << Ln::SH) - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < K; ++i)
          sy[(u0 + i + K * (lr >> Ln::SH)) * RP + rib] = v[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < L * RB; e += NT) {
      const int tt = e / RB, row = e % RB;
      if (r0 + row < R) y[(bs + t0 + tt) * R + r0 + row] = sy[tt * RP + row];
    }
  }
}

// S == 1 (a decode step): the lanes and the per-step arithmetic of
// paged_ssm_kernel, without shared memory or barriers. A lane reads its
// row's dt and x and its states' B and C itself, alongside its slot's
// read page and plan, then its page rows (two dependent loads in all);
// the readout's sum over the row's lanes is the butterfly of the batched
// kernel's reduce-scatter (the same pairs in the same order), so a step's
// bits do not depend on which kernel ran it. Lanes past R run on row R-1
// (the shuffles need every lane) and store nothing.
template <int DS, bool DBX, bool kRow>
__global__ void __launch_bounds__(Lanes<DS>::NT)
paged_ssm_step_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ A, long long a_rs,
                      long long a_cs, float* h_pool,
                      const int* __restrict__ read_page,
                      const int* __restrict__ live,
                      const int* __restrict__ phys_w,
                      const int* __restrict__ t_w,
                      const int* __restrict__ n_new, float* __restrict__ y,
                      int R, int W) {
  using Ln = Lanes<DS>;
  constexpr int TPR = Ln::TPR, G = Ln::G;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane % TPR;
  const int r = blockIdx.x * Ln::RB + warp * Ln::RW + lane / TPR;
  const bool has_row = r < R;
  const int rr = has_row ? r : R - 1, s0 = lr * G;
  const size_t page_elems = (size_t)R * DS, o = (size_t)rr * DS + s0;
  const int* pw = phys_w + (size_t)b * W;
  const int* tw = t_w + (size_t)b * W;
  const int nn = n_new[b], rp = read_page[b];
  const int pw0 = W > 0 ? pw[0] : 0, tw0 = W > 0 ? tw[0] : -1;
  const bool lv = live[b] != 0;
  const float d = dt[(size_t)b * R + rr], xv = x[(size_t)b * R + rr];
  float bq[G], cq[G], h[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    bq[i] = Bm[(size_t)b * DS + s0 + i];
    cq[i] = Cm[(size_t)b * DS + s0 + i];
    h[i] = 0.f;
  }
  if (lv) ldv(h, h_pool + (size_t)rp * page_elems + o);
  if (nn > 0) {
    const float a0 = kRow ? expf(d * A[rr * a_rs]) : 0.f;
    const float dx = __fmul_rn(d, xv);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float a = kRow ? a0 : expf(d * A[rr * a_rs + (s0 + i) * a_cs]);
      const float term = DBX ? __fmul_rn(__fmul_rn(d, bq[i]), xv)
                             : __fmul_rn(dx, bq[i]);
      h[i] = __fmaf_rn(a, h[i], term);
    }
  }
  float p = __fmul_rn(h[0], cq[0]);
#pragma unroll
  for (int i = 1; i < G; ++i) p = __fmaf_rn(h[i], cq[i], p);
#pragma unroll
  for (int m = TPR / 2; m >= 1; m /= 2)
    p += __shfl_xor_sync(0xffffffffu, p, m);
  if (!has_row) return;
  if (lr == 0) y[(size_t)b * R + r] = p;
  // a decode step's plan has one window (the first read above with the
  // rest of the slot's scalars); any more are read here
  for (int w = 0; w < W; ++w) {
    const int page = w ? pw[w] : pw0, t = w ? tw[w] : tw0;
    if (page != 0 && t == 0) stv(h_pool + (size_t)page * page_elems + o, h);
  }
}

template <int DS, bool DBX, bool kRow>
int launch(const float* dt, const float* x, const float* Bm,
           const float* Cm, const float* A, long long a_rs, long long a_cs,
           float* h_pool, const int* read_page, const int* live,
           const int* phys_w, const int* t_w, const int* n_new, float* y,
           int B, int S, int R, int W, cudaStream_t stream) {
  using Ln = Lanes<DS>;
  const dim3 grid((R + Ln::RB - 1) / Ln::RB, B);
  if (S == 1) {
    paged_ssm_step_kernel<DS, DBX, kRow><<<grid, Ln::NT, 0, stream>>>(
        dt, x, Bm, Cm, A, a_rs, a_cs, h_pool, read_page, live, phys_w, t_w,
        n_new, y, R, W);
    return (int)cudaGetLastError();
  }
  constexpr size_t smem = sizeof(float) * Ln::smem_floats;
  static const int attr = (int)cudaFuncSetAttribute(
      paged_ssm_kernel<DS, DBX, kRow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr) return attr;
  paged_ssm_kernel<DS, DBX, kRow><<<grid, Ln::NT, smem, stream>>>(
          dt, x, Bm, Cm, A, a_rs, a_cs, h_pool, read_page, live, phys_w,
          t_w, n_new, y, S, R, W);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PS_ARGS                                                       \
  static_cast<const float*>(dt), static_cast<const float*>(x),             \
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),        \
      static_cast<const float*>(A), a_rs, a_cs, static_cast<float*>(h_pool), \
      static_cast<const int*>(read_page), static_cast<const int*>(live),   \
      static_cast<const int*>(phys_w), static_cast<const int*>(t_w),       \
      static_cast<const int*>(n_new), static_cast<float*>(y), B, S, R, W, st
  // mamba2's decay is one number a row (a stride-0 view): one exp a step
#define REPRO_PS_LAUNCH(DSV)                                                \
  return order == 0 ? launch<DSV, true, false>(REPRO_PS_ARGS)              \
         : a_cs == 0 ? launch<DSV, false, true>(REPRO_PS_ARGS)             \
                     : launch<DSV, false, false>(REPRO_PS_ARGS)
  switch (ds) {
    case 4: REPRO_PS_LAUNCH(4);
    case 8: REPRO_PS_LAUNCH(8);
    case 16: REPRO_PS_LAUNCH(16);
    case 32: REPRO_PS_LAUNCH(32);
    case 64: REPRO_PS_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_PS_LAUNCH
#undef REPRO_PS_ARGS
}
