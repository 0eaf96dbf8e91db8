// TOPSIS closeness kernels for Hopper (sm_90a).
//
// Ports of the four Pallas kernels in src/repro/kernels/topsis_pallas.py:
//
//   topsis_single_kernel   <- _topsis_kernel / topsis_closeness_blocks
//   topsis_batched_kernel  <- _topsis_batched_kernel / topsis_closeness_batched_blocks
//   topsis_kinds_kernel    <- _topsis_kinds_kernel / topsis_closeness_kinds_blocks
//   topsis_grid_kernel     <- _topsis_grid_kernel / topsis_closeness_grid_blocks
//
// Every kernel computes, per (pod, node) and over the criteria,
//   v   = x * inv_norm * w
//   d+- = ||v - a+-||_2
//   cc  = d- / max(d+ + d-, 1e-12), or 0.5 when d+ + d- <= 1e-12,
// with IEEE sqrtf and division (no fast-math), the criteria summed in
// order. For K2-K4, column norms, weight normalisation and the masked
// ideal points a+- are global reductions that the wrapper
// (repro_torch/kernels/ops.py) computes in plain torch; padded criteria
// carry zeros in inv_norm, w and a+-, so they add exact zeros. K1 does its
// own reductions and its own -inf fill (below).
//
// Layout. The TPU kernels keep criteria on sublanes and nodes on lanes,
// (8, N). Hopper has no lanes: here the criteria are row-major (..., N, 8)
// float32, each row 32 bytes.
//
// K1 (one per-pod GreenPod decision) is one launch of one thread block
// cluster of 16 CTAs of 512 threads (a compile-time size: of 8 and 16,
// 16 was the faster on an H100, PERF.md §6). The TPU design left the column
// norms and the masked ideal points to XLA because a Pallas grid cannot
// reduce across its blocks; a cluster can, through distributed shared
// memory. It takes the raw weights and the benefit bits
// by value (no upload), the (N,) mask or null and the number c of real
// criteria (a template on C, 1..8), and writes the (N,) closeness with -inf
// on invalid nodes. Each CTA owns a contiguous share of the rows, 4 nodes
// a thread.
//   * Pass A: each thread loads its 4 rows (real criteria only) and mask
//     bytes into registers and accumulates, per criterion, the sum of
//     squares over all rows and the max and min of x over valid rows, and
//     the count of valid rows; warp shuffles, then shared memory, reduce
//     them within the CTA, and every CTA reads the partials of all ranks
//     in rank order through distributed shared memory, so all derive the
//     same bits.
//   * Then inv_norm = 1 / max(sqrt(ss), 1e-12), w normalised by its sum
//     (in order), and a+- = fl(fl(x_ext * inv_norm) * w) from the extremes
//     of x: for inv_norm >= 0 rounding x * inv_norm is non-decreasing in x,
//     and rounding u * w monotone in u with w's sign, so these are the
//     floats masked_ideal_points gives on v (a zero's sign aside). No
//     valid row: a+- = -+inf and every output -inf.
//   * Pass B scores the rows still in registers (finish_quad, below) and
//     writes -inf where the mask is 0, 4 nodes a float4 streaming store
//     where N % 4 == 0. Past the rows the cluster holds on chip
//     (16 x 512 x 4: a share of more than one quad a thread) each CTA
//     loops over its share in both passes, re-reading its rows in pass B
//     (from L2).
//   Warps with no rows of the share skip both passes. Bound: ~25 bytes a
//   node, 0.11 us at N = 15,000 at 3.35 TB/s; on an H100 the kernel takes
//   ~5.6 us of device time at 16 CTAs (~6.9 at 8) against ~0.85 us for
//   an empty launch of the same cluster: a chain of latencies (the loads,
//   the reductions, the cluster barrier and the remote reads, pass B), not
//   bytes or instruction throughput, sets it.
//
// K2: one thread owns one (pod, node), reads its row as two float4 loads
// (neighbouring threads read neighbouring rows: coalesced) and writes one
// float; the grid is (ceil(N / 256), P) and a block's pod operands go to
// shared memory once. The wrapper writes -inf over infeasible nodes
// afterwards.
//
// K3 and K4 write 4 consecutive nodes a thread, as one float4 streaming
// store, and sum only the C real criteria (a template on C, 1..8). Both
// take the (P, N) feasibility mask, read as one 32-bit word per 4 nodes,
// and write -inf where it is 0: the fill K2's wrapper runs as a second
// pass over the output is fused into the store. Bound: an
// output is 4 bytes written against ~41 float32 instructions of its own
// (5 a real criterion, two IEEE square roots and one IEEE division at
// ~10 each) and ~20 of loads, tests and addressing, so both kernels are
// bound by instruction issue, not by bytes (~64 an output in K3, ~55 in
// K4). The designs keep the rest off that path:
//   * the square roots and the division take the branch-free sequences of
//     topsis_math.cuh, warp by warp, wherever they equal sqrtf and '/'
//     bit for bit (finish_quad), which drops the slow-path branches;
//   * K3 (the scheduling round): a block owns a tile of 128 nodes (a
//     warp's width) and a chunk of 96 pods, split among its 8 warps. It
//     stages the tile's rows of all K kinds, real criteria only,
//     transposed to (kind, criterion, node) in shared memory, and the
//     chunk's small operands and kind indices: each thread issues all of
//     its staging loads before it waits on any, and no thread waits on
//     more than that one round of loads before its first store. Each warp
//     then loops over its pods reading 4 nodes of a criterion as one
//     float4 (conflict-free). A kind tensor too large to stage is read
//     from global memory instead (STAGED = false, slower). A pod
//     whose kind is outside [0, K) gets NaN.
//   * K4 (the weight grid): a block owns 512 nodes of one pod. Each thread
//     reads and normalises its 4 rows and its 4 mask bytes once; the
//     schemes' (w, a+, a-) go to shared memory in chunks of 64 and are
//     read as broadcasts, each reused over the thread's 4 nodes.
//   * Where N % 4 != 0 a pod's row of the output is not 16-byte aligned:
//     VEC = false stores and reads the mask byte by byte; nodes past N are
//     never stored.
//
// C interface, loaded with ctypes by repro_torch/kernels/topsis_cuda.py.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on a good launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "topsis_math.cuh"

namespace cg = cooperative_groups;

// K1's weights and benefit bits, passed by value (no upload): w holds the
// raw weights of the c real criteria (the rest ignored), bit j of benefit
// is set when criterion j is a benefit (higher is better).
struct SingleWeights {
  float w[8];
  unsigned int benefit;
};

namespace {

constexpr int C_PAD = 8;
constexpr int BLOCK = 256;
constexpr float EPS = 1e-12f;
constexpr int QUAD = 4;                       // K3, K4: nodes a thread
// K3: K3_LANES threads side by side cover a tile of K3_TILE nodes; the
// block's K3_GROUPS such groups share the tile and split the pod chunk.
constexpr int K3_THREADS = 256;
constexpr int K3_LANES = 32;
constexpr int K3_TILE = QUAD * K3_LANES;
constexpr int K3_GROUPS = K3_THREADS / K3_LANES;
static_assert(K3_LANES % 32 == 0, "a pod group is whole warps");
static_assert(K3_THREADS % K3_TILE == 0, "whole tile rows a staging pass");
constexpr int POD_CHUNK = 96;                 // pods a block
constexpr int SMALL_PIECES = (POD_CHUNK * 8 + K3_THREADS - 1) / K3_THREADS;
constexpr int ROW_BATCH = 4;                  // kind rows in flight a thread
constexpr size_t STAGE_MAX_BYTES = 96 * 1024;  // staged kind rows, at most
// K1: one cluster of K1_CLUSTER CTAs of K1_THREADS threads, QUAD nodes a
// thread.
constexpr int K1_THREADS = 512;
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_CLUSTER = 16;                // past 8: non-portable
static_assert(K1_CLUSTER <= 16, "the largest cluster Hopper launches");
// K4
constexpr int K4_THREADS = 128;
constexpr int K4_TILE = QUAD * K4_THREADS;
constexpr int SCHEME_CHUNK = 64;              // schemes staged at a time

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float neg_inf_f() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         int64_t row, float (&r)[C_PAD]) {
  const float4* p = reinterpret_cast<const float4*>(x + row * C_PAD);
  const float4 lo = __ldg(p);
  const float4 hi = __ldg(p + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// The closeness of summed squared distances: square roots, the 1e-12 rule.
__device__ __forceinline__ float finish(float sp, float sn) {
  const float d_pos = sqrtf(sp);
  const float d_neg = sqrtf(sn);
  const float denom = d_pos + d_neg;
  return denom <= EPS ? 0.5f : d_neg / fmaxf(denom, EPS);
}

// u = x * inv_norm (the normalised row); weight, distances, closeness.
// K2's closeness routine, over all C_PAD criteria.
__device__ __forceinline__ float closeness(const float (&u)[C_PAD],
                                           const float* w,
                                           const float* a_pos,
                                           const float* a_neg) {
  float sp = 0.f, sn = 0.f;
#pragma unroll
  for (int c = 0; c < C_PAD; ++c) {
    const float v = u[c] * w[c];
    const float dp = v - a_pos[c];
    const float dn = v - a_neg[c];
    sp += dp * dp;
    sn += dn * dn;
  }
  return finish(sp, sn);
}

// finish() of QUAD nodes' sums. Every lane of the warp calls it; where
// every lane's sums are in sqrt_in's range (all but degenerate rows:
// distance 0, or no valid node) the warp takes the branch-free sequences
// of topsis_math.cuh, else finish() for the quad: the same bits either
// way.
__device__ __forceinline__ void finish_quad(const float (&sp)[QUAD],
                                            const float (&sn)[QUAD],
                                            float (&cc)[QUAD]) {
  bool fast = true;
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    fast &= sqrt_in_range(sp[j]) & sqrt_in_range(sn[j]);
  if (__all_sync(0xffffffffu, fast)) {
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
      const float d_pos = sqrt_in(sp[j]);
      const float d_neg = sqrt_in(sn[j]);
      const float denom = d_pos + d_neg;
      cc[j] = denom <= EPS ? 0.5f : div_in(d_neg, denom);
    }
  } else {
#pragma unroll
    for (int j = 0; j < QUAD; ++j) cc[j] = finish(sp[j], sn[j]);
  }
}

// K1, K3 and K4's closeness routine: QUAD nodes' normalised rows u[c][j]
// against one operand set, over the C real criteria in order.
template <int C>
__device__ __forceinline__ void score_quad(const float (&u)[C][QUAD],
                                           const float* w,
                                           const float* a_pos,
                                           const float* a_neg,
                                           float (&cc)[QUAD]) {
  float sp[QUAD] = {}, sn[QUAD] = {};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float wc = w[c], ap = a_pos[c], an = a_neg[c];
#pragma unroll
    for (int j = 0; j < QUAD; ++j) {
      const float v = u[c][j] * wc;
      const float dp = v - ap;
      const float dn = v - an;
      sp[j] += dp * dp;
      sn[j] += dn * dn;
    }
  }
  finish_quad(sp, sn, cc);
}

// Mask bytes of nodes o .. o + 3 of a (P, N) row-major mask (null: all
// valid), of the cnt nodes that exist: VEC reads them as one aligned
// 32-bit word (cnt is then 0 or 4), else byte by byte.
template <bool VEC>
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ valid,
                                              int64_t o, int cnt) {
  if (valid == nullptr) return 0x01010101u;
  if (VEC)
    return cnt ? __ldg(reinterpret_cast<const unsigned int*>(valid + o)) : 0u;
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    if (j < cnt) m |= uint32_t(__ldg(valid + o + j)) << (8 * j);
  return m;
}

// -inf where the mask byte is 0, then a streaming store of the cnt nodes
// (the output is next read by the device-to-host copy, not by this
// kernel).
template <bool VEC>
__device__ __forceinline__ void store_quad(float* __restrict__ out, int64_t o,
                                           int cnt, uint32_t mask,
                                           const float (&cc)[QUAD]) {
  float r[QUAD];
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    r[j] = (mask >> (8 * j)) & 0xffu ? cc[j] : neg_inf_f();
  if (VEC) {
    if (cnt)
      __stcs(reinterpret_cast<float4*>(out + o),
             make_float4(r[0], r[1], r[2], r[3]));
  } else {
#pragma unroll
    for (int j = 0; j < QUAD; ++j)
      if (j < cnt) __stcs(out + o + j, r[j]);
  }
}

// Loads one pod's four (C_PAD,) small operands into shared memory:
// s[0:8] inv_norm, s[8:16] w, s[16:24] a_pos, s[24:32] a_neg.
__device__ __forceinline__ void load_small(float* s, int64_t pod,
                                           const float* __restrict__ inv_norm,
                                           const float* __restrict__ w,
                                           const float* __restrict__ a_pos,
                                           const float* __restrict__ a_neg) {
  const int t = threadIdx.x;
  if (t < 4 * C_PAD) {
    const float* src = t < C_PAD ? inv_norm
                     : t < 2 * C_PAD ? w
                     : t < 3 * C_PAD ? a_pos : a_neg;
    s[t] = src[pod * C_PAD + (t % C_PAD)];
  }
  __syncthreads();
}

__device__ __forceinline__ float score_row(const float* __restrict__ x,
                                           int64_t row, const float* s) {
  float u[C_PAD];
  load_row(x, row, u);
#pragma unroll
  for (int c = 0; c < C_PAD; ++c) u[c] *= s[c];
  return closeness(u, s + C_PAD, s + 2 * C_PAD, s + 3 * C_PAD);
}

// --- K1 ------------------------------------------------------------------------
// The cluster barrier, split: arrive releases this thread's writes to
// shared memory (and marks it done reading the others'), wait acquires
// every CTA's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The C real criteria of the cnt rows row0 .. row0 + cnt - 1 (zeros past
// cnt): one float4 a row, two where C > 4.
template <int C>
__device__ __forceinline__ void load_quad_rows(const float* __restrict__ x,
                                               int64_t row0, int cnt,
                                               float (&r)[QUAD][C]) {
#pragma unroll
  for (int j = 0; j < QUAD; ++j) {
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (j < cnt) {
      const float4* p = reinterpret_cast<const float4*>(x + (row0 + j) * C_PAD);
      lo = __ldg(p);
      if (C > 4) hi = __ldg(p + 1);
    }
    const float v[C_PAD] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int c = 0; c < C; ++c) r[j][c] = v[c];
  }
}

// Pass A over one quad: the sums of squares over every row that exists
// (rows past cnt are zeros and add 0), the extremes and the count over
// the valid ones.
template <int C>
__device__ __forceinline__ void accumulate_quad(const float (&r)[QUAD][C],
                                                int cnt, uint32_t mask,
                                                float (&ss)[C], float (&hi)[C],
                                                float (&lo)[C], int& nvalid) {
#pragma unroll
  for (int j = 0; j < QUAD; ++j) {
    const bool ok = j < cnt && ((mask >> (8 * j)) & 0xffu);
    nvalid += ok;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ss[c] += r[j][c] * r[j][c];
      if (ok) {
        hi[c] = fmaxf(hi[c], r[j][c]);
        lo[c] = fminf(lo[c], r[j][c]);
      }
    }
  }
}

// K1: one (N, 8) matrix -> (N,) closeness, the reductions and the -inf
// fill fused; launched as one cluster (grid = cluster). valid: the (N,)
// mask or null.
template <int C, bool VEC>
__global__ void __launch_bounds__(K1_THREADS, 1)
topsis_single_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int n, SingleWeights wts) {
  // partials: per criterion the sum of squares, the max, the min (3 C),
  // then the count of valid rows (as a float: exact to 2^24, and only
  // whether it is 0 is read)
  constexpr int NP = 3 * C + 1;
  __shared__ float part[K1_WARPS][NP];      // one row a warp
  __shared__ float cta[NP];                 // this CTA's, read cluster-wide
  __shared__ float all[K1_CLUSTER][NP];     // every rank's, copied here
  __shared__ float ops[4][C];               // inv_norm, w, a_pos, a_neg

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int ranks = K1_CLUSTER;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int quads = (n + QUAD - 1) / QUAD;
  const int per = (quads + ranks - 1) / ranks;
  const int64_t start = int64_t(rank) * per;
  const int q0 = start < quads ? int(start) : quads;
  const int q1 = min(quads, q0 + per);
  // every CTA's share is at most one quad a thread: its rows stay in
  // registers between the passes
  const bool resident = per <= K1_THREADS;

  // --- pass A: per-thread partials
  float ss[C], hi[C], lo[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ss[c] = 0.f;
    hi[c] = neg_inf_f();
    lo[c] = -neg_inf_f();
  }
  int nvalid = 0;
  float r[QUAD][C];
  uint32_t mask = 0;
  int cnt = 0;
  // A warp whose first quad is past the share has nothing in either pass
  // and skips both (it keeps the identities above). The loop runs the same
  // number of times in every lane of a warp (finish_quad's warp vote);
  // resident, it runs at most once and leaves r, mask, cnt for pass B.
  const bool idle = q0 + warp * 32 >= q1;
  if (!idle)
    for (int base = q0; base < q1; base += K1_THREADS) {
      const int q = base + t;
      cnt = q < q1 ? min(QUAD, n - q * QUAD) : 0;
      load_quad_rows<C>(x, int64_t(q) * QUAD, cnt, r);
      mask = load_mask<VEC>(valid, int64_t(q) * QUAD, cnt);
      accumulate_quad<C>(r, cnt, mask, ss, hi, lo, nvalid);
    }

  // within the CTA: each warp by shuffles, then each partial over the
  // K1_WARPS warps by a half-warp of shuffles (a tree: any fixed order
  // will do, since every CTA reads this CTA's result, not its own)
  static_assert(K1_WARPS == 16, "one half-warp a partial");
  static_assert(NP * K1_WARPS <= K1_THREADS, "a thread a warp's partial");
  float cnt_f = 0.f;
  if (!idle) {
    cnt_f = (float)warp_sum(nvalid);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ss[c] = warp_sum(ss[c]);
      hi[c] = warp_max(hi[c]);
      lo[c] = warp_min(lo[c]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      part[warp][c] = ss[c];
      part[warp][C + c] = hi[c];
      part[warp][2 * C + c] = lo[c];
    }
    part[warp][3 * C] = cnt_f;
  }
  __syncthreads();
  {
    const int v = t / K1_WARPS, w = t % K1_WARPS;   // a half-warp a v
    float a = v < NP ? part[w][v] : 0.f;
#pragma unroll
    for (int o = K1_WARPS / 2; o; o >>= 1) {
      const float b = __shfl_xor_sync(0xffffffffu, a, o);
      a = v < C ? a + b : v < 2 * C ? fmaxf(a, b)
        : v < 3 * C ? fminf(a, b) : a + b;
    }
    if (v < NP && w == 0) cta[v] = a;
  }
  cluster_arrive();
  cluster_wait();

  // across the cluster: one remote read a thread, every rank's partials
  // into this CTA's shared memory at once; then every CTA combines the
  // ranks in rank order, so every CTA derives the same inv_norm, w, a+-
  if (t < ranks * NP)
    all[t / NP][t % NP] = cluster.map_shared_rank(cta, t / NP)[t % NP];
  __syncthreads();
  // done with the cluster's shared memory; no CTA exits before every CTA
  // has arrived (the wait at the end)
  cluster_arrive();
  if (t < C) {
    float s = 0.f, h = neg_inf_f(), l = -neg_inf_f(), nv = 0.f;
#pragma unroll
    for (int q = 0; q < ranks; ++q) {
      s += all[q][t];
      h = fmaxf(h, all[q][C + t]);
      l = fminf(l, all[q][2 * C + t]);
      nv += all[q][3 * C];
    }
    float wsum = 0.f, wt = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {   // constant indices: wts stays in params
      wsum += wts.w[c];
      if (c == t) wt = wts.w[c];
    }
    const float w = wt / fmaxf(wsum, EPS);
    const float inv = 1.f / fmaxf(sqrtf(s), EPS);
    const bool ben = (wts.benefit >> t) & 1u;
    float a_pos, a_neg;
    if (nv == 0.f) {
      a_pos = ben ? neg_inf_f() : -neg_inf_f();
      a_neg = -a_pos;
    } else {
      const float u_hi = h * inv, u_lo = l * inv;
      const float v_hi = w >= 0.f ? u_hi * w : u_lo * w;
      const float v_lo = w >= 0.f ? u_lo * w : u_hi * w;
      a_pos = ben ? v_hi : v_lo;
      a_neg = ben ? v_lo : v_hi;
    }
    ops[0][t] = inv;
    ops[1][t] = w;
    ops[2][t] = a_pos;
    ops[3][t] = a_neg;
  }
  __syncthreads();

  // --- pass B: score the rows, -inf where invalid
  for (int base = q0; !idle && base < q1; base += K1_THREADS) {
    const int q = base + t;
    if (!resident) {
      cnt = q < q1 ? min(QUAD, n - q * QUAD) : 0;
      load_quad_rows<C>(x, int64_t(q) * QUAD, cnt, r);
      mask = load_mask<VEC>(valid, int64_t(q) * QUAD, cnt);
    }
    float u[C][QUAD];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < QUAD; ++j) u[c][j] = r[j][c] * ops[0][c];
    float cc[QUAD];
    score_quad<C>(u, ops[1], ops[2], ops[3], cc);
    store_quad<VEC>(out, int64_t(q) * QUAD, cnt, mask, cc);
  }
  cluster_wait();
}

// The launch floor of K1's shape: an empty kernel, one cluster (one unused
// parameter: a launch takes at least one).
__global__ void __launch_bounds__(K1_THREADS, 1)
topsis_cluster_floor_kernel(int) {}

// K2: a (P, N, 8) queue tensor, per-pod small operands (P, 8) -> (P, N).
__global__ void __launch_bounds__(BLOCK)
topsis_batched_kernel(const float* __restrict__ x,
                      const float* __restrict__ inv_norm,
                      const float* __restrict__ w,
                      const float* __restrict__ a_pos,
                      const float* __restrict__ a_neg,
                      float* __restrict__ out, int n) {
  __shared__ float s[4 * C_PAD];
  const int64_t pod = blockIdx.y;
  load_small(s, pod, inv_norm, w, a_pos, a_neg);
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i < n) out[pod * n + i] = score_row(x, pod * n + i, s);
}

// K3: a (K, N, 8) per-kind tensor plus kind_idx (P,) -> (P, N). Pod p
// reads the criteria rows of kind kind_idx[p]; a kind outside [0, K)
// gives NaN over the pod's row instead of reading out of bounds. valid is
// the (P, N) mask or null. Grid (ceil(N / K3_TILE), ceil(P / POD_CHUNK));
// STAGED: dynamic shared memory of K * C * K3_TILE floats.
template <int C, bool VEC, bool STAGED>
__global__ void __launch_bounds__(K3_THREADS)
topsis_kinds_kernel(const int32_t* __restrict__ kind_idx, int k,
                    const float* __restrict__ x,
                    const float* __restrict__ inv_norm,
                    const float* __restrict__ w,
                    const float* __restrict__ a_pos,
                    const float* __restrict__ a_neg,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int n, int p) {
  extern __shared__ float4 staged4[];
  __shared__ __align__(16) float small[POD_CHUNK][4 * C_PAD];
  __shared__ int kinds[POD_CHUNK];
  float* staged = reinterpret_cast<float*>(staged4);
  const int t = threadIdx.x;
  const int tile0 = blockIdx.x * K3_TILE;
  const int pod0 = blockIdx.y * POD_CHUNK;
  const int pods = min(POD_CHUNK, p - pod0);

  // Staging: every load a thread makes is issued before any is waited on.
  // The small operands as float4 pieces (8 a pod: 2 of each operand).
#pragma unroll
  for (int j = 0; j < SMALL_PIECES; ++j) {
    const int i = t + j * K3_THREADS;
    if (i < pods * 8) {
      const int q = i / 8, part = i % 8, op = part / 2;
      const float* src = op == 0 ? inv_norm : op == 1 ? w
                       : op == 2 ? a_pos : a_neg;
      *reinterpret_cast<float4*>(&small[q][4 * part]) = __ldg(
          reinterpret_cast<const float4*>(src + int64_t(pod0 + q) * C_PAD)
          + part % 2);
    }
  }
  for (int i = t; i < pods; i += K3_THREADS)
    kinds[i] = __ldg(kind_idx + pod0 + i);
  if (STAGED) {
    // the tile's rows of every kind, ROW_BATCH kinds a thread at a time
    constexpr int STRIDE = K3_THREADS / K3_TILE;
    const int node = t % K3_TILE;
    const bool in = tile0 + node < n;
    for (int kind0 = t / K3_TILE; kind0 < k; kind0 += ROW_BATCH * STRIDE) {
      float r[ROW_BATCH][C_PAD] = {};
#pragma unroll
      for (int b = 0; b < ROW_BATCH; ++b)
        if (in && kind0 + b * STRIDE < k)
          load_row(x, int64_t(kind0 + b * STRIDE) * n + tile0 + node, r[b]);
#pragma unroll
      for (int b = 0; b < ROW_BATCH; ++b)
        if (kind0 + b * STRIDE < k)
#pragma unroll
          for (int c = 0; c < C; ++c)
            staged[((kind0 + b * STRIDE) * C + c) * K3_TILE + node] = r[b][c];
    }
  }
  __syncthreads();

  // lanes past N run the loop on zero rows (finish_quad wants the whole
  // warp) and store nothing
  const int node0 = (t % K3_LANES) * QUAD;
  const int64_t g0 = int64_t(tile0) + node0;
  const int cnt = g0 < n ? min(QUAD, n - int(g0)) : 0;
  for (int q = t / K3_LANES; q < pods; q += K3_GROUPS) {
    const int64_t o = int64_t(pod0 + q) * n + g0;
    const uint32_t mask = load_mask<VEC>(valid, o, cnt);
    const int kind = kinds[q];
    const float* s = small[q];
    float cc[QUAD];
    if (kind < 0 || kind >= k) {
#pragma unroll
      for (int j = 0; j < QUAD; ++j) cc[j] = nan_f();
    } else {
      float u[C][QUAD];
      if (STAGED) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(
              staged + (kind * C + c) * K3_TILE + node0);
          u[c][0] = xv.x * s[c]; u[c][1] = xv.y * s[c];
          u[c][2] = xv.z * s[c]; u[c][3] = xv.w * s[c];
        }
      } else {
#pragma unroll
        for (int j = 0; j < QUAD; ++j) {
          float r[C_PAD] = {};
          if (j < cnt) load_row(x, int64_t(kind) * n + g0 + j, r);
#pragma unroll
          for (int c = 0; c < C; ++c) u[c][j] = r[c] * s[c];
        }
      }
      score_quad<C>(u, s + C_PAD, s + 2 * C_PAD, s + 3 * C_PAD, cc);
    }
    store_quad<VEC>(out, o, cnt, mask, cc);
  }
}

// K4: a (P, N, 8) queue tensor under S weight schemes. inv_norm is per pod
// (P, 8); w, a_pos and a_neg are per (scheme, pod), (S, P, 8); valid is
// the (P, N) mask, shared by every scheme, or null. Output (S, P, N).
// Grid (ceil(N / K4_TILE), P). The rows and mask are read and the rows
// normalised once, then scored S times.
template <int C, bool VEC>
__global__ void __launch_bounds__(K4_THREADS)
topsis_grid_kernel(const float* __restrict__ x,
                   const float* __restrict__ inv_norm,
                   const float* __restrict__ w,
                   const float* __restrict__ a_pos,
                   const float* __restrict__ a_neg,
                   const uint8_t* __restrict__ valid,
                   float* __restrict__ out, int n, int p, int s_count) {
  __shared__ __align__(16) float ops[SCHEME_CHUNK][3 * C_PAD];
  __shared__ float inv[C_PAD];
  const int t = threadIdx.x;
  const int64_t pod = blockIdx.y;
  const int64_t g0 = (int64_t(blockIdx.x) * K4_THREADS + t) * QUAD;
  const int cnt = g0 < n ? min(QUAD, n - int(g0)) : 0;
  const int64_t o = pod * n + g0;

  float r[QUAD][C_PAD] = {};
#pragma unroll
  for (int j = 0; j < QUAD; ++j)
    if (j < cnt) load_row(x, o + j, r[j]);
  const uint32_t mask = load_mask<VEC>(valid, o, cnt);
  if (t < C_PAD) inv[t] = __ldg(inv_norm + pod * C_PAD + t);
  __syncthreads();
  float u[C][QUAD];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < QUAD; ++j) u[c][j] = r[j][c] * inv[c];

  for (int s0 = 0; s0 < s_count; s0 += SCHEME_CHUNK) {
    const int sc = min(SCHEME_CHUNK, s_count - s0);
    __syncthreads();                  // every thread is done with ops
    for (int i = t; i < sc * 3 * C_PAD; i += K4_THREADS) {
      const int q = i / (3 * C_PAD), rr = i % (3 * C_PAD);
      const float* src = rr < C_PAD ? w : rr < 2 * C_PAD ? a_pos : a_neg;
      ops[q][rr] = __ldg(src + (int64_t(s0 + q) * p + pod) * C_PAD
                         + rr % C_PAD);
    }
    __syncthreads();
    for (int q = 0; q < sc; ++q) {
      float cc[QUAD];
      score_quad<C>(u, ops[q], ops[q] + C_PAD, ops[q] + 2 * C_PAD, cc);
      store_quad<VEC>(out, (int64_t(s0 + q) * p) * n + o, cnt, mask, cc);
    }
  }
}

inline dim3 grid_for(int n, int p) {
  return dim3((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)p);
}

inline unsigned tiles(int n, int tile) {
  return (unsigned)((n + tile - 1) / tile);
}

// One cluster of K1_CLUSTER CTAs (grid = cluster). Past 8 CTAs a kernel
// must be allowed a non-portable cluster size: once per kernel and device.
template <auto Kernel, typename... Args>
int launch_cluster(int device, cudaStream_t st, Args... args) {
  static std::atomic<uint64_t> allowed{0};
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (K1_CLUSTER > 8 && !(allowed.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)K1_CLUSTER);
  cfg.blockDim = dim3(K1_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K1_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

struct SingleArgs {
  const float* x; const uint8_t* valid; float* out; int n; SingleWeights wts;
  int device;
};

template <int C>
int single_for_c(const SingleArgs& a, cudaStream_t st) {
  if (a.n % QUAD == 0)
    return launch_cluster<topsis_single_kernel<C, true>>(
        a.device, st, a.x, a.valid, a.out, a.n, a.wts);
  return launch_cluster<topsis_single_kernel<C, false>>(
      a.device, st, a.x, a.valid, a.out, a.n, a.wts);
}

struct KindsArgs {
  const int32_t* kind_idx; int k; const float* x; const float* inv_norm;
  const float* w; const float* a_pos; const float* a_neg;
  const uint8_t* valid; float* out; int n; int p;
};

template <int C, bool VEC, bool STAGED>
int launch_kinds(const KindsArgs& a, cudaStream_t st) {
  const size_t smem = STAGED ? size_t(a.k) * C * K3_TILE * sizeof(float) : 0;
  auto kernel = topsis_kinds_kernel<C, VEC, STAGED>;
  if (smem)   // past the default limit of 48 KB less the static arrays
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid(tiles(a.n, K3_TILE),
                  (unsigned)((a.p + POD_CHUNK - 1) / POD_CHUNK));
  kernel<<<grid, K3_THREADS, smem, st>>>(a.kind_idx, a.k, a.x, a.inv_norm,
                                           a.w, a.a_pos, a.a_neg, a.valid,
                                           a.out, a.n, a.p);
  return (int)cudaGetLastError();
}

template <int C>
int kinds_for_c(const KindsArgs& a, cudaStream_t st) {
  const bool vec = a.n % QUAD == 0;
  const bool staged =
      size_t(a.k) * C * K3_TILE * sizeof(float) <= STAGE_MAX_BYTES;
  if (vec)
    return staged ? launch_kinds<C, true, true>(a, st)
                  : launch_kinds<C, true, false>(a, st);
  return staged ? launch_kinds<C, false, true>(a, st)
                : launch_kinds<C, false, false>(a, st);
}

struct GridArgs {
  const float* x; const float* inv_norm; const float* w; const float* a_pos;
  const float* a_neg; const uint8_t* valid; float* out; int n; int p; int s;
};

template <int C>
int grid_for_c(const GridArgs& a, cudaStream_t st) {
  const dim3 grid(tiles(a.n, K4_TILE), (unsigned)a.p);
  if (a.n % QUAD == 0)
    topsis_grid_kernel<C, true><<<grid, K4_THREADS, 0, st>>>(
        a.x, a.inv_norm, a.w, a.a_pos, a.a_neg, a.valid, a.out, a.n, a.p,
        a.s);
  else
    topsis_grid_kernel<C, false><<<grid, K4_THREADS, 0, st>>>(
        a.x, a.inv_norm, a.w, a.a_pos, a.a_neg, a.valid, a.out, a.n, a.p,
        a.s);
  return (int)cudaGetLastError();
}

// One instantiation per number of real criteria, indexed by C - 1.
using SingleFn = int (*)(const SingleArgs&, cudaStream_t);
using KindsFn = int (*)(const KindsArgs&, cudaStream_t);
using GridFn = int (*)(const GridArgs&, cudaStream_t);
constexpr SingleFn SINGLE_BY_C[C_PAD] = {
    single_for_c<1>, single_for_c<2>, single_for_c<3>, single_for_c<4>,
    single_for_c<5>, single_for_c<6>, single_for_c<7>, single_for_c<8>};
constexpr KindsFn KINDS_BY_C[C_PAD] = {
    kinds_for_c<1>, kinds_for_c<2>, kinds_for_c<3>, kinds_for_c<4>,
    kinds_for_c<5>, kinds_for_c<6>, kinds_for_c<7>, kinds_for_c<8>};
constexpr GridFn GRID_BY_C[C_PAD] = {
    grid_for_c<1>, grid_for_c<2>, grid_for_c<3>, grid_for_c<4>,
    grid_for_c<5>, grid_for_c<6>, grid_for_c<7>, grid_for_c<8>};

}  // namespace

extern "C" {

// K1: x (N, 8), valid (N,) or null, out (N,); wts by value; c real
// criteria (1..8).
int topsis_single(const float* x, const uint8_t* valid, float* out, int n,
                  SingleWeights wts, int c, int device, void* stream) {
  if (c < 1 || c > C_PAD) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return SINGLE_BY_C[c - 1](SingleArgs{x, valid, out, n, wts, device},
                            (cudaStream_t)stream);
}

// K1's launch floor: the empty kernel in K1's cluster shape.
int topsis_cluster_floor(int device, void* stream) {
  cudaSetDevice(device);
  return launch_cluster<topsis_cluster_floor_kernel>(
      device, (cudaStream_t)stream, 0);
}

int topsis_batched(const float* x, const float* inv_norm, const float* w,
                   const float* a_pos, const float* a_neg, float* out, int n,
                   int p, int device, void* stream) {
  cudaSetDevice(device);
  topsis_batched_kernel<<<grid_for(n, p), BLOCK, 0, (cudaStream_t)stream>>>(
      x, inv_norm, w, a_pos, a_neg, out, n);
  return (int)cudaGetLastError();
}

// c: the number of real criteria, 1..8 (the rows stay 8 wide); valid: the
// (P, N) bool mask or null.
int topsis_kinds(const int32_t* kind_idx, int k, const float* x,
                 const float* inv_norm, const float* w, const float* a_pos,
                 const float* a_neg, const uint8_t* valid, float* out, int n,
                 int p, int c, int device, void* stream) {
  if (c < 1 || c > C_PAD) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return KINDS_BY_C[c - 1](
      KindsArgs{kind_idx, k, x, inv_norm, w, a_pos, a_neg, valid, out, n, p},
      (cudaStream_t)stream);
}

int topsis_grid(const float* x, const float* inv_norm, const float* w,
                const float* a_pos, const float* a_neg, const uint8_t* valid,
                float* out, int n, int p, int s, int c, int device,
                void* stream) {
  if (c < 1 || c > C_PAD) return (int)cudaErrorInvalidValue;
  cudaSetDevice(device);
  return GRID_BY_C[c - 1](
      GridArgs{x, inv_norm, w, a_pos, a_neg, valid, out, n, p, s},
      (cudaStream_t)stream);
}

const char* topsis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
