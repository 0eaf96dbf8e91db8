// Flash-attention forward for Hopper (sm_90a): K5 of the port.
//
// Replaces the Pallas kernel _flash_kernel / flash_attention_blocks in
// src/repro/kernels/flash_attention.py. It computes what that kernel
// computes, not its block structure:
//
//   s   = q . k^T * sm_scale                       in float32
//   mask: key < kv_len, key <= query (causal), key > query - window
//   m   = running max of the masked s (NEG_BIG where nothing is valid)
//   p   = exp(s - m) on valid keys, 0 elsewhere    (float32 through P.V)
//   out = acc / max(l, 1e-30)  in q's dtype,  lse = m + log(max(l, 1e-30))
//
// with GQA: query head h reads key/value head h / (H / Hkv). One block per
// (query tile, batch * head), longest tiles first; a loop over key tiles
// of BK = 64 rows with online softmax (the TPU kernel runs its key axis as
// the sequential innermost grid dimension and carries (m, l, acc) in VMEM
// scratch; here the loop runs inside the block and the carry lives in
// registers). Key tiles wholly above the causal diagonal, wholly before the
// window, or past kv_len are skipped, not masked; nothing is padded along
// S, and rows past Sq are never stored.
//
// Bound. At the serving shape (B=4, H=32, Hkv=8, S=2048, D=128, bf16,
// causal) the work is 4*D operations per valid pair, ~1.4e11 against ~168
// MB of traffic: the card's limit is operations, 139 us at the bf16
// tensor-core peak (50 us for the bytes).
//
// bf16 (the main path): tensor cores. Each of the block's 4 warps owns 16
// query rows (BQ = 64; 8 warps and 128 rows measured slower). The q strip
// stays in shared memory and is read by ldmatrix at each k-step: held in
// registers for the whole loop, it spilled at D = 128 and ran slower. K and
// V tiles are bf16 in shared memory (pitched rows, see mma_bf16.cuh),
// double-buffered: cp.async brings tile j+1 while tile j is computed, one
// barrier per tile. s = q.k^T runs on mma.sync m16n8k16 (bf16 x bf16
// products are exact in float32, the sums float32) and is scaled after the
// product. The online softmax works on the accumulator fragments (a row's
// 4 lanes reduce by 2 shuffles) and masks only in tiles that cross the
// diagonal, the window edge or kv_len. p never goes to shared memory: the
// accumulator layout is the next product's A layout, so p is split in
// registers into hi = bf16(p) and lo = bf16(p - hi) and P.V runs as two
// MMAs: about 16 bits of p, where bf16(p) would keep 8, at 1.5x the tensor
// work the bound counts (2*D + 2*(2*D) per pair against 4*D). Each tile's
// P.V goes into a fresh accumulator, added to O by one FFMA with the
// rescale. At D = 128 the block holds 85 KB of shared memory: two blocks
// per SM.
//
// D = 256 (gemma-7b): a warp's whole O would be 128 floats a lane, and
// beside S and p it spilled (348 bytes) whatever the key tile or unrolling.
// So 8 warps share the block, two to each 16-row strip, each holding half
// of O's columns (64 floats). Each computes q.k^T over its half of D; the
// pair swaps the partial sums through shared memory (behind a barrier of
// the two warps; the block barrier of the next key tile frees the slots),
// and each adds the other's: s0 + s1 is the same bits in both, so both
// hold the same S, m, l and p, and each takes P.V for its columns. 197 KB,
// one block of 8 warps an SM. Each warp computing all of S itself (no
// swap), and key tiles of 32 with the swap, ran slower in development
// builds (not kept). The work a pair is twice D = 128's: at gemma's
// serving shape (B=4, H=16, S=2048) the bound is llama's.
//
// float32: the FMA kernel of the first port (CUDA cores, q^T, k^T and p^T
// transposed in shared memory as float32). On tensor cores float32 inputs
// would need q, k and v split as well; it is the instantiation that
// chip_smoke's tight float32 checks (serving in float32) hold. At D = 256
// its tiles take 217 KB: one block an SM.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128, 256). C interface, loaded with ctypes by
// repro_torch/kernels/flash_cuda.py; the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;   // row pitch of Q^T and P^T (floats)
constexpr int KS = BK + 4;   // row pitch of K^T
constexpr float NEG_BIG = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int h, hkv, sq, skv, kv_len, window;  // window <= 0: none
  int causal;
  float sm_scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
};

template <int D>
constexpr int smem_fma() {
  return (int)sizeof(float) * (D * QS + D * KS + BK * D + BK * QS);
}

// float32: thread (ty, tx) = (tid / 16, tid % 16) of THREADS owns query
// rows 4*ty .. 4*ty+3 of the BQ-row tile: the 4x4 block of S at key columns
// 4*tx .. 4*tx+3, and output columns tx + 16*c (c < D/16) of those rows.
// The 16 threads that share a row are 16 consecutive lanes of one warp, so
// the row max and row sum are 4 shuffles. Q^T, K^T and P^T sit in shared
// memory transposed and padded so that every inner-loop read is a float4
// that is either broadcast or conflict-free; V sits row-major.
template <typename T, int D>
__device__ __forceinline__ void fwd_fma(const Params& p) {
  constexpr int DN = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // D x QS, q^T * sm_scale
  float* Kt = Qt + D * QS;                      // D x KS, k^T
  float* Vs = Kt + D * KS;                      // BK x D
  float* Pt = Vs + BK * D;                      // BK x QS, p^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int hk = h / (p.h / p.hkv);
  const int q0 = iq * BQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    Qt[d * QS + r] = q0 + r < p.sq
        ? to_f32(qg[(int64_t)(q0 + r) * p.q_ss + d]) * p.sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  int k_end = min(p.kv_len, p.skv);
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's K, V, P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < p.skv;
      Kt[d * KS + r] = in ? to_f32(kg[(int64_t)(k0 + r) * p.k_ss + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vg[(int64_t)(k0 + r) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * QS + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * KS + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float rmax = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        ok[j] = kj < p.kv_len && kj < p.skv;
        if (p.causal) ok[j] = ok[j] && kj <= qi;
        if (p.window > 0) ok[j] = ok[j] && kj > qi - p.window;
        if (!ok[j]) s[i][j] = NEG_BIG;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(4 * tx + j) * QS + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(&Pt[kk * QS + 4 * ty]);
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
        acc[0][c] = fmaf(pp.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pp.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pp.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pp.w, vv, acc[3][c]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DN; ++c)
      store(&og[(int64_t)r * p.o_ss + tx + 16 * c], acc[i][c] / lm);
    if (tx == 0)
      p.lse[((int64_t)b * p.h + h) * p.sq + r] = m[i] + logf(lm);
  }
}


// bf16: BQ / 16 warps, each 16 query rows of the tile; lane (g, t) =
// (lane / 4, lane % 4) holds rows g and g + 8 of its warp's strip. At
// D > 128 (FwdTc::SPLIT) two warps share each strip (8 warps), each
// holding half of O's columns (the header).
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct FwdTc {
  static constexpr bool SPLIT = D > 128;
  static constexpr int WARPS = SPLIT ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int DH = SPLIT ? D / 2 : D;   // O columns a warp
  static constexpr int MIN_BLOCKS = SPLIT ? 1 : 2;
  // floats of the partial-S exchange: (strip, half) x a lane's BK / 8
  // accumulator tiles x 32 lanes
  static constexpr int XCH = SPLIT ? 4 * 2 * (BK / 2) * 32 : 0;
};

template <int D>
constexpr int smem_tc() {
  return (int)sizeof(__nv_bfloat16) * (BQ + 4 * BK) *
             mma_bf16::Tile<D>::PITCH +
         (int)sizeof(float) * FwdTc<D>::XCH;
}

template <int D>
__device__ __forceinline__ void fwd_tc(const Params& p) {
  using namespace mma_bf16;
  using bf16 = __nv_bfloat16;
  using C = FwdTc<D>;
  constexpr int PITCH = Tile<D>::PITCH;
  constexpr int KD = C::DH / 16;  // k-steps of q.k^T (a warp's half of D)
  constexpr int ND = C::DH / 8;   // 8-column tiles of the warp's O
  constexpr int NK = BK / 8;      // 8-column tiles of S
  constexpr int NT = C::THREADS;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // BQ x PITCH
  bf16* Ks = Qs + BQ * PITCH;                 // 2 x BK x PITCH
  bf16* Vs = Ks + 2 * BK * PITCH;             // 2 x BK x PITCH
  float* Xs = reinterpret_cast<float*>(Vs + 2 * BK * PITCH);  // C::XCH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp & 3;                 // the warp's 16 rows
  const int half = C::SPLIT ? warp >> 2 : 0;  // its half of D
  const int d0 = half * C::DH;
  const int iq = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int hk = h / (p.h / p.hkv);
  const int q0 = iq * BQ;
  const int qw = q0 + 16 * strip;               // the warp's first row
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_end = min(p.kv_len, p.skv);
  int k_end = kv_end;
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<BQ, D, NT>(Qs, qg, p.q_ss, q0, p.sq);
  if (n_tiles > 0) {
    load_tile<BK, D, NT>(Ks, kg, p.k_ss, k_begin, p.skv);
    load_tile<BK, D, NT>(Vs, vg, p.v_ss, k_begin, p.skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();


  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  const int rows[2] = {qw + g, qw + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait<0>();  // tile j has landed (this thread's copies)
      __syncthreads();     // ... everyone's; tile j-1's buffer is free
    }
    if (j + 1 < n_tiles) {
      load_tile<BK, D, NT>(Ks + (buf ^ 1) * BK * PITCH, kg, p.k_ss,
                           k0 + BK, p.skv);
      load_tile<BK, D, NT>(Vs + (buf ^ 1) * BK * PITCH, vg, p.v_ss,
                           k0 + BK, p.skv);
    }
    cp_async_commit();
    // warp-uniform (and the same for both warps of a strip): a tile with
    // no valid pair for this warp's rows
    if (qw >= p.sq || (p.causal && k0 > qw + 15) ||
        (p.window > 0 && k0 + BK - 1 <= qw - p.window))
      continue;
    const bf16* Kb = Ks + buf * BK * PITCH;
    const bf16* Vb = Vs + buf * BK * PITCH;

    // S (SPLIT: this warp's half of the sum over D)
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];  // re-read: held in registers, the q strip spills
      ldsm_x4(qa, a_addr<D>(Qs, 16 * strip, d0 + 16 * kk, lane));
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, bt_addr<D>(Kb, 8 * n, d0 + 16 * kk, lane));
        mma(s[n], qa, kf[0], kf[1]);
        mma(s[n + 1], qa, kf[2], kf[3]);
      }
    }
    if constexpr (C::SPLIT) {
      // the pair swaps halves; s0 + s1 is the same sum in both warps
      float* slot = Xs + (strip * 2 + half) * NK * 4 * 32;
      const float* other = Xs + (strip * 2 + (half ^ 1)) * NK * 4 * 32;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) slot[(4 * n + e) * 32 + lane] = s[n][e];
      // both have written; the slots are written again only after the
      // next tile's block barrier, which each warp reaches once it has
      // read this tile's
      bar_sync(1 + strip, 64);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += other[(4 * n + e) * 32 + lane];
    }

    // scale; mask only where the tile crosses kv_len, the diagonal or the
    // window edge for some row of the warp
    const bool edge = k0 + BK > kv_end || (p.causal && k0 + BK - 1 > qw) ||
                      (p.window > 0 && k0 <= qw + 15 - p.window);
    uint32_t dead = 0;  // bit 4n + e: element (n, e) is masked
    float rmax[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.sm_scale;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int qi = rows[e >> 1];
          bool ok = key < kv_end;
          if (p.causal) ok = ok && key <= qi;
          if (p.window > 0) ok = ok && key > qi - p.window;
          if (!ok) {
            x = NEG_BIG;
            dead |= 1u << (4 * n + e);
          }
        }
        s[n][e] = x;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
      const float m_new = fmaxf(m[i], rmax[i]);
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // p = hi + lo, in the A layout, straight from the accumulators
    uint32_t ph[NK / 2][4], pl[NK / 2][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = (dead >> (4 * n + e)) & 1u
            ? 0.f : exp2f((s[n][e] - m[e >> 1]) * LOG2E);
        s[n][e] = pr;
        l[e >> 1] += pr;  // this lane's columns; the row sum is taken last
      }
#pragma unroll
    for (int c = 0; c < NK / 2; ++c)
      split_a(s[2 * c], s[2 * c + 1], ph[c], pl[c]);

    // O = alpha * O + P.V. The tile's 2 * BK / 16 products go into a fresh
    // accumulator, added to O by one FFMA: the tensor cores' float32
    // additions are not rounded to nearest, and a chain of every key
    // tile's products into O would carry their error along.
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < NK / 2; ++c) {
        uint32_t vf[4];
        ldsm_x4_t(vf, a_addr<D>(Vb, 16 * c, d0 + 8 * n, lane));
        mma(pv[0], ph[c], vf[0], vf[1]);
        mma(pv[0], pl[c], vf[0], vf[1]);
        mma(pv[1], ph[c], vf[2], vf[3]);
        mma(pv[1], pl[c], vf[2], vf[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n + u][e] = fmaf(o[n + u][e], alpha[e >> 1], pv[u][e]);
    }
  }

  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + d0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = rows[i];
    if (r >= p.sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          &og[(int64_t)r * p.o_ss + 8 * n + 2 * t]) =
          __floats2bfloat162_rn(o[n][2 * i] / lm, o[n][2 * i + 1] / lm);
    if (t == 0 && half == 0)
      p.lse[((int64_t)b * p.h + h) * p.sq + r] = m[i] + logf(lm);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(
    mma_bf16::kTensorCores<T> ? FwdTc<D>::THREADS : THREADS,
    mma_bf16::kTensorCores<T> ? FwdTc<D>::MIN_BLOCKS : 1)
flash_fwd_kernel(const Params p) {
  if constexpr (mma_bf16::kTensorCores<T>)
    fwd_tc<D>(p);
  else
    fwd_fma<T, D>(p);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool tc = mma_bf16::kTensorCores<T>;
  constexpr int bytes = tc ? smem_tc<D>() : smem_fma<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.h);
  flash_fwd_kernel<T, D><<<grid, tc ? FwdTc<D>::THREADS : THREADS, bytes,
                           stream>>>(p);
  return cudaGetLastError();
}

// Dynamic shared memory of a launch at head dim d (0: not built).
template <typename T>
int smem_bytes(int d) {
  constexpr bool tc = mma_bf16::kTensorCores<T>;
  switch (d) {
    case 32: return tc ? smem_tc<32>() : smem_fma<32>();
    case 64: return tc ? smem_tc<64>() : smem_fma<64>();
    case 80: return tc ? smem_tc<80>() : smem_fma<80>();
    case 128: return tc ? smem_tc<128>() : smem_fma<128>();
    case 256: return tc ? smem_tc<256>() : smem_fma<256>();
    default: return 0;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 80: return launch<T, 80>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
    case 256: return launch<T, 256>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements; the head-dim axis
// is contiguous. lse is a contiguous (B, H, Sq) float32 tensor.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, float* lse, int batch,
                        int h, int hkv, int sq, int skv, int d,
                        int64_t q_sb, int64_t q_sh, int64_t q_ss,
                        int64_t k_sb, int64_t k_sh, int64_t k_ss,
                        int64_t v_sb, int64_t v_sh, int64_t v_ss,
                        int64_t o_sb, int64_t o_sh, int64_t o_ss,
                        float sm_scale, int causal, int window, int kv_len,
                        int device, void* stream) {
  cudaSetDevice(device);
  Params p{q, k, v, out, lse, h, hkv, sq, skv, kv_len, window, causal,
           sm_scale, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 1
      ? dispatch<__nv_bfloat16>(p, batch, d, s)
      : dtype == 0 ? dispatch<float>(p, batch, d, s) : cudaErrorInvalidValue;
  return (int)e;
}

// Dynamic shared memory (bytes) a launch at head dim d takes; 0 for a
// head dim that is not built.
int flash_attention_fwd_smem(int dtype, int d) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(d)
                    : dtype == 0 ? smem_bytes<float>(d) : 0;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
