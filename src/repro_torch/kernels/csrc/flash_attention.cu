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
// with online softmax (the TPU kernel runs its key axis as the sequential
// innermost grid dimension and carries (m, l, acc) in VMEM scratch; here
// the loop runs inside the block and the carry lives in registers). Key
// tiles wholly above the causal diagonal, wholly before the window, or
// past kv_len are skipped, not masked; rows past Sq are never stored.
//
// Bound. At the serving shape (B=4, H=32, Hkv=8, S=2048, D=128, bf16,
// causal) the work is 4*D operations per valid pair, ~1.4e11 against ~168
// MB of traffic: the card's limit is operations, 139 us at the bf16
// tensor-core peak (50 us for the bytes).
//
// bf16 (the main path): wgmma, TMA and warp-specialised warpgroups
// (hopper.cuh holds the primitives). A block of 384 threads owns 128 query
// rows: warpgroup 0 is the producer, whose first thread starts every TMA
// load (setmaxnreg leaves it 24 registers), and warpgroups 1 and 2 are
// the consumers, 64 rows each (240 registers). q's tile is loaded once; K
// and V tiles of BK keys (128; 64 at D = 256, where O alone takes 128
// registers a thread) come through a ring of 3 stages (2 at D = 256), each
// with a full and an empty mbarrier for K and for V, so that a consumer
// starts q.k^T while V is still in flight and the producer refills K as
// soon as both consumers have taken S (with 2 stages the consumers still
// waited for K at D = 128). The tensor maps are 4-d over (D, S, heads, batch) with the
// tensor's own strides, so a (B, S, H, D) tensor seen through
// transpose(1, 2) is read as it is; rows past S arrive as zeros and the
// last tile is masked by kv_len. Tiles are boxes of 64 columns with
// 128-byte swizzle (D = 64, 128, 256), 32 with 64-byte (D = 32) or 16 with
// 32-byte (D = 80), and the wgmma descriptors take the same swizzle.
// S = q.k^T is one m64nBKk16 wgmma a 16-column k-step with both operands
// in shared memory (bf16 x bf16 products are exact in float32, the sums
// float32). The online softmax works on the accumulator fragments (a
// row's 4 lanes reduce by 2 shuffles) and masks, without branches, only in
// tiles that cross the diagonal, the window edge or kv_len: a masked
// logit is -inf, and the row max starts at NEG_BIG, so m and p are those
// of a NEG_BIG mask. The max is taken on q.k and then scaled (the same
// value: rounding is monotone), and p = 2^(q.k * scale * log2(e) -
// m * log2(e)), one FFMA and one ex2 a logit: s = (q.k) * sm_scale is not
// rounded on its own (p moves by about one float32 rounding of the
// exponent against exp(s - m)). p
// never goes to shared memory: the accumulator layout repacked to bf16x2
// is the next product's A operand in registers, so p is split there into
// hi = bf16(p) and lo = bf16(p - hi) and P.V runs as two register-A
// wgmmas a k-step with V read transposed from shared memory: about 16
// bits of p, where bf16(p) would keep 8, at 1.5x the tensor work the bound
// counts. Each tile's P.V goes into a fresh accumulator, added to O by one
// FFMA with the rescale (the tensor cores' float32 additions are not
// rounded to nearest, and a chain of every key tile's products into O
// would carry their error along); at D = 256 it is taken in chunks of 64
// columns. out is stored from registers as bf16x2 (o * (1 / l), one
// division a row), lse by the row's first lane. Within a consumer the
// tile's steps run in order (S, softmax, P.V): the two consumers overlap
// only as the warp schedulers interleave them. Shared memory: 225 KB at
// D = 128, 193 KB at D = 256; one block an SM.
//
// float32: the FMA kernel of the first port (CUDA cores, q^T, k^T and p^T
// transposed in shared memory as float32). On tensor cores float32 inputs
// would need q, k and v split as well; it is the instantiation that
// chip_smoke's tight float32 checks (serving in float32) hold. At D = 256
// its tiles take 217 KB: one block an SM.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128, 256). C interface, loaded with ctypes by
// repro_torch/kernels/flash_cuda.py; the entry point encodes the bf16
// tensor maps (cuTensorMapEncodeTiled reached through the CUDA runtime:
// nothing links libcuda), launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;   // row pitch of Q^T and P^T (floats)
constexpr int KS = BK + 4;   // row pitch of K^T
constexpr float NEG_BIG = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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



// bf16: the warp-specialised kernel (the header). Thread layout of a
// consumer warpgroup as in hopper.cuh: warp w of the group, lane (g, t) =
// (lane / 4, lane % 4), holds rows 16w + g and 16w + g + 8 of the group's
// 64.
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
constexpr bool kWgmma = false;
template <>
constexpr bool kWgmma<__nv_bfloat16> = true;

template <int D>
struct FwdWg {
  using SW = hopper::Swizzle<D>;
  static constexpr int BQ = 128;                 // 2 consumers x 64 rows
  static constexpr int BK = D > 128 ? 64 : 128;  // keys a tile
  static constexpr int DC = D > 128 ? 64 : D;    // O columns a P.V chunk
  static constexpr int STAGES = D > 128 ? 2 : 3;  // K, V ring depth
  static constexpr int THREADS = 384;
  static constexpr int CONSUMER_WARPS = 8;       // arrivals on an empty bar
  static constexpr int Q_BOX = BQ * SW::BYTES;   // bytes of a box
  static constexpr int KV_BOX = BK * SW::BYTES;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // q, the K and V rings, the barriers, and 1 KB to align the tiles
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
};

constexpr float NEG_INF = -__builtin_huge_valf();

template <int D>
__device__ __forceinline__ void fwd_wg(const Params& p,
                                       const CUtensorMap* mq,
                                       const CUtensorMap* mk,
                                       const CUtensorMap* mv) {
  using namespace hopper;
  using C = FwdWg<D>;
  using SW = typename C::SW;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + C::Q_BYTES;              // STAGES tiles
  uint8_t* Vs = Ks + C::STAGES * C::KV_BYTES;  // STAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + C::STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::STAGES;
  uint64_t* k_empty = v_full + C::STAGES;
  uint64_t* v_empty = k_empty + C::STAGES;

  const int iq = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int hk = h / (p.h / p.hkv);
  const int q0 = iq * C::BQ;
  const int kv_end = min(p.kv_len, p.skv);
  int k_end = kv_end;
  if (p.causal) k_end = min(k_end, q0 + C::BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / C::BK * C::BK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], C::CONSUMER_WARPS);
      mbar_init(&v_empty[s], C::CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < SW::BOXES; ++x)
        tma_load_4d(Qs + x * C::Q_BOX, mq, q_full, x * SW::BW, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::STAGES;
        const uint32_t phase = (j / C::STAGES) & 1;
        const int k0 = k_begin + j * C::BK;
        mbar_wait(&k_empty[s], phase ^ 1);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < SW::BOXES; ++x)
          tma_load_4d(Ks + s * C::KV_BYTES + x * C::KV_BOX, mk, &k_full[s],
                      x * SW::BW, k0, hk, b);
        mbar_wait(&v_empty[s], phase ^ 1);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < SW::BOXES; ++x)
          tma_load_4d(Vs + s * C::KV_BYTES + x * C::KV_BOX, mv, &v_full[s],
                      x * SW::BW, k0, hk, b);
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows
    setmaxnreg_inc<240>();
    constexpr int NS = C::BK / 2;   // S accumulators a thread
    constexpr int NO = D / 2;       // O accumulators a thread
    constexpr int KQ = D / 16;      // k-steps of q.k^T
    constexpr int KP = C::BK / 16;  // k-steps of P.V
    const int tw = threadIdx.x - 128 * (threadIdx.x / 128);
    const int c = threadIdx.x / 128 - 1;
    const int warp = tw >> 5, lane = tw & 31, t = lane & 3;
    const int qw = q0 + 64 * c;                 // the group's first row
    const int rows[2] = {qw + 16 * warp + (lane >> 2),
                         qw + 16 * warp + (lane >> 2) + 8};
    // descriptors at k-step 0 of the group's q rows, of stage 0's K (both
    // K-major) and of stage 0's V (MN-major); a stage is KV_BYTES further
    const uint64_t dq = desc(smem_u32(Qs) + 64 * c * SW::BYTES, 16, SW::ATOM,
                             SW::LAYOUT);
    const uint64_t dk = desc(smem_u32(Ks), 16, SW::ATOM, SW::LAYOUT);
    const uint64_t dv = desc(smem_u32(Vs), C::KV_BOX, SW::ATOM, SW::LAYOUT);
    constexpr uint64_t STAGE = C::KV_BYTES >> 4;

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
    const float scale_log2 = p.sm_scale * LOG2E;
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % C::STAGES;
      const uint32_t phase = (j / C::STAGES) & 1;
      const int k0 = k_begin + j * C::BK;
      mbar_wait(&k_full[s], phase);
      __syncwarp();
      // group-uniform: a tile with no valid pair for this group's rows
      if (qw >= p.sq || (p.causal && k0 > qw + 63) ||
          (p.window > 0 && k0 + C::BK - 1 <= qw - p.window)) {
        if (lane == 0) mbar_arrive(&k_empty[s]);
        // V must land before the stage is released for refilling
        mbar_wait(&v_full[s], phase);
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[s]);
        __syncwarp();
        continue;
      }

      // this tile's descriptors, opaque to the compiler: it would hoist
      // every k-step's descriptor out of the loop, 2 registers each
      uint64_t dqj = dq, dkj = dk + s * STAGE, dvj = dv + s * STAGE;
      asm volatile("" : "+l"(dqj), "+l"(dkj), "+l"(dvj));

      // S = q . k^T
      float sacc[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        // box of the k-step's 16 columns, then 32 bytes a k-step within it
        constexpr int PER_BOX = SW::BW / 16;
        const uint64_t qo = (kk / PER_BOX) * (C::Q_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        const uint64_t ko = (kk / PER_BOX) * (C::KV_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        Wgmma<C::BK>::ss(sacc, dqj + qo, dkj + ko, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[s]);

      // mask only where the tile crosses kv_len, the diagonal or the
      // window edge for some row of the group; a masked logit is -inf
      const bool edge = k0 + C::BK > kv_end ||
                        (p.causal && k0 + C::BK - 1 > qw) ||
                        (p.window > 0 && k0 <= qw + 63 - p.window);
      if (edge) {
        // valid keys of this lane's rows: [lo, hi) (hi exclusive)
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          hi[r] = p.causal ? min(kv_end, rows[r] + 1) : kv_end;
          lo[r] = p.window > 0 ? rows[r] - p.window + 1 : 0;
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int r = (i >> 1) & 1;
          sacc[i] = key >= lo[r] && key < hi[r] ? sacc[i] : NEG_INF;
        }
      }
      // the row max of q.k (max commutes with the positive scale: the max
      // of the scaled s is the scaled max), 2 partial maxima a row
      float rmax[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = ((i >> 1) & 1) + 2 * ((i >> 2) & 1);
        rmax[r] = fmaxf(rmax[r], sacc[i]);
      }
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(rmax[r], rmax[r + 2]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x * p.sm_scale);
        alpha[r] = ex2((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        // a row with no valid key yet keeps m = NEG_BIG, whose multiple
        // would overflow: its logits are all -inf, and p is 0 from any mb
        mb[r] = m_new == NEG_BIG ? 0.f : m_new * LOG2E;
      }
      // p = 2^(s.scale.log2(e) - m.log2(e)) = exp(s.scale - m), and
      // p = hi + lo in the A layout: register e of k-step kk holds
      // accumulators 8kk + 2e and 8kk + 2e + 1 (row (e & 1) of the lane)
      uint32_t ph[KP][4], pl[KP][4];
      float rsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const float p0 = ex2(fmaf(sacc[i], scale_log2, -mb[e & 1]));
          const float p1 = ex2(fmaf(sacc[i + 1], scale_log2, -mb[e & 1]));
          rsum[e] += p0;   // this lane's columns; the row sum is taken last
          rsum[e] += p1;
          split(p0, p1, ph[kk][e], pl[kk][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = fmaf(l[r], alpha[r], rsum[r] + rsum[r + 2]);

      // O = alpha * O + P.V, a fresh accumulator a chunk of DC columns
      mbar_wait(&v_full[s], phase);
      __syncwarp();
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += C::DC) {
        float pv[C::DC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          // 16 keys a k-step: 16 rows of every box; the chunk's first box
          const uint64_t vo = (n0 / SW::BW) * (C::KV_BOX >> 4) +
                              kk * ((16 * SW::BYTES) >> 4);
          Wgmma<C::DC>::rs(pv, ph[kk], dvj + vo, kk > 0);
          Wgmma<C::DC>::rs(pv, pl[kk], dvj + vo, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int i = 0; i < C::DC / 2; ++i)
          o[n0 / 2 + i] = fmaf(o[n0 / 2 + i], alpha[(i >> 1) & 1], pv[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[s]);
    }

    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = rows[r];
      if (row >= p.sq) continue;
      const float lm = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / lm;  // one division a row, then products
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            &og[(int64_t)row * p.o_ss + 8 * n + 2 * t]) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                  o[4 * n + 2 * r + 1] * inv);
      if (t == 0) p.lse[((int64_t)b * p.h + h) * p.sq + row] = m[r] + logf(lm);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgmma<T> ? FwdWg<D>::THREADS : THREADS, 1)
flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv) {
  if constexpr (kWgmma<T>)
    fwd_wg<D>(p, &mq, &mk, &mv);
  else
    fwd_fma<T, D>(p);
}

// The bf16 kernel's tensor maps: q in boxes of BQ rows, k and v of BK
// (with no keys, copies of q's: no key tile is loaded). false if one
// cannot be encoded.
struct Maps {
  CUtensorMap q, k, v;
};

template <int D>
bool make_maps(const Params& p, int batch, Maps& maps) {
  using C = FwdWg<D>;
  using SW = typename C::SW;
  if (!hopper::tensor_map_4d(&maps.q, p.q, D, p.sq, p.h, batch, p.q_ss,
                             p.q_sh, p.q_sb, SW::BW, C::BQ, SW::BYTES))
    return false;
  if (p.skv == 0) {
    maps.k = maps.v = maps.q;
    return true;
  }
  return hopper::tensor_map_4d(&maps.k, p.k, D, p.skv, p.hkv, batch, p.k_ss,
                               p.k_sh, p.k_sb, SW::BW, C::BK, SW::BYTES) &&
         hopper::tensor_map_4d(&maps.v, p.v, D, p.skv, p.hkv, batch, p.v_ss,
                               p.v_sh, p.v_sb, SW::BW, C::BK, SW::BYTES);
}

template <typename T, int D>
constexpr int smem_of() {
  if constexpr (kWgmma<T>)
    return FwdWg<D>::SMEM;
  else
    return smem_fma<D>();
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, int device,
                   cudaStream_t stream) {
  constexpr bool wg = kWgmma<T>;
  constexpr int bytes = smem_of<T, D>();
  // the attribute belongs to the kernel on one device: set once per device
  static std::atomic<uint64_t> configured{0};
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (!(configured.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  Maps maps{};
  if constexpr (wg)
    if (!make_maps<D>(p, batch, maps)) return cudaErrorInvalidValue;
  const int rows = wg ? FwdWg<D>::BQ : BQ;
  const dim3 grid((p.sq + rows - 1) / rows, batch * p.h);
  flash_fwd_kernel<T, D><<<grid, wg ? FwdWg<D>::THREADS : THREADS, bytes,
                           stream>>>(p, maps.q, maps.k, maps.v);
  return cudaGetLastError();
}

// Dynamic shared memory of a launch at head dim d (0: not built).
template <typename T>
int smem_bytes(int d) {
  switch (d) {
    case 32: return smem_of<T, 32>();
    case 64: return smem_of<T, 64>();
    case 80: return smem_of<T, 80>();
    case 128: return smem_of<T, 128>();
    case 256: return smem_of<T, 256>();
    default: return 0;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, int device,
                     cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, device, s);
    case 64: return launch<T, 64>(p, batch, device, s);
    case 80: return launch<T, 80>(p, batch, device, s);
    case 128: return launch<T, 128>(p, batch, device, s);
    case 256: return launch<T, 256>(p, batch, device, s);
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
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Params p{q, k, v, out, lse, h, hkv, sq, skv, kv_len, window, causal,
           sm_scale, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = dtype == 1 ? dispatch<__nv_bfloat16>(p, batch, d, device, s)
      : dtype == 0 ? dispatch<float>(p, batch, d, device, s)
                   : cudaErrorInvalidValue;
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
