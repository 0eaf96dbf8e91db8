// Flash-attention backward for Hopper (sm_90a): K6 (dq) and K7 (dk, dv).
//
// Replaces the Pallas kernels _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel of src/repro/kernels/flash_attention.py, the
// backward of the custom_vjp around K5. With lse from K5's forward and
// dd = rowsum(do * out) from the caller (outside the kernels, as in the
// reference), both recompute, per valid (query, key) pair:
//
//   s  = (q . k) * sm_scale                  in float32
//   p  = exp(s - lse)  on valid keys, 0 elsewhere
//   dp = do . v
//   ds = p * (dp - dd) * sm_scale
//
// and K6 sums dq = sum_k ds * k, K7 dk = sum_q ds^T * q and
// dv = sum_q p^T * do over every query of every head of the key's GQA
// group. The mask is K5's: key < kv_len, key <= query (causal),
// key > query - window; rows past Sq and keys past Skv are masked too, so
// nothing is padded (the reference pads S to a tile multiple and relies on
// do = 0 there).
//
// K6: one block per (query tile, batch * head), looping over key tiles with
// the dq tile in registers (the TPU kernel carries it in VMEM across its
// sequential kv grid axis). K7: one block per (64-key tile, batch * kv
// head), looping over every query head of the group and every query tile,
// the reference's flattened (group, iq) axis, with dk and dv in registers.
// No atomics: each output row is written once, by one block, in a fixed
// order of sums, so dk and dv are deterministic and need no zero-fill pass
// (a key tile with no valid pair writes zeros). Tiles wholly above the
// causal diagonal, outside the window or past kv_len are skipped, as K5
// skips them.
//
// Bound. At the training shape (B=1, H=32, Hkv=8, S=4095, D=128, bf16,
// causal) each valid pair costs K6 6*D operations (s, dp, dq) and K7 8*D
// (s, dp, dv, dk): ~2.1e11 and ~2.7e11 per layer, 208 and 278 us at the
// bf16 tensor-core peak, against ~35 us for the bytes: both are bound by
// operations.
//
// bf16 (the main path): wgmma, TMA and warp-specialised warpgroups on K5's
// pieces (hopper.cuh). A block has 384 threads: warpgroup 0 is the
// producer, whose first thread starts every TMA load, and warpgroups 1 and
// 2 are the consumers (setmaxnreg moves the producer's registers to them).
// The tensor maps are K5's: 4-d over (D, S, heads, batch) with the
// tensors' own strides, boxes of 64 columns with 128-byte swizzle (D = 64,
// 128, 256), 32 with 64-byte (D = 32) or 16 with 32-byte (D = 80). Rows
// past S arrive as zeros, and every pair off the mask, a query at or past
// Sq included, is masked in the kernel: without branches, and only in
// tiles that cross kv_len, Sq, the diagonal or the window edge. p is
// 2^(q.k * scale * log2(e) - lse * log2(e)), one FFMA and one ex2 a pair
// as in K5 (about one float32 rounding of the exponent from exp(s - lse)).
// p and ds enter the output products as bf16 hi/lo halves in registers
// (the accumulator layout repacked as the A operand, hopper.cuh), so each
// output product is two register-A wgmmas a k-step: K6's tensor work is
// 8*D a valid pair and K7's 12*D, 4/3x and 1.5x what the bound counts (278
// and 417 us at the peak). Each tile's output product goes into a fresh
// accumulator (a chunk of 64 columns at D = 256), added to the running
// sum by one FADD: the tensor cores' float32 additions are not rounded to
// nearest, and a chain of every tile's products into dK and dV drifts past
// the limit chip_smoke.py holds them to (over 1% of bf16 outputs one ulp
// off at mixtral-8x7b's window shape; 0.25% with fresh accumulators).
//
// K6 (dq_wg): 128 query rows of one (batch, head) a block, 64 a consumer.
// q and do are loaded once; K and V tiles of BK keys (64; 32 at D = 256,
// where q and do alone take 128 KB) come through a ring of 3 stages (2 at
// D = 256) with a full and an empty mbarrier for K and for V: S = q.k^T
// starts while V is in flight, p is taken while dP = do.v^T runs, and V's
// stage is released as soon as dP is done. dQ += dS.K reads the K tile a
// second time, MN-major, through another descriptor on the same shared
// memory, as K5 reads V. Each thread keeps lse and dd of its two rows in
// registers. Shared memory 164,968 bytes at D = 128, 197,704 at D = 256.
//
// K7 (dkv_wg): 64 keys of one (batch, kv head) a block; K and V are loaded
// once and stay. The producer streams the (query head, query tile of 64)
// pairs through a ring of 3 stages (2 at D = 256): q and do by TMA, lse
// (times log2 e) and dd by plain loads of its second warp (they are
// (B, H, Sq) float32, and at Sq = 4095 a row of 16,380 bytes is no
// multiple of 16: no tensor map takes it), 0 at rows past Sq. The two
// consumers share the 64 keys in two roles: consumer 0 computes s^T =
// K.q^T, p^T and dV += P^T.do, and hands p^T to consumer 1 through shared
// memory (two buffers, each behind a full and an empty mbarrier);
// consumer 1 computes dp^T = V.do^T, ds^T = p^T (dp^T - dd)
// scale and dK += dS^T.q. Keys are the wgmma's M rows; q and do are read
// K-major for the score products and MN-major for the output products.
// One D-wide accumulator a consumer leaves room for the fresh
// accumulators above: dK and dV together in one consumer (128 floats a
// thread at D = 128) would not. blockIdx.y is the key tile, so under the
// causal mask every (batch, kv head) takes its longest tiles first. Shared
// memory 166,488 bytes at D = 128, 231,496 at D = 256.
//
// In float32 both are the FMA kernels of the first port (CUDA cores, 67
// TFLOP/s peak). Thread layout: 256 threads, (ty, tx) =
// (tid / 16, tid % 16). Thread (ty, tx) computes the 4x4 block of the
// score tile at rows 4*ty.. (queries in K6, keys in K7) and columns 4*tx..
// (keys in K6, queries in K7), and owns output columns tx + 16*c
// (c < D/16) of rows 4*ty..4*ty+3. Q, dO, K and V tiles sit in shared
// memory transposed (D x 68 floats), so the score products read broadcast
// or conflict-free float4s; the output products read the transposed tiles
// by column (a 2-way bank conflict) and ds / p by float4. At D = 256 the K
// and V tiles (K6) or the q and do tiles (K7) are staged DC columns at a
// time (DC = 128 and 64), once for the score products and again, last
// chunk first, for the output products; the other pair stays whole (221
// and 204 KB). The float32 instantiations are what chip_smoke's float32
// checks (4 training layers in float32, the f32_window case) hold; the
// bf16 ones are held by the bf16 checks and their planted faults.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128, 256). C interface, loaded with ctypes by
// repro_torch/kernels/flash_cuda.py; each entry point encodes the bf16
// tensor maps (cuTensorMapEncodeTiled through the CUDA runtime: nothing
// links libcuda), launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int TP = 68;  // row pitch (floats) of every transposed tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, Sq) contiguous
  const float* dd;   // (B, H, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int h, hkv, sq, skv, kv_len, window;  // window <= 0: none
  int causal;
  float sm_scale;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;     // dout
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
};

// rows r0 .. r0+63 of a (S, D) slab (row stride ss) into dst[d * TP + r],
// zero past the slab's n rows.
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, int64_t ss,
                                       int r0, int n) {
  const int valid = min(BQ, n - r0);
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    dst[d * TP + r] = r < valid ? to_f32(src[(int64_t)(r0 + r) * ss + d])
                                : 0.f;
  }
}

// a[i][j] += sum_d A[d][ra + i] * B[d][cb + j] and
// c[i][j] += sum_d C[d][ra + i] * E[d][cb + j], the two score products.
template <int D>
__device__ __forceinline__ void score_products(
    float a[4][4], float c[4][4], const float* A, const float* B,
    const float* C, const float* E, int ra, int cb) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&A[d * TP + ra]);
    const float4 y = *reinterpret_cast<const float4*>(&B[d * TP + cb]);
    const float4 z = *reinterpret_cast<const float4*>(&C[d * TP + ra]);
    const float4 w = *reinterpret_cast<const float4*>(&E[d * TP + cb]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
    const float zv[4] = {z.x, z.y, z.z, z.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
        c[i][j] = fmaf(zv[i], wv[j], c[i][j]);
      }
  }
}

__device__ __forceinline__ bool valid_pair(const Params& p, int qi, int kj) {
  bool ok = qi < p.sq && kj < p.kv_len && kj < p.skv;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// Columns of the staged pair of float32 tiles (K6: K and V; K7: q and
// do) held at a time: all of D up to 128; at D = 256 a whole pair of
// D x TP tiles more would not fit.
template <int D, bool DKV>
__host__ __device__ constexpr int fma_chunk() {
  return D <= 128 ? D : DKV ? 64 : 128;
}

template <int D>
constexpr int smem_dq() {
  return (int)sizeof(float) *
         (2 * D * TP + 2 * fma_chunk<D, false>() * TP + BK * TP);
}
template <int D>
constexpr int smem_dkv() {
  return (int)sizeof(float) *
         (2 * D * TP + 2 * fma_chunk<D, true>() * TP + 2 * BQ * TP);
}

// --- K6: dq --------------------------------------------------------------------
// float32: the FMA layout above; one block per (query tile, batch * head),
// blockIdx.x the query tile. K and V come in DC columns at a time (all of
// D up to 128).
template <typename T, int D>
__device__ __forceinline__ void dq_fma(const Params& p) {
  constexpr int DC = fma_chunk<D, false>();
  constexpr int NC = D / DC;    // column chunks of K and V
  constexpr int CN = DC / 16;   // output columns per thread in a chunk
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // D x TP, q^T
  float* Ot = Qt + D * TP;                      // D x TP, do^T
  float* Kt = Ot + D * TP;                      // DC x TP, a chunk of k^T
  float* Vt = Kt + DC * TP;                     // DC x TP, a chunk of v^T
  float* St = Vt + DC * TP;                     // BK x TP, ds^T
  __shared__ float lse_s[BQ], dd_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int hk = h / (p.h / p.hkv);
  const int q0 = iq * BQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int64_t row = ((int64_t)b * p.h + h) * p.sq;

  load_t<T, D>(Qt, qg, p.q_ss, q0, p.sq);
  load_t<T, D>(Ot, og, p.o_ss, q0, p.sq);
  if (tid < BQ) {
    const bool in = q0 + tid < p.sq;
    lse_s[tid] = in ? p.lse[row + q0 + tid] : 0.f;
    dd_s[tid] = in ? p.dd[row + q0 + tid] : 0.f;
  }

  float acc[4][NC * CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC * CN; ++c) acc[i][c] = 0.f;

  int k_end = min(p.kv_len, p.skv);
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();  // Q, dO staged; the previous chunk's K, V and the
                        // previous tile's K, ds are consumed
      load_t<T, DC>(Kt, kg + c * DC, p.k_ss, k0, p.skv);
      load_t<T, DC>(Vt, vg + c * DC, p.v_ss, k0, p.skv);
      __syncthreads();
      score_products<DC>(s, dp, Qt + c * DC * TP, Kt, Ot + c * DC * TP, Vt,
                         4 * ty, 4 * tx);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      const float lse = lse_s[4 * ty + i], dd = dd_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid_pair(p, qi, k0 + 4 * tx + j);
        const float pr = ok ? expf(s[i][j] * p.sm_scale - lse) : 0.f;
        s[i][j] = pr * (dp[i][j] - dd) * p.sm_scale;  // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&St[(4 * tx + j) * TP + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // dq += ds . K, chunk by chunk from the last one staged
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      if (c < NC - 1) {
        __syncthreads();  // chunk c + 1 is consumed
        load_t<T, DC>(Kt, kg + c * DC, p.k_ss, k0, p.skv);
        __syncthreads();
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 g =
            *reinterpret_cast<const float4*>(&St[kk * TP + 4 * ty]);
#pragma unroll
        for (int u = 0; u < CN; ++u) {
          const float kv = Kt[(tx + 16 * u) * TP + kk];
          acc[0][c * CN + u] = fmaf(g.x, kv, acc[0][c * CN + u]);
          acc[1][c * CN + u] = fmaf(g.y, kv, acc[1][c * CN + u]);
          acc[2][c * CN + u] = fmaf(g.z, kv, acc[2][c * CN + u]);
          acc[3][c * CN + u] = fmaf(g.w, kv, acc[3][c * CN + u]);
        }
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < NC * CN; ++c)
      store(&dqg[(int64_t)r * p.dq_ss + tx + 16 * c], acc[i][c]);
  }
}

// --- K7: dk, dv ------------------------------------------------------------------
// float32: the FMA layout above; one block per (key tile, batch * kv head)
// with blockIdx.x the key tile. q and do come in DC columns at a time (all
// of D up to 128).
template <typename T, int D>
__device__ __forceinline__ void dkv_fma(const Params& p) {
  constexpr int DC = fma_chunk<D, true>();
  constexpr int NC = D / DC;    // column chunks of q and do
  constexpr int CN = DC / 16;   // output columns per thread in a chunk
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // D x TP, k^T (resident)
  float* Vt = Kt + D * TP;                      // D x TP, v^T (resident)
  float* Qt = Vt + D * TP;                      // DC x TP, a chunk of q^T
  float* Ot = Qt + DC * TP;                     // DC x TP, a chunk of do^T
  float* Ps = Ot + DC * TP;                     // BQ x TP, p[query][key]
  float* Ss = Ps + BQ * TP;                     // BQ x TP, ds[query][key]
  __shared__ float lse_s[BQ], dd_s[BQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ik = blockIdx.x;                    // causal: longest tiles first
  const int b = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv;
  const int group = p.h / p.hkv;
  const int k0 = ik * BK;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_t<T, D>(Kt, kg, p.k_ss, k0, p.skv);
  load_t<T, D>(Vt, vg, p.v_ss, k0, p.skv);

  float dk[4][NC * CN], dv[4][NC * CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC * CN; ++c) dk[i][c] = dv[i][c] = 0.f;

  // query tiles that hold a valid pair with a key of this tile
  int iq_begin = 0, iq_end = (p.sq + BQ - 1) / BQ;
  if (k0 >= min(p.kv_len, p.skv)) iq_end = 0;
  if (p.causal) iq_begin = k0 / BQ;
  if (p.window > 0)
    iq_end = min(iq_end, (k0 + BK - 1 + p.window - 1) / BQ + 1);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const int64_t row = ((int64_t)b * p.h + h) * p.sq;
    for (int iq = iq_begin; iq < iq_end; ++iq) {
      const int q0 = iq * BQ;
      // s^T and dp^T: rows are keys 4*ty.., columns queries 4*tx..
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        __syncthreads();  // the previous chunk's Q, dO and the previous
                          // tile's Q, dO, p, ds are consumed
        load_t<T, DC>(Qt, qg + c * DC, p.q_ss, q0, p.sq);
        load_t<T, DC>(Ot, og + c * DC, p.o_ss, q0, p.sq);
        if (c == 0 && tid < BQ) {
          const bool in = q0 + tid < p.sq;
          lse_s[tid] = in ? p.lse[row + q0 + tid] : 0.f;
          dd_s[tid] = in ? p.dd[row + q0 + tid] : 0.f;
        }
        __syncthreads();
        score_products<DC>(s, dp, Kt + c * DC * TP, Qt, Vt + c * DC * TP,
                           Ot, 4 * ty, 4 * tx);
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + 4 * tx + j;
        const float lse = lse_s[4 * tx + j], dd = dd_s[4 * tx + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = valid_pair(p, qi, k0 + 4 * ty + i);
          const float pr = ok ? expf(s[i][j] * p.sm_scale - lse) : 0.f;
          s[i][j] = pr;
          dp[i][j] = pr * (dp[i][j] - dd) * p.sm_scale;  // ds
        }
        *reinterpret_cast<float4*>(&Ps[(4 * tx + j) * TP + 4 * ty]) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(&Ss[(4 * tx + j) * TP + 4 * ty]) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      }
      __syncthreads();

      // dv += p^T . dO and dk += ds^T . Q, chunk by chunk from the last
      // one staged
#pragma unroll
      for (int c = NC - 1; c >= 0; --c) {
        if (c < NC - 1) {
          __syncthreads();  // chunk c + 1 is consumed
          load_t<T, DC>(Qt, qg + c * DC, p.q_ss, q0, p.sq);
          load_t<T, DC>(Ot, og + c * DC, p.o_ss, q0, p.sq);
          __syncthreads();
        }
#pragma unroll 2
        for (int qq = 0; qq < BQ; ++qq) {
          const float4 pp =
              *reinterpret_cast<const float4*>(&Ps[qq * TP + 4 * ty]);
          const float4 gs =
              *reinterpret_cast<const float4*>(&Ss[qq * TP + 4 * ty]);
#pragma unroll
          for (int u = 0; u < CN; ++u) {
            const int n = c * CN + u;
            const float ov = Ot[(tx + 16 * u) * TP + qq];
            const float qv = Qt[(tx + 16 * u) * TP + qq];
            dv[0][n] = fmaf(pp.x, ov, dv[0][n]);
            dv[1][n] = fmaf(pp.y, ov, dv[1][n]);
            dv[2][n] = fmaf(pp.z, ov, dv[2][n]);
            dv[3][n] = fmaf(pp.w, ov, dv[3][n]);
            dk[0][n] = fmaf(gs.x, qv, dk[0][n]);
            dk[1][n] = fmaf(gs.y, qv, dk[1][n]);
            dk[2][n] = fmaf(gs.z, qv, dk[2][n]);
            dk[3][n] = fmaf(gs.w, qv, dk[3][n]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= p.skv) continue;
#pragma unroll
    for (int c = 0; c < NC * CN; ++c) {
      store(&dkg[(int64_t)r * p.dk_ss + tx + 16 * c], dk[i][c]);
      store(&dvg[(int64_t)r * p.dv_ss + tx + 16 * c], dv[i][c]);
    }
  }
}


// --- bf16: wgmma, TMA and warp-specialised warpgroups ------------------------------
// The layout of a consumer warpgroup is hopper.cuh's: warp w of the group,
// lane (g, t) = (lane / 4, lane % 4), holds rows 16w + g and 16w + g + 8 of
// the group's 64 and, of an m64nN score, columns 8j + 2t and 8j + 2t + 1:
// accumulator i sits at row (i >> 1) & 1, column 8 (i >> 2) + 2t + (i & 1).
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
constexpr bool kWgmma = false;
template <>
constexpr bool kWgmma<__nv_bfloat16> = true;

constexpr int WG_THREADS = 384;      // a producer and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;    // arrivals on an empty barrier
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 64,512, the
// block's 384 x 168
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// K6: 128 query rows a block (64 a consumer), key tiles of BK through a
// ring of STAGES; dQ taken in chunks of DC columns.
template <int D>
struct DqWg {
  using SW = hopper::Swizzle<D>;
  static constexpr int BQ = 128;
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int DC = D > 128 ? 64 : D;
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int Q_BOX = BQ * SW::BYTES;   // bytes of a box
  static constexpr int KV_BOX = BK * SW::BYTES;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // q, do, the K and V rings, the barriers, and 1 KB to align the tiles
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
};

// K7: 64 keys a block (both consumers), (head, query tile of BQ) pairs
// through a ring of STAGES; dK and dV taken in chunks of DC columns; p^T
// handed from consumer 0 to consumer 1 through two buffers.
template <int D>
struct DkvWg {
  using SW = hopper::Swizzle<D>;
  static constexpr int BK = 64;
  static constexpr int BQ = 64;
  static constexpr int DC = D > 128 ? 64 : D;
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int LOADERS = 32;             // the lanes that load lse, dd
  static constexpr int BOX = 64 * SW::BYTES;     // bytes of a box (64 rows)
  static constexpr int TILE = 64 * D * 2;        // bytes of a 64-row tile
  static constexpr int P_FLOATS = BK * BQ;       // a p^T buffer
  // K, V, the q and do rings, p^T, lse and dd, the barriers, alignment
  static constexpr int SMEM = 1024 + 2 * TILE + 2 * STAGES * TILE +
                              2 * P_FLOATS * 4 + 2 * STAGES * BQ * 4 +
                              8 * (1 + 2 * STAGES + 4);
};

// K6: dq of 128 query rows of one (batch, head); the file's header.
template <int D>
__device__ __forceinline__ void dq_wg(const Params& p, const CUtensorMap* mq,
                                      const CUtensorMap* mk,
                                      const CUtensorMap* mv,
                                      const CUtensorMap* mo) {
  using namespace hopper;
  using C = DqWg<D>;
  using SW = typename C::SW;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Os = Qs + C::Q_BYTES;               // do
  uint8_t* Ks = Os + C::Q_BYTES;               // STAGES tiles
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
      mbar_init(&k_empty[s], CONSUMER_WARPS);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < SW::BOXES; ++x) {
        tma_load_4d(Qs + x * C::Q_BOX, mq, q_full, x * SW::BW, q0, h, b);
        tma_load_4d(Os + x * C::Q_BOX, mo, q_full, x * SW::BW, q0, h, b);
      }
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
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = C::BK / 2;   // score accumulators a thread
    constexpr int KQ = D / 16;      // k-steps of the score products
    constexpr int KP = C::BK / 16;  // k-steps of dS.K
    constexpr int PER_BOX = SW::BW / 16;
    const int tw = threadIdx.x % 128;
    const int c = threadIdx.x / 128 - 1;
    const int warp = tw >> 5, lane = tw & 31, t = lane & 3;
    const int qw = q0 + 64 * c;                 // the group's first row
    const int rows[2] = {qw + 16 * warp + (lane >> 2),
                         qw + 16 * warp + (lane >> 2) + 8};
    // lse (times log2 e) and dd of the lane's rows; 0 past Sq, where no
    // row is stored
    const int64_t row0 = ((int64_t)b * p.h + h) * p.sq;
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < p.sq;
      lse2[r] = in ? p.lse[row0 + rows[r]] * LOG2E : 0.f;
      dd[r] = in ? p.dd[row0 + rows[r]] : 0.f;
    }
    // descriptors at k-step 0 of the group's q and do rows, of stage 0's
    // K and V (all K-major), and of stage 0's K read MN-major for dS.K; a
    // stage is KV_BYTES further
    const uint64_t dq0 = desc(smem_u32(Qs) + 64 * c * SW::BYTES, 16,
                              SW::ATOM, SW::LAYOUT);
    const uint64_t do0 = desc(smem_u32(Os) + 64 * c * SW::BYTES, 16,
                              SW::ATOM, SW::LAYOUT);
    const uint64_t dk0 = desc(smem_u32(Ks), 16, SW::ATOM, SW::LAYOUT);
    const uint64_t dv0 = desc(smem_u32(Vs), 16, SW::ATOM, SW::LAYOUT);
    const uint64_t dkt = desc(smem_u32(Ks), C::KV_BOX, SW::ATOM, SW::LAYOUT);
    constexpr uint64_t STAGE = C::KV_BYTES >> 4;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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

      // this tile's descriptors, opaque to the compiler (it would hoist
      // every k-step's descriptor out of the loop, 2 registers each)
      uint64_t dqj = dq0, doj = do0, dkj = dk0 + s * STAGE,
               dvj = dv0 + s * STAGE, dktj = dkt + s * STAGE;
      asm volatile("" : "+l"(dqj), "+l"(doj), "+l"(dkj), "+l"(dvj),
                   "+l"(dktj));

      // S = q.k^T, then dP = do.v^T once V has landed
      float sacc[NS], dpacc[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint64_t qo = (kk / PER_BOX) * (C::Q_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        const uint64_t ko = (kk / PER_BOX) * (C::KV_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        Wgmma<C::BK>::ss(sacc, opaque(dqj + qo), opaque(dkj + ko), kk > 0);
      }
      wgmma_commit();
      mbar_wait(&v_full[s], phase);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint64_t qo = (kk / PER_BOX) * (C::Q_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        const uint64_t ko = (kk / PER_BOX) * (C::KV_BOX >> 4) +
                            (kk % PER_BOX) * 2;
        Wgmma<C::BK>::ss(dpacc, opaque(doj + qo), opaque(dvj + ko), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sacc);

      // p = 2^(q.k . scale . log2(e) - lse . log2(e)) = exp(s - lse) while
      // dP is in flight; masked, without branches, only where the tile
      // crosses kv_len, the diagonal or the window edge for some row
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sacc[i] = ex2(fmaf(sacc[i], scale_log2, -lse2[(i >> 1) & 1]));
      const bool edge = k0 + C::BK > kv_end ||
                        (p.causal && k0 + C::BK - 1 > qw) ||
                        (p.window > 0 && k0 <= qw + 63 - p.window);
      if (edge) {
        // valid keys of this lane's rows: [lo, hi)
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
          sacc[i] = key >= lo[r] && key < hi[r] ? sacc[i] : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[s]);

      // ds = p (dp - dd) scale = hi + lo in the A layout: register e of
      // k-step kk holds accumulators 8kk + 2e and 8kk + 2e + 1
      uint32_t dh[KP][4], dl[KP][4];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const float d0 = sacc[i] * (dpacc[i] - dd[e & 1]) * p.sm_scale;
          const float d1 =
              sacc[i + 1] * (dpacc[i + 1] - dd[e & 1]) * p.sm_scale;
          split(d0, d1, dh[kk][e], dl[kk][e]);
        }

      // dQ += dS.K: a fresh accumulator a chunk of DC columns, added by
      // one FADD; K read MN-major
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += C::DC) {
        float part[C::DC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          // 16 keys a k-step: 16 rows of every box; the chunk's first box
          const uint64_t ko = (n0 / SW::BW) * (C::KV_BOX >> 4) +
                              kk * ((16 * SW::BYTES) >> 4);
          const uint64_t b = opaque(dktj + ko);
          Wgmma<C::DC>::rs(part, dh[kk], b, kk > 0);
          Wgmma<C::DC>::rs(part, dl[kk], b, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        fence_regs(dh);
        fence_regs(dl);
#pragma unroll
        for (int i = 0; i < C::DC / 2; ++i) acc[n0 / 2 + i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[s]);
    }

    bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rows[r];
      if (row >= p.sq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            &dqg[(int64_t)row * p.dq_ss + 8 * n + 2 * t]) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

// K7: dk and dv of 64 keys of one (batch, kv head); the file's header.
template <int D>
__device__ __forceinline__ void dkv_wg(const Params& p, const CUtensorMap* mq,
                                       const CUtensorMap* mk,
                                       const CUtensorMap* mv,
                                       const CUtensorMap* mo) {
  using namespace hopper;
  using C = DkvWg<D>;
  using SW = typename C::SW;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + C::TILE;
  uint8_t* Qs = Vs + C::TILE;                  // STAGES tiles
  uint8_t* Os = Qs + C::STAGES * C::TILE;      // STAGES tiles, do
  float* Ps = reinterpret_cast<float*>(Os + C::STAGES * C::TILE);  // 2 x p^T
  float* Ls = Ps + 2 * C::P_FLOATS;            // STAGES x BQ, lse * log2(e)
  float* Ds = Ls + C::STAGES * C::BQ;          // STAGES x BQ, dd
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + C::STAGES * C::BQ);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + C::STAGES;
  uint64_t* p_full = q_empty + C::STAGES;
  uint64_t* p_empty = p_full + 2;

  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.y * C::BK;            // causal: longest tiles first
  const int kv_end = min(p.kv_len, p.skv);
  // query tiles that hold a valid pair with a key of this tile
  int iq_begin = 0, iq_end = (p.sq + C::BQ - 1) / C::BQ;
  if (k0 >= kv_end) iq_end = 0;
  if (p.causal) iq_begin = k0 / C::BQ;
  if (p.window > 0)
    iq_end = min(iq_end, (k0 + C::BK - 1 + p.window - 1) / C::BQ + 1);
  const int nqt = max(0, iq_end - iq_begin);
  const int n_iter = group * nqt;               // (head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&q_full[s], 1 + C::LOADERS);
      mbar_init(&q_empty[s], CONSUMER_WARPS);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&p_full[i], 128);
      mbar_init(&p_empty[i], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: thread 0 starts the TMA loads, warp 1
    // loads each stage's lse and dd
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      if (n_iter > 0) {
        mbar_expect_tx(kv_full, 2 * C::TILE);
#pragma unroll
        for (int x = 0; x < SW::BOXES; ++x) {
          tma_load_4d(Ks + x * C::BOX, mk, kv_full, x * SW::BW, k0, hk, b);
          tma_load_4d(Vs + x * C::BOX, mv, kv_full, x * SW::BW, k0, hk, b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::STAGES;
        const uint32_t phase = (it / C::STAGES) & 1;
        const int h = hk * group + it / nqt;
        const int q0 = (iq_begin + it % nqt) * C::BQ;
        mbar_wait(&q_empty[s], phase ^ 1);
        mbar_expect_tx(&q_full[s], 2 * C::TILE);
#pragma unroll
        for (int x = 0; x < SW::BOXES; ++x) {
          tma_load_4d(Qs + s * C::TILE + x * C::BOX, mq, &q_full[s],
                      x * SW::BW, q0, h, b);
          tma_load_4d(Os + s * C::TILE + x * C::BOX, mo, &q_full[s],
                      x * SW::BW, q0, h, b);
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 32 + C::LOADERS) {
      const int lane = threadIdx.x - 32;
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % C::STAGES;
        const uint32_t phase = (it / C::STAGES) & 1;
        const int h = hk * group + it / nqt;
        const int q0 = (iq_begin + it % nqt) * C::BQ;
        const int64_t row0 = ((int64_t)b * p.h + h) * p.sq;
        mbar_wait(&q_empty[s], phase ^ 1);
        // rows at or past Sq are 0 (their pairs are masked)
        for (int r = lane; r < C::BQ; r += C::LOADERS) {
          const bool in = q0 + r < p.sq;
          Ls[s * C::BQ + r] = in ? p.lse[row0 + q0 + r] * LOG2E : 0.f;
          Ds[s * C::BQ + r] = in ? p.dd[row0 + q0 + r] : 0.f;
        }
        mbar_arrive(&q_full[s]);
      }
    }
  } else {
    // a consumer warpgroup, role 0: s^T = K.q^T, p^T (handed over), dV +=
    // P^T.do; role 1: dp^T = V.do^T, ds^T with the p^T handed over, dK +=
    // dS^T.q. Both on the block's 64 keys.
    setmaxnreg_inc<CONSUMER_REGS>();
    constexpr int NS = C::BQ / 2;   // score accumulators a thread
    constexpr int KD = D / 16;      // k-steps of the score product
    constexpr int KP = C::BQ / 16;  // k-steps of the output product
    constexpr int PER_BOX = SW::BW / 16;
    const int tw = threadIdx.x % 128;
    const int role = threadIdx.x / 128 - 1;
    const int warp = tw >> 5, lane = tw & 31, t = lane & 3;
    const int keys[2] = {k0 + 16 * warp + (lane >> 2),
                         k0 + 16 * warp + (lane >> 2) + 8};
    // the score product's A (K or V) and B (stage 0's q or do), both
    // K-major; the output product's B (stage 0's do or q) MN-major, the
    // same tile as the other role's score B: a stage is TILE further
    const uint64_t da = desc(smem_u32(role ? Vs : Ks), 16, SW::ATOM,
                             SW::LAYOUT);
    const uint64_t db = desc(smem_u32(role ? Os : Qs), 16, SW::ATOM,
                             SW::LAYOUT);
    const uint64_t dm = desc(smem_u32(role ? Qs : Os), C::BOX, SW::ATOM,
                             SW::LAYOUT);
    constexpr uint64_t STAGE = C::TILE >> 4;
    // role 0's mask: the valid queries of this lane's keys, [lo, hi)
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = p.causal ? keys[r] : 0;
      hi[r] = keys[r] >= kv_end ? 0
              : p.window > 0    ? min(p.sq, keys[r] + p.window)
                                : p.sq;
    }

    float acc[D / 2];   // dV (role 0) or dK (role 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const float scale_log2 = p.sm_scale * LOG2E;
    if (n_iter > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % C::STAGES;
      const uint32_t phase = (it / C::STAGES) & 1;
      const int q0 = (iq_begin + it % nqt) * C::BQ;
      const int pb = it & 1;                     // the p^T buffer
      const uint32_t pphase = (it >> 1) & 1;
      mbar_wait(&q_full[s], phase);
      __syncwarp();
      uint64_t daj = da, dbj = db + s * STAGE, dmj = dm + s * STAGE;
      asm volatile("" : "+l"(daj), "+l"(dbj), "+l"(dmj));

      // s^T (role 0) or dp^T (role 1): keys x queries
      float x[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint64_t o = (kk / PER_BOX) * (C::BOX >> 4) + (kk % PER_BOX) * 2;
        Wgmma<C::BQ>::ss(x, opaque(daj + o), opaque(dbj + o), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);

      // accumulators 4j .. 4j + 3: columns 8j + 2t, 8j + 2t + 1 of rows g
      // and g + 8; their lse (dd) are a float2 of the stage
      const float2* l2 = reinterpret_cast<const float2*>(Ls + s * C::BQ);
      const float2* d2 = reinterpret_cast<const float2*>(Ds + s * C::BQ);
      float4* pbuf = reinterpret_cast<float4*>(Ps + pb * C::P_FLOATS);
      if (role == 0) {
        // p^T = 2^(s^T . scale . log2(e) - lse . log2(e)), masked without
        // branches where the tile crosses kv_len, Sq, the diagonal or the
        // window edge (block-uniform)
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          const float2 l = l2[4 * j + t];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] =
                ex2(fmaf(x[4 * j + e], scale_log2, -(e & 1 ? l.y : l.x)));
        }
        const bool inside =
            k0 + C::BK <= kv_end && q0 + C::BQ <= p.sq &&
            (!p.causal || k0 + C::BK - 1 <= q0) &&
            (p.window <= 0 || q0 + C::BQ - 1 < k0 + p.window);
        if (!inside) {
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int q = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const int r = (i >> 1) & 1;
            x[i] = q >= lo[r] && q < hi[r] ? x[i] : 0.f;
          }
        }
        mbar_wait(&p_empty[pb], pphase ^ 1);
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
          pbuf[j * 128 + tw] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        mbar_arrive(&p_full[pb]);
      } else {
        // ds^T = p^T (dp^T - dd) scale
        mbar_wait(&p_full[pb], pphase);
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          const float4 pt = pbuf[j * 128 + tw];
          const float2 dd = d2[4 * j + t];
          x[4 * j] = pt.x * (x[4 * j] - dd.x) * p.sm_scale;
          x[4 * j + 1] = pt.y * (x[4 * j + 1] - dd.y) * p.sm_scale;
          x[4 * j + 2] = pt.z * (x[4 * j + 2] - dd.x) * p.sm_scale;
          x[4 * j + 3] = pt.w * (x[4 * j + 3] - dd.y) * p.sm_scale;
        }
        mbar_arrive(&p_empty[pb]);
      }

      // p^T or ds^T = hi + lo in the A layout: register e of k-step kk
      // holds accumulators 8kk + 2e and 8kk + 2e + 1
      uint32_t xh[KP][4], xl[KP][4];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          split(x[i], x[i + 1], xh[kk][e], xl[kk][e]);
        }

      // dV += P^T.do or dK += dS^T.q: a fresh accumulator a chunk of DC
      // columns, added by one FADD; do or q read MN-major
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += C::DC) {
        float part[C::DC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          // 16 queries a k-step: 16 rows of every box; the chunk's first box
          const uint64_t o = (n0 / SW::BW) * (C::BOX >> 4) +
                             kk * ((16 * SW::BYTES) >> 4);
          const uint64_t b = opaque(dmj + o);
          Wgmma<C::DC>::rs(part, xh[kk], b, kk > 0);
          Wgmma<C::DC>::rs(part, xl[kk], b, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        fence_regs(xh);
        fence_regs(xl);
#pragma unroll
        for (int i = 0; i < C::DC / 2; ++i) acc[n0 / 2 + i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[s]);
    }

    // every key row of the tile is written once, zeros where no pair was
    // valid
    bf16* dst = static_cast<bf16*>(role ? p.dk : p.dv) +
                b * (role ? p.dk_sb : p.dv_sb) +
                hk * (role ? p.dk_sh : p.dv_sh);
    const int64_t ss = role ? p.dk_ss : p.dv_ss;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = keys[r];
      if (key >= p.skv) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(&dst[(int64_t)key * ss + 8 * n +
                                                2 * t]) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgmma<T> ? WG_THREADS : THREADS, 1)
flash_bwd_dq_kernel(const Params p, const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mo) {
  if constexpr (kWgmma<T>)
    dq_wg<D>(p, &mq, &mk, &mv, &mo);
  else
    dq_fma<T, D>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgmma<T> ? WG_THREADS : THREADS, 1)
flash_bwd_dkv_kernel(const Params p, const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mo) {
  if constexpr (kWgmma<T>)
    dkv_wg<D>(p, &mq, &mk, &mv, &mo);
  else
    dkv_fma<T, D>(p);
}

// The bf16 kernels' tensor maps: q and do in boxes of q_rows rows, k and v
// of kv_rows. A tensor with no rows takes a copy of another's map (its
// kernel loads nothing from it). false if one cannot be encoded.
struct Maps {
  CUtensorMap q, k, v, o;
};

template <int D>
bool make_maps(const Params& p, int batch, int q_rows, int kv_rows,
               Maps& m) {
  using SW = hopper::Swizzle<D>;
  if (p.sq > 0 &&
      !(hopper::tensor_map_4d(&m.q, p.q, D, p.sq, p.h, batch, p.q_ss,
                              p.q_sh, p.q_sb, SW::BW, q_rows, SW::BYTES) &&
        hopper::tensor_map_4d(&m.o, p.dout, D, p.sq, p.h, batch, p.o_ss,
                              p.o_sh, p.o_sb, SW::BW, q_rows, SW::BYTES)))
    return false;
  if (p.skv > 0 &&
      !(hopper::tensor_map_4d(&m.k, p.k, D, p.skv, p.hkv, batch, p.k_ss,
                              p.k_sh, p.k_sb, SW::BW, kv_rows, SW::BYTES) &&
        hopper::tensor_map_4d(&m.v, p.v, D, p.skv, p.hkv, batch, p.v_ss,
                              p.v_sh, p.v_sb, SW::BW, kv_rows, SW::BYTES)))
    return false;
  if (p.sq == 0) m.q = m.o = m.k;
  if (p.skv == 0) m.k = m.v = m.q;
  return true;
}

// Dynamic shared memory of a K6 or (dkv) K7 launch at head dim D.
template <typename T, int D>
int smem_bytes(bool dkv) {
  if constexpr (kWgmma<T>)
    return dkv ? DkvWg<D>::SMEM : DqWg<D>::SMEM;
  else
    return dkv ? smem_dkv<D>() : smem_dq<D>();
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, bool dkv, int device,
                   cudaStream_t stream) {
  constexpr bool wg = kWgmma<T>;
  const int bytes = smem_bytes<T, D>(dkv);
  // the attribute belongs to a kernel on one device: one flag a kernel,
  // one bit of it a device
  static std::atomic<uint64_t> configured[2] = {};
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (!(configured[dkv].load(std::memory_order_relaxed) & bit)) {
    const void* fn = dkv ? (const void*)flash_bwd_dkv_kernel<T, D>
                         : (const void*)flash_bwd_dq_kernel<T, D>;
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured[dkv].fetch_or(bit, std::memory_order_relaxed);
  }
  Maps maps{};
  if constexpr (wg) {
    const bool ok = dkv ? make_maps<D>(p, batch, DkvWg<D>::BQ,
                                       DkvWg<D>::BK, maps)
                        : make_maps<D>(p, batch, DqWg<D>::BQ, DqWg<D>::BK,
                                       maps);
    if (!ok) return cudaErrorInvalidValue;
  }
  const int threads = wg ? WG_THREADS : THREADS;
  if (dkv) {
    const int bk = wg ? DkvWg<D>::BK : BK;
    const int nk = (p.skv + bk - 1) / bk;
    // bf16: blockIdx.y the key tile, so that every (batch, kv head) takes
    // its first (longest causal) tiles before any takes its next
    if (wg && nk > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid = wg ? dim3(batch * p.hkv, nk) : dim3(nk, batch * p.hkv);
    flash_bwd_dkv_kernel<T, D><<<grid, threads, bytes, stream>>>(
        p, maps.q, maps.k, maps.v, maps.o);
  } else {
    const int bq = wg ? DqWg<D>::BQ : BQ;
    const dim3 grid((p.sq + bq - 1) / bq, batch * p.h);
    flash_bwd_dq_kernel<T, D><<<grid, threads, bytes, stream>>>(
        p, maps.q, maps.k, maps.v, maps.o);
  }
  return cudaGetLastError();
}

template <typename T>
int smem_bytes(int d, bool dkv) {
  switch (d) {
    case 32: return smem_bytes<T, 32>(dkv);
    case 64: return smem_bytes<T, 64>(dkv);
    case 80: return smem_bytes<T, 80>(dkv);
    case 128: return smem_bytes<T, 128>(dkv);
    case 256: return smem_bytes<T, 256>(dkv);
    default: return 0;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, bool dkv, int device,
                     cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, dkv, device, s);
    case 64: return launch<T, 64>(p, batch, dkv, device, s);
    case 80: return launch<T, 80>(p, batch, dkv, device, s);
    case 128: return launch<T, 128>(p, batch, dkv, device, s);
    case 256: return launch<T, 256>(p, batch, dkv, device, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int dtype, const Params& p, int batch, int d, bool dkv, int device,
        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = dtype == 1 ? dispatch<__nv_bfloat16>(p, batch, d, dkv, device, s)
      : dtype == 0 ? dispatch<float>(p, batch, d, dkv, device, s)
                   : cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Strides are in elements; every head-dim
// axis is contiguous. lse and dd are contiguous (B, H, Sq) float32.
int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* dd, void* dq, int batch, int h,
                           int hkv, int sq, int skv, int d,
                           int64_t q_sb, int64_t q_sh, int64_t q_ss,
                           int64_t k_sb, int64_t k_sh, int64_t k_ss,
                           int64_t v_sb, int64_t v_sh, int64_t v_ss,
                           int64_t o_sb, int64_t o_sh, int64_t o_ss,
                           int64_t dq_sb, int64_t dq_sh, int64_t dq_ss,
                           float sm_scale, int causal, int window,
                           int kv_len, int device, void* stream) {
  Params p{q, k, v, dout, lse, dd, dq, nullptr, nullptr,
           h, hkv, sq, skv, kv_len, window, causal, sm_scale,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss, 0, 0, 0, 0, 0, 0};
  return run(dtype, p, batch, d, false, device, stream);
}

int flash_attention_bwd_dkv(int dtype, const void* q, const void* k,
                            const void* v, const void* dout,
                            const float* lse, const float* dd, void* dk,
                            void* dv, int batch, int h, int hkv, int sq,
                            int skv, int d,
                            int64_t q_sb, int64_t q_sh, int64_t q_ss,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            int64_t o_sb, int64_t o_sh, int64_t o_ss,
                            int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
                            int64_t dv_sb, int64_t dv_sh, int64_t dv_ss,
                            float sm_scale, int causal, int window,
                            int kv_len, int device, void* stream) {
  Params p{q, k, v, dout, lse, dd, nullptr, dk, dv,
           h, hkv, sq, skv, kv_len, window, causal, sm_scale,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, 0, 0, 0, dk_sb, dk_sh, dk_ss,
           dv_sb, dv_sh, dv_ss};
  return run(dtype, p, batch, d, true, device, stream);
}

// Dynamic shared memory (bytes) a launch of K6 (dkv = 0) or K7 (dkv = 1)
// at head dim d takes; 0 for a head dim that is not built.
int flash_attention_bwd_smem(int dtype, int d, int dkv) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(d, dkv != 0)
                    : dtype == 0 ? smem_bytes<float>(d, dkv != 0) : 0;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
