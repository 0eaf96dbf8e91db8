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
// K6: one block per (64-row query tile, batch * head), looping over key
// tiles with the dq tile in registers (the TPU kernel carries it in VMEM
// across its sequential kv grid axis). K7: one block per (64-row key tile,
// batch * kv head), looping over every query head of the group and every
// query tile, the reference's flattened (group, iq) axis, with dk and dv in
// registers. No atomics: each output row is written once, by one block, so
// dk and dv are deterministic and need no zero-fill pass. Tiles wholly
// above the causal diagonal, outside the window or past kv_len are skipped,
// as K5 skips them.
//
// Bound. At the training shape (B=1, H=32, Hkv=8, S=4095, D=128, bf16,
// causal) each valid pair costs K6 6*D operations (s, dp, dq) and K7 8*D
// (s, dp, dv, dk): ~2.1e11 and ~2.7e11 per layer, 208 and 278 us at the
// bf16 tensor-core peak, against ~35 us for the bytes: both are bound by
// operations.
//
// K6 and K7 in bf16 (the main path) run on the tensor cores: mma.sync
// m16n8k16 on bf16 tiles staged by cp.async, p and ds split into two bf16
// halves in registers to keep their float32 semantics (dq_tc and dkv_tc
// below; the building blocks are in mma_bf16.cuh). With the split K6's
// tensor work is 8*D a pair and K7's 12*D, 4/3x and 1.5x what the bound
// counts (278 and 417 us at the peak).
//
// In float32 both are the FMA kernels of the first port (CUDA cores, 67
// TFLOP/s peak). Thread layout: 256 threads, (ty, tx) =
// (tid / 16, tid % 16). Thread (ty, tx) computes the 4x4 block of the
// score tile at rows 4*ty.. (queries in K6, keys in K7) and columns 4*tx..
// (keys in K6, queries in K7), and owns output columns tx + 16*c
// (c < D/16) of rows 4*ty..4*ty+3. Q, dO, K and V tiles sit in shared
// memory transposed (D x 68 floats), so the score products read broadcast
// or conflict-free float4s; the output products read the transposed tiles
// by column (a 2-way bank conflict) and ds / p by float4. The float32
// instantiations are what chip_smoke's float32 checks (4 training layers
// in float32, the f32_window case) hold; the bf16 ones are held by the
// bf16 checks and their planted faults.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128). C interface, loaded with ctypes by
// repro_torch/kernels/flash_cuda.py; each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int TP = 68;  // row pitch (floats) of every transposed tile

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

template <int D>
constexpr int smem_dq() { return (int)sizeof(float) * (4 * D * TP + BK * TP); }
template <int D>
constexpr int smem_dkv() {
  return (int)sizeof(float) * (4 * D * TP + 2 * BQ * TP);
}

// --- K6: dq --------------------------------------------------------------------
// float32: the FMA layout above; one block per (query tile, batch * head),
// blockIdx.x the query tile.
template <typename T, int D>
__device__ __forceinline__ void dq_fma(const Params& p) {
  constexpr int DN = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // D x TP, q^T
  float* Ot = Qt + D * TP;                      // D x TP, do^T
  float* Kt = Ot + D * TP;                      // D x TP, k^T
  float* Vt = Kt + D * TP;                      // D x TP, v^T
  float* St = Vt + D * TP;                      // BK x TP, ds^T
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

  float acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;

  int k_end = min(p.kv_len, p.skv);
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q, dO staged; the previous tile's K, ds consumed
    load_t<T, D>(Kt, kg, p.k_ss, k0, p.skv);
    load_t<T, D>(Vt, vg, p.v_ss, k0, p.skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    score_products<D>(s, dp, Qt, Kt, Ot, Vt, 4 * ty, 4 * tx);

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

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 g = *reinterpret_cast<const float4*>(&St[kk * TP + 4 * ty]);
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float kv = Kt[(tx + 16 * c) * TP + kk];
        acc[0][c] = fmaf(g.x, kv, acc[0][c]);
        acc[1][c] = fmaf(g.y, kv, acc[1][c]);
        acc[2][c] = fmaf(g.z, kv, acc[2][c]);
        acc[3][c] = fmaf(g.w, kv, acc[3][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c)
      store(&dqg[(int64_t)r * p.dq_ss + tx + 16 * c], acc[i][c]);
  }
}

// --- K7: dk, dv ------------------------------------------------------------------
// float32: the FMA layout above; one block per (key tile, batch * kv head)
// with blockIdx.x the key tile.
template <typename T, int D>
__device__ __forceinline__ void dkv_fma(const Params& p) {
  constexpr int DN = D / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // D x TP, k^T (resident)
  float* Vt = Kt + D * TP;                      // D x TP, v^T (resident)
  float* Qt = Vt + D * TP;                      // D x TP, q^T
  float* Ot = Qt + D * TP;                      // D x TP, do^T
  float* Ps = Ot + D * TP;                      // BQ x TP, p[query][key]
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

  float dk[4][DN], dv[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk[i][c] = dv[i][c] = 0.f;

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
      __syncthreads();  // the previous tile's Q, dO, p, ds are consumed
      load_t<T, D>(Qt, qg, p.q_ss, q0, p.sq);
      load_t<T, D>(Ot, og, p.o_ss, q0, p.sq);
      if (tid < BQ) {
        const bool in = q0 + tid < p.sq;
        lse_s[tid] = in ? p.lse[row + q0 + tid] : 0.f;
        dd_s[tid] = in ? p.dd[row + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T: rows are keys 4*ty.., columns queries 4*tx..
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      score_products<D>(s, dp, Kt, Qt, Vt, Ot, 4 * ty, 4 * tx);

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

#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 pp = *reinterpret_cast<const float4*>(&Ps[qq * TP + 4 * ty]);
        const float4 gs = *reinterpret_cast<const float4*>(&Ss[qq * TP + 4 * ty]);
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          const float ov = Ot[(tx + 16 * c) * TP + qq];
          const float qv = Qt[(tx + 16 * c) * TP + qq];
          dv[0][c] = fmaf(pp.x, ov, dv[0][c]);
          dv[1][c] = fmaf(pp.y, ov, dv[1][c]);
          dv[2][c] = fmaf(pp.z, ov, dv[2][c]);
          dv[3][c] = fmaf(pp.w, ov, dv[3][c]);
          dk[0][c] = fmaf(gs.x, qv, dk[0][c]);
          dk[1][c] = fmaf(gs.y, qv, dk[1][c]);
          dk[2][c] = fmaf(gs.z, qv, dk[2][c]);
          dk[3][c] = fmaf(gs.w, qv, dk[3][c]);
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
    for (int c = 0; c < DN; ++c) {
      store(&dkg[(int64_t)r * p.dk_ss + tx + 16 * c], dk[i][c]);
      store(&dvg[(int64_t)r * p.dv_ss + tx + 16 * c], dv[i][c]);
    }
  }
}


// bf16: tensor cores. One block per (batch * kv head, key tile of BK = 64
// rows), blockIdx.y the key tile, so the longest (causal) tiles are
// dispatched first. Each of the 4 warps owns 16 key rows; K and V stay in
// shared memory (bf16, pitched), the q and do tiles (BQ = 64 rows) with
// their lse and dd are double-buffered by cp.async over the flattened
// (head of the group, query tile) loop. The query tile is taken in parts
// of SUB = 16 queries so that at D = 128 the dK and dV accumulators (128
// floats a lane) leave room for s^T and dp^T (8 each) without spilling
// (parts of 32 spilled 48 bytes a thread):
//   s^T  = K.Q^T           (A: K by ldmatrix, B: Q by ldmatrix)
//   p^T  = exp(s^T * scale - lse), 0 off the mask
//   dV  += P^T.dO          (A: p^T split hi/lo, B: dO by ldmatrix.trans)
//   dp^T = V.dO^T
//   ds^T = p^T * (dp^T - dd) * scale
//   dK  += dS^T.Q          (A: ds^T split hi/lo, B: Q by ldmatrix.trans)
// p and ds never leave the registers. The split costs 12*D tensor
// operations a valid pair where the bound counts 8*D.
constexpr int THREADS_DKV = 2 * BK;  // a warp per 16 keys
constexpr int SUB = 16;
constexpr float LOG2E = 1.4426950408889634f;

// acc (the warp's 16 rows x D) += X.Y for X = x, 16 x NS*8 float32 in the
// accumulator layout of a score product (K7's p^T or ds^T, K6's ds),
// split hi/lo, and Y = rows c0..c0+NS*8-1 of the pitched tile Y (K7's q
// or do, K6's k; read by ldmatrix.trans). Each 8-column tile's products
// go into a fresh accumulator that one FADD adds to acc: the tensor cores'
// float32 additions are not rounded to nearest, and a chain of every
// query tile's products into acc drifts (by 1% of bf16 outputs differing
// from the plain version at the training shape).
template <int D, int NS>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[NS][4],
                                           const __nv_bfloat16* Y, int c0,
                                           int lane) {
  using namespace mma_bf16;
  uint32_t hi[NS / 2][4], lo[NS / 2][4];
#pragma unroll
  for (int c = 0; c < NS / 2; ++c)
    split_a(x[2 * c], x[2 * c + 1], hi[c], lo[c]);
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < NS / 2; ++c) {
      uint32_t yf[4];
      ldsm_x4_t(yf, a_addr<D>(Y, c0 + 16 * c, 8 * n, lane));
      mma(part[0], hi[c], yf[0], yf[1]);
      mma(part[0], lo[c], yf[0], yf[1]);
      mma(part[1], hi[c], yf[2], yf[3]);
      mma(part[1], lo[c], yf[2], yf[3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n + u][e] += part[u][e];
  }
}

template <int D>
constexpr int smem_dkv_tc() {
  return (int)sizeof(__nv_bfloat16) * (2 * BK + 4 * BQ) *
             mma_bf16::Tile<D>::PITCH +
         (int)sizeof(float) * 4 * BQ;
}

template <int D>
__device__ __forceinline__ void dkv_tc(const Params& p) {
  using namespace mma_bf16;
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = Tile<D>::PITCH;
  constexpr int KD = D / 16;    // k-steps of the score products
  constexpr int ND = D / 8;     // 8-column tiles of dK, dV
  constexpr int NS = SUB / 8;   // 8-column tiles of a score part
  constexpr int NT = THREADS_DKV;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // BK x PITCH (resident)
  bf16* Vs = Ks + BK * PITCH;                 // BK x PITCH (resident)
  bf16* Qs = Vs + BK * PITCH;                 // 2 x BQ x PITCH
  bf16* Os = Qs + 2 * BQ * PITCH;             // 2 x BQ x PITCH, do
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * PITCH);  // 2 x BQ lse
  float* Ds = Ls + 2 * BQ;                                    // 2 x BQ dd

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.y * BK;
  const int kw = k0 + 16 * warp;                // the warp's first key
  const int kv_end = min(p.kv_len, p.skv);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // query tiles that hold a valid pair with a key of this tile
  int iq_begin = 0, iq_end = (p.sq + BQ - 1) / BQ;
  if (k0 >= kv_end) iq_end = 0;
  if (p.causal) iq_begin = k0 / BQ;
  if (p.window > 0)
    iq_end = min(iq_end, (k0 + BK - 1 + p.window - 1) / BQ + 1);
  const int nqt = max(0, iq_end - iq_begin);
  const int n_iter = group * nqt;

  // stage the (head, query tile) of iteration it into buffer buf
  auto stage = [&](int it, int buf) {
    const int h = hk * group + it / nqt;
    const int q0 = (iq_begin + it % nqt) * BQ;
    const bf16* qg =
        static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* og =
        static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
    load_tile<BQ, D, NT, true>(Qs + buf * BQ * PITCH, qg, p.q_ss, q0, p.sq);
    load_tile<BQ, D, NT, true>(Os + buf * BQ * PITCH, og, p.o_ss, q0, p.sq);
    const int64_t row = ((int64_t)b * p.h + h) * p.sq;
    const int r = tid & (BQ - 1);
    const bool in = q0 + r < p.sq;
    const float* src = (tid < BQ ? p.lse : p.dd) + row + (in ? q0 + r : 0);
    cp_async4((tid < BQ ? Ls : Ds) + buf * BQ + r, src, in);
  };

  load_tile<BK, D, NT, true>(Ks, kg, p.k_ss, k0, p.skv);
  load_tile<BK, D, NT, true>(Vs, vg, p.v_ss, k0, p.skv);
  if (n_iter > 0) stage(0, 0);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int keys[2] = {kw + g, kw + g + 8};

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();  // iteration it's tiles have landed (this thread's)
    __syncthreads();     // ... everyone's; iteration it-1's buffer is free
    if (it + 1 < n_iter) stage(it + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = (iq_begin + it % nqt) * BQ;
    const bf16* Qb = Qs + buf * BQ * PITCH;
    const bf16* Ob = Os + buf * BQ * PITCH;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;

#pragma unroll 1
    for (int part = 0; part < BQ / SUB; ++part) {
      const int c0 = part * SUB;   // first column (query) of the part
      const int qs = q0 + c0;
      // warp-uniform: no valid pair between the warp's keys and the part
      if (kw >= kv_end || qs >= p.sq || (p.causal && qs + SUB - 1 < kw) ||
          (p.window > 0 && qs - p.window >= kw + 15))
        continue;
      const bool edge = kw + 15 >= kv_end || qs + SUB > p.sq ||
                        (p.causal && qs < kw + 15) ||
                        (p.window > 0 && qs + SUB - 1 - p.window >= kw);

      float st[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a_addr<D>(Ks, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t qf[4];
          ldsm_x4(qf, bt_addr<D>(Qb, c0 + 8 * n, 16 * kk, lane));
          mma(st[n], af, qf[0], qf[1]);
          mma(st[n + 1], af, qf[2], qf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * t + (e & 1);
          bool ok = true;
          if (edge) {
            const int qi = q0 + col, key = keys[e >> 1];
            ok = qi < p.sq && key < kv_end;
            if (p.causal) ok = ok && key <= qi;
            if (p.window > 0) ok = ok && key > qi - p.window;
          }
          st[n][e] = ok ? exp2f((st[n][e] * p.sm_scale - Lb[col]) * LOG2E)
                        : 0.f;
        }

      // dV += P^T.dO
      accumulate<D, NS>(dv, st, Ob, c0, lane);

      // dp^T = V.dO^T, then ds^T in place
      float dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, a_addr<D>(Vs, 16 * warp, 16 * kk, lane));
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t of[4];
          ldsm_x4(of, bt_addr<D>(Ob, c0 + 8 * n, 16 * kk, lane));
          mma(dpt[n], af, of[0], of[1]);
          mma(dpt[n + 1], af, of[2], of[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * n + 2 * t + (e & 1);
          dpt[n][e] = st[n][e] * (dpt[n][e] - Db[col]) * p.sm_scale;
        }

      // dK += dS^T.Q
      accumulate<D, NS>(dk, dpt, Qb, c0, lane);
    }
  }
  cp_async_wait<0>();  // nothing left in flight (n_iter may be 0)

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = keys[i];
    if (r >= p.skv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(
          &dkg[(int64_t)r * p.dk_ss + 8 * n + 2 * t]) =
          __floats2bfloat162_rn(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          &dvg[(int64_t)r * p.dv_ss + 8 * n + 2 * t]) =
          __floats2bfloat162_rn(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(
    mma_bf16::kTensorCores<T> ? THREADS_DKV : THREADS,
    mma_bf16::kTensorCores<T> ? 2 : 1)  // two bf16 blocks an SM
flash_bwd_dkv_kernel(const Params p) {
  if constexpr (mma_bf16::kTensorCores<T>)
    dkv_tc<D>(p);
  else
    dkv_fma<T, D>(p);
}

// --- K6, bf16: dq on the tensor cores ------------------------------------------
// K5's loop with K7's products. One block per (query tile of BQ = 64 rows,
// batch * head), blockIdx.x the query tile, longest (causal) tiles first.
// Each of the 4 warps owns 16 query rows; the q and do tiles stay in
// shared memory (bf16, pitched) and are re-read by ldmatrix (held in
// registers they would take 64 of them a lane), K and V tiles (BK = 64
// keys) are double-buffered by cp.async, the next tile's copy in flight
// during the current one's products; lse and dd of the lane's two rows
// sit in registers. The whole key tile is taken at once: at D = 128 the
// dQ accumulator (64 floats a lane) and s and dp (32 each) fit without
// spilling, and parts of 32 or 16 keys ran slower:
//   s   = Q.K^T            (A: Q by ldmatrix, B: K by ldmatrix)
//   dp  = dO.V^T           (A: dO by ldmatrix, B: V by ldmatrix)
//   p   = exp(s * scale - lse), 0 off the mask
//   ds  = p * (dp - dd) * scale
//   dQ += dS.K             (A: ds split hi/lo, B: K by ldmatrix.trans)
// ds never leaves the registers. The split costs 8*D tensor operations a
// valid pair where the bound counts 6*D. About 104 KB of shared memory at
// D = 128: two blocks an SM.
constexpr int THREADS_DQ = 2 * BQ;  // a warp per 16 queries

template <int D>
constexpr int smem_dq_tc() {
  return (int)sizeof(__nv_bfloat16) * (2 * BQ + 4 * BK) *
         mma_bf16::Tile<D>::PITCH;
}

template <int D>
__device__ __forceinline__ void dq_tc(const Params& p) {
  using namespace mma_bf16;
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = Tile<D>::PITCH;
  constexpr int KD = D / 16;       // k-steps of the score products
  constexpr int ND = D / 8;        // 8-column tiles of dQ
  constexpr int NK = BK / 8;       // 8-column tiles of S
  constexpr int NT = THREADS_DQ;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // BQ x PITCH
  bf16* Os = Qs + BQ * PITCH;                 // BQ x PITCH, do
  bf16* Ks = Os + BQ * PITCH;                 // 2 x BK x PITCH
  bf16* Vs = Ks + 2 * BK * PITCH;             // 2 x BK x PITCH

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int iq = gridDim.x - 1 - blockIdx.x;    // longest tiles first
  const int b = blockIdx.y / p.h, h = blockIdx.y % p.h;
  const int hk = h / (p.h / p.hkv);
  const int q0 = iq * BQ;
  const int qw = q0 + 16 * warp;                // the warp's first row
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* og =
      static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int kv_end = min(p.kv_len, p.skv);
  int k_end = kv_end;
  if (p.causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<BQ, D, NT, true>(Qs, qg, p.q_ss, q0, p.sq);
  load_tile<BQ, D, NT, true>(Os, og, p.o_ss, q0, p.sq);
  if (n_tiles > 0) {
    load_tile<BK, D, NT, true>(Ks, kg, p.k_ss, k_begin, p.skv);
    load_tile<BK, D, NT, true>(Vs, vg, p.v_ss, k_begin, p.skv);
  }
  cp_async_commit();

  const int rows[2] = {qw + g, qw + g + 8};
  const int64_t row = ((int64_t)b * p.h + h) * p.sq;
  float lse[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < p.sq;
    lse[i] = in ? p.lse[row + rows[i]] : 0.f;
    dd[i] = in ? p.dd[row + rows[i]] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    const int buf = j & 1;
    cp_async_wait<0>();  // tile j has landed (this thread's copies)
    __syncthreads();     // ... everyone's; tile j-1's buffer is free
    if (j + 1 < n_tiles) {
      // unrolled: K7 rolls its copy loops to save registers; here rolled
      // ones ran slower and unrolled ones do not spill
      load_tile<BK, D, NT>(Ks + (buf ^ 1) * BK * PITCH, kg, p.k_ss, k0 + BK,
                           p.skv);
      load_tile<BK, D, NT>(Vs + (buf ^ 1) * BK * PITCH, vg, p.v_ss, k0 + BK,
                           p.skv);
    }
    cp_async_commit();
    const bf16* Kb = Ks + buf * BK * PITCH;
    const bf16* Vb = Vs + buf * BK * PITCH;

    // warp-uniform: a tile with no valid pair for this warp's rows
    if (qw >= p.sq || (p.causal && k0 > qw + 15) ||
        (p.window > 0 && k0 + BK - 1 <= qw - p.window))
      continue;
    // mask only where the tile crosses kv_len, Sq, the diagonal or the
    // window edge for some row of the warp
    const bool edge = k0 + BK > kv_end || qw + 15 >= p.sq ||
                      (p.causal && k0 + BK - 1 > qw) ||
                      (p.window > 0 && k0 <= qw + 15 - p.window);

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, a_addr<D>(Qs, 16 * warp, 16 * kk, lane));
      ldsm_x4(oa, a_addr<D>(Os, 16 * warp, 16 * kk, lane));
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, bt_addr<D>(Kb, 8 * n, 16 * kk, lane));
        ldsm_x4(vf, bt_addr<D>(Vb, 8 * n, 16 * kk, lane));
        mma(s[n], qa, kf[0], kf[1]);
        mma(s[n + 1], qa, kf[2], kf[3]);
        mma(dp[n], oa, vf[0], vf[1]);
        mma(dp[n + 1], oa, vf[2], vf[3]);
      }
    }
    // ds in place of s
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int qi = rows[e >> 1];
          ok = qi < p.sq && key < kv_end;
          if (p.causal) ok = ok && key <= qi;
          if (p.window > 0) ok = ok && key > qi - p.window;
        }
        const float pr =
            ok ? exp2f((s[n][e] * p.sm_scale - lse[e >> 1]) * LOG2E) : 0.f;
        s[n][e] = pr * (dp[n][e] - dd[e >> 1]) * p.sm_scale;
      }

    // dQ += dS.K
    accumulate<D, NK>(dq, s, Kb, 0, lane);
  }
  cp_async_wait<0>();  // nothing left in flight (n_tiles may be 0)

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rows[i];
    if (r >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          &dqg[(int64_t)r * p.dq_ss + 8 * n + 2 * t]) =
          __floats2bfloat162_rn(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(
    mma_bf16::kTensorCores<T> ? THREADS_DQ : THREADS,
    mma_bf16::kTensorCores<T> ? 2 : 1)  // two bf16 blocks an SM
flash_bwd_dq_kernel(const Params p) {
  if constexpr (mma_bf16::kTensorCores<T>)
    dq_tc<D>(p);
  else
    dq_fma<T, D>(p);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, bool dkv, cudaStream_t stream) {
  // one flag per instantiation and kernel: the attribute is set once
  static bool configured[2] = {false, false};
  constexpr bool tc = mma_bf16::kTensorCores<T>;
  const int bytes = dkv ? (tc ? smem_dkv_tc<D>() : smem_dkv<D>())
                        : (tc ? smem_dq_tc<D>() : smem_dq<D>());
  const void* fn = dkv ? (const void*)flash_bwd_dkv_kernel<T, D>
                       : (const void*)flash_bwd_dq_kernel<T, D>;
  if (!configured[dkv]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured[dkv] = true;
  }
  const int nk = (p.skv + BK - 1) / BK;
  if (dkv && tc) {
    if (nk > 65535) return cudaErrorInvalidConfiguration;  // gridDim.y
    const dim3 grid(batch * p.hkv, nk);
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS_DKV, bytes, stream>>>(p);
  } else if (dkv) {
    const dim3 grid(nk, batch * p.hkv);
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  } else {
    const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.h);
    flash_bwd_dq_kernel<T, D><<<grid, tc ? THREADS_DQ : THREADS, bytes,
                                stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, bool dkv,
                     cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, dkv, s);
    case 64: return launch<T, 64>(p, batch, dkv, s);
    case 80: return launch<T, 80>(p, batch, dkv, s);
    case 128: return launch<T, 128>(p, batch, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(int dtype, const Params& p, int batch, int d, bool dkv, int device,
        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = dtype == 1 ? dispatch<__nv_bfloat16>(p, batch, d, dkv, s)
      : dtype == 0 ? dispatch<float>(p, batch, d, dkv, s)
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

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
