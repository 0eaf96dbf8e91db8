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
// D = 256 (gemma-7b; the work a pair is twice D = 128's, and at gemma's
// training shape, H = 16, the bound is llama's). The D <= 128 tiles do not
// fit: K6's dQ and K7's dK + dV accumulators would be 128 and 256 floats a
// lane beside the score tiles, and the float32 kernels' four transposed
// D x 68 tiles alone are 278 KB, over the 227 KB a block may hold. So:
// - bf16 K6: 8 warps and 128 query rows a block, key tiles of 32 (s and
//   dp 16 floats a lane beside dQ's 128), the score k-loop unrolled by 2
//   (unrolled whole it spilled); 198 KB, one block an SM.
// - bf16 K7: 8 warps, two to each 16-key strip, in two roles: one computes
//   s^T, p^T and dV (all 256 columns), and hands p^T to the other through
//   shared memory (double-buffered, behind a barrier of the two warps),
//   which computes dp^T, ds^T and dK. Each holds one 128-float accumulator
//   and runs one product chain a part; the tensor work is D = 128's design
//   (12*D a pair), split evenly. The score k-loop is unrolled by 4. One
//   block still owns each key tile: no atomics. 207 KB, one block an SM.
// - float32 K6 and K7: the K and V tiles (K6) or the q and do tiles (K7)
//   are staged DC columns at a time (DC = 128 and 64), once for the score
//   products and again, last chunk first, for the output products; the
//   other pair stays whole. 221 and 204 KB.
// At D <= 128 every kernel keeps its shape above.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128, 256). C interface, loaded with ctypes by
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
//
// At D > 128 (DkvTc::SPLIT) the block has 8 warps, two to each 16-key
// strip w % 4: warp w < 4 computes s^T, p^T and dV, and hands p^T to warp
// w + 4 through shared memory, which computes dp^T, ds^T and dK (the
// file's header).
constexpr int SUB = 16;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DkvTc {
  static constexpr bool SPLIT = D > 128;
  static constexpr int WARPS = SPLIT ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = SPLIT ? 1 : 2;
  // floats of the p^T hand-over: (strip, buffer) x a lane's SUB / 8
  // accumulator tiles x 32 lanes
  static constexpr int XCH = SPLIT ? 4 * 2 * (SUB / 2) * 32 : 0;
};

// acc (the warp's 16 rows x D) += X.Y for X = x, 16 x NS*8 float32 in the
// accumulator layout of a score
// product (K7's p^T or ds^T, K6's ds), split hi/lo, and Y = rows
// c0..c0+NS*8-1 of the pitched tile Y (K7's q or do, K6's k; read by
// ldmatrix.trans). Each 8-column tile's products go into a fresh
// accumulator that one FADD adds to acc: the tensor cores' float32
// additions are not rounded to nearest, and a chain of every query tile's
// products into acc drifts (by 1% of bf16 outputs differing from the plain
// version at the training shape).
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

// x (16 rows of A x NS*8 columns, accumulator layout) = A.B^T over all of
// D: A the warp's 16 rows from row a0 of a pitched tile, B rows c0.. of
// another (one per output column); both read by ldmatrix.
template <int D, int NS>
__device__ __forceinline__ void score_tc(float (&x)[NS][4],
                                         const __nv_bfloat16* A, int a0,
                                         const __nv_bfloat16* B, int c0,
                                         int lane) {
  using namespace mma_bf16;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  // at D > 128 unrolled by 4 only: unrolled whole, K7 spilled 4 bytes
#pragma unroll (D > 128 ? 4 : D / 16)
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a_addr<D>(A, a0, 16 * kk, lane));
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, bt_addr<D>(B, c0 + 8 * n, 16 * kk, lane));
      mma(x[n], af, bf[0], bf[1]);
      mma(x[n + 1], af, bf[2], bf[3]);
    }
  }
}

template <int D>
constexpr int smem_dkv_tc() {
  return (int)sizeof(__nv_bfloat16) * (2 * BK + 4 * BQ) *
             mma_bf16::Tile<D>::PITCH +
         (int)sizeof(float) * (4 * BQ + DkvTc<D>::XCH);
}

template <int D>
__device__ __forceinline__ void dkv_tc(const Params& p) {
  using namespace mma_bf16;
  using bf16 = __nv_bfloat16;
  using C = DkvTc<D>;
  constexpr int PITCH = Tile<D>::PITCH;
  constexpr int ND = D / 8;     // 8-column tiles of dK, dV
  constexpr int NS = SUB / 8;   // 8-column tiles of a score part
  constexpr int NA = C::SPLIT ? 1 : 2;  // dK and dV, or (SPLIT) one
  constexpr int NT = C::THREADS;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // BK x PITCH (resident)
  bf16* Vs = Ks + BK * PITCH;                 // BK x PITCH (resident)
  bf16* Qs = Vs + BK * PITCH;                 // 2 x BQ x PITCH
  bf16* Os = Qs + 2 * BQ * PITCH;             // 2 x BQ x PITCH, do
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * PITCH);  // 2 x BQ lse
  float* Ds = Ls + 2 * BQ;                                    // 2 x BQ dd
  float* Xs = Ds + 2 * BQ;                    // C::XCH, p^T handed over

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp & 3;                 // the warp's 16 keys
  const int role = C::SPLIT ? warp >> 2 : 0;  // SPLIT: 0 dV, 1 dK
  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.y * BK;
  const int kw = k0 + 16 * strip;               // the warp's first key
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
    if (tid < 2 * BQ) {
      const int64_t row = ((int64_t)b * p.h + h) * p.sq;
      const int r = tid & (BQ - 1);
      const bool in = q0 + r < p.sq;
      const float* src = (tid < BQ ? p.lse : p.dd) + row + (in ? q0 + r : 0);
      cp_async4((tid < BQ ? Ls : Ds) + buf * BQ + r, src, in);
    }
  };

  load_tile<BK, D, NT, true>(Ks, kg, p.k_ss, k0, p.skv);
  load_tile<BK, D, NT, true>(Vs, vg, p.v_ss, k0, p.skv);
  if (n_iter > 0) stage(0, 0);
  cp_async_commit();

  float acc[NA][ND][4];   // dK, dV; SPLIT: the role's one
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
  const int keys[2] = {kw + g, kw + g + 8};
  int xb = 0;   // the hand-over buffer of the next part (SPLIT)

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
      // warp-uniform (and the same for both warps of a strip): no valid
      // pair between the warp's keys and the part
      if (kw >= kv_end || qs >= p.sq || (p.causal && qs + SUB - 1 < kw) ||
          (p.window > 0 && qs - p.window >= kw + 15))
        continue;
      const bool edge = kw + 15 >= kv_end || qs + SUB > p.sq ||
                        (p.causal && qs < kw + 15) ||
                        (p.window > 0 && qs + SUB - 1 - p.window >= kw);
      // s^T -> p^T in place: exp(s^T * scale - lse), 0 off the mask
      auto probs = [&](float (&x)[NS][4]) {
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
            x[n][e] = ok ? exp2f((x[n][e] * p.sm_scale - Lb[col]) * LOG2E)
                         : 0.f;
          }
      };
      // dp^T -> ds^T in place: p^T * (dp^T - dd) * scale
      auto dscores = [&](float (&x)[NS][4], const float (&pt)[NS][4]) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * n + 2 * t + (e & 1);
            x[n][e] = pt[n][e] * (x[n][e] - Db[col]) * p.sm_scale;
          }
      };

      if constexpr (C::SPLIT) {
        // role 0: s^T, p^T (handed over), dV += P^T.dO;
        // role 1: dp^T, ds^T with the p^T handed over, dK += dS^T.Q
        float* xp = Xs + (strip * 2 + xb) * NS * 4 * 32;
        float x[NS][4];
        score_tc<D, NS>(x, role ? Vs : Ks, 16 * strip, role ? Ob : Qb, c0,
                        lane);
        if (role == 0) {
          probs(x);
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) xp[(4 * n + e) * 32 + lane] = x[n][e];
        }
        // p^T is written; a buffer is written again two parts on, after
        // the next barrier, which role 1 reaches only once it has read
        // this part's
        bar_sync(1 + strip, 64);
        xb ^= 1;
        if (role == 1) {
          float pt[NS][4];
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pt[n][e] = xp[(4 * n + e) * 32 + lane];
          dscores(x, pt);
        }
        accumulate<D, NS>(acc[0], x, role ? Qb : Ob, c0, lane);
      } else {
        float st[NS][4], dpt[NS][4];
        score_tc<D, NS>(st, Ks, 16 * strip, Qb, c0, lane);
        probs(st);
        // dV += P^T.dO
        accumulate<D, NS>(acc[NA - 1], st, Ob, c0, lane);
        // dp^T = V.dO^T, ds^T in place; dK += dS^T.Q
        score_tc<D, NS>(dpt, Vs, 16 * strip, Ob, c0, lane);
        dscores(dpt, st);
        accumulate<D, NS>(acc[0], dpt, Qb, c0, lane);
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight (n_iter may be 0)

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
  bf16* dst[NA];
  int64_t ss[NA];
  if constexpr (C::SPLIT) {
    dst[0] = role ? dkg : dvg;
    ss[0] = role ? p.dk_ss : p.dv_ss;
  } else {
    dst[0] = dkg, dst[NA - 1] = dvg;
    ss[0] = p.dk_ss, ss[NA - 1] = p.dv_ss;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = keys[i];
    if (r >= p.skv) continue;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            &dst[a][(int64_t)r * ss[a] + 8 * n + 2 * t]) =
            __floats2bfloat162_rn(acc[a][n][2 * i], acc[a][n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(
    mma_bf16::kTensorCores<T> ? DkvTc<D>::THREADS : THREADS,
    mma_bf16::kTensorCores<T> ? DkvTc<D>::MIN_BLOCKS : 1)
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
// D = 128: two blocks an SM. At D > 128 (DqTc): 8 warps and 128 rows a
// block, key tiles of 32.
template <int D>
struct DqTc {
  static constexpr bool WIDE = D > 128;
  static constexpr int WARPS = WIDE ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;   // a warp per 16 queries
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BK = WIDE ? 32 : 64;
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;
};

template <int D>
constexpr int smem_dq_tc() {
  return (int)sizeof(__nv_bfloat16) * (2 * DqTc<D>::BQ + 4 * DqTc<D>::BK) *
         mma_bf16::Tile<D>::PITCH;
}

template <int D>
__device__ __forceinline__ void dq_tc(const Params& p) {
  using namespace mma_bf16;
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = Tile<D>::PITCH;
  constexpr int BQ = DqTc<D>::BQ;
  constexpr int BK = DqTc<D>::BK;
  constexpr int KD = D / 16;       // k-steps of the score products
  constexpr int ND = D / 8;        // 8-column tiles of dQ
  constexpr int NK = BK / 8;       // 8-column tiles of S
  constexpr int NT = DqTc<D>::THREADS;
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
    // at D > 128 unrolled by 2 only: unrolled whole, its fragment loads
    // are hoisted and spill
#pragma unroll (DqTc<D>::WIDE ? 2 : KD)
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
    mma_bf16::kTensorCores<T> ? DqTc<D>::THREADS : THREADS,
    mma_bf16::kTensorCores<T> ? DqTc<D>::MIN_BLOCKS : 1)
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
    flash_bwd_dkv_kernel<T, D><<<grid, DkvTc<D>::THREADS, bytes, stream>>>(
        p);
  } else if (dkv) {
    const dim3 grid(nk, batch * p.hkv);
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  } else {
    const int bq = tc ? DqTc<D>::BQ : BQ;
    const dim3 grid((p.sq + bq - 1) / bq, batch * p.h);
    flash_bwd_dq_kernel<T, D><<<grid, tc ? DqTc<D>::THREADS : THREADS,
                                bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

// Dynamic shared memory of a K6 or (dkv) K7 launch at head dim d (0: not
// built).
template <typename T, int D>
int smem_bytes(bool dkv) {
  constexpr bool tc = mma_bf16::kTensorCores<T>;
  return dkv ? (tc ? smem_dkv_tc<D>() : smem_dkv<D>())
             : (tc ? smem_dq_tc<D>() : smem_dq<D>());
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
cudaError_t dispatch(const Params& p, int batch, int d, bool dkv,
                     cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, dkv, s);
    case 64: return launch<T, 64>(p, batch, dkv, s);
    case 80: return launch<T, 80>(p, batch, dkv, s);
    case 128: return launch<T, 128>(p, batch, dkv, s);
    case 256: return launch<T, 256>(p, batch, dkv, s);
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
