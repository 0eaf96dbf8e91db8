// Flash-attention forward for Hopper (sm_90a): K5 of the port.
//
// Replaces the Pallas kernel _flash_kernel / flash_attention_blocks in
// src/repro/kernels/flash_attention.py. It computes what that kernel
// computes, not its block structure:
//
//   s   = (q * sm_scale) . k^T                     in float32
//   mask: key < kv_len, key <= query (causal), key > query - window
//   m   = running max of the masked s (NEG_BIG where nothing is valid)
//   p   = exp(s - m) on valid keys, 0 elsewhere    (float32 through P.V)
//   out = acc / max(l, 1e-30)  in q's dtype,  lse = m + log(max(l, 1e-30))
//
// with GQA: query head h reads key/value head h / (H / Hkv).
//
// Shape. One block per (query tile of BQ = 64 rows, batch * head), 256
// threads, a loop over key tiles of BK = 64 rows with online softmax. The
// TPU kernel runs its key axis as the sequential innermost grid dimension
// and carries (m, l, acc) in VMEM scratch; here the loop runs inside the
// block and the carry lives in registers, since blocks run in no order.
// Key tiles wholly above the causal diagonal, wholly before the window, or
// past kv_len are skipped, not masked (the TPU kernel masks them; the
// result is the same). Query tiles are scheduled longest first.
//
// Thread layout. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4*ty .. 4*ty+3 of the tile: the 4x4 block of S at key columns
// 4*tx .. 4*tx+3, and output columns tx + 16*c (c < D/16) of those rows.
// The 16 threads that share a row are 16 consecutive lanes of one warp, so
// the row max and row sum are 4 shuffles. Q^T, K^T and P^T sit in shared
// memory transposed and padded so that every inner-loop read is a float4
// that is either broadcast or conflict-free; V sits row-major.
//
// Bound. At the serving shape (B=4, H=32, Hkv=8, S=2048, D=128, bf16,
// causal) the work is ~1.4e11 operations against ~168 MB of traffic, so the
// card's limit is operations (139 us at the bf16 tensor-core peak, against
// 50 us for the bytes). This first kernel does its arithmetic in float32
// FMAs on the CUDA cores (67 TFLOP/s peak, no tensor cores): it reads each
// K/V tile once per query tile, keeps the softmax state in registers and
// writes only out and lse. Tensor cores (mma.sync / wgmma with a split
// P) and TMA staging are later work.
//
// Templated on the element type (float, __nv_bfloat16) and the head dim
// (32, 64, 80, 128). C interface, loaded with ctypes by
// repro_torch/kernels/flash_cuda.py; the entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
constexpr int smem_bytes() {
  return (int)sizeof(float) * (D * QS + D * KS + BK * D + BK * QS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
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

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.h);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 80: return launch<T, 80>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
