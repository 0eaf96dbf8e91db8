// TOPSIS closeness kernels for Hopper (sm_90a).
//
// Ports of the four Pallas kernels in src/repro/kernels/topsis_pallas.py:
//
//   topsis_single_kernel   <- _topsis_kernel / topsis_closeness_blocks
//   topsis_batched_kernel  <- _topsis_batched_kernel / topsis_closeness_batched_blocks
//   topsis_kinds_kernel    <- _topsis_kinds_kernel / topsis_closeness_kinds_blocks
//   topsis_grid_kernel     <- _topsis_grid_kernel / topsis_closeness_grid_blocks
//
// Every kernel computes, per (pod, node) and over C_PAD = 8 criteria,
//   v   = x * inv_norm * w
//   d+- = ||v - a+-||_2
//   cc  = d- / max(d+ + d-, 1e-12), or 0.5 when d+ + d- <= 1e-12.
// Column norms, weight normalisation and the masked ideal points a+- are
// global reductions that the wrapper (repro_torch/kernels/ops.py) computes
// in plain torch; it also writes -inf over infeasible nodes afterwards.
// Padded criteria carry zeros in inv_norm, w and a+-, so they add nothing.
//
// Layout. The TPU kernels keep criteria on sublanes and nodes on lanes,
// (8, N). Hopper has no lanes: here the criteria are row-major (..., N, 8)
// float32, so one thread owns one (pod, node), reads its 32-byte row as two
// float4 loads (neighbouring threads read neighbouring rows: coalesced),
// keeps the row in registers, and writes one float.
//
// Bound. Each kernel does ~50 flops per 36 bytes moved (a 32-byte row in,
// a 4-byte closeness out), far below the card's flop:byte balance, so all
// four are bound by device-memory bytes. The design moves each byte once:
//   * the grid is (ceil(N / 256), P); a block's pod is blockIdx.y, so its
//     small operands are loaded once per block into shared memory;
//   * the kinds kernel reads kind_idx[blockIdx.y] and offsets the criteria
//     pointer, so it streams the (K, N, 8) per-kind tensor instead of a
//     (P, N, 8) per-pod copy (the TPU kernel's scalar prefetch);
//   * the grid kernel loops over the S weight schemes inside the thread:
//     the criteria row is read once and reused for every scheme (the TPU
//     kernel's "scheme axis innermost"); only the (S, P, N) output grows
//     with S.
//
// C interface, loaded with ctypes by repro_torch/kernels/topsis_cuda.py.
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on a good launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C_PAD = 8;
constexpr int BLOCK = 256;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         int64_t row, float (&r)[C_PAD]) {
  const float4* p = reinterpret_cast<const float4*>(x + row * C_PAD);
  const float4 lo = __ldg(p);
  const float4 hi = __ldg(p + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// u = x * inv_norm (the normalised row); weight, distances, closeness.
// The one closeness routine every kernel shares.
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
  const float d_pos = sqrtf(sp);
  const float d_neg = sqrtf(sn);
  const float denom = d_pos + d_neg;
  return denom <= EPS ? 0.5f : d_neg / fmaxf(denom, EPS);
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

// K1: one (N, 8) matrix, small operands (8,) -> (N,).
__global__ void __launch_bounds__(BLOCK)
topsis_single_kernel(const float* __restrict__ x,
                     const float* __restrict__ inv_norm,
                     const float* __restrict__ w,
                     const float* __restrict__ a_pos,
                     const float* __restrict__ a_neg,
                     float* __restrict__ out, int n) {
  __shared__ float s[4 * C_PAD];
  load_small(s, 0, inv_norm, w, a_pos, a_neg);
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i < n) out[i] = score_row(x, i, s);
}

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
// writes NaN over the pod's row instead of reading out of bounds.
__global__ void __launch_bounds__(BLOCK)
topsis_kinds_kernel(const int32_t* __restrict__ kind_idx, int k,
                    const float* __restrict__ x,
                    const float* __restrict__ inv_norm,
                    const float* __restrict__ w,
                    const float* __restrict__ a_pos,
                    const float* __restrict__ a_neg,
                    float* __restrict__ out, int n) {
  __shared__ float s[4 * C_PAD];
  const int64_t pod = blockIdx.y;
  load_small(s, pod, inv_norm, w, a_pos, a_neg);
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int kind = __ldg(kind_idx + pod);
  if (kind < 0 || kind >= k) {
    out[pod * n + i] = __int_as_float(0x7fc00000);
    return;
  }
  out[pod * n + i] = score_row(x, int64_t(kind) * n + i, s);
}

// K4: a (P, N, 8) queue tensor under S weight schemes. inv_norm is per pod
// (P, 8); w, a_pos and a_neg are per (scheme, pod), (S, P, 8). Output
// (S, P, N). The row is read and normalised once, then scored S times.
__global__ void __launch_bounds__(BLOCK)
topsis_grid_kernel(const float* __restrict__ x,
                   const float* __restrict__ inv_norm,
                   const float* __restrict__ w,
                   const float* __restrict__ a_pos,
                   const float* __restrict__ a_neg,
                   float* __restrict__ out, int n, int p, int s_count) {
  __shared__ float inv[C_PAD];
  const int64_t pod = blockIdx.y;
  if (threadIdx.x < C_PAD) inv[threadIdx.x] = inv_norm[pod * C_PAD + threadIdx.x];
  __syncthreads();
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  float u[C_PAD];
  load_row(x, pod * n + i, u);
#pragma unroll
  for (int c = 0; c < C_PAD; ++c) u[c] *= inv[c];
  for (int s = 0; s < s_count; ++s) {
    const int64_t sp = (int64_t(s) * p + pod) * C_PAD;
    out[(int64_t(s) * p + pod) * n + i] =
        closeness(u, w + sp, a_pos + sp, a_neg + sp);
  }
}

inline dim3 grid_for(int n, int p) {
  return dim3((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)p);
}

}  // namespace

extern "C" {

int topsis_single(const float* x, const float* inv_norm, const float* w,
                  const float* a_pos, const float* a_neg, float* out, int n,
                  int device, void* stream) {
  cudaSetDevice(device);
  topsis_single_kernel<<<grid_for(n, 1), BLOCK, 0, (cudaStream_t)stream>>>(
      x, inv_norm, w, a_pos, a_neg, out, n);
  return (int)cudaGetLastError();
}

int topsis_batched(const float* x, const float* inv_norm, const float* w,
                   const float* a_pos, const float* a_neg, float* out, int n,
                   int p, int device, void* stream) {
  cudaSetDevice(device);
  topsis_batched_kernel<<<grid_for(n, p), BLOCK, 0, (cudaStream_t)stream>>>(
      x, inv_norm, w, a_pos, a_neg, out, n);
  return (int)cudaGetLastError();
}

int topsis_kinds(const int32_t* kind_idx, int k, const float* x,
                 const float* inv_norm, const float* w, const float* a_pos,
                 const float* a_neg, float* out, int n, int p, int device,
                 void* stream) {
  cudaSetDevice(device);
  topsis_kinds_kernel<<<grid_for(n, p), BLOCK, 0, (cudaStream_t)stream>>>(
      kind_idx, k, x, inv_norm, w, a_pos, a_neg, out, n);
  return (int)cudaGetLastError();
}

int topsis_grid(const float* x, const float* inv_norm, const float* w,
                const float* a_pos, const float* a_neg, float* out, int n,
                int p, int s, int device, void* stream) {
  cudaSetDevice(device);
  topsis_grid_kernel<<<grid_for(n, p), BLOCK, 0, (cudaStream_t)stream>>>(
      x, inv_norm, w, a_pos, a_neg, out, n, p, s);
  return (int)cudaGetLastError();
}

const char* topsis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
