// Fused RMSNorm for Hopper (sm_90a): K8 of the port.
//
// Replaces the Pallas kernel _rmsnorm_kernel / rmsnorm_blocks in
// src/repro/kernels/rmsnorm_pallas.py:
//
//   y = x * rsqrt(sum(x^2) / D + eps) * gamma     over the last axis,
//
// in float32 (gamma is float32), written in x's dtype (float32 or
// bfloat16). The TPU kernel tiles rows along sublanes and needs the
// feature axis padded to 128 lanes; here one block of 256 threads owns one
// row of any width and masks nothing.
//
// Bound. About 4 operations per element against 2 bytes in and 2 out
// (bf16): far below the card's operations-per-byte balance, so the limit
// is device-memory bytes (one read of x, one write of y). The design moves
// each byte once from device memory: the block reads its row with 16-byte
// vector loads (8 bf16 or 4 float32 per load) where the row width allows,
// reduces the sum of squares in float32 (warp shuffles, then one float per
// warp in shared memory), and reads the row a second time to scale it;
// that second read hits the L1/L2 copy of the row just read (8 KB at
// D = 4096 bf16), not device memory.
//
// C interface, loaded with ctypes by repro_torch/kernels/rmsnorm_cuda.py;
// the entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// N elements of T in one 16-byte vector (or one element when N == 1).
template <typename T, int N>
struct alignas(N == 1 ? sizeof(T) : 16) Vec {
  T v[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               T* __restrict__ y, int d, float eps) {
  using V = Vec<T, N>;
  const int64_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  V* yr = reinterpret_cast<V*>(y + row * d);
  const int nv = d / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    const V a = xr[i];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float f = to_f32(a.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float warp_sums[THREADS / 32];
  __shared__ float rstd;
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t += warp_sums[w];
    rstd = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = rstd;

  for (int i = threadIdx.x; i < nv; i += THREADS) {
    const V a = xr[i];
    V o;
#pragma unroll
    for (int e = 0; e < N; ++e)
      from_f32(to_f32(a.v[e]) * r * gamma[i * N + e], &o.v[e]);
    yr[i] = o;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const float* g, void* y, int rows, int d,
                     float eps, bool vec, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, N><<<rows, THREADS, 0, s>>>(xt, g, yt, d, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, THREADS, 0, s>>>(xt, g, yt, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. x and y are contiguous (rows, d); gamma is
// a contiguous (d,) float32 vector.
int rmsnorm_fwd(int dtype, const void* x, const float* gamma, void* y,
                int rows, int d, float eps, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elt = dtype == 1 ? 2 : 4;
  const bool vec = (d * elt) % 16 == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaError_t e = dtype == 1
      ? dispatch<__nv_bfloat16>(x, gamma, y, rows, d, eps, vec, s)
      : dtype == 0 ? dispatch<float>(x, gamma, y, rows, d, eps, vec, s)
                   : cudaErrorInvalidValue;
  return (int)e;
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
