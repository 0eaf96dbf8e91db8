// Holds csrc/topsis_math.cuh against IEEE sqrtf and division, bit for bit,
// on the card: sqrt_in against sqrtf for every float x with
// sqrt_in_range(x), and div_in against '/' for 2^32 (n, d) pairs hashed
// from their index, n in [2^-51, 2^64], d = n + m with m in [2^-52, 2^66]
// and d <= 2^65 — the domain finish_quad sends to div_in.
//
// C interface, loaded with ctypes by repro_torch/kernels/topsis_cuda.py:
// counts[0..3] = sqrt mismatches, quotient mismatches, square roots
// tried, quotients tried (int64, zeroed by the caller).

#include <cuda_runtime.h>
#include <stdint.h>

#include "topsis_math.cuh"

namespace {

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16; x *= 0x7feb352du;
  x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

// 1.m * 2^e with m from the hash's low 23 bits, e from its top 7 bits
// folded into [lo, lo + span).
__device__ __forceinline__ float sample(uint32_t h, int lo, int span) {
  return ldexpf(1.f + float(h & 0x7fffffu) * 0x1p-23f,
                int(h >> 25) % span + lo);
}

__global__ void topsis_math_check_kernel(unsigned long long* counts) {
  unsigned long long bad_sqrt = 0, bad_div = 0, n_sqrt = 0, n_div = 0;
  const uint64_t step = uint64_t(gridDim.x) * blockDim.x;
  for (uint64_t i = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (uint64_t(1) << 32); i += step) {
    const float x = __uint_as_float(uint32_t(i));
    if (sqrt_in_range(x)) {
      ++n_sqrt;
      bad_sqrt += __float_as_uint(sqrt_in(x)) != __float_as_uint(sqrtf(x));
    }
    const float n = sample(hash32(uint32_t(i)), -51, 116);
    const float d = n + sample(hash32(uint32_t(i) ^ 0x9e3779b9u), -52, 118);
    if (d <= 0x1p65f) {
      ++n_div;
      bad_div += __float_as_uint(div_in(n, d)) != __float_as_uint(n / d);
    }
  }
  atomicAdd(counts, bad_sqrt);
  atomicAdd(counts + 1, bad_div);
  atomicAdd(counts + 2, n_sqrt);
  atomicAdd(counts + 3, n_div);
}

}  // namespace

extern "C" {

int topsis_math_check(unsigned long long* counts, int device, void* stream) {
  cudaSetDevice(device);
  topsis_math_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      counts);
  return (int)cudaGetLastError();
}

const char* topsis_math_check_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
