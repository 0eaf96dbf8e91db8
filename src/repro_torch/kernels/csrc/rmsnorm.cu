// Fused RMSNorm for Hopper (sm_90a): K8 of the port.
//
// Replaces the Pallas kernel _rmsnorm_kernel / rmsnorm_blocks in
// src/repro/kernels/rmsnorm_pallas.py:
//
//   y = x * rsqrt(sum(x^2) / D + eps) * gamma     over the last axis,
//
// in float32 (gamma is float32), written in x's dtype (float32 or
// bfloat16). The TPU kernel tiles rows along sublanes and needs the
// feature axis padded to 128 lanes; here any width is taken and nothing
// is masked or padded.
//
// Bound. About 4 operations per element against 2 bytes in and 2 out
// (bf16): far below the card's operations-per-byte balance, so the limit
// is device-memory bytes (one read of x, one write of y). The design moves
// each byte once and waits on nothing but its own row:
//
// * rmsnorm_rows_kernel, for rows of 16-byte vectors (8 bf16 or 4
//   float32), up to 16 vectors a thread and 8 warps a row (32768 bf16 or
//   16384 float32): a group of WPR warps owns a row at a time,
//   each thread holding up to VPT vectors of it in registers between the
//   sum of squares and the scale, so x is read from device memory once.
//   The sum is reduced by warp shuffles; a group of several warps adds
//   its warps' sums through one shared array behind a barrier of the
//   group's warps only (bar.sync with an id and a count), never the block.
//   gamma is copied once per block into shared memory by 16-byte loads,
//   laid out so that the warp's reads of it are 16-byte and conflict-free
//   (gs[c * nv + i] is float4 c of vector i's gamma). The grid is sized to
//   the blocks the SMs hold at once and loops over the rows.
// * rmsnorm_kernel, for the other widths (not a multiple of 16 bytes, or
//   wider than the register path holds): one block of 256 threads per
//   row, two passes over the row (the second from L1/L2), the block's sum
//   through shared memory.
//
// C interface, loaded with ctypes by repro_torch/kernels/rmsnorm_cuda.py;
// the entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// Barrier of the `count` threads of named barrier `id` (1..15; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Register path: d a multiple of N = 16 / sizeof(T), nv = d / N vectors
// with nv <= 32 * WPR * VPT. Thread r of a row's group holds vectors
// r + 32 * WPR * i, i < VPT.
template <typename T, int VPT, int WPR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x,
                    const float* __restrict__ gamma, T* __restrict__ y,
                    int rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);
  constexpr int G4 = N / 4;            // float4s of gamma per vector
  constexpr int TPR = 32 * WPR;        // threads per row
  constexpr int GROUPS = WARPS / WPR;  // rows in flight per block
  using V = Vec<T, N>;
  extern __shared__ float4 gs[];       // G4 x nv
  __shared__ float part[2][WARPS];     // WPR > 1: the warps' sums

  const int nv = d / N;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  for (int f = threadIdx.x; f < nv * G4; f += THREADS) {
    const int i = f / G4, c = f - i * G4;
    gs[c * nv + i] = g4[f];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / WPR;
  const int r = (warp - grp * WPR) * 32 + lane;
  [[maybe_unused]] int parity = 0;
  for (int64_t row = (int64_t)blockIdx.x * GROUPS + grp; row < rows;
       row += (int64_t)gridDim.x * GROUPS) {
    const V* xr = reinterpret_cast<const V*>(x + row * d);
    V* yr = reinterpret_cast<V*>(y + row * d);
    V a[VPT];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = r + TPR * i;
      if (vi < nv) {
        a[i] = xr[vi];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = to_f32(a[i].v[e]);
          ss = fmaf(f, f, ss);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (WPR > 1) {
      // part[parity] was last read two rows ago, before the group's
      // barrier of the previous row: no second barrier is needed
      if (lane == 0) part[parity][warp] = ss;
      group_sync(1 + grp, TPR);
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += part[parity][grp * WPR + w];
      parity ^= 1;
    }
    const float rs = rsqrtf(ss / (float)d + eps);

#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = r + TPR * i;
      if (vi < nv) {
        float gv[N];
#pragma unroll
        for (int c = 0; c < G4; ++c) {
          const float4 q = gs[c * nv + vi];
          gv[4 * c] = q.x;
          gv[4 * c + 1] = q.y;
          gv[4 * c + 2] = q.z;
          gv[4 * c + 3] = q.w;
        }
        V o;
#pragma unroll
        for (int e = 0; e < N; ++e)
          from_f32(to_f32(a[i].v[e]) * rs * gv[e], &o.v[e]);
        yr[vi] = o;
      }
    }
  }
}

// Any width: one block per row, two passes.
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
  __shared__ float warp_sums[WARPS];
  __shared__ float rstd;
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += warp_sums[w];
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

template <typename T, int VPT, int WPR>
cudaError_t launch_rows(const T* x, const float* g, T* y, int rows, int d,
                        float eps, int device, cudaStream_t s) {
  const auto fn = rmsnorm_rows_kernel<T, VPT, WPR>;
  const int bytes = d * (int)sizeof(float);  // gamma
  static bool configured = false;
  if (!configured) {
    // gamma at the widest row this instantiation takes
    constexpr int widest = 32 * WPR * VPT * (int)(16 / sizeof(T));
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        widest * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                    bytes);
  if (e != cudaSuccess) return e;
  constexpr int GROUPS = WARPS / WPR;
  const int64_t need = ((int64_t)rows + GROUPS - 1) / GROUPS;
  const int64_t fit = (int64_t)sms * per_sm;
  const int blocks = (int)(need < fit ? need : fit);
  rmsnorm_rows_kernel<T, VPT, WPR><<<blocks, THREADS, bytes, s>>>(
      x, g, y, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* g, void* y, int rows, int d,
                     float eps, int device, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (d % N) {
    rmsnorm_kernel<T, 1><<<rows, THREADS, 0, s>>>(xt, g, yt, d, eps);
    return cudaGetLastError();
  }
  // the register path: the fewest vectors a thread, then the fewest warps
  // a row, that hold the row
  const int per_lane = (d / N + 31) / 32;  // vectors a thread at WPR = 1
  auto rows_path = [&](auto vpt, auto wpr) {
    return launch_rows<T, decltype(vpt)::value, decltype(wpr)::value>(
        xt, g, yt, rows, d, eps, device, s);
  };
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  if (per_lane <= 1) return rows_path(I1{}, I1{});
  if (per_lane <= 2) return rows_path(I2{}, I1{});
  if (per_lane <= 4) return rows_path(I4{}, I1{});
  if (per_lane <= 8) return rows_path(I8{}, I1{});
  if (per_lane <= 16) return rows_path(I16{}, I1{});
  if (per_lane <= 32) return rows_path(I16{}, I2{});
  if (per_lane <= 64) return rows_path(I16{}, I4{});
  if (per_lane <= 128) return rows_path(I16{}, I8{});
  rmsnorm_kernel<T, N><<<rows, THREADS, 0, s>>>(xt, g, yt, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. x and y are contiguous (rows, d); gamma is
// a contiguous (d,) float32 vector. Where d * sizeof(x) is a multiple of
// 16 bytes, x, y and gamma must be 16-byte aligned (the wrapper checks).
int rmsnorm_fwd(int dtype, const void* x, const float* gamma, void* y,
                int rows, int d, float eps, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elt = dtype == 1 ? 2 : 4;
  if ((d * elt) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(gamma)) % 16)
    return (int)cudaErrorMisalignedAddress;
  e = dtype == 1
      ? dispatch<__nv_bfloat16>(x, gamma, y, rows, d, eps, device, s)
      : dtype == 0 ? dispatch<float>(x, gamma, y, rows, d, eps, device, s)
                   : cudaErrorInvalidValue;
  return (int)e;
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
