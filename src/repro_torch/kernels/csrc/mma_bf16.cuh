// Tensor-core building blocks shared by the bf16 flash-attention kernels
// (K5 in flash_attention.cu, K6 and K7 in flash_attention_bwd.cu): bf16
// tiles staged in shared memory by cp.async, fragments read by ldmatrix, the
// warp-level mma.sync.m16n8k16 (bf16 in, float32 accumulate), and the
// split of a float32 operand into two bf16 halves.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16:
//     a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//     a[2] = A[g][2t+8..+9],   a[3] = A[g+8][2t+8..+9];
//   B (16 x 8, k x n), 2 registers: b[0] = B[2t..2t+1][g],
//     b[1] = B[2t+8..+9][g];
//   C (16 x 8 float32), 4 floats: c[0..1] = C[g][2t..2t+1],
//     c[2..3] = C[g+8][2t..2t+1].
// So the accumulators of two neighbouring 16x8 tiles (columns 16c..16c+15)
// are, element for element, the A fragment of the next product's k-chunk
// c: a probability tile never leaves the registers.
//
// Tiles. A tile of R rows of D bf16 sits row-major with a pitch of D + 8
// elements (D*2 + 16 bytes). Every row starts on 16 bytes (cp.async and
// ldmatrix need that), and the 8 row addresses one ldmatrix phase reads
// (8 consecutive rows, one 16-byte column chunk) fall in 8 distinct
// 16-byte bank groups for D = 32, 64, 80, 128 and 256 (pitches of 5, 9,
// 11, 17 and 33 chunks, all odd), so the reads are free of bank conflicts.
// Every loop over a row's D / 8 chunks takes any D that is a multiple of
// 16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace mma_bf16 {

// The element types whose kernels run on the tensor cores (the others keep
// the float32 FMA kernels).
template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

template <int D>
struct Tile {
  static constexpr int PITCH = D + 8;  // elements
  static_assert(D % 16 == 0, "head dim must be a multiple of the MMA depth");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; with !valid nothing is read and the 16
// bytes are zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy (one float), zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0+R-1 of an (n, D) bf16 slab with row stride ss (elements)
// into a pitched tile, by every thread of the block (NT threads); rows at
// or past n are zero-filled. src and ss*2 must be multiples of 16 bytes.
// ROLLED keeps the copy loop a loop: unrolled, the compiler hoists each
// copy's address out of the caller's main loop, which costs registers
// that a kernel with large accumulators does not have.
template <int R, int D, int NT, bool ROLLED = false>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ss, int r0, int n) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  auto copy = [&](int i) {
    const int r = i / CH, c = i - r * CH;
    const bool in = r0 + r < n;
    const __nv_bfloat16* s = src + (in ? (int64_t)(r0 + r) * ss : 0) + c * 8;
    cp_async16(dst + r * Tile<D>::PITCH + c * 8, s, in);
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = threadIdx.x; i < R * CH; i += NT) copy(i);
  } else {
#pragma unroll
    for (int i = threadIdx.x; i < R * CH; i += NT) copy(i);
  }
}

// Barrier of the `count` threads of named barrier `id` (1..15; 0 is
// __syncthreads): the two warps that share a strip at D = 256 (K5, K7).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Four 8x8 b16 matrices; lane l supplies the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Address, for lane `lane`, of the ldmatrix.x4 that reads the A fragment
// of rows row0..row0+15, columns col0..col0+15 of a pitched tile. The
// same address read with .trans gives the B fragments (b[0], b[1] of
// columns col0..col0+7, then of col0+8..col0+15) of the product whose k
// axis runs down rows row0..row0+15.
template <int D>
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* tile,
                                           int row0, int col0, int lane) {
  return smem_u32(tile + (row0 + (lane & 15)) * Tile<D>::PITCH + col0 +
                  (lane >> 4) * 8);
}

// Address of the ldmatrix.x4 (no .trans) that reads the B fragments of
// the product X . T^T, where T is a pitched tile with one row per output
// column: rows (output columns) n0..n0+15, k columns k0..k0+15; registers
// 0, 1 are b[0], b[1] of columns n0..n0+7, registers 2, 3 of n0+8..n0+15.
template <int D>
__device__ __forceinline__ uint32_t bt_addr(const __nv_bfloat16* tile,
                                            int n0, int k0, int lane) {
  return smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) *
                             Tile<D>::PITCH +
                  k0 + ((lane >> 3) & 1) * 8);
}

// d += a . b on the tensor cores: m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each packed as bf16x2 with
// x0 in the low half. hi + lo keeps about 16 bits of x, where bf16(x)
// keeps 8; x - hi is exact in float32.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The hi and lo A fragments of k-chunk c from the accumulators x of a
// 16-row strip (x[2c] holds columns 16c..16c+7, x[2c+1] 16c+8..16c+15).
__device__ __forceinline__ void split_a(const float (&x0)[4],
                                        const float (&x1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(x0[0], x0[1], hi[0], lo[0]);
  split(x0[2], x0[3], hi[1], lo[1]);
  split(x1[0], x1[1], hi[2], lo[2]);
  split(x1[2], x1[3], hi[3], lo[3]);
}

}  // namespace mma_bf16
