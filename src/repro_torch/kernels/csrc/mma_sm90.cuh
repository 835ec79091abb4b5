// Thin wrappers over the PTX that the bf16 tensor-core paths of the GEMM
// (gemm.cu), flash attention (flash_attention.cu), the SSD scan
// (ssm_scan.cu) and WKV-6 (wkv6.cu) share: ldmatrix, mma.sync m16n8k16
// (bf16 in, f32 sums), cp.async with zero fill, the map from an m16n8
// accumulator fragment to its (row, col), and f32 pairs packed into bf16,
// whole or split into a high and a low part.
//
// Notation for a warp's lanes: g = lane / 4 (the "group", 0..7) and
// c = lane % 4 (the lane within its quad). A 32-bit register holds two
// bf16 values; the lower 16 bits hold the one of lower column (or k)
// index.
//
// Shared-memory tiles that these wrappers read are row-major with a row
// stride of an odd number of 16-byte units (a width that is a multiple of
// 16 bf16, plus 8): the 8 row addresses of one 8 x 8 ldmatrix then fall
// into 8 different 16-byte slots of the 128-byte bank window, so ldmatrix
// hits no bank conflict.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of b16 from shared memory. Lane l gives the address
// of row l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte aligned).
// Lane (g, c) receives in r[j] the elements (row g, cols 2c and 2c + 1)
// of matrix j.
//
// As an A fragment of m16n8k16 (row-major A, 16 rows x 16 k): give lane l
// the address of row l % 16, k offset 8 * (l / 16); then r[0..3] are
// a[0..3] (rows 0-7 k 0-7, rows 8-15 k 0-7, rows 0-7 k 8-15, rows 8-15
// k 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8 x 8 matrices, from the row addresses of lanes 0-15 (lane l: row
// l % 8 of matrix l / 8; the other lanes' addresses are not read); r[j]
// as for ldmatrix_x4. As the B fragment of one m16n8k16 n-tile from a B
// stored n-major: give lane l the address of n row l % 8, k offset
// 8 ((l / 8) % 2).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The same four matrices, each transposed on the way: lane (g, c)
// receives in r[j] the elements (rows 2c and 2c + 1, col g) of matrix j
// as stored.
//
// As the B fragments of two m16n8k16 n-tiles from a B stored k-major
// (row k, col n, as a row-major (K, N) matrix or V stored (key, dim)):
// give lane l the address of k row l % 16, n offset 8 * (l / 16); then
// r[0], r[1] are b[0], b[1] of the n-tile at cols 0-7 and r[2], r[3]
// those of the n-tile at cols 8-15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A B for one m16n8k16 tile, bf16 operands, f32 sums.
//   a[0] = A(g, 2c..2c+1)      a[1] = A(g + 8, 2c..2c+1)
//   a[2] = A(g, 2c+8..2c+9)    a[3] = A(g + 8, 2c+8..2c+9)
//   b[0] = B(2c..2c+1, g)      b[1] = B(2c+8..2c+9, g)   ("col": B's
//   two values of one register are consecutive in k, for one n)
//   d[0], d[1] = D(g, 2c), D(g, 2c + 1)
//   d[2], d[3] = D(g + 8, 2c), D(g + 8, 2c + 1)
// So B stored n-major (row n, col k, as K in attention, (key, dim)) gives
// its fragments by ldmatrix_x4 without transpose: lane l gives the
// address of n row (l % 8) + 8 * (l / 16), k offset 8 * ((l / 8) % 2);
// then r[0], r[1] are b[0], b[1] of the n-tile at rows 0-7 and r[2], r[3]
// those of the n-tile at rows 8-15.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row and column, inside its 16 x 8 tile, of element i (0..3) of an
// m16n8 accumulator fragment (the d of mma_bf16_16816) held by `lane`.
__device__ __forceinline__ int frag_row(int lane, int i) {
  return (lane >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int i) {
  return 2 * (lane & 3) + (i & 1);
}

// Two f32 values rounded to bf16 in one register, `lo` in the lower half:
// two consecutive columns of an accumulator fragment become one register
// of an A fragment (or two adjacent outputs).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of a register as f32 (`lo` half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// Two f32 values split into bf16 pairs hi + lo: hi = bf16(v), lo =
// bf16(v - hi). A product of a split operand by a bf16 operand, as two
// mma, keeps ~16 bits of the f32 operand where one mma keeps 8.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1.
// Both addresses 16-byte aligned. With `valid` false nothing is read and
// the 16 bytes are filled with zeros (src-size 0): ragged rows and the
// padding of a tile need no separate store. `src` must still be a valid
// address; callers pass the tensor's base then.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// Closes the group of cp.async issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N committed groups are still in flight (groups
// complete in order). Each thread waits for its own copies: a
// __syncthreads() after it makes the whole tile visible.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
