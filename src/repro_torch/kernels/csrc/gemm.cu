// GEMM forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_matmul_kernel`, launched by `matmul` in
// src/repro/kernels/gemm/kernel.py:18: C = A B with A (M, K) and B (K, N),
// row-major and contiguous, both in f32 or both in bf16. Products are
// summed in f32 and C is rounded once to the inputs' dtype, as the JAX
// `matmul_ref` (both operands in f32, one product, one cast) computes it.
//
// The TPU kernel walks a sequential K axis of its grid with an f32
// accumulator in VMEM, over blocks padded to 128. Here a block owns one
// BM x BN output tile and loops over K itself: the loop takes the place
// of the grid's K axis, and the accumulator lives in registers. The
// kernel masks the ragged M, N and K edges itself (out-of-range elements
// enter as 0, out-of-range outputs are not written): no padding copies.
// Tiles are 128 x 128 when those make at least one block per SM, else
// 64 x 64, so that small products still spread over the card. The two
// dtypes take two kernels.
//
// f32 (`gemm_f32_kernel`): f32 FFMA on the CUDA cores, never the tensor
// cores: TF32 would keep about three digits, below the JAX suite's f32
// limit of 2e-5. A block is 256 threads (16 x 16); each holds a
// (BM/16) x (BN/16) micro-tile of f32 sums, its rows 4 apart in groups of
// 64 (and its columns likewise) so that each k step reads its A and B
// values from shared memory as float4 (an A vector is the same for 16
// threads, a B vector sits beside its neighbours'). The BK-deep tiles of
// A (stored k-major) and B are staged in shared memory; each thread
// fetches 4 consecutive elements of each operand per tile, and fetches
// the next tile into registers while the block multiplies the current
// one. A row is fetched with one 16-byte load where the row length is a
// multiple of 4 and the base 16-byte aligned; otherwise element by
// element. Tiles are 128 x 128 x 8 (8 x 8 a thread) or 64 x 64 x 16
// (4 x 4 a thread).
//
// bf16 (`gemm_bf16_kernel`): the tensor cores through mma.sync m16n8k16
// (bf16 in, f32 sums; mma_sm90.cuh). A block is 8 warps in a 2 x 4 grid,
// each owning a (BM/2) x (BN/4) part of the tile (64 x 32 at 128 x 128:
// 4 x 4 mma tiles, 64 f32 sums a lane); two blocks share an SM. K runs
// in 64-deep tiles through a 3-stage ring of A and B tiles in shared
// memory, filled by 16-byte cp.async two tiles ahead of the products, so
// loads overlap the mma; inside a tile the fragments of the next 16-deep
// step are loaded while the current one multiplies. A tile rows are
// padded from 64 to 72 bf16 and B tile rows from BN to BN + 8 (an odd
// number of 16-byte units), so ldmatrix hits no bank conflict. A feeds
// its fragments through ldmatrix; B, row-major (K, N), through
// ldmatrix.trans, with no transpose copy in memory. Rows past M, columns
// past N and k past K enter as zeros through cp.async's zero fill. A row
// whose length (K for A, N for B) is not a multiple of 8 elements, or a
// base that is not 16-byte aligned, cannot take 16-byte copies: that
// operand goes element by element through registers into the same
// shared-memory tiles, a branch of this kernel. C is rounded to bf16
// once, staged in shared memory over the ring and written in 16-byte
// rows. Blocks take their tiles in groups of 8 tile rows, column by
// column inside a group, so the blocks in flight share A rows and B
// columns in L2: at 128 x 128 tiles the A and B tiles a product streams
// from L2 (2 M N K (1/BM + 1/BN) bytes, 3.4 GB at zamba2-2.7b's in_proj)
// bound it next to the mma (PERF.md).
//
// What bounds it on an H100 SXM (data sheet): the larger of 2 M K N
// operations at the peak rate of their type and the bytes (A and B read
// once, C written once) at 3.35 TB/s. In f32 the peak is 67 TFLOP/s on
// the CUDA cores; in bf16 989 TFLOP/s on the tensor cores, reached only
// through wgmma, which this kernel does not use yet (mma.sync issues
// from each warp on its own). Every size the calibration pass and the
// model projections use is bound by operations.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;   // f32: 16 x 16; bf16: 8 warps

// Four consecutive elements of a row starting at `p`; those at or past
// `valid` enter as 0 (and are not read). One vector load where `vec`
// allows it and all four are in range.
__device__ __forceinline__ void load4(const float* p, int valid, bool vec,
                                      float (&f)[4]) {
  if (vec && valid >= 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = i < valid ? p[i] : 0.f;
  }
}

// Four consecutive outputs of a row starting at `p`; only the first
// `valid` are written.
__device__ __forceinline__ void store4(float* p, int valid, bool vec,
                                       const float* f) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) p[i] = f[i];
  }
}

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  bool vec_a, vec_b, vec_c;   // rows allow vector loads / stores
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(const Params p) {
  constexpr int TM = BM / 16, TN = BN / 16;   // outputs a thread
  static_assert(BM * BK == 4 * kThreads && BK * BN == 4 * kThreads,
                "a thread fetches 4 elements of A and of B a tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 reads");
  __shared__ __align__(16) float As[BK][BM];   // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const float* __restrict__ A = static_cast<const float*>(p.a);
  const float* __restrict__ B = static_cast<const float*>(p.b);
  float* __restrict__ C = static_cast<float*>(p.c);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's fetch: 4 consecutive k of one row of A, 4 consecutive
  // n of one row of B.
  const int a_row = tid / (BK / 4), a_k = (tid % (BK / 4)) * 4;
  const int b_k = tid / (BN / 4), b_col = (tid % (BN / 4)) * 4;
  const int a_m = m0 + a_row, b_n = n0 + b_col;
  const float* a_ptr = A + static_cast<long long>(a_m) * K + a_k;
  const float* b_ptr = B + static_cast<long long>(b_k) * N + b_n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  load4(a_ptr, a_m < M ? K - a_k : 0, p.vec_a, ra);
  load4(b_ptr, b_k < K ? N - b_n : 0, p.vec_b, rb);

  const int n_tiles = (K + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&Bs[b_k][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();

    if (t + 1 < n_tiles) {   // the next tile's loads fly during the sums
      const int k0 = (t + 1) * BK;
      load4(a_ptr + k0, a_m < M ? K - k0 - a_k : 0, p.vec_a, ra);
      load4(b_ptr + static_cast<long long>(k0) * N,
            k0 + b_k < K ? N - b_n : 0, p.vec_b, rb);
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[k][h * 64 + ty * 4]);
        a[4 * h] = v.x;
        a[4 * h + 1] = v.y;
        a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[k][h * 64 + tx * 4]);
        b[4 * h] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
    float* crow = C + static_cast<long long>(m) * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      store4(crow + n, N - n, p.vec_c, &acc[i][4 * h]);
    }
  }
}

// ---- bf16 on the tensor cores ----------------------------------------

constexpr int kWarpsM = 2, kWarpsN = 4;  // a block's 8 warps
constexpr int kBK16 = 64;                // k depth of a tile
constexpr int kStages = 3;               // tiles in the cp.async ring
constexpr int kLdA = kBK16 + 8;          // A tile row stride, bf16
constexpr int kGroupM = 8;               // tile rows in a raster group

template <int BM, int BN>
struct Bf16Tiles {
  static constexpr int kLdB = BN + 8;   // an odd number of 16-byte units
  static constexpr int kA = BM * kLdA;  // bf16 per A stage
  static constexpr int kB = kBK16 * kLdB;
  // The ring; the epilogue's C tile (BM x kLdB) reuses it.
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * kStages * (kA + kB);
  static_assert(BM * kLdB <= kStages * (kA + kB), "C tile fits the ring");
};

// Stages one R x W tile of a row-major bf16 matrix (rows of `ld`
// elements, `rows` x `cols` in range) into shared memory (row stride
// `lds`) from row r0, col c0. With `vec` each 16-byte chunk is one
// cp.async, zero-filled past the edges, a thread's chunks kThreads
// apart, stepped without division; otherwise element by element through
// registers (rows not 16-byte aligned, or a row length that splits a
// chunk).
template <int R, int W>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int lds,
                                           const __nv_bfloat16* src, int ld,
                                           int rows, int cols, int r0,
                                           int c0, bool vec, int tid) {
  constexpr int kChunks = W / 8;
  if (vec) {
    static_assert(R * kChunks % kThreads == 0 &&
                  R * kChunks / kThreads <= 4, "whole rounds, unrolled");
    constexpr int kDr = kThreads / kChunks, kDc = kThreads % kChunks;
    int r = tid / kChunks, c = tid % kChunks;
#pragma unroll
    for (int it = 0; it < R * kChunks / kThreads; ++it) {
      const int gr = r0 + r, gc = c0 + 8 * c;
      const bool ok = gr < rows && gc < cols;   // cols % 8 == 0 here
      mma::cp_async_16(
          mma::smem_addr(dst + r * lds + 8 * c),
          ok ? src + static_cast<long long>(gr) * ld + gc : src, ok);
      r += kDr;
      c += kDc;
      if (c >= kChunks) {
        c -= kChunks;
        ++r;
      }
    }
    return;
  }
  for (int i = tid; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int gr = r0 + r, gc = c0 + c;
    const __nv_bfloat16* s = src + static_cast<long long>(gr) * ld + gc;
    alignas(16) __nv_bfloat16 e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = gr < rows && gc + j < cols ? s[j] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst + r * lds + c) =
        *reinterpret_cast<const uint4*>(e);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(const Params p) {
  using Tiles = Bf16Tiles<BM, BN>;
  constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;  // a warp's part
  constexpr int MT = WM / 16, NT = WN / 8;    // its mma tiles
  static_assert(MT >= 1 && NT % 2 == 0, "x4 ldmatrix.trans feeds 2 n-tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kStages * Tiles::kA;

  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  __nv_bfloat16* C = static_cast<__nv_bfloat16*>(p.c);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / kWarpsN) * WM, wn = (warp % kWarpsN) * WN;
  // Output tiles in groups of kGroupM tile rows, column-major inside a
  // group: the blocks in flight share their A rows and B columns in L2.
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kGroupM;
  const int rows_in_group = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x - group * per_group;
  const int m0 = (first_m + in_group % rows_in_group) * BM;
  const int n0 = (in_group / rows_in_group) * BN;
  const int n_tiles = (K + kBK16 - 1) / kBK16;

  auto load_stage = [&](int t) {
    const int s = t % kStages, k0 = t * kBK16;
    stage_tile<BM, kBK16>(As + s * Tiles::kA, kLdA, A, K, M, K, m0, k0,
                          p.vec_a, tid);
    stage_tile<kBK16, BN>(Bs + s * Tiles::kB, Tiles::kLdB, B, N, K, N, k0,
                          n0, p.vec_b, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_stage(t);
    mma::cp_async_commit();   // one group a tile, empty or not
  }

  // ldmatrix row addresses of this lane (see mma_sm90.cuh): A row
  // lane % 16 at k offset 8 (lane / 16); B k row lane % 16 at n offset
  // 8 (lane / 16).
  const int lrow = lane % 16, lcol = 8 * (lane / 16);

  for (int t = 0; t < n_tiles; ++t) {
    mma::cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();                     // ... for every thread; and tile
                                         // t - 1's stage is free
    if (t + kStages - 1 < n_tiles) load_stage(t + kStages - 1);
    mma::cp_async_commit();

    const __nv_bfloat16* as = As + (t % kStages) * Tiles::kA;
    const __nv_bfloat16* bs = Bs + (t % kStages) * Tiles::kB;
    // The fragments of k step ks + 1 are loaded while step ks multiplies.
    uint32_t af[2][MT][4], bf[2][NT][2];
    auto load_frags = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma::ldmatrix_x4(af[buf][i], mma::smem_addr(
            as + (wm + 16 * i + lrow) * kLdA + kk + lcol));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, mma::smem_addr(
            bs + (kk + lrow) * Tiles::kLdB + wn + 8 * j + lcol));
        bf[buf][j][0] = r[0];
        bf[buf][j][1] = r[1];
        bf[buf][j + 1][0] = r[2];
        bf[buf][j + 1][1] = r[3];
      }
    };
    load_frags(0, 0);
#pragma unroll
    for (int ks = 0; ks < kBK16 / 16; ++ks) {
      if (ks + 1 < kBK16 / 16) load_frags((ks + 1) % 2, 16 * (ks + 1));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma::mma_bf16_16816(acc[i][j], af[ks % 2][i], bf[ks % 2][j][0],
                              bf[ks % 2][j][1]);
    }
  }
  mma::cp_async_wait<0>();   // no copy outlives the block

  // Epilogue: the tile rounded to bf16 into shared memory (over the
  // ring), then written out in 16-byte rows where N and C allow.
  __syncthreads();
  __nv_bfloat16* Cs = As;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm + 16 * i + mma::frag_row(lane, 2 * h);
        const int c = wn + 8 * j + mma::frag_col(lane, 0);
        *reinterpret_cast<uint32_t*>(Cs + r * Tiles::kLdB + c) =
            mma::pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  constexpr int kChunks = BN / 8;
  for (int i = tid; i < BM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const __nv_bfloat16* src = Cs + r * Tiles::kLdB + c;
    __nv_bfloat16* dst = C + static_cast<long long>(m) * N + n;
    if (p.vec_c && n + 8 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
    }
  }
}

template <int BM, int BN, int BK>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_f32_kernel<BM, BN, BK><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  constexpr size_t smem = Bf16Tiles<BM, BN>::kSmem;
  auto* fn = gemm_bf16_kernel<BM, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % bytes == 0;
}

// Whether BM x BN tiles give every SM a block (else the small tiles).
cudaError_t big_tiles(const Params& p, int bm, int bn, bool* big) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *big = static_cast<long long>((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn)
         >= sms;
  return e;
}

cudaError_t dispatch_f32(Params p, cudaStream_t stream) {
  p.vec_a = p.K % 4 == 0 && aligned(p.a, 16);
  p.vec_b = p.N % 4 == 0 && aligned(p.b, 16);
  p.vec_c = p.N % 4 == 0 && aligned(p.c, 16);
  bool big = false;
  const cudaError_t e = big_tiles(p, 128, 128, &big);
  if (e != cudaSuccess) return e;
  return big ? launch_f32<128, 128, 8>(p, stream)
             : launch_f32<64, 64, 16>(p, stream);
}

cudaError_t dispatch_bf16(Params p, cudaStream_t stream) {
  p.vec_a = p.K % 8 == 0 && aligned(p.a, 16);   // 16-byte rows
  p.vec_b = p.N % 8 == 0 && aligned(p.b, 16);
  p.vec_c = p.N % 8 == 0 && aligned(p.c, 16);   // 16-byte rows
  bool big = false;
  const cudaError_t e = big_tiles(p, 128, 128, &big);
  if (e != cudaSuccess) return e;
  return big ? launch_bf16<128, 128>(p, stream)
             : launch_bf16<64, 64>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and C). A (M, K), B (K, N) and
// C (M, N) are row-major and contiguous.
extern "C" int gemm_fwd(const void* a, const void* b, void* c, int dtype,
                        int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const Params p{a, b, c, M, N, K, false, false, false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = dispatch_f32(p, s);
  else if (dtype == 1) e = dispatch_bf16(p, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
