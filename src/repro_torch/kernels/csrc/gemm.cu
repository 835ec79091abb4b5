// GEMM forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_matmul_kernel`, launched by `matmul` in
// src/repro/kernels/gemm/kernel.py:18: C = A B with A (M, K) and B (K, N),
// row-major and contiguous, both in f32 or both in bf16. Products are
// summed in f32 and C is rounded once to the inputs' dtype, as the JAX
// `matmul_ref` (both operands in f32, one product, one cast) computes it.
//
// Design. The TPU kernel walks a sequential K axis of its grid with an
// f32 accumulator in VMEM, over blocks padded to 128. Here a block owns
// one BM x BN output tile and loops over K itself: the loop takes the
// place of the grid's K axis, and the accumulator lives in registers. A
// block is 256 threads (16 x 16); each holds a (BM/16) x (BN/16) micro-
// tile of f32 sums, its rows 4 apart in groups of 64 (and its columns
// likewise) so that each k step reads its A and B values from shared
// memory as float4 (an A vector is the same for 16 threads, a B vector
// sits beside its neighbours'). The BK-deep tiles of A (stored k-major)
// and B are staged in shared memory as f32; each thread fetches 4
// consecutive elements of each operand per tile, and fetches the next
// tile into registers while the block multiplies the current one. A row
// is fetched with one vector load (16 bytes in f32, 8 in bf16) where the
// row length is a multiple of 4 and the base 16-byte (8-byte) aligned;
// otherwise element by element. The kernel masks the ragged M, N and K
// edges itself (out-of-range elements enter as 0, out-of-range outputs
// are not written): no padding copies. Tiles are 128 x 128 x 8 (8 x 8 a
// thread) when those make at least one block per SM, else 64 x 64 x 16
// (4 x 4 a thread), so that small products still spread over the card.
//
// Arithmetic. f32 and bf16 alike run as f32 FFMA on the CUDA cores, never
// on the tensor cores: TF32 would keep about three digits, below the JAX
// suite's f32 limit of 2e-5. `mma.sync` and then `wgmma` with TMA for
// bf16 are later work.
//
// What bounds it on an H100 SXM (data sheet): the larger of 2 M K N
// operations at the peak rate of their type and the bytes (A and B read
// once, C written once) at 3.35 TB/s. In f32 the peak is 67 TFLOP/s on
// the CUDA cores; in bf16 989 TFLOP/s on the tensor cores, which this
// kernel does not use, so it sits far above the bf16 bound. Every size
// the calibration pass and the model projections use is bound by
// operations.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 16 x 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements of a row starting at `p`; those at or past
// `valid` enter as 0 (and are not read). One vector load where `vec`
// allows it and all four are in range.
template <typename T>
__device__ __forceinline__ void load4(const T* p, int valid, bool vec,
                                      float (&f)[4]) {
  if (vec && valid >= 4) {
    if constexpr (std::is_same_v<T, float>) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      f[0] = v.x;
      f[1] = v.y;
      f[2] = v.z;
      f[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      f[0] = lo.x;
      f[1] = lo.y;
      f[2] = hi.x;
      f[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = i < valid ? to_f(p[i]) : 0.f;
  }
}

// Four consecutive outputs of a row starting at `p`, each rounded once;
// only the first `valid` are written.
template <typename T>
__device__ __forceinline__ void store4(T* p, int valid, bool vec,
                                       const float* f) {
  if (vec && valid >= 4) {
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      uint2 v;
      v.x = *reinterpret_cast<const unsigned*>(&lo);
      v.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(p) = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < valid) {
        if constexpr (std::is_same_v<T, float>) p[i] = f[i];
        else p[i] = __float2bfloat16(f[i]);
      }
    }
  }
}

struct Params {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  bool vec_a, vec_b, vec_c;   // rows allow vector loads / stores
};

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Params p) {
  constexpr int TM = BM / 16, TN = BN / 16;   // outputs a thread
  static_assert(BM * BK == 4 * kThreads && BK * BN == 4 * kThreads,
                "a thread fetches 4 elements of A and of B a tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 reads");
  __shared__ __align__(16) float As[BK][BM];   // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const T* __restrict__ A = static_cast<const T*>(p.a);
  const T* __restrict__ B = static_cast<const T*>(p.b);
  T* __restrict__ C = static_cast<T*>(p.c);
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's fetch: 4 consecutive k of one row of A, 4 consecutive
  // n of one row of B.
  const int a_row = tid / (BK / 4), a_k = (tid % (BK / 4)) * 4;
  const int b_k = tid / (BN / 4), b_col = (tid % (BN / 4)) * 4;
  const int a_m = m0 + a_row, b_n = n0 + b_col;
  const T* a_ptr = A + static_cast<long long>(a_m) * K + a_k;
  const T* b_ptr = B + static_cast<long long>(b_k) * N + b_n;

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
    T* crow = C + static_cast<long long>(m) * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      store4(crow + n, N - n, p.vec_c, &acc[i][4 * h]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  gemm_kernel<T, BM, BN, BK><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
cudaError_t dispatch(Params p, cudaStream_t stream) {
  constexpr int vec_bytes = 4 * sizeof(T);
  p.vec_a = p.K % 4 == 0 && aligned(p.a, vec_bytes);
  p.vec_b = p.N % 4 == 0 && aligned(p.b, vec_bytes);
  p.vec_c = p.N % 4 == 0 && aligned(p.c, vec_bytes);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long big_tiles =
      static_cast<long long>((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (big_tiles >= sms) return launch<T, 128, 128, 8>(p, stream);
  return launch<T, 64, 64, 16>(p, stream);
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
  if (dtype == 0) e = dispatch<float>(p, s);
  else if (dtype == 1) e = dispatch<__nv_bfloat16>(p, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
