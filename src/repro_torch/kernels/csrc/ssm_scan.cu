// Mamba-2 SSD scan forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`, launched by `ssm_scan` in
// src/repro/kernels/ssm_scan/kernel.py, with the contract of the JAX
// `ssm_scan_chunked` (src/repro/kernels/ssm_scan/chunked.py) that the
// Mamba-2 layer calls in prefill: an initial state h0 in (null means
// zeros), y and the final state out. Per batch row b and head h, with
// g = h / (H / G) the head's state group and h_t the (P, N) state:
//
//   h_t[p][n] = exp(dt_t * a_h) * h_{t-1}[p][n] + dt_t * x_t[p] * B_t[n]
//   y_t[p]    = sum_n C_t[n] * h_t[p][n] + D_h * x_t[p]
//
// Layout: x (B, S, H, P), B and C (B, S, G, N), all in f32 or bf16 and read
// through their strides with the last dim contiguous (the pieces of a
// split convolution output need no copy, and B and C are read by group,
// never repeated per head); dt (B, S, H) f32 through its strides; a, D
// (H,) f32; h0 and hT (B, H, P, N) f32, contiguous; y (B, S, H, P) in the
// input dtype. The D * x skip is added in f32 and y is rounded once.
//
// Design. The TPU kernel walks a sequential grid axis over chunks of 128
// steps, with the intra-chunk work as MXU matmuls and the state in VMEM.
// Here the recurrence runs one step at a time and the state never leaves
// registers. A block is 128 threads on (b, h, 128 / L rows of P); each row
// p of the state is split over L neighbouring threads that hold 32
// columns each (N = 64: L = 2, 64 rows a block, one block a head). The
// decay is one scalar per (b, h, step), so a step costs a thread 3 f32
// operations per state value (scale, add the input, multiply by C) and a
// shuffle to sum y over its row. B_t and C_t are read from shared memory
// as float4: the L threads of a row read neighbouring vectors, and all
// rows of a warp read the same ones (broadcast). A thread's columns are
// 4 l + 4 L q + i (q < 8, i < 4), so the vectors of one read sit in
// distinct banks. Of the tilings tried at the zamba2 shape (16 to 64
// columns and 1 or 2 rows a thread, 32 to 128 threads a block, the step
// loop unrolled or not) none was clearly faster than this one, and 16
// columns a thread, with a second shuffle, was slower.
//
// Timesteps are staged a tile at a time (32 in bf16, 16 in f32, whose
// prefetch takes twice the registers) in shared memory as f32, together
// with dt_t and the decay exp(dt_t * a_h). The next tile is loaded from
// device memory into registers with 16-byte vector loads (every row of x,
// B and C must start 16-byte aligned) while the block computes the
// current one. The build uses no fast-math or flush-to-zero: a decay
// exp(dt a) below 1.2e-38 is a subnormal and must not become 0 early.
//
// What bounds it on an H100: at the zamba2-2.7b prefill shape (B=4,
// S=1024, H=80, P=64, G=1, N=64, bf16 x/B/C/y, f32 dt/h0/hT) the bytes are
// 2 x 41.9 MB (x, y) + 1.3 MB (dt) + 1.0 MB (B, C) + 2 x 5.2 MB (h0, hT)
// = 97 MB, 0.029 ms at 3.35 TB/s; the chunked form's matrix products
// (chunk 256) would take 0.027 ms at the bf16 tensor-core peak. This form
// does 3 x 4096 f32 operations per (b, h, step), 4.0e9 in all, at least
// 0.12 ms on the CUDA cores, so the operations bound it, several times
// above the byte bound. The chunked form on the tensor cores (mma / wgmma
// on (Lc x N)(N x Lc) and (Lc x Lc)(Lc x P) products) would reach the byte
// bound; it is later work.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;

// Per state dim N: the columns a thread holds, the threads that share a
// row of the state, and the rows a block covers.
template <int N>
struct Shape {
  static constexpr int kColsT = N < 32 ? N : 32;
  static constexpr int kLanes = N / kColsT;
  static constexpr int kRows = kThreads / kLanes;
  static constexpr int kQuads = kColsT / 4;           // float4 a thread
  static_assert(kColsT % 4 == 0 && 32 % kLanes == 0, "tiling");
};

// Timesteps per staged tile.
template <typename T>
constexpr int kTile = sizeof(T) == 2 ? 32 : 16;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* h0;                    // null: zero initial state
  void* y;
  float* hT;
  int S, H, P, G;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  if constexpr (std::is_same_v<T, float>) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 g = __bfloat1622float2(h[i]);
      f[2 * i] = g.x;
      f[2 * i + 1] = g.y;
    }
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// One tile's inputs in flight: 16-byte vectors of x (this block's rows),
// B and C, and one dt, loaded for the next tile while the block computes
// the current one.
template <typename T, int N>
struct Prefetch {
  static constexpr int kVec = 16 / sizeof(T);           // elements a load
  static constexpr int kRowVecs = Shape<N>::kRows / kVec;
  static constexpr int kStateVecs = N / kVec;
  static constexpr int kX = (kTile<T> * kRowVecs + kThreads - 1) / kThreads;
  static constexpr int kBC = (kTile<T> * kStateVecs + kThreads - 1) /
                             kThreads;
  static_assert(N % kVec == 0 && Shape<N>::kRows % kVec == 0, "vectors");
  uint4 x[kX], b[kBC], c[kBC];
  float dt;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(Params p) {
  using SH = Shape<N>;
  using PF = Prefetch<T, N>;
  constexpr int kLanes = SH::kLanes, kRows = SH::kRows;
  constexpr int kQuads = SH::kQuads, kT = kTile<T>, kVec = PF::kVec;
  __shared__ __align__(16) float sx[kT][kRows];
  __shared__ __align__(16) float sb[kT][N];
  __shared__ __align__(16) float sc[kT][N];
  __shared__ float sdt[kT], sdec[kT];
  __shared__ float sy[kT][kRows];

  const int blocks_per_head = (p.P + kRows - 1) / kRows;
  const int bh = blockIdx.x / blocks_per_head;
  const int p0 = (blockIdx.x % blocks_per_head) * kRows;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int row = tid / kLanes, l = tid % kLanes;
  const int prow = p0 + row;
  const bool live = prow < p.P;       // rows past P compute on zeros
  const int rows = min(kRows, p.P - p0);
  const float ah = p.a[h], dh = p.D[h];

  // Column of element i of float4 q of this thread.
  auto col = [&](int q) { return 4 * (kLanes * q + l); };
  const long long hbase = ((long long)bh * p.P + prow) * N;
  float st[kQuads][4];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.h0 && live)
      v = *reinterpret_cast<const float4*>(p.h0 + hbase + col(q));
    st[q][0] = v.x;
    st[q][1] = v.y;
    st[q][2] = v.z;
    st[q][3] = v.w;
  }

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* bm = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* cm = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + p0;

  // Vector e of a tile's x covers step e / kRowVecs, rows from
  // (e % kRowVecs) * kVec; of B or C, step e / kStateVecs. Steps at or
  // past S, and rows at or past P, are not loaded.
  PF pf;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PF::kX; ++j) {
      const int e = tid + kThreads * j;
      const long long ts = t0 + e / PF::kRowVecs;
      const int r = (e % PF::kRowVecs) * kVec;
      if (e < kT * PF::kRowVecs && ts < p.S && r < rows)
        pf.x[j] = load16(x + ts * p.x_ss + r);
    }
#pragma unroll
    for (int j = 0; j < PF::kBC; ++j) {
      const int e = tid + kThreads * j;
      const long long ts = t0 + e / PF::kStateVecs;
      const int c = (e % PF::kStateVecs) * kVec;
      if (e < kT * PF::kStateVecs && ts < p.S) {
        pf.b[j] = load16(bm + ts * p.b_ss + c);
        pf.c[j] = load16(cm + ts * p.c_ss + c);
      }
    }
    if (tid < kT && t0 + tid < p.S) pf.dt = __ldg(dt + (t0 + tid) * p.dt_ss);
  };
  auto stage = [&](int n) {
#pragma unroll
    for (int j = 0; j < PF::kX; ++j) {
      const int e = tid + kThreads * j;
      const int t = e / PF::kRowVecs, r = (e % PF::kRowVecs) * kVec;
      if (e < kT * PF::kRowVecs && t < n) {
        if (r < rows) {
          unpack<T>(pf.x[j], &sx[t][r]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) sx[t][r + i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PF::kBC; ++j) {
      const int e = tid + kThreads * j;
      const int t = e / PF::kStateVecs, c = (e % PF::kStateVecs) * kVec;
      if (e < kT * PF::kStateVecs && t < n) {
        unpack<T>(pf.b[j], &sb[t][c]);
        unpack<T>(pf.c[j], &sc[t][c]);
      }
    }
    if (tid < n) {
      sdt[tid] = pf.dt;
      sdec[tid] = expf(pf.dt * ah);
    }
  };

  load(0);
  for (int t0 = 0; t0 < p.S; t0 += kT) {
    const int n = min(kT, p.S - t0);
    __syncthreads();                  // the previous tile is written out
    stage(n);
    __syncthreads();
    if (t0 + kT < p.S) load(t0 + kT);   // in flight during this tile

#pragma unroll 1
    for (int t = 0; t < n; ++t) {
      const float xv = sx[t][row];
      const float dtx = sdt[t] * xv, dec = sdec[t];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(&sb[t][col(q)]);
        const float4 cv = *reinterpret_cast<const float4*>(&sc[t][col(q)]);
        st[q][0] = fmaf(st[q][0], dec, dtx * bv.x);
        st[q][1] = fmaf(st[q][1], dec, dtx * bv.y);
        st[q][2] = fmaf(st[q][2], dec, dtx * bv.z);
        st[q][3] = fmaf(st[q][3], dec, dtx * bv.w);
        acc0 = fmaf(cv.x, st[q][0], acc0);
        acc1 = fmaf(cv.y, st[q][1], acc1);
        acc0 = fmaf(cv.z, st[q][2], acc0);
        acc1 = fmaf(cv.w, st[q][3], acc1);
      }
      float acc = acc0 + acc1;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (l == 0) sy[t][row] = fmaf(dh, xv, acc);
    }
    __syncthreads();

    for (int e = tid; e < n * rows; e += kThreads) {
      const int t = e / rows, r = e % rows;
      store(y + (t0 + t) * p.y_ss + r, sy[t][r]);
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      *reinterpret_cast<float4*>(p.hT + hbase + col(q)) =
          make_float4(st[q][0], st[q][1], st[q][2], st[q][3]);
  }
}

template <typename T, int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto* fn = ssm_scan_kernel<T, N>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int rows = Shape<N>::kRows;
  const dim3 grid(B * p.H * ((p.P + rows - 1) / rows));
  fn<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, 8>(p, B, stream);      // the JAX suite's
    case 16: return launch<T, 16>(p, B, stream);    // the calibration's
    case 64: return launch<T, 64>(p, B, stream);    // zamba2-2.7b
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). Strides are in
// elements. h0 may be null (zero initial state).
extern "C" int ssm_scan_fwd(
    const void* x, const float* dt, const float* a, const void* Bm,
    const void* Cm, const float* D, const float* h0, void* y, float* hT,
    int dtype, int B, int S, int H, int P, int G, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      P % vec != 0)
    return cudaErrorInvalidValue;
  const Params p{x, dt, a, Bm, Cm, D, h0, y, hT, S, H, P, G,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = dispatch<float>(p, B, N, s);
  else if (dtype == 1) e = dispatch<__nv_bfloat16>(p, B, N, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
