// RWKV-6 (Finch) WKV forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_wkv_kernel`, launched by `wkv6` in
// src/repro/kernels/rwkv6/kernel.py, with the contract of the JAX
// `wkv6_chunked` (src/repro/kernels/rwkv6/chunked.py) that the RWKV-6
// layer calls in prefill: an initial state s0 in (null means zeros), y and the
// final state out. Per batch row b and head h, with S_t the (K, K)
// key-major state:
//
//   y_t[v]    = sum_k r_t[k] * (S_{t-1}[k][v] + u[k] * k_t[k] * v_t[v])
//   S_t[k][v] = w_t[k] * S_{t-1}[k][v] + k_t[k] * v_t[v]
//
// Layout: r, k, v, w (B, S, H, K) in f32 or bf16, read through their
// strides with the last dim contiguous (views of a (B, S, H*K) projection
// need no head-major copy); u (H, K) f32; s0 and sT (B, H, K, K) f32,
// contiguous; y (B, S, H, K) in the input dtype. K is 16, 32 or 64.
//
// Design. The TPU kernel walks a sequential grid axis over chunks and
// carries the state in VMEM. Here the recurrence runs one step at a time,
// and the state never leaves registers. A block is one warp and owns
// (b, h, 32 value columns): two blocks share a head at K = 64. Each lane
// holds a tile of the state, 8 keys x 8 columns at K = 64, and per step
// does 3 f32 operations per value it holds, reading 3 x 8 key values and
// 8 column values from shared memory for them. The 8 key groups of a
// column group read different keys in different banks (the rows are
// padded by a word after every 32 keys), and a lane's columns are
// interleaved (column group + 4 j), so the lanes' partial sums of y land
// in 32 different banks. The bonus term is sum_k r u k times v_t[v]; each
// lane adds its keys' share to its partials, which are summed when the
// tile is written out.
//
// Timesteps are staged a tile at a time (16 in bf16, 8 in f32, whose
// prefetch takes twice the registers) in shared memory as f32. The next
// tile is loaded from device memory into registers (16-byte vector loads,
// so every row of r, k, v, w must start 16-byte aligned) while the block
// computes the current one. The decay is multiplied in directly (no
// exp(log w)), and the build uses no fast-math or flush-to-zero: the
// plain version clamps w at 1e-38, a subnormal.
//
// What bounds it on an H100: at the rwkv6-3b prefill shape (B=4, S=1024,
// H=40, K=64, bf16 r/k/v/w/y, f32 s0/sT) the bytes are 5 x 21.0 MB +
// 2 x 2.6 MB = 110 MB, 0.033 ms at 3.35 TB/s. This form does 3 x 4096
// f32 operations per (b, h, step), 2.0e9 in all, at least 0.06 ms on the
// CUDA cores. Each step waits on the one before, the warps are few, and
// their latencies show: it runs several times slower than that. The
// chunked form on the tensor cores (mma / wgmma on (Lc x K)(K x K)
// products) turns most of the recurrence into independent products and
// would reach the byte bound; it is later work.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Per head dim K: the tile of the state a lane holds (keys x columns),
// and what follows for the warp that is a block.
template <int K>
struct Shape {
  static constexpr int kKeys = K == 16 ? 4 : 8;
  static constexpr int kColsT = K == 16 ? 2 : K == 32 ? 4 : 8;
  static constexpr int kGroups = K / kKeys;           // key groups
  static constexpr int kColGroups = 32 / kGroups;
  static constexpr int kCols = kColGroups * kColsT;   // columns a block
  // Row stride of the partial sums: kColGroups modulo 32, so lane
  // (g, cg) writes bank g * kColGroups + cg.
  static constexpr int kColsP =
      kColGroups + 32 * ((kCols - kColGroups + 31) / 32);
  static constexpr int kRow = K + K / 32;             // padded key row
  static_assert(kGroups * kColGroups == 32, "one warp");
  static_assert(32 % kKeys == 0 && K % kCols == 0, "tiling");
};

// Timesteps per staged tile.
template <typename T>
constexpr int kTile = sizeof(T) == 2 ? 16 : 8;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  const float* s0;                    // null: zero initial state
  void* y;
  float* sT;
  int S, H;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One tile's inputs in flight: each lane holds 16-byte vectors of r, k,
// w (kRK each) and of v (kV), loaded for the next tile while the block
// computes the current one.
template <typename T, int K>
struct Prefetch {
  static constexpr int kVec = 16 / sizeof(T);           // elements a load
  static constexpr int kNRK = kTile<T> * K / kVec;      // vectors a tile
  static constexpr int kNV = kTile<T> * Shape<K>::kCols / kVec;
  static constexpr int kRK = (kNRK + 31) / 32;
  static constexpr int kV = (kNV + 31) / 32;
  static_assert(Shape<K>::kCols % kVec == 0, "v rows in whole vectors");
  uint4 r[kRK], k[kRK], w[kRK], v[kV];
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& x, float* f) {
  if constexpr (std::is_same_v<T, float>) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
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

template <typename T, int K>
__global__ void __launch_bounds__(32) wkv6_kernel(Params p) {
  using SH = Shape<K>;
  using PF = Prefetch<T, K>;
  constexpr int kKeys = SH::kKeys, kColsT = SH::kColsT;
  constexpr int kGroups = SH::kGroups, kColGroups = SH::kColGroups;
  constexpr int kCols = SH::kCols, kColsP = SH::kColsP, kRow = SH::kRow;
  constexpr int kT = kTile<T>, kVec = PF::kVec;
  __shared__ float sr[kT][kRow];
  __shared__ float sk[kT][kRow];
  __shared__ float sw[kT][kRow];
  __shared__ float sv[kT][kCols];
  __shared__ float sy[kT][kGroups][kColsP];   // partial sums per key group

  constexpr int kBlocks = K / kCols;          // blocks per head
  const int bh = blockIdx.x / kBlocks;
  const int v0 = (blockIdx.x % kBlocks) * kCols;
  const int b = bh / p.H, h = bh % p.H;
  const int lane = threadIdx.x;
  const int g = lane % kGroups, cg = lane / kGroups;
  const int key0 = g * kKeys;
  const int slot0 = key0 + key0 / 32;         // a key group never straddles
  // Lane columns cg + kColGroups * j, j < kColsT, of the block's kCols.
  const long long sbase = (long long)bh * K * K + (long long)key0 * K + v0 +
                          cg;

  float s[kKeys][kColsT], uu[kKeys];
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    uu[i] = p.u[h * K + key0 + i];
#pragma unroll
    for (int j = 0; j < kColsT; ++j)
      s[i][j] = p.s0 ? p.s0[sbase + (long long)i * K + kColGroups * j]
                     : 0.f;
  }

  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + v0;
  const T* w = static_cast<const T*>(p.w) + b * p.w_sb + h * p.w_sh;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + v0;

  // Vector e of a tile covers row e / (cols / kVec), columns from
  // (e % (cols / kVec)) * kVec. Rows at or past S are not loaded.
  PF pf;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PF::kRK; ++j) {
      const int e = lane + 32 * j;
      const long long ts = t0 + e / (K / kVec);
      const int c = (e % (K / kVec)) * kVec;
      if (e < PF::kNRK && ts < p.S) {
        pf.r[j] = load16(r + ts * p.r_ss + c);
        pf.k[j] = load16(k + ts * p.k_ss + c);
        pf.w[j] = load16(w + ts * p.w_ss + c);
      }
    }
#pragma unroll
    for (int j = 0; j < PF::kV; ++j) {
      const int e = lane + 32 * j;
      const long long ts = t0 + e / (kCols / kVec);
      const int c = (e % (kCols / kVec)) * kVec;
      if (e < PF::kNV && ts < p.S) pf.v[j] = load16(v + ts * p.v_ss + c);
    }
  };
  // A vector never straddles a 32-key boundary, so its slots are
  // c + c / 32 + i.
  auto stage = [&](int n) {
#pragma unroll
    for (int j = 0; j < PF::kRK; ++j) {
      const int e = lane + 32 * j;
      const int t = e / (K / kVec), c = (e % (K / kVec)) * kVec;
      if (e < PF::kNRK && t < n) {
        const int sl = c + c / 32;
        unpack<T>(pf.r[j], &sr[t][sl]);
        unpack<T>(pf.k[j], &sk[t][sl]);
        unpack<T>(pf.w[j], &sw[t][sl]);
      }
    }
#pragma unroll
    for (int j = 0; j < PF::kV; ++j) {
      const int e = lane + 32 * j;
      const int t = e / (kCols / kVec), c = (e % (kCols / kVec)) * kVec;
      if (e < PF::kNV && t < n) unpack<T>(pf.v[j], &sv[t][c]);
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
      float vv[kColsT], acc[kColsT], bonus = 0.f;
#pragma unroll
      for (int j = 0; j < kColsT; ++j) {
        vv[j] = sv[t][cg + kColGroups * j];
        acc[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float rr = sr[t][slot0 + i], kk = sk[t][slot0 + i];
        const float ww = sw[t][slot0 + i];
        bonus = fmaf(rr * uu[i], kk, bonus);
#pragma unroll
        for (int j = 0; j < kColsT; ++j) {
          acc[j] = fmaf(rr, s[i][j], acc[j]);
          s[i][j] = fmaf(ww, s[i][j], kk * vv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsT; ++j)
        sy[t][g][cg + kColGroups * j] = fmaf(bonus, vv[j], acc[j]);
    }
    __syncthreads();

    for (int e = lane; e < n * kCols; e += 32) {
      const int t = e / kCols, c = e % kCols;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) a += sy[t][i][c];
      store(y + (t0 + t) * p.y_ss + c, a);
    }
  }

#pragma unroll
  for (int i = 0; i < kKeys; ++i)
#pragma unroll
    for (int j = 0; j < kColsT; ++j)
      p.sT[sbase + (long long)i * K + kColGroups * j] = s[i][j];
}

template <typename T, int K>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // Ask for the largest shared-memory carveout, so that CUDA does
  // not keep so much of the SM's 256 KB as L1 that fewer blocks fit.
  auto* fn = wkv6_kernel<T, K>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H * (K / Shape<K>::kCols));
  fn<<<grid, 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y). Strides are in
// elements. s0 may be null (zero initial state).
extern "C" int wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w,
    const float* u, const float* s0, void* y, float* sT, int dtype,
    int B, int S, int H, int K,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  const Params p{r, k, v, w, u, s0, y, sT, S, H,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 w_sb, w_ss, w_sh, y_sb, y_ss, y_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = dispatch<float>(p, B, K, s);
  else if (dtype == 1) e = dispatch<__nv_bfloat16>(p, B, K, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
