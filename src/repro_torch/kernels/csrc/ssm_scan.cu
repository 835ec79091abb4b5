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
// input dtype. The D * x skip is added in f32 and y is rounded once. The
// build uses no fast-math or flush-to-zero: a decay exp(dt a) below
// 1.2e-38 is a subnormal and must not become 0 early. The two dtypes take
// two kernels.
//
// bf16 (`ssd_bf16_kernel`): the TPU kernel's chunked form on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 sums; mma_sm90.cuh). Per
// chunk of kL = 64 steps, with cum the running sum of dt * a over the
// chunk (so every exponent below is <= 0):
//
//   W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j   (j <= i, else 0)
//   y_i     = sum_j W[i][j] x_j + exp(cum_i) (C_i . h) + D x_i
//   h      <- exp(cum_L) h + sum_j (dt_j exp(cum_L - cum_j) x_j) B_j^T
//
// A block of 4 warps owns (b, h, 64 columns of P) and walks the chunks in
// order; the state h stays in registers as m16n8 accumulators, 16 rows of
// P a warp, across the whole walk (the TPU keeps it in VMEM). x, B and C
// of the next chunk stream into a 2-stage ring by 16-byte cp.async during
// the current chunk's products; warp 0 reads the next chunk's dt and
// writes its running sum at the end of the current one. Per chunk: (1) the
// 10 lower-triangular 16 x 16 blocks of C B^T are shared out over the
// warps by halves (5 a warp, row blocks 0 and 3 or 1 and 2), scaled into
// W in f32 and stored to shared memory; (2) each warp
// computes y for all 64 rows and its 16 columns of P: C h^T with h's B
// fragments taken from its own state accumulators (their layout is the
// B fragment layout), then W x over the blocks at or below the diagonal;
// (3) it updates its rows of h by x^T B. Rows are padded by 8 bf16, so
// ldmatrix hits no bank conflict. N = 8 is padded to the mma's k of 16
// with zero columns; ragged S is zero-filled, and the padding steps
// (dt = 0, x = B = C = 0) neither decay nor feed the state.
//
// Rounding. The mma takes bf16 operands where the TPU's MXU at default
// precision rounds the same f32 operands (W, h, dt x) to bf16 too. A CPU
// emulation at zamba2-2.7b's widths (tests/test_torch_ssd_bf16.py) puts
// one rounding of each at the JAX limit (y 6.9e-2 beyond rtol, limit
// 6e-2, at S 256), so each of W, h and the scaled x is split into bf16
// hi + lo and takes two mma (C, B and x are bf16 inputs, exact); the
// emulation then reads 2.8e-5.
//
// C B^T is computed per (b, h) although with G = 1 it serves all heads of
// a group: at zamba2's shape 320 (b, h) blocks already run only 2-3 to an
// SM, and sharing C B^T across heads would cut the blocks further, for a
// product that is a tenth of the mma.
//
// f32 (`ssm_scan_f32_kernel`): the sequential recurrence on the f32 CUDA
// cores (the calibration pass and the f32 oracle runs). A block is 128
// threads on (b, h, 128 / L rows of P); each row p of the state is split
// over L neighbouring threads that hold 32 columns each (N = 64: L = 2, 64
// rows a block, one block a head). A step costs a thread 3 f32 operations
// per state value and a shuffle to sum y over its row. B_t and C_t are
// read from shared memory as float4 (a thread's columns are 4 l + 4 L q +
// i, q < 8, i < 4, so the vectors of one read sit in distinct banks).
// Timesteps are staged 16 at a time in shared memory, together with dt_t
// and exp(dt_t * a_h); the next tile is loaded into registers with
// 16-byte vector loads (every row of x, B and C must start 16-byte
// aligned) while the block computes the current one.
//
// What bounds it on an H100: at the zamba2-2.7b prefill shape (B=4,
// S=1024, H=80, P=64, G=1, N=64, bf16 x/B/C/y, f32 dt/h0/hT) the bytes are
// 2 x 41.9 MB (x, y) + 1.3 MB (dt) + 1.0 MB (B, C) + 2 x 5.2 MB (h0, hT)
// = 97 MB, 0.029 ms at 3.35 TB/s, against the chunked products' 16 GFLOP
// at the bf16 tensor-core peak, 0.016 ms: the bytes bound it. The split
// operands double two of the four products, and mma.sync does not reach
// the peak that wgmma does.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

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
  int S, H, P, G, N;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

// ---- f32 on the CUDA cores: the recurrence ----------------------------

constexpr int kTile = 16;             // timesteps per staged tile

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

__device__ __forceinline__ float4 load16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// One tile's inputs in flight: float4 vectors of x (this block's rows), B
// and C, and one dt, loaded for the next tile while the block computes the
// current one.
template <int N>
struct Prefetch {
  static constexpr int kRowVecs = Shape<N>::kRows / 4;
  static constexpr int kStateVecs = N / 4;
  static constexpr int kX = (kTile * kRowVecs + kThreads - 1) / kThreads;
  static constexpr int kBC = (kTile * kStateVecs + kThreads - 1) / kThreads;
  float4 x[kX], b[kBC], c[kBC];
  float dt;
};

template <int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_f32_kernel(Params p) {
  using SH = Shape<N>;
  using PF = Prefetch<N>;
  constexpr int kLanes = SH::kLanes, kRows = SH::kRows;
  constexpr int kQuads = SH::kQuads, kT = kTile;
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

  const float* x = static_cast<const float*>(p.x) + b * p.x_sb +
                   h * p.x_sh + p0;
  const float* bm = static_cast<const float*>(p.Bm) + b * p.b_sb +
                    g * p.b_sg;
  const float* cm = static_cast<const float*>(p.Cm) + b * p.c_sb +
                    g * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* y = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh + p0;

  // Vector e of a tile's x covers step e / kRowVecs, rows from
  // (e % kRowVecs) * 4; of B or C, step e / kStateVecs. Steps at or past
  // S, and rows at or past P, are not loaded.
  PF pf;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PF::kX; ++j) {
      const int e = tid + kThreads * j;
      const long long ts = t0 + e / PF::kRowVecs;
      const int r = (e % PF::kRowVecs) * 4;
      if (e < kT * PF::kRowVecs && ts < p.S && r < rows)
        pf.x[j] = load16(x + ts * p.x_ss + r);
    }
#pragma unroll
    for (int j = 0; j < PF::kBC; ++j) {
      const int e = tid + kThreads * j;
      const long long ts = t0 + e / PF::kStateVecs;
      const int c = (e % PF::kStateVecs) * 4;
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
      const int t = e / PF::kRowVecs, r = (e % PF::kRowVecs) * 4;
      if (e < kT * PF::kRowVecs && t < n)
        *reinterpret_cast<float4*>(&sx[t][r]) =
            r < rows ? pf.x[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < PF::kBC; ++j) {
      const int e = tid + kThreads * j;
      const int t = e / PF::kStateVecs, c = (e % PF::kStateVecs) * 4;
      if (e < kT * PF::kStateVecs && t < n) {
        *reinterpret_cast<float4*>(&sb[t][c]) = pf.b[j];
        *reinterpret_cast<float4*>(&sc[t][c]) = pf.c[j];
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
        acc += __shfl_xor_sync(kFull, acc, o);
      if (l == 0) sy[t][row] = fmaf(dh, xv, acc);
    }
    __syncthreads();

    for (int e = tid; e < n * rows; e += kThreads) {
      const int t = e / rows, r = e % rows;
      y[(t0 + t) * p.y_ss + r] = sy[t][r];
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      *reinterpret_cast<float4*>(p.hT + hbase + col(q)) =
          make_float4(st[q][0], st[q][1], st[q][2], st[q][3]);
  }
}

template <int N>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  auto* fn = ssm_scan_f32_kernel<N>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const int rows = Shape<N>::kRows;
  const dim3 grid(B * p.H * ((p.P + rows - 1) / rows));
  fn<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores: the chunked form -----------------------

using bf16 = __nv_bfloat16;
constexpr int kL = 64;                // steps a chunk
constexpr int kPT = 64;               // columns of P a block, 16 a warp
constexpr int kLdX = kPT + 8;         // smem row strides (bf16)
constexpr int kLdW = kL + 8;
constexpr float kLog2e = 1.4426950408889634f;

// NP: the state dim N padded to a multiple of 16.
template <int NP>
struct SsdTiles {
  static constexpr int kLdS = NP + 8;
  static constexpr int kX = kL * kLdX;     // bf16 in an x tile
  static constexpr int kS = kL * kLdS;     // ... in a B or C tile
  static constexpr int kW = kL * kLdW;     // ... in a W tile (hi or lo)
  // x, B, C in 2 stages; W hi and lo; cum and dt of 2 chunks (f32).
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * (kX + 2 * kS) + 2 * kW) + sizeof(float) * 4 * kL;
};

// Copies rows t0 .. t0 + kL - 1 (those below S) and columns 0 .. cols - 1
// of a bf16 matrix with row stride `ld` into a kL x W tile of row stride
// W + 8, by 16-byte cp.async; the rest of the tile is zero-filled (cols is
// a multiple of 8, so no chunk is partial).
template <int W>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long ld, int t0, int S,
                                           int cols, int tid) {
  constexpr int kChunks = W / 8;
  for (int i = tid; i < kL * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = t0 + r < S && c < cols;
    const bf16* s = src + (long long)(t0 + r) * ld + c;
    mma::cp_async_16(mma::smem_addr(dst + r * (W + 8) + c), ok ? s : src,
                     ok);
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bf16_kernel(const Params p) {
  using Tiles = SsdTiles<NP>;
  constexpr int kLdS = Tiles::kLdS;
  constexpr int KN = NP / 16;         // k16 steps over the state dim
  constexpr int NN = NP / 8;          // n-tiles of h (8 state columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // 2 stages
  bf16* bs = xs + 2 * Tiles::kX;                    // 2 stages
  bf16* cs = bs + 2 * Tiles::kS;                    // 2 stages
  bf16* whi = cs + 2 * Tiles::kS;
  bf16* wlo = whi + Tiles::kW;
  float* cums = reinterpret_cast<float*>(wlo + Tiles::kW);   // 2 chunks
  float* dts = cums + 2 * kL;                                 // 2 chunks

  const int tiles = (p.P + kPT - 1) / kPT;
  const int bh = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * kPT;
  const int b = bh / p.H, h = bh % p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 2, qc = lane & 3;   // fragment group, quad lane
  const int ps = 16 * warp;                  // this warp's columns of P
  const bool live = p0 + ps < p.P;
  // a in log2 units: the running sums are of dt a log2(e), so each decay
  // is one exp2f (no fast-math: subnormal results stay).
  const float ah = p.a[h] * kLog2e, dh = p.D[h];
  const int n_chunks = (p.S + kL - 1) / kL;

  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh +
                   p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  bf16* yg = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh + p0;

  auto load = [&](int c) {
    const int t0 = c * kL, s = c % 2;
    stage_tile<kPT>(xs + s * Tiles::kX, xg, p.x_ss, t0, p.S, p.P - p0, tid);
    stage_tile<NP>(bs + s * Tiles::kS, bg, p.b_ss, t0, p.S, p.N, tid);
    stage_tile<NP>(cs + s * Tiles::kS, cg, p.c_ss, t0, p.S, p.N, tid);
  };
  // Warp 0: dt of steps lane and lane + 32 of chunk c (0 past S), then
  // their running sum of dt * a log2(e) over the chunk (inclusive) into
  // chunk c's slots of cums and dts.
  auto read_dt = [&](int c, float& d0, float& d1) {
    const int t = c * kL + lane;
    d0 = t < p.S ? __ldg(dtg + (long long)t * p.dt_ss) : 0.f;
    d1 = t + 32 < p.S ? __ldg(dtg + (long long)(t + 32) * p.dt_ss) : 0.f;
  };
  auto scan = [&](int c, float d0, float d1) {
    float c0 = d0 * ah, c1 = d1 * ah;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float v0 = __shfl_up_sync(kFull, c0, o);
      const float v1 = __shfl_up_sync(kFull, c1, o);
      if (lane >= o) {
        c0 += v0;
        c1 += v1;
      }
    }
    c1 += __shfl_sync(kFull, c0, 31);
    float* cum = cums + (c % 2) * kL;
    float* dt = dts + (c % 2) * kL;
    cum[lane] = c0;
    cum[lane + 32] = c1;
    dt[lane] = d0;
    dt[lane + 32] = d1;
  };

  // This warp's 16 rows of the state (rows ps + qg and ps + qg + 8 of the
  // block's P tile), all NP columns, as m16n8 accumulators.
  float hacc[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pr = p0 + ps + qg + 8 * r, n = 8 * j + 2 * qc;
      float2 v = make_float2(0.f, 0.f);
      if (p.h0 && pr < p.P && n < p.N)
        v = *reinterpret_cast<const float2*>(
            p.h0 + ((long long)bh * p.P + pr) * p.N + n);
      hacc[j][2 * r] = v.x;
      hacc[j][2 * r + 1] = v.y;
    }

  // ldmatrix row addresses of this lane (mma_sm90.cuh): an A operand and
  // a k-major B take row lane % 16 at column offset 8 (lane / 16); an
  // n-major B, and x^T as an A, take row (lane % 8) + 8 (lane / 16) at
  // column offset 8 ((lane / 8) % 2).
  const int lrow = lane % 16, lcol = 8 * (lane / 16);
  const int krow = lane % 8 + 8 * (lane / 16), kcol = 8 * ((lane / 8) % 2);

  if (warp == 0) {
    float d0, d1;
    read_dt(0, d0, d1);
    scan(0, d0, d1);
  }
  load(0);
  mma::cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % 2, t0 = c * kL;
    mma::cp_async_wait<0>();
    __syncthreads();   // chunk c's tiles and sums are in; W, stage c+1 free
    float nd0 = 0.f, nd1 = 0.f;
    if (c + 1 < n_chunks) {
      load(c + 1);
      if (warp == 0) read_dt(c + 1, nd0, nd1);
    }
    mma::cp_async_commit();
    const bf16* xt = xs + s * Tiles::kX;
    const bf16* bt = bs + s * Tiles::kS;
    const bf16* ct = cs + s * Tiles::kS;
    const float* cum = cums + s * kL;
    const float* dt = dts + s * kL;

    // (1) W, 16 rows x 8 columns at a time: C B^T (K = state dim),
    // scaled in f32, split, stored. Warp w takes n-tile w % 2 of every
    // block in row blocks w / 2 and 3 - w / 2 (5 a warp), C's fragments
    // loaded once a row block.
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int I = side ? 3 - warp / 2 : warp / 2, t = warp % 2;
      uint32_t a[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        mma::ldmatrix_x4(a[kk], mma::smem_addr(
            ct + (16 * I + lrow) * kLdS + 16 * kk + lcol));
      for (int J = 0; J <= I; ++J) {
        float sacc[4] = {};
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t r[2];
          mma::ldmatrix_x2(r, mma::smem_addr(
              bt + (16 * J + 8 * t + krow) * kLdS + 16 * kk + kcol));
          mma::mma_bf16_16816(sacc, a[kk], r[0], r[1]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 16 * I + qg + 8 * rr;
          const int j = 16 * J + 8 * t + 2 * qc;
          // exp only where j <= i: there the exponent is <= 0.
          const float w0 = j <= i ? sacc[2 * rr] *
                                        exp2f(cum[i] - cum[j]) * dt[j]
                                  : 0.f;
          const float w1 = j + 1 <= i ? sacc[2 * rr + 1] *
                                            exp2f(cum[i] - cum[j + 1]) *
                                            dt[j + 1]
                                      : 0.f;
          uint32_t hi, lo;
          mma::split_bf16(w0, w1, hi, lo);
          *reinterpret_cast<uint32_t*>(whi + i * kLdW + j) = hi;
          *reinterpret_cast<uint32_t*>(wlo + i * kLdW + j) = lo;
        }
      }
    }
    __syncthreads();                   // W is whole

    if (live) {
      // (2) y for the 64 rows and this warp's 16 columns of P. h's B
      // fragments (k = state column, n = p): the accumulator of rows
      // ps + qg (+ 8), columns 8 j + 2 qc, is exactly b[0] (j even) or
      // b[1] (j odd) of n-tile 0 (+ 1) of k-step j / 2.
      uint32_t hb[KN][2][2], hl[KN][2][2];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mma::split_bf16(hacc[2 * kk + e][2 * t],
                            hacc[2 * kk + e][2 * t + 1], hb[kk][t][e],
                            hl[kk][t][e]);
#pragma unroll
      for (int I = 0; I < 4; ++I) {
        float yacc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t a[4];
          mma::ldmatrix_x4(a, mma::smem_addr(ct + (16 * I + lrow) * kLdS +
                                             16 * kk + lcol));
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma::mma_bf16_16816(yacc[t], a, hb[kk][t][0], hb[kk][t][1]);
            mma::mma_bf16_16816(yacc[t], a, hl[kk][t][0], hl[kk][t][1]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float e = exp2f(cum[16 * I + qg + 8 * rr]);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            yacc[t][2 * rr] *= e;
            yacc[t][2 * rr + 1] *= e;
          }
        }
#pragma unroll
        for (int J = 0; J <= I; ++J) {
          uint32_t ah4[4], al4[4], r[4];
          mma::ldmatrix_x4(ah4, mma::smem_addr(whi + (16 * I + lrow) * kLdW +
                                               16 * J + lcol));
          mma::ldmatrix_x4(al4, mma::smem_addr(wlo + (16 * I + lrow) * kLdW +
                                               16 * J + lcol));
          mma::ldmatrix_x4_trans(r, mma::smem_addr(
              xt + (16 * J + lrow) * kLdX + ps + lcol));
          mma::mma_bf16_16816(yacc[0], ah4, r[0], r[1]);
          mma::mma_bf16_16816(yacc[0], al4, r[0], r[1]);
          mma::mma_bf16_16816(yacc[1], ah4, r[2], r[3]);
          mma::mma_bf16_16816(yacc[1], al4, r[2], r[3]);
        }
        // D x in f32, one rounding, bf16 pairs out.
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 16 * I + qg + 8 * rr;
          if (t0 + i >= p.S) continue;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int pc = ps + 8 * t + 2 * qc;
            if (p0 + pc >= p.P) continue;
            const float2 xv = mma::unpack_bf16(
                *reinterpret_cast<const uint32_t*>(xt + i * kLdX + pc));
            *reinterpret_cast<uint32_t*>(yg + (long long)(t0 + i) * p.y_ss +
                                         pc) =
                mma::pack_bf16(fmaf(dh, xv.x, yacc[t][2 * rr]),
                               fmaf(dh, xv.y, yacc[t][2 * rr + 1]));
          }
        }
      }

      // (3) h <- exp(cum_L) h + (x s)^T B, s_j = dt_j exp(cum_L - cum_j):
      // x^T's A fragments by ldmatrix.trans of x, scaled and split in
      // registers (a[0], a[1] hold steps 2 qc, 2 qc + 1 of the k-step;
      // a[2], a[3] those plus 8); B's by ldmatrix.trans (k-major).
      const float cl = cum[kL - 1];
      const float dec = exp2f(cl);
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= dec;
#pragma unroll
      for (int J = 0; J < kL / 16; ++J) {
        uint32_t ax[4], ahi[4], alo[4];
        mma::ldmatrix_x4_trans(ax, mma::smem_addr(
            xt + (16 * J + krow) * kLdX + ps + kcol));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 16 * J + 8 * half + 2 * qc;
          const float s0 = dt[j] * exp2f(cl - cum[j]);
          const float s1 = dt[j + 1] * exp2f(cl - cum[j + 1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float2 v = mma::unpack_bf16(ax[2 * half + m]);
            mma::split_bf16(v.x * s0, v.y * s1, ahi[2 * half + m],
                            alo[2 * half + m]);
          }
        }
#pragma unroll
        for (int nn = 0; nn < NN / 2; ++nn) {
          uint32_t r[4];
          mma::ldmatrix_x4_trans(r, mma::smem_addr(
              bt + (16 * J + lrow) * kLdS + 16 * nn + lcol));
          mma::mma_bf16_16816(hacc[2 * nn], ahi, r[0], r[1]);
          mma::mma_bf16_16816(hacc[2 * nn], alo, r[0], r[1]);
          mma::mma_bf16_16816(hacc[2 * nn + 1], ahi, r[2], r[3]);
          mma::mma_bf16_16816(hacc[2 * nn + 1], alo, r[2], r[3]);
        }
      }
    }
    if (warp == 0 && c + 1 < n_chunks) scan(c + 1, nd0, nd1);
  }
  mma::cp_async_wait<0>();            // no copy outlives the block

  if (!live) return;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pr = p0 + ps + qg + 8 * r, n = 8 * j + 2 * qc;
      if (pr < p.P && n < p.N)
        *reinterpret_cast<float2*>(p.hT + ((long long)bh * p.P + pr) * p.N +
                                   n) =
            make_float2(hacc[j][2 * r], hacc[j][2 * r + 1]);
    }
}

template <int NP>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = SsdTiles<NP>::kSmem;
  auto* fn = ssd_bf16_kernel<NP>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H * ((p.P + kPT - 1) / kPT));
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
  const Params p{x, dt, a, Bm, Cm, D, h0, y, hT, S, H, P, G, N,
                 x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                 b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (N) {
      case 8: e = launch_f32<8>(p, B, s); break;     // the JAX suite's
      case 16: e = launch_f32<16>(p, B, s); break;   // the calibration's
      case 64: e = launch_f32<64>(p, B, s); break;   // zamba2-2.7b
    }
  } else if (dtype == 1) {
    switch (N) {
      case 8:                                        // zero-padded to 16
      case 16: e = launch_bf16<16>(p, B, s); break;
      case 64: e = launch_bf16<64>(p, B, s); break;
    }
  }
  return static_cast<int>(e);
}
