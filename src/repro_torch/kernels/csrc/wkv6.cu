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
// contiguous; y (B, S, H, K) in the input dtype. K is 16, 32 or 64. The
// decays are clamped to [1e-38, 1] as the plain version clamps them and
// multiplied in directly (no exp(log w)); the build uses no fast-math or
// flush-to-zero, since 1e-38 and its products are subnormals. The two
// dtypes take two kernels.
//
// bf16 (`wkv6_bf16_kernel`): the TPU kernel's chunked form on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 sums; mma_sm90.cuh). A
// block of 4 warps owns (b, h, 32 value columns; two blocks share a head
// at K = 64 and each recomputes the chunk's A) and walks chunks of kL = 32
// steps in order, its rows of the state in registers as m16n8
// accumulators across the walk (the TPU keeps S in VMEM). Inside a chunk
// the decay from step j to step i > j is the per-channel product
// prod_{j<l<i} w_l, so A[i][j] = sum_c r_i[c] prod(...)[c] k_j[c] is no
// plain product. The chunk is cut into 8 quarters of 4 steps, with r~_i =
// r_i times the product of i's quarter before i, k~_j = k_j times the
// product of j's quarter after j, and Q_q the product of quarter q. For
// any reference step m with j <= m < i,
//
//   A[i][j] = (r~_i prod_{quarters after m's, before i's} Q)
//           . (k~_j prod_{quarters after j's, up to m's} Q),
//
// every factor a product of decays, so <= 1: a factor that underflows does
// so only where the true product is smaller still, and no exp of a
// positive exponent is formed. Per chunk: (1) warp m makes r~, k~ and Q
// of quarters 2 m and 2 m + 1 (a lane a channel), and 64 threads the
// per-channel products of Q the later phases scale by; (2) in its block
// of 8 steps, warp m computes in f32 on the CUDA cores the two triangles
// inside the quarters (a quad of lanes a row or column, stepping the
// decay, as the Pallas kernel's row loop; the bonus r u k on the
// diagonal) and the 4 x 4 product between them (r~ . k~, m the block's
// step 3); then one 16 x 8 tile of A between blocks of 8 on the tensor
// cores (m the tile's last column); (3) each warp computes y for 16 rows
// and 16 value columns: (r~ E) S with E the product of the quarters
// before the row's, plus A v; (4) it updates its 16 key rows of S by
// diag(prod Q) S + (k~ F)^T v, F the product of the quarters after the
// step's. r, k, v, w of the next chunk stream into a 2-stage ring by
// 16-byte cp.async during the current chunk.
//
// Rounding. The mma takes bf16 operands. A CPU emulation at rwkv6-3b's
// widths (tests/test_torch_wkv6_bf16.py) puts one rounding of any of r~,
// k~, A or S far beyond the serve path's limit (rtol 1e-2, atol 5e-3: the
// decays there are near 1, so long sums of large terms cancel), so every
// f32 operand is split into bf16 hi + lo: hi.hi + hi.lo + lo.hi against
// another split operand, hi + lo against a bf16 input (v).
//
// f32 (`wkv6_f32_kernel`): the sequential recurrence on the f32 CUDA
// cores (the calibration pass and the f32 oracle runs). A block is one
// warp and owns (b, h, 32 value columns). Each lane holds a tile of the
// state, 8 keys x 8 columns at K = 64, and per step does 3 f32 operations
// per value it holds, reading 3 x 8 key values and 8 column values from
// shared memory for them; the rows are padded by a word after every 32
// keys and a lane's columns are interleaved (column group + 4 j), so the
// lanes' partial sums of y land in 32 different banks. Timesteps are
// staged 8 at a time in shared memory; the next tile is loaded into
// registers (16-byte vector loads, so every row of r, k, v, w must start
// 16-byte aligned) while the block computes the current one.
//
// What bounds it on an H100: at the rwkv6-3b prefill shape (B=4, S=1024,
// H=40, K=64, bf16 r/k/v/w/y, f32 s0/sT) the bytes are 5 x 21.0 MB +
// 2 x 2.6 MB = 110 MB, 0.033 ms at 3.35 TB/s, against ~4 GFLOP of chunked
// products (0.004 ms at the bf16 tensor-core peak): the bytes bound it.
// The kernel's own work beside the products is the part of A inside the
// blocks of 8 on the CUDA cores: 12 (i, j) pairs x K channels x 2
// operations a block in the triangles and 16 x K in the 4 x 4 products,
// done twice at K = 64 (once a block).
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

__device__ __forceinline__ float clamp_decay(float w) {
  return fminf(fmaxf(w, 1e-38f), 1.f);
}

// ---- f32 on the CUDA cores: the recurrence ----------------------------

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

constexpr int kTile = 8;              // timesteps per staged tile

// One tile's inputs in flight: each lane holds float4 vectors of r, k, w
// (kRK each) and of v (kV), loaded for the next tile while the block
// computes the current one.
template <int K>
struct Prefetch {
  static constexpr int kNRK = kTile * K / 4;            // vectors a tile
  static constexpr int kNV = kTile * Shape<K>::kCols / 4;
  static constexpr int kRK = (kNRK + 31) / 32;
  static constexpr int kV = (kNV + 31) / 32;
  static_assert(Shape<K>::kCols % 4 == 0, "v rows in whole vectors");
  float4 r[kRK], k[kRK], w[kRK], v[kV];
};

__device__ __forceinline__ float4 load16(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void put4(float* f, const float4& x) {
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

template <int K>
__global__ void __launch_bounds__(32) wkv6_f32_kernel(Params p) {
  using SH = Shape<K>;
  using PF = Prefetch<K>;
  constexpr int kKeys = SH::kKeys, kColsT = SH::kColsT;
  constexpr int kGroups = SH::kGroups, kColGroups = SH::kColGroups;
  constexpr int kCols = SH::kCols, kColsP = SH::kColsP, kRow = SH::kRow;
  constexpr int kT = kTile;
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

  const float* r = static_cast<const float*>(p.r) + b * p.r_sb + h * p.r_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh +
                   v0;
  const float* w = static_cast<const float*>(p.w) + b * p.w_sb + h * p.w_sh;
  float* y = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh + v0;

  // Vector e of a tile covers row e / (cols / 4), columns from
  // (e % (cols / 4)) * 4. Rows at or past S are not loaded.
  PF pf;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PF::kRK; ++j) {
      const int e = lane + 32 * j;
      const long long ts = t0 + e / (K / 4);
      const int c = (e % (K / 4)) * 4;
      if (e < PF::kNRK && ts < p.S) {
        pf.r[j] = load16(r + ts * p.r_ss + c);
        pf.k[j] = load16(k + ts * p.k_ss + c);
        pf.w[j] = load16(w + ts * p.w_ss + c);
      }
    }
#pragma unroll
    for (int j = 0; j < PF::kV; ++j) {
      const int e = lane + 32 * j;
      const long long ts = t0 + e / (kCols / 4);
      const int c = (e % (kCols / 4)) * 4;
      if (e < PF::kNV && ts < p.S) pf.v[j] = load16(v + ts * p.v_ss + c);
    }
  };
  // A vector never straddles a 32-key boundary, so its slots are
  // c + c / 32 + i.
  auto stage = [&](int n) {
#pragma unroll
    for (int j = 0; j < PF::kRK; ++j) {
      const int e = lane + 32 * j;
      const int t = e / (K / 4), c = (e % (K / 4)) * 4;
      if (e < PF::kNRK && t < n) {
        const int sl = c + c / 32;
        put4(&sr[t][sl], pf.r[j]);
        put4(&sk[t][sl], pf.k[j]);
        put4(&sw[t][sl], pf.w[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PF::kV; ++j) {
      const int e = lane + 32 * j;
      const int t = e / (kCols / 4), c = (e % (kCols / 4)) * 4;
      if (e < PF::kNV && t < n) put4(&sv[t][c], pf.v[j]);
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
      y[(t0 + t) * p.y_ss + c] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < kKeys; ++i)
#pragma unroll
    for (int j = 0; j < kColsT; ++j)
      p.sT[sbase + (long long)i * K + kColGroups * j] = s[i][j];
}

template <int K>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  // Ask for the largest shared-memory carveout, so that CUDA does
  // not keep so much of the SM's 256 KB as L1 that fewer blocks fit.
  auto* fn = wkv6_f32_kernel<K>;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H * (K / Shape<K>::kCols));
  fn<<<grid, 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores: the chunked form -----------------------

using bf16 = __nv_bfloat16;
constexpr int kL = 32;                // steps a chunk: 8 quarters of 4
constexpr int kLdA = kL + 8;          // smem row stride of A (bf16)

template <int K>
struct WkvTiles {
  static constexpr int kV = K < 32 ? K : 32;   // value columns a block
  static constexpr int kLdK = K + 8;           // bf16 rows of r, k, w
  static constexpr int kLdV = kV + 8;          // bf16 rows of v and S
  static constexpr int kLdF = K + 4;           // f32 rows of r~, k~
  static constexpr int kRaw = kL * (3 * kLdK + kLdV);   // bf16 a stage
  static constexpr int kA = kL * kLdA;         // bf16 in A, hi or lo
  static constexpr int kS = K * kLdV;          // bf16 in S, hi or lo
  static constexpr int kF = kL * kLdF;         // f32 in r~ or k~
  // Per channel: Q, E, F of the 8 quarters, the chunk's product, and the
  // row factors of the 4 tiles between blocks (4 quarters each).
  static constexpr int kFac = (8 + 8 + 8 + 1 + 16) * K;
  // Raw r, k, w, v in 2 stages; A and S hi and lo; r~, k~; the factors.
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kRaw + 2 * kA + 2 * kS) +
      sizeof(float) * (2 * kF + kFac);
};

// Copies rows t0 .. t0 + kL - 1 (those below S) and columns 0 .. W - 1
// of a bf16 matrix with row stride `ld` into a kL x W tile of row stride
// W + 8, by 16-byte cp.async; rows past S are zero-filled.
template <int W>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long ld, int t0, int S,
                                           int tid) {
  constexpr int kChunks = W / 8;
  for (int i = tid; i < kL * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = t0 + r < S;
    const bf16* s = src + (long long)(t0 + r) * ld + c;
    mma::cp_async_16(mma::smem_addr(dst + r * (W + 8) + c), ok ? s : src,
                     ok);
  }
}

// N consecutive bf16 from shared memory (8-byte aligned, N a multiple
// of 4) as f32.
template <int N>
__device__ __forceinline__ void load_row(float (&f)[N], const bf16* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = mma::unpack_bf16(v.x), b = mma::unpack_bf16(v.y);
    f[i] = a.x;
    f[i + 1] = a.y;
    f[i + 2] = b.x;
    f[i + 3] = b.y;
  }
}

// Two consecutive bf16 from shared memory (4-byte aligned) as f32.
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// Stores v to A's (row, col) as bf16 hi and lo.
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int at,
                                          float v) {
  const bf16 h = __float2bfloat16(v);
  hi[at] = h;
  lo[at] = __float2bfloat16(v - __bfloat162float(h));
}

// The four 16 x 8 tiles of A between blocks of 8, one a warp: tile u is
// (16-row group I, 8-column block n) = (0, 0), (1, 0), (1, 1), (1, 2);
// with n = 2 I only the lower 8 rows lie after the columns.
__device__ __forceinline__ int tile_rows(int u) { return u == 0 ? 0 : 1; }
__device__ __forceinline__ int tile_cols(int u) { return u == 0 ? 0 : u - 1; }

template <int K>
__global__ void __launch_bounds__(kThreads)
wkv6_bf16_kernel(const Params p) {
  using Tiles = WkvTiles<K>;
  constexpr int kV = Tiles::kV, kLdK = Tiles::kLdK, kLdV = Tiles::kLdV;
  constexpr int kLdF = Tiles::kLdF;
  constexpr int KK = K / 16;          // k16 steps over the channels
  constexpr int kQ = K / 4;           // channels a lane in the triangles
  constexpr int kH = K / 2;           // ... in the 4 x 4 products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);     // 2 stages
  bf16* ahi = raw + 2 * Tiles::kRaw;
  bf16* alo = ahi + Tiles::kA;
  bf16* shi = alo + Tiles::kA;
  bf16* slo = shi + Tiles::kS;
  float* rq = reinterpret_cast<float*>(slo + Tiles::kS);   // r~
  float* kq = rq + Tiles::kF;                               // k~
  float* qm = kq + Tiles::kF;         // Q_q, product of quarter q, [8][K]
  float* em = qm + 8 * K;             // E_q: of the quarters before q
  float* fm = em + 8 * K;             // F_q: of the quarters after q
  float* dm = fm + 8 * K;             // the chunk's product
  float* um = dm + K;                 // row factors of the tiles, [4][4][K]

  constexpr int kBlocks = K / kV;     // blocks per head
  const int bh = blockIdx.x / kBlocks;
  const int v0 = (blockIdx.x % kBlocks) * kV;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 2, qc = lane & 3;   // fragment group, quad lane
  const int n_chunks = (p.S + kL - 1) / kL;

  const bf16* rg = static_cast<const bf16*>(p.r) + b * p.r_sb + h * p.r_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh +
                   v0;
  const bf16* wg = static_cast<const bf16*>(p.w) + b * p.w_sb + h * p.w_sh;
  bf16* yg = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh + v0;

  // A stage: r, k, w (kL x K) then v (kL x kV).
  auto tile_r = [&](int s) { return raw + s * Tiles::kRaw; };
  auto tile_k = [&](int s) { return tile_r(s) + kL * kLdK; };
  auto tile_w = [&](int s) { return tile_r(s) + 2 * kL * kLdK; };
  auto tile_v = [&](int s) { return tile_r(s) + 3 * kL * kLdK; };
  auto load = [&](int c) {
    const int t0 = c * kL, s = c % 2;
    stage_tile<K>(tile_r(s), rg, p.r_ss, t0, p.S, tid);
    stage_tile<K>(tile_k(s), kg, p.k_ss, t0, p.S, tid);
    stage_tile<K>(tile_w(s), wg, p.w_ss, t0, p.S, tid);
    stage_tile<kV>(tile_v(s), vg, p.v_ss, t0, p.S, tid);
  };
  auto pair = [](const float* f) {
    return *reinterpret_cast<const float2*>(f);
  };

  // This warp's 16 key rows of S (16 warp + qg, + 8), kV value columns,
  // as m16n8 accumulators.
  const bool owns_keys = 16 * warp < K;
  float sacc[kV / 8][4];
#pragma unroll
  for (int j = 0; j < kV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = 16 * warp + qg + 8 * r, col = v0 + 8 * j + 2 * qc;
      float2 x = make_float2(0.f, 0.f);
      if (p.s0 && owns_keys)
        x = *reinterpret_cast<const float2*>(
            p.s0 + ((long long)bh * K + key) * K + col);
      sacc[j][2 * r] = x.x;
      sacc[j][2 * r + 1] = x.y;
    }
  // The triangles: lane (half, t, q) owns step t of quarter 2 warp + half
  // and channels q kQ .. q kQ + kQ - 1; its share of u.
  const int tq = (lane >> 2) & 3, q0 = (lane & 3) * kQ;
  float uq[kQ];
#pragma unroll
  for (int c = 0; c < kQ; ++c) uq[c] = p.u[h * K + q0 + c];

  // ldmatrix row addresses of this lane (mma_sm90.cuh): an A operand and
  // a k-major B take row lane % 16 at column offset 8 (lane / 16).
  const int lrow = lane % 16, lcol = 8 * (lane / 16);

  load(0);
  mma::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % 2, t0 = c * kL;
    mma::cp_async_wait<0>();
    __syncthreads();   // chunk c is in; A, S, r~, k~, stage c+1 free
    if (c + 1 < n_chunks) load(c + 1);
    mma::cp_async_commit();
    const bf16* rt = tile_r(s);
    const bf16* kt = tile_k(s);
    bf16* wt = tile_w(s);
    const bf16* vt = tile_v(s);

    // S as the inter-chunk term's B operand, hi and lo.
    if (owns_keys) {
#pragma unroll
      for (int j = 0; j < kV / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          mma::split_bf16(sacc[j][2 * r], sacc[j][2 * r + 1], hi, lo);
          const int at = (16 * warp + qg + 8 * r) * kLdV + 8 * j + 2 * qc;
          *reinterpret_cast<uint32_t*>(shi + at) = hi;
          *reinterpret_cast<uint32_t*>(slo + at) = lo;
        }
    }

    // (1) Quarters 2 warp and 2 warp + 1 (a lane two channels): w clamped
    // (1 on padding steps: no decay) and written back in place; r~ = r
    // times the product of its quarter before the step, k~ = k times the
    // product of its quarter after it; Q of each quarter. Every load
    // comes before the stores into the same tiles.
    if (2 * lane < K) {
      const int ch = 2 * lane;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int q = 2 * warp + hq;
        float2 wv[4], rv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (4 * q + i) * kLdK + ch;
          wv[i] = load_pair(wt + at);
          rv[i] = load_pair(rt + at);
          kv[i] = load_pair(kt + at);
        }
        float2 e = make_float2(1.f, 1.f), a = e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * q + i;
          wv[i] = t0 + row < p.S ? make_float2(clamp_decay(wv[i].x),
                                               clamp_decay(wv[i].y))
                                 : make_float2(1.f, 1.f);
          *reinterpret_cast<uint32_t*>(wt + row * kLdK + ch) =
              mma::pack_bf16(wv[i].x, wv[i].y);
          *reinterpret_cast<float2*>(rq + row * kLdF + ch) =
              make_float2(rv[i].x * e.x, rv[i].y * e.y);
          e = make_float2(e.x * wv[i].x, e.y * wv[i].y);
        }
        *reinterpret_cast<float2*>(qm + q * K + ch) = e;
#pragma unroll
        for (int i = 3; i >= 0; --i) {
          *reinterpret_cast<float2*>(kq + (4 * q + i) * kLdF + ch) =
              make_float2(kv[i].x * a.x, kv[i].y * a.y);
          a = make_float2(a.x * wv[i].x, a.y * wv[i].y);
        }
      }
    }
    __syncthreads();                   // r~, k~, w, Q and S are in

    // Per channel: E_q, F_q, the chunk's product, and each tile's row
    // factors, the product of the quarters from 2 n + 2 up to the row's
    // quarter (0 on the diagonal tiles' upper rows, which are dropped).
    if (tid < K) {
      float qv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) qv[q] = qm[q * K + tid];
      float e = 1.f, f = 1.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        em[q * K + tid] = e;
        e *= qv[q];
        fm[(7 - q) * K + tid] = f;
        f *= qv[7 - q];
      }
      dm[tid] = e;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int I = tile_rows(u), n = tile_cols(u);
        const bool diag = n == 2 * I;
        float g = 1.f;
        for (int q = 2 * n + 2; q < 4 * I; ++q) g *= qv[q];
#pragma unroll
        for (int hb = 0; hb < 4; ++hb) {
          um[(4 * u + hb) * K + tid] = diag && hb < 2 ? 0.f : g;
          if (4 * I + hb >= 2 * n + 2) g *= qv[4 * I + hb];
        }
      }
    }

    // (2a) Inside quarters 2 warp and 2 warp + 1, in f32: lane (half, t,
    // q) takes the entries (i, t), i > t (its column: k_t decayed step by
    // step), then (t, j), j < t (its row: r_t decayed step by step), 3 in
    // all, and the bonus (t, t); a quad sums its channels by shuffles.
    {
      const int base = 8 * warp + 4 * (lane >> 4);
      // Zeros above the diagonal of A's 16 x 16 diagonal tiles: in this
      // block of 8 and, for an even block, in the block to its right.
      for (int e = lane; e < 64; e += 32) {
        const int i = e / 8, j = e % 8;
        const int at = (8 * warp + i) * kLdA + 8 * warp + j;
        if (j > i) ahi[at] = alo[at] = __float2bfloat16(0.f);
        if (warp % 2 == 0) ahi[at + 8] = alo[at + 8] = __float2bfloat16(0.f);
      }
      float rtv[kQ], st[kQ], bonus = 0.f;
      load_row<kQ>(rtv, rt + (base + tq) * kLdK + q0);
      load_row<kQ>(st, kt + (base + tq) * kLdK + q0);
#pragma unroll
      for (int cc = 0; cc < kQ; ++cc)
        bonus = fmaf(rtv[cc] * uq[cc], st[cc], bonus);
      bonus += __shfl_xor_sync(kFull, bonus, 1);
      bonus += __shfl_xor_sync(kFull, bonus, 2);
      if ((lane & 3) == 0)
        put_split(ahi, alo, (base + tq) * kLdA + base + tq, bonus);
#pragma unroll
      for (int sidx = 0; sidx < 3; ++sidx) {
        const bool col = sidx < 3 - tq;
        if (sidx == 3 - tq) {
#pragma unroll
          for (int cc = 0; cc < kQ; ++cc) st[cc] = rtv[cc];
        }
        // Row read against st: r_i (column) or k_j (row).
        const int row = col ? tq + 1 + sidx : tq - 1 - (sidx - (3 - tq));
        float x[kQ], wr[kQ], part[4] = {};
        load_row<kQ>(x, (col ? rt : kt) + (base + row) * kLdK + q0);
        load_row<kQ>(wr, wt + (base + row) * kLdK + q0);
#pragma unroll
        for (int cc = 0; cc < kQ; ++cc) {
          part[cc % 4] = fmaf(x[cc], st[cc], part[cc % 4]);
          st[cc] *= wr[cc];
        }
        float acc = (part[0] + part[1]) + (part[2] + part[3]);
        acc += __shfl_xor_sync(kFull, acc, 1);
        acc += __shfl_xor_sync(kFull, acc, 2);
        if ((lane & 3) == 0) {
          const int i = col ? row : tq, j = col ? tq : row;
          put_split(ahi, alo, (base + i) * kLdA + base + j, acc);
        }
      }
    }

    // (2b) Between the two quarters of block warp, in f32: rows 4..7 of
    // the block against columns 0..3, r~_i . k~_j; lane (pair, half of
    // the channels), the pair's two lanes summed by a shuffle.
    {
      const int i = 8 * warp + 4 + (lane >> 3);
      const int j = 8 * warp + ((lane >> 1) & 3);
      const int c0 = (lane & 1) * kH;
      float part[4] = {};
#pragma unroll
      for (int cc = 0; cc < kH; cc += 4) {
        const float4 a = *reinterpret_cast<const float4*>(
            rq + i * kLdF + c0 + cc);
        const float4 bq = *reinterpret_cast<const float4*>(
            kq + j * kLdF + c0 + cc);
        part[0] = fmaf(a.x, bq.x, part[0]);
        part[1] = fmaf(a.y, bq.y, part[1]);
        part[2] = fmaf(a.z, bq.z, part[2]);
        part[3] = fmaf(a.w, bq.w, part[3]);
      }
      float acc = (part[0] + part[1]) + (part[2] + part[3]);
      acc += __shfl_xor_sync(kFull, acc, 1);
      if ((lane & 1) == 0) put_split(ahi, alo, i * kLdA + j, acc);
    }
    __syncthreads();                   // the factors are in

    // (2c) One 16 x 8 tile of A between blocks of 8, on the tensor cores,
    // with the reference step the tile's last column: rows r~ times the
    // quarters from the column block's end to the row's quarter, columns
    // k~ times the second quarter of their block for the first quarter's.
    {
      const int I = tile_rows(warp), n = tile_cols(warp);
      const bool diag = n == 2 * I;
      const float* uf = um + 4 * warp * K;
      float acc[4] = {};
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t ah[4], al[4], bh2[2], bl2[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ch = 16 * kk + 2 * qc + 8 * hh;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 g = pair(uf + (2 * r + qg / 4) * K + ch);
            const float2 x = pair(rq + (16 * I + qg + 8 * r) * kLdF + ch);
            mma::split_bf16(x.x * g.x, x.y * g.y, ah[2 * hh + r],
                            al[2 * hh + r]);
          }
          float2 kv = pair(kq + (8 * n + qg) * kLdF + ch);
          if (qg < 4) {
            const float2 g = pair(qm + (2 * n + 1) * K + ch);
            kv.x *= g.x;
            kv.y *= g.y;
          }
          mma::split_bf16(kv.x, kv.y, bh2[hh], bl2[hh]);
        }
        mma::mma_bf16_16816(acc, ah, bh2[0], bh2[1]);
        mma::mma_bf16_16816(acc, ah, bl2[0], bl2[1]);
        mma::mma_bf16_16816(acc, al, bh2[0], bh2[1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (diag && r == 0) continue;
        uint32_t hi, lo;
        mma::split_bf16(acc[2 * r], acc[2 * r + 1], hi, lo);
        const int at = (16 * I + qg + 8 * r) * kLdA + 8 * n + 2 * qc;
        *reinterpret_cast<uint32_t*>(ahi + at) = hi;
        *reinterpret_cast<uint32_t*>(alo + at) = lo;
      }
    }
    __syncthreads();                   // A is whole

    // (3) y for rows 16 I (I = warp % 2) and value columns 16 vq (vq =
    // warp / 2): (r~ E) S, E the product of the quarters before the row's,
    // then A v.
    const int I = warp % 2, vq = warp / 2;
    if (16 * vq < kV) {
      float yacc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ch = 16 * kk + 2 * qc + 8 * hh;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * I + qg + 8 * r;
            const float2 e = pair(em + (row / 4) * K + ch);
            const float2 x = pair(rq + row * kLdF + ch);
            mma::split_bf16(x.x * e.x, x.y * e.y, ah[2 * hh + r],
                            al[2 * hh + r]);
          }
        }
        uint32_t sh4[4], sl4[4];
        mma::ldmatrix_x4_trans(sh4, mma::smem_addr(
            shi + (16 * kk + lrow) * kLdV + 16 * vq + lcol));
        mma::ldmatrix_x4_trans(sl4, mma::smem_addr(
            slo + (16 * kk + lrow) * kLdV + 16 * vq + lcol));
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma::mma_bf16_16816(yacc[t], ah, sh4[2 * t], sh4[2 * t + 1]);
          mma::mma_bf16_16816(yacc[t], ah, sl4[2 * t], sl4[2 * t + 1]);
          mma::mma_bf16_16816(yacc[t], al, sh4[2 * t], sh4[2 * t + 1]);
        }
      }
#pragma unroll
      for (int J = 0; J <= 1; ++J) {
        if (J > I) break;
        uint32_t ah4[4], al4[4], vb[4];
        mma::ldmatrix_x4(ah4, mma::smem_addr(ahi + (16 * I + lrow) * kLdA +
                                             16 * J + lcol));
        mma::ldmatrix_x4(al4, mma::smem_addr(alo + (16 * I + lrow) * kLdA +
                                             16 * J + lcol));
        mma::ldmatrix_x4_trans(vb, mma::smem_addr(
            vt + (16 * J + lrow) * kLdV + 16 * vq + lcol));
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma::mma_bf16_16816(yacc[t], ah4, vb[2 * t], vb[2 * t + 1]);
          mma::mma_bf16_16816(yacc[t], al4, vb[2 * t], vb[2 * t + 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * I + qg + 8 * r;
        if (t0 + row >= p.S) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          *reinterpret_cast<uint32_t*>(
              yg + (long long)(t0 + row) * p.y_ss + 16 * vq + 8 * t +
              2 * qc) = mma::pack_bf16(yacc[t][2 * r], yacc[t][2 * r + 1]);
      }
    }

    // (4) This warp's key rows of S: times the chunk's product of decays,
    // plus (k~ F)^T v, F the product of the quarters after the step's.
    // A = (k~ F)^T has rows = keys, k = steps: a[0], a[1] hold steps
    // 2 qc, 2 qc + 1 (one quarter) of keys qg, qg + 8; a[2], a[3] steps
    // + 8.
    if (owns_keys) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d = dm[16 * warp + qg + 8 * r];
#pragma unroll
        for (int j = 0; j < kV / 8; ++j) {
          sacc[j][2 * r] *= d;
          sacc[j][2 * r + 1] *= d;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 16 * kk + 8 * hh + 2 * qc;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = 16 * warp + qg + 8 * r;
            const float f = fm[(j / 4) * K + key];
            mma::split_bf16(kq[j * kLdF + key] * f,
                            kq[(j + 1) * kLdF + key] * f, ah[2 * hh + r],
                            al[2 * hh + r]);
          }
        }
#pragma unroll
        for (int nn = 0; nn < kV / 16; ++nn) {
          uint32_t vb[4];
          mma::ldmatrix_x4_trans(vb, mma::smem_addr(
              vt + (16 * kk + lrow) * kLdV + 16 * nn + lcol));
          mma::mma_bf16_16816(sacc[2 * nn], ah, vb[0], vb[1]);
          mma::mma_bf16_16816(sacc[2 * nn], al, vb[0], vb[1]);
          mma::mma_bf16_16816(sacc[2 * nn + 1], ah, vb[2], vb[3]);
          mma::mma_bf16_16816(sacc[2 * nn + 1], al, vb[2], vb[3]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();            // no copy outlives the block

  if (!owns_keys) return;
#pragma unroll
  for (int j = 0; j < kV / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = 16 * warp + qg + 8 * r, col = v0 + 8 * j + 2 * qc;
      *reinterpret_cast<float2*>(p.sT + ((long long)bh * K + key) * K +
                                 col) =
          make_float2(sacc[j][2 * r], sacc[j][2 * r + 1]);
    }
}

template <int K>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = WkvTiles<K>::kSmem;
  auto* fn = wkv6_bf16_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * p.H * (K / WkvTiles<K>::kV));
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (K) {
      case 16: e = launch_f32<16>(p, B, s); break;
      case 32: e = launch_f32<32>(p, B, s); break;
      case 64: e = launch_f32<64>(p, B, s); break;
    }
  } else if (dtype == 1) {
    switch (K) {
      case 16: e = launch_bf16<16>(p, B, s); break;
      case 32: e = launch_bf16<32>(p, B, s); break;
      case 64: e = launch_bf16<64>(p, B, s); break;
    }
  }
  return static_cast<int>(e);
}
