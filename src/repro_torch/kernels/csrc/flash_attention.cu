// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` in src/repro/kernels/flash_attention/kernel.py. It
// computes the same function: softmax(scale * Q K^T) V with f32
// accumulation and an online softmax (running max, running denominator),
// GQA (query head h reads KV head h / (H / KV)), causal and sliding-window
// masks (kpos > qpos - window), tanh soft-capping, a custom scale, a
// value width Dv that may differ from the key width Dk, and query rows that
// start at position q_offset (query row i sits at position q_offset + i:
// a slice of a longer query, such as one rank's rows of a query chunk
// when the rows are split over a mesh). It takes Dk, Dv
// <= 256, and MLA's absorbed latent heads: Dk and Dv that round up to 288
// and 256 (minicpm3-4b's kv_lora 256 + rope 32 keys over kv_lora 256
// values, one KV head) or to 576 and 512 (deepseek-v2's kv_lora 512 + rope
// 64 over kv_lora 512); kMaxHeadDim and FLASH_WIDE_PAIRS are the one list
// of both.
//
// Layout: q (B, Sq, H, Dk), k (B, Skv, KV, Dk), v (B, Skv, KV, Dv), read
// through their strides with the last dim contiguous; o (B, Sq, H, Dv).
// Ragged Sq and Skv are masked here, never padded in memory.
//
// The TPU kernel walks a sequential grid axis over KV tiles and carries
// its accumulator in VMEM scratch. Here one thread block owns one (b, h,
// query tile) and loops over KV tiles itself. KV tiles that the causal or
// window mask empties for the whole query tile are skipped; skipping is
// exact, since such a tile would add exp(NEG_INF - m) = 0 to every row
// that has a valid key. Query tiles run heaviest (latest, under the
// causal mask) first: in the f32 kernel within each (b, h); in the bf16
// kernel across groups of (b, h) pairs whose K and V fit in L2 together,
// so that no long tile starts last and leaves the card idle at the end.
// Masking uses the finite NEG_INF = -2e38 and the max(l, 1e-37) clamp of
// the reference: with -INFINITY a fully masked tile gives inf - inf =
// NaN. A row with no valid key at all (only possible when a window ends
// before key 0 of a shorter KV sequence) is not defined by either
// version. The two dtypes take two kernels.
//
// Value widths past 256 are split across blocks: a grid axis of Dv / 256
// value slices, each block computing the whole of S = Q K^T and the
// softmax but staging and writing only its slice's 256 value columns, so
// that the output accumulator keeps 128 registers a lane (512 columns
// would take 256, more than a thread has). Both slices of a row compute
// the same S and P bit for bit, so its two halves use the same weights;
// the price is Q K^T computed once a slice.
//
// f32 (`flash_f32_kernel`), on the f32 CUDA cores (TF32 would miss the
// f32 limits): a block owns 32 query rows and loops over 64-key tiles.
// Each KV tile is staged in shared memory as f32 (K rows padded to an odd
// stride, so lanes reading different rows hit different banks; a key
// wider than kF32KChunk = 288 is staged in chunks of that width, one
// after the other, for the shared memory); the Q tile is staged once.
// Each of the 4 warps owns 8 query rows: a lane scores keys `lane` and
// `lane + 32` against all 8 rows, the row max and sum are warp shuffles,
// and for P V a lane keeps output columns `lane + 32 i` of the 8 rows in
// registers while the probabilities are broadcast by shuffles.
//
// bf16 (`flash_bf16_kernel`): FlashAttention-2's design on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 sums; mma_sm90.cuh). A
// block of 4 warps owns 64 query rows, 16 a warp. The kernel is a
// template over DK and DV, the key and value widths padded with zeros to
// a multiple of 16 in shared memory: Dk <= 256 and Dv <= 256 both take
// D = DK = DV, the next multiple of 16 of the larger; MLA's pair takes
// DK 288 and DV 256, so the output accumulator stays at DV's 128
// registers a lane and only the Q K^T loop runs over DK. The Q tile is
// staged once and goes into registers as A fragments through ldmatrix
// (at DK > 192 it stays in shared memory, for the registers). K and V
// tiles of 64 keys (32 when DK or DV > 160, for the registers) stream
// through a 2-stage
// ring filled by 16-byte cp.async, the next tile's copies in flight
// during the current one's products. Rows are padded by 8 bf16 (an odd
// number of 16-byte units), so ldmatrix hits no bank conflict. Each KV
// tile, a warp: (1) S = Q K^T into f32 registers, K's B fragments by
// ldmatrix; (2) the scale, the soft-cap and, only on a tile that one
// needs, the masks, at the (qpos, kpos) of each accumulator element, in
// log2 units; (3) the online softmax, its row max over the 4 lanes of a
// quad by __shfl_xor_sync 1 and 2 (each lane keeps a partial row sum,
// summed over the quad once at the end), exponentials by ex2.approx;
// (4) P turned in registers from the accumulator layout into A
// fragments; (5) O += P V, V's B fragments by ldmatrix.trans. The
// reference keeps P in f32. Up to head dim 128 (kSplitP) P is split into
// bf16 hi + lo (hi = bf16(P), lo = bf16(P - hi)) and O += P_lo V + P_hi
// V: ~2^-17 a probability, for twice the P V products. One bf16 P rounds
// each probability by up to 2^-9, which a 48-layer random bf16 encoder
// (hubert-xlarge, head dim 80) carries on to its logits beyond the plain
// version's own spread (PERF.md). Wider heads keep one bf16 P: with the
// split, the instances at 160, 256 and MLA's heads spill registers, and
// without it they read within their limits (PERF.md). A row stride, head
// stride or base that is not 16-byte aligned, or a head dim that is not a
// multiple of 8, takes an element-by-element load into the same tiles, a
// branch of this kernel.
//
// What bounds it on an H100: at the smollm-360m prefill shape (B=4,
// S=1024, H=15, KV=5, D=64, bf16, causal) the work is ~8 GFLOP against
// ~21 MB of q/k/v/o, ~380 FLOP per byte, above the card's ~295 FLOP/byte
// ridge: bound by operations (989 TFLOP/s through wgmma, which mma.sync
// does not reach). At zamba2-2.7b's (B=4, S=1024, H=KV=32, D=160) the
// bytes bound it. At minicpm3-4b's MLA shape (B=4, S=1024, H=40, KV=1,
// Dk 288, Dv 256) ~91 GFLOP against ~182 MB, ~500 FLOP per byte: bound
// by operations; its one KV head is read by all 40 heads from L2. At
// deepseek-v2's (B=4, S=1024, H=128, KV=1, Dk 576, Dv 512) ~585 GFLOP
// against ~1.15 GB, bound by operations (0.59 ms); the value split
// computes Q K^T twice, which the bound counts once.
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
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, KV, Dk, Dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;                 // window <= 0: none
  int q_offset;                       // the position of query row 0
  float softcap, scale;               // softcap <= 0: none
  // bf16 only: 16-byte rows in, 4-byte pairs out; (b, h) pairs a group
  // of the block order, and B.
  bool vec_q, vec_k, vec_v, vec_o;
  int group, B;
};

// ---- f32 on the CUDA cores --------------------------------------------

constexpr int kBQ = 32;               // query rows per block
constexpr int kBK = 64;               // keys per KV tile (2 per lane)
constexpr int kRows = kBQ / kWarps;   // query rows per warp

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Widest key chunk and value slice of the f32 kernel, for the shared
// memory (at Dk 576: Q 72 KB + a K chunk 72 KB + a V slice 64 KB).
constexpr int kF32KChunk = 288;
constexpr int kF32VSlice = 256;

// NV = ceil(slice width / 32): output columns per lane, kept in registers.
template <int NV>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  const int Dk = p.Dk;
  const int dkc = min(Dk, kF32KChunk);  // key columns staged at a time
  const int ldk = dkc | 1;            // odd row stride: no bank conflicts
  // blockIdx.y = slice * H + h: value slice `slice` of head h.
  const int h = blockIdx.y % p.H, slice = blockIdx.y / p.H;
  const int Dv = min(kF32VSlice, p.Dv - slice * kF32VSlice);
  float* qs = smem;                   // kBQ x Dk
  float* ks = qs + kBQ * Dk;          // kBK x ldk
  float* vs = ks + kBK * ldk;         // kBK x Dv

  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kRows;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh + slice * kF32VSlice;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
              slice * kF32VSlice;

  for (int i = tid; i < kBQ * Dk; i += kThreads) {
    const int r = i / Dk, d = i - r * Dk, qi = q0 + r;
    qs[i] = qi < p.Sq ? qg[qi * p.q_ss + d] : 0.f;
  }

  // KV range that any row of this query tile can see (positions are
  // q_offset on from the tile's rows).
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, p.q_offset + min(q0 + kBQ, p.Sq));
  if (p.window > 0) kv_lo = max(0, p.q_offset + q0 - p.window + 1);

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    // Scores of keys (lane, lane + 32) against the warp's 8 rows, over
    // the key's chunks in order (one chunk up to Dk 288).
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d0 = 0; d0 < Dk; d0 += dkc) {
      const int w = min(dkc, Dk - d0);
      __syncthreads();                // last chunk or tile consumed
      for (int i = tid; i < kBK * w; i += kThreads) {
        const int r = i / w, d = i - r * w, kj = k0 + r;
        ks[r * ldk + d] = kj < p.Skv ? kg[kj * p.k_ss + d0 + d] : 0.f;
      }
      if (d0 == 0) {
        for (int i = tid; i < kBK * Dv; i += kThreads) {
          const int r = i / Dv, d = i - r * Dv, kj = k0 + r;
          vs[i] = kj < p.Skv ? vg[kj * p.v_ss + d] : 0.f;
        }
      }
      __syncthreads();
      const float* ka = ks + lane * ldk;
      const float* kb = ks + (lane + 32) * ldk;
      const float* qw = qs + r0 * Dk + d0;
      for (int d = 0; d < w; ++d) {
        const float x0 = ka[d], x1 = kb[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qv = qw[r * Dk + d];
          s[r][0] = fmaf(qv, x0, s[r][0]);
          s[r][1] = fmaf(qv, x1, s[r][1]);
        }
      }
    }

    // Mask, online softmax; s becomes the tile's probabilities.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r, qpos = p.q_offset + qi;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        float x = s[r][c] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Skv && qi < p.Sq;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[r][c] = ok ? x : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      s[r][0] = p0;
      s[r][1] = p1;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[r][i] *= alpha;
    }

    // acc += P V; probability of key j of row r sits in lane j % 32.
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      for (int jj = 0; jj < 32; ++jj) {
        const float* vrow = vs + (32 * c + jj) * Dv;
        float vv[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < Dv ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(kFull, s[r][c], jj);
#pragma unroll
          for (int i = 0; i < NV; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < Dv) og[qi * p.o_ss + d] = acc[r][i] / den;
    }
  }
}

template <int NV>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const int dv = p.Dv < kF32VSlice ? p.Dv : kF32VSlice;
  const int dkc = p.Dk < kF32KChunk ? p.Dk : kF32KChunk;
  const size_t smem =
      sizeof(float) * (size_t(kBQ) * p.Dk + size_t(kBK) * (dkc | 1) +
                       size_t(kBK) * dv);
  auto* fn = flash_f32_kernel<NV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int slices = (p.Dv + kF32VSlice - 1) / kF32VSlice;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H * slices, B);
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int B, cudaStream_t stream) {
  switch (((p.Dv < kF32VSlice ? p.Dv : kF32VSlice) + 31) / 32) {
    case 1: return launch_f32<1>(p, B, stream);
    case 2: return launch_f32<2>(p, B, stream);
    case 3: return launch_f32<3>(p, B, stream);
    case 4: return launch_f32<4>(p, B, stream);
    case 5: return launch_f32<5>(p, B, stream);
    case 6: return launch_f32<6>(p, B, stream);
    case 7: return launch_f32<7>(p, B, stream);
    case 8: return launch_f32<8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 on the tensor cores -----------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kBQ16 = 16 * kWarps;    // query rows a block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
// K and V bytes of the (b, h) pairs whose blocks run together (see
// dispatch_bf16): about half of the H100's 50 MB L2. At zamba2-2.7b's
// prefill shape (128 pairs, 4 groups) this order takes ~4% less time than
// one heaviest-first order over all pairs (PERF.md, Findings).
constexpr long long kL2Budget = 24ll << 20;

// 2^x; 0 for the masked scores (NEG_INF in either unit).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DK, DV: Dk and Dv padded to a multiple of 16.
template <int DK, int DV>
struct FlashTiles {
  static constexpr int kD = DK > DV ? DK : DV;
  static constexpr int kBKV = kD <= 160 ? 64 : 32;  // keys per KV tile
  static constexpr bool kQInRegs = DK <= 192;
  // P split into bf16 hi + lo for P V, where the registers leave room
  // for it: one bf16 P at wider heads (their spare registers go to O).
  static constexpr bool kSplitP = kD <= 128;
  static constexpr int kLdK = DK + 8;               // smem row stride, Q, K
  static constexpr int kLdV = DV + 8;               // ... V
  static constexpr int kQ = kBQ16 * kLdK;           // bf16 in the Q tile
  static constexpr int kK = kBKV * kLdK;            // ... in a K tile
  static constexpr int kV = kBKV * kLdV;            // ... in a V tile
  static constexpr size_t kSmem = sizeof(bf16) * (kQ + 2 * kK + 2 * kV);
};

// Stages rows r0 .. r0 + R - 1 (those below `rows`) of a (rows, cols)
// bf16 matrix with row stride `ld` into an R x W shared tile of row
// stride W + 8; columns past `cols` and rows past `rows` become zeros.
// With `vec` each 16-byte chunk is one cp.async (zero-filled when out of
// range; `cols` is then a multiple of 8, so no chunk is partial);
// otherwise element by element through registers.
template <int R, int W>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ld, int rows, int r0,
                                           int cols, bool vec, int tid) {
  constexpr int kChunks = W / 8, kLd = W + 8;
  for (int i = tid; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8, gr = r0 + r;
    bf16* d = dst + r * kLd + c;
    const bf16* s = src + gr * ld + c;
    if (vec) {
      const bool ok = gr < rows && c < cols;
      mma::cp_async_16(mma::smem_addr(d), ok ? s : src, ok);
    } else {
      alignas(16) bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = gr < rows && c + j < cols ? s[j] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const Params p) {
  using Tiles = FlashTiles<DK, DV>;
  constexpr int kBKV = Tiles::kBKV;
  constexpr int kLdK = Tiles::kLdK, kLdV = Tiles::kLdV;
  constexpr int KT = DK / 16;     // k16 steps of Q K^T over the key width
  constexpr int NS = kBKV / 8;    // n-tiles of S (8 keys each)
  constexpr int NO = DV / 8;      // n-tiles of O (8 value dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tiles::kQ;          // 2 stages
  bf16* vs = ks + 2 * Tiles::kK;      // 2 stages

  // Blocks run in groups of p.group (b, h) pairs, whose K and V fit in
  // L2 together; inside a group, query tiles heaviest (latest, under the
  // causal mask) first across all its pairs, so that no long tile starts
  // last.
  const int n_qt = (p.Sq + kBQ16 - 1) / kBQ16;
  const int pairs = p.B * p.H, per_group = p.group * n_qt;
  const int grp = blockIdx.x / per_group;
  const int in_grp = blockIdx.x - grp * per_group;
  const int grp_pairs = min(p.group, pairs - grp * p.group);
  const int pair = grp * p.group + in_grp % grp_pairs;
  const int q0 = (n_qt - 1 - in_grp / grp_pairs) * kBQ16;
  const int h = pair % p.H, b = pair / p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qw0 = q0 + 16 * warp;     // this warp's first query row
  const int pw0 = p.q_offset + qw0;   // and its position
  // This block's value slice: columns DV * blockIdx.y on, dv of them.
  const int dv0 = DV * static_cast<int>(blockIdx.y);
  const int dv = min(DV, p.Dv - dv0);

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh + dv0;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + dv0;

  // KV range that any row of this query tile can see (positions are
  // q_offset on from the tile's rows).
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, p.q_offset + min(q0 + kBQ16, p.Sq));
  if (p.window > 0) kv_lo = max(0, p.q_offset + q0 - p.window + 1);
  const int n_kv = kv_hi > kv_lo ? (kv_hi - kv_lo + kBKV - 1) / kBKV : 0;

  auto load_kv = [&](int t) {
    const int k0 = kv_lo + t * kBKV, s = t % 2;
    stage_rows<kBKV, DK>(ks + s * Tiles::kK, kg, p.k_ss, p.Skv, k0, p.Dk,
                         p.vec_k, tid);
    stage_rows<kBKV, DV>(vs + s * Tiles::kV, vg, p.v_ss, p.Skv, k0, dv,
                         p.vec_v, tid);
  };

  stage_rows<kBQ16, DK>(qs, qg, p.q_ss, p.Sq, q0, p.Dk, p.vec_q, tid);
  mma::cp_async_commit();
  if (n_kv > 0) load_kv(0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();            // the Q tile has landed
  __syncthreads();

  // ldmatrix row addresses of this lane (mma_sm90.cuh): A (Q) and the
  // transposed B (V) take row lane % 16 at column offset 8 (lane / 16); K,
  // an n-major B, takes key row (lane % 8) + 8 (lane / 16) at dim offset
  // 8 ((lane / 8) % 2).
  const int lrow = lane % 16, lcol = 8 * (lane / 16);
  const int krow = lane % 8 + 8 * (lane / 16), kcol = 8 * ((lane / 8) % 2);
  const bf16* q_lane = qs + (16 * warp + lrow) * kLdK + lcol;

  uint32_t qf[Tiles::kQInRegs ? KT : 1][4];
  if constexpr (Tiles::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      mma::ldmatrix_x4(qf[kk], mma::smem_addr(q_lane + 16 * kk));
  }

  // Scores are kept in log2 units: x * log2(e), so exp2 gives the
  // probabilities; NEG_INF marks a masked score in either unit.
  const bool capped = p.softcap > 0.f;
  const float s_mul = capped ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap_mul = p.softcap * kLog2e;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Running max and (this lane's part of the) sum of rows g and g + 8.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = kv_lo + t * kBKV;
    if (t + 1 < n_kv) load_kv(t + 1);   // lands during this tile's sums
    mma::cp_async_commit();
    mma::cp_async_wait<1>();            // tile t has landed
    __syncthreads();
    const bf16* kst = ks + (t % 2) * Tiles::kK;
    const bf16* vst = vs + (t % 2) * Tiles::kV;

    // (1) S = Q K^T.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      if constexpr (Tiles::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        mma::ldmatrix_x4(qa, mma::smem_addr(q_lane + 16 * kk));
      }
      uint32_t r[NS / 2][4];
#pragma unroll
      for (int j = 0; j < NS; j += 2)
        mma::ldmatrix_x4(r[j / 2], mma::smem_addr(
            kst + (8 * j + krow) * kLdK + 16 * kk + kcol));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        mma::mma_bf16_16816(s[j], qa, r[j / 2][0], r[j / 2][1]);
        mma::mma_bf16_16816(s[j + 1], qa, r[j / 2][2], r[j / 2][3]);
      }
    }

    // (2) Scale, soft-cap, masks (on tiles that reach past Skv, the
    // diagonal or the window's edge for some row of this warp). Each
    // branch is uniform over the warp and taken once a tile, outside the
    // unrolled loops: inside them the compiler would predicate the
    // soft-cap's tanh and the masks onto every tile.
    if (capped) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = cap_mul * tanhf(s[j][e] * s_mul);
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= s_mul;
    }
    if (k0 + kBKV > p.Skv || (p.causal && k0 + kBKV - 1 > pw0) ||
        (p.window > 0 && k0 <= pw0 + 15 - p.window)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = pw0 + mma::frag_row(lane, e);
          const int kpos = k0 + 8 * j + mma::frag_col(lane, e);
          bool ok = kpos < p.Skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) s[j][e] = kNegInf;
        }
    }

    // (3) Online softmax over rows g (elements 0, 1) and g + 8 (2, 3).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float alpha = exp2_approx(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2_approx(s[j][e] - mx);
          sum += s[j][e];
        }
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // (4) + (5) O += P V, P's A fragments packed from S's accumulators
    // (with kSplitP each f32 probability split into bf16 hi + lo, two
    // mma, ~16 bits of P where one bf16 keeps 8): keys 16 kk .. 16 kk +
    // 15 are S n-tiles 2 kk (k 0-7) and 2 kk + 1.
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = s[2 * kk + h][2 * e], p1 = s[2 * kk + h][2 * e + 1];
          if constexpr (Tiles::kSplitP)
            mma::split_bf16(p0, p1, ph[2 * h + e], pl[2 * h + e]);
          else
            ph[2 * h + e] = mma::pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, mma::smem_addr(
            vst + (16 * kk + lrow) * kLdV + 8 * j + lcol));
        if constexpr (Tiles::kSplitP) {
          mma::mma_bf16_16816(o[j], pl, r[0], r[1]);
          mma::mma_bf16_16816(o[j + 1], pl, r[2], r[3]);
        }
        mma::mma_bf16_16816(o[j], ph, r[0], r[1]);
        mma::mma_bf16_16816(o[j + 1], ph, r[2], r[3]);
      }
    }
    __syncthreads();                    // stage t % 2 free for tile t + 2
  }
  mma::cp_async_wait<0>();              // no copy outlives the block

  // Epilogue: the quad's partial row sums, the clamp, one rounding.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(kFull, den, 1);
    den += __shfl_xor_sync(kFull, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-37f);
    const int qi = qw0 + mma::frag_row(lane, 2 * r);
    if (qi >= p.Sq) continue;
    bf16* orow = og + qi * p.o_ss;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + mma::frag_col(lane, 0);
      const float v0 = o[j][2 * r] * inv, v1 = o[j][2 * r + 1] * inv;
      if (p.vec_o && d + 1 < dv) {
        *reinterpret_cast<uint32_t*>(orow + d) = mma::pack_bf16(v0, v1);
      } else {
        if (d < dv) orow[d] = __float2bfloat16(v0);
        if (d + 1 < dv) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// A value width DV past 256 runs as flash_bf16_kernel<DK, 256> over a
// grid axis of DV / 256 value slices (<576, 512>: Q 74,752 B + K 2 x
// 37,376 + V 2 x 16,896 = 183,296 B of shared memory).
template <int DK, int DV = DK>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int DVS = DV > 256 ? 256 : DV;
  constexpr size_t smem = FlashTiles<DK, DVS>::kSmem;
  auto* fn = flash_bf16_kernel<DK, DVS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks =
      static_cast<long long>((p.Sq + kBQ16 - 1) / kBQ16) * p.H * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), (p.Dv + DVS - 1) / DVS);
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The head dims both kernels take, the one list of them (the wrapper,
// kernel.py, reads these two lines): Dk, Dv <= kMaxHeadDim (the bf16
// kernel's <D, D> instances, D the larger rounded up to 16), and the
// (DK, DV) pairs, rounded up to 16, of FLASH_WIDE_PAIRS, each its own
// launch: MLA's latent heads, minicpm3-4b's (256 + 32 rope keys over 256
// values, the <288, 256> instance) and deepseek-v2's (512 + 64 rope keys
// over 512 values, <576, 256> over two value slices).
constexpr int kMaxHeadDim = 256;
#define FLASH_WIDE_PAIRS(X) X(288, 256) X(576, 512)

int up16(int d) { return (d + 15) / 16 * 16; }

bool wide_pair(int Dk, int Dv) {
#define FLASH_IS_PAIR(DK, DV) \
  if (up16(Dk) == DK && up16(Dv) == DV) return true;
  FLASH_WIDE_PAIRS(FLASH_IS_PAIR)
#undef FLASH_IS_PAIR
  return false;
}

bool supported_dims(int Dk, int Dv) {
  return Dk > 0 && Dv > 0 &&
         ((Dk <= kMaxHeadDim && Dv <= kMaxHeadDim) || wide_pair(Dk, Dv));
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<std::uintptr_t>(ptr) % bytes == 0;
}

// 16-byte row copies need a 16-byte base, strides of whole 16-byte units
// and a width of whole 8-element chunks.
bool rows16(const void* ptr, long long sb, long long ss, long long sh,
            int width) {
  return aligned(ptr, 16) && sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0 &&
         width % 8 == 0;
}

cudaError_t dispatch_bf16(Params p, int B, cudaStream_t stream) {
  // Groups of (b, h) pairs whose K and V fit in kL2Budget together, as
  // even as the count allows.
  const long long pairs = static_cast<long long>(B) * p.H;
  const long long pair_bytes =
      static_cast<long long>(p.Skv) * (p.Dk + p.Dv) * sizeof(bf16);
  const long long fit = kL2Budget / pair_bytes;
  const long long most = fit > 0 ? fit : 1;
  const long long n_groups = (pairs + most - 1) / most;
  p.group = static_cast<int>((pairs + n_groups - 1) / n_groups);
  p.B = B;
  p.vec_q = rows16(p.q, p.q_sb, p.q_ss, p.q_sh, p.Dk);
  p.vec_k = rows16(p.k, p.k_sb, p.k_ss, p.k_sh, p.Dk);
  p.vec_v = rows16(p.v, p.v_sb, p.v_ss, p.v_sh, p.Dv);
  p.vec_o = aligned(p.o, 4) && p.o_sb % 2 == 0 && p.o_ss % 2 == 0 &&
            p.o_sh % 2 == 0;
#define FLASH_LAUNCH_PAIR(DK, DV) \
  if (up16(p.Dk) == DK && up16(p.Dv) == DV) \
    return launch_bf16<DK, DV>(p, B, stream);
  FLASH_WIDE_PAIRS(FLASH_LAUNCH_PAIR)
#undef FLASH_LAUNCH_PAIR
  switch (((p.Dk > p.Dv ? p.Dk : p.Dv) + 15) / 16) {
    case 1: return launch_bf16<16>(p, B, stream);
    case 2: return launch_bf16<32>(p, B, stream);
    case 3: return launch_bf16<48>(p, B, stream);
    case 4: return launch_bf16<64>(p, B, stream);
    case 5: return launch_bf16<80>(p, B, stream);
    case 6: return launch_bf16<96>(p, B, stream);
    case 7: return launch_bf16<112>(p, B, stream);
    case 8: return launch_bf16<128>(p, B, stream);
    case 9: return launch_bf16<144>(p, B, stream);
    case 10: return launch_bf16<160>(p, B, stream);
    case 11: return launch_bf16<176>(p, B, stream);
    case 12: return launch_bf16<192>(p, B, stream);
    case 13: return launch_bf16<208>(p, B, stream);
    case 14: return launch_bf16<224>(p, B, stream);
    case 15: return launch_bf16<240>(p, B, stream);
    case 16: return launch_bf16<256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Sq, int Skv, int H, int KV, int Dk, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int q_offset, float softcap, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || !supported_dims(Dk, Dv))
    return cudaErrorInvalidValue;
  const Params p{q, k, v, o, Sq, Skv, H, KV, Dk, Dv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 causal, window, q_offset, softcap, scale,
                 false, false, false, false, 1, B};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = dispatch_f32(p, B, s);
  else if (dtype == 1) e = dispatch_bf16(p, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
