// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` in src/repro/kernels/flash_attention/kernel.py. It
// computes the same function: softmax(scale * Q K^T) V with f32
// accumulation and an online softmax (running max, running denominator),
// GQA (query head h reads KV head h / (H / KV)), causal and sliding-window
// masks (kpos > qpos - window), tanh soft-capping, a custom scale, and a
// value width Dv that may differ from the key width Dk (both <= 256).
//
// Layout: q (B, Sq, H, Dk), k (B, Skv, KV, Dk), v (B, Skv, KV, Dv), read
// through their strides with the last dim contiguous; o (B, Sq, H, Dv).
// Ragged Sq and Skv are masked here, never padded in memory.
//
// Design. The TPU kernel walks a sequential grid axis over KV tiles and
// carries its accumulator in VMEM scratch. Here one thread block owns one
// (b, h, 32-row query tile) and loops over 64-key KV tiles itself. Each
// KV tile is staged in shared memory as f32 (K rows padded to an odd
// stride, so lanes reading different rows hit different banks); the Q
// tile is staged once. Each of the 4 warps owns 8 query rows: a lane
// scores keys `lane` and `lane + 32` against all 8 rows, the row max and
// sum are warp shuffles, and for P V a lane keeps output columns
// `lane + 32 i` of the 8 rows in registers while the probabilities are
// broadcast by shuffles. KV tiles that the causal or window mask empties
// for the whole query tile are skipped; skipping is exact, since such a
// tile would add exp(NEG_INF - m) = 0 to every row that has a valid key.
// Query tiles run heaviest (latest, under the causal mask) first.
//
// Masking uses the finite NEG_INF = -2e38 and the max(l, 1e-37) clamp of
// the reference: with -INFINITY a fully masked tile gives inf - inf = NaN.
// A row with no valid key at all (only possible when a window ends before
// key 0 of a shorter KV sequence) is not defined by either version.
//
// What bounds it on an H100: at the smollm-360m prefill shape (B=4,
// S=1024, H=15, KV=5, D=64, bf16, causal) the work is ~8 GFLOP against
// ~21 MB of q/k/v/o, ~380 FLOP per byte, above the card's ~295 FLOP/byte
// ridge: compute bound. This first version does its products on the f32
// CUDA cores from shared memory (no tensor cores), so it sits far from
// that bound; mma.sync / wgmma tiles and TMA loads are the next steps.
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;               // query rows per block
constexpr int kBK = 64;               // keys per KV tile (2 per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
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
  float softcap, scale;               // softcap <= 0: none
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// NV = ceil(Dv / 32): output columns per lane, kept in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int Dk = p.Dk, Dv = p.Dv;
  const int ldk = Dk | 1;             // odd row stride: no bank conflicts
  float* qs = smem;                   // kBQ x Dk
  float* ks = qs + kBQ * Dk;          // kBK x ldk
  float* vs = ks + kBK * ldk;         // kBK x Dv

  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kRows;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * Dk; i += kThreads) {
    const int r = i / Dk, d = i - r * Dk, qi = q0 + r;
    qs[i] = qi < p.Sq ? to_f32(qg[qi * p.q_ss + d]) : 0.f;
  }

  // KV range that any row of this query tile can see.
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kBQ, p.Sq));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();                  // last tile consumed; Q tile visible
    for (int i = tid; i < kBK * Dk; i += kThreads) {
      const int r = i / Dk, d = i - r * Dk, kj = k0 + r;
      ks[r * ldk + d] = kj < p.Skv ? to_f32(kg[kj * p.k_ss + d]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, d = i - r * Dv, kj = k0 + r;
      vs[i] = kj < p.Skv ? to_f32(vg[kj * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // Scores of keys (lane, lane + 32) against the warp's 8 rows.
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = ks + lane * ldk;
    const float* kb = ks + (lane + 32) * ldk;
    const float* qw = qs + r0 * Dk;
    for (int d = 0; d < Dk; ++d) {
      const float x0 = ka[d], x1 = kb[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * Dk + d];
        s[r][0] = fmaf(qv, x0, s[r][0]);
        s[r][1] = fmaf(qv, x1, s[r][1]);
      }
    }

    // Mask, online softmax; s becomes the tile's probabilities.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        float x = s[r][c] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Skv && qpos < p.Sq;
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
      if (d < Dv) store(og + qi * p.o_ss + d, acc[r][i] / den);
    }
  }
}

template <typename T, int NV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(kBQ) * p.Dk + size_t(kBK) * (p.Dk | 1) +
                       size_t(kBK) * p.Dv);
  auto* fn = flash_fwd_kernel<T, NV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  fn<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  switch ((p.Dv + 31) / 32) {
    case 1: return launch<T, 1>(p, B, stream);
    case 2: return launch<T, 2>(p, B, stream);
    case 3: return launch<T, 3>(p, B, stream);
    case 4: return launch<T, 4>(p, B, stream);
    case 5: return launch<T, 5>(p, B, stream);
    case 6: return launch<T, 6>(p, B, stream);
    case 7: return launch<T, 7>(p, B, stream);
    case 8: return launch<T, 8>(p, B, stream);
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
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      Dk <= 0 || Dk > 256 || Dv <= 0 || Dv > 256)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, o, Sq, Skv, H, KV, Dk, Dv,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 causal, window, softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) e = dispatch<float>(p, B, s);
  else if (dtype == 1) e = dispatch<__nv_bfloat16>(p, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
