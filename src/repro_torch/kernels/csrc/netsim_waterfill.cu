// Batched flow-level NoP simulation (max-min fair waterfilling, event by
// event) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package runs this as
// `waterfill_rates` (src/repro/core/netsim_jax.py:43) inside
// `waterfill_times` (:79) under `vmap`, two nested `lax.while_loop`s
// that XLA compiles into one loop on the device; the evaluator's
// congestion="flow" mode traces it per op inside its jit. Eager PyTorch
// has no such loop: the number of events and of waterfilling rounds
// depends on the data, so the plain version (netsim/ref.py) waits for
// the device once per round. Here one block runs one simulation's whole
// event loop, and every simulation of a call (a sweep's grid, or the
// P x n_ops x 2 phases of an evaluator call) is one launch.
//
// What is simulated (core/netsim.py `simulate_flows`): F flows, each
// with a fixed route over L links of given capacity, start together
// with their bytes. Each event solves the max-min fair rates by
// progressive filling (each round: the link of least fair share
// residual / users among the links that unfixed flows still cross,
// ties to the lowest link index as np.argmin; its flows are fixed at
// that share and their share is taken off every link they cross), then
// advances to the next completion, and retires flows under EPS_BYTES.
//
// Layout: one thread per flow (F <= 1024), its bytes left, rate and
// done time in registers and its route in shared memory as an int32
// list (ascending, padded with -1). Per link in shared memory: residual
// capacity, the count of unfixed flows on it (shared-memory integer
// atomics over the routes) and the count of flows fixed in the last
// round. A round: each thread applies the last round's fixes to its
// strided links (residual = max(residual - count * share, 0)) and takes
// their least share; a warp shuffle and a shared exchange give every
// thread the block's argmin; the unfixed flows on that link fix their
// rate and count themselves off their links' users. Two block barriers
// a round, two more an event.
//
// Numerics: counts are exact integers, and every float64 operation is
// the numpy engine's, in its order, each rounded once (__dmul_rn,
// __dsub_rn, __ddiv_rn, __dadd_rn: nvcc may not contract them into an
// FMA), with no fast-math. So `latency` and `done` are bit-identical to
// the numpy engine and to the plain version; `link_bytes` is summed by
// atomics in another order. A simulation that stalls at zero rate or
// outlasts MAX_EVENTS reports NaN (the numpy engine raises), as the JAX
// engine does.
//
// What bounds it: the rounds of one simulation depend on each other, so
// its chain of rounds (at the latency of the block's barriers and
// exchanges) is the floor, and blocks run side by side up to the card's
// resident limit; the bytes (capacities, routes and bytes in, done times
// out) are far below that. `netsim_round_probe` runs the chain of empty
// block-argmin rounds with no links or flows: its time per round is the
// bound's measured round latency (PERF.md).
//
// C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxFlows = 1024;
constexpr double kEpsBytes = 1e-6;   // core/netsim.py EPS_BYTES
constexpr int kMaxEvents = 10000;    // core/netsim.py MAX_EVENTS

int threads_for(int F) { return F <= 32 ? 32 : (F + 31) / 32 * 32; }

size_t smem_bytes(int F, int L, int R) {
  return static_cast<size_t>(L + 32) * sizeof(double) +
         (static_cast<size_t>(2) * L + 32 + static_cast<size_t>(F) * R) *
             sizeof(int);
}

// np.argmin's order: the smaller value, ties to the lower index.
__device__ __forceinline__ bool before(double v, int i, double bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmin(double& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// caps (N, L); routes (N, F, R); msgs, done (N, S, F); latency, rounds
// (N, S); link_bytes (N, S, L), zeroed by the caller, or null. Block b
// is simulation b % S of network b / S.
__global__ void __launch_bounds__(kMaxFlows)
netsim_waterfill_kernel(const double* __restrict__ caps,
                        const int* __restrict__ routes,
                        const double* __restrict__ msgs,
                        double* __restrict__ latency,
                        double* __restrict__ done,
                        double* __restrict__ link_bytes,
                        int* __restrict__ rounds_out, int S, int F, int L,
                        int R) {
  extern __shared__ double smem[];
  double* s_res = smem;                                   // [L]
  double* s_part_v = s_res + L;                           // [32]
  int* s_users = reinterpret_cast<int*>(s_part_v + 32);   // [L]
  int* s_fixed = s_users + L;                             // [L]
  int* s_part_i = s_fixed + L;                            // [32]
  int* s_route = s_part_i + 32;                           // [F * R]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const double* cap = caps + static_cast<size_t>(b / S) * L;
  const int* rt = routes + static_cast<size_t>(b / S) * F * R;
  for (int i = tid; i < F * R; i += nthr) s_route[i] = rt[i];

  const bool owner = tid < F;
  const int* my = s_route + static_cast<size_t>(owner ? tid : 0) * R;
  double bl = owner ? msgs[static_cast<size_t>(b) * F + tid] : 0.0;
  double rate = 0.0;
  double t_done = 0.0;
  double* lb = link_bytes ? link_bytes + static_cast<size_t>(b) * L
                          : nullptr;
  __syncthreads();
  int len = 0;
  if (owner)
    while (len < R && my[len] >= 0) ++len;

  double t = 0.0;
  int events = 0;
  int rounds = 0;
  bool bad = false;
  for (;;) {
    // ---- event: reset the links, count the active flows on them
    for (int l = tid; l < L; l += nthr) {
      s_res[l] = cap[l];
      s_users[l] = 0;
      s_fixed[l] = 0;
    }
    __syncthreads();
    const bool active = owner && bl > kEpsBytes;
    bool unfixed = active;
    rate = 0.0;
    if (active)
      for (int k = 0; k < len; ++k) atomicAdd(&s_users[my[k]], 1);
    if (!__syncthreads_or(active)) break;
    if (++events > kMaxEvents) {
      bad = true;
      break;
    }

    // ---- waterfilling rounds (the numpy engine's L + 1 at most)
    double share = 0.0;
    for (int it = 0; it <= L; ++it) {
      double bv = CUDART_INF;
      int bi = INT_MAX;
      int live = 0;
      for (int l = tid; l < L; l += nthr) {
        const int c = s_fixed[l];
        if (c) {
          s_res[l] = fmax(
              __dsub_rn(s_res[l], __dmul_rn(static_cast<double>(c), share)),
              0.0);
          s_fixed[l] = 0;
        }
        const int u = s_users[l];
        double v = CUDART_INF;
        if (u > 0) {
          v = __ddiv_rn(s_res[l], static_cast<double>(u));
          live = 1;
        }
        if (before(v, l, bv, bi)) {
          bv = v;
          bi = l;
        }
      }
      warp_argmin(bv, bi);
      if (lane == 0) {
        s_part_v[warp] = bv;
        s_part_i[warp] = bi;
      }
      if (!__syncthreads_or(live)) break;
      bv = CUDART_INF;
      bi = INT_MAX;
      for (int w = 0; w < nwarps; ++w)
        if (before(s_part_v[w], s_part_i[w], bv, bi)) {
          bv = s_part_v[w];
          bi = s_part_i[w];
        }
      share = bv;
      ++rounds;
      if (unfixed) {
        bool on = false;
        for (int k = 0; k < len && my[k] <= bi; ++k) on |= my[k] == bi;
        if (on) {
          rate = share;
          unfixed = false;
          for (int k = 0; k < len; ++k) {
            atomicAdd(&s_fixed[my[k]], 1);
            atomicSub(&s_users[my[k]], 1);
          }
        }
      }
      __syncthreads();
    }

    // ---- advance to the next completion
    const bool pos = active && rate > 0.0;
    const double until = warp_min(pos ? __ddiv_rn(bl, rate) : CUDART_INF);
    if (lane == 0) s_part_v[warp] = until;
    if (!__syncthreads_or(pos)) {
      bad = true;  // stalled: no active flow has a positive rate
      break;
    }
    double dt = CUDART_INF;
    for (int w = 0; w < nwarps; ++w) dt = fmin(dt, s_part_v[w]);
    if (active) {
      const double moved = __dmul_rn(rate, dt);
      if (lb) {
        const double m = fmin(moved, bl);
        for (int k = 0; k < len; ++k) atomicAdd(&lb[my[k]], m);
      }
      bl = fmax(__dsub_rn(bl, moved), 0.0);
      if (bl <= kEpsBytes) t_done = __dadd_rn(t, dt);
    }
    t = __dadd_rn(t, dt);
  }

  if (tid == 0) {
    latency[b] = bad ? CUDART_NAN : t;
    rounds_out[b] = rounds;
  }
  if (owner) done[static_cast<size_t>(b) * F + tid] = bad ? CUDART_NAN : t_done;
  if (lb && bad) {
    __syncthreads();  // every atomic add lands before the NaN stores
    for (int l = tid; l < L; l += nthr) lb[l] = CUDART_NAN;
  }
}

// The chain of `rounds` empty rounds of netsim_waterfill_kernel (a warp
// argmin, the shared exchange behind a block barrier with a vote, every
// thread's pass over the warps' minima, a second barrier) with no links
// or flows: its time per round is the latency floor of one round.
__global__ void __launch_bounds__(kMaxFlows)
netsim_round_probe_kernel(double* __restrict__ out, int rounds) {
  __shared__ double s_part_v[32];
  __shared__ int s_part_i[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  double v = static_cast<double>(tid);
  int i = tid;
  for (int r = 0; r < rounds; ++r) {
    double bv = v;
    int bi = i;
    warp_argmin(bv, bi);
    if (lane == 0) {
      s_part_v[warp] = bv;
      s_part_i[warp] = bi;
    }
    if (!__syncthreads_or(bi >= 0)) break;
    bv = CUDART_INF;
    bi = INT_MAX;
    for (int w = 0; w < nwarps; ++w)
      if (before(s_part_v[w], s_part_i[w], bv, bi)) {
        bv = s_part_v[w];
        bi = s_part_i[w];
      }
    v = bv + static_cast<double>((tid + r) & 1);
    i = (bi + tid) & 1023;
    __syncthreads();
  }
  if (tid == 0) out[0] = v + i;
}

}  // namespace

extern "C" int netsim_waterfill(const void* caps, const void* routes,
                                const void* msgs, void* latency, void* done,
                                void* link_bytes, void* rounds, int N, int S,
                                int F, int L, int R, void* stream) {
  if (N <= 0 || S <= 0 || F <= 0 || L <= 0 || R <= 0 || F > kMaxFlows)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(N) * S > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, L, R);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        netsim_waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  netsim_waterfill_kernel<<<N * S, threads_for(F), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(caps), static_cast<const int*>(routes),
      static_cast<const double*>(msgs), static_cast<double*>(latency),
      static_cast<double*>(done), static_cast<double*>(link_bytes),
      static_cast<int*>(rounds), S, F, L, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int netsim_round_probe(void* out, int rounds, int threads,
                                  void* stream) {
  if (rounds <= 0 || threads < 32 || threads > kMaxFlows || threads % 32)
    return cudaErrorInvalidValue;
  netsim_round_probe_kernel<<<1, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int netsim_blocks_per_sm(int F, int L, int R, int* blocks) {
  if (F <= 0 || F > kMaxFlows || L <= 0 || R <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, L, R);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        netsim_waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, netsim_waterfill_kernel, threads_for(F), smem));
}
