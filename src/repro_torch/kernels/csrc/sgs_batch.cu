// Batched RCPSP list scheduling (the pipeliner's SGS) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package runs this as
// `sgs_instance` under `vmap` (src/repro/core/pipelining_jax.py:62), a
// `lax.fori_loop` of B * L dependent steps that XLA compiles into one
// loop on the device. Eager PyTorch has no such loop: each step of the
// plain version (sgs/ref.py) is some fifteen launches, 53,000 for
// ViT-B/16's 222-job chain at batch 16. So the whole schedule of one
// grid point runs here in one warp, and the G points of a sweep group in
// G warps of one launch.
//
// What is scheduled (DESIGN.md §13): B samples each run the same chain
// of L jobs (in, comp, out per op), job p of the chain on resource
// (0, 1, 0)[p % 3] (0 the NoP, 1 the chiplet array), each resource
// running one job at a time. Since a job's only successor is the next
// job of its chain, the ready set is each sample's frontier (its next
// unscheduled position), and one step of the serial heap SGS dispatches
// the frontier job of highest priority, ties to the smallest job id
// s * L + p (the heap's tie-break), at the later of its chain's ready
// time and its resource's free time. Priorities (the chain's critical
// path, a reversed cumulative sum) come from the host, as the JAX
// package computes them, so every engine compares the same floats.
//
// One warp per grid point; lanes stride over the B samples. Each step:
// every lane takes the best frontier job of its samples (priority -inf
// for a finished sample), a warp max of the priorities and a warp min of
// the job ids among the lanes at that max pick the job, and lane 0
// dispatches it (start, the sample's ready time, its resource's free
// time, the sample's frontier) and the warp syncs. The chain's
// durations and priorities and the per-sample frontiers and ready times
// live in shared memory; the two free times in lane 0's registers.
//
// Only float64 max and + touch the times, in the serial engine's order,
// so makespans and starts are bit-identical to the plain version, to
// the numpy frontier loop and to the serial `list_schedule` (no
// fast-math: none is needed, and none would be allowed).
//
// What bounds it: the B * L steps depend on each other (each dispatch
// moves a frontier that the next step's max reads), so one warp's
// chain of steps, two warp reductions each, is the floor; the bytes
// (durations and priorities in, starts out) and the few operations a
// step are far below it at every sweep shape. `sgs_step_probe` runs the
// same chain of empty warp-reduction steps with no dispatch, and its
// time per step is the bound's measured step latency (PERF.md).
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

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

size_t smem_bytes(int B, int L) {
  return static_cast<size_t>(L) * 2 * sizeof(double) +
         static_cast<size_t>(B) * (sizeof(double) + sizeof(int));
}

// dur, prio (G, L); makespan (G); starts (G, B, L). Block g = point g.
__global__ void __launch_bounds__(32)
sgs_batch_kernel(const double* __restrict__ dur,
                 const double* __restrict__ prio,
                 double* __restrict__ makespan,
                 double* __restrict__ starts, int B, int L) {
  extern __shared__ double smem[];
  double* s_dur = smem;
  double* s_prio = s_dur + L;
  double* s_ready = s_prio + L;
  int* s_ptr = reinterpret_cast<int*>(s_ready + B);
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const double* d = dur + static_cast<size_t>(g) * L;
  const double* pr = prio + static_cast<size_t>(g) * L;
  double* st = starts + static_cast<size_t>(g) * B * L;
  for (int i = lane; i < L; i += 32) {
    s_dur[i] = d[i];
    s_prio[i] = pr[i];
  }
  for (int s = lane; s < B; s += 32) {
    s_ready[s] = 0.0;
    s_ptr[s] = 0;
  }
  __syncwarp();
  double free0 = 0.0, free1 = 0.0;  // lane 0's: NoP, chiplet array
  const int steps = B * L;
  for (int step = 0; step < steps; ++step) {
    // This lane's best frontier job: samples ascend, so the first at the
    // lane's max priority has the smallest job id.
    double best = -CUDART_INF;
    int jid = INT_MAX;
    for (int s = lane; s < B; s += 32) {
      const int p = s_ptr[s];
      if (p < L && s_prio[p] > best) {
        best = s_prio[p];
        jid = s * L + p;
      }
    }
    const double top = warp_max(best);
    const int pick = warp_min(best == top ? jid : INT_MAX);
    if (pick == INT_MAX) break;  // only a NaN priority leaves no pick
    if (lane == 0) {
      const int s = pick / L;
      const int p = pick - s * L;
      const bool comp = (p % 3) == 1;
      const double t0 = fmax(s_ready[s], comp ? free1 : free0);
      const double t1 = t0 + s_dur[p];
      st[static_cast<size_t>(s) * L + p] = t0;
      s_ready[s] = t1;
      s_ptr[s] = p + 1;
      if (comp) free1 = t1;
      else free0 = t1;
    }
    __syncwarp();
  }
  if (lane == 0) makespan[g] = fmax(free0, free1);
}

// The chain of `steps` warp-reduction steps of sgs_batch_kernel (a
// double max and an int min over the warp, then a warp sync) with no
// dispatch: its time per step is the latency floor of one SGS step.
__global__ void __launch_bounds__(32)
sgs_step_probe_kernel(double* __restrict__ out, int steps) {
  const int lane = threadIdx.x;
  double v = static_cast<double>(lane);
  int j = lane;
  for (int step = 0; step < steps; ++step) {
    const double top = warp_max(v);
    j = warp_min(v == top ? j : INT_MAX) + lane;
    v = top - static_cast<double>(j & 1);
    __syncwarp();
  }
  if (lane == 0) out[0] = v + j;
}

}  // namespace

extern "C" int sgs_batch(const void* dur, const void* prio, void* makespan,
                         void* starts, int G, int B, int L, void* stream) {
  if (G <= 0 || B <= 0 || L <= 0) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * L > INT_MAX / 2) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(B, L);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgs_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sgs_batch_kernel<<<G, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(dur), static_cast<const double*>(prio),
      static_cast<double*>(makespan), static_cast<double*>(starts), B, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgs_step_probe(void* out, int steps, void* stream) {
  if (steps <= 0) return cudaErrorInvalidValue;
  sgs_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
