// Order-fixed segmented reduction of sorted runs, written for Hopper (sm_90a).
//
// out[s] = reduce(vals[offsets[s] .. offsets[s + 1])) for s < num_segments,
// by sum, min or max; an empty run holds the reduction's identity (0, +inf,
// -inf). Entries outside [offsets[0], offsets[num_segments]) are never read.
//
// It stands in for the reference's jax.ops.segment_sum/min/max in the
// packed-key engine (repro/core/sortkeys.py) and in the per-column sums of
// the MCL prune: there is no TPU kernel behind it. A scatter_reduce_ of
// atomics adds a segment's values in an order that changes from run to run,
// and every padding entry of the engine's 2^27-slot expansions reduces into
// one discard slot; this kernel fixes the order and never reads the padding.
//
// What bounds it on this card: bytes. Each value in a run is read once (4
// bytes), each offset once (4 bytes), each output written once; the
// operations are one add per value. The engine's runs are short (most hold
// 0-3 entries), so a launch moves little and the time goes to the chain of
// dependent loads of each run (its two offsets, then its values) and to
// how many such chains the card keeps in flight.
//
// Design: the grid covers every run at once. A block of 256 threads takes
// R consecutive runs, R = 256 unless that leaves less than one wave of
// blocks on a 132-SM card (then fewer, down to 1, so a launch of a few
// thousand long runs still spreads over the whole card). Thread t reads
// the offsets of run t (coalesced) and, if the run holds at most
// kThreadRun entries, reduces it alone, serially in entry order: the order
// of the plain version's serial scatter_reduce_ on the CPU, so those sums
// have the CPU's bits. Longer runs go to lists in shared memory: up to
// kWarpRun entries to one of the block's warps (lane l reduces entries l,
// l + 32, ... in order, then a fixed xor butterfly), longer ones to the
// whole block (thread t reduces entries t, t + 256, ..., each warp folds by
// the butterfly, and thread 0 folds the 8 warp results in warp order).
// Which path a run takes depends on its length alone, and which warp or
// block does it changes nothing, so the same inputs give the same bits on
// every run. The kernel allocates nothing, launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadRun = 32;    // runs of at most this many entries: one thread
constexpr int kWarpRun = 4096;    // at most this many: one warp; longer: the block
constexpr int kWaveBlocks = 132 * 8;  // one wave of 256-thread blocks on an H100

enum AddKind : int { kSum = 0, kMin = 1, kMax = 2 };

template <int kKind>
__device__ __forceinline__ float combine(float a, float b) {
  if (kKind == kSum) return a + b;
  if (kKind == kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <int kKind>
__device__ __forceinline__ float identity() {
  if (kKind == kSum) return 0.f;
  if (kKind == kMin) return INFINITY;
  return -INFINITY;
}

// vals[e0 .. e1) folded one entry at a time, up to four loads in flight
template <int kKind>
__device__ __forceinline__ float serial(const float* __restrict__ vals, int e0, int e1) {
  float acc = identity<kKind>();
  int e = e0;
  for (; e + 4 <= e1; e += 4) {
    const float a = vals[e], b = vals[e + 1], c = vals[e + 2], d = vals[e + 3];
    acc = combine<kKind>(combine<kKind>(combine<kKind>(combine<kKind>(acc, a), b), c), d);
  }
  // the last 0-3 entries (all of most runs): loaded together, then folded in order
  const int rest = e1 - e;
  const float a = rest > 0 ? vals[e] : 0.f;
  const float b = rest > 1 ? vals[e + 1] : 0.f;
  const float c = rest > 2 ? vals[e + 2] : 0.f;
  if (rest > 0) acc = combine<kKind>(acc, a);
  if (rest > 1) acc = combine<kKind>(acc, b);
  if (rest > 2) acc = combine<kKind>(acc, c);
  return acc;
}

// vals[e0 + first], vals[e0 + first + stride], ... folded in order
template <int kKind>
__device__ __forceinline__ float strided(const float* __restrict__ vals, int e0, int e1,
                                         int first, int stride) {
  float acc = identity<kKind>();
#pragma unroll 4
  for (int e = e0 + first; e < e1; e += stride) acc = combine<kKind>(acc, vals[e]);
  return acc;
}

template <int kKind>
__device__ __forceinline__ float warp_fold(float acc) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc = combine<kKind>(acc, __shfl_xor_sync(0xffffffffu, acc, d));
  return acc;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const float* __restrict__ vals, const int* __restrict__ offsets,
                          int num_segments, int runs_per_block, float* __restrict__ out) {
  __shared__ int s_warp_runs[kThreads];
  __shared__ int s_block_runs[kThreads];
  __shared__ int s_num_warp, s_num_block;
  __shared__ float s_part[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    s_num_warp = 0;
    s_num_block = 0;
  }
  __syncthreads();

  const long long s = static_cast<long long>(blockIdx.x) * runs_per_block + t;
  if (t < runs_per_block && s < num_segments) {
    const int e0 = offsets[s];
    const int e1 = offsets[s + 1];
    const int len = e1 - e0;
    if (len <= kThreadRun) {
      out[s] = serial<kKind>(vals, e0, e1);
    } else if (len <= kWarpRun) {
      s_warp_runs[atomicAdd(&s_num_warp, 1)] = static_cast<int>(s);
    } else {
      s_block_runs[atomicAdd(&s_num_block, 1)] = static_cast<int>(s);
    }
  }
  __syncthreads();

  const int num_warp = s_num_warp;
  for (int i = warp; i < num_warp; i += kWarps) {
    const int r = s_warp_runs[i];
    const float acc = warp_fold<kKind>(strided<kKind>(vals, offsets[r], offsets[r + 1], lane, 32));
    if (lane == 0) out[r] = acc;
  }

  const int num_block = s_num_block;  // the same in every thread: the loop's barriers are safe
  for (int i = 0; i < num_block; ++i) {
    const int r = s_block_runs[i];
    const float acc =
        warp_fold<kKind>(strided<kKind>(vals, offsets[r], offsets[r + 1], t, kThreads));
    if (lane == 0) s_part[warp] = acc;
    __syncthreads();
    if (t == 0) {
      float total = s_part[0];
      for (int w = 1; w < kWarps; ++w) total = combine<kKind>(total, s_part[w]);
      out[r] = total;
    }
    __syncthreads();  // s_part is written again for the next run
  }
}

}  // namespace

extern "C" int segment_reduce_launch(const float* vals, const int* offsets, int num_segments,
                                     int add_kind, float* out, cudaStream_t stream) {
  if (num_segments < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  // R runs a block: 256, or fewer when 256 would leave less than one wave
  int runs = (num_segments + kWaveBlocks - 1) / kWaveBlocks;
  runs = runs < kThreads ? runs : kThreads;
  const int blocks = (num_segments + runs - 1) / runs;
  switch (add_kind) {
    case kSum:
      segment_reduce_kernel<kSum><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments,
                                                                   runs, out);
      break;
    case kMin:
      segment_reduce_kernel<kMin><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments,
                                                                   runs, out);
      break;
    case kMax:
      segment_reduce_kernel<kMax><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments,
                                                                   runs, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The longest run one thread reduces, and the longest one warp reduces
// (longer runs take the block): which path a run takes.
extern "C" int segment_reduce_thread_run() { return kThreadRun; }
extern "C" int segment_reduce_warp_run() { return kWarpRun; }
