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
// operations are one add per value.
//
// Design: one warp per segment, grid-strided over segments. Lane l reduces
// the run's entries l, l + 32, ... in order, then the warp combines its 32
// partials with a fixed xor butterfly. Nothing depends on scheduling, so the
// same inputs give the same bits on every run. A long run is read by all 32
// lanes at once; a short one leaves lanes idle, which costs issue slots but
// no bytes. The kernel allocates nothing, launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

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

template <int kKind>
__global__ void segment_reduce_kernel(const float* __restrict__ vals,
                                      const int* __restrict__ offsets,
                                      int num_segments, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < num_segments; s += warps) {
    const int e0 = offsets[s];
    const int e1 = offsets[s + 1];
    float acc = identity<kKind>();
    for (int e = e0 + lane; e < e1; e += 32) acc = combine<kKind>(acc, vals[e]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      acc = combine<kKind>(acc, __shfl_xor_sync(0xffffffffu, acc, d));
    }
    if (lane == 0) out[s] = acc;
  }
}

}  // namespace

extern "C" int segment_reduce_launch(const float* vals, const int* offsets, int num_segments,
                                     int add_kind, float* out, cudaStream_t stream) {
  if (num_segments < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_segments == 0) return static_cast<int>(cudaSuccess);
  const long long want = (static_cast<long long>(num_segments) * 32 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  switch (add_kind) {
    case kSum:
      segment_reduce_kernel<kSum><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments, out);
      break;
    case kMin:
      segment_reduce_kernel<kMin><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments, out);
      break;
    case kMax:
      segment_reduce_kernel<kMax><<<blocks, kThreads, 0, stream>>>(vals, offsets, num_segments, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
