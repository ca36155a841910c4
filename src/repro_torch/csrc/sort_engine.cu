// Bitonic sort of (key, value) pairs in shared memory, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sort_engine.py::
// bitonic_sort_pairs_pallas (body _bitonic_kernel). Keys are int32, values
// any 32-bit payload moved as raw bits; n is a power of two up to 2^14.
// Stage (kk, jj), for kk = 2, 4, ..., n and jj = kk/2, ..., 1, pairs the
// low index lo (bit jj clear) with lo | jj, ascending when (lo & kk) == 0.
// The tie rule is the TPU kernel's: in_order = a <= b, swap = asc ?
// !in_order : in_order, so equal keys stay in an ascending stage and swap
// in a descending one. No atomics and no data-dependent control flow: the
// result is bit-identical to the plain version and to the TPU kernel's,
// values included.
//
// What bounds it on this card: bytes, in principle: the function reads and
// writes 8 bytes per pair, 256 KiB in all at n = 2^14, which is well under
// a microsecond at the memory rate. In fact it is bound by its barriers:
// the network has log2(n) * (log2(n) + 1) / 2 stages (105 at 2^14), each
// a pass over shared memory ended by __syncthreads(), on one SM.
//
// Design: the TPU kernel keeps the arrays in VMEM and writes each stage as
// a reshape and a select. Here one block of up to 1024 threads holds both
// arrays in dynamic shared memory (2^14 * 8 bytes = 128 KiB, above the
// 48 KiB default, so the launch raises the block's limit first); each
// thread does n / 2 / threads compare-exchanges per stage. The kernel
// allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxElems = 1 << 14;
constexpr int kMaxThreads = 1024;

__global__ void bitonic_pairs_kernel(const int* __restrict__ keys,
                                     const unsigned* __restrict__ vals, int n,
                                     int* __restrict__ keys_out,
                                     unsigned* __restrict__ vals_out) {
  extern __shared__ int smem[];
  int* s_k = smem;
  unsigned* s_v = reinterpret_cast<unsigned*>(smem + n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_k[i] = keys[i];
    s_v[i] = vals[i];
  }
  __syncthreads();
  const int half = n >> 1;
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int jj = kk >> 1; jj > 0; jj >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // pair p -> low index: a 0 inserted at bit jj of p
        const int lo = ((p & ~(jj - 1)) << 1) | (p & (jj - 1));
        const int hi = lo | jj;
        const bool asc = (lo & kk) == 0;
        const int a = s_k[lo];
        const int b = s_k[hi];
        const bool in_order = a <= b;
        if (asc ? !in_order : in_order) {
          s_k[lo] = b;
          s_k[hi] = a;
          const unsigned va = s_v[lo];
          s_v[lo] = s_v[hi];
          s_v[hi] = va;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keys_out[i] = s_k[i];
    vals_out[i] = s_v[i];
  }
}

}  // namespace

extern "C" int bitonic_sort_pairs_launch(const int* keys, const unsigned* vals,
                                         int n, int* keys_out, unsigned* vals_out,
                                         cudaStream_t stream) {
  if (n <= 0 || n > kMaxElems || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n) * (sizeof(int) + sizeof(unsigned));
  // per launch, not once: the limit is an attribute of the current device
  const cudaError_t err = cudaFuncSetAttribute(
      bitonic_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n < 2 ? 1 : (n / 2 < kMaxThreads ? n / 2 : kMaxThreads);
  bitonic_pairs_kernel<<<1, threads, smem, stream>>>(keys, vals, n, keys_out, vals_out);
  return static_cast<int>(cudaGetLastError());
}
