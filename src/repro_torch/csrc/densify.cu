// Densify: scatter a padded COO entry list into a dense f32 tile, summing
// duplicates, written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/densify.py::densify_pallas (body
// _densify_kernel). out[r, c] += v for every entry (r, c, v) with
// 0 <= r < m and 0 <= c < n; padding carries the sentinels (m, n) and is
// skipped. The dense-accumulator multiply uses it to turn the narrow
// per-batch column block of B into a dense tile once, before the SpMM
// streams A through it.
//
// What bounds it on this card: bytes. The dense tile (m * n * 4 bytes) has
// to be written once (the wrapper's zero fill) and each entry read once
// (12 bytes); the adds are one per entry. At the MCL dense phase's shape
// the tile is 256 MiB and the entries a few MB, so the zero fill is nearly
// all of it.
//
// Design: the TPU kernel builds one-hot row and column selectors and
// accumulates their product on the MXU, once per (output tile, entry
// block). Here the scatter is direct: one thread per entry and one
// atomicAdd into the zeroed tile, which also sums duplicates (in an order
// that varies from run to run). The wrapper zeroes the tile; the kernel
// allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void densify_kernel(const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const float* __restrict__ vals, int cap, int m,
                               int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int r = rows[i];
  const int c = cols[i];
  if (r < 0 || r >= m || c < 0 || c >= n) return;
  atomicAdd(out + static_cast<size_t>(r) * n + c, vals[i]);
}

}  // namespace

extern "C" int densify_launch(const int* rows, const int* cols,
                              const float* vals, int cap, int m, int n,
                              float* out, cudaStream_t stream) {
  if (cap < 0 || m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (cap + kThreads - 1) / kThreads;
  densify_kernel<<<blocks, kThreads, 0, stream>>>(rows, cols, vals, cap, m, n, out);
  return static_cast<int>(cudaGetLastError());
}
