// SpMM: padded-COO sparse A (m x k) times dense B (k x n) -> dense f32 C,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spmm.py::spmm_pallas (body
// _spmm_kernel). C[r, :] = sum of v * B[c, :] over A's entries (r, c, v).
// The wrapper has already ordered A's entries by row (a stable sort, so
// slot order is kept within a row) and built row pointers; entries whose
// row or column is a sentinel sort past the last row pointer and are never
// read.
//
// What bounds it on this card: bytes. A is read once (12 bytes an entry),
// B and C once each (k * n * 4 and m * n * 4 bytes: 256 MiB each at the
// MCL dense phase's shape); the operations are 2 * nnz(A) * n, about 8.6
// GFLOP there, half the byte time at the f32 peak. This kernel reads a row
// of B for every entry of A (nnz(A) * n * 4 bytes, ~16 GB at that shape)
// and relies on L2 to serve most of it: the grid runs the column tiles in
// its slow dimension, so the blocks in flight share one 256-column stripe
// of B (k * 1 KiB, 16 MiB at that shape), which fits in L2.
//
// Design: the TPU kernel turns both the gather of B's rows and the scatter
// into C's rows into one-hot products on the MXU, with the C tile resident
// in VMEM across the reduction. Here the row pointers make the scatter a
// plain store: one block per (row, 256-column tile), one thread per column,
// which sums the row's entries in a register in slot order and writes its
// element of C once. No atomics, no zero fill; every element of C is
// written. The kernel allocates nothing, launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 256;  // C columns per block, one per thread

__global__ void spmm_rows_kernel(const int* __restrict__ rowptr,
                                 const int* __restrict__ cols,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ b, int n,
                                 float* __restrict__ out) {
  const int r = blockIdx.x;
  const int j = blockIdx.y * kTile + threadIdx.x;
  if (j >= n) return;
  const int e0 = rowptr[r];
  const int e1 = rowptr[r + 1];
  float acc = 0.f;
  for (int e = e0; e < e1; ++e) {
    acc += vals[e] * b[static_cast<size_t>(cols[e]) * n + j];
  }
  out[static_cast<size_t>(r) * n + j] = acc;
}

}  // namespace

extern "C" int spmm_launch(const int* rowptr, const int* cols, const float* vals,
                           const float* b, int m, int n, float* out,
                           cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m, tiles);
  spmm_rows_kernel<<<grid, kTile, 0, stream>>>(rowptr, cols, vals, b, n, out);
  return static_cast<int>(cudaGetLastError());
}
