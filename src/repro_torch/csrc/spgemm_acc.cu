// Sort-free paired SpGEMM (COO x COO -> dense f32 C), written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm_acc.py::spgemm_paired_pallas
// (body _paired_kernel). C[a_row, b_col] += a_val * b_val for every pair of
// an A entry and a B entry with a_col == b_row. Neither operand needs any
// order. An A entry whose row lies outside [0, m), or a B entry whose
// column lies outside [0, n), contributes nothing whatever its value: that
// drops the padding (sentinels m and n), also where A's and B's padding
// meet on the contraction sentinel.
//
// What bounds it on this card: bytes, counted as the function needs them:
// both entry lists read once (12 bytes a slot) and C written once (m * n *
// 4 bytes; 64 MiB for a 16384 x 1024 batch block), about 0.02 ms. Its
// operations are one multiply-add per matching pair. This kernel does
// cap_a * cap_b comparisons instead (about 4e9 at that batch), a few
// instructions each, so it is bound by instruction issue, far above the
// byte bound; the k-binned kernel (spgemm_binned.cu) exists to cut them.
//
// Design: the TPU kernel's grid is (m/m_blk x n/n_blk) output tiles, each
// pairing all of A against all of B through one-hot products on the MXU,
// which multiplies the comparisons by the number of output tiles. Here
// every pair is compared once: one block per 256 A entries, one A entry per
// thread; B's (row, col, val) entries are staged through shared memory in
// tiles of 2048 (24 KiB), and every thread compares its A column with each
// staged B row (all threads read the same element: a broadcast). On a
// match the thread adds a_val * b_val into C with atomicAdd. A block whose
// A entries all lie outside [0, m) returns at once. C's offset is size_t
// (m * n can pass 2^31); cap_a * cap_b passes 2^31 too, but no index here
// spans it. The wrapper zeroes C; the kernel allocates nothing, launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsA = 256;  // A entries per block, one per thread
constexpr int kTileB = 2048;    // B entries staged per shared-memory pass

__global__ void paired_kernel(const int* __restrict__ a_rows,
                              const int* __restrict__ a_cols,
                              const float* __restrict__ a_vals, int cap_a,
                              const int* __restrict__ b_rows,
                              const int* __restrict__ b_cols,
                              const float* __restrict__ b_vals, int cap_b,
                              int m, int n, float* __restrict__ out) {
  __shared__ int s_r[kTileB];
  __shared__ int s_c[kTileB];
  __shared__ float s_v[kTileB];

  const size_t ia = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int ar = -1;
  int ac = 0;
  float av = 0.f;
  if (ia < static_cast<size_t>(cap_a)) {
    ar = a_rows[ia];
    ac = a_cols[ia];
    av = a_vals[ia];
  }
  const bool live = ar >= 0 && ar < m;
  if (!__syncthreads_or(live)) return;  // the whole block is padding

  float* out_row = out + static_cast<size_t>(live ? ar : 0) * n;
  for (int t0 = 0; t0 < cap_b; t0 += kTileB) {
    const int cnt = min(kTileB, cap_b - t0);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_r[j] = b_rows[t0 + j];
      s_c[j] = b_cols[t0 + j];
      s_v[j] = b_vals[t0 + j];
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) {
        if (s_r[j] == ac) {
          const int c = s_c[j];
          if (c >= 0 && c < n) atomicAdd(out_row + c, av * s_v[j]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int spgemm_paired_launch(const int* a_rows, const int* a_cols,
                                    const float* a_vals, int cap_a,
                                    const int* b_rows, const int* b_cols,
                                    const float* b_vals, int cap_b, int m, int n,
                                    float* out, cudaStream_t stream) {
  if (cap_a <= 0 || cap_b <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (static_cast<unsigned>(cap_a) + kThreadsA - 1) / kThreadsA;
  paired_kernel<<<blocks, kThreadsA, 0, stream>>>(a_rows, a_cols, a_vals, cap_a, b_rows,
                                                  b_cols, b_vals, cap_b, m, n, out);
  return static_cast<int>(cudaGetLastError());
}
