// k-binned paired SpGEMM (COO x COO -> dense f32 C), written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm_binned.py::
// spgemm_paired_binned_pallas (body _binned_kernel). Both operands arrive
// counting-sorted into num_bins contraction ranges, (num_bins, bin_cap)
// arrays from bin_entries_by_k; A pads k with -1, B with -2 (never equal),
// values with 0. Only entries of the same bin are paired:
// C[a_row, b_col] += a_val * b_val wherever a_k == b_k.
//
// What bounds it on this card: bytes. The work the data needs is one
// multiply-add per matching pair (a few per output entry), while the dense
// output tile is m * n * 4 bytes (64 MB at the default n = 2^14 plan) and
// has to be written once; the operands are a few MB. The pairing loop
// itself is Sum_g bin_cap_a * bin_cap_b comparisons out of shared memory,
// which is the kernel's real cost whenever the bins are padded far beyond
// their valid entries.
//
// Design: the TPU kernel builds a dense match matrix per (A block, B block)
// pair and contracts it with two one-hot matrix products on the MXU. Here
// the match is a comparison, not a product: one block per (bin, tile of 256
// A entries); the bin's B entries are staged through shared memory in
// tiles of 1024; each thread owns one A entry, compares it with every
// staged B entry and on a match adds a_val * b_val into C with atomicAdd.
// A block whose A entries are all padding returns at once. The wrapper
// zeroes C; the kernel allocates nothing, launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreadsA = 256;  // A entries per block, one per thread
constexpr int kTileB = 1024;    // B entries staged per shared-memory pass

__global__ void binned_paired_kernel(const int* __restrict__ a_rows,
                                     const int* __restrict__ a_k,
                                     const float* __restrict__ a_vals,
                                     const int* __restrict__ b_k,
                                     const int* __restrict__ b_cols,
                                     const float* __restrict__ b_vals,
                                     int bin_cap_a, int bin_cap_b, int m, int n,
                                     float* __restrict__ out) {
  __shared__ int s_k[kTileB];
  __shared__ int s_c[kTileB];
  __shared__ float s_v[kTileB];

  const int g = blockIdx.y;
  const int ia = blockIdx.x * blockDim.x + threadIdx.x;
  int ar = 0;
  int ak = -1;
  float av = 0.f;
  if (ia < bin_cap_a) {
    const size_t off = static_cast<size_t>(g) * bin_cap_a + ia;
    ar = a_rows[off];
    ak = a_k[off];
    av = a_vals[off];
  }
  const bool live = ak >= 0 && ar >= 0 && ar < m;
  if (!__syncthreads_or(live)) return;  // the whole block is padding

  const size_t boff = static_cast<size_t>(g) * bin_cap_b;
  float* out_row = out + static_cast<size_t>(ar) * n;
  for (int t0 = 0; t0 < bin_cap_b; t0 += kTileB) {
    const int cnt = min(kTileB, bin_cap_b - t0);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_k[j] = b_k[boff + t0 + j];
      s_c[j] = b_cols[boff + t0 + j];
      s_v[j] = b_vals[boff + t0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        if (s_k[j] == ak) {
          const int c = s_c[j];
          if (c >= 0 && c < n) atomicAdd(out_row + c, av * s_v[j]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int spgemm_paired_binned_launch(const int* a_rows, const int* a_k,
                                           const float* a_vals, const int* b_k,
                                           const int* b_cols, const float* b_vals,
                                           int num_bins, int bin_cap_a,
                                           int bin_cap_b, int m, int n, float* out,
                                           cudaStream_t stream) {
  if (num_bins <= 0 || num_bins > 65535 || bin_cap_a <= 0 || bin_cap_b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((bin_cap_a + kThreadsA - 1) / kThreadsA, num_bins);
  binned_paired_kernel<<<grid, kThreadsA, 0, stream>>>(
      a_rows, a_k, a_vals, b_k, b_cols, b_vals, bin_cap_a, bin_cap_b, m, n, out);
  return static_cast<int>(cudaGetLastError());
}
