// Sort-free paired SpGEMM (COO x COO -> dense f32 C), written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm_acc.py::spgemm_paired_pallas
// (body _paired_kernel). C[a_row, b_col] += a_val * b_val for every pair of
// an A entry and a B entry with a_col == b_row, for any int32 contraction
// value (also outside [0, k): the function is given no k). Neither operand
// needs any order. An A entry whose row lies outside [0, m), or a B entry
// whose column lies outside [0, n), contributes nothing whatever its value:
// that drops the padding (sentinels m and n), also where A's and B's
// padding meet on the contraction sentinel.
//
// What bounds it on this card: bytes, counted as the function needs them:
// both entry lists read once (12 bytes a slot) and C written once (m * n *
// 4 bytes; 64 MiB for a 16384 x 1024 batch block), about 0.02 ms. Its
// operations are one multiply-add per matching pair. Pairing every A slot
// with every B slot, as the TPU kernel does, would instead take cap_a *
// cap_b comparisons (5.3e9 for 2.6e5 matches at that batch), bound by
// instruction issue far above the byte bound.
//
// Design: O(cap_a + cap_b + matches) work. B is bucketed by its
// contraction index, then every A entry walks its own bucket:
//   1. paired_count_kernel: drops the B entries whose column lies outside
//      [0, n) and counts the rest per bucket (b_row & (nb - 1), nb the
//      power of two >= cap_b, at most 2^30), with one atomicAdd per run of
//      equal buckets in a warp (__match_any_sync), and keeps each entry's
//      rank within its bucket.
//   2. paired_scan_kernel: the exclusive scan of the counts. One block of
//      1024 threads scans 2^16 counts in tiles of 4096 with a carry; above
//      2^16 buckets each block scans its 2^16, and a second launch of the
//      same kernel, one block, scans the blocks' totals in place into the
//      base of each block's span.
//   3. paired_scatter_kernel: writes each live B entry (row, col, val) as
//      one 16-byte record at its bucket's offset plus its rank.
//   4. paired_match_kernel: one thread per A entry; an entry whose row
//      lies in [0, m) walks its bucket, compares b_row == a_col (buckets
//      mix contraction values that agree in their low bits) and adds
//      a_val * b_val into C with atomicAdd (size_t offset). A bucket longer
//      than 32 records (a heavy contraction index) is not walked by its
//      thread alone: the warp takes such buckets one at a time, its 32
//      lanes striding over the records, before each lane walks its short
//      bucket. One A entry against a bucket of N records then costs one
//      warp N / 32 steps.
// The wrapper allocates C (zeroed), the counts (zeroed) and the scratch
// (offsets, block bases, ranks, records); the kernels allocate nothing,
// launch in order on the caller's stream, and the entry point returns the
// first nonzero cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;            // 32 warps: one warp scans their totals
constexpr int kScanTile = 4 * kScanThreads;   // counts a scan block takes per step
constexpr int kScanSpanLog = 16;              // counts one scan block covers
constexpr int kWarpSplit = 32;                // longer buckets are walked by the warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bucket_base(const int* block_base, int bucket) {
  return block_base == nullptr ? 0 : block_base[bucket >> kScanSpanLog];
}

__global__ void paired_count_kernel(const int* __restrict__ b_rows,
                                    const int* __restrict__ b_cols, int cap_b, int n, int mask,
                                    int* __restrict__ counts, int* __restrict__ rank) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int bucket = -1;  // -1: no entry, or its column lies outside [0, n)
  if (i < static_cast<size_t>(cap_b)) {
    const int c = b_cols[i];
    if (c >= 0 && c < n) bucket = b_rows[i] & mask;
  }
  // lanes of one bucket take consecutive ranks from one atomicAdd
  const unsigned peers = __match_any_sync(kFull, bucket);
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (bucket >= 0 && lane == leader) first = atomicAdd(counts + bucket, __popc(peers));
  first = __shfl_sync(kFull, first, leader);
  if (i < static_cast<size_t>(cap_b)) {
    rank[i] = bucket >= 0 ? first + __popc(peers & ((1u << lane) - 1u)) : -1;
  }
}

// Exclusive scan of in[j * 2^16 .. (j + 1) * 2^16) into out for block j,
// its total into block_sums[j] (when given). in and out may be one array.
__global__ void __launch_bounds__(kScanThreads)
    paired_scan_kernel(const int* in, int len, int* out, int* __restrict__ block_sums) {
  __shared__ int warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lo = static_cast<long long>(blockIdx.x) << kScanSpanLog;
  const long long hi = min(lo + (1LL << kScanSpanLog), static_cast<long long>(len));
  int carry = 0;
  for (long long t0 = lo; t0 < hi; t0 += kScanTile) {
    const long long i0 = t0 + 4LL * threadIdx.x;
    int x[4];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = i0 + q < hi ? in[i0 + q] : 0;
      sum += x[q];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int wt = warp_total[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, wt, o);
        if (lane >= o) wt += y;
      }
      warp_total[lane] = wt;
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_total[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < hi) out[i0 + q] = run;
      run += x[q];
    }
    carry += warp_total[31];
    __syncthreads();  // warp_total is rewritten by the next tile
  }
  if (block_sums != nullptr && threadIdx.x == 0) block_sums[blockIdx.x] = carry;
}

__global__ void paired_scatter_kernel(const int* __restrict__ b_rows,
                                      const int* __restrict__ b_cols,
                                      const float* __restrict__ b_vals, int cap_b, int mask,
                                      const int* __restrict__ rank,
                                      const int* __restrict__ offsets,
                                      const int* __restrict__ block_base,
                                      int4* __restrict__ records) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(cap_b)) return;
  const int r = rank[i];
  if (r < 0) return;
  const int row = b_rows[i];
  const int bucket = row & mask;
  const int at = bucket_base(block_base, bucket) + offsets[bucket] + r;
  records[at] = make_int4(row, b_cols[i], __float_as_int(b_vals[i]), 0);
}

__global__ void paired_match_kernel(const int* __restrict__ a_rows,
                                    const int* __restrict__ a_cols,
                                    const float* __restrict__ a_vals, int cap_a, int m, int n,
                                    int mask, const int* __restrict__ counts,
                                    const int* __restrict__ offsets,
                                    const int* __restrict__ block_base,
                                    const int4* __restrict__ records, float* __restrict__ out) {
  const size_t ia = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int ar = 0;  // stays 0 (and len 0) unless the entry's row lies in [0, m)
  int ac = 0;
  float av = 0.f;
  int start = 0;
  int len = 0;
  if (ia < static_cast<size_t>(cap_a)) {
    const int r = a_rows[ia];
    if (r >= 0 && r < m) {
      ar = r;
      ac = a_cols[ia];
      av = a_vals[ia];
      const int bucket = ac & mask;
      len = counts[bucket];
      start = bucket_base(block_base, bucket) + offsets[bucket];
    }
  }
  // long buckets: the whole warp walks each in turn
  unsigned long_lanes = __ballot_sync(kFull, len > kWarpSplit);
  while (long_lanes != 0u) {
    const int src = __ffs(long_lanes) - 1;
    long_lanes &= long_lanes - 1u;
    const int s = __shfl_sync(kFull, start, src);
    const int l = __shfl_sync(kFull, len, src);
    const int c = __shfl_sync(kFull, ac, src);
    const float x = __shfl_sync(kFull, av, src);
    float* row = out + static_cast<size_t>(__shfl_sync(kFull, ar, src)) * n;
    for (int j = lane; j < l; j += 32) {
      const int4 e = records[s + j];
      if (e.x == c) atomicAdd(row + e.y, x * __int_as_float(e.z));
    }
  }
  if (len > kWarpSplit) return;
  float* row = out + static_cast<size_t>(ar) * n;
  for (int j = 0; j < len; ++j) {
    const int4 e = records[start + j];
    if (e.x == ac) atomicAdd(row + e.y, av * __int_as_float(e.z));
  }
}

unsigned grid_for(int count, int threads) {
  return (static_cast<unsigned>(count) + threads - 1) / threads;
}

}  // namespace

extern "C" int spgemm_paired_launch(const int* a_rows, const int* a_cols, const float* a_vals,
                                    int cap_a, const int* b_rows, const int* b_cols,
                                    const float* b_vals, int cap_b, int m, int n, float* out,
                                    int nb, int* counts, int* offsets, int* block_base,
                                    int* rank, int* records, cudaStream_t stream) {
  if (cap_a <= 0 || cap_b <= 0 || m <= 0 || n <= 0 || nb <= 0 || (nb & (nb - 1)) != 0 ||
      nb > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mask = nb - 1;
  const int scan_blocks = static_cast<int>((static_cast<long long>(nb) - 1) >> kScanSpanLog) + 1;
  int* base = scan_blocks > 1 ? block_base : nullptr;
  int4* rec = reinterpret_cast<int4*>(records);
  cudaError_t err;
  paired_count_kernel<<<grid_for(cap_b, kThreads), kThreads, 0, stream>>>(
      b_rows, b_cols, cap_b, n, mask, counts, rank);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  paired_scan_kernel<<<scan_blocks, kScanThreads, 0, stream>>>(counts, nb, offsets, base);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (base != nullptr) {
    paired_scan_kernel<<<1, kScanThreads, 0, stream>>>(base, scan_blocks, base, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  paired_scatter_kernel<<<grid_for(cap_b, kThreads), kThreads, 0, stream>>>(
      b_rows, b_cols, b_vals, cap_b, mask, rank, offsets, base, rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  paired_match_kernel<<<grid_for(cap_a, kThreads), kThreads, 0, stream>>>(
      a_rows, a_cols, a_vals, cap_a, m, n, mask, counts, offsets, base, rec, out);
  return static_cast<int>(cudaGetLastError());
}
