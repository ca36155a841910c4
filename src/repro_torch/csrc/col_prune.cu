// Per-column top-k bisection bracket for MCL pruning, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/col_prune.py::
// col_topk_bounds_pallas (body _col_prune_kernel). For each column c of a
// dense f32 (m, n) block x it runs the same arithmetic:
//   hi = max_i |x[i, c]| + 1e-6, lo = 0;
//   24 times: mid = 0.5 * (lo + hi); cnt = #{i : |x[i, c]| >= mid};
//             cnt > k ? lo = mid : hi = mid;
// and writes out[0, c] = lo, out[1, c] = hi. Every step is one correctly
// rounded f32 operation on exact integer counts, so the bracket is
// bit-identical to the plain version and to the TPU kernel's.
//
// What bounds it on this card: bytes. The function needs one read of x
// (m * n * 4 bytes) and 8 bytes written per column; its operations are a
// compare and an add per element per step. This kernel reads x once for
// the maximum and once per bisection step, 25 reads in all: a column tile
// of the MCL dense phase (16384 rows) is 2 MiB, too large for shared
// memory, and the whole block (256 MiB) is far larger than L2, so each step
// streams x from device memory again. Fusing the steps (a per-column
// histogram pass, or keeping the tile on chip across a cluster) is a later
// optimisation.
//
// Design: the TPU kernel reduces a (m, n_blk) VMEM block with vector ops.
// Here one block takes a tile of 32 adjacent columns: lane = column, so
// every row of the tile is one coalesced 128-byte read, and the block's
// warps take interleaved row slices. Each step, every thread counts its
// rows, the per-warp counts meet in shared memory, and every thread sums
// them for its own column, so all warps hold the same (lo, hi) without a
// broadcast. The row loop is unrolled so each thread keeps several loads in
// flight. The kernel allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCols = 32;   // columns per block, one per lane
constexpr int kWarps = 32;  // row slices per block
constexpr int kIters = 24;  // THRESH_ITERS of the TPU kernel

__global__ void __launch_bounds__(kCols * kWarps)
    col_topk_bounds_kernel(const float* __restrict__ x, int m, int n, int k,
                           float* __restrict__ out) {
  __shared__ float s_max[kWarps][kCols];
  __shared__ int s_cnt[kWarps][kCols];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const bool live = col < n;
  const float* xc = x + (live ? col : 0);

  float mx = 0.f;  // |x| >= 0, so 0 is the identity of this maximum
  if (live) {
#pragma unroll 4
    for (int r = warp; r < m; r += kWarps) {
      mx = fmaxf(mx, fabsf(xc[static_cast<size_t>(r) * n]));
    }
  }
  s_max[warp][lane] = mx;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_max[w][lane]);

  float lo = 0.f;
  float hi = __fadd_rn(mx, 1e-6f);
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
    if (live) {
#pragma unroll 4
      for (int r = warp; r < m; r += kWarps) {
        cnt += fabsf(xc[static_cast<size_t>(r) * n]) >= mid;
      }
    }
    s_cnt[warp][lane] = cnt;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w][lane];
    __syncthreads();  // s_cnt is written again next step
    if (total > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  if (warp == 0 && live) {
    out[col] = lo;
    out[static_cast<size_t>(n) + col] = hi;
  }
}

}  // namespace

extern "C" int col_topk_bounds_launch(const float* x, int m, int n, int k,
                                      float* out, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kCols, kWarps);
  const dim3 grid((n + kCols - 1) / kCols);
  col_topk_bounds_kernel<<<grid, block, 0, stream>>>(x, m, n, k, out);
  return static_cast<int>(cudaGetLastError());
}
