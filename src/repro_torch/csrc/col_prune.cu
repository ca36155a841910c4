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
// compare and an add per element per step. A column tile of the MCL dense
// phase (16384 rows) is 2 MiB, too large for shared memory, and the block
// (256 MiB) is far larger than L2, so every step that counts reads x again.
//
// Design: this kernel reads x 4 times, not 25: once for the maxima, then
// once per 8 bisection steps. The midpoints of the next 8 steps are fixed
// by (lo, hi) before them: they form a tree of 255 thresholds, node p (1 ..
// 255) the midpoint of its nearest ancestors p - s and p + s (s the lowest
// set bit of p; position 0 holds lo, 256 holds hi), computed with the same
// __fadd_rn / __fmul_rn. Correct rounding is monotone, so the thresholds
// ascend in position order (equal neighbours allowed once the interval is
// an ulp wide). One pass bins each |x| by bucket = #{p : t_p <= |x|}, an
// 8-step search, into a per-column histogram; #{|x| >= t_p} is then the
// sum of the buckets >= p, exact for every node, and the 8 steps are
// replayed with the same cnt > k rule. Bucket 0 counts toward no node, so
// an |x| below the smallest threshold (the zeros of an MCL block) costs one
// compare. One tile is 32 adjacent columns (lane = column: every row of the
// tile is one coalesced 128-byte read), its rows split over a thread block
// cluster of 8 blocks of 1024 threads, one block an SM, each thread with 16
// loads in flight. A block keeps the thresholds and histogram with the
// column in the low address bits, so each lane reads and counts in its own
// shared-memory bank. After a pass the cluster sums its 8 histograms
// through distributed shared memory: block r adds up buckets 32r .. 32r+31
// of all 8 and suffix-sums them, and every block replays the steps for all
// 32 columns from those sums (integer sums and a maximum are exact in any
// order, so all 8 agree). Two cluster barriers a pass, one for the maxima
// and one before exit. One launch per call; the kernel allocates nothing,
// launches on the caller's stream through cudaLaunchKernelEx with the
// cluster size as a launch attribute, and returns the launch's error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 32;                  // columns per tile, one per lane
constexpr int kWarps = 32;                 // row slices per block
constexpr int kThreads = kCols * kWarps;
constexpr int kUnroll = 16;                // loads in flight per thread
constexpr int kSplit = 8;                  // blocks per cluster: the tile's rows split 8 ways
constexpr int kIters = 24;                 // THRESH_ITERS of the TPU kernel
constexpr int kDepth = 8;                  // bisection steps per read of x
constexpr int kPasses = kIters / kDepth;
constexpr int kNodes = 1 << kDepth;        // buckets 0 .. 255; thresholds at 1 .. 255
constexpr int kBucketsPerRank = kNodes / kSplit;
static_assert(kIters % kDepth == 0, "whole passes");
static_assert(kBucketsPerRank % kWarps == 0, "whole buckets per warp in the cluster sum");
static_assert(kDepth >= 3, "three levels of the tree are held in registers");

struct Smem {
  float t[kNodes + 1][kCols];         // t[0] = lo, t[1 .. 255] thresholds, t[256] = hi
  int hist[kNodes][kCols];            // this block's count per bucket
  int part[kBucketsPerRank][kCols];   // cluster's counts of the rank's buckets >= i, per column
  float warp_max[kWarps][kCols];
  float max[kCols];
  float lo[kCols];
  float hi[kCols];
};

__global__ void __launch_bounds__(kThreads, 1)
    col_topk_bounds_kernel(const float* __restrict__ x, int m, int n, int k,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = (blockIdx.x / kSplit) * kCols + lane;
  const bool live = col < n;
  const int rows = (m + kSplit - 1) / kSplit;
  const int r0 = static_cast<int>(rank) * rows;
  const int r1 = min(m, r0 + rows);
  const float* xc = x + (live ? col : 0);
  auto at = [&](int r) { return fabsf(xc[static_cast<size_t>(r) * n]); };

  // rows r0 + warp, r0 + warp + kWarps, ...: kUnroll loads issued before any is used
  auto rows_of = [&](auto&& use) {
    if (!live) return;
    int r = r0 + warp;
    for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = at(r + u * kWarps);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) use(v[u]);
    }
    for (; r < r1; r += kWarps) use(at(r));
  };

  // read 1: the column maxima
  float mx = 0.f;  // |x| >= 0, so 0 is the identity of this maximum
  rows_of([&](float v) { mx = fmaxf(mx, v); });
  sm.warp_max[warp][lane] = mx;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm.warp_max[w][lane]);
    sm.max[lane] = mx;
  }
  cluster.sync();
  if (warp == 0) {
    float g = 0.f;
    for (unsigned q = 0; q < kSplit; ++q) g = fmaxf(g, cluster.map_shared_rank(sm.max, q)[lane]);
    sm.lo[lane] = 0.f;
    sm.hi[lane] = __fadd_rn(g, 1e-6f);
  }

  for (int pass = 0; pass < kPasses; ++pass) {
    // the tree of the next kDepth midpoints, level by level from the root
    for (int i = threadIdx.x; i < kNodes * kCols; i += kThreads) (&sm.hist[0][0])[i] = 0;
    __syncthreads();
    if (warp == 0) {
      sm.t[0][lane] = sm.lo[lane];
      sm.t[kNodes][lane] = sm.hi[lane];
    }
    __syncthreads();
    for (int s = kNodes / 2; s >= 1; s >>= 1) {
      for (int node = warp; node < kNodes / (2 * s); node += kWarps) {
        const int p = s * (2 * node + 1);
        sm.t[p][lane] = __fmul_rn(0.5f, __fadd_rn(sm.t[p - s][lane], sm.t[p + s][lane]));
      }
      __syncthreads();
    }

    // read 2 + pass: each |x| into its bucket
    constexpr int h = kNodes / 2;
    const float t_min = sm.t[1][lane], t_max = sm.t[kNodes - 1][lane];
    const float t_h = sm.t[h][lane];
    const float t_q1 = sm.t[h / 2][lane], t_q3 = sm.t[h + h / 2][lane];
    const float t_e1 = sm.t[h / 4][lane], t_e3 = sm.t[3 * h / 4][lane];
    const float t_e5 = sm.t[5 * h / 4][lane], t_e7 = sm.t[7 * h / 4][lane];
    auto count = [&](float v) {
      if (!(t_min <= v)) return;  // bucket 0: at or above no threshold
      int p = kNodes - 1;
      if (!(t_max <= v)) {
        p = t_h <= v ? h : 0;
        p += (p ? t_q3 : t_q1) <= v ? h / 2 : 0;
        const float t3 = p < h ? (p ? t_e3 : t_e1) : (p == h ? t_e5 : t_e7);
        p += t3 <= v ? h / 4 : 0;
#pragma unroll
        for (int s = h / 8; s >= 1; s >>= 1) p += sm.t[p + s][lane] <= v ? s : 0;
      }
      atomicAdd(&sm.hist[p][lane], 1);
    };
    rows_of(count);
    cluster.sync();

    // block `rank` sums its kBucketsPerRank buckets over the cluster, then
    // suffix-sums them per column
    for (int i = warp; i < kBucketsPerRank; i += kWarps) {
      const int b = static_cast<int>(rank) * kBucketsPerRank + i;
      int total = 0;
      for (unsigned q = 0; q < kSplit; ++q) {
        total += cluster.map_shared_rank(&sm.hist[0][0], q)[b * kCols + lane];
      }
      sm.part[i][lane] = total;
    }
    __syncthreads();
    if (warp == 0) {
      int acc = 0;
      for (int i = kBucketsPerRank - 1; i >= 0; --i) {
        acc += sm.part[i][lane];
        sm.part[i][lane] = acc;
      }
    }
    cluster.sync();

    // replay the kDepth steps: cnt(t_p) = #{bucket >= p}
    if (warp == 0) {
      int above[kSplit];  // counts of the buckets owned by ranks above q
      int run = 0;
      for (int q = kSplit - 1; q >= 0; --q) {
        above[q] = run;
        run += cluster.map_shared_rank(&sm.part[0][0], static_cast<unsigned>(q))[lane];
      }
      float lo = sm.lo[lane], hi = sm.hi[lane];
      int p = h;
      for (int s = h; s >= 1; s >>= 1) {
        const int q = p / kBucketsPerRank;
        const int cnt = cluster.map_shared_rank(&sm.part[0][0], static_cast<unsigned>(q))
                            [(p % kBucketsPerRank) * kCols + lane] + above[q];
        const float mid = sm.t[p][lane];
        if (cnt > k) {
          lo = mid;
          p += s / 2;
        } else {
          hi = mid;
          p -= s / 2;
        }
      }
      sm.lo[lane] = lo;
      sm.hi[lane] = hi;
    }
  }
  if (rank == 0 && warp == 0 && live) {
    out[col] = sm.lo[lane];
    out[static_cast<size_t>(n) + col] = sm.hi[lane];
  }
  cluster.sync();  // no block exits while a peer may still read its shared memory
}

}  // namespace

extern "C" int col_topk_bounds_launch(const float* x, int m, int n, int k, float* out,
                                      cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Smem);
  // per launch, not once: the limit is an attribute of the current device
  cudaError_t err = cudaFuncSetAttribute(col_topk_bounds_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n + kCols - 1) / kCols) * kSplit, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, col_topk_bounds_kernel, x, m, n, k, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many times a call reads x: once for the maxima, then once a pass.
extern "C" int col_topk_bounds_reads_of_x() { return 1 + kPasses; }
