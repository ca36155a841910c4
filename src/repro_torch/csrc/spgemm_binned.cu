// k-binned paired SpGEMM (COO x COO -> dense f32 C), written for Hopper
// (sm_90a), with a fixed order of sums.
//
// Replaces the TPU kernel repro/kernels/spgemm_binned.py::
// spgemm_paired_binned_pallas (body _binned_kernel). Both operands arrive
// as (num_bins, bin_cap) arrays from bin_entries_by_k; A pads k with -1, B
// with -2 (never equal), values with 0. Only entries of the same bin are
// paired: C[a_row, b_col] += a_val * b_val wherever a_k == b_k. An A entry
// whose row lies outside [0, m), or a B entry whose column lies outside
// [0, n), contributes nothing.
//
// The order of sums: for every C[r, c] the products of its pairs are added
// bins ascending, then A slots ascending, then B slots ascending (the order
// in which spgemm_paired_binned_ref lists them), starting from 0.0f, each
// product and each sum rounded on its own (__fmul_rn, __fadd_rn: no FMA
// contraction). C is then bit-identical to a serial f32 sum in that order,
// whatever the grid. No atomic touches C, and every element of C is
// written exactly once, so the wrapper does not zero it.
//
// What bounds it on this card: bytes. The work the data needs is one
// multiply-add per matching pair (~2.5e5 at the default n = 2^14 plan's
// batch), while C is m * n * 4 bytes (64 MiB there) and is written once;
// the operands are a few MB.
//
// Design: O(cap_a + cap_b + matches) work plus one write of C. The wrapper
// sorts, stably (torch.sort), A's flat slots by row and B's by contraction
// index; a stable sort keeps flat (bin, slot) order among equal keys. Then:
//   1. binned_prep_kernel, one thread per position: the first sorted A
//      position of each row r in [0, m] (a binary search; rows outside
//      [0, m) sort before row 0 or from row m on and are never read); for
//      each sorted A position with a row in [0, m), the range of sorted B
//      positions with its k and its bin (a binary search on (k, flat B
//      slot)), as a record (B start, B count, a_val); and B's (column,
//      value) in sorted order.
//   2. binned_pull_kernel: one warp per (row r, tile of kTile columns),
//      the tile's sums in shared memory. The warp lists row r's products
//      in order (A positions ascending, then each one's B range ascending)
//      and takes them 32 at a time, one a lane: an inclusive scan of the B
//      counts of 32 A positions, and a 5-step search over it, tell each
//      lane its A position and B position. Lanes whose products fall on
//      one column (a B bucket may repeat a column) add in rounds, the
//      lowest lane first (__match_any_sync); __syncwarp between rounds and
//      between chunks keeps the order. The warp then writes its tile of
//      row r, zeros included (16-byte stores where n % 4 == 0).
// The design's limit: a row's products are walked by its warp alone, 32 a
// step, so a row with many products (thousands of A entries, or a heavy k)
// is serial in its warp; on protein-like inputs a row has ~15.5 entries.
// Each column tile walks the row's products again.
// The kernels allocate nothing, launch in order on the caller's stream,
// and the entry point returns the first nonzero cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPrepThreads = 256;
constexpr int kWarps = 8;     // warps a pull block
constexpr int kTile = 1024;   // columns a warp sums in shared memory (4 KiB)
constexpr unsigned kFull = 0xffffffffu;

// First position j in [0, len) whose (key[j], slot[j]) is not below (k, s).
__device__ __forceinline__ int lower_bound(const int* __restrict__ key,
                                           const long long* __restrict__ slot, int len,
                                           int k, long long s) {
  int lo = 0;
  int hi = len;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int km = key[mid];
    if (km < k || (km == k && slot != nullptr && slot[mid] < s)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void binned_prep_kernel(const int* __restrict__ a_key,
                                   const long long* __restrict__ a_slot, int na,
                                   const int* __restrict__ a_k,
                                   const float* __restrict__ a_vals, int bin_cap_a,
                                   const int* __restrict__ b_key,
                                   const long long* __restrict__ b_slot, int nb,
                                   const int* __restrict__ b_cols,
                                   const float* __restrict__ b_vals, int bin_cap_b, int m,
                                   int* __restrict__ row_start, int4* __restrict__ a_rec,
                                   int2* __restrict__ b_rec) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i <= m) {
    row_start[i] = lower_bound(a_key, nullptr, na, static_cast<int>(i), 0);
  }
  if (i < na) {
    const int r = a_key[i];
    if (r >= 0 && r < m) {
      const long long flat = a_slot[i];
      const long long g = flat / bin_cap_a;
      const int k = a_k[flat];
      const int lo = lower_bound(b_key, b_slot, nb, k, g * bin_cap_b);
      const int hi = lower_bound(b_key, b_slot, nb, k, (g + 1) * bin_cap_b);
      a_rec[i] = make_int4(lo, hi - lo, __float_as_int(a_vals[flat]), 0);
    }
  }
  if (i < nb) {
    const long long s = b_slot[i];
    b_rec[i] = make_int2(b_cols[s], __float_as_int(b_vals[s]));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    binned_pull_kernel(const int* __restrict__ row_start, const int4* __restrict__ a_rec,
                       const int2* __restrict__ b_rec, int m, int n, int tiles,
                       float* __restrict__ out) {
  __shared__ __align__(16) float sums[kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(m) * tiles) return;  // the whole warp
  const int r = static_cast<int>(task / tiles);
  const int c0 = static_cast<int>(task % tiles) * kTile;
  const int cw = min(kTile, n - c0);
  float* tile = sums[warp];
  for (int j = lane; j < cw; j += 32) tile[j] = 0.0f;
  __syncwarp();

  const int lo = row_start[r];
  const int hi = row_start[r + 1];
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    int bstart = 0;
    int len = 0;
    float av = 0.0f;
    if (i < hi) {
      const int4 e = a_rec[i];
      bstart = e.x;
      len = e.y;
      av = __int_as_float(e.z);
    }
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int p0 = 0; p0 < total; p0 += 32) {
      const int p = p0 + lane;
      // s: the number of lanes whose products all come before p, i.e. the
      // lane whose A position holds product p (incl is nondecreasing)
      int s = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, incl, s + step - 1) <= p) s += step;
      }
      s = min(s, 31);
      const int bs = __shfl_sync(kFull, bstart, s);
      const int ex = __shfl_sync(kFull, excl, s);
      const float x = __shfl_sync(kFull, av, s);
      bool live = false;
      int col = 0;
      float v = 0.0f;
      if (p < total) {
        const int2 b = b_rec[bs + (p - ex)];
        if (b.x >= c0 && b.x - c0 < cw) {
          live = true;
          col = b.x - c0;
          v = __fmul_rn(x, __int_as_float(b.y));
        }
      }
      // products on one column add in lane order: the earlier product first
      const unsigned peers = __match_any_sync(kFull, live ? col : -1 - lane);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (live && rank == 0) tile[col] = __fadd_rn(tile[col], v);
      unsigned more = __ballot_sync(kFull, live && rank > 0);
      for (int round = 1; more != 0u; ++round) {
        __syncwarp();
        if (live && rank == round) tile[col] = __fadd_rn(tile[col], v);
        more = __ballot_sync(kFull, live && rank > round);
      }
      __syncwarp();
    }
  }

  float* row = out + static_cast<size_t>(r) * n + c0;
  if ((n & 3) == 0) {  // c0 and cw are multiples of 4: 16-byte aligned stores
    const float4* src = reinterpret_cast<const float4*>(tile);
    float4* dst = reinterpret_cast<float4*>(row);
    for (int q = lane; q < (cw >> 2); q += 32) dst[q] = src[q];
  } else {
    for (int j = lane; j < cw; j += 32) row[j] = tile[j];
  }
}

}  // namespace

// a_key/a_slot: A's rows sorted stably and their flat slots (g * bin_cap_a
// + slot); b_key/b_slot: B's contraction indices sorted stably and their
// flat slots. Scratch: row_start (m + 1), a_rec (na int4), b_rec (nb int2).
// C (m x n) needs no initial value.
extern "C" int spgemm_paired_binned_launch(
    const int* a_key, const long long* a_slot, const int* a_k, const float* a_vals, int na,
    int bin_cap_a, const int* b_key, const long long* b_slot, const int* b_cols,
    const float* b_vals, int nb, int bin_cap_b, int m, int n, int* row_start, int4* a_rec,
    int2* b_rec, float* out, cudaStream_t stream) {
  if (na < 0 || nb < 0 || bin_cap_a <= 0 || bin_cap_b <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long prep = max(static_cast<long long>(m) + 1,
                             static_cast<long long>(max(na, nb)));
  binned_prep_kernel<<<static_cast<unsigned>((prep + kPrepThreads - 1) / kPrepThreads),
                       kPrepThreads, 0, stream>>>(
      a_key, a_slot, na, a_k, a_vals, bin_cap_a, b_key, b_slot, nb, b_cols, b_vals,
      bin_cap_b, m, row_start, a_rec, b_rec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  const long long tasks = static_cast<long long>(m) * tiles;
  binned_pull_kernel<<<static_cast<unsigned>((tasks + kWarps - 1) / kWarps), kWarps * 32, 0,
                       stream>>>(row_start, a_rec, b_rec, m, n, tiles, out);
  return static_cast<int>(cudaGetLastError());
}
