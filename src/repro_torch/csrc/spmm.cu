// SpMM: padded-COO sparse A (m x k) times dense B (k x n) -> dense f32 C,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spmm.py::spmm_pallas (body
// _spmm_kernel). C[r, :] = sum of v * B[c, :] over A's entries (r, c, v),
// summed in f32; B is f32 or bf16 (one template parameter). The wrapper has
// already ordered A's entries by row (a stable sort, so slot order is kept
// within a row) and built row pointers; entries whose row or column is a
// sentinel sort past the last row pointer and are never read. In the
// accumulate mode the kernel adds A·B to the C it is given instead
// (C += A·B): the Cannon ring's stages sum into one tile that way, so no
// second (m x n) tile is held for a stage's product; a row of C with no
// entries in A is then neither read nor written, and a block whose rows
// have none returns at once.
//
// What bounds it on this card: bytes. A is read once (12 bytes an entry),
// B and C once each (k * n and m * n elements: 256 MiB each in f32 at the
// MCL dense phase's shape); the operations are 2 * nnz(A) * n, about 8.6
// GFLOP there, 0.13 ms at the f32 peak. A kernel that reads a row of B for
// every entry of A moves nnz(A) * n * 4 bytes through L2 (~17 GB at that
// shape, ~14x the compulsory bytes): the earlier one-thread-per-element
// version was bound there. Serving each of those reads from shared memory
// instead still moves the 17 GB through the SMs' load pipes; this kernel
// reuses each shared-memory load for 4 rows, and is then bound by the
// instructions it issues (FMAs included, some on zeros of the slab below).
//
// Design: one block owns 64 consecutive rows of C and, in turn, 8 tiles of
// 128 columns; each of its 16 warps owns 4 rows, each lane 4 columns of
// those rows in registers. Once per block, a hash table in shared memory
// counts how often each column index occurs among the rows' entries; the
// columns used twice or more, ranked by (count descending, column
// ascending), up to kStripes of them, become the block's staged columns.
// Their values are gathered into a dense (staged column x row) slab in
// shared memory, duplicates summed in slot order, and every other entry of
// a warp's rows goes to the warp's rest list in shared memory, in slot
// order. Per tile, the B stripe (the tile's 128 columns) of every staged
// column is copied into shared memory once; each warp runs the dense
// product of its 4 slab rows and the stripes with FP32 FMA (no TF32), one
// stripe load feeding 4 rows, then adds its rest lists from global memory,
// 4 loads in flight. In MCL's 64-node clusters the staged columns carry
// ~93 % of the entries. A row with more than kLong entries is left out of
// the slab and split over the block's 16 warps in fixed contiguous slices
// whose partials are summed in warp order, so it does not serialise one
// warp; a row whose rest does not fit its warp's list is walked entry by
// entry. Every element of C (in the accumulate mode, of a row with entries)
// is written once, with no atomics on values and no zero fill, and each sum runs in an order fixed by the inputs alone
// (the staging ranks depend on the entries only; a block whose columns
// overflow the table stages none), so two calls give the same bits. The
// kernel allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRows = 64;        // rows of C per block
constexpr int kCols = 128;       // columns of C per tile: 32 lanes x 4
constexpr int kTilesPerBlock = 8;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kLgHash = 10;
constexpr int kHash = 1 << kLgHash;  // slots of the column-count table
constexpr int kStripes = 108;    // columns staged per block
constexpr int kRest = 1024 / kWarps;  // per warp: its rows' unstaged entries kept in shared memory
constexpr int kLong = 256;       // a row with more entries is split over the warps
constexpr int kUnroll = 4;       // entries whose B loads are issued before their FMAs
constexpr int kEmpty = -1;
constexpr unsigned kFib = 2654435769u;
static_assert(kRowsPerWarp % 4 == 0, "a warp's slab rows are read as float4s");

struct Candidates {
  int slot[kHash];  // hash slot of each column used twice or more
  int rank[kHash];
};

union alignas(16) Scratch {
  Candidates cand;             // set-up
  float part[kWarps][kCols];   // long-row partials, per tile
};

struct Smem {
  int key[kHash];
  int sid[kHash];  // count while counting, then staged column id or -1
  Scratch u;
  int stripe_col[kStripes];
  int rowptr[kRows + 1];
  int ncand;
  int full;
  unsigned long long long_rows;  // bit i: row r0 + i has more than kLong entries
  int2 meta[kWarps][32];         // per warp: 32 entries' (id, value bits)
  int2 rest[kWarps][kRest];      // per warp: its rows' unstaged (column, value bits), slot order
  int rest_beg[kRows];
  int rest_end[kRows];           // -1: the row's unstaged entries did not fit; walk the row
  alignas(16) float slab[kStripes][kRows];
  alignas(16) float stripe[kStripes][kCols];
};

__device__ __forceinline__ unsigned hash_slot(int c) {
  return (static_cast<unsigned>(c) * kFib) >> (32 - kLgHash);
}

// Count one occurrence of column c; false when the table is full.
__device__ __forceinline__ bool count_col(Smem& s, int c) {
  volatile int* key = s.key;
  unsigned h = hash_slot(c);
  for (int p = 0; p < kHash; ++p, h = (h + 1) & (kHash - 1)) {
    int cur = key[h];
    if (cur == kEmpty) cur = atomicCAS(&s.key[h], kEmpty, c);
    if (cur == kEmpty || cur == c) {
      atomicAdd(&s.sid[h], 1);
      return true;
    }
  }
  return false;
}

// Staged column id of c, or -1.
__device__ __forceinline__ int lookup(const Smem& s, int c) {
  unsigned h = hash_slot(c);
  for (int p = 0; p < kHash; ++p, h = (h + 1) & (kHash - 1)) {
    const int kk = s.key[h];
    if (kk == c) return s.sid[h];
    if (kk == kEmpty) return -1;
  }
  return -1;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// B[c, j .. j + 3] as f32, zero past column n.
template <typename T>
__device__ __forceinline__ float4 b_quad(const T* __restrict__ b, int c, int j, int n, bool vec) {
  const T* row = b + static_cast<size_t>(c) * n;
  if (vec && j + 3 < n) return load4(row + j);
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < n) q.x = to_f32(row[j]);
  if (j + 1 < n) q.y = to_f32(row[j + 1]);
  if (j + 2 < n) q.z = to_f32(row[j + 2]);
  if (j + 3 < n) q.w = to_f32(row[j + 3]);
  return q;
}

__device__ __forceinline__ void fma4(float v, float4 q, float4& acc) {
  acc.x = fmaf(v, q.x, acc.x);
  acc.y = fmaf(v, q.y, acc.y);
  acc.z = fmaf(v, q.z, acc.z);
  acc.w = fmaf(v, q.w, acc.w);
}

// acc += sum over entries [e0, e1), in slot order, of v * B[c, j .. j + 3]:
// every entry (kAll, staged columns from their stripes) or only the
// entries whose column is not staged. Whole warp, uniform. The warp looks
// up 32 entries at a time, packs the ones it takes into its slice of
// shared memory in slot order, and reads them back as broadcasts.
template <bool kAll, typename T>
__device__ __forceinline__ void row_sum(Smem& s, const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        const T* __restrict__ b, int e0, int e1, int j,
                                        int jl, int n, bool vec, float4& acc) {
  const int lane = threadIdx.x & 31;
  int2* meta = s.meta[threadIdx.x >> 5];
  for (int base = e0; base < e1; base += 32) {
    const int e = base + lane;
    bool take = false;
    int id = 0;
    float v = 0.f;
    if (e < e1) {
      const int c = cols[e];
      const int sid = lookup(s, c);
      take = kAll || sid < 0;
      id = sid >= 0 ? sid : ~c;
      v = vals[e];
    }
    const unsigned taken = __ballot_sync(0xffffffffu, take);
    if (take) meta[__popc(taken & ((1u << lane) - 1u))] = make_int2(id, __float_as_int(v));
    __syncwarp();
    const int cnt = __popc(taken);
    int i = 0;
    for (; i + kUnroll <= cnt; i += kUnroll) {
      float4 q[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int2 mv = meta[i + u];
        w[u] = __int_as_float(mv.y);
        q[u] = mv.x >= 0 ? *reinterpret_cast<const float4*>(&s.stripe[mv.x][jl])
                         : b_quad(b, ~mv.x, j, n, vec);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma4(w[u], q[u], acc);
    }
    for (; i < cnt; ++i) {
      const int2 mv = meta[i];
      const float4 q = mv.x >= 0 ? *reinterpret_cast<const float4*>(&s.stripe[mv.x][jl])
                                 : b_quad(b, ~mv.x, j, n, vec);
      fma4(__int_as_float(mv.y), q, acc);
    }
    __syncwarp();
  }
}

// acc += sum over the list's (column, value) pairs, in order, of
// v * B[c, j .. j + 3], kUnroll loads from global memory in flight.
template <typename T>
__device__ __forceinline__ void list_sum(const int2* list, int q0, int q1,
                                         const T* __restrict__ b, int j, int n, bool vec,
                                         float4& acc) {
  int q = q0;
  for (; q + kUnroll <= q1; q += kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = b_quad(b, list[q + u].x, j, n, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fma4(__int_as_float(list[q + u].y), x[u], acc);
  }
  for (; q < q1; ++q) fma4(__int_as_float(list[q].y), b_quad(b, list[q].x, j, n, vec), acc);
}

// Write q to C[r, j..j+3], or add it to what C holds there (accumulate).
__device__ __forceinline__ void store_quad(float* __restrict__ out, int r, int j, int n,
                                           bool vec, bool accumulate, float4 q) {
  float* row = out + static_cast<size_t>(r) * n;
  if (vec && j + 3 < n) {
    float4* dst = reinterpret_cast<float4*>(row + j);
    if (accumulate) {
      const float4 c = *dst;
      q = make_float4(c.x + q.x, c.y + q.y, c.z + q.z, c.w + q.w);
    }
    *dst = q;
    return;
  }
  if (j < n) row[j] = accumulate ? row[j] + q.x : q.x;
  if (j + 1 < n) row[j + 1] = accumulate ? row[j + 1] + q.y : q.y;
  if (j + 2 < n) row[j + 2] = accumulate ? row[j + 2] + q.z : q.z;
  if (j + 3 < n) row[j + 3] = accumulate ? row[j + 3] + q.w : q.w;
}

// Once per block: stage the columns its rows use twice or more, ranked by
// (count descending, column ascending), and gather their values into the
// slab, duplicates summed in slot order. Returns the staged count.
__device__ int stage_columns(Smem& s, const int* __restrict__ cols,
                             const float* __restrict__ vals, int e0, int e1, int rows) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    if (!count_col(s, cols[e])) s.full = 1;
  }
  __syncthreads();
  if (!s.full) {
    for (int h = tid; h < kHash; h += kThreads) {
      if (s.key[h] != kEmpty && s.sid[h] >= 2) s.u.cand.slot[atomicAdd(&s.ncand, 1)] = h;
    }
  }
  __syncthreads();
  const int ncand = s.ncand;
  for (int i = tid; i < ncand; i += kThreads) {
    const int ci = s.key[s.u.cand.slot[i]], ki = s.sid[s.u.cand.slot[i]];
    int rank = 0;
    for (int q = 0; q < ncand; ++q) {
      const int cq = s.key[s.u.cand.slot[q]], kq = s.sid[s.u.cand.slot[q]];
      rank += (kq > ki) || (kq == ki && cq < ci);
    }
    s.u.cand.rank[i] = rank;
  }
  __syncthreads();
  for (int h = tid; h < kHash; h += kThreads) {
    if (s.full || s.sid[h] < 2) s.sid[h] = -1;
  }
  for (int x = tid; x < kStripes * kRows; x += kThreads) (&s.slab[0][0])[x] = 0.f;
  __syncthreads();
  for (int i = tid; i < ncand; i += kThreads) {
    const int h = s.u.cand.slot[i], rank = s.u.cand.rank[i];
    if (rank < kStripes) s.stripe_col[rank] = s.key[h];
    s.sid[h] = rank < kStripes ? rank : -1;
  }
  __syncthreads();
  // slab: each warp its rows, 32 entries at a time; lanes holding the same
  // column are summed in lane order by the lowest of them. The unstaged
  // entries go to the warp's rest list, in slot order.
  int pos = 0;
  for (int g = 0; g < kRowsPerWarp; ++g) {
    const int i = warp * kRowsPerWarp + g;
    if (i >= rows || ((s.long_rows >> i) & 1ull)) continue;
    const int ra = s.rowptr[i], rb = s.rowptr[i + 1];
    const int beg = pos;
    bool fits = true;
    for (int base = ra; base < rb; base += 32) {
      const int e = base + lane;
      int sid = -1, c = 0;
      float v = 0.f;
      if (e < rb) {
        c = cols[e];
        sid = lookup(s, c);
        v = vals[e];
      }
      const unsigned group = __match_any_sync(0xffffffffu, sid >= 0 ? sid : -1 - lane);
      float sum = 0.f;
      for (int l = 0; l < 32; ++l) {
        const float x = __shfl_sync(0xffffffffu, v, l);
        if ((group >> l) & 1u) sum += x;
      }
      if (sid >= 0 && lane == __ffs(group) - 1) s.slab[sid][i] += sum;
      const bool rest = e < rb && sid < 0;
      const unsigned left = __ballot_sync(0xffffffffu, rest);
      fits = fits && pos + __popc(left) <= kRest;
      if (fits) {
        if (rest) s.rest[warp][pos + __popc(left & ((1u << lane) - 1u))] =
            make_int2(c, __float_as_int(v));
        pos += __popc(left);
      }
    }
    if (!fits) pos = beg;
    if (lane == 0) {
      s.rest_beg[i] = beg;
      s.rest_end[i] = fits ? pos : -1;
    }
  }
  __syncthreads();
  return min(ncand, kStripes);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
spmm_tile_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                 const float* __restrict__ vals, const T* __restrict__ b, int m, int n,
                 bool vec, bool accumulate, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - r0);

  for (int h = tid; h < kHash; h += kThreads) {
    s.key[h] = kEmpty;
    s.sid[h] = 0;
  }
  if (tid == 0) {
    s.ncand = 0;
    s.full = 0;
    s.long_rows = 0ull;
  }
  if (tid <= rows) s.rowptr[tid] = rowptr[r0 + tid];
  __syncthreads();
  if (accumulate && s.rowptr[0] == s.rowptr[rows]) return;  // C += 0 on every row
  if (tid < rows && s.rowptr[tid + 1] - s.rowptr[tid] > kLong) {
    atomicOr(&s.long_rows, 1ull << tid);
  }
  const int staged = stage_columns(s, cols, vals, s.rowptr[0], s.rowptr[rows], rows);

  const int tiles = (n + kCols - 1) / kCols;
  const int jl = lane * 4;
  for (int tile = blockIdx.y * kTilesPerBlock;
       tile < min(tiles, (blockIdx.y + 1) * kTilesPerBlock); ++tile) {
    const int j = tile * kCols + jl;
    for (int st = warp; st < staged; st += kWarps) {
      *reinterpret_cast<float4*>(&s.stripe[st][jl]) = b_quad(b, s.stripe_col[st], j, n, vec);
    }
    __syncthreads();
    // the warp's rows: the slab times the stripes, in staged order, then
    // the unstaged entries in slot order
    float4 acc[kRowsPerWarp];
#pragma unroll
    for (int g = 0; g < kRowsPerWarp; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int st = 0; st < staged; ++st) {
      float4 a[kRowsPerWarp / 4];
      bool any = false;
#pragma unroll
      for (int h = 0; h < kRowsPerWarp / 4; ++h) {
        a[h] = *reinterpret_cast<const float4*>(&s.slab[st][warp * kRowsPerWarp + 4 * h]);
        any = any || a[h].x != 0.f || a[h].y != 0.f || a[h].z != 0.f || a[h].w != 0.f;
      }
      if (!any) continue;
      const float4 q = *reinterpret_cast<const float4*>(&s.stripe[st][jl]);
#pragma unroll
      for (int h = 0; h < kRowsPerWarp / 4; ++h) {
        fma4(a[h].x, q, acc[4 * h]);
        fma4(a[h].y, q, acc[4 * h + 1]);
        fma4(a[h].z, q, acc[4 * h + 2]);
        fma4(a[h].w, q, acc[4 * h + 3]);
      }
    }
#pragma unroll
    for (int g = 0; g < kRowsPerWarp; ++g) {
      const int i = warp * kRowsPerWarp + g;
      // in the accumulate mode a row with no entries keeps its C untouched
      if (i < rows && !((s.long_rows >> i) & 1ull) &&
          !(accumulate && s.rowptr[i] == s.rowptr[i + 1])) {
        if (s.rest_end[i] >= 0) {
          list_sum(s.rest[warp], s.rest_beg[i], s.rest_end[i], b, j, n, vec, acc[g]);
        } else {
          row_sum<false>(s, cols, vals, b, s.rowptr[i], s.rowptr[i + 1], j, jl, n, vec, acc[g]);
        }
        store_quad(out, r0 + i, j, n, vec, accumulate, acc[g]);
      }
    }
    // long rows: contiguous slices per warp, partials summed in warp order
    for (unsigned long long rest = s.long_rows; rest; rest &= rest - 1) {
      const int i = __ffsll(static_cast<long long>(rest)) - 1;
      const int ra = s.rowptr[i], len = s.rowptr[i + 1] - ra;
      const int sa = ra + static_cast<int>(static_cast<long long>(len) * warp / kWarps);
      const int sb = ra + static_cast<int>(static_cast<long long>(len) * (warp + 1) / kWarps);
      float4 acc_l = make_float4(0.f, 0.f, 0.f, 0.f);
      row_sum<true>(s, cols, vals, b, sa, sb, j, jl, n, vec, acc_l);
      *reinterpret_cast<float4*>(&s.u.part[warp][jl]) = acc_l;
      __syncthreads();
      if (warp == 0) {
        float4 sum = *reinterpret_cast<const float4*>(&s.u.part[0][jl]);
        for (int w = 1; w < kWarps; ++w) {
          const float4 p = *reinterpret_cast<const float4*>(&s.u.part[w][jl]);
          sum.x += p.x;
          sum.y += p.y;
          sum.z += p.z;
          sum.w += p.w;
        }
        store_quad(out, r0 + i, j, n, vec, accumulate, sum);
      }
      __syncthreads();
    }
    __syncthreads();  // the next tile overwrites the stripes
  }
}

template <typename T>
int launch(const int* rowptr, const int* cols, const float* vals, const T* b, int m, int n,
           int vec, int accumulate, float* out, cudaStream_t stream) {
  const int tiles = (n + kCols - 1) / kCols;
  const dim3 grid((m + kRows - 1) / kRows, (tiles + kTilesPerBlock - 1) / kTilesPerBlock);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(spmm_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmm_tile_kernel<T><<<grid, kThreads, smem, stream>>>(rowptr, cols, vals, b, m, n, vec != 0,
                                                        accumulate != 0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b_dtype: 0 = float32, 1 = bfloat16. vec: B's rows and C's rows are
// 16-byte (f32) or 8-byte (bf16) aligned for 4-column accesses.
// accumulate: 0 writes C = A·B; 1 adds A·B to the C it is given (each
// element of a row with entries read and written once, by the thread that
// sums it; the other rows are not touched).
extern "C" int spmm_launch(const int* rowptr, const int* cols, const float* vals,
                           const void* b, int b_dtype, int m, int n, int vec, int accumulate,
                           float* out, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b_dtype == 0) {
    return launch(rowptr, cols, vals, static_cast<const float*>(b), m, n, vec, accumulate, out,
                  stream);
  }
  if (b_dtype == 1) {
    return launch(rowptr, cols, vals, static_cast<const __nv_bfloat16*>(b), m, n, vec,
                  accumulate, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
