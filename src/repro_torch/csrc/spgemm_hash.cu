// Hash-accumulator insert for SpGEMM, written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm_hash.py::hash_insert_pallas
// (body _hash_insert_kernel, probe rounds _insert_rounds, _accumulate,
// fib_hash), which inserts one chunk of (packed row-major i32 key, f32
// value) partial products into an open-addressing table, accumulating
// values with the semiring's sum, min or max and counting the drops. The
// reference calls it once per chunk from a fori_loop over the expansion
// (repro/core/local_spgemm.py::spgemm_hash). Two kernels here:
//
//   * hash_insert_kernel: that one-chunk insert, the direct counterpart of
//     the Pallas kernel (one launch per chunk of given keys and values).
//   * hash_expand_insert_kernel: the whole batch in one launch. Thread e
//     covers expansion slot e of [0, min(total, num_chunks * chunk_cap)),
//     grid-strided: it finds its B entry t (the first t with cum[t] > e, a
//     binary search of the inclusive prefix of products per B entry), forms
//     A's slot colptr[k] + (e - cum[t - 1]), the semiring product and the
//     packed key a_row * (n + 1) + b_row, and inserts it. total is read on
//     the device, so the host never waits. No expansion buffer exists: the
//     table is the only scratch, and the host issues one launch per batch
//     instead of one per chunk plus a dozen ops to build each chunk.
//
// Masked multiply (paper section V-B): the reference filters every chunk's
// keys against the mask's ascending packed keys before the insert
// (keys_in_sorted in repro/core/local_spgemm.py::spgemm_hash), so products
// off the mask never take a slot. Here the fused kernel does the same after
// forming the key: a binary search of the key in the mask's keys (global
// memory, read through L2) decides whether it is inserted -- on a hit in
// "strict" mode, on a miss in "complement" mode. A product filtered out is
// not a drop. The search adds log2(mask keys) dependent loads per product;
// staging the keys in shared memory is left for a later change.
//
// What bounds them on this card: neither bytes nor arithmetic at the main
// path's sizes. A batch of the n = 2^20 hash run reads A's tile, B's block
// and cum once (a few MB) and touches one 8-byte slot per distinct key:
// tens of microseconds at 3.35 TB/s. What they wait on is the latency of a
// few dependent loads (the binary search, A's slot) and atomics per entry
// (the claim, then the accumulate), which land in L2; the one-chunk kernel
// also waits on its launch.
//
// Insert: a slot moves from EMPTY to a key once and never changes again, so
// a plain (volatile) read that sees a key is final; only a slot read as
// EMPTY is claimed with atomicCAS, and a CAS that returns our own key counts
// as a hit. Entries with equal keys follow the same probe sequence, so they
// meet in one slot, and the table is a valid linear-probing table: its
// occupied slots and its key -> value set are the reference's whatever the
// order the threads run in (a key's displacement, and so a drop under
// max_probes, can depend on that order). Entries that find no slot within
// max_probes are counted in one atomic counter, the overflow flag the
// batched driver's retry ladder reads.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 0x7fffffff;     // INT32_MAX: sorts after every real key
constexpr unsigned kFib = 2654435769u;  // golden-ratio multiplier (fib_hash)
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100

enum AddKind : int { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  int* ai = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(ai);
  while (v < __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(ai, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  int* ai = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(ai);
  while (v > __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(ai, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

template <int kKind>
__device__ __forceinline__ void accumulate(float* slot, float v) {
  if (kKind == kSum) {
    atomicAdd(slot, v);
  } else if (kKind == kMin) {
    atomic_min_f32(slot, v);
  } else {
    atomic_max_f32(slot, v);
  }
}

template <int kKind>
__device__ __forceinline__ void insert(int* table_key, float* __restrict__ table_val, int key,
                                       float v, int lg_table, int max_probes,
                                       int* __restrict__ dropped) {
  const unsigned mask = (1u << lg_table) - 1u;
  const unsigned h0 = (static_cast<unsigned>(key) * kFib) >> (32 - lg_table);
  const volatile int* vkey = table_key;
  for (int p = 0; p < max_probes; ++p) {
    const unsigned slot = (h0 + static_cast<unsigned>(p)) & mask;
    int cur = vkey[slot];
    if (cur == kEmpty) cur = atomicCAS(&table_key[slot], kEmpty, key);
    if (cur == kEmpty || cur == key) {
      accumulate<kKind>(&table_val[slot], v);
      return;
    }
  }
  atomicAdd(dropped, 1);
}

template <int kKind>
__global__ void hash_insert_kernel(int* table_key, float* __restrict__ table_val,
                                   const int* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   const unsigned char* __restrict__ valid, int n,
                                   int lg_table, int max_probes,
                                   int* __restrict__ dropped) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  insert<kKind>(table_key, table_val, keys[i], vals[i], lg_table, max_probes, dropped);
}

enum MulKind : int { kTimes = 0, kMulMin = 1, kPlus = 2, kPair = 3 };
enum MaskMode : int { kMaskNone = 0, kMaskStrict = 1, kMaskComplement = 2 };

struct Expansion {
  const int* a_rows;    // A column-major sorted (CSC order)
  const float* a_vals;
  const int* colptr;    // A's column starts
  const int* b_rows;    // B's entries as (row = output column j, col = k)
  const int* b_cols;
  const float* b_vals;
  const int* cum;       // inclusive prefix of products per B entry
  const int* mask_keys; // ascending packed mask keys, sentinel padding last
  int cap_a, cap_b, n, mask_n, mask_mode, mul_kind;
  long long limit;      // num_chunks * chunk_cap: slots the plan enumerates
};

// Is key one of the ascending keys[0, count)? (lower bound, then compare)
__device__ __forceinline__ bool in_sorted(const int* __restrict__ keys, int count, int key) {
  int lo = 0, hi = count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < count && keys[lo] == key;
}

template <int kKind>
__global__ void hash_expand_insert_kernel(Expansion x, int* table_key,
                                          float* __restrict__ table_val, int lg_table,
                                          int max_probes, int* __restrict__ dropped) {
  const long long total = x.cum[x.cap_b - 1];
  const long long end = total < x.limit ? total : x.limit;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < end;
       e += stride) {
    int lo = 0, hi = x.cap_b - 1;  // cum[cap_b - 1] = total > e
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (x.cum[mid] > e) hi = mid; else lo = mid + 1;
    }
    const int t = lo;
    const long long start = t > 0 ? x.cum[t - 1] : 0;
    int ai = x.colptr[x.b_cols[t]] + static_cast<int>(e - start);
    ai = ai < 0 ? 0 : (ai >= x.cap_a ? x.cap_a - 1 : ai);
    const float av = x.a_vals[ai];
    const float bv = x.b_vals[t];
    float v;
    switch (x.mul_kind) {
      case kTimes: v = av * bv; break;
      case kMulMin: v = fminf(av, bv); break;
      case kPlus: v = av + bv; break;
      default: v = 1.f; break;
    }
    // row-major packed key with int32 wraparound, as the reference's
    const int key = static_cast<int>(static_cast<unsigned>(x.a_rows[ai]) *
                                         static_cast<unsigned>(x.n + 1) +
                                     static_cast<unsigned>(x.b_rows[t]));
    if (x.mask_mode != kMaskNone &&
        in_sorted(x.mask_keys, x.mask_n, key) != (x.mask_mode == kMaskStrict)) {
      continue;
    }
    insert<kKind>(table_key, table_val, key, v, lg_table, max_probes, dropped);
  }
}

}  // namespace

extern "C" int hash_insert_launch(int* table_key, float* table_val, const int* keys,
                                  const float* vals, const unsigned char* valid,
                                  int n, int lg_table, int max_probes, int add_kind,
                                  int* dropped, cudaStream_t stream) {
  if (n <= 0 || lg_table < 1 || lg_table > 31 || max_probes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  switch (add_kind) {
    case kSum:
      hash_insert_kernel<kSum><<<blocks, kThreads, 0, stream>>>(
          table_key, table_val, keys, vals, valid, n, lg_table, max_probes, dropped);
      break;
    case kMin:
      hash_insert_kernel<kMin><<<blocks, kThreads, 0, stream>>>(
          table_key, table_val, keys, vals, valid, n, lg_table, max_probes, dropped);
      break;
    case kMax:
      hash_insert_kernel<kMax><<<blocks, kThreads, 0, stream>>>(
          table_key, table_val, keys, vals, valid, n, lg_table, max_probes, dropped);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hash_expand_insert_launch(int* table_key, float* table_val, const int* a_rows,
                                         const float* a_vals, const int* colptr,
                                         const int* b_rows, const int* b_cols,
                                         const float* b_vals, const int* cum,
                                         const int* mask_keys, int cap_a, int cap_b, int n,
                                         int mask_n, int mask_mode, long long limit,
                                         int mul_kind, int lg_table, int max_probes,
                                         int add_kind, int* dropped, cudaStream_t stream) {
  if (cap_a <= 0 || cap_b < 0 || n < 0 || limit < 0 || lg_table < 1 || lg_table > 31 ||
      max_probes < 0 || mul_kind < kTimes || mul_kind > kPair || mask_mode < kMaskNone ||
      mask_mode > kMaskComplement || mask_n < 0 ||
      (mask_mode != kMaskNone && mask_n > 0 && mask_keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap_b == 0 || limit == 0) return static_cast<int>(cudaSuccess);
  const Expansion x{a_rows, a_vals, colptr, b_rows, b_cols, b_vals, cum, mask_keys,
                    cap_a, cap_b, n, mask_n, mask_mode, mul_kind, limit};
  const long long want = (limit + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  switch (add_kind) {
    case kSum:
      hash_expand_insert_kernel<kSum><<<blocks, kThreads, 0, stream>>>(
          x, table_key, table_val, lg_table, max_probes, dropped);
      break;
    case kMin:
      hash_expand_insert_kernel<kMin><<<blocks, kThreads, 0, stream>>>(
          x, table_key, table_val, lg_table, max_probes, dropped);
      break;
    case kMax:
      hash_expand_insert_kernel<kMax><<<blocks, kThreads, 0, stream>>>(
          x, table_key, table_val, lg_table, max_probes, dropped);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
