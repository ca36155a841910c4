// Hash-accumulator insert for SpGEMM, written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm_hash.py::hash_insert_pallas
// (body _hash_insert_kernel, probe rounds _insert_rounds, _accumulate,
// fib_hash). One launch inserts one chunk of (packed row-major i32 key,
// f32 value) partial products into an open-addressing table that lives in
// device memory, accumulating values with the semiring's sum, min or max.
//
// What bounds it on this card: neither bytes nor arithmetic. A chunk is
// 4096 entries (9 bytes each) and each valid entry touches one 8-byte slot,
// so a launch moves ~100 KB: under 0.1 us at 3.35 TB/s. What it waits on is
// the launch itself and the latency of a few dependent atomics per entry
// (the claim, then the accumulate), which land in L2.
//
// Design: one thread per chunk entry, so a chunk fills ~16 blocks and the
// probe chains of different entries run in parallel instead of in the TPU
// kernel's vectorised rounds. A slot moves from EMPTY to a key once and
// never changes again, so a plain (volatile) read that sees a key is final;
// only a slot read as EMPTY is claimed with atomicCAS, and a CAS that
// returns our own key counts as a hit. Entries with equal keys follow the
// same probe sequence, so they meet in one slot, and the table is a valid
// linear-probing table: its occupied slots and its key -> value set are the
// reference's, whatever the order the threads run in. Entries that find no
// slot within max_probes are counted in one atomic counter, the overflow
// flag the batched driver's retry ladder reads.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 0x7fffffff;     // INT32_MAX: sorts after every real key
constexpr unsigned kFib = 2654435769u;  // golden-ratio multiplier (fib_hash)
constexpr int kThreads = 256;

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
__global__ void hash_insert_kernel(int* table_key, float* __restrict__ table_val,
                                   const int* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   const unsigned char* __restrict__ valid, int n,
                                   int lg_table, int max_probes,
                                   int* __restrict__ dropped) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int key = keys[i];
  const float v = vals[i];
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
