// Bitonic sort of (key, value) pairs over a thread block cluster, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sort_engine.py::
// bitonic_sort_pairs_pallas (body _bitonic_kernel). Keys are int32, values
// any 32-bit payload moved as raw bits; n is a power of two up to 2^14.
// Stage (kk, jj), for kk = 2, 4, ..., n and jj = kk/2, ..., 1, pairs the
// low index lo (bit jj clear) with lo | jj, ascending when (lo & kk) == 0.
// The tie rule is the TPU kernel's: in_order = a <= b, swap = asc ?
// !in_order : in_order, so equal keys stay in an ascending stage and swap
// in a descending one. No atomics and no data-dependent control flow: the
// result is bit-identical to the plain version and to the TPU kernel's,
// values included.
//
// What bounds it on this card: bytes, in principle: the function reads and
// writes 8 bytes per pair, 256 KiB in all at n = 2^14, well under a
// microsecond at the memory rate. In fact it is bound by the network's
// log2(n) * (log2(n) + 1) / 2 dependent stages (105 at 2^14), by the
// instructions each stage takes in one warp, and by the barriers between
// stages.
//
// Design: the n pairs are spread over a cluster of C = n / 2048 blocks
// (one block below 2048 pairs), L = n / C pairs a block, and each thread
// holds E = min(16, L) of them in registers. Which E local indices a
// thread holds is a "window": the log2(E) index bits w .. w+log2(E)-1 come
// from the register number, the other bits from the thread number. A stage
// whose partner bit lies in the window is a compare-exchange between two of
// the thread's own registers. Before a stage whose bit lies outside, the
// block re-lays its pairs through shared memory into the window that holds
// that bit (windows at bits 0, 4 and 7 of a 2048-pair block), so up to four
// stages run between two barriers: 17 re-layouts for the 66 stages inside
// a 2048-pair block. The kernel is a template on log2(L) and unrolls every
// phase inside a block, so each window, partner register and direction is a
// constant or one bit of the thread number: a stage is straight-line code,
// one compare and four selects per pair, with no branch. Shared-memory
// indices are XOR-swizzled (bits 5.. into the bank bits), so the three
// windows of a 2048-pair block store and load without bank conflicts.
// A stage whose partner lies in another block (the 6 stages with jj >= 2048
// at n = 2^14) is a push: both blocks hold their pairs in the same
// registers of the same threads, so each thread stores its 16 pairs as
// 16-byte vectors straight into the partner block's receive buffer through
// distributed shared memory (neighbouring threads on neighbouring
// addresses), the cluster waits once on cluster.sync(), and each thread
// reads the partner's pairs from its own block's buffer. Both sides decide
// the swap from the same two keys, so they agree. Nothing is read from
// another block's shared memory, so no block waits for its peers before it
// exits; two receive buffers alternate, so one cluster barrier a stage
// suffices, and a relaxed cluster arrive at the start, waited on before the
// first push, makes sure every peer is running. The wrapper launches
// through cudaLaunchKernelEx with the cluster size as a launch attribute
// and raises if the card refuses it. The kernel allocates nothing, launches
// on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogN = 14;   // 2^14 pairs at most
constexpr int kLogBlock = 11;  // 2048 pairs a block: 16 KiB a buffer
constexpr int kLogPerThread = 4;

// log2 of the pairs a thread holds in a block of 2^log_l pairs.
__host__ __device__ constexpr int log_per_thread(int log_l) {
  return log_l < kLogPerThread ? log_l : kLogPerThread;
}

// Bank swizzle: XOR bits 5.. of a local index into its bits 0..4. A
// bijection on every 32-aligned group of indices.
__device__ __forceinline__ int swizzle(int i) {
  const int x = i >> 5;
  return i ^ ((x & 15) ^ (((x >> 3) & 1) << 4));
}

// The local index of register r of thread t in the window at bit w.
template <int kLogE>
__device__ __forceinline__ int local_index(int t, int r, int w) {
  return (t & ((1 << w) - 1)) | (r << w) | ((t >> w) << (w + kLogE));
}

// The lowest bit of the window that holds bit b.
template <int kLogL>
__device__ __forceinline__ constexpr int window_of(int b) {
  constexpr int e = log_per_thread(kLogL);
  return e == 0 ? 0 : ((b / e) * e < kLogL - e ? (b / e) * e : kLogL - e);
}

// One compare-exchange under the reference's tie rule: swap = asc !=
// (a <= b), which is (a > b) != desc.
__device__ __forceinline__ void compare_exchange(int& ka, int& kb, unsigned& va, unsigned& vb,
                                                 bool desc) {
  const bool swap = (ka > kb) != desc;
  const int k0 = ka;
  const unsigned v0 = va;
  ka = swap ? kb : ka;
  kb = swap ? k0 : kb;
  va = swap ? vb : va;
  vb = swap ? v0 : vb;
}

// Re-lay the block's pairs from the window at bit `from` to the window at
// bit `to` through one shared-memory buffer (2^kLogL keys, then values).
template <int kLogL>
__device__ __forceinline__ void relayout(int (&k)[1 << log_per_thread(kLogL)],
                                         unsigned (&v)[1 << log_per_thread(kLogL)], int* buf,
                                         int t, int from, int to) {
  constexpr int kLogE = log_per_thread(kLogL);
  unsigned* vbuf = reinterpret_cast<unsigned*>(buf + (1 << kLogL));
#pragma unroll
  for (int r = 0; r < (1 << kLogE); ++r) {
    const int i = swizzle(local_index<kLogE>(t, r, from));
    buf[i] = k[r];
    vbuf[i] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < (1 << kLogE); ++r) {
    const int i = swizzle(local_index<kLogE>(t, r, to));
    k[r] = buf[i];
    v[r] = vbuf[i];
  }
}

// The stages of phase p (kk = 2^p) on the block's index bits below
// min(p, kLogL), from the window at bit 0 and back to it. Unrolled: with p
// known at compile time every window, partner and direction is a constant
// or one bit of the thread number. kAcross: a phase that also crossed
// blocks, every pair of the block sorting one way (desc_all).
template <int kLogL, bool kAcross>
__device__ __forceinline__ void merge_in_block(int p, bool desc_all, int t, int gbase,
                                               int (&k)[1 << log_per_thread(kLogL)],
                                               unsigned (&v)[1 << log_per_thread(kLogL)],
                                               int* smem, int& relayouts) {
  constexpr int kLogE = log_per_thread(kLogL);
  int w = 0;
#pragma unroll
  for (int b = kLogL - 1; b >= 0; --b) {
    if (!kAcross && b >= p) continue;
    if (b < w || b >= w + kLogE) {
      relayout<kLogL>(k, v, smem + (relayouts & 1) * 2 * (1 << kLogL), t, w, window_of<kLogL>(b));
      ++relayouts;
      w = window_of<kLogL>(b);
    }
    const int j = b - w;
#pragma unroll
    for (int r = 0; r < (1 << kLogE); ++r) {
      if (((r >> j) & 1) == 0) {
        const int h = r | (1 << j);
        const bool desc =
            kAcross ? desc_all : (((gbase | local_index<kLogE>(t, r, w)) >> p) & 1) != 0;
        compare_exchange(k[r], k[h], v[r], v[h], desc);
      }
    }
  }
}

// Grid: one cluster of 2^log_n / 2^kLogL blocks (one block when log_n <=
// kLogL) of 2^(kLogL - log2 E) threads. Dynamic shared memory: two
// re-layout buffers, and two receive buffers when the cluster has peers,
// each 2^kLogL keys then 2^kLogL values.
template <int kLogL>
__global__ void __launch_bounds__(1 << (kLogL - log_per_thread(kLogL)))
    bitonic_cluster_kernel(const int* __restrict__ keys, const unsigned* __restrict__ vals,
                           int log_n, int* __restrict__ keys_out,
                           unsigned* __restrict__ vals_out) {
  constexpr int kLogE = log_per_thread(kLogL);
  constexpr int kE = 1 << kLogE;
  constexpr int kL = 1 << kLogL;
  constexpr int kT = kL / kE;
  constexpr int kTop = kLogL - kLogE;  // lanes of a warp on consecutive indices
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x & (kT - 1);
  const int gbase = rank << kLogL;
  const bool across = log_n > kLogL;
  // peers' shared memory is written only after every block has started
  if (across) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  int k[kE];
  unsigned v[kE];
#pragma unroll
  for (int r = 0; r < kE; ++r) {  // the window at bit 0: t*E .. t*E + E - 1
    k[r] = keys[gbase + local_index<kLogE>(t, r, 0)];
    v[r] = vals[gbase + local_index<kLogE>(t, r, 0)];
  }
  int relayouts = 0;
#pragma unroll
  for (int p = 1; p <= kLogL; ++p) {
    merge_in_block<kLogL, false>(p, false, t, gbase, k, v, smem, relayouts);
  }
  if constexpr (kLogL == kLogBlock && kE % 4 == 0) {
    if (across) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      int crossings = 0;
      for (int p = kLogL + 1; p <= log_n; ++p) {
        const bool desc_all = ((gbase >> p) & 1) != 0;
        for (int b = p - 1; b >= kLogL; --b) {
          // the partner holds the same local indices in the same registers
          // of the same thread: push ours into its receive buffer, 16 bytes
          // a store, neighbouring threads on neighbouring addresses
          const int bit = 1 << (b - kLogL);
          const bool low_side = (rank & bit) == 0;
          int4* in_k = smem4 + (4 + 2 * (crossings & 1)) * kL / 4;
          int4* in_v = in_k + kL / 4;
          int4* out_k = cluster.map_shared_rank(in_k, static_cast<unsigned>(rank ^ bit));
          int4* out_v = cluster.map_shared_rank(in_v, static_cast<unsigned>(rank ^ bit));
#pragma unroll
          for (int q = 0; q < kE / 4; ++q) {
            out_k[q * kT + t] = make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
            out_v[q * kT + t] =
                make_int4(static_cast<int>(v[4 * q]), static_cast<int>(v[4 * q + 1]),
                          static_cast<int>(v[4 * q + 2]), static_cast<int>(v[4 * q + 3]));
          }
          cluster.sync();
#pragma unroll
          for (int q = 0; q < kE / 4; ++q) {
            const int4 pk = in_k[q * kT + t];
            const int4 pv = in_v[q * kT + t];
            const int theirs[4] = {pk.x, pk.y, pk.z, pk.w};
            const int theirs_v[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 4 * q + e;
              // either side keeps the partner's pair exactly when the pair swaps
              const bool swap = (low_side ? k[r] > theirs[e] : theirs[e] > k[r]) != desc_all;
              k[r] = swap ? theirs[e] : k[r];
              v[r] = swap ? static_cast<unsigned>(theirs_v[e]) : v[r];
            }
          }
          ++crossings;
        }
        merge_in_block<kLogL, true>(p, desc_all, t, gbase, k, v, smem, relayouts);
      }
    }
  }
  // every phase ends in the window at bit 0; store from the top window, where
  // a warp's lanes write consecutive words
  if constexpr (kTop > 0) relayout<kLogL>(k, v, smem + (relayouts & 1) * 2 * kL, t, 0, kTop);
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    keys_out[gbase + local_index<kLogE>(t, r, kTop)] = k[r];
    vals_out[gbase + local_index<kLogE>(t, r, kTop)] = v[r];
  }
}

template <int kLogL>
cudaError_t launch(const int* keys, const unsigned* vals, int log_n, int log_l, int* keys_out,
                   unsigned* vals_out, cudaStream_t stream) {
  if constexpr (kLogL < kLogBlock) {
    if (log_l > kLogL) {
      return launch<kLogL + 1>(keys, vals, log_n, log_l, keys_out, vals_out, stream);
    }
  }
  const int blocks = 1 << (log_n - kLogL);
  const int buffers = blocks > 1 ? 4 : 2;
  const size_t smem = static_cast<size_t>(buffers) * 2 * (size_t{1} << kLogL) * sizeof(int);
  // per launch, not once: the limit is an attribute of the current device
  cudaError_t err = cudaFuncSetAttribute(bitonic_cluster_kernel<kLogL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(1 << (kLogL - log_per_thread(kLogL)), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bitonic_cluster_kernel<kLogL>, keys, vals, log_n, keys_out,
                           vals_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int bitonic_sort_pairs_launch(const int* keys, const unsigned* vals, int n,
                                         int* keys_out, unsigned* vals_out,
                                         cudaStream_t stream) {
  if (n <= 0 || n > (1 << kMaxLogN) || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int log_l = log_n < kLogBlock ? log_n : kLogBlock;
  return static_cast<int>(launch<0>(keys, vals, log_n, log_l, keys_out, vals_out, stream));
}
