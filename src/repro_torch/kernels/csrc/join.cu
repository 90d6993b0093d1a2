// Hash-join probe kernels (paper §V, Figs. 7-8) for Hopper (sm_90a).
//
// probe_counts_i32 replaces probe_counts_pallas / _probe_counts_kernel /
//   _lower_bound in src/repro/kernels/join/join.py.  For every probe key it
//   returns the bucket start (lower bound) and the exact match count (upper
//   bound - start) over the sorted build side: torch.searchsorted's left
//   and right bounds, for every int32 key.
//   Bound: device-memory bytes (4 B key read, 8 B written per probe row; the
//   table is read once).  The two searches cost 2*(log2(ts)+1) compares a
//   row, below the integer rate for every table the executor builds.
//   Design: one thread per probe key, a branchless binary search over the
//   table held in global memory and read through L2/L1 (__ldg).  The
//   pipeline's build side is the whole build table (millions of keys, tens
//   of MB), so it is not tiled into shared memory the way the TPU kernel
//   held one block in VMEM; the first levels of every search hit the same
//   few entries, which stay cached.  The search runs over the table padded
//   to a power of two, and the padding is virtual: positions >= n_s read as
//   2**31 - 1, which sorts at or above every int32 key, and both bounds are
//   clamped to n_s.  So no padded copy is made, and a key equal to
//   2**31 - 1 counts only real entries (the TPU kernel counted its pads).
//   Each search is a chain of dependent loads; this first version hides
//   their latency only through occupancy, so it runs well below the byte
//   bound (its measured share is in PERF.md).
//
// probe_multi_i32 replaces probe_multi_pallas / _probe_multi_kernel in the
//   same file: the bucket (start, count) of probe_counts_i32, plus an
//   (n, cap) matrix of the bucket's first `cap` build rows read through
//   `order` (sorted position -> build row), -1 past the count.  Chains
//   longer than `cap` are completed by the caller's overflow pass.
//   Bound: device-memory bytes (4 B key read, (8 + 4 * cap) B written per
//   probe row; table and order read once).
//   Design: B2's thread per key and its two clamped, virtually padded
//   searches, then up to `cap` reads of `order` from the bucket start,
//   which are contiguous, and a row of `cap` int32 stores.  The reference
//   padded `order` with -1 to the table's power of two; the clamp keeps
//   every read inside the real table, so no padded copy is made.
//
// hash_probe_i32 replaces probe_pallas / _probe_kernel in the same file:
//   Knuth multiplicative hash (k * 2654435769) & (ts - 1), a linear probe
//   bounded at probe_depth where the first hit wins, the matched build row
//   or -1, and a match count per logical block.
//   Bound: device-memory bytes (probe keys in, s_idx out, the 2*ts*4 B
//   table read once).
//   Design: the 32768-slot key+value table is 256 KB, over the 227 KB of
//   shared memory a block can use, so it stays in global memory and is
//   served from L2 (50 MB).  The hash multiplies as unsigned 32-bit, which
//   wraps exactly like the reference's int32 product.  One CUDA block per
//   logical block strides its rows and reduces its count in shared memory,
//   like the selection kernel; the ragged tail is masked by the loop bound.
#include "common.cuh"

namespace {

using repro_torch::block_sum;
using repro_torch::kThreads;

constexpr int32_t kPadSentinel = 2147483647;  // 2**31 - 1
constexpr uint32_t kKnuth = 2654435769u;      // the int32 -1640531527

__device__ __forceinline__ int32_t table_at(const int32_t* __restrict__ a,
                                            int64_t n_s, int64_t i) {
  return i < n_s ? __ldg(a + i) : kPadSentinel;
}

// First index in [0, ts] with a[idx] >= q (kStrict = false) or a[idx] > q
// (kStrict = true), for ts a power of two.  Invariant: the answer lies in
// [base, base + len]; each step halves len without a branch.
template <bool kStrict>
__device__ __forceinline__ int64_t bound_pow2(const int32_t* __restrict__ a,
                                              int64_t n_s, int64_t ts,
                                              int32_t q) {
  int64_t base = 0;
  for (int64_t half = ts >> 1; half > 0; half >>= 1) {
    const int32_t v = table_at(a, n_s, base + half - 1);
    const bool right = kStrict ? (v <= q) : (v < q);
    base += right ? half : 0;
  }
  const int32_t v = table_at(a, n_s, base);
  return base + ((kStrict ? (v <= q) : (v < q)) ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads)
probe_counts_kernel(const int32_t* __restrict__ s_sorted, int64_t n_s,
                    int64_t ts, const int32_t* __restrict__ keys, int64_t n,
                    int32_t* __restrict__ start, int32_t* __restrict__ count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t q = keys[i];
  const int64_t lo_p = bound_pow2<false>(s_sorted, n_s, ts, q);
  const int64_t hi_p = bound_pow2<true>(s_sorted, n_s, ts, q);
  const int64_t lo = lo_p < n_s ? lo_p : n_s;
  const int64_t hi = hi_p < n_s ? hi_p : n_s;
  start[i] = static_cast<int32_t>(lo);
  count[i] = static_cast<int32_t>(hi - lo);
}

__global__ void __launch_bounds__(kThreads)
probe_multi_kernel(const int32_t* __restrict__ s_sorted,
                   const int32_t* __restrict__ order, int64_t n_s,
                   int64_t ts, const int32_t* __restrict__ keys, int64_t n,
                   int32_t cap, int32_t* __restrict__ mat,
                   int32_t* __restrict__ start, int32_t* __restrict__ count) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t q = keys[i];
  const int64_t lo_p = bound_pow2<false>(s_sorted, n_s, ts, q);
  const int64_t hi_p = bound_pow2<true>(s_sorted, n_s, ts, q);
  const int64_t lo = lo_p < n_s ? lo_p : n_s;
  const int64_t hi = hi_p < n_s ? hi_p : n_s;
  start[i] = static_cast<int32_t>(lo);
  count[i] = static_cast<int32_t>(hi - lo);
  int32_t* row = mat + i * cap;
  for (int32_t k = 0; k < cap; ++k)
    row[k] = lo + k < hi ? __ldg(order + lo + k) : -1;
}

__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ ht_keys,
                  const int32_t* __restrict__ ht_vals, int64_t ts,
                  const int32_t* __restrict__ keys, int64_t n,
                  int32_t probe_depth, int64_t block,
                  int32_t* __restrict__ s_idx, int32_t* __restrict__ counts) {
  const uint32_t mask = static_cast<uint32_t>(ts - 1);
  const int64_t b = blockIdx.x;
  const int64_t begin = b * block;
  const int64_t end = begin + block < n ? begin + block : n;
  int local = 0;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const int32_t k = keys[i];
    const uint32_t h = static_cast<uint32_t>(k) * kKnuth;
    int32_t r = -1;
    for (int32_t d = 0; d < probe_depth; ++d) {
      const uint32_t slot = (h + static_cast<uint32_t>(d)) & mask;
      if (r < 0 && __ldg(ht_keys + slot) == k) r = __ldg(ht_vals + slot);
    }
    s_idx[i] = r;
    local += r >= 0;
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0) counts[b] = total;
}

}  // namespace

// The launchers run on `stream` and return cudaGetLastError().
extern "C" int probe_counts_i32(const void* s_sorted, int64_t n_s, int64_t ts,
                                const void* keys, int64_t n, void* start,
                                void* count, void* stream) {
  if (n > 0) {
    const int64_t grid = (n + kThreads - 1) / kThreads;
    probe_counts_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(s_sorted), n_s, ts,
        static_cast<const int32_t*>(keys), n, static_cast<int32_t*>(start),
        static_cast<int32_t*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_multi_i32(const void* s_sorted, const void* order,
                               int64_t n_s, int64_t ts, const void* keys,
                               int64_t n, int32_t cap, void* mat, void* start,
                               void* count, void* stream) {
  if (n > 0) {
    const int64_t grid = (n + kThreads - 1) / kThreads;
    probe_multi_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(s_sorted),
        static_cast<const int32_t*>(order), n_s, ts,
        static_cast<const int32_t*>(keys), n, cap, static_cast<int32_t*>(mat),
        static_cast<int32_t*>(start), static_cast<int32_t*>(count));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hash_probe_i32(const void* ht_keys, const void* ht_vals,
                              int64_t ts, const void* keys, int64_t n,
                              int32_t probe_depth, int64_t block, void* s_idx,
                              void* counts, void* stream) {
  const int64_t n_blocks = (n + block - 1) / block;
  if (n_blocks > 0) {
    hash_probe_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ht_keys),
        static_cast<const int32_t*>(ht_vals), ts,
        static_cast<const int32_t*>(keys), n, probe_depth, block,
        static_cast<int32_t*>(s_idx), static_cast<int32_t*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
