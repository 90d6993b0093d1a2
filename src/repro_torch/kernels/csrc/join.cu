// Hash-join probe kernels (paper §V, Figs. 7-8) for Hopper (sm_90a).
//
// probe_counts_i32 replaces probe_counts_pallas / _probe_counts_kernel /
//   _lower_bound in src/repro/kernels/join/join.py.  For every probe key it
//   returns the bucket start (lower bound) and the exact match count (upper
//   bound - start) over the sorted build side: torch.searchsorted's left
//   and right bounds, for every int32 key.
//   Bound: device-memory bytes (4 B key read, 8 B written per probe row; the
//   table is read once).  At SSB SF 10 (2,556 keys, 59,986,214 probes) that
//   is 720 MB, 0.215 ms at 3.35 TB/s.
//   Design: the search runs over the table padded to a power of two ts, and
//   the padding is virtual in device memory: positions >= n_s hold
//   2**31 - 1, which sorts at or above every int32 key, and both bounds are
//   clamped to n_s, so a key equal to 2**31 - 1 counts only real entries
//   (the TPU kernel counted its pads).  The keys a search reads first sit in
//   shared memory as a breadth-first (Eytzinger) tree.  Each block of the
//   probe loads them once and runs a grid-stride loop over the probe keys,
//   on a grid of a few blocks an SM.  A thread takes 4 keys at a time (one
//   int4 load where the keys are 16-byte aligned, a scalar head and tail
//   otherwise) and interleaves their four branchless descents.  The tree
//   matters for the banks: the positions base + half - 1 a plain binary
//   search reads all lie in one bank of shared memory from half >= 32 on,
//   so a warp's deep levels serialise up to 32 ways, while one level of
//   the tree is contiguous and spreads over every bank.  The upper bound
//   comes from the lower one: a key whose entry at the lower bound
//   differs matches nothing; otherwise a gallop (1, 2, 4, ... past it,
//   then a binary search) finds the end of its run, log2(count) + 1
//   steps.  Indices are int32 (the wrapper keeps n_s < 2**31 - 1).  Two
//   routes, chosen by the wrapper from n_s (join.probe_counts_route):
//   * shared (ts <= kSharedMax = 8,192 keys): each block copies the
//     padded table into shared memory and builds the tree from it there,
//     64 KB for both at most, so three blocks fit an SM and no other launch
//     is needed.  This covers SSB's date keys and the eager join's pass
//     blocks of 8,192;
//   * sampled (larger tables: a pipeline's whole build side): a first
//     launch gathers kSample = 8,192 keys, every (ts / 8,192)-th, as a tree
//     into scratch, and each block copies it to shared memory.  The tree
//     narrows a key to ts / 8,192 positions, binary steps in device memory
//     narrow those to a window of 16 (fewer for a smaller step), which is
//     read as int4 loads and counted: the keys below q give the lower
//     bound, the keys equal to q the count, and only a run past the window
//     gallops on.
//   PERF.md keeps its time beside the bound and two torch.searchsorted.
//
// probe_multi_i32 replaces probe_multi_pallas / _probe_multi_kernel in the
//   same file: the bucket (start, count) of probe_counts_i32, plus an
//   (n, cap) matrix of the bucket's first `cap` build rows read through
//   `order` (sorted position -> build row), -1 past the count.  Chains
//   longer than `cap` are completed by the caller's overflow pass.
//   Bound: device-memory bytes (4 B key read, (8 + 4 * cap) B written per
//   probe row; table and order read once).
//   Design: a thread per key and two clamped, virtually padded binary
//   searches over the table in device memory (bound_pow2), then up to
//   `cap` reads of `order` from the bucket start, which are contiguous,
//   and a row of `cap` int32 stores.  The reference
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

constexpr int32_t kSharedMax = 8192;   // shared route: ts <= 8,192 keys
constexpr int kSampleLevels = 13;      // sampled route: a tree of 8,192 keys
constexpr int32_t kSample = 1 << kSampleLevels;
constexpr int kKeys = 4;               // keys a thread searches at a time

// A search tree over 2**L sorted positions, stored breadth first
// (Eytzinger order): node k >= 1 of depth d = floor(log2 k) is sorted
// position ((2 (k - 2**d) + 1) << (L - 1 - d)) - 1, and node 0 holds the
// one position the tree leaves out, 2**L - 1.  The nodes a level of the
// search reads are contiguous, so a warp's loads of one level spread over
// all 32 banks, where the sorted positions base + half - 1 of a plain
// binary search all lie in one bank from half >= 32 on.
__device__ __forceinline__ int32_t tree_to_sorted(int32_t k, int levels) {
  if (k == 0) return (1 << levels) - 1;
  const int d = 31 - __clz(k);
  return (((k - (1 << d)) * 2 + 1) << (levels - 1 - d)) - 1;
}

// After `levels` steps k = 2 k + (tree[k] < q) from k = 1, k - 2**levels is
// the number of the tree's 2**levels - 1 keys below q: the path's bits.
template <int K>
__device__ __forceinline__ void descend(const int32_t* tree, int levels,
                                        const int32_t (&q)[K],
                                        int32_t (&below)[K]) {
  int32_t k[K];
#pragma unroll
  for (int j = 0; j < K; ++j) k[j] = 1;
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int j = 0; j < K; ++j) k[j] = 2 * k[j] + (tree[k[j]] < q[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) below[j] = k[j] - (1 << levels);
}

// Entries at and past the (clamped) lower bound lo are >= q: the run of q
// starts at lo if it starts at all.  Gallop to a position past its end,
// then binary-search the last gap.  lo + b and lo + mid stay below n_s, and
// 2 b is taken only while b <= rem / 2, so nothing overflows int32.
template <class Table>
__device__ __forceinline__ int32_t run_length(const Table& t, int32_t lo,
                                              int32_t q) {
  if (lo >= t.n_s || t.at(lo) != q) return 0;
  const int32_t rem = t.n_s - lo;
  int32_t a = 1, b = 1, hi;           // t.at(lo + i) == q for every i < a
  for (;;) {
    if (b >= rem) { hi = rem; break; }
    if (t.at(lo + b) != q) { hi = b; break; }
    a = b + 1;
    b = b > (rem >> 1) ? rem : 2 * b;
  }
  while (a < hi) {                    // the run ends in [a, hi]
    const int32_t mid = a + ((hi - a) >> 1);
    if (t.at(lo + mid) == q) a = mid + 1; else hi = mid;
  }
  return a;
}

// The shared route: the whole table, padded to ts = 2**levels, in shared
// memory, sorted and as a tree.
struct SharedTable {
  const int32_t* sorted;
  const int32_t* tree;
  int32_t n_s;
  int levels;

  __device__ __forceinline__ int32_t at(int32_t i) const { return sorted[i]; }

  // the lower bound is the count below q among positions 0 .. ts - 2,
  // plus one if all of those and position ts - 1 (node 0) are below q
  __device__ __forceinline__ void probe(const int32_t (&q)[kKeys],
                                        int32_t (&lo)[kKeys],
                                        int32_t (&count)[kKeys]) const {
    descend(tree, levels, q, lo);
    const int32_t last = (1 << levels) - 1;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      lo[j] += lo[j] == last && tree[0] < q[j];
      lo[j] = min(lo[j], n_s);
      count[j] = run_length(*this, lo[j], q[j]);
    }
  }
};

// The sampled route: every step-th key (positions (m + 1) step - 1, step =
// ts / kSample) as a tree in shared memory; the table in device memory,
// virtually padded.  The tree narrows a search to step keys from base;
// binary steps from device memory narrow it to a window of kWindow (step
// if smaller), which is read as int4 vectors and counted: the keys below q
// give the lower bound, the keys equal to q the count, unless the run
// reaches past the window.
template <int kWindow>
struct SampledTable {
  const int32_t* tree;
  const int32_t* __restrict__ s;
  int32_t n_s, step, log_step;
  bool aligned;                       // s is 16-byte aligned

  __device__ __forceinline__ int32_t at(int32_t i) const {
    return i < n_s ? __ldg(s + i) : kPadSentinel;
  }

  __device__ __forceinline__ void probe(const int32_t (&q)[kKeys],
                                        int32_t (&lo)[kKeys],
                                        int32_t (&count)[kKeys]) const {
    int32_t base[kKeys];
    descend(tree, kSampleLevels, q, base);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) base[j] <<= log_step;
    for (int32_t half = step >> 1; half >= kWindow; half >>= 1) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        base[j] += at(base[j] + half - 1) < q[j] ? half : 0;
    }
    int32_t lt[kKeys], eq[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      lt[j] = 0;
      eq[j] = 0;
      if (kWindow % 4 == 0 && aligned && base[j] + kWindow <= n_s) {
        const int4* w = reinterpret_cast<const int4*>(s + base[j]);
#pragma unroll
        for (int t = 0; t < kWindow / 4; ++t) {
          const int4 v = __ldg(w + t);
          lt[j] += (v.x < q[j]) + (v.y < q[j]) + (v.z < q[j]) + (v.w < q[j]);
          eq[j] += (v.x == q[j]) + (v.y == q[j]) + (v.z == q[j]) +
                   (v.w == q[j]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < kWindow; ++t) {
          if (base[j] + t < n_s) {
            const int32_t v = __ldg(s + base[j] + t);
            lt[j] += v < q[j];
            eq[j] += v == q[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      lo[j] = min(base[j] + lt[j], n_s);
      count[j] = eq[j];
      if (eq[j] > 0 && lt[j] + eq[j] == kWindow &&
          base[j] + kWindow < n_s)
        count[j] += run_length(*this, base[j] + kWindow, q[j]);
    }
  }
};

// Grid-stride over the keys, four at a time: a scalar head up to the first
// 16-byte boundary of `keys`, int4 groups, a scalar tail.
template <class Table>
__device__ __forceinline__ void probe_all(const Table& t,
                                          const int32_t* __restrict__ keys,
                                          int64_t n,
                                          int32_t* __restrict__ start,
                                          int32_t* __restrict__ count) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(keys);
  const int64_t to_16 = static_cast<int64_t>(((16 - (addr & 15)) & 15) >> 2);
  const int64_t head = to_16 < n ? to_16 : n;
  const int64_t n_vec = (n - head) / kKeys;
  const int64_t tail = head + kKeys * n_vec;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the head and the tail: at most 3 keys each, by the grid's first threads
  const int64_t edge = tid < head ? tid : tail + (tid - head);
  if (tid < head + (n - tail)) {
    const int32_t k = __ldg(keys + edge);
    const int32_t q[kKeys] = {k, k, k, k};
    int32_t lo[kKeys], c[kKeys];
    t.probe(q, lo, c);
    start[edge] = lo[0];
    count[edge] = c[0];
  }
  const bool vec_out = ((reinterpret_cast<uintptr_t>(start + head) |
                         reinterpret_cast<uintptr_t>(count + head)) & 15) == 0;
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  for (int64_t v = tid; v < n_vec; v += stride) {
    const int4 kv = __ldg(k4 + v);
    const int32_t q[kKeys] = {kv.x, kv.y, kv.z, kv.w};
    int32_t lo[kKeys], c[kKeys];
    t.probe(q, lo, c);
    const int64_t i = head + kKeys * v;
    if (vec_out) {
      *reinterpret_cast<int4*>(start + i) =
          make_int4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<int4*>(count + i) =
          make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        start[i + j] = lo[j];
        count[i + j] = c[j];
      }
    }
  }
}

// tree[k] = the key at sorted position (tree_to_sorted(k) + 1) step - 1,
// 2**31 - 1 past the table: the sampled route's tree of kSample keys.
__global__ void __launch_bounds__(kThreads)
build_tree_kernel(const int32_t* __restrict__ s_sorted, int32_t n_s,
                  int32_t step, int32_t* __restrict__ tree) {
  const int32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= kSample) return;
  const int64_t pos =
      static_cast<int64_t>(tree_to_sorted(k, kSampleLevels) + 1) * step - 1;
  tree[k] = pos < n_s ? __ldg(s_sorted + pos) : kPadSentinel;
}

// Each block stages the table (coalesced), builds the tree from it in
// shared memory, then probes.
__global__ void __launch_bounds__(kThreads)
probe_counts_shared_kernel(const int32_t* __restrict__ s_sorted, int32_t n_s,
                           int levels, const int32_t* __restrict__ keys,
                           int64_t n, int32_t* __restrict__ start,
                           int32_t* __restrict__ count) {
  extern __shared__ int4 smem4[];
  const int32_t ts = 1 << levels;
  int32_t* sorted = reinterpret_cast<int32_t*>(smem4);
  int32_t* tree = sorted + ts;
  // the padded table: int4 loads where s_sorted is 16-byte aligned, all of
  // a thread's loads in flight at once
  if ((reinterpret_cast<uintptr_t>(s_sorted) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s_sorted);
#pragma unroll 8
    for (int32_t i = threadIdx.x; i < ts / 4; i += kThreads) {
      int4 v;
      if (4 * i + 3 < n_s) {
        v = __ldg(s4 + i);
      } else {
        v.x = 4 * i < n_s ? __ldg(s_sorted + 4 * i) : kPadSentinel;
        v.y = 4 * i + 1 < n_s ? __ldg(s_sorted + 4 * i + 1) : kPadSentinel;
        v.z = 4 * i + 2 < n_s ? __ldg(s_sorted + 4 * i + 2) : kPadSentinel;
        v.w = kPadSentinel;
      }
      smem4[i] = v;
    }
  } else {
#pragma unroll 8
    for (int32_t i = threadIdx.x; i < ts; i += kThreads)
      sorted[i] = i < n_s ? __ldg(s_sorted + i) : kPadSentinel;
  }
  __syncthreads();
  for (int32_t k = threadIdx.x; k < ts; k += kThreads)
    tree[k] = sorted[tree_to_sorted(k, levels)];
  __syncthreads();
  probe_all(SharedTable{sorted, tree, n_s, levels}, keys, n, start, count);
}

template <int kWindow>
__global__ void __launch_bounds__(kThreads)
probe_counts_sampled_kernel(const int32_t* __restrict__ s_sorted,
                            int32_t n_s, int32_t log_step,
                            const int32_t* __restrict__ tree_g,
                            const int32_t* __restrict__ keys, int64_t n,
                            int32_t* __restrict__ start,
                            int32_t* __restrict__ count) {
  __shared__ int4 tree4[kSample / 4];
  const int4* src = reinterpret_cast<const int4*>(tree_g);
  for (int i = threadIdx.x; i < kSample / 4; i += kThreads)
    tree4[i] = __ldg(src + i);
  __syncthreads();
  const int32_t* tree = reinterpret_cast<const int32_t*>(tree4);
  const bool aligned = (reinterpret_cast<uintptr_t>(s_sorted) & 15) == 0;
  probe_all(SampledTable<kWindow>{tree, s_sorted, n_s, int32_t{1} << log_step,
                                  log_step, aligned},
            keys, n, start, count);
}

// Blocks for a grid-stride probe: enough for every group of four keys up
// to as many as fit on the card at once.  The card's occupancy for the
// kernel is asked once per shared-memory size.
template <auto kKernel>
int64_t probe_grid(size_t smem, int64_t n) {
  static int sms = 0, per_sm = 0;
  static size_t asked = ~size_t{0};
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (asked != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads,
                                                  smem);
    asked = smem;
  }
  const int64_t want = (n + kThreads * kKeys - 1) / (kThreads * kKeys);
  const int64_t most = static_cast<int64_t>(max(per_sm, 1)) * max(sms, 1);
  return want < most ? want : most;
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

template <int kWindow>
void launch_sampled(const int32_t* s, int32_t n_s, int32_t log_step,
                    const int32_t* tree, const void* keys, int64_t n,
                    void* start, void* count, cudaStream_t st) {
  const int64_t grid = probe_grid<probe_counts_sampled_kernel<kWindow>>(0, n);
  probe_counts_sampled_kernel<kWindow>
      <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          s, n_s, log_step, tree, static_cast<const int32_t*>(keys), n,
          static_cast<int32_t*>(start), static_cast<int32_t*>(count));
}

}  // namespace

// The launchers run on `stream` and return cudaGetLastError().
// ts is the power of two the table is padded to (>= 4).  `scratch` is
// null for the shared route (ts <= kSharedMax), and 16-byte-aligned device
// memory for kSample int32 (the search tree) for the sampled route.
extern "C" int probe_counts_i32(const void* s_sorted, int64_t n_s, int64_t ts,
                                const void* keys, int64_t n, void* start,
                                void* count, void* scratch, void* stream) {
  if (ts < 4 || (ts & (ts - 1)) || n_s > ts || ts > (int64_t{1} << 31) ||
      (scratch == nullptr) != (ts <= kSharedMax) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(s_sorted);
  const int32_t ns = static_cast<int32_t>(n_s);
  int log_ts = 0;
  while ((int64_t{1} << log_ts) < ts) ++log_ts;
  if (ts <= kSharedMax) {
    const size_t smem = 2 * sizeof(int32_t) * static_cast<size_t>(ts);
    if (smem > 48 * 1024) {
      static bool raised = false;
      if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            probe_counts_shared_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(2 * sizeof(int32_t) * kSharedMax));
        if (err != cudaSuccess) return static_cast<int>(err);
        raised = true;
      }
    }
    const int64_t grid = probe_grid<probe_counts_shared_kernel>(smem, n);
    probe_counts_shared_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                                 st>>>(
        s, ns, log_ts, static_cast<const int32_t*>(keys), n,
        static_cast<int32_t*>(start), static_cast<int32_t*>(count));
  } else {
    const int32_t log_step = log_ts - kSampleLevels;     // >= 1
    int32_t* tree = static_cast<int32_t*>(scratch);
    build_tree_kernel<<<kSample / kThreads, kThreads, 0, st>>>(
        s, ns, int32_t{1} << log_step, tree);
    if (log_step == 1)
      launch_sampled<2>(s, ns, log_step, tree, keys, n, start, count, st);
    else if (log_step == 2)
      launch_sampled<4>(s, ns, log_step, tree, keys, n, start, count, st);
    else if (log_step == 3)
      launch_sampled<8>(s, ns, log_step, tree, keys, n, start, count, st);
    else
      launch_sampled<16>(s, ns, log_step, tree, keys, n, start, count, st);
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
