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
//   on a grid of a few blocks an SM.  A warp takes 128 keys at a time,
//   lane l the keys l + 32 j, j < 4 (coalesced at any alignment; where
//   the probe keys are sorted, one j's 32 searches read neighbouring
//   entries and share lines), and a thread interleaves its four
//   branchless descents.  The tree
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
//   longer than `cap` are completed by the caller's overflow pass; the
//   count stays exact past `cap`.
//   Bound: device-memory bytes (4 B key read, (8 + 4 * cap) B written per
//   probe row; table and order read once).  At TPC-H SF 1's order keys
//   (6,001,215 build rows, 1,500,000 probes, cap 8) that is 114 MB,
//   0.034 ms at 3.35 TB/s.
//   Design: the search is probe_counts_i32's, on the same two routes and
//   through the same code (probe_all with a Table and an output), so
//   (start, count) equal probe_counts_i32's bit for bit.  A warp's 128
//   rows of `mat` are contiguous, and so are a bucket's first
//   min(count, cap) build rows in `order`.  Where cap % 4 == 0 (every row
//   starts on a 16-byte mark) the warp writes its rows as int4 chunks,
//   lane l the chunks l, l + 32, ..., so that each store instruction
//   covers 512 contiguous bytes; a chunk's bucket comes by shuffles from
//   the lane that searched it.  A lane writing its own rows as int4s (a
//   row's 32 bytes at 128-byte strides across the warp) took 3.5 times as
//   long on an H100 at the 50-key dimension's shape (PERF.md).  Other
//   caps store a lane's own rows as scalars.  The clamp keeps every read
//   inside the real table, so `order` needs no padded copy.
//
// hash_probe_i32 replaces probe_pallas / _probe_kernel in the same file:
//   Knuth multiplicative hash (k * 2654435769) & (ts - 1), a linear probe
//   bounded at probe_depth where the first hit wins, the matched build row
//   or -1, and a match count per logical block of `block` rows.
//   Bound: device-memory bytes (probe keys in, s_idx out, the 2*ts*4 B
//   table read once).  At SSB's eager join (2 x 32,768 slots, 1,192,560
//   probes) that is 9.8 MB, 0.0029 ms at 3.35 TB/s.
//   Design: the 32768-slot key+value table is 256 KB, over the 227 KB of
//   shared memory a block can use, so it stays in global memory and is
//   served from L2 (50 MB).  The kernel is latency-bound, so it keeps many
//   rows in flight: a warp takes 128 contiguous rows, lane l the rows
//   l + 32 j, j < 4 (coalesced loads and stores at any alignment), and a
//   thread probes its four together.  The slots a row's walk reads are
//   read as 16-byte windows of four aligned slots, all four rows' windows
//   loaded before any is compared, and the first hit is picked in
//   registers, so no load waits on an earlier compare; a row needs
//   another window only if the walk goes past this one, and reads ht_vals
//   only on a hit.  The counts of a logical block are summed per warp
//   (per row where a warp's rows straddle two logical blocks) and added
//   with atomicAdd into `counts`, which the launcher zeroes first, so they
//   are exact for any `block`.  The hash multiplies as unsigned 32-bit, which wraps exactly
//   like the reference's int32 product.
#include "common.cuh"

namespace {

using repro_torch::kThreads;

constexpr int32_t kPadSentinel = 2147483647;  // 2**31 - 1
constexpr uint32_t kKnuth = 2654435769u;      // the int32 -1640531527
constexpr int32_t kSharedMax = 8192;   // shared route: ts <= 8,192 keys
constexpr int kSampleLevels = 13;      // sampled route: a tree of 8,192 keys
constexpr int32_t kSample = 1 << kSampleLevels;
static_assert(kSample / 4 % kThreads == 0, "a block copies the tree evenly");
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

// v sorts before the first position a search looks for: the first entry
// >= q (the lower bound), or with kStrict the first entry > q (the upper
// bound).
template <bool kStrict>
__device__ __forceinline__ bool before(int32_t v, int32_t q) {
  return kStrict ? v <= q : v < q;
}

// After `levels` steps k = 2 k + before(tree[k], q) from k = 1,
// k - 2**levels is the number of the tree's 2**levels - 1 keys before q:
// the path's bits.
template <bool kStrict = false, int K>
__device__ __forceinline__ void descend(const int32_t* tree, int levels,
                                        const int32_t (&q)[K],
                                        int32_t (&below)[K]) {
  int32_t k[K];
#pragma unroll
  for (int j = 0; j < K; ++j) k[j] = 1;
  for (int l = 0; l < levels; ++l) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      k[j] = 2 * k[j] + before<kStrict>(tree[k[j]], q[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) below[j] = k[j] - (1 << levels);
}

// Entries at and past the (clamped) lower bound lo are >= q: the run of q
// starts at lo if it starts at all.  Gallop to a position past its end,
// then binary-search the last gap; -1 if the run reaches past lo + limit
// (the caller then searches for its end).  lo + b and lo + mid stay below
// n_s, and 2 b is taken only while b <= rem / 2, so nothing overflows
// int32.
template <class Table>
__device__ __forceinline__ int32_t run_length(const Table& t, int32_t lo,
                                              int32_t q, int32_t limit) {
  if (lo >= t.n_s || t.at(lo) != q) return 0;
  const int32_t rem = t.n_s - lo;
  int32_t a = 1, b = 1, hi;           // t.at(lo + i) == q for every i < a
  for (;;) {
    if (b >= rem) { hi = rem; break; }
    if (t.at(lo + b) != q) { hi = b; break; }
    if (b >= limit) return -1;
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
      count[j] = run_length(*this, lo[j], q[j], n_s);
    }
  }
};

// The sampled route: every step-th key (positions (m + 1) step - 1, step =
// ts / kSample) as a tree in shared memory; the table in device memory,
// virtually padded.  The tree narrows a search to step keys from base;
// binary steps from device memory narrow it to a window of kWindow (step
// if smaller), which is read as int4 vectors and counted: the keys before
// the bound give it, the keys equal to q the count, unless the run
// reaches past the window.  Then a short run's end is found by a gallop
// of up to kWindow past it, a longer run's by a second search, for the
// upper bound, which costs as many loads as the first whatever the run's
// length.
template <int kWindow>
struct SampledTable {
  const int32_t* tree;
  const int32_t* __restrict__ s;
  int32_t n_s, step, log_step;
  bool aligned;                       // s is 16-byte aligned

  __device__ __forceinline__ int32_t at(int32_t i) const {
    return i < n_s ? __ldg(s + i) : kPadSentinel;
  }

  // The window [base, base + kWindow] holding each key's bound (see
  // before()); ahead[j] counts the window's real entries before it, same[j]
  // those equal to q[j].
  template <bool kStrict>
  __device__ __forceinline__ void narrow(const int32_t (&q)[kKeys],
                                         int32_t (&base)[kKeys],
                                         int32_t (&ahead)[kKeys],
                                         int32_t (&same)[kKeys]) const {
    descend<kStrict>(tree, kSampleLevels, q, base);
#pragma unroll
    for (int j = 0; j < kKeys; ++j) base[j] <<= log_step;
    for (int32_t half = step >> 1; half >= kWindow; half >>= 1) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        base[j] += before<kStrict>(at(base[j] + half - 1), q[j]) ? half : 0;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      ahead[j] = 0;
      same[j] = 0;
      if (kWindow % 4 == 0 && aligned && base[j] + kWindow <= n_s) {
        const int4* w = reinterpret_cast<const int4*>(s + base[j]);
#pragma unroll
        for (int t = 0; t < kWindow / 4; ++t) {
          const int4 v = __ldg(w + t);
          ahead[j] += before<kStrict>(v.x, q[j]) + before<kStrict>(v.y, q[j]) +
                      before<kStrict>(v.z, q[j]) + before<kStrict>(v.w, q[j]);
          same[j] += (v.x == q[j]) + (v.y == q[j]) + (v.z == q[j]) +
                     (v.w == q[j]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < kWindow; ++t) {
          if (base[j] + t < n_s) {
            const int32_t v = __ldg(s + base[j] + t);
            ahead[j] += before<kStrict>(v, q[j]);
            same[j] += v == q[j];
          }
        }
      }
    }
  }

  __device__ __forceinline__ void probe(const int32_t (&q)[kKeys],
                                        int32_t (&lo)[kKeys],
                                        int32_t (&count)[kKeys]) const {
    int32_t base[kKeys], lt[kKeys], eq[kKeys];
    narrow<false>(q, base, lt, eq);
    bool longer[kKeys], any = false;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      lo[j] = min(base[j] + lt[j], n_s);
      count[j] = eq[j];
      longer[j] = false;
      if (eq[j] > 0 && lt[j] + eq[j] == kWindow &&
          base[j] + kWindow < n_s) {
        // the run reaches past the window; one that fills it is long
        const int32_t more =
            lt[j] == 0 ? -1 : run_length(*this, base[j] + kWindow, q[j],
                                         kWindow);
        if (more >= 0) count[j] += more;
        longer[j] = more < 0;
        any |= more < 0;
      }
    }
    if (any) {
      int32_t ends[kKeys], le[kKeys], same[kKeys];
      narrow<true>(q, ends, le, same);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        if (longer[j]) count[j] = min(ends[j] + le[j], n_s) - lo[j];
    }
  }
};

// A warp probes 32 * kKeys keys at a time, from `first` on: lane l the
// keys first + l + 32 j, j < kKeys, so every load and store of keys,
// starts and counts covers 128 contiguous bytes at any alignment, and
// where the probe keys are sorted (a key column in key order, as a
// join's probe side often is), the 32 searches of one j read neighbouring
// table entries and share their lines.  An output takes the warp's
// (lower bound, count) of each key; its lanes call it together.

// probe_counts_i32's output: each key's bucket start and count.
struct BucketOut {
  int32_t* __restrict__ start;
  int32_t* __restrict__ count;

  __device__ __forceinline__ void put(int64_t first, int64_t n,
                                      const int32_t (&lo)[kKeys],
                                      const int32_t (&c)[kKeys]) const {
    const int64_t i = first + (threadIdx.x & 31);
    const bool whole = first + 32 * kKeys <= n;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (whole || i + 32 * j < n) {
        start[i + 32 * j] = lo[j];
        count[i + 32 * j] = c[j];
      }
    }
  }
};

// probe_multi_i32's output: the bucket, and the bucket's first cap build
// rows through `order`, -1 past the count.  A warp's rows of mat are
// contiguous.  rows4 (cap % 4 == 0 and mat 16-byte aligned): lane l
// writes the warp's int4 chunks l, l + 32, ..., so each store covers 512
// contiguous bytes; the chunk's bucket comes from the lane that searched
// it, by shuffles.  Otherwise each lane writes its own rows.
struct MatchOut {
  BucketOut bucket;
  const int32_t* __restrict__ order;
  int32_t* __restrict__ mat;
  int32_t cap;
  bool rows4;

  __device__ __forceinline__ void put(int64_t first, int64_t n,
                                      const int32_t (&lo)[kKeys],
                                      const int32_t (&c)[kKeys]) const {
    bucket.put(first, n, lo, c);
    const int lane = threadIdx.x & 31;
    int32_t m[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) m[j] = min(c[j], cap);
    if (!rows4) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int64_t i = first + 32 * j + lane;
        if (i >= n) continue;
        for (int32_t t = 0; t < cap; ++t)
          mat[i * cap + t] = t < m[j] ? __ldg(order + lo[j] + t) : -1;
      }
      return;
    }
    const unsigned full = 0xffffffffu;
    const int32_t per_row = cap >> 2;
    const int64_t left = n - first;
    const int32_t chunks =
        static_cast<int32_t>(left < 32 * kKeys ? left : 32 * kKeys) * per_row;
    int4* dst = reinterpret_cast<int4*>(mat + first * cap);
    for (int32_t cb = 0; cb < chunks; cb += 32) {
      const int32_t ch = cb + lane;
      const int32_t row = ch / per_row;      // of the warp's rows
      const int32_t t = 4 * (ch - row * per_row);
      int32_t l = 0, mm = 0;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int32_t lj = __shfl_sync(full, lo[j], row & 31);
        const int32_t mj = __shfl_sync(full, m[j], row & 31);
        if (row >> 5 == j) {
          l = lj;
          mm = mj;
        }
      }
      if (ch < chunks) {
        const int32_t* p = order + l + t;
        int4 v;
        v.x = t < mm ? __ldg(p) : -1;
        v.y = t + 1 < mm ? __ldg(p + 1) : -1;
        v.z = t + 2 < mm ? __ldg(p + 2) : -1;
        v.w = t + 3 < mm ? __ldg(p + 3) : -1;
        dst[ch] = v;
      }
    }
  }
};

// Grid-stride over the keys a warp at a time.  Lanes past the end search
// the last key again, so that every lane's search is one of the path's.
template <class Table, class Out>
__device__ __forceinline__ void probe_all(const Table& t,
                                          const int32_t* __restrict__ keys,
                                          int64_t n, const Out& out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kKeys;
  for (int64_t first = warp * 32 * kKeys; first < n; first += step) {
    int32_t q[kKeys], lo[kKeys], c[kKeys];
    const int32_t* k = keys + first + lane;
    if (first + 32 * kKeys <= n) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) q[j] = __ldg(k + 32 * j);
    } else {
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        q[j] = __ldg(first + 32 * j + lane < n ? k + 32 * j : keys + n - 1);
    }
    t.probe(q, lo, c);
    out.put(first, n, lo, c);
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
template <class Out>
__global__ void __launch_bounds__(kThreads)
probe_shared_kernel(const int32_t* __restrict__ s_sorted, int32_t n_s,
                    int levels, const int32_t* __restrict__ keys, int64_t n,
                    Out out) {
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
  probe_all(SharedTable{sorted, tree, n_s, levels}, keys, n, out);
}

template <int kWindow, class Out>
__global__ void __launch_bounds__(kThreads)
probe_sampled_kernel(const int32_t* __restrict__ s_sorted, int32_t n_s,
                     int32_t log_step, const int32_t* __restrict__ tree_g,
                     const int32_t* __restrict__ keys, int64_t n, Out out) {
  __shared__ int4 tree4[kSample / 4];
  const int4* src = reinterpret_cast<const int4*>(tree_g);
  // all of a thread's loads in flight at once
#pragma unroll
  for (int i = 0; i < kSample / 4; i += kThreads)
    tree4[i + threadIdx.x] = __ldg(src + i + threadIdx.x);
  __syncthreads();
  const int32_t* tree = reinterpret_cast<const int32_t*>(tree4);
  const bool aligned = (reinterpret_cast<uintptr_t>(s_sorted) & 15) == 0;
  probe_all(SampledTable<kWindow>{tree, s_sorted, n_s, int32_t{1} << log_step,
                                  log_step, aligned},
            keys, n, out);
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

template <int kWindow, class Out>
void launch_sampled(const int32_t* s, int32_t n_s, int32_t log_step,
                    const int32_t* tree, const int32_t* keys, int64_t n,
                    const Out& out, cudaStream_t st) {
  const int64_t grid = probe_grid<probe_sampled_kernel<kWindow, Out>>(0, n);
  probe_sampled_kernel<kWindow, Out>
      <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          s, n_s, log_step, tree, keys, n, out);
}

// Both bucket probes: the route from ts, then a grid-stride probe.
template <class Out>
int launch_probe(const void* s_sorted, int64_t n_s, int64_t ts,
                 const void* keys_v, int64_t n, void* scratch, const Out& out,
                 void* stream) {
  if (ts < 4 || (ts & (ts - 1)) || n_s > ts || ts > (int64_t{1} << 31) ||
      (scratch == nullptr) != (ts <= kSharedMax) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(s_sorted);
  const int32_t* keys = static_cast<const int32_t*>(keys_v);
  const int32_t ns = static_cast<int32_t>(n_s);
  int log_ts = 0;
  while ((int64_t{1} << log_ts) < ts) ++log_ts;
  if (ts <= kSharedMax) {
    const size_t smem = 2 * sizeof(int32_t) * static_cast<size_t>(ts);
    if (smem > 48 * 1024) {
      static bool raised = false;
      if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            probe_shared_kernel<Out>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(2 * sizeof(int32_t) * kSharedMax));
        if (err != cudaSuccess) return static_cast<int>(err);
        raised = true;
      }
    }
    const int64_t grid = probe_grid<probe_shared_kernel<Out>>(smem, n);
    probe_shared_kernel<Out><<<static_cast<unsigned>(grid), kThreads, smem,
                               st>>>(s, ns, log_ts, keys, n, out);
  } else {
    const int32_t log_step = log_ts - kSampleLevels;     // >= 1
    int32_t* tree = static_cast<int32_t*>(scratch);
    build_tree_kernel<<<kSample / kThreads, kThreads, 0, st>>>(
        s, ns, int32_t{1} << log_step, tree);
    if (log_step == 1)
      launch_sampled<2>(s, ns, log_step, tree, keys, n, out, st);
    else if (log_step == 2)
      launch_sampled<4>(s, ns, log_step, tree, keys, n, out, st);
    else if (log_step == 3)
      launch_sampled<8>(s, ns, log_step, tree, keys, n, out, st);
    else
      launch_sampled<16>(s, ns, log_step, tree, keys, n, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first d < depth with ht_keys[(h + d) & mask] == k for each of a
// thread's rows (-1 if none), read as windows of kW slots: kW = 4 reads
// the aligned int4 holding slots 4 w .. 4 w + 3 past the row's own int4
// (needs ts >= 4 and 16-byte aligned keys), kW = 1 one slot a step.  All
// rows' windows are loaded before any is compared, and a row reads on
// only while its walk is unfinished.
template <int kW>
__device__ __forceinline__ void first_hits(const int32_t* __restrict__ ht_keys,
                                           uint32_t mask, int32_t depth,
                                           int rows,
                                           const int32_t (&k)[kKeys],
                                           const uint32_t (&h)[kKeys],
                                           int32_t (&found)[kKeys]) {
  int32_t skip[kKeys];                // slots of window 0 before slot h
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    found[j] = -1;
    skip[j] = kW == 4 ? static_cast<int32_t>(h[j] & 3) : 0;
  }
  for (int32_t w = 0;; ++w) {
    int32_t v[kKeys][kW];
    bool read[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      read[j] = j < rows && found[j] < 0 && kW * w - skip[j] < depth;
      if (!read[j]) continue;
      if constexpr (kW == 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(ht_keys) +
                             (((h[j] >> 2) + static_cast<uint32_t>(w)) &
                              (mask >> 2)));
        v[j][0] = x.x;
        v[j][1] = x.y;
        v[j][2] = x.z;
        v[j][3] = x.w;
      } else {
        v[j][0] = __ldg(ht_keys + ((h[j] + static_cast<uint32_t>(w)) & mask));
      }
    }
    bool more = false;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (!read[j]) continue;
#pragma unroll
      for (int p = 0; p < kW; ++p) {
        const int32_t d = kW * w + p - skip[j];
        if (found[j] < 0 && d >= 0 && d < depth && v[j][p] == k[j])
          found[j] = d;
      }
      more |= found[j] < 0 && kW * (w + 1) - skip[j] < depth;
    }
    if (!more) break;
  }
}

// A warp takes 32 * kKeys contiguous rows, lane l the rows first + l +
// 32 j, as probe_all does: coalesced loads of the keys and stores of
// s_idx at any alignment.  The grid covers every row once.
template <int kW>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ ht_keys,
                  const int32_t* __restrict__ ht_vals, uint32_t mask,
                  const int32_t* __restrict__ keys, int64_t n,
                  int32_t depth, int64_t block, int32_t* __restrict__ s_idx,
                  int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      ((static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5) *
      32 * kKeys;
  if (first >= n) return;             // the whole warp
  const int64_t left = n - first - lane;
  const int rows = left <= 0 ? 0 : left > 32 * (kKeys - 1) ? kKeys
                                   : static_cast<int>((left + 31) / 32);
  int32_t k[kKeys];
  uint32_t h[kKeys];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    k[j] = j < rows ? __ldg(keys + first + 32 * j + lane) : 0;
    h[j] = (static_cast<uint32_t>(k[j]) * kKnuth) & mask;
  }
  int32_t found[kKeys], r[kKeys];
  first_hits<kW>(ht_keys, mask, depth, rows, k, h, found);
  int hits = 0;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    r[j] = found[j] >= 0
               ? __ldg(ht_vals +
                       ((h[j] + static_cast<uint32_t>(found[j])) & mask))
               : -1;
    if (j < rows) {
      s_idx[first + 32 * j + lane] = r[j];
      hits += r[j] >= 0;
    }
  }
  // the counts: one atomicAdd a warp where its rows lie in one logical
  // block, else one a hit
  const int64_t last = (first + 32 * kKeys < n ? first + 32 * kKeys : n) - 1;
  if (first / block == last / block) {
    const int total = __reduce_add_sync(0xffffffffu, hits);
    if (lane == 0 && total > 0) atomicAdd(counts + first / block, total);
  } else {
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      if (j < rows && r[j] >= 0)
        atomicAdd(counts + (first + 32 * j + lane) / block, 1);
  }
}

}  // namespace

// The launchers run on `stream` and return cudaGetLastError().
// ts is the power of two the table is padded to (>= 4).  `scratch` is
// null for the shared route (ts <= kSharedMax), and 16-byte-aligned device
// memory for kSample int32 (the search tree) for the sampled route.
extern "C" int probe_counts_i32(const void* s_sorted, int64_t n_s, int64_t ts,
                                const void* keys, int64_t n, void* start,
                                void* count, void* scratch, void* stream) {
  return launch_probe(
      s_sorted, n_s, ts, keys, n, scratch,
      BucketOut{static_cast<int32_t*>(start), static_cast<int32_t*>(count)},
      stream);
}

// `mat` is (n, cap) int32, row-major.  A warp's int4 chunks of mat are
// counted in int32, so caps past 2**24 take the scalar stores.
extern "C" int probe_multi_i32(const void* s_sorted, const void* order,
                               int64_t n_s, int64_t ts, const void* keys,
                               int64_t n, int32_t cap, void* mat, void* start,
                               void* count, void* scratch, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool rows4 = cap % 4 == 0 && cap <= (1 << 24) &&
                     (reinterpret_cast<uintptr_t>(mat) & 15) == 0;
  return launch_probe(
      s_sorted, n_s, ts, keys, n, scratch,
      MatchOut{BucketOut{static_cast<int32_t*>(start),
                         static_cast<int32_t*>(count)},
               static_cast<const int32_t*>(order), static_cast<int32_t*>(mat),
               cap, rows4},
      stream);
}

// `counts` (ceil(n / block) int32) is zeroed here, then summed into.
extern "C" int hash_probe_i32(const void* ht_keys, const void* ht_vals,
                              int64_t ts, const void* keys, int64_t n,
                              int32_t probe_depth, int64_t block, void* s_idx,
                              void* counts, void* stream) {
  if (ts < 1 || (ts & (ts - 1)) || ts > (int64_t{1} << 32) || block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_blocks = (n + block - 1) / block;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_blocks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(
      (n + kThreads * kKeys - 1) / (kThreads * kKeys));
  const uint32_t mask = static_cast<uint32_t>(ts - 1);
  const int32_t* hk = static_cast<const int32_t*>(ht_keys);
  const int32_t* hv = static_cast<const int32_t*>(ht_vals);
  const int32_t* k = static_cast<const int32_t*>(keys);
  int32_t* out = static_cast<int32_t*>(s_idx);
  int32_t* c = static_cast<int32_t*>(counts);
  if (ts >= 4 && (reinterpret_cast<uintptr_t>(ht_keys) & 15) == 0)
    hash_probe_kernel<4><<<grid, kThreads, 0, st>>>(hk, hv, mask, k, n,
                                                    probe_depth, block, out, c);
  else
    hash_probe_kernel<1><<<grid, kThreads, 0, st>>>(hk, hv, mask, k, n,
                                                    probe_depth, block, out, c);
  return static_cast<int>(cudaGetLastError());
}
