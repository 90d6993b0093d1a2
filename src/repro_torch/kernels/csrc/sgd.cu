// Minibatch SGD for GLMs (paper §VI, Fig. 9) for Hopper (sm_90a).
//
// Replaces: sgd_pallas / _sgd_kernel in src/repro/kernels/sgd/sgd.py
// (its pl.pallas_call at :68).
// Computes: for each of K jobs (learning rate lr_k, L2 weight l2_k), from
//   x = xs0[k], `epochs` passes over the m rows in minibatches of B:
//     z_r = <a_r, x>,  d_r = link(z_r) - b_r           (link: identity or
//     g_j = (sum_r d_r a_rj) / B                        sigmoid)
//     x_j = x_j - lr * (g_j + 2 l2 * x_j)
//   and writes the final x to xs[k].
// Bound: the latency of each job's chain of epochs * m / B dependent steps
//   (18,750 at the MNIST shape with B = 16 and 5 epochs).  The 4 * m * n
//   flops per job and epoch and the bytes (the dataset read once) are far
//   below the card's rates; PERF.md keeps the measured time beside both.
//
// Two routes, which kernels/sgd/sgd.py picks from (n, B) alone:
//
// Ring (sgd_ring_f32), for n % 4 == 0, B in {4, 8, 16} and n / 4 within 8 x
//   256 consumer threads.  A job runs on a cluster of C blocks (C in {1, 2,
//   4, 8}; 1 at the MNIST shape, the fastest measured); block c owns a
//   contiguous slice of the features, and each consumer thread of it owns
//   four of them, whose weights it keeps in registers.  One more warp of each
//   block, the producer, keeps the ring of S = 3 tiles full with the bulk
//   copy engine (cp.async.bulk, one mbarrier a slot): a tile is the block's
//   slice of a minibatch's B rows (one copy where the block holds whole rows,
//   since a minibatch is contiguous; else one a row, issued by B lanes at
//   once) and its B labels.  Right after a step's barrier the producer
//   refills the slot that step read with the minibatch S steps on, wrapping
//   at the end of each epoch, so no step waits on device memory (four tiles
//   measured no faster than three).  A consumer step: the thread's B partial
//   dot products from its tile in registers; a warp-wide reduce-scatter (B -
//   1 + log2(32 / B) shuffles) leaves each row's warp sum in one lane, which
//   stores it into every block of the cluster (distributed shared memory;
//   double-buffered by step parity); half of the next tile is read from the
//   ring; one block barrier (C = 1) or cluster barrier (C > 1); lanes < B of
//   every warp add the C x W warp sums of their row in a fixed order, apply
//   the link (expf) and subtract the label into the warp's d; the update uses
//   d and the tile still in registers; the other half of the next tile is
//   read.  One barrier a step.  The bound is the step's chain of latencies
//   (about 1,800 clocks at the MNIST shape) and, at C = 1, shared memory's
//   bandwidth: each tile is written and read once, 2 x B x n x 4 bytes a step
//   at 128 bytes a clock (about 800 clocks at the MNIST shape).
// Split (sgd_split_f32), every other (n, B), at any width that fits on
//   the card; it replaced the direct kernel (one block a job, the model in
//   shared memory, the minibatch read twice from device memory a plain
//   load at a time: 176 ms on an H100 at 4,096 x 47,236, 4 jobs, and a
//   refusal past
//   about 58,000 features).  Up to four jobs share the tiles: each group's
//   features are split over P blocks of 256 consumer threads and a
//   producer warp, whose bulk copies fill a ring of sub-tiles (16 rows of
//   512 features, each row from its 16-byte-aligned cover, so any n) as
//   far ahead as the ring has room, after asking L2 to prefetch the next
//   minibatch.  The dot products' block sums are exchanged once a step:
//   inside one cluster (P <= 16) through distributed shared memory and a
//   cluster barrier, or, where no cluster keeps a step's tile in its
//   blocks' rings, across a cooperative launch of up to 128 blocks
//   through device memory and a grid barrier (on an H100 at 4,096 x 47,236
//   the grid of 127 blocks took 1.46 ms, a cluster of 16 4.37: one SM's
//   bulk copies
//   bring in about 23 GB/s, so the width of the launch sets the rate).
//   Where a step's tile fits the ring (`resident`) the update reads it
//   there, else the producer copies it again from L2.  The model slices
//   stay in shared memory where four slots fit beside them, else in
//   device memory, each feature read and written only by the thread that
//   owns it.  The bound is the dataset read once and a step's chain: the
//   exchange's barrier and its latencies, about 5-6 us a step.
// Both routes sum in an order fixed by (n, B) and use no float atomics,
// so a job's weights are the same however the rows are cut into launches
// (at minibatch boundaries) and whichever jobs share the launch.  nvcc
// contracts multiply-adds into FMAs and the sums run in another order
// than torch.matmul, so the kernels agree with their plain version within
// a tolerance, not bit for bit.
#include "common.cuh"

#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRingThreadsMax = 256;   // consumer threads a ring block,
                                       // at most (plus a producer warp)
constexpr int kStages = 3;             // minibatch tiles in the ring

// sigmoid(s) = 1 / (1 + exp(-s)) for logreg, s for ridge.
__device__ __forceinline__ float link(float s, int32_t logreg) {
  return logreg ? 1.0f / (1.0f + expf(-s)) : s;
}

// ---- ring route ---------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte-aligned global `src` to shared
// `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store v at `p`'s offset in the shared memory of cluster block `rank`.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               ::"r"(remote), "f"(v) : "memory");
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// One halving step of warp_reduce_scatter and the ones after it, with
// constant trip counts, so v stays in registers (a loop nvcc does not
// unroll indexes v with the lane and moves it to local memory).
template <int B, int H>
__device__ __forceinline__ void halve(float (&v)[B], int lane) {
  if constexpr (H < log2_of(B)) {
    constexpr int kHalf = B >> (H + 1);
    const bool upper = lane & (16 >> H);
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float send = upper ? v[k] : v[k + kHalf];
      const float keep = upper ? v[k + kHalf] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, 16 >> H);
    }
    halve<B, H + 1>(v, lane);
  }
}

// Sum each of v[0..B-1] over the warp.  Each halving step keeps one half
// of the values and adds the partner's copy of it; then the lanes that
// share a row fold the rest.  Row r's sum ends in lanes
// r << (5 - log2 B) .. (r + 1) << (5 - log2 B) - 1, all equal.
template <int B>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[B], int lane) {
  constexpr int kLog = log2_of(B);
  halve<B, 0>(v, lane);
  float s = v[0];
#pragma unroll
  for (int h = kLog; h < 5; ++h) s += __shfl_xor_sync(kFull, s, 16 >> h);
  return s;
}

// Shared memory of a ring block: the stages' mbarriers (128 bytes); the
// tiles, float [S][B][4 * per_block] (the block's slice of each row, S =
// kStages); the labels, float [S][B]; the warp sums of the cluster, float
// [2][C][W][B]; each warp's d, float [W][B].
template <int B>
__global__ void __launch_bounds__(kRingThreadsMax + 32, 1)
sgd_ring_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ xs0, const float* __restrict__ lrs,
                const float* __restrict__ l2s, int64_t m, int32_t n,
                int32_t epochs, int32_t logreg, int32_t cluster,
                int32_t per_block, float* __restrict__ xs) {
  constexpr int S = kStages;
  extern __shared__ __align__(128) uint64_t ring_smem[];
  const int T = blockDim.x - 32;               // the consumer threads
  const int W = T >> 5;                        // consumer warps; warp W
                                               // is the producer
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint64_t* full = ring_smem;                  // S mbarriers in 128 bytes
  float4* tiles = reinterpret_cast<float4*>(ring_smem + 16);
  float* labels = reinterpret_cast<float*>(tiles + S * B * per_block);
  float* sums = labels + S * B;
  float* dsm = sums + 2 * cluster * W * B;
  const uint32_t rank = cluster > 1 ? cluster_rank() : 0;
  const int64_t job = blockIdx.x / cluster;
  const int32_t c0 = 4 * static_cast<int32_t>(rank) * per_block;
  const int32_t j0 = c0 + 4 * t;
  const bool owns = t < per_block && j0 < n;     // four features, n % 4 == 0
  const int32_t width = min(4 * per_block, n - c0);  // the block's features
  const float lr = lrs[job];
  const float two_l2 = 2.0f * l2s[job];
  constexpr float kInvB = 1.0f / B;             // exact: B is a power of 2
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = owns ? xs0[job * n + j0 + k] : 0.0f;

  const int64_t nb = m / B;
  const int64_t steps = nb * epochs;
  const uint32_t tile_bytes = 4u * B * static_cast<uint32_t>(max(width, 0));
  // the producer warp copies minibatch `fill_tile` (and its labels) into
  // ring slot `fill_slot`: lane 0 one bulk copy where the block holds
  // whole rows, else lane r row r of the block's slice; lane 31 the
  // labels
  int64_t fill_tile = 0;
  int fill_slot = 0;
  const auto fill = [&]() {
    float* dst = reinterpret_cast<float*>(tiles + fill_slot * B * per_block);
    const float* src = a + fill_tile * B * int64_t(n) + c0;
    if (lane == 0) mbar_expect_tx(&full[fill_slot], tile_bytes + 4u * B);
    __syncwarp();
    if (width == n) {
      if (lane == 0) bulk_load(dst, src, tile_bytes, &full[fill_slot]);
    } else if (width > 0 && lane < B) {
      bulk_load(dst + lane * 4 * per_block, src + lane * int64_t(n),
                tile_bytes / B, &full[fill_slot]);
    }
    if (lane == 31)
      bulk_load(labels + fill_slot * B, b + fill_tile * B, 4u * B,
                &full[fill_slot]);
    fill_tile = fill_tile + 1 == nb ? 0 : fill_tile + 1;
    fill_slot = fill_slot + 1 == S ? 0 : fill_slot + 1;
  };
  // the step's barrier, the block's (C = 1) or the cluster's (C > 1):
  // the producer and the consumers reach it on their own code paths
  const auto sync = [&]() {
    if (cluster > 1) {
      cluster_sync();
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"r"(T + 32) : "memory");
    }
  };
  if (warp == W) {
    // the producer: fills the ring, then after each step's barrier
    // refills the slot that step read (last read during the step before,
    // ahead of the barrier every thread has now passed) with the
    // minibatch S steps on, its copies flowing in while the step ends
    if (lane == 0) {
      for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int s = 0; s < S && s < steps; ++s) fill();
    sync();
    for (int64_t step = 0; step < steps; ++step) {
      sync();
      if (step + S < steps) fill();
    }
    return;
  }
  // the barriers are set up, and (C > 1) every block of the cluster runs
  // before any stores into its shared memory
  sync();

  constexpr int kShift = 5 - log2_of(B);      // lanes a row's sum spans
  const int my_row = lane >> kShift;
  // the tile and labels of the current step, in registers.  The next
  // ones are read from the ring in two halves, before the step's barrier
  // and after its update, so the reads spread over the step (the ring's
  // incoming copies and these reads share shared memory's bandwidth);
  // both halves come before the next barrier, after which the producer
  // refills that slot
  float4 av[B];
  float label = 0.0f;
  if (steps > 0) mbar_wait(&full[0], 0);
#pragma unroll
  for (int r = 0; r < B; ++r)
    av[r] = owns ? tiles[r * per_block + t] : make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < B) label = labels[lane];
  int next_slot = 0;                          // the ring slot of step + 1
  uint32_t next_parity = 0;                   // its mbarrier phase
  for (int64_t step = 0; step < steps; ++step) {
    next_slot = next_slot + 1 == S ? 0 : next_slot + 1;
    next_parity ^= next_slot == 0;
    float p[B];
#pragma unroll
    for (int r = 0; r < B; ++r)
      p[r] = av[r].x * x[0] + av[r].y * x[1] + av[r].z * x[2] + av[r].w * x[3];
    const float ws = warp_reduce_scatter<B>(p, lane);
    float* buf = sums + (step & 1) * cluster * W * B;
    if ((lane & ((1 << kShift) - 1)) == 0) {
      float* dst = buf + (rank * W + warp) * B + my_row;
      if (cluster > 1) {
        for (int c = 0; c < cluster; ++c) st_cluster(dst, c, ws);
      } else {
        *dst = ws;
      }
    }
    float4 next[B];
    float next_label = 0.0f;
    if (step + 1 < steps) {
      mbar_wait(&full[next_slot], next_parity);
      const float4* tile = tiles + next_slot * B * per_block + t;
#pragma unroll
      for (int r = 0; r < B / 2; ++r)
        next[r] = owns ? tile[r * per_block] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < B) next_label = labels[next_slot * B + lane];
    }
    sync();
    if (lane < B) {
      // the C x W warp sums in order, read four at a time
      const int count = cluster * W;
      float z = buf[lane];
      int i = 1;
      for (; i + 3 < count; i += 4) {
        const float s0 = buf[i * B + lane], s1 = buf[(i + 1) * B + lane];
        const float s2 = buf[(i + 2) * B + lane], s3 = buf[(i + 3) * B + lane];
        z += s0;
        z += s1;
        z += s2;
        z += s3;
      }
      for (; i < count; ++i) z += buf[i * B + lane];
      dsm[warp * B + lane] = link(z, logreg) - label;
    }
    __syncwarp();
    float d[B];
#pragma unroll
    for (int r = 0; r < B; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(dsm + warp * B + r);
      d[r] = q.x; d[r + 1] = q.y; d[r + 2] = q.z; d[r + 3] = q.w;
    }
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < B; ++r) {
      g[0] += d[r] * av[r].x;
      g[1] += d[r] * av[r].y;
      g[2] += d[r] * av[r].z;
      g[3] += d[r] * av[r].w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gk = g[k] * kInvB;
      x[k] = x[k] - lr * (gk + two_l2 * x[k]);
    }
    if (step + 1 < steps) {
      const float4* tile = tiles + next_slot * B * per_block + t;
#pragma unroll
      for (int r = B / 2; r < B; ++r)
        next[r] = owns ? tile[r * per_block] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < B; ++r) av[r] = next[r];
    label = next_label;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (owns) xs[job * n + j0 + k] = x[k];
}

template <int B>
int launch_ring(const float* a, const float* b, const float* xs0,
                const float* lrs, const float* l2s, int64_t m, int32_t n,
                int32_t epochs, int32_t logreg, int32_t k, int32_t cluster,
                int32_t threads, float* xs, cudaStream_t stream) {
  const int warps = threads / 32;
  const int32_t groups = n / 4;
  const int32_t per_block = (groups + cluster - 1) / cluster;
  const size_t smem = 128 + sizeof(float4) * kStages * B * per_block
                      + sizeof(float) * (kStages * B + 2 * cluster * warps * B
                                         + warps * B);
  const cudaError_t err = cudaFuncSetAttribute(
      sgd_ring_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k) * cluster);
  cfg.blockDim = dim3(threads + 32);          // and the producer warp
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, sgd_ring_kernel<B>, a, b, xs0, lrs, l2s, m, n, epochs, logreg,
      cluster, per_block, xs);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// ---- split route --------------------------------------------------------- //

constexpr int kSplitThreads = 256;        // consumer threads a block
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitSub = 512;            // features a sub-tile
constexpr int kSplitFpt = kSplitSub / kSplitThreads;  // features a thread
constexpr int kSplitRowStride = kSplitSub + 8;  // floats a sub-tile row:
                                          // the 16-byte-aligned cover
                                          // of up to 512 + 6 floats
constexpr int kSplitRows = 16;            // rows a sub-tile (a row chunk)
constexpr int kSplitStagesMax = 16;       // sub-tile slots in the ring
constexpr int kSplitClusterMax = 16;      // non-portable cluster size
constexpr int kSplitGridMax = 128;        // blocks of a grid-wide group
constexpr int kSplitChunks = 4;           // a grid exchange sums its
                                          // blocks in 4 runs, then those
constexpr int kSplitRun = kSplitGridMax / kSplitChunks;   // blocks a run

// Byte offsets into a split block's shared memory (kernels/sgd/sgd.py's
// split_shared_bytes mirrors this): 2 x 16 mbarriers; `stages` sub-tile
// slots of min(B, 16) rows of kSplitRowStride floats; the model slice of
// `kgp` jobs (where it lives on chip); each consumer warp's sums, float
// [W][NR][16 kgp] (NR = ceil(B / 16) row chunks); a cluster's block
// sums, float [2][C][NR][16 kgp] (none for a grid-wide exchange, which
// goes through device memory); d and the exchange's partial runs, float
// [W][NR][16 kgp]; the labels, float [2][NR * 16].
struct SplitLayout {
  size_t slots, model, wsums, sums, dsm, labels, total;
};

__host__ __device__ inline SplitLayout split_layout(int32_t minibatch,
                                                    int32_t blocks,
                                                    int32_t grid,
                                                    int32_t width,
                                                    int32_t stages,
                                                    bool model_on_chip,
                                                    int32_t kgp) {
  const size_t nr = (static_cast<size_t>(minibatch) + kSplitRows - 1)
                    / kSplitRows;
  const size_t rows = minibatch < kSplitRows ? minibatch : kSplitRows;
  const size_t vals = nr * kSplitRows * kgp;   // one warp's sums
  SplitLayout l;
  size_t off = 2 * kSplitStagesMax * sizeof(uint64_t);
  l.slots = off;
  off += sizeof(float) * stages * rows * kSplitRowStride;
  l.model = off;
  off += model_on_chip ? sizeof(float) * kgp * width : 0;
  l.wsums = off;
  off += sizeof(float) * kSplitWarps * vals;
  l.sums = off;
  off += grid ? 0 : sizeof(float) * 2 * blocks * vals;
  l.dsm = off;
  off += sizeof(float) * kSplitWarps * vals;
  l.labels = off;
  off += sizeof(float) * 2 * nr * kSplitRows;
  l.total = off;
  return l;
}

struct SplitArgs {
  const float* a;
  const float* b;
  const float* xs0;
  const float* lrs;
  const float* l2s;
  float* xs;
  float* part;          // grid exchange: float [2][blocks][NR][16 KG]
  uint32_t* arrivals;   // grid exchange: the barrier's counter, zeroed
  int64_t m;
  int32_t n, minibatch, epochs, logreg, k;
  int32_t blocks, width, stages, resident, kgp, prefetch;
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(kSplitThreads) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Sum each of v[0..V-1] over the warp, leaving value i in lanes
// i * 32 / V .. (i + 1) * 32 / V - 1 (V <= 32) or values 2 lane, 2 lane
// + 1 in v[0], v[1] (V = 64).  Every value is summed in the same tree
// (lanes paired across bit 4, then 3, 2, 1, 0; each add commutes), so
// its bits do not depend on its index, that is on the job's place in a
// group.
template <int V, int H>
__device__ __forceinline__ void split_halve(float (&v)[V], int lane) {
  if constexpr (H < 5 && (V >> H) > 1) {
    constexpr int kHalf = (V >> H) / 2;
    const bool upper = lane & (16 >> H);
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float send = upper ? v[k] : v[k + kHalf];
      const float keep = upper ? v[k + kHalf] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, 16 >> H);
    }
    split_halve<V, H + 1>(v, lane);
  }
}

template <int V>
__device__ __forceinline__ void split_reduce_scatter(float (&v)[V],
                                                     int lane) {
  split_halve<V, 0>(v, lane);
#pragma unroll
  for (int h = log2_of(V); h < 5; ++h)
    v[0] += __shfl_xor_sync(kFull, v[0], 16 >> h);
}

// The split route.  The features of a group of up to KG jobs are split
// over P blocks (`blocks`): block `rank` owns features [rank * width,
// (rank + 1) * width) of every job of the group, and each consumer
// thread of it the features t, t + 256 of each 512-feature sub-tile of
// that slice.  Warp 8, the producer, copies the block's slice of each
// minibatch into a ring of `stages` slots, a sub-tile (up to 16 rows of
// up to 512 features) a slot, one bulk copy a row from the row's
// 16-byte-aligned cover (the consumers skip the 0-3 floats before it),
// as far ahead as the ring has free slots.  A step: the dot visits the
// sub-tiles row chunk by row chunk; each warp sums its threads' partial
// dot products (reduce-scatter), the block its warps' sums in order; the
// blocks exchange those sums, kGrid = false: P <= 16 blocks are one
// cluster, the sums go into every block's shared memory (distributed
// shared memory, double-buffered by step parity) and one cluster barrier
// follows; kGrid = true: P blocks of a cooperative launch (every group in
// turn), the sums go to device memory (`part`, double-buffered) and one
// grid barrier follows (a counter in device memory); then the block adds
// the P block sums of each value in order and forms d = link(z) - b; the
// update visits the sub-tiles again, from the slots where the whole tile
// stays (`resident`) or as the producer copies them again (L2 holds them:
// it was asked to prefetch the minibatch a step ahead).  The model slice
// lives in shared memory (kModelOnChip) or in xs, read and written only
// by the thread that owns the feature.
template <int KG, bool kModelOnChip, bool kGrid>
__global__ void __launch_bounds__(kSplitThreads + 32, 1)
sgd_split_kernel(const SplitArgs p) {
  constexpr int V = kSplitRows * KG;          // values a row chunk
  constexpr int NPL = V > 32 ? V / 32 : 1;   // of them a lane after
                                             // the reduce-scatter
  extern __shared__ __align__(128) uint64_t split_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(split_smem);
  const int32_t B = p.minibatch, P = p.blocks, R = p.stages;
  const int32_t n = p.n;
  const int nr = (B + kSplitRows - 1) / kSplitRows;
  const int rows = B < kSplitRows ? B : kSplitRows;
  const int nrv = nr * V;
  const SplitLayout lay = split_layout(B, P, kGrid, p.width, R, kModelOnChip,
                                       p.kgp);
  uint64_t* full = split_smem;
  uint64_t* empty = split_smem + kSplitStagesMax;
  float* slots = reinterpret_cast<float*>(base + lay.slots);
  float* wsums = reinterpret_cast<float*>(base + lay.wsums);
  float* sums = reinterpret_cast<float*>(base + lay.sums);
  float* dblk = reinterpret_cast<float*>(base + lay.dsm);   // d, [NRV]
  float* runs = dblk + nrv;           // grid exchange, [kSplitChunks][NRV]
  float* labs = reinterpret_cast<float*>(base + lay.labels);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t rank = kGrid ? blockIdx.x : cluster_rank();
  const int64_t groups = (static_cast<int64_t>(p.k) + KG - 1) / KG;
  // a cluster trains one group; a grid-wide launch trains them in turn
  const int64_t g_first = kGrid ? 0 : blockIdx.x / P;
  const int64_t g_end = kGrid ? groups : g_first + 1;
  const int64_t c0 = static_cast<int64_t>(rank) * p.width;
  const int64_t owned = n - c0 < p.width ? n - c0 : p.width;
  const int32_t width = owned > 0 ? static_cast<int32_t>(owned) : 0;
  const int nf = (width + kSplitSub - 1) / kSplitSub;
  const int ns = nr * nf;                     // sub-tiles a step
  const int64_t nb = p.m / B;
  const int64_t steps = nb * p.epochs;        // a group's
  const size_t slot_floats = static_cast<size_t>(rows) * kSplitRowStride;
  // the setup barrier: the mbarriers are set up, and (cluster) every
  // block of the cluster runs before any stores into its shared memory
  const auto setup_sync = [&]() {
    if constexpr (kGrid) {
      asm volatile("bar.sync 1, %0;\n" ::"r"(kSplitThreads + 32) : "memory");
    } else {
      cluster_arrive();
      cluster_wait();
    }
  };

  if (warp == kSplitWarps) {
    // the producer: lane r copies row r of each sub-tile; every lane
    // spins on the slot's empty barrier (its phase parity flipped, so
    // the first pass through the ring does not wait)
    if (lane == 0) {
      for (int s = 0; s < R; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kSplitWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    setup_sync();
    // a cluster barrier counts every thread of the cluster, so this warp
    // arrives at step x's before it waits on a slot that the consumers
    // free only after that barrier, and waits for step x - 1's first
    int64_t arrived = 0, waited = 0;
    const auto arrive_through = [&](int64_t x) {
      if constexpr (!kGrid) {
        while (arrived <= x) {
          if (waited < arrived) {
            cluster_wait();
            ++waited;
          }
          cluster_arrive();
          ++arrived;
        }
      }
    };
    const int64_t per = p.resident ? ns : 2 * ns;   // loads a step
    int64_t ld = 0;
    const auto issue = [&](int64_t row0, int rc, int fc) {
      if (ld >= R) {
        // the slot's last load: freed in the dot of its step x (after
        // barrier x - 1) or in the update (after barrier x)
        const int64_t prev = ld - R;
        const int64_t x = prev / per;
        arrive_through(!p.resident && prev % per < ns ? x - 1 : x);
      }
      const int slot = static_cast<int>(ld % R);
      mbar_wait(&empty[slot], static_cast<uint32_t>((ld / R) & 1) ^ 1u);
      ++ld;
      const int nrows = min(kSplitRows, B - rc * kSplitRows);
      const int32_t f0 = fc * kSplitSub;
      const int32_t len = min(kSplitSub, width - f0);
      uint32_t bytes = 0;
      const float* src = p.a;
      if (lane < nrows) {
        const int64_t q = (row0 + rc * kSplitRows + lane) * int64_t(n) + c0
                          + f0;
        const int64_t q16 = q & ~int64_t(3);
        const int64_t e16 = (q + len + 3) & ~int64_t(3);
        bytes = static_cast<uint32_t>(4 * (e16 - q16));
        src = p.a + q16;
      }
      uint32_t total = bytes;
      for (int off = 16; off > 0; off >>= 1)
        total += __shfl_xor_sync(kFull, total, off);
      if (lane == 0) mbar_expect_tx(&full[slot], total);
      __syncwarp();
      if (lane < nrows)
        bulk_load(slots + slot * slot_floats + lane * kSplitRowStride, src,
                  bytes, &full[slot]);
    };
    const int64_t all = (g_end - g_first) * steps;   // steps of the launch
    for (int64_t step = 0; step < all; ++step) {
      const int64_t row0 = (step % nb) * B;
      if (p.prefetch && step + 1 < all && width > 0) {
        const int64_t next0 = ((step + 1) % nb) * B;
        for (int r = lane; r < B; r += 32) {
          const int64_t q = (next0 + r) * int64_t(n) + c0;
          const int64_t q16 = q & ~int64_t(3);
          const int64_t e16 = (q + width + 3) & ~int64_t(3);
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                       ::"l"(p.a + q16),
                       "r"(static_cast<uint32_t>(4 * (e16 - q16)))
                       : "memory");
        }
      }
      for (int q = 0; q < ns; ++q) issue(row0, q / nf, q % nf);     // dot
      if (!p.resident)
        for (int fc = 0; fc < nf; ++fc)                              // update
          for (int rc = 0; rc < nr; ++rc) issue(row0, rc, fc);
    }
    if (all > 0) {
      arrive_through(all - 1);
      if constexpr (!kGrid) cluster_wait();
    }
    return;
  }

  setup_sync();
  const float fb = static_cast<float>(B);
  const int n4 = n & 3;
  int64_t ld = 0;
  uint32_t target = 0;                       // grid barrier: arrivals due
  float next_label = 0.0f;                   // thread t's label of the
  if (t < B && steps > 0) next_label = p.b[t];   // next step (t < 256)
  for (int64_t group = g_first; group < g_end; ++group) {
    const int64_t job0 = group * KG;
    const int64_t left = p.k - job0;
    const int kg = left < KG ? static_cast<int>(left) : KG;
    // job slot k's model slice (a slot past the group's jobs reads job
    // kg - 1's and writes nothing)
    float* xrow[KG];
    float lr[KG], tl2[KG];
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int64_t job = job0 + min(k, kg - 1);
      xrow[k] = kModelOnChip
                    ? reinterpret_cast<float*>(base + lay.model) + k * p.width
                    : p.xs + job * n + c0;
      lr[k] = p.lrs[job];
      tl2[k] = 2.0f * p.l2s[job];
    }
    // each thread copies in the features it owns (no barrier: no other
    // thread reads or writes them)
    for (int fc = 0; fc < nf; ++fc) {
#pragma unroll
      for (int i = 0; i < kSplitFpt; ++i) {
        const int32_t f = fc * kSplitSub + t + i * kSplitThreads;
        if (f < width) {
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            if (k < kg) {
              xrow[k][f] = p.xs0[(job0 + k) * n + c0 + f];
            } else if (kModelOnChip) {
              xrow[k][f] = 0.0f;
            }
          }
        }
      }
    }

    for (int64_t step = 0; step < steps; ++step) {
      // the exchange's buffer parity runs on across the groups of a
      // grid-wide launch: a group's first step must not write the buffer
      // that slower blocks may still be reading the last group's sums
      // from (the steps a group may be odd, and no barrier parts them)
      const int par = static_cast<int>(((group - g_first) * steps + step)
                                       & 1);
      const int64_t row0 = (step % nb) * B;
      // the labels: thread t's arrived during the last step; the next
      // step's load flies during this one
      float* lab = labs + par * nr * kSplitRows;
      for (int r = t; r < B; r += kSplitThreads) {
        if (r == t) {
          lab[r] = next_label;
          const int64_t nrow = ((step + 1) % nb) * B + r;
          next_label = p.b[nrow];
        } else {
          lab[r] = p.b[row0 + r];
        }
      }
      const int64_t ld0 = ld;
      // ---- dot: z = A x, row chunk by row chunk
      for (int rc = 0; rc < nr; ++rc) {
        const int rb = min(kSplitRows, B - rc * kSplitRows);
        int sh[kSplitRows];    // where row r starts in its slot: its
                               // offset from a 16-byte mark (c0 and
                               // every sub-tile start are multiples of 4)
#pragma unroll
        for (int r = 0; r < kSplitRows; ++r)
          sh[r] = static_cast<int>(((row0 + rc * kSplitRows + r) & 3) * n4)
                  & 3;
        float acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0.0f;
        for (int fc = 0; fc < nf; ++fc) {
          const int slot = static_cast<int>(ld % R);
          mbar_wait(&full[slot], static_cast<uint32_t>((ld / R) & 1));
          ++ld;
          const float* tile = slots + slot * slot_floats;
          const int32_t f0 = fc * kSplitSub;
          const int32_t len = min(kSplitSub, width - f0);
#pragma unroll
          for (int i = 0; i < kSplitFpt; ++i) {
            const int f = t + i * kSplitThreads;
            if (f < len) {
              float xv[KG];
#pragma unroll
              for (int k = 0; k < KG; ++k) xv[k] = xrow[k][f0 + f];
#pragma unroll
              for (int r = 0; r < kSplitRows; ++r) {
                if (r < rb) {
                  const float av = tile[r * kSplitRowStride + sh[r] + f];
#pragma unroll
                  for (int k = 0; k < KG; ++k)
                    acc[k * kSplitRows + r] =
                        __fmaf_rn(av, xv[k], acc[k * kSplitRows + r]);
                }
              }
            }
          }
          if (!p.resident) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[slot]);
          }
        }
        split_reduce_scatter<V>(acc, lane);
        float* ws = wsums + warp * nrv + rc * V;
        if constexpr (V >= 32) {
#pragma unroll
          for (int j = 0; j < NPL; ++j) ws[lane * NPL + j] = acc[j];
        } else {
          constexpr int kSpan = 32 / V;        // lanes holding one value
          if (lane % kSpan == 0) ws[lane / kSpan] = acc[0];
        }
      }
      // ---- the blocks exchange their sums; z of each (job, row) is the
      // P block sums added in order
      consumers_sync();
      if constexpr (kGrid) {
        float* mine = p.part + (static_cast<int64_t>(par) * P + rank) * nrv;
        for (int u = t; u < nrv; u += kSplitThreads) {
          float z = wsums[u];
          for (int w = 1; w < kSplitWarps; ++w) z += wsums[w * nrv + u];
          mine[u] = z;
        }
        consumers_sync();
        target += static_cast<uint32_t>(P);
        if (t == 0) {
          __threadfence();
          atomicAdd(p.arrivals, 1u);
          while (static_cast<int32_t>(ld_acquire_gpu(p.arrivals) - target)
                 < 0) {
          }
          __threadfence();
        }
        consumers_sync();
        // the P sums in kSplitChunks runs of consecutive blocks, each in
        // order (straight from L2: the lines change every other step),
        // then the runs in order
        const float* all = p.part + static_cast<int64_t>(par) * P * nrv;
        const int per_run = (P + kSplitChunks - 1) / kSplitChunks;
        for (int it = t; it < kSplitChunks * nrv; it += kSplitThreads) {
          const int run = it / nrv, u = it - run * nrv;
          const int lo = run * per_run, n_run = min(P - lo, per_run);
          // the run's loads all in flight, then added in order
          float v[kSplitRun];
#pragma unroll
          for (int c = 0; c < kSplitRun; ++c)
            v[c] = c < n_run
                       ? __ldcg(all + static_cast<int64_t>(lo + c) * nrv + u)
                       : 0.0f;
          float z = v[0];
#pragma unroll
          for (int c = 1; c < kSplitRun; ++c)
            if (c < n_run) z += v[c];
          runs[run * nrv + u] = n_run > 0 ? z : 0.0f;
        }
        consumers_sync();
        for (int u = t; u < nrv; u += kSplitThreads) {
          float z = runs[u];
          for (int run = 1; run < kSplitChunks; ++run) z += runs[run * nrv + u];
          const int r = (u / V) * kSplitRows + (u % kSplitRows);
          dblk[u] = r < B ? link(z, p.logreg) - lab[r] : 0.0f;
        }
      } else {
        float* buf = sums + par * P * nrv;
        for (int idx = t; idx < P * nrv; idx += kSplitThreads) {
          const int dst = idx / nrv, u = idx - dst * nrv;
          float z = wsums[u];
          for (int w = 1; w < kSplitWarps; ++w) z += wsums[w * nrv + u];
          float* to = buf + rank * nrv + u;
          if (dst == static_cast<int>(rank)) {
            *to = z;
          } else {
            st_cluster(to, dst, z);
          }
        }
        cluster_arrive();
        cluster_wait();
        for (int u = t; u < nrv; u += kSplitThreads) {
          float z = buf[u];
          for (int c = 1; c < P; ++c) z += buf[c * nrv + u];
          const int r = (u / V) * kSplitRows + (u % kSplitRows);
          dblk[u] = r < B ? link(z, p.logreg) - lab[r] : 0.0f;
        }
      }
      consumers_sync();
      // ---- update: x -= lr (A^T d / B + 2 l2 x), sub-tile by sub-tile
      for (int fc = 0; fc < nf; ++fc) {
        const int32_t f0 = fc * kSplitSub;
        const int32_t len = min(kSplitSub, width - f0);
        float g[kSplitFpt][KG];
#pragma unroll
        for (int i = 0; i < kSplitFpt; ++i)
#pragma unroll
          for (int k = 0; k < KG; ++k) g[i][k] = 0.0f;
        for (int rc = 0; rc < nr; ++rc) {
          int slot;
          if (p.resident) {
            slot = static_cast<int>((ld0 + rc * nf + fc) % R);
          } else {
            slot = static_cast<int>(ld % R);
            mbar_wait(&full[slot], static_cast<uint32_t>((ld / R) & 1));
            ++ld;
          }
          const int rb = min(kSplitRows, B - rc * kSplitRows);
          int sh[kSplitRows];
#pragma unroll
          for (int r = 0; r < kSplitRows; ++r)
            sh[r] = static_cast<int>(((row0 + rc * kSplitRows + r) & 3) * n4)
                    & 3;
          float d[V];
          const float4* d4 = reinterpret_cast<const float4*>(dblk + rc * V);
#pragma unroll
          for (int v = 0; v < V; v += 4) {
            const float4 q = d4[v / 4];
            d[v] = q.x; d[v + 1] = q.y; d[v + 2] = q.z; d[v + 3] = q.w;
          }
          const float* tile = slots + slot * slot_floats;
#pragma unroll
          for (int i = 0; i < kSplitFpt; ++i) {
            const int f = t + i * kSplitThreads;
            if (f < len) {
#pragma unroll
              for (int r = 0; r < kSplitRows; ++r) {
                if (r < rb) {
                  const float av = tile[r * kSplitRowStride + sh[r] + f];
#pragma unroll
                  for (int k = 0; k < KG; ++k)
                    g[i][k] = __fmaf_rn(d[k * kSplitRows + r], av, g[i][k]);
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[slot]);
        }
#pragma unroll
        for (int i = 0; i < kSplitFpt; ++i) {
          const int f = t + i * kSplitThreads;
          if (f < len) {
#pragma unroll
            for (int k = 0; k < KG; ++k) {
              if (kModelOnChip || k < kg) {
                const float x = xrow[k][f0 + f];
                const float gk = __fdiv_rn(g[i][k], fb);
                xrow[k][f0 + f] =
                    __fmaf_rn(-lr[k], __fmaf_rn(tl2[k], x, gk), x);
              }
            }
          }
        }
      }
      if (p.resident) ld = ld0 + ns;
    }
    if (kModelOnChip) {
      for (int fc = 0; fc < nf; ++fc) {
#pragma unroll
        for (int i = 0; i < kSplitFpt; ++i) {
          const int32_t f = fc * kSplitSub + t + i * kSplitThreads;
          if (f < width) {
#pragma unroll
            for (int k = 0; k < KG; ++k)
              if (k < kg) p.xs[(job0 + k) * n + c0 + f] = xrow[k][f];
          }
        }
      }
    }
  }
}

template <int KG, bool kModelOnChip, bool kGrid>
int launch_split(const SplitArgs& p, size_t smem, cudaStream_t stream) {
  const auto kernel = sgd_split_kernel<KG, kModelOnChip, kGrid>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!kGrid && p.blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t groups = (static_cast<int64_t>(p.k) + KG - 1) / KG;
  const int64_t grid = kGrid ? p.blocks : groups * p.blocks;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kSplitThreads + 32);   // and the producer warp
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kGrid) {
    // every block resident at once, or the launch fails (no block spins
    // on a barrier that a block still waiting for an SM must reach)
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, p);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGrid>
int launch_split_jobs(const SplitArgs& p, size_t smem, bool model_on_chip,
                      cudaStream_t stream) {
  // jobs a group: the fewest of 1, 2, 4 (at most kgp) that hold K
  int kg = 1;
  while (kg < p.kgp && kg < p.k) kg *= 2;
  if (model_on_chip) {
    switch (kg) {
      case 1: return launch_split<1, true, kGrid>(p, smem, stream);
      case 2: return launch_split<2, true, kGrid>(p, smem, stream);
      default: return launch_split<4, true, kGrid>(p, smem, stream);
    }
  }
  switch (kg) {
    case 1: return launch_split<1, false, kGrid>(p, smem, stream);
    case 2: return launch_split<2, false, kGrid>(p, smem, stream);
    default: return launch_split<4, false, kGrid>(p, smem, stream);
  }
}

}  // namespace

// The ring route: K jobs on clusters of `cluster` blocks of `threads`
// consumer threads (and a producer warp); kernels/sgd/sgd.py's ring_plan
// picks both from (n, minibatch).  a and b 16-byte aligned, n % 4 == 0,
// minibatch 4, 8 or 16.  Launches on `stream`; returns the launch's CUDA
// error code.
extern "C" int sgd_ring_f32(const void* a, const void* b, const void* xs0,
                            const void* lrs, const void* l2s, int64_t m,
                            int32_t n, int32_t minibatch, int32_t epochs,
                            int32_t logreg, int32_t k, int32_t cluster,
                            int32_t threads, void* xs, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (cluster < 1 || cluster > 8 || threads < 32 || threads > kRingThreadsMax
      || threads % 32 || n <= 0 || n % 4
      || static_cast<int64_t>(cluster) * threads * 4 < n
      || reinterpret_cast<uintptr_t>(a) % 16
      || reinterpret_cast<uintptr_t>(b) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* f0 = static_cast<const float*>(xs0);
  const float* flr = static_cast<const float*>(lrs);
  const float* fl2 = static_cast<const float*>(l2s);
  float* fx = static_cast<float*>(xs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (minibatch) {
    case 4:
      return launch_ring<4>(fa, fb, f0, flr, fl2, m, n, epochs, logreg, k,
                            cluster, threads, fx, st);
    case 8:
      return launch_ring<8>(fa, fb, f0, flr, fl2, m, n, epochs, logreg, k,
                            cluster, threads, fx, st);
    case 16:
      return launch_ring<16>(fa, fb, f0, flr, fl2, m, n, epochs, logreg, k,
                             cluster, threads, fx, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The split route: K jobs in groups of up to `kgp` (1, 2 or 4), each
// group's features over `blocks` blocks of `width` features (a multiple
// of 4): one cluster (blocks <= 16), or with `grid` a cooperative launch
// of `blocks` <= 128 that trains the groups in turn, its exchange in
// `part` (float [2][blocks][ceil(minibatch / 16)][16 kgp]) and its
// barrier counter in `arrivals` (zeroed); a ring of `stages` sub-tile
// slots (2 to 16); `resident` keeps each step's tile in the ring from the
// dot to the update; `model_on_chip` keeps the model slices in shared
// memory; `prefetch` asks L2 for each next minibatch.
// kernels/sgd/sgd.py's split_plan picks all of them from (n, minibatch).
// a 16-byte aligned.  Launches on `stream`; returns the launch's CUDA
// error code.
extern "C" int sgd_split_f32(const void* a, const void* b, const void* xs0,
                             const void* lrs, const void* l2s, int64_t m,
                             int32_t n, int32_t minibatch, int32_t epochs,
                             int32_t logreg, int32_t k, int32_t blocks,
                             int32_t grid, int32_t width, int32_t stages,
                             int32_t resident, int32_t model_on_chip,
                             int32_t kgp, int32_t prefetch, void* part,
                             void* arrivals, void* xs, void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || blocks > (grid ? kSplitGridMax : kSplitClusterMax)
      || width <= 0 || width % 4 || n <= 0
      || static_cast<int64_t>(blocks) * width < n
      || stages < 2 || stages > kSplitStagesMax || minibatch <= 0
      || epochs < 0 || m < 0 || m % minibatch
      || (kgp != 1 && kgp != 2 && kgp != 4)
      || (grid && (part == nullptr || arrivals == nullptr))
      || reinterpret_cast<uintptr_t>(a) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.xs0 = static_cast<const float*>(xs0);
  p.lrs = static_cast<const float*>(lrs);
  p.l2s = static_cast<const float*>(l2s);
  p.xs = static_cast<float*>(xs);
  p.part = static_cast<float*>(part);
  p.arrivals = static_cast<uint32_t*>(arrivals);
  p.m = m;
  p.n = n;
  p.minibatch = minibatch;
  p.epochs = epochs;
  p.logreg = logreg;
  p.k = k;
  p.blocks = blocks;
  p.width = width;
  p.stages = stages;
  p.resident = resident;
  p.kgp = kgp;
  p.prefetch = prefetch;
  const size_t smem = split_layout(minibatch, blocks, grid, width, stages,
                                   model_on_chip != 0, kgp).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return grid ? launch_split_jobs<true>(p, smem, model_on_chip != 0, st)
              : launch_split_jobs<false>(p, smem, model_on_chip != 0, st);
}

// The shared memory one block may use on `device` (the opt-in maximum),
// written to *out; returns the CUDA error code.
extern "C" int sgd_max_shared_bytes(int32_t device, int32_t* out) {
  int v = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = v;
  return static_cast<int>(err);
}
