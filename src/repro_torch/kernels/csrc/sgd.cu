// Minibatch SGD for GLMs (paper §VI, Fig. 9) for Hopper (sm_90a).
//
// Replaces: sgd_pallas / _sgd_kernel in src/repro/kernels/sgd/sgd.py.
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
// Direct (sgd_direct_f32), every other (n, B) whose n + B floats fit one
//   block: one 256-thread block per job, the model in shared memory, each
//   step reading its (B, n) minibatch from global memory twice (dot:
//   warp w takes rows w, w + 8, ..., lanes stride the features; update:
//   thread t owns features t, t + 256, ...) with a barrier after each.
//
// Both routes sum in an order fixed by (n, B) and use no float atomics,
// so a job's weights are the same however the rows are cut into launches
// (at minibatch boundaries) and whichever jobs share the launch.  nvcc
// contracts multiply-adds into FMAs and the sums run in another order
// than torch.matmul, so the kernels agree with their plain version within
// a tolerance, not bit for bit.
#include "common.cuh"

#include <math.h>

namespace {

using repro_torch::kThreads;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRingThreadsMax = 256;   // consumer threads a ring block,
                                       // at most (plus a producer warp)
constexpr int kStages = 3;             // minibatch tiles in the ring

// sigmoid(s) = 1 / (1 + exp(-s)) for logreg, s for ridge.
__device__ __forceinline__ float link(float s, int32_t logreg) {
  return logreg ? 1.0f / (1.0f + expf(-s)) : s;
}

// ---- direct route -------------------------------------------------------- //

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_fold(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sgd_direct_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ xs0, const float* __restrict__ lrs,
                  const float* __restrict__ l2s, int64_t m, int32_t n,
                  int32_t minibatch, int32_t epochs, int32_t logreg,
                  float* __restrict__ xs) {
  extern __shared__ float smem[];
  float* x = smem;        // the job's model, n floats
  float* d = smem + n;    // link(z) - b of the current minibatch
  const int64_t job = blockIdx.x;
  const float lr = lrs[job];
  const float two_l2 = 2.0f * l2s[job];
  const float fb = static_cast<float>(minibatch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < n; j += kThreads) x[j] = xs0[job * n + j];
  __syncthreads();
  const int64_t nb = m / minibatch;
  for (int32_t e = 0; e < epochs; ++e) {
    for (int64_t i = 0; i < nb; ++i) {
      const float* blk = a + i * minibatch * static_cast<int64_t>(n);
      for (int r = warp; r < minibatch; r += kWarps) {            // Dot
        const float* row = blk + static_cast<int64_t>(r) * n;
        float s = 0.0f;
        for (int j = lane; j < n; j += 32) s += row[j] * x[j];
        s = warp_fold(s);
        if (lane == 0) d[r] = link(s, logreg) - b[i * minibatch + r];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kThreads) {           // Update
        float g = 0.0f;
        for (int r = 0; r < minibatch; ++r)
          g += d[r] * blk[static_cast<int64_t>(r) * n + j];
        g = g / fb;
        const float xj = x[j];
        x[j] = xj - lr * (g + two_l2 * xj);
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < n; j += kThreads) xs[job * n + j] = x[j];
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

// The direct route: one block per job on `stream`; returns
// cudaGetLastError().
extern "C" int sgd_direct_f32(const void* a, const void* b, const void* xs0,
                              const void* lrs, const void* l2s, int64_t m,
                              int32_t n, int32_t minibatch, int32_t epochs,
                              int32_t logreg, int32_t k, void* xs,
                              void* stream) {
  if (k > 0) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(n) + minibatch);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sgd_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sgd_direct_kernel<<<static_cast<unsigned>(k), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(xs0), static_cast<const float*>(lrs),
        static_cast<const float*>(l2s), m, n, minibatch, epochs, logreg,
        static_cast<float*>(xs));
  }
  return static_cast<int>(cudaGetLastError());
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
