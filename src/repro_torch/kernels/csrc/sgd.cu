// Minibatch SGD for GLMs (paper §VI, Fig. 9) for Hopper (sm_90a).
//
// Replaces: sgd_pallas / _sgd_kernel in src/repro/kernels/sgd/sgd.py.
// Computes: for each of K jobs (learning rate lr_k, L2 weight l2_k), from
//   x = xs0[k], `epochs` passes over the m rows in minibatches of B:
//     z_r = <a_r, x>,  d_r = link(z_r) - b_r           (link: identity or
//     g_j = (sum_r d_r a_rj) / B                        sigmoid)
//     x_j = x_j - lr * (g_j + 2 l2 * x_j)
//   and writes the final x to xs[k].
// Bound: neither bytes nor operations.  Each job is a chain of
//   epochs * m / B dependent steps (18,750 at the MNIST shape with B = 16
//   and 5 epochs), each a dot product, a block-wide barrier, a gradient
//   and another barrier, so its time is the chain's latency; the bytes
//   (the dataset, read once per job and epoch) and the 4 * m * n flops
//   per job and epoch are far below the card's rates.  PERF.md keeps the
//   measured time beside both bounds.
// Design: one CUDA block of 256 threads per job (the Fig. 10a
//   parallelism: every job trains at once, one per SM).  The job's model
//   lives in shared memory for the whole launch, as the TPU kernel kept
//   it in VMEM scratch; each step reads its (B, n) minibatch from global
//   memory.  Dot: warp w takes rows w, w + 8, ...; each lane sums its
//   strided features in order and the warp folds the 32 partials with a
//   fixed butterfly.  Update: thread t owns features t, t + 256, ... and
//   sums d_r a_rj over r = 0..B-1 in order.  No float atomics and no
//   order that depends on timing, so the kernel is deterministic: a job's
//   weights are the same however the rows are cut into launches (at
//   minibatch boundaries) and whichever jobs share the launch.  nvcc
//   contracts multiply-adds into FMAs and the sums run in another order
//   than torch.matmul, so the kernel agrees with its plain version within
//   a tolerance, not bit for bit.
#include "common.cuh"

#include <math.h>

namespace {

using repro_torch::kThreads;

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_fold(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const float* __restrict__ a, const float* __restrict__ b,
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
        if (lane == 0) {
          const float z = logreg ? 1.0f / (1.0f + expf(-s)) : s;
          d[r] = z - b[i * minibatch + r];
        }
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

}  // namespace

// Launches one block per job on `stream`; returns cudaGetLastError().
extern "C" int sgd_f32(const void* a, const void* b, const void* xs0,
                       const void* lrs, const void* l2s, int64_t m,
                       int32_t n, int32_t minibatch, int32_t epochs,
                       int32_t logreg, int32_t k, void* xs, void* stream) {
  if (k > 0) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(n) + minibatch);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sgd_kernel<<<static_cast<unsigned>(k), kThreads, smem,
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
