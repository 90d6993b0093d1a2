// Range selection (paper §IV, Fig. 4) for Hopper (sm_90a).
//
// Replaces: select_pallas / _selection_kernel in
//   src/repro/kernels/selection/selection.py
// Computes: for an int32 or float32 column x of n rows and an inclusive
// [lo, hi] of the column's own type,
//   idx[i]    = i if lo <= x[i] <= hi else -1       (the index line)
//   counts[b] = matches in rows [b*block, min((b+1)*block, n))
// The float32 entry compares as the TPU kernel does after it casts the
// bounds to x.dtype: the caller passes them rounded to float32, and a NaN
// row never matches (both ordered compares are false).
// Bound: device-memory bytes.  Each row is read once (4 B) and its index
//   line written once (4 B), plus 4 B per logical block; two compares a
//   row are far below the card's integer rate.
// Design: one CUDA block of 256 threads per logical block.  Threads stride
//   through the block's rows, so neighbouring threads touch neighbouring
//   addresses (coalesced 128-byte sectors); the per-block count is a warp
//   shuffle reduction then one shared-memory pass, written by one thread,
//   so nothing carries between CUDA blocks and no atomics are needed.  The
//   ragged tail (n % block != 0) is masked by the loop bound, which is
//   what lets the port drop the TPU kernel's n % block == 0 requirement.
#include "common.cuh"

namespace {

using repro_torch::block_sum;
using repro_torch::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_range_kernel(const T* __restrict__ x, int64_t n, T lo, T hi,
                    int64_t block, int32_t* __restrict__ idx,
                    int32_t* __restrict__ counts) {
  const int64_t b = blockIdx.x;
  const int64_t begin = b * block;
  const int64_t end = begin + block < n ? begin + block : n;
  int local = 0;
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const T v = x[i];
    const bool hit = (v >= lo) & (v <= hi);
    idx[i] = hit ? static_cast<int32_t>(i) : -1;
    local += hit;
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0) counts[b] = total;
}

template <typename T>
int launch_select(const void* x, int64_t n, T lo, T hi, int64_t block,
                  void* idx, void* counts, void* stream) {
  const int64_t n_blocks = (n + block - 1) / block;
  if (n_blocks > 0) {
    select_range_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), n, lo, hi, block,
        static_cast<int32_t*>(idx), static_cast<int32_t*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int select_range_i32(const void* x, int64_t n, int32_t lo,
                                int32_t hi, int64_t block, void* idx,
                                void* counts, void* stream) {
  return launch_select<int32_t>(x, n, lo, hi, block, idx, counts, stream);
}

extern "C" int select_range_f32(const void* x, int64_t n, float lo,
                                float hi, int64_t block, void* idx,
                                void* counts, void* stream) {
  return launch_select<float>(x, n, lo, hi, block, idx, counts, stream);
}
