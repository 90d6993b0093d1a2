// Traffic generator (paper §II, Fig. 1/2) for Hopper (sm_90a).
//
// Replaces: stream_copy_pallas / _copy_kernel in src/repro/core/bandwidth.py
// Computes: o[i] = x[i] + 1 over a 1-D int32 or float32 array: every
//   element read once and written once, the read + write stream the
//   paper's traffic generators drive through each HBM port.  int32 wraps
//   at 2**31 - 1 as in JAX and PyTorch: the add is done in uint32 and cast
//   back, because signed overflow is undefined in C++.
// Bound: device-memory bytes (2 * n * 4 bytes); one add an element is far
//   below the card's integer and float rates.
// Design: a grid-stride loop over 16-byte vectors (int4 / float4), so a
//   warp's 32 loads cover four whole 128-byte sectors.  The grid is sized
//   by core/shim.py's plan_stream_block to fill the card; each thread
//   strides over the rest.  A scalar head runs up to x's first 16-byte
//   boundary and a scalar tail past the last whole vector, so any length
//   and any start address works (the engines of stream_copy_distributed
//   launch on slices that need not be aligned).  Vectors need x and o to
//   share their offset within 16 bytes: the wrapper allocates o so, and
//   where a caller's buffers differ the launcher streams scalars only.
#include "common.cuh"

namespace {

using repro_torch::kThreads;
constexpr int kVectorBytes = 16;

__device__ __forceinline__ int32_t plus_one(int32_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) + 1u);
}
__device__ __forceinline__ float plus_one(float v) { return v + 1.0f; }
__device__ __forceinline__ int4 plus_one(int4 v) {
  return make_int4(plus_one(v.x), plus_one(v.y), plus_one(v.z),
                   plus_one(v.w));
}
__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(plus_one(v.x), plus_one(v.y), plus_one(v.z),
                     plus_one(v.w));
}

template <typename T> struct Vector;
template <> struct Vector<int32_t> { using type = int4; };
template <> struct Vector<float> { using type = float4; };

// Elements [0, head) are scalars; then whole vectors; then a scalar tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_copy_kernel(const T* __restrict__ x, T* __restrict__ o, int64_t n,
                   int64_t head) {
  using V = typename Vector<T>::type;
  constexpr int64_t kPer = kVectorBytes / sizeof(T);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = tid; i < head; i += stride) o[i] = plus_one(x[i]);
  const int64_t n_vec = (n - head) / kPer;
  const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
  V* __restrict__ ov = reinterpret_cast<V*>(o + head);
  for (int64_t i = tid; i < n_vec; i += stride) ov[i] = plus_one(xv[i]);
  for (int64_t i = head + n_vec * kPer + tid; i < n; i += stride)
    o[i] = plus_one(x[i]);
}

template <typename T>
int launch(const void* x, void* o, int64_t n, int32_t grid, void* stream) {
  if (n > 0 && grid > 0) {
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
    int64_t head = n;                      // scalars only, unless ...
    if (xa % kVectorBytes == oa % kVectorBytes && xa % sizeof(T) == 0) {
      const int64_t lead = static_cast<int64_t>(
          (kVectorBytes - xa % kVectorBytes) % kVectorBytes / sizeof(T));
      head = lead < n ? lead : n;
    }
    stream_copy_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(o), n, head);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` with `grid` blocks; return cudaGetLastError().
extern "C" int stream_copy_i32(const void* x, void* o, int64_t n,
                               int32_t grid, void* stream) {
  return launch<int32_t>(x, o, n, grid, stream);
}

extern "C" int stream_copy_f32(const void* x, void* o, int64_t n,
                               int32_t grid, void* stream) {
  return launch<float>(x, o, n, grid, stream);
}
