// Traffic generator (paper §II, Fig. 1/2) for Hopper (sm_90a).
//
// Replaces: stream_copy_pallas / _copy_kernel in src/repro/core/bandwidth.py
// Computes: o[i] = x[i] + 1 over a 1-D int32 or float32 array: every
//   element read once and written once, the read + write stream the
//   paper's traffic generators drive through each HBM port.  int32 wraps
//   at 2**31 - 1 as in JAX and PyTorch: the add is done in uint32 and cast
//   back, because signed overflow is undefined in C++.
// Bound: device-memory bytes, 2 * n * 4 (0.641 ms for 1 GiB of int32 at
//   3.35 TB/s); one add an element is far below the card's rates.
// Design: a wave of two resident blocks per SM, each claiming tiles of 4 x
//   256 16-byte vectors (int4 / float4) from a counter in device memory
//   (atomicAdd) until none is left, so a block that draws less bandwidth than
//   its neighbours takes fewer tiles and no SM idles at the end (a static
//   split, by contiguous chunk or by grid stride, ends on a tail of slow
//   blocks).  A thread issues its four loads before its first store, and a
//   warp's loads for one slot cover four whole 128-byte sectors.  Plain loads
//   and stores: the evict-first hints (__ldcs / __stcs,
//   ld.global.nc.L1::no_allocate) measured slower on an H100, and so did a
//   ring of bulk copies through shared memory (cp.async.bulk, one persistent
//   block an SM; PERF.md).  Each launch zeroes its counter first
//   (cudaMemsetAsync on the wrapper's 4-byte scratch).  A scalar head runs up
//   to x's first 16-byte boundary and a scalar tail past the last whole
//   vector, so any length and any start address works (the engines of
//   stream_copy_distributed launch on slices that need not be aligned).
//   Vectors need x and o to share their offset within 16 bytes: the wrapper
//   allocates o so, and where a caller's buffers differ the launcher streams
//   scalars only.
#include "common.cuh"

namespace {

using repro_torch::kThreads;
constexpr int kVectorBytes = 16;
constexpr int kUnroll = 4;      // core/shim.py's UNROLL: loads in flight

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

// Elements [0, head) and the tail past the last whole vector are scalars,
// streamed by block 0; the vectors go in tiles of kUnroll * kThreads, each
// claimed by one block through `next_tile`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_copy_kernel(const T* __restrict__ x, T* __restrict__ o, int64_t n,
                   int64_t head, unsigned* __restrict__ next_tile) {
  using V = typename Vector<T>::type;
  constexpr int64_t kPer = kVectorBytes / sizeof(T);
  constexpr int64_t kTile = kUnroll * kThreads;
  __shared__ unsigned claimed;
  const int64_t n_vec = (n - head) / kPer;
  const int64_t tiles = (n_vec + kTile - 1) / kTile;
  const V* __restrict__ xv = reinterpret_cast<const V*>(x + head);
  V* __restrict__ ov = reinterpret_cast<V*>(o + head);
  for (;;) {
    if (threadIdx.x == 0) claimed = atomicAdd(next_tile, 1u);
    __syncthreads();
    const int64_t tile = claimed;
    __syncthreads();
    if (tile >= tiles) break;
    const int64_t i = tile * kTile + threadIdx.x;
    if (i + (kUnroll - 1) * kThreads < n_vec) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = xv[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ov[i + u * kThreads] = plus_one(v[u]);
    } else {
      for (int u = 0; u < kUnroll && i + u * kThreads < n_vec; ++u)
        ov[i + u * kThreads] = plus_one(xv[i + u * kThreads]);
    }
  }
  if (blockIdx.x == 0) {
    for (int64_t i = threadIdx.x; i < head; i += kThreads)
      o[i] = plus_one(x[i]);
    for (int64_t i = head + n_vec * kPer + threadIdx.x; i < n; i += kThreads)
      o[i] = plus_one(x[i]);
  }
}

// Elements before the first 16-byte boundary of x: all n unless x and o
// share their offset within 16 bytes.
template <typename T>
int64_t scalar_head(const void* x, const void* o, int64_t n) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
  if (xa % kVectorBytes != oa % kVectorBytes || xa % sizeof(T) != 0) return n;
  const int64_t lead = static_cast<int64_t>(
      (kVectorBytes - xa % kVectorBytes) % kVectorBytes / sizeof(T));
  return lead < n ? lead : n;
}

template <typename T>
int launch(const void* x, void* o, int64_t n, int32_t grid, int32_t unroll,
           void* next_tile, void* stream) {
  if (n <= 0 || grid <= 0) return static_cast<int>(cudaGetLastError());
  if (unroll != kUnroll) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(next_tile);
  const cudaError_t err = cudaMemsetAsync(ctr, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_copy_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(o), n,
      scalar_head<T>(x, o, n), ctr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` with `grid` blocks claiming tiles of `unroll` (4,
// the compiled kUnroll) x 256 vectors through the 4-byte scratch
// `next_tile`; return the CUDA error.
extern "C" int stream_copy_i32(const void* x, void* o, int64_t n,
                               int32_t grid, int32_t unroll, void* next_tile,
                               void* stream) {
  return launch<int32_t>(x, o, n, grid, unroll, next_tile, stream);
}

extern "C" int stream_copy_f32(const void* x, void* o, int64_t n,
                               int32_t grid, int32_t unroll, void* next_tile,
                               void* stream) {
  return launch<float>(x, o, n, grid, unroll, next_tile, stream);
}
