// Shared pieces of the port's CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;  // threads per CUDA block in every kernel

// Sum of `v` over the CUDA block (kThreads threads): warp shuffles, then
// one pass of warp 0 over the per-warp partials.  The result is valid in
// thread 0 only.  At most one call per kernel (one static shared array).
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---- Hopper's TMA, mbarriers and wgmma, shared by B7's kernels ------- //
//
// The forward (flash_attention.cu) and the bf16 backward
// (flash_attention_bwd.cu) load through 4-D tensor maps with the
// 128-byte swizzle, pace a ring of tiles with mbarriers and multiply on
// wgmma; these are the pieces both use.
namespace sm90 {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = 128;    // a swizzled row of one TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The barriers of a block: q's full barrier, then k's and v's full
// barriers and the empty barrier of each stage of the ring.
template <int kStages> struct Barriers {
  uint32_t q_full;
  __device__ uint32_t k_full(int st) const { return q_full + 8 * (1 + st); }
  __device__ uint32_t v_full(int st) const {
    return q_full + 8 * (1 + kStages + st);
  }
  __device__ uint32_t empty(int st) const {
    return q_full + 8 * (1 + 2 * kStages + st);
  }
  static constexpr int kBytes = 8 * (1 + 3 * kStages);

  __device__ void init(uint32_t consumers) const {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The loads of one block, each issued by one thread: the q tile, and k
// and v tiles of `bc` rows into the stages of the ring.  A tile is
// `boxes` boxes of `box` columns; a box of r rows fills r * 128 bytes.
template <int kStages> struct Loader {
  Barriers<kStages> bars;
  const CUtensorMap *tm_q, *tm_k, *tm_v;
  uint32_t s_q, s_k, s_v;
  int boxes, box, br, bc, h, hk, q0, b;

  __device__ void q() const {
    mbar_expect_tx(bars.q_full, boxes * br * kRowBytes);
    for (int c = 0; c < boxes; ++c)
      tma_load_4d(s_q + c * br * kRowBytes, tm_q, bars.q_full, c * box, h, q0,
                  b);
  }
  // kv tile n into stage st, which must be free
  __device__ void kv(int n, int st) const {
    const uint32_t bytes = boxes * bc * kRowBytes;
    mbar_expect_tx(bars.k_full(st), bytes);
    for (int c = 0; c < boxes; ++c)
      tma_load_4d(s_k + st * bytes + c * bc * kRowBytes, tm_k, bars.k_full(st),
                  c * box, hk, n * bc, b);
    mbar_expect_tx(bars.v_full(st), bytes);
    for (int c = 0; c < boxes; ++c)
      tma_load_4d(s_v + st * bytes + c * bc * kRowBytes, tm_v, bars.v_full(st),
                  c * box, hk, n * bc, b);
  }
};

// The shared memory, in ints, that `position_tiles` takes for n_kv tiles.
__host__ __device__ constexpr int stats_ints(int n_kv) { return 3 * n_kv + 4; }
constexpr int kMaskBit = 1 << 30;

// Under the position mask: the kv tiles of kBc columns that the q tile
// (rows q0 .. q0 + kBr - 1 below seq_q) needs, in order, written to the
// list in `stats` as n, or n | kMaskBit where some (row, column) of the
// tile is masked or it is the ragged last tile; returns how many.  A tile
// whose least k position exceeds every row's q position adds nothing to
// any row, so it is skipped, unless some row keeps no key at all (that
// row averages every key, as a softmax over a fully masked row does):
// then none is.  qp and kp are the batch row's positions.  Every thread
// of the block calls this; `stats` is stats_ints(n_kv) ints of shared
// memory.
template <int kBc, int kBr>
__device__ int position_tiles(const int32_t* __restrict__ qp,
                              const int32_t* __restrict__ kp, int seq_q,
                              int seq_k, int q0, int n_kv, int* stats) {
  static_assert(kBc % 32 == 0 && kBr % 32 == 0, "a warp's 32 in one tile");
  int* kmin = stats;
  int* kmax = stats + n_kv;
  int* list = stats + 2 * n_kv;
  int* s = stats + 3 * n_kv;     // rows' largest and least q, count
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < n_kv; i += blockDim.x) {
    kmin[i] = INT32_MAX;
    kmax[i] = INT32_MIN;
  }
  if (tid == 0) {
    s[0] = INT32_MIN;
    s[1] = INT32_MAX;
  }
  __syncthreads();
  // a warp folds 32 consecutive columns (or rows), one lane's atomics
  for (int c0 = tid - lane; c0 < seq_k; c0 += blockDim.x) {
    const bool in = c0 + lane < seq_k;
    const int p = in ? kp[c0 + lane] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT32_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT32_MIN);
    if (lane == 0) {
      atomicMin(&kmin[c0 / kBc], lo);
      atomicMax(&kmax[c0 / kBc], hi);
    }
  }
  for (int r0 = tid - lane; r0 < kBr; r0 += blockDim.x) {
    const bool in = q0 + r0 + lane < seq_q;
    const int p = in ? qp[q0 + r0 + lane] : 0;
    const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT32_MIN);
    const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT32_MAX);
    if (lane == 0) {
      atomicMax(&s[0], hi);
      atomicMin(&s[1], lo);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int least = INT32_MAX;
    for (int n = 0; n < n_kv; ++n) least = min(least, kmin[n]);
    const bool skip = s[1] >= least;          // every row keeps a key
    int m = 0;
    for (int n = 0; n < n_kv; ++n)
      if (!skip || kmin[n] <= s[0])
        list[m++] = n | (kmax[n] > s[1] || (n + 1) * kBc > seq_k
                             ? kMaskBit : 0);
    s[2] = m;
  }
  __syncthreads();
  return s[2];
}

// Under the position mask, the tile list of the backward's dK / dV blocks
// (both routes), the transpose of `position_tiles`: the q tiles of kBq
// rows that the kv tile (rows k0 .. k0 + kBk - 1 below seq_k) must visit,
// in order, written to the list in `stats` as t, or t | kMaskBit where
// some pair of the two is masked; returns how many.  A q tile is listed
// where its largest q position reaches the kv tile's least k position
// (some row keeps a key of it), or where it holds a row that keeps no key
// at all (a q position below every k position of the batch row): such a
// row averages every key, P = 1 / Sk, so it adds to every kv tile's dV.  A
// listed tile is masked where its least q position is below the kv tile's
// largest k position, or where it holds such a row.  qp and kp are the
// batch row's positions; every thread of the block calls this; `stats` is
// stats_ints(n_q) ints of shared memory.
template <int kBq, int kBk>
__device__ int kv_position_tiles(const int32_t* __restrict__ qp,
                                 const int32_t* __restrict__ kp, int seq_q,
                                 int seq_k, int k0, int n_q, int* stats) {
  static_assert(kBq % 32 == 0 && kBk % 32 == 0, "a warp's 32 in one tile");
  int* qmin = stats;
  int* qmax = stats + n_q;
  int* list = stats + 2 * n_q;
  int* s = stats + 3 * n_q;   // the kv tile's least and largest k, the
                              // row's least k, count
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < n_q; i += blockDim.x) {
    qmin[i] = INT32_MAX;
    qmax[i] = INT32_MIN;
  }
  if (tid == 0) {
    s[0] = INT32_MAX;
    s[1] = INT32_MIN;
    s[2] = INT32_MAX;
  }
  __syncthreads();
  // a warp folds 32 consecutive rows (or columns), one lane's atomics
  for (int r0 = tid - lane; r0 < seq_q; r0 += blockDim.x) {
    const bool in = r0 + lane < seq_q;
    const int p = in ? qp[r0 + lane] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT32_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT32_MIN);
    if (lane == 0) {
      atomicMin(&qmin[r0 / kBq], lo);
      atomicMax(&qmax[r0 / kBq], hi);
    }
  }
  for (int c0 = tid - lane; c0 < seq_k; c0 += blockDim.x) {
    const bool in = c0 + lane < seq_k;
    const int p = in ? kp[c0 + lane] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, in ? p : INT32_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, in ? p : INT32_MIN);
    if (lane == 0) {
      atomicMin(&s[2], lo);
      if (c0 >= k0 && c0 < k0 + kBk) {
        atomicMin(&s[0], lo);
        atomicMax(&s[1], hi);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int t = 0; t < n_q; ++t) {
      const bool dead = qmin[t] < s[2];
      if (dead || qmax[t] >= s[0])
        list[m++] = t | (dead || qmin[t] < s[1] ? kMaskBit : 0);
    }
    s[3] = m;
  }
  __syncthreads();
  return s[3];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Makes the context of the device that holds `p` current on this thread.
// cuTensorMapEncodeTiled is a driver call and fails on a thread that has
// made no CUDA call yet (autograd's backward worker, when an attention's
// backward is its first op; any fresh thread whose first op is a launch),
// so every launcher that encodes tensor maps calls this first.
inline cudaError_t bind_device(const void* p) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, p);
  return err != cudaSuccess ? err : cudaSetDevice(attr.device);
}

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (D, heads, S, B) over a contiguous (B, S, heads, D) tensor of
// bfloat16 or float32, boxes of 128 bytes of columns x 1 head x `rows`
// rows x 1, 128-byte swizzle; columns past D and rows past S read as zeros.
inline bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, bool bf16,
              int d, int heads, int seq, int batch, int rows) {
  const cuuint64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * esize;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kRowBytes / esize), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of accumulators across the wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

}  // namespace sm90

// ---- split TF32 on mma.sync, shared by B7's and B8's f32 routes ------- //
//
// An f32 operand x is split into hi + lo, each read by the tensor cores as
// TF32, and a . b = lo.hi + hi.lo + hi.hi is summed in f32 (lo.lo, under
// 2^-22 of the product, is dropped).  B7's f32 forward and backward
// (flash_attention.cu) and B8's f32 backward (ssd_bwd.cu) use these.
namespace tf32 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half of the dropped unit added to the magnitude bits, then
// the low 13 of the 23 mantissa bits cleared, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = tf32(x), lo = the remainder, which x - hi holds
// exactly, rounded to TF32 too (kRoundLo) or left whole: the tensor cores
// then read its 19 high bits, dropping under 2^-11 of lo (|lo| <= 2^-12
// |x|), two integer operations fewer.
template <bool kRoundLo = true>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  const float rest = x - __uint_as_float(hi);
  lo = kRoundLo ? tf32_rna(rest) : __float_as_uint(rest);
}

// The A operand (16 x 8, row) of one k step from its four elements: rows
// g and g + 8 at k index t (x0, x1) and t + 4 (x2, x3), split.
template <bool kRoundLo = true>
__device__ __forceinline__ void split_a(float x0, float x1, float x2,
                                        float x3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split<kRoundLo>(x0, hi[0], lo[0]);
  split<kRoundLo>(x1, hi[1], lo[1]);
  split<kRoundLo>(x2, hi[2], lo[2]);
  split<kRoundLo>(x3, hi[3], lo[3]);
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) . B (8 x 8, tf32, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with a and b split (b's k indices t and t + 4 in b0, b1):
// the small terms first, then hi . hi.
template <bool kRoundLo = true>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split<kRoundLo>(b0, bh0, bl0);
  split<kRoundLo>(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

}  // namespace tf32

}  // namespace repro_torch
