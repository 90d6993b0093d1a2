// Flash attention (online softmax) for Hopper (sm_90a), in two routes.
//
// Replaces: flash_attention / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py.
// Computes: for q (B, S, H, D) and k, v (B, S, KV, D) in model layout
//   (H a multiple of KV; q head h reads kv head h / (H / KV)):
//     s_ij = (q_i . k_j) * D^-1/2             in f32, masked to -1e30 where
//                                             j > i (causal) or j >= S
//     o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
//   with the running (m, l, acc) of the online softmax in f32 and p rounded
//   to the value type before p . v (l sums the unrounded p), as the TPU
//   kernel does; o in q's type.
// Bound: operations.  At the llama3-8b prefill shape (B 4, S 2,000, H 32,
//   KV 8, D 128, bf16) the causal half of Q.K^T and P.V is 131 GFLOP
//   against 164 MB of q, k, v and o; at the card's bf16 tensor rate that
//   is 0.13 ms, at its memory rate 0.05 ms.
// Routes, a plain function of (dtype, D) that the wrapper decides before
//   the launch (flash_attention.route):
//   * tensor cores (flash_attention_tc_fwd): bfloat16 with D 64 or 128,
//     which is every served model's prefill.  Its design:
//     - a block of three warpgroups per (128-row q tile, b * H + h), the
//       heaviest causal q tiles of every head first.  Warpgroup 0 is the
//       producer: it gives up registers (setmaxnreg to 40) and one thread
//       issues every TMA load.  Warpgroups 1 and 2 are consumers (232
//       registers), each owning 64 q rows;
//     - TMA over 4-D tensor maps (D, heads, S, B), encoded on the host, so
//       a (b, head, s0) tile is one coordinate, kv head h / (H / KV) is
//       read in place (GQA needs no copy), and rows past S arrive as
//       zeros.  A box is 64 columns (128 bytes) with the 128-byte swizzle,
//       so D = 128 loads as two boxes.  The q tile is loaded once; k and v
//       tiles of 128 rows stream through a ring of two stages with full
//       and empty mbarriers, k and v on their own full barriers, so Q.K^T
//       starts before v lands.  D = 128: q 32 KB + 2 x (k 32 KB + v 32 KB)
//       = 160 KB, so 128-row kv tiles fit with two stages, one block an SM;
//     - S = Q.K^T: wgmma m64n128k16 bf16 -> f32, A = q and B = k both
//       K-major from shared memory.  The online softmax runs on the
//       accumulator fragments: a thread holds two rows, each row's values
//       lie in the four threads of a quad, so its max folds with two
//       shuffles (l stays a per-thread partial sum until the epilogue);
//       scale * log2 e is folded into exp2f.  Only the diagonal tile and
//       the ragged last tile are masked; kv tiles past the diagonal are
//       not loaded;
//     - O += P.V: p in bf16 packed straight from the accumulator fragment
//       into wgmma's register A operand (the f32 layout of one 16-column
//       slice of S is the bf16 A layout of that k step), B = v from shared
//       memory MN-major, transposed by the descriptor, so v needs no
//       transposed copy;
//     - o / max(l, 1e-30) in bf16, stored from the fragments with the row
//       mask.
//     The driver's cuTensorMapEncodeTiled is found at run time through
//     cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//   * CUDA cores (flash_attention_fwd): float32 (tensor cores would mean
//     TF32, which cannot meet the f32 tolerance of 2e-5), and bfloat16 with
//     D 16, 32, 80 or 96.  Its design: one block of 256 threads per (64-row
//     q tile, b * H + h).  The q tile is staged once, transposed, in shared
//     memory; k and v tiles of 64 rows stream through one shared buffer (k
//     transposed for Q.K^T, then v row-major for P.V).  Thread (ty, tx) of
//     a 16 x 16 layout owns rows 4 ty .. 4 ty + 3 of the tile: 4 x 4
//     scores (columns 4 tx .. 4 tx + 3) and 4 x D/16 outputs (columns
//     tx + 16 c); the 16 threads of a row group are one half-warp, so row
//     maxima and sums fold with shuffles.  Kv tiles strictly above the
//     diagonal are skipped, and the q tiles with the most work are
//     scheduled first.
//   Both routes mask the ragged last q and kv tiles, so any S >= 1 works
//   (the TPU kernel needs S % 128 == 0).  PERF.md keeps each route's time
//   beside the bound.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using repro_torch::kThreads;

constexpr int kTile = 64;            // q rows and kv rows per tile
constexpr int kPStride = kTile + 4;  // padded row of P (keeps 16-byte rows)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// p rounded to the value type, as the TPU kernel's p.astype(v.dtype)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * static_cast<size_t>(D) * kTile +
                          static_cast<size_t>(kTile) * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int32_t seq,
             int32_t heads, int32_t kv_heads, int32_t causal, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                       // [D][kTile], q tile transposed
  float* kv = qT + D * kTile;             // kT [D][kTile], then v [kTile][D]
  float* ps = kv + D * kTile;             // p [kTile][kPStride]

  const int n_qt = (seq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const int64_t q_row = static_cast<int64_t>(heads) * D;     // token stride
  const int64_t kv_row = static_cast<int64_t>(kv_heads) * D;
  const T* qb = q + static_cast<int64_t>(b) * seq * q_row + h * D;
  const T* kb = k + static_cast<int64_t>(b) * seq * kv_row + hk * D;
  const T* vb = v + static_cast<int64_t>(b) * seq * kv_row + hk * D;

  // the q tile, transposed; rows past S read as 0 and are never stored
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i % kTile, d = i / kTile;
    qT[d * kTile + r] = q0 + r < seq ? to_f32(qb[(q0 + r) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // causal: kv tiles whose first row lies past the tile's last q row are
  // skipped; the last one processed holds the diagonal
  const int last_q = min(q0 + kTile, seq) - 1;
  const int kv_end = causal ? last_q + 1 : seq;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();                      // kv and ps are free again
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i % kTile, d = i / kTile;
      kv[d * kTile + j] = k0 + j < seq ? to_f32(kb[(k0 + j) * kv_row + d])
                                       : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * kTile + 4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&kv[d * kTile + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // online softmax over this tile's columns, one row group per half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 4 * tx + c;
        const bool keep = kj < seq && (!causal || kj <= qi);
        s[r][c] = keep ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = expf(s[r][c] - m_new);
        sum += p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      *reinterpret_cast<float4*>(&ps[(4 * ty + r) * kPStride + 4 * tx]) =
          make_float4(round_to<T>(p[0]), round_to<T>(p[1]),
                      round_to<T>(p[2]), round_to<T>(p[3]));
    }
    __syncthreads();                      // scores done with kT; p written

    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i % D;
      kv[j * D + d] = k0 + j < seq ? to_f32(vb[(k0 + j) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    const int n_j = min(kTile, seq - k0);
    for (int j = 0; j < n_j; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&ps[(4 * ty + r) * kPStride + j]);
        pr[r][0] = t4.x; pr[r][1] = t4.y; pr[r][2] = t4.z; pr[r][3] = t4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j + jj >= n_j) break;
        const float* vr = &kv[(j + jj) * D];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = vr[tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r][jj], vv, acc[r][c]);
        }
      }
    }
  }

  T* ob = o + static_cast<int64_t>(b) * seq * q_row + h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= seq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[qi * q_row + tx + 16 * c] = from_f32<T>(acc[r][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int32_t b,
           int32_t s, int32_t h, int32_t kvh, int32_t causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((s + kTile - 1) / kTile, static_cast<unsigned>(b) * h);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, kvh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int32_t b,
             int32_t s, int32_t h, int32_t kvh, int32_t d, int32_t causal,
             float sc, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    case 32: return launch<T, 32>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    case 64: return launch<T, 64>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    case 80: return launch<T, 80>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    case 96: return launch<T, 96>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    case 128: return launch<T, 128>(q, k, v, o, b, s, h, kvh, causal, sc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, s, h, d), k and v (b, s, kvh, d), o like q, all contiguous, of
// float32 (bf16 == 0) or bfloat16 (bf16 == 1); d one of 16, 32, 64, 80,
// 96, 128; `scale` multiplies q . k (D^-1/2, rounded to float by the
// caller).  Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int32_t b,
                                   int32_t s, int32_t h, int32_t kvh,
                                   int32_t d, int32_t causal, int32_t bf16,
                                   float scale, void* stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, kvh, d, causal,
                                        scale, st)
              : dispatch<float>(q, k, v, o, b, s, h, kvh, d, causal, scale,
                                st);
}

// ---- the tensor-core route ---------------------------------------------- //

namespace {
namespace tc {

constexpr int kBr = 128;          // q rows a block: two consumer warpgroups
constexpr int kBc = 128;          // kv rows a tile
constexpr int kStages = 2;        // the k, v ring
constexpr int kBlock = 384;       // the producer warpgroup and two consumers
constexpr int kBox = 64;          // columns a TMA box: 128 bytes, the swizzle
constexpr int kRowBytes = 128;    // a swizzled row of one box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Layout {
  static_assert(D == 64 || D == 128, "the tensor-core route takes D 64, 128");
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQBytes = kBr * D * 2;
  static constexpr int kKVBytes = kBc * D * 2;
  // offsets from a 1024-byte-aligned base (the 128-byte swizzle repeats
  // every 8 rows, and wgmma's descriptors assume that alignment)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kUsed = kBars + 8 * (1 + 3 * kStages) + 1024;
  // at least 116 KB, so never two blocks share an SM: each block's
  // setmaxnreg.inc needs the registers its producer gives up, and two
  // blocks could each wait for the other's
  static constexpr int kBytes = kUsed > 116 * 1024 ? kUsed : 116 * 1024;
};

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

template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 2],
                                        const uint32_t (&a)[4], uint64_t dv);
template <>
__device__ __forceinline__ void pv_step<128>(float (&acc)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t dv) {
  wgmma_rs_n128(acc, a, dv);
}
template <>
__device__ __forceinline__ void pv_step<64>(float (&acc)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t dv) {
  wgmma_rs_n64(acc, a, dv);
}

template <int D>
__global__ void __launch_bounds__(kBlock, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int32_t seq, int32_t heads,
                int32_t kv_heads, int32_t bh_total, int32_t causal,
                float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  const auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  const auto empty = [&](int st) {
    return q_full + 8 * (1 + 2 * kStages + st);
  };

  const int n_qt = (seq + kBr - 1) / kBr;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_total;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kBr;
  const int n_kv_all = (seq + kBc - 1) / kBc;
  // causal: kv tiles past the tile's last q row are never loaded
  const int n_kv = causal ? min(n_kv_all, (min(q0 + kBr, seq) - 1) / kBc + 1)
                          : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(s_q + c * kBr * kRowBytes, &tm_q, q_full, c * kBox, h, q0,
                    b);
      for (int n = 0; n < n_kv; ++n) {
        const int st = n % kStages;
        if (n >= kStages) mbar_wait(empty(st), ((n / kStages) - 1) & 1);
        const uint32_t kb = s_k + st * L::kKVBytes;
        const uint32_t vb = s_v + st * L::kKVBytes;
        mbar_expect_tx(k_full(st), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(kb + c * kBc * kRowBytes, &tm_k, k_full(st), c * kBox,
                      hk, n * kBc, b);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(vb + c * kBc * kRowBytes, &tm_v, v_full(st), c * kBox,
                      hk, n * kBc, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // the thread's rows r0 and r0 + 8; in every 8-column group of an
    // accumulator it holds columns cq and cq + 1 of both rows
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t qa = s_q + cw * 64 * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[kBc / 2];
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) sc[i] = 0.f;
    uint32_t pa[kBc / 16][4];

    mbar_wait(q_full, 0);
    for (int n = 0; n < n_kv; ++n) {
      const int st = n % kStages;
      const uint32_t par = (n / kStages) & 1;
      const uint32_t kb = s_k + st * L::kKVBytes;
      const uint32_t vb = s_v + st * L::kKVBytes;

      // S = Q . K^T over D in steps of 16 (32 bytes within a swizzled row;
      // the second box of D = 128 starts kBr (kBc) rows on)
      mbar_wait(k_full(st), par);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(
            sc,
            sw128_desc(qa + (kk / 4) * kBr * kRowBytes + (kk % 4) * 32, 16,
                       1024),
            sw128_desc(kb + (kk / 4) * kBc * kRowBytes + (kk % 4) * 32, 16,
                       1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // masks on the diagonal and the ragged last tile only; then the
      // online softmax in log2 units, rows folded over the quad
      const int k0 = n * kBc;
      const bool edge = k0 + kBc > seq ||
                        (causal && k0 + kBc - 1 > q0 + 64 * cw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + cq + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          if (col >= seq || (causal && col > row)) x = kNegInf;
        }
        sc[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        const float p = exp2f(sc[i] - m[(i / 2) % 2]);
        l[(i / 2) % 2] += p;
        sc[i] = p;
      }
      // k step kk of P.V reads columns 16 kk .. 16 kk + 15 of P: the
      // accumulator's registers 8 kk .. 8 kk + 7, paired in order
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P . V over the tile's kv rows in steps of 16 (2,048 bytes);
      // v's D columns are its MN dimension, the second box kBc rows on
      mbar_wait(v_full(st), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
        pv_step<D>(acc, pa[kk],
                   sw128_desc(vb + kk * 16 * kRowBytes, kBc * kRowBytes,
                              1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(st));
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
    const int64_t row_stride = static_cast<int64_t>(heads) * D;
    __nv_bfloat16* ob = o + static_cast<int64_t>(b) * seq * row_stride +
                        static_cast<int64_t>(h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= seq) continue;
      __nv_bfloat16* orow = ob + row * row_stride + cq;
#pragma unroll
      for (int g = 0; g < D / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g) =
            __floats2bfloat162_rn(acc[4 * g + 2 * r] / den[r],
                                  acc[4 * g + 2 * r + 1] / den[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
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

// A 4-D map (D, heads, S, B) over a contiguous (B, S, heads, D) bf16 tensor,
// boxes of 64 columns x 1 head x `rows` rows x 1, 128-byte swizzle, rows
// past S read as zeros.
bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
              int heads, int seq, int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int32_t b,
           int32_t s, int32_t h, int32_t kvh, int32_t causal, float scale,
           cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!make_map(fn, &mq, q, D, h, s, b, kBr) ||
      !make_map(fn, &mk, k, D, kvh, s, b, kBc) ||
      !make_map(fn, &mv, v, D, kvh, s, b, kBc))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bh = static_cast<int64_t>(b) * h;
  const int64_t blocks = bh * ((s + kBr - 1) / kBr);
  if (bh > INT32_MAX || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_tc_kernel<D><<<static_cast<unsigned>(blocks), kBlock, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, h, kvh,
      static_cast<int32_t>(bh), causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// The tensor-core route: q (b, s, h, d), k and v (b, s, kvh, d), o like q,
// all contiguous bfloat16 with 16-byte-aligned data; d 64 or 128; `scale`
// multiplies q . k (D^-1/2).  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorNotSupported if the driver has no
// cuTensorMapEncodeTiled).
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* o, int32_t b,
                                      int32_t s, int32_t h, int32_t kvh,
                                      int32_t d, int32_t causal, float scale,
                                      void* stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return tc::launch<64>(q, k, v, o, b, s, h, kvh, causal, scale, st);
    case 128:
      return tc::launch<128>(q, k, v, o, b, s, h, kvh, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
