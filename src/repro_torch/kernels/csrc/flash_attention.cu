// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces: flash_attention / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py.
// Computes: for q (B, S, H, D) and k, v (B, S, KV, D) in model layout
//   (H a multiple of KV; q head h reads kv head h / (H / KV)):
//     s_ij = (q_i . k_j) * D^-1/2             in f32, masked to -1e30 where
//                                             j > i (causal) or j >= S
//     o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
//   with the running (m, l, acc) of the online softmax in f32 and p rounded
//   to the value type before p . v, as the TPU kernel does; o in q's type.
// Bound: operations.  At the llama3-8b prefill shape (B 4, S 2,000, H 32,
//   KV 8, D 128, bf16) the causal half of Q.K^T and P.V is 131 GFLOP
//   against 164 MB of q, k, v and o; at the card's bf16 tensor rate that
//   is 0.13 ms, at its memory rate 0.05 ms.  This kernel runs on the CUDA
//   cores in f32 (67 TFLOP/s at most), so it cannot come near the bf16
//   bound: wgmma and TMA are the redesign's work.  PERF.md keeps its time
//   beside the bound.
// Design: one block of 256 threads per (64-row q tile, b * H + h).  The q
//   tile is staged once, transposed, in shared memory; k and v tiles of 64
//   rows stream through one shared buffer (k transposed for Q.K^T, then v
//   row-major for P.V), so no repeated copy of a kv head is made for GQA.
//   Thread (ty, tx) of a 16 x 16 layout owns rows 4 ty .. 4 ty + 3 of the
//   tile: 4 x 4 scores (columns 4 tx .. 4 tx + 3) and 4 x D/16 outputs
//   (columns tx + 16 c); the 16 threads of a row group are one half-warp,
//   so row maxima and sums fold with shuffles.  Kv tiles strictly above
//   the diagonal are skipped (the causal half), and the q tiles with the
//   most work are scheduled first.  The ragged last q and kv tiles are
//   masked, so any S >= 1 works (the TPU kernel needs S % 128 == 0).
#include "common.cuh"

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
