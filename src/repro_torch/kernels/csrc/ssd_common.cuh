// Shared pieces of the SSD (Mamba-2) chunk scan's kernels: the forward
// (ssd.cu) and its gradient (ssd_bwd.cu).
//
// Both take the chunks of a head in parallel, a block per (batch row,
// chunk, head), and rebuild a chunk's log-decays cum (the cumsum of a_t =
// -exp(a_log) dt_t over the chunk) in shared memory.  The forward sums and
// keeps cum in f32; the gradient in f64 (its Tag says so: CumOf): a chunk
// of strong decays sums to thousands, where an f32 cum carries an
// absolute error of 1e-4 into every exp(cum_i - cum_j) the passes take, a
// relative error that the gradients (a_log's above all) then show at
// 1e-4.  An f64 difference is rounded to f32 before its exp.
//
// Here: staging of tiles (cp.async), the chunk's cum, the tensor-core
// helpers (ldmatrix, mma.sync m16n8k16 bf16 -> f32, the hi / lo split of
// an f32 operand), pass 1 (a chunk's own state, or, for the backward, R_k
// = sum_i exp(cum_i) gy_i c_i^T, the same product with other operands and
// weights) and pass 2 (the state passing).
#pragma once

#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace repro_torch {
namespace ssd {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;   // rows or state columns of a CUDA-core tile
constexpr int kPad = 8;      // bf16 padding of a tensor-core tile's rows

struct Shape {
  int32_t bsz, seq, nh, hd, ng, ds, q, nc;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(V)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int V, typename T>
__device__ __forceinline__ void stage_vec(T* dst, int dstride, const T* src,
                                          int64_t sstride, int rows,
                                          int valid, int width) {
  const int per = width * static_cast<int>(sizeof(T)) / V;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, v = i % per;
    char* d = reinterpret_cast<char*>(dst + r * dstride) + v * V;
    if (r < valid) {
      cp_async<V>(d, reinterpret_cast<const char*>(src + r * sstride) + v * V);
    } else if (V == 16) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (V == 8) {
      *reinterpret_cast<uint2*>(d) = make_uint2(0, 0);
    } else {
      *reinterpret_cast<uint32_t*>(d) = 0;
    }
  }
}

// Copy `rows` rows of `width` elements from global memory (row stride
// `sstride` elements) into shared memory (row stride `dstride`); rows at
// or past `valid` are zero-filled.  cp.async moves the widest of 16, 8 or
// 4 bytes that every address allows; the caller waits on cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dstride, const T* src,
                                      int64_t sstride, int rows, int valid,
                                      int width) {
  const uint64_t all = reinterpret_cast<uintptr_t>(src) | smem_addr(dst)
                       | static_cast<uint64_t>(width * sizeof(T))
                       | static_cast<uint64_t>(sstride * sizeof(T))
                       | static_cast<uint64_t>(dstride * sizeof(T));
  if (all % 16 == 0) {
    stage_vec<16>(dst, dstride, src, sstride, rows, valid, width);
  } else if (all % 8 == 0) {
    stage_vec<8>(dst, dstride, src, sstride, rows, valid, width);
  } else if (all % 4 == 0) {
    stage_vec<4>(dst, dstride, src, sstride, rows, valid, width);
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width, e = i % width;
      dst[r * dstride + e] = r < valid ? src[r * sstride + e] : from_f32<T>(0.f);
    }
  }
}

// The chunk a block owns: blocks of one (b, chunk) are adjacent, so the
// heads of a group read its b and c tiles from L2.
struct Chunk {
  int bi, k, h, g, t0, len;
  int64_t idx;                // (bi, h, k) in the scratch
};

__device__ __forceinline__ Chunk chunk_of(const Shape& sh) {
  Chunk ch;
  ch.h = blockIdx.x % sh.nh;
  const int rest = blockIdx.x / sh.nh;
  ch.k = rest % sh.nc;
  ch.bi = rest / sh.nc;
  ch.g = ch.h / (sh.nh / sh.ng);
  ch.t0 = ch.k * sh.q;
  ch.len = min(sh.q, sh.seq - ch.t0);
  ch.idx = (static_cast<int64_t>(ch.bi) * sh.nh + ch.h) * sh.nc + ch.k;
  return ch;
}

// The type a kernel keeps cum in: f32 for the forward's instances (Tag
// void), Tag::cum for the gradient's.
template <typename Tag>
struct CumOf {
  using type = typename Tag::cum;
};
template <>
struct CumOf<void> {
  using type = float;
};
template <typename Tag>
using cum_t = typename CumOf<Tag>::type;

// The head of a block's shared memory: dt of the chunk (q floats), cum (q
// C) and 4 warp totals (C); cum_bytes is its size, a multiple of 16 for
// every q the kernels take.
template <typename C>
struct Cum {
  float* dtv;
  C* cum;
  C* wsum;
};

template <typename C>
__host__ __device__ inline size_t cum_bytes(int q) {
  return (4 + sizeof(C)) * static_cast<size_t>(q) + 4 * sizeof(C);
}

template <typename C>
__device__ __forceinline__ Cum<C> cum_at(void* smem, int q) {
  Cum<C> c;
  c.dtv = static_cast<float*>(smem);
  c.cum = reinterpret_cast<C*>(c.dtv + q);
  c.wsum = c.cum + q;
  return c;
}

// Past the head: the block's shared memory after cum_bytes<C>(q).
template <typename C>
__device__ __forceinline__ char* past_cum(void* smem, int q) {
  return static_cast<char*>(smem) + cum_bytes<C>(q);
}

// dt of the chunk (zero past S) into dtv, and cum = the chunk's inclusive
// cumsum of a_neg dt in C: a warp scan of each 32 values, then the totals
// of the warps before.  Needs blockDim.x >= q; every pass sums in this
// order.
template <typename C>
__device__ __forceinline__ void chunk_cum(const float* dt, const Shape& sh,
                                          const Chunk& ch, float a_neg,
                                          const Cum<C>& cm) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float* dtc = dt + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * sh.nh
                     + ch.h;
  C v = 0;
  if (tid < sh.q) {
    cm.dtv[tid] = tid < ch.len ? dtc[static_cast<int64_t>(tid) * sh.nh] : 0.f;
    v = static_cast<C>(a_neg) * cm.dtv[tid];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const C u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) cm.wsum[w] = v;
  }
  __syncthreads();
  if (tid < sh.q) {
    for (int i = 0; i < w; ++i) v += cm.wsum[i];
    cm.cum[tid] = v;
  }
  __syncthreads();
}

// exp(u - v) of two log-decays, the difference taken in their type
__device__ __forceinline__ float exp_diff(double u, double v) {
  return expf(static_cast<float>(u - v));
}

__device__ __forceinline__ float exp_diff(float u, float v) {
  return expf(u - v);
}

// ---- tensor-core helpers --------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as packed bf16 pairs hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// Fragment lanes: an m16n8 accumulator holds rows g and g + 8, columns
// 2 t and 2 t + 1; ldmatrix.x4 takes row rr of matrix qq from lane
// 8 qq + rr.
struct Lane {
  int g, t, qq, rr;
};

__device__ __forceinline__ Lane lane_of() {
  const int lane = threadIdx.x & 31;
  return Lane{lane >> 2, lane & 3, lane >> 3, lane & 7};
}

// ---- pass 1: chunk states -------------------------------------------------
//
// kOut false, the forward's chunk states: S_k = sum_j w_j x_j b_j^T with
// w_j = dt_j exp(cum_last - cum_j), and the chunk's decay exp(cum_last).
// kOut true, the backward's R_k = sum_i w_i gy_i c_i^T with w_i =
// exp(cum_i): the same product, called with gy for x and c for b, and no
// decay written.

// Shared: the head, w (q floats), then the route's tiles.
template <typename C>
inline size_t states_cc_smem(int q, int hd, int ds, int size) {
  return cum_bytes<C>(q) + 4 * static_cast<size_t>(q)
         + static_cast<size_t>(kSlice) * (hd + ds) * size;
}

template <typename C>
inline size_t states_tc_smem(int q, int hd, int ds) {
  return cum_bytes<C>(q) + 4 * static_cast<size_t>(q)
         + 2 * static_cast<size_t>(q) * (2 * (hd + kPad) + ds + kPad);
}

// The chunk's w (and, for the forward, its decay); returns the block's
// shared memory past w.
template <bool kOut, typename C>
__device__ __forceinline__ char* chunk_weights(
    const float* dt, const float* a_log, float* decay, const Shape& sh,
    const Chunk& ch, void* smem, float*& wv) {
  const Cum<C> cm = cum_at<C>(smem, sh.q);
  wv = reinterpret_cast<float*>(past_cum<C>(smem, sh.q));
  chunk_cum(dt, sh, ch, -expf(a_log[ch.h]), cm);
  const C last = cm.cum[sh.q - 1];
  for (int j = threadIdx.x; j < sh.q; j += blockDim.x)
    wv[j] = kOut ? expf(static_cast<float>(cm.cum[j]))
                 : cm.dtv[j] * exp_diff(last, cm.cum[j]);
  if (!kOut && threadIdx.x == 0) decay[ch.idx] = expf(static_cast<float>(last));
  __syncthreads();
  return reinterpret_cast<char*>(wv + sh.q);
}

// Thread (w, lane) sums S[d][s] for d = 32 m + 4 w + r, s = lane + 32 k
// over slices of 32 tokens; NC = ceil(hd / 32), ND = ceil(ds / 32).  Tag
// names the caller in the kernel's name (the backward's instances carry
// its namespace, so a profile can sum them apart from the forward's).
template <typename T, int NC, int ND, bool kOut, typename Tag>
__global__ void __launch_bounds__(kThreads)
states_cc(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a_log, const T* __restrict__ bm,
          float* __restrict__ states, float* __restrict__ decay, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int hd = sh.hd, ds = sh.ds;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const T* xc = x + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                + static_cast<int64_t>(ch.h) * hd;
  const T* bc = bm + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                + static_cast<int64_t>(ch.g) * ds;
  float* wv;
  T* xs = reinterpret_cast<T*>(chunk_weights<kOut, cum_t<Tag>>(
      dt, a_log, decay, sh, ch, smem, wv));                     // [kSlice][hd]
  T* bs = xs + kSlice * hd;                                     // [kSlice][ds]

  float acc[NC][4][ND];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < ND; ++k) acc[m][r][k] = 0.f;

  for (int j0 = 0; j0 < ch.len; j0 += kSlice) {
    const int n = min(kSlice, ch.len - j0);
    __syncthreads();                    // the last slice is consumed
    stage(xs, hd, xc + j0 * x_row, x_row, n, n, hd);
    stage(bs, ds, bc + j0 * b_row, b_row, n, n, ds);
    cp_async_wait_all();
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float wj = wv[j0 + jj];
      float xv[NC][4], bv[ND];
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = 32 * m + 4 * w + r;
          xv[m][r] = d < hd ? to_f32(xs[jj * hd + d]) * wj : 0.f;
        }
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const int s = lane + 32 * k;
        bv[k] = s < ds ? to_f32(bs[jj * ds + s]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < NC; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < ND; ++k)
            acc[m][r][k] = fmaf(xv[m][r], bv[k], acc[m][r][k]);
    }
  }
  float* out = states + ch.idx * hd * ds;
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = 32 * m + 4 * w + r;
      if (d >= hd) continue;
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const int s = lane + 32 * k;
        if (s < ds) out[d * ds + s] = acc[m][r][k];
      }
    }
}

// S = (x w)^T b as an (hd, ds) product over the chunk's tokens: warp w
// takes 16 x 16 tiles of S in turn; x w is split into hi and lo in place.
template <bool kOut, typename Tag>
__global__ void __launch_bounds__(kThreads)
states_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a_log, const bf16* __restrict__ bm,
          float* __restrict__ states, float* __restrict__ decay, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds;
  const int sx = hd + kPad, sb = ds + kPad;
  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  bf16* xh = reinterpret_cast<bf16*>(past_cum<cum_t<Tag>>(smem, q)
                                     + 4 * q);           // [q][sx]
  bf16* xl = xh + q * sx;                                // [q][sx], lo
  bf16* bs = xl + q * sx;                                // [q][sb]
  stage(xh, sx,
        x + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
            + static_cast<int64_t>(ch.h) * hd,
        x_row, q, ch.len, hd);
  stage(bs, sb,
        bm + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
            + static_cast<int64_t>(ch.g) * ds,
        b_row, q, ch.len, ds);
  float* wv;
  chunk_weights<kOut, cum_t<Tag>>(dt, a_log, decay, sh, ch, smem, wv);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < q * hd / 2; i += kThreads) {
    const int j = 2 * i / hd, d = 2 * i % hd;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(xh + j * sx + d);
    const float2 v = __bfloat1622float2(*hp);
    uint32_t hi, lo;
    split2(v.x * wv[j], v.y * wv[j], hi, lo);
    *reinterpret_cast<uint32_t*>(hp) = hi;
    *reinterpret_cast<uint32_t*>(xl + j * sx + d) = lo;
  }
  __syncthreads();

  const Lane ln = lane_of();
  const int ktiles = (ch.len + 15) / 16;   // token tiles that hold tokens
  const int nqs = ds / 16;
  float* out = states + ch.idx * hd * ds;
  for (int u = threadIdx.x >> 5; u < (hd / 16) * nqs; u += kWarps) {
    const int mt = u / nqs, nq = u % nqs;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < ktiles; ++ks) {
      uint32_t ah[4], al[4], bb[4];
      // A (d, j) from x w stored [j][d]; B (j, s) from b stored [j][s]
      const int ao = (16 * ks + (ln.qq >> 1) * 8 + ln.rr) * sx + 16 * mt
                     + (ln.qq & 1) * 8;
      ldsm_x4_t(ah, xh + ao);
      ldsm_x4_t(al, xl + ao);
      ldsm_x4_t(bb, bs + (16 * ks + (ln.qq & 1) * 8 + ln.rr) * sb + 16 * nq
                        + (ln.qq >> 1) * 8);
      mma(a0, ah, bb[0], bb[1]);
      mma(a0, al, bb[0], bb[1]);
      mma(a1, ah, bb[2], bb[3]);
      mma(a1, al, bb[2], bb[3]);
    }
    float* o = out + (16 * mt + ln.g) * ds + 16 * nq + 2 * ln.t;
    *reinterpret_cast<float2*>(o) = make_float2(a0[0], a0[1]);
    *reinterpret_cast<float2*>(o + 8 * ds) = make_float2(a0[2], a0[3]);
    *reinterpret_cast<float2*>(o + 8) = make_float2(a1[0], a1[1]);
    *reinterpret_cast<float2*>(o + 8 * ds + 8) = make_float2(a1[2], a1[3]);
  }
}

// ---- pass 2: state passing ------------------------------------------------

// Thread i of a head owns its state entries 4 i .. 4 i + 3 (n = hd ds per
// head; whole float4s when n % 4 == 0); the next chunk's load is issued
// before the current chunk's store (issuing four chunks' loads together
// measured slower).  h_out may be null (the backward's rebuild of the
// entering states needs no final state).
template <bool kVec, typename Tag>
__global__ void __launch_bounds__(kThreads)
state_pass(float* __restrict__ st, const float* __restrict__ decay,
           float* __restrict__ h_out, int32_t nc, int32_t n, int32_t tiles) {
  const int64_t head = blockIdx.x / tiles;
  const int e = ((blockIdx.x % tiles) * kThreads + threadIdx.x) * 4;
  if (e >= n) return;
  float* s = st + head * nc * n + e;
  const float* dec = decay + head * nc;
  float* ho = h_out == nullptr ? nullptr : h_out + head * n + e;
  if (kVec) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hv = zero;
    float4 cur = nc > 0 ? *reinterpret_cast<const float4*>(s) : zero;
    for (int k = 0; k < nc; ++k) {
      const float4 nxt =
          k + 1 < nc ? *reinterpret_cast<const float4*>(
                           s + static_cast<int64_t>(k + 1) * n)
                     : zero;
      const float dk = dec[k];
      *reinterpret_cast<float4*>(s + static_cast<int64_t>(k) * n) = hv;
      hv = make_float4(fmaf(hv.x, dk, cur.x), fmaf(hv.y, dk, cur.y),
                       fmaf(hv.z, dk, cur.z), fmaf(hv.w, dk, cur.w));
      cur = nxt;
    }
    if (ho != nullptr) *reinterpret_cast<float4*>(ho) = hv;
  } else {
    for (int i = 0; i < min(4, n - e); ++i) {
      float hv = 0.f;
      for (int k = 0; k < nc; ++k) {
        float* p = s + static_cast<int64_t>(k) * n + i;
        const float v = *p;
        *p = hv;
        hv = fmaf(hv, dec[k], v);
      }
      if (ho != nullptr) ho[i] = hv;
    }
  }
}

// ---- plans and launches ---------------------------------------------------

enum Mode { kF32 = 0, kBf16 = 1, kTensorCores = 2 };

struct Pass {
  const void* fn;
  size_t smem;
};

inline int groups(int n) { return n <= 32 ? 1 : n <= 64 ? 2 : 4; }

template <typename T, int NC, bool kOut, typename Tag>
const void* states_cc_fn(int nd) {
  switch (nd) {
    case 1:
      return reinterpret_cast<const void*>(&states_cc<T, NC, 1, kOut, Tag>);
    case 2:
      return reinterpret_cast<const void*>(&states_cc<T, NC, 2, kOut, Tag>);
    default:
      return reinterpret_cast<const void*>(&states_cc<T, NC, 4, kOut, Tag>);
  }
}

template <typename T, bool kOut, typename Tag>
Pass states_cc_pass(int q, int hd, int ds) {
  const int nd = groups(ds);
  Pass p;
  switch (groups(hd)) {
    case 1: p.fn = states_cc_fn<T, 1, kOut, Tag>(nd); break;
    case 2: p.fn = states_cc_fn<T, 2, kOut, Tag>(nd); break;
    default: p.fn = states_cc_fn<T, 4, kOut, Tag>(nd);
  }
  p.smem = states_cc_smem<cum_t<Tag>>(q, hd, ds, sizeof(T));
  return p;
}

// Pass 1 of `mode` (kOut: the backward's R_k).
template <bool kOut, typename Tag>
Pass states_pass(int mode, int q, int hd, int ds) {
  if (mode == kTensorCores)
    return Pass{reinterpret_cast<const void*>(&states_tc<kOut, Tag>),
                states_tc_smem<cum_t<Tag>>(q, hd, ds)};
  return mode == kBf16 ? states_cc_pass<bf16, kOut, Tag>(q, hd, ds)
                       : states_cc_pass<float, kOut, Tag>(q, hd, ds);
}

template <typename Tag>
Pass state_pass_pass(int hd, int ds) {
  return Pass{(hd * ds) % 4 == 0
                  ? reinterpret_cast<const void*>(&state_pass<true, Tag>)
                  : reinterpret_cast<const void*>(&state_pass<false, Tag>),
              0};
}

inline bool valid(int mode, int hd, int ds, int q) {
  if (hd <= 0 || ds <= 0 || hd > 128 || ds > 128 || q <= 0 || q > 128
      || q % 32)
    return false;
  if (mode == kTensorCores) return hd % 16 == 0 && ds % 16 == 0;
  return mode == kF32 || mode == kBf16;
}

inline cudaError_t allow_smem(const Pass& p) {
  if (p.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(p.smem));
}

inline cudaError_t launch(const Pass& p, unsigned grid, void** args,
                          cudaStream_t st) {
  const cudaError_t err = allow_smem(p);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(p.fn, dim3(grid), dim3(kThreads), args, p.smem, st);
}

// The state passing's grid: B nh heads of `tiles` blocks, each thread 4
// entries of a head's n = hd ds.
inline int32_t state_tiles(int32_t n) {
  return (n + 4 * kThreads - 1) / (4 * kThreads);
}

}  // namespace ssd
}  // namespace repro_torch
