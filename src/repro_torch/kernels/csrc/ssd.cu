// The SSD (Mamba-2) chunk scan for Hopper (sm_90a).
//
// Replaces: ssd_pallas / _ssd_kernel in src/repro/kernels/ssd/ssd.py.
// Computes: for x (B, S, nh, hd), dt (B, S, nh) f32, b and c (B, S, ng, ds),
//   a_log and d_skip (nh,) f32 (head h reads group h / (nh / ng)), chunk by
//   chunk of Q tokens with the state h (hd, ds) carried in f32:
//     a_t = -exp(a_log) dt_t,  cum = cumsum of a over the chunk
//     y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (c_i . h) + d_skip x_i
//     h   = h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j b_j^T
//   in f32, like the TPU kernel; y in x's type, the final h in f32.
// Bound: operations.  At the mamba2-780m prefill shape (B 4, S 2,000,
//   nh 48, hd 64, ng 1, ds 128, bf16) the four products of every chunk
//   (the causal half of C.B^T and of the scores times x, C.h^T, and the
//   state update) are 22 GFLOP of f32 work against 110 MB of inputs and
//   outputs: 0.33 ms at the card's f32 rate, 0.03 ms at its memory rate.
//   PERF.md keeps the measured time beside the bound.
// Design: one block of 256 threads per (b, head), the chunks in sequence
//   inside it, as the TPU kernel's sequential grid axis; h stays in shared
//   memory across chunks as it stayed in VMEM.  A chunk's x dt and b (in
//   f32, b transposed) are staged whole; c and the masked, decayed scores
//   go through in tiles of 32 rows, so a Q x Q score block is never held
//   and mamba2's hd 64, ds 128 use 163 KB of the 227 KB a block may use.
//   Warp w owns rows 4 w .. 4 w + 3 of a tile, lane l the columns l + 32 k;
//   padded row strides keep the shared-memory reads free of bank conflicts.
//   The ragged last chunk is masked (dt = 0 past S contributes nothing),
//   so any S >= 1 works; the wrapper raises on a shape past the budget.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

using repro_torch::kThreads;

constexpr int kRows = 32;                 // rows of a score tile
constexpr int kWarps = kThreads / 32;

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

// Shared floats for one block; ssd/ssd.py repeats this formula.
__host__ __device__ inline size_t smem_floats(int hd, int ds, int chunk) {
  return static_cast<size_t>(kRows) * ds            // c tile, transposed
         + static_cast<size_t>(hd) * (ds + 1)       // h
         + static_cast<size_t>(chunk) * hd          // x dt
         + static_cast<size_t>(ds) * (chunk + 1)    // b, transposed
         + static_cast<size_t>(kRows) * (chunk + 1) // score tile
         + 4 * static_cast<size_t>(chunk);          // dt, cum, exp(cum), decay
}

// NC = ceil(hd / 32) and ND = ceil(ds / 32) column groups of a lane.
template <typename T, int NC, int ND>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ d_skip,
           T* __restrict__ y, float* __restrict__ h_out, int32_t seq,
           int32_t nh, int32_t hd, int32_t ng, int32_t ds, int32_t chunk) {
  extern __shared__ __align__(16) float smem[];
  const int qs = chunk + 1;                 // padded row of bT and gs
  const int hs_row = ds + 1;                // padded row of hs
  float* cT = smem;                         // [ds][kRows]
  float* hs = cT + kRows * ds;              // [hd][ds + 1]
  float* xs = hs + hd * hs_row;             // [chunk][hd], x * dt
  float* bT = xs + chunk * hd;              // [ds][chunk + 1]
  float* gs = bT + ds * qs;                 // [kRows][chunk + 1]
  float* dtv = gs + kRows * qs;             // [chunk]
  float* cum = dtv + chunk;
  float* ecum = cum + chunk;                // exp(cum)
  float* dec = ecum + chunk;                // exp(cum_last - cum)

  const int bi = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int g = h / (nh / ng);
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const float a_neg = -expf(a_log[h]);
  const float dsk = d_skip[h];

  const int64_t x_row = static_cast<int64_t>(nh) * hd;     // token strides
  const int64_t b_row = static_cast<int64_t>(ng) * ds;
  const T* xb = x + static_cast<int64_t>(bi) * seq * x_row + h * hd;
  const float* dtb = dt + static_cast<int64_t>(bi) * seq * nh + h;
  const T* bb = bm + static_cast<int64_t>(bi) * seq * b_row + g * ds;
  const T* cb = cm + static_cast<int64_t>(bi) * seq * b_row + g * ds;
  T* yb = y + static_cast<int64_t>(bi) * seq * x_row + h * hd;

  for (int i = tid; i < hd * hs_row; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    const int len = min(chunk, seq - t0);
    __syncthreads();                        // the last chunk is done with xs, bT
    for (int j = tid; j < chunk; j += kThreads)
      dtv[j] = j < len ? dtb[static_cast<int64_t>(t0 + j) * nh] : 0.f;
    __syncthreads();
    for (int i = tid; i < chunk * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      xs[i] = j < len ? to_f32(xb[(t0 + j) * x_row + d]) * dtv[j] : 0.f;
    }
    for (int i = tid; i < chunk * ds; i += kThreads) {
      const int j = i % chunk, s = i / chunk;
      bT[s * qs + j] = j < len ? to_f32(bb[(t0 + j) * b_row + s]) : 0.f;
    }
    if (tid == 0) {                         // in order, like a cumsum
      float run = 0.f;
      for (int j = 0; j < chunk; ++j) {
        run += a_neg * dtv[j];
        cum[j] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < chunk; j += kThreads) {
      ecum[j] = expf(cum[j]);
      dec[j] = expf(cum[chunk - 1] - cum[j]);
    }

    // y, one tile of kRows rows at a time, from the state entering the chunk
    for (int r0 = 0; r0 < len; r0 += kRows) {
      __syncthreads();                      // cT and ecum are free / ready
      for (int i = tid; i < kRows * ds; i += kThreads) {
        const int r = i % kRows, s = i / kRows;
        cT[s * kRows + r] =
            r0 + r < len ? to_f32(cb[(t0 + r0 + r) * b_row + s]) : 0.f;
      }
      __syncthreads();
      const int n_k = r0 / 32 + 1;          // column groups up to the diagonal
      float gacc[4][4], inter[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) gacc[r][k] = 0.f;
#pragma unroll
        for (int m = 0; m < NC; ++m) inter[r][m] = 0.f;
      }
      for (int s = 0; s < ds; ++s) {
        const float4 c4 = *reinterpret_cast<const float4*>(&cT[s * kRows + 4 * w]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < n_k) {
            const float bv = bT[s * qs + lane + 32 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r) gacc[r][k] = fmaf(cv[r], bv, gacc[r][k]);
          }
        }
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int d = lane + 32 * m;
          if (d < hd) {
            const float hv = hs[d * hs_row + s];
#pragma unroll
            for (int r = 0; r < 4; ++r) inter[r][m] = fmaf(cv[r], hv, inter[r][m]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 4 * w + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = lane + 32 * k;
          if (k < n_k)
            gs[(4 * w + r) * qs + j] =
                j <= i ? gacc[r][k] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
      __syncwarp();                         // a warp reads only its own rows
      const int n_j = min(len, r0 + kRows);
      float yv[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < NC; ++m) yv[r][m] = 0.f;
      for (int j = 0; j < n_j; ++j) {
        float gv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = gs[(4 * w + r) * qs + j];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int d = lane + 32 * m;
          if (d < hd) {
            const float xv = xs[j * hd + d];
#pragma unroll
            for (int r = 0; r < 4; ++r) yv[r][m] = fmaf(gv[r], xv, yv[r][m]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r0 + 4 * w + r;
        if (i >= len) continue;
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int d = lane + 32 * m;
          if (d < hd) {
            const int64_t at = (t0 + i) * x_row + d;
            const float v = yv[r][m] + ecum[i] * inter[r][m];
            yb[at] = from_f32<T>(v + dsk * to_f32(xb[at]));
          }
        }
      }
    }
    __syncthreads();                        // every tile has read hs

    // advance the state: thread (w, lane) owns h[d][s] for d = d0 + 4 w + r,
    // s = lane + 32 k
    const float e_last = ecum[chunk - 1];
    for (int d0 = 0; d0 < hd; d0 += 4 * kWarps) {
      float acc[4][ND];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < ND; ++k) acc[r][k] = 0.f;
      for (int j = 0; j < len; ++j) {
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int d = d0 + 4 * w + r;
          xv[r] = d < hd ? xs[j * hd + d] * dec[j] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          const int s = lane + 32 * k;
          if (s < ds) {
            const float bv = bT[s * qs + j];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(xv[r], bv, acc[r][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = d0 + 4 * w + r;
        if (d >= hd) continue;
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          const int s = lane + 32 * k;
          if (s < ds) hs[d * hs_row + s] = hs[d * hs_row + s] * e_last + acc[r][k];
        }
      }
    }
  }
  __syncthreads();
  float* hb = h_out + static_cast<int64_t>(blockIdx.x) * hd * ds;
  for (int i = tid; i < hd * ds; i += kThreads)
    hb[i] = hs[(i / ds) * hs_row + i % ds];
}

template <typename T, int NC, int ND>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, void* y, void* h_out,
           int32_t bsz, int32_t seq, int32_t nh, int32_t hd, int32_t ng,
           int32_t ds, int32_t chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd, ds, chunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T, NC, ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T, NC, ND><<<static_cast<unsigned>(bsz) * nh, kThreads, smem,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<T*>(y), static_cast<float*>(h_out), seq, nh, hd, ng, ds,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

inline int groups(int n) { return n <= 32 ? 1 : n <= 64 ? 2 : 4; }

template <typename T, int NC>
int dispatch_ds(int nd, const void* x, const void* dt, const void* a_log,
                const void* b, const void* c, const void* d_skip, void* y,
                void* h_out, int32_t bsz, int32_t seq, int32_t nh, int32_t hd,
                int32_t ng, int32_t ds, int32_t chunk, cudaStream_t st) {
  switch (nd) {
    case 1: return launch<T, NC, 1>(x, dt, a_log, b, c, d_skip, y, h_out, bsz,
                                    seq, nh, hd, ng, ds, chunk, st);
    case 2: return launch<T, NC, 2>(x, dt, a_log, b, c, d_skip, y, h_out, bsz,
                                    seq, nh, hd, ng, ds, chunk, st);
    default: return launch<T, NC, 4>(x, dt, a_log, b, c, d_skip, y, h_out,
                                     bsz, seq, nh, hd, ng, ds, chunk, st);
  }
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, const void* d_skip, void* y, void* h_out,
             int32_t bsz, int32_t seq, int32_t nh, int32_t hd, int32_t ng,
             int32_t ds, int32_t chunk, cudaStream_t st) {
  const int nd = groups(ds);
  switch (groups(hd)) {
    case 1: return dispatch_ds<T, 1>(nd, x, dt, a_log, b, c, d_skip, y, h_out,
                                     bsz, seq, nh, hd, ng, ds, chunk, st);
    case 2: return dispatch_ds<T, 2>(nd, x, dt, a_log, b, c, d_skip, y, h_out,
                                     bsz, seq, nh, hd, ng, ds, chunk, st);
    default: return dispatch_ds<T, 4>(nd, x, dt, a_log, b, c, d_skip, y,
                                      h_out, bsz, seq, nh, hd, ng, ds, chunk,
                                      st);
  }
}

}  // namespace

// x (bsz, seq, nh, hd) and y like it, of float32 (bf16 == 0) or bfloat16
// (bf16 == 1); dt (bsz, seq, nh) f32; a_log, d_skip (nh,) f32; b, c
// (bsz, seq, ng, ds) of x's type; h_out (bsz, nh, hd, ds) f32; all
// contiguous.  hd, ds <= 128; chunk a multiple of 32, at most 128; nh a
// multiple of ng.  Launches on `stream`; returns cudaGetLastError().
extern "C" int ssd_fwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* d_skip,
                       void* y, void* h_out, int32_t bsz, int32_t seq,
                       int32_t nh, int32_t hd, int32_t ng, int32_t ds,
                       int32_t chunk, int32_t bf16, void* stream) {
  if (bsz <= 0 || nh <= 0) return static_cast<int>(cudaGetLastError());
  if (hd > 128 || ds > 128 || chunk > 128 || chunk % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, y, h_out,
                                        bsz, seq, nh, hd, ng, ds, chunk, st)
              : dispatch<float>(x, dt, a_log, b, c, d_skip, y, h_out, bsz,
                                seq, nh, hd, ng, ds, chunk, st);
}
