// The SSD (Mamba-2) chunk scan for Hopper (sm_90a), in the state-passing
// form of the Mamba-2 paper (arXiv:2405.21060, section 6).
//
// Replaces: ssd_pallas / _ssd_kernel in src/repro/kernels/ssd/ssd.py.
// Computes: for x (B, S, nh, hd), dt (B, S, nh) f32, b and c (B, S, ng, ds),
//   a_log and d_skip (nh,) f32 (head h reads group h / (nh / ng)), over
//   chunks k of Q tokens, with a_t = -exp(a_log) dt_t and cum the cumsum
//   of a over a chunk:
//     pass 1, chunk states (a block per batch row, chunk and head):
//       S_k = sum_j exp(cum_last - cum_j) dt_j x_j b_j^T, (hd, ds) f32,
//       and the chunk's decay exp(cum_last);
//     pass 2, state passing (a thread per 4 state entries of a head, the
//       chunks in sequence): H_0 = 0, H_{k+1} = H_k exp(cum_last_k) + S_k;
//       H_k overwrites S_k in the scratch, H_nc is the final state;
//     pass 3, chunk scan (a block per batch row, chunk and head):
//       y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) (c_i . H_k) + d_skip x_i;
//   y in x's type and the final state in f32, as the TPU kernel gives them.
// Bound: at the mamba2-780m prefill shape (B 4, S 2,000, nh 48, hd 64,
//   ng 1, ds 128, bf16, chunk 128) the function's four products are 22
//   GFLOP against 110 MB of inputs and outputs: 0.022 ms at the card's
//   bf16 tensor rate, 0.033 ms at its memory rate.  The state-passing
//   form's scratch ((B, nh, nc, hd, ds) f32, 100.7 MB: written by pass 1,
//   read and written by pass 2, read by pass 3) adds ~400 MB of traffic,
//   a floor near 0.15 ms.  PERF.md keeps the measured times.
// Design: the chunks of a head run in parallel (B nh nc blocks in passes
//   1 and 3, 3,072 at the prefill shape), where the TPU kernel carried h
//   along a sequential grid axis; only the elementwise pass 2 walks the
//   chunks in order.  A chunk's cum is a warp scan.  cp.async brings the
//   tiles of x, b and c into shared memory (an address it cannot take, a
//   bf16 row off a 4-byte mark, is copied by plain loads), and every pass
//   fits two blocks an SM.  Two routes, which ssd/ssd.py picks:
//   * tensor cores (bf16, hd and ds multiples of 16): mma.sync m16n8k16
//     bf16 -> f32 on ldmatrix'd tiles.  C.B^T is exact (bf16 operands).
//     The three products with an f32 operand (the masked, decayed scores
//     against x; x dt decay against b; C against H) split it into hi =
//     bf16(v) and lo = bf16(v - hi), two MMAs summed in f32: one rounding
//     to bf16 misses the state's 1e-4 tolerance tenfold, and TF32 keeps
//     fewer bits than the split.  Warp w of pass 3 owns rows 16 w ..
//     16 w + 15 of the chunk and walks the j tiles up to the diagonal;
//     shared rows are padded by 16 bytes, so ldmatrix reads are free of
//     bank conflicts;
//   * CUDA cores (f32, and bf16 at other widths): f32 FMAs on register
//     tiles; pass 3 takes rows in tiles of 32 and streams b, c and H
//     through shared memory in slices of 32 state columns.
//   A chunk's cum is summed and kept in f32 (the gradient's in f64:
//   ssd_common.cuh says why).
//   Every sum runs in a fixed order with no atomics, so two launches on
//   one input give the same bits.  The ragged last chunk is zero-padded
//   (dt = 0 past S adds nothing), so any S >= 1 works.
#include "ssd_common.cuh"

namespace {

using namespace repro_torch::ssd;
using repro_torch::kThreads;

constexpr int kHalf = 64;    // rows of H a tensor-core pass 3 stages at once

// ---- pass 3: chunk scan ---------------------------------------------------

inline size_t scan_cc_smem(int q, int hd, int size) {
  const size_t st = kSlice + 1;
  const size_t tiles = q * st * size + kSlice * st * size + hd * st * 4;
  const size_t scores = static_cast<size_t>(kSlice) * (q + 1) * 4;
  return cum_bytes<float>(q) + static_cast<size_t>(q) * hd * size
         + (tiles > scores ? tiles : scores);
}

inline size_t scan_tc_smem(int q, int hd, int ds) {
  const size_t sb = ds + kPad;
  const size_t c = q * sb;
  const size_t h = 2 * static_cast<size_t>(hd < kHalf ? hd : kHalf) * sb;
  return cum_bytes<float>(q)
         + 2 * (static_cast<size_t>(q) * (hd + kPad) + q * sb + (c > h ? c : h));
}

// Rows in tiles of 32: warp w owns rows 4 w .. 4 w + 3 of a tile, lane l
// the columns l + 32 m; b, c and H pass through shared memory in slices
// of 32 state columns, and the masked, decayed scores of the tile then
// take the slices' place.  NC = ceil(hd / 32).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2)
scan_cc(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a_log, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ d_skip,
        const float* __restrict__ hin, T* __restrict__ y, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int sst = kSlice + 1;
  const int sg = q + 1;
  const Cum<float> cu = cum_at<float>(smem, q);
  const float* dtv = cu.dtv;
  const float* cum = cu.cum;
  T* xs = reinterpret_cast<T*>(past_cum<float>(smem, q));  // [q][hd]
  T* bt = xs + q * hd;                                    // [q][sst]
  T* ct = bt + q * sst;                                   // [kSlice][sst]
  float* ht = reinterpret_cast<float*>(ct + kSlice * sst);  // [hd][sst]
  float* gs = reinterpret_cast<float*>(bt);               // [kSlice][sg]

  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  const bool has_h = ch.k > 0;            // H_0 = 0
  const float* hk = hin + ch.idx * hd * ds;
  const float dsk = d_skip[ch.h];
  stage(xs, hd, x + xo, x_row, ch.len, ch.len, hd);
  chunk_cum(dt, sh, ch, -expf(a_log[ch.h]), cu);

  for (int r0 = 0; r0 < ch.len; r0 += kSlice) {
    const int nk = r0 / kSlice + 1;      // column groups up to the diagonal
    float gacc[4][4], zacc[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) gacc[r][k] = 0.f;
#pragma unroll
      for (int m = 0; m < NC; ++m) zacc[r][m] = 0.f;
    }
    for (int s0 = 0; s0 < ds; s0 += kSlice) {
      const int sw = min(kSlice, ds - s0);
      __syncthreads();                   // the slices (or scores) are free
      stage(bt, sst, bm + bo + s0, b_row, kSlice * nk,
            min(ch.len, kSlice * nk), sw);
      stage(ct, sst, cm + bo + r0 * b_row + s0, b_row, kSlice,
            min(kSlice, ch.len - r0), sw);
      if (has_h) stage(ht, sst, hk + s0, ds, hd, hd, sw);
      cp_async_wait_all();
      __syncthreads();
      for (int s = 0; s < sw; ++s) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = to_f32(ct[(4 * w + r) * sst + s]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < nk) {
            const float bv = to_f32(bt[(lane + 32 * k) * sst + s]);
#pragma unroll
            for (int r = 0; r < 4; ++r) gacc[r][k] = fmaf(cv[r], bv, gacc[r][k]);
          }
        }
        if (has_h) {
#pragma unroll
          for (int m = 0; m < NC; ++m) {
            const int d = lane + 32 * m;
            if (d < hd) {
              const float hv = ht[d * sst + s];
#pragma unroll
              for (int r = 0; r < 4; ++r) zacc[r][m] = fmaf(cv[r], hv, zacc[r][m]);
            }
          }
        }
      }
    }
    __syncthreads();                     // the scores take the slices' place
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + 4 * w + r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane + 32 * k;
        if (k < nk)
          gs[(4 * w + r) * sg + j] =
              j <= i ? gacc[r][k] * exp_diff(cum[i], cum[j]) * dtv[j] : 0.f;
      }
    }
    __syncwarp();                        // a warp reads only its own rows
    const int nj = min(ch.len, r0 + kSlice);
    float yv[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < NC; ++m) yv[r][m] = 0.f;
    for (int j = 0; j < nj; ++j) {
      float gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = gs[(4 * w + r) * sg + j];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int d = lane + 32 * m;
        if (d < hd) {
          const float xv = to_f32(xs[j * hd + d]);
#pragma unroll
          for (int r = 0; r < 4; ++r) yv[r][m] = fmaf(gv[r], xv, yv[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + 4 * w + r;
      if (i >= ch.len) continue;
      const float ei = expf(static_cast<float>(cum[i]));
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int d = lane + 32 * m;
        if (d < hd) {
          const float v = yv[r][m] + ei * zacc[r][m]
                          + dsk * to_f32(xs[i * hd + d]);
          y[xo + i * x_row + d] = from_f32<T>(v);
        }
      }
    }
  }
}

// Rows h0 .. h0 + kHalf - 1 of H (hd, ds), KS float4s a thread
template <int KS>
__device__ __forceinline__ void load_half(float4 (&hreg)[KS], const float* hk,
                                          int hd, int ds, int h0) {
  const int n = min(kHalf, hd - h0) * ds;
#pragma unroll
  for (int it = 0; it < KS; ++it) {
    const int e = 4 * (threadIdx.x + kThreads * it);
    if (e < n) hreg[it] = *reinterpret_cast<const float4*>(hk + h0 * ds + e);
  }
}

// Warp w owns rows 16 w .. 16 w + 15 of the chunk, its c fragments held
// in registers: first C . H^T (H split, in halves of 64 rows that take the
// c tile's place), scaled by exp(cum_i); then, for each 16-token tile j up
// to the diagonal, the scores C . B^T, masked and decayed, split and
// multiplied with x.  NT = hd / 8 and KS = ds / 16 at most.
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads, NT <= 8 ? 2 : 1)
scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a_log, const bf16* __restrict__ bm,
        const bf16* __restrict__ cm, const float* __restrict__ d_skip,
        const float* __restrict__ hin, bf16* __restrict__ y, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds;
  const int sx = hd + kPad, sb = ds + kPad;
  const Cum<float> cu = cum_at<float>(smem, q);
  const float* dtv = cu.dtv;
  const float* cum = cu.cum;
  bf16* xs = reinterpret_cast<bf16*>(past_cum<float>(smem, q));  // [q][sx]
  bf16* bs = xs + q * sx;                        // [q][sb]
  bf16* cs = bs + q * sb;                        // [q][sb], then H:
  bf16* hh = cs;                                 // [min(hd, kHalf)][sb] hi
  bf16* hl = cs + min(hd, kHalf) * sb;           // [min(hd, kHalf)][sb] lo

  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  stage(xs, sx, x + xo, x_row, q, ch.len, hd);
  stage(bs, sb, bm + bo, b_row, q, ch.len, ds);
  stage(cs, sb, cm + bo, b_row, q, ch.len, ds);
  const bool has_h = ch.k > 0;            // H_0 = 0
  const float* hk = hin + ch.idx * hd * ds;
  const float dsk = d_skip[ch.h];
  chunk_cum(dt, sh, ch, -expf(a_log[ch.h]), cu);

  float4 hreg[KS];
  if (has_h) load_half(hreg, hk, hd, ds, 0);
  cp_async_wait_all();
  __syncthreads();

  const Lane ln = lane_of();
  const int r = threadIdx.x >> 5;
  const bool active = 16 * r < ch.len;   // rows of this warp hold tokens
  const int ks_n = ds / 16, nt_n = hd / 8;
  uint32_t cf[KS][4];
  if (active) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks < ks_n)
        ldsm_x4(cf[ks], cs + (16 * r + (ln.qq & 1) * 8 + ln.rr) * sb + 16 * ks
                            + (ln.qq >> 1) * 8);
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  if (has_h) {
#pragma unroll
    for (int half = 0; half < (NT + 7) / 8; ++half) {
      const int h0 = kHalf * half;
      if (h0 >= hd) break;
      if (half > 0) load_half(hreg, hk, hd, ds, h0);
      __syncthreads();                   // c (or the last half) is consumed
      const int n = min(kHalf, hd - h0) * ds;
#pragma unroll
      for (int it = 0; it < KS; ++it) {
        const int e = 4 * (threadIdx.x + kThreads * it);
        if (e < n) {
          const int d = e / ds, s = e % ds;
          uint2 hi, lo;
          split2(hreg[it].x, hreg[it].y, hi.x, lo.x);
          split2(hreg[it].z, hreg[it].w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(hh + d * sb + s) = hi;
          *reinterpret_cast<uint2*>(hl + d * sb + s) = lo;
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int n0 = 8 * half + 2 * np;   // n-tiles n0, n0 + 1 of acc
          if (n0 >= NT || n0 >= nt_n) continue;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            if (ks >= ks_n) continue;
            // B (s, d) from H stored [d][s]
            const int off = (16 * np + (ln.qq >> 1) * 8 + ln.rr) * sb + 16 * ks
                            + (ln.qq & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, hh + off);
            ldsm_x4(bl, hl + off);
            mma(acc[n0], cf[ks], bh[0], bh[1]);
            mma(acc[n0], cf[ks], bl[0], bl[1]);
            mma(acc[n0 + 1], cf[ks], bh[2], bh[3]);
            mma(acc[n0 + 1], cf[ks], bl[2], bl[3]);
          }
        }
      }
    }
  }
  if (!active) return;                   // no barrier follows

  const int ia = 16 * r + ln.g, ib = ia + 8;
  const float ca = cum[ia], cb = cum[ib];
  if (has_h) {
    const float ea = expf(ca), eb = expf(cb);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
  }
  for (int jt = 0; jt <= r; ++jt) {
    float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ks_n) continue;
      // B (s, j) from b stored [j][s]
      uint32_t bb[4];
      ldsm_x4(bb, bs + (16 * jt + (ln.qq >> 1) * 8 + ln.rr) * sb + 16 * ks
                      + (ln.qq & 1) * 8);
      mma(g0, cf[ks], bb[0], bb[1]);
      mma(g1, cf[ks], bb[2], bb[3]);
    }
    // the scores at rows ia, ib and columns j, j + 1 (g0), j + 8, j + 9 (g1)
    const int j = 16 * jt + 2 * ln.t;
    auto p = [&](float gv, float ci, int i, int jj) {
      return jj <= i ? gv * exp_diff(ci, cum[jj]) * dtv[jj] : 0.f;
    };
    uint32_t ah[4], al[4];
    split2(p(g0[0], ca, ia, j), p(g0[1], ca, ia, j + 1), ah[0], al[0]);
    split2(p(g0[2], cb, ib, j), p(g0[3], cb, ib, j + 1), ah[1], al[1]);
    split2(p(g1[0], ca, ia, j + 8), p(g1[1], ca, ia, j + 9), ah[2], al[2]);
    split2(p(g1[2], cb, ib, j + 8), p(g1[3], cb, ib, j + 9), ah[3], al[3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np >= nt_n) continue;
      // B (j, d) from x stored [j][d]
      uint32_t bx[4];
      ldsm_x4_t(bx, xs + (16 * jt + (ln.qq & 1) * 8 + ln.rr) * sx + 16 * np
                        + (ln.qq >> 1) * 8);
      mma(acc[2 * np], ah, bx[0], bx[1]);
      mma(acc[2 * np], al, bx[0], bx[1]);
      mma(acc[2 * np + 1], ah, bx[2], bx[3]);
      mma(acc[2 * np + 1], al, bx[2], bx[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n >= nt_n) continue;
    const int d = 8 * n + 2 * ln.t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? ib : ia;
      if (i >= ch.len) continue;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + i * sx + d));
      *reinterpret_cast<__nv_bfloat162*>(y + xo + i * x_row + d) =
          __floats2bfloat162_rn(acc[n][2 * half] + dsk * xv.x,
                                acc[n][2 * half + 1] + dsk * xv.y);
    }
  }
}
// ---- plans and launches ---------------------------------------------------

struct Plan {
  Pass pass[3];
};

template <typename T>
const void* scan_cc_fn(int hd) {
  switch (groups(hd)) {
    case 1: return reinterpret_cast<const void*>(&scan_cc<T, 1>);
    case 2: return reinterpret_cast<const void*>(&scan_cc<T, 2>);
    default: return reinterpret_cast<const void*>(&scan_cc<T, 4>);
  }
}

Pass scan_pass(int mode, int q, int hd, int ds) {
  if (mode == kTensorCores) {
    const bool wide_d = hd > 64, wide_s = ds > 64;
    return Pass{
        wide_d ? (wide_s ? reinterpret_cast<const void*>(&scan_tc<16, 8>)
                         : reinterpret_cast<const void*>(&scan_tc<16, 4>))
               : (wide_s ? reinterpret_cast<const void*>(&scan_tc<8, 8>)
                         : reinterpret_cast<const void*>(&scan_tc<8, 4>)),
        scan_tc_smem(q, hd, ds)};
  }
  return mode == kBf16 ? Pass{scan_cc_fn<bf16>(hd), scan_cc_smem(q, hd, 2)}
                       : Pass{scan_cc_fn<float>(hd), scan_cc_smem(q, hd, 4)};
}

Plan plan(int mode, int q, int hd, int ds) {
  Plan p;
  p.pass[0] = states_pass<false, void>(mode, q, hd, ds);
  p.pass[1] = state_pass_pass<void>(hd, ds);
  p.pass[2] = scan_pass(mode, q, hd, ds);
  return p;
}

}  // namespace

// x (bsz, seq, nh, hd) and y like it; dt (bsz, seq, nh) f32; a_log,
// d_skip (nh,) f32; b, c (bsz, seq, ng, ds) of x's type; h_out (bsz, nh,
// hd, ds) f32; the scratch: states (bsz, nh, nc, hd, ds) f32 and decay
// (bsz, nh, nc) f32, nc = ceil(seq / chunk); all contiguous.  mode 0: f32
// on the CUDA cores, 1: bf16 on the CUDA cores, 2: bf16 on the tensor
// cores (hd, ds multiples of 16).  hd, ds <= 128; chunk a multiple of 32,
// at most 128; nh a multiple of ng.  `passes` is a mask of the passes to
// launch (1: chunk states into the scratch, 2: state passing in place and
// h_out, 4: chunk scan from the scratch into y; 7 is the whole scan), in
// that order on `stream`.  Returns the first CUDA error, else
// cudaGetLastError().
extern "C" int ssd_fwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* d_skip,
                       void* y, void* h_out, void* states, void* decay,
                       int32_t bsz, int32_t seq, int32_t nh, int32_t hd,
                       int32_t ng, int32_t ds, int32_t chunk, int32_t mode,
                       int32_t passes, void* stream) {
  if (!valid(mode, hd, ds, chunk) || ng <= 0 || nh % ng || seq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz <= 0 || nh <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape sh{bsz, seq, nh, hd, ng, ds, chunk, (seq + chunk - 1) / chunk};
  const Plan p = plan(mode, chunk, hd, ds);
  const unsigned blocks = static_cast<unsigned>(bsz) * nh * sh.nc;
  cudaError_t err = cudaSuccess;
  if ((passes & 1) && sh.nc > 0) {
    void* args[] = {&x, &dt, &a_log, &b, &states, &decay, &sh};
    err = launch(p.pass[0], blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    int32_t n = hd * ds, tiles = state_tiles(n);
    void* args[] = {&states, &decay, &h_out, &sh.nc, &n, &tiles};
    err = launch(p.pass[1], static_cast<unsigned>(bsz) * nh * tiles, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((passes & 4) && sh.nc > 0) {
    void* args[] = {&x, &dt, &a_log, &b, &c, &d_skip, &states, &y, &sh};
    err = launch(p.pass[2], blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// For each pass at (mode, hd, ds, chunk): the blocks of kThreads threads
// that fit on one SM (registers and shared memory, from the occupancy
// calculator) into blocks[0..2], and the shared bytes a block takes into
// smem[0..2].
extern "C" int ssd_occupancy(int32_t mode, int32_t hd, int32_t ds,
                             int32_t chunk, int32_t* blocks, int32_t* smem) {
  if (!valid(mode, hd, ds, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(mode, chunk, hd, ds);
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = allow_smem(p.pass[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[i], p.pass[i].fn, kThreads, p.pass[i].smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem[i] = static_cast<int32_t>(p.pass[i].smem);
  }
  return 0;
}
