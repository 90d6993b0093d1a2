// The gradient of the SSD (Mamba-2) chunk scan for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The reference trains Mamba-2 through
//   ssd_chunked (src/repro/models/mamba.py:70), which XLA differentiates;
//   this is that gradient for the port's forward (ssd.cu, which replaces
//   ssd_pallas, src/repro/kernels/ssd/ssd.py:71), so that a training step
//   on the card runs no plain version.
// Computes: the gradients of ssd.cu's (y, final state) at (x, dt, a_log,
//   b, c, d_skip) against gy and gh (gh may be null: zero).  With the
//   forward's notation (a_t = -exp(a_log) dt_t, cum its cumsum over a chunk
//   of Q tokens, L = cum_last, H_k the state entering chunk k), over five
//   passes:
//     1. states: H_k rebuilt by the forward's passes 1 and 2 into the
//        scratch (no (B, nh, nc, hd, ds) tensor is kept from the forward);
//     2. out states: R_k = sum_i exp(cum_i) gy_i c_i^T, what chunk k's y
//        sends back to H_k (the forward's pass 1 with gy, c and exp(cum)
//        for x, b and the decay weight);
//     3. state pass, the chunks in reverse, elementwise and in place: G =
//        gh, then dS_k = G and G <- R_k + exp(L_k) G; dS_k over R_k;
//     4. chunk pass (a block per batch row, chunk and head): with E_ij =
//        exp(cum_i - cum_j) (j <= i), e_i = exp(cum_i), w_j = dt_j
//        exp(L - cum_j), M_ij = (c_i . b_j) E_ij dt_j, W_ij = (gy_i . x_j)
//        E_ij dt_j and F_ij = (c_i . b_j) W_ij:
//          dx_j = sum_i M_ij gy_i + d_skip gy_j + w_j dS b_j,
//          db_j = sum_i W_ij c_i + w_j dS^T x_j (a share per head),
//          dc_i = sum_j W_ij b_j + e_i H^T gy_i (a share per head),
//          d(cum)_t = sum_j F_tj - sum_i F_it + e_t v_t - w_t u_t, with
//          v_t = gy_t . H c_t and u_t = x_t . dS b_t, and dL = sum_j w_j
//          u_j + exp(L) <dS, H>, carried to each token's a by a reverse
//          cumsum: da_t; ddt_t = sum_i F_it / dt_t + exp(L - cum_t) u_t -
//          exp(a_log) da_t; the chunk's share of da_log = sum_t a_t da_t,
//          summed term by term as sum_{j <= i} F_ij (cum_i - cum_j) + sum_t
//          e_t v_t cum_t + sum_j w_j u_j (L - cum_j) + L exp(L) <dS, H>
//          (the reverse cumsum's form takes differences of sums some
//          thousand times larger under strong decays, which loses a_log's
//          gradient to f32 rounding); and of dd_skip = sum gy . x;
//     5. reduce: db and dc summed over the heads of a group, da_log and
//        dd_skip over the blocks, in a fixed order.
// Bound: at mamba2-780m's training shape (x 4 x 4,096 x 48 x 64 bf16, b
//   and c 4 x 4,096 x 1 x 128, chunk 128, gh absent) the function reads x,
//   gy, dt, b, c once and writes dx, ddt, db, dc once: 325.1 MB, 0.0970 ms
//   at 3.35 TB/s; its products (ssd_flops(backward=True), twice the
//   forward's) are 90.5 GFLOP, 0.0915 ms at 989 TFLOP/s: bound by bytes.
//   The passes move far more: two (B, nh, nc, hd, ds) f32 scratches (H_k
//   and R_k / dS_k, 100.7 MB each, each written and read twice or more),
//   and db's and dc's per-head f32 shares (402.7 MB each, written once and
//   read once).  A block that walked a group's heads and kept one share
//   for them measured slower at every number of heads tried (PERF.md).
//   PERF.md keeps the measured times.
// Design: every pass but 3 and 5 runs the chunks of a head in parallel.
//   The chunk pass is register-resident on the tensor-core route (bf16,
//   hd and ds multiples of 16): x, gy, b and c of the chunk and one f32
//   (hd, ds) state split into bf16 hi and lo sit in shared memory (one
//   block an SM); warp w owns tokens 16 w .. 16 w + 15, first as rows i
//   (dc, sum_j F_ij: C B^T and GY X^T recomputed a 16 x 16 tile at a
//   time up to the diagonal, W split into hi / lo A fragments and
//   multiplied with b), then as rows j (dx, then db: B C^T and X GY^T from
//   the diagonal on, M^T and W^T multiplied with gy and c), with H in the
//   shared tiles for the first and dS for the second.  mma.sync m16n8k16
//   bf16 -> f32 on ldmatrix'd tiles; bf16 operands are exact, an f32
//   operand (H, dS, M, W) is split into hi = bf16(v) and lo = bf16(v -
//   hi), two products summed in f32, as the forward does.  The CUDA-core
//   route (f32, bf16 at other widths) keeps C B^T (then M) and GY X^T
//   (then W) as f32 Q x Q tiles in shared memory and runs every product as
//   a register-tiled FMA product over k-slices staged in shared memory.
//   cum is f64 (ssd_common.cuh).  No atomics: every sum has a fixed order,
//   so two calls give the same bits.  No TMA: nothing here encodes a
//   tensor map, so no thread needs the driver's context bound first.
#include "ssd_common.cuh"

// Every kernel of the backward is named in this namespace (the shared
// passes' instances through their Tag), so a profile sums them by name.
namespace ssd_grad {

using namespace repro_torch::ssd;
using repro_torch::kThreads;

// Names the backward's instances of the shared passes, and keeps their cum
// in f64.
struct Tag {
  using cum = double;
};

constexpr unsigned kFull = 0xffffffffu;

// ---- per-token scratch of the chunk pass ----------------------------------

// After the cum head: exp(cum), w, sum_j F_tj, sum_i T_it (T = F / dt),
// u, v (q floats each), then 32 floats for block sums.
struct Tok {
  float *ev, *wv, *rowf, *colt, *uu, *vv, *red;
};

__host__ __device__ inline size_t tok_bytes(int q) {
  return 4 * (6 * static_cast<size_t>(q) + 32);
}

__device__ __forceinline__ Tok tok_at(char* p, int q) {
  Tok t;
  t.ev = reinterpret_cast<float*>(p);
  t.wv = t.ev + q;
  t.rowf = t.wv + q;
  t.colt = t.rowf + q;
  t.uu = t.colt + q;
  t.vv = t.uu + q;
  t.red = t.vv + q;
  return t;
}

// exp(cum) and w of each token; the sums zeroed.
__device__ __forceinline__ void chunk_tokens(const Cum<double>& cm,
                                             const Tok& tk, int q) {
  const double last = cm.cum[q - 1];
  for (int t = threadIdx.x; t < q; t += kThreads) {
    tk.ev[t] = expf(static_cast<float>(cm.cum[t]));
    tk.wv[t] = cm.dtv[t] * exp_diff(last, cm.cum[t]);
    tk.rowf[t] = tk.colt[t] = tk.uu[t] = tk.vv[t] = 0.f;
  }
  __syncthreads();
}

// The sum of v over the block in a fixed order, in every thread; every
// thread calls it.  red: kThreads / 32 floats.
__device__ __forceinline__ float block_total(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  __syncthreads();
  return t;
}

// The sum over the 4 lanes of a quad (the columns of a fragment row);
// commutative pairs, so every lane of the quad holds the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The chunk's tail, from the per-token sums: d(cum), its reverse cumsum
// plus dL, ddt, and the chunk's shares of da_log (`pair`: this thread's
// share of sum F_ij (cum_i - cum_j)) and of dd_skip (`dd`); `dsh`: this
// thread's share of <dS, H>.  Every thread calls it.
__device__ __forceinline__ void chunk_finish(
    const Cum<double>& cm, const Tok& tk, const Chunk& ch, const Shape& sh,
    float a_neg, float pair, float dsh, float dd, float* __restrict__ ddt,
    float* __restrict__ dalog_part, float* __restrict__ dd_part) {
  const int q = sh.q, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool tok = t < ch.len;
  dd = block_total(dd, tk.red);
  dsh = block_total(dsh, tk.red);
  const float wu = tok ? tk.wv[t] * tk.uu[t] : 0.f;
  const float wu_all = block_total(wu, tk.red);
  const double last = cm.cum[q - 1];
  const float e_last = expf(static_cast<float>(last));
  // d(cum), then its reverse inclusive cumsum over the chunk: a warp scan
  // of each 32 tokens, then the totals of the warps after
  float v = tok ? tk.rowf[t] - cm.dtv[t] * tk.colt[t] + tk.ev[t] * tk.vv[t]
                      - wu
                : 0.f;
  if (t < q) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(kFull, v, off);
      if (lane + off < 32) v += u;
    }
    if (lane == 0) tk.red[8 + w] = v;
  }
  __syncthreads();
  if (tok) {
    for (int i = w + 1; i < q / 32; ++i) v += tk.red[8 + i];
    const float da = v + wu_all + e_last * dsh;
    ddt[(static_cast<int64_t>(ch.bi) * sh.seq + ch.t0 + t) * sh.nh + ch.h] =
        tk.colt[t] + exp_diff(last, cm.cum[t]) * tk.uu[t] + a_neg * da;
    const double ct = cm.cum[t];
    pair += tk.ev[t] * tk.vv[t] * static_cast<float>(ct)
            + wu * static_cast<float>(last - ct);
  }
  __syncthreads();
  pair = block_total(pair, tk.red);
  if (t == 0) {
    dalog_part[ch.idx] = pair + static_cast<float>(last) * e_last * dsh;
    dd_part[ch.idx] = dd;
  }
}

// ---- chunk pass, tensor cores ---------------------------------------------

// Shared: the cum head, the per-token scratch, x and gy ([q][hd + kPad]),
// b and c ([q][ds + kPad]), an f32 state split into hi and lo ([hd][ds +
// kPad] each), bf16.
inline size_t chunk_tc_smem(int q, int hd, int ds) {
  const size_t sx = hd + kPad, sb = ds + kPad;
  return cum_bytes<double>(q) + tok_bytes(q)
         + 2 * (2 * q * sx + 2 * q * sb + 2 * static_cast<size_t>(hd) * sb);
}

// An f32 (hd, ds) state into bf16 hi and lo tiles [hd][sb]; returns this
// thread's share of <st, other> (0 where other is null).
__device__ __forceinline__ float split_state(const float* __restrict__ st,
                                             const float* __restrict__ other,
                                             bf16* hi, bf16* lo, int hd,
                                             int ds, int sb) {
  float dot = 0.f;
  for (int e = 4 * threadIdx.x; e < hd * ds; e += 4 * kThreads) {
    const float4 v = *reinterpret_cast<const float4*>(st + e);
    if (other != nullptr) {
      const float4 o = *reinterpret_cast<const float4*>(other + e);
      dot = fmaf(v.x, o.x, fmaf(v.y, o.y, fmaf(v.z, o.z, fmaf(v.w, o.w, dot))));
    }
    const int d = e / ds, s = e % ds;
    uint2 h, l;
    split2(v.x, v.y, h.x, l.x);
    split2(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + d * sb + s) = h;
    *reinterpret_cast<uint2*>(lo + d * sb + s) = l;
  }
  return dot;
}

// acc (16 x 8 n-tiles, n < 2 nn_n) += A (16 x 16 k-tiles held as
// fragments af[k], k < kk_n) . B, B (k, n) read from a tile stored [k][n]
// (trans = true, row stride `stride`, split into hi / lo where lo is not
// null) or [n][k] (trans = false).  k-tile kt of B starts at row 16 kt (or
// column); nn_n n-pairs of 16 columns.
template <int NA, int NK>
__device__ __forceinline__ void mma_rows(float (&acc)[NA][4],
                                         const uint32_t (&af)[NK][4],
                                         int kk_n, const bf16* hi,
                                         const bf16* lo, int stride,
                                         int nn_n, bool trans,
                                         const Lane& ln) {
#pragma unroll
  for (int kt = 0; kt < NK; ++kt) {
    if (kt >= kk_n) continue;
#pragma unroll
    for (int np = 0; np < NA / 2; ++np) {
      if (np >= nn_n) continue;
      const int off = trans ? (16 * kt + (ln.qq & 1) * 8 + ln.rr) * stride
                                  + 16 * np + (ln.qq >> 1) * 8
                            : (16 * np + (ln.qq >> 1) * 8 + ln.rr) * stride
                                  + 16 * kt + (ln.qq & 1) * 8;
      uint32_t bh[4];
      if (trans) ldsm_x4_t(bh, hi + off); else ldsm_x4(bh, hi + off);
      mma(acc[2 * np], af[kt], bh[0], bh[1]);
      mma(acc[2 * np + 1], af[kt], bh[2], bh[3]);
      if (lo != nullptr) {
        uint32_t bl[4];
        if (trans) ldsm_x4_t(bl, lo + off); else ldsm_x4(bl, lo + off);
        mma(acc[2 * np], af[kt], bl[0], bl[1]);
        mma(acc[2 * np + 1], af[kt], bl[2], bl[3]);
      }
    }
  }
}

// A 16 x 16 tile (two n-tiles g0, g1) of rows R (fragments af, k < kk_n)
// times the 16 rows of a tile stored [row][k] starting at row r0: the
// product R . T^T.
template <int NK>
__device__ __forceinline__ void mma_tile(float (&g0)[4], float (&g1)[4],
                                         const uint32_t (&af)[NK][4],
                                         int kk_n, const bf16* t, int stride,
                                         int r0, const Lane& ln) {
#pragma unroll
  for (int i = 0; i < 4; ++i) g0[i] = g1[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NK; ++kt) {
    if (kt >= kk_n) continue;
    uint32_t bb[4];
    ldsm_x4(bb, t + (r0 + (ln.qq >> 1) * 8 + ln.rr) * stride + 16 * kt
                    + (ln.qq & 1) * 8);
    mma(g0, af[kt], bb[0], bb[1]);
    mma(g1, af[kt], bb[2], bb[3]);
  }
}

// The A fragments (rows 16 r .. 16 r + 15, k < kk_n) of a tile stored
// [row][k].
template <int NK>
__device__ __forceinline__ void load_rows(uint32_t (&af)[NK][4], const bf16* t,
                                          int stride, int r, int kk_n,
                                          const Lane& ln) {
#pragma unroll
  for (int kt = 0; kt < NK; ++kt)
    if (kt < kk_n)
      ldsm_x4(af[kt], t + (16 * r + (ln.qq & 1) * 8 + ln.rr) * stride
                          + 16 * kt + (ln.qq >> 1) * 8);
}

// The 16 x 16 f32 tile (g0: columns c0, c0 + 1, g1: c0 + 8, c0 + 9 of rows
// ra and ra + 8) split into hi and lo A fragments.
__device__ __forceinline__ void split_frag(const float (&v)[8], uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  split2(v[0], v[1], ah[0], al[0]);
  split2(v[2], v[3], ah[1], al[1]);
  split2(v[4], v[5], ah[2], al[2]);
  split2(v[6], v[7], ah[3], al[3]);
}

// NP = hd / 8 and NS = ds / 8 at most (8 or 16 each).
template <int NP, int NS>
__global__ void __launch_bounds__(kThreads, 1)
chunk_bwd_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_log, const bf16* __restrict__ bm,
             const bf16* __restrict__ cmat, const float* __restrict__ d_skip,
             const bf16* __restrict__ gy, const float* __restrict__ hin,
             const float* __restrict__ dst, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ dalog_part,
             float* __restrict__ dd_part, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds;
  const int sx = hd + kPad, sb = ds + kPad;
  const Cum<double> cm = cum_at<double>(smem, q);
  const Tok tk = tok_at(past_cum<double>(smem, q), q);
  bf16* xs =
      reinterpret_cast<bf16*>(past_cum<double>(smem, q) + tok_bytes(q));
  bf16* gs = xs + q * sx;
  bf16* bs = gs + q * sx;
  bf16* cs = bs + q * sb;
  bf16* sth = cs + q * sb;
  bf16* stl = sth + hd * sb;

  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  stage(xs, sx, x + xo, x_row, q, ch.len, hd);
  stage(gs, sx, gy + xo, x_row, q, ch.len, hd);
  stage(bs, sb, bm + bo, b_row, q, ch.len, ds);
  stage(cs, sb, cmat + bo, b_row, q, ch.len, ds);
  const float a_neg = -expf(a_log[ch.h]);
  chunk_cum(dt, sh, ch, a_neg, cm);
  chunk_tokens(cm, tk, q);
  const bool has_h = ch.k > 0;            // H_0 = 0
  const float* hk = hin + ch.idx * hd * ds;
  const float* sk = dst + ch.idx * hd * ds;
  if (has_h) split_state(hk, nullptr, sth, stl, hd, ds, sb);
  cp_async_wait_all();
  __syncthreads();

  const Lane ln = lane_of();
  const int r = threadIdx.x >> 5;
  const int ntl = (ch.len + 15) / 16;     // 16-token tiles that hold tokens
  const bool active = r < ntl;
  const int ks_n = ds / 16, kp_n = hd / 16;
  const int ia = 16 * r + ln.g, ib = ia + 8;
  const double ca = active ? cm.cum[ia] : 0.0, cb = active ? cm.cum[ib] : 0.0;
  float pair = 0.f;                       // sum F_ij (cum_i - cum_j), a share

  // rows i: dc = W b + e (gy H), sum_j F_ij, v
  if (active) {
    uint32_t cf[NS / 2][4], gf[NP / 2][4];
    load_rows(cf, cs, sb, r, ks_n, ln);
    load_rows(gf, gs, sx, r, kp_n, ln);
    float acc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    if (has_h) {
      // gy H: B (p, s) from H stored [p][s]
      mma_rows(acc, gf, kp_n, sth, stl, sb, ks_n, true, ln);
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n >= ds / 8) continue;
        const int s = 8 * n + 2 * ln.t;
        const float2 c2a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cs + ia * sb + s));
        const float2 c2b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cs + ib * sb + s));
        va = fmaf(acc[n][0], c2a.x, fmaf(acc[n][1], c2a.y, va));
        vb = fmaf(acc[n][2], c2b.x, fmaf(acc[n][3], c2b.y, vb));
      }
      va = quad_sum(va);
      vb = quad_sum(vb);
      if (ln.t == 0) {
        tk.vv[ia] = va;
        tk.vv[ib] = vb;
      }
      const float ea = tk.ev[ia], eb = tk.ev[ib];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }
    }
    float rfa = 0.f, rfb = 0.f;
    for (int jt = 0; jt <= r; ++jt) {
      float g0[4], g1[4], z0[4], z1[4];
      mma_tile(g0, g1, cf, ks_n, bs, sb, 16 * jt, ln);   // C B^T
      mma_tile(z0, z1, gf, kp_n, xs, sx, 16 * jt, ln);   // GY X^T
      const int j = 16 * jt + 2 * ln.t;
      // W = gy.x E dt_j; F = (c.b) W
      auto wf = [&](float cbv, float gxv, int i, double ci, int jj,
                    float& rf) -> float {
        if (jj > i) return 0.f;
        const double sg = ci - cm.cum[jj];
        const float wv = gxv * expf(static_cast<float>(sg)) * cm.dtv[jj];
        const float fv = cbv * wv;
        rf += fv;
        pair = fmaf(fv, static_cast<float>(sg), pair);
        return wv;
      };
      const float wq[8] = {wf(g0[0], z0[0], ia, ca, j, rfa),
                           wf(g0[1], z0[1], ia, ca, j + 1, rfa),
                           wf(g0[2], z0[2], ib, cb, j, rfb),
                           wf(g0[3], z0[3], ib, cb, j + 1, rfb),
                           wf(g1[0], z1[0], ia, ca, j + 8, rfa),
                           wf(g1[1], z1[1], ia, ca, j + 9, rfa),
                           wf(g1[2], z1[2], ib, cb, j + 8, rfb),
                           wf(g1[3], z1[3], ib, cb, j + 9, rfb)};
      uint32_t af[2][1][4];
      split_frag(wq, af[0][0], af[1][0]);
      // W b: B (j, s) from b stored [j][s], the k-tile at row 16 jt
      mma_rows(acc, af[0], 1, bs + 16 * jt * sb, nullptr, sb, ks_n, true, ln);
      mma_rows(acc, af[1], 1, bs + 16 * jt * sb, nullptr, sb, ks_n, true, ln);
    }
    rfa = quad_sum(rfa);
    rfb = quad_sum(rfb);
    if (ln.t == 0) {
      tk.rowf[ia] = rfa;
      tk.rowf[ib] = rfb;
    }
    float* dco = dc_part + ((static_cast<int64_t>(ch.bi) * sh.seq + ch.t0)
                                * sh.nh + ch.h) * ds;
    const int64_t drow = static_cast<int64_t>(sh.nh) * ds;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if (n >= ds / 8) continue;
      const int s = 8 * n + 2 * ln.t;
      if (ia < ch.len)
        *reinterpret_cast<float2*>(dco + ia * drow + s) =
            make_float2(acc[n][0], acc[n][1]);
      if (ib < ch.len)
        *reinterpret_cast<float2*>(dco + ib * drow + s) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();                        // H's tiles are consumed
  const float dsh = split_state(sk, has_h ? hk : nullptr, sth, stl, hd, ds, sb);
  __syncthreads();

  // rows j, first: dx = M^T gy + d_skip gy + w (b dS^T), sum_i T_ij, u
  if (active) {
    uint32_t bf[NS / 2][4], xf[NP / 2][4];
    load_rows(bf, bs, sb, r, ks_n, ln);
    load_rows(xf, xs, sx, r, kp_n, ln);
    float acc[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    // b dS^T: B (s, p) from dS stored [p][s]
    mma_rows(acc, bf, ks_n, sth, stl, sb, kp_n, false, ln);
    float ua = 0.f, ub = 0.f;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n >= hd / 8) continue;
      const int p = 8 * n + 2 * ln.t;
      const float2 xa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + ia * sx + p));
      const float2 xb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + ib * sx + p));
      ua = fmaf(acc[n][0], xa.x, fmaf(acc[n][1], xa.y, ua));
      ub = fmaf(acc[n][2], xb.x, fmaf(acc[n][3], xb.y, ub));
    }
    ua = quad_sum(ua);
    ub = quad_sum(ub);
    if (ln.t == 0) {
      tk.uu[ia] = ua;
      tk.uu[ib] = ub;
    }
    const float wa = tk.wv[ia], wb = tk.wv[ib];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      acc[n][0] *= wa;
      acc[n][1] *= wa;
      acc[n][2] *= wb;
      acc[n][3] *= wb;
    }
    const float dta = cm.dtv[ia], dtb = cm.dtv[ib];
    float cta = 0.f, ctb = 0.f;
    for (int it = r; it < ntl; ++it) {
      float g0[4], g1[4], z0[4], z1[4];
      mma_tile(g0, g1, bf, ks_n, cs, sb, 16 * it, ln);   // B C^T
      mma_tile(z0, z1, xf, kp_n, gs, sx, 16 * it, ln);   // X GY^T
      const int i = 16 * it + 2 * ln.t;
      // M^T_ji = (b.c) E dt_j; T = (b.c) E (x.gy)
      auto mt = [&](float bcv, float xgv, int jr, double cj, float dtj,
                    int ii, float& ct) -> float {
        if (ii < jr) return 0.f;
        const float e = exp_diff(cm.cum[ii], cj);
        ct = fmaf(bcv * e, xgv, ct);
        return bcv * e * dtj;
      };
      const float mq[8] = {mt(g0[0], z0[0], ia, ca, dta, i, cta),
                           mt(g0[1], z0[1], ia, ca, dta, i + 1, cta),
                           mt(g0[2], z0[2], ib, cb, dtb, i, ctb),
                           mt(g0[3], z0[3], ib, cb, dtb, i + 1, ctb),
                           mt(g1[0], z1[0], ia, ca, dta, i + 8, cta),
                           mt(g1[1], z1[1], ia, ca, dta, i + 9, cta),
                           mt(g1[2], z1[2], ib, cb, dtb, i + 8, ctb),
                           mt(g1[3], z1[3], ib, cb, dtb, i + 9, ctb)};
      uint32_t af[2][1][4];
      split_frag(mq, af[0][0], af[1][0]);
      // M^T gy: B (i, p) from gy stored [i][p], the k-tile at row 16 it
      mma_rows(acc, af[0], 1, gs + 16 * it * sx, nullptr, sx, kp_n, true, ln);
      mma_rows(acc, af[1], 1, gs + 16 * it * sx, nullptr, sx, kp_n, true, ln);
    }
    cta = quad_sum(cta);
    ctb = quad_sum(ctb);
    if (ln.t == 0) {
      tk.colt[ia] = cta;
      tk.colt[ib] = ctb;
    }
    const float dsk = d_skip[ch.h];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n >= hd / 8) continue;
      const int p = 8 * n + 2 * ln.t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half ? ib : ia;
        if (j >= ch.len) continue;
        const float2 g2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gs + j * sx + p));
        *reinterpret_cast<__nv_bfloat162*>(dx + xo + j * x_row + p) =
            __floats2bfloat162_rn(fmaf(dsk, g2.x, acc[n][2 * half]),
                                  fmaf(dsk, g2.y, acc[n][2 * half + 1]));
      }
    }
  }

  // rows j, then: db = W^T c + w (x dS)
  if (active) {
    uint32_t xf[NP / 2][4];
    load_rows(xf, xs, sx, r, kp_n, ln);
    float acc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    // x dS: B (p, s) from dS stored [p][s]
    mma_rows(acc, xf, kp_n, sth, stl, sb, ks_n, true, ln);
    const float wa = tk.wv[ia], wb = tk.wv[ib];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      acc[n][0] *= wa;
      acc[n][1] *= wa;
      acc[n][2] *= wb;
      acc[n][3] *= wb;
    }
    const float dta = cm.dtv[ia], dtb = cm.dtv[ib];
    for (int it = r; it < ntl; ++it) {
      float z0[4], z1[4];
      mma_tile(z0, z1, xf, kp_n, gs, sx, 16 * it, ln);   // X GY^T
      const int i = 16 * it + 2 * ln.t;
      auto wt = [&](float xgv, int jr, double cj, float dtj, int ii) {
        return ii < jr ? 0.f : xgv * exp_diff(cm.cum[ii], cj) * dtj;
      };
      const float wq[8] = {wt(z0[0], ia, ca, dta, i), wt(z0[1], ia, ca, dta, i + 1),
                           wt(z0[2], ib, cb, dtb, i), wt(z0[3], ib, cb, dtb, i + 1),
                           wt(z1[0], ia, ca, dta, i + 8),
                           wt(z1[1], ia, ca, dta, i + 9),
                           wt(z1[2], ib, cb, dtb, i + 8),
                           wt(z1[3], ib, cb, dtb, i + 9)};
      uint32_t af[2][1][4];
      split_frag(wq, af[0][0], af[1][0]);
      // W^T c: B (i, s) from c stored [i][s], the k-tile at row 16 it
      mma_rows(acc, af[0], 1, cs + 16 * it * sb, nullptr, sb, ks_n, true, ln);
      mma_rows(acc, af[1], 1, cs + 16 * it * sb, nullptr, sb, ks_n, true, ln);
    }
    float* dbo = db_part + ((static_cast<int64_t>(ch.bi) * sh.seq + ch.t0)
                                * sh.nh + ch.h) * ds;
    const int64_t drow = static_cast<int64_t>(sh.nh) * ds;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if (n >= ds / 8) continue;
      const int s = 8 * n + 2 * ln.t;
      if (ia < ch.len)
        *reinterpret_cast<float2*>(dbo + ia * drow + s) =
            make_float2(acc[n][0], acc[n][1]);
      if (ib < ch.len)
        *reinterpret_cast<float2*>(dbo + ib * drow + s) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();                        // the per-token sums are written

  float dd = 0.f;
  for (int e = threadIdx.x; e < ch.len * hd; e += kThreads) {
    const int j = e / hd, p = e % hd;
    dd = fmaf(__bfloat162float(gs[j * sx + p]), __bfloat162float(xs[j * sx + p]),
              dd);
  }
  chunk_finish(cm, tk, ch, sh, a_neg, pair, dsh, dd, ddt, dalog_part, dd_part);
}

// ---- chunk pass, CUDA cores -----------------------------------------------

constexpr int kT = 128 + 4;   // row stride of a staged k-slice (floats)

// acc (8 x 8 a thread) += A . B over k < kk for an (mm, nn) product, mm
// and nn <= 128: thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16
// r and columns tx + 16 c.  A (m, k) and B (k, n) come through the
// accessors a k-slice of kSlice at a time, staged in as and bs ([kSlice][kT]
// floats each), zero past mm, nn and kk.
template <typename FA, typename FB>
__device__ __forceinline__ void gemm_cc(float (&acc)[8][8], const FA& fa,
                                        const FB& fb, int mm, int nn, int kk,
                                        float* as, float* bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k0 = 0; k0 < kk; k0 += kSlice) {
    __syncthreads();                      // the last slice is consumed
    for (int e = threadIdx.x; e < kSlice * 128; e += kThreads) {
      const int kq = e >> 7, m = e & 127, k = k0 + kq;
      as[kq * kT + m] = m < mm && k < kk ? fa(m, k) : 0.f;
      bs[kq * kT + m] = m < nn && k < kk ? fb(k, m) : 0.f;
    }
    __syncthreads();
    const int kn = min(kSlice, kk - k0);
    for (int kq = 0; kq < kn; ++kq) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = as[kq * kT + ty + 16 * i];
        bv[i] = bs[kq * kT + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
}

// Shared: the cum head, the per-token scratch, the k-slices, C B^T (then
// M) and GY X^T (then W) as [q][q + 1] f32, and per-thread row and column
// shares [16][q] twice.
inline size_t chunk_cc_smem(int q) {
  return cum_bytes<double>(q) + tok_bytes(q)
         + 4 * (2 * static_cast<size_t>(kSlice) * kT
                + 2 * static_cast<size_t>(q) * (q + 1) + 2 * 16 * q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chunk_bwd_cc(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_log, const T* __restrict__ bm,
             const T* __restrict__ cmat, const float* __restrict__ d_skip,
             const T* __restrict__ gy, const float* __restrict__ hin,
             const float* __restrict__ dst, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ dalog_part,
             float* __restrict__ dd_part, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds, len = ch.len, qs = q + 1;
  const Cum<double> cm = cum_at<double>(smem, q);
  const Tok tk = tok_at(past_cum<double>(smem, q), q);
  float* as =
      reinterpret_cast<float*>(past_cum<double>(smem, q) + tok_bytes(q));
  float* bs = as + kSlice * kT;
  float* pm = bs + kSlice * kT;           // [q][qs]: C B^T, then M
  float* wm = pm + q * qs;                // [q][qs]: GY X^T, then W
  float* rpart = wm + q * qs;             // [16][q]
  float* cpart = rpart + 16 * q;          // [16][q]

  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  const T* xg = x + xo;
  const T* gg = gy + xo;
  const T* bg = bm + bo;
  const T* cg = cmat + bo;
  const bool has_h = ch.k > 0;            // H_0 = 0
  const float* hk = hin + ch.idx * hd * ds;
  const float* sk = dst + ch.idx * hd * ds;
  const float a_neg = -expf(a_log[ch.h]);
  chunk_cum(dt, sh, ch, a_neg, cm);
  chunk_tokens(cm, tk, q);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  auto xa = [&](int m, int k) { return to_f32(xg[m * x_row + k]); };
  auto ga = [&](int m, int k) { return to_f32(gg[m * x_row + k]); };
  auto ba = [&](int m, int k) { return to_f32(bg[m * b_row + k]); };
  auto ca = [&](int m, int k) { return to_f32(cg[m * b_row + k]); };
  float acc[8][8];
  float pair = 0.f;

  // C B^T, kept; then GY X^T, turned with it into M, W and the sums of F
  zero(acc);
  gemm_cc(acc, ca, [&](int k, int n) { return ba(n, k); }, len, len, ds, as,
          bs);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (ty + 16 * i < q && tx + 16 * c < q)
        pm[(ty + 16 * i) * qs + tx + 16 * c] = acc[i][c];
  zero(acc);
  gemm_cc(acc, ga, [&](int k, int n) { return xa(n, k); }, len, len, hd, as,
          bs);
  float cp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
    const int i = ty + 16 * ri;
    if (i >= q) continue;
    float rp = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = tx + 16 * c;
      if (j >= q) continue;
      float mv = 0.f, wv = 0.f;
      if (j <= i) {
        const double sg = cm.cum[i] - cm.cum[j];
        const float e = expf(static_cast<float>(sg));
        const float cbv = pm[i * qs + j] * e, dtj = cm.dtv[j];
        const float tv = cbv * acc[ri][c];
        mv = cbv * dtj;
        wv = acc[ri][c] * e * dtj;
        rp += tv * dtj;
        cp[c] += tv;
        pair = fmaf(tv * dtj, static_cast<float>(sg), pair);
      }
      pm[i * qs + j] = mv;
      wm[i * qs + j] = wv;
    }
    rpart[tx * q + i] = rp;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (tx + 16 * c < q) cpart[ty * q + tx + 16 * c] = cp[c];
  __syncthreads();
  for (int t = threadIdx.x; t < q; t += kThreads) {
    float rs = 0.f, cs = 0.f;
    for (int i = 0; i < 16; ++i) {
      rs += rpart[i * q + t];
      cs += cpart[i * q + t];
    }
    tk.rowf[t] = rs;
    tk.colt[t] = cs;
  }
  // (gemm_cc's first barrier orders these reads before the shares' reuse)

  // dx = w (b dS^T) + M^T gy + d_skip gy; u = x . (dS b)
  zero(acc);
  gemm_cc(acc, ba, [&](int k, int n) { return sk[n * ds + k]; }, len, hd, ds,
          as, bs);
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
    const int j = ty + 16 * ri;
    float up = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int p = tx + 16 * c;
      if (j < len && p < hd) up = fmaf(acc[ri][c], xa(j, p), up);
    }
    if (j < q) rpart[tx * q + j] = up;
    const float wj = j < q ? tk.wv[j] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[ri][c] *= wj;
  }
  gemm_cc(acc, [&](int m, int k) { return pm[k * qs + m]; }, ga, len, hd, len,
          as, bs);
  const float dsk = d_skip[ch.h];
#pragma unroll
  for (int ri = 0; ri < 8; ++ri)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = ty + 16 * ri, p = tx + 16 * c;
      if (j < len && p < hd)
        dx[xo + j * x_row + p] = from_f32<T>(fmaf(dsk, ga(j, p), acc[ri][c]));
    }
  __syncthreads();
  for (int t = threadIdx.x; t < q; t += kThreads) {
    float us = 0.f;
    for (int i = 0; i < 16; ++i) us += rpart[i * q + t];
    tk.uu[t] = us;
  }

  // db = w (x dS) + W^T c
  zero(acc);
  gemm_cc(acc, xa, [&](int k, int n) { return sk[k * ds + n]; }, len, ds, hd,
          as, bs);
#pragma unroll
  for (int ri = 0; ri < 8; ++ri) {
    const int j = ty + 16 * ri;
    const float wj = j < q ? tk.wv[j] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[ri][c] *= wj;
  }
  gemm_cc(acc, [&](int m, int k) { return wm[k * qs + m]; }, ca, len, ds, len,
          as, bs);
  const int64_t drow = static_cast<int64_t>(sh.nh) * ds;
  float* dbo = db_part + ((static_cast<int64_t>(ch.bi) * sh.seq + ch.t0)
                              * sh.nh + ch.h) * ds;
  float* dco = dc_part + ((static_cast<int64_t>(ch.bi) * sh.seq + ch.t0)
                              * sh.nh + ch.h) * ds;
#pragma unroll
  for (int ri = 0; ri < 8; ++ri)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = ty + 16 * ri, s = tx + 16 * c;
      if (j < len && s < ds) dbo[j * drow + s] = acc[ri][c];
    }

  // dc = e (gy H) + W b; v = c . (H^T gy)
  zero(acc);
  if (has_h) {
    gemm_cc(acc, ga, [&](int k, int n) { return hk[k * ds + n]; }, len, ds, hd,
            as, bs);
#pragma unroll
    for (int ri = 0; ri < 8; ++ri) {
      const int i = ty + 16 * ri;
      float vp = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int s = tx + 16 * c;
        if (i < len && s < ds) vp = fmaf(acc[ri][c], ca(i, s), vp);
      }
      if (i < q) cpart[tx * q + i] = vp;
      const float ei = i < q ? tk.ev[i] : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[ri][c] *= ei;
    }
  }
  gemm_cc(acc, [&](int m, int k) { return wm[m * qs + k]; }, ba, len, ds, len,
          as, bs);
#pragma unroll
  for (int ri = 0; ri < 8; ++ri)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int i = ty + 16 * ri, s = tx + 16 * c;
      if (i < len && s < ds) dco[i * drow + s] = acc[ri][c];
    }
  __syncthreads();
  float dsh = 0.f;
  if (has_h) {
    for (int t = threadIdx.x; t < q; t += kThreads) {
      float vs = 0.f;
      for (int i = 0; i < 16; ++i) vs += cpart[i * q + t];
      tk.vv[t] = vs;
    }
    for (int e = threadIdx.x; e < hd * ds; e += kThreads)
      dsh = fmaf(sk[e], hk[e], dsh);
  }
  float dd = 0.f;
  for (int e = threadIdx.x; e < len * hd; e += kThreads) {
    const int j = e / hd, p = e % hd;
    dd = fmaf(ga(j, p), xa(j, p), dd);
  }
  __syncthreads();
  chunk_finish(cm, tk, ch, sh, a_neg, pair, dsh, dd, ddt, dalog_part, dd_part);
}

// ---- pass 3: the state pass in reverse ------------------------------------

// Thread i of a head owns its state entries 4 i .. 4 i + 3, as the
// forward's pass 2 does, walking the chunks from the last: G = gh (or 0),
// then dS_k = G over R_k and G <- R_k + decay_k G.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
state_pass_bwd(float* __restrict__ st, const float* __restrict__ decay,
               const float* __restrict__ gh, int32_t nc, int32_t n,
               int32_t tiles) {
  const int64_t head = blockIdx.x / tiles;
  const int e = ((blockIdx.x % tiles) * kThreads + threadIdx.x) * 4;
  if (e >= n) return;
  float* s = st + head * nc * n + e;
  const float* dec = decay + head * nc;
  const float* g0 = gh == nullptr ? nullptr : gh + head * n + e;
  if (kVec) {
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 g = g0 != nullptr ? *reinterpret_cast<const float4*>(g0) : zero4;
    float4 cur = nc > 0 ? *reinterpret_cast<const float4*>(
                              s + static_cast<int64_t>(nc - 1) * n)
                        : zero4;
    for (int k = nc - 1; k >= 0; --k) {
      const float4 nxt = k > 0 ? *reinterpret_cast<const float4*>(
                                     s + static_cast<int64_t>(k - 1) * n)
                               : zero4;
      const float dk = dec[k];
      *reinterpret_cast<float4*>(s + static_cast<int64_t>(k) * n) = g;
      g = make_float4(fmaf(g.x, dk, cur.x), fmaf(g.y, dk, cur.y),
                      fmaf(g.z, dk, cur.z), fmaf(g.w, dk, cur.w));
      cur = nxt;
    }
  } else {
    for (int i = 0; i < min(4, n - e); ++i) {
      float g = g0 != nullptr ? g0[i] : 0.f;
      for (int k = nc - 1; k >= 0; --k) {
        float* p = s + static_cast<int64_t>(k) * n + i;
        const float v = *p;
        *p = g;
        g = fmaf(g, dec[k], v);
      }
    }
  }
}

// ---- pass 5: the fixed-order sums -----------------------------------------

// out (rows, ng, ds) = the sum over the heads of each group of part (rows,
// nh, ds), in head order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_sum(const float* __restrict__ part, T* __restrict__ out, int64_t rows,
          int32_t nh, int32_t ng, int32_t ds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * ng * ds) return;
  const int s = static_cast<int>(i % ds);
  const int64_t rg = i / ds;
  const int g = static_cast<int>(rg % ng);
  const int64_t row = rg / ng;
  const int rep = nh / ng;
  const float* p = part + (row * nh + static_cast<int64_t>(g) * rep) * ds + s;
  float v = 0.f;
  for (int hh = 0; hh < rep; ++hh) v += p[static_cast<int64_t>(hh) * ds];
  out[i] = from_f32<T>(v);
}

// da_log and dd_skip (nh,) = the sums of the blocks' shares (B, nh, nc),
// batch row by batch row and chunk by chunk.
__global__ void __launch_bounds__(kThreads)
head_sum(const float* __restrict__ dalog_part, const float* __restrict__ dd_part,
         float* __restrict__ da_log, float* __restrict__ dd_skip, int32_t bsz,
         int32_t nh, int32_t nc) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= nh) return;
  float a = 0.f, d = 0.f;
  for (int bi = 0; bi < bsz; ++bi)
    for (int k = 0; k < nc; ++k) {
      const int64_t i = (static_cast<int64_t>(bi) * nh + h) * nc + k;
      a += dalog_part[i];
      d += dd_part[i];
    }
  da_log[h] = a;
  dd_skip[h] = d;
}

// ---- plans ------------------------------------------------------------------

Pass chunk_pass(int mode, int q, int hd, int ds) {
  if (mode == kTensorCores) {
    const bool wide_d = hd > 64, wide_s = ds > 64;
    return Pass{
        wide_d ? (wide_s ? reinterpret_cast<const void*>(&chunk_bwd_tc<16, 16>)
                         : reinterpret_cast<const void*>(&chunk_bwd_tc<16, 8>))
               : (wide_s ? reinterpret_cast<const void*>(&chunk_bwd_tc<8, 16>)
                         : reinterpret_cast<const void*>(&chunk_bwd_tc<8, 8>)),
        chunk_tc_smem(q, hd, ds)};
  }
  return Pass{mode == kBf16
                  ? reinterpret_cast<const void*>(&chunk_bwd_cc<bf16>)
                  : reinterpret_cast<const void*>(&chunk_bwd_cc<float>),
              chunk_cc_smem(q)};
}

}  // namespace ssd_grad

using namespace ssd_grad;

// The gradients of ssd_fwd's (y, h_out) at (x, dt, a_log, b, c, d_skip)
// against gy (like x) and gh ((bsz, nh, hd, ds) f32, or null: zero).
// Scratch, all f32: states, dstates (bsz, nh, nc, hd, ds), decay (bsz, nh,
// nc), db_part, dc_part (bsz, seq, nh, ds), dalog_part, dd_part
// (bsz, nh, nc).  Out: dx like x, ddt like dt, da_log and dd_skip (nh,)
// f32, db and dc like b.  All contiguous; the modes and limits are
// ssd_fwd's.  `passes` is a mask of the passes to launch, in this order (31 is the
// whole gradient): 1 rebuilds the entering states into `states` (and
// decay), 2 writes R into dstates, 4 turns dstates into dS in place, 8 the
// chunk pass (dx, ddt and the shares), 16 the sums (db, dc, da_log,
// dd_skip).  Returns the first CUDA error, else cudaGetLastError().
extern "C" int ssd_bwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* d_skip,
                       const void* gy, const void* gh, void* states,
                       void* decay, void* dstates, void* db_part,
                       void* dc_part, void* dalog_part, void* dd_part,
                       void* dx, void* ddt, void* da_log, void* db, void* dc,
                       void* dd_skip, int32_t bsz, int32_t seq, int32_t nh,
                       int32_t hd, int32_t ng, int32_t ds, int32_t chunk,
                       int32_t mode, int32_t passes, void* stream) {
  if (!valid(mode, hd, ds, chunk) || ng <= 0 || nh % ng || seq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bsz <= 0 || nh <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape sh{bsz, seq, nh, hd, ng, ds, chunk, (seq + chunk - 1) / chunk};
  const unsigned blocks = static_cast<unsigned>(bsz) * nh * sh.nc;
  int32_t n = hd * ds, tiles = state_tiles(n);
  const unsigned state_blocks = static_cast<unsigned>(bsz) * nh * tiles;
  void* null = nullptr;
  cudaError_t err = cudaSuccess;
  if ((passes & 1) && sh.nc > 0) {
    void* args[] = {&x, &dt, &a_log, &b, &states, &decay, &sh};
    err = launch(states_pass<false, Tag>(mode, chunk, hd, ds), blocks, args,
                 st);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* pargs[] = {&states, &decay, &null, &sh.nc, &n, &tiles};
    err = launch(state_pass_pass<Tag>(hd, ds), state_blocks, pargs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((passes & 2) && sh.nc > 0) {
    void* args[] = {&gy, &dt, &a_log, &c, &dstates, &null, &sh};
    err = launch(states_pass<true, Tag>(mode, chunk, hd, ds), blocks, args,
                 st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 4) {
    void* args[] = {&dstates, &decay, &gh, &sh.nc, &n, &tiles};
    const Pass p{n % 4 == 0
                     ? reinterpret_cast<const void*>(&state_pass_bwd<true>)
                     : reinterpret_cast<const void*>(&state_pass_bwd<false>),
                 0};
    err = launch(p, state_blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((passes & 8) && sh.nc > 0) {
    void* args[] = {&x,  &dt,  &a_log,   &b,       &c,          &d_skip,
                    &gy, &states, &dstates, &dx,   &ddt,        &db_part,
                    &dc_part, &dalog_part, &dd_part, &sh};
    err = launch(chunk_pass(mode, chunk, hd, ds), blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 16) {
    int64_t rows = static_cast<int64_t>(bsz) * seq;
    const int64_t outs = rows * ng * ds;
    if (outs > 0) {
      const unsigned g =
          static_cast<unsigned>((outs + kThreads - 1) / kThreads);
      const Pass p{mode == kF32
                       ? reinterpret_cast<const void*>(&group_sum<float>)
                       : reinterpret_cast<const void*>(&group_sum<bf16>),
                   0};
      void* bargs[] = {&db_part, &db, &rows, &nh, &ng, &ds};
      err = launch(p, g, bargs, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      void* cargs[] = {&dc_part, &dc, &rows, &nh, &ng, &ds};
      err = launch(p, g, cargs, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    void* hargs[] = {&dalog_part, &dd_part, &da_log, &dd_skip, &bsz, &nh,
                     &sh.nc};
    err = launch(Pass{reinterpret_cast<const void*>(&head_sum), 0},
                 static_cast<unsigned>((nh + kThreads - 1) / kThreads), hargs,
                 st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// For each pass at (mode, hd, ds, chunk) with shared memory of its own
// (the states, out states and chunk passes): the blocks of kThreads
// threads that fit on one SM into blocks[0..2], and the shared bytes a
// block takes into smem[0..2].
extern "C" int ssd_bwd_occupancy(int32_t mode, int32_t hd, int32_t ds,
                                 int32_t chunk, int32_t* blocks,
                                 int32_t* smem) {
  if (!valid(mode, hd, ds, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Pass ps[3] = {states_pass<false, Tag>(mode, chunk, hd, ds),
                      states_pass<true, Tag>(mode, chunk, hd, ds),
                      chunk_pass(mode, chunk, hd, ds)};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = allow_smem(ps[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[i], ps[i].fn, kThreads, ps[i].smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem[i] = static_cast<int32_t>(ps[i].smem);
  }
  return 0;
}
