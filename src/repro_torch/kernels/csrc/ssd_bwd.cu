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
//   of Q tokens, L = cum_last, H_k the state entering chunk k), over four
//   passes:
//     1. states (a block per batch row, chunk and head, one chunk cum): the
//        chunk's own state S_k = sum_j w_j x_j b_j^T, w_j = dt_j exp(L -
//        cum_j), and its decay exp(L) (the forward's pass 1: no (B, nh, nc,
//        hd, ds) tensor is kept from the forward), and R_k = sum_i exp(cum_i)
//        gy_i c_i^T, what chunk k's y sends back to H_k;
//     2. state pass, elementwise and in place, two scans: S into H (the
//        forward's pass 2, chunks in order), and R into dS (chunks in
//        reverse: G = gh, then dS_k = G and G <- R_k + exp(L_k) G);
//     3. chunk pass (a block per batch row, chunk and head): with E_ij =
//        exp(cum_i - cum_j) (j <= i), e_i = exp(cum_i), w_j as above, M_ij
//        = (c_i . b_j) E_ij dt_j, W_ij = (gy_i . x_j) E_ij dt_j and F_ij =
//        (c_i . b_j) W_ij:
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
//     4. reduce, one launch: db and dc summed over the shares of a group,
//        da_log and dd_skip over the blocks, in a fixed order.
// Bound: at mamba2-780m's training shape (x 4 x 4,096 x 48 x 64 bf16, b
//   and c 4 x 4,096 x 1 x 128, chunk 128, gh absent) the function reads x,
//   gy, dt, b, c once and writes dx, ddt, db, dc once: 325.1 MB, 0.0970 ms
//   at 3.35 TB/s; its products (ssd_flops(backward=True), twice the
//   forward's) are 90.5 GFLOP, 0.0915 ms at 989 TFLOP/s: bound by bytes.
//   The passes move far more: two (B, nh, nc, hd, ds) f32 scratches (S
//   then H, and R then dS, 201.3 MB each: written by pass 1, read and
//   written by pass 2, read by pass 3), x and gy twice (100.7 MB each), and
//   db's and dc's f32 shares, (B, S, nh / C, ds) each (50.3 MB at C = 8;
//   402.7 MB each a head, C = 1), written once and read once: some 2.3 GB
//   of device memory a call on the tensor-core route, and some 0.7 GB
//   between the shared memories of a cluster's blocks (7 / 8 of each
//   block's two f32 shares at C = 8).  In f32 (the CUDA-core route) at
//   mamba2-780m's widths, 1 x 4,096, the function is 22.62 GFLOP and 161.0
//   MB: 0.1371 ms at 495 TFLOP/s of TF32 times the three products of the
//   split (0.3377 ms at the CUDA cores' 67 TFLOP/s), against 0.0480 ms for
//   the bytes: bound by operations.  PERF.md keeps the measured times.
// Design: every pass but 2 and 4 runs the chunks of a head in parallel.
//   On the tensor-core route (bf16, hd and ds multiples of 16) passes 1
//   and 3 multiply on wgmma (m64nNk16 bf16 -> f32).  bf16 operands are
//   exact; an f32 operand (a weighted x or gy, H, dS, M, W) is split into
//   hi = bf16(v) and lo = bf16(v - hi), two products summed in f32, as the
//   forward does.  Every k loop has a trip count fixed at compile time
//   (the padded width) and the accumulators are touched in no divergent
//   path: otherwise ptxas serialises every wgmma of the kernel.  cum is
//   f64 (ssd_common.cuh), computed once a block in each pass.
//   Pass 1 (states_bwd_wg) is two warpgroups, one a product: warpgroup 0
//   S from x w and b, warpgroup 1 R from gy e and c, each over the chunk's
//   tokens 64 at a time, its own tiles staged by cp.async in wgmma's
//   128-byte swizzle, the weighted operand split in place; A is the
//   weighted (token, hd) tile read transposed (MN-major) and B the (token,
//   ds) tile, MN-major.  Two blocks an SM at hd 64.
//   Pass 3 (chunk_bwd_wg) is a block of two warpgroups per (batch row,
//   chunk, head), one block an SM, launched in thread-block clusters of C
//   blocks: C consecutive heads of one group at the same (batch row,
//   chunk), C the largest divisor of nh / ng up to 8 (the wrapper's
//   cluster_heads).  chunk_of's order already puts the head fastest, so a
//   cluster is C consecutive blocks and a block's rank is h % C.  Rank r
//   owns rows r P .. r P + P - 1 of the chunk (P = ceil(128 / C)).  x and
//   gy stage by cp.async into 128-row tiles in wgmma's 128-byte swizzle,
//   hd and ds padded to 64 or 128 with zeros.  b and c, the same for every
//   head of a group, are read once a cluster: their 64-column x 16-row TMA
//   boxes are shared out among the ranks, and each rank's loads are
//   multicast to every block of the cluster (where a tensor map cannot
//   take them, a misaligned view or ds not a multiple of 64, each block
//   stages its own).  The f32 states H and dS are split into bf16 hi and
//   lo tiles (both resident where they fit).  Warpgroup wg owns tokens 64
//   wg .. 64 wg + 63, first as rows i (dc = W b + e (gy H), sum_j F_ij, v,
//   and gy . x from the diagonal of GY X^T), then as rows j (dx = M^T gy +
//   w (b dS^T), db = W^T c + w (x dS), sum_i T_ij, u); the two take the
//   halves of the Q x Q products in other orders and meet at no barrier
//   between them.  The Q x Q products C B^T and GY X^T run by 64 x 64
//   blocks on and below the diagonal, once per orientation, both operands
//   K-major in shared memory; the state products take the state as an
//   MN-major or K-major shared operand; the split M, W products take the A
//   operand in registers, straight from the elementwise work on the
//   accumulator.  db's and dc's head shares are summed on the chip, into
//   the buffers of the rows' owners (f32, rows of SP + 8 floats): dc's
//   straight from the accumulators by asynchronous stores to distributed
//   shared memory (st.async, counted on the owner's mbarrier), which
//   travel while rows j run; db's through this block's shared memory and
//   one bulk copy to each owner (cp.async.bulk), which travels while the
//   chunk's tail runs.  The owner sums its rows of the C shares in rank
//   order from its own shared memory and writes one share of (B, S, nh /
//   C, ds).  A buffer lies over tiles its block no longer reads (dc's over
//   H's and past them, db's over x, gy, b and c), and each warp of the
//   owner says so on an mbarrier of every block before any writes there.
//   No block leaves before all that was sent to it has landed.  One
//   cluster barrier, at the start, orders the mbarriers' set-up before
//   their first use from a peer.  Where H and dS are not both resident (hd
//   = ds = 128) dc's shares are summed before dS is split into H's tiles.
//   Every width the route takes fits C up to 8 (211,936 bytes at hd 64 or
//   128, ds 128), so no width falls back to C = 1.
//   The CUDA-core route (f32, and bf16 at widths that are not multiples
//   of 16) runs every product on the tensor cores as split TF32: mma.sync
//   m16n8k8, each f32 operand x = hi + lo (hi rounded as cvt.rna rounds,
//   lo left whole), three products summed in f32 (tf32::, common.cuh; B7's
//   f32 backward does the same).  mma.sync rather than wgmma: wgmma reads
//   TF32 operands from shared memory only, K-major only, so every split
//   operand would need tiles of its own (flash_attention.cu's note); a
//   bf16 operand is TF32 exactly, and its lo's products are dropped.  Its
//   operands stage by cp.async into two buffers in turn (k slices of 64
//   columns of a width, or of 64 tokens: half the barriers of 32, 5-7%
//   faster), zero past the chunk's tokens and past hd and ds, which the k
//   steps pad to multiples of 8, so every width up to 128 goes.  Pass 1
//   (states_bwd_tf) is one launch, one chunk cum a block: S and R cut into
//   16 x 64 warp tiles, two a warp at a time, over the chunk's tokens 16
//   at a time; two blocks an SM.  Pass 3 (chunk_bwd_tf) gives warp w 16 of
//   the chunk's rows, first as rows i (C B^T and GY X^T over j <= i, then
//   T's row and column sums, W, dc = e (gy H) + W b and v), then as rows j
//   (B C^T into M^T, dx = w (b dS^T) + M^T gy + d_skip gy and u; X GY^T
//   into W^T, db = w (x dS) + W^T c).  The M, W products take their A
//   operand straight from the accumulator fragments (the `ab` form); the
//   Q x Q products are computed once per orientation rather than kept in
//   shared memory; T's column sums cross the warps through shared memory,
//   in warp order.  Warps w and w + 4 share a scheduler, so they take row
//   tiles r and 7 - r (w < 4 ? w : 11 - w), whose causal halves sum to the
//   same work in either orientation.  A thread holds at most a 16 x Q
//   fragment (64 registers) and a 16 x 64 accumulator (32): every product
//   of a width runs 64 output columns at a time, and C B^T waits in shared
//   memory (the park), thread by thread, while GY X^T is summed (with two
//   16 x Q fragments and a 16 x 128 accumulator ptxas put the arrays in
//   local memory: 255 registers and 2.6 KB of stack a thread, a chunk pass
//   2.4-2.9x slower than the FMA one).  The registers still hold it to one
//   block an SM.  It runs in clusters of C heads of one group, C as on the
//   tensor-core route: each block writes its share of dc, later of db,
//   into the park, and after a cluster barrier each sums its rows of the C
//   shares in rank order from the blocks' shared memory
//   (ld.shared::cluster) into one share a cluster; a second barrier frees
//   the park.  No atomics: every sum has a fixed order, so two calls give
//   the same bits.  The launcher binds the device before it encodes b's
//   and c's tensor maps (bind_device, common.cuh).
#include "ssd_common.cuh"

// Every kernel of the backward is named in this namespace (the shared
// passes' instances through their Tag), so a profile sums them by name.
namespace ssd_grad {

using namespace repro_torch::ssd;
using namespace repro_torch::sm90;
using repro_torch::kThreads;

// Names the backward's instances of the shared passes, and keeps their cum
// in f64.
struct Tag {
  using cum = double;
};

constexpr unsigned kFull = 0xffffffffu;

// ---- per-token scratch of the chunk pass ----------------------------------

// After the cum head: exp(cum), w, sum_j F_tj, sum_i T_it (T = F / dt),
// u, v (q floats each), cum as f32 pairs hi + lo (q float2s), then 32
// floats for block sums.
struct Tok {
  float *ev, *wv, *rowf, *colt, *uu, *vv;
  float2* c2;
  float* red;
};

__host__ __device__ inline size_t tok_bytes(int q) {
  return 4 * (8 * static_cast<size_t>(q) + 32);
}

__device__ __forceinline__ Tok tok_at(char* p, int q) {
  Tok t;
  t.ev = reinterpret_cast<float*>(p);
  t.wv = t.ev + q;
  t.rowf = t.wv + q;
  t.colt = t.rowf + q;
  t.uu = t.colt + q;
  t.vv = t.uu + q;
  t.c2 = reinterpret_cast<float2*>(t.vv + q);
  t.red = reinterpret_cast<float*>(t.c2 + q);
  return t;
}

// exp(cum), w and cum as hi + lo of each token; the sums zeroed.
__device__ __forceinline__ void chunk_tokens(const Cum<double>& cm,
                                             const Tok& tk, int q) {
  const double last = cm.cum[q - 1];
  for (int t = threadIdx.x; t < q; t += kThreads) {
    tk.ev[t] = expf(static_cast<float>(cm.cum[t]));
    tk.wv[t] = cm.dtv[t] * exp_diff(last, cm.cum[t]);
    tk.rowf[t] = tk.colt[t] = tk.uu[t] = tk.vv[t] = 0.f;
    const float hi = static_cast<float>(cm.cum[t]);
    tk.c2[t] = make_float2(hi, static_cast<float>(cm.cum[t] - hi));
  }
  __syncthreads();
}

// cum_i - cum_j from the pairs hi + lo, in f32: where exp of the
// difference is above f32's underflow (|cum_i - cum_j| < 104), either the
// his lie within a factor two of each other, so their difference is exact,
// or it exceeds the smaller one, so its one rounding is relative to
// itself: the result is as close as the f64 difference rounded to f32.
__device__ __forceinline__ float cum_diff(float2 i, float2 j) {
  return (i.x - j.x) + (i.y - j.y);
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

// ---- chunk pass, tensor cores (wgmma) -------------------------------------
//
// (The design is in the note at the top.)  Each warpgroup waits for its
// products before the elementwise work that follows them.

constexpr int kTok = 128;        // a token tile's rows (the longest chunk)
constexpr int kMaxCluster = 8;   // blocks a cluster of the chunk pass

// The element offset of (r, c) in a bf16 tile of kRows rows in the
// 128-byte swizzle: columns in boxes of 64 (kRows rows of 128 bytes each),
// the 16-byte chunk c / 8 of row r at chunk (c / 8) ^ (r % 8) of the row.
template <int kRows>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (kRows * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3)
         + (c & 7);
}

// wgmma's descriptor of rows r0 .. of a kRows-row tile as a K-major
// operand, k step kk (16 columns: 32 bytes within a swizzled row, the next
// box kRows rows on).
template <int kRows>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int r0, int kk) {
  return sw128_desc(tile + (kk >> 2) * kRows * kRowBytes + r0 * kRowBytes
                        + (kk & 3) * 32, 16, 1024);
}

// ... and of rows k0 .. k0 + 15 as an MN-major B operand (the K rows; N
// across the tile's boxes, transposed by the instruction).
template <int kRows>
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int k0) {
  return sw128_desc(tile + k0 * kRowBytes, kRows * kRowBytes, 1024);
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), bf16, both in shared
// memory (128-byte swizzle), each K-major (kTrans 0) or MN-major (1,
// transposed through the descriptor); scale_d = 0 overwrites D.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), the same way.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wg_ss128(float (&d)[64], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// A K-major (kTransA 0) or MN-major (1).
template <int N, int kTransB, int kTransA = 0>
__device__ __forceinline__ void wg_ss(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 64)
    wg_ss64<kTransA, kTransB>(d, da, db, 1);
  else
    wg_ss128<kTransA, kTransB>(d, da, db, 1);
}

// D (64 x N) += A (64 x 16, bf16 fragments in registers) . B, B MN-major.
template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

template <int N> __device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The f32 64 x 64 accumulator as the bf16 hi and lo A fragments of its
// four k steps (k step kk: the accumulator's registers 8 kk .. 8 kk + 7,
// paired in order).
__device__ __forceinline__ void split_acc(const float (&v)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split2(v[8 * kk + 2 * j], v[8 * kk + 2 * j + 1], hi[kk][j], lo[kk][j]);
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int N> __device__ __forceinline__ void fence_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Rows ra and ra + 8 (those below len) of an f32 (64 x N) accumulator, its
// first `width` columns (a multiple of 16), into rows `stride` floats
// apart at `out`.  The values are copied out of the accumulator first, in
// code every thread runs: an accumulator touched in a divergent path
// makes ptxas serialise every wgmma of the kernel.
template <int N>
__device__ __forceinline__ void store_rows(float* out, int64_t stride, int ra,
                                           int len, int width, int tq,
                                           const float (&acc)[N / 2]) {
  float v[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) v[i] = acc[i];
  fence_regs(v);
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (8 * n >= width) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r < len)
        *reinterpret_cast<float2*>(out + r * stride + 8 * n + 2 * tq) =
            make_float2(v[4 * n + 2 * half], v[4 * n + 2 * half + 1]);
    }
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread-block clusters (distributed shared memory) -------------------

// This block's rank in its cluster, and the cluster's blocks.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}

// The cluster barrier, used once, at the start: every block arrives once
// its mbarriers are set up (relaxed: fence.mbarrier_init orders them) and
// waits before its first operation on a peer's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of this block's shared
// address `addr`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// One arrival on the mbarrier at cluster address `bar` (a peer's, or this
// block's own), releasing this thread's accesses to the cluster.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// Waits for phase 0 of this block's mbarrier `bar`, acquiring what the
// cluster's blocks released into it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// (v0, .., v3) into a block's shared memory at cluster address `addr`,
// counted in bytes on that block's mbarrier `bar` (cluster address).
__device__ __forceinline__ void st_async4(uint32_t addr, float v0, float v1,
                                          float v2, float v3, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v0), "f"(v1), "f"(v2), "f"(v3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at `src` to a
// peer's at cluster address `dst`, counted on the peer's mbarrier `bar`.
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One TMA box of a 4-D tensor map into this block's shared memory at `dst`
// and the same place in each block of `mask` (bit p: rank p), counted on
// each one's mbarrier at `bar`.
__device__ __forceinline__ void tma_multicast_4d(uint32_t dst,
                                                 const CUtensorMap* map,
                                                 uint32_t bar, int c0, int c1,
                                                 int c2, int c3,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The 128 threads of warpgroup wg wait for each other (named barrier 1 +
// wg; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// Rows r0 .. r1 - 1 of a kRows-row tile of a (seq, heads, width) slice,
// `src` at the tile's first row and `sstride` elements a row, into a
// swizzled tile of kW columns; rows at or past `valid` and columns at or
// past `width` (a multiple of 16) are zeros.  Threads tid of nthr take
// the 16-byte pieces in turn: cp.async where every address allows, else
// element by element; the caller waits.
template <int kRows, int kW>
__device__ __forceinline__ void stage_sw(bf16* tile, const bf16* src,
                                         int64_t sstride, int valid,
                                         int width, int r0, int r1, int tid,
                                         int nthr) {
  constexpr int kChunks = kW / 8;
  const bool vec = ((reinterpret_cast<uintptr_t>(src)
                     | static_cast<uint64_t>(sstride * 2)) & 15) == 0;
  for (int i = r0 * kChunks + tid; i < r1 * kChunks; i += nthr) {
    const int r = i / kChunks, c = 8 * (i % kChunks);
    bf16* d = tile + sw<kRows>(r, c);
    if (r < valid && c < width) {
      const bf16* s = src + r * sstride + c;
      if (vec) {
        cp_async<16>(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = s[e];
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// An f32 (hd, ds) state into bf16 hi and lo swizzled tiles of kH rows and
// kS columns (zero past hd and ds), and, where `other_hi` is not null, the
// state `other` the same way; returns this thread's share of <st, other>
// (0 where other is null).  A thread's loads are all issued before the
// first split, so they are in flight together.
template <int kH, int kS>
__device__ __forceinline__ float split_state(const float* __restrict__ st,
                                             const float* __restrict__ other,
                                             bf16* hi, bf16* lo,
                                             bf16* other_hi, bf16* other_lo,
                                             int hd, int ds) {
  constexpr int kIters = kH * kS / (4 * kThreads);
  float4 v[kIters], o[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = 4 * (threadIdx.x + it * kThreads);
    const int p = e / kS, s = e % kS;
    const bool in = p < hd && s < ds;
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    v[it] = in ? *reinterpret_cast<const float4*>(st + p * ds + s) : zero4;
    o[it] = in && other != nullptr
                ? *reinterpret_cast<const float4*>(other + p * ds + s)
                : zero4;
  }
  float dot = 0.f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = 4 * (threadIdx.x + it * kThreads);
    const int at = sw<kH>(e / kS, e % kS);
    dot = fmaf(v[it].x, o[it].x, fmaf(v[it].y, o[it].y,
               fmaf(v[it].z, o[it].z, fmaf(v[it].w, o[it].w, dot))));
    uint2 h, l;
    split2(v[it].x, v[it].y, h.x, l.x);
    split2(v[it].z, v[it].w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + at) = h;
    *reinterpret_cast<uint2*>(lo + at) = l;
    if (other_hi != nullptr) {
      split2(o[it].x, o[it].y, h.x, l.x);
      split2(o[it].z, o[it].w, h.y, l.y);
      *reinterpret_cast<uint2*>(other_hi + at) = h;
      *reinterpret_cast<uint2*>(other_lo + at) = l;
    }
  }
  return dot;
}

// Byte offsets of the tiles from a 1024-byte-aligned base.
template <int HP, int SP> struct WgLayout {
  static constexpr int kX = 0;                          // x  [kTok][HP]
  static constexpr int kG = kX + kTok * HP * 2;         // gy [kTok][HP]
  static constexpr int kB = kG + kTok * HP * 2;         // b  [kTok][SP]
  static constexpr int kC = kB + kTok * SP * 2;         // c  [kTok][SP]
  static constexpr int kStBytes = HP * SP * 2;          // a state's half
  static constexpr int kDs = kC + kTok * SP * 2;        // dS hi, lo
  // H beside dS where both fit, else dS in H's tiles once H is consumed
  static constexpr bool kBoth = HP * SP <= 64 * 128;
  static constexpr int kH = kBoth ? kDs + 2 * kStBytes : kDs;
  // the buffers that receive the cluster's shares of this block's rows of
  // dc and of db, [kTok + kMaxCluster][kShareRow] f32 each: dc's over H's
  // tiles (rows j do not read H) and past them, db's over x, gy, b and c
  // (free once rows j are done); 8 floats of padding a row keep a warp's
  // rows on other banks
  static constexpr int kShareRow = SP + 8;
  static constexpr int kRecvBytes = (kTok + kMaxCluster) * kShareRow * 4;
  static constexpr int kRecvC = kH;
  static constexpr int kRecvB = kX;
  static_assert(kRecvB + kRecvBytes <= kDs, "db's buffer within x to c");
  static constexpr int kBytes = kRecvC + kRecvBytes > kH + 2 * kStBytes
                                    ? kRecvC + kRecvBytes
                                    : kH + 2 * kStBytes;
};

// The chunk pass's mbarriers, 8 bytes each after the per-token scratch:
// the peers' rows of b and c landed; every block of the cluster may write
// its share of dc (of db) into this block's buffer; every share of this
// block's rows of dc (of db) landed.
enum { kBarBc, kBarReadyC, kBarFullC, kBarReadyB, kBarFullB };
constexpr int kBarBytes = 64;

template <int HP, int SP> inline size_t chunk_wg_smem(int q) {
  return cum_bytes<double>(q) + tok_bytes(q) + kBarBytes + 1024
         + WgLayout<HP, SP>::kBytes;
}

// What a warpgroup's phases read and write: the block's staged tiles
// (generic pointers for element reads, shared addresses for wgmma), its
// per-token scratch, and the outputs.
struct WgCtx {
  Cum<double> cm;
  Tok tk;
  Chunk ch;
  const bf16 *xs, *gs, *cs;
  uint32_t ux, ug, ub, uc, uhh, uhl, udh, udl;
  uint32_t ready_c, ready_b;            // kBarReadyC, kBarReadyB
  const float* d_skip;
  bf16* dx;
  int64_t xo, x_row;
  int len, hd, ds;
  bool has_h;
};

// This warp will read the tiles under a buffer (`ready`: its kBarReadyC
// or kBarReadyB) no more: one arrival on that mbarrier of every block of
// the cluster, lane p's on rank p's.
__device__ __forceinline__ void warp_done_with(uint32_t ready) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  if (lane < cluster_blocks()) mbar_arrive_peer(peer_addr(ready, lane));
}

// The share of the cluster's heads in (B, S, nh / C, ds) `part`, at the
// chunk's first row.
__device__ __forceinline__ float* share_out(float* part, const Shape& sh,
                                            const Chunk& ch) {
  const int nrank = cluster_blocks();
  return part + ((static_cast<int64_t>(ch.bi) * sh.seq + ch.t0)
                     * (sh.nh / nrank)
                 + ch.h / nrank) * sh.ds;
}

// The first of a thread's two rows (this and 8 on) in its warpgroup's
// accumulators.
__device__ __forceinline__ int share_row0(int wg) {
  const int tw = threadIdx.x & 127;
  return 64 * wg + 16 * (tw >> 5) + ((tw & 31) >> 2);
}

// This block's share of dc (rows ra and ra + 8 of an f32 (64 x SP)
// accumulator, its first ds columns) into the buffers (`recv`, counted on
// `full`) of the rows' owners: of the cluster's C blocks, rank o owns rows
// o P .. o P + P - 1 (P = ceil(kTok / C)) and keeps rank p's share of row
// r at its buffer row p P + r - o P (SP + 8 floats a row).  Asynchronous
// stores of 16 bytes, from registers: lanes tq and tq ^ 1 trade halves,
// so that the even one holds 4 columns of row ra and the odd one the same
// 4 of row ra + 8.  Every thread runs it, whatever its rows (see
// store_rows).
template <int SP>
__device__ __forceinline__ void push_share(uint32_t recv, uint32_t full,
                                           int ra, int ds,
                                           const float (&acc)[SP / 2]) {
  float v[SP / 2];
#pragma unroll
  for (int i = 0; i < SP / 2; ++i) v[i] = acc[i];
  fence_regs(v);
  const int nrank = cluster_blocks(), rank = cluster_rank();
  const int per = (kTok + nrank - 1) / nrank, tq = threadIdx.x & 3;
  const bool odd = tq & 1;
  const int r = ra + (odd ? 8 : 0), o = r / per;
  const uint32_t at = peer_addr(
      recv + static_cast<uint32_t>((rank * per + r - o * per) * (SP + 8)
                                   + 2 * (tq & 2)) * 4, o);
  const uint32_t bar = peer_addr(full, o);
#pragma unroll
  for (int n = 0; n < SP / 8; ++n) {
    // even lanes send row ra + 8's pair, odd lanes row ra's
    const float s0 = odd ? v[4 * n] : v[4 * n + 2];
    const float s1 = odd ? v[4 * n + 1] : v[4 * n + 3];
    const float g0 = __shfl_xor_sync(kFull, s0, 1);
    const float g1 = __shfl_xor_sync(kFull, s1, 1);
    if (8 * n < ds) {
      if (odd)
        st_async4(at + 32 * n, g0, g1, v[4 * n + 2], v[4 * n + 3], bar);
      else
        st_async4(at + 32 * n, v[4 * n], v[4 * n + 1], g0, g1, bar);
    }
  }
}

// Rows ra and ra + 8 of an f32 (64 x SP) accumulator into a [kTok][SP +
// 8] share in this block's shared memory.  Every thread runs it, whatever
// its rows (see store_rows).
template <int SP>
__device__ __forceinline__ void local_share(float* share, int ra,
                                            const float (&acc)[SP / 2]) {
  float v[SP / 2];
#pragma unroll
  for (int i = 0; i < SP / 2; ++i) v[i] = acc[i];
  fence_regs(v);
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < SP / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(share + (ra + 8 * half) * (SP + 8) + 8 * n
                                 + 2 * tq) =
          make_float2(v[4 * n + 2 * half], v[4 * n + 2 * half + 1]);
}

// The cluster's sum of its heads' shares of this block's rows (rank P ..
// rank P + P - 1, those below len), each row's shares in rank order, from
// the buffer `recv` (rank p's share of row r at row p P + r - rank P,
// `stride` floats a row) into `out` (share_out's).
template <int SP>
__device__ __forceinline__ void sum_shares(const float* recv, float* out,
                                           const Shape& sh, int len,
                                           int stride) {
  const int nrank = cluster_blocks(), rank = cluster_rank(), ds = sh.ds;
  const int per = (kTok + nrank - 1) / nrank, r0 = rank * per;
  const int rows = min(len, r0 + per) - r0, n4 = ds / 4;
  const int64_t out_row = static_cast<int64_t>(sh.nh / nrank) * ds;
  for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
    const int lr = e / n4, c = 4 * (e % n4);
    const float* p = recv + lr * stride + c;
    float4 v = *reinterpret_cast<const float4*>(p);
    for (int k = 1; k < nrank; ++k) {
      const float4 u =
          *reinterpret_cast<const float4*>(p + k * per * stride);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(out + (r0 + lr) * out_row + c) = v;
  }
}

// Warpgroup wg's tokens as rows i: dc = W b + e (gy H) into acc (zero on
// entry), sum_j F_ij, v, and a share of sum_i gy_i . x_i into dd (the
// diagonal of GY X^T); returns the thread's share of sum F_ij (cum_i -
// cum_j).  Both warpgroups run one copy of the code (a copy a warpgroup
// measured slower).  In the accumulators the thread holds rows ra and ra
// + 8 of the warpgroup's 64 and, in every 8-column group, columns 2 tq and
// 2 tq + 1 (register 4 n + e: column 8 n + 2 tq + (e & 1) of row ra, or of
// rb where e & 2).
template <int HP, int SP>
__device__ __forceinline__ float rows_i(const WgCtx& c, int wg,
                                        float (&acc)[SP / 2], float& dd) {
  if (64 * wg >= c.len) {
    warp_done_with(c.ready_c);
    return 0.f;
  }
  const int tw = threadIdx.x & 127, tq = tw & 3;
  const int r0 = 64 * wg;
  const int len = c.len, ds = c.ds;
  const int ra = r0 + 16 * (tw >> 5) + ((tw & 31) >> 2), rb = ra + 8;
  const Cum<double>& cm = c.cm;
  const Tok& tk = c.tk;
  const bf16* cs = c.cs;
  const uint32_t ux = c.ux, ug = c.ug, ub = c.ub, uc = c.uc;
  const float2 ka = ra < len ? tk.c2[ra] : make_float2(0.f, 0.f);
  const float2 kb = rb < len ? tk.c2[rb] : make_float2(0.f, 0.f);
  const uint32_t uhh = c.uhh, uhl = c.uhl;
  const bool has_h = c.has_h;
  float pair = 0.f;
  if (has_h) {
    // gy H: A gy (rows i, K-major over p), B H ([p][s]: MN-major)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      wg_ss<SP, 1>(acc, kdesc<kTok>(ug, r0, kk), mdesc<HP>(uhh, 16 * kk));
      wg_ss<SP, 1>(acc, kdesc<kTok>(ug, r0, kk), mdesc<HP>(uhl, 16 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    warp_done_with(c.ready_c);          // H is read
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int n = 0; n < SP / 8; ++n) {
      if (8 * n >= ds) continue;          // ds is a multiple of 16
      const int s = 8 * n + 2 * tq;
      const float2 c2a = bf2(cs + sw<kTok>(ra, s));
      const float2 c2b = bf2(cs + sw<kTok>(rb, s));
      va = fmaf(acc[4 * n], c2a.x, fmaf(acc[4 * n + 1], c2a.y, va));
      vb = fmaf(acc[4 * n + 2], c2b.x, fmaf(acc[4 * n + 3], c2b.y, vb));
    }
    va = quad_sum(va);
    vb = quad_sum(vb);
    if (tq == 0) {
      if (ra < len) tk.vv[ra] = va;
      if (rb < len) tk.vv[rb] = vb;
    }
    const float ea = ra < len ? tk.ev[ra] : 0.f;
    const float eb = rb < len ? tk.ev[rb] : 0.f;
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) acc[i] *= (i & 2) ? eb : ea;
  } else {
    warp_done_with(c.ready_c);
  }
  float rfa = 0.f, rfb = 0.f;
  for (int jb = 0; jb <= wg; ++jb) {    // the j blocks up to the rows
    // C B^T (K over ds) and GY X^T (K over hd), rows i, columns j
    float s1[32], s2[32];
    zero(s1);
    zero(s2);
    fence_regs(s1);
    fence_regs(s2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk)
      wg_ss<64, 0>(s1, kdesc<kTok>(uc, r0, kk),
                   kdesc<kTok>(ub, 64 * jb, kk));
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      wg_ss<64, 0>(s2, kdesc<kTok>(ug, r0, kk),
                   kdesc<kTok>(ux, 64 * jb, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s1);
    fence_regs(s2);
    // W = gy.x E dt_j into s2; F = (c.b) W.  Selects, not branches:
    // the accumulators are touched in no divergent path, which would
    // make ptxas serialise every wgmma
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool lower = (e & 2) != 0;
      const int i = lower ? rb : ra;
      const int j = 64 * jb + 8 * (e >> 2) + 2 * tq + (e & 1);
      const bool keep = j <= i && i < len;
      const int jk = keep ? j : 0;
      dd += keep && j == i ? s2[e] : 0.f;     // gy_i . x_i
      const float sg = keep ? cum_diff(lower ? kb : ka, tk.c2[jk]) : 0.f;
      const float wv = keep ? s2[e] * __expf(sg) * cm.dtv[jk] : 0.f;
      const float fv = s1[e] * wv;
      if (lower) rfb += fv; else rfa += fv;
      pair = fmaf(fv, sg, pair);
      s2[e] = wv;
    }
    uint32_t wh[4][4], wl[4][4];
    split_acc(s2, wh, wl);
    // W b: B b ([j][s]: MN-major), its rows 64 jb .. 64 jb + 63
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_rs<SP>(acc, wh[kk], mdesc<kTok>(ub, 64 * jb + 16 * kk));
      wg_rs<SP>(acc, wl[kk], mdesc<kTok>(ub, 64 * jb + 16 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  rfa = quad_sum(rfa);
  rfb = quad_sum(rfb);
  if (tq == 0) {
    if (ra < len) tk.rowf[ra] = rfa;
    if (rb < len) tk.rowf[rb] = rfb;
  }
  return pair;
}

// Warpgroup wg's tokens as rows j: dx = M^T gy + d_skip gy + w (b dS^T),
// db = W^T c + w (x dS) into adb (zero on entry), sum_i T_ij, u (the
// layout of rows_i); says on kBarReadyB when the warp has read the tiles
// for the last time, before its dx stores.
template <int HP, int SP>
__device__ __forceinline__ void rows_j(const WgCtx& c, int wg,
                                       float (&adb)[SP / 2]) {
  if (64 * wg >= c.len) {
    warp_done_with(c.ready_b);
    return;
  }
  const int tw = threadIdx.x & 127, tq = tw & 3;
  const int r0 = 64 * wg;
  const int len = c.len, hd = c.hd;
  const int ra = r0 + 16 * (tw >> 5) + ((tw & 31) >> 2), rb = ra + 8;
  const Cum<double>& cm = c.cm;
  const Tok& tk = c.tk;
  const Chunk& ch = c.ch;
  const bf16 *xs = c.xs, *gs = c.gs;
  const uint32_t ux = c.ux, ug = c.ug, ub = c.ub, uc = c.uc;
  const float2 ka = ra < len ? tk.c2[ra] : make_float2(0.f, 0.f);
  const float2 kb = rb < len ? tk.c2[rb] : make_float2(0.f, 0.f);
  const uint32_t udh = c.udh, udl = c.udl;
  const int nblk = (len + 63) / 64;       // 64-token blocks that hold tokens
  const float* d_skip = c.d_skip;
  bf16* dx = c.dx;
  const int64_t xo = c.xo, x_row = c.x_row;
  // b dS^T: A b (rows j, K-major over s), B dS^T (dS [p][s]: K-major);
  // x dS: A x (K-major over p), B dS (MN-major)
  float adx[HP / 2];
  zero(adx);
  fence_regs(adx);
  fence_regs(adb);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SP / 16; ++kk) {
    wg_ss<HP, 0>(adx, kdesc<kTok>(ub, r0, kk), kdesc<HP>(udh, 0, kk));
    wg_ss<HP, 0>(adx, kdesc<kTok>(ub, r0, kk), kdesc<HP>(udl, 0, kk));
  }
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk) {
    wg_ss<SP, 1>(adb, kdesc<kTok>(ux, r0, kk), mdesc<HP>(udh, 16 * kk));
    wg_ss<SP, 1>(adb, kdesc<kTok>(ux, r0, kk), mdesc<HP>(udl, 16 * kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(adx);
  fence_regs(adb);
  float ua = 0.f, ub_ = 0.f;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    if (8 * n >= hd) continue;            // hd is a multiple of 16
    const int p = 8 * n + 2 * tq;
    const float2 xa = bf2(xs + sw<kTok>(ra, p));
    const float2 xb = bf2(xs + sw<kTok>(rb, p));
    ua = fmaf(adx[4 * n], xa.x, fmaf(adx[4 * n + 1], xa.y, ua));
    ub_ = fmaf(adx[4 * n + 2], xb.x, fmaf(adx[4 * n + 3], xb.y, ub_));
  }
  ua = quad_sum(ua);
  ub_ = quad_sum(ub_);
  if (tq == 0) {
    if (ra < len) tk.uu[ra] = ua;
    if (rb < len) tk.uu[rb] = ub_;
  }
  const float wa = ra < len ? tk.wv[ra] : 0.f;
  const float wb = rb < len ? tk.wv[rb] : 0.f;
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) adx[i] *= (i & 2) ? wb : wa;
#pragma unroll
  for (int i = 0; i < SP / 2; ++i) adb[i] *= (i & 2) ? wb : wa;
  const float dta = ra < len ? cm.dtv[ra] : 0.f;
  const float dtb = rb < len ? cm.dtv[rb] : 0.f;
  float cta = 0.f, ctb = 0.f;
  for (int ib = wg; ib < nblk; ++ib) {  // the i blocks from the rows on
    // B C^T (K over ds) and X GY^T (K over hd), rows j, columns i
    float bc[32], xg[32];
    zero(bc);
    zero(xg);
    fence_regs(bc);
    fence_regs(xg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk)
      wg_ss<64, 0>(bc, kdesc<kTok>(ub, r0, kk),
                   kdesc<kTok>(uc, 64 * ib, kk));
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      wg_ss<64, 0>(xg, kdesc<kTok>(ux, r0, kk),
                   kdesc<kTok>(ug, 64 * ib, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(bc);
    fence_regs(xg);
    // M^T_ji = (b.c) E dt_j into bc, W^T_ji = (x.gy) E dt_j into xg;
    // T_ji = (b.c) E (x.gy)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool lower = (e & 2) != 0;
      const int j = lower ? rb : ra;
      const int i = 64 * ib + 8 * (e >> 2) + 2 * tq + (e & 1);
      const bool keep = i >= j && i < len;
      const float ee =
          keep ? __expf(cum_diff(tk.c2[keep ? i : 0], lower ? kb : ka))
               : 0.f;
      const float dtj = lower ? dtb : dta;
      const float be = bc[e] * ee;
      if (lower) ctb = fmaf(be, xg[e], ctb); else cta = fmaf(be, xg[e], cta);
      bc[e] = be * dtj;
      xg[e] = xg[e] * ee * dtj;
    }
    uint32_t mh[4][4], ml[4][4], wh[4][4], wl[4][4];
    split_acc(bc, mh, ml);
    split_acc(xg, wh, wl);
    // M^T gy: B gy ([i][p]: MN-major); W^T c: B c ([i][s]: MN-major)
    fence_regs(adx);
    fence_regs(adb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_rs<HP>(adx, mh[kk], mdesc<kTok>(ug, 64 * ib + 16 * kk));
      wg_rs<HP>(adx, ml[kk], mdesc<kTok>(ug, 64 * ib + 16 * kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_rs<SP>(adb, wh[kk], mdesc<kTok>(uc, 64 * ib + 16 * kk));
      wg_rs<SP>(adb, wl[kk], mdesc<kTok>(uc, 64 * ib + 16 * kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adx);
    fence_regs(adb);
  }
  cta = quad_sum(cta);
  ctb = quad_sum(ctb);
  if (tq == 0) {
    if (ra < len) tk.colt[ra] = cta;
    if (rb < len) tk.colt[rb] = ctb;
  }
  // dx = adx + d_skip gy, in registers first (see store_rows)
  const float dsk = d_skip[ch.h];
  uint32_t dxo[HP / 4];
#pragma unroll
  for (int n = 0; n < HP / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 g2 = bf2(gs + sw<kTok>(half ? rb : ra, 8 * n + 2 * tq));
      dxo[2 * n + half] =
          pack_bf16(fmaf(dsk, g2.x, adx[4 * n + 2 * half]),
                    fmaf(dsk, g2.y, adx[4 * n + 2 * half + 1]));
    }
  fence_u32(dxo);
  warp_done_with(c.ready_b);          // x, gy, b and c are read
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    if (8 * n >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = half ? rb : ra;
      if (j < len)
        *reinterpret_cast<uint32_t*>(dx + xo + j * x_row + 8 * n + 2 * tq) =
            dxo[2 * n + half];
    }
  }
}

// HP = hd and SP = ds padded to 64 or 128; launched in clusters of C
// blocks (C consecutive heads of one group, C dividing nh / ng; always
// with a cluster dimension, 1 too: it runs cluster instructions), shares
// (B, S, nh / C, ds).  With `tma`, b and c come by tm_b and tm_c (boxes
// of 64 columns x 16 rows), each box loaded by one rank for the cluster;
// else each block stages them itself.
template <int HP, int SP>
__global__ void __launch_bounds__(kThreads, 1)
chunk_bwd_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_log, const bf16* __restrict__ bm,
             const bf16* __restrict__ cmat, const float* __restrict__ d_skip,
             const bf16* __restrict__ gy, const float* __restrict__ hin,
             const float* __restrict__ dst, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ dalog_part,
             float* __restrict__ dd_part, Shape sh,
             const __grid_constant__ CUtensorMap tm_b,
             const __grid_constant__ CUtensorMap tm_c, int32_t tma) {
  using L = WgLayout<HP, SP>;
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds, len = ch.len;
  const Cum<double> cm = cum_at<double>(smem, q);
  const Tok tk = tok_at(past_cum<double>(smem, q), q);
  char* const bars_at = past_cum<double>(smem, q) + tok_bytes(q);
  const uint32_t bars = smem_addr(bars_at);
  char* const head_end = bars_at + kBarBytes;
  const uint32_t base = (smem_addr(head_end) + 1023u) & ~1023u;
  char* const tiles = head_end + (base - smem_addr(head_end));
  bf16* xs = reinterpret_cast<bf16*>(tiles + L::kX);
  bf16* gs = reinterpret_cast<bf16*>(tiles + L::kG);
  bf16* bs = reinterpret_cast<bf16*>(tiles + L::kB);
  bf16* cs = reinterpret_cast<bf16*>(tiles + L::kC);
  bf16* hh = reinterpret_cast<bf16*>(tiles + L::kH);
  bf16* hl = hh + HP * SP;
  bf16* dh = reinterpret_cast<bf16*>(tiles + L::kDs);
  bf16* dl = dh + HP * SP;
  const uint32_t ux = base + L::kX, ug = base + L::kG, ub = base + L::kB,
                 uc = base + L::kC, uhh = base + L::kH,
                 uhl = uhh + L::kStBytes, udh = base + L::kDs,
                 udl = udh + L::kStBytes;

  // rank r owns rows r P .. r P + P - 1 of the shares
  const int nrank = cluster_blocks(), rank = cluster_rank();
  const int per = (kTok + nrank - 1) / nrank;
  const int own = min(kTok, (rank + 1) * per) - rank * per;
  if (threadIdx.x == 0) {
    mbar_init(bars + 8 * kBarBc, 1);
    mbar_init(bars + 8 * kBarReadyC, kWarps * nrank);
    mbar_init(bars + 8 * kBarFullC, 1);
    mbar_init(bars + 8 * kBarReadyB, kWarps * nrank);
    mbar_init(bars + 8 * kBarFullB, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // what comes: the boxes of b and c of the chunk's q rows (every rank's
    // loads reach every block), and every block's share of this block's
    // rows of dc (its first ds columns) and of db (whole padded rows)
    mbar_expect_tx(bars + 8 * kBarBc, tma ? q * SP * 4 : 0);
    mbar_expect_tx(bars + 8 * kBarFullC, own * ds * 4 * nrank);
    mbar_expect_tx(bars + 8 * kBarFullB, own * L::kShareRow * 4 * nrank);
  }
  cluster_arrive_relaxed();

  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  stage_sw<kTok, HP>(xs, x + xo, x_row, len, hd, 0, kTok, threadIdx.x,
                     kThreads);
  stage_sw<kTok, HP>(gs, gy + xo, x_row, len, hd, 0, kTok, threadIdx.x,
                     kThreads);
  if (tma) {
    // rows q .. kTok - 1 of b and c, which no box covers: zeros
    for (int i = q * (SP / 8) + threadIdx.x; i < kTok * (SP / 8);
         i += kThreads) {
      const int at = sw<kTok>(i / (SP / 8), 8 * (i % (SP / 8)));
      *reinterpret_cast<uint4*>(bs + at) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(cs + at) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
    const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                       + static_cast<int64_t>(ch.g) * ds;
    stage_sw<kTok, SP>(bs, bm + bo, b_row, len, ds, 0, kTok, threadIdx.x,
                       kThreads);
    stage_sw<kTok, SP>(cs, cmat + bo, b_row, len, ds, 0, kTok, threadIdx.x,
                       kThreads);
  }
  // the states: dS and H together where both fit, else H now and dS once
  // the rows i are done (H_0 = 0)
  const bool has_h = ch.k > 0;
  const float* hk = hin + ch.idx * hd * ds;
  const float* sk = dst + ch.idx * hd * ds;
  float dsh = 0.f;                        // a share of <dS, H>
  if (L::kBoth)
    dsh = split_state<HP, SP>(sk, has_h ? hk : nullptr, dh, dl,
                              has_h ? hh : nullptr, hl, hd, ds);
  else if (has_h)
    split_state<HP, SP>(hk, nullptr, hh, hl, nullptr, nullptr, hd, ds);
  cluster_wait();                 // every peer's mbarriers are set up
  if (tma && threadIdx.x == 0) {
    // this rank's boxes of the cluster's: every nrank-th of 2 (b, c) x
    // SP / 64 column boxes x q / 16 row boxes, to every rank
    const int cols = SP / 64, boxes = 2 * cols * (q / 16);
    const uint16_t all = static_cast<uint16_t>((1u << nrank) - 1u);
    for (int i = rank; i < boxes; i += nrank) {
      const int t = i & 1, cb = (i >> 1) % cols, rb = (i >> 1) / cols;
      tma_multicast_4d((t ? uc : ub) + cb * kTok * kRowBytes
                           + rb * 16 * kRowBytes,
                       t ? &tm_c : &tm_b, bars + 8 * kBarBc, 64 * cb, ch.g,
                       ch.t0 + 16 * rb, ch.bi, all);
    }
  }
  const float a_neg = -expf(a_log[ch.h]);
  chunk_cum(dt, sh, ch, a_neg, cm);
  chunk_tokens(cm, tk, q);
  cp_async_wait_all();
  fence_async_smem();                     // the staged tiles, for wgmma
  __syncthreads();
  mbar_wait_cluster(bars + 8 * kBarBc);   // the cluster's loads of b and c

  const WgCtx wc{cm, tk, ch, xs, gs, cs, ux, ug, ub, uc, uhh, uhl, udh,
                 udl, bars + 8 * kBarReadyC, bars + 8 * kBarReadyB, d_skip,
                 dx, xo, x_row, len, hd, ds, has_h};
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across the warp
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x >> 7), 0);
  float acc[SP / 2];
  zero(acc);
  float dd = 0.f;                         // a share of sum gy . x
  // sum F_ij (cum_i - cum_j), a share.  The warpgroups take the halves of
  // the Q x Q products in other orders (rows i: 1 block, then 2; rows j:
  // 2, then 1), so they meet at no barrier between the two.
  const float pair = rows_i<HP, SP>(wc, wg, acc, dd);
  // dc's shares: from registers into the buffers of their rows' owners,
  // once every block of the cluster has read its H (rows_i says so, warp
  // by warp); they travel while rows j run
  mbar_wait_cluster(bars + 8 * kBarReadyC);
  push_share<SP>(base + L::kRecvC, bars + 8 * kBarFullC, share_row0(wg), ds,
                 acc);
  float* const recv_c = reinterpret_cast<float*>(tiles + L::kRecvC);
  if (!L::kBoth) {
    // dS goes where dc's buffer is: sum the shares first
    mbar_wait_cluster(bars + 8 * kBarFullC);
    sum_shares<SP>(recv_c, share_out(dc_part, sh, ch), sh, len,
                   L::kShareRow);
    __syncthreads();                      // the buffer is read
    dsh = split_state<HP, SP>(sk, has_h ? hk : nullptr, dh, dl, nullptr,
                              nullptr, hd, ds);
    fence_async_smem();
    __syncthreads();
  }

  zero(acc);
  rows_j<HP, SP>(wc, wg, acc);
  if (L::kBoth) {
    mbar_wait_cluster(bars + 8 * kBarFullC);
    sum_shares<SP>(recv_c, share_out(dc_part, sh, ch), sh, len,
                   L::kShareRow);
  }
  __syncthreads();                        // dc's buffer (or dS's tiles) read
  // db's share: into this block's shared memory where dc's buffer was,
  // then by bulk copies into the owners' buffers over x, gy, b and c,
  // while chunk_finish runs
  local_share<SP>(recv_c, share_row0(wg), acc);
  fence_async_smem();
  __syncthreads();
  mbar_wait_cluster(bars + 8 * kBarReadyB);
  if (threadIdx.x == 0) {
    for (int o = 0; o < nrank; ++o) {
      const uint32_t rows = min(kTok, (o + 1) * per) - o * per;
      bulk_to_peer(
          peer_addr(base + L::kRecvB + rank * per * L::kShareRow * 4, o),
          base + L::kRecvC + o * per * L::kShareRow * 4,
          rows * L::kShareRow * 4, peer_addr(bars + 8 * kBarFullB, o));
    }
    bulk_commit();
  }
  chunk_finish(cm, tk, ch, sh, a_neg, pair, dsh, dd, ddt, dalog_part, dd_part);
  mbar_wait_cluster(bars + 8 * kBarFullB);
  sum_shares<SP>(reinterpret_cast<const float*>(tiles + L::kRecvB),
                 share_out(db_part, sh, ch), sh, len, L::kShareRow);
  if (threadIdx.x == 0) bulk_wait_read();  // the copies have read the share
}

// ---- the CUDA-core route: split TF32 on mma.sync --------------------------
//
// (The design is in the note at the top.)  Every product is mma.sync
// m16n8k8 TF32 with each f32 operand split, x = hi + lo, hi rounded as
// cvt.rna rounds and lo left whole (the tensor cores read its 19 high
// bits), and a . b = lo.hi + hi.lo + hi.hi summed in f32, as B7's f32
// backward does (tf32::, common.cuh).  A bf16 operand is TF32 exactly: its
// lo is zero and the products with it are dropped.  Warp w owns rows 16 w
// .. 16 w + 15 of every product (tokens in the chunk pass); thread (g, t)
// = (lane / 4, lane % 4) holds rows g and g + 8 at columns 2t and 2t + 1
// of each n tile of 8 columns.  Operands stage by cp.async into two
// buffers in turn, zero past the chunk's tokens and past each width, and
// every k step runs on the padded width, a multiple of 8.

namespace tf = repro_torch::tf32;

constexpr bool kRoundLo = false;   // lo left whole (B7's bwd::kRoundLo)
constexpr int kKs = 64;            // k columns of a slice of a width
constexpr int kKt = kKs / 8;       // its k tiles
constexpr int kLdK = kKs + 4;      // its row stride: 4 (mod 32) words
constexpr int kTiles = kTok / 8;   // n tiles of the widest product

template <typename T> constexpr bool kExact = false;   // TF32 exactly
template <> constexpr bool kExact<bf16> = true;

__host__ __device__ inline int pad8(int w) { return (w + 7) / 8 * 8; }
// The row stride (elements) of a tile of width w read as B (k, n) with k
// the row: 8 (mod 32), so that a k step's reads at rows t and t + 4
// (`warp_ss`) of f32 fall in 32 banks; 4 (mod 32) where a step reads rows
// 2t and 2t + 1 (`warp_ab`: the chunk pass's kHalf + 4).
__host__ __device__ inline int ld_kn(int w) { return (w + 31) / 32 * 32 + 8; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N> __device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// rows x cols of a row-major source (`stride` elements a row) into a
// shared tile of `ld` elements a row, rows at or past `vrows` and columns
// at or past `vcols` zero.  Every thread calls it; the copies are
// cp.async (`stage`), which the caller commits and waits on.
template <typename T>
__device__ __forceinline__ void stage_win(T* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int vrows, int cols, int vcols) {
  stage(dst, ld, src, stride, rows, vrows, vcols);
  const int pad = cols - vcols;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads)
    dst[(i / pad) * ld + vcols + i % pad] = from_f32<T>(0.f);
}

// Step s of a product's k loop over `n` staged slices, the block's:
// load(s, buf) issues slice s's copies into buffer buf (0 or 1).  At s = 0
// it issues slice 0's; it issues slice s + 1's, waits for slice s's and
// meets the block at a barrier; false past the last slice.  The caller
// multiplies slice s (buffer s & 1) while slice s + 1 is in flight and
// ends each step at a barrier, so the buffers are free after the loop:
//   for (int s = 0; k_step(s, n, load); ++s) { ...; __syncthreads(); }
// (the products stay in the loop's body: an accumulator taken by reference
// into a lambda that is not inlined would live in local memory).
template <typename Load>
__device__ __forceinline__ bool k_step(int s, int n, const Load& load) {
  if (s >= n) return false;
  if (s == 0) {
    load(0, 0);
    cp_async_commit();
  }
  if (s + 1 < n) {
    load(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return true;
}

// Readers of a shared tile of `ld` elements a row, as f32: at (row, col),
// and transposed (at (k, n), row n, column k).
template <typename T>
__device__ __forceinline__ auto at_rc(const T* p, int ld) {
  return [=](int r, int c) { return to_f32(p[r * ld + c]); };
}
template <typename T>
__device__ __forceinline__ auto at_cr(const T* p, int ld) {
  return [=](int k, int n) { return to_f32(p[n * ld + k]); };
}

// x as the split pair (hi, lo); lo zero where x is TF32 already.
template <bool kEx>
__device__ __forceinline__ void tsplit(float x, uint32_t& hi, uint32_t& lo) {
  if (kEx) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    tf::split<kRoundLo>(x, hi, lo);
  }
}

// d += a . b of split operands (b's k indices t and t + 4 in bh[0], bh[1]):
// the small terms first, then hi . hi; a term with an exact factor's lo
// is dropped.
template <bool kExA, bool kExB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if (!kExA) tf::mma(d, al, bh[0], bh[1]);
  if (!kExB) tf::mma(d, ah, bl[0], bl[1]);
  tf::mma(d, ah, bh[0], bh[1]);
}

// The `ss` form: acc (the warp's 16 rows x kN n tiles) += A . B over `ks`
// k steps of 8, A (16 x 8 ks) through fa(r, k) (r the warp's row) and B
// (8 ks x 8 kN) through fb(k, n), both in shared memory; n tiles [n0, n1)
// only.  kExA, kExB: the operand is TF32 exactly.
template <bool kExA, bool kExB, int kN, typename FA, typename FB>
__device__ __forceinline__ void warp_ss(float (&acc)[kN][4], const FA& fa,
                                        const FB& fb, int ks, int n0,
                                        int n1) {
  if (n0 >= n1) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < 8 * ks; k += 8) {
    uint32_t ah[4], al[4];
    tsplit<kExA>(fa(g, k + t), ah[0], al[0]);
    tsplit<kExA>(fa(g + 8, k + t), ah[1], al[1]);
    tsplit<kExA>(fa(g, k + t + 4), ah[2], al[2]);
    tsplit<kExA>(fa(g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n < n0 || n >= n1) continue;
      uint32_t bh[2], bl[2];
      tsplit<kExB>(fb(k + t, 8 * n + g), bh[0], bl[0]);
      tsplit<kExB>(fb(k + t + 4, 8 * n + g), bh[1], bl[1]);
      mma_split<kExA, kExB>(acc[n], ah, al, bh, bl);
    }
  }
}

// The `ab` form: c (16 x 8 kN) += P . B, P the warp's f32 accumulator
// fragments of an earlier product (16 x 8 kK) fed straight from registers
// as A, k tiles [k0, k1); B through fb(k, n), n tiles below n1.  Tile kk
// holds P's columns 2t and 2t + 1 where A wants k indices t and t + 4, so
// the k step is permuted and B's rows 8 kk + 2t and 8 kk + 2t + 1 are read
// in their place (flash_attention.cu's `ab`).
template <bool kExB, int kK, int kN, typename FB>
__device__ __forceinline__ void warp_ab(float (&c)[kN][4],
                                        const float (&p)[kK][4],
                                        const FB& fb, int k0, int k1,
                                        int n1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    if (kk < k0 || kk >= k1) continue;
    uint32_t ah[4], al[4];
    tf::split_a<kRoundLo>(p[kk][0], p[kk][2], p[kk][1], p[kk][3], ah, al);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n >= n1) continue;
      uint32_t bh[2], bl[2];
      tsplit<kExB>(fb(8 * kk + 2 * t, 8 * n + g), bh[0], bl[0]);
      tsplit<kExB>(fb(8 * kk + 2 * t + 1, 8 * n + g), bh[1], bl[1]);
      mma_split<false, kExB>(c[n], ah, al, bh, bl);
    }
  }
}

// ---- chunk pass, split TF32 ------------------------------------------------

constexpr int kHalf = 64;                  // output columns a pass of a width
constexpr int kHalfTiles = kHalf / 8;
// One buffer: a slice pair, [kTok][kLdK] f32 each (A, then B).
constexpr size_t kTileF = static_cast<size_t>(kTok) * kLdK;
constexpr size_t kBufBytes = 2 * kTileF * 4;
// C B^T's fragments, parked thread by thread while GY X^T is summed; then
// a share of db or dc, [q][ld_share(ds)] f32, while it is summed across a
// cluster.
constexpr size_t kParkBytes = static_cast<size_t>(kTok) * (kTok + 8) * 4;

// The row stride (floats) of a share of db or dc in shared memory.
__host__ __device__ inline int ld_share(int ds) { return pad8(ds) + 8; }

// Shared: the cum head, the per-token scratch, T's column shares
// [kWarps][q] f32, the two buffers, then the park.
__host__ __device__ inline size_t chunk_tf_head(int q) {
  return (cum_bytes<double>(q) + tok_bytes(q)
          + 4 * static_cast<size_t>(kWarps) * q + 15) / 16 * 16;
}
inline size_t chunk_tf_smem(int q) {
  return chunk_tf_head(q) + 2 * kBufBytes + kParkBytes;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Columns c0 .. c0 + 8 kN - 1 of this block's share of db or dc (the
// warps' fragments of rows below len, columns below ds): into `out`
// (share_out's) in a cluster of one, else into `shr` (rows of
// ld_share(ds) floats) for `sum_cluster`.
template <int kN>
__device__ __forceinline__ void put_rows(const float (&acc)[kN][4],
                                         float* out, float* shr,
                                         const Shape& sh, int len, int r0,
                                         int c0) {
  const int nrank = cluster_blocks(), ds = sh.ds;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* dst = nrank == 1 ? out : shr;
  const int64_t stride =
      nrank == 1 ? static_cast<int64_t>(sh.nh / nrank) * ds : ld_share(ds);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), s = c0 + 8 * n + 2 * t + (e & 1);
      if (i < len && s < ds) dst[i * stride + s] = acc[n][e];
    }
}

// In a cluster of C > 1 blocks, after `put_rows`: each block sums its rows
// of the C shares, P = ceil(len / C) rows a rank, in rank order, from the
// blocks' shared memory into `out`; barriers before (the shares are in
// place) and after (the peers have read them).  Every thread calls it.
__device__ __forceinline__ void sum_cluster(float* out, float* shr,
                                            const Shape& sh, int len) {
  const int nrank = cluster_blocks(), ds = sh.ds;
  if (nrank == 1) return;
  const int64_t orow = static_cast<int64_t>(sh.nh / nrank) * ds;
  const int ls = ld_share(ds);
  cluster_sync();
  const int rank = cluster_rank(), per = (len + nrank - 1) / nrank;
  const int row0 = rank * per, rows = max(0, min(len, row0 + per) - row0);
  const uint32_t base = smem_addr(shr);
  if (ds % 4 == 0) {
    const int n4 = ds / 4;
    for (int e = threadIdx.x; e < rows * n4; e += kThreads) {
      const int r = row0 + e / n4, c = 4 * (e % n4);
      const uint32_t at = base + 4u * (r * ls + c);
      float4 v = ld_cluster4(peer_addr(at, 0));
      for (int k = 1; k < nrank; ++k) {
        const float4 u = ld_cluster4(peer_addr(at, k));
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(out + r * orow + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * ds; e += kThreads) {
      const int r = row0 + e / ds, c = e % ds;
      const uint32_t at = base + 4u * (r * ls + c);
      float v = ld_cluster(peer_addr(at, 0));
      for (int k = 1; k < nrank; ++k) v += ld_cluster(peer_addr(at, k));
      out[r * orow + c] = v;
    }
  }
  cluster_sync();
}

// The warp's rows r (r0 + g and r0 + 8 + g) of acc times v[r] (zero where
// the warp holds no tokens).
template <int kN>
__device__ __forceinline__ void scale_rows(float (&acc)[kN][4],
                                           const float* v, int r0,
                                           bool rows) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = rows ? v[r0 + g + 8 * h] : 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][2 * h] *= m;
      acc[n][2 * h + 1] *= m;
    }
  }
}

// p (rows j, columns i, n tiles [n0, n1)) into p_ji E_ij dt_j for i >= j,
// zero above: B C^T into M^T, X GY^T into W^T.
__device__ __forceinline__ void to_upper(float (&p)[kTiles][4], const Tok& tk,
                                         const Cum<double>& cm, int r0,
                                         int n0, int n1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    if (n < n0 || n >= n1) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = r0 + g + 8 * (e >> 1), i = 8 * n + 2 * t + (e & 1);
      p[n][e] = i >= j ? p[n][e] * expf(cum_diff(tk.c2[i], tk.c2[j]))
                             * cm.dtv[j]
                       : 0.f;
    }
  }
}

// The chunk pass of the CUDA-core route (the design is in the note at the
// top): a block per (batch row, chunk, head) in clusters of C heads, warp
// w rows 16 w .. 16 w + 15 of the chunk, first as rows i, then as rows j;
// every product of a width runs 64 output columns at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
chunk_bwd_tf(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ a_log, const T* __restrict__ bm,
             const T* __restrict__ cmat, const float* __restrict__ d_skip,
             const T* __restrict__ gy, const float* __restrict__ hin,
             const float* __restrict__ dst, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ db_part,
             float* __restrict__ dc_part, float* __restrict__ dalog_part,
             float* __restrict__ dd_part, Shape sh) {
  constexpr bool kEx = kExact<T>;
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds, len = ch.len;
  const Cum<double> cm = cum_at<double>(smem, q);
  const Tok tk = tok_at(past_cum<double>(smem, q), q);
  float* const colpart =
      reinterpret_cast<float*>(past_cum<double>(smem, q) + tok_bytes(q));
  char* const bufs = reinterpret_cast<char*>(smem) + chunk_tf_head(q);
  float* const park = reinterpret_cast<float*>(bufs + 2 * kBufBytes);
  auto tile_a = [=](int b) {
    return reinterpret_cast<T*>(bufs + b * kBufBytes);
  };
  auto tile_b = [=](int b) {
    return reinterpret_cast<float*>(bufs + b * kBufBytes) + kTileF;
  };
  auto tile_bt = [=](int b) { return reinterpret_cast<T*>(tile_b(b)); };

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
  for (int i = threadIdx.x; i < kWarps * q; i += kThreads) colpart[i] = 0.f;

  // warp w's row tile: w and 11 - w, so that the two warps of a
  // scheduler (w and w + 4) hold tiles r and 7 - r, whose causal halves
  // sum to the same work in either orientation
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = w < 4 ? w : 11 - w;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * rt;
  const bool rows = r0 < len;             // the warp holds tokens
  const int nt = (len + 7) / 8;           // token tiles
  const int hdp = pad8(hd), dsp = pad8(ds);
  const int nhs = (hd + kKs - 1) / kKs, nds = (ds + kKs - 1) / kKs;
  const int nts = (len + kKs - 1) / kKs;  // token slices
  constexpr int kLh = kHalf + 8;          // ld_kn(kHalf)
  constexpr int kLa = kHalf + 4;          // an `ab` B tile's stride
  // k steps of slice s of a padded width
  auto steps = [](int wp, int s) { return min(kKs, wp - kKs * s) / 8; };
  // the chunk's tokens (zero past len) x columns kKs s .. of a width
  auto tok_cols = [=](T* tile, const T* src, int64_t stride, int width,
                      int s) {
    const int c0 = kKs * s;
    stage_win(tile, kLdK, src + c0, stride, q, len, kKs,
              min(kKs, width - c0));
  };
  // tokens kKs s .. (zero past len) x cw columns, an `ab` B operand
  auto tok_rows = [=](T* tile, const T* src, int64_t stride, int cw,
                      int s) {
    const int t0 = kKs * s;
    stage_win(tile, kLa, src + t0 * stride, stride, kKs, len - t0, pad8(cw),
              cw);
  };
  // the Q x Q products' loads: token rows x a width's slice, twice
  auto ld_cb = [=](int s, int b) {
    tok_cols(tile_a(b), cg, b_row, ds, s);
    tok_cols(tile_bt(b), bg, b_row, ds, s);
  };
  auto ld_bc = [=](int s, int b) {
    tok_cols(tile_a(b), bg, b_row, ds, s);
    tok_cols(tile_bt(b), cg, b_row, ds, s);
  };
  auto ld_gx = [=](int s, int b) {
    tok_cols(tile_a(b), gg, x_row, hd, s);
    tok_cols(tile_bt(b), xg, x_row, hd, s);
  };
  auto ld_xg = [=](int s, int b) {
    tok_cols(tile_a(b), xg, x_row, hd, s);
    tok_cols(tile_bt(b), gg, x_row, hd, s);
  };
  const float dsk = d_skip[ch.h];
  float pair = 0.f, dd = 0.f;
  float* const dc_out = share_out(dc_part, sh, ch);
  float* const db_out = share_out(db_part, sh, ch);

  // -- rows i: C B^T (parked) and GY X^T, then T's sums and W
  const int n1i = rows ? min(2 * rt + 2, nt) : 0;  // tiles j <= i
  float wi[kTiles][4];
  {
    float cb[kTiles][4];
    zero(cb);
    for (int s = 0; k_step(s, nds, ld_cb); ++s) {
      warp_ss<kEx, kEx>(cb, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                        at_cr(tile_bt(s & 1), kLdK), steps(dsp, s), 0, n1i);
      __syncthreads();
    }
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      if (n >= n1i) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        park[(4 * n + e) * kThreads + threadIdx.x] = cb[n][e];
    }
  }
  zero(wi);
  for (int s = 0; k_step(s, nhs, ld_gx); ++s) {
    warp_ss<kEx, kEx>(wi, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                      at_cr(tile_bt(s & 1), kLdK), steps(hdp, s), 0, n1i);
    __syncthreads();
  }
  {
    // T_ij = (C B^T)_ij E_ij (GY X^T)_ij, F = T dt_j, W = (GY X^T) E dt_j
    float rowp[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      if (n >= n1i) continue;
      float colp[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        float wv = 0.f;
        if (j <= i) {
          const float sg = cum_diff(tk.c2[i], tk.c2[j]);
          const float ex = expf(sg), dtj = cm.dtv[j];
          const float tv =
              park[(4 * n + e) * kThreads + threadIdx.x] * ex * wi[n][e];
          const float fv = tv * dtj;
          rowp[e >> 1] += fv;
          colp[e & 1] += tv;
          pair = fmaf(fv, sg, pair);
          wv = wi[n][e] * ex * dtj;
          if (i == j) dd += wi[n][e];        // gy_i . x_i
        }
        wi[n][e] = wv;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {         // over the warp's 16 rows
        colp[c] += __shfl_xor_sync(kFull, colp[c], 4);
        colp[c] += __shfl_xor_sync(kFull, colp[c], 8);
        colp[c] += __shfl_xor_sync(kFull, colp[c], 16);
      }
      if (g == 0) {
        colpart[w * q + 8 * n + 2 * t] = colp[0];
        colpart[w * q + 8 * n + 2 * t + 1] = colp[1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(rowp[h]);
      if (rows && t == 0) tk.rowf[r0 + g + 8 * h] = v;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < q; j += kThreads) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += colpart[k * q + j];
    tk.colt[j] = s;
  }

  // -- dc = e (gy H) + W b, and v = c . (H^T gy), 64 columns at a time
  {
    float vp[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < ds; c0 += kHalf) {
      const int cw = min(kHalf, ds - c0), nn = rows ? pad8(cw) / 8 : 0;
      float acc[kHalfTiles][4];
      zero(acc);
      if (has_h) {
        auto ld = [=](int s, int b) {       // gy, H's rows kKs s ..
          const int p0 = kKs * s;
          tok_cols(tile_a(b), gg, x_row, hd, s);
          stage_win(tile_b(b), kLh, hk + p0 * ds + c0, ds, kKs, hd - p0,
                    pad8(cw), cw);
        };
        for (int s = 0; k_step(s, nhs, ld); ++s) {
          warp_ss<kEx, false>(acc, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                              at_rc(tile_b(s & 1), kLh), steps(hdp, s), 0,
                              nn);
          __syncthreads();
        }
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n) {
          if (n >= nn) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g + 8 * (e >> 1);
            const int s = c0 + 8 * n + 2 * t + (e & 1);
            if (i < len && s < ds)
              vp[e >> 1] = fmaf(acc[n][e], to_f32(cg[i * b_row + s]),
                                vp[e >> 1]);
          }
        }
        scale_rows(acc, tk.ev, r0, rows);
      }
      auto ld = [=](int s, int b) { tok_rows(tile_a(b), bg + c0, b_row, cw, s); };
      for (int s = 0; k_step(s, nts, ld); ++s) {
        warp_ab<kEx>(acc, wi, at_rc(tile_a(s & 1) - kKs * s * kLa, kLa),
                     kKt * s, min(kKt * s + kKt, n1i), nn);
        __syncthreads();
      }
      put_rows(acc, dc_out, park, sh, len, r0, c0);
    }
    if (has_h) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(vp[h]);
        if (rows && t == 0) tk.vv[r0 + g + 8 * h] = v;
      }
    }
  }
  sum_cluster(dc_out, park, sh, len);

  // -- rows j: B C^T into M^T, then dx = w (b dS^T) + M^T gy + d_skip gy
  // and u = x . (dS b), 64 columns at a time
  const int n0j = 2 * rt;                 // tiles i >= j
  float pj[kTiles][4];
  zero(pj);
  for (int s = 0; k_step(s, nds, ld_bc); ++s) {
    warp_ss<kEx, kEx>(pj, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                      at_cr(tile_bt(s & 1), kLdK), steps(dsp, s), n0j, nt);
    __syncthreads();
  }
  to_upper(pj, tk, cm, r0, n0j, nt);
  {
    float up[2] = {0.f, 0.f};
    for (int c0 = 0; c0 < hd; c0 += kHalf) {
      const int cw = min(kHalf, hd - c0), nn = rows ? pad8(cw) / 8 : 0;
      float acc[kHalfTiles][4];
      zero(acc);
      auto ld = [=](int s, int b) {         // b, dS's rows c0 .., columns
        const int k0 = kKs * s;             // kKs s ..
        tok_cols(tile_a(b), bg, b_row, ds, s);
        stage_win(tile_b(b), kLdK, sk + c0 * ds + k0, ds, pad8(cw), cw, kKs,
                  min(kKs, ds - k0));
      };
      for (int s = 0; k_step(s, nds, ld); ++s) {
        warp_ss<kEx, false>(acc, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                            at_cr(tile_b(s & 1), kLdK), steps(dsp, s), 0, nn);
        __syncthreads();
      }
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n) {
        if (n >= nn) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + g + 8 * (e >> 1);
          const int p = c0 + 8 * n + 2 * t + (e & 1);
          if (j < len && p < hd)
            up[e >> 1] = fmaf(acc[n][e], to_f32(xg[j * x_row + p]),
                              up[e >> 1]);
        }
      }
      scale_rows(acc, tk.wv, r0, rows);
      auto lg = [=](int s, int b) { tok_rows(tile_a(b), gg + c0, x_row, cw, s); };
      for (int s = 0; k_step(s, nts, lg); ++s) {
        warp_ab<kEx>(acc, pj, at_rc(tile_a(s & 1) - kKs * s * kLa, kLa),
                     max(kKt * s, n0j), min(kKt * s + kKt, nt), nn);
        __syncthreads();
      }
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + g + 8 * (e >> 1);
          const int p = c0 + 8 * n + 2 * t + (e & 1);
          if (j < len && p < hd)
            dx[xo + j * x_row + p] =
                from_f32<T>(fmaf(dsk, to_f32(gg[j * x_row + p]), acc[n][e]));
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(up[h]);
      if (rows && t == 0) tk.uu[r0 + g + 8 * h] = v;
    }
  }

  // -- rows j: X GY^T into W^T, then db = w (x dS) + W^T c, 64 columns at
  // a time
  zero(pj);
  for (int s = 0; k_step(s, nhs, ld_xg); ++s) {
    warp_ss<kEx, kEx>(pj, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                      at_cr(tile_bt(s & 1), kLdK), steps(hdp, s), n0j, nt);
    __syncthreads();
  }
  to_upper(pj, tk, cm, r0, n0j, nt);
  for (int c0 = 0; c0 < ds; c0 += kHalf) {
    const int cw = min(kHalf, ds - c0), nn = rows ? pad8(cw) / 8 : 0;
    float acc[kHalfTiles][4];
    zero(acc);
    auto ld = [=](int s, int b) {           // x, dS's rows kKs s ..
      const int p0 = kKs * s;
      tok_cols(tile_a(b), xg, x_row, hd, s);
      stage_win(tile_b(b), kLh, sk + p0 * ds + c0, ds, kKs, hd - p0,
                pad8(cw), cw);
    };
    for (int s = 0; k_step(s, nhs, ld); ++s) {
      warp_ss<kEx, false>(acc, at_rc(tile_a(s & 1) + r0 * kLdK, kLdK),
                          at_rc(tile_b(s & 1), kLh), steps(hdp, s), 0, nn);
      __syncthreads();
    }
    scale_rows(acc, tk.wv, r0, rows);
    auto lc = [=](int s, int b) { tok_rows(tile_a(b), cg + c0, b_row, cw, s); };
    for (int s = 0; k_step(s, nts, lc); ++s) {
      warp_ab<kEx>(acc, pj, at_rc(tile_a(s & 1) - kKs * s * kLa, kLa),
                   max(kKt * s, n0j), min(kKt * s + kKt, nt), nn);
      __syncthreads();
    }
    put_rows(acc, db_out, park, sh, len, r0, c0);
  }
  sum_cluster(db_out, park, sh, len);

  float dsh = 0.f;
  if (has_h)
    for (int e = threadIdx.x; e < hd * ds; e += kThreads)
      dsh = fmaf(sk[e], hk[e], dsh);
  chunk_finish(cm, tk, ch, sh, a_neg, pair, dsh, dd, ddt, dalog_part, dd_part);
}

// ---- pass 1: the chunk states, tensor cores (wgmma) -----------------------

constexpr int kStep = 64;        // tokens a step of the states pass

// Byte offsets of a warpgroup's tiles (A hi, A lo: [kStep][HP]; B:
// [kStep][SP]) from a 1024-byte-aligned base; warpgroup 1's follow
// warpgroup 0's.
template <int HP, int SP> struct StLayout {
  static constexpr int kA = kStep * HP * 2;
  static constexpr int kWg = 2 * kA + kStep * SP * 2;
  static constexpr int kBytes = 2 * kWg;
};

template <int HP, int SP> inline size_t states_wg_smem(int q) {
  return cum_bytes<double>(q) + 8 * static_cast<size_t>(q) + 1024
         + StLayout<HP, SP>::kBytes;
}

// S = sum_j w_j x_j b_j^T (warpgroup 0) and R = sum_i e_i gy_i c_i^T
// (warpgroup 1) of the chunk, both (hd, ds) f32, and the chunk's decay
// exp(L): each warpgroup stages its operands kStep tokens at a time (rows
// past the chunk zero), splits the weighted one in place into hi and lo,
// and runs D (64 x SP) += A^T B for each 64 rows of hd, A read transposed
// (MN-major) from its [token][hd] tile and B MN-major from its [token][ds]
// tile.  HP = hd and SP = ds padded to 64 or 128.
template <int HP, int SP>
__global__ void __launch_bounds__(kThreads, HP == 64 ? 2 : 1)
states_bwd_wg(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_log, const bf16* __restrict__ bm,
              const bf16* __restrict__ cmat, const bf16* __restrict__ gy,
              float* __restrict__ states, float* __restrict__ decay,
              float* __restrict__ dstates, Shape sh) {
  using L = StLayout<HP, SP>;
  constexpr int kM = HP / 64;             // 64-row blocks of hd
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds, len = ch.len;
  const Cum<double> cm = cum_at<double>(smem, q);
  float* const wv = reinterpret_cast<float*>(past_cum<double>(smem, q));
  float* const ev = wv + q;
  char* const head_end = reinterpret_cast<char*>(ev + q);
  const uint32_t base = (smem_addr(head_end) + 1023u) & ~1023u;
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x >> 7), 0);
  const int tw = threadIdx.x & 127;
  char* const mine = head_end + (base - smem_addr(head_end)) + wg * L::kWg;
  bf16* ah = reinterpret_cast<bf16*>(mine);
  bf16* al = reinterpret_cast<bf16*>(mine + L::kA);
  bf16* bt = reinterpret_cast<bf16*>(mine + 2 * L::kA);
  const uint32_t uah = base + wg * L::kWg, ual = uah + L::kA,
                 ubt = uah + 2 * L::kA;
  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const bf16* asrc = (wg == 0 ? x : gy)
                     + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const bf16* bsrc = (wg == 0 ? bm : cmat)
                     + (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  stage_sw<kStep, HP>(ah, asrc, x_row, len, hd, 0, kStep, tw, 128);
  stage_sw<kStep, SP>(bt, bsrc, b_row, len, ds, 0, kStep, tw, 128);
  chunk_cum(dt, sh, ch, -expf(a_log[ch.h]), cm);
  const double last = cm.cum[q - 1];
  for (int t = threadIdx.x; t < q; t += kThreads) {
    wv[t] = cm.dtv[t] * exp_diff(last, cm.cum[t]);
    ev[t] = expf(static_cast<float>(cm.cum[t]));
  }
  if (threadIdx.x == 0) decay[ch.idx] = expf(static_cast<float>(last));
  __syncthreads();
  const float* wt = wg == 0 ? wv : ev;

  float acc[kM][SP / 2];
#pragma unroll
  for (int m = 0; m < kM; ++m) zero(acc[m]);
#pragma unroll
  for (int step = 0; step < kTok / kStep; ++step) {
    const int t0 = step * kStep;
    if (step > 0) {                       // the last step's products waited
      stage_sw<kStep, HP>(ah, asrc + t0 * x_row, x_row, len - t0, hd, 0,
                          kStep, tw, 128);
      stage_sw<kStep, SP>(bt, bsrc + t0 * b_row, b_row, len - t0, ds, 0,
                          kStep, tw, 128);
    }
    cp_async_wait_all();
    wg_sync(wg);
    // the weighted operand into hi (in place) and lo
    for (int i = tw; i < kStep * HP / 8; i += 128) {
      const int j = i / (HP / 8), at = sw<kStep>(j, 8 * (i % (HP / 8)));
      const float wj = t0 + j < len ? wt[t0 + j] : 0.f;
      uint4 v = *reinterpret_cast<const uint4*>(ah + at), h, l;
      const uint32_t* vi = reinterpret_cast<const uint32_t*>(&v);
      uint32_t* hi = reinterpret_cast<uint32_t*>(&h);
      uint32_t* lo = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vi + k));
        split2(f.x * wj, f.y * wj, hi[k], lo[k]);
      }
      *reinterpret_cast<uint4*>(ah + at) = h;
      *reinterpret_cast<uint4*>(al + at) = l;
    }
    fence_async_smem();
    wg_sync(wg);
#pragma unroll
    for (int m = 0; m < kM; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        const uint64_t db = mdesc<kStep>(ubt, 16 * kk);
        wg_ss<SP, 1, 1>(acc[m],
                        mdesc<kStep>(uah + m * kStep * kRowBytes, 16 * kk),
                        db);
        wg_ss<SP, 1, 1>(acc[m],
                        mdesc<kStep>(ual + m * kStep * kRowBytes, 16 * kk),
                        db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < kM; ++m) fence_regs(acc[m]);
    wg_sync(wg);                          // the tiles are consumed
  }
  float* out = (wg == 0 ? states : dstates) + ch.idx * hd * ds;
  const int ra = 16 * (tw >> 5) + ((tw & 31) >> 2);
#pragma unroll
  for (int m = 0; m < kM; ++m)
    store_rows<SP>(out + 64 * m * ds, ds, ra, hd - 64 * m, ds, tw & 3,
                   acc[m]);
}

// ---- pass 1: the chunk states, split TF32 ---------------------------------

constexpr int kStTok = 16;       // tokens a slice of the states pass

// Shared: the cum head, w and exp(cum) (q floats each), then two buffers
// of x's and gy's slices ([kStTok][ld_kn(hd)] each) and b's and c's
// ([kStTok][ld_kn(ds)] each), in x's type.
inline size_t states_tf_smem(int q, int hd, int ds, int size) {
  return cum_bytes<double>(q) + 8 * static_cast<size_t>(q)
         + 4 * static_cast<size_t>(kStTok) * (ld_kn(hd) + ld_kn(ds)) * size;
}

// S = sum_j w_j x_j b_j^T and R = sum_i e_i gy_i c_i^T of the chunk, both
// (hd, ds) f32, and the chunk's decay exp(L), from one chunk cum.  The
// products are A (d, j) = x_j[d] w_j (gy e, split) times B (j, s) = b_j[s]
// (c), over the chunk's tokens kStTok at a time; their outputs are cut
// into 16-row x 64-column warp tiles, S's then R's, and warp w takes tiles
// w and w + 8 of each 16 in turn (rounds: 2 at hd = ds = 128, else 1).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
states_bwd_tf(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a_log, const T* __restrict__ bm,
              const T* __restrict__ cmat, const T* __restrict__ gy,
              float* __restrict__ states, float* __restrict__ decay,
              float* __restrict__ dstates, Shape sh) {
  constexpr bool kEx = kExact<T>;
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = chunk_of(sh);
  const int q = sh.q, hd = sh.hd, ds = sh.ds, len = ch.len;
  const Cum<double> cm = cum_at<double>(smem, q);
  float* const wv = reinterpret_cast<float*>(past_cum<double>(smem, q));
  float* const ev = wv + q;
  T* const tiles = reinterpret_cast<T*>(ev + q);
  const int lx = ld_kn(hd), lb = ld_kn(ds);
  const int buf = 2 * kStTok * (lx + lb);   // elements a buffer
  const int64_t x_row = static_cast<int64_t>(sh.nh) * hd;
  const int64_t b_row = static_cast<int64_t>(sh.ng) * ds;
  const int64_t xo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * x_row
                     + static_cast<int64_t>(ch.h) * hd;
  const int64_t bo = (static_cast<int64_t>(ch.bi) * sh.seq + ch.t0) * b_row
                     + static_cast<int64_t>(ch.g) * ds;
  chunk_cum(dt, sh, ch, -expf(a_log[ch.h]), cm);
  const double last = cm.cum[q - 1];
  for (int t = threadIdx.x; t < q; t += kThreads) {
    wv[t] = cm.dtv[t] * exp_diff(last, cm.cum[t]);
    ev[t] = expf(static_cast<float>(cm.cum[t]));
  }
  if (threadIdx.x == 0) decay[ch.idx] = expf(static_cast<float>(last));
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (hd + 15) / 16, nb = (ds + 63) / 64, per = mt * nb;
  const int ndt = pad8(ds) / 8, hw = (hd + 31) / 32 * 32;
  const int slices = (len + kStTok - 1) / kStTok;
  for (int base = 0; base < 2 * per; base += 2 * kWarps) {
    float acc[2][8][4];
    zero(acc[0]);
    zero(acc[1]);
    auto load = [=](int s, int b) {
      T* p = tiles + b * buf;
      const int t0 = kStTok * s;
      stage_win(p, lx, x + xo + t0 * x_row, x_row, kStTok, len - t0, hw, hd);
      stage_win(p + kStTok * lx, lx, gy + xo + t0 * x_row, x_row, kStTok,
                len - t0, hw, hd);
      stage_win(p + 2 * kStTok * lx, lb, bm + bo + t0 * b_row, b_row, kStTok,
                len - t0, pad8(ds), ds);
      stage_win(p + 2 * kStTok * lx + kStTok * lb, lb, cmat + bo + t0 * b_row,
                b_row, kStTok, len - t0, pad8(ds), ds);
    };
    for (int s = 0; k_step(s, slices, load); ++s) {
      const T* p = tiles + (s & 1) * buf;
      const int t0 = kStTok * s;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int id = base + w + kWarps * u;
        if (id >= 2 * per) continue;
        const int r = id >= per, m = (id % per) / nb, c0 = 64 * (id % nb);
        const T* a = p + r * kStTok * lx + 16 * m;
        const float* wt = (r ? ev : wv) + t0;
        warp_ss<false, kEx>(
            acc[u],
            [=](int rr, int k) { return to_f32(a[k * lx + rr]) * wt[k]; },
            at_rc(p + 2 * kStTok * lx + r * kStTok * lb + c0, lb),
            kStTok / 8, 0, min(8, ndt - c0 / 8));
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int id = base + w + kWarps * u;
      if (id >= 2 * per) continue;
      const int r = id >= per, m = (id % per) / nb, c0 = 64 * (id % nb);
      float* out = (r ? dstates : states) + ch.idx * hd * ds;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * m + g + 8 * (e >> 1);
          const int s = c0 + 8 * n + 2 * t + (e & 1);
          if (d < hd && s < ds) out[d * ds + s] = acc[u][n][e];
        }
    }
  }
}

// ---- pass 2: the state pass in reverse ------------------------------------

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

// ---- pass 4: the fixed-order sums, one launch -----------------------------

// db and dc (rows, ng, ds) = the sums over each group's shares of db_part
// and dc_part (rows, shares, ds), in share order; and, in the grid's first
// nh threads, da_log and dd_skip (nh,) = the sums of the blocks' shares
// (B, nh, nc), batch row by batch row and chunk by chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_bwd(const float* __restrict__ db_part,
           const float* __restrict__ dc_part, T* __restrict__ db,
           T* __restrict__ dc, int64_t rows, int32_t shares, int32_t ng,
           int32_t ds, const float* __restrict__ dalog_part,
           const float* __restrict__ dd_part, float* __restrict__ da_log,
           float* __restrict__ dd_skip, int32_t bsz, int32_t nh,
           int32_t nc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nh) {
    float a = 0.f, d = 0.f;
    for (int bi = 0; bi < bsz; ++bi)
      for (int k = 0; k < nc; ++k) {
        const int64_t at = (static_cast<int64_t>(bi) * nh + i) * nc + k;
        a += dalog_part[at];
        d += dd_part[at];
      }
    da_log[i] = a;
    dd_skip[i] = d;
  }
  if (i >= rows * ng * ds) return;
  const int s = static_cast<int>(i % ds);
  const int64_t rg = i / ds;
  const int grp = static_cast<int>(rg % ng);
  const int64_t row = rg / ng;
  const int per = shares / ng;
  const int64_t at = (row * shares + static_cast<int64_t>(grp) * per) * ds + s;
  float vb = 0.f, vc = 0.f;
  for (int k = 0; k < per; ++k) {
    vb += db_part[at + static_cast<int64_t>(k) * ds];
    vc += dc_part[at + static_cast<int64_t>(k) * ds];
  }
  db[i] = from_f32<T>(vb);
  dc[i] = from_f32<T>(vc);
}

// ---- plans ------------------------------------------------------------------

Pass chunk_pass(int mode, int q, int hd, int ds) {
  if (mode == kTensorCores) {
    const bool wide_d = hd > 64, wide_s = ds > 64;
    return wide_d ? (wide_s ? Pass{reinterpret_cast<const void*>(
                                       &chunk_bwd_wg<128, 128>),
                                   chunk_wg_smem<128, 128>(q)}
                            : Pass{reinterpret_cast<const void*>(
                                       &chunk_bwd_wg<128, 64>),
                                   chunk_wg_smem<128, 64>(q)})
                  : (wide_s ? Pass{reinterpret_cast<const void*>(
                                       &chunk_bwd_wg<64, 128>),
                                   chunk_wg_smem<64, 128>(q)}
                            : Pass{reinterpret_cast<const void*>(
                                       &chunk_bwd_wg<64, 64>),
                                   chunk_wg_smem<64, 64>(q)});
  }
  return Pass{mode == kBf16
                  ? reinterpret_cast<const void*>(&chunk_bwd_tf<bf16>)
                  : reinterpret_cast<const void*>(&chunk_bwd_tf<float>),
              chunk_tf_smem(q)};
}

Pass states_wg_pass(int q, int hd, int ds) {
  const bool wide_d = hd > 64, wide_s = ds > 64;
  return wide_d ? (wide_s ? Pass{reinterpret_cast<const void*>(
                                     &states_bwd_wg<128, 128>),
                                 states_wg_smem<128, 128>(q)}
                          : Pass{reinterpret_cast<const void*>(
                                     &states_bwd_wg<128, 64>),
                                 states_wg_smem<128, 64>(q)})
                : (wide_s ? Pass{reinterpret_cast<const void*>(
                                     &states_bwd_wg<64, 128>),
                                 states_wg_smem<64, 128>(q)}
                          : Pass{reinterpret_cast<const void*>(
                                     &states_bwd_wg<64, 64>),
                                 states_wg_smem<64, 64>(q)});
}

// Pass 1 of `mode`'s route: S and R in one launch.
Pass states_bwd_pass(int mode, int q, int hd, int ds) {
  if (mode == kTensorCores) return states_wg_pass(q, hd, ds);
  return mode == kBf16
             ? Pass{reinterpret_cast<const void*>(&states_bwd_tf<bf16>),
                    states_tf_smem(q, hd, ds, 2)}
             : Pass{reinterpret_cast<const void*>(&states_bwd_tf<float>),
                    states_tf_smem(q, hd, ds, 4)};
}

// The launch of the chunk pass in clusters of `cluster` blocks.
cudaLaunchConfig_t cluster_config(const Pass& p, unsigned grid, int cluster,
                                  cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_cluster(const Pass& p, unsigned grid, int cluster,
                           void** args, cudaStream_t st) {
  const cudaError_t err = allow_smem(p);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, grid, cluster, st, &attr);
  return cudaLaunchKernelExC(&cfg, p.fn, args);
}

// A cluster of `cluster` heads: 1 to kMaxCluster, dividing the heads of a
// group.
inline bool valid_cluster(int nh, int ng, int cluster) {
  return cluster >= 1 && cluster <= kMaxCluster && (nh / ng) % cluster == 0;
}

}  // namespace ssd_grad

using namespace ssd_grad;

// The gradients of ssd_fwd's (y, h_out) at (x, dt, a_log, b, c, d_skip)
// against gy (like x) and gh ((bsz, nh, hd, ds) f32, or null: zero).
// Scratch, all f32: states, dstates (bsz, nh, nc, hd, ds), decay (bsz, nh,
// nc), db_part, dc_part (bsz, seq, nh / cluster, ds), dalog_part, dd_part
// (bsz, nh, nc).  Out: dx like x, ddt like dt, da_log and dd_skip (nh,)
// f32, db and dc like b.  All contiguous; the modes and limits are
// ssd_fwd's; `cluster` heads share a chunk pass's cluster (see
// valid_cluster).  `passes` is a mask of the passes to
// launch, in this order (15 is the whole gradient): 1 writes the chunks'
// own states into `states`, their decays, and R into dstates, 2 turns
// states into the entering states H and dstates into dS in place, 4 the
// chunk pass (dx, ddt and the shares), 8 the sums (db, dc, da_log,
// dd_skip).  Returns the first CUDA error, else cudaGetLastError().
extern "C" int ssd_bwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* d_skip,
                       const void* gy, const void* gh, void* states,
                       void* decay, void* dstates, void* db_part,
                       void* dc_part, void* dalog_part, void* dd_part,
                       void* dx, void* ddt, void* da_log, void* db, void* dc,
                       void* dd_skip, int32_t bsz, int32_t seq, int32_t nh,
                       int32_t hd, int32_t ng, int32_t ds, int32_t chunk,
                       int32_t cluster, int32_t mode, int32_t passes,
                       void* stream) {
  if (!valid(mode, hd, ds, chunk) || ng <= 0 || nh % ng || seq < 0
      || !valid_cluster(nh, ng, cluster))
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
    void* args[] = {&x, &dt, &a_log, &b, &c, &gy, &states, &decay, &dstates,
                    &sh};
    err = launch(states_bwd_pass(mode, chunk, hd, ds), blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    if (sh.nc > 0) {
      void* args[] = {&states, &decay, &null, &sh.nc, &n, &tiles};
      err = launch(state_pass_pass<Tag>(hd, ds), state_blocks, args, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    void* args[] = {&dstates, &decay, &gh, &sh.nc, &n, &tiles};
    const Pass p{n % 4 == 0
                     ? reinterpret_cast<const void*>(&state_pass_bwd<true>)
                     : reinterpret_cast<const void*>(&state_pass_bwd<false>),
                 0};
    err = launch(p, state_blocks, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((passes & 4) && sh.nc > 0) {
    void* args[] = {&x,  &dt,  &a_log,   &b,       &c,          &d_skip,
                    &gy, &states, &dstates, &dx,   &ddt,        &db_part,
                    &dc_part, &dalog_part, &dd_part, &sh, nullptr, nullptr,
                    nullptr};
    const Pass p = chunk_pass(mode, chunk, hd, ds);
    if (mode == kTensorCores) {
      // b and c by TMA where a map takes them (16-byte aligned, whole
      // boxes of 64 columns), else staged by each block
      CUtensorMap tm_b = {}, tm_c = {};
      int32_t tma = 0;
      if (ds % 64 == 0
          && ((reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c))
              & 15) == 0) {
        err = bind_device(b);
        if (err != cudaSuccess) return static_cast<int>(err);
        const EncodeTiled fn = encode_tiled();
        if (fn == nullptr
            || !make_map(fn, &tm_b, b, true, ds, ng, seq, bsz, 16)
            || !make_map(fn, &tm_c, c, true, ds, ng, seq, bsz, 16))
          return static_cast<int>(cudaErrorInvalidValue);
        tma = 1;
      }
      args[16] = &tm_b;
      args[17] = &tm_c;
      args[18] = &tma;
    }
    err = launch_cluster(p, blocks, cluster, args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 8) {
    int64_t rows = static_cast<int64_t>(bsz) * seq;
    int32_t shares = nh / cluster;        // the shares of a row
    const int64_t outs = rows * ng * ds, threads = outs > nh ? outs : nh;
    const Pass p{mode == kF32
                     ? reinterpret_cast<const void*>(&reduce_bwd<float>)
                     : reinterpret_cast<const void*>(&reduce_bwd<bf16>),
                 0};
    void* args[] = {&db_part, &dc_part, &db, &dc, &rows, &shares, &ng, &ds,
                    &dalog_part, &dd_part, &da_log, &dd_skip, &bsz, &nh,
                    &sh.nc};
    err = launch(p, static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                 args, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// For the passes with shared memory of their own at (mode, hd, ds, chunk)
// (1, the states; 3, the chunk pass): the blocks of kThreads threads that
// fit on one SM into blocks[0..1] and the shared bytes a block takes into
// smem[0..1], and the chunk pass's clusters of `cluster` blocks that can
// be resident on the card at once into *clusters.
extern "C" int ssd_bwd_occupancy(int32_t mode, int32_t hd, int32_t ds,
                                 int32_t chunk, int32_t cluster,
                                 int32_t* blocks, int32_t* smem,
                                 int32_t* clusters) {
  if (!valid(mode, hd, ds, chunk) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const Pass ps[2] = {states_bwd_pass(mode, chunk, hd, ds),
                      chunk_pass(mode, chunk, hd, ds)};
  for (int i = 0; i < 2; ++i) {
    cudaError_t err = allow_smem(ps[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[i], ps[i].fn, kThreads, ps[i].smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem[i] = static_cast<int32_t>(ps[i].smem);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(ps[1], static_cast<unsigned>(cluster), cluster, nullptr,
                     &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, ps[1].fn, &cfg));
}
