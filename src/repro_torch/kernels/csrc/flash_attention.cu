// Flash attention (online softmax) for Hopper (sm_90a), on the tensor cores
// in both of its types, and the float32 route of its backward (namespace
// bwd, below: split TF32 on mma.sync as the forward's f32 route; the
// bfloat16 backward is flash_attention_bwd.cu).
//
// Replaces: flash_attention / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py; the backward
//   replaces no TPU kernel: the reference's training differentiates XLA's
//   dense attention (src/repro/models/attention.py, _dense_attn).
// Computes: for q (B, Sq, H, D) and k, v (B, Sk, KV, D) in model layout
//   (H a multiple of KV; q head h reads kv head h / (H / KV)):
//     s_ij = (q_i . k_j) * D^-1/2             in f32, masked to -1e30 where
//                                             j > i (causal, Sq == Sk) or,
//                                             given int32 positions q_pos
//                                             (B, Sq) and k_pos (B, Sk),
//                                             where q_pos_i < k_pos_j
//                                             (causal by position, the
//                                             reference's mask)
//     o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
//   over j < Sk; non-causal attention takes any Sq and Sk (an encoder-
//   decoder's cross-attention).  Columns past Sk sit at -2e30, below the
//   mask, so a row that no key reaches averages the keys, as the
//   reference's softmax does, and not the zero rows past Sk.
//   with the running (m, l, acc) of the online softmax in f32 and p rounded
//   to the value type before p . v (l sums the unrounded p), as the TPU
//   kernel does; o in q's type.
// Bound: operations.  At the llama3-8b prefill shape (B 4, S 2,000, H 32,
//   KV 8, D 128) the causal half of Q.K^T and P.V is 131 GFLOP against
//   164 MB of q, k, v and o in bf16: 0.13 ms at the card's bf16 tensor
//   rate, 0.05 ms at its memory rate.  At stablelm-3b's (H = KV = 32,
//   D 80) it is 82 GFLOP against 164 MB: 0.083 ms and 0.049 ms.
// Routes, a function of the type alone that the wrapper decides before the
//   launch (flash_attention.route); both take D 16, 32, 64, 80, 96, 128:
//   * bfloat16 (flash_attention_tc_fwd, namespace bf16):
//     - a block of three warpgroups per (128-row q tile, b * H + h), the
//       heaviest causal q tiles of every head first.  Warpgroup 0 is the
//       producer: it gives up registers (setmaxnreg to 40) and one thread
//       issues every TMA load.  Warpgroups 1 and 2 are consumers (232
//       registers), each owning 64 q rows;
//     - TMA over 4-D tensor maps (D, heads, S, B), encoded on the host, so
//       a (b, head, s0) tile is one coordinate, kv head h / (H / KV) is
//       read in place (GQA needs no copy), and rows past S arrive as
//       zeros.  A box is 64 columns (128 bytes) with the 128-byte swizzle.
//       D pads to whole boxes (64 or 128 columns): the tensor map's inner
//       extent is D, so TMA fills the columns past D with zeros and moves
//       no extra bytes.  Zero padding rather than a narrower swizzle keeps
//       one operand layout and two wgmma shapes for every head dim; Q.K^T
//       stops at D (the zero columns add nothing), so only P.V runs the
//       padded width (at D 80: 80 + 128 columns of work for 80 + 80).
//       The q tile is loaded once; k and v tiles of 128 rows stream
//       through a ring of two stages with full and empty mbarriers, k and
//       v on their own full barriers, so Q.K^T starts before v lands.  At
//       a padded width of 128: q 32 KB + 2 x (k 32 KB + v 32 KB) = 160 KB,
//       one block an SM;
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
//       mask, D columns of the padded width.
//   * float32 (flash_attention_f32_fwd, namespace tf32): single-pass TF32
//     keeps 11 significant bits and cannot meet the f32 tolerance of 2e-5,
//     so every product is split: x = hi + lo with hi = tf32(x) (rounded
//     as cvt.rna rounds, by integer operations) and lo = tf32(x - hi),
//     and a . b = hi.hi + hi.lo + lo.hi, each term
//     a TF32 tensor-core product summed in f32 (the dropped lo.lo is
//     below 2^-22 of a . b).  Its design:
//     - a block of eight warps (16 q rows each, 128 in all) per (128-row
//       q tile, b * H + h), heaviest causal tiles first, loading through
//       the same 4-D tensor maps as the bf16 route with f32 boxes of 32
//       columns (128 bytes, the 128-byte swizzle), D padded to whole boxes
//       by TMA's zero fill.  q is loaded once; k and v tiles of 64 rows
//       stream through a ring of two stages (D 128: q 64 KB + 2 x (k 32 KB
//       + v 32 KB) = 192 KB).  No producer warp: a ninth warp would put
//       three warps on one of the SM's four schedulers and cap a thread at
//       168 registers, where this route takes up to 238; thread 0 issues
//       a stage's next load once every thread has left it;
//     - mma.sync m16n8k8 TF32 rather than wgmma: wgmma reads TF32 operands
//       from shared memory, K-major only, so the split halves of q, k and
//       a transposed v would need shared memory of their own (q alone 128
//       KB at D 128), while mma.sync takes fragments from registers: each
//       thread loads raw f32 elements and splits them there;
//     - the order of a sum is free where both operands share it: Q.K^T
//       takes D's columns in an order that gives each thread two k steps
//       per 16-byte load, and P.V takes v's columns (o's, permuted back at
//       the store) so that one 16-byte load gives four n tiles; with the
//       swizzle, the eight threads of each phase of those loads read eight
//       different 16-byte chunks, so no load waits on a bank;
//     - P for P.V comes straight from S's accumulator fragments: these
//       hold kv columns 2t and 2t + 1 of a k step where the A operand
//       wants t and t + 4, so the k step is permuted (A's t is column 2t,
//       its t + 4 column 2t + 1) and v's rows are read in the same order;
//     - the online softmax as in the bf16 route, with p unrounded (its
//       type is f32); each tile's P.V is summed apart from O and added in
//       f32, so the tensor cores' accumulation error does not build up
//       over a row's tiles;
//     - a warp skips the math of a kv tile that lies wholly above its 16
//       rows' diagonal.
//   Both routes mask the ragged last q and kv tiles, so any Sq, Sk >= 1
//   work (the TPU kernel needs S % 128 == 0), and copy nothing for GQA.
//   The mask is a template parameter, so the index-masked kernels are
//   compiled without the position mask's code.  Under the position mask
//   (positions need not rise) each block first folds its rows' q
//   positions and each kv tile's k positions into shared memory
//   (`position_tiles`), then loads and computes only the kv tiles that
//   some row keeps a key of, and masks only those that hold a masked
//   pair, reading each column's k position from device memory there.  The
//   driver's cuTensorMapEncodeTiled is found at run time through
//   cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//   PERF.md keeps each route's time beside the bound.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

// ---- what both tensor-core routes share ---------------------------------- //

namespace {

using namespace repro_torch::sm90;

constexpr float kPastEnd = -2e30f;     // columns past Sk, below the mask
constexpr float kLn2 = 0.6931471805599453f;

// The log-sum-exp of the thread's rows r0 and r0 + 8 (below seq_q) into
// `row_lse` (the (b, h) row of lse, (B, H, Sq) f32), in natural units, from
// the online softmax's running max m (log2 units, the scale folded in) and
// the quad's whole sum l: (m + log2 l) ln 2.  A row that keeps no key (m
// still at the mask) gets the mask itself, -1e30, which is what a
// logsumexp of its masked scores rounds to in f32; the backward reads it
// as the row that averages every key.
__device__ __forceinline__ void store_lse(float* row_lse, int r0, int seq_q,
                                          const float (&m)[2],
                                          const float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (r0 + 8 * r < seq_q)
      row_lse[r0 + 8 * r] =
          m[r] <= kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
}

// The arguments of a launch that every route takes.
struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;                     // null: no log-sum-exp written
  int32_t b, sq, sk, h, kvh, causal;
  const int32_t *q_pos, *k_pos;   // both null: the index mask
  float scale;
  cudaStream_t stream;
};

// Makes q's device current on this thread (bind_device: the first CUDA
// call of a fresh thread may be this launch), encodes the three maps (q
// at Sq rows, k and v at Sk) and launches
// `kernel` over B * H * ceil(Sq / br) blocks of `threads` with `smem`
// bytes of dynamic shared memory.
template <typename Kernel, typename Out>
int launch_tiled(Kernel kernel, bool bf16, int br, int bc, int threads,
                 int smem, int32_t d, const Args& a) {
  const cudaError_t bound = bind_device(a.q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  if (!make_map(fn, &mq, a.q, bf16, d, a.h, a.sq, a.b, br) ||
      !make_map(fn, &mk, a.k, bf16, d, a.kvh, a.sk, a.b, bc) ||
      !make_map(fn, &mv, a.v, bf16, d, a.kvh, a.sk, a.b, bc))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bh = static_cast<int64_t>(a.b) * a.h;
  const int64_t blocks = bh * ((a.sq + br - 1) / br);
  if (bh > INT32_MAX || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, a.stream>>>(
      mq, mk, mv, static_cast<Out*>(a.o), a.lse, a.sq, a.sk, a.h, a.kvh,
      static_cast<int32_t>(bh), a.causal, a.q_pos, a.k_pos,
      a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The head dims both routes take, as a switch onto compile-time D.
template <template <int> class Launch>
int by_head_dim(int32_t d, const Args& a) {
  switch (d) {
#define REPRO_FA_CASE(D) \
  case D: return Launch<D>::run(a);
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(128)
#undef REPRO_FA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bfloat16: wgmma ----------------------------------------------------- //

namespace bf16 {

constexpr int kBr = 128;          // q rows a block: two consumer warpgroups
constexpr int kBc = 128;          // kv rows a tile
constexpr int kStages = 2;        // the k, v ring
constexpr int kBlock = 384;       // the producer warpgroup and two consumers
constexpr int kBox = 64;          // columns a TMA box: 128 bytes, the swizzle

template <int D> struct Layout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 2 * kBox,
                "the bf16 route takes D a multiple of 16, up to 128");
  // D padded to whole boxes; TMA fills the columns past D with zeros
  static constexpr int kPad = (D + kBox - 1) / kBox * kBox;
  static constexpr int kBoxes = kPad / kBox;
  static constexpr int kQBytes = kBr * kPad * 2;
  static constexpr int kKVBytes = kBc * kPad * 2;
  // offsets from a 1024-byte-aligned base (the 128-byte swizzle repeats
  // every 8 rows, and wgmma's descriptors assume that alignment)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // the position mask's tile statistics (stats_ints of the kv tiles)
  static constexpr int kStats = (kBars + Barriers<kStages>::kBytes + 15) /
                                16 * 16;
  static constexpr int kUsed = kStats + 1024;
  // at least 116 KB, so never two blocks share an SM: each block's
  // setmaxnreg.inc needs the registers its producer gives up, and two
  // blocks could each wait for the other's
  static constexpr int bytes(int stats) {
    return kUsed + stats > 116 * 1024 ? kUsed + stats : 116 * 1024;
  }
};

// One k step of P.V at the padded width N (64 or 128).
template <int N>
__device__ __forceinline__ void pv_step(float (&acc)[N / 2],
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

template <int D, bool kByPos>
__global__ void __launch_bounds__(kBlock, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
             int32_t seq_q, int32_t seq_k,
             int32_t heads, int32_t kv_heads, int32_t bh_total,
             int32_t causal, const int32_t* __restrict__ q_pos,
             const int32_t* __restrict__ k_pos, float scale_log2) {
  using L = Layout<D>;
  constexpr int kPad = L::kPad;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ, s_k = base + L::kK, s_v = base + L::kV;
  const Barriers<kStages> bars{base + L::kBars};

  const int n_qt = (seq_q + kBr - 1) / kBr;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_total;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kBr;
  const int n_kv_all = (seq_k + kBc - 1) / kBc;
  int* const list = reinterpret_cast<int*>(
                        smem_raw + (base - smem_u32(smem_raw)) + L::kStats) +
                    2 * n_kv_all;

  if (threadIdx.x == 0) bars.init(2 * 128);
  // causal by index (Sq == Sk): kv tiles past the tile's last q row are
  // never loaded; by position, the tiles `position_tiles` lists
  int n_kv;
  if constexpr (kByPos)
    n_kv = position_tiles<kBc, kBr>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, q0, n_kv_all,
        list - 2 * n_kv_all);
  else
    n_kv = causal ? min(n_kv_all, (min(q0 + kBr, seq_q) - 1) / kBc + 1)
                  : n_kv_all;
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const Loader<kStages> load{bars, &tm_q, &tm_k, &tm_v, s_q, s_k, s_v,
                                 L::kBoxes, kBox, kBr, kBc, h, hk, q0, b};
      load.q();
      for (int it = 0; it < n_kv; ++it) {
        // stage it % kStages is free once every consumer thread is done
        // with the tile it - kStages
        if (it >= kStages)
          mbar_wait(bars.empty(it % kStages), ((it / kStages) - 1) & 1);
        load.kv(kByPos ? list[it] & ~kMaskBit : it, it % kStages);
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
    // by position: the rows' q positions (a row past Sq keeps every key;
    // it is not stored) and the batch row's k positions
    int qp[2] = {INT32_MAX, INT32_MAX};
    const int32_t* kp = nullptr;
    if constexpr (kByPos) {
      for (int r = 0; r < 2; ++r)
        if (r0 + 8 * r < seq_q)
          qp[r] = q_pos[static_cast<int64_t>(b) * seq_q + r0 + 8 * r];
      kp = k_pos + static_cast<int64_t>(b) * seq_k;
    }

    float acc[kPad / 2];
#pragma unroll
    for (int i = 0; i < kPad / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[kBc / 2];
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) sc[i] = 0.f;
    uint32_t pa[kBc / 16][4];

    mbar_wait(bars.q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int n = kByPos ? list[it] & ~kMaskBit : it;
      const uint32_t kb = s_k + st * L::kKVBytes;
      const uint32_t vb = s_v + st * L::kKVBytes;

      // S = Q . K^T over D in steps of 16 (32 bytes within a swizzled row;
      // the second box starts kBr (kBc) rows on); the zero columns past D
      // are not multiplied
      mbar_wait(bars.k_full(st), par);
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

      // masks on the diagonal and the ragged last tile only (by
      // position, on the tiles listed so); then the online softmax in
      // log2 units, rows folded over the quad
      const int k0 = n * kBc;
      const bool edge = kByPos ? (list[it] & kMaskBit) != 0
                               : k0 + kBc > seq_k ||
                                     (causal && k0 + kBc - 1 > q0 + 64 * cw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + cq + (i % 2);
          const int row = r0 + 8 * ((i / 2) % 2);
          if (col >= seq_k)
            x = kPastEnd;
          else if (kByPos ? qp[(i / 2) % 2] < __ldg(kp + col)
                          : causal && col > row)
            x = kNegInf;
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
      for (int i = 0; i < kPad / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P . V over the tile's kv rows in steps of 16 (2,048 bytes);
      // v's padded columns are its MN dimension, the second box kBc rows on
      mbar_wait(bars.v_full(st), par);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk)
        pv_step<kPad>(acc, pa[kk],
                      sw128_desc(vb + kk * 16 * kRowBytes, kBc * kRowBytes,
                                 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bars.empty(st));
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
    if (lse != nullptr && cq == 0)
      store_lse(lse + static_cast<int64_t>(bh) * seq_q, r0, seq_q, m, l);
    const int64_t row_stride = static_cast<int64_t>(heads) * D;
    __nv_bfloat16* ob = o + static_cast<int64_t>(b) * seq_q * row_stride +
                        static_cast<int64_t>(h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= seq_q) continue;
      __nv_bfloat16* orow = ob + row * row_stride + cq;
#pragma unroll
      for (int g = 0; g < D / 8; ++g)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g) =
            __floats2bfloat162_rn(acc[4 * g + 2 * r] / den[r],
                                  acc[4 * g + 2 * r + 1] / den[r]);
    }
  }
}

template <int D> struct Launch {
  static int run(const Args& a) {
    const bool by_pos = a.q_pos != nullptr;
    const int stats = by_pos ? 4 * stats_ints((a.sk + kBc - 1) / kBc) : 0;
    return launch_tiled<decltype(&flash_kernel<D, false>), __nv_bfloat16>(
        by_pos ? flash_kernel<D, true> : flash_kernel<D, false>, true, kBr,
        kBc, kBlock, Layout<D>::bytes(stats), D, a);
  }
};

}  // namespace bf16

// ---- float32: split TF32 on mma.sync ----------------------------------- //

namespace tf32 {

constexpr int kBr = 128;                   // q rows a block
constexpr int kBc = 64;                    // kv rows a tile
constexpr int kStages = 2;                 // the k, v ring
constexpr int kWarps = kBr / 16;           // warps, 16 q rows each
constexpr int kBlock = 32 * kWarps;
constexpr int kBox = 32;                   // columns a TMA box: 128 bytes

template <int D> struct Layout {
  static_assert(D % 16 == 0 && D >= 16 && D <= 4 * kBox,
                "the f32 route takes D a multiple of 16, up to 128");
  // D padded to whole boxes; TMA fills the columns past D with zeros
  static constexpr int kBoxes = (D + kBox - 1) / kBox;
  static constexpr int kPad = kBoxes * kBox;
  static constexpr int kQBytes = kBoxes * kBr * kRowBytes;
  static constexpr int kKVBytes = kBoxes * kBc * kRowBytes;
  // offsets from a 1024-byte-aligned base (the swizzle repeats every 8
  // rows of 128 bytes)
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // the position mask's tile statistics (stats_ints of the kv tiles)
  static constexpr int kStats = (kBars + Barriers<kStages>::kBytes + 15) /
                                16 * 16;
  static constexpr int bytes(int stats) { return kStats + 1024 + stats; }
};

// The 16-byte chunk c (columns 4c .. 4c + 3 of box `box`) of row r of a
// tile of `kRows` rows that TMA wrote with the 128-byte swizzle: each box
// is kRows rows of 128 bytes, and in row r chunk c sits at c ^ (r % 8).
template <int kRows>
__device__ __forceinline__ float4 ld_chunk(const uint8_t* tile, int box,
                                           int r, int c) {
  return *reinterpret_cast<const float4*>(
      tile + box * (kRows * kRowBytes) + r * kRowBytes + ((c ^ (r & 7)) << 4));
}

// The split-TF32 arithmetic (tf32_rna, split, split_a, mma, mma3) is
// common.cuh's, shared with B8's f32 backward.
using repro_torch::tf32::mma;
using repro_torch::tf32::mma3;
using repro_torch::tf32::split;
using repro_torch::tf32::split_a;

template <int D, bool kByPos>
__global__ void __launch_bounds__(kBlock, 1)
flash_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
             float* __restrict__ lse, int32_t seq_q, int32_t seq_k, int32_t heads, int32_t kv_heads,
             int32_t bh_total, int32_t causal,
             const int32_t* __restrict__ q_pos,
             const int32_t* __restrict__ k_pos, float scale_log2) {
  using L = Layout<D>;
  constexpr int kN = L::kPad / 8;   // n tiles of P.V, k steps of Q.K^T
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const Barriers<kStages> bars{base + L::kBars};

  const int n_qt = (seq_q + kBr - 1) / kBr;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_total;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int b = bh / heads;
  const int h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kBr;
  const int n_kv_all = (seq_k + kBc - 1) / kBc;
  int* const list = reinterpret_cast<int*>(sm + L::kStats) + 2 * n_kv_all;
  const Loader<kStages> load{bars, &tm_q, &tm_k, &tm_v, base + L::kQ,
                             base + L::kK, base + L::kV, L::kBoxes, kBox,
                             kBr, kBc, h, hk, q0, b};

  // thread 0 issues the loads (no producer warp: see the note above)
  if (threadIdx.x == 0) bars.init(kBlock);
  // causal by index (Sq == Sk): kv tiles past the tile's last q row are
  // never loaded; by position, the tiles `position_tiles` lists
  int n_kv;
  if constexpr (kByPos)
    n_kv = position_tiles<kBc, kBr>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, q0, n_kv_all,
        list - 2 * n_kv_all);
  else
    n_kv = causal ? min(n_kv_all, (min(q0 + kBr, seq_q) - 1) / kBc + 1)
                  : n_kv_all;
  __syncthreads();
  if (threadIdx.x == 0) {
    load.q();
    for (int it = 0; it < kStages && it < n_kv; ++it)
      load.kv(kByPos ? list[it] & ~kMaskBit : it, it);
  }

  // A warp owns 16 q rows.  In an m16n8 fragment the thread holds rows g
  // and g + 8 and, of an 8-column group, columns 2t and 2t + 1
  // (accumulators) or t and t + 4 (operands).
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * w;                  // the warp's first row in the tile
  const int r0 = q0 + wr + g;             // the thread's rows r0, r0 + 8
  const uint8_t* sq = sm + L::kQ;
  // by position: the rows' q positions (a row past Sq keeps every key; it
  // is not stored) and the batch row's k positions
  int qp[2] = {INT32_MAX, INT32_MAX};
  const int32_t* kp = nullptr;
  if constexpr (kByPos) {
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < seq_q)
        qp[r] = q_pos[static_cast<int64_t>(b) * seq_q + r0 + 8 * r];
    kp = k_pos + static_cast<int64_t>(b) * seq_k;
  }

  // O in n tiles of 8 columns, permuted: the thread's chunk g of box J
  // holds columns 32 J + 4 g + i of n tiles 4 J + i, so its accumulators
  // cover columns 32 J + 8 t .. 32 J + 8 t + 7 of rows g and g + 8
  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bars.q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int n = kByPos ? list[it] & ~kMaskBit : it;
    const uint8_t* sk = sm + L::kK + st * L::kKVBytes;
    const uint8_t* sv = sm + L::kV + st * L::kKVBytes;
    const int k0 = n * kBc;
    mbar_wait(bars.k_full(st), par);
    // causal by index: a tile wholly above the warp's rows adds nothing
    // to them
    if (!causal || kByPos || k0 <= q0 + wr + 15) {
      // S = Q . K^T.  The sum over D runs in any order that q and k share:
      // k steps (box, half, sub) take, at A's k indices t and t + 4,
      // columns 4 c + 2 sub and 4 c + 2 sub + 1 of the box with
      // c = 2 t + half, so one 16-byte load gives a thread two k steps,
      // and the eight threads of a phase (g, g + 1; t = 0..3) read eight
      // different chunks of the swizzle
      float s[kBc / 8][4];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int bx = 0; bx < L::kBoxes; ++bx)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = 2 * t + half;
          const float4 qa = ld_chunk<kBr>(sq, bx, wr + g, c);
          const float4 qb = ld_chunk<kBr>(sq, bx, wr + g + 8, c);
          uint32_t ah0[4], al0[4], ah1[4], al1[4];
          split_a(qa.x, qb.x, qa.y, qb.y, ah0, al0);
          split_a(qa.z, qb.z, qa.w, qb.w, ah1, al1);
#pragma unroll
          for (int j = 0; j < kBc / 8; ++j) {
            const float4 kb = ld_chunk<kBc>(sk, bx, 8 * j + g, c);
            mma3(s[j], ah0, al0, kb.x, kb.y);
            mma3(s[j], ah1, al1, kb.z, kb.w);
          }
        }

      // masks on the diagonal and the ragged last tile only (by
      // position, on the tiles listed so); then the online softmax in
      // log2 units, rows folded over the quad
      const bool edge = kByPos ? (list[it] & kMaskBit) != 0
                               : k0 + kBc > seq_k ||
                                     (causal && k0 + kBc - 1 > q0 + wr);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[j][i] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + 2 * t + (i & 1);
            const int row = r0 + 8 * (i >> 1);
            if (col >= seq_k)
              x = kPastEnd;
            else if (kByPos ? qp[i >> 1] < __ldg(kp + col)
                            : causal && col > row)
              x = kNegInf;
          }
          s[j][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
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
      for (int j = 0; j < kBc / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(s[j][i] - m[i >> 1]);
          l[i >> 1] += p;
          s[j][i] = p;
        }

      // O = O * alpha + P . V, the tile's P . V summed apart and added in
      // f32: carried in the tensor cores' accumulator over a whole row's
      // tiles, O would pick up their accumulation error tile after tile.
      // k step kk's accumulator holds kv columns 2t, 2t + 1; at A's k
      // indices t and t + 4 they are read with v's rows 2t and 2t + 1,
      // each a 16-byte load of chunk g per box (the eight threads of a
      // phase again on eight chunks)
      mbar_wait(bars.v_full(st), par);
      float pv[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBc / 8; ++kk) {
        uint32_t ah[4], al[4];
        split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ah, al);
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          const float4 v0 = ld_chunk<kBc>(sv, bx, 8 * kk + 2 * t, g);
          const float4 v1 = ld_chunk<kBc>(sv, bx, 8 * kk + 2 * t + 1, g);
          mma3(pv[4 * bx + 0], ah, al, v0.x, v1.x);
          mma3(pv[4 * bx + 1], ah, al, v0.y, v1.y);
          mma3(pv[4 * bx + 2], ah, al, v0.z, v1.z);
          mma3(pv[4 * bx + 3], ah, al, v0.w, v1.w);
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[j][i] = fmaf(acc[j][i], alpha[i >> 1], pv[j][i]);
    }
    mbar_arrive(bars.empty(st));
    // stage st is free once every thread is done with tile n
    if (threadIdx.x == 0 && it + kStages < n_kv) {
      mbar_wait(bars.empty(st), par);
      load.kv(kByPos ? list[it + kStages] & ~kMaskBit : it + kStages, st);
    }
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && t == 0)
    store_lse(lse + static_cast<int64_t>(bh) * seq_q, r0, seq_q, m, l);
  const int64_t row_stride = static_cast<int64_t>(heads) * D;
  float* ob = o + static_cast<int64_t>(b) * seq_q * row_stride +
              static_cast<int64_t>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= seq_q) continue;
    float* orow = ob + row * row_stride;
#pragma unroll
    for (int bx = 0; bx < L::kBoxes; ++bx) {
      const int col = kBox * bx + 8 * t;
      if (col >= D) continue;               // the zero columns of a pad
      *reinterpret_cast<float4*>(orow + col) = make_float4(
          acc[4 * bx][2 * r] / den[r], acc[4 * bx + 1][2 * r] / den[r],
          acc[4 * bx + 2][2 * r] / den[r], acc[4 * bx + 3][2 * r] / den[r]);
      *reinterpret_cast<float4*>(orow + col + 4) = make_float4(
          acc[4 * bx][2 * r + 1] / den[r], acc[4 * bx + 1][2 * r + 1] / den[r],
          acc[4 * bx + 2][2 * r + 1] / den[r],
          acc[4 * bx + 3][2 * r + 1] / den[r]);
    }
  }
}

template <int D> struct Launch {
  static int run(const Args& a) {
    const bool by_pos = a.q_pos != nullptr;
    const int stats = by_pos ? 4 * stats_ints((a.sk + kBc - 1) / kBc) : 0;
    return launch_tiled<decltype(&flash_kernel<D, false>), float>(
        by_pos ? flash_kernel<D, true> : flash_kernel<D, false>, false, kBr,
        kBc, kBlock, Layout<D>::bytes(stats), D, a);
  }
};

}  // namespace tf32

// ---- the backward's float32 route: Delta, dK and dV, dQ ----------------- //
//
// The gradients of the function above at (q, k, v) against the output's
// gradient dO, from the forward's o and lse (in natural units):
//   P = exp(S * scale - lse)   (S masked as above; a row that keeps no key,
//                              lse = -1e30, has P = 1 / Sk on every key)
//   Delta = rowsum(dO o O)     dV = P^T . dO     dP = dO . V^T
//   dS = P o (dP - Delta)      (0 wherever the mask drops a pair)
//   dQ = scale dS . K          dK = scale dS^T . Q
// in three launches: (a) Delta in f32 into the wrapper's scratch; (b) one
// block per (64-row kv tile, b * H + h) loops over the q tiles that keep a
// key of its tile and writes dK and dV once, or with GQA its q head's
// share of them into f32 scratch, which (d) group_sum_kernel adds up in
// the order of the group's q heads (one block a q head measured no slower
// than a block looping over the group at granite-moe's shape, and 28%
// faster at qwen2-vl's, whose group loop had too few blocks: PERF.md);
// (c) one block per (64-row q tile, b * H + h) loops over the kv tiles it
// keeps and writes dQ once.  No block adds into another's output and no
// sum uses atomics, so two calls give the same bits.  The bfloat16 route (wgmma, TMA, warp specialisation) is
// flash_attention_bwd.cu.
// Bound: operations.  The scores are computed again, then dV, dP, dQ and
// dK: 2.5 times the forward's Q.K^T and P.V over the kept pairs, each a
// split-TF32 product of three tensor-core products (at stablelm-3b's
// training shape 3 x 214.8 GFLOP, 1.30 ms at the card's TF32 rate).
// Design: a block of four warps, a warp owning 16 rows of the block's
// 64-row tile; the block's own tiles and the streamed tiles of each step
// (64 rows up to D 64, else 32, so that two or three blocks share an SM)
// stage in shared memory by cp.async, rows of D + 4 floats (rows past S
// read as zeros).  Every product is mma.sync m16n8k8 TF32 with both
// operands split, x = hi + lo, and a . b = lo.hi + hi.lo + hi.hi summed in
// f32, as the forward's f32 route does (its lo unrounded here: kRoundLo),
// in two forms:
//   `abt`  C = A . B^T, both from shared memory (S^T = K . Q^T and
//          dP^T = V . dO^T in (b), S = Q . K^T and dP = dO . V^T in (c)),
//          each element split where a thread reads it;
//   `ab`   C += P . B, P the f32 accumulator fragments of an earlier
//          product, fed straight from registers: k step kk's accumulator
//          holds columns 2t and 2t + 1 where the A operand wants k indices
//          t and t + 4, so the k step is permuted (A's t is column 2t, its
//          t + 4 column 2t + 1) and B's rows are read in that order, as the
//          forward's P.V does (dV += P^T . dO, dK += dS^T . Q in (b),
//          dQ += dS . K in (c)).  Each step's product is summed apart and
//          added to the running gradient in f32: the tensor cores' own
//          accumulation would carry its error along every q (kv) tile.
// The mask is a uniform run-time switch (0 none, 1 by index, 2 by
// position), applied per element only in a tile pair that holds a masked
// pair or a ragged edge.  By index, (b) starts at the q tile that holds
// its first kv row and (c) stops at the kv tile that holds its last q row;
// by position, (c) walks the kv tiles the forward's `position_tiles` lists
// for its q tile and (b) the q tiles `kv_position_tiles` lists for its kv
// tile (common.cuh; the bf16 route walks the same lists): a q tile with a
// row that keeps no key is on every kv tile's list, since such a row
// averages every key and adds 1 / Sk . dO to every kv row's dV.  Rows past
// S read as zeros: a q row past Sq, with lse and Delta read as 0, adds
// nothing to dK or dV in an unmasked tile pair.
namespace bwd {

using tf32::mma3;
using tf32::split_a;

// lo left unrounded in every split (tf32::split): 8% faster than rounded
// at stablelm-3b's shape; PERF.md has both variants' errors
constexpr bool kRoundLo = false;

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kRows = 16 * kWarps;        // a block's own rows, (b) and (c)
constexpr int kDeltaWarps = 8;            // (a): one warp a row
constexpr float kDead = 0.5f * kNegInf;   // lse at or below: no key kept

enum Mask { kNone = 0, kByIndex = 1, kByPos = 2 };

// The rows a step streams past a block's own tile (q rows in (b), kv rows
// in (c)), and a staged row's floats: with ld = 4 (mod 16) both product
// forms read shared memory with no bank conflict (below).
template <int D> constexpr int kStep = D <= 64 ? 64 : 32;
template <int D> constexpr int kLd = D + 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows first .. first + kN - 1 of a (B, S, heads, D) tensor's (b, head)
// slice (`src` at its row 0, `stride` floats a row) into a tile of kN rows
// of kLd<D> floats; rows at or past n are zeros.  Every thread of the
// block calls this; the caller waits (cp_async_wait_all, __syncthreads).
template <int D, int kN>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          int64_t stride, int first, int n) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kN * kChunks; i += kBlock) {
    const int r = i / kChunks, c = i % kChunks;
    float* dst = tile + r * kLd<D> + 4 * c;
    if (first + r < n)
      cp_async16(dst, src + (first + r) * stride + 4 * c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// C (16 x N) = A . B^T over K columns: A the warp's 16 rows of a staged
// tile, B N rows of another.  In a k step of 8 columns the thread reads
// A's rows g and g + 8 and B's row 8 j + g at columns t and t + 4: word g
// ld + t, which with ld = 4 (mod 16) puts a warp's 32 reads in 32 banks.
template <int K, int N, int ld>
__device__ __forceinline__ void abt(float (&c)[N / 8][4], const float* a,
                                    const float* b) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    split_a<kRoundLo>(a[g * ld + k + t], a[(g + 8) * ld + k + t],
                      a[g * ld + k + t + 4], a[(g + 8) * ld + k + t + 4], ah,
                      al);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mma3<kRoundLo>(c[j], ah, al, b[(8 * j + g) * ld + k + t],
                     b[(8 * j + g) * ld + k + t + 4]);
  }
}

// C (16 x D) += P . B: P (16 x K) the accumulator fragments of an earlier
// product, B K rows of a staged tile.  k step kk takes B's rows 8 kk + 2t
// and 8 kk + 2t + 1 (the permutation above).  Columns go by pairs of n
// tiles: tiles 2m and 2m + 1 take, at the thread's n index g, columns 16 m
// + 2g and 16 m + 2g + 1 of one 8-byte read (32 banks over each half-warp
// with ld = 4 (mod 16)), so the thread's accumulators of the pair hold
// columns 16 m + 4t .. 16 m + 4t + 3 of its rows (`store_rows`).  Two
// pairs at a time are summed over K apart from C and then added to it.
template <int K, int D, int ld>
__device__ __forceinline__ void ab(float (&c)[D / 8][4],
                                   const float (&p)[K / 8][4],
                                   const float* b) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int kPairs = D / 16;
#pragma unroll
  for (int m0 = 0; m0 < kPairs; m0 += 2) {
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_a<kRoundLo>(p[kk][0], p[kk][2], p[kk][1], p[kk][3], ah, al);
      const float* r0 = b + (8 * kk + 2 * t) * ld + 2 * g;
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        if (m0 + mm >= kPairs) continue;
        const float2 y0 =
            *reinterpret_cast<const float2*>(r0 + 16 * (m0 + mm));
        const float2 y1 =
            *reinterpret_cast<const float2*>(r0 + ld + 16 * (m0 + mm));
        mma3<kRoundLo>(s[2 * mm], ah, al, y0.x, y1.x);
        mma3<kRoundLo>(s[2 * mm + 1], ah, al, y0.y, y1.y);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * m0 + j >= D / 8) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) c[2 * m0 + j][e] += s[j][e];
    }
  }
}

// The thread's rows r0 and r0 + 8 (below n) of an `ab` accumulator times
// `mul` into rows `stride` floats apart at `out`.
template <int D>
__device__ __forceinline__ void store_rows(float* out, int64_t stride,
                                           int r0, int n,
                                           const float (&acc)[D / 8][4],
                                           float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= n) continue;
    float* row = out + (r0 + 8 * r) * stride + 4 * t;
#pragma unroll
    for (int m = 0; m < D / 16; ++m)
      *reinterpret_cast<float4*>(row + 16 * m) = make_float4(
          mul * acc[2 * m][2 * r], mul * acc[2 * m + 1][2 * r],
          mul * acc[2 * m][2 * r + 1], mul * acc[2 * m + 1][2 * r + 1]);
  }
}

// (a) Delta (B, H, Sq) f32 = rowsum(dO o O): one warp a (b, i, h) row.
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(const float* __restrict__ o, const float* __restrict__ go,
             float* __restrict__ delta, int64_t rows, int32_t seq_q,
             int32_t heads, int32_t d) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kDeltaWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(o[row * d + c], go[row * d + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t bi = row / heads;         // b * Sq + i
    const int h = static_cast<int>(row % heads);
    const int64_t b = bi / seq_q;
    const int i = static_cast<int>(bi % seq_q);
    delta[(b * heads + h) * seq_q + i] = acc;
  }
}

// The GQA group's dK and dV from the q heads' shares (`part`: f32, dK's
// (B, Sk, H, D) then dV's, `plane` floats apart), added in the order of the
// group's q heads, dK times `scale`: a thread a 4-column chunk of a (b, j,
// kv head) row.
__global__ void __launch_bounds__(32 * kDeltaWarps)
group_sum_kernel(const float* __restrict__ part, float* __restrict__ dk,
                 float* __restrict__ dv, int64_t chunks, int64_t plane,
                 int32_t kv_heads, int32_t group, int32_t d, float scale) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * (32 * kDeltaWarps) + threadIdx.x;
  if (c >= chunks) return;
  const int64_t row = c / (d / 4);           // (b * Sk + j) * KV + hk
  const int col = static_cast<int>(c % (d / 4)) * 4;
  const int64_t bj = row / kv_heads;
  const int hk = static_cast<int>(row % kv_heads);
  const float* src =
      part + (bj * kv_heads + hk) * static_cast<int64_t>(group) * d + col;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = src + which * plane;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < group; ++g) {
      const float4 y = __ldg(reinterpret_cast<const float4*>(p + g * d));
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
    const float mul = which == 0 ? scale : 1.f;
    *reinterpret_cast<float4*>((which == 0 ? dk : dv) + row * d + col) =
        make_float4(mul * x.x, mul * x.y, mul * x.z, mul * x.w);
  }
}

// The arguments of the backward's launches.
struct BwdArgs {
  const float *go, *q, *k, *v, *o;
  const float* lse;
  float* delta;                 // scratch (B, H, Sq) f32
  float* part;                  // scratch 2 x (B, Sk, H, D) f32, or null
  float *dq, *dk, *dv;
  int32_t b, sq, sk, h, kvh, mask;
  const int32_t *q_pos, *k_pos;
  float scale;
  cudaStream_t stream;
};

// Shared memory of (b) and (c) in bytes: two tiles of the block's own
// rows, two of a step's, `per_row` ints for each row of a step, and the
// position mask's `stats` ints.
template <int D>
constexpr int bwd_smem(int per_row, int stats) {
  return 4 * ((2 * kRows + 2 * kStep<D>) * kLd<D> + per_row * kStep<D> +
              stats);
}

// (b) dK and dV of one 64-row kv tile of q head h's kv head hk in batch
// row b; with GQA (`part` given) h's share of them goes to `part` (f32,
// dK's (B, Sk, H, D) then dV's) for group_sum_kernel to add up.  At D 80
// three blocks' shared memory fits an SM, and the registers are held to
// three blocks' share (168 a thread, spilling 120 bytes); unasked, ptxas
// took 178, two blocks an SM, which measured slower (PERF.md).
template <int D>
__global__ void __launch_bounds__(kBlock, D == 80 ? 3 : 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ go,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ part, int32_t seq_q,
            int32_t seq_k, int32_t heads, int32_t kv_heads, int32_t bh_total,
            int32_t mask, const int32_t* __restrict__ q_pos,
            const int32_t* __restrict__ k_pos, float scale_log2,
            float scale) {
  constexpr int kS = kStep<D>, ld = kLd<D>;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + kRows * ld;
  float* s_q = s_v + kRows * ld;
  float* s_do = s_q + kS * ld;
  float* s_lse = s_do + kS * ld;           // log2 units
  float* s_delta = s_lse + kS;
  int* s_qp = reinterpret_cast<int*>(s_delta + kS);
  int* stats = s_qp + kS;                  // the position mask's list
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // the heaviest causal tiles (the first) of every head first
  const int bh = static_cast<int>(blockIdx.x) % bh_total;  // b * H + h
  const int kt = static_cast<int>(blockIdx.x) / bh_total;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int k0 = kt * kRows;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * D;
  const int64_t q_stride = static_cast<int64_t>(heads) * D;
  const int64_t kv_base = static_cast<int64_t>(b) * seq_k * kv_stride +
                          static_cast<int64_t>(hk) * D;
  load_rows<D, kRows>(s_k, k + kv_base, kv_stride, k0, seq_k);
  load_rows<D, kRows>(s_v, v + kv_base, kv_stride, k0, seq_k);

  // the q tiles to visit: by index from the one that holds the tile's
  // first kv row; by position the ones `kv_position_tiles` lists
  const int n_qt = (seq_q + kS - 1) / kS;
  int n_list, qt0 = 0;
  if (mask == kByPos) {
    n_list = kv_position_tiles<kS, kRows>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, k0, n_qt,
        stats);
  } else {
    qt0 = mask == kByIndex ? k0 / kS : 0;
    n_list = n_qt - qt0;
  }
  const int* list = stats + 2 * n_qt;

  // the thread's kv rows j0 and j0 + 8 (the columns of S^T are q rows)
  const int j0 = k0 + 16 * warp + g;
  int kp[2] = {0, 0};
  if (mask == kByPos)
    for (int r = 0; r < 2; ++r)
      if (j0 + 8 * r < seq_k)
        kp[r] = k_pos[static_cast<int64_t>(b) * seq_k + j0 + 8 * r];
  const float inv_sk = 1.f / static_cast<float>(seq_k);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  const int64_t q_base = static_cast<int64_t>(b) * seq_q * q_stride +
                         static_cast<int64_t>(h) * D;
  const int64_t row_base = static_cast<int64_t>(bh) * seq_q;
  for (int it = 0; it < n_list; ++it) {
    const int entry = mask == kByPos ? list[it] : qt0 + it;
    const int q0 = (entry & ~kMaskBit) * kS;
    // a masked pair in the tile pair: by index where a q row precedes
    // a kv row; by position as the list says
    const bool edge = mask == kByPos ? (entry & kMaskBit) != 0
                                     : mask == kByIndex &&
                                           q0 < k0 + kRows - 1;
    __syncthreads();          // every warp is done with the last step
    load_rows<D, kS>(s_q, q + q_base, q_stride, q0, seq_q);
    load_rows<D, kS>(s_do, go + q_base, q_stride, q0, seq_q);
    for (int i = threadIdx.x; i < kS; i += kBlock) {
      const bool in = q0 + i < seq_q;
      s_lse[i] = in ? lse[row_base + q0 + i] * kLog2e : 0.f;
      s_delta[i] = in ? delta[row_base + q0 + i] : 0.f;
      if (mask == kByPos)
        s_qp[i] = in ? q_pos[static_cast<int64_t>(b) * seq_q + q0 + i]
                     : INT32_MIN;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K . Q^T and dP^T = V . dO^T over the warp's 16 kv rows;
    // then P^T into s and dS^T = P^T o (dP^T - Delta) into ds
    float s[kS / 8][4], ds[kS / 8][4];
    abt<D, kS, ld>(s, s_k + 16 * warp * ld, s_q);
    abt<D, kS, ld>(ds, s_v + 16 * warp * ld, s_do);
#pragma unroll
    for (int j = 0; j < kS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * j + 2 * t + (e & 1);      // q row in the step
        float p;
        bool kept = true;
        if (!edge) {
          p = exp2f(s[j][e] * scale_log2 - s_lse[ci]);
        } else {
          const int i = q0 + ci, jr = j0 + 8 * (e >> 1);
          const bool in = i < seq_q && jr < seq_k;
          kept = in;
          if (mask == kByIndex) kept = kept && jr <= i;
          if (mask == kByPos) kept = kept && s_qp[ci] >= kp[e >> 1];
          p = kept ? exp2f(s[j][e] * scale_log2 - s_lse[ci]) : 0.f;
          if (mask == kByPos && s_lse[ci] <= kDead * kLog2e)
            p = in ? inv_sk : 0.f;  // a row with no key averages every key
        }
        s[j][e] = p;
        ds[j][e] = kept ? p * (ds[j][e] - s_delta[ci]) : 0.f;
      }
    // dV += P^T . dO; dK += dS^T . Q
    ab<kS, D, ld>(acc_dv, s, s_do);
    ab<kS, D, ld>(acc_dk, ds, s_q);
  }

  if (part != nullptr) {
    // the q head's share, unscaled, at (b, j, h) of each f32 plane
    const int64_t plane = static_cast<int64_t>(bh_total) * seq_k * D;
    float* pk = part + (static_cast<int64_t>(b) * seq_k + k0) * q_stride +
                static_cast<int64_t>(h) * D;
    store_rows<D>(pk, q_stride, 16 * warp + g, seq_k - k0, acc_dk, 1.f);
    store_rows<D>(pk + plane, q_stride, 16 * warp + g, seq_k - k0, acc_dv,
                  1.f);
    return;
  }
  const int64_t dst = kv_base + static_cast<int64_t>(k0) * kv_stride;
  store_rows<D>(dk + dst, kv_stride, 16 * warp + g, seq_k - k0, acc_dk,
                scale);
  store_rows<D>(dv + dst, kv_stride, 16 * warp + g, seq_k - k0, acc_dv,
                1.f);
}

// (c) dQ of one 64-row q tile of q head h in batch row b.
template <int D>
__global__ void __launch_bounds__(kBlock)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ go,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int32_t seq_q, int32_t seq_k, int32_t heads,
          int32_t kv_heads, int32_t bh_total, int32_t mask,
          const int32_t* __restrict__ q_pos,
          const int32_t* __restrict__ k_pos, float scale_log2,
          float scale) {
  constexpr int kS = kStep<D>, ld = kLd<D>;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = s_q + kRows * ld;
  float* s_k = s_do + kRows * ld;
  float* s_v = s_k + kS * ld;
  int* s_kp = reinterpret_cast<int*>(s_v + kS * ld);
  int* stats = s_kp + kS;                  // the position mask's list
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // the heaviest causal tiles (the last) of every head first
  const int n_qt = (seq_q + kRows - 1) / kRows;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_total;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kRows;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * D;
  const int64_t q_stride = static_cast<int64_t>(heads) * D;
  const int64_t q_base = static_cast<int64_t>(b) * seq_q * q_stride +
                         static_cast<int64_t>(h) * D;
  const int64_t kv_base = static_cast<int64_t>(b) * seq_k * kv_stride +
                          static_cast<int64_t>(hk) * D;
  load_rows<D, kRows>(s_q, q + q_base, q_stride, q0, seq_q);
  load_rows<D, kRows>(s_do, go + q_base, q_stride, q0, seq_q);

  // the kv tiles to visit: by index up to the one that holds the tile's
  // last q row; by position the ones `position_tiles` lists
  const int n_kt = (seq_k + kS - 1) / kS;
  int n_list;
  if (mask == kByPos)
    n_list = position_tiles<kS, kRows>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, q0, n_kt,
        stats);
  else
    n_list = mask == kByIndex ? (min(q0 + kRows, seq_q) + kS - 1) / kS
                              : n_kt;
  const int* list = stats + 2 * n_kt;

  // the thread's q rows i0 and i0 + 8: lse (log2 units), Delta, position
  const int i0 = q0 + 16 * warp + g;
  const int64_t row_base = static_cast<int64_t>(bh) * seq_q;
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  int qp[2] = {INT32_MIN, INT32_MIN};
  bool dead[2] = {false, false};
  for (int r = 0; r < 2; ++r)
    if (i0 + 8 * r < seq_q) {
      lse2[r] = lse[row_base + i0 + 8 * r] * kLog2e;
      dl[r] = delta[row_base + i0 + 8 * r];
      // a row with no key averages every key: its dS is 0 throughout
      dead[r] = mask == kByPos && lse2[r] <= kDead * kLog2e;
      if (mask == kByPos)
        qp[r] = q_pos[static_cast<int64_t>(b) * seq_q + i0 + 8 * r];
    }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_list; ++it) {
    const int entry = mask == kByPos ? list[it] : it;
    const int k0 = (entry & ~kMaskBit) * kS;
    // a masked pair or a kv column past Sk in the tile pair
    const bool edge = mask == kByPos
                          ? (entry & kMaskBit) != 0
                          : k0 + kS > seq_k ||
                                (mask == kByIndex && k0 + kS - 1 > q0);
    __syncthreads();            // every warp is done with the last step
    load_rows<D, kS>(s_k, k + kv_base, kv_stride, k0, seq_k);
    load_rows<D, kS>(s_v, v + kv_base, kv_stride, k0, seq_k);
    if (mask == kByPos)
      for (int j = threadIdx.x; j < kS; j += kBlock)
        s_kp[j] = k0 + j < seq_k
                      ? k_pos[static_cast<int64_t>(b) * seq_k + k0 + j]
                      : 0;
    cp_async_wait_all();
    __syncthreads();

    // S = Q . K^T, dP = dO . V^T over the warp's 16 q rows; dS in dP
    float s[kS / 8][4], ds[kS / 8][4];
    abt<D, kS, ld>(s, s_q + 16 * warp * ld, s_k);
    abt<D, kS, ld>(ds, s_do + 16 * warp * ld, s_v);
#pragma unroll
    for (int j = 0; j < kS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool kept = true;
        if (edge) {
          const int cj = 8 * j + 2 * t + (e & 1);
          const int jc = k0 + cj, i = i0 + 8 * r;
          kept = i < seq_q && jc < seq_k && !dead[r];
          if (mask == kByIndex) kept = kept && jc <= i;
          if (mask == kByPos) kept = kept && qp[r] >= s_kp[cj];
        }
        ds[j][e] = kept ? exp2f(s[j][e] * scale_log2 - lse2[r]) *
                              (ds[j][e] - dl[r])
                        : 0.f;
      }
    // dQ += dS . K
    ab<kS, D, ld>(acc, ds, s_k);
  }

  store_rows<D>(dq + q_base + static_cast<int64_t>(q0) * q_stride, q_stride,
                16 * warp + g, seq_q - q0, acc, scale);
}

template <int D> int bwd_run(const BwdArgs& a) {
  const float scale_log2 = a.scale * kLog2e;
  const bool by_pos = a.mask == kByPos;
  constexpr int kS = kStep<D>;
  // (a) Delta
  const int64_t rows = static_cast<int64_t>(a.b) * a.sq * a.h;
  const int64_t blocks_a = (rows + kDeltaWarps - 1) / kDeltaWarps;
  const int64_t bh_kv = static_cast<int64_t>(a.b) * a.kvh;
  const int64_t bh_q = static_cast<int64_t>(a.b) * a.h;
  // a block a q head; with GQA its shares into the scratch, then their sum
  const bool split = a.h != a.kvh;
  if (split && a.part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks_b = bh_q * ((a.sk + kRows - 1) / kRows);
  const int64_t blocks_c = bh_q * ((a.sq + kRows - 1) / kRows);
  if (blocks_a > INT32_MAX || blocks_b > INT32_MAX || blocks_c > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<<<static_cast<unsigned>(blocks_a), 32 * kDeltaWarps, 0,
                 a.stream>>>(a.o, a.go, a.delta, rows, a.sq, a.h, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // (b) dK and dV: a step's lse, Delta and q positions; the q tile list
  const int smem_b = bwd_smem<D>(
      3, by_pos ? stats_ints((a.sq + kS - 1) / kS) : 0);
  err = cudaFuncSetAttribute(dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<D><<<static_cast<unsigned>(blocks_b), kBlock, smem_b,
                   a.stream>>>(
      a.q, a.k, a.v, a.go, a.lse, a.delta, a.dk, a.dv,
      split ? a.part : nullptr, a.sq, a.sk, a.h, a.kvh,
      static_cast<int32_t>(bh_q), a.mask, a.q_pos, a.k_pos, scale_log2,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (split) {
    const int64_t chunks = bh_kv * a.sk * (D / 4);
    const int64_t blocks = (chunks + 32 * kDeltaWarps - 1) /
                           (32 * kDeltaWarps);
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    group_sum_kernel<<<static_cast<unsigned>(blocks), 32 * kDeltaWarps, 0,
                       a.stream>>>(a.part, a.dk, a.dv, chunks,
                                   bh_q * a.sk * D, a.kvh, a.h / a.kvh, D,
                                   a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // (c) dQ: a step's k positions; the kv tile list
  const int smem_c = bwd_smem<D>(
      1, by_pos ? stats_ints((a.sk + kS - 1) / kS) : 0);
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<static_cast<unsigned>(blocks_c), kBlock, smem_c,
                 a.stream>>>(
      a.q, a.k, a.v, a.go, a.lse, a.delta, a.dq, a.sq, a.sk, a.h, a.kvh,
      static_cast<int32_t>(bh_q), a.mask, a.q_pos, a.k_pos, scale_log2,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

int bwd_by_head_dim(int32_t d, const BwdArgs& a) {
  switch (d) {
#define REPRO_FA_BWD_CASE(D) \
  case D: return bwd_run<D>(a);
    REPRO_FA_BWD_CASE(16)
    REPRO_FA_BWD_CASE(32)
    REPRO_FA_BWD_CASE(64)
    REPRO_FA_BWD_CASE(80)
    REPRO_FA_BWD_CASE(96)
    REPRO_FA_BWD_CASE(128)
#undef REPRO_FA_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd
}  // namespace

// q (b, sq, h, d), k and v (b, sk, kvh, d), o like q, all contiguous with
// 16-byte-aligned data, of bfloat16 (flash_attention_tc_fwd) or float32
// (flash_attention_f32_fwd); d one of 16, 32, 64, 80, 96, 128; `causal`
// needs sq == sk, and with q_pos (b, sq) and k_pos (b, sk) int32 masks by
// position (both null: by index); `scale` multiplies q . k (D^-1/2).
// Non-null `lse` (b, h, sq) f32 receives each row's log-sum-exp of its
// kept scaled scores (natural units; null, as serving passes, writes
// nothing).  Launch on `stream`; return cudaGetLastError()
// (cudaErrorNotSupported where cuTensorMapEncodeTiled is not found).
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int32_t b, int32_t sq, int32_t sk,
                                      int32_t h, int32_t kvh, int32_t d,
                                      int32_t causal, const int32_t* q_pos,
                                      const int32_t* k_pos, float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaGetLastError());
  return by_head_dim<bf16::Launch>(
      d, Args{q, k, v, o, lse, b, sq, sk, h, kvh, causal, q_pos, k_pos,
              scale, static_cast<cudaStream_t>(stream)});
}

extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int32_t b, int32_t sq, int32_t sk,
                                       int32_t h, int32_t kvh, int32_t d,
                                       int32_t causal, const int32_t* q_pos,
                                       const int32_t* k_pos, float scale,
                                       void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaGetLastError());
  return by_head_dim<tf32::Launch>(
      d, Args{q, k, v, o, lse, b, sq, sk, h, kvh, causal, q_pos, k_pos,
              scale, static_cast<cudaStream_t>(stream)});
}

// The gradients of the function above at (q, k, v) against go (like q),
// given its o and lse (b, h, sq) f32 from a forward at the same arguments:
// dq like q, dk and dv like k, of float32 (flash_attention_f32_bwd; the
// bfloat16 route, flash_attention_tc_bwd, is flash_attention_bwd.cu), all
// contiguous with 16-byte-aligned data; `delta` is (b, h, sq) f32
// scratch; `part` (2 x (b, sk, h, d) f32 scratch, the GQA group's q heads'
// shares of dK and dV) is needed where h != kvh, else null.  Three
// launches (four with GQA) on `stream`; return cudaGetLastError()
// (cudaErrorInvalidValue for a head dim the kernels are not built for, a
// grid of 2**31 blocks or more, or GQA without `part`).
extern "C" int flash_attention_f32_bwd(const void* go, const void* q,
                                       const void* k, const void* v,
                                       const void* o, const float* lse,
                                       float* delta, float* part, void* dq,
                                       void* dk, void* dv, int32_t b,
                                       int32_t sq, int32_t sk, int32_t h,
                                       int32_t kvh,
                                       int32_t d, int32_t causal,
                                       const int32_t* q_pos,
                                       const int32_t* k_pos, float scale,
                                       void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaGetLastError());
  const int32_t mask = q_pos != nullptr ? bwd::kByPos
                       : causal         ? bwd::kByIndex
                                        : bwd::kNone;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return bwd::bwd_by_head_dim(
      d, bwd::BwdArgs{f(go), f(q), f(k), f(v), f(o), lse, delta, part,
                      static_cast<float*>(dq), static_cast<float*>(dk),
                      static_cast<float*>(dv), b, sq, sk, h, kvh, mask, q_pos,
                      k_pos, scale, static_cast<cudaStream_t>(stream)});
}
