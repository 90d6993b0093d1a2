// The backward of B7's flash attention in bfloat16 for Hopper (sm_90a):
// wgmma fed by TMA, in warp-specialised blocks.
//
// Replaces: no TPU kernel.  The reference's training differentiates XLA's
//   dense attention (src/repro/models/attention.py, _dense_attn); this is
//   the gradient of the bfloat16 route of flash_attention.cu
//   (flash_attention_tc_fwd) and takes what it takes: q (B, Sq, H, D) and
//   k, v (B, Sk, KV, D) in model layout, q head h reading kv head
//   h / (H / KV) in place, any Sq and Sk non-causally, causal by index at
//   Sq == Sk or by int32 positions q_pos (B, Sq), k_pos (B, Sk).
// Computes, from the forward's o and its rows' lse (B, H, Sq) f32 in
//   natural units, against the output's gradient dO:
//     P = exp(S * scale - lse)   (S masked as the forward masks it; a row
//                                that keeps no key, lse = -1e30, has
//                                P = 1 / Sk on every key)
//     Delta = rowsum(dO o O)     dV = P^T . dO     dP = dO . V^T
//     dS = P o (dP - Delta)      (0 wherever the mask drops a pair)
//     dQ = scale dS . K          dK = scale dS^T . Q
//   with P and dS rounded to bf16 for the products that take them, every
//   sum in f32, dq, dk and dv in bf16.
// Bound: operations.  The scores again, then dV, dP, dQ and dK: 2.5 times
//   the forward's Q.K^T and P.V over the kept pairs.  At stablelm-3b's
//   training shape (1 x 4,096 x 32 x 80, causal) 214.8 GFLOP, 0.217 ms at
//   the card's bf16 tensor rate against 0.004 ms of bytes.
// Design: three launches (four where a GQA group is split, below), as the
//   float32 route (flash_attention.cu, bwd), in namespace bwd.
//   (a) Delta: one thread a (b, i, h) row, reading o and dO 16 bytes at a
//       time, the sum in a fixed order.
//   (b) dK, dV: a block of three warpgroups per (128-row kv tile,
//       b * KV + kv head), the heaviest causal tiles (the first) of every
//       head first.  Warpgroup 0 produces (setmaxnreg down to 24): one
//       thread loads k and v once by TMA, then the 64-row q and dO tiles of
//       each step into a ring of two stages with full and empty mbarriers;
//       its second warp copies each step's rows of lse (log2 units), Delta
//       and q positions into the stage with plain loads (lse and Delta are
//       (B, H, Sq) f32 rows, whose 4-byte stride no tensor map takes at
//       Sq % 4 != 0).  Warpgroups 1 and 2 consume (setmaxnreg up to 240),
//       each owning 64 kv rows and holding their dK and dV in registers.
//       A step is one q tile of one q head: a block loops over the q heads
//       of its kv head's GQA group, so the group's sum stays in the block,
//       or, where the caller gives f32 scratch (the wrapper does where
//       those blocks would be fewer than the card's SMs), a block takes
//       one q head, writes its share of dK and dV there, and one more
//       launch (group_sum_tc) adds the group's shares in the order of its
//       q heads.  Each q tile:
//         S^T  = K . Q^T      wgmma ss m64n64, both K-major as TMA wrote
//                             them, over D in steps of 16 (the zero
//                             columns of the padded box are not read);
//         dP^T = V . dO^T     the same, issued at once, so both run while
//                             the first is waited for;
//         P^T in registers    exp2 of the scaled scores less the column's
//                             lse, masked per element only in a tile that
//                             holds a masked pair (by index, the diagonal;
//                             by position, as the tile list says);
//         dV  += P^T . dO     wgmma rs: P^T packed to bf16 straight from
//                             the accumulator fragments into the register
//                             A operand, dO MN-major through the
//                             descriptor (no transposed copy);
//         dS^T in registers   P^T o (dP^T - Delta);
//         dK  += dS^T . Q     wgmma rs, q MN-major through the descriptor,
//                             left running into the next step's S^T and
//                             dP^T (the stage is released, and the packed
//                             operand reused, once those are waited for).
//       dV's and dK's width is D itself (n16 .. n128: at D 80, 80 columns,
//       not the 128 of the padded box, which 64-column boxes would cost);
//       at D 128 a consumer holds dK and dV (64 + 64 f32), S^T and dP^T
//       (32 + 32) and one packed A operand (16): dS^T is packed once dV's
//       product, which reads P^T's, is done.  Each score product's first k
//       step writes its accumulator as an output only (wgmma_ss_n*_first):
//       with an in-out accumulator the compiler carried the last step's
//       values into the product, copied registers between its k steps and
//       had ptxas insert a wait for the tensor cores before each copy, and
//       D 128's dK / dV kernels spilled; now nothing spills.
//   (c) dQ: the same block shape per (128-row q tile, b * H + h), the
//       heaviest causal tiles (the last) first; q and dO resident, k and v
//       tiles of kKvStep rows through the ring (the forward's Barriers and
//       Loader): 128 at D up to 80, where a consumer's S, dP (64 + 64 f32),
//       dQ and packed dS fit its registers, else 64.  S = Q . K^T and
//       dP = dO . V^T (ss, n128 or n64), dS in registers, dQ += dS . K
//       (rs, k MN-major), left running into the next step.  The scores and
//       dP are computed a second time here (7 products where the bound
//       counts 5): that keeps every output written by one block, in one
//       order, with no atomics, so two calls give the same bits.
//   Under the position mask (c) visits the kv tiles the forward's
//   `position_tiles` lists for its q tile, and (b) its transpose
//   (`kv_position_tiles`): for each kv tile, the q tiles that keep a pair
//   of it, and every q tile that holds a row with no key, since such a row
//   averages every key and adds 1 / Sk . dO to every kv row's dV.  By
//   index, (b) starts at the q tile of its first kv row and (c) stops at
//   the kv tile of its last q row.  Rows past S arrive from TMA as zeros:
//   with lse and Delta read as 0 there, such a q row adds nothing to dK or
//   dV and needs no mask; kv rows past Sk are masked in (c) and never
//   stored by (b).
//   A block asks for at least 116 KB of shared memory, so no two share an
//   SM (each setmaxnreg.inc needs the registers its own producer gives up).
//   The launcher first makes the data's device current on the calling
//   thread (`bind_device`, common.cuh): the tensor maps' encoder is a
//   driver call.
//   PERF.md keeps the times beside the bound.
#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {
namespace bwd {

using namespace repro_torch::sm90;

constexpr int kBlock = 384;       // the producer warpgroup and two consumers
constexpr int kStages = 2;        // the ring: (b)'s q, dO and (c)'s k, v
constexpr int kBox = 64;          // columns a TMA box: 128 bytes, the swizzle
constexpr int kOwn = 128;         // a block's own rows: kv in (b), q in (c)
constexpr int kStep = 64;         // q rows a step of (b) streams
// kv rows a step of (c) streams: 128 where a consumer's scores, dP and dQ
// (64 + 64 + D / 2 f32) and the packed dS (32) fit its registers
template <int D> constexpr int kKvStep = D <= 80 ? 128 : 64;
constexpr int kDeltaBlock = 256;  // (a): one thread a row
constexpr float kDead = 0.5f * kNegInf * kLog2e;   // lse (log2) at or below:
                                                   // the row keeps no key

template <int D, int kS> struct Layout {   // kS rows a streamed tile
  static_assert(D % 16 == 0 && D >= 16 && D <= 2 * kBox,
                "the bf16 backward takes D a multiple of 16, up to 128");
  // D padded to whole boxes; TMA fills the columns past D with zeros
  static constexpr int kPad = (D + kBox - 1) / kBox * kBox;
  static constexpr int kBoxes = kPad / kBox;
  static constexpr int kOwnBytes = kOwn * kPad * 2;     // a resident tile
  static constexpr int kStepBytes = kS * kPad * 2;      // a streamed tile
  static constexpr int kRowStage = 3 * kS * 4;          // (b): lse, Delta, qp
  // offsets from a 1024-byte-aligned base (the 128-byte swizzle repeats
  // every 8 rows, and wgmma's descriptors assume that alignment)
  static constexpr int kA = 0;                        // k (b) / q (c)
  static constexpr int kB = kOwnBytes;                // v (b) / dO (c)
  static constexpr int kC = 2 * kOwnBytes;            // stages: q / k
  static constexpr int kD = kC + kStages * kStepBytes;    // stages: dO / v
  static constexpr int kRows = kD + kStages * kStepBytes;
  static constexpr int kBars = kRows + kStages * kRowStage;
  // the position mask's tile statistics
  static constexpr int kStats = (kBars + Barriers<kStages>::kBytes + 15) /
                                16 * 16;
  static constexpr int kUsed = kStats + 1024;
  static constexpr int bytes(int stats) {
    return kUsed + stats > 116 * 1024 ? kUsed + stats : 116 * 1024;
  }
};

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma shapes the forward does not use ---------------------------- //

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x N, f32) = A (64 x 16) . B (16 x N), A and B K-major in shared
// memory (128-byte swizzle): a product's first k step, N 64 or 128.  D is
// an output only, so the compiler carries no earlier value of it into the
// product (an in-out D ties the k steps' registers to the loop's last
// values and costs copies between k steps, each one a wait for the tensor
// cores).
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b) {
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// D (64 x 16, f32) += A (64 x 16, bf16 in registers) . B (16 x 16), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers) . B (16 x 32), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, bf16 in registers) . B (16 x 80), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// D (64 x 96, f32) += A (64 x 16, bf16 in registers) . B (16 x 96), B
// MN-major in shared memory (128-byte swizzle, transposed through the
// descriptor).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(1));
}

// One k step of D (64 x W, f32) += A (64 x 16, bf16 in registers) . B,
// B MN-major in shared memory, at each width W.  dK, dV and dQ take W = D:
// wgmma takes any width that is a multiple of 8, and a B operand MN-major
// across 64-column boxes reads each box at the descriptor's leading byte
// offset, the last one in part (D 80: one box and 16 columns of the next).
__device__ __forceinline__ void rs_step(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t b) {
  wgmma_rs_n16(d, a, b);
}
__device__ __forceinline__ void rs_step(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n32(d, a, b);
}
__device__ __forceinline__ void rs_step(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
__device__ __forceinline__ void rs_step(float (&d)[40],
                                        const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n80(d, a, b);
}
__device__ __forceinline__ void rs_step(float (&d)[48],
                                        const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n96(d, a, b);
}
__device__ __forceinline__ void rs_step(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// d (64 x 64) = A . B^T over D: A the 64 rows at `a`, B the 64 rows at `b`,
// both K-major with their 64-column boxes `a_box` and `b_box` bytes apart;
// the D / 16 k steps of 32 bytes within a swizzled row.
template <int D>
__device__ __forceinline__ void ss_64(float (&d)[32], uint32_t a,
                                      uint32_t a_box, uint32_t b,
                                      uint32_t b_box) {
  wgmma_ss_n64_first(d, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(d,
                 sw128_desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                 sw128_desc(b + (kk / 4) * b_box + (kk % 4) * 32, 16, 1024),
                 1);
}

// d (64 x 128) = A . B^T over D, as ss_64 at wgmma's n128.
template <int D>
__device__ __forceinline__ void ss_128(float (&d)[64], uint32_t a,
                                       uint32_t a_box, uint32_t b,
                                       uint32_t b_box) {
  wgmma_ss_n128_first(d, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n128(d,
                  sw128_desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                  sw128_desc(b + (kk / 4) * b_box + (kk % 4) * 32, 16, 1024),
                  1);
}

// d = A . B^T over D at the accumulator's width, 64 or 128.
template <int D>
__device__ __forceinline__ void ss_n(float (&d)[32], uint32_t a,
                                     uint32_t a_box, uint32_t b,
                                     uint32_t b_box) {
  ss_64<D>(d, a, a_box, b, b_box);
}
template <int D>
__device__ __forceinline__ void ss_n(float (&d)[64], uint32_t a,
                                     uint32_t a_box, uint32_t b,
                                     uint32_t b_box) {
  ss_128<D>(d, a, a_box, b, b_box);
}

// d (64 x W) += A (64 x K, packed in registers) . B (the K rows at `b`,
// MN-major: their W columns, boxes `b_box` bytes apart, are wgmma's N),
// in k steps of 16 rows (2,048 bytes).
template <int W, int K>
__device__ __forceinline__ void rs_k(float (&d)[W / 2],
                                     const uint32_t (&a)[K / 16][4],
                                     uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    rs_step(d, a[kk], sw128_desc(b + kk * 16 * kRowBytes, b_box, 1024));
}

// The A operand of a product over the N columns of an accumulator x (64 x
// N, f32): k step kk is x's registers 8 kk .. 8 kk + 7, paired in order
// (the f32 layout of a 16-column slice is the bf16 A layout), rounded.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Zeroes an accumulator.
template <int N> __device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Stores the thread's rows r0 and r0 + 8 (below `rows`) of a (64 x D) f32
// accumulator times `mul` into bf16 rows `stride` elements apart at `out`:
// in every 8-column group the thread holds columns cq, cq + 1.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           int64_t stride, int r0, int rows,
                                           int cq, const float (&acc)[D / 2],
                                           float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* p = out + row * stride + cq;
#pragma unroll
    for (int g = 0; g < D / 8; ++g)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * g) =
          __floats2bfloat162_rn(mul * acc[4 * g + 2 * r],
                                mul * acc[4 * g + 2 * r + 1]);
  }
}

// (a) Delta (B, H, Sq) f32 = rowsum(dO o O): one thread a (b, i, h) row,
// neighbouring threads on neighbouring rows of o and dO.
template <int D>
__global__ void __launch_bounds__(kDeltaBlock)
delta_tc(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ go, float* __restrict__ delta,
         int64_t rows, int32_t seq_q, int32_t heads) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kDeltaBlock + threadIdx.x;
  if (r >= rows) return;                 // r = (b * Sq + i) * H + h
  const int h = static_cast<int>(r % heads);
  const int64_t bi = r / heads;
  const int i = static_cast<int>(bi % seq_q);
  const int64_t b = bi / seq_q;
  const uint4* po = reinterpret_cast<const uint4*>(o + r * D);
  const uint4* pg = reinterpret_cast<const uint4*>(go + r * D);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 x = __ldg(po + c), y = __ldg(pg + c);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = __bfloat1622float2(xa[e]);
      const float2 yf = __bfloat1622float2(ya[e]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
  }
  delta[(b * heads + h) * seq_q + i] = acc;
}

// The GQA group's dK and dV from the q heads' shares (`part`: f32, dK's
// (B, Sk, H, D) then dV's, `plane` floats apart), added in the order of the
// group's q heads, dK times `scale`, rounded to bf16: one thread 8 columns
// of one (b, j, kv head) row.
template <int D>
__global__ void __launch_bounds__(kDeltaBlock)
group_sum_tc(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int64_t chunks, int64_t plane,
             int32_t kv_heads, int32_t group, float scale) {
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * kDeltaBlock + threadIdx.x;
  if (c >= chunks) return;
  const int64_t row = c / (D / 8);           // (b * Sk + j) * KV + hk
  const int col = static_cast<int>(c % (D / 8)) * 8;
  const int64_t bj = row / kv_heads;
  const int hk = static_cast<int>(row % kv_heads);
  const float* src =
      part + (bj * kv_heads * group + static_cast<int64_t>(hk) * group) * D +
      col;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* p = src + which * plane;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
    for (int g = 0; g < group; ++g) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(p + g * D));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(p + g * D + 4));
      x[0] += lo.x, x[1] += lo.y, x[2] += lo.z, x[3] += lo.w;
      x[4] += hi.x, x[5] += hi.y, x[6] += hi.z, x[7] += hi.w;
    }
    const float mul = which == 0 ? scale : 1.f;
    __nv_bfloat162 out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = __floats2bfloat162_rn(mul * x[2 * e], mul * x[2 * e + 1]);
    *reinterpret_cast<uint4*>((which == 0 ? dk : dv) + row * D + col) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// (b) dK and dV of one 128-row kv tile of kv head hk in batch row b: over
// the q heads of hk's group, or with kSplit over one q head h alone, whose
// share of dK and dV goes to `part` (f32, dK's (B, Sk, H, D) then dV's)
// for `group_sum_tc` to add up.
template <int D, bool kByPos, bool kSplit>
__global__ void __launch_bounds__(kBlock, 1)
dkdv_tc(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        float* __restrict__ part, int32_t seq_q, int32_t seq_k,
        int32_t heads, int32_t kv_heads, int32_t bh_total, int32_t causal,
            const int32_t* __restrict__ q_pos,
            const int32_t* __restrict__ k_pos, float scale_log2,
            float scale) {
  using L = Layout<D, kStep>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  // q_full: k and v; k_full(st): a step's q and dO; v_full(st): its rows
  const Barriers<kStages> bars{base + L::kBars};

  // the heaviest causal tiles (the first) of every head first
  const int kt = static_cast<int>(blockIdx.x) / bh_total;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int group = heads / kv_heads;
  // the block's q heads: h0 .. h0 + n_heads - 1, all of kv head hk
  const int b = bh / (kSplit ? heads : kv_heads);
  const int h0 = kSplit ? bh % heads : bh % kv_heads * group;
  const int hk = h0 / group;
  const int n_heads = kSplit ? 1 : group;
  const int k0 = kt * kOwn;
  const int n_qt = (seq_q + kStep - 1) / kStep;
  int* const list = reinterpret_cast<int*>(sm + L::kStats) + 2 * n_qt;

  if (threadIdx.x == 0) bars.init(2 * 128);
  // by index, a q tile wholly before the kv tile keeps none of its keys;
  // by position, the q tiles `kv_position_tiles` lists
  int n_list, qt0 = 0;
  if constexpr (kByPos) {
    n_list = kv_position_tiles<kStep, kOwn>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, k0, n_qt,
        list - 2 * n_qt);
  } else {
    qt0 = causal ? k0 / kStep : 0;
    n_list = n_qt - qt0;
  }
  __syncthreads();
  // step it: q head h0 + it / n_list, q tile entry(it % n_list)
  const int steps = n_heads * n_list;
  auto entry = [&](int it) {
    return kByPos ? list[it % n_list] : qt0 + it % n_list;
  };

  if (threadIdx.x < 128) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      // one thread issues every TMA load: k and v once, then each step's
      // q and dO tiles
      mbar_expect_tx(bars.q_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(base + L::kA + c * kOwn * kRowBytes, &tm_k, bars.q_full,
                    c * kBox, hk, k0, b);
        tma_load_4d(base + L::kB + c * kOwn * kRowBytes, &tm_v, bars.q_full,
                    c * kBox, hk, k0, b);
      }
      for (int it = 0; it < steps; ++it) {
        const int st = it % kStages;
        // stage st is free once every consumer thread is done with the
        // step it - kStages
        if (it >= kStages)
          mbar_wait(bars.empty(st), ((it / kStages) - 1) & 1);
        const int h = h0 + it / n_list;
        const int q0 = (entry(it) & ~kMaskBit) * kStep;
        mbar_expect_tx(bars.k_full(st), 2 * L::kStepBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(base + L::kC + st * L::kStepBytes + c * kStep * kRowBytes,
                      &tm_q, bars.k_full(st), c * kBox, h, q0, b);
          tma_load_4d(base + L::kD + st * L::kStepBytes + c * kStep * kRowBytes,
                      &tm_do, bars.k_full(st), c * kBox, h, q0, b);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // the second warp: each step's rows of lse (log2 units), Delta and
      // q positions; rows past Sq read as 0, 0 and below every position
      for (int it = 0; it < steps; ++it) {
        const int st = it % kStages;
        if (it >= kStages)
          mbar_wait(bars.empty(st), ((it / kStages) - 1) & 1);
        const int h = h0 + it / n_list;
        const int q0 = (entry(it) & ~kMaskBit) * kStep;
        float* r_lse = reinterpret_cast<float*>(sm + L::kRows +
                                                st * L::kRowStage);
        float* r_delta = r_lse + kStep;
        int* r_qp = reinterpret_cast<int*>(r_delta + kStep);
        const int64_t row = (static_cast<int64_t>(b) * heads + h) * seq_q;
        for (int r = lane; r < kStep; r += 32) {
          const int i = q0 + r;
          const bool in = i < seq_q;
          r_lse[r] = in ? lse[row + i] * kLog2e : 0.f;
          r_delta[r] = in ? delta[row + i] : 0.f;
          if constexpr (kByPos)
            r_qp[r] = in ? q_pos[static_cast<int64_t>(b) * seq_q + i]
                         : INT32_MIN;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(bars.v_full(st));
      }
    }
  } else {
    // ---- consumer warpgroups: 64 kv rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // the thread's kv rows j0 and j0 + 8; in every 8-column group of an
    // accumulator it holds columns cq and cq + 1 (q rows of a step)
    const int jw = k0 + 64 * cw;            // the warpgroup's first kv row
    const int j0 = jw + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t ka = base + L::kA + cw * 64 * kRowBytes;
    const uint32_t va = base + L::kB + cw * 64 * kRowBytes;
    int kp[2] = {0, 0};
    if constexpr (kByPos)
      for (int r = 0; r < 2; ++r)
        if (j0 + 8 * r < seq_k)
          kp[r] = k_pos[static_cast<int64_t>(b) * seq_k + j0 + 8 * r];
    const float inv_sk = 1.f / static_cast<float>(seq_k);

    float acc_dk[D / 2], acc_dv[D / 2], s[32], dp[32];
    zero(acc_dk);
    zero(acc_dv);
    uint32_t pa[4][4];            // P^T, then dS^T, packed

    mbar_wait(bars.q_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int e = entry(it);
      const int q0 = (e & ~kMaskBit) * kStep;
      const uint32_t qb = base + L::kC + st * L::kStepBytes;
      const uint32_t dob = base + L::kD + st * L::kStepBytes;
      const bool edge = kByPos ? (e & kMaskBit) != 0
                               : causal && q0 < jw + 63;

      // S^T = K . Q^T and dP^T = V . dO^T, both in flight
      mbar_wait(bars.k_full(st), par);
      wgmma_fence();
      ss_64<D>(s, ka, kOwn * kRowBytes, qb, kStep * kRowBytes);
      wgmma_commit();
      ss_64<D>(dp, va, kOwn * kRowBytes, dob, kStep * kRowBytes);
      wgmma_commit();
      mbar_wait(bars.v_full(st), par);
      const float* r_lse = reinterpret_cast<const float*>(
          sm + L::kRows + st * L::kRowStage);
      const float* r_delta = r_lse + kStep;
      const int* r_qp = reinterpret_cast<const int*>(r_delta + kStep);
      // the last step's dK and this one's S^T are done (groups complete
      // in order): the last stage is free, and so is the packed operand
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(acc_dk);
      if (it > 0) mbar_arrive(bars.empty((it - 1) % kStages));

      // P^T: column c is q row q0 + c; masks only where the tile says
      uint32_t keep = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + cq + (i % 2);
        const int rr = (i / 2) % 2;
        float p = exp2f(s[i] * scale_log2 - r_lse[c]);
        if (edge) {
          bool kept;
          if constexpr (kByPos)
            kept = r_qp[c] >= kp[rr];
          else
            kept = q0 + c >= j0 + 8 * rr;
          if (!kept) {
            p = 0.f;
            keep &= ~(1u << i);
          }
          // a row with no key averages every key
          if (kByPos && r_lse[c] <= kDead) p = inv_sk;
        }
        s[i] = p;
      }
      pack_a<kStep>(pa, s);

      // dV += P^T . dO
      fence_regs(acc_dv);
      wgmma_fence();
      rs_k<D, kStep>(acc_dv, pa, dob, kStep * kRowBytes);
      wgmma_commit();

      // dS^T = P^T o (dP^T - Delta), 0 off the mask, while dV runs; its
      // A operand is free once dV is done (one packed operand at a time
      // keeps a D 128 consumer within its 240 registers)
      wgmma_wait<1>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + cq + (i % 2);
        dp[i] = (keep >> i) & 1u ? s[i] * (dp[i] - r_delta[c]) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(acc_dv);
      pack_a<kStep>(pa, dp);

      // dK += dS^T . Q, left running into the next step's S^T and dP^T
      fence_regs(acc_dk);
      wgmma_fence();
      rs_k<D, kStep>(acc_dk, pa, qb, kStep * kRowBytes);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc_dk);

    if constexpr (kSplit) {
      // the q head's share, unscaled, at (b, j, h0) of each f32 plane
      const int64_t stride = static_cast<int64_t>(heads) * D;
      const int64_t plane =             // B * Sk * H * D
          static_cast<int64_t>(bh_total) / heads * seq_k * stride;
      float* pk = part + static_cast<int64_t>(b) * seq_k * stride +
                  static_cast<int64_t>(h0) * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + 8 * r;
        if (j >= seq_k) continue;
#pragma unroll
        for (int g = 0; g < D / 8; ++g) {
          float* p = pk + j * stride + 8 * g + cq;
          *reinterpret_cast<float2*>(p) =
              make_float2(acc_dk[4 * g + 2 * r], acc_dk[4 * g + 2 * r + 1]);
          *reinterpret_cast<float2*>(p + plane) =
              make_float2(acc_dv[4 * g + 2 * r], acc_dv[4 * g + 2 * r + 1]);
        }
      }
    } else {
      const int64_t stride = static_cast<int64_t>(kv_heads) * D;
      const int64_t off = static_cast<int64_t>(b) * seq_k * stride +
                          static_cast<int64_t>(hk) * D;
      store_rows<D>(dk + off, stride, j0, seq_k, cq, acc_dk, scale);
      store_rows<D>(dv + off, stride, j0, seq_k, cq, acc_dv, 1.f);
    }
  }
}

// (c) dQ of one 128-row q tile of q head h in batch row b.
template <int D, bool kByPos>
__global__ void __launch_bounds__(kBlock, 1)
dq_tc(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int32_t seq_q, int32_t seq_k,
          int32_t heads, int32_t kv_heads, int32_t bh_total, int32_t causal,
          const int32_t* __restrict__ q_pos,
          const int32_t* __restrict__ k_pos, float scale_log2,
          float scale) {
  constexpr int kS = kKvStep<D>;
  using L = Layout<D, kS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  // q_full: q and dO; k_full(st), v_full(st): a step's k and v
  const Barriers<kStages> bars{base + L::kBars};

  // the heaviest causal tiles (the last) of every head first
  const int n_qt = (seq_q + kOwn - 1) / kOwn;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_total;
  const int bh = static_cast<int>(blockIdx.x) % bh_total;
  const int b = bh / heads, h = bh % heads;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kOwn;
  const int n_kv_all = (seq_k + kS - 1) / kS;
  int* const list = reinterpret_cast<int*>(sm + L::kStats) + 2 * n_kv_all;

  if (threadIdx.x == 0) bars.init(2 * 128);
  // by index, kv tiles past the q tile's last row are never loaded; by
  // position, the tiles the forward's `position_tiles` lists
  int n_kv;
  if constexpr (kByPos)
    n_kv = position_tiles<kS, kOwn>(
        q_pos + static_cast<int64_t>(b) * seq_q,
        k_pos + static_cast<int64_t>(b) * seq_k, seq_q, seq_k, q0, n_kv_all,
        list - 2 * n_kv_all);
  else
    n_kv = causal ? min(n_kv_all, (min(q0 + kOwn, seq_q) - 1) / kS + 1)
                  : n_kv_all;
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars.q_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(base + L::kA + c * kOwn * kRowBytes, &tm_q, bars.q_full,
                    c * kBox, h, q0, b);
        tma_load_4d(base + L::kB + c * kOwn * kRowBytes, &tm_do,
                    bars.q_full, c * kBox, h, q0, b);
      }
      const Loader<kStages> load{bars, &tm_q, &tm_k, &tm_v, 0u,
                                 base + L::kC, base + L::kD, L::kBoxes, kBox,
                                 kOwn, kS, h, hk, q0, b};
      for (int it = 0; it < n_kv; ++it) {
        if (it >= kStages)
          mbar_wait(bars.empty(it % kStages), ((it / kStages) - 1) & 1);
        load.kv(kByPos ? list[it] & ~kMaskBit : it, it % kStages);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // the thread's q rows r0 and r0 + 8: lse (log2 units), Delta,
    // position; in every 8-column group it holds columns cq and cq + 1
    const int r0 = q0 + 64 * cw + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint32_t qa = base + L::kA + cw * 64 * kRowBytes;
    const uint32_t doa = base + L::kB + cw * 64 * kRowBytes;
    const int64_t row = static_cast<int64_t>(bh) * seq_q;
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    int qp[2] = {INT32_MIN, INT32_MIN};
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < seq_q) {
        lse2[r] = lse[row + r0 + 8 * r] * kLog2e;
        dl[r] = delta[row + r0 + 8 * r];
        if constexpr (kByPos)
          qp[r] = q_pos[static_cast<int64_t>(b) * seq_q + r0 + 8 * r];
      }
    const int32_t* kp =
        kByPos ? k_pos + static_cast<int64_t>(b) * seq_k : nullptr;

    float acc[D / 2], s[kS / 2], dp[kS / 2];
    zero(acc);
    uint32_t pa[kS / 16][4];

    mbar_wait(bars.q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int e = kByPos ? list[it] : it;
      const int k0 = (e & ~kMaskBit) * kS;
      const uint32_t kb = base + L::kC + st * L::kStepBytes;
      const uint32_t vb = base + L::kD + st * L::kStepBytes;
      // masks on the diagonal and the ragged last tile only (by position,
      // on the tiles listed so); a row with no key keeps no pair, dS = 0
      const bool edge = kByPos ? (e & kMaskBit) != 0
                               : k0 + kS > seq_k ||
                                     (causal && k0 + kS - 1 > q0 + 64 * cw);

      // S = Q . K^T, then dP = dO . V^T once v has landed
      mbar_wait(bars.k_full(st), par);
      wgmma_fence();
      ss_n<D>(s, qa, kOwn * kRowBytes, kb, kS * kRowBytes);
      wgmma_commit();
      mbar_wait(bars.v_full(st), par);
      wgmma_fence();
      ss_n<D>(dp, doa, kOwn * kRowBytes, vb, kS * kRowBytes);
      wgmma_commit();
      // the last step's dQ and this one's S are done: the last stage is
      // free, and so is the packed operand
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(acc);
      if (it > 0) mbar_arrive(bars.empty((it - 1) % kStages));
#pragma unroll
      for (int i = 0; i < kS / 2; ++i) {
        const int rr = (i / 2) % 2;
        bool kept = true;
        if (edge) {
          const int col = k0 + 8 * (i / 4) + cq + (i % 2);
          if constexpr (kByPos)
            kept = col < seq_k && qp[rr] >= __ldg(kp + col);
          else
            kept = col < seq_k && (!causal || col <= r0 + 8 * rr);
        }
        s[i] = kept ? exp2f(s[i] * scale_log2 - lse2[rr]) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kS / 2; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
      pack_a<kS>(pa, dp);

      // dQ += dS . K, left running into the next step's S and dP
      fence_regs(acc);
      wgmma_fence();
      rs_k<D, kS>(acc, pa, kb, kS * kRowBytes);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int64_t stride = static_cast<int64_t>(heads) * D;
    store_rows<D>(dq + static_cast<int64_t>(b) * seq_q * stride +
                          static_cast<int64_t>(h) * D,
                      stride, r0, seq_q, cq, acc, scale);
  }
}

// The arguments of the backward's launches.
struct BwdArgs {
  const void *go, *q, *k, *v, *o;
  const float* lse;
  float* delta;                 // scratch (B, H, Sq) f32
  float* part;                  // scratch 2 x (B, Sk, H, D) f32, or null
  void *dq, *dk, *dv;
  int32_t b, sq, sk, h, kvh, causal;
  const int32_t *q_pos, *k_pos;
  float scale;
  cudaStream_t stream;
};

// One launch of `kernel` over `blocks` blocks with `smem` bytes of dynamic
// shared memory; returns cudaGetLastError().
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int64_t blocks, int threads, int smem,
           cudaStream_t stream, A... args) {
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D> struct Launch {
  static int run(const BwdArgs& a) {
    const cudaError_t bound = bind_device(a.q);
    if (bound != cudaSuccess) return static_cast<int>(bound);
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // (b) streams 64-row q and dO tiles past 128-row k and v tiles, (c)
    // the other way round
    CUtensorMap q_step, do_step, k_own, v_own, q_own, do_own, k_step,
        v_step;
    if (!make_map(fn, &q_step, a.q, true, D, a.h, a.sq, a.b, kStep) ||
        !make_map(fn, &do_step, a.go, true, D, a.h, a.sq, a.b, kStep) ||
        !make_map(fn, &k_own, a.k, true, D, a.kvh, a.sk, a.b, kOwn) ||
        !make_map(fn, &v_own, a.v, true, D, a.kvh, a.sk, a.b, kOwn) ||
        !make_map(fn, &q_own, a.q, true, D, a.h, a.sq, a.b, kOwn) ||
        !make_map(fn, &do_own, a.go, true, D, a.h, a.sq, a.b, kOwn) ||
        !make_map(fn, &k_step, a.k, true, D, a.kvh, a.sk, a.b,
                  kKvStep<D>) ||
        !make_map(fn, &v_step, a.v, true, D, a.kvh, a.sk, a.b, kKvStep<D>))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool by_pos = a.q_pos != nullptr;
    const float scale_log2 = a.scale * kLog2e;
    const int64_t rows = static_cast<int64_t>(a.b) * a.h * a.sq;
    const int64_t bh_kv = static_cast<int64_t>(a.b) * a.kvh;
    const int64_t bh_q = static_cast<int64_t>(a.b) * a.h;
    if (bh_kv > INT32_MAX || bh_q > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    using Bf = __nv_bfloat16;
    // (a) Delta
    int err = launch(&delta_tc<D>, (rows + kDeltaBlock - 1) / kDeltaBlock,
                     kDeltaBlock, 0, a.stream, static_cast<const Bf*>(a.o),
                     static_cast<const Bf*>(a.go), a.delta, rows, a.sq, a.h);
    if (err != 0) return err;
    // (b) dK and dV: a block a kv head's group, or with scratch for the
    // q heads' shares a block a q head, then their sum
    const int n_q = (a.sq + kStep - 1) / kStep;
    const bool split = a.part != nullptr && a.h != a.kvh;
    auto* const dkdv =
        by_pos ? (split ? &dkdv_tc<D, true, true> : &dkdv_tc<D, true, false>)
               : (split ? &dkdv_tc<D, false, true>
                        : &dkdv_tc<D, false, false>);
    const int64_t bh_b = split ? bh_q : bh_kv;
    err = launch(dkdv, bh_b * ((a.sk + kOwn - 1) / kOwn), kBlock,
                 Layout<D, kStep>::bytes(by_pos ? 4 * stats_ints(n_q) : 0),
                 a.stream,
                 q_step, do_step, k_own, v_own, a.lse,
                 static_cast<const float*>(a.delta), static_cast<Bf*>(a.dk),
                 static_cast<Bf*>(a.dv), a.part, a.sq, a.sk, a.h, a.kvh,
                 static_cast<int32_t>(bh_b), a.causal, a.q_pos, a.k_pos,
                 scale_log2, a.scale);
    if (err != 0) return err;
    if (split) {
      const int64_t chunks = bh_kv * a.sk * (D / 8);
      err = launch(&group_sum_tc<D>, (chunks + kDeltaBlock - 1) / kDeltaBlock,
                   kDeltaBlock, 0, a.stream,
                   static_cast<const float*>(a.part), static_cast<Bf*>(a.dk),
                   static_cast<Bf*>(a.dv), chunks, bh_q * a.sk * D, a.kvh,
                   a.h / a.kvh, a.scale);
      if (err != 0) return err;
    }
    // (c) dQ
    const int n_kv = (a.sk + kKvStep<D> - 1) / kKvStep<D>;
    auto* const dq = by_pos ? &dq_tc<D, true> : &dq_tc<D, false>;
    return launch(dq,
                  bh_q * ((a.sq + kOwn - 1) / kOwn), kBlock,
                  Layout<D, kKvStep<D>>::bytes(
                      by_pos ? 4 * stats_ints(n_kv) : 0),
                  a.stream, q_own, do_own, k_step, v_step, a.lse,
                  static_cast<const float*>(a.delta), static_cast<Bf*>(a.dq),
                  a.sq, a.sk, a.h, a.kvh, static_cast<int32_t>(bh_q),
                  a.causal, a.q_pos, a.k_pos, scale_log2, a.scale);
  }
};

}  // namespace bwd
}  // namespace

// The gradients of flash_attention_tc_fwd at (q, k, v) against go (like
// q), given its o and lse (b, h, sq) f32 from a forward at the same
// arguments: dq like q, dk and dv like k, all bfloat16, contiguous with
// 16-byte-aligned data; d one of 16, 32, 64, 80, 96, 128; `causal` needs
// sq == sk, and with q_pos (b, sq) and k_pos (b, sk) int32 masks by
// position (both null: by index); `delta` is (b, h, sq) f32 scratch; a
// non-null `part` (2 x (b, sk, h, d) f32 scratch) splits a GQA group's q
// heads over blocks of their own, whose shares of dk and dv one more
// launch adds up in the group's order (null, or h == kvh: a block sums
// its kv head's group itself).
// Three launches (four split) on `stream`; return cudaGetLastError()
// (cudaErrorInvalidValue for a head dim the kernels are not built for or a
// grid of 2**31 blocks or more, cudaErrorNotSupported where
// cuTensorMapEncodeTiled is not found).
extern "C" int flash_attention_tc_bwd(const void* go, const void* q,
                                      const void* k, const void* v,
                                      const void* o, const float* lse,
                                      float* delta, float* part, void* dq,
                                      void* dk, void* dv, int32_t b,
                                      int32_t sq,
                                      int32_t sk, int32_t h, int32_t kvh,
                                      int32_t d, int32_t causal,
                                      const int32_t* q_pos,
                                      const int32_t* k_pos, float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0)
    return static_cast<int>(cudaGetLastError());
  const bwd::BwdArgs a{go,  q,  k,  v,  o,      lse,   delta, part,
                       dq,  dk, dv, b,  sq,     sk,    h,     kvh,
                       causal, q_pos, k_pos, scale,
                       static_cast<cudaStream_t>(stream)};
  switch (d) {
#define REPRO_FA_BWD_CASE(D) \
  case D: return bwd::Launch<D>::run(a);
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
