"""The HBM-shim analogue for Hopper: block planning for streaming kernels.

The paper's shim merges two 256-bit AXI ports into one 512-bit port so
each engine issues wide bursts.  On an H100 the wide access is a 16-byte
vector load or store per thread (4 int32 or float32), and a warp's 32
neighbouring vectors cover four 128-byte sectors, so every transaction is
whole.  A stream's rate is set by the bytes in flight and by how evenly
the SMs finish, so a thread issues ``UNROLL`` such loads before its first
store, and a wave of resident blocks claims tiles of ``UNROLL`` vectors a
thread one at a time until the array is done.  A streaming kernel has no
working set to keep in shared memory: its block plan is the threads of a
CUDA block, the vector width, the loads a thread keeps in flight, and
the grid.

The traffic generator (``kernels/bandwidth``) plans with ``BlockPlan``
and ``plan_stream_block``.  ``plan_matmul_block`` plans a tensor-core
product's tiles: multiples of the wgmma shape whose operand ring fits in
one block's shared memory and whose f32 accumulator fits in the
registers set aside for it.  ``merged_port_width`` is the card's wide
access.
"""
from __future__ import annotations

import dataclasses

THREADS = 256               # threads a CUDA block in every port kernel
VECTOR_BYTES = 16           # one 128-bit load or store a thread
H100_SMS = 132              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2           # resident blocks a wave puts on each SM
UNROLL = 4                  # 16-byte loads a thread issues before storing
WARP = 32                   # threads a warp
# --- a Hopper SM for tensor-core tiles (H100 SXM data sheet) -------------- #
SMEM_BYTES = 227 * 1024     # shared memory one block may take
ACC_BYTES = 128 * 1024      # registers a block's f32 accumulator may take
WGMMA_M = 64                # rows of one warpgroup's wgmma
WGMMA_N = 64                # tile columns: a 128-byte swizzled bf16 row
WGMMA_K = 64                # tile depth: a 128-byte swizzled bf16 row
MAX_TILE = 256


def round_up(x: int, m: int) -> int:
    """The least multiple of ``m`` at or above ``x``."""
    return ((x + m - 1) // m) * m


def round_down(x: int, m: int) -> int:
    """The greatest multiple of ``m`` at or below ``x``, and at least ``m``."""
    return max((x // m) * m, m)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    threads: int            # threads a CUDA block
    vector: int             # elements a thread loads at once (16 bytes)
    grid: int               # CUDA blocks, at most one wave of them
    unroll: int             # vectors a thread loads before its stores
    tile: int               # vectors a block claims at a time


def plan_stream_block(n_elems: int, dtype_bytes: int, *,
                      sms: int = H100_SMS) -> BlockPlan:
    """1-D streaming plan: 16-byte vectors, ``THREADS`` threads a block,
    ``UNROLL`` loads in flight a thread, and as many blocks as the vectors
    need (one a thread at most), up to one wave on the card
    (``BLOCKS_PER_SM`` on each of ``sms`` SMs).  The blocks claim tiles of
    ``THREADS * UNROLL`` vectors one at a time until none is left."""
    if VECTOR_BYTES % dtype_bytes:
        raise ValueError(f"{dtype_bytes}-byte elements do not pack into "
                         f"{VECTOR_BYTES}-byte vectors")
    vector = VECTOR_BYTES // dtype_bytes
    n_vec = -(-max(int(n_elems), 1) // vector)
    grid = max(min(-(-n_vec // THREADS), sms * BLOCKS_PER_SM), 1)
    return BlockPlan(THREADS, vector, grid, UNROLL, THREADS * UNROLL)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    block: tuple            # (bm, bn, bk)
    smem_bytes: int         # the operand tiles' ring in shared memory
    acc_bytes: int          # the f32 accumulator tile in registers
    n_buffers: int          # stages of the ring

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_BYTES and self.acc_bytes <= ACC_BYTES


def plan_matmul_block(m: int, n: int, k: int, dtype_bytes: int = 2,
                      acc_bytes: int = 4, n_buffers: int = 2) -> MatmulPlan:
    """Tensor-core (bm, bn, bk) tiles for an (m, k) x (k, n) product: each
    dim rounded up to its wgmma multiple (``WGMMA_M``, ``WGMMA_N``,
    ``WGMMA_K``) and capped at ``MAX_TILE``, then, while the A and B tiles'
    ``n_buffers``-stage ring overflows ``SMEM_BYTES`` or the bm x bn
    accumulator overflows ``ACC_BYTES``, the largest dim halved (of equals
    the last, k before n before m, as the reference picks) and rounded
    down to its wgmma multiple, none below it (the reference halves
    without rounding, so a 384 there becomes 192, off its 128 grid)."""
    mins = (WGMMA_M, WGMMA_N, WGMMA_K)
    tile = [min(round_up(max(int(x), 1), q), MAX_TILE)
            for x, q in zip((m, n, k), mins)]

    def plan() -> MatmulPlan:
        bm, bn, bk = tile
        return MatmulPlan((bm, bn, bk),
                          n_buffers * (bm * bk + bk * bn) * dtype_bytes,
                          bm * bn * acc_bytes, n_buffers)

    while not plan().fits and tile != list(mins):
        big = max(range(3), key=lambda i: (tile[i], i))
        tile[big] = round_down(tile[big] // 2, mins[big])
    return plan()


def merged_port_width(dtype_bytes: int) -> int:
    """Bytes of the card's wide access, the counterpart of the paper's
    512-bit merged port: one warp's 16-byte vector loads (``WARP`` x
    ``VECTOR_BYTES`` = 512 bytes, four whole 128-byte sectors), a whole
    number of ``dtype_bytes`` elements."""
    if VECTOR_BYTES % dtype_bytes:
        raise ValueError(f"{dtype_bytes}-byte elements do not pack into "
                         f"{VECTOR_BYTES}-byte vectors")
    return WARP * VECTOR_BYTES
