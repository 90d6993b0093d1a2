"""The HBM-shim analogue for Hopper: block planning for streaming kernels.

The paper's shim merges two 256-bit AXI ports into one 512-bit port so
each engine issues wide bursts.  On an H100 the wide access is a 16-byte
vector load or store per thread (4 int32 or float32), and a warp's 32
neighbouring vectors cover four 128-byte sectors, so every transaction is
whole.  A streaming kernel has no working set to keep in shared memory:
its block plan is the threads of a CUDA block, the vector width, and a
grid that keeps every SM busy, each block striding over the rest.

Only what the traffic generator (``kernels/bandwidth``) needs is here:
``BlockPlan`` and ``plan_stream_block``.
"""
from __future__ import annotations

import dataclasses

THREADS = 256               # threads a CUDA block in every port kernel
VECTOR_BYTES = 16           # one 128-bit load or store a thread
H100_SMS = 132              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 8           # 2,048 resident threads an SM / THREADS


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    threads: int            # threads a CUDA block
    vector: int             # elements a thread loads at once (16 bytes)
    grid: int               # CUDA blocks; each strides over the rest


def plan_stream_block(n_elems: int, dtype_bytes: int, *,
                      sms: int = H100_SMS) -> BlockPlan:
    """1-D streaming plan: 16-byte vectors, ``THREADS`` threads a block,
    and as many blocks as the vectors need, up to a full card
    (``BLOCKS_PER_SM`` on each of ``sms`` SMs)."""
    if VECTOR_BYTES % dtype_bytes:
        raise ValueError(f"{dtype_bytes}-byte elements do not pack into "
                         f"{VECTOR_BYTES}-byte vectors")
    vector = VECTOR_BYTES // dtype_bytes
    n_vec = -(-max(int(n_elems), 1) // vector)
    grid = min(-(-n_vec // THREADS), sms * BLOCKS_PER_SM)
    return BlockPlan(THREADS, vector, max(grid, 1))
