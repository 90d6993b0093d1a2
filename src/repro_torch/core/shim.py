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

Only what the traffic generator (``kernels/bandwidth``) needs is here:
``BlockPlan`` and ``plan_stream_block``.
"""
from __future__ import annotations

import dataclasses

THREADS = 256               # threads a CUDA block in every port kernel
VECTOR_BYTES = 16           # one 128-bit load or store a thread
H100_SMS = 132              # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 2           # resident blocks a wave puts on each SM
UNROLL = 4                  # 16-byte loads a thread issues before storing


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
