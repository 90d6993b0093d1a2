"""Range-selection kernel (paper §IV, Fig. 4) — wrapper and plain version.

The CUDA kernel (``kernels/csrc/selection.cu``) replaces the TPU's
``select_pallas``: one CUDA block per logical block of rows, coalesced
loads, a per-block count reduced in shared memory, and a masked ragged
tail, so any column length is accepted.  The kernel has an int32 and a
float32 entry, as ``select_pallas`` compares in the column's own type
(a float32 column's bounds rounded to float32, ``ref.float32_bounds``;
NaN matches nothing); each has its own launch counter.  ``select``
launches it for CUDA tensors and uses ``select_plain`` for CPU tensors;
there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selection import ref

DEFAULT_BLOCK = 4096      # rows per logical block (one per-block count)

# column type -> (launcher, launch counter, bounds normalization)
_ENTRIES = {torch.int32: ("select_range_i32", "select", ref.int32_bounds),
            torch.float32: ("select_range_f32", "select_f32",
                            ref.float32_bounds)}


def select_plain(x: torch.Tensor, lo, hi, *, block: int = DEFAULT_BLOCK):
    """Plain PyTorch version of the kernel: (idx (N,) with -1 dummies,
    counts (ceil(N/block),))."""
    return ref.select_blocked(x, lo, hi, block)


def select(x: torch.Tensor, lo, hi, *, block: int = DEFAULT_BLOCK):
    """Range selection through the CUDA kernel (plain version on CPU) over
    an int32 or a float32 column."""
    if x.device.type == "cpu":
        return select_plain(x, lo, hi, block=block)
    if x.dtype not in _ENTRIES:
        raise TypeError(f"x: expected int32 or float32, got {x.dtype}")
    symbol, counter, bounds = _ENTRIES[x.dtype]
    _build.require_int32_cuda(x, "x", x.dtype)
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    n = x.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: index lines are int32")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    counts = torch.empty(-(-n // block), dtype=torch.int32, device=x.device)
    if n == 0:
        return idx, counts
    lo, hi = bounds(lo, hi)
    fn = _build.function(symbol)
    rc = fn(x.data_ptr(), n, lo, hi, block, idx.data_ptr(),
            counts.data_ptr(), _build.stream_handle(x.device))
    _build.check(rc, symbol)
    _build.LAUNCHES[counter] += 1
    return idx, counts
