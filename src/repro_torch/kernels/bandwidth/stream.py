"""Traffic-generator kernel (paper §II, Fig. 1/2) — wrapper and plain
version.

The CUDA kernel (``kernels/csrc/bandwidth.cu``) replaces the TPU's
``stream_copy_pallas``: a wave of blocks claims tiles of 16-byte vectors
from a counter (a 4-byte scratch the wrapper allocates and the launcher
zeroes), a thread keeping several loads in flight, with a scalar head
and tail; ``core/shim.py`` plans the grid and the loads in flight.
``stream_copy`` launches it for CUDA int32 and float32 tensors and uses
``ref.stream_copy_ref`` for CPU tensors; any other type on the card
raises ``TypeError`` instead of taking the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.shim import VECTOR_BYTES, plan_stream_block
from repro_torch.kernels import _build
from repro_torch.kernels.bandwidth import ref

_SYMBOLS = {torch.int32: "stream_copy_i32", torch.float32: "stream_copy_f32"}


def _out_like(x: torch.Tensor) -> torch.Tensor:
    """An output at the same offset within 16 bytes as ``x``, so the
    kernel's vectors line up for both (a slice ``x[1:]`` starts 4 bytes
    past a boundary; its output is a view that does too)."""
    shift = x.data_ptr() % VECTOR_BYTES
    if shift == 0:
        return torch.empty_like(x)
    size = x.element_size()
    buf = torch.empty(x.shape[0] + VECTOR_BYTES // size, dtype=x.dtype,
                      device=x.device)
    off = (shift - buf.data_ptr() % VECTOR_BYTES) % VECTOR_BYTES // size
    return buf[off:off + x.shape[0]]


def stream_copy(x: torch.Tensor, *,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + 1`` through the CUDA kernel (the plain version on the CPU),
    written to ``out`` when given."""
    if x.device.type == "cpu":
        y = ref.stream_copy_ref(x)
        return y if out is None else out.copy_(y)
    symbol = _SYMBOLS.get(x.dtype)
    if symbol is None:
        raise TypeError(f"stream_copy: the kernel takes int32 or float32, "
                        f"got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("stream_copy: expected a contiguous 1-D tensor, "
                         f"got shape {tuple(x.shape)}")
    if out is None:
        out = _out_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("stream_copy: out must be a contiguous tensor of "
                         "x's shape, type and device")
    n = x.shape[0]
    if n == 0:
        return out
    plan = plan_stream_block(n, x.element_size())
    next_tile = torch.empty(1, dtype=torch.int32, device=x.device)
    fn = _build.function(symbol)
    rc = fn(x.data_ptr(), out.data_ptr(), n, plan.grid, plan.unroll,
            next_tile.data_ptr(), _build.stream_handle(x.device))
    _build.check(rc, symbol)
    _build.LAUNCHES["stream_copy"] += 1
    return out
