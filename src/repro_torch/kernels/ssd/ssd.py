"""The SSD (Mamba-2) chunk scan — wrapper and plain version.

The CUDA kernel (``kernels/csrc/ssd.cu``) replaces the TPU's
``ssd_pallas``: one block per (batch row, head), the chunks in sequence
inside it with the state h (hd, ds) in shared memory, b and c read per
group and a_log, d_skip per head (no repeated copies), the ragged last
chunk masked.  ``ssd_scan`` launches it for CUDA tensors and takes
``ref.ssd_plain`` for CPU tensors; there is no fallback from the card to
the plain version.  A shape whose chunk does not fit the shared memory of
one block raises ``ValueError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sgd.sgd import max_shared_bytes
from repro_torch.kernels.ssd import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_WIDTH = 128                 # hd and ds: the widest column groups built
ROWS = 32                       # rows of a score tile in the kernel


def smem_bytes(hd: int, ds: int, chunk: int) -> int:
    """Shared memory one block takes (``smem_floats`` in ``ssd.cu``)."""
    return 4 * (ROWS * ds + hd * (ds + 1) + chunk * hd + ds * (chunk + 1)
                + ROWS * (chunk + 1) + 4 * chunk)


def _check(x, dt, a_log, b, c, d_skip, chunk) -> None:
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"expected x (B, S, nh, hd) and b, c (B, S, ng, ds),"
                         f" got {tuple(x.shape)}, {tuple(b.shape)}")
    bsz, s, nh, hd = x.shape
    ng = b.shape[2]
    if (dt.shape != (bsz, s, nh) or c.shape != b.shape
            or b.shape[:2] != (bsz, s) or a_log.shape != (nh,)
            or d_skip.shape != (nh,) or ng == 0 or nh % ng):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
            f"{tuple(a_log.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
            f"d_skip {tuple(d_skip.shape)}: want dt (B, S, nh), a_log and "
            "d_skip (nh,), b and c (B, S, ng, ds) with nh a multiple of ng")
    if x.dtype not in DTYPES:
        raise TypeError(f"x: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"b and c must be of x's type {x.dtype}, got "
                        f"{b.dtype}, {c.dtype}")
    for t, name in ((dt, "dt"), (a_log, "a_log"), (d_skip, "d_skip")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 128):
    """x (B, S, nh, hd); dt (B, S, nh) f32; a_log, d_skip (nh,) f32; b, c
    (B, S, ng, ds) of x's type -> (y like x, final state (B, nh, hd, ds)
    f32), through the CUDA kernel (the plain version on the CPU)."""
    _check(x, dt, a_log, b, c, d_skip, chunk)
    if x.device.type == "cpu":
        return ref.ssd_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    bsz, s, nh, hd = x.shape
    ng, ds = b.shape[2], b.shape[3]
    for t, name in ((x, "x"), (dt, "dt"), (a_log, "a_log"), (b, "b"),
                    (c, "c"), (d_skip, "d_skip")):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    smem, limit = smem_bytes(hd, ds, chunk), max_shared_bytes(x.device)
    if smem > limit:
        raise ValueError(
            f"hd {hd}, ds {ds} and chunk {chunk} need {smem} bytes of shared "
            f"memory; a block may use at most {limit} bytes")
    if hd > MAX_WIDTH or ds > MAX_WIDTH or chunk > 128 or chunk % ROWS:
        raise ValueError(f"hd {hd}, ds {ds}, chunk {chunk}: the kernel takes "
                         f"hd, ds <= {MAX_WIDTH} and a chunk that is a "
                         f"multiple of {ROWS} up to 128")
    y = torch.empty_like(x)
    h = torch.empty((bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
    if bsz * nh == 0:
        return y, h
    fn = _build.function("ssd_fwd")
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h.data_ptr(), bsz,
            s, nh, hd, ng, ds, chunk, int(x.dtype == torch.bfloat16),
            _build.stream_handle(x.device))
    _build.check(rc, "ssd_fwd")
    _build.LAUNCHES["ssd"] += 1
    return y, h
