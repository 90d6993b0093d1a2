"""Minibatch SGD for GLMs (paper §VI, Fig. 9) — wrapper and plain version.

The CUDA kernel (``kernels/csrc/sgd.cu``) replaces the TPU's
``sgd_pallas``: one CUDA block per hyper-parameter job (the Fig. 10a
parallelism), the job's model resident in shared memory for the whole
launch, and every reduction in a fixed order, so a job's weights do not
depend on how the rows are cut into launches (at minibatch boundaries) or
on which jobs share a launch.  ``sgd`` launches it for CUDA tensors and
takes ``ref.sgd_ref`` for CPU tensors; there is no fallback from the card
to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sgd import ref

KINDS = ("ridge", "logreg")

_max_shared: Dict[int, int] = {}


def max_shared_bytes(device: torch.device) -> int:
    """Shared memory one block may use on ``device`` (opt-in maximum)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _max_shared:
        out = ctypes.c_int32(0)
        fn = _build.function("sgd_max_shared_bytes")
        _build.check(fn(idx, ctypes.byref(out)), "sgd_max_shared_bytes")
        _max_shared[idx] = out.value
    return _max_shared[idx]


def _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if a.dim() != 2:
        raise ValueError(f"a: expected (m, n), got {tuple(a.shape)}")
    m, n = a.shape
    k = xs0.shape[0]
    if b.shape != (m,) or xs0.shape != (k, n) or lrs.shape != (k,) \
            or l2s.shape != (k,):
        raise ValueError(
            f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, xs0 "
            f"{tuple(xs0.shape)}, lrs {tuple(lrs.shape)}, l2s "
            f"{tuple(l2s.shape)}: want (m, n), (m,), (K, n), (K,), (K,)")
    for t, name in ((a, "a"), (b, "b"), (xs0, "xs0"), (lrs, "lrs"),
                    (l2s, "l2s")):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if minibatch <= 0 or m % minibatch:
        raise ValueError(f"{m} rows are not a multiple of the minibatch "
                         f"{minibatch}")
    if epochs < 0:
        raise ValueError(f"epochs must be >= 0, got {epochs}")


def sgd(a: torch.Tensor, b: torch.Tensor, xs0: torch.Tensor,
        lrs: torch.Tensor, l2s: torch.Tensor, *, minibatch: int = 16,
        epochs: int = 1, kind: str = "ridge") -> torch.Tensor:
    """Train K GLMs on one dataset: a (m, n) f32, b (m,), xs0 (K, n),
    lrs (K,), l2s (K,) -> xs (K, n), through the CUDA kernel (plain
    version on CPU).  Raises ``ValueError`` when ``n`` floats do not fit
    the shared memory one block may use."""
    _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind)
    if a.device.type == "cpu":
        return ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=minibatch,
                           epochs=epochs, kind=kind)
    for t, name in ((a, "a"), (b, "b"), (xs0, "xs0"), (lrs, "lrs"),
                    (l2s, "l2s")):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    m, n = a.shape
    k = xs0.shape[0]
    if n >= 2 ** 31 or minibatch >= 2 ** 31 or epochs >= 2 ** 31 \
            or k >= 2 ** 31:
        raise ValueError("n, minibatch, epochs and K must fit int32")
    smem = 4 * (n + minibatch)
    limit = max_shared_bytes(a.device)
    if smem > limit:
        raise ValueError(
            f"{n} features and a minibatch of {minibatch} need {smem} bytes "
            f"of shared memory; a block may use at most {limit} bytes")
    xs = torch.empty_like(xs0)
    if k == 0:
        return xs
    fn = _build.function("sgd_f32")
    rc = fn(a.data_ptr(), b.data_ptr(), xs0.data_ptr(), lrs.data_ptr(),
            l2s.data_ptr(), m, n, minibatch, epochs,
            int(kind == "logreg"), k, xs.data_ptr(),
            _build.stream_handle(a.device))
    _build.check(rc, "sgd_f32")
    _build.LAUNCHES["sgd"] += 1
    return xs
