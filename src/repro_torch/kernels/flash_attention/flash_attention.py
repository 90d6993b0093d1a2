"""Flash attention (online softmax) — wrapper and plain version.

The CUDA kernel (``kernels/csrc/flash_attention.cu``) replaces the TPU's
``flash_attention``: one block per 64-row q tile and head, kv tiles
streamed through shared memory with the running (m, l, acc) in f32, kv
tiles above the causal diagonal skipped, kv heads read in place for GQA,
and the ragged last tiles masked, so any length works.  ``flash_attention``
launches it for CUDA tensors and takes ``ref.attention_plain`` for CPU
tensors; there is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)      # instantiated in the CUDA source


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, S, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if v.shape != k.shape or k.shape != (b, s, kvh, d) or kvh == 0 \
            or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want k and v (B, S, KV, D) "
                         "with H a multiple of KV")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                            f"got {t.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, D), k and v (B, S, KV, D), float32 or bfloat16 ->
    attention output like q, through the CUDA kernel (the plain version on
    the CPU)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.attention_plain(q, k, v, causal=causal)
    b, s, h, d = q.shape
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if b * h >= 2 ** 16:
        raise ValueError(f"B * H = {b * h}: the grid takes at most 65,535")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.function("flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], d, int(causal), int(q.dtype == torch.bfloat16),
            d ** -0.5, _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_fwd")
    _build.LAUNCHES["flash_attention"] += 1
    return o
