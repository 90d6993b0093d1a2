"""Flash attention (online softmax) — wrapper and plain version.

The CUDA kernels (``kernels/csrc/flash_attention.cu``) replace the TPU's
``flash_attention`` on Hopper's tensor cores, in one route per type,
which ``route`` picks before the launch; each takes every D in
``HEAD_DIMS``:

* ``"tc"``, bfloat16: wgmma fed by TMA, one block per 128-row q tile and
  head, 128-row kv tiles in a two-stage ring; D pads to 64 or 128
  columns with TMA's zero fill (Q.K^T stops at D);
* ``"tf32x3"``, float32: one TF32 product would keep 11 significant
  bits, short of the f32 tolerance, so each operand is split into a TF32
  high part and a TF32 remainder and a . b = hi.hi + hi.lo + lo.hi, on
  mma.sync m16n8k8 from TMA-loaded f32 tiles, 64-row kv tiles in a
  two-stage ring.

Both keep the running (m, l, acc) in f32, skip kv tiles above the causal
diagonal, read kv heads in place for GQA and mask the ragged last tiles,
so any length works.  TMA takes 16-byte-aligned addresses only, so the
wrapper first copies an operand that starts off a 16-byte mark (a
contiguous view such as ``buf[1:]``) into fresh memory.
``flash_attention`` launches a kernel for CUDA tensors and takes
``ref.attention_plain`` for CPU tensors; there is no fallback from the
card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)      # instantiated in the CUDA source
# each route's launcher and launch counter
ENTRY = {"tc": "flash_attention_tc_fwd", "tf32x3": "flash_attention_f32_fwd"}
COUNTER = {"tc": "flash_attention_tc", "tf32x3": "flash_attention_f32"}
Q_TILE = 128                               # q rows a block, both routes


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head dim d): ``"tc"`` (bf16 wgmma)
    or ``"tf32x3"`` (f32 as three TF32 products).  Both routes are built
    for every d in ``HEAD_DIMS`` and for no other, which this refuses."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


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
    rt = route(q.dtype, d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    # TMA reads from 16-byte-aligned addresses only: a contiguous view
    # that starts off a 16-byte mark is copied into fresh memory
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    blocks = b * h * -(-s // Q_TILE)
    if blocks >= 2 ** 31:
        raise ValueError(f"B * H * ceil(S / {Q_TILE}) = {blocks}: the grid "
                         "takes at most 2**31 - 1 blocks")
    fn = _build.function(ENTRY[rt])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], d, int(causal), d ** -0.5,
            _build.stream_handle(q.device))
    _build.check(rc, ENTRY[rt])
    _build.LAUNCHES[COUNTER[rt]] += 1
    return o
