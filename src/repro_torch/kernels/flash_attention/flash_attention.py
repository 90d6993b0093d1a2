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

Both keep the running (m, l, acc) in f32, read kv heads in place for GQA
and mask the ragged last q and kv tiles, so any lengths work: q (B, Sq,
H, D) against k, v (B, Sk, KV, D) non-causally at any Sq and Sk (the
encoder-decoder's cross-attention), causally at Sq == Sk.  The causal
mask is by index, where the kernels skip kv tiles above the diagonal,
or, given int32 positions ``q_pos`` (B, Sq) and ``k_pos`` (B, Sk) on
q's device, by position (``q_pos[b, i] >= k_pos[b, j]`` keeps a key, as
the reference masks), where each block lists the kv tiles its rows keep
a key of, loads only those and masks only those that hold a masked
pair.  TMA takes 16-byte-aligned addresses only, so the wrapper first
copies an operand that starts off a 16-byte mark (a contiguous view
such as ``buf[1:]``) into fresh memory.
``flash_attention`` launches a kernel for CUDA tensors and takes
``ref.attention_plain`` for CPU tensors; there is no fallback from the
card to the plain version.

Training differentiates through ``FlashAttentionFn``: its forward is the
kernel's launch (``_launch``, the one seam a CPU test may swap for the
plain version), its backward runs ``ref.attention_plain`` again on the
saved q, k, v (and positions) under autograd and returns that function's
gradients, a batch row and a group of kv heads at a time so that the f32
scores of a slice stay within ``BACKWARD_SCORE_BYTES``.  The reference
has no backward kernel either: its training attention is XLA's dense or
chunked softmax attention, which XLA differentiates
(``repro/models/attention.py:184-205``).  The backward is plain torch on
the card by design, under the profiler label ``PLAIN_BACKWARD``.

On fake tensors (stand-ins that hold no data: the dry run's) the wrapper
calls the kernel's function as one op, ``repro_torch::flash_attention``
(o and the rows' log-sum-exp), differentiated by one op too,
``repro_torch::flash_attention_backward``: a counting dispatch mode sees
each once, with the kernels' operands and results as its bytes and
``attention_flops`` as its operations, where the plain version would
show the dense S x S scores that no kernel writes.  On real CPU tensors
the two ops compute the plain version and its gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)      # instantiated in the CUDA source
# each route's launcher and launch counter
ENTRY = {"tc": "flash_attention_tc_fwd", "tf32x3": "flash_attention_f32_fwd"}
COUNTER = {"tc": "flash_attention_tc", "tf32x3": "flash_attention_f32"}
Q_TILE = 128                               # q rows a block, both routes
# the f32 scores one slice of the plain backward holds (it holds a few
# tensors of that size while autograd runs)
BACKWARD_SCORE_BYTES = 1 << 30
PLAIN_BACKWARD = "flash_attention.plain_backward"


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head dim d): ``"tc"`` (bf16 wgmma)
    or ``"tf32x3"`` (f32 as three TF32 products).  Both routes are built
    for every d in ``HEAD_DIMS`` and for no other, which this refuses."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


def _check(q, k, v, causal, q_pos, k_pos) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape != (b, sk, kvh, d) or kvh == 0 \
            or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want k and v (B, Sk, KV, D) "
                         "with H a multiple of KV")
    if sk == 0 and q.numel():
        raise ValueError("attention over no keys")
    if causal and sk != sq:
        raise ValueError(f"causal attention needs as many keys as queries, "
                         f"got Sq {sq} and Sk {sk}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                            f"got {t.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if (q_pos is None) != (k_pos is None):
        raise ValueError("give both q_pos and k_pos, or neither")
    if q_pos is None:
        return
    if not causal:
        raise ValueError("positions mask causal attention only")
    for t, name, n in ((q_pos, "q_pos", sq), (k_pos, "k_pos", sk)):
        if t.shape != (b, n):
            raise ValueError(f"{name}: want ({b}, {n}), got {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: want int32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_pos: Optional[torch.Tensor] = None,
                    k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, KV, D), float32 or bfloat16 ->
    attention output like q, through the CUDA kernel (the plain version on
    the CPU), differentiable on both.  ``causal`` needs Sq == Sk;
    ``q_pos`` and ``k_pos`` (int32, (B, Sq) and (B, Sk)) make its mask one
    by position."""
    _check(q, k, v, causal, q_pos, k_pos)
    if is_fake(q):
        return attention_op(q, k, v, causal, q_pos, k_pos)[0]
    if q.device.type == "cpu":
        return ref.attention_plain(q, k, v, causal=causal, q_pos=q_pos,
                                   k_pos=k_pos)
    return FlashAttentionFn.apply(q, k, v, causal, q_pos, k_pos)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel forward (``_launch``) and the plain version's gradients
    (``plain_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_pos, k_pos):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        return _launch(q, k, v, causal, q_pos, k_pos)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, go):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        with torch.profiler.record_function(PLAIN_BACKWARD):
            gq, gk, gv = plain_backward(q, k, v, go, causal=ctx.causal,
                                        q_pos=q_pos, k_pos=k_pos,
                                        needs=ctx.needs_input_grad[:3])
        return gq, gk, gv, None, None, None


def plain_backward(q, k, v, go, *, causal: bool, q_pos=None, k_pos=None,
                   needs=(True, True, True)):
    """The gradients of ``ref.attention_plain`` at (q, k, v) against the
    output's gradient ``go`` (None where ``needs`` says no), computed by
    autograd over slices of batch rows and kv heads (with their q heads)
    whose f32 scores stay within ``BACKWARD_SCORE_BYTES``."""
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    out = [torch.empty_like(t) if need else None
           for t, need in zip((q, k, v), needs)]
    if not any(needs) or q.numel() == 0:
        return out
    head_bytes = max(g * sq * sk * 4, 1)
    heads = max(1, min(kvh, BACKWARD_SCORE_BYTES // head_bytes))
    rows = max(1, BACKWARD_SCORE_BYTES // (head_bytes * kvh)) \
        if heads == kvh else 1
    for r0 in range(0, b, rows):
        r = slice(r0, r0 + rows)
        for k0 in range(0, kvh, heads):
            kv_h = slice(k0, k0 + heads)
            q_h = slice(k0 * g, (k0 + heads) * g)
            parts = [t[r, :, sl].detach().requires_grad_(need)
                     for t, sl, need in ((q, q_h, needs[0]),
                                         (k, kv_h, needs[1]),
                                         (v, kv_h, needs[2]))]
            with torch.enable_grad():
                o = ref.attention_plain(
                    *parts, causal=causal,
                    q_pos=None if q_pos is None else q_pos[r],
                    k_pos=None if k_pos is None else k_pos[r])
                grads = iter(torch.autograd.grad(
                    o, [p for p in parts if p.requires_grad], go[r, :, q_h]))
            for dst, sl, need in zip(out, (q_h, kv_h, kv_h), needs):
                if need:
                    dst[r, :, sl] = next(grads)
    return out


def _launch(q, k, v, causal, q_pos, k_pos) -> torch.Tensor:
    """One launch of the route's kernel on checked CUDA tensors, counted;
    the output like q."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    named = [(q, "q"), (k, "k"), (v, "v")]
    if q_pos is not None:
        named += [(q_pos, "q_pos"), (k_pos, "k_pos")]
    for t, name in named:
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
    blocks = b * h * -(-sq // Q_TILE)
    if blocks >= 2 ** 31:
        raise ValueError(f"B * H * ceil(Sq / {Q_TILE}) = {blocks}: the grid "
                         "takes at most 2**31 - 1 blocks")
    fn = _build.function(ENTRY[rt])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq,
            sk, h, k.shape[2], d, int(causal),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), d ** -0.5,
            _build.stream_handle(q.device))
    _build.check(rc, ENTRY[rt])
    _build.LAUNCHES[COUNTER[rt]] += 1
    return o


# --------------------------------------------------------------------------- #
# the kernel as one op on stand-ins (see the module)
# --------------------------------------------------------------------------- #

def attention_flops(q_shape, k_shape, causal: bool,
                    backward: bool = False) -> int:
    """The operations of attention at these shapes: Q.K^T and P.V over the
    kept pairs, 2 a multiply-add (4 D a pair; the causal half at Sq ==
    Sk, i >= j, which is also what a position mask keeps where positions
    rise along the row); a backward 2.5 times that (the scores computed
    again, then dV, dP, dQ and dK)."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    fwd = 4 * b * h * d * pairs
    return fwd * 5 // 2 if backward else fwd


def _lse(q, k, causal, q_pos, k_pos) -> torch.Tensor:
    """The log-sum-exp of each row's kept scores, (B, H, Sq) f32."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * d ** -0.5
    if causal:
        keep = torch.ones(sq, sq, dtype=torch.bool, device=q.device).tril() \
            if q_pos is None else \
            q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
        scores = torch.where(keep, scores, ref.NEG_INF)
    return torch.logsumexp(scores, -1).reshape(b, h, sq)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                 q_pos: Optional[Tensor], k_pos: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    """``flash_attention``'s function as one op: (o like q, the rows'
    log-sum-exp (B, H, Sq) f32); the plain version on real tensors."""
    o = ref.attention_plain(q, k, v, causal=causal, q_pos=q_pos,
                            k_pos=k_pos)
    return o.contiguous(), _lse(q, k, causal, q_pos, k_pos).contiguous()


@attention_op.register_fake
def _(q, k, v, causal, q_pos, k_pos):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=(), device_types="cpu")
def attention_backward_op(go: Tensor, q: Tensor, k: Tensor, v: Tensor,
                          o: Tensor, lse: Tensor, causal: bool,
                          q_pos: Optional[Tensor], k_pos: Optional[Tensor]
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """The gradients of ``attention_op``'s o at (q, k, v) against ``go``,
    given the forward's o and log-sum-exp (what a backward kernel reads);
    on real tensors the plain version's gradients (``torch.func.vjp``: an
    op's own code runs below autograd)."""
    _, vjp = torch.func.vjp(
        lambda q, k, v: ref.attention_plain(q, k, v, causal=causal,
                                            q_pos=q_pos, k_pos=k_pos),
        q, k, v)
    return tuple(g.contiguous() for g in vjp(go))


@attention_backward_op.register_fake
def _(go, q, k, v, o, lse, causal, q_pos, k_pos):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal, q_pos, k_pos = inputs
    ctx.causal = causal
    ctx.set_materialize_grads(False)          # lse's gradient: none
    ctx.save_for_backward(q, k, v, *output, q_pos, k_pos)


def _attention_backward(ctx, go, _glse):
    q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
    return (*attention_backward_op(go, q, k, v, o, lse, ctx.causal, q_pos,
                                   k_pos), None, None, None)


attention_op.register_autograd(_attention_backward,
                               setup_context=_attention_setup)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _attention_op_flops(q_shape, k_shape, v_shape, causal, *args,
                        out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _attention_backward_op_flops(go_shape, q_shape, k_shape, v_shape,
                                 o_shape, lse_shape, causal, *args,
                                 out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, causal, backward=True)
