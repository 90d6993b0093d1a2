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

Training differentiates through ``FlashAttentionFn``. Its forward is the
kernel's launch (``_launch``), which also writes each row's log-sum-exp
(B, H, Sq) f32 when a gradient will be asked for; it saves q, k, v, o
and that. Its backward is the backward kernel's call
(``_launch_backward``: three launches, or four, counted once, under the
profiler label ``BACKWARD``): Delta = rowsum(dO o O), then dK and dV by kv tile,
then dQ by q tile, with P recomputed from the saved log-sum-exp. In
bfloat16 (``kernels/csrc/flash_attention_bwd.cu``) dK / dV and dQ are
Hopper kernels of the forward's shape: a block of three warpgroups per
128-row kv (q) tile, a producer issuing TMA loads of 64-row q and dO
(64- or 128-row k and v, ``backward_steps``) tiles into a two-stage
ring, two consumers on wgmma with the tile they own resident and their
gradient in registers; under the position mask dQ visits the forward's
kv tile list and dK / dV its transpose (``ref.kv_tile_visits``: a q tile
with a row that keeps no key is on every list). A dK / dV block loops
over its kv head's GQA group, or, where those blocks would be fewer than
the card's SMs (``_splits_group``), each q head takes blocks of its own
and one more launch sums their f32 shares in the group's order. In
float32 (``kernels/csrc/flash_attention.cu``) a block of four warps owns
a 64-row tile and streams 64-row steps (32 above D 64) staged by
cp.async; every product is split TF32 on mma.sync (three tensor-core
products, as the forward's f32 route), an earlier product's accumulator
feeding the next straight from registers; a dK / dV block takes one q
head, and with GQA a fourth launch sums the group's shares in order;
under the position mask dQ and dK / dV walk the same tile lists as the
bf16 route.
No sum uses atomics and each runs in a fixed order, so two calls give
the same bits. On a CUDA tensor it launches those kernels or raises; it
never falls back. The two launchers are the
seams that a CPU test swaps for the plain versions:
``ref.attention_plain`` for the forward, and ``plain_backward`` for the
backward. ``plain_backward`` runs ``ref.attention_plain`` again on the
saved q, k, v (and positions) under autograd, a batch row and a group of
kv heads at a time, so that the f32 scores of a slice stay within
``BACKWARD_SCORE_BYTES``; the card runs it only to check the kernel. The
reference has no backward kernel: its training attention is XLA's dense
or chunked softmax attention, which XLA differentiates
(``repro/models/attention.py:184-205``).

On fake tensors (stand-ins that hold no data: the dry run's) the wrapper
calls the kernel's function as one op, ``repro_torch::flash_attention``
(o and the rows' log-sum-exp), differentiated by one op too,
``repro_torch::flash_attention_backward`` (what the backward kernel
reads and writes): a counting dispatch mode sees each once, with the
kernels' operands and results as its bytes and ``attention_flops`` as its
operations, where the plain version would show the dense S x S scores
that no kernel writes.  On real CPU tensors
the two ops compute the plain version and its gradients.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)      # instantiated in the CUDA source
# each route's launcher and launch counter, forward and backward
ENTRY = {"tc": "flash_attention_tc_fwd", "tf32x3": "flash_attention_f32_fwd"}
COUNTER = {"tc": "flash_attention_tc", "tf32x3": "flash_attention_f32"}
BACKWARD_ENTRY = {"tc": "flash_attention_tc_bwd",
                  "tf32x3": "flash_attention_f32_bwd"}
BACKWARD_COUNTER = {"tc": "flash_attention_bwd_tc",
                    "tf32x3": "flash_attention_bwd_f32"}
Q_TILE = 128                               # q rows a block, both routes
# rows a block of the backward's three launches, per route: Delta's (b, i,
# h) rows, dK / dV's kv rows, dQ's q rows
BACKWARD_BLOCKS = {"tc": (256, 128, 128), "tf32x3": (8, 64, 64)}


def backward_steps(dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """The rows a step of the backward streams past a block's own tile:
    (q rows past dK / dV's kv tile, kv rows past dQ's q tile)."""
    if route(dtype, d) == "tf32x3":
        return (64, 64) if d <= 64 else (32, 32)
    return 64, 128 if d <= 80 else 64
# the f32 scores one slice of the plain backward holds (it holds a few
# tensors of that size while autograd runs)
BACKWARD_SCORE_BYTES = 1 << 30
BACKWARD = "flash_attention.backward"      # the backward kernel's label


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
    """The kernel forward (``_launch``), which writes the rows' log-sum-exp
    where a gradient will be asked for, and the backward kernel
    (``_launch_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_pos, k_pos):
        ctx.causal = causal
        lse = None
        if any(ctx.needs_input_grad[:3]):     # serving's tensors need none
            b, sq, h, _ = q.shape
            lse = torch.empty((b, h, sq), dtype=torch.float32,
                              device=q.device)
        o = _launch(q, k, v, causal, q_pos, k_pos, lse)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, go):
        q, k, v, o, lse, q_pos, k_pos = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD):
            grads = _launch_backward(go, q, k, v, o, lse, ctx.causal, q_pos,
                                     k_pos)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad[:3])),
                None, None, None)


def plain_backward(q, k, v, go, *, causal: bool, q_pos=None, k_pos=None):
    """The gradients (dq, dk, dv) of ``ref.attention_plain`` at (q, k, v)
    against the output's gradient ``go``, computed by autograd over slices
    of batch rows and kv heads (with their q heads) whose f32 scores stay
    within ``BACKWARD_SCORE_BYTES``."""
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if q.numel() == 0:
        return [torch.zeros_like(t) for t in (q, k, v)]
    out = [torch.empty_like(t) for t in (q, k, v)]
    head_bytes = max(g * sq * sk * 4, 1)
    heads = max(1, min(kvh, BACKWARD_SCORE_BYTES // head_bytes))
    rows = max(1, BACKWARD_SCORE_BYTES // (head_bytes * kvh)) \
        if heads == kvh else 1
    for r0 in range(0, b, rows):
        r = slice(r0, r0 + rows)
        for k0 in range(0, kvh, heads):
            kv_h = slice(k0, k0 + heads)
            q_h = slice(k0 * g, (k0 + heads) * g)
            parts = [t[r, :, sl].detach().requires_grad_()
                     for t, sl in ((q, q_h), (k, kv_h), (v, kv_h))]
            with torch.enable_grad():
                o = ref.attention_plain(
                    *parts, causal=causal,
                    q_pos=None if q_pos is None else q_pos[r],
                    k_pos=None if k_pos is None else k_pos[r])
                grads = torch.autograd.grad(o, parts, go[r, :, q_h])
            for dst, sl, grad in zip(out, (q_h, kv_h, kv_h), grads):
                dst[r, :, sl] = grad
    return out


def _require_on(q, named) -> None:
    """Each named tensor on q's device and contiguous."""
    for t, name in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def _aligned(*ts):
    """The tensors, each that starts off a 16-byte mark (a contiguous view
    such as ``buf[1:]``) copied into fresh memory: TMA and cp.async read
    from 16-byte-aligned addresses only."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _launch(q, k, v, causal, q_pos, k_pos, lse=None) -> torch.Tensor:
    """One launch of the route's kernel on checked CUDA tensors, counted;
    the output like q.  A given ``lse`` ((B, H, Sq) f32) receives the
    rows' log-sum-exp."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    named = [(q, "q"), (k, "k"), (v, "v")]
    if q_pos is not None:
        named += [(q_pos, "q_pos"), (k_pos, "k_pos")]
    if lse is not None:
        if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
            raise ValueError(f"lse: want ({b}, {h}, {sq}) float32, got "
                             f"{tuple(lse.shape)} {lse.dtype}")
        named.append((lse, "lse"))
    _require_on(q, named)
    rt = route(q.dtype, d)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    q, k, v = _aligned(q, k, v)
    blocks = b * h * -(-sq // Q_TILE)
    if blocks >= 2 ** 31:
        raise ValueError(f"B * H * ceil(Sq / {Q_TILE}) = {blocks}: the grid "
                         "takes at most 2**31 - 1 blocks")
    fn = _build.function(ENTRY[rt])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, h,
            k.shape[2], d, int(causal),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), d ** -0.5,
            _build.stream_handle(q.device))
    _build.check(rc, ENTRY[rt])
    _build.LAUNCHES[COUNTER[rt]] += 1
    return o


def _splits_group(device, b, h, kvh, sk) -> bool:
    """Whether the bf16 backward gives a GQA group's q heads dK / dV blocks
    of their own (each head's share in f32 scratch, summed over the group
    in order by one more launch) rather than a block a kv head that loops
    over its group: where the group's blocks, B * KV * ceil(Sk / 128),
    are fewer than the card's SMs.  On an H100 (132 SMs, 700 W) the split
    took 1.64 ms against 2.10 at qwen2-vl's training shape (128 blocks)
    and 0.651 against 0.620 at granite-moe's (256), both timed by
    ``attention_probe.py --backward`` (PERF.md).  The f32 route splits
    every GQA group: it has no group loop."""
    if h == kvh:
        return False
    rows_b = BACKWARD_BLOCKS["tc"][1]
    return b * kvh * -(-sk // rows_b) < _sm_count(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_backward(go, q, k, v, o, lse, causal, q_pos, k_pos):
    """One call of the route's backward kernel (three launches: Delta, dK
    and dV, dQ; a fourth that sums a GQA group's shares of dK and dV where
    the group is split: always in f32, where ``_splits_group`` says in
    bf16) on checked CUDA tensors, counted once ->
    (dq like q, dk and dv like k).  ``o`` and ``lse`` are the forward's at
    the same arguments; ``go`` may be strided (autograd's), and is made
    contiguous."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    go = go.contiguous()
    if go.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"go {tuple(go.shape)} and o {tuple(o.shape)}: "
                         f"want q's {tuple(q.shape)}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, go,
                                                                   o)):
        raise TypeError(f"q, k, v, go and o: one type of {DTYPES}, got "
                        f"{[t.dtype for t in (q, k, v, go, o)]}")
    if lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse: want the forward's ({b}, {h}, {sq}) float32")
    named = [(go, "go"), (q, "q"), (k, "k"), (v, "v"), (o, "o"),
             (lse, "lse")]
    if q_pos is not None:
        named += [(q_pos, "q_pos"), (k_pos, "k_pos")]
    _require_on(q, named)
    rt = route(q.dtype, d)
    if q.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    go, q, k, v, o = _aligned(go, q, k, v, o)
    split = h != kvh if rt == "tf32x3" else _splits_group(q.device, b, h,
                                                           kvh, sk)
    rows_a, rows_b, rows_c = BACKWARD_BLOCKS[rt]
    heads_b = "H" if split else "KV"
    grids = {f"B * Sq * H / {rows_a}": -(-b * sq * h // rows_a),
             f"B * {heads_b} * ceil(Sk / {rows_b})":
                 b * (h if split else kvh) * -(-sk // rows_b),
             f"B * H * ceil(Sq / {rows_c})": b * h * -(-sq // rows_c)}
    for what, blocks in grids.items():
        if blocks >= 2 ** 31:
            raise ValueError(f"{what} = {blocks}: the grid takes at most "
                             "2**31 - 1 blocks")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = torch.empty((2, b, sk, h, d), dtype=torch.float32,
                       device=q.device) if split else None
    scratch = [delta.data_ptr(), None if part is None else part.data_ptr()]
    fn = _build.function(BACKWARD_ENTRY[rt])
    rc = fn(go.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *scratch, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kvh, d, int(causal),
            None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), d ** -0.5,
            _build.stream_handle(q.device))
    _build.check(rc, BACKWARD_ENTRY[rt])
    _build.LAUNCHES[BACKWARD_COUNTER[rt]] += 1
    return dq, dk, dv


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
