"""The SSD (Mamba-2) chunk scan — wrapper, routes and plain version.

The CUDA kernels (``kernels/csrc/ssd.cu``) replace the TPU's
``ssd_pallas`` with the state-passing form of the scan: one ``ssd_fwd``
call launches three passes, the chunk states (a block per batch row,
chunk and head), the state passing (the chunks of a head in sequence,
elementwise, in place on the scratch) and the chunk scan (a block per
batch row, chunk and head), so the chunks of a head run in parallel.
``route`` picks the arithmetic from the type and the widths before the
launch, never from the length, the batch or the pointers:

* ``"tc"``, bfloat16 with hd and ds multiples of 16: tensor cores
  (``mma.sync`` bf16 -> f32), every f32 operand split into a bf16 high
  part and a bf16 remainder, two products summed in f32; counter
  ``ssd_tc``;
* ``"cuda_core"``, float32 and bfloat16 at the other widths: f32 FMAs;
  counter ``ssd``.

``ssd_scan`` launches the kernels for CUDA tensors and takes
``ref.ssd_plain`` for CPU tensors; there is no fallback from the card to
the plain version.  ``run_passes`` launches chosen passes on buffers the
caller gives, for the card tests and per-pass timing; it counts no
launch.  The wrapper allocates the scratch (``scratch``) with
``torch.empty``.

Training differentiates through ``SSDScanFn``: its forward is
``_scan`` (the kernels' launch, the one seam a CPU test may swap for the
plain version), its backward ``_scan_backward``, one call of the backward
kernels (``kernels/csrc/ssd_bwd.cu``: one ``ssd_bwd`` call of four
passes, ``BACKWARD_PASSES``, counted once on ``BACKWARD_COUNTER``, under
the profiler label ``BACKWARD``): each chunk's own state and what its y
sends back to its entering state, the two state passings (the states in
order into the entering states, the latter in reverse into their
gradients), a chunk pass for dx, dt, the shares of db and dc and the
blocks' shares of da_log and d_skip, and fixed-order sums of the shares.
On the tensor-core route the products of the first and third are wgmma,
on the CUDA-core route split TF32 on ``mma.sync`` (each f32 operand hi +
lo, three products summed in f32); on both the chunk pass runs in
thread-block clusters of ``backward_cluster`` heads of one group that sum
their db and dc shares on the chip, one share a cluster
(``cluster_heads``), and the sums are one launch.
The reference has no backward kernel: it trains
through ``ssd_chunked``, which XLA differentiates.  On a CUDA tensor the backward
launches or raises; on a CPU tensor (a test's) it takes
``plain_backward``, autograd of the plain version in its chunk-parallel
form, ``ref.ssd_chunked_plain`` (the kernel's three passes, which
``ssd_plain``'s chunk-by-chunk loop equals).  ``ref.ssd_backward_plain``
writes the same gradients out pass by pass; the card's tests and
``chip_smoke.py`` hold the kernel against both.

On fake tensors (stand-ins that hold no data: the dry run's) the wrapper
calls the kernels' function as one op, ``repro_torch::ssd_scan``,
differentiated by one op too, ``repro_torch::ssd_scan_backward``: a
counting dispatch mode sees each once, with the kernels' operands and
results as its bytes and ``ssd_flops`` as its operations, where the
plain version would show its intra-chunk intermediates.  On real CPU
tensors the two ops compute the plain version and its gradients.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_WIDTH = 128                 # hd and ds: the widest tiles built
CHUNK_STEP = 32                 # chunk: a multiple of this, at most 128
MAX_CHUNK = 128
TC_STEP = 16                    # the tensor-core route's width step
PASSES = ("chunk_states", "state_pass", "chunk_scan")
COUNTER = {"tc": "ssd_tc", "cuda_core": "ssd"}
BACKWARD_COUNTER = {"tc": "ssd_bwd_tc", "cuda_core": "ssd_bwd"}
BACKWARD_PASSES = ("states", "state_pass", "chunk", "reduce")
MAX_CLUSTER = 8                 # heads a cluster of the backward's chunk pass
BACKWARD_OUTPUTS = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")
BACKWARD = "ssd.backward"
# what the names of the backward's kernels share (a ctypes launch runs
# under no torch op, so a profile finds them by name)
BACKWARD_KERNELS = "ssd_grad::"


def route(dtype: torch.dtype, hd: int, ds: int) -> str:
    """The kernel that takes (dtype, hd, ds): ``"tc"`` (tensor cores) or
    ``"cuda_core"``."""
    return "tc" if dtype == torch.bfloat16 and hd % TC_STEP == 0 \
        and ds % TC_STEP == 0 else "cuda_core"


def _mode(dtype: torch.dtype, hd: int, ds: int) -> int:
    """``ssd_fwd``'s mode: 0 f32 and 1 bf16 on the CUDA cores, 2 tensor
    cores."""
    if route(dtype, hd, ds) == "tc":
        return 2
    return int(dtype == torch.bfloat16)


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


def _check_card(x, dt, a_log, b, c, d_skip, chunk) -> None:
    """What the kernels take beyond ``_check``: one device, contiguous
    tensors, the widths and chunks built, a grid of at most 2**31 - 1."""
    for t, name in ((x, "x"), (dt, "dt"), (a_log, "a_log"), (b, "b"),
                    (c, "c"), (d_skip, "d_skip")):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    bsz, s, nh, hd = x.shape
    ds = b.shape[3]
    if hd > MAX_WIDTH or ds > MAX_WIDTH or chunk > MAX_CHUNK \
            or chunk % CHUNK_STEP:
        raise ValueError(f"hd {hd}, ds {ds}, chunk {chunk}: the kernel takes "
                         f"hd, ds <= {MAX_WIDTH} and a chunk that is a "
                         f"multiple of {CHUNK_STEP} up to {MAX_CHUNK}")
    if bsz * nh * -(-s // chunk) >= 2 ** 31:
        raise ValueError(f"B * nh * ceil(S / chunk) = "
                         f"{bsz * nh * -(-s // chunk)}: the grid takes at "
                         "most 2**31 - 1 blocks")


def scratch(x: torch.Tensor, chunk: int, ds: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The passes' scratch for x (B, S, nh, hd): the chunk states
    (B, nh, nc, hd, ds) f32 and the chunk decays (B, nh, nc) f32."""
    bsz, s, nh, hd = x.shape
    nc = -(-s // chunk)
    return (torch.empty((bsz, nh, nc, hd, ds), dtype=torch.float32,
                        device=x.device),
            torch.empty((bsz, nh, nc), dtype=torch.float32, device=x.device))


def _launch(x, dt, a_log, b, c, d_skip, y, h, states, decay, chunk,
            passes: int) -> None:
    bsz, s, nh, hd = x.shape
    ng, ds = b.shape[2], b.shape[3]
    fn = _build.function("ssd_fwd")
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h.data_ptr(),
            states.data_ptr(), decay.data_ptr(), bsz, s, nh, hd, ng, ds,
            chunk, _mode(x.dtype, hd, ds), passes,
            _build.stream_handle(x.device))
    _build.check(rc, "ssd_fwd")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 128):
    """x (B, S, nh, hd); dt (B, S, nh) f32; a_log, d_skip (nh,) f32; b, c
    (B, S, ng, ds) of x's type -> (y like x, final state (B, nh, hd, ds)
    f32), through the CUDA kernels (the plain version on the CPU),
    differentiable on both."""
    _check(x, dt, a_log, b, c, d_skip, chunk)
    if is_fake(x):
        return scan_op(x, dt, a_log, b, c, d_skip, chunk)
    if x.device.type == "cpu":
        return ref.ssd_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    _check_card(x, dt, a_log, b, c, d_skip, chunk)
    return SSDScanFn.apply(x, dt, a_log, b, c, d_skip, chunk)


class SSDScanFn(torch.autograd.Function):
    """The kernels' forward (``_scan``) and backward (``_scan_backward``);
    the final state's gradient may be absent."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip)
        return _scan(x, dt, a_log, b, c, d_skip, chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gh):
        needs = ctx.needs_input_grad[:6]
        if not any(needs) or (gy is None and gh is None):
            return (None,) * 7
        with torch.profiler.record_function(BACKWARD):
            grads = _scan_backward(*ctx.saved_tensors, gy, gh, ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, needs)),
                None)


def plain_backward(x, dt, a_log, b, c, d_skip, gy, gh, *, chunk: int = 128):
    """The gradients of the plain version (``ref.ssd_chunked_plain``) at
    its six inputs against those of y and the final state (either may be
    None), by autograd; None where neither output has a gradient."""
    live = [(i, g) for i, g in enumerate((gy, gh)) if g is not None]
    if not live:
        return [None] * 6
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c, d_skip)]
    with torch.enable_grad():
        outs = ref.ssd_chunked_plain(*ins, chunk=chunk)
        return list(torch.autograd.grad([outs[i] for i, _ in live], ins,
                                        [g for _, g in live]))


def _scan(x, dt, a_log, b, c, d_skip, chunk):
    """One ``ssd_fwd`` call (its three passes) on checked CUDA tensors,
    counted: (y like x, the final state (B, nh, hd, ds) f32)."""
    bsz, s, nh, hd = x.shape
    ds = b.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((bsz, nh, hd, ds), dtype=torch.float32, device=x.device)
    if bsz * nh == 0:
        return y, h
    states, decay = scratch(x, chunk, ds)
    _launch(x, dt, a_log, b, c, d_skip, y, h, states, decay, chunk, 7)
    _build.LAUNCHES[COUNTER[route(x.dtype, hd, ds)]] += 1
    return y, h


def cluster_heads(rep: int) -> int:
    """The heads of a cluster of the tensor-core chunk pass for ``rep``
    heads a group: the largest divisor of ``rep`` up to ``MAX_CLUSTER``."""
    return max(c for c in range(1, min(rep, MAX_CLUSTER) + 1) if rep % c == 0)


def backward_cluster(dtype: torch.dtype, hd: int, ds: int, nh: int,
                     ng: int) -> int:
    """The heads that share a cluster of the backward's chunk pass, and so
    one share of db and dc: ``cluster_heads(nh // ng)`` on either route
    (the type and widths pick the route, not the cluster)."""
    return cluster_heads(nh // ng)


def cluster_share_sum(part: torch.Tensor, ng: int, cluster: int
                      ) -> torch.Tensor:
    """The plain version of the backward's two-level sum of the heads'
    shares (B, S, nh, ds) into (B, S, ng, ds), in the kernel's order: each
    cluster's ``cluster`` heads in order (the chunk pass, into one share a
    cluster), then a group's clusters in order (the reduce pass)."""
    bsz, s, nh, ds = part.shape
    heads = part.reshape(bsz, s, nh // cluster, cluster, ds)
    shares = heads[:, :, :, 0]
    for r in range(1, cluster):
        shares = shares + heads[:, :, :, r]
    groups = shares.reshape(bsz, s, ng, nh // cluster // ng, ds)
    out = groups[:, :, :, 0]
    for k in range(1, groups.shape[3]):
        out = out + groups[:, :, :, k]
    return out


def _backward_layout(x: torch.Tensor, b: torch.Tensor, chunk: int,
                     cluster: int = 1
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, type) of each of the backward's buffers: the scratch (f32:
    the chunk states, then the entering states, and their gradients (B,
    nh, nc, hd, ds), the chunk decays and the blocks' shares of da_log and
    d_skip (B, nh, nc), the shares of db and dc, one a cluster of
    ``cluster`` heads (B, S, nh / cluster, ds)) and the outputs (dx like
    x, ddt (B, S, nh) f32, da_log and dd_skip (nh,) f32, db and dc like b)
    for x (B, S, nh, hd) and b (B, S, ng, ds)."""
    bsz, s, nh, hd = x.shape
    ds = b.shape[3]
    nc = -(-s // chunk)
    f32 = torch.float32
    return {"states": ((bsz, nh, nc, hd, ds), f32),
            "decay": ((bsz, nh, nc), f32),
            "dstates": ((bsz, nh, nc, hd, ds), f32),
            "db_part": ((bsz, s, nh // cluster, ds), f32),
            "dc_part": ((bsz, s, nh // cluster, ds), f32),
            "dalog_part": ((bsz, nh, nc), f32), "dd_part": ((bsz, nh, nc), f32),
            "dx": (tuple(x.shape), x.dtype), "ddt": ((bsz, s, nh), f32),
            "da_log": ((nh,), f32), "db": (tuple(b.shape), b.dtype),
            "dc": (tuple(b.shape), b.dtype), "dd_skip": ((nh,), f32)}


def _cluster_of(x: torch.Tensor, b: torch.Tensor,
                cluster: Optional[int]) -> int:
    """``cluster``, or the route's (``backward_cluster``) where None; a
    cluster the chunk pass does not take (not a divisor of a group's heads
    up to ``MAX_CLUSTER``) raises."""
    _, _, nh, hd = x.shape
    ng, ds = b.shape[2], b.shape[3]
    if cluster is None:
        return backward_cluster(x.dtype, hd, ds, nh, ng)
    rep = nh // ng
    if not 1 <= cluster <= MAX_CLUSTER or rep % cluster:
        raise ValueError(f"cluster {cluster}: the chunk pass takes a "
                         f"divisor of the {rep} heads of a group up to "
                         f"{MAX_CLUSTER}")
    return cluster


def backward_buffers(x: torch.Tensor, b: torch.Tensor, chunk: int,
                     cluster: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """The backward's buffers (``_backward_layout``) for clusters of
    ``cluster`` heads (None: the route's), uninitialised, on x's
    device."""
    cluster = _cluster_of(x, b, cluster)
    return {k: torch.empty(shape, dtype=dtype, device=x.device)
            for k, (shape, dtype) in
            _backward_layout(x, b, chunk, cluster).items()}


def _launch_backward(x, dt, a_log, b, c, d_skip, gy, gh, bufs, chunk,
                     cluster: int, passes: int) -> None:
    bsz, s, nh, hd = x.shape
    ng, ds = b.shape[2], b.shape[3]
    fn = _build.function("ssd_bwd")
    ptr = [bufs[k].data_ptr() for k in (
        "states", "decay", "dstates", "db_part", "dc_part", "dalog_part",
        "dd_part", *BACKWARD_OUTPUTS)]
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(), gy.data_ptr(),
            None if gh is None else gh.data_ptr(), *ptr, bsz, s, nh, hd, ng,
            ds, chunk, cluster, _mode(x.dtype, hd, ds), passes,
            _build.stream_handle(x.device))
    _build.check(rc, "ssd_bwd")


def _backward_operands(x, b, gy, gh):
    """gy in x's type and gh f32, contiguous on x's device (gy None: zero;
    gh None stays None, the kernel's zero)."""
    bsz, _, nh, hd = x.shape
    ds = b.shape[3]
    gy = torch.zeros_like(x) if gy is None else gy.to(x.dtype).contiguous()
    if gh is not None:
        gh = gh.to(torch.float32).contiguous()
    for t, name, shape in ((gy, "gy", tuple(x.shape)),
                           (gh, "gh", (bsz, nh, hd, ds))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return gy, gh


def _scan_backward(x, dt, a_log, b, c, d_skip, gy, gh, chunk):
    """The gradients (dx, ddt, da_log, db, dc, dd_skip) of ``_scan`` at its
    inputs against gy and gh (either may be None: zero): one ``ssd_bwd``
    call (its four passes) on checked CUDA tensors, counted once;
    ``plain_backward``'s on CPU tensors."""
    if x.device.type == "cpu":
        return plain_backward(x, dt, a_log, b, c, d_skip, gy, gh,
                              chunk=chunk)
    _check(x, dt, a_log, b, c, d_skip, chunk)
    _check_card(x, dt, a_log, b, c, d_skip, chunk)
    gy, gh = _backward_operands(x, b, gy, gh)
    bsz, _, nh, hd = x.shape
    ds = b.shape[3]
    cluster = backward_cluster(x.dtype, hd, ds, nh, b.shape[2])
    bufs = backward_buffers(x, b, chunk, cluster)
    if bsz * nh == 0:                   # nothing to launch
        return tuple(bufs[k].zero_() for k in BACKWARD_OUTPUTS)
    _launch_backward(x, dt, a_log, b, c, d_skip, gy, gh, bufs, chunk,
                     cluster, 2 ** len(BACKWARD_PASSES) - 1)
    _build.LAUNCHES[BACKWARD_COUNTER[route(x.dtype, hd, ds)]] += 1
    return tuple(bufs[k] for k in BACKWARD_OUTPUTS)


def run_backward_passes(x, dt, a_log, b, c, d_skip, gy, gh, *,
                        bufs: Dict[str, torch.Tensor], chunk: int = 128,
                        passes: Sequence[str] = BACKWARD_PASSES,
                        cluster: Optional[int] = None) -> None:
    """Launch the named passes of the backward's route, in their order, on
    the caller's ``backward_buffers`` (for the same ``cluster``; None: the
    route's): ``states`` writes each chunk's own state into ``states``, its
    decay, and R (what its y sends back to its entering state) into
    ``dstates``, ``state_pass`` turns those in place into the entering
    states and their gradients dS, ``chunk`` writes dx, ddt and the
    shares, ``reduce`` sums the shares into db, dc, da_log and dd_skip.
    CUDA tensors only; counts no launch."""
    _check(x, dt, a_log, b, c, d_skip, chunk)
    if x.device.type != "cuda":
        raise ValueError("run_backward_passes launches the kernels: it takes "
                         f"CUDA tensors, got {x.device}")
    _check_card(x, dt, a_log, b, c, d_skip, chunk)
    gy, gh = _backward_operands(x, b, gy, gh)
    unknown = set(passes) - set(BACKWARD_PASSES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}; the passes are "
                         f"{BACKWARD_PASSES}")
    cluster = _cluster_of(x, b, cluster)
    for k, (shape, dtype) in _backward_layout(x, b, chunk, cluster).items():
        t = bufs[k]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{k}: expected a contiguous {shape} {dtype} "
                             f"on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if x.shape[0] * x.shape[2]:
        _launch_backward(x, dt, a_log, b, c, d_skip, gy, gh, bufs, chunk,
                         cluster, sum(1 << i for i, p in
                                      enumerate(BACKWARD_PASSES)
                                      if p in passes))


def run_passes(x, dt, a_log, b, c, d_skip, *, states: torch.Tensor,
               decay: torch.Tensor, y: torch.Tensor, h: torch.Tensor,
               chunk: int = 128, passes: Sequence[str] = PASSES) -> None:
    """Launch the named passes of ``ssd_scan``'s route, in their order, on
    the caller's buffers (``scratch`` and y, h like ``ssd_scan``'s):
    ``chunk_states`` writes states and decay, ``state_pass`` turns states
    into the state entering each chunk in place and writes h,
    ``chunk_scan`` reads that and writes y.  CUDA tensors only; counts no
    launch."""
    _check(x, dt, a_log, b, c, d_skip, chunk)
    if x.device.type != "cuda":
        raise ValueError("run_passes launches the kernels: it takes CUDA "
                         f"tensors, got {x.device}")
    _check_card(x, dt, a_log, b, c, d_skip, chunk)
    bsz, s, nh, hd = x.shape
    nc, ds = -(-s // chunk), b.shape[3]
    f32 = torch.float32
    want = {"states": ((bsz, nh, nc, hd, ds), f32), "decay": ((bsz, nh, nc),
                                                              f32),
            "y": (tuple(x.shape), x.dtype), "h": ((bsz, nh, hd, ds), f32)}
    for t, name in ((states, "states"), (decay, "decay"), (y, "y"),
                    (h, "h")):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: expected a contiguous {shape} "
                             f"{dtype} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    unknown = set(passes) - set(PASSES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}; the passes are "
                         f"{PASSES}")
    if bsz * nh:
        _launch(x, dt, a_log, b, c, d_skip, y, h, states, decay, chunk,
                sum(1 << i for i, p in enumerate(PASSES) if p in passes))


def occupancy(dtype: torch.dtype, hd: int, ds: int, chunk: int
              ) -> Dict[str, Tuple[int, int]]:
    """Per pass of (dtype, hd, ds, chunk)'s route on the current card:
    (blocks that fit on one SM, shared bytes a block takes)."""
    blocks, smem = (ctypes.c_int32 * 3)(), (ctypes.c_int32 * 3)()
    fn = _build.function("ssd_occupancy")
    _build.check(fn(_mode(dtype, hd, ds), hd, ds, chunk, blocks, smem),
                 "ssd_occupancy")
    return {p: (blocks[i], smem[i]) for i, p in enumerate(PASSES)}


def _backward_occupancy(dtype, hd, ds, chunk, cluster):
    blocks, smem = (ctypes.c_int32 * 2)(), (ctypes.c_int32 * 2)()
    clusters = (ctypes.c_int32 * 1)()
    fn = _build.function("ssd_bwd_occupancy")
    _build.check(fn(_mode(dtype, hd, ds), hd, ds, chunk, cluster, blocks,
                    smem, clusters), "ssd_bwd_occupancy")
    return blocks, smem, clusters[0]


def backward_occupancy(dtype: torch.dtype, hd: int, ds: int, chunk: int
                       ) -> Dict[str, Tuple[int, int]]:
    """For the backward's passes with shared memory of their own
    (``states``, ``chunk``) at (dtype, hd, ds, chunk)'s route on the
    current card: (blocks that fit on one SM, shared bytes a block
    takes)."""
    blocks, smem, _ = _backward_occupancy(dtype, hd, ds, chunk, 1)
    return {p: (blocks[i], smem[i]) for i, p in
            enumerate(("states", "chunk"))}


def backward_clusters(dtype: torch.dtype, hd: int, ds: int, chunk: int,
                      cluster: int) -> int:
    """The clusters of ``cluster`` blocks of the backward's chunk pass at
    (dtype, hd, ds, chunk)'s route that the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    return _backward_occupancy(dtype, hd, ds, chunk, cluster)[2]


# --------------------------------------------------------------------------- #
# the kernels as one op on stand-ins (see the module)
# --------------------------------------------------------------------------- #

def ssd_flops(x_shape, b_shape, chunk: int, backward: bool = False) -> int:
    """The operations of the chunked scan at these shapes, per head and
    chunk of L tokens: C.B^T and the scores times x over the causal half,
    (ds + hd) L (L + 1), and C.H^T and the state update in full, 4 L hd
    ds; a backward twice that (each product's gradient for each of its
    two operands)."""
    bsz, s, nh, hd = x_shape
    ds = b_shape[3]
    per_head = sum((ds + hd) * n * (n + 1) + 4 * n * hd * ds
                   for n in (min(chunk, s - t) for t in range(0, s, chunk)))
    fwd = bsz * nh * per_head
    return 2 * fwd if backward else fwd


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def scan_op(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
            d_skip: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """``ssd_scan``'s function as one op: (y like x, the final state (B, nh,
    hd, ds) f32); the plain version on real tensors."""
    y, h = ref.ssd_plain(x, dt, a_log, b, c, d_skip, chunk=chunk)
    return y.contiguous(), h.contiguous()


@scan_op.register_fake
def _(x, dt, a_log, b, c, d_skip, chunk):
    bsz, _, nh, hd = x.shape
    return x.new_empty(x.shape), x.new_empty((bsz, nh, hd, b.shape[3]),
                                             dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssd_scan_backward", mutates_args=(),
                         device_types="cpu")
def scan_backward_op(gy: Tensor, gh: Optional[Tensor], x: Tensor,
                     dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
                     d_skip: Tensor, chunk: int
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                Tensor]:
    """The gradients of ``scan_op`` at its six inputs against those of y
    and the final state (None: zero); on real tensors the plain version's
    (``ref.ssd_chunked_plain``'s, by ``torch.func.vjp``: an op's own code
    runs below autograd)."""
    (_, h), vjp = torch.func.vjp(
        lambda *a: ref.ssd_chunked_plain(*a, chunk=chunk),
        x, dt, a_log, b, c, d_skip)
    return tuple(g.contiguous() for g in
                 vjp((gy, torch.zeros_like(h) if gh is None else gh)))


@scan_backward_op.register_fake
def _(gy, gh, x, dt, a_log, b, c, d_skip, chunk):
    return tuple(t.new_empty(t.shape) for t in (x, dt, a_log, b, c, d_skip))


def _scan_setup(ctx, inputs, output):
    ctx.chunk = inputs[-1]
    ctx.set_materialize_grads(False)          # an unused output's: None
    ctx.save_for_backward(*inputs[:-1])


def _scan_op_backward(ctx, gy, gh):
    saved = ctx.saved_tensors
    gy = torch.zeros_like(saved[0]) if gy is None else gy
    return (*scan_backward_op(gy, gh, *saved, ctx.chunk), None)


scan_op.register_autograd(_scan_op_backward, setup_context=_scan_setup)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _scan_op_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, d_shape,
                   chunk, *args, out_shape=None, **kwargs) -> int:
    return ssd_flops(x_shape, b_shape, chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_backward)
def _scan_backward_op_flops(gy_shape, gh_shape, x_shape, dt_shape, a_shape,
                            b_shape, c_shape, d_shape, chunk, *args,
                            out_shape=None, **kwargs) -> int:
    return ssd_flops(x_shape, b_shape, chunk, backward=True)
