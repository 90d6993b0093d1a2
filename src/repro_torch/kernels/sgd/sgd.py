"""Minibatch SGD for GLMs (paper §VI, Fig. 9) — wrapper and plain version.

The CUDA kernels (``kernels/csrc/sgd.cu``) replace the TPU's
``sgd_pallas`` in two routes, which ``route`` picks from (n, minibatch)
alone before the launch:

* ``"ring"`` (``ring_plan`` takes n): a cluster of C blocks per job
  (C = 1 up to 1,024 features), the features split between them and four
  a thread, a producer warp a block keeping a ring of the next three
  minibatches' tiles in shared memory full with bulk copies
  (cp.async.bulk) before a step needs them; one barrier a step.  The
  bulk copies read 16-byte-aligned rows, so the ring takes
  n % 4 == 0, and the wrapper copies a dataset or label column that
  starts off a 16-byte mark into fresh memory first;
* ``"split"`` (``split_plan`` takes every other (n, minibatch), at any
  width that fits on the card): up to four jobs share the tiles; each
  group's features are split over P blocks, a producer warp a block
  copying the block's slice of each minibatch into a ring of 512-feature
  sub-tiles with bulk copies (from each row's 16-byte-aligned cover, so
  any n), and the blocks exchange their dot products' sums once a step:
  inside one cluster (P <= 16, distributed shared memory) where a
  cluster's blocks keep a step's tile in their rings, else across a
  cooperative launch of 128 blocks (device memory and a grid barrier;
  the wrapper allocates its exchange and counter).  The update reads the
  tile from the ring where it stays there, else from L2.  Each block's
  slice of the model stays in shared memory where it fits, else in
  device memory.

Every reduction runs in an order fixed by (n, minibatch), so a job's
weights do not depend on how the rows are cut into launches (at minibatch
boundaries) or on which jobs share a launch.  ``sgd`` launches a kernel
for CUDA tensors and takes ``ref.sgd_ref`` for CPU tensors; there is no
fallback from the card to the plain version.  Each route has its own
launch counter (``sgd``, ``sgd_split``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sgd import ref

KINDS = ("ridge", "logreg")

RING_MINIBATCHES = (4, 8, 16)         # instantiated in the CUDA source
CLUSTER_SIZES = (1, 2, 4, 8)          # blocks a job, 8 the portable most
RING_CLUSTER_MIN = 1                  # the fastest at the MNIST shape
RING_THREADS_MAX = 256                # consumer threads a ring block
RING_STAGES = 3                       # minibatch tiles in the ring
H100_SHARED_BYTES = 232_448           # opt-in shared memory of one block

SPLIT_ROWS = 16                       # rows a sub-tile (a row chunk)
SPLIT_SUB = 512                       # features a sub-tile
SPLIT_ROW_FLOATS = SPLIT_SUB + 8      # its 16-byte-aligned row cover
SPLIT_WARPS = 8                       # consumer warps a block
SPLIT_CLUSTER_MAX = 16                # non-portable cluster size
SPLIT_GRID_BLOCKS = 128               # a grid-wide launch (of 132 SMs)
SPLIT_STAGES = (2, 16)                # sub-tile slots in a block's ring
SPLIT_STAGES_BESIDE_MODEL = 4         # the fewest beside an on-chip model
SPLIT_PREFETCH_BYTES = 16 << 20       # minibatches L2 is asked to fetch


@dataclasses.dataclass(frozen=True)
class RingPlan:
    cluster: int            # blocks a job
    threads: int            # consumer threads a block, four features each


def ring_shared_bytes(n: int, minibatch: int, plan: RingPlan) -> int:
    """Shared memory one ring block takes: its mbarriers (128 bytes), the
    tiles (its slice of each row), the labels, the double-buffered warp
    sums of the whole cluster and each warp's d."""
    warps = plan.threads // 32
    per_block = -(-(n // 4) // plan.cluster)
    return (128 + 16 * RING_STAGES * minibatch * per_block
            + 4 * minibatch * (RING_STAGES + 2 * plan.cluster * warps
                               + warps))


def ring_plan(n: int, minibatch: int, *,
              cluster: Optional[int] = None) -> Optional[RingPlan]:
    """The ring route's cluster size and block width for n features and
    this minibatch, or None where the ring does not take them: n % 4 != 0
    (its bulk copies read whole 16-byte groups), a minibatch it is not
    built for, or more than 8 x 256 consumer threads' features.  The
    smallest cluster size from ``RING_CLUSTER_MIN`` whose blocks hold
    their slice wins; ``cluster`` fixes the size instead (to time the
    others).  A function of (n, minibatch) only, so every launch over the
    same features trains in the same order."""
    if minibatch not in RING_MINIBATCHES or n <= 0 or n % 4:
        return None
    sizes = (cluster,) if cluster is not None else \
        tuple(c for c in CLUSTER_SIZES if c >= RING_CLUSTER_MIN)
    for c in sizes:
        per_block = -(-(n // 4) // c)
        plan = RingPlan(c, -(-per_block // 32) * 32)   # whole warps
        if plan.threads <= RING_THREADS_MAX \
                and ring_shared_bytes(n, minibatch, plan) <= H100_SHARED_BYTES:
            return plan
    return None


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    blocks: int             # blocks a group of jobs' features are split over
    grid: bool              # a cooperative launch exchanging through
                            # device memory; else one cluster (<= 16)
    width: int              # features a block (a multiple of 4)
    stages: int             # sub-tile slots in a block's ring
    resident: bool          # a step's tile stays in the ring
    model_on_chip: bool     # the model slices live in shared memory
    jobs: int               # jobs a group at most (1, 2 or 4)
    prefetch: bool          # L2 fetches each minibatch a step ahead


def split_shared_bytes(minibatch: int, plan: SplitPlan) -> int:
    """Shared memory one split block takes (``split_layout`` in
    ``csrc/sgd.cu``): 2 x 16 mbarriers, the sub-tile slots, the model
    slices where they live on chip, each warp's sums, a cluster's
    double-buffered block sums (none for a grid-wide exchange), d with the
    exchange's partial runs, and the labels, for every (job, row) of a
    minibatch."""
    chunks = -(-minibatch // SPLIT_ROWS)
    rows = min(minibatch, SPLIT_ROWS)
    vals = chunks * SPLIT_ROWS * plan.jobs
    return (256 + 4 * plan.stages * rows * SPLIT_ROW_FLOATS
            + (4 * plan.jobs * plan.width if plan.model_on_chip else 0)
            + 4 * vals * (2 * SPLIT_WARPS
                          + (0 if plan.grid else 2 * plan.blocks))
            + 8 * chunks * SPLIT_ROWS)


def split_fit(n: int, minibatch: int, blocks: int,
              grid: bool) -> Optional[SplitPlan]:
    """The plan of at most ``blocks`` blocks for n features (as many as
    slices of a multiple of 4 features need) exchanging through one
    cluster or, with ``grid``, a grid-wide launch, or None where the
    fixed buffers leave no room for two sub-tile slots.  ``split_plan``
    picks among these; the tests take the others to drive each exchange
    at a width whose own plan takes the other."""
    chunks = -(-minibatch // SPLIT_ROWS)
    jobs = 4 if chunks <= 2 else 2 if chunks <= 4 else 1
    slot = 4 * min(minibatch, SPLIT_ROWS) * SPLIT_ROW_FLOATS
    width = -(-(-(-n // blocks)) // 4) * 4     # ceil(n / blocks), to 4s
    blocks = -(-n // width)
    for on_chip, fewest in ((True, SPLIT_STAGES_BESIDE_MODEL),
                            (False, SPLIT_STAGES[0])):
        fixed = split_shared_bytes(minibatch, SplitPlan(
            blocks, grid, width, 0, False, on_chip, jobs, False))
        stages = min(SPLIT_STAGES[1], (H100_SHARED_BYTES - fixed) // slot)
        if stages >= fewest:
            sub_tiles = chunks * -(-width // SPLIT_SUB)
            return SplitPlan(blocks, grid, width, stages, sub_tiles < stages,
                             on_chip, jobs,
                             4 * minibatch * n <= SPLIT_PREFETCH_BYTES)
    return None


def split_plan(n: int, minibatch: int) -> Optional[SplitPlan]:
    """The split route's plan for n features and this minibatch, or None
    where no plan fits a block's shared memory (a minibatch of thousands
    of rows).  The smallest cluster whose blocks keep a whole step's tile
    in their ring wins; where none does, a grid-wide launch of
    ``SPLIT_GRID_BLOCKS`` blocks (whose blocks' fixed buffers are never
    larger than a cluster's, so it fits wherever a cluster does).  The
    model slices stay in shared memory where four sub-tile slots still
    fit beside them.  A function of (n, minibatch) only, so every launch
    over the same features trains in the same order."""
    if n <= 0 or minibatch <= 0:
        return None
    for blocks in range(1, SPLIT_CLUSTER_MAX + 1):
        plan = split_fit(n, minibatch, blocks, False)
        if plan is not None and plan.resident:
            return plan
    return split_fit(n, minibatch, SPLIT_GRID_BLOCKS, True)


def route(n: int, minibatch: int) -> str:
    """The kernel that trains n features in minibatches of ``minibatch``:
    ``"ring"`` or ``"split"``."""
    return "ring" if ring_plan(n, minibatch) is not None else "split"


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


def _check_card(a, b, xs0, lrs, l2s, minibatch, epochs) -> None:
    for t, name in ((a, "a"), (b, "b"), (xs0, "xs0"), (lrs, "lrs"),
                    (l2s, "l2s")):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if a.device.type != "cuda":
        raise ValueError(f"the SGD kernels run on the card, got {a.device}")
    n, k = a.shape[1], xs0.shape[0]
    if n >= 2 ** 31 or minibatch >= 2 ** 31 or epochs >= 2 ** 31 \
            or k >= 2 ** 31:
        raise ValueError("n, minibatch, epochs and K must fit int32")


def sgd(a: torch.Tensor, b: torch.Tensor, xs0: torch.Tensor,
        lrs: torch.Tensor, l2s: torch.Tensor, *, minibatch: int = 16,
        epochs: int = 1, kind: str = "ridge") -> torch.Tensor:
    """Train K GLMs on one dataset: a (m, n) f32, b (m,), xs0 (K, n),
    lrs (K,), l2s (K,) -> xs (K, n), through a CUDA kernel (plain version
    on CPU): the ring route or the split route, as ``route`` says."""
    _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind)
    if a.device.type == "cpu":
        return ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=minibatch,
                           epochs=epochs, kind=kind)
    _check_card(a, b, xs0, lrs, l2s, minibatch, epochs)
    n = a.shape[1]
    plan = ring_plan(n, minibatch)
    if plan is not None:
        return sgd_ring(a, b, xs0, lrs, l2s, minibatch=minibatch,
                        epochs=epochs, kind=kind, plan=plan)
    split = split_plan(n, minibatch)
    if split is None and n > 0:
        raise ValueError(f"a minibatch of {minibatch} rows does not fit the "
                         "split route's shared memory")
    return sgd_split(a, b, xs0, lrs, l2s, minibatch=minibatch, epochs=epochs,
                     kind=kind, plan=split)


def sgd_split(a: torch.Tensor, b: torch.Tensor, xs0: torch.Tensor,
              lrs: torch.Tensor, l2s: torch.Tensor, *, minibatch: int,
              epochs: int, kind: str,
              plan: Optional[SplitPlan]) -> torch.Tensor:
    """The split route with a given plan (``sgd`` passes
    ``split_plan(n, minibatch)``; another plan trains the same rows in
    another summation order, which is how the tests drive each exchange
    at widths whose own plan takes the other).  CUDA tensors only."""
    _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind)
    _check_card(a, b, xs0, lrs, l2s, minibatch, epochs)
    m, n = a.shape
    k = xs0.shape[0]
    xs = torch.empty_like(xs0)
    if k == 0 or n == 0:
        return xs
    most = SPLIT_GRID_BLOCKS if plan.grid else SPLIT_CLUSTER_MAX
    if not 1 <= plan.blocks <= most or plan.width % 4 \
            or plan.blocks * plan.width < n or plan.jobs not in (1, 2, 4) \
            or not SPLIT_STAGES[0] <= plan.stages <= SPLIT_STAGES[1] \
            or split_shared_bytes(minibatch, plan) > H100_SHARED_BYTES:
        raise ValueError(f"{plan} does not train {n} features in "
                         f"minibatches of {minibatch}")
    groups = -(-k // plan.jobs)
    if (1 if plan.grid else groups) * plan.blocks >= 2 ** 31:
        raise ValueError(f"{k} jobs need more blocks than int32 counts")
    # the bulk copies read from 16-byte marks (a slice at a minibatch
    # boundary of an aligned dataset keeps them)
    if a.data_ptr() % 16:
        a = a.clone()
    part = arrivals = None
    if plan.grid:
        # the exchange's block sums, double-buffered, and the barrier's
        # counter
        part = torch.empty(2 * plan.blocks * -(-minibatch // SPLIT_ROWS)
                           * SPLIT_ROWS * plan.jobs, dtype=torch.float32,
                           device=a.device)
        arrivals = torch.zeros(1, dtype=torch.int32, device=a.device)
    fn = _build.function("sgd_split_f32")
    rc = fn(a.data_ptr(), b.data_ptr(), xs0.data_ptr(), lrs.data_ptr(),
            l2s.data_ptr(), m, n, minibatch, epochs, int(kind == "logreg"),
            k, plan.blocks, int(plan.grid), plan.width, plan.stages,
            int(plan.resident), int(plan.model_on_chip), plan.jobs,
            int(plan.prefetch), part.data_ptr() if plan.grid else None,
            arrivals.data_ptr() if plan.grid else None, xs.data_ptr(),
            _build.stream_handle(a.device))
    _build.check(rc, "sgd_split_f32")
    _build.LAUNCHES["sgd_split"] += 1
    return xs


def sgd_ring(a: torch.Tensor, b: torch.Tensor, xs0: torch.Tensor,
             lrs: torch.Tensor, l2s: torch.Tensor, *, minibatch: int,
             epochs: int, kind: str, plan: RingPlan) -> torch.Tensor:
    """The ring route with a given plan (``sgd`` passes
    ``ring_plan(n, minibatch)``; another plan trains the same rows in
    another summation order, which is how its cluster sizes are timed
    against each other).  CUDA tensors only."""
    _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind)
    _check_card(a, b, xs0, lrs, l2s, minibatch, epochs)
    m, n = a.shape
    k = xs0.shape[0]
    if minibatch not in RING_MINIBATCHES or plan.cluster not in CLUSTER_SIZES \
            or not 0 < plan.threads <= RING_THREADS_MAX \
            or plan.threads % 32 or 4 * plan.cluster * plan.threads < n \
            or n % 4:
        raise ValueError(f"{plan} does not train {n} features in "
                         f"minibatches of {minibatch}")
    xs = torch.empty_like(xs0)
    if k == 0:
        return xs
    # the bulk copies read from 16-byte marks (a slice at a minibatch
    # boundary of an aligned dataset keeps them)
    a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    fn = _build.function("sgd_ring_f32")
    rc = fn(a.data_ptr(), b.data_ptr(), xs0.data_ptr(), lrs.data_ptr(),
            l2s.data_ptr(), m, n, minibatch, epochs, int(kind == "logreg"),
            k, plan.cluster, plan.threads, xs.data_ptr(),
            _build.stream_handle(a.device))
    _build.check(rc, "sgd_ring_f32")
    _build.LAUNCHES["sgd"] += 1
    return xs
