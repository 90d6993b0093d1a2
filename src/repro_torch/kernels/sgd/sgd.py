"""Minibatch SGD for GLMs (paper §VI, Fig. 9) — wrapper and plain version.

The CUDA kernels (``kernels/csrc/sgd.cu``) replace the TPU's
``sgd_pallas`` in two routes, which ``route`` picks from (n, minibatch)
alone before the launch:

* ``"ring"`` (``ring_plan`` takes n): a cluster of C blocks per job
  (C = 1 up to 1,024 features), the features split between them and four
  a thread, a producer warp a block keeping a ring of the next three
  minibatches' tiles in shared memory full with bulk copies
  (cp.async.bulk) before a step needs them; one barrier a step.  The bulk copies read 16-byte-aligned rows, so the ring takes
  n % 4 == 0, and the wrapper copies a dataset or label column that
  starts off a 16-byte mark into fresh memory first;
* ``"direct"``, every other (n, minibatch) whose n + minibatch floats fit
  one block: one block per hyper-parameter job (the Fig. 10a
  parallelism), the model in shared memory, each step reading its
  minibatch from device memory.

Every reduction runs in an order fixed by (n, minibatch), so a job's
weights do not depend on how the rows are cut into launches (at minibatch
boundaries) or on which jobs share a launch.  ``sgd`` launches a kernel
for CUDA tensors and takes ``ref.sgd_ref`` for CPU tensors; there is no
fallback from the card to the plain version.  Each route has its own
launch counter (``sgd``, ``sgd_direct``).
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


def route(n: int, minibatch: int) -> str:
    """The kernel that trains n features in minibatches of ``minibatch``:
    ``"ring"`` or ``"direct"``."""
    return "ring" if ring_plan(n, minibatch) is not None else "direct"


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
    on CPU).  Raises ``ValueError`` on the direct route when ``n`` floats
    do not fit the shared memory one block may use."""
    _check_shapes(a, b, xs0, lrs, l2s, minibatch, epochs, kind)
    if a.device.type == "cpu":
        return ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=minibatch,
                           epochs=epochs, kind=kind)
    _check_card(a, b, xs0, lrs, l2s, minibatch, epochs)
    m, n = a.shape
    plan = ring_plan(n, minibatch)
    if plan is not None:
        return sgd_ring(a, b, xs0, lrs, l2s, minibatch=minibatch,
                        epochs=epochs, kind=kind, plan=plan)
    smem = 4 * (n + minibatch)
    limit = max_shared_bytes(a.device)
    if smem > limit:
        raise ValueError(
            f"{n} features and a minibatch of {minibatch} need {smem} bytes "
            f"of shared memory; a block may use at most {limit} bytes")
    xs = torch.empty_like(xs0)
    k = xs0.shape[0]
    if k == 0:
        return xs
    fn = _build.function("sgd_direct_f32")
    rc = fn(a.data_ptr(), b.data_ptr(), xs0.data_ptr(), lrs.data_ptr(),
            l2s.data_ptr(), m, n, minibatch, epochs,
            int(kind == "logreg"), k, xs.data_ptr(),
            _build.stream_handle(a.device))
    _build.check(rc, "sgd_direct_f32")
    _build.LAUNCHES["sgd_direct"] += 1
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
