"""GPipe-style pipeline parallelism over a mesh axis.

The counterpart of ``repro.distributed.pipeline``.  Rank ``i`` of the
axis is stage ``i`` and holds that stage's params; microbatches move
round a ring, one ``batch_isend_irecv`` a tick.  The schedule is the
classic fill-drain: with M microbatches and P stages it takes M + P - 1
ticks, stage 0 injects microbatch t at tick t, a stage works at ticks
stage .. stage + M - 1 and passes its ring buffer on at the others, and
the last stage keeps each finished microbatch.  The bubble fraction is
(P - 1) / (M + P - 1) (``bubble_fraction``).  The output is then
broadcast from the last stage to every rank of the axis, so every rank
returns the stages applied in turn.  (The reference's closing
``ppermute`` from the last stage to all is refused by JAX at two or more
stages; the port computes what its docstring states.)
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _ring_shift(y: torch.Tensor, group, stage: int, n_stages: int
                ) -> torch.Tensor:
    """y sent to the next stage, the previous stage's y received; the
    identity on a ring of one (a send to oneself is refused)."""
    if n_stages == 1:
        return y
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    buf = torch.empty_like(y)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y.contiguous(), nxt, group),
        dist.P2POp(dist.irecv, buf, prv, group)])
    for r in reqs:
        r.wait()
    return buf


def pipeline_apply(mesh: DeviceMesh, axis: str, stage_fn: Callable,
                   stage_params: Any, x: torch.Tensor, n_micro: int
                   ) -> torch.Tensor:
    """x (B, ...), the same on every rank, through n_stages =
    ``mesh[axis].size()`` stages.  ``stage_fn(stage_params, microbatch)``
    -> a microbatch of the same shape; ``stage_params`` are this rank's
    stage's.  Returns the pipeline output (B, ...) on every rank."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not a multiple of {n_micro} "
                         "microbatches")
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    last = n_stages - 1
    for t in range(n_micro + n_stages - 1):
        y = buf
        if stage <= t < n_micro + stage:          # this stage is active
            y = stage_fn(stage_params,
                         micro[min(t, n_micro - 1)] if stage == 0 else buf)
            if stage == last:
                out[t - last] = y
        buf = _ring_shift(y, group, stage, n_stages)
    dist.broadcast(out, group_src=last, group=group)
    return out.reshape(x.shape)
