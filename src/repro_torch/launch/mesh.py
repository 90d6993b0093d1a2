"""Meshes: the ranks of a ``torch.distributed`` process group as a
``DeviceMesh``, and the production meshes as abstract shapes.

The counterpart of ``repro.launch.mesh``.  Axes:
  * ``pod``   — inter-pod data parallelism
  * ``data``  — intra-pod data / FSDP parallelism
  * ``model`` — tensor / expert parallelism

``make_host_mesh`` lays the current process group out as ``(1, world)``
over ``("data", "model")``, on the card unless the caller names the CPU;
with no process group yet it starts a one-rank group (NCCL on the card,
gloo on the CPU) through a ``file://`` store in a temporary directory.
``make_production_mesh`` gives the 256- and 512-chip meshes that the
sharding rules are resolved against; no process group here has that many
ranks, so these are ``AbstractMesh``es: axis names and sizes, no
devices, which is all that ``distributed.sharding.resolve``, ``spec`` and
``validate_divisibility`` read.  ``mesh_axis`` and ``data_axes`` take
either kind.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
from typing import Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as a JAX ``Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.axis_sizes))


Mesh = Union[DeviceMesh, AbstractMesh]


def axis_names(mesh: Mesh) -> tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def axis_sizes(mesh: Mesh) -> dict[str, int]:
    """``{axis name: size}`` of either kind of mesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(axis_names(mesh), mesh.shape))
    return mesh.shape


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _start_one_rank_group(device: torch.device) -> None:
    """A process group of this process alone: NCCL for the card, gloo for
    the CPU, rendezvous through a file in a new temporary directory.  NCCL
    that fails to start raises; nothing falls back to gloo on the card."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    # the store's file is read for as long as the group lives: the
    # directory goes when the process exits
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    store = os.path.join(tmp, "store")
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device(
            "cuda", torch.cuda.current_device() if device.index is None
            else device.index)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1, **kw)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """``(1, world)`` over ``("data", "model")`` of the current process
    group, on the card (``device=None``) or the device type named; starts
    a one-rank group when there is none."""
    dev = resolve(device)
    if not dist.is_initialized():
        _start_one_rank_group(dev)
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def mesh_axis(mesh: Mesh, name: str) -> int:
    """Axis size, 1 if the axis does not exist on this mesh."""
    return axis_sizes(mesh).get(name, 1)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch-sharding axes present on this mesh (pod first)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
