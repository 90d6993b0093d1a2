"""Meshes: the ranks of a ``torch.distributed`` process group as a
``DeviceMesh``, and the production meshes as abstract shapes.

The counterpart of ``repro.launch.mesh``.  Axes:
  * ``pod``   — inter-pod data parallelism
  * ``data``  — intra-pod data / FSDP parallelism
  * ``model`` — tensor / expert parallelism

``make_host_mesh`` lays the current process group out as ``(1, world)``
over ``("data", "model")``, on the card unless the caller names the CPU.
A group that exists (one a launcher or the caller started) is joined;
with none, ``start_group`` starts one: from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) where ``WORLD_SIZE`` is set, NCCL on card
``LOCAL_RANK`` or gloo on the CPU; else a one-rank group (NCCL on the
card, gloo on the CPU) through a ``file://`` store in a temporary
directory.  ``process_group`` holds a group for a launcher's body and
destroys it afterwards only where it started it.
``make_production_mesh`` gives the 256- and 512-chip meshes that the
sharding rules are resolved against; no process group here has that many
ranks, so these are ``AbstractMesh``es: axis names and sizes, no
devices, which is all that ``distributed.sharding.resolve``, ``spec`` and
``validate_divisibility`` read.  ``mesh_axis`` and ``data_axes`` take
either kind.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import os
import shutil
import tempfile
from typing import Iterator, Optional, Union

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


def _start_one_rank_group(device: torch.device) -> str:
    """A process group of this process alone: NCCL for the card, gloo for
    the CPU, rendezvous through a file in a new temporary directory.  NCCL
    that fails to start raises; nothing falls back to gloo on the card.
    Returns the init method."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    # the store's file is read for as long as the group lives: the
    # directory goes when the process exits
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    init = f"file://{os.path.join(tmp, 'store')}"
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device(
            "cuda", torch.cuda.current_device() if device.index is None
            else device.index)
    dist.init_process_group(backend, init_method=init, rank=0,
                            world_size=1, **kw)
    return init


def _start_from_env(device: torch.device) -> str:
    """The group torchrun describes in the environment: NCCL on card
    ``LOCAL_RANK`` (made the current device first, so that ``"cuda"``
    names it), gloo on the CPU."""
    if device.type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=card)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return "env://"


def start_group(device: DeviceLike = None) -> Optional[str]:
    """Start the default process group unless one exists: from the
    environment where ``WORLD_SIZE`` is set, else one rank through a file
    store.  Returns the init method of the group it started, None where
    it found one."""
    if dist.is_initialized():
        return None
    dev = resolve(device)
    if "WORLD_SIZE" in os.environ:
        return _start_from_env(dev)
    return _start_one_rank_group(dev)


@contextlib.contextmanager
def process_group(device: DeviceLike = None) -> Iterator[Optional[str]]:
    """The default process group for the body (``start_group``), which
    yields how it was started (None: the caller's) and, where it started
    the group, destroys it on the way out."""
    started = start_group(device)
    try:
        yield started
    finally:
        if started is not None and dist.is_initialized():
            dist.destroy_process_group()


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """``(1, world)`` over ``("data", "model")`` of the current process
    group, on the card (``device=None``) or the device type named; starts
    a group (``start_group``) when there is none."""
    dev = resolve(device)
    start_group(dev)
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def mesh_axis(mesh: Mesh, name: str) -> int:
    """Axis size, 1 if the axis does not exist on this mesh."""
    return axis_sizes(mesh).get(name, 1)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch-sharding axes present on this mesh (pod first)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
