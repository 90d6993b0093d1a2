"""Checkpoints of a training run, the counterpart of
``repro.train.checkpoint``, in its layout:

  * ``<dir>/step_XXXXXXXX/`` holds ``manifest.json`` (step, time, extra,
    and per leaf its key, path, shape and logical dtype) and
    ``shards.npz`` (one array a leaf; bf16 is stored as f32, exactly);
  * a write goes to ``.tmp_step_XXXXXXXX`` and is published by one
    rename, so a crash mid-write never leaves a broken latest step;
  * the last ``keep`` checkpoints are kept;
  * a tree of DTensors (a run over several ranks) is gathered whole and
    written by rank 0 (``save``).

The tree is nested dicts, lists and tuples of tensors (a model's
``state_dict`` beside the optimizer state); a leaf's path is the
reference's ``keystr`` form (``['params']['embed']``), and ``restore``
puts every leaf back into the structure of ``like`` with its type, on
its device, or, given ``shardings``, as a DTensor over a mesh of the
current process group (the reference's elastic re-sharding): each rank
reads the file and places only its own block of each leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import local_block, of_block


def _is_sharding(x) -> bool:
    """A ``(device_mesh, placements)`` leaf of a shardings tree."""
    return isinstance(x, tuple) and len(x) == 2 \
        and isinstance(x[0], DeviceMesh)


def flatten(tree, prefix: str = "", is_leaf=None) -> list:
    """[(path, tensor)] in the tree's order, each path in the reference's
    ``keystr`` form; ``is_leaf`` stops the walk at a container."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [leaf for key, v in items
            for leaf in flatten(v, prefix + key, is_leaf)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _dir(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}"


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` and keep the
    last ``keep`` steps.  A tree with DTensor leaves is saved by every
    rank of the default process group together: each such leaf is
    gathered whole (a collective), rank 0 alone writes, publishes and
    prunes, and a barrier holds every rank until the step is published.
    The layout on disk is the same either way."""
    ckpt_dir = Path(ckpt_dir)
    final = _dir(ckpt_dir, step)
    leaves = flatten(tree)
    group = any(isinstance(leaf, DTensor) for _, leaf in leaves)
    if group and dist.get_rank() != 0:
        for _, leaf in leaves:                 # rank 0's gathers
            if isinstance(leaf, DTensor):
                leaf.full_tensor()
        dist.barrier()
        return final
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": []}
    arrays = {}
    for i, (name, leaf) in enumerate(leaves):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        logical_dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:          # npz-safe storage as f32
            t = t.float()
        key = f"leaf_{i:05d}"
        arrays[key] = t.numpy()
        manifest["leaves"].append(
            {"key": key, "path": name, "shape": list(t.shape),
             "dtype": logical_dtype})
    np.savez(tmp / "shards.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish

    # retention
    ckpts = sorted(d for d in ckpt_dir.iterdir()
                   if d.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    if group:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_")]
    return max(steps) if steps else None


def _sharded(arr: np.ndarray, dtype: torch.dtype, sharding):
    """This rank's block of ``arr`` as a DTensor laid out by ``sharding``
    = (device_mesh, placements); no bytes cross the group."""
    mesh, placements = sharding
    block = arr[local_block(arr.shape, mesh, placements)]
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    local = torch.from_numpy(np.ascontiguousarray(block)).to(device=dev,
                                                             dtype=dtype)
    return of_block(local, mesh, placements, arr.shape)


def restore(ckpt_dir: str | Path, like: Any, *, step: Optional[int] = None,
            shardings: Any = None):
    """(the checkpoint's tree in the structure of ``like``, its
    manifest): every leaf found by ``like``'s path, of ``like``'s shape,
    type and device; the latest step when ``step`` is None.
    ``shardings``, a tree matching ``like`` whose leaves are
    ``(device_mesh, placements)``, makes each leaf a DTensor of ``like``'s
    type whose local tensor is this rank's block, on the mesh's device."""
    flat_shardings = None
    if shardings is not None:
        flat_shardings = dict(flatten(shardings, is_leaf=_is_sharding))
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    with np.load(d / "shards.npz") as data:
        for name, leaf in flatten(like):
            m = by_path.get(name)
            if m is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[m["key"]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                                 f"want {tuple(leaf.shape)}")
            if flat_shardings is not None:
                out.append(_sharded(arr, leaf.dtype, flat_shardings[name]))
                continue
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
    return _unflatten(like, iter(out)), manifest


def manifest_of(ckpt_dir: str | Path, step: int) -> dict:
    return json.loads((_dir(ckpt_dir, step) / "manifest.json").read_text())
