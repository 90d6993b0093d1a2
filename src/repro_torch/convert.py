"""Carrying state across from the reference: the port's Catalog is built
from the same numpy columns that build the reference's tables, so both
systems hold identical data; a reference cost model's calibration
snapshot becomes the port's overlay, so both price with the same
constants; and a reference LM's params become the port model's
``state_dict``, so both compute from the same weights."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.columnar.table import Table
from repro_torch.device import DeviceLike, resolve
from repro_torch.query.cost import CHANNEL_KEYS
from repro_torch.query.exec import Catalog


def catalog_from_arrays(tables: Mapping[str, Mapping[str, np.ndarray]],
                        device: DeviceLike = None) -> Catalog:
    """``{table: {column: array}}`` -> a Catalog on ``device`` (the card
    when None).  Column order and dtypes are kept as given."""
    dev = resolve(device)
    cat = Catalog(dev)
    for name, cols in tables.items():
        cat.register(Table.from_arrays(name, cols, dev))
    return cat


# the reference's backends and the port's impl labels that play their part:
# its plain path (XLA) is the port's torch path, its kernels (Pallas) the
# port's CUDA kernels
_IMPL_OF_BACKEND = {"xla": "torch", "pallas": "cuda"}


def calibration_from_reference(snapshot: Optional[Mapping]
                               ) -> Optional[dict]:
    """A reference ``CostModel.calibration_snapshot()`` (or calibration
    file) as the port's calibration overlay: ``xla`` numbers under
    ``torch``, ``pallas`` numbers under ``cuda``, the tier channels as
    they are.  ``None`` stays ``None``."""
    if snapshot is None:
        return None
    backends = {_IMPL_OF_BACKEND[b]: dict(v)
                for b, v in snapshot.get("backends", {}).items()
                if b in _IMPL_OF_BACKEND}
    out = {"backend": snapshot.get("backend", "reference"),
           "backends": backends}
    out.update({k: snapshot[k] for k in CHANNEL_KEYS if k in snapshot})
    return out


def _param_tensor(a) -> torch.Tensor:
    """A reference leaf (numpy, float32 or ml_dtypes' bfloat16) as a torch
    tensor of the same type; bf16 travels through float32, exactly."""
    a = np.asarray(a)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        a.dtype.name)
    if dtype is None:
        raise TypeError(f"unexpected parameter type {a.dtype}")
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_params_from_arrays(cfg, tree: Mapping) -> dict:
    """The reference's LM params (``jax.tree.map(np.asarray, params)``) as
    the port's ``Transformer`` state_dict.  The reference stacks each
    superblock position's params over superblocks; layer ``i`` of the port
    is superblock ``i // P`` at position ``i % P``."""
    from repro_torch.models.transformer import _period
    p = _period(cfg)
    out = {k: _param_tensor(tree[k])
           for k in ("embed", "unembed", "final_norm") if k in tree}
    for j, position in enumerate(tree["layers"]):
        for name, stacked in _leaves(position):
            for sb in range(np.shape(stacked)[0]):
                out[f"layers.{sb * p + j}.{name}"] = _param_tensor(
                    stacked[sb])
    return out
