"""Carrying state across from the reference: the port's Catalog is built
from the same numpy columns that build the reference's tables, so both
systems hold identical data, and a reference cost model's calibration
snapshot becomes the port's overlay, so both price with the same
constants."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

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
