"""Carrying state across from the reference: the port's Catalog is built
from the same numpy columns that build the reference's tables, so both
systems hold identical data."""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.columnar.table import Table
from repro_torch.device import DeviceLike, resolve
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

