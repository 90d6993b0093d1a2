"""Warm-start persistence: semantic-cache snapshots that survive restarts.

A restarted executor pays a cold-start tax twice: the semantic cache
re-materializes every result and bitmap from scratch, and the cost model
forgets the calibration it ran under.  This module writes both (the
cache's serializable residents and the model's
``calibration_snapshot()``) into one ``.npz`` file, and replays them.

Format: one ``np.savez`` archive holding a ``manifest`` JSON string and
one flat array per buffer.  Tensors are written as numpy
(``.cpu().numpy()``) and read back as CPU tensors of the same dtype; a
tensor numpy cannot hold (bfloat16) makes its entry unserializable.  Keys
are stored as ``repr(key)`` and recovered with ``ast.literal_eval``: only
keys that round-trip exactly (tuples of str / int / bool, as every
executor key is) persist.  Values may be scalars, tensors, numpy arrays,
tuples or lists of them, or ``columnar.Table``s.

Staleness is rejected at two granularities:

* the whole file: a missing or corrupt archive, an unparsable manifest or
  another ``format`` loads as None (and ``warm_start`` restores nothing);
* each entry: an entry whose dependency table's saved version differs
  from the loading catalog's current one, or whose table is gone, is
  dropped and counted as stale, so a snapshot taken before a mutation
  never serves stale bytes.

Restored entries land in the cache's host tier (``SemanticCache.restore``)
and reach the device on first use.
"""
from __future__ import annotations

import ast
import json
import os
import tempfile
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.columnar.table import Column, Table

FORMAT_VERSION = 1


# --------------------------------------------------------------------------- #
# value (de)serialization

def _encode_value(value, arrays: dict, prefix: str):
    """One cache value as a JSON spec, its buffers appended to ``arrays``
    as numpy.  None when the value holds something not serialized
    (objects, callables, bfloat16 tensors, ...)."""
    if isinstance(value, (bool, int, float, str)) or value is None:
        return {"t": "scalar", "v": value}
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return {"t": "scalar", "v": value.item()}
    if isinstance(value, Table):
        cols = {}
        for name, col in value.columns.items():
            arr = _host_array(col.data)
            if arr is None:
                return None
            ref = f"{prefix}_c{len(arrays)}"
            arrays[ref] = arr
            cols[name] = ref
        return {"t": "table", "name": value.name,
                "version": int(value.version), "cols": cols}
    if isinstance(value, (tuple, list)):
        items = []
        for i, v in enumerate(value):
            spec = _encode_value(v, arrays, f"{prefix}_i{i}")
            if spec is None:
                return None
            items.append(spec)
        return {"t": "tuple", "items": items}
    if isinstance(value, torch.Tensor):
        arr = _host_array(value)
        if arr is None:
            return None
        ref = f"{prefix}_t"
        arrays[ref] = arr
        return {"t": "tensor", "ref": ref}
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError):
        return None
    if arr.dtype == object:
        return None
    if arr.ndim == 0:
        return {"t": "scalar", "v": arr.item()}
    ref = f"{prefix}_a"
    arrays[ref] = arr
    return {"t": "array", "ref": ref}


def _host_array(data) -> Optional[np.ndarray]:
    """A column or tensor as a numpy array, or None when numpy has no
    dtype for it."""
    if isinstance(data, torch.Tensor):
        try:
            return data.detach().cpu().numpy()
        except TypeError:
            return None
    arr = np.asarray(data)
    return None if arr.dtype == object else arr


def _decode_value(spec, npz):
    t = spec["t"]
    if t == "scalar":
        return spec["v"]
    if t == "tensor":
        return torch.from_numpy(np.array(npz[spec["ref"]]))
    if t == "array":
        return np.asarray(npz[spec["ref"]])
    if t == "tuple":
        return tuple(_decode_value(s, npz) for s in spec["items"])
    if t != "table":
        raise ValueError(f"unknown value spec {t!r}")
    cols = {name: Column(np.asarray(npz[ref]), name, "host")
            for name, ref in spec["cols"].items()}
    return Table(spec["name"], cols, None, int(spec["version"]))


def _key_repr(key) -> Optional[str]:
    """``repr`` of a cache key iff ``ast.literal_eval`` recovers it
    exactly; None for keys that do not persist."""
    r = repr(key)
    try:
        back = ast.literal_eval(r)
    except (ValueError, SyntaxError):
        return None
    return r if back == key else None


# --------------------------------------------------------------------------- #
# save / load

def save_state(path: str, cache, *, cost_model=None,
               table_versions: Optional[Mapping[str, int]] = None) -> dict:
    """Snapshot ``cache``'s serializable residents (both tiers; the load
    re-tiers them into the host) and the cost model's calibration to
    ``path``.  Atomic: written to a temporary file beside the target and
    renamed over it, so a killed process never leaves a torn snapshot.
    Returns ``{"path", "saved", "skipped"}``."""
    arrays: dict = {}
    entries = []
    skipped = 0
    with cache._lock:
        residents = list(cache._entries.values())
    for i, e in enumerate(residents):
        krepr = _key_repr(e.key)
        spec = (_encode_value(e.value, arrays, f"e{i}")
                if krepr is not None else None)
        if spec is None:
            skipped += 1
            continue
        entries.append({
            "key": krepr, "kind": e.kind, "n_bytes": int(e.n_bytes),
            "recompute_s": float(e.recompute_s),
            "tables": list(e.tables), "hits": int(e.hits),
            "interval": list(e.interval) if e.interval else None,
            "tenant": e.tenant, "value": spec})
    manifest = {
        "format": FORMAT_VERSION,
        "table_versions": {str(k): int(v) for k, v in
                           (table_versions or {}).items()},
        "calibration": (cost_model.calibration_snapshot()
                        if cost_model is not None else None),
        "entries": entries,
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, manifest=np.frombuffer(
                json.dumps(manifest).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return {"path": path, "saved": len(entries), "skipped": skipped}


def load_state(path: str,
               table_versions: Optional[Mapping[str, int]] = None
               ) -> Optional[dict]:
    """Parse a snapshot into ``{"calibration", "entries", "stale"}``
    without touching any cache.  None for a missing, corrupt or
    wrong-format file; entries whose dependency tables moved from
    ``table_versions`` (or are gone) are dropped and counted in
    ``"stale"``."""
    try:
        npz = np.load(path, allow_pickle=False)
    except (OSError, ValueError):
        return None
    if not isinstance(npz, np.lib.npyio.NpzFile):
        return None
    with npz:
        try:
            manifest = json.loads(bytes(np.asarray(npz["manifest"])).decode())
        except (KeyError, ValueError):
            return None
        if not isinstance(manifest, dict) \
                or manifest.get("format") != FORMAT_VERSION:
            return None
        saved_versions = manifest.get("table_versions", {})
        current = {str(k): int(v) for k, v in (table_versions or {}).items()}
        out, stale = [], 0
        for ent in manifest.get("entries", ()):
            try:
                key = ast.literal_eval(ent["key"])
                deps = tuple(ent["tables"])
                if table_versions is not None and any(
                        t not in current
                        or current[t] != saved_versions.get(t)
                        for t in deps):
                    stale += 1
                    continue
                value = _decode_value(ent["value"], npz)
            except (ValueError, SyntaxError, KeyError):
                stale += 1
                continue
            interval = tuple(ent["interval"]) if ent.get("interval") \
                else None
            out.append({"key": key, "value": value, "kind": ent["kind"],
                        "n_bytes": int(ent["n_bytes"]),
                        "recompute_s": float(ent["recompute_s"]),
                        "tables": deps, "hits": int(ent.get("hits", 0)),
                        "interval": interval, "tenant": ent.get("tenant")})
    return {"calibration": manifest.get("calibration"),
            "entries": out, "stale": stale}


def warm_start(path: str, cache, *, cost_model=None,
               table_versions: Optional[Mapping[str, int]] = None) -> dict:
    """Load a snapshot and replay it: entries into ``cache.restore`` (the
    host tier first), the calibration onto ``cost_model``.  A missing,
    corrupt or stale file restores nothing and raises nothing."""
    state = load_state(path, table_versions)
    if state is None:
        return {"restored": 0, "stale": 0, "calibrated": False,
                "loaded": False}
    restored = 0
    for ent in state["entries"]:
        if cache.restore(ent["key"], ent["value"], kind=ent["kind"],
                         n_bytes=ent["n_bytes"],
                         recompute_s=ent["recompute_s"],
                         tables=ent["tables"], interval=ent["interval"],
                         tenant=ent["tenant"], hits=ent["hits"]):
            restored += 1
    calibrated = False
    cal = state["calibration"]
    if cost_model is not None and isinstance(cal, dict):
        cost_model.apply_calibration(cal)
        calibrated = True
    return {"restored": restored, "stale": state["stale"],
            "calibrated": calibrated, "loaded": True}
