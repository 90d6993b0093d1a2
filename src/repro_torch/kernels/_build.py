"""Builds the port's CUDA kernels from ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``).  All sources compile in
parallel, one ``nvcc`` each.  A library's file name carries a hash of its
sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused.  The libraries are bound with ``ctypes``: pointers and the CUDA
stream travel as ``c_void_p``, and every launcher returns
``cudaGetLastError()``, which ``check`` turns into an exception.

Nothing here runs at import time: the tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("selection", "join", "sgd", "bandwidth", "flash_attention", "ssd")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_F32 = ctypes.c_float
SIGNATURES = {
    # x, n, lo, hi, block, idx, counts, stream
    "select_range_i32": ("selection",
                         (_P, _I64, _I32, _I32, _I64, _P, _P, _P)),
    # s_sorted, n_s, ts, keys, n, start, count, stream
    "probe_counts_i32": ("join", (_P, _I64, _I64, _P, _I64, _P, _P, _P)),
    # s_sorted, order, n_s, ts, keys, n, cap, mat, start, count, stream
    "probe_multi_i32": ("join",
                        (_P, _P, _I64, _I64, _P, _I64, _I32, _P, _P, _P,
                         _P)),
    # ht_keys, ht_vals, ts, keys, n, probe_depth, block, s_idx, counts,
    # stream
    "hash_probe_i32": ("join",
                       (_P, _P, _I64, _P, _I64, _I32, _I64, _P, _P, _P)),
    # a, b, xs0, lrs, l2s, m, n, minibatch, epochs, logreg, k, xs, stream
    "sgd_f32": ("sgd", (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                        _I32, _P, _P)),
    # device, out (int32*)
    "sgd_max_shared_bytes": ("sgd", (_I32, ctypes.POINTER(_I32))),
    # x, o, n, grid, stream
    "stream_copy_i32": ("bandwidth", (_P, _P, _I64, _I32, _P)),
    "stream_copy_f32": ("bandwidth", (_P, _P, _I64, _I32, _P)),
    # q, k, v, o, b, s, h, kv_heads, d, causal, bf16, scale, stream
    "flash_attention_fwd": ("flash_attention",
                            (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                             _I32, _I32, _F32, _P)),
    # x, dt, a_log, b, c, d_skip, y, h_out, bsz, seq, nh, hd, ng, ds,
    # chunk, bf16, stream
    "ssd_fwd": ("ssd", (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                        _I32, _I32, _I32, _I32, _I32, _P)),
}

# Kernel launches per wrapper, bumped only where a wrapper launches its
# kernel (never on the plain CPU path).  ``chip_smoke.py`` zeroes these
# before driving the executor or the LM server and reads them after.
LAUNCHES: Dict[str, int] = {"select": 0, "probe_counts": 0,
                            "probe_multi": 0, "probe": 0, "sgd": 0,
                            "stream_copy": 0, "flash_attention": 0,
                            "ssd": 0}

_lock = threading.Lock()
_funcs: Dict[str, object] = {}
BUILD_LOG: Dict[str, str] = {}        # source -> nvcc's -Xptxas -v output


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.stem == name
                                            or f.suffix == ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes started together; returns source name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])    # atomic against concurrent builds
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def function(symbol: str):
    """The ctypes launcher ``symbol``, building its library on first use."""
    with _lock:
        fn = _funcs.get(symbol)
        if fn is None:
            paths = build_all()
            libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
            for sym, (src, argtypes) in SIGNATURES.items():
                f = getattr(libs[src], sym)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                _funcs[sym] = f
            fn = _funcs[symbol]
        return fn


def check(rc: int, symbol: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {symbol} failed: cudaError {rc}")


def require_int32_cuda(t, name: str) -> None:
    """The kernels take contiguous int32 tensors on the card."""
    import torch
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected 1-D, got shape {tuple(t.shape)}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
