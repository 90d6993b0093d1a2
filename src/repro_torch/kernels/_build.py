"""Builds the port's CUDA kernels from ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``).  All sources compile in
parallel, one ``nvcc`` each.  A library's file name carries a hash of its
sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused.  The libraries are bound with ``ctypes``: pointers and the CUDA
stream travel as ``c_void_p``, and every launcher returns
``cudaGetLastError()``, which ``check`` turns into an exception.

The tensor-core flash attention encodes its TMA tensor maps with the
driver's ``cuTensorMapEncodeTiled``, which it looks up at run time through
``cudaGetDriverEntryPoint`` (``...ByVersion`` from CUDA 12.5), so no
library links ``-lcuda``.

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
SOURCES = ("selection", "join", "sgd", "bandwidth", "flash_attention",
           "flash_attention_bwd", "ssd", "ssd_bwd")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_F32 = ctypes.c_float
SIGNATURES = {
    # x, n, lo, hi, block, idx, counts, stream
    "select_range_i32": ("selection",
                         (_P, _I64, _I32, _I32, _I64, _P, _P, _P)),
    "select_range_f32": ("selection",
                         (_P, _I64, _F32, _F32, _I64, _P, _P, _P)),
    # s_sorted, n_s, ts, keys, n, start, count, tree scratch (null for
    # the shared route), stream
    "probe_counts_i32": ("join", (_P, _I64, _I64, _P, _I64, _P, _P, _P,
                                  _P)),
    # s_sorted, order, n_s, ts, keys, n, cap, mat, start, count, tree
    # scratch (null for the shared route), stream
    "probe_multi_i32": ("join",
                        (_P, _P, _I64, _I64, _P, _I64, _I32, _P, _P, _P,
                         _P, _P)),
    # ht_keys, ht_vals, ts, keys, n, probe_depth, block, s_idx, counts,
    # stream
    "hash_probe_i32": ("join",
                       (_P, _P, _I64, _P, _I64, _I32, _I64, _P, _P, _P)),
    # a, b, xs0, lrs, l2s, m, n, minibatch, epochs, logreg, k, cluster,
    # threads, xs, stream
    "sgd_ring_f32": ("sgd", (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                             _I32, _I32, _I32, _I32, _P, _P)),
    # a, b, xs0, lrs, l2s, m, n, minibatch, epochs, logreg, k, blocks,
    # grid, width, stages, resident, model_on_chip, jobs, prefetch, part,
    # arrivals, xs, stream
    "sgd_split_f32": ("sgd", (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                              _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                              _I32, _I32, _P, _P, _P, _P)),
    # device, out (int32*)
    "sgd_max_shared_bytes": ("sgd", (_I32, ctypes.POINTER(_I32))),
    # x, o, n, grid, unroll, next_tile (4-byte scratch), stream
    "stream_copy_i32": ("bandwidth", (_P, _P, _I64, _I32, _I32, _P, _P)),
    "stream_copy_f32": ("bandwidth", (_P, _P, _I64, _I32, _I32, _P, _P)),
    # q, k, v, o, lse (null: none written), b, sq, sk, h, kv_heads, d,
    # causal, q_pos, k_pos (both null for the index mask), scale, stream
    "flash_attention_tc_fwd": ("flash_attention",
                               (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                _I32, _I32, _I32, _P, _P, _F32, _P)),
    "flash_attention_f32_fwd": ("flash_attention",
                                (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _P, _P, _F32, _P)),
    # go, q, k, v, o, lse, delta (scratch), part (scratch or null), dq,
    # dk, dv, b, sq, sk, h, kv_heads, d, causal, q_pos, k_pos, scale,
    # stream
    "flash_attention_tc_bwd": ("flash_attention_bwd",
                               (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                                _P, _P, _F32, _P)),
    "flash_attention_f32_bwd": ("flash_attention",
                                (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                                 _P, _P, _F32, _P)),
    # x, dt, a_log, b, c, d_skip, y, h_out, states, decay, bsz, seq, nh,
    # hd, ng, ds, chunk, mode, passes, stream
    "ssd_fwd": ("ssd", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                        _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P)),
    # mode, hd, ds, chunk, blocks (int32[3]), smem (int32[3])
    "ssd_occupancy": ("ssd", (_I32, _I32, _I32, _I32, ctypes.POINTER(_I32),
                              ctypes.POINTER(_I32))),
    # x, dt, a_log, b, c, d_skip, gy, gh (null: zero), the scratch (states,
    # decay, dstates, db_part, dc_part, dalog_part, dd_part), dx, ddt,
    # da_log, db, dc, dd_skip, bsz, seq, nh, hd, ng, ds, chunk, cluster,
    # mode, passes, stream
    "ssd_bwd": ("ssd_bwd", (_P,) * 21 + (_I32,) * 10 + (_P,)),
    # mode, hd, ds, chunk, cluster, blocks (int32[2]), smem (int32[2]),
    # clusters (int32[1])
    "ssd_bwd_occupancy": ("ssd_bwd", (_I32, _I32, _I32, _I32, _I32,
                                      ctypes.POINTER(_I32),
                                      ctypes.POINTER(_I32),
                                      ctypes.POINTER(_I32))),
}

# Kernel launches per wrapper and route, bumped only where a wrapper
# launches its kernel (never on the plain CPU path): B1's int32
# ("select") and float32 ("select_f32") entries, B2's and B3's
# shared-memory and sampled routes, B5's ring ("sgd") and split
# ("sgd_split") routes, B7's bf16 ("flash_attention_tc") and f32
# ("flash_attention_f32") tensor-core routes, B7's backward in each type
# ("flash_attention_bwd_tc", "flash_attention_bwd_f32": one count a call
# of its three or four launches), B8's CUDA-core ("ssd") and tensor-core
# ("ssd_tc") routes and B8's backward on each ("ssd_bwd", "ssd_bwd_tc":
# one count a call of its passes) each have their own count.
# ``chip_smoke.py`` zeroes these before driving the executor or the LM
# server and reads them after.
LAUNCHES: Dict[str, int] = {"select": 0, "select_f32": 0,
                            "probe_counts": 0,
                            "probe_counts_sampled": 0,
                            "probe_multi": 0, "probe_multi_sampled": 0,
                            "probe": 0, "sgd": 0,
                            "sgd_split": 0,
                            "stream_copy": 0, "flash_attention_tc": 0,
                            "flash_attention_f32": 0,
                            "flash_attention_bwd_tc": 0,
                            "flash_attention_bwd_f32": 0, "ssd": 0,
                            "ssd_tc": 0, "ssd_bwd": 0, "ssd_bwd_tc": 0}

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


def require_int32_cuda(t, name: str, dtype=None) -> None:
    """The kernels take contiguous 1-D tensors on the card, of int32
    unless ``dtype`` names another type."""
    import torch
    dtype = torch.int32 if dtype is None else dtype
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {str(dtype)[6:]}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected 1-D, got shape {tuple(t.shape)}")


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, as the
    compiled kernels PyTorch generates itself read it: building a
    ``torch.cuda.Stream`` object (``current_stream(device)``) costs more
    host time than a short kernel takes on the card."""
    import torch
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())
