"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass or the script exits non-zero:

1. card: the name and power limit, as nvidia-smi reports them;
2. build: the CUDA kernels, compiled from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the queries below give it (the bucket probe also at the
   TPC-H join's negative-padded pass blocks) and at a ragged length with
   keys at both ends of int32; integer outputs must be bit-identical.  Each is timed with CUDA events beside
   its bound (bytes read once and written once over the card's data-sheet
   memory rate) and, where one PyTorch call computes the same function,
   that call's time;
4. ssb: an SSB Q1.1-shaped query at scale factor 10 (lineorder, 59,986,214
   rows, against the 2,556-row date dimension) through the executor in
   batch, stream and eager modes; each must equal a numpy int64 oracle,
   and each mode must have launched the kernels of its path;
5. tpch: a duplicate-keyed join at TPC-H scale factor 1 (orders against a
   filtered lineitem, which the optimizer makes the build side) in eager
   and batch modes, against a numpy oracle;
6. glm: hyper-parameter search (8 logistic-regression jobs, 5 epochs,
   minibatch 16) over an MNIST-shaped training set (60,000 rows, 784
   float32 features in [0, 1], a binary label from a planted logistic
   model) through the executor in batch, stream and eager modes: the
   modes' weights must be bit-identical, every model's loss below ln 2,
   and the SGD kernel's weights must equal its plain version's within
   rtol=1e-4, atol=1e-5; then ``score_glm`` against numpy;
7. multi_join: ``hash_join_multi`` at TPC-H scale factor 1, built on
   lineitem's order keys and probed with orders' (chains of 1-7), and
   built on lineitem's quantity and probed with its 50 values (chains of
   ~120,000, nearly all from the overflow pass); pair lists must equal a
   numpy sort-based oracle bit for bit;
8. calibrate: the traffic-generator kernel (``o = x + 1``) against its
   plain version, bit for bit, at 1 GiB of int32, at a ragged length, on
   a misaligned slice, at 2**31 - 1 and in float32, timed beside
   ``torch.add(x, 1)``; then ``calibrate()`` into a temporary file, loaded
   back and applied to an executor over SSB SF 10 with ``recost`` (the
   epoch must move, and a second ``recost`` with the same file must
   change no price); then the Fig. 2 analogue (``stream_copy_distributed``
   over 1, 4 and 16 engines, partitioned and congested, in GB/s);
9. spill: SSB Q1.1 at SF 10 under a 256 MiB device budget (one lineorder
   column stays on the card, three go to host DRAM) in batch and stream
   mode, and with a 512 MiB host budget as well (one column goes to
   disk), each equal to the numpy oracle and the unspilled run; the
   promoted bytes over the measured time beside the calibrated
   ``h2d_gbps``.  The GLM search of phase 6 also trains under a 64 MiB
   device budget, and its weights must equal the resident run's bit for
   bit.

The data is made from ``--seed`` with numpy, with the column domains of
the SSB and TPC-H specifications and MNIST's shape.  The second-to-last line is the kernels'
JSON summary; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet (HBM3)
FP32_FLOPS_PER_S = 67e12         # H100 SXM data sheet, outside tensor cores

SSB_LINEORDER_ROWS = 59_986_214  # SSB scale factor 10
SSB_DATE_ROWS = 2_556            # 1992-01-01 .. 1998-12-30
TPCH_LINEITEM_ROWS = 6_001_215   # TPC-H scale factor 1
TPCH_ORDERS_ROWS = 1_500_000
MNIST_ROWS, MNIST_FEATURES = 60_000, 784   # MNIST's training set
GLM_JOBS, GLM_EPOCHS, GLM_MINIBATCH = 8, 5, 16
STREAM_ROWS = 1 << 28            # 1 GiB of int32: far past the 50 MB L2
MIB = 1 << 20
# the SGD kernel sums in another order than its plain version and nvcc
# contracts multiply-adds into FMAs: weights agree within this, not bitwise
SGD_TOL = dict(rtol=1e-4, atol=1e-5)


def log(*args):
    print(*args, flush=True)


# --------------------------------------------------------------------------- #
# data, from the specifications' column domains

def _retailprice(partkey):
    """TPC-H / SSB P_RETAILPRICE in cents, from the part key."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def make_ssb(rows: int, seed: int):
    """lineorder (orderdate, quantity, discount, extendedprice) and the date
    dimension.  Order dates are uniform over the first 2,556 - 151 days
    (TPC-H's O_ORDERDATE rule, which SSB keeps); the date table's key is
    named ``orderdate`` as well, because the join DSL joins on one name."""
    r = np.random.default_rng(seed)
    start = datetime.date(1992, 1, 1)
    days = [start + datetime.timedelta(d) for d in range(SSB_DATE_ROWS)]
    datekey = np.asarray([d.year * 10000 + d.month * 100 + d.day
                          for d in days], np.int32)
    order_day = r.integers(0, SSB_DATE_ROWS - 151, rows)
    quantity = r.integers(1, 51, rows, dtype=np.int32)
    discount = r.integers(0, 11, rows, dtype=np.int32)
    partkey = r.integers(1, 800_001, rows)              # 200,000 * (1 + log2 10)
    extendedprice = (quantity * _retailprice(partkey)).astype(np.int32)
    lineorder = {"orderdate": datekey[order_day], "quantity": quantity,
                 "discount": discount, "extendedprice": extendedprice}
    return {"lineorder": lineorder, "date": {"orderdate": datekey}}


def ssb_query(Q):
    return (Q.scan("lineorder").filter("orderdate", 19930101, 19931231)
            .filter("discount", 1, 3).filter("quantity", 1, 24)
            .join(Q.scan("date"), on="orderdate").sum("extendedprice"))


def ssb_oracle(tables) -> int:
    lo = tables["lineorder"]
    m = ((lo["orderdate"] >= 19930101) & (lo["orderdate"] <= 19931231)
         & (lo["discount"] >= 1) & (lo["discount"] <= 3)
         & (lo["quantity"] >= 1) & (lo["quantity"] <= 24)
         & np.isin(lo["orderdate"], tables["date"]["orderdate"]))
    return int(lo["extendedprice"][m].astype(np.int64).sum())


def make_tpch(lineitem_rows: int, orders_rows: int, seed: int):
    """orders (orderkey, totalprice) and lineitem (orderkey, quantity).
    Order keys are sparse as in the specification (the first 8 of every 32
    keys); each order has 1 to 7 lines, cut or topped up to the exact row
    count."""
    r = np.random.default_rng(seed + 1)
    i = np.arange(orders_rows)
    orderkey = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    totalprice = r.integers(85_771, 55_528_517, orders_rows, dtype=np.int32)
    per_order = r.integers(1, 8, orders_rows)
    order_idx = np.repeat(i, per_order)
    if order_idx.size >= lineitem_rows:
        order_idx = order_idx[:lineitem_rows]
    else:
        extra = r.integers(0, orders_rows, lineitem_rows - order_idx.size)
        order_idx = np.concatenate([order_idx, np.sort(extra)])
    quantity = r.integers(1, 51, lineitem_rows, dtype=np.int32)
    tables = {"orders": {"orderkey": orderkey, "totalprice": totalprice},
              "lineitem": {"orderkey": orderkey[order_idx],
                           "quantity": quantity}}
    return tables, order_idx


def tpch_query(Q):
    return (Q.scan("orders").join(Q.scan("lineitem").filter("quantity", 1, 1),
                                  on="orderkey").sum("totalprice"))


def tpch_oracle(tables, order_idx) -> int:
    keep = tables["lineitem"]["quantity"] == 1
    lines = np.bincount(order_idx[keep], minlength=order_idx.max() + 1)
    price = tables["orders"]["totalprice"].astype(np.int64)
    return int((lines[:price.size] * price).sum())


def make_mnist_like(rows: int, features: int, seed: int):
    """An MNIST-shaped training set: ``features`` float32 pixel columns in
    [0, 1], about 19% of them inked as in MNIST, and a binary label drawn
    from a planted logistic model over the pixels."""
    r = np.random.default_rng(seed + 2)
    ink = r.random((rows, features), dtype=np.float32) < 0.19
    a = np.where(ink, r.random((rows, features), dtype=np.float32),
                 np.float32(0))
    z = a @ r.normal(size=features)
    z *= 3.0 / z.std()
    label = (r.random(rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    cols = {f"px{j}": a[:, j] for j in range(features)}
    cols["label"] = label
    return {"mnist": cols}, a, label


def glm_query(Q, HyperParams):
    grid = [HyperParams(0.1 / (i + 1), 0.001 * i) for i in range(GLM_JOBS)]
    return Q.scan("mnist").train_glm(
        [f"px{j}" for j in range(MNIST_FEATURES)], "label", grid,
        kind="logreg", epochs=GLM_EPOCHS)


def multi_join_oracle(s: np.ndarray, l: np.ndarray):
    """The (l_idx, s_idx) pair list of ``s ⋈ l`` in (probe row, bucket
    position) order, from a stable sort of the build side: numpy's own
    sort and searches, independent of the port."""
    order = np.argsort(s, kind="stable")
    ss = s[order]
    lo = np.searchsorted(ss, l, side="left")
    cnt = np.searchsorted(ss, l, side="right") - lo
    total = int(cnt.sum())
    l_idx = np.repeat(np.arange(l.size), cnt)
    within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    s_idx = order[np.repeat(lo, cnt) + within]
    return l_idx.astype(np.int32), s_idx.astype(np.int32), total


# --------------------------------------------------------------------------- #
# timing

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> float:
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
    return float(err)


# --------------------------------------------------------------------------- #
# phases

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.function(next(s for s, (src, _) in _build.SIGNATURES.items()
                             if src == name))
    log(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(p.name for p in paths.values())})")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev, ssb_tables, tpch_tables):
    """Every kernel against its plain version at the main path's shapes
    (and a small ragged length), timed.  Returns the JSON rows."""
    import torch
    from repro_torch.core import join as join_core
    from repro_torch.kernels.join import join as jk
    from repro_torch.kernels.join import ref as join_ref
    from repro_torch.kernels.selection import selection as sk

    lo = ssb_tables["lineorder"]
    orderdate = torch.from_numpy(lo["orderdate"]).to(dev)
    datekeys = torch.from_numpy(ssb_tables["date"]["orderdate"]).to(dev)
    rows = []

    def check(name, kernel, plain):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        return err

    # B1 at the eager filter's shape: the whole orderdate column, block
    # 1024 (what engine.select_range passes); 59,986,214 is ragged
    n = orderdate.shape[0]
    r = np.random.default_rng(5)
    small = torch.from_numpy(r.integers(0, 100, 1_000_003,
                                        dtype=np.int32)).to(dev)
    check("select_range", lambda: sk.select(small, 10, 60, block=1024),
          lambda: sk.select_plain(small, 10, 60, block=1024))
    b1 = dict(kernel=lambda: sk.select(orderdate, 19930101, 19931231,
                                       block=1024),
              plain=lambda: sk.select_plain(orderdate, 19930101, 19931231,
                                            block=1024))
    err = check("select_range", b1["kernel"], b1["plain"])
    nb = -(-n // 1024)
    rows.append(dict(
        name="select_range", route="cuda",
        source="src/repro_torch/kernels/csrc/selection.cu",
        replaces="src/repro/kernels/selection/selection.py:37",
        max_abs_err=err, ms=time_ms(b1["kernel"]),
        plain_ms=time_ms(b1["plain"], reps=5),
        bytes=4 * n + 4 * n + 4 * nb, library_ms=None,
        shape=f"x=({n},) int32, block=1024"))

    # B2 at the fused probe's shape: the sorted date keys against every
    # lineorder row (batch mode probes the whole column)
    s_sorted, _ = join_ref.bucket_build(datekeys)
    keys_small = r.integers(19920000, 19990000, 100_003, dtype=np.int32)
    keys_small[-3:] = (2 ** 31 - 1, -2 ** 31, -1)
    keys_small = torch.from_numpy(keys_small).to(dev)
    check("probe_counts", lambda: jk.probe_counts(s_sorted, keys_small),
          lambda: join_ref.bucket_probe(s_sorted, keys_small))
    b2_kernel = lambda: jk.probe_counts(s_sorted, orderdate)   # noqa: E731
    b2_plain = lambda: join_ref.bucket_probe(s_sorted,         # noqa: E731
                                             orderdate)
    err = check("probe_counts", b2_kernel, b2_plain)

    # B2 at the eager duplicate-keyed join's shape: the filtered lineitem
    # keys cut into HT_CAPACITY pass blocks with distinct negative pads, as
    # join_distributed_multi builds them, against every orders key
    cap = join_core.HT_CAPACITY
    keep = tpch_tables["lineitem"]["quantity"] == 1
    build = torch.from_numpy(tpch_tables["lineitem"]["orderkey"][keep]).to(dev)
    okeys = torch.from_numpy(tpch_tables["orders"]["orderkey"]).to(dev)
    n_passes = -(-build.shape[0] // cap)
    padded = join_core._pad_build(build, n_passes)
    blocks = [join_ref.bucket_build(padded[p * cap:(p + 1) * cap])[0]
              for p in range(n_passes)]
    tpch_kernel = lambda: [t for b in blocks                  # noqa: E731
                           for t in jk.probe_counts(b, okeys)]
    tpch_plain = lambda: [t for b in blocks                   # noqa: E731
                          for t in join_ref.bucket_probe(b, okeys)]
    err = max(err, check("probe_counts", tpch_kernel, tpch_plain))
    tpch_bound = n_passes * (4 * cap + 12 * okeys.shape[0]) \
        / HBM_BYTES_PER_S * 1e3

    def tpch_library():
        for b in blocks:
            torch.searchsorted(b, okeys, side="left")
            torch.searchsorted(b, okeys, side="right")

    log(f"  probe_counts  {n_passes} TPC-H pass blocks of ({cap},) with "
        f"{n_passes * cap - build.shape[0]} negative pads, keys="
        f"({okeys.shape[0]},): kernel {time_ms(tpch_kernel, reps=5):.4f} ms,"
        f" bound {tpch_bound:.4f} ms, plain "
        f"{time_ms(tpch_plain, reps=5):.4f} ms, library "
        f"{time_ms(tpch_library, reps=5):.4f} ms (two torch.searchsorted a "
        "block) for all passes, bit-identical")

    def library_b2():
        torch.searchsorted(s_sorted, orderdate, side="left")
        torch.searchsorted(s_sorted, orderdate, side="right")

    rows.append(dict(
        name="probe_counts", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:189",
        max_abs_err=err, ms=time_ms(b2_kernel), plain_ms=time_ms(b2_plain),
        bytes=4 * s_sorted.shape[0] + 4 * n + 8 * n,
        library_ms=time_ms(library_b2),
        shape=f"s_sorted=({s_sorted.shape[0]},), keys=({n},) int32"))

    # B4 at the eager unique join's shape: the filtered lineorder keys
    # against the date table built the way join_distributed builds it
    m = ((lo["orderdate"] >= 19930101) & (lo["orderdate"] <= 19931231)
         & (lo["discount"] >= 1) & (lo["discount"] <= 3)
         & (lo["quantity"] >= 1) & (lo["quantity"] <= 24))
    probe_keys = torch.from_numpy(lo["orderdate"][m]).to(dev)
    padded = join_core._pad_build(datekeys, 1)
    ts = 4 * join_core.HT_CAPACITY
    ht_k, ht_v, _ = join_ref.build_table(padded, ts, 8)
    check("hash_probe",
          lambda: jk.probe(ht_k, ht_v, keys_small[:100_001], probe_depth=8),
          lambda: jk.probe_plain(ht_k, ht_v, keys_small[:100_001],
                                 probe_depth=8))
    b4_kernel = lambda: jk.probe(ht_k, ht_v, probe_keys,     # noqa: E731
                                 probe_depth=8)
    b4_plain = lambda: jk.probe_plain(ht_k, ht_v,             # noqa: E731
                                      probe_keys, probe_depth=8)
    err = check("hash_probe", b4_kernel, b4_plain)
    n4 = probe_keys.shape[0]
    rows.append(dict(
        name="hash_probe", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:48",
        max_abs_err=err, ms=time_ms(b4_kernel), plain_ms=time_ms(b4_plain),
        bytes=8 * ts + 4 * n4 + 4 * n4 + 4 * -(-n4 // 4096),
        library_ms=None,
        shape=f"table=2x({ts},), keys=({n4},) int32, depth 8"))

    for row in rows:
        finish_row(row)
    return rows


def finish_row(row, agree: str = "bit-identical"):
    """Turn a kernel row's ``bytes`` (and ``ops``, float32 operations) into
    its bound — the larger of bytes over the memory rate and operations
    over the float32 rate — and log the row."""
    t_bytes = row.pop("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = row.pop("ops", 0) / FP32_FLOPS_PER_S * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    lib = row["library_ms"]
    log(f"  {row['name']:13s} {row['shape']}: kernel {row['ms']:.4f} ms,"
        f" bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of the rate), plain "
        f"{row['plain_ms']:.4f} ms"
        + (f", library {lib:.4f} ms" if lib is not None else "")
        + f", {agree}")


def equals(want):
    """A ``_run_modes`` check: the value must equal the oracle's."""
    def check(mode, value):
        if value != want:
            raise AssertionError(f"{mode}: {value} != oracle {want}")
        return f"value {value} (= oracle)"
    return check


def _run_modes(ex, q, modes, check, counts_by_mode, reps=11, **kw):
    """Run ``q`` once per mode with the launch counters zeroed just before
    and read just after, ``check(mode, value)`` the value (it raises, or
    returns what to log), then time ``reps`` warm runs (host clock around
    work that ends in a synchronize), checking each.  Returns mode ->
    (first-run seconds, sorted warm seconds, first run's value)."""
    import torch
    from repro_torch.kernels import _build
    times = {}
    for mode in modes:
        run = lambda: ex.execute(q, mode=mode,                  # noqa: E731
                                 **(kw if mode == "stream" else {}))
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts_by_mode[mode] = dict(_build.LAUNCHES)
        said = check(mode, res.value)
        warm = warm_runs(run, lambda v: check(f"{mode} (warm)", v), reps)
        times[mode] = (first, warm, res.value)
        log(f"  {mode:6s}: {said}; first run {first * 1e3:.3f} ms, "
            f"{spread(warm)}; launches {counts_by_mode[mode]}")
        log("    " + profile_once(run))
    return times


def warm_runs(run, check, reps=11):
    """Sorted seconds of ``reps`` runs of ``run`` (host clock around work
    that ends in a synchronize), each result's value checked."""
    import torch
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        value = run().value
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(value)
    return sorted(warm)


def spread(warm) -> str:
    return (f"warm median {warm[len(warm) // 2] * 1e3:.3f} ms [min "
            f"{warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over "
            f"{len(warm)} runs")


def profile_once(run, top: int = 5) -> str:
    """One more warm run under ``torch.profiler``: the device's busy time
    (the sum of kernel and copy self times) against the run's wall time,
    and the kernels that took most of it.  The profiler's own cost
    lengthens the wall time, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        return "profile: no device time traced (not measured)"
    dev.sort(key=lambda e: -e.self_device_time_total)
    heads = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in dev[:top])
    return (f"profile: device busy {busy_us / 1e3:.3f} ms of "
            f"{wall_us / 1e3:.3f} ms wall (idle <= "
            f"{1 - busy_us / wall_us:.0%}), {sum(e.count for e in dev)} "
            f"device ops; top: {heads}")


def phase_ssb(dev, tables):
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q
    t0 = time.perf_counter()
    want = ssb_oracle(tables)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    n = tables["lineorder"]["orderdate"].shape[0]
    log(f"ssb: lineorder {n} rows x 4 int32 columns on the card, catalog "
        f"in {time.perf_counter() - t0:.2f} s; oracle {want}")
    q = ssb_query(Q)
    plan = ex.explain(q)
    log("  plan:\n    " + plan.replace("\n", "\n    "))
    for line in plan.splitlines():
        op = line.strip().split(":")[0]
        if op in ("join", "filter") and "impl=cuda" not in line:
            raise AssertionError(f"{op} is not planned on the kernels: "
                                 f"{line.strip()}")
    if not any(l.strip().startswith("join:") for l in plan.splitlines()):
        raise AssertionError("the date join is not the unique-key join")
    counts = {}
    _run_modes(ex, q, ("batch", "stream", "eager"), equals(want), counts,
               morsel_rows=1 << 22)
    need = {"batch": ("probe_counts",), "stream": ("probe_counts",),
            "eager": ("select", "probe")}
    for mode, kernels in need.items():
        for k in kernels:
            if counts[mode][k] <= 0:
                raise AssertionError(f"{mode} launched no {k} kernel")
    return counts


def phase_tpch(dev, tables, order_idx):
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q
    want = tpch_oracle(tables, order_idx)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    q = tpch_query(Q)
    plan = ex.explain(q)
    log(f"tpch: lineitem {tables['lineitem']['orderkey'].shape[0]} rows, "
        f"orders {tables['orders']['orderkey'].shape[0]} rows; oracle "
        f"{want}\n  plan:\n    " + plan.replace("\n", "\n    "))
    lines = [l.strip() for l in plan.splitlines()]
    join = next((i for i, l in enumerate(lines)
                 if l.startswith("join_multi:")), None)
    if join is None or "impl=cuda" not in lines[join]:
        raise AssertionError("the duplicate-keyed join is not join_multi "
                             "on the kernels")
    # the build side is the join's second child: the filtered lineitem
    opt, _ = ex.plan(q.node)
    j = opt.child
    if not (getattr(j.right, "child", None) is not None
            and j.right.child.table == "lineitem"):
        raise AssertionError(f"build side is not the filtered lineitem: "
                             f"{j.right}")
    counts = {}
    _run_modes(ex, q, ("eager", "batch"), equals(want), counts)
    if counts["eager"]["probe_counts"] <= 0:
        raise AssertionError("eager join_multi launched no probe_counts")
    return counts


def timed_once_ms(fn):
    """(result, milliseconds) of one call, CUDA events around it: for the
    plain SGD version, whose one call takes seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def phase_glm(dev, seed):
    """Hyper-parameter search over the MNIST-shaped set in every mode, the
    SGD kernel against its plain version at that shape, then scoring.
    Returns (launch counts by mode, the kernel's JSON row)."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.kernels.sgd import ref as sgd_ref
    from repro_torch.kernels.sgd import sgd as sgd_kernels
    from repro_torch.query import Executor, HyperParams, Q

    t0 = time.perf_counter()
    tables, a_np, label = make_mnist_like(MNIST_ROWS, MNIST_FEATURES, seed)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    log(f"glm: {MNIST_ROWS} rows x {MNIST_FEATURES} float32 features + "
        f"label ({a_np.nbytes / 1e6:.0f} MB) on the card in "
        f"{time.perf_counter() - t0:.2f} s; {GLM_JOBS} jobs, "
        f"{GLM_EPOCHS} epochs, minibatch {GLM_MINIBATCH}")
    q = glm_query(Q, HyperParams)
    plan = ex.explain(q)
    log("  plan:\n    " + plan.replace("\n", "\n    "))
    if not plan.startswith("train_glm: impl=cuda"):
        raise AssertionError(f"train_glm is not planned on the kernels: "
                             f"{plan.splitlines()[0]}")
    ln2 = float(np.log(2.0))

    def check(mode, value):
        xs, losses = value
        if xs.shape != (GLM_JOBS, MNIST_FEATURES) \
                or not bool(torch.isfinite(xs).all()):
            raise AssertionError(f"{mode}: weights {tuple(xs.shape)} not "
                                 "finite or of the wrong shape")
        if not bool((losses < ln2).all()):
            raise AssertionError(f"{mode}: a loss is not below ln 2: "
                                 f"{losses.tolist()}")
        return ("losses " + ", ".join(f"{v:.4f}" for v in losses.tolist())
                + " (all < ln 2)")

    counts = {}
    runs = _run_modes(ex, q, ("batch", "stream", "eager"), check, counts,
                      morsel_rows=16_384)
    weights = {mode: r[2][0] for mode, r in runs.items()}
    for mode in ("batch", "stream"):
        if not torch.equal(weights[mode], weights["eager"]):
            raise AssertionError(f"{mode} weights differ from eager's")
    log(f"  batch, stream ({-(-MNIST_ROWS // 16_384)} morsels) and eager "
        "weights are bit-identical")

    # the same search under a 64 MiB device budget: the columns that do
    # not fit go to host DRAM and every epoch streams them back
    from repro_torch.kernels import _build
    from repro_torch.query import TierBudgets
    spilled = Executor(catalog_from_arrays(tables, dev), dev,
                       tier_budgets=TierBudgets(device=64 * MIB))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = spilled.execute(q).value
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts["spilled batch"] = dict(_build.LAUNCHES)
    check("spilled batch", value)
    if not torch.equal(value[0], weights["eager"]):
        raise AssertionError("spilled weights differ from the resident run's")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        spilled.execute(q)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    warm.sort()
    by_tier = {}
    for tier in spilled.last_spill.tiers.values():
        by_tier[tier] = by_tier.get(tier, 0) + 1
    log(f"  spilled (64 MiB device budget): columns by tier {by_tier}; "
        f"weights bit-identical to the resident run's; first run "
        f"{first * 1e3:.3f} ms, warm median {warm[1] * 1e3:.3f} ms [min "
        f"{warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over 3 runs; "
        f"launches {counts['spilled batch']}")
    del spilled
    for mode, c in counts.items():
        if c["sgd"] <= 0:
            raise AssertionError(f"{mode} launched no sgd kernel")

    # B5 against its plain version at the main path's shape: eager mode's
    # one launch over the whole set (60,000 rows need no pad)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(label).to(dev)
    grid = q.node.grid
    lrs = torch.tensor([g.lr for g in grid], dtype=torch.float32, device=dev)
    l2s = torch.tensor([g.l2 for g in grid], dtype=torch.float32, device=dev)
    xs0 = torch.zeros((GLM_JOBS, MNIST_FEATURES), dtype=torch.float32,
                      device=dev)
    kw = dict(minibatch=GLM_MINIBATCH, epochs=GLM_EPOCHS, kind="logreg")
    kernel = lambda: sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw)  # noqa: E731
    xs_k = kernel()
    xs_p, plain_ms = timed_once_ms(
        lambda: sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw))
    torch.cuda.synchronize()
    if not torch.equal(xs_k, weights["eager"]):
        raise AssertionError("the kernel's weights differ from eager mode's")
    err = float((xs_k - xs_p).abs().max())
    rel = float(((xs_k - xs_p).abs() / xs_p.abs().clamp(min=1e-30)).max())
    if not torch.allclose(xs_k, xs_p, **SGD_TOL):
        raise AssertionError(f"sgd: kernel differs from its plain version "
                             f"beyond {SGD_TOL} (max abs err {err})")
    m, n = a.shape
    steps = GLM_EPOCHS * m // GLM_MINIBATCH
    row = dict(
        name="sgd", route="cuda",
        source="src/repro_torch/kernels/csrc/sgd.cu",
        replaces="src/repro/kernels/sgd/sgd.py:55",
        max_abs_err=err, ms=time_ms(kernel, reps=5, warmup=1),
        plain_ms=plain_ms, library_ms=None,
        # every input read once, the weights written once; 2 FMAs a
        # feature a row a job an epoch (the dot and the gradient)
        bytes=4 * (m * n + m + 2 * GLM_JOBS * n + 2 * GLM_JOBS),
        ops=4 * GLM_JOBS * GLM_EPOCHS * m * n,
        shape=f"a=({m}, {n}) f32, {GLM_JOBS} jobs, {GLM_EPOCHS} epochs, "
              f"minibatch {GLM_MINIBATCH}")
    streamed_bytes = 4 * GLM_JOBS * GLM_EPOCHS * m * (n + 1)
    log(f"  sgd: max abs err {err:.3e}, max rel err {rel:.3e} against the "
        f"plain version (tolerance {SGD_TOL}); the dataset streamed once "
        f"per job and epoch is {streamed_bytes / 1e9:.3f} GB, "
        f"{streamed_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
        f"rate; each job is a chain of {steps} dependent steps, "
        f"{row['ms'] * 1e3 / steps:.3f} us a step")
    finish_row(row, agree=f"within {SGD_TOL}")

    # score with the best model (trained fresh through execute, as the
    # port has no model cache) against numpy in float64
    sq = Q.scan("mnist").score_glm(q)
    t0 = time.perf_counter()
    scores = ex.execute(sq).value.column("score")
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    xs_b, losses_b = runs["batch"][2]
    x = xs_b[int(torch.argmin(losses_b))].double().cpu().numpy()
    want = 1.0 / (1.0 + np.exp(-(a_np.astype(np.float64) @ x)))
    got = scores.double().cpu().numpy()
    score_err = float(np.abs(got - want).max())
    if got.shape != (MNIST_ROWS,) or not np.allclose(got, want, rtol=1e-5,
                                                     atol=1e-5):
        raise AssertionError(f"score_glm differs from numpy (max abs err "
                             f"{score_err})")
    log(f"  score_glm: {MNIST_ROWS} scores of the argmin model equal "
        f"numpy's sigmoid(a @ x) within rtol=1e-5, atol=1e-5 (max abs err "
        f"{score_err:.3e}); {score_s * 1e3:.3f} ms with its fresh train")
    return counts, row


def phase_multi_join(dev, tables):
    """``hash_join_multi`` at TPC-H SF 1 against a numpy oracle, bit for
    bit, on two build sides; then B3 against its plain version at the
    order-key shape.  Returns (launch counts by join, the kernel's row)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.join import join as jk
    from repro_torch.kernels.join import ref as join_ref
    from repro_torch.kernels.join.ops import hash_join_multi

    li, od = tables["lineitem"], tables["orders"]
    cases = {
        "orderkey": (li["orderkey"], od["orderkey"]),
        "quantity": (li["quantity"], np.arange(1, 51, dtype=np.int32)),
    }
    counts = {}
    for name, (s, l) in cases.items():
        l_want, s_want, total = multi_join_oracle(s, l)
        max_out = s.size
        st, lt = torch.from_numpy(s).to(dev), torch.from_numpy(l).to(dev)
        run = lambda: hash_join_multi(st, lt, max_out=max_out)  # noqa: E731
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts[name] = dict(_build.LAUNCHES)
        if counts[name]["probe_multi"] <= 0:
            raise AssertionError(f"{name}: hash_join_multi launched no "
                                 "probe_multi kernel")
        got_l, got_s = res.l_idx.cpu().numpy(), res.s_idx.cpu().numpy()
        if int(res.total) != total or bool(res.overflowed) \
                or total > max_out:
            raise AssertionError(f"{name}: total {int(res.total)} (oracle "
                                 f"{total}), overflowed "
                                 f"{bool(res.overflowed)}")
        if not (np.array_equal(got_l[:total], l_want)
                and np.array_equal(got_s[:total], s_want)
                and (got_l[total:] == -1).all()
                and (got_s[total:] == -1).all()):
            raise AssertionError(f"{name}: pair list differs from the "
                                 "oracle")
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        warm.sort()
        chains = np.bincount(np.searchsorted(np.sort(np.unique(s)), s))
        log(f"multi_join {name}: build {s.size} keys (chains "
            f"{chains.min()}-{chains.max()}), probe {l.size} keys -> "
            f"{total} pairs, bit-identical to the oracle; first run "
            f"{first * 1e3:.3f} ms, warm median {warm[2] * 1e3:.3f} ms "
            f"[min {warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f}] over 5 "
            f"runs; launches {counts[name]}")
        log("    " + profile_once(run))

    # B3 against its plain version at the order-key join's shape
    s, l = cases["orderkey"]
    s_sorted, order = join_ref.bucket_build(torch.from_numpy(s).to(dev))
    keys = torch.from_numpy(l).to(dev)
    kernel = lambda: jk.probe_multi(s_sorted, order, keys)     # noqa: E731
    plain = lambda: jk.probe_multi_plain(s_sorted, order, keys)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"probe_multi: kernel differs from its plain "
                             f"version (max abs err {err})")
    n_s, n_l = s_sorted.shape[0], keys.shape[0]
    cap = got[0].shape[1]
    row = dict(
        name="probe_multi", route="cuda",
        source="src/repro_torch/kernels/csrc/join.cu",
        replaces="src/repro/kernels/join/join.py:142",
        max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
        library_ms=None,
        bytes=8 * n_s + 4 * n_l + (8 + 4 * cap) * n_l,
        shape=f"s_sorted, order=({n_s},), keys=({n_l},) int32, cap {cap}")
    finish_row(row)
    return counts, row


def phase_calibrate(dev, ssb_tables, spill_dir):
    """B6 against its plain version, timed; the calibration written, read
    back and applied with ``recost``; the Fig. 2 analogue.  Returns (launch
    counts of the calibration run, the kernel's row, the calibration)."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.core import bandwidth, channels
    from repro_torch.kernels import _build
    from repro_torch.kernels.bandwidth import ref as bw_ref
    from repro_torch.kernels.bandwidth import stream
    from repro_torch.query import Executor, Q, load_calibration
    from repro_torch.query.calibrate import calibrate

    r = np.random.default_rng(8)
    x = torch.from_numpy(r.integers(-2 ** 31, 2 ** 31, STREAM_ROWS,
                                    dtype=np.int64).astype(np.int32)).to(dev)
    x[0] = 2 ** 31 - 1
    ragged = x[:(1 << 20) + 3]
    cases = {"1 GiB int32": x, "ragged (1 << 20) + 3": ragged,
             "misaligned x[1:]": ragged[1:],
             "2**31 - 1": torch.full((1027,), 2 ** 31 - 1, dtype=torch.int32,
                                     device=dev),
             "float32": torch.from_numpy(r.standard_normal((1 << 20) + 5)
                                         .astype(np.float32)).to(dev)[1:]}
    for name, t in cases.items():
        got, want = stream.stream_copy(t), bw_ref.stream_copy_ref(t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"stream_copy ({name}): kernel differs "
                                 "from its plain version")
    if int(stream.stream_copy(cases["2**31 - 1"])[0]) != -2 ** 31:
        raise AssertionError("stream_copy: 2**31 - 1 did not wrap")
    log(f"calibrate: stream_copy bit-identical to its plain version on "
        f"{', '.join(cases)}")
    row = dict(
        name="stream_copy", route="cuda",
        source="src/repro_torch/kernels/csrc/bandwidth.cu",
        replaces="src/repro/core/bandwidth.py:27", max_abs_err=0.0,
        ms=time_ms(lambda: stream.stream_copy(x), reps=10),
        plain_ms=time_ms(lambda: bw_ref.stream_copy_ref(x), reps=10),
        library_ms=time_ms(lambda: torch.add(x, 1), reps=10),
        bytes=2 * 4 * STREAM_ROWS,
        shape=f"x=({STREAM_ROWS},) int32")
    finish_row(row)

    # the calibration run: the slice's path through the kernel
    path = os.path.join(spill_dir, "BENCH_calibration_torch.json")
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = calibrate(path)
    torch.cuda.synchronize()
    counts = {"calibrate": dict(_build.LAUNCHES)}
    if counts["calibrate"]["stream_copy"] <= 0:
        raise AssertionError("calibrate() launched no stream_copy kernel")
    cal = load_calibration(path)
    if cal != report or set(cal["backends"]) != {"torch", "cuda"} \
            or not cal["h2d_gbps"] > 0:
        raise AssertionError(f"the calibration file does not read back: "
                             f"{cal}")
    log(f"  calibrate() in {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{impl} {b['achieved_gbps']:.1f} GB/s "
                    f"(stream_eff {b['stream_eff']:.4f}, call overhead "
                    f"{b['call_overhead_s'] * 1e6:.2f} us)"
                    for impl, b in cal["backends"].items())
        + f"; h2d {cal['h2d_gbps']:.2f} GB/s from pinned memory; "
        f"launches {counts['calibrate']}")

    # recost an executor over SSB SF 10 with it
    ex = Executor(catalog_from_arrays(ssb_tables, dev), dev)
    q = ssb_query(Q)

    def morsel_rows():
        return ex.plan(q.node)[1].morsel_rows

    before = morsel_rows()
    epoch = ex.recost(cal)
    after, plan = morsel_rows(), ex.explain(q)
    if epoch != 1 or ex.cost_model.calibrated_from != "cuda":
        raise AssertionError(f"recost: epoch {epoch}, calibrated from "
                             f"{ex.cost_model.calibrated_from}")
    ex.recost(cal)
    if ex.cost_epoch != 2 or ex.explain(q) != plan:
        raise AssertionError("a second recost with the same calibration "
                             "changed a price")
    log(f"  recost: epoch 0 -> 1 -> 2, the second changes no price; SSB "
        f"stream plan morsel_rows {before} (placeholders) -> {after} "
        "(calibrated)")
    del ex

    # the Fig. 2 analogue: one generator per engine, partitioned vs
    # congested (each engine streams its own slice either way on one card)
    fig2 = []
    for n_eng in (1, 4, 16):
        for placement in ("partitioned", "congested"):
            plan_ = channels.plan(placement, n_eng, dev)
            gbps = bandwidth.measure_gbps(
                lambda t: bandwidth.stream_copy_distributed(t, plan_), x)
            fig2.append(f"{n_eng} {placement} {gbps:.1f}")
    log("  fig2 analogue (engines, placement, GB/s): " + "; ".join(fig2))
    return counts, row, cal


def phase_spill(dev, ssb_tables, cal, spill_dir):
    """SSB Q1.1 at SF 10 under device (and host) budgets: host spill in
    batch and stream, host and disk spill in batch, each against the
    oracle.  Returns launch counts by run."""
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q, TierBudgets

    want = ssb_oracle(ssb_tables)
    q = ssb_query(Q)
    counts = {}
    cases = (("host", TierBudgets(device=256 * MIB), ("batch", "stream")),
             ("host+disk", TierBudgets(device=256 * MIB, host=512 * MIB),
              ("batch",)))
    for name, budgets, modes in cases:
        ex = Executor(catalog_from_arrays(ssb_tables, dev), dev,
                      tier_budgets=budgets)
        ex._spill_dir = spill_dir
        ex.recost(cal)
        by_mode = {}
        times = _run_modes(ex, q, modes, equals(want), by_mode)
        spill = ex.last_spill
        tiers = {c: t for (_, c), t in spill.tiers.items()}
        lo = ex.catalog.tables["lineorder"]
        if any(lo.column_tier(c) != t for c, t in tiers.items()):
            raise AssertionError(f"{name}: catalog tiers differ from the "
                                 f"spill plan {tiers}")
        promoted = sum(n for t, n in spill.bytes_by_tier.items()
                       if t != "device")
        for mode, (first, warm, value) in times.items():
            med = warm[len(warm) // 2]
            log(f"spill {name} {mode}: tiers {tiers}; {promoted} bytes "
                f"promoted a run over {med * 1e3:.3f} ms (median of "
                f"{len(warm)}) = {promoted / med / 1e9:.2f} GB/s against "
                f"the calibrated h2d {ex.cost_model.h2d_gbps:.2f} GB/s; "
                f"priced promotion {spill.promote_s_per_exec * 1e3:.3f} ms")
            counts[f"{name} {mode}"] = by_mode[mode]
            if by_mode[mode]["probe_counts"] <= 0:
                raise AssertionError(f"spill {name} {mode} launched no "
                                     "probe_counts kernel")
        if name == "host":
            ex.overlap_transfers = False
            same = equals(want)
            warm = warm_runs(lambda: ex.execute(q),
                             lambda v: same("batch, one thread", v))
            log(f"spill host batch without the prefetch thread: "
                f"{spread(warm)}")
        expect = ["device", "host", "host", "host"] if name == "host" \
            else ["device", "disk", "host", "host"]
        if sorted(tiers.values()) != expect:
            raise AssertionError(f"{name}: tiers {tiers}, expected {expect}")
        del ex, lo
        torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_all = time.perf_counter()

    card = phase_card()
    phase_build()

    t0 = time.perf_counter()
    ssb = make_ssb(SSB_LINEORDER_ROWS, args.seed)
    tpch, order_idx = make_tpch(TPCH_LINEITEM_ROWS, TPCH_ORDERS_ROWS,
                                args.seed)
    log(f"data: made in {time.perf_counter() - t0:.2f} s (seed {args.seed})")

    log("kernels against their plain versions:")
    rows = phase_kernels(dev, ssb, tpch)
    ssb_counts = phase_ssb(dev, ssb)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as spill_dir:
        cal_counts, copy_row, cal = phase_calibrate(dev, ssb, spill_dir)
        spill_counts = phase_spill(dev, ssb, cal, spill_dir)
    del ssb
    tpch_counts = phase_tpch(dev, tpch, order_idx)
    glm_counts, sgd_row = phase_glm(dev, args.seed)
    multi_counts, multi_row = phase_multi_join(dev, tpch)
    rows += [multi_row, sgd_row, copy_row]

    key = {"select_range": "select", "probe_counts": "probe_counts",
           "hash_probe": "probe", "probe_multi": "probe_multi",
           "sgd": "sgd", "stream_copy": "stream_copy"}
    for row in rows:
        row["launches"] = sum(c[key[row["name"]]]
                              for counts in (ssb_counts, tpch_counts,
                                             glm_counts, multi_counts,
                                             cal_counts, spill_counts)
                              for c in counts.values())
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 "path")
        row.pop("shape")
    log(f"tpch launches: {tpch_counts}; glm launches: {glm_counts}; "
        f"calibrate launches: {cal_counts}; spill launches: {spill_counts}")
    log(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
