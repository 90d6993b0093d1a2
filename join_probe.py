"""Time the join probes B3 and B4 on the card for one checkout of the port,
to compare commits.

    python3 join_probe.py [--src DIR] [--reps 200]

Each line gives a kernel's time at a shape of ``chip_smoke.py``'s main
path: the minimum, median and maximum of three timings of its device
time a call, each over ``--reps`` calls under ``torch.profiler``
(``chip_smoke.device_ms``), the time a call takes dispatched from the
host one by one (CUDA events around ``--reps`` calls), and the byte
bound (inputs read once, outputs written once, over 3.35 TB/s):

* ``probe_multi`` (B3) at ``hash_join_multi``'s order-key join (TPC-H SF
  1: 6,001,215 sorted lineitem order keys and their ``order``, the
  1,500,000 order keys, cap 8), at the quantity join (50 probe keys,
  chains of ~120,000) and at a 50-key dimension probed by lineitem's
  6,001,215 quantities;
* ``probe`` (B4) at SSB SF 10's eager unique join (the date table in
  32,768 slots, depth 8, the 1,192,560 lineorder keys the filter keeps)
  and at its first 1/8 and 1/2, so that the fixed cost and the cost a
  row can be read apart;
* ``probe_counts`` (B2), which shares B3's search, at SSB's batch join
  (2,556 date keys, 59,986,214 lineorder keys: the shared route), at
  lineitem joined with orders (1,500,000 order keys, 6,001,215 lineitem
  keys: the sampled route), and at the eager duplicate-keyed TPC-H join
  (the 119,384 lineitem keys of quantity 1 against the 1,500,000 order
  keys: their 15 negative-padded pass blocks of 8,192 on the shared
  route, all 15 a call, and the whole of them sorted on the sampled
  route).

Each line ends with the device time a call of each kernel and copy the
call launches (from one more profiled run of ``--reps`` calls).  It also
prints the card's name and power limit, and the registers and
spills ``ptxas`` reports for the join kernels when this process built
them.  ``--src`` imports ``repro_torch`` from another checkout's
``src`` (its kernels build into that checkout), so two commits are
compared by running this script once for each, in turns, in one call.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import sys

import numpy as np

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def _short(key: str) -> str:
    """A kernel's own name (with its template arguments' first word) out of
    the profiler's demangled signature."""
    m = re.search(r"(\w+_kernel(?:<\w+)?)", key)
    return m.group(1) if m else key[:40]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("join_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import join as join_core
    from repro_torch.kernels import _build
    from repro_torch.kernels.join import join as jk
    from repro_torch.kernels.join import ref as join_ref

    dev = torch.device("cuda", 0)
    card = cs.phase_card()

    def split(fn):
        """Device time a call of each kernel and copy ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        parts = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return "; ".join(f"{_short(e.key)} "
                         f"{e.self_device_time_total / 1e3 / args.reps:.4f}"
                         for e in sorted(parts, key=lambda e:
                                         -e.self_device_time_total))

    def line(name, shape, fn, n_bytes):
        times = sorted(cs.device_ms(fn, args.reps) for _ in range(3))
        host = cs.time_ms(fn, reps=args.reps)
        bound = n_bytes / cs.HBM_BYTES_PER_S * 1e3
        mid = statistics.median(times)
        print(f"{src} {name} {shape}: device {times[0]:.4f} / {mid:.4f} / "
              f"{times[-1]:.4f} ms a call (min / median / max of 3 x "
              f"{args.reps} calls), dispatched from the host {host:.4f} ms "
              f"a call, bound {bound:.4f} ms ({bound / mid:.1%} of the "
              f"median); {card}; by kernel (ms a call): {split(fn)}",
              flush=True)

    tpch, _ = cs.make_tpch(cs.TPCH_LINEITEM_ROWS, cs.TPCH_ORDERS_ROWS, SEED)
    li = tpch["lineitem"]
    okeys = torch.from_numpy(tpch["orders"]["orderkey"]).to(dev)
    cases = (
        ("order keys", li["orderkey"], okeys),
        ("quantity", li["quantity"],
         torch.arange(1, 51, dtype=torch.int32, device=dev)),
        ("quantity dimension", np.arange(1, 51, dtype=np.int32),
         torch.from_numpy(li["quantity"]).to(dev)),
    )
    for what, s, keys in cases:
        s_sorted, order = join_ref.bucket_build(torch.from_numpy(s).to(dev))
        n_s, n = s_sorted.shape[0], keys.shape[0]
        cap = jk.DEFAULT_MATCH_CAP
        line("probe_multi", f"{what}: s_sorted=({n_s},), keys=({n},), cap "
             f"{cap}", lambda: jk.probe_multi(s_sorted, order, keys),
             8 * n_s + 4 * n + (8 + 4 * cap) * n)
    ordered, _ = join_ref.bucket_build(okeys)
    lkeys = torch.from_numpy(li["orderkey"]).to(dev)
    line("probe_counts", f"s_sorted=({ordered.shape[0]},), keys="
         f"({lkeys.shape[0]},), sampled route",
         lambda: jk.probe_counts(ordered, lkeys),
         4 * ordered.shape[0] + 12 * lkeys.shape[0])
    cap = join_core.HT_CAPACITY
    build = torch.from_numpy(li["orderkey"][li["quantity"] == 1]).to(dev)
    n_passes = -(-build.shape[0] // cap)
    padded = join_core._pad_build(build, n_passes)
    blocks = [join_ref.bucket_build(padded[p * cap:(p + 1) * cap])[0]
              for p in range(n_passes)]
    line("probe_counts", f"{n_passes} pass blocks of ({cap},), keys="
         f"({okeys.shape[0]},), shared route",
         lambda: [jk.probe_counts(b, okeys) for b in blocks],
         n_passes * (4 * cap + 12 * okeys.shape[0]))
    filtered, _ = join_ref.bucket_build(build)
    line("probe_counts", f"s_sorted=({filtered.shape[0]},), keys="
         f"({okeys.shape[0]},), "
         f"{jk.probe_counts_route(filtered.shape[0])} route",
         lambda: jk.probe_counts(filtered, okeys),
         4 * filtered.shape[0] + 12 * okeys.shape[0])
    del tpch, cases, ordered, lkeys, blocks, filtered

    ssb = cs.make_ssb(cs.SSB_LINEORDER_ROWS, SEED)
    lo = ssb["lineorder"]
    m = ((lo["orderdate"] >= 19930101) & (lo["orderdate"] <= 19931231)
         & (lo["discount"] >= 1) & (lo["discount"] <= 3)
         & (lo["quantity"] >= 1) & (lo["quantity"] <= 24))
    probe_keys = torch.from_numpy(lo["orderdate"][m]).to(dev)
    datekeys = torch.from_numpy(ssb["date"]["orderdate"]).to(dev)
    orderdate = torch.from_numpy(lo["orderdate"]).to(dev)
    del ssb, lo
    s_dates, _ = join_ref.bucket_build(datekeys)
    line("probe_counts", f"s_sorted=({s_dates.shape[0]},), keys="
         f"({orderdate.shape[0]},), shared route",
         lambda: jk.probe_counts(s_dates, orderdate),
         4 * s_dates.shape[0] + 12 * orderdate.shape[0])
    del orderdate
    ts = 4 * join_core.HT_CAPACITY
    ht_k, ht_v, _ = join_ref.build_table(join_core._pad_build(datekeys, 1),
                                         ts, 8)
    n4 = probe_keys.shape[0]
    for part in (8, 2, 1):
        keys = probe_keys[:n4 // part]
        n = keys.shape[0]
        line("probe", f"table=2x({ts},), keys=({n},) (1/{part}), depth 8",
             lambda: jk.probe(ht_k, ht_v, keys, probe_depth=8),
             8 * ts + 8 * n + 4 * -(-n // jk.DEFAULT_BLOCK))

    for text in _build.BUILD_LOG.get("join", "").splitlines():
        if "entry function" in text or "registers" in text or \
                "spill" in text:
            print(f"{src} ptxas join: {text.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
