"""Measure the card's streaming numbers -> ``BENCH_calibration_torch.json``.

The cost model ships with placeholder stream efficiencies, call overheads
and tier channels.  This replaces them with numbers measured on the card,
for each of the port's two ``impl`` labels:

* ``torch`` — the library reduction ``torch.sum`` (the reference's
  ``jnp.sum``), which reads the stream once;
* ``cuda`` — the traffic-generator kernel (``kernels/bandwidth``,
  ``o = x + 1``), which reads it once and writes it once.

Each reports ``achieved_gbps`` (the bytes its stream moves over its time:
1x for the sum, 2x for the copy), ``predicted_gbps`` (the model's
``bandwidth_gbps("partitioned")``), ``stream_eff`` (their ratio, at most
1) and ``call_overhead_s`` (the host's time per call on an 8-element
input).  ``h2d_gbps`` is measured from pinned host memory, the path the
morsel loop stages through.  The stream is ``1 << 28`` int32 (1 GiB),
far past the H100's 50 MB L2: a 32 MiB stream would stay in L2 between
back-to-back launches and measure the cache, not HBM.

There is no CPU calibration: without a card this raises.  The file is
written where ``out_path`` says (the working directory by default) and
``.gitignore`` lists it, so a card's numbers never become a CPU run's
constants unnoticed.

    python -m repro_torch.query.calibrate [--smoke] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.bandwidth.stream import stream_copy
from repro_torch.query.cost import CALIBRATION_FILE, CostModel


def _device_s(fn, x, iters: int) -> float:
    """Seconds per call of ``fn(x)`` on the card: CUDA events around
    ``iters`` calls after a warm-up call."""
    fn(x)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def _host_s(fn, x, iters: int) -> float:
    """Seconds per call of ``fn(x)`` on the host clock, up to the last
    call's completion: the dispatch latency a tiny call pays."""
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def calibrate(out_path: str = CALIBRATION_FILE, *, smoke: bool = False,
              device: DeviceLike = None) -> dict:
    """Measure the card and write the calibration file; returns it."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("calibration measures the card; there is no "
                           f"calibration on {dev}")
    with torch.cuda.device(dev):
        n = 1 << 24 if smoke else 1 << 28         # 64 MiB / 1 GiB of int32
        x = torch.arange(n, dtype=torch.int32, device=dev)
        tiny = torch.zeros(8, dtype=torch.int32, device=dev)
        predicted = CostModel(1, impl="cuda").bandwidth_gbps("partitioned")
        backends = {}
        iters = 5 if smoke else 20
        for impl, fn, passes in (("torch", torch.sum, 1),
                                 ("cuda", stream_copy, 2)):
            achieved = passes * x.nbytes / _device_s(fn, x, iters) / 1e9
            backends[impl] = {
                "achieved_gbps": achieved,
                "predicted_gbps": predicted,
                "stream_eff": min(achieved / predicted, 1.0),
                "call_overhead_s": _host_s(fn, tiny, 200),
            }
        del x
        n_h2d = 1 << 22 if smoke else 1 << 26     # 16 MiB / 256 MiB
        host = torch.ones(n_h2d, dtype=torch.int32, pin_memory=True)
        dst = torch.empty(n_h2d, dtype=torch.int32, device=dev)
        t_h2d = _device_s(lambda a: dst.copy_(a, non_blocking=True), host,
                          5 if smoke else 10)
        report = {
            "backend": "cuda",
            "device": torch.cuda.get_device_name(dev),
            "n_bytes": n * 4,
            "h2d_gbps": host.nbytes / t_h2d / 1e9,
            "h2d_bytes": host.nbytes,
            "backends": backends,
        }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a 64 MiB stream instead of 1 GiB")
    ap.add_argument("--out", default=CALIBRATION_FILE)
    args = ap.parse_args(argv)
    print(json.dumps(calibrate(args.out, smoke=args.smoke), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
