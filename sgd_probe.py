"""Time B5 on the card for one checkout of the port, to compare commits.

    python3 sgd_probe.py [--src DIR] [--only split|glm]

Two measurements (``--only`` picks one), each printed on a line of its
own:

* ``split``: the split route at ``chip_smoke.py``'s wide GLM shapes
  (RCV1's 47,236 features on 4,096 rows, news20.binary's 1,355,191 on
  1,024; 4 logistic-regression jobs, one epoch, minibatch 16): one
  ``sgd`` launch, CUDA events, the mean of 10 launches after one
  warm-up, twice, on dense uniform unit-norm rows with random labels and
  on ``chip_smoke.text_rows``;
* ``glm batch``: ``chip_smoke.py``'s MNIST-shaped GLM search (8 jobs, 5
  epochs) through the executor in batch mode: the first run, then the
  median, min and max of 11 warm runs (host clock around work that ends
  in a synchronize).

``--src`` imports ``repro_torch`` from another checkout's ``src`` (its
kernels build into that checkout), so two commits are compared by
running this script once for each, in turns, in one call.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 10
SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--only", choices=("split", "glm"))
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("sgd_probe: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def launch_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / REPS

    if args.only != "glm":
        print(f"{src} split: " + split_times(launch_ms, dev), flush=True)
    if args.only != "split":
        print(f"{src} glm batch: " + glm_batch_times(dev), flush=True)
    return 0


def split_times(launch_ms, dev) -> str:
    import torch
    from repro_torch.kernels.sgd import sgd as sgd_kernels
    out = []
    for rows, features, terms in (
            (cs.WIDE_ROWS, cs.WIDE_FEATURES, cs.WIDE_TERMS),
            (cs.NEWS20_ROWS, cs.NEWS20_FEATURES, cs.NEWS20_TERMS)):
        for name, lr in (("uniform", 0.05), ("text", cs.WIDE_LR)):
            gen = torch.Generator(device=dev).manual_seed(SEED + 5)
            if name == "uniform":
                a = torch.rand((rows, features), generator=gen, device=dev)
                a /= a.norm(dim=1, keepdim=True)
                b = (torch.rand(rows, generator=gen, device=dev)
                     > 0.5).float()
            else:
                a, b = cs.text_rows(rows, features, terms, gen, dev)
            jobs = range(cs.WIDE_JOBS)
            lrs = torch.tensor([lr / (i + 1) for i in jobs], device=dev)
            l2s = torch.tensor([0.001 * i for i in jobs], device=dev)
            xs0 = torch.zeros((cs.WIDE_JOBS, features), device=dev)

            def run():
                return sgd_kernels.sgd(a, b, xs0, lrs, l2s,
                                       minibatch=cs.GLM_MINIBATCH, epochs=1,
                                       kind="logreg")
            out.append(f"{features} {name} {launch_ms(run):.4f} / "
                       f"{launch_ms(run):.4f} ms")
            del a, b
            torch.cuda.empty_cache()
    return "; ".join(out)


def glm_batch_times(dev) -> str:
    import torch
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, HyperParams, Q
    tables, _, _ = cs.make_mnist_like(cs.MNIST_ROWS, cs.MNIST_FEATURES,
                                      SEED)
    ex = Executor(catalog_from_arrays(tables, dev), dev)
    q = cs.glm_query(Q, HyperParams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.execute(q, mode="batch")
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    warm = cs.warm_runs(lambda: ex.execute(q, mode="batch"),
                        lambda value: None)
    return f"first run {first * 1e3:.3f} ms, {cs.spread(warm)}"


if __name__ == "__main__":
    sys.exit(main())
