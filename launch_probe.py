"""The launchers on N ranks against one rank, on whatever cards a machine
has (or the CPU's gloo ranks).

    python -m torch.distributed.run --standalone --nproc_per_node 1 \
        launch_probe.py --out DIR
    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        launch_probe.py --out DIR
    python launch_probe.py --compare DIR 1 4

Each run trains the smoke llama3-8b, mamba2-780m and granite-moe-3b-a800m
(3 AdamW steps of 2 x 64 tokens) and serves the smoke llama3-8b and
mamba2-780m (4 x 24 prompts, 12 tokens) through ``launch.train.train``
and ``launch.serve.serve`` with the drawn weights made f32, as
``tests/test_torch_launch.py`` does on gloo, and rank 0 writes the
losses, every parameter whole, the tokens, each step's seconds and the
kernels' launch counters to ``DIR/launch_{N}.pt``.  ``--compare`` prints
the largest differences of the N-rank run from the one-rank run.  Add
``--device cpu`` to run on gloo ranks.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

TRAIN = ("llama3-8b", "mamba2-780m", "granite-moe-3b-a800m")
SERVE = ("llama3-8b", "mamba2-780m")


def run(out_dir: str, device) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import start_group

    build = serve_mod.build_model

    def build_f32(*a, **kw):
        mb, model = build(*a, **kw)
        return mb, model.float()
    train_mod.build_model = serve_mod.build_model = build_f32
    start_group(device)          # held for the whole run: launchers join
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"world": world, "train": {}, "serve": {}}
    for arch in TRAIN:
        _build.reset_launches()
        stats = {}
        model, losses = train_mod.train(arch, steps=3, seq_len=64,
                                        global_batch=2, device=device,
                                        log_every=100, stats=stats)
        out["train"][arch] = {
            "losses": losses, "s": [st["s"] for st in stats["steps"]],
            "params": {n: sharding.whole(p).detach().cpu()
                       for n, p in model.named_parameters()},
            "launches": {k: n for k, n in _build.LAUNCHES.items() if n}}
    for arch in SERVE:
        _build.reset_launches()
        t0 = time.perf_counter()
        toks = serve_mod.serve(arch, device=device)
        out["serve"][arch] = {
            "tokens": toks.cpu(), "s": time.perf_counter() - t0,
            "launches": {k: n for k, n in _build.LAUNCHES.items() if n}}
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        torch.save(out, os.path.join(out_dir, f"launch_{world}.pt"))
    dist.destroy_process_group()


def compare(out_dir: str, one: int, many: int) -> int:
    import torch
    a = torch.load(os.path.join(out_dir, f"launch_{one}.pt"))
    b = torch.load(os.path.join(out_dir, f"launch_{many}.pt"))
    bad = 0
    for arch, ra in a["train"].items():
        rb = b["train"][arch]
        dl = max(abs(x - y) for x, y in zip(ra["losses"], rb["losses"]))
        dp = max(float((ra["params"][n] - rb["params"][n]).abs().max())
                 for n in ra["params"])
        print(f"train {arch}: {many} ranks against {one}: losses "
              f"{rb['losses']} / {ra['losses']}, largest loss difference "
              f"{dl:.3e}, parameter {dp:.3e}; steps s {rb['s']} / "
              f"{ra['s']}; launches a rank {rb['launches']} / "
              f"{ra['launches']}")
        bad += not (dl <= 1e-5 and dp <= 1e-5)
    for arch, ra in a["serve"].items():
        rb = b["serve"][arch]
        same = torch.equal(ra["tokens"], rb["tokens"])
        print(f"serve {arch}: {many} ranks against {one}: tokens "
              f"{'equal' if same else 'DIFFER'}; {rb['s']:.2f} / "
              f"{ra['s']:.2f} s; launches a rank {rb['launches']} / "
              f"{ra['launches']}")
        bad += not same
    print(f"{bad} of {len(a['train']) + len(a['serve'])} runs outside 1e-5")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/launch_probe")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--compare", nargs=3, metavar=("DIR", "ONE", "MANY"))
    args = ap.parse_args()
    if args.compare:
        d, one, many = args.compare
        return compare(d, int(one), int(many))
    run(args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
