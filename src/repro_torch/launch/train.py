"""End-to-end training launcher: model + optimizer + data + checkpoints
wired together, the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --full --seq-len 4096 --global-batch 1 --steps 10

It runs on the CUDA card unless ``--device`` (``device=``) names another.
The weights are random, drawn from ``--seed`` on the target device with
the reference's init rule; the batches are ``data.synthetic_batch``'s
(the reference's own draw), with an encoder-decoder's frames or a vlm's
patch embeddings from ``np.random.default_rng(step)``.  With
``--ckpt-dir`` it saves the model's ``state_dict`` and the optimizer state
every ``--ckpt-every`` steps and, started again, resumes from the latest.
It runs on the current process group laid out as the host mesh, so the
same command runs under torchrun on several ranks:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m repro_torch.launch.train --arch mamba2-780m --device cpu --steps 2

Rank 0 prints the mesh, each logged step, the losses and the kernels'
launch counters so far.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_arch, smoke_config
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh, mesh_axis, process_group
from repro_torch.launch.serve import (
    _on_card, _sync, build_model, launches_line, mesh_line,
)
from repro_torch.models import registry
from repro_torch.models.common import distribute
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.fault_tolerance import StragglerDetector
from repro_torch.train.optimizer import AdamW, PaperSGD
from repro_torch.train.train_loop import make_train_step


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          seq_len: int = 128, global_batch: int = 8,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          optimizer: str = "adamw", lr: float = 3e-4, log_every: int = 10,
          seed: int = 0, device: DeviceLike = None,
          overfit_batch: bool = False, stats: Optional[dict] = None):
    """Train ``arch`` (its smoke config with ``smoke``) for ``steps``
    steps of ``global_batch`` x ``seq_len`` tokens -> (the model, the
    losses of the steps run, plain floats equal on every rank).
    ``overfit_batch`` trains on the first batch at every step, a run
    whose loss must fall.  ``stats``, where given, receives
    ``"steps"``: per step run a dict of its ``step``, ``loss``, ``ce``,
    ``aux``, ``grad_norm`` and seconds ``s`` (host clock around the step,
    ending in a synchronize).

    As the reference's launcher: the process group laid out as the host
    mesh (``make_host_mesh``; a group started here is destroyed on
    return), the rules resolved for ``ShapeConfig("train", seq_len,
    global_batch, "train")``, and the step run under them.  Over more
    than one rank the parameters (drawn whole from ``seed`` by every
    rank, each keeping its block) and the optimizer state are DTensors
    laid out by ``init_specs(tp)``, the batches are laid out by the
    rules, a checkpoint is gathered and written by rank 0, and a resumed
    run restores onto its own mesh, whatever the saving run's was.  One
    rank keeps plain tensors (the rules then change nothing).  Only rank
    0 prints."""
    dev = resolve(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    shape = ShapeConfig("train", seq_len, global_batch, "train")
    with process_group(dev) as started:
        mesh = make_host_mesh(dev)
        dev = _on_card(dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        rules = sharding.resolve(cfg, mesh, shape)
        tp = mesh_axis(mesh, "model")
        mb, model = build_model(cfg, dev, seed=seed)
        specs = mb.init_specs(tp)
        if world > 1:
            distribute(model, specs, rules)
        opt = AdamW(lr=lr) if optimizer == "adamw" else PaperSGD(lr=lr)
        opt_state = opt.init(dict(model.named_parameters()))
        step_fn = make_train_step(mb, model, opt, rules)
        if rank == 0:
            print(f"[train] {mesh_line(mesh, started, dev)}")

        data_cfg = DataConfig(cfg.vocab_size, seq_len, global_batch,
                              seed=seed)
        start = 0
        if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
            like = {"params": model.state_dict(), "opt": opt_state}
            shardings = None if world == 1 else {
                "params": sharding.tree_shardings(specs, rules),
                "opt": sharding.tree_shardings(opt.init_specs(specs),
                                               rules)}
            tree, man = ckpt_lib.restore(ckpt_dir, like,
                                         shardings=shardings)
            model.load_state_dict(tree["params"])
            opt_state = tree["opt"]
            start = man["extra"]["step"]
            if rank == 0:
                print(f"[train] resumed from step {start}")
        batch_sharding = None if world == 1 else {
            k: rules.named(*la.logical)
            for k, la in registry.batch_logical(cfg, shape).items()}
        pipe = Pipeline(data_cfg, dev, start_step=start,
                        extras_fn=_extras_fn(cfg, model.embed.dtype),
                        sharding=batch_sharding)

        straggle = StragglerDetector()
        losses = []
        first = pipe.next() if overfit_batch else None
        for step in range(start, steps):
            batch = first if overfit_batch else pipe.next()
            _sync(dev)
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, batch)
            _sync(dev)
            dt = time.perf_counter() - t0
            straggle.observe(f"host{rank}", dt)
            m = {k: float(v) for k, v in metrics.items()}
            losses.append(m["loss"])
            if stats is not None:
                stats.setdefault("steps", []).append(dict(m, step=step,
                                                          s=dt))
            if rank == 0 and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step={step:5d} loss={m['loss']:.4f} "
                      f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                      f"dt={dt * 1e3:.0f}ms")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt_lib.save(ckpt_dir, step + 1,
                              {"params": model.state_dict(),
                               "opt": opt_state},
                              extra={"step": step + 1, "data": pipe.state()})
    if rank == 0:
        print(f"[train] losses {json.dumps(losses)}")
        print(f"[train] {launches_line()}")
    return model, losses


def _extras_fn(cfg, dtype=torch.bfloat16):
    """A batch's other inputs as the reference's launcher draws them (from
    ``np.random.default_rng(step)``, normal at scale 0.02, in ``dtype``):
    a vlm's patch embeddings over its first positions, an
    encoder-decoder's frames (one a token position); None for the other
    families."""
    if cfg.family == "vlm":
        def fn(dc, step):
            rng = np.random.default_rng(step)
            p = min(cfg.n_vision_patches, dc.seq_len)
            ve = rng.normal(scale=0.02,
                            size=(dc.global_batch, p, cfg.d_model))
            return {"vision_embeds": torch.from_numpy(ve).to(dtype)}
        return fn
    if cfg.is_enc_dec:
        def fn(dc, step):
            rng = np.random.default_rng(step)
            fr = rng.normal(scale=0.02,
                            size=(dc.global_batch, dc.seq_len, cfg.d_model))
            return {"frames": torch.from_numpy(fr).to(dtype)}
        return fn
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the full published widths and depth")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "paper_sgd"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--overfit-batch", action="store_true",
                    help="train on the first batch at every step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps,
          seq_len=args.seq_len, global_batch=args.global_batch,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          optimizer=args.optimizer, lr=args.lr, log_every=args.log_every,
          seed=args.seed, device=args.device,
          overfit_batch=args.overfit_batch)


if __name__ == "__main__":
    main()
