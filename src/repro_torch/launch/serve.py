"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --no-smoke --prompt-len 2000 --gen-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --smoke --device cpu

It runs on the CUDA card unless ``--device`` (``device=``) names another;
the weights are random, drawn from ``--seed`` on the target device with
the reference's init rule, the prompts from ``--seed + 1`` and, for the
encoder-decoder family, the frame embeddings (``n_audio_frames`` of
them, the conv frontend being a stub) from ``--seed + 2``.  It runs on
the current process group laid out as the host mesh, so the same command
runs under torchrun on several ranks:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m repro_torch.launch.serve --arch llama3-8b --device cpu

Rank 0 prints the mesh, the timing, the tokens and the kernels' launch
counters so far.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get_arch, smoke_config
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    ShardingRules, from_whole, is_sharded, whole,
)
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models import registry
from repro_torch.models.common import distribute, init_params
from repro_torch.train.train_loop import (
    cache_objects, greedy, make_decode_step, make_prefill_step,
)


def build_model(cfg, device: torch.device, *, seed: int = 0,
                state_dict: Optional[dict] = None):
    """(bundle, model) on ``device``: weights from ``state_dict`` when
    given, else drawn from ``seed``."""
    mb = registry.bundle(cfg)
    model = mb.build(device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_params(model, torch.Generator(device=device).manual_seed(seed))
    return mb, model


def draw_prompts(cfg, batch: int, prompt_len: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """The prompts ``serve`` draws: (batch, prompt_len) token ids from
    ``seed + 1`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=g, device=device)


def draw_frames(cfg, batch: int, seed: int, device: torch.device,
                dtype=torch.bfloat16) -> torch.Tensor:
    """The frame embeddings ``serve`` draws for an encoder-decoder: (batch,
    ``cfg.n_audio_frames``, d_model), normal at scale 0.02, from ``seed +
    2`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed + 2)
    return (0.02 * torch.randn(batch, cfg.n_audio_frames, cfg.d_model,
                               generator=g, device=device)).to(dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(mb, model, prompts: torch.Tensor, gen_len: int, *,
             frames: Optional[torch.Tensor] = None,
             stats: Optional[dict] = None,
             rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """Greedy continuation of ``prompts`` (B, S): the prefill's token and
    ``gen_len - 1`` decoded ones, (B, gen_len).  An encoder-decoder takes
    ``frames`` (B, S_enc, d_model), its cross cache made for them.  With
    ``stats``, the prefill's and the decode loop's seconds (host clock
    around work that ends in a synchronize) go into it as ``prefill_s``
    and ``decode_s``.  ``rules`` reach every step; where the model's
    parameters are DTensors laid out by them, the caches are made under
    them (``registry.make_cache(cfg, shape, rules)``: each rank its block),
    the prompts and frames are laid out over the batch, the steps run
    under ``no_grad`` (DTensor's composite ops, such as ``unflatten``, do
    not decompose under ``inference_mode``), and the tokens come back
    whole on every rank."""
    if gen_len < 1:
        raise ValueError(f"gen_len must be at least 1, got {gen_len}")
    sharded = is_sharded(rules, model.embed)
    with torch.no_grad() if sharded else torch.inference_mode():
        b, s = prompts.shape
        dev = prompts.device
        dtype = model.embed.dtype
        if sharded:
            shape = ShapeConfig("serve", s + gen_len, b, "prefill")
            caches = cache_objects(registry.make_cache(
                mb.cfg, shape, rules, dev, dtype), 0)
            prompts = from_whole(prompts, *rules.named("batch", None))
            if frames is not None:
                frames = from_whole(frames,
                                    *rules.named("batch", None, None))
        else:
            caches = registry.make_cache(
                mb.cfg, b, s + gen_len, dev, dtype,
                enc_len=None if frames is None else frames.shape[1])
        inputs = {} if frames is None else {"frames": frames}
        prefill = make_prefill_step(mb, model, rules)
        decode = make_decode_step(mb, model, rules)
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(prompts, caches, **inputs)
        tok = greedy(mb.cfg, logits, rules)
        if stats is not None:
            _sync(dev)
            t1 = time.perf_counter()
            stats["prefill_s"] = t1 - t0
        out = [tok]
        for i in range(gen_len - 1):
            tok, logits, caches = decode(tok, s + i, caches)
            out.append(tok)
        gen = whole(torch.cat(out, dim=1))
        if stats is not None:
            _sync(dev)
            stats["decode_s"] = time.perf_counter() - t1
    return gen


def serve(arch: str, *, smoke: bool = True, prompt_len: int = 24,
          gen_len: int = 12, batch: int = 4, seed: int = 0,
          device: DeviceLike = None, state_dict: Optional[dict] = None,
          prompts=None, frames=None,
          stats: Optional[dict] = None) -> torch.Tensor:
    """Serve ``batch`` prompts of ``prompt_len`` tokens (with frame
    embeddings for an encoder-decoder) and return the greedy tokens
    (batch, gen_len), whole and equal on every rank.  ``state_dict``,
    ``prompts`` and ``frames`` replace the drawn weights, prompts and
    frames (as the tests do to hold the port to the reference);
    ``stats`` receives the timings of ``generate``.

    As the reference's launcher: the process group laid out as the host
    mesh (``make_host_mesh``; a group started here is destroyed on
    return), the rules resolved for ``ShapeConfig("serve", prompt_len +
    gen_len, batch, "prefill")``, and, over more than one rank, the
    parameters held as DTensors laid out by ``init_specs(1)``'s logical
    dims; every rank draws the same weights, prompts and frames and keeps
    its block.  One rank keeps plain tensors (the rules then change
    nothing).  Only rank 0 prints."""
    dev = resolve(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    with process_group(dev) as started:
        mesh = make_host_mesh(dev)
        dev = _on_card(dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        mb, model = build_model(cfg, dev, seed=seed, state_dict=state_dict)
        if prompts is None:
            prompts = draw_prompts(cfg, batch, prompt_len, seed, dev)
        else:
            prompts = torch.as_tensor(prompts, device=dev).long()
        batch, prompt_len = prompts.shape
        shape = ShapeConfig("serve", prompt_len + gen_len, batch, "prefill")
        rules = sharding.resolve(cfg, mesh, shape)
        if world > 1:
            distribute(model, mb.init_specs(1), rules)
        if cfg.is_enc_dec:
            frames = draw_frames(cfg, batch, seed, dev, model.embed.dtype) \
                if frames is None else torch.as_tensor(frames, device=dev)
        if rank == 0:
            print(f"[serve] {mesh_line(mesh, started, dev)}")
        t0 = time.perf_counter()
        gen = generate(mb, model, prompts, gen_len, frames=frames,
                       stats=stats, rules=rules)
        _sync(dev)
        dt = time.perf_counter() - t0
    audio = "" if frames is None else f", {frames.shape[1]} frames"
    if rank == 0:
        print(f"[serve] {cfg.name} on {dev}: {batch}x{prompt_len} prompt"
              f"{audio} -> {batch}x{gen_len} tokens in {dt:.2f}s "
              f"({batch * gen_len / dt:.1f} tok/s)")
        print(f"[serve] tokens {json.dumps(gen.tolist())}")
        print(f"[serve] {launches_line()}")
    return gen


def _on_card(dev: torch.device) -> torch.device:
    """The card ``"cuda"`` names now (after ``make_host_mesh``, this
    rank's), with its index; any other device as it is."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_line(mesh, started: Optional[str], device: torch.device) -> str:
    """What a launcher prints of its mesh: the mesh, this rank's device,
    the group's backend and size, and where the group came from."""
    how = "the caller's" if started is None else f"started from {started}"
    return (f"mesh {tuple(mesh.shape)} over {mesh.mesh_dim_names} on "
            f"{device}: a {dist.get_world_size()}-rank "
            f"{dist.get_backend()} group, {how}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True, help="the reduced same-family config "
                    "(--no-smoke: the full published widths and depth)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, prompt_len=args.prompt_len,
          gen_len=args.gen_len, batch=args.batch, seed=args.seed,
          device=args.device)


def launches_line() -> str:
    """The kernels' launch counters this process has counted so far (on
    the CPU, where the plain versions run, none)."""
    return "kernel launches " + json.dumps(
        {k: n for k, n in _build.LAUNCHES.items() if n})


if __name__ == "__main__":
    main()
