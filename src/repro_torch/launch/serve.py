"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --no-smoke --prompt-len 2000 --gen-len 32

It runs on the CUDA card unless ``--device`` (``device=``) names another;
the weights are random, drawn from ``--seed`` on the target device with
the reference's init rule, and the prompts from ``--seed + 1``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import registry
from repro_torch.models.common import init_params
from repro_torch.train.train_loop import make_decode_step, make_prefill_step


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(mb, model, prompts: torch.Tensor, gen_len: int, *,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy continuation of ``prompts`` (B, S): the prefill's token and
    ``gen_len - 1`` decoded ones, (B, gen_len).  With ``stats``, the
    prefill's and the decode loop's seconds (host clock around work that
    ends in a synchronize) go into it as ``prefill_s`` and ``decode_s``."""
    if gen_len < 1:
        raise ValueError(f"gen_len must be at least 1, got {gen_len}")
    b, s = prompts.shape
    dev = prompts.device
    caches = registry.make_cache(mb.cfg, b, s + gen_len, dev,
                                 model.embed.dtype)
    prefill = make_prefill_step(mb, model)
    decode = make_decode_step(mb, model)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(prompts, caches)
    tok = torch.argmax(logits[..., :mb.cfg.vocab_size], dim=-1)
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
    out = [tok]
    for i in range(gen_len - 1):
        tok, logits, caches = decode(tok, s + i, caches)
        out.append(tok)
    gen = torch.cat(out, dim=1)
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
    return gen


def serve(arch: str, *, smoke: bool = True, prompt_len: int = 24,
          gen_len: int = 12, batch: int = 4, seed: int = 0,
          device: DeviceLike = None, state_dict: Optional[dict] = None,
          prompts=None, stats: Optional[dict] = None) -> torch.Tensor:
    """Serve ``batch`` prompts of ``prompt_len`` tokens and return the
    greedy tokens (batch, gen_len).  ``state_dict`` and ``prompts``
    replace the drawn weights and prompts (as the tests do to hold the
    port to the reference); ``stats`` receives the timings of
    ``generate``."""
    dev = resolve(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_config(cfg)
    mb, model = build_model(cfg, dev, seed=seed, state_dict=state_dict)
    if prompts is None:
        prompts = draw_prompts(cfg, batch, prompt_len, seed, dev)
    else:
        prompts = torch.as_tensor(prompts, device=dev).long()
    batch, prompt_len = prompts.shape
    t0 = time.perf_counter()
    gen = generate(mb, model, prompts, gen_len, stats=stats)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {dev}: {batch}x{prompt_len} prompt -> "
          f"{batch}x{gen_len} tokens in {dt:.2f}s "
          f"({batch * gen_len / dt:.1f} tok/s)")
    return gen


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


if __name__ == "__main__":
    main()
