"""Time the flash-attention kernel (B7) on the card for one checkout of the
port, to compare commits.

    python3 attention_probe.py [--src DIR] [--tag NAME]

One line, ``[NAME]`` and then, for each shape of ``chip_smoke.py``'s
served prefills (llama3-8b: 4 x 2,000 x 32 x 128, GQA 4; qwen2-vl: 28
heads, GQA 7; granite-moe: 24 heads of 64, GQA 3; qwen2-vl's f32 check,
batch 1), the mean milliseconds a call over 20 calls after 3 (CUDA
events) with the causal mask by index and, where the checkout's
wrapper takes positions, masked by Qwen2-VL's positions (256 patches at
one t, the text after them rising) and by positions that rise along
the row (the index mask's function, taken through the position mask).
Inputs are normal, drawn on the card from seed 0.  ``--src`` imports
``repro_torch`` from another checkout's ``src`` (its kernels build into
that checkout), so two commits are compared by running this script
once for each, in turns, in one call.
"""
from __future__ import annotations

import argparse
import inspect
import os
import sys

SHAPES = (("llama3-8b", 4, 32, 8, 128, "bfloat16"),
          ("qwen2-vl", 4, 28, 4, 128, "bfloat16"),
          ("granite-moe", 4, 24, 8, 64, "bfloat16"),
          ("qwen2-vl f32", 1, 28, 4, 128, "float32"))
SEQ, PATCHES, SIDE = 2_000, 256, 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention as fa
    takes_positions = "q_pos" in inspect.signature(
        fa.flash_attention).parameters
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def ms(fn, reps=20, warmup=3):
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

    i = torch.arange(SEQ, device=dev)
    out = []
    for name, b, h, kvh, d, dt in SHAPES:
        dtype = getattr(torch, dt)
        q = randn(b, SEQ, h, d, dtype=dtype)
        k, v = (randn(b, SEQ, kvh, d, dtype=dtype) for _ in range(2))
        out.append(f"{name} index {ms(lambda: fa.flash_attention(q, k, v)):.4f}")
        if takes_positions:
            for label, t in (
                    ("position", torch.where(i < PATCHES, 0,
                                             SIDE + i - PATCHES)),
                    ("rising-as-position", i)):
                t = t.to(torch.int32).expand(b, SEQ).contiguous()
                out.append(f"{name} {label} " + format(ms(
                    lambda: fa.flash_attention(q, k, v, q_pos=t, k_pos=t)),
                    ".4f"))
        del q, k, v
    print(f"[{args.tag}] " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
