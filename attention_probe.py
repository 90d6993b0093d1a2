"""Time the flash-attention kernel (B7) on the card for one checkout of the
port, to compare commits.

    python3 attention_probe.py [--src DIR] [--tag NAME] [--backward]

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

``--backward`` times B7's backward kernel instead (``_launch_backward``,
from the forward kernel's o and lse on the same inputs, 20 calls after
3, CUDA events) at the training shapes of ``chip_smoke.py``'s phase
``lm_kernels``, batch 1: stablelm-3b (4,096 x 32 x 80, causal),
granite-moe (4,096 x 24 of 64 over 8 kv heads, causal), qwen2-vl (4,096
x 28 of 128 over 4 kv heads, masked by Qwen2-VL's positions), whisper's
encoder (1,500 x 20 x 64, non-causal) and cross-attention (416 queries
over 1,500 frames), all in bf16, and stablelm-3b's shape in f32; beside
each, the device ms a call of each of its kernels (the names under
``bwd::``), from ``torch.profiler`` over 5 more calls.
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
# name, sq, sk, h, kv heads, d, type, mask ("causal", "position", "none")
BACKWARD_SHAPES = (
    ("stablelm-3b", 4096, 4096, 32, 32, 80, "bfloat16", "causal"),
    ("granite-moe", 4096, 4096, 24, 8, 64, "bfloat16", "causal"),
    ("qwen2-vl position", 4096, 4096, 28, 4, 128, "bfloat16", "position"),
    ("whisper encoder", 1500, 1500, 20, 20, 64, "bfloat16", "none"),
    ("whisper cross", 416, 1500, 20, 20, 64, "bfloat16", "none"),
    ("stablelm-3b f32", 4096, 4096, 32, 32, 80, "float32", "causal"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernel at the training shapes")
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

    def by_kernel(fn, reps=5):
        """Device ms a call of each kernel named under ``bwd::``."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms_of = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and "bwd::" in e.key:
                name = e.key.split("bwd::", 1)[1].split("<")[0]
                ms_of[name] = ms_of.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / reps
        return ", ".join(f"{n} {t:.4f}" for n, t in sorted(ms_of.items()))

    if args.backward:
        out = []
        for name, sq, sk, h, kvh, d, dt, mask in BACKWARD_SHAPES:
            dtype = getattr(torch, dt)
            q, go = (randn(1, sq, h, d, dtype=dtype) for _ in range(2))
            k, v = (randn(1, sk, kvh, d, dtype=dtype) for _ in range(2))
            pos = None
            if mask == "position":
                i = torch.arange(sq, device=dev)
                pos = torch.where(i < PATCHES, 0, SIDE + i - PATCHES).to(
                    torch.int32)[None].contiguous()
            causal = mask != "none"
            lse = torch.empty((1, h, sq), dtype=torch.float32, device=dev)
            o = fa._launch(q, k, v, causal, pos, pos, lse)
            run = lambda: fa._launch_backward(go, q, k, v, o, lse,  # noqa
                                              causal, pos, pos)
            out.append(f"{name} {ms(run):.4f} ({by_kernel(run)})")
            del q, k, v, go, o, lse
        print(f"[{args.tag}] backward: " + "; ".join(out), flush=True)
        return 0
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
