"""Time the context-parallel decode's local part on the card by step, on
each side of 2**31 elements of k and v.

    python3 cp_probe.py

For 262,144, 524,287 and 524,288 positions of 32 heads of 128 in bf16
(jamba-v0.1-52b's widths; 524,288 is the reference's long_500k, where k
and v hold 2**31 elements each), all positions valid, batch 1: the
mean milliseconds a call over 5 calls after 1 (CUDA events) of
``context_parallel.cp_local`` and of its steps alone: the f32 cast of k,
the scores einsum over the f32 k, and the output einsum of p (1, 32, 1,
S) f32 over the f32 v.  Inputs are normal, drawn on the card from seed
0.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

SEQS = (262_144, 524_287, 524_288)
HEADS, HEAD_DIM = 32, 128
REPS = 5


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cp_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.distributed import context_parallel as cp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / REPS

    for s in SEQS:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((1, HEADS, 1, HEAD_DIM),
                                 (1, s, HEADS, HEAD_DIM),
                                 (1, s, HEADS, HEAD_DIM)))
        valid = torch.ones(1, s, dtype=torch.bool, device=dev)
        qf, kf, vf = q.float(), k.float(), v.float()
        p = torch.softmax(torch.einsum("bhqd,bkhd->bhqk", qf, kf), -1)
        n = k.numel()
        print(f"S {s:,} ({n:,} elements, {'>=' if n >= 2 ** 31 else '<'} "
              f"2**31): cp_local {ms(lambda: cp.cp_local(q, k, v, valid)):.3f}"
              f" ms; k.float() {ms(lambda: k.float()):.3f} ms; scores "
              f"einsum {ms(lambda: torch.einsum('bhqd,bkhd->bhqk', qf, kf)):.3f}"
              f" ms; output einsum "
              f"{ms(lambda: torch.einsum('bhqk,bkhd->bhqd', p, vf)):.3f} ms",
              flush=True)
        del q, k, v, valid, qf, kf, vf, p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
