"""Time the flash-attention kernel (B7) and the SSD scan's backward (B8's
gradient) on the card for one checkout of the port, to compare commits.

    python3 attention_probe.py [--src DIR] [--tag NAME]
        [--backward [--dtype TYPE] [--split auto|loop|split] [--errors]]
        [--ssd [--dtype TYPE]]

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
over 1,500 frames), each in bf16 and in f32; beside each, the device ms
a call of each of its kernels (the names under ``bwd::``), from
``torch.profiler`` over 5 more calls.  ``--dtype`` keeps the shapes of
one type; ``--split`` makes every GQA shape take the group loop or the
split by q head in dK / dV (``_splits_group``; ``auto`` leaves the
wrapper's rule); ``--errors`` adds, for each shape, the worst error of
dq, dk and dv as a share of that gradient's largest magnitude, against
``plain_backward`` (f32 scores) and against autograd of the same
function in f64.

``--ssd`` times B8's backward instead: for mamba2-780m's training step
(x 4 x 4,096 x 48 x 64 bf16, b and c 4 x 4,096 x 1 x 128, chunk 128, gh
absent) and jamba's widths (x 4 x 4,096 x 128 x 64, b and c ds 16), the
mean milliseconds of ``_scan_backward`` over 20 calls after 3 (CUDA
events), each of its passes (``BACKWARD_PASSES``) alone on the same
buffers (``run_backward_passes``), and the chunk pass's blocks an SM and
shared bytes a block (``backward_occupancy``); where the checkout's
chunk pass runs in clusters of heads, also its cluster, the clusters the
card holds at once (``backward_clusters``) and the whole backward with
clusters of 8, 4, 2 and 1 heads in turns (8, 4, 2, 1, 1, 2, 4, 8), those
the checkout's route takes.  Its inputs are drawn in Mamba-2's init
ranges (dt in [0.001, 0.1], A in [1, 16]).  With ``--dtype float32`` it
times the CUDA-core route instead, in f32 at ``SSD_F32_SHAPES``: the f32
training check's step (x 1 x 256 x 48 x 64, b and c 1 x 256 x 1 x 128)
and mamba2-780m's and jamba's widths at 1 x 4,096.
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
    ("stablelm-3b f32", 4096, 4096, 32, 32, 80, "float32", "causal"),
    ("granite-moe f32", 4096, 4096, 24, 8, 64, "float32", "causal"),
    ("qwen2-vl position f32", 4096, 4096, 28, 4, 128, "float32",
     "position"),
    ("whisper encoder f32", 1500, 1500, 20, 20, 64, "float32", "none"),
    ("whisper cross f32", 416, 1500, 20, 20, 64, "float32", "none"))
# B8's backward: name, batch, heads, head dim, groups, state
SSD_SHAPES = (("mamba2-780m train", 4, 48, 64, 1, 128),
              ("jamba widths", 4, 128, 64, 1, 16))
SSD_SEQ, SSD_CHUNK = 4_096, 128
# (name, batch, length, heads, hd, groups, ds) of the f32 rows
SSD_F32_SHAPES = (("f32 check", 1, 256, 48, 64, 1, 128),
                  ("mamba2-780m f32", 1, SSD_SEQ, 48, 64, 1, 128),
                  ("jamba f32", 1, SSD_SEQ, 128, 64, 1, 16))


def attention_f64(q, k, v, causal, q_pos, k_pos):
    """``ref.attention_plain``'s function with every operation in f64."""
    import torch
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * d ** -0.5
    if causal:
        keep = (torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
                if q_pos is None else
                q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :])
        scores = torch.where(keep, scores, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v) / p.sum(-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def backward_f64(go, q, k, v, causal, q_pos, k_pos):
    """(dq, dk, dv) of ``attention_f64`` in f64, a kv head at a time."""
    import torch
    g = q.shape[2] // k.shape[2]
    out = [torch.empty(t.shape, dtype=torch.float64, device=t.device)
           for t in (q, k, v)]
    for hk in range(k.shape[2]):
        qh, kh = slice(hk * g, (hk + 1) * g), slice(hk, hk + 1)
        parts = [t[:, :, sl].double().requires_grad_()
                 for t, sl in ((q, qh), (k, kh), (v, kh))]
        with torch.enable_grad():
            o = attention_f64(*parts, causal, q_pos, k_pos)
            grads = torch.autograd.grad(o, parts, go[:, :, qh].double())
        for dst, sl, grad in zip(out, (qh, kh, kh), grads):
            dst[:, :, sl] = grad
    return out


def worst(got, want):
    """The largest of max |got - want| / max |want| over the gradients."""
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernel at the training shapes")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="with --backward: the shapes of this type only;"
                    " with --ssd: float32 times the f32 rows")
    ap.add_argument("--split", choices=("auto", "loop", "split"),
                    default="auto",
                    help="with --backward: force the GQA path of dK / dV")
    ap.add_argument("--errors", action="store_true",
                    help="with --backward: the worst error of each shape")
    ap.add_argument("--ssd", action="store_true",
                    help="time B8's backward and its passes")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device is available", file=sys.stderr)
        return 2
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

    if args.ssd:
        return ssd_backward(args.tag, dev, g, ms, args.dtype or "bfloat16")
    from repro_torch.kernels.flash_attention import flash_attention as fa
    if args.split != "auto":
        forced = args.split == "split"
        fa._splits_group = lambda device, b, h, kvh, *rest: forced and \
            h != kvh
    takes_positions = "q_pos" in inspect.signature(
        fa.flash_attention).parameters
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
            if args.dtype not in (None, dt):
                continue
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
            row = f"{name} {ms(run):.4f} ({by_kernel(run)}"
            if args.errors:
                got = run()
                plain = fa.plain_backward(q, k, v, go, causal=causal,
                                          q_pos=pos, k_pos=pos)
                exact = backward_f64(go, q, k, v, causal, pos, pos)
                row += (f"; worst error {worst(got, plain):.3e} against "
                        f"plain_backward, {worst(got, exact):.3e} against "
                        f"f64; plain_backward {worst(plain, exact):.3e} "
                        "against f64")
                del got, plain, exact
            out.append(row + ")")
            del q, k, v, go, o, lse
            torch.cuda.empty_cache()
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


def ssd_backward(tag, dev, g, ms, dtype) -> int:
    """B8's backward at ``SSD_SHAPES`` (bf16) or ``SSD_F32_SHAPES``
    (float32): the whole, each pass, occupancy, clusters."""
    import torch
    from repro_torch.kernels.ssd import ssd as ssd_kernels
    dtype = getattr(torch, dtype)

    def randn(*shape, dtype=dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    shapes = SSD_F32_SHAPES if dtype == torch.float32 else tuple(
        (name, bsz, SSD_SEQ, nh, hd, ng, ds)
        for name, bsz, nh, hd, ng, ds in SSD_SHAPES)
    out = []
    for name, bsz, seq, nh, hd, ng, ds in shapes:
        ins = (randn(bsz, seq, nh, hd),
               uniform(0.001, 0.1, bsz, seq, nh),
               torch.log(uniform(1.0, 16.0, nh)),
               randn(bsz, seq, ng, ds), randn(bsz, seq, ng, ds),
               randn(nh, dtype=torch.float32))
        gy = randn(bsz, seq, nh, hd)
        whole = ms(lambda: ssd_kernels._scan_backward(*ins, gy, None,
                                                      SSD_CHUNK))
        bufs = ssd_kernels.backward_buffers(ins[0], ins[3], SSD_CHUNK)

        def one(p):
            return ms(lambda: ssd_kernels.run_backward_passes(
                *ins, gy, None, bufs=bufs, chunk=SSD_CHUNK, passes=(p,)))
        passes = ", ".join(f"{p} {one(p):.4f}"
                           for p in ssd_kernels.BACKWARD_PASSES)
        occ = ssd_kernels.backward_occupancy(dtype, hd, ds, SSD_CHUNK)
        extra = ""
        if hasattr(ssd_kernels, "backward_cluster"):
            cl = ssd_kernels.backward_cluster(dtype, hd, ds, nh, ng)
            cbufs = {}
            for c in (8, 4, 2, 1):
                if (nh // ng) % c == 0:
                    try:
                        cbufs[c] = ssd_kernels.backward_buffers(
                            ins[0], ins[3], SSD_CHUNK, cluster=c)
                    except ValueError:      # not on this checkout's route
                        pass
            sizes = list(cbufs)
            turns = {c: [] for c in sizes}
            for c in sizes + sizes[::-1]:
                turns[c].append(ms(
                    lambda c=c: ssd_kernels.run_backward_passes(
                        *ins, gy, None, bufs=cbufs[c], chunk=SSD_CHUNK,
                        cluster=c)))
            resident = [ssd_kernels.backward_clusters(dtype, hd, ds,
                                                      SSD_CHUNK, c)
                        for c in sizes]
            at_once = ", ".join(f"{n} of {c}"
                                for c, n in zip(sizes, resident))
            extra = (f", clusters of {cl}, {at_once} at once; in turns "
                + ", ".join(f"C={c} " + " / ".join(f"{t:.4f}" for t in v)
                            for c, v in turns.items()))
            del cbufs
        out.append(f"{name} {whole:.4f} ({passes}; states pass "
                   f"{occ['states'][0]} block(s) an SM, {occ['states'][1]} "
                   f"shared bytes; chunk pass {occ['chunk'][0]} block(s) an "
                   f"SM, {occ['chunk'][1]} shared bytes{extra})")
        del ins, gy, bufs
        torch.cuda.empty_cache()
    print(f"[{tag}] ssd backward {dtype}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
