"""Tables of the dry run's results (``build/dryrun_results_torch.json``,
written by ``launch.dryrun``): the roofline and the dry-run table of a
mesh, and the cells a hill-climb would start from.  Run as
``python -m repro_torch.analysis.report [roofline | dryrun MESH | compact
MESH | pick]``."""
from __future__ import annotations

import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_results_torch.json"

_BOTTLENECK_HINTS = {
    ("train", "memory"): "fuse/cast attention+MoE intermediates (bf16 "
                         "softmax path, the flash kernel's backward)",
    ("train", "compute"): "already tensor-core-bound: raise per-card batch or "
                          "cheaper remat policy",
    ("train", "collective"): "shrink grad/activation psums: int8 grad "
                             "compression, reduce-scatter instead of AR",
    ("prefill", "memory"): "larger KV blocks / flash kernel removes masked-"
                           "block traffic",
    ("prefill", "compute"): "causal block skipping (the flash kernel) "
                            "halves score FLOPs",
    ("prefill", "collective"): "keep KV local: shard seq, not heads",
    ("decode", "memory"): "weights+cache streaming bound (expected): "
                          "quantize KV / batch more sequences",
    ("decode", "compute"): "unexpected for decode — check padding waste",
    ("decode", "collective"): "decode psums should be tiny: check cache "
                              "layout",
}


def load(mesh: str = "pod16x16", results: dict | None = None) -> list[dict]:
    """The cells of ``mesh`` in key order, from ``results`` or else the
    results file."""
    res = json.loads(RESULTS.read_text()) if results is None else results
    return [v for k, v in sorted(res.items()) if v["mesh"] == mesh]


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(mesh: str = "pod16x16",
                   results: dict | None = None) -> str:
    rows = ["| arch | shape | t_compute | t_memory | t_collective | bound |"
            " MODEL_FLOPS | useful/HLO | MFU bound | note |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in load(mesh, results):
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | — |"
                        f" — | — | SKIP: {c['reason'][:60]} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | — |"
                        f" — | — | ERROR |")
            continue
        r = c["roofline"]
        kind = ("train" if c["shape"].startswith("train") else
                "prefill" if c["shape"].startswith("prefill") else "decode")
        hint = _BOTTLENECK_HINTS.get((kind, r["bottleneck"]), "")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"**{r['bottleneck']}** | {r['model_flops_global']:.3g} | "
            f"{r['useful_flops_ratio']:.2f} | {r['mfu_bound']*100:.1f}% | "
            f"{hint} |")
    return "\n".join(rows)


def dryrun_table(mesh: str, results: dict | None = None) -> str:
    rows = ["| arch | shape | status | compile | flops/dev | bytes/dev |"
            " coll ops | coll bytes/dev | arg bytes/dev | temp bytes/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in load(mesh, results):
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | {c['status']} | — |"
                        f" — | — | — | — | — | — |")
            continue
        m = c["memory"]
        coll_n = sum(c["collectives"].values())
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok | {c['compile_s']}s | "
            f"{c['flops_per_dev']:.3g} | {c['bytes_per_dev']:.3g} | "
            f"{coll_n} | {c['coll_operand_bytes']:.3g} | "
            f"{(m['argument_bytes'] or 0)/1e9:.2f}GB | "
            f"{(m['temp_bytes'] or 0)/1e9:.2f}GB |")
    return "\n".join(rows)


def compact_table(mesh: str = "pod16x16",
                  results: dict | None = None) -> str:
    """One row an arch, one column a shape: each cell's roofline terms
    t_compute / t_memory / t_collective in ms, its bottleneck and its
    collective operand bytes a device (or skipped / error); the cells of
    ``roofline_table`` in less room."""
    from repro_torch.configs import SHAPES
    cells = load(mesh, results)
    shapes = [s for s in SHAPES if any(c["shape"] == s for c in cells)]
    shapes += [s for s in dict.fromkeys(c["shape"] for c in cells)
               if s not in shapes]
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---|" + "---|" * len(shapes)]
    for arch in sorted({c["arch"] for c in cells}):
        out = []
        for sh in shapes:
            c = next((c for c in cells if c["arch"] == arch
                      and c["shape"] == sh), None)
            if c is None or c["status"] != "ok":
                out.append("—" if c is None else c["status"])
                continue
            r = c["roofline"]
            out.append(f"{r['t_compute'] * 1e3:,.1f} / "
                       f"{r['t_memory'] * 1e3:,.1f} / "
                       f"{r['t_collective'] * 1e3:,.1f} "
                       f"{r['bottleneck'][:4]}, "
                       f"{c['coll_operand_bytes'] / 1e9:.3g} GB")
        rows.append(f"| {arch} | " + " | ".join(out) + " |")
    return "\n".join(rows)


def pick_hillclimb_cells(results: dict | None = None) -> dict:
    """worst MFU-bound train cell, most collective-bound cell, and the cell
    most representative of the paper's technique (the MoE join-analogue)."""
    cells = [c for c in load("pod16x16", results) if c["status"] == "ok"]
    train = [c for c in cells if c["shape"] == "train_4k"]
    worst = min(train, key=lambda c: c["roofline"]["mfu_bound"])
    collective = max(
        cells, key=lambda c: c["roofline"]["t_collective"] /
        max(c["roofline"]["t_compute"] + c["roofline"]["t_memory"], 1e-12))
    moe = [c for c in train if "moe" in c["arch"] or "llama4" in c["arch"]
           or "jamba" in c["arch"]]
    representative = max(moe, key=lambda c: c["roofline"]["t_memory"])
    return {"worst_mfu": f"{worst['arch']}|{worst['shape']}",
            "most_collective": f"{collective['arch']}|{collective['shape']}",
            "paper_representative":
                f"{representative['arch']}|{representative['shape']}"}


if __name__ == "__main__":
    import sys
    what = sys.argv[1] if len(sys.argv) > 1 else "roofline"
    if what == "roofline":
        print(roofline_table())
    elif what == "dryrun":
        print(dryrun_table(sys.argv[2] if len(sys.argv) > 2 else "pod16x16"))
    elif what == "compact":
        print(compact_table(sys.argv[2] if len(sys.argv) > 2 else
                            "pod16x16"))
    elif what == "pick":
        print(json.dumps(pick_hillclimb_cells(), indent=2))
