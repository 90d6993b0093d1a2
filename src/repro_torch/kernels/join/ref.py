"""Plain-torch oracle for the naively partitioned hash join (paper
Algorithm 2).

Semantics: S (small side, build) and L (large side, probe) are int32 key
columns.  For every L[i] that equals some S[j], emit the pair (j, i).  Two
build layouts coexist: the open-addressing table (unique S, the paper's
II=1 fast path) and the sorted-bucket layout (duplicate-capable,
multi-match — ``bucket_build``/``bucket_probe``/``emit_pairs_into``).

Where JAX clamps an out-of-range gather silently, torch raises (or asserts
on the card), so every gather below clips its index explicitly.
"""
from __future__ import annotations

import torch

KNUTH_U32 = 2654435769            # the int32 -1640531527, as unsigned


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _hash(k: torch.Tensor, table_size: int) -> torch.Tensor:
    """Knuth multiplicative hash with int32 wrap-around: the int64 product
    has the same low 32 bits as the wrapped int32 one, and the mask keeps
    only low bits."""
    return ((k.to(torch.int64) * KNUTH_U32) & (table_size - 1)).to(
        torch.int32)


def build_table(s_keys: torch.Tensor, table_size: int, probe_depth: int = 4):
    """Open-addressing table via the paper's sequential build, vectorized:
    slot = hash(k) + probe offset, bounded linear probing, lowest build
    index wins a contested slot.  Returns (ht_keys, ht_vals, placed) with
    EMPTY = -1; keys that exhaust ``probe_depth`` are not placed."""
    if table_size & (table_size - 1):
        raise ValueError(f"table_size {table_size} is not a power of two")
    dev = s_keys.device
    n = s_keys.shape[0]
    ht_keys = torch.full((table_size,), -1, dtype=torch.int32, device=dev)
    ht_vals = torch.full((table_size,), -1, dtype=torch.int32, device=dev)
    placed = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0:
        return ht_keys, ht_vals, placed
    h = _hash(s_keys, table_size)
    taken = torch.zeros(table_size, dtype=torch.bool, device=dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    for depth in range(probe_depth):
        slot = (h + depth) & (table_size - 1)
        cand = torch.where(~placed, slot, table_size).to(torch.int64)
        # who gets each slot: lowest build index wins (scatter-min)
        winner = torch.full((table_size + 1,), n, dtype=torch.int32,
                            device=dev).scatter_reduce(
            0, cand, rows, "amin")[:table_size]
        win_ok = (winner < n) & ~taken
        got = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        got[torch.where(win_ok, winner, n).to(torch.int64)] = True
        safe = winner.clamp(0, n - 1)
        ht_keys = torch.where(win_ok, s_keys[safe], ht_keys)
        ht_vals = torch.where(win_ok, safe, ht_vals)
        taken = taken | win_ok
        placed = placed | got[:n]
    return ht_keys, ht_vals, placed


def probe_ref(ht_keys: torch.Tensor, ht_vals: torch.Tensor,
              l_keys: torch.Tensor, probe_depth: int = 4):
    """Vectorized bounded linear probe — the kernel's exact semantics.
    Returns (s_idx, hit)."""
    ts = ht_keys.shape[0]
    h = _hash(l_keys, ts)
    s_idx = torch.full(l_keys.shape, -1, dtype=torch.int32,
                       device=l_keys.device)
    for depth in range(probe_depth):
        slot = ((h + depth) & (ts - 1)).to(torch.int64)
        hit = (ht_keys[slot] == l_keys) & (s_idx < 0)
        s_idx = torch.where(hit, ht_vals[slot], s_idx)
    return s_idx, s_idx >= 0


# ---- duplicate-capable sorted-bucket table -------------------------------- #

def bucket_build(s_keys: torch.Tensor):
    """Sorted-bucket build: (s_sorted, order) where ``order`` maps sorted
    positions back to build rows.  The sort is stable, so duplicate keys
    land in one bucket in ascending build order."""
    order = torch.argsort(s_keys, stable=True).to(torch.int32)
    return s_keys[order], order


def bucket_probe(s_sorted: torch.Tensor, l_keys: torch.Tensor):
    """Multi-match probe: each probe key's bucket start in the sorted
    build side and its EXACT match count."""
    start = torch.searchsorted(s_sorted, l_keys, side="left")
    end = torch.searchsorted(s_sorted, l_keys, side="right")
    return start.to(torch.int32), (end - start).to(torch.int32)


def emit_pairs_into(l_buf: torch.Tensor, s_buf: torch.Tensor,
                    order: torch.Tensor, start: torch.Tensor,
                    counts: torch.Tensor, *, out_base, l_base=0, s_base=0):
    """Materialize the ragged match lists into a fixed pair-list buffer.

    Pair ``t`` of this probe batch (ordered by probe row, then bucket
    position) lands in slot ``out_base + t`` of ``l_buf``/``s_buf``,
    shifted by ``l_base``/``s_base``.  Output slot t finds its probe row by
    binary search over the exclusive prefix sum of ``counts``; pairs past
    the buffer are dropped (the caller checks ``total``).  Returns
    (l_buf, s_buf, total matches this batch).  Prefix sums run in int64,
    which equals the reference's int32 wherever that does not overflow."""
    n_l = counts.shape[0]
    c64 = counts.to(torch.int64)
    total = c64.sum()
    if n_l == 0:
        return l_buf, s_buf, total
    base = torch.cumsum(c64, 0) - c64                 # exclusive prefix sum
    t = torch.arange(l_buf.shape[0], dtype=torch.int64, device=l_buf.device)
    rel = t - out_base
    i = (torch.searchsorted(base, rel, side="right") - 1).clamp(0, n_l - 1)
    k = rel - base[i]
    valid = (rel >= 0) & (rel < total)
    src = (start.to(torch.int64)[i] + k).clamp(0, order.shape[0] - 1)
    l_buf = torch.where(valid, (i + l_base).to(torch.int32), l_buf)
    s_buf = torch.where(valid, (order[src] + s_base).to(torch.int32), s_buf)
    return l_buf, s_buf, total
