"""End-to-end hash joins (build + probe + materialize).

* ``hash_join`` — the paper's unique-S fast path (open addressing, at most
  one match per probe row).  Its exactness bound is surfaced: the result
  carries ``overflowed``, true when the bounded build dropped more keys
  than the slow-path buffer can recover (those matches are lost).
* ``hash_join_multi`` — duplicate-capable multi-match join over the
  sorted-bucket layout.  Emits the exact multiset of (l_idx, s_idx) pairs
  as a fixed-capacity pair list; ``total`` is always the exact pair count,
  ``overflowed`` flags a truncated list (first ``max_out`` pairs kept, in
  (probe row, bucket position) order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ref
from repro_torch.kernels.join.join import DEFAULT_BLOCK, DEFAULT_MATCH_CAP

MAX_DROPPED = 256     # slow-path buffer for keys the bounded build dropped
_DROP_FILL = -(2 ** 30)
_SLOW_PATH_ROWS = 1 << 20      # probe rows compared per slow-path chunk


class JoinResult(NamedTuple):
    """Unique-S join output: one line per probe row."""
    s_idx: torch.Tensor       # (N_L,) matched build index or -1
    total: torch.Tensor       # scalar: number of matches found
    dropped: torch.Tensor     # scalar: build keys the bounded build dropped
    overflowed: torch.Tensor  # scalar bool: dropped > MAX_DROPPED — matches
                              # for the excess keys were LOST


class MultiJoinResult(NamedTuple):
    """Multi-match join output: a (l_idx, s_idx) pair list."""
    l_idx: torch.Tensor       # (max_out,) probe-side row or -1 padding
    s_idx: torch.Tensor       # (max_out,) build-side row or -1 padding
    total: torch.Tensor       # scalar: EXACT pair count (even if > max_out)
    overflowed: torch.Tensor  # scalar bool: total > max_out (list truncated)


def hash_join(s_keys: torch.Tensor, l_keys: torch.Tensor, *,
              table_size: int, probe_depth: int = 4,
              block: int = DEFAULT_BLOCK) -> JoinResult:
    """Naively-partitioned hash join (Algorithm 2), unique S.

    The build is the vectorized sequential-equivalent build; the probe is
    the accelerated phase (the hash-probe kernel on the card).  Keys the
    bounded build could not place take a direct-compare side path, so the
    join is exact up to MAX_DROPPED drops; beyond that ``overflowed`` is
    set."""
    ht_keys, ht_vals, placed = ref.build_table(s_keys, table_size,
                                               probe_depth)
    s_idx, _ = join_kernels.probe(ht_keys, ht_vals, l_keys, block=block,
                                  probe_depth=probe_depth)

    dropped = (~placed).sum()
    # slow path: up to MAX_DROPPED unplaced keys, compared directly.  With
    # nothing dropped the buffer holds only fill keys whose values are -1,
    # so skipping it leaves s_idx exactly as the full comparison would
    if int(dropped):
        n_s = s_keys.shape[0]
        dev = s_keys.device
        unplaced = ~placed
        drop_rank = torch.cumsum(unplaced.to(torch.int64), 0) - 1
        # overflow beyond MAX_DROPPED goes to the trash slot (sliced off)
        slot = torch.where(unplaced & (drop_rank < MAX_DROPPED), drop_rank,
                           MAX_DROPPED)
        drop_keys = torch.full((MAX_DROPPED + 1,), _DROP_FILL,
                               dtype=torch.int32, device=dev)
        drop_vals = torch.full((MAX_DROPPED + 1,), -1, dtype=torch.int32,
                               device=dev)
        order = torch.arange(n_s, dtype=torch.int32, device=dev)
        keep = slot < MAX_DROPPED
        drop_keys[slot[keep]] = s_keys[keep]
        drop_vals[slot[keep]] = order[keep]
        drop_keys, drop_vals = drop_keys[:MAX_DROPPED], drop_vals[:MAX_DROPPED]
        parts = []
        for lo in range(0, l_keys.shape[0], _SLOW_PATH_ROWS):
            lk = l_keys[lo:lo + _SLOW_PATH_ROWS]
            eq = lk[:, None] == drop_keys[None, :]       # (rows, MAX_DROPPED)
            which = torch.argmax(eq.to(torch.int8), dim=1)
            cur = s_idx[lo:lo + _SLOW_PATH_ROWS]
            parts.append(torch.where((cur < 0) & eq.any(dim=1),
                                     drop_vals[which], cur))
        if parts:
            s_idx = torch.cat(parts)

    total = (s_idx >= 0).sum()
    return JoinResult(s_idx, total, dropped, dropped > MAX_DROPPED)


def hash_join_multi(s_keys: torch.Tensor, l_keys: torch.Tensor, *,
                    max_out: int,
                    cap: int = DEFAULT_MATCH_CAP) -> MultiJoinResult:
    """Duplicate-capable multi-match join: the exact (l_idx, s_idx) pair
    multiset of ``s_keys ⋈ l_keys``, materialized into a (max_out,) pair
    list ordered by (probe row, bucket position).

    The multi-match probe (the kernel on the card, its plain version on
    the CPU) emits up to ``cap`` matches per probe row; the overflow pass
    of ``_assemble_capped`` materializes the tail of longer chains, so the
    cap is a bus width, not a correctness limit.  The probe's padding is
    virtual and clamped, so every int32 key joins exactly."""
    n_s, n_l = s_keys.shape[0], l_keys.shape[0]
    if n_s == 0 or n_l == 0:
        empty = torch.full((max_out,), -1, dtype=torch.int32,
                           device=l_keys.device)
        return MultiJoinResult(
            empty, empty.clone(),
            torch.zeros((), dtype=torch.int64, device=l_keys.device),
            torch.zeros((), dtype=torch.bool, device=l_keys.device))
    s_sorted, order = ref.bucket_build(s_keys)
    mat, start, counts = join_kernels.probe_multi(s_sorted, order, l_keys,
                                                  cap=cap)
    l_idx, s_idx, total = _assemble_capped(mat, order, start, counts,
                                           max_out, cap)
    return MultiJoinResult(l_idx, s_idx, total, total > max_out)


def _assemble_capped(mat: torch.Tensor, order: torch.Tensor,
                     start: torch.Tensor, counts: torch.Tensor,
                     max_out: int, cap: int):
    """Pair list from the probe's capped egress plus an overflow pass.

    In-cap matches scatter straight from the (N_L, cap) matrix to their
    global pair rank; chains longer than the cap get their tail
    materialized by a gather over the residual counts.  Writes that fall
    past ``max_out`` land in a trash slot that is sliced off.  Prefix sums
    run in int64 (the reference's are int32; equal wherever that does not
    overflow).  Returns (l_idx, s_idx, exact total)."""
    dev = counts.device
    n_l = counts.shape[0]
    c64 = counts.to(torch.int64)
    base = torch.cumsum(c64, 0) - c64
    total = c64.sum()
    rows = torch.arange(n_l, dtype=torch.int32, device=dev)
    l_buf = torch.full((max_out + 1,), -1, dtype=torch.int32, device=dev)
    s_buf = torch.full((max_out + 1,), -1, dtype=torch.int32, device=dev)
    for k in range(cap):                               # in-cap egress lines
        pos = base + k
        ok = (k < c64) & (pos < max_out)
        tpos = torch.where(ok, pos, max_out)
        l_buf[tpos] = torch.where(ok, rows, -1)
        s_buf[tpos] = torch.where(ok, mat[:, k], -1)
    # overflow pass: ragged chain tails (match k >= cap)
    res = (c64 - cap).clamp(min=0)
    rbase = torch.cumsum(res, 0) - res
    rtotal = res.sum()
    t = torch.arange(max_out, dtype=torch.int64, device=dev)
    i = (torch.searchsorted(rbase, t, right=True) - 1).clamp(0, n_l - 1)
    k2 = t - rbase[i]
    pos = base[i] + cap + k2
    src = (start.to(torch.int64)[i] + cap + k2).clamp(0, order.shape[0] - 1)
    ok = (t < rtotal) & (pos < max_out)
    tpos = torch.where(ok, pos, max_out)
    l_buf[tpos] = torch.where(ok, i.to(torch.int32), -1)
    s_buf[tpos] = torch.where(ok, order[src], -1)
    return l_buf[:max_out], s_buf[:max_out], total


def materialize(s_idx: torch.Tensor, l_values: torch.Tensor,
                s_values: torch.Tensor):
    """The paper's materialization: matched (S_out, L_out) columns with -1
    dummies where s_idx == -1."""
    hit = s_idx >= 0
    s_out = torch.where(hit, s_values[s_idx.clamp(min=0)], -1)
    l_out = torch.where(hit, l_values, -1)
    return s_out, l_out


def materialize_pairs(l_idx: torch.Tensor, s_idx: torch.Tensor,
                      l_values: torch.Tensor, s_values: torch.Tensor):
    """Multi-match materialization: gather the value columns for a pair
    list (the BAT-pair contract), -1 where the list is padding."""
    hit = l_idx >= 0
    l_out = torch.where(hit, l_values[l_idx.clamp(min=0)], -1)
    s_out = torch.where(hit, s_values[s_idx.clamp(min=0)], -1)
    return l_out, s_out
