"""End-to-end unique-key hash join (build + probe + materialize).

``hash_join`` is the paper's unique-S fast path (open addressing, at most
one match per probe row).  Its exactness bound is surfaced: the result
carries ``overflowed``, true when the bounded build dropped more keys than
the slow-path buffer can recover (those matches are lost).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ref
from repro_torch.kernels.join.join import DEFAULT_BLOCK

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


def materialize(s_idx: torch.Tensor, l_values: torch.Tensor,
                s_values: torch.Tensor):
    """The paper's materialization: matched (S_out, L_out) columns with -1
    dummies where s_idx == -1."""
    hit = s_idx >= 0
    s_out = torch.where(hit, s_values[s_idx.clamp(min=0)], -1)
    l_out = torch.where(hit, l_values, -1)
    return s_out, l_out
