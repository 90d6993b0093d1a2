"""Scale-out hash join (paper §V) over the plan's engines.

MonetDB's naive partitioning: L is range-partitioned across engines, S's
table is built once per pass and shared by every engine (the paper
replicates it per probe pipeline in URAM).  When S exceeds the on-chip
table capacity the operator probes in multiple passes, rescanning L per S
block — the linear regime of Fig. 8b.  The engines are contiguous shards
of one card, run one after another.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ops as join_ops
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.join.join import DEFAULT_BLOCK

HT_CAPACITY = 8192            # tuples per pass — the paper's URAM budget


def _pad_build(s_keys: torch.Tensor, n_passes: int) -> torch.Tensor:
    """Pad the build side to whole HT_CAPACITY blocks with DISTINCT
    negative sentinels: they sort below every real (non-negative) key, never
    equal a probe key, and keep the keys unique for the open-addressing
    build (a block of identical pads would flood its drop buffer)."""
    pad_s = n_passes * HT_CAPACITY - s_keys.shape[0]
    if not pad_s:
        return s_keys
    pads = -(2 ** 30) - torch.arange(pad_s, dtype=torch.int32,
                                     device=s_keys.device)
    return torch.cat([s_keys, pads])


def _shards(l_keys: torch.Tensor, plan: ChannelPlan) -> int:
    n_eng = plan.n_engines
    if l_keys.shape[0] % n_eng:
        raise ValueError(f"{l_keys.shape[0]} probe rows do not split into "
                         f"{n_eng} engines")
    return l_keys.shape[0] // n_eng


def join_distributed(s_keys: torch.Tensor, l_keys: torch.Tensor,
                     plan: ChannelPlan, *,
                     table_size: int = 4 * HT_CAPACITY,
                     probe_depth: int = 8, block: int = DEFAULT_BLOCK):
    """Unique-key join: s_keys (N_S,) shared, l_keys (N_L,) split over the
    engines.  Returns (s_idx per L position (N_L,), total matches)."""
    n_passes = -(-s_keys.shape[0] // HT_CAPACITY)
    s_keys = _pad_build(s_keys, n_passes)
    shard = _shards(l_keys, plan)
    lines, dropped_max = [], 0
    for eng in range(plan.n_engines):
        l_local = l_keys[eng * shard:(eng + 1) * shard]
        s_idx = torch.full(l_local.shape, -1, dtype=torch.int32,
                           device=l_keys.device)
        for p in range(n_passes):                     # rescan L per S block
            res = join_ops.hash_join(
                s_keys[p * HT_CAPACITY:(p + 1) * HT_CAPACITY], l_local,
                table_size=table_size, probe_depth=probe_depth, block=block)
            s_idx = torch.where((s_idx < 0) & (res.s_idx >= 0),
                                res.s_idx + p * HT_CAPACITY, s_idx)
            dropped_max = max(dropped_max, int(res.dropped))
        lines.append(s_idx)
    if dropped_max > join_ops.MAX_DROPPED:
        warnings.warn(
            f"hash-join build dropped {dropped_max} keys in one pass, more "
            f"than the MAX_DROPPED={join_ops.MAX_DROPPED} slow-path buffer: "
            "overflowing keys match nothing (undercount). Increase "
            "table_size or probe_depth.", RuntimeWarning, stacklevel=2)
    s_idx = torch.cat(lines) if lines else l_keys.new_empty(0)
    return s_idx, (s_idx >= 0).sum()


def join_distributed_multi(s_keys: torch.Tensor, l_keys: torch.Tensor,
                           plan: ChannelPlan, *, max_out_per_shard=None):
    """Duplicate-capable join: s_keys (N_S,) shared (may hold duplicates),
    l_keys (N_L,) split over the engines.  Keys must be non-negative:
    negative values collide with the pass-padding sentinels (the engine
    layer validates this).

    Every engine probes its shard against the sorted-bucket layout of each
    S block (the counts kernel on the card) and materializes its slice
    of the GLOBAL (l_idx, s_idx) pair multiset into a fixed per-engine pair
    list, appending each pass's pairs at a running offset.

    Returns (l_idx (n_engines*max_out,) with GLOBAL probe positions, s_idx
    likewise, per-engine exact pair totals (n_engines,), per-engine
    overflow flags (n_engines,)).  Totals stay exact when a list
    overflows, so callers can re-run with the right capacity."""
    n_s = s_keys.shape[0]
    shard = _shards(l_keys, plan)
    max_out = max_out_per_shard if max_out_per_shard is not None \
        else max(2 * shard, 64)
    n_passes = -(-n_s // HT_CAPACITY) if n_s else 0
    s_keys = _pad_build(s_keys, n_passes)
    builds = [join_ref.bucket_build(
        s_keys[p * HT_CAPACITY:(p + 1) * HT_CAPACITY])
        for p in range(n_passes)]
    dev = l_keys.device
    l_bufs, s_bufs, totals = [], [], []
    for eng in range(plan.n_engines):
        l_local = l_keys[eng * shard:(eng + 1) * shard]
        l_buf = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
        s_buf = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for p, (s_sorted, order) in enumerate(builds):
            start, counts = join_kernels.probe_counts(s_sorted, l_local)
            l_buf, s_buf, t_p = join_ref.emit_pairs_into(
                l_buf, s_buf, order, start, counts, out_base=total,
                l_base=eng * shard, s_base=p * HT_CAPACITY)
            total = total + t_p
        l_bufs.append(l_buf)
        s_bufs.append(s_buf)
        totals.append(total)
    totals = torch.stack(totals)
    return torch.cat(l_bufs), torch.cat(s_bufs), totals, totals > max_out


def join_distributed_multi_result(s_keys: torch.Tensor, l_keys: torch.Tensor,
                                  plan: ChannelPlan, *,
                                  max_out_per_shard=None
                                  ) -> join_ops.MultiJoinResult:
    """``join_distributed_multi`` under the ``MultiJoinResult`` contract of
    the single-device ``hash_join_multi``: the engines' pair slices are
    compacted into one contiguous prefix of the (n_engines * max_out,)
    list, ``total`` is the exact global pair count (the sum of the
    engines' exact totals, right even when a list overflowed) and
    ``overflowed`` is true iff any engine truncated its list."""
    l_buf, s_buf, totals, over = join_distributed_multi(
        s_keys, l_keys, plan, max_out_per_shard=max_out_per_shard)
    keep = l_buf >= 0
    pos = torch.nonzero(keep).flatten()
    l_idx = torch.full_like(l_buf, -1)
    s_idx = torch.full_like(s_buf, -1)
    l_idx[:pos.shape[0]] = l_buf[pos]
    s_idx[:pos.shape[0]] = s_buf[pos]
    return join_ops.MultiJoinResult(l_idx, s_idx, totals.sum(), over.any())
