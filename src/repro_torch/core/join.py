"""Scale-out hash join (paper §V) over the plan's engines.

MonetDB's naive partitioning: L is range-partitioned across engines, S's
table is built once per pass and shared by every engine (the paper
replicates it per probe pipeline in URAM).  When S exceeds the on-chip
table capacity the operator probes in multiple passes, rescanning L per S
block — the linear regime of Fig. 8b.  The engines are contiguous shards
of one card, run one after another.

``join_shuffle_multi`` is the planner's costed alternative to sharing the
build side: both sides hash-partition into per-shard buckets and each
shard joins its own buckets, so a shard builds only its ~1/n of S.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.distributed import sharding as shardlib
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


def _bucket_cap(n_rows: int, n_shards: int) -> int:
    """Default per-shard bucket capacity for one shuffled side: twice the
    uniform-hash expectation plus slack, so typical skew fits without a
    retry.  The shuffle's exact counts size the retry when it does not."""
    return 2 * (-(-n_rows // n_shards)) + 64 if n_rows else 64


def _round_build_cap(cap: int) -> int:
    """A build bucket above one pass holds a whole number of HT_CAPACITY
    blocks: the pass loop slices fixed blocks."""
    return cap if cap <= HT_CAPACITY else -(-cap // HT_CAPACITY) * HT_CAPACITY


def join_shuffle_multi(s_keys: torch.Tensor, l_keys: torch.Tensor,
                       layout: "shardlib.ShardLayout", *, s_cap=None,
                       l_cap=None, max_out_per_shard=None):
    """Shuffle-repartitioned duplicate-capable join.

    Both sides are hash-partitioned by ``shardlib.hash_shard`` into fixed-
    capacity per-shard buckets carrying their global row ids.  Each shard
    then runs the sorted-bucket multi-pass join on its own buckets:
    ``ceil(s_cap / HT_CAPACITY)`` passes, each a bucket build of one
    block, the counts kernel over the shard's whole probe bucket, and the
    pairs emitted at the running offset.  Matching keys hash to one
    shard, so the union of the shards' pair multisets is the global join.
    The shards run one after another on the card, so the counts kernel
    launches ``n_shards * passes`` times.

    Build pads are distinct sentinels ``-(2**30) - i`` (the bucket build
    needs them distinct and below every real key); probe pads are -1,
    which match nothing.

    Returns ``(l_idx, s_idx, totals, pair_overflow, shuffle)``: flat
    (n_shards * max_out_per_shard,) pair lists of global row ids (-1
    padding, each shard's slice contiguous), the shards' exact pair
    totals, their truncation flags, and ``shuffle = (s_counts, l_counts,
    overflowed)``, the exact per-shard shuffle cardinalities; if
    ``overflowed``, bucket rows were dropped and the caller retries with
    the measured capacities."""
    n = layout.n_shards
    n_s, n_l = s_keys.shape[0], l_keys.shape[0]
    dev = l_keys.device
    s_cap = _round_build_cap(s_cap if s_cap is not None
                             else _bucket_cap(n_s, n))
    l_cap = l_cap if l_cap is not None else _bucket_cap(n_l, n)
    max_out = max_out_per_shard if max_out_per_shard is not None \
        else max(2 * l_cap, 64)

    def arange(k):
        return torch.arange(k, dtype=torch.int32, device=dev)

    s_fill = (-(2 ** 30) - arange(n * s_cap)).reshape(n, s_cap)
    (s_bkeys, s_bids), s_counts, s_over = shardlib.partition_to_shards(
        shardlib.hash_shard(s_keys, n), (s_keys, arange(n_s)), n, s_cap,
        (s_fill, torch.full((n, s_cap), -1, dtype=torch.int32,
                            device=dev)))
    l_fill = torch.full((n, l_cap), -1, dtype=torch.int32, device=dev)
    (l_bkeys, l_bids), l_counts, l_over = shardlib.partition_to_shards(
        shardlib.hash_shard(l_keys, n), (l_keys, arange(n_l)), n, l_cap,
        (l_fill, l_fill))

    n_passes = -(-s_cap // HT_CAPACITY)
    blk = min(HT_CAPACITY, s_cap)
    l_bufs, s_bufs, totals = [], [], []
    for shard in range(n):
        s_local, l_local = s_bkeys[shard], l_bkeys[shard]
        l_buf = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
        s_buf = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for p in range(n_passes):         # rescan the shard's probe bucket
            s_sorted, order = join_ref.bucket_build(
                s_local[p * blk:(p + 1) * blk])
            start, counts = join_kernels.probe_counts(s_sorted, l_local)
            # emitted indices are bucket positions into the flat (n * cap,)
            # shuffled id arrays; global ids are gathered below
            l_buf, s_buf, t_p = join_ref.emit_pairs_into(
                l_buf, s_buf, order, start, counts, out_base=total,
                l_base=shard * l_cap, s_base=shard * s_cap + p * blk)
            total = total + t_p
        l_bufs.append(l_buf)
        s_bufs.append(s_buf)
        totals.append(total)
    l_buf, s_buf = torch.cat(l_bufs), torch.cat(s_bufs)
    totals = torch.stack(totals)
    valid = l_buf >= 0
    l_idx = torch.where(valid, l_bids.reshape(-1)[l_buf.clamp(min=0)], -1)
    s_idx = torch.where(valid, s_bids.reshape(-1)[s_buf.clamp(min=0)], -1)
    return (l_idx, s_idx, totals, totals > max_out,
            (s_counts, l_counts, s_over | l_over))
