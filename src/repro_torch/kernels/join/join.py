"""Hash-join probe kernels (paper §V, Figs. 7-8) — wrappers and plain
versions.

Two CUDA kernels (``kernels/csrc/join.cu``) replace the TPU's Pallas
probes on the executor's path:

* ``probe_counts`` (replaces ``probe_counts_pallas``): bucket (start,
  count) of every probe key over the sorted build side: a branchless
  lower-bound search down a breadth-first search tree in shared memory,
  then the end of the key's run from there.  ``probe_counts_route``
  picks the route from the table's length: a table of at most
  ``SHARED_TABLE_MAX`` keys is held whole, a larger one (a pipeline's
  whole build side) is searched through a tree of ``SAMPLE_KEYS`` of its
  keys and then in device memory.  Its plain version is
  ``ref.bucket_probe``; the kernel equals it for every int32 key (the
  TPU kernel padded the table with ``2**31 - 1`` and so miscounted that
  key; the kernel's padding is clamped).
* ``probe_multi`` (replaces ``probe_multi_pallas``): the same bucket
  (start, count), found by the same search on the same two routes
  (``probe_multi_route``), plus an (N_L, cap) matrix of the bucket's
  first ``cap`` build rows (through ``order``), -1 past the count — the
  widened egress bus of ``ops.hash_join_multi``, whose overflow pass
  completes longer chains.  Its plain version is ``probe_multi_plain``.
* ``probe`` (replaces ``probe_pallas``): the open-addressing probe of the
  paper's unique-key fast path, four rows a thread with their slot
  windows loaded together.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors.  The kernels mask their ragged tails, so unlike
the TPU kernels any probe length is accepted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.join import ref

DEFAULT_BLOCK = 4096
DEFAULT_MATCH_CAP = 8          # egress lines per probe row (B3)
# B2's routes (kSharedMax and kSample in csrc/join.cu): a table of up to
# 8,192 keys, padded to its power of two, and its search tree take 64 KB of
# shared memory, which leaves room for three blocks an SM; a larger one is
# searched through a tree of 8,192 of its keys (32 KB), then in device
# memory
SHARED_TABLE_MAX = 8_192
SAMPLE_KEYS = 8_192


# ---- B2: counts-only multi-match probe ------------------------------------ #

def probe_counts_route(n_s: int) -> str:
    """The B2 route for a table of ``n_s`` sorted keys: ``"shared"`` (the
    whole table in shared memory) or ``"sampled"``."""
    return "shared" if max(n_s, 4) <= SHARED_TABLE_MAX else "sampled"


# B3 searches with B2's code, so it takes B2's routes
probe_multi_route = probe_counts_route


def _search_args(n_s: int, device):
    """The padded length and, for the sampled route, the search tree's
    scratch (which the kernel builds) that both bucket probes pass."""
    tree = None if probe_counts_route(n_s) == "shared" else torch.empty(
        SAMPLE_KEYS, dtype=torch.int32, device=device)
    return 1 << (max(n_s, 4) - 1).bit_length(), tree


def probe_counts(s_sorted: torch.Tensor, l_keys: torch.Tensor):
    """(start (N_L,), counts (N_L,)) of each probe key's bucket in the
    sorted build side, as ``ref.bucket_probe`` gives them; counts are
    exact."""
    if l_keys.device.type == "cpu":
        return ref.bucket_probe(s_sorted, l_keys)
    _build.require_int32_cuda(s_sorted, "s_sorted")
    _build.require_int32_cuda(l_keys, "l_keys")
    if s_sorted.device != l_keys.device:
        raise ValueError("s_sorted and l_keys are on different devices")
    n_s, n = s_sorted.shape[0], l_keys.shape[0]
    if n_s >= 2 ** 31 - 1:
        raise ValueError(f"build side of {n_s} rows: positions are int32")
    start = torch.empty_like(l_keys)
    count = torch.empty_like(l_keys)
    if n == 0:
        return start, count
    ts, tree = _search_args(n_s, l_keys.device)
    fn = _build.function("probe_counts_i32")
    rc = fn(s_sorted.data_ptr(), n_s, ts, l_keys.data_ptr(), n,
            start.data_ptr(), count.data_ptr(),
            None if tree is None else tree.data_ptr(),
            _build.stream_handle(l_keys.device))
    _build.check(rc, "probe_counts_i32")
    _build.LAUNCHES["probe_counts" if tree is None
                    else "probe_counts_sampled"] += 1
    return start, count


# ---- B3: multi-match probe with a capped egress matrix -------------------- #

def probe_multi_plain(s_sorted: torch.Tensor, order: torch.Tensor,
                      l_keys: torch.Tensor, *, cap: int = DEFAULT_MATCH_CAP):
    """Plain version of the multi-match probe: ``ref.bucket_probe``, then
    the first ``cap`` build rows of each bucket gathered through
    ``order``, -1 past the count.  Returns (mat (N_L, cap), start, count)."""
    start, count = ref.bucket_probe(s_sorted, l_keys)
    ks = torch.arange(cap, dtype=torch.int32, device=l_keys.device)
    hit = ks[None, :] < count[:, None]
    if s_sorted.shape[0] == 0:
        mat = torch.full(hit.shape, -1, dtype=torch.int32,
                         device=l_keys.device)
    else:
        src = (start[:, None] + ks[None, :]).clamp(0, s_sorted.shape[0] - 1)
        mat = torch.where(hit, order[src.to(torch.int64)], -1)
    return mat, start, count


def probe_multi(s_sorted: torch.Tensor, order: torch.Tensor,
                l_keys: torch.Tensor, *, cap: int = DEFAULT_MATCH_CAP):
    """(mat (N_L, cap), start (N_L,), count (N_L,)) of each probe key over
    the sorted build side through the CUDA kernel (plain version on CPU);
    counts are exact even past ``cap``.  (start, count) equal
    ``probe_counts``' bit for bit: the kernels share their search."""
    if l_keys.device.type == "cpu":
        return probe_multi_plain(s_sorted, order, l_keys, cap=cap)
    for t, name in ((s_sorted, "s_sorted"), (order, "order"),
                    (l_keys, "l_keys")):
        _build.require_int32_cuda(t, name)
        if t.device != l_keys.device:
            raise ValueError(f"{name} is on {t.device}, l_keys on "
                             f"{l_keys.device}")
    n_s, n = s_sorted.shape[0], l_keys.shape[0]
    if order.shape[0] != n_s:
        raise ValueError(f"order has {order.shape[0]} entries, the table "
                         f"{n_s}")
    if n_s >= 2 ** 31 - 1:
        raise ValueError(f"build side of {n_s} rows: positions are int32")
    if not 0 < cap < 2 ** 31:
        raise ValueError(f"cap must be positive, got {cap}")
    mat = torch.empty((n, cap), dtype=torch.int32, device=l_keys.device)
    start = torch.empty_like(l_keys)
    count = torch.empty_like(l_keys)
    if n == 0:
        return mat, start, count
    ts, tree = _search_args(n_s, l_keys.device)
    fn = _build.function("probe_multi_i32")
    rc = fn(s_sorted.data_ptr(), order.data_ptr(), n_s, ts,
            l_keys.data_ptr(), n, cap, mat.data_ptr(), start.data_ptr(),
            count.data_ptr(), None if tree is None else tree.data_ptr(),
            _build.stream_handle(l_keys.device))
    _build.check(rc, "probe_multi_i32")
    _build.LAUNCHES["probe_multi" if tree is None
                    else "probe_multi_sampled"] += 1
    return mat, start, count


# ---- B4: open-addressing unique-key probe --------------------------------- #

def probe_plain(ht_keys: torch.Tensor, ht_vals: torch.Tensor,
                l_keys: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                probe_depth: int = 4):
    """Plain version of the hash-probe kernel: (s_idx (N_L,) with -1 for
    misses, per-block match counts (ceil(N_L/block),))."""
    s_idx, hit = ref.probe_ref(ht_keys, ht_vals, l_keys, probe_depth)
    n = l_keys.shape[0]
    nb = -(-n // block)
    padded = torch.zeros(nb * block, dtype=torch.int32, device=hit.device)
    padded[:n] = hit
    return s_idx, padded.view(nb, block).sum(dim=1, dtype=torch.int32)


def probe(ht_keys: torch.Tensor, ht_vals: torch.Tensor, l_keys: torch.Tensor,
          *, block: int = DEFAULT_BLOCK, probe_depth: int = 4):
    """Probe L against the open-addressing table through the CUDA kernel
    (plain version on CPU)."""
    if l_keys.device.type == "cpu":
        return probe_plain(ht_keys, ht_vals, l_keys, block=block,
                           probe_depth=probe_depth)
    for t, name in ((ht_keys, "ht_keys"), (ht_vals, "ht_vals"),
                    (l_keys, "l_keys")):
        _build.require_int32_cuda(t, name)
    ts = ht_keys.shape[0]
    if ts < 1 or ts & (ts - 1) or ht_vals.shape[0] != ts:
        raise ValueError(f"table of {ts} slots: need a power of two with "
                         "as many values as keys")
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    n = l_keys.shape[0]
    s_idx = torch.empty_like(l_keys)
    # the launcher zeroes the counts before the kernel sums into them
    counts = torch.empty(-(-n // block), dtype=torch.int32,
                         device=l_keys.device)
    if n == 0:
        return s_idx, counts
    fn = _build.function("hash_probe_i32")
    rc = fn(ht_keys.data_ptr(), ht_vals.data_ptr(), ts, l_keys.data_ptr(),
            n, int(probe_depth), block, s_idx.data_ptr(), counts.data_ptr(),
            _build.stream_handle(l_keys.device))
    _build.check(rc, "hash_probe_i32")
    _build.LAUNCHES["probe"] += 1
    return s_idx, counts
