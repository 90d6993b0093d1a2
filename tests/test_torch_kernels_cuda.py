"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and carries the ``requires_cuda``
marker; the ``cuda`` fixture decides at run time whether to skip, so the
set of collected tests is the same on every machine.  This file imports
neither ``jax`` nor ``repro`` (the card's machine has no JAX), so it runs
there on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Integer outputs must be bit-identical to the plain versions.  The SGD
kernel's two routes (a ring of minibatch tiles in shared memory, and the
split route, a cluster of blocks over the features, for the widths the
ring does not take, up to any width that fits on the card) sum in
another order than their plain version (and nvcc contracts multiply-adds
into FMAs), so weights agree within rtol=1e-4, atol=1e-5; each route is
deterministic, so streamed training (one launch per morsel) equals one
launch over all rows bit for bit.  The traffic generator (``o = x + 1``)
is bit-identical to its plain version at any length, at every offset of
x and of ``out``, at the top of int32 and in float32; a spill plan
streams host and disk columns back through pinned copies.  The
flash attention takes views that start off a 16-byte mark on both routes.

The flash-attention kernels (B7, on the tensor cores at every head dim:
wgmma for bfloat16, three split-TF32 mma.sync products a product for
float32) sum in another order than their plain version (a dense f32
softmax on cuBLAS), so outputs agree within 2e-5 in float32 and 2e-2 in
bfloat16 (the reference's own bf16 tolerance), also non-causally at
other q and k lengths (cross-attention) and causally masked by per-row
positions.  The counts-only probe (B2) is bit-identical to
``bucket_probe`` on both of its routes (table in shared memory, or a
sample of it), at the budget's edge and at both ends of int32.  The
SSD kernels (B8, a tensor-core route for bfloat16 at widths that are
multiples of 16, a CUDA-core route otherwise) agree with their plain
version within rtol=atol=1e-4 in float32 (the final state too in
bfloat16; y rounded to bfloat16 within one rounding, 1.6e-2), each of
their three passes with its plain pass, and two launches give the same
bits.  A 2-layer smoke model's logits on the card equal
its CPU logits within 2e-2: every bf16 product rounds on its own path.
On a CUDA tensor that requires grad, B7 and B8 launch once and give an
output with a ``grad_fn``; their gradients (each a backward kernel's,
one counted call) equal plain autograd's within 1e-5 in float32 and 2e-2
in bfloat16 of their largest magnitude (B8's against the plain version
run in float64: under strong decays the float32 plain version's own
rounding exceeds 1e-5), and a 2-layer f32 smoke model's loss and
gradients on the card equal the CPU's within 1e-5 and 1e-3 (the
kernels' f32 routes differ from the plain ones by f32 rounding).  B8's
backward kernel is also held against ``plain_backward`` at every width
and chunk the forward takes, pass by pass, on misaligned views, twice
to the same bits, and from a training step with ``plain_backward`` made
to raise; B7's forward runs from a thread with no CUDA call yet.
The selection kernel's float32 entry (B1) is bit-identical to its plain
version, NaN rows and bounds that round to float32 included, and the
eager float filter, the shuffle join and ``Executor(shards=4)`` on the
card equal the CPU bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bandwidth
from repro_torch.core import channels
from repro_torch.core import join as join_core
from repro_torch.kernels import _build
from repro_torch.kernels.bandwidth import ref as bw_ref
from repro_torch.kernels.bandwidth import stream
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ops as join_ops
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.selection import selection
from repro_torch.kernels.sgd import ref as sgd_ref
from repro_torch.kernels.sgd import sgd as sgd_kernels
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_kernels

SGD_TOL = dict(rtol=1e-4, atol=1e-5)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
LM_TOL = 2e-2
MOE_MARGIN = 1e-6
MOE_TOL = 1e-4

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _same(a, b):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n,block", [(0, 1024), (1, 1024), (1024, 1024),
                                     (7 * 1024 + 3, 1024),
                                     ((1 << 20) + 5, 4096)])
def test_select_kernel_matches_plain(cuda, n, block):
    r = np.random.default_rng(n)
    x = _i32(r.integers(-50, 150, size=n), cuda)
    before = _build.LAUNCHES["select"]
    idx, counts = selection.select(x, 10, 60, block=block)
    idx_p, counts_p = selection.select_plain(x, 10, 60, block=block)
    _same(idx, idx_p)
    _same(counts, counts_p)
    assert _build.LAUNCHES["select"] == before + (n > 0)


def test_select_kernel_empty_and_inverted_ranges(cuda):
    x = _i32(np.arange(-5000, 5000), cuda)
    for lo, hi in ((7, 7), (9, 3), (-2 ** 40, 2 ** 40)):
        idx, counts = selection.select(x, lo, hi, block=1024)
        idx_p, counts_p = selection.select_plain(x, lo, hi, block=1024)
        _same(idx, idx_p)
        _same(counts, counts_p)


@pytest.mark.parametrize("n_s,n_l", [(0, 1000), (1, 1000), (2556, 100_003),
                                     ((1 << 20) + 17, 1 << 20)])
def test_probe_counts_kernel_matches_plain(cuda, n_s, n_l):
    r = np.random.default_rng(n_s)
    dom = max(n_s // 3, 1)
    s_sorted, _ = join_ref.bucket_build(_i32(r.integers(0, dom, n_s), cuda))
    keys = _i32(r.integers(0, 2 * dom, n_l), cuda)
    start, count = join_kernels.probe_counts(s_sorted, keys)
    start_p, count_p = join_ref.bucket_probe(s_sorted, keys)
    _same(start, start_p)
    _same(count, count_p)


@pytest.mark.parametrize("n_s", [5, join_core.HT_CAPACITY + 700])
def test_probe_counts_kernel_on_negative_padded_pass_blocks(cuda, n_s):
    """The pass blocks of ``join_distributed_multi`` (distinct negative
    pads, as in the eager duplicate-keyed join) and probe keys at both
    ends of int32, 2**31 - 1 included, which the table also holds."""
    r = np.random.default_rng(n_s)
    s = np.concatenate([r.integers(0, max(n_s // 3, 1), n_s),
                        [2 ** 31 - 1] * 2])
    keys = _i32(np.concatenate([r.integers(0, n_s, 50_000),
                                [2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -1,
                                 -(2 ** 30), -(2 ** 30) - 1]]), cuda)
    s_pad = join_core._pad_build(_i32(s, cuda),
                                 -(-s.size // join_core.HT_CAPACITY))
    for p in range(s_pad.shape[0] // join_core.HT_CAPACITY):
        blk = s_pad[p * join_core.HT_CAPACITY:(p + 1) * join_core.HT_CAPACITY]
        s_sorted, _ = join_ref.bucket_build(blk)
        start, count = join_kernels.probe_counts(s_sorted, keys)
        start_p, count_p = join_ref.bucket_probe(s_sorted, keys)
        _same(start, start_p)
        _same(count, count_p)


def _chained_table(r, n_s):
    """n_s sorted int32 keys in runs of 1-8 spread over int32, holding
    -2**31, -1 and 2**31 - 1 once n_s >= 3."""
    if n_s == 0:
        return np.zeros(0, np.int32)
    vals = np.unique(r.integers(-2 ** 31, 2 ** 31, n_s, dtype=np.int64))
    s = np.repeat(vals, r.integers(1, 9, vals.size))
    s = r.choice(s, n_s - 3 if n_s >= 3 else n_s, replace=False)
    if n_s >= 3:
        s = np.concatenate([s, [-2 ** 31, -1, 2 ** 31 - 1]])
    return np.sort(s).astype(np.int32)


def _probe_keys(r, table, n_l):
    """Half hits drawn from the table, half any int32, with both ends of
    int32 and their neighbours at the end and (past the first 4) inside."""
    ends = np.array([-2 ** 31, -2 ** 31 + 1, -1, 0, 2 ** 31 - 2, 2 ** 31 - 1])
    hits = r.choice(table, n_l // 2) if table.size else np.zeros(0, np.int64)
    rest = r.integers(-2 ** 31, 2 ** 31, n_l - hits.size)
    keys = r.permutation(np.concatenate([hits, rest]))
    tail = min(ends.size, n_l)
    keys[n_l - tail:] = ends[ends.size - tail:]
    if n_l >= 4 + 2 * ends.size:
        keys[4:4 + ends.size] = ends
    return keys.astype(np.int32)


B2_BUDGET = join_kernels.SHARED_TABLE_MAX


@pytest.mark.parametrize("n_s", [0, 1, 2556, B2_BUDGET - 1, B2_BUDGET,
                                 B2_BUDGET + 1, 119_384, 1_000_003])
def test_probe_counts_routes_are_bit_identical(cuda, n_s):
    """Both routes of B2 and their edge (the shared budget - 1, + 0, + 1),
    runs of 1-8 equal keys, keys at both ends of int32, a probe length
    that is no multiple of 4 and slices of it at every 16-byte offset."""
    r = np.random.default_rng(n_s + 11)
    table = _chained_table(r, n_s)
    s_sorted, _ = join_ref.bucket_build(_i32(table, cuda))
    keys = _i32(_probe_keys(r, table, 100_003), cuda)
    counter = ("probe_counts" if join_kernels.probe_counts_route(n_s)
               == "shared" else "probe_counts_sampled")
    before = dict(_build.LAUNCHES)
    for off in range(4):
        got = join_kernels.probe_counts(s_sorted, keys[off:])
        want = join_ref.bucket_probe(s_sorted, keys[off:])
        for g, w in zip(got, want):
            _same(g, w)
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: 4 if k == counter else 0 for k in before}


@pytest.mark.parametrize("n_l", [1, 2, 3, 5, 4099])
@pytest.mark.parametrize("n_s", [2556, B2_BUDGET + 1])
def test_probe_counts_short_probes(cuda, n_s, n_l):
    """Fewer keys than one group of four, and a scalar head and tail only,
    on both routes."""
    r = np.random.default_rng(n_l)
    table = _chained_table(r, n_s)
    s_sorted, _ = join_ref.bucket_build(_i32(table, cuda))
    keys = _i32(_probe_keys(r, table, n_l + 3), cuda)
    for off in range(4):
        got = join_kernels.probe_counts(s_sorted, keys[off:off + n_l])
        want = join_ref.bucket_probe(s_sorted, keys[off:off + n_l])
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("n_s,n_l,depth", [(1, 5000, 8), (2556, 100_003, 8),
                                           (8192, 1 << 20, 8),
                                           (8192, 4096, 1)])
def test_hash_probe_kernel_matches_plain(cuda, n_s, n_l, depth):
    r = np.random.default_rng(n_s + depth)
    s = _i32(r.choice(10 * n_s + 10, size=n_s, replace=False), cuda)
    keys = _i32(r.integers(-1, 10 * n_s + 10, n_l), cuda)
    ht_k, ht_v, _ = join_ref.build_table(s, 32768, depth)
    s_idx, counts = join_kernels.probe(ht_k, ht_v, keys, probe_depth=depth)
    s_idx_p, counts_p = join_kernels.probe_plain(ht_k, ht_v, keys,
                                                 probe_depth=depth)
    _same(s_idx, s_idx_p)
    _same(counts, counts_p)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x64 = torch.arange(10, device=cuda)
    with pytest.raises(TypeError):
        selection.select(x64, 0, 5)
    strided = torch.arange(20, dtype=torch.int32, device=cuda)[::2]
    with pytest.raises(ValueError):
        selection.select(strided, 0, 5)
    table = torch.zeros(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):          # not a power of two
        join_kernels.probe(table, table, table)


@pytest.mark.parametrize("n_s,n_l,cap", [(0, 1000, 8), (1, 1000, 8),
                                         (2556, 100_003, 8),
                                         (40_000, 1 << 16, 3),
                                         ((1 << 20) + 17, 1 << 20, 8)])
def test_probe_multi_kernel_matches_plain(cuda, n_s, n_l, cap):
    """Chains shorter and longer than the cap, probe keys outside the
    table, and keys at both ends of int32 (2**31 - 1 also in the table)."""
    r = np.random.default_rng(n_s + cap)
    dom = max(n_s // 5, 1)
    s = np.concatenate([r.integers(0, dom, n_s),
                        [2 ** 31 - 1, -2 ** 31] if n_s else []])
    keys = np.concatenate([r.integers(-2, 2 * dom, n_l - 4),
                           [2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -1]])
    s_sorted, order = join_ref.bucket_build(_i32(s, cuda))
    keys = _i32(keys, cuda)
    counter = _B3_COUNTER[join_kernels.probe_multi_route(s.size)]
    before = _build.LAUNCHES[counter]
    got = join_kernels.probe_multi(s_sorted, order, keys, cap=cap)
    want = join_kernels.probe_multi_plain(s_sorted, order, keys, cap=cap)
    for g, w in zip(got, want):
        _same(g, w)
    assert _build.LAUNCHES[counter] == before + 1
    if n_s > 100:
        assert int(want[2].max()) > cap


_B3_COUNTER = {"shared": "probe_multi", "sampled": "probe_multi_sampled"}
_B2_COUNTER = {"shared": "probe_counts", "sampled": "probe_counts_sampled"}


@pytest.mark.parametrize("cap", [1, 3, 8, 9])
@pytest.mark.parametrize("n_s", [1, 2556, B2_BUDGET - 1, B2_BUDGET,
                                 B2_BUDGET + 1, 119_384, 1_000_003])
def test_probe_multi_routes_are_bit_identical(cuda, n_s, cap):
    """B3 on both routes and their edge (the shared budget - 1, + 0, + 1),
    runs of 1-8 equal keys, both ends of int32 in the table and among the
    probe keys, a probe length that is no multiple of 4 and slices of it
    at every 16-byte offset; cap 3 and 9 put the rows of ``mat`` off
    16-byte marks.  mat, start and count equal the plain version's,
    (start, count) equal B2's, and each launch counts on its route's
    counter."""
    r = np.random.default_rng(n_s + 13 * cap)
    table = _chained_table(r, n_s)
    s_sorted, order = join_ref.bucket_build(_i32(r.permutation(table),
                                                 cuda))
    keys = _i32(_probe_keys(r, table, 100_003), cuda)
    route = join_kernels.probe_multi_route(n_s)
    assert route == join_kernels.probe_counts_route(n_s)
    before = dict(_build.LAUNCHES)
    for off in range(4):
        got = join_kernels.probe_multi(s_sorted, order, keys[off:], cap=cap)
        want = join_kernels.probe_multi_plain(s_sorted, order, keys[off:],
                                              cap=cap)
        assert got[0].shape == (keys.shape[0] - off, cap)
        for g, w in zip(got, want):
            _same(g, w)
        b2 = join_kernels.probe_counts(s_sorted, keys[off:])
        _same(got[1], b2[0])
        _same(got[2], b2[1])
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: 4 if k in (_B3_COUNTER[route], _B2_COUNTER[route]) else 0
         for k in before}


@pytest.mark.parametrize("cap", [1, 8, 9])
@pytest.mark.parametrize("n_s", [5_000, 6_001_215])
def test_probe_multi_chains_past_the_window_and_the_cap(cuda, n_s, cap):
    """Build keys of 50 values (TPC-H's quantity; runs of ~n_s / 50, past
    the sampled route's window of 16 and past every cap) and a run of
    2**31 - 1, probed with every value, their neighbours and both ends of
    int32: counts are exact and ``mat`` holds each run's first cap build
    rows."""
    r = np.random.default_rng(n_s + cap)
    s = np.concatenate([r.integers(1, 51, n_s - 40), [2 ** 31 - 1] * 40])
    s_sorted, order = join_ref.bucket_build(_i32(s, cuda))
    keys = _i32(np.concatenate([np.arange(-1, 53), [2 ** 31 - 1,
                                                    2 ** 31 - 2, -2 ** 31]]),
                cuda)
    for off in range(4):
        got = join_kernels.probe_multi(s_sorted, order, keys[off:], cap=cap)
        want = join_kernels.probe_multi_plain(s_sorted, order, keys[off:],
                                              cap=cap)
        for g, w in zip(got, want):
            _same(g, w)
    assert int(want[2].max()) > max(16, cap)


@pytest.mark.parametrize("block", [1, 4095, 4096, 10_000])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8])
def test_hash_probe_blocks_and_depths(cuda, depth, block):
    """B4 on a table built at depth 8 and probed at ``depth`` (keys placed
    deeper miss), three quarters full so that walks run long, with misses,
    a ragged tail and the keys at every 16-byte offset: s_idx and the
    counts of every logical block of ``block`` rows equal the plain
    version's."""
    r = np.random.default_rng(depth + block)
    s = r.choice(1 << 20, size=3_000, replace=False)
    ht_k, ht_v, _ = join_ref.build_table(_i32(s, cuda), 4096, 8)
    keys = _i32(np.concatenate([r.integers(-1, 1 << 20, 40_000),
                                r.permutation(s)[:10_003]]), cuda)
    before = dict(_build.LAUNCHES)
    for off in range(4):
        got = join_kernels.probe(ht_k, ht_v, keys[off:], block=block,
                                 probe_depth=depth)
        want = join_kernels.probe_plain(ht_k, ht_v, keys[off:], block=block,
                                        probe_depth=depth)
        for g, w in zip(got, want):
            _same(g, w)
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: 4 if k == "probe" else 0 for k in before}
    deepest = join_kernels.probe_plain(ht_k, ht_v, keys[3:], block=block,
                                       probe_depth=8)[1].sum()
    assert 0 < int(want[1].sum()) <= int(deepest)
    assert depth > 1 or int(want[1].sum()) < int(deepest)


@pytest.mark.parametrize("ts", [1, 2, 4, 16, 32_768])
def test_hash_probe_small_tables_and_short_probes(cuda, ts):
    """Tables of 1 and 2 slots (read a slot at a time), of 4 and more
    (read in 16-byte windows that wrap at the table's end), and probe
    lengths of 1 to 9 rows at every 16-byte offset."""
    r = np.random.default_rng(ts)
    n_s = max(ts // 2, 1)
    s = r.choice(100 * ts, size=n_s, replace=False)
    ht_k, ht_v, _ = join_ref.build_table(_i32(s, cuda), ts, 8)
    pool = _i32(np.concatenate([s, r.integers(0, 100 * ts, 16)]), cuda)
    for n in range(1, 10):
        for off in range(4):
            keys = pool[off:off + n]
            for depth in (1, 3, 8):
                got = join_kernels.probe(ht_k, ht_v, keys, block=2,
                                         probe_depth=depth)
                want = join_kernels.probe_plain(ht_k, ht_v, keys, block=2,
                                                probe_depth=depth)
                for g, w in zip(got, want):
                    _same(g, w)


def test_hash_probe_table_off_a_16_byte_mark(cuda):
    """A table whose keys start off a 16-byte mark is read a slot at a
    time, with the same result."""
    r = np.random.default_rng(3)
    s = r.choice(1 << 16, size=700, replace=False)
    ht_k, ht_v, _ = join_ref.build_table(_i32(s, cuda), 1024, 8)
    keys = _i32(np.concatenate([s, r.integers(0, 1 << 16, 5_000)]), cuda)
    want = join_kernels.probe_plain(ht_k, ht_v, keys, probe_depth=8)
    for off in (1, 2, 3):
        buf = torch.empty(1024 + off, dtype=torch.int32, device=cuda)
        buf[off:] = ht_k
        got = join_kernels.probe(buf[off:], ht_v, keys, probe_depth=8)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("max_out", [10, 1 << 20])
def test_hash_join_multi_on_the_card_equals_the_cpu(cuda, max_out):
    """The whole multi-match join, probe kernel and overflow pass, on the
    card against the same join on CPU tensors (the plain probe)."""
    r = np.random.default_rng(max_out)
    s = r.integers(0, 3000, 200_000).astype(np.int32)
    l = r.integers(0, 3500, 5000).astype(np.int32)
    got = join_ops.hash_join_multi(_i32(s, cuda), _i32(l, cuda),
                                   max_out=max_out)
    want = join_ops.hash_join_multi(torch.from_numpy(s), torch.from_numpy(l),
                                    max_out=max_out)
    for g, w in zip(got, want):
        _same(g, w.to(g.device))


def _sgd_inputs(device, m, n, k, kind, seed=0):
    r = np.random.default_rng(seed + n + k)
    a = r.uniform(0, 1, (m, n)).astype(np.float32)
    if kind == "logreg":
        b = (a @ r.normal(size=n) > 0.5 * r.normal(size=n).sum())
    else:
        b = a @ r.normal(size=n) / max(n, 1)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(a, **f32),
            torch.as_tensor(np.asarray(b, np.float32), **f32),
            torch.as_tensor(r.normal(0, 0.1, (k, n)), **f32),
            torch.as_tensor(0.5 / (1 + np.arange(k)) / max(n, 1), **f32),
            torch.as_tensor(1e-3 * (np.arange(k) % 3), **f32))


def _sgd_moving_inputs(device, m, n, k, seed=0):
    """Logistic-regression inputs whose weights move far past the
    tolerance: rows of about unit norm (N(0, 1 / n) entries), starting
    weights N(0, 0.25), so z = <a, x> is O(1) from the first step and each
    step's d hangs on every feature's share of z, and a learning rate of
    30 (1 - j / 10) for job j."""
    r = np.random.default_rng(seed + n + k)
    a = r.standard_normal((m, n), dtype=np.float32) / np.float32(np.sqrt(n))
    b = (a @ r.standard_normal(n, dtype=np.float32) > 0).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(a, **f32), torch.as_tensor(b, **f32),
            torch.as_tensor(0.5 * r.standard_normal((k, n)), **f32),
            torch.as_tensor(30.0 * (1 - 0.1 * np.arange(k)), **f32),
            torch.as_tensor(1e-3 * (np.arange(k) % 3), **f32))


def _assert_moved(want, xs0, factor=10.0):
    """Every job's median weight ends ``factor`` times ``SGD_TOL`` from
    where it started, so weights left in place fail the comparison."""
    tol = SGD_TOL["atol"] + SGD_TOL["rtol"] * want.abs()
    moved = ((want - xs0).abs() / tol).median(dim=1).values
    assert float(moved.min()) > factor, moved.tolist()


@pytest.mark.parametrize("n", [1, 3, 784, 2048])
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_kernel_matches_plain(cuda, n, k, kind):
    # each route counts its own launches: the ring "sgd", the split
    # route (n % 4 != 0) "sgd_split"
    counter = {"ring": "sgd", "split": "sgd_split"}[
        sgd_kernels.route(n, 16)]
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 256, n, k, kind)
    before = _build.LAUNCHES[counter]
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                          kind=kind)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                           kind=kind)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_kernel_streamed_equals_one_launch_bitwise(cuda, kind):
    """Epochs over morsels (one launch each, weights carried) against one
    launch over all rows; and a job alone against the job in a group."""
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 1600, 784, 8, kind)
    once = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                           kind=kind)
    xs = xs0
    for _ in range(3):
        for lo in range(0, 1600, 480):            # 480, 480, 480, 160 rows
            xs = sgd_kernels.sgd(a[lo:lo + 480], b[lo:lo + 480], xs, lrs,
                                 l2s, minibatch=16, epochs=1, kind=kind)
    _same(xs, once)
    alone = sgd_kernels.sgd(a, b, xs0[3:4].contiguous(), lrs[3:4], l2s[3:4],
                            minibatch=16, epochs=3, kind=kind)
    _same(alone[0], once[3])


@pytest.mark.parametrize("n", [1, 3, 4, 784, 785, 1028, 4096])
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_ring_route_matches_plain(cuda, n, k, kind):
    """Every width through ``sgd``: the ring on one block (n <= 1,024) or
    a cluster of them (1,028 features on 2 blocks, 4,096 on 4), where
    n % 4 == 0; the split route where not (the ring's bulk copies read
    whole 16-byte groups).  Exactly one launch, counted on its route."""
    route = sgd_kernels.route(n, 16)
    assert route == ("ring" if n % 4 == 0 else "split")
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 320, n, k, kind)
    before = dict(_build.LAUNCHES)
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=2,
                          kind=kind)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=16, epochs=2,
                           kind=kind)
    torch.cuda.synchronize()
    counter = {"ring": "sgd", "split": "sgd_split"}[route]
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == counter) for c in before}
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


@pytest.mark.parametrize("cluster", sgd_kernels.CLUSTER_SIZES)
@pytest.mark.parametrize("minibatch", sgd_kernels.RING_MINIBATCHES)
def test_sgd_ring_every_cluster_size_and_minibatch(cuda, cluster, minibatch):
    """Every cluster size the ring takes (the ones timed against each
    other at the MNIST shape) and every minibatch it is built for, at
    784 features, against the plain version."""
    plan = sgd_kernels.ring_plan(784, minibatch, cluster=cluster)
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 256, 784, 8, "logreg")
    kw = dict(minibatch=minibatch, epochs=2, kind="logreg")
    got = sgd_kernels.sgd_ring(a, b, xs0, lrs, l2s, plan=plan, **kw)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


@pytest.mark.parametrize("n", [784, 785, 4096, 9_000])
def test_sgd_ring_route_on_a_misaligned_dataset_is_bit_identical(cuda, n):
    """A dataset or label column that starts 4 bytes past a 16-byte mark
    (which the bulk copies cannot read in place, so the wrapper copies
    the dataset first), on the ring (784, 4,096) and the split route
    (785 on one block, 9,000 on a cluster): the same sums, the same
    bits."""
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 160, n, 3, "logreg")
    buf = torch.empty(a.numel() + 1, dtype=torch.float32, device=cuda)
    a_off = buf[1:].view(a.shape)
    a_off.copy_(a)
    b_off = torch.empty(b.numel() + 1, dtype=torch.float32,
                        device=cuda)[1:]
    b_off.copy_(b)
    assert a_off.data_ptr() % 16 != 0 and b_off.data_ptr() % 16 != 0
    kw = dict(minibatch=16, epochs=2, kind="logreg")
    want = sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw)
    _same(sgd_kernels.sgd(a_off, b, xs0, lrs, l2s, **kw), want)
    _same(sgd_kernels.sgd(a, b_off, xs0, lrs, l2s, **kw), want)


@pytest.mark.parametrize("n,minibatch", [(50_000, 16), (9_000, 16),
                                         (785, 16), (784, 12), (784, 32),
                                         (784, 2)])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_direct_route_matches_plain(cuda, n, minibatch, kind):
    """The split route (which replaced the direct kernel): models too
    wide for a ring (50,000 features on a cluster of 16 blocks) and
    minibatches the ring is not built for."""
    assert sgd_kernels.route(n, minibatch) == "split"
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 4 * 96, n, 3, kind)
    before = dict(_build.LAUNCHES)
    kw = dict(minibatch=minibatch, epochs=2, kind=kind)
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw)
    torch.cuda.synchronize()
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == "sgd_split") for c in before}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


@pytest.mark.parametrize("n", [20_003, 47_236])
@pytest.mark.parametrize("blocks,grid", [(4, False), (16, False), (32, True),
                                         (128, True)])
def test_sgd_split_route_every_exchange_matches_plain(cuda, n, blocks, grid):
    """The split route's two exchanges, whichever its plan picks at
    these widths: clusters of 4 and 16 blocks (the step's tile read again
    from L2 where the ring cannot hold it; at 47,236 features on 4 blocks
    the model slices in device memory) and grid-wide launches of 32 and
    up to 128 blocks, 5 jobs in two groups, against the plain version,
    every job's weights moving far past the tolerance."""
    plan = sgd_kernels.split_fit(n, 16, blocks, grid)
    a, b, xs0, lrs, l2s = _sgd_moving_inputs(cuda, 320, n, 5)
    kw = dict(minibatch=16, epochs=2, kind="logreg")
    got = sgd_kernels.sgd_split(a, b, xs0, lrs, l2s, plan=plan, **kw)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw)
    torch.cuda.synchronize()
    _assert_moved(want, xs0)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


# a width (at minibatch 16) whose model slices live in device memory on
# the split route's grid-wide launch
SPLIT_OFF_CHIP = 760_001


@pytest.mark.parametrize("n,minibatch,m", [
    (784, 16, 1440), (784, 8, 1440), (1028, 16, 1440), (4096, 16, 1440),
    (785, 16, 1440), (9_000, 16, 1440), (784, 12, 1440),
    (47_236, 16, 1440), (SPLIT_OFF_CHIP, 16, 96)])
def test_sgd_streamed_equals_one_launch_bitwise_on_each_route(cuda, n,
                                                              minibatch, m):
    """Epochs over morsels (one launch each, weights carried) against one
    launch over all rows, and a job alone against the job in a group, on
    the ring (one block at two minibatches, clusters of 2 and 4) and the
    split route (n % 4 != 0 on one block, a resident cluster of 5 at
    9,000, a minibatch of 12, a grid-wide launch at 47,236, and one whose
    model lives in device memory)."""
    if n == SPLIT_OFF_CHIP:
        assert not sgd_kernels.split_plan(n, minibatch).model_on_chip
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, m, n, 5, "logreg")
    kw = dict(minibatch=minibatch, kind="logreg")
    once = sgd_kernels.sgd(a, b, xs0, lrs, l2s, epochs=3, **kw)
    xs = xs0
    for _ in range(3):
        for lo in range(0, m, m // 3):
            xs = sgd_kernels.sgd(a[lo:lo + m // 3], b[lo:lo + m // 3], xs,
                                 lrs, l2s, epochs=1, **kw)
    _same(xs, once)
    alone = sgd_kernels.sgd(a, b, xs0[3:4].contiguous(), lrs[3:4], l2s[3:4],
                            epochs=3, **kw)
    _same(alone[0], once[3])


@pytest.mark.parametrize("epochs", [1, 3])
def test_sgd_grid_route_odd_steps_across_groups(cuda, epochs):
    """A grid-wide launch trains its groups of jobs in turn: 5 jobs (4 a
    group at a minibatch of 16) at 47,236 features over 17 minibatches,
    an odd number of steps a group, so the exchange's double buffer must
    not restart at the second group (its first step would write the
    buffer that slower blocks still read the first group's last sums
    from).  Against the plain version; three launches and each job alone
    bit for bit."""
    n, m = 47_236, 16 * 17
    plan = sgd_kernels.split_plan(n, 16)
    assert plan.grid and plan.jobs == 4
    a, b, xs0, lrs, l2s = _sgd_moving_inputs(cuda, m, n, 5)
    kw = dict(minibatch=16, epochs=epochs, kind="logreg")
    got = [sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw) for _ in range(3)]
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw)
    torch.cuda.synchronize()
    _assert_moved(want, xs0)
    np.testing.assert_allclose(got[0].cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)
    for again in got[1:]:
        _same(again, got[0])
    for j in range(5):
        alone = sgd_kernels.sgd(a, b, xs0[j:j + 1].contiguous(),
                                lrs[j:j + 1], l2s[j:j + 1], **kw)
        _same(alone[0], got[0][j])


@pytest.mark.parametrize("n,m", [(58_097, 16), (1_355_191, 64)])
def test_sgd_kernel_refuses_a_model_wider_than_shared_memory(cuda, n, m):
    """Named for the fault it now pins: the direct kernel kept a job's
    model in one block's shared memory and refused n = 58,097 (232,452
    bytes with a minibatch of 16), where the reference trains.  The split
    route trains it, and news20.binary's 1,355,191 features (its model
    slices in device memory), within the tolerance of the plain version,
    the weights moving far past it; what it still refuses is a count past
    int32."""
    a, b, xs0, lrs, l2s = _sgd_moving_inputs(cuda, m, n, 1)
    assert sgd_kernels.route(n, 16) == "split"
    kw = dict(minibatch=16, epochs=1, kind="logreg")
    before = _build.LAUNCHES["sgd_split"]
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, **kw)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sgd_split"] == before + 1
    _assert_moved(want, xs0)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)
    with pytest.raises(ValueError, match="int32"):
        sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=2 ** 31)


def test_executor_trains_through_the_kernel_stream_equals_eager(cuda):
    """The executor's GLM path on the card: every mode launches the SGD
    kernel, and streamed weights equal eager weights bit for bit."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, HyperParams, Q
    r = np.random.default_rng(2)
    a = r.uniform(0, 1, (1000, 20)).astype(np.float32)
    y = (a @ r.normal(size=20) > 0).astype(np.float32)
    cols = {f"f{j}": a[:, j] for j in range(20)}
    cols["y"] = y
    ex = Executor(catalog_from_arrays({"t": cols}, cuda), cuda)
    q = Q.scan("t").train_glm([f"f{j}" for j in range(20)], "y",
                              [HyperParams(0.1 / (i + 1), 0.001 * i)
                               for i in range(4)], epochs=3)
    out = {}
    for mode, kw in (("batch", {}), ("stream", {"morsel_rows": 160}),
                     ("eager", {})):
        before = _build.LAUNCHES["sgd"]
        out[mode] = ex.execute(q, mode=mode, **kw).value
        assert _build.LAUNCHES["sgd"] > before
    _same(out["stream"][0], out["eager"][0])
    _same(out["batch"][0], out["eager"][0])


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 4096 + 7, (1 << 20) + 3,
                               (1 << 22) + 1])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_copy_kernel_matches_plain(cuda, n, dtype):
    r = np.random.default_rng(n)
    if dtype == torch.int32:
        x = _i32(r.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64), cuda)
        if n:
            x[0] = 2 ** 31 - 1                  # wraps to -2**31
    else:
        x = torch.as_tensor(r.standard_normal(n).astype(np.float32) * 1e4,
                            device=cuda)
    before = _build.LAUNCHES["stream_copy"]
    got = stream.stream_copy(x)
    _same(got, bw_ref.stream_copy_ref(x))
    assert _build.LAUNCHES["stream_copy"] == before + (n > 0)


@pytest.mark.parametrize("start", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_copy_kernel_on_misaligned_slices(cuda, start, dtype):
    base = torch.arange(-(1 << 16), (1 << 16) + 9, device=cuda).to(dtype)
    before = base.clone()
    for stop in (base.shape[0], base.shape[0] - 2, start + 3, start + 1):
        x = base[start:stop]
        got = stream.stream_copy(x)
        _same(got, bw_ref.stream_copy_ref(x))
        # the output shares x's offset within 16 bytes (the vector path)
        assert got.data_ptr() % 16 == x.data_ptr() % 16
        # an output at another offset takes the scalar path, same bits
        out = torch.empty(x.shape[0] + 1, dtype=dtype, device=cuda)[1:]
        _same(stream.stream_copy(x, out=out), bw_ref.stream_copy_ref(x))
    _same(base, before)                          # x is never written


def test_stream_copy_kernel_at_one_gib_claims_tiles(cuda):
    """The calibration's shape: 1 GiB of int32, one wave of blocks
    claiming tiles until the array is done, several loads in flight a
    thread."""
    n = 1 << 28
    plan = stream.plan_stream_block(n, 4)
    assert plan.grid * plan.tile * plan.vector < n and plan.unroll > 1
    x = torch.arange(n, dtype=torch.int32, device=cuda)
    x[-1] = 2 ** 31 - 1
    got = stream.stream_copy(x)
    torch.cuda.synchronize()
    assert bool(torch.equal(got, bw_ref.stream_copy_ref(x)))
    assert int(got[-1]) == -2 ** 31
    del got
    out = torch.full_like(x, 7)
    assert stream.stream_copy(x, out=out) is out
    assert bool(torch.equal(out, bw_ref.stream_copy_ref(x)))


@pytest.mark.parametrize("x_start", [0, 1, 2, 3])
@pytest.mark.parametrize("out_start", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_copy_kernel_every_start_offset_into_out(cuda, x_start,
                                                        out_start, dtype):
    """x and out at every offset within 16 bytes, ragged lengths around
    one thread row and one chunk: vectors where the offsets agree,
    scalars where they differ, the same bits either way."""
    n_max = (1 << 18) + 11
    base = torch.arange(-(n_max // 2), n_max - n_max // 2 + 4,
                        device=cuda).to(dtype)
    for n in (1, 3, 1023, 1024 + 5, n_max):
        x = base[x_start:x_start + n]
        buf = torch.full((n + 4,), -5, dtype=dtype, device=cuda)
        out = buf[out_start:out_start + n]
        before = _build.LAUNCHES["stream_copy"]
        stream.stream_copy(x, out=out)
        _same(out, bw_ref.stream_copy_ref(x))
        assert _build.LAUNCHES["stream_copy"] == before + 1
        # nothing outside out is written
        assert bool((buf[:out_start] == -5).all())
        assert bool((buf[out_start + n:] == -5).all())


def test_stream_copy_kernel_wraps_int32_and_refuses_other_types(cuda):
    x = torch.tensor([2 ** 31 - 1] * 9, dtype=torch.int32, device=cuda)
    assert stream.stream_copy(x).tolist() == [-2 ** 31] * 9
    for dtype in (torch.float16, torch.int64, torch.float64, torch.int16):
        with pytest.raises(TypeError):
            stream.stream_copy(torch.zeros(8, dtype=dtype, device=cuda))
    with pytest.raises(ValueError):
        stream.stream_copy(torch.zeros((4, 4), dtype=torch.int32,
                                       device=cuda))


@pytest.mark.parametrize("n_engines", [1, 4, 16])
@pytest.mark.parametrize("placement", ["partitioned", "congested"])
def test_stream_copy_distributed_matches_plain(cuda, n_engines, placement):
    n = n_engines * ((1 << 18) + 3)       # shards start off 16-byte marks
    x = _i32(np.random.default_rng(n_engines).integers(-9, 9, n), cuda)
    before = _build.LAUNCHES["stream_copy"]
    got = bandwidth.stream_copy_distributed(
        x, channels.plan(placement, n_engines, cuda))
    _same(got, bw_ref.stream_copy_ref(x))
    assert _build.LAUNCHES["stream_copy"] == before + n_engines
    assert bandwidth.measure_gbps(stream.stream_copy, x) > 0


def test_spilled_executor_on_the_card_equals_resident(cuda, tmp_path):
    """Host and disk columns staged through pinned copies and the
    prefetch thread give the resident run's value, in batch (routed to
    the spill stream) and in stream mode, with and without the thread."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q, TierBudgets
    r = np.random.default_rng(3)
    n = 300_007
    arrays = {"big": {"k": r.integers(0, 1000, n).astype(np.int32),
                      "v": r.integers(0, 100, n).astype(np.int32),
                      "w": r.integers(1, 50, n).astype(np.int32)},
              "small": {"k": np.arange(0, 1000, 2, dtype=np.int32)}}
    q = (Q.scan("big").join(Q.scan("small"), on="k").filter("v", 10, 60)
         .sum("w"))
    want = Executor(catalog_from_arrays(arrays, cuda), cuda).execute(q).value
    col = n * 4
    for overlap in (True, False):
        ex = Executor(catalog_from_arrays(arrays, cuda), cuda,
                      tier_budgets=TierBudgets(device=col + 4096, host=col),
                      overlap_transfers=overlap)
        ex._spill_dir = str(tmp_path)
        before = _build.LAUNCHES["probe_counts"]
        res = ex.execute(q)
        assert res.value == want and res.mode == "stream"
        assert _build.LAUNCHES["probe_counts"] > before
        assert sorted(ex.last_spill.tiers.values()) == ["device", "disk",
                                                       "host"]
        assert ex.execute(q, mode="stream", morsel_rows=65_536).value == want


# ---- flash attention (B7) ------------------------------------------------- #

def _qkv(device, b, s, h, kvh, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=g).to(device, dtype)
                 for n in (h, kvh, kvh))


@pytest.mark.parametrize("s", [1, 77, 128, 2000])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, s, group, dtype, causal):
    q, k, v = _qkv(cuda, 2, s, 8, 8 // group, 128, dtype, seed=s)
    counter = fa.COUNTER[fa.route(dtype, 128)]
    before = _build.LAUNCHES[counter]
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa_ref.attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert _build.LAUNCHES[counter] == before + 1


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 2000])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_tensor_core_route_matches_plain(cuda, s, group, d,
                                                         causal, dtype):
    """Both tensor-core routes at every head dim: bf16 on wgmma (those
    under 64 and between 64 and 128 padded by TMA's zero fill), f32 as
    split TF32 on mma.sync with 64-row kv tiles; one tile and a ragged
    one, the diagonal tiles, a 128-row q tile over two f32 kv tiles, GQA
    groups of 1, 4 and 8, each within its type's tolerance."""
    q, k, v = _qkv(cuda, 2, s, 8, 8 // group, d, dtype, seed=s + d + group)
    counter = fa.COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa_ref.attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == counter) for k in before}


def test_flash_attention_routes_by_type_and_head_dim(cuda):
    """bf16 takes the wgmma route and f32 the split-TF32 route at every
    head dim, the served ones (128, stablelm-3b's 80) among them."""
    for dtype, d, counter in ((torch.bfloat16, 128, "flash_attention_tc"),
                              (torch.bfloat16, 64, "flash_attention_tc"),
                              (torch.float32, 128, "flash_attention_f32"),
                              (torch.bfloat16, 32, "flash_attention_tc"),
                              (torch.bfloat16, 80, "flash_attention_tc"),
                              (torch.float32, 80, "flash_attention_f32")):
        q, k, v = _qkv(cuda, 1, 100, 4, 2, d, dtype, seed=d)
        before = dict(_build.LAUNCHES)
        fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
            {k: int(k == counter) for k in before}, (dtype, d)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 16)])
def test_flash_attention_tensor_core_route_takes_more_than_65535_heads(
        cuda, dtype, d):
    """Each route's grid is one dimension of q tiles x B * H, so B * H is
    not held to the former CUDA-core grid's 65,535."""
    q, k, v = _qkv(cuda, 2, 3, 33_000, 33_000, d, dtype,
                   seed=5 if dtype == torch.bfloat16 else 6)
    got = fa.flash_attention(q, k, v)
    want = fa_ref.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_kernel_every_head_dim(cuda, d):
    q, k, v = _qkv(cuda, 1, 77, 4, 2, d, torch.float32, seed=d)
    got = fa.flash_attention(q, k, v)
    want = fa_ref.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTN_TOL[torch.float32]


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                           v)


@pytest.mark.parametrize("h,kvh,d", [(24, 8, 64), (40, 8, 128),
                                     (28, 4, 128), (32, 8, 128)],
                         ids=["granite-moe", "llama4-scout", "qwen2-vl",
                              "jamba"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_at_the_moe_hybrid_and_vlm_heads(cuda, h, kvh, d,
                                                        dtype):
    """The served families' head counts: granite-moe's D 64 with GQA 3,
    llama4-scout's GQA 5, qwen2-vl's GQA 7 and jamba's GQA 4, causal over
    300 tokens (a ragged q tile), on each type's route."""
    q, k, v = _qkv(cuda, 2, 300, h, kvh, d, dtype, seed=h + kvh)
    counter = fa.COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(q, k, v)
    want = fa_ref.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == counter) for k in before}


@pytest.mark.parametrize("s", [1, 129])
@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float32, 80)])
def test_flash_attention_tensor_core_route_takes_misaligned_views(cuda, s,
                                                                  which,
                                                                  dtype, d):
    """A contiguous view that starts one element (2 bytes in bf16, 4 in
    f32) past a 16-byte mark, one operand at a time, runs through its
    type's route: both read through TMA, which needs aligned addresses, so
    the wrapper copies that operand first."""
    q, k, v = _qkv(cuda, 1, s, 4, 2, d, dtype, seed=s)
    ops = {"q": q, "k": k, "v": v}
    t = ops[which]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    ops[which] = view
    counter = fa.COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(ops["q"], ops["k"], ops["v"])
    want = fa_ref.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == counter) for k in before}


def _launched(before, counter):
    return {k: _build.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == counter) for k in before}


@pytest.mark.parametrize("sq", [1, 32, 416])
@pytest.mark.parametrize("sk", [1, 92, 1500])
@pytest.mark.parametrize("d,group", [(64, 1), (64, 4), (128, 1), (128, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_cross_lengths_match_plain(cuda, sq, sk, d, group,
                                                   dtype):
    """Non-causal attention of Sq queries over Sk keys (an encoder-decoder's
    cross-attention: whisper's decoder 416 = 3 x 128 + 32 rows against
    1,500 = 11 x 128 + 92 = 23 x 64 + 28 frames), ragged on both sides,
    on each type's route, one launch each."""
    g = torch.Generator(device="cpu").manual_seed(sq * 7 + sk + d + group)
    q = torch.randn(2, sq, 8, d, generator=g).to(cuda, dtype)
    k, v = (torch.randn(2, sk, 8 // group, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    counter = fa.COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa_ref.attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert _launched(before, counter)


def _vlm_t(s, patches):
    """Qwen2-VL's temporal positions: ``patches`` image patches share t = 0,
    and the text after them resumes at the grid's side."""
    side = int(np.ceil(np.sqrt(patches)))
    i = np.arange(s)
    return np.where(i < patches, 0, side + i - patches)


def _positions(pattern, b, s, seed):
    """(q_pos, k_pos) int32 (b, s) of a named pattern: Qwen2-VL's shared t,
    positions that fall along the row, random repeats, and rows that no
    key reaches (k positions past every q position of the first half)."""
    r = np.random.default_rng(seed)
    if pattern == "shared_t":
        qp = np.broadcast_to(_vlm_t(s, min(256, s // 2 + 1)), (b, s))
    elif pattern == "falling":
        qp = np.broadcast_to(np.arange(s)[::-1], (b, s))
    elif pattern == "repeats":
        qp = r.integers(0, max(s // 4, 1), (b, s))
    else:
        qp = np.broadcast_to(np.arange(s), (b, s))
    kp = qp + s // 2 if pattern == "no_key_rows" else qp
    return (torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (qp, kp))


@pytest.mark.parametrize("s", [1, 32, 92, 416, 1500])
@pytest.mark.parametrize("pattern", ["shared_t", "falling", "repeats",
                                     "no_key_rows"])
@pytest.mark.parametrize("d,group", [(64, 1), (128, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_position_mask_matches_plain(cuda, s, pattern, d,
                                                     group, dtype):
    """Causal attention masked by per-row positions (``q_pos >= k_pos``
    keeps a key, the reference's mask) on each type's route: every kv tile
    is loaded and masked, the first tiles of a falling row hold no key of
    it, and a row that no key reaches averages every key as the plain
    version does."""
    q, k, v = _qkv(cuda, 2, s, 8, 8 // group, d, dtype, seed=s + d)
    qp, kp = (t.to(cuda) for t in _positions(pattern, 2, s, s))
    counter = fa.COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(q, k, v, q_pos=qp, k_pos=kp)
    want = fa_ref.attention_plain(q, k, v, q_pos=qp, k_pos=kp)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert _launched(before, counter)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_position_mask_at_the_qwen2_vl_prefill(cuda, dtype):
    """qwen2-vl's served prefill (4 x 2,000 tokens, 28 heads of 128, GQA 7)
    with its 256 patches at one t: the position mask against the plain
    version, and rising positions equal to the index mask bit for bit."""
    b = 4 if dtype == torch.bfloat16 else 1
    q, k, v = _qkv(cuda, b, 2000, 28, 4, 128, dtype, seed=28)
    qp, kp = (t.to(cuda) for t in _positions("shared_t", b, 2000, 0))
    got = fa.flash_attention(q, k, v, q_pos=qp, k_pos=kp)
    want = fa_ref.attention_plain(q, k, v, q_pos=qp, k_pos=kp)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    del want
    rising = torch.arange(2000, dtype=torch.int32, device=cuda).expand(b, -1)
    rising = rising.contiguous()
    assert torch.equal(fa.flash_attention(q, k, v, q_pos=rising,
                                          k_pos=rising),
                       fa.flash_attention(q, k, v))


def test_flash_attention_refuses_causal_cross_lengths_and_bad_positions(cuda):
    q, k, v = _qkv(cuda, 1, 32, 4, 2, 64, torch.bfloat16)
    k2, v2 = (t.repeat(1, 2, 1, 1) for t in (k, v))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k2, v2)
    pos = torch.arange(32, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(ValueError, match="both"):
        fa.flash_attention(q, k, v, q_pos=pos)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention(q, k, v, q_pos=pos.long(), k_pos=pos.long())
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention(q, k, v, q_pos=pos.cpu(), k_pos=pos.cpu())


# ---- SSD chunk scan (B8) --------------------------------------------------- #

def _ssd_inputs(device, bsz, s, nh, hd, ng, ds, dtype, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(                       # noqa: E731
        r.normal(size=shape).astype(np.float32))
    dt = torch.from_numpy(r.uniform(0.01, 0.2, size=(bsz, s, nh))
                          .astype(np.float32))
    x, b, c = f(bsz, s, nh, hd), f(bsz, s, ng, ds), f(bsz, s, ng, ds)
    return (x.to(device, dtype), dt.to(device), f(nh).to(device),
            b.to(device, dtype), c.to(device, dtype), f(nh).to(device))


def _ssd_counts(before):
    return {k: _build.LAUNCHES[k] - before[k] for k in before}


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 77, 128, 200, 2000])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("hd,ds", [(16, 16), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, s, ng, hd, ds, chunk, dtype):
    """f32 takes the CUDA cores, bf16 at these widths the tensor cores;
    each call counts one launch on its route's counter and no other."""
    args = _ssd_inputs(cuda, 2, s, 4, hd, ng, ds, dtype, seed=s)
    counter = ssd_kernels.COUNTER[ssd_kernels.route(dtype, hd, ds)]
    assert counter == ("ssd" if dtype == torch.float32 else "ssd_tc")
    before = dict(_build.LAUNCHES)
    y, h = ssd_kernels.ssd_scan(*args, chunk=chunk)
    assert _ssd_counts(before) == {k: int(k == counter) for k in before}
    y_p, h_p = ssd_ref.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(
        y.float(), y_p.float(),
        **(SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL))
    torch.testing.assert_close(h, h_p, **SSD_TOL)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_kernel_bf16_and_chunk_lengths(cuda, chunk):
    args = _ssd_inputs(cuda, 2, 300, 8, 64, 2, 128, torch.bfloat16)
    y, h = ssd_kernels.ssd_scan(*args, chunk=chunk)
    y_p, h_p = ssd_ref.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_BF16_TOL)
    torch.testing.assert_close(h, h_p, **SSD_TOL)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("hd,ds", [(24, 16), (64, 120), (80, 48), (16, 128),
                                   (128, 16), (128, 128), (1, 1), (33, 97)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_every_width(cuda, hd, ds, chunk, dtype):
    """Widths off the multiples of 16 take the CUDA cores in bf16 too;
    hd 80 and 128 take the tensor-core route's two halves of H."""
    args = _ssd_inputs(cuda, 2, 300, 4, hd, 2, ds, dtype, seed=hd + ds)
    counter = ssd_kernels.COUNTER[ssd_kernels.route(dtype, hd, ds)]
    before = dict(_build.LAUNCHES)
    y, h = ssd_kernels.ssd_scan(*args, chunk=chunk)
    assert _ssd_counts(before) == {k: int(k == counter) for k in before}
    y_p, h_p = ssd_ref.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y.float(), y_p.float(),
        **(SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL))
    torch.testing.assert_close(h, h_p, **SSD_TOL)


@pytest.mark.parametrize("s,chunk", [(77, 128), (200, 64), (2000, 128)])
@pytest.mark.parametrize("dtype,hd,ds", [(torch.float32, 64, 128),
                                         (torch.bfloat16, 64, 128),
                                         (torch.bfloat16, 24, 16)])
def test_ssd_passes_match_their_plain_passes(cuda, s, chunk, dtype, hd, ds):
    """Each pass of the route alone, fed its plain predecessor's output,
    against its plain pass."""
    x, dt, a_log, b, c, d_skip = args = _ssd_inputs(cuda, 2, s, 4, hd, 2, ds,
                                                    dtype, seed=7)
    states, decay = ssd_kernels.scratch(x, chunk, ds)
    y = torch.empty_like(x)
    h = torch.empty((2, 4, hd, ds), dtype=torch.float32, device=cuda)
    before = dict(_build.LAUNCHES)
    ssd_kernels.run_passes(*args, states=states, decay=decay, y=y, h=h,
                           chunk=chunk, passes=["chunk_states"])
    s_p, dec_p = ssd_ref.ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(states, s_p, **SSD_TOL)
    torch.testing.assert_close(decay, dec_p, **SSD_TOL)

    states.copy_(s_p)
    decay.copy_(dec_p)
    ssd_kernels.run_passes(*args, states=states, decay=decay, y=y, h=h,
                           chunk=chunk, passes=["state_pass"])
    h_in, h_p = ssd_ref.ssd_state_pass_plain(s_p, dec_p)
    torch.cuda.synchronize()
    torch.testing.assert_close(states, h_in, **SSD_TOL)
    torch.testing.assert_close(h, h_p, **SSD_TOL)

    states.copy_(h_in)
    ssd_kernels.run_passes(*args, states=states, decay=decay, y=y, h=h,
                           chunk=chunk, passes=["chunk_scan"])
    y_p = ssd_ref.ssd_chunk_scan_plain(*args, h_in, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        y.float(), y_p.float(),
        **(SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_two_launches_are_bit_identical(cuda, dtype):
    args = _ssd_inputs(cuda, 2, 2000, 8, 64, 1, 128, dtype, seed=5)
    y1, h1 = ssd_kernels.ssd_scan(*args)
    y2, h2 = ssd_kernels.ssd_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("which", ["x", "b", "c", "dt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_misaligned_views(cuda, which, dtype):
    """A contiguous view that starts off a 16-byte mark (``buf[1:]``) is
    staged by narrower asynchronous copies or plain loads, to the same
    bits."""
    args = list(_ssd_inputs(cuda, 2, 200, 4, 64, 1, 128, dtype, seed=3))
    want = ssd_kernels.ssd_scan(*args)
    at = {"x": 0, "dt": 1, "b": 3, "c": 4}[which]
    t = args[at]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    args[at] = buf[1:].view(t.shape)
    args[at].copy_(t)
    assert args[at].data_ptr() % 16 != 0
    got = ssd_kernels.ssd_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_kernel_refuses_a_chunk_past_shared_memory(cuda):
    """Every pass fits two blocks on an SM at mamba2-780m's widths, and at
    the widest shape the kernel takes each pass's shared memory fits twice;
    a width past it, or another type, is refused before any launch."""
    # two blocks of this many bytes (each with the 1 KB the SM reserves a
    # block) fit in the SM's shared memory, which exceeds a block's limit
    two = sgd_kernels.max_shared_bytes(cuda) // 2 - 1024
    for dtype in (torch.float32, torch.bfloat16):
        for p, (blocks, _) in ssd_kernels.occupancy(dtype, 64, 128,
                                                    128).items():
            assert blocks >= 2, (dtype, p, blocks)
        for p, (blocks, smem) in ssd_kernels.occupancy(dtype, 128, 128,
                                                       128).items():
            assert blocks >= 1 and smem <= two, \
                (dtype, p, blocks, smem)
    args = _ssd_inputs(cuda, 1, 64, 2, 128, 1, 256, torch.float32)
    with pytest.raises(ValueError, match="ds <= 128"):
        ssd_kernels.ssd_scan(*args)
    args = _ssd_inputs(cuda, 1, 64, 2, 64, 1, 64, torch.float16)
    with pytest.raises(TypeError):
        ssd_kernels.ssd_scan(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_jamba_widths(cuda, dtype):
    """jamba's Mamba layers: 128 heads of 64, one group, a state of 16
    (bf16 takes the tensor cores, f32 the CUDA cores), a ragged chunk."""
    args = _ssd_inputs(cuda, 2, 300, 128, 64, 1, 16, dtype, seed=16)
    counter = ssd_kernels.COUNTER[ssd_kernels.route(dtype, 64, 16)]
    assert counter == ("ssd" if dtype == torch.float32 else "ssd_tc")
    before = dict(_build.LAUNCHES)
    y, h = ssd_kernels.ssd_scan(*args)
    assert _ssd_counts(before) == {k: int(k == counter) for k in before}
    y_p, h_p = ssd_ref.ssd_plain(*args)
    torch.cuda.synchronize()
    y_tol = SSD_TOL if dtype == torch.float32 else SSD_BF16_TOL
    torch.testing.assert_close(y.float(), y_p.float(), **y_tol)
    torch.testing.assert_close(h, h_p, **SSD_TOL)


# ---- the LM path ----------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "stablelm-3b"])
def test_smoke_model_on_the_card_equals_the_cpu(cuda, arch):
    import dataclasses
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.serve import build_model
    from repro_torch.models import registry
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), num_layers=2)
    mb, cpu_model = build_model(cfg, torch.device("cpu"), seed=3)
    _, card_model = build_model(cfg, cuda, state_dict=cpu_model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 200),
                         generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        caches = registry.make_cache(cfg, 2, 201, dev)
        _build.reset_launches()
        with torch.inference_mode():
            logits, caches = mb.prefill_fn(model, toks.to(dev), caches)
            step, _ = mb.decode_fn(model, toks[:, :1].to(dev), 200, caches)
        out[dev] = (logits.cpu(), step.cpu(), dict(_build.LAUNCHES))
    # the smoke models are bf16: mamba's hd 16, ds 16 take B8's tensor
    # cores, the dense head dim 32 B7's (padded to 64 columns)
    kernel = "ssd_tc" if cfg.family == "ssm" else "flash_attention_tc"
    assert out["cpu"][2][kernel] == 0 and out["cuda"][2][kernel] == 2
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        assert float((got - want).abs().max()) <= LM_TOL


def test_streaming_server_on_the_card_equals_the_cpu(cuda):
    """The query server streaming join aggregates over a 1 << 20-row
    seeded table on the card (B2 probing once a morsel for each group of
    members) returns the same integer sums as the same server on the CPU,
    bit for bit, with members joining mid-circle and a dedup rider."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q, QueryServer

    r = np.random.default_rng(23)
    n = 1 << 20
    arrays = {"big": {"k": r.integers(0, 5000, n).astype(np.int32),
                      "v": r.integers(0, 100, n).astype(np.int32),
                      "w": r.integers(1, 50, n).astype(np.int32)},
              "small": {"k": np.asarray(r.choice(5000, 3000, replace=False),
                                        np.int32)},
              "dup": {"k": r.integers(0, 5000, 9000).astype(np.int32)}}
    bounds = [(0, 9), (10, 40), (20, 60), (0, 99), (5, 15), (30, 31)]

    def serve(device):
        srv = QueryServer(Executor(catalog_from_arrays(arrays, device),
                                   device), streaming=True,
                          morsel_rows=1 << 17)
        qids = []
        for i, (lo, hi) in enumerate(bounds):
            build = "small" if i % 2 else "dup"
            qids.append(srv.submit(Q.scan("big").join(Q.scan(build), on="k")
                                   .filter("v", lo, hi).sum("w")))
            if i == 3:
                qids.append(srv.submit(Q.scan("big")
                                       .join(Q.scan("dup"), on="k")
                                       .filter("v", 0, 9).sum("w")))
            srv.pump()
        res = srv.drain()
        return [res[q] for q in qids], srv.stats()

    _build.reset_launches()
    got, st = serve(cuda)
    assert _build.LAUNCHES["probe_counts"] \
        + _build.LAUNCHES["probe_counts_sampled"] > 0
    want, cpu_st = serve("cpu")
    assert got == want and all(isinstance(v, int) for v in got)
    assert st["n_streamed"] == cpu_st["n_streamed"] == len(bounds)
    assert st["n_deduped"] == 1


@pytest.mark.parametrize("n,block", [(1, 1024), (1024, 1024),
                                     (7 * 1024 + 3, 1024),
                                     ((1 << 20) + 5, 4096)])
@pytest.mark.parametrize("lo,hi", [(0.1, 0.3), (-0.7, 0.7), (0, 1),
                                   (0.5, 0.25), (-1e39, 1e39),
                                   (float("-inf"), 0.0)])
def test_select_f32_route_matches_plain(cuda, n, block, lo, hi):
    """B1's float32 entry: bounds rounded to float32 (both 0.1 and 0.3
    move), NaN rows that match nothing, infinities and a ragged tail,
    bit for bit with the plain version, on its own counter."""
    r = np.random.default_rng(n + block)
    x = r.uniform(-1, 1, n).astype(np.float32)
    x[r.choice(n, min(n, 64), replace=False)] = r.choice(
        np.asarray([0.1, 0.3, -0.7, 0.7, 0.25, 0.5], np.float32),
        min(n, 64))
    x[r.choice(n, min(n, 8), replace=False)] = np.nan
    if n > 2:
        x[:2] = (np.inf, -np.inf)
    xc = torch.from_numpy(x).to(cuda)
    before = dict(_build.LAUNCHES)
    idx, counts = selection.select(xc, lo, hi, block=block)
    assert _build.LAUNCHES["select_f32"] == before["select_f32"] + 1
    assert _build.LAUNCHES["select"] == before["select"]
    idx_p, counts_p = selection.select_plain(xc, lo, hi, block=block)
    _same(idx, idx_p)
    _same(counts, counts_p)
    assert idx.dtype == torch.int32
    cpu_idx, _ = selection.select(torch.from_numpy(x), lo, hi, block=block)
    _same(idx, cpu_idx)


def test_select_refuses_other_types_on_the_card(cuda):
    for dtype in (torch.int64, torch.float64, torch.float16):
        with pytest.raises(TypeError, match="int32 or float32"):
            selection.select(torch.zeros(8, dtype=dtype, device=cuda), 0, 1)


def _float_filter_arrays(n=1 << 20):
    r = np.random.default_rng(31)
    return {"prices": {"price": (r.integers(0, 10 ** 7, n) / 100)
                       .astype(np.float32),
                       "q": r.integers(1, 51, n).astype(np.int32)}}


def test_eager_float_filter_on_the_card_equals_the_cpu(cuda):
    """The eager filter on a float32 column runs B1's float32 entry on
    the card (no fallback to the plain mask) and returns the CPU's rows."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q

    arrays = _float_filter_arrays()
    queries = (Q.scan("prices").filter("price", 1000, 30000)
               .project("price", "q"),
               Q.scan("prices").filter("price", 0, 1).project("price"))
    for q in queries:
        _build.reset_launches()
        got = Executor(catalog_from_arrays(arrays, cuda), cuda) \
            .execute(q, mode="eager").value
        assert _build.LAUNCHES["select_f32"] > 0
        want = Executor(catalog_from_arrays(arrays, "cpu"), "cpu") \
            .execute(q, mode="eager").value
        for c in want.columns:
            _same(got.column(c), want.column(c))
    s = Q.scan("prices").filter("price", 500, 900).sum("q")
    assert Executor(catalog_from_arrays(arrays, cuda), cuda) \
        .execute(s, mode="eager").value \
        == Executor(catalog_from_arrays(arrays, "cpu"), "cpu") \
        .execute(s, mode="eager").value


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
@pytest.mark.parametrize("n_s", [5_000, 60_000])
def test_join_shuffle_on_the_card_equals_the_cpu(cuda, n_shards, n_s):
    """The shuffle join on the card (B2 once per shard per pass) gives the
    CPU's pairs bit for bit, one pass a shard and several."""
    from repro_torch.columnar import engine
    from repro_torch.columnar.table import Table
    from repro_torch.distributed.sharding import ShardLayout

    r = np.random.default_rng(n_s + n_shards)
    l = r.integers(0, 20_000, 300_001).astype(np.int32)
    s = r.integers(0, 20_000, n_s).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        _build.reset_launches()
        out[dev.type] = engine.join_shuffle(
            Table.from_arrays("l", {"k": l}, dev),
            Table.from_arrays("s", {"k": s}, dev), "k",
            ShardLayout(n_shards))
        if dev.type == "cuda":
            s_cap = join_core._round_build_cap(
                join_core._bucket_cap(n_s, n_shards))
            assert _build.LAUNCHES["probe_counts"] \
                >= n_shards * -(-s_cap // join_core.HT_CAPACITY)
    for c in ("l_idx", "r_idx"):
        _same(out["cuda"].column(c), out["cpu"].column(c))


def test_sharded_executor_on_the_card_equals_the_cpu(cuda):
    """``Executor(shards=4)`` on the card, in every mode, over filters,
    a duplicate-keyed join, a unique-keyed join, a mean, a projection
    and a non-dividing table, equals the same executor on the CPU and the
    unsharded one on the card."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q

    r = np.random.default_rng(41)
    n = 1 << 20
    arrays = {"big": {"k": r.integers(0, 5000, n).astype(np.int32),
                      "v": r.integers(0, 100, n).astype(np.int32),
                      "w": r.integers(1, 50, n).astype(np.int32)},
              "odd": {"k": r.integers(0, 5000, n + 3).astype(np.int32),
                      "v": r.integers(0, 100, n + 3).astype(np.int32)},
              "small": {"k": np.asarray(r.choice(5000, 3000, replace=False),
                                        np.int32),
                        "x": r.integers(0, 9, 3000).astype(np.int32)},
              "dup": {"k": r.integers(0, 5000, 20_000).astype(np.int32),
                      "y": r.integers(1, 9, 20_000).astype(np.int32)}}
    queries = [
        Q.scan("big").filter("v", 10, 60).sum("w"),
        Q.scan("big").filter("v", 5, 50).mean("w"),
        Q.scan("big").join(Q.scan("dup"), on="k").filter("v", 0, 70)
         .sum("y"),
        Q.scan("big").join(Q.scan("small"), on="k").filter("v", 3, 90)
         .sum("x"),
        Q.scan("odd").join(Q.scan("dup"), on="k").filter("v", 20, 40)
         .count("k"),
    ]
    proj = Q.scan("big").join(Q.scan("small"), on="k") \
        .filter("v", 10, 30).project("w", "x")
    card = Executor(catalog_from_arrays(arrays, cuda), cuda, shards=4)
    plain = Executor(catalog_from_arrays(arrays, cuda), cuda)
    cpu = Executor(catalog_from_arrays(arrays, "cpu"), "cpu", shards=4)
    for i, q in enumerate(queries):
        for mode in ("batch", "stream", "eager"):
            kw = {"morsel_rows": 1 << 17} if mode == "stream" else {}
            _build.reset_launches()
            got = card.execute(q, mode=mode, **kw).value
            # eager filters select through B1; fused and streamed joins
            # probe through B2 (a fused filter is a mask, no kernel)
            if mode == "eager":
                assert _build.LAUNCHES["select"] > 0, (i, mode)
            elif i >= 2:
                assert _build.LAUNCHES["probe_counts"] \
                    + _build.LAUNCHES["probe_counts_sampled"] > 0, (i, mode)
            assert got == cpu.execute(q, mode=mode, **kw).value, (q, mode)
            assert got == plain.execute(q, mode=mode, **kw).value, (q, mode)
    got = card.execute(proj, mode="eager").value
    want = cpu.execute(proj, mode="eager").value
    for c in ("w", "x"):
        _same(got.column(c), want.column(c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_equals_the_cpu(cuda, dtype):
    """granite-moe's MoE layer at full width (40 experts, top 8) over one
    batch row of 512 tokens, on the card and on the CPU from the same
    weights and input.  Routing rule: the card's experts equal the CPU's
    wherever the CPU's boundary gap (k-th less (k+1)-th probability)
    exceeds ``MOE_MARGIN``; the row is compared when every routing
    decision agrees (printed), y within ``MOE_TOL`` of its largest
    magnitude in f32 and ``LM_TOL`` in bf16."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import MoE, aux_loss
    cfg = get_arch("granite-moe-3b-a800m")
    cpu = MoE(cfg)
    init_params(cpu, torch.Generator().manual_seed(7))
    card = MoE(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    if dtype == torch.float32:          # the experts' weights are bf16
        cpu.float(), card.float()
    x = torch.randn(1, 512, cfg.d_model,
                    generator=torch.Generator().manual_seed(8)).to(dtype)
    out = {}
    with torch.inference_mode():
        for where, mod in (("cpu", cpu), ("card", card)):
            xx = x.to(next(mod.parameters()).device)
            probs, _, ids = mod.route(xx)
            y, aux = mod(xx), aux_loss(probs, ids)
            out[where] = (probs.cpu(), ids.cpu(), y.float().cpu(),
                          float(aux))
    probs, ids_cpu = out["cpu"][:2]
    k = cfg.top_k
    top = probs.sort(-1, descending=True).values
    clear = (top[..., k - 1] - top[..., k]) > MOE_MARGIN
    same = (ids_cpu.sort(-1).values == out["card"][1].sort(-1).values).all(-1)
    assert bool(same[clear].all())
    print(f"{int((~clear).sum())} of {clear.numel()} decisions within "
          f"{MOE_MARGIN}; {int((~same).sum())} differ")
    assert bool(same.all()), "the one row's routing differs: no row to compare"
    tol = MOE_TOL if dtype == torch.float32 else LM_TOL
    y_cpu, y_card = out["cpu"][2], out["card"][2]
    assert float((y_card - y_cpu).abs().max()) <= tol * float(
        y_cpu.abs().max())
    assert abs(out["card"][3] - out["cpu"][3]) <= 1e-5 * out["cpu"][3]


# ---- training: the kernels' autograd Functions ----------------------------- #

GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the chunk-by-chunk plain scan against the chunk-parallel one: a_log's
# gradient (a sum over every token's decay with cancellations) rounds
# differently in f32, 9e-5 of its largest magnitude on the CPU
SSD_ORDER_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _grads_close(got, want, dtype_or_tol):
    tol = GRAD_TOL.get(dtype_or_tol, dtype_or_tol)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["causal", "cross", "position"])
def test_flash_attention_gradients_through_the_kernel_match_plain(
        cuda, d, dtype, kind):
    """B7 on a CUDA tensor that requires grad: the kernel launches once,
    its output carries a ``grad_fn``, and its gradients (the backward
    kernel's, one counted call) equal plain autograd's within
    ``GRAD_TOL`` of their largest magnitude: the served heads' dims
    (whisper's 64, stablelm-3b's 80, the GQA models' 128), causal, cross
    lengths, and masked by position."""
    g = torch.Generator(device=cuda).manual_seed(d)
    b, sq, sk, h, kvh = {"causal": (2, 300, 300, 8, 2),
                         "cross": (2, 70, 333, 4, 4),
                         "position": (2, 257, 257, 6, 3)}[kind]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    q, k, v = randn(b, sq, h, d), randn(b, sk, kvh, d), randn(b, sk, kvh, d)
    kw = dict(causal=kind != "cross")
    if kind == "position":
        pos = (torch.arange(sq, device=cuda) // 3).expand(b, sq)
        kw.update(q_pos=pos.to(torch.int32).contiguous(),
                  k_pos=pos.to(torch.int32).contiguous())
    go = randn(b, sq, h, d)
    ins = [t.requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    out = fa.flash_attention(*ins, **kw)
    assert out.grad_fn is not None
    assert _build.LAUNCHES[fa.COUNTER[fa.route(dtype, d)]] == 1
    got = torch.autograd.grad(out, ins, go)
    assert _build.LAUNCHES[fa.BACKWARD_COUNTER[fa.route(dtype, d)]] == 1
    want_out = fa_ref.attention_plain(*ins, **kw)
    want = torch.autograd.grad(want_out, ins, go)
    torch.cuda.synchronize()
    assert float((out - want_out).detach().abs().max()) <= ATTN_TOL[dtype]
    _grads_close(got, want, dtype)


def _bwd_inputs(cuda, b, sq, sk, h, kvh, d, dtype, form, seed):
    """q, k, v, go on the card and the mask arguments of a form: "causal"
    (by index), "position" (repeated positions) or "cross" (non-causal, Sq
    and Sk as given)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, go = (torch.randn(b, sq, h, d, generator=g).to(cuda, dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, kvh, d, generator=g).to(cuda, dtype)
            for _ in range(2))
    kw = dict(causal=form != "cross", q_pos=None, k_pos=None)
    if form == "position":
        qp, kp = (t.to(cuda) for t in _positions("repeats", b, sq, seed))
        kw.update(q_pos=qp, k_pos=kp)
    return q, k, v, go, kw


def _forward_with_lse(q, k, v, kw):
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    o = fa._launch(q, k, v, kw["causal"], kw["q_pos"], kw["k_pos"], lse)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form,sq,sk", [("causal", 37, 37),
                                        ("causal", 1000, 1000),
                                        ("position", 300, 300),
                                        ("cross", 37, 1000),
                                        ("cross", 1000, 37)])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_attention_forward_writes_the_plain_lse(cuda, dtype, form, sq,
                                                      sk, d):
    """Asked for it, each forward route writes the rows' log-sum-exp (B, H,
    Sq) f32 in natural units, equal to the plain ``_lse`` within 1e-5 (the
    scores are f32 sums of the same products), and the same output as
    without it, bit for bit."""
    q, k, v, _, kw = _bwd_inputs(cuda, 2, sq, sk, 6, 2, d, dtype, form,
                                 seed=sq + sk + d)
    o, lse = _forward_with_lse(q, k, v, kw)
    want = fa._lse(q, k, kw["causal"], kw["q_pos"], kw["k_pos"])
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, fa._launch(q, k, v, kw["causal"], kw["q_pos"],
                                     kw["k_pos"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("form,sq,sk", [("causal", 37, 37),
                                        ("causal", 1000, 1000),
                                        ("position", 37, 37),
                                        ("position", 1000, 1000),
                                        ("cross", 37, 1000),
                                        ("cross", 1000, 37)])
@pytest.mark.parametrize("group", [1, 3, 7])
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, d, form,
                                                       sq, sk, group):
    """The backward kernel (Delta, dK / dV by kv tile, dQ by q tile) against
    ``plain_backward`` on the same inputs, from the forward kernel's o and
    lse: every head dim, GQA 1, 3 and 7, ragged q and kv tiles, causal by
    index and by position at Sq == Sk and non-causal at other lengths,
    within ``GRAD_TOL`` of each gradient's largest magnitude (the kernel
    rounds P and dS to bf16 for its products, the plain version the
    unnormalised p), one counted call."""
    b = 2 if max(sq, sk) < 1000 else 1
    q, k, v, go, kw = _bwd_inputs(cuda, b, sq, sk, 2 * group, 2, d, dtype,
                                  form, seed=d + group + sq)
    o, lse = _forward_with_lse(q, k, v, kw)
    counter = fa.BACKWARD_COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa._launch_backward(go, q, k, v, o, lse, **kw)
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == counter) for c in before}
    want = fa.plain_backward(q, k, v, go, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["causal", "position", "cross"])
def test_flash_attention_backward_kernel_is_deterministic(cuda, dtype, form):
    """No atomics, and where a GQA group's q heads take dK / dV blocks of
    their own (bf16), their shares are summed in the group's order: two
    backward calls on the same inputs give the same bits (GQA 4, ragged
    tiles)."""
    sk = 333 if form == "cross" else 517
    q, k, v, go, kw = _bwd_inputs(cuda, 2, 517, sk, 8, 2, 128, dtype, form,
                                  seed=9)
    o, lse = _forward_with_lse(q, k, v, kw)
    first = fa._launch_backward(go, q, k, v, o, lse, **kw)
    second = fa._launch_backward(go, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_never_reaches_the_plain_version(
        cuda, dtype, monkeypatch):
    """On CUDA tensors the Function's backward is the kernel's call: with
    ``plain_backward`` made to raise, autograd still gives the gradients,
    and the forward and backward counters each move once; a strided
    gradient from autograd is taken (made contiguous)."""
    def refuse(*a, **kw):
        raise AssertionError("plain_backward on a CUDA tensor")
    q, k, v, go, kw = _bwd_inputs(cuda, 2, 200, 200, 6, 2, 64, dtype,
                                  "causal", seed=4)
    want = fa.plain_backward(q, k, v, go, **kw)
    monkeypatch.setattr(fa, "plain_backward", refuse)
    ins = [t.requires_grad_() for t in (q, k, v)]
    rt = fa.route(dtype, 64)
    before = dict(_build.LAUNCHES)
    out = fa.flash_attention(*ins, causal=True)
    # a strided output gradient: a transposed copy's transpose
    go_strided = go.transpose(1, 2).contiguous().transpose(1, 2)
    assert not go_strided.is_contiguous()
    got = torch.autograd.grad(out, ins, go_strided)
    torch.cuda.synchronize()
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c in (fa.COUNTER[rt], fa.BACKWARD_COUNTER[rt]))
         for c in before}
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_rows_without_a_key_match_plain(cuda, dtype):
    """Position-masked rows whose q position is below every k position keep
    no key: the forward and the backward equal the plain version, which
    averages every key (no gradient reaches q or k through such a row),
    and nothing is NaN; such a row's lse is the mask, -1e30."""
    b, s, h, kvh, d = 2, 150, 4, 2, 64
    q, k, v, go, _ = _bwd_inputs(cuda, b, s, s, h, kvh, d, dtype, "causal",
                                 seed=12)
    qp, kp = (t.to(cuda) for t in _positions("no_key_rows", b, s, 0))
    kw = dict(causal=True, q_pos=qp, k_pos=kp)
    o, lse = _forward_with_lse(q, k, v, kw)
    want_o = fa_ref.attention_plain(q, k, v, q_pos=qp, k_pos=kp)
    got = fa._launch_backward(go, q, k, v, o, lse, **kw)
    want = fa.plain_backward(q, k, v, go, **kw)
    torch.cuda.synchronize()
    dead = qp < kp.min(-1, keepdim=True).values
    assert bool(dead.any()) and bool((~dead).any())
    assert bool((lse.transpose(1, 2)[dead] == -1e30).all())
    assert bool(torch.isfinite(o).all())
    assert float((o.float() - want_o.float()).abs().max()) <= \
        ATTN_TOL[dtype]
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("group", [1, 3, 7])
def test_flash_attention_backward_tile_lists_skip_and_keep_dead_rows(
        cuda, dtype, d, group):
    """Under the position mask both backward routes walk tile lists:
    Qwen2-VL's patches (128 at one t, the text rising after them), q rows
    64 .. 127 below every k position (rows that keep no key: they average
    every key and add 1 / Sk . dO to every kv row's dV) and k positions
    past every q position from row 512 on (kv tiles that no kept pair
    reaches, which only the dead rows' q tiles visit).  The gradients
    equal ``plain_backward``'s within ``GRAD_TOL``, finite, one counted
    call, two calls bit-identical."""
    s = 640
    q, k, v, go, kw = _bwd_inputs(cuda, 1, s, s, 2 * group, 2, d, dtype,
                                  "causal", seed=d + group)
    i = np.arange(s)
    qp = np.where(i < 128, 0, 16 + i - 128)
    kp = qp.copy()
    qp[64:128] = -1
    kp[512:] = 10 ** 6
    kw.update(q_pos=torch.from_numpy(qp[None].astype(np.int32)).to(cuda),
              k_pos=torch.from_numpy(kp[None].astype(np.int32)).to(cuda))
    o, lse = _forward_with_lse(q, k, v, kw)
    counter = fa.BACKWARD_COUNTER[fa.route(dtype, d)]
    before = dict(_build.LAUNCHES)
    got = fa._launch_backward(go, q, k, v, o, lse, **kw)
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == counter) for c in before}
    again = fa._launch_backward(go, q, k, v, o, lse, **kw)
    want = fa.plain_backward(q, k, v, go, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert float(got[1][:, 512:].abs().max()) == 0.0   # no kept pair
    assert float(got[2][:, 512:].abs().max()) > 0.0    # the dead rows' dO
    _grads_close(got, want, dtype)


def test_flash_attention_backward_refuses_what_it_does_not_take(cuda):
    q, k, v, go, kw = _bwd_inputs(cuda, 1, 64, 64, 4, 2, 64, torch.float32,
                                  "causal", seed=1)
    o, lse = _forward_with_lse(q, k, v, kw)
    with pytest.raises(ValueError, match="lse"):
        fa._launch_backward(go, q, k, v, o, None, **kw)
    with pytest.raises(ValueError, match="lse"):
        fa._launch_backward(go, q, k, v, o, lse[:, :2], **kw)
    with pytest.raises(TypeError):
        fa._launch_backward(go.bfloat16(), q, k, v, o, lse, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        fa._launch_backward(go, q, k, v, o, lse.cpu(), **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_gradients_through_the_kernel_match_plain(cuda, dtype):
    """B8 on CUDA tensors that require grad at mamba2-780m's widths (64,
    ds 128; the tensor-core route in bf16, the CUDA cores in f32) over
    two whole chunks and a ragged one with strong decays: one launch, a
    ``grad_fn``, and the plain version's gradients, finite: within
    ``GRAD_TOL`` of the chunk-parallel form's, within ``SSD_ORDER_TOL`` of
    the chunk-by-chunk form's, with and without the final state's
    gradient.  The backward is a kernel of its own, so the plain forms
    run in f64 on the same inputs: under these decays a chunk's
    log-decays sum to thousands, and the f32 plain version's own rounding
    of them puts its gradients (a_log's most) further from their f64
    values than ``GRAD_TOL``."""
    g = torch.Generator(device=cuda).manual_seed(5)
    bsz, s, nh, hd, ng, ds = 2, 300, 8, 64, 1, 128

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda).to(dt)
    x, b, c = randn(bsz, s, nh, hd), randn(bsz, s, ng, ds), \
        randn(bsz, s, ng, ds)
    dt = torch.rand(bsz, s, nh, generator=g, device=cuda) * 2
    a_log = torch.log(1 + 15 * torch.rand(nh, generator=g, device=cuda))
    d_skip = randn(nh, dt=torch.float32)
    ins = [t.requires_grad_() for t in (x, dt, a_log, b, c, d_skip)]
    _build.reset_launches()
    y, h = ssd_kernels.ssd_scan(*ins)
    assert y.grad_fn is not None
    assert _build.LAUNCHES[ssd_kernels.COUNTER[
        ssd_kernels.route(dtype, hd, ds)]] == 1
    gy, gh = randn(bsz, s, nh, hd), randn(bsz, nh, hd, ds, dt=torch.float32)
    ins64 = [t.detach().double().requires_grad_() for t in ins]
    for plain, tol in ((ssd_ref.ssd_chunked_plain, GRAD_TOL[dtype]),
                       (ssd_ref.ssd_plain, SSD_ORDER_TOL[dtype])):
        y_p, h_p = plain(*ins64)
        for outs, wants, grads in (((y, h), (y_p, h_p), (gy, gh)),
                                   ((y,), (y_p,), (gy,))):
            got = torch.autograd.grad(outs, ins, grads, retain_graph=True)
            want = torch.autograd.grad(wants, ins64,
                                       [t.double() for t in grads],
                                       retain_graph=True)
            assert all(bool(torch.isfinite(t).all()) for t in got)
            _grads_close(got, [w.to(t.dtype) for w, t in zip(want, ins)],
                         tol)


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-780m"])
def test_smoke_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """A 2-layer f32 smoke model's loss and every gradient through
    ``loss_fn`` (the checkpointed layers, the kernels' f32 routes and
    their Functions) on the card against the CPU's plain autograd on the
    same weights: loss within 1e-5, each gradient within 1e-3 of its
    largest magnitude; B7 / B8 launched twice a layer (the forward and
    the recompute)."""
    import dataclasses
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.serve import build_model
    from repro_torch.train.data import DataConfig, synthetic_batch
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), num_layers=2)
    mb, cpu_model = build_model(cfg, torch.device("cpu"), seed=3)
    _, card_model = build_model(cfg, cuda, seed=3)
    cpu_model.float(), card_model.float()
    card_model.load_state_dict(cpu_model.state_dict())
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 200, 2, seed=1), 0)
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        params = [p.requires_grad_() for p in model.parameters()]
        _build.reset_launches()
        loss, _ = mb.loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params)
        out[dev] = (float(loss.detach()), [t.cpu() for t in grads],
                    dict(_build.LAUNCHES))
    kernel = "ssd" if cfg.family == "ssm" else "flash_attention_f32"
    assert out["cuda"][2][kernel] == 4 and out["cpu"][2][kernel] == 0
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert bool(got.any())
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())


# --------------------------------------------------------------------------- #
# the distributed layer on a one-rank NCCL group, against the same calls on
# the CPU (a gloo mesh of the same group)

@pytest.fixture
def card_and_cpu_meshes(cuda, tmp_path):
    """One process group with NCCL for the card and gloo for the CPU; the
    card's mesh (``make_host_mesh()``) and the CPU's."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"file://{tmp_path / 'store'}",
        rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield mesh_mod.make_host_mesh(), mesh_mod.make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_starts_nccl_on_the_card(cuda):
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    assert not dist.is_initialized()
    mesh = mesh_mod.make_host_mesh()
    try:
        assert dist.get_backend() == "nccl"
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_without_a_card_raises(cuda, monkeypatch):
    """No card means no mesh: nothing falls back to the CPU or gloo."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_host_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_decode_on_the_card_equals_the_cpu(card_and_cpu_meshes, dtype):
    from repro_torch.distributed import context_parallel as cp
    card, cpu = card_and_cpu_meshes
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((2, 8, 1, 64), (2, 4096, 8, 64), (2, 4096, 8, 64)))
    valid = torch.rand(2, 4096, generator=g) > 0.3
    valid[1] = False                     # a row with no valid key
    want = cp.cp_decode_attention(cpu, "model", q, k, v, valid)
    got = cp.cp_decode_attention(card, "model", *(t.cuda() for t in
                                                  (q, k, v, valid)))
    assert got.device.type == "cuda" and got.dtype == dtype
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)
    ref = cp.cp_decode_reference(*(t.cuda() for t in (q, k, v, valid)))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


def test_pipeline_on_the_card_equals_the_cpu(card_and_cpu_meshes):
    from repro_torch.distributed import pipeline
    card, cpu = card_and_cpu_meshes
    g = torch.Generator().manual_seed(1)
    w = torch.randn(64, 64, generator=g) / 8
    x = torch.randn(8, 16, 64, generator=g)

    def stage(p, xb):
        return torch.tanh(xb @ p)

    want = pipeline.pipeline_apply(cpu, "model", stage, w, x, 4)
    got = pipeline.pipeline_apply(card, "model", stage, w.cuda(), x.cuda(), 4)
    by_micro = torch.cat([stage(w.cuda(), x[i:i + 2].cuda())
                          for i in range(0, 8, 2)])
    _same(got, by_micro)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_compressed_psum_on_the_card_equals_the_cpu(card_and_cpu_meshes):
    """Payloads, scales, means and residuals bit for bit over two steps of
    error feedback, on leaves whose largest magnitudes span many scales
    (a scale divided on the card by a reciprocal would miss by an ulp)."""
    from repro_torch.distributed import compression as comp
    from repro_torch.train.checkpoint import flatten
    card, cpu = card_and_cpu_meshes
    g = torch.Generator().manual_seed(2)
    grads = {"w": torch.randn(256, 96, generator=g),
             "many": [torch.randn(97, generator=g) * float(i + 1) ** 3
                      for i in range(64)],
             "z": torch.zeros(16),
             "t": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5])}
    res = comp.zero_residual(grads)

    def to_card(tree):
        return {k: [t.cuda() for t in v] if isinstance(v, list) else v.cuda()
                for k, v in tree.items()}

    def same(a, b):
        for (pa, x), (pb, y) in zip(flatten(a), flatten(b)):
            assert pa == pb and torch.equal(x.cpu(), y), pa

    for _ in range(2):
        q_tree, new_res = comp.compress_tree(grads, res)
        c_q, c_res = comp.compress_tree(to_card(grads), to_card(res))
        same(c_res, new_res)
        same(comp.decompress_tree(c_q), comp.decompress_tree(q_tree))
        mean, p_res = comp.compressed_psum(cpu, "model")(grads, res)
        c_mean, c_p_res = comp.compressed_psum(card, "model")(to_card(grads),
                                                              to_card(res))
        same(c_mean, mean)
        same(c_p_res, p_res)
        same(mean, comp.decompress_tree(q_tree))
        res = new_res


def test_restore_onto_the_card_mesh_equals_the_cpu(card_and_cpu_meshes,
                                                   tmp_path):
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    from repro_torch.train import checkpoint
    card, cpu = card_and_cpu_meshes
    cfg = smoke_config(get_arch("jamba-v0.1-52b"))
    specs = registry.bundle(cfg).init_specs(1)
    g = torch.Generator().manual_seed(3)
    params = {k: (0.02 * torch.randn(la.shape, generator=g)).to(la.dtype)
              for k, la in specs.items()}
    checkpoint.save(tmp_path / "ckpt", 1, params)
    outs = []
    for mesh in (card, cpu):
        rules = sharding.resolve(cfg, mesh)
        shardings = sharding.tree_shardings(specs, rules)
        got, _ = checkpoint.restore(tmp_path / "ckpt", params,
                                    shardings=shardings)
        for k, x in got.items():
            assert x.placements == shardings[k][1]
            assert x.to_local().device.type == mesh.device_type
        outs.append(got)
    for k in params:
        card_local = outs[0][k].to_local().cpu()
        assert torch.equal(card_local, outs[1][k].to_local()), k
        assert torch.equal(card_local, params[k]), k


def test_launchers_start_and_destroy_a_one_rank_nccl_group(cuda, tmp_path,
                                                           capsys):
    """``launch.train`` and ``launch.serve`` on the card with no group:
    each starts a one-rank NCCL group, keeps plain parameters, launches
    B7 once a layer a prefill (twice a layer a train step), and leaves no
    group behind; a DTensor tree saved on the card's one-rank mesh is the
    plain tree's checkpoint."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import registry
    from repro_torch.train import checkpoint
    assert not dist.is_initialized()
    _build.reset_launches()
    model, losses = train_mod.train("llama3-8b", steps=2, seq_len=128,
                                    global_batch=2)
    cfg = smoke_config(get_arch("llama3-8b"))
    assert _build.LAUNCHES["flash_attention_tc"] == 2 * 2 * cfg.num_layers
    assert not dist.is_initialized() and all(np.isfinite(losses))
    assert not any(isinstance(p, DTensor) for p in model.parameters())
    _build.reset_launches()
    gen = serve_mod.serve("llama3-8b", gen_len=4)
    assert _build.LAUNCHES["flash_attention_tc"] == cfg.num_layers
    assert gen.shape == (4, 4) and not dist.is_initialized()
    out = capsys.readouterr().out
    assert "1-rank nccl group, started from file://" in out
    params = {n: p.detach() for n, p in model.named_parameters()}
    with mesh_mod.process_group(cuda):
        mesh = mesh_mod.make_host_mesh(cuda)
        rules = sharding.resolve(cfg, mesh)
        specs = registry.bundle(cfg).init_specs(1)
        tree = {n: sharding.from_whole(t, *rules.named(*specs[n].logical))
                for n, t in params.items()}
        checkpoint.save(tmp_path / "d", 1, tree)
    assert not dist.is_initialized()
    checkpoint.save(tmp_path / "p", 1, params)
    for d in ("d", "p"):
        got, _ = checkpoint.restore(tmp_path / d, params)
        assert all(torch.equal(got[n], params[n]) for n in params), d


# ---- B7's bf16 backward (wgmma, TMA ring): its shapes and tile lists ------ #

def _bwd_positions(pattern, s, cuda):
    """(q_pos, k_pos) int32 (1, s) on the card: Qwen2-VL's layout (256
    patches at one t, the text rising after them), or that layout with the
    second 64-row q tile below every k position (its rows keep no key) and
    the last 128-row kv tile above every q position (no kept pair reaches
    it: its dV is the dead rows' 1 / Sk share alone)."""
    qp = _vlm_t(s, 256).copy()
    kp = qp.copy()
    if pattern == "dead_tile":
        qp[64:128] = -1
        kp[(s - 1) // 128 * 128:] = 10 ** 6
    return tuple(_i32(a[None], cuda) for a in (qp, kp))


def _bwd_against_plain(cuda, b, sq, sk, h, kvh, d, form, seed, pos=None):
    q, k, v, go, kw = _bwd_inputs(cuda, b, sq, sk, h, kvh, d, torch.bfloat16,
                                  form, seed=seed)
    if pos is not None:
        kw.update(q_pos=pos[0], k_pos=pos[1])
    o, lse = _forward_with_lse(q, k, v, kw)
    before = dict(_build.LAUNCHES)
    got = fa._launch_backward(go, q, k, v, o, lse, **kw)
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == "flash_attention_bwd_tc") for c in before}
    want = fa.plain_backward(q, k, v, go, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _grads_close(got, want, torch.bfloat16)
    return got, want


@pytest.mark.parametrize("group", [1, 3])
def test_flash_attention_bf16_backward_at_d80_full_length(cuda, group):
    """stablelm-3b's head dim (dK, dV and dQ on wgmma's n80 shape, the
    second 64-column box read in part) at its training length, 4,096,
    causal, GQA 1 and 3: every step of the causal schedule, the heaviest
    tiles first, within ``GRAD_TOL``."""
    _bwd_against_plain(cuda, 1, 4096, 4096, 2 * group, 2, 80, "causal",
                       seed=80 + group)


@pytest.mark.parametrize("s", [1000, 4096])
def test_flash_attention_bf16_backward_by_qwen2_vl_positions(cuda, s):
    """Masked by Qwen2-VL's positions (256 patches at one t, then text), as
    its training step runs it (GQA 7, D 128): dQ over the forward's kv tile
    lists, dK / dV over their transpose, which leaves out the q tiles of
    the patches for the text's kv tiles."""
    pos = _bwd_positions("qwen2_vl", s, cuda)
    visits = fa_ref.kv_tile_visits(*pos)
    assert not bool(visits.all())
    _bwd_against_plain(cuda, 1, s, s, 7, 1, 128, "causal", seed=s, pos=pos)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_backward_dead_q_tile(cuda, d):
    """A whole 64-row q tile keeps no key (each of its rows averages every
    key) and no kept pair reaches the last kv tile: that tile's dK / dV
    block still visits the dead q tile, so its dV is the dead rows' 1 / Sk
    share of dO, as ``plain_backward`` has it."""
    s = 1000
    pos = _bwd_positions("dead_tile", s, cuda)
    visits = fa_ref.kv_tile_visits(*pos)
    assert visits[0, -1].nonzero().flatten().tolist() == [1]
    got, want = _bwd_against_plain(cuda, 1, s, s, 4, 2, d, "causal",
                                   seed=d, pos=pos)
    assert float(want[2][:, (s - 1) // 128 * 128:].float().abs().max()) > 0


@pytest.mark.parametrize("form,sq,sk", [("causal", 1003, 1003),
                                        ("causal", 6, 6),
                                        ("cross", 1003, 61),
                                        ("cross", 21, 1003)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_backward_rows_off_a_16_byte_stride(cuda, form,
                                                                 sq, sk, d):
    """Sq % 4 != 0: the (B, H, Sq) f32 rows of lse and Delta start off a
    16-byte mark for most heads, which the producer's plain loads take."""
    _bwd_against_plain(cuda, 2, sq, sk, 6, 2, d, form, seed=sq + sk + d)


def test_flash_attention_bf16_backward_is_deterministic_at_granite_moe(cuda):
    """Two backward calls at granite-moe's training shape (1 x 4,096 x 24
    x 64, GQA 3, causal) give the same bits: each output is written by one
    block, whose sums run in a fixed order."""
    q, k, v, go, kw = _bwd_inputs(cuda, 1, 4096, 4096, 24, 8, 64,
                                  torch.bfloat16, "causal", seed=3)
    o, lse = _forward_with_lse(q, k, v, kw)
    first = fa._launch_backward(go, q, k, v, o, lse, **kw)
    second = fa._launch_backward(go, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_bf16_backward_on_a_thread_without_cuda_calls(cuda):
    """The backward's first call on a thread that has made no CUDA call
    (autograd's worker, when the attention's backward is its first op)
    encodes its tensor maps all the same: the kernel binds the data's
    device first."""
    import threading
    q, k, v, go, kw = _bwd_inputs(cuda, 2, 300, 300, 8, 2, 64,
                                  torch.bfloat16, "causal", seed=5)
    o, lse = _forward_with_lse(q, k, v, kw)
    want = fa.plain_backward(q, k, v, go, **kw)
    got = {}

    def run():
        try:
            got["grads"] = fa._launch_backward(go, q, k, v, o, lse, **kw)
            torch.cuda.synchronize()
        except Exception as e:               # reported below
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    _grads_close(got["grads"], want, torch.bfloat16)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("form,sq,sk", [("causal", 517, 517),
                                        ("position", 300, 300),
                                        ("cross", 37, 1003)])
@pytest.mark.parametrize("d,group", [(64, 3), (80, 7), (128, 7)])
def test_flash_attention_bf16_backward_group_loop_and_split(
        cuda, monkeypatch, split, form, sq, sk, d, group):
    """Both ways of the bf16 backward's dK / dV with GQA, whichever
    ``_splits_group`` would pick at this shape: a block a kv head looping
    over its group, or a block a q head with the group's f32 shares summed
    in order after; each within ``GRAD_TOL`` of ``plain_backward``, and
    two calls give the same bits."""
    monkeypatch.setattr(fa, "_splits_group", lambda *a: split)
    got, _ = _bwd_against_plain(cuda, 2, sq, sk, 2 * group, 2, d, form,
                                seed=sq + d + group)
    q, k, v, go, kw = _bwd_inputs(cuda, 2, sq, sk, 2 * group, 2, d,
                                  torch.bfloat16, form, seed=sq + d + group)
    o, lse = _forward_with_lse(q, k, v, kw)
    again = fa._launch_backward(go, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form,sq,sk", [("causal", 517, 517),
                                        ("position", 300, 300),
                                        ("cross", 37, 1003)])
@pytest.mark.parametrize("d,group", [(64, 3), (80, 7), (128, 7)])
def test_flash_attention_f32_backward_splits_every_gqa_group(
        cuda, monkeypatch, form, sq, sk, d, group):
    """The f32 backward's dK / dV with GQA, a block a q head and the
    group's f32 shares summed in order after (the fourth launch),
    whatever ``_splits_group`` would say for bf16: within ``GRAD_TOL`` of
    ``plain_backward``, one counted call, and two calls give the same
    bits."""
    monkeypatch.setattr(fa, "_splits_group", lambda *a: False)
    q, k, v, go, kw = _bwd_inputs(cuda, 2, sq, sk, 2 * group, 2, d,
                                  torch.float32, form, seed=sq + d + group)
    o, lse = _forward_with_lse(q, k, v, kw)
    before = dict(_build.LAUNCHES)
    got = fa._launch_backward(go, q, k, v, o, lse, **kw)
    assert {c: _build.LAUNCHES[c] - before[c] for c in before} == \
        {c: int(c == "flash_attention_bwd_f32") for c in before}
    again = fa._launch_backward(go, q, k, v, o, lse, **kw)
    want = fa.plain_backward(q, k, v, go, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _grads_close(got, want, torch.float32)


def test_flash_attention_f32_backward_refuses_gqa_without_scratch(cuda):
    """The f32 entry needs the q heads' scratch for a GQA group: given
    none it launches nothing and returns cudaErrorInvalidValue (1)."""
    q, k, v, go, kw = _bwd_inputs(cuda, 1, 64, 64, 6, 2, 64, torch.float32,
                                  "causal", seed=3)
    o, lse = _forward_with_lse(q, k, v, kw)
    delta = torch.empty((1, 6, 64), dtype=torch.float32, device=cuda)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    fn = _build.function(fa.BACKWARD_ENTRY["tf32x3"])
    rc = fn(go.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, 64, 64, 6, 2,
            64, 1, None, None, 64 ** -0.5, _build.stream_handle(cuda))
    assert rc == 1


def test_flash_attention_bf16_backward_splits_only_a_short_grid(cuda):
    """The split is taken where the group loop's dK / dV blocks are fewer
    than the card's SMs (qwen2-vl's 4 kv heads at 4,096), not where they
    fill it (granite-moe's 8 kv heads) nor without GQA."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows = fa.BACKWARD_BLOCKS["tc"][1]
    assert fa._splits_group(cuda, 1, 28, 4, 4096) == (4 * 32 < sms)
    assert fa._splits_group(cuda, 1, 24, 8, 4096) == (8 * 32 < sms)
    assert not fa._splits_group(cuda, 1, 32, 32, 128)
    assert fa._splits_group(cuda, 1, 8, 2, rows)


def test_flash_attention_forward_on_a_thread_without_cuda_calls(cuda):
    """The forward's first call on a thread that has made no CUDA call
    encodes its tensor maps all the same (the launcher binds the data's
    device first), to the main thread's bits."""
    import threading
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 300, n, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for n in (8, 2, 2))
    want = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["o"] = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
        except Exception as e:               # reported below
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    assert torch.equal(got["o"], want)


# ---- B8's backward kernel -------------------------------------------------- #

def _ssd_grad_inputs(device, bsz, s, nh, hd, ng, ds, dtype, seed=0,
                     strong=False):
    """The scan's six inputs (Mamba-2's init ranges: dt in [0.001, 0.1], A
    in [1, 16]; or strong decays, dt in [0, 2]), gy like x and gh f32."""
    r = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))
    dt = r.uniform(0.0, 2.0, (bsz, s, nh)) if strong else \
        r.uniform(0.001, 0.1, (bsz, s, nh))
    args = (f(bsz, s, nh, hd).to(device, dtype),
            torch.from_numpy(dt.astype(np.float32)).to(device),
            torch.from_numpy(np.log(r.uniform(1.0, 16.0, nh))
                             .astype(np.float32)).to(device),
            f(bsz, s, ng, ds).to(device, dtype),
            f(bsz, s, ng, ds).to(device, dtype), f(nh).to(device))
    return args, f(bsz, s, nh, hd).to(device, dtype), \
        f(bsz, nh, hd, ds).to(device)


def _plain_grads64(args, gy, gh, chunk=128):
    """``plain_backward`` on the same inputs in f64, each gradient in its
    input's type: the reference the kernel is held to."""
    want = ssd_kernels.plain_backward(
        *(t.double() for t in args), gy.double(),
        None if gh is None else gh.double(), chunk=chunk)
    return [w.to(t.dtype) for w, t in zip(want, args)]


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("chunk", [32, 64, 96, 128])
@pytest.mark.parametrize("hd,ds,ng", [(64, 128, 1), (64, 16, 1), (64, 128, 2),
                                      (16, 16, 2), (128, 128, 2), (80, 48, 1),
                                      (33, 97, 2), (40, 24, 1), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_matches_plain(cuda, dtype, hd, ds, ng, chunk, with_gh):
    """Both routes of the backward kernel (tensor cores for bf16 at widths
    that are multiples of 16: mamba2-780m's 64 / 128, jamba's 64 / 16; the
    CUDA-core route, split TF32 on mma.sync, for f32 and for bf16 at other
    widths: 33 x 97, 40 x 24, 1 x 1, each padded to a multiple of 8)
    against ``plain_backward`` in f64 within ``GRAD_TOL`` of each
    gradient's largest magnitude (1e-5 in f32), over a ragged last chunk,
    with and without the final state's gradient; one counted call on its
    route's counter."""
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 300, 4, hd, ng, ds, dtype,
                                    seed=hd + ds + chunk)
    gh = gh if with_gh else None
    counter = ssd_kernels.BACKWARD_COUNTER[ssd_kernels.route(dtype, hd, ds)]
    before = dict(_build.LAUNCHES)
    got = ssd_kernels._scan_backward(*args, gy, gh, chunk)
    assert _ssd_counts(before) == {k: int(k == counter) for k in before}
    _grads_close(got, _plain_grads64(args, gy, gh, chunk), dtype)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("hd,ds,ng", [(64, 128, 1), (64, 16, 1), (64, 16, 4),
                                      (64, 128, 3), (128, 64, 2),
                                      (128, 128, 1), (32, 48, 2)])
def test_ssd_backward_chunk_pass_on_wgmma(cuda, hd, ds, ng, strong):
    """The tensor-core route's chunk pass (two warpgroups on wgmma, hd and
    ds padded to 64 or 128, the states resident together or one after the
    other) at mamba2-780m's widths (hd 64, ds 128), jamba's (ds 16) and
    the other paddings, one group and several, over whole chunks and a
    ragged last one, with Mamba-2's decays and strong ones (dt up to 2):
    the gradients finite, within the bf16 ``GRAD_TOL`` of the plain version
    in f64, one counted call, two calls bit-identical; the pass takes one
    block an SM."""
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 300, 2 * ng, hd, ng, ds,
                                    torch.bfloat16, seed=hd + ds + ng,
                                    strong=strong)
    assert ssd_kernels.route(torch.bfloat16, hd, ds) == "tc"
    before = dict(_build.LAUNCHES)
    got = ssd_kernels._scan_backward(*args, gy, gh, 128)
    assert _ssd_counts(before) == {k: int(k == "ssd_bwd_tc") for k in before}
    again = ssd_kernels._scan_backward(*args, gy, gh, 128)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, _plain_grads64(args, gy, gh), torch.bfloat16)
    blocks, _ = ssd_kernels.backward_occupancy(torch.bfloat16, hd, ds,
                                               128)["chunk"]
    assert blocks == 1


@pytest.mark.parametrize("hd,ds", [(64, 128), (64, 16), (33, 97)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_stays_finite_under_strong_decays(cuda, dtype, hd, ds):
    """dt up to 2 and A up to 16 over whole 128-token chunks, at
    mamba2-780m's widths, jamba's and odd ones (both routes in bf16, the
    split-TF32 route in f32): every gradient finite and within
    ``GRAD_TOL`` of the plain version's in f64."""
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 512, 8, hd, 1, ds, dtype,
                                    seed=3, strong=True)
    got = ssd_kernels._scan_backward(*args, gy, gh, 128)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _grads_close(got, _plain_grads64(args, gy, gh), dtype)


@pytest.mark.parametrize("hd,ds", [(64, 128), (40, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_two_calls_are_bit_identical(cuda, dtype, hd, ds):
    """No atomics: the heads' shares of db and dc (across a cluster of 8
    heads, then the clusters) and the blocks' shares of da_log and d_skip
    are summed in a fixed order, on both routes."""
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 2000, 8, hd, 1, ds, dtype,
                                    seed=5)
    first = ssd_kernels._scan_backward(*args, gy, gh, 128)
    second = ssd_kernels._scan_backward(*args, gy, gh, 128)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd,ds", [(64, 128), (33, 97)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_launches_the_backward_kernel(cuda, monkeypatch, dtype,
                                                   hd, ds):
    """With ``plain_backward`` made to raise, autograd through ``ssd_scan``
    still gives the gradients: one forward launch and one backward call,
    each on its route's counter."""
    def refuse(*args, **kw):
        raise AssertionError("plain_backward ran on the card")
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 300, 4, hd, 2, ds, dtype,
                                    seed=11)
    want = _plain_grads64(args, gy, gh)
    monkeypatch.setattr(ssd_kernels, "plain_backward", refuse)
    ins = [t.clone().requires_grad_() for t in args]
    rt = ssd_kernels.route(dtype, hd, ds)
    _build.reset_launches()
    y, h = ssd_kernels.ssd_scan(*ins)
    got = torch.autograd.grad((y, h), ins, (gy, gh))
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        ssd_kernels.COUNTER[rt]: 1, ssd_kernels.BACKWARD_COUNTER[rt]: 1}
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("hd,ds", [(64, 128), (33, 97)])
@pytest.mark.parametrize("which", ["x", "dt", "b", "c", "gy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_takes_misaligned_views(cuda, which, dtype, hd, ds):
    """A contiguous view that starts off a 16-byte mark is staged by
    narrower copies, to the same bits, as the forward takes it."""
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 200, 4, hd, 1, ds, dtype,
                                    seed=3)
    args = list(args)
    want = ssd_kernels._scan_backward(*args, gy, gh, 128)
    t = gy if which == "gy" else args[{"x": 0, "dt": 1, "b": 3,
                                        "c": 4}[which]]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    if which == "gy":
        gy = view
    else:
        args[{"x": 0, "dt": 1, "b": 3, "c": 4}[which]] = view
    got = ssd_kernels._scan_backward(*args, gy, gh, 128)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ssd_backward_refuses_what_it_does_not_take(cuda):
    """A gradient of another shape, a width or chunk past the kernel's, is
    refused before any launch."""
    args, gy, gh = _ssd_grad_inputs(cuda, 1, 64, 2, 64, 1, 64, torch.float32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="gy"):
        ssd_kernels._scan_backward(*args, gy[:, :32], gh, 128)
    with pytest.raises(ValueError, match="gh"):
        ssd_kernels._scan_backward(*args, gy, gh[:, :1], 128)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernels._scan_backward(*args, gy, gh, 48)
    wide, gy_w, gh_w = _ssd_grad_inputs(cuda, 1, 64, 2, 64, 1, 256,
                                        torch.float32)
    with pytest.raises(ValueError, match="ds <= 128"):
        ssd_kernels._scan_backward(*wide, gy_w, gh_w, 128)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_of_no_rows_launches_nothing(cuda, dtype):
    """A batch of no rows gives zero gradients of the inputs' shapes and
    types, and neither launches nor counts a kernel."""
    args, gy, gh = _ssd_grad_inputs(cuda, 0, 64, 2, 64, 1, 64, dtype)
    before = dict(_build.LAUNCHES)
    got = ssd_kernels._scan_backward(*args, gy, gh, 128)
    assert _build.LAUNCHES == before
    assert [(tuple(g.shape), g.dtype) for g in got] == \
        [(tuple(t.shape), t.dtype) for t in args]
    assert not any(g.any() for g in got)


def test_ssd_backward_fits_the_card(cuda):
    """The passes with shared memory of their own fit at the widest shape
    the kernel takes (the chunk pass one block an SM); at mamba2-780m's
    widths the states pass fits more than one; the chunk pass's clusters
    of up to 8 heads fit on both routes at every padding, at least one at
    once."""
    for dtype in (torch.float32, torch.bfloat16):
        for p, (blocks, _) in ssd_kernels.backward_occupancy(
                dtype, 128, 128, 128).items():
            assert blocks >= 1, (dtype, p)
        occ = ssd_kernels.backward_occupancy(dtype, 64, 128, 128)
        assert occ["states"][0] >= 2, occ
    for dtype, hd, ds in ((torch.bfloat16, 64, 128), (torch.bfloat16, 64, 16),
                          (torch.bfloat16, 128, 64),
                          (torch.bfloat16, 128, 128),
                          (torch.float32, 64, 128), (torch.float32, 64, 16),
                          (torch.float32, 128, 128),
                          (torch.float32, 33, 97)):
        for cluster in range(1, ssd_kernels.MAX_CLUSTER + 1):
            assert ssd_kernels.backward_clusters(
                dtype, hd, ds, 128, cluster) >= 1, (dtype, hd, ds, cluster)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("dtype,hd,ds", [
    (torch.bfloat16, 64, 128), (torch.bfloat16, 64, 16),
    (torch.bfloat16, 128, 128), (torch.float32, 64, 128),
    (torch.float32, 64, 16), (torch.float32, 33, 97)])
@pytest.mark.parametrize("rep", [1, 2, 3, 6, 8, 16])
def test_ssd_backward_sums_shares_across_a_cluster_of_heads(
        cuda, rep, dtype, hd, ds, with_gh, strong):
    """The chunk pass of either route (wgmma for bf16 at multiples of 16,
    split TF32 for f32 and other widths) in clusters of C heads (C the
    largest divisor of the ``rep`` heads of a group up to 8: 1, 2, 3, 6,
    8, 8), two groups, over a ragged last chunk, with and without the
    final state's gradient, under Mamba-2's decays and strong ones: the
    shares are (B, S, nh / C, ds), the gradients finite and within the
    type's ``GRAD_TOL`` of the plain version in f64, two calls
    bit-identical, one counted call; the cluster launch fits (one block an
    SM, at least one cluster at once)."""
    ng = 2
    nh = ng * rep
    cluster = ssd_kernels.backward_cluster(dtype, hd, ds, nh, ng)
    assert cluster == {1: 1, 2: 2, 3: 3, 6: 6, 8: 8, 16: 8}[rep]
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 300, nh, hd, ng, ds, dtype,
                                    seed=rep + hd + ds, strong=strong)
    gh = gh if with_gh else None
    bufs = ssd_kernels.backward_buffers(args[0], args[3], 128)
    assert tuple(bufs["db_part"].shape) == (2, 300, nh // cluster, ds)
    counter = ssd_kernels.BACKWARD_COUNTER[ssd_kernels.route(dtype, hd, ds)]
    before = dict(_build.LAUNCHES)
    got = ssd_kernels._scan_backward(*args, gy, gh, 128)
    assert _ssd_counts(before) == {k: int(k == counter) for k in before}
    again = ssd_kernels._scan_backward(*args, gy, gh, 128)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _grads_close(got, _plain_grads64(args, gy, gh), dtype)
    assert ssd_kernels.backward_occupancy(dtype, hd, ds, 128)["chunk"][0] == 1
    assert ssd_kernels.backward_clusters(dtype, hd, ds, 128, cluster) >= 1


@pytest.mark.parametrize("dtype,hd,ds", [(torch.bfloat16, 64, 128),
                                         (torch.float32, 64, 128),
                                         (torch.float32, 33, 97)])
@pytest.mark.parametrize("rep", [3, 6, 8, 16])
def test_ssd_backward_cluster_share_is_its_heads_summed_in_order(
        cuda, rep, dtype, hd, ds):
    """A cluster's share of db and dc is its heads' shares (the chunk pass
    at C = 1) summed in rank order, bit for bit, at every cluster the
    group's heads take, on both routes (in f32 at a width the sum takes
    4 floats at a time and at one it takes one at a time); db and dc are
    then ``cluster_share_sum``'s of the heads' shares, bit for bit."""
    ng, chunk = 1, 128
    nh = ng * rep
    args, gy, gh = _ssd_grad_inputs(cuda, 1, 300, nh, hd, ng, ds, dtype,
                                    seed=rep)
    heads = ssd_kernels.backward_buffers(args[0], args[3], chunk, cluster=1)
    ssd_kernels.run_backward_passes(*args, gy, gh, bufs=heads, chunk=chunk,
                                    cluster=1)
    for cluster in (c for c in range(2, ssd_kernels.MAX_CLUSTER + 1)
                    if rep % c == 0):
        bufs = ssd_kernels.backward_buffers(args[0], args[3], chunk,
                                            cluster=cluster)
        ssd_kernels.run_backward_passes(*args, gy, gh, bufs=bufs,
                                        chunk=chunk, cluster=cluster)
        torch.cuda.synchronize()
        for part, out in (("db_part", "db"), ("dc_part", "dc")):
            p = heads[part].reshape(1, 300, nh // cluster, cluster, ds)
            want = p[:, :, :, 0]
            for r in range(1, cluster):
                want = want + p[:, :, :, r]
            assert torch.equal(bufs[part], want), (cluster, part)
            assert torch.equal(bufs[out], ssd_kernels.cluster_share_sum(
                heads[part], ng, cluster).to(bufs[out].dtype)), (cluster,
                                                                 out)


@pytest.mark.parametrize("dtype,hd,ds", [(torch.float32, 64, 128),
                                         (torch.bfloat16, 64, 128),
                                         (torch.bfloat16, 33, 97),
                                         (torch.float32, 33, 97),
                                         (torch.float32, 64, 16),
                                         (torch.float32, 40, 24)])
def test_ssd_backward_passes_match_their_plain_passes(cuda, dtype, hd, ds):
    """Each pass alone against its plain version: the chunks' own states
    and decays (the forward's pass 1) and R (pass 3's gradient of the
    entering states) from the states pass, then the entering states (the
    forward's pass 2) and dS (pass 2's gradient) from the state pass,
    then the chunk pass and the sums against the composition."""
    chunk = 64
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 200, 4, hd, 2, ds, dtype,
                                    seed=7)
    x, dt, a_log, b, c, d_skip = args
    bufs = ssd_kernels.backward_buffers(x, b, chunk)

    def run(*passes):
        ssd_kernels.run_backward_passes(*args, gy, gh, bufs=bufs, chunk=chunk,
                                        passes=passes)
    before = dict(_build.LAUNCHES)
    run("states")
    states, decay = ssd_ref.ssd_chunk_states_plain(x, dt, a_log, b,
                                                   chunk=chunk)
    h_in, _ = ssd_ref.ssd_state_pass_plain(states, decay)
    *_, dh_in = ssd_ref.ssd_chunk_scan_bwd_plain(*args, h_in, gy,
                                                 chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(bufs["states"], states, **SSD_TOL)
    torch.testing.assert_close(bufs["decay"], decay, **SSD_TOL)
    torch.testing.assert_close(bufs["dstates"], dh_in, **SSD_TOL)
    run("state_pass")
    dstates, _ = ssd_ref.ssd_state_pass_bwd_plain(h_in, decay, dh_in, gh)
    torch.testing.assert_close(bufs["states"], h_in, **SSD_TOL)
    torch.testing.assert_close(bufs["dstates"], dstates, **SSD_TOL)
    run("chunk", "reduce")
    got = [bufs[k] for k in ssd_kernels.BACKWARD_OUTPUTS]
    _grads_close(got, _plain_grads64(args, gy, gh, chunk), dtype)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("dtype,hd,ds", [(torch.float32, 64, 128),
                                         (torch.float32, 128, 128),
                                         (torch.float32, 64, 16),
                                         (torch.float32, 33, 97),
                                         (torch.bfloat16, 40, 24)])
def test_ssd_backward_states_pass_is_one_kernel_for_s_and_r(cuda, dtype, hd,
                                                            ds):
    """On the CUDA-core route pass 1 alone (``passes=("states",)``) is one
    kernel, ``states_bwd_tf``, that writes both each chunk's own state S
    (and its decay) and R, what its y sends back to its entering state,
    over scratch filled with NaN, within ``SSD_TOL`` of the plain passes,
    over a ragged last chunk."""
    from torch.profiler import ProfilerActivity, profile
    chunk = 128
    args, gy, gh = _ssd_grad_inputs(cuda, 2, 300, 4, hd, 2, ds, dtype,
                                    seed=hd + ds)
    x, dt, a_log, b, c, d_skip = args
    assert ssd_kernels.route(dtype, hd, ds) == "cuda_core"
    bufs = ssd_kernels.backward_buffers(x, b, chunk)
    for k in ("states", "decay", "dstates"):
        bufs[k].fill_(float("nan"))
    ssd_kernels.run_backward_passes(*args, gy, gh, bufs=bufs, chunk=chunk,
                                    passes=("states",))    # the build
    torch.cuda.synchronize()
    for k in ("states", "decay", "dstates"):
        bufs[k].fill_(float("nan"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ssd_kernels.run_backward_passes(*args, gy, gh, bufs=bufs,
                                        chunk=chunk, passes=("states",))
        torch.cuda.synchronize()
    launched = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and ssd_kernels.BACKWARD_KERNELS in e.key}
    assert list(launched.values()) == [1] \
        and "states_bwd_tf" in next(iter(launched)), launched
    states, decay = ssd_ref.ssd_chunk_states_plain(x, dt, a_log, b,
                                                   chunk=chunk)
    h_in, _ = ssd_ref.ssd_state_pass_plain(states, decay)
    *_, dh_in = ssd_ref.ssd_chunk_scan_bwd_plain(*args, h_in, gy,
                                                 chunk=chunk)
    torch.testing.assert_close(bufs["states"], states, **SSD_TOL)
    torch.testing.assert_close(bufs["decay"], decay, **SSD_TOL)
    torch.testing.assert_close(bufs["dstates"], dh_in, **SSD_TOL)
