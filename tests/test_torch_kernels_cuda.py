"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and carries the ``requires_cuda``
marker; the ``cuda`` fixture decides at run time whether to skip, so the
set of collected tests is the same on every machine.  This file imports
neither ``jax`` nor ``repro`` (the card's machine has no JAX), so it runs
there on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Integer outputs must be bit-identical to the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import join as join_core
from repro_torch.kernels import _build
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.selection import selection

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
