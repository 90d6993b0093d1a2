"""The core leftovers against the reference: ``core/shim``'s
``round_up``, ``round_down``, ``plan_matmul_block`` (Hopper tiles) and
``merged_port_width`` (the card's wide access), and
``core/selection.selectivity_histogram``, bit for bit with
``jnp.histogram``'s counts on int32 and float32 columns."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shim as r_shim
from repro.core.selection import selectivity_histogram as r_histogram

from repro_torch.core import shim
from repro_torch.core.selection import selectivity_histogram

SIZES = (1, 7, 63, 64, 65, 100, 128, 129, 512, 1000, 4096, 65536)


def test_round_up_and_down_match_the_reference():
    for x, m in itertools.product(range(0, 300), (1, 2, 8, 64, 128)):
        assert shim.round_up(x, m) == r_shim.round_up(x, m), (x, m)
        assert shim.round_down(x, m) == r_shim.round_down(x, m), (x, m)


def _halve(x, q):
    return max(x // 2, q)


def _reference_order(m, n, k, mins, cap, fits, halve=_halve):
    """The reference's planning loop (``repro.core.shim.
    plan_matmul_block``) over any tile minimums, cap and fit predicate:
    round each dim up to its minimum, cap it, then halve the largest
    (``max((bm, 0), (bn, 1), (bk, 2))``: of equals the last) until it
    fits or every dim is at its minimum; ``halve`` takes a dim to its
    next size (the port's rounds down to the dim's multiple)."""
    bm, bn, bk = (min(r_shim.round_up(x, q), cap)
                  for x, q in zip((m, n, k), mins))
    while not fits(bm, bn, bk):
        big = max((bm, 0), (bn, 1), (bk, 2))
        if big[1] == 0:
            bm = halve(bm, mins[0])
        elif big[1] == 1:
            bn = halve(bn, mins[1])
        else:
            bk = halve(bk, mins[2])
        if (bm, bn, bk) == tuple(mins):
            break
    return bm, bn, bk


def test_the_reference_order_is_the_references_plan():
    def fits(bm, bn, bk):
        return 2 * (bm * bk + bk * bn) * 2 + bm * bn * 4 <= \
            r_shim.VMEM_BYTES // 2
    for mnk in itertools.product(SIZES, repeat=3):
        assert _reference_order(*mnk, (r_shim.MXU,) * 3, 512, fits) == \
            r_shim.plan_matmul_block(*mnk).block, mnk


@pytest.mark.parametrize("dtype_bytes,n_buffers", [(2, 2), (2, 4), (4, 2),
                                                   (1, 3)])
def test_plan_matmul_block_shrinks_in_the_references_order(dtype_bytes,
                                                          n_buffers):
    mins = (shim.WGMMA_M, shim.WGMMA_N, shim.WGMMA_K)

    def fits(bm, bn, bk):
        return n_buffers * (bm * bk + bk * bn) * dtype_bytes <= \
            shim.SMEM_BYTES and bm * bn * 4 <= shim.ACC_BYTES
    for mnk in itertools.product(SIZES, repeat=3):
        p = shim.plan_matmul_block(*mnk, dtype_bytes=dtype_bytes,
                                   n_buffers=n_buffers)
        assert p.block == _reference_order(
            *mnk, mins, shim.MAX_TILE, fits,
            lambda x, q: shim.round_down(x // 2, q)), mnk
        assert p.fits and fits(*p.block)
        assert all(b % q == 0 and q <= b <= shim.MAX_TILE
                   for b, q in zip(p.block, mins))
        assert p.smem_bytes == n_buffers * (p.block[0] * p.block[2]
                                            + p.block[2] * p.block[1]) \
            * dtype_bytes


def test_plan_matmul_block_keeps_a_small_product_whole():
    p = shim.plan_matmul_block(100, 70, 30)
    assert p.block == (128, 128, 64) and p.fits


def test_merged_port_width_is_a_warps_16_byte_access():
    for b in (1, 2, 4, 8, 16):
        w = shim.merged_port_width(b)
        assert w == 512 and w % b == 0
        # a whole number of the reference's elements, as its width is
        assert r_shim.merged_port_width(b) % b == 0
    with pytest.raises(ValueError):
        shim.merged_port_width(3)


def _columns():
    rng = np.random.default_rng(0)
    for i in range(60):
        kind = i % 4
        if kind == 0:
            x = rng.integers(-10 ** 6, 10 ** 6, 1000).astype(np.int32)
        elif kind == 1:
            x = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 6)
                 ).astype(np.float32)
        elif kind == 2:       # values on the bin edges
            x = (np.round(rng.uniform(-3, 3, 1000) * 4) / 4).astype(
                np.float32)
        else:
            x = np.arange(0, 1000, dtype=np.int32) % 101
        if i % 7 == 0:
            x[:] = x[0]      # one value: the range widens by 0.5 each way
        yield x, (3, 10, 17, 32, 1)[i % 5]


def test_selectivity_histogram_is_the_references_bit_for_bit():
    for x, bins in _columns():
        want = np.asarray(r_histogram(jnp.asarray(x),
                                      selectivity_bins=bins))
        got = selectivity_histogram(torch.from_numpy(x), bins)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), (x.dtype, bins)
        assert got.sum() == x.size
