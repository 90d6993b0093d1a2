"""The shuffle join's building blocks against the JAX reference, on the CPU.

* ``hash_shard`` / ``partition_to_shards`` against the reference's, which
  are plain ``jnp`` code and run in this process: buckets, counts and
  overflow flags equal, with a cap that overflows and one that suffices.
* ``join_shuffle_multi`` / ``engine.join_shuffle`` at 2, 3 and 8 shards,
  with several build passes per shard, and through the retry of either
  capacity: the pairs equal the port's ``engine.join`` and the reference's
  one-device ``engine.join`` (on an Auto-axis mesh).

The reference's own ``join_shuffle`` needs one JAX device per shard; it
is reached in ``test_torch_shard.py``'s subprocess.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.columnar import engine as r_engine
from repro.columnar.table import Table as RTable
from repro.core.channels import plan as r_plan
from repro.distributed import sharding as r_sharding

from repro_torch.columnar import engine
from repro_torch.columnar.table import Table
from repro_torch.core import join as join_core
from repro_torch.core.channels import plan
from repro_torch.distributed import sharding

SHARDS = (2, 3, 8)
# (probe rows, build rows, key domain): the reference differential's
# sizes, and a build of 60,000 rows that takes several passes a shard
SIZES = [(4096, 512, 200), (4097, 512, 200), (4096, 60_000, 5_000)]


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_layout_key_and_validation(n_shards):
    lay = sharding.ShardLayout(n_shards)
    assert lay.key() == r_sharding.ShardLayout(n_shards).key() \
        == ("shard_layout", n_shards, "shard")
    assert sharding.QUERY_SHARD_AXIS == r_sharding.QUERY_SHARD_AXIS
    with pytest.raises(ValueError, match="n_shards"):
        sharding.ShardLayout(0)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("cap", ["overflowing", "sufficient"])
def test_partition_to_shards_matches_reference(n_shards, cap):
    r = np.random.default_rng(n_shards)
    keys = r.integers(0, 200, 4097).astype(np.int32)
    ids = np.arange(4097, dtype=np.int32)
    c = 64 if cap == "overflowing" else 4097
    fill = (-(2 ** 30) - np.arange(n_shards * c, dtype=np.int32)) \
        .reshape(n_shards, c)
    ids_fill = np.full((n_shards, c), -1, np.int32)
    sid_r = r_sharding.hash_shard(jnp.asarray(keys), n_shards)
    (bk_r, bi_r), cnt_r, over_r = r_sharding.partition_to_shards(
        sid_r, (jnp.asarray(keys), jnp.asarray(ids)), n_shards, c,
        (jnp.asarray(fill), jnp.asarray(ids_fill)))
    sid = sharding.hash_shard(torch.from_numpy(keys), n_shards)
    assert sid.dtype == torch.int32
    np.testing.assert_array_equal(_np(sid), np.asarray(sid_r))
    (bk, bi), cnt, over = sharding.partition_to_shards(
        sid, (torch.from_numpy(keys), torch.from_numpy(ids)), n_shards, c,
        (torch.from_numpy(fill), torch.from_numpy(ids_fill)))
    np.testing.assert_array_equal(_np(bk), np.asarray(bk_r))
    np.testing.assert_array_equal(_np(bi), np.asarray(bi_r))
    np.testing.assert_array_equal(_np(cnt), np.asarray(cnt_r))
    assert bool(over) == bool(over_r) == (cap == "overflowing")
    assert int(cnt.sum()) == 4097           # exact even when rows dropped


def _keys(n_l, n_s, dom):
    r = np.random.default_rng(n_l + n_s + dom)
    return (r.integers(0, dom, n_l).astype(np.int32),
            r.integers(0, dom, n_s).astype(np.int32))


def _tables(n_l, n_s, dom):
    l, s = _keys(n_l, n_s, dom)
    return (Table.from_arrays("l", {"k": l}, "cpu").place(plan(device="cpu")),
            Table.from_arrays("s", {"k": s}, "cpu"))


@functools.lru_cache(maxsize=None)
def _reference_pairs(n_l, n_s, dom):
    """The reference's one-device ``engine.join`` (one per table shape:
    each call compiles)."""
    l, s = _keys(n_l, n_s, dom)
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    out = r_engine.join(RTable.from_arrays("l", {"k": l})
                        .place(r_plan(mesh, "model", "partitioned")),
                        RTable.from_arrays("s", {"k": s}), "k")
    return np.asarray(out.column("l_idx")), np.asarray(out.column("r_idx"))


def _oracle(n_l, n_s, dom):
    """numpy's probe-row-major pair list: each probe row's matches in
    ascending build order."""
    l, s = _keys(n_l, n_s, dom)
    order = np.argsort(s, kind="stable")
    lo = np.searchsorted(s[order], l, "left")
    hi = np.searchsorted(s[order], l, "right")
    l_idx = np.repeat(np.arange(n_l), hi - lo)
    r_idx = np.concatenate([order[a:b] for a, b in zip(lo, hi)])
    return l_idx, r_idx


def _canonical(pairs):
    """A pair list put in probe-row-major order by a stable sort."""
    l_idx, r_idx = pairs.column("l_idx"), pairs.column("r_idx")
    order = torch.argsort(l_idx, stable=True)
    return _np(l_idx[order]), _np(r_idx[order])


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("n_l,n_s,dom", SIZES)
def test_join_shuffle_equals_the_broadcast_join(n_shards, n_l, n_s, dom):
    """The shuffled pairs equal the port's ``engine.join`` and the
    reference's: bit for bit while the build fits one pass (both are
    probe-row-major), and as the same probe-row-major list over several
    passes, where the broadcast join emits pass by pass (60,000 build
    rows: 8 passes at 1 engine, 8 a shard at 2 shards, 2 at 8)."""
    pt_l, pt_s = _tables(n_l, n_s, dom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = engine.join_shuffle(pt_l, pt_s, "k",
                                  sharding.ShardLayout(n_shards))
        port = engine.join(pt_l, pt_s, "k")
    want_l, want_r = _oracle(n_l, n_s, dom)
    np.testing.assert_array_equal(_np(got.column("l_idx")), want_l)
    np.testing.assert_array_equal(_np(got.column("r_idx")), want_r)
    np.testing.assert_array_equal(_canonical(port)[1], want_r)
    if n_s <= join_core.HT_CAPACITY:
        ref_l, ref_r = _reference_pairs(n_l, n_s, dom)
        np.testing.assert_array_equal(_np(got.column("l_idx")), ref_l)
        np.testing.assert_array_equal(_np(got.column("r_idx")), ref_r)
        np.testing.assert_array_equal(_np(port.column("r_idx")), ref_r)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_join_shuffle_multi_passes_and_exact_totals(n_shards, monkeypatch):
    """Per shard ``ceil(s_cap / HT_CAPACITY)`` passes, each probing the
    shard's whole probe bucket: the counts kernel launches n_shards x
    passes times.  The totals are exact and the pair slices -1 padded.
    3 shards x 60,000 build rows: s_cap = 2 * 20,000 + 64 rounds to 5
    blocks of 8,192, so 5 passes a shard."""
    r = np.random.default_rng(n_shards)
    s = torch.from_numpy(r.integers(0, 5000, 60_000).astype(np.int32))
    l = torch.from_numpy(r.integers(0, 5000, 4096).astype(np.int32))
    s_cap = join_core._round_build_cap(join_core._bucket_cap(60_000,
                                                             n_shards))
    assert s_cap % join_core.HT_CAPACITY == 0
    calls = []
    real = join_core.join_kernels.probe_counts

    def counted(s_sorted, keys):
        calls.append((s_sorted.shape[0], keys.shape[0]))
        return real(s_sorted, keys)

    monkeypatch.setattr(join_core.join_kernels, "probe_counts", counted)
    l_idx, s_idx, totals, over, (s_cnt, l_cnt, shuf_over) = \
        join_core.join_shuffle_multi(s, l, sharding.ShardLayout(n_shards),
                                     max_out_per_shard=60_000)
    passes = s_cap // join_core.HT_CAPACITY
    if n_shards == 3:
        assert passes == 5
    assert len(calls) == n_shards * passes
    l_cap = join_core._bucket_cap(4096, n_shards)
    assert set(calls) == {(join_core.HT_CAPACITY, l_cap)}
    counts = torch.bincount(s.long(), minlength=5000)
    assert int(totals.sum()) == int(counts[l.long()].sum())
    assert not bool(over.any()) and not bool(shuf_over)
    assert int(s_cnt.sum()) == 60_000 and int(l_cnt.sum()) == 4096
    assert int((l_idx >= 0).sum()) == int(totals.sum())
    assert torch.equal(l_idx >= 0, s_idx >= 0)
    assert l_idx.shape == (n_shards * 60_000,)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("short", ["buckets", "pairs"])
def test_join_shuffle_retries_with_the_measured_capacities(n_shards, short,
                                                           monkeypatch):
    """A first try with buckets (or pair lists) far too small overflows;
    the exact counts size the retry, which completes the join."""
    pt_l, pt_s = _tables(4096, 512, 200)
    tiny = dict(s_cap=8, l_cap=8) if short == "buckets" \
        else dict(max_out_per_shard=8)
    lay = sharding.ShardLayout(n_shards)
    first = join_core.join_shuffle_multi(pt_s.column("k"), pt_l.column("k"),
                                         lay, **tiny)
    if short == "buckets":
        assert bool(first[4][2])
        assert int(first[4][1].sum()) == 4096       # exact counts
    else:
        assert not bool(first[4][2]) and bool(first[3].all())
    tries = []
    real = join_core.join_shuffle_multi

    def shrunk(s_keys, l_keys, layout, **kw):
        tries.append(kw)
        return real(s_keys, l_keys, layout, **(kw or tiny))

    monkeypatch.setattr(join_core, "join_shuffle_multi", shrunk)
    got = engine.join_shuffle(pt_l, pt_s, "k", lay)
    # truncated buckets undercount the pairs, so a bucket overflow can
    # take a third try sized by the second's exact pair totals
    assert tries[0] == {} and len(tries) == (2 if short == "pairs"
                                             else len(tries))
    assert 2 <= len(tries) <= 3
    assert tries[-1]["l_cap"] >= 4096 // n_shards
    want_l, want_r = _oracle(4096, 512, 200)
    np.testing.assert_array_equal(_np(got.column("l_idx")), want_l)
    np.testing.assert_array_equal(_np(got.column("r_idx")), want_r)


def test_join_shuffle_checks_the_key_domain():
    pt_l, _ = _tables(64, 16, 10)
    bad = Table.from_arrays("s", {"k": np.asarray([-1, 2], np.int32)}, "cpu")
    with pytest.raises(ValueError, match="non-negative"):
        engine.join_shuffle(pt_l, bad, "k", sharding.ShardLayout(2))
