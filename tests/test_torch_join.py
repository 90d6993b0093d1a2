"""The port's joins (``kernels/join/ops.py``'s ``hash_join_multi``) and
distributed operators (``core/selection.py``, ``core/join.py``) against
the JAX reference, on the CPU.

Key distributions follow the reference's join differential suite (unique,
duplicate-heavy, Zipf, adversarial); the reference runs on an Auto-axis
mesh.  Pair lists, totals, overflow flags and selection index lists must
be bit-identical.  The port's multi-engine plans (contiguous shards run
one after another on one device) must equal its one-engine plan.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import join as r_join_core
from repro.core import selection as r_sel_core
from repro.core.channels import plan as r_plan
from repro.kernels.join import ops as r_join_ops

from repro_torch.core import join as join_core
from repro_torch.core import selection as sel_core
from repro_torch.core.channels import plan
from repro_torch.kernels.join import ops as join_ops


def _ref_plan(placement="partitioned"):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    return r_plan(mesh, "model", placement)


def _eq(port, reference):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(reference))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def make_keys(dist, r, n_s, n_l):
    if dist == "unique":
        dom = 10 * max(n_s, 1)
        s = r.choice(dom, size=n_s, replace=False)
        l = r.integers(0, dom, size=n_l)
    elif dist == "dup_heavy":
        dom = max(n_s // 4, 1)
        s = r.integers(0, dom, size=n_s)
        l = r.integers(0, 2 * dom, size=n_l)
    elif dist == "zipf":
        s = np.minimum(r.zipf(1.5, size=n_s), 200) - 1
        l = np.minimum(r.zipf(1.5, size=n_l), 200) - 1
    elif dist == "all_equal":
        s = np.full(n_s, 7)
        l = np.where(r.random(n_l) < 0.5, 7, 9)
    elif dist == "single_key":
        s = np.full(1, 5)
        l = r.integers(0, 10, size=n_l)
    else:
        raise ValueError(dist)
    return s.astype(np.int32), l.astype(np.int32)


DISTS = ("unique", "dup_heavy", "zipf", "all_equal", "single_key")


@pytest.mark.parametrize("dist", DISTS)
def test_join_distributed_multi_matches_reference(dist):
    r = np.random.default_rng(len(dist))
    s, l = make_keys(dist, r, 120, 1024)
    want = r_join_core.join_distributed_multi(
        jnp.asarray(s), jnp.asarray(l), _ref_plan())
    got = join_core.join_distributed_multi(_t(s), _t(l), plan())
    for g, w in zip(got, want):
        _eq(g, w)


def test_join_distributed_multi_multipass_and_overflow_match_reference():
    """A build side over HT_CAPACITY probes in passes with distinct
    negative pads; a pair list too small for the matches flags overflow
    with the exact total."""
    r = np.random.default_rng(9)
    s = r.integers(0, 3000, join_core.HT_CAPACITY + 500).astype(np.int32)
    l = r.integers(0, 3200, 512).astype(np.int32)
    want = r_join_core.join_distributed_multi(
        jnp.asarray(s), jnp.asarray(l), _ref_plan(), max_out_per_shard=100)
    got = join_core.join_distributed_multi(_t(s), _t(l), plan(),
                                           max_out_per_shard=100)
    for g, w in zip(got, want):
        _eq(g, w)
    assert bool(got[3].any()) and int(got[2].sum()) > 100


@pytest.mark.parametrize("n_s", [1, 300, join_core.HT_CAPACITY + 100])
def test_join_distributed_matches_reference(n_s):
    r = np.random.default_rng(n_s)
    s = r.choice(10 * n_s + 10, size=n_s, replace=False).astype(np.int32)
    l = r.integers(0, 10 * n_s + 10, 2048).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = r_join_core.join_distributed(jnp.asarray(s), jnp.asarray(l),
                                            _ref_plan())
        got = join_core.join_distributed(_t(s), _t(l), plan())
        _eq(got[0], want[0])
        assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("n_eng", [2, 3])
def test_engines_split_the_probe_side_without_changing_results(n_eng):
    r = np.random.default_rng(n_eng)
    s, l = make_keys("dup_heavy", r, 200, 1200)
    one = join_core.join_distributed_multi(_t(s), _t(l), plan(),
                                           max_out_per_shard=20_000)
    many = join_core.join_distributed_multi(_t(s), _t(l),
                                            plan(n_engines=n_eng),
                                            max_out_per_shard=20_000)
    assert not bool(one[3].any() or many[3].any())
    assert int(many[2].sum()) == int(one[2].sum())
    keep1, keepn = one[0] >= 0, many[0] >= 0
    _eq(many[0][keepn], one[0][keep1])
    _eq(many[1][keepn], one[1][keep1])
    u = r.choice(5000, 300, replace=False).astype(np.int32)
    _eq(join_core.join_distributed(_t(u), _t(l), plan(n_engines=n_eng))[0],
        join_core.join_distributed(_t(u), _t(l), plan())[0])
    x = _t(r.integers(0, 100, 1200))
    _eq(sel_core.select_distributed(x, 10, 40, plan(n_engines=n_eng))[0],
        sel_core.select_distributed(x, 10, 40, plan())[0])


def test_select_distributed_matches_reference():
    x = np.random.default_rng(4).integers(0, 1000, 8192).astype(np.int32)
    for placement in ("partitioned", "congested"):
        want = r_sel_core.select_distributed(jnp.asarray(x), 100, 400,
                                             _ref_plan(placement), block=1024)
        got = sel_core.select_distributed(_t(x), 100, 400,
                                          plan(placement), block=1024)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


# ---- hash_join_multi: the multi-match probe (B3) plus the overflow pass --- #

def _ref_multi(s, l, max_out, cap, impl):
    """The reference's hash_join_multi; its Pallas probe needs the probe
    length to tile its block, so one block covers all of it."""
    return r_join_ops.hash_join_multi(
        jnp.asarray(s), jnp.asarray(l), max_out=max_out, cap=cap,
        block=max(l.size, 1), impl=impl, interpret=True)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("cap", [8, 2])
def test_hash_join_multi_matches_reference_under_both_impls(dist, cap):
    """Pair lists, totals and overflow flags bit for bit, against the
    reference's XLA path and its Pallas path (interpret mode); the dup
    distributions have chains longer than the cap."""
    r = np.random.default_rng(len(dist) + cap)
    s, l = make_keys(dist, r, 120, 1024)
    for max_out in (8192, 100):              # roomy, then truncating
        got = join_ops.hash_join_multi(_t(s), _t(l), max_out=max_out,
                                       cap=cap)
        for impl in ("xla", "pallas"):
            want = _ref_multi(s, l, max_out, cap, impl)
            for g, w in zip(got, want):
                _eq(g, w)
        assert bool(got.overflowed) == (int(got.total) > max_out)


def test_hash_join_multi_chains_far_past_the_cap():
    """Nearly every pair comes from the overflow pass."""
    r = np.random.default_rng(3)
    s = r.integers(0, 4, 2000).astype(np.int32)
    l = np.asarray([0, 1, 9, 2, 3, 3], np.int32)
    got = join_ops.hash_join_multi(_t(s), _t(l), max_out=2000)
    for impl in ("xla", "pallas"):
        for g, w in zip(got, _ref_multi(s, l, 2000, 8, impl)):
            _eq(g, w)
    assert int(got.total) == int(np.isin(s, [0, 1, 2]).sum()
                                 + 2 * (s == 3).sum())
    assert bool(got.overflowed)


@pytest.mark.parametrize("n_s,n_l", [(0, 50), (30, 0), (0, 0)])
def test_hash_join_multi_empty_sides_match_reference(n_s, n_l):
    s = np.arange(n_s, dtype=np.int32) % 7
    l = np.arange(n_l, dtype=np.int32) % 5
    got = join_ops.hash_join_multi(_t(s), _t(l), max_out=16)
    want = r_join_ops.hash_join_multi(jnp.asarray(s), jnp.asarray(l),
                                      max_out=16, impl="xla")
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got.total) == 0 and not bool(got.overflowed)


def test_materialize_pairs_matches_reference():
    r = np.random.default_rng(8)
    s, l = make_keys("dup_heavy", r, 40, 256)
    s_vals = r.integers(0, 1000, s.size).astype(np.int32)
    l_vals = r.integers(0, 1000, l.size).astype(np.int32)
    got = join_ops.hash_join_multi(_t(s), _t(l), max_out=600)
    want = _ref_multi(s, l, 600, 8, "xla")
    for g, w in zip(join_ops.materialize_pairs(got.l_idx, got.s_idx,
                                               _t(l_vals), _t(s_vals)),
                    r_join_ops.materialize_pairs(
                        want.l_idx, want.s_idx, jnp.asarray(l_vals),
                        jnp.asarray(s_vals))):
        _eq(g, w)


@pytest.mark.parametrize("dist,max_out", [("dup_heavy", None),
                                          ("zipf", 300),
                                          ("unique", None)])
def test_join_distributed_multi_result_matches_reference(dist, max_out):
    """The distributed multi-match join under the single-device result
    contract: one compacted pair prefix, the exact total, the overflow
    flag; over more than one pass when the build side needs it."""
    r = np.random.default_rng(len(dist))
    n_s = join_core.HT_CAPACITY + 300 if dist == "unique" else 150
    s, l = make_keys(dist, r, n_s, 1024)
    want = r_join_core.join_distributed_multi_result(
        jnp.asarray(s), jnp.asarray(l), _ref_plan(),
        max_out_per_shard=max_out)
    got = join_core.join_distributed_multi_result(
        _t(s), _t(l), plan(), max_out_per_shard=max_out)
    for g, w in zip(got, want):
        _eq(g, w)
    assert bool(got.overflowed) == (max_out is not None
                                    and int(got.total) > max_out)
