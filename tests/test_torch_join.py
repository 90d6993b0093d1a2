"""The port's distributed operators (``core/selection.py``,
``core/join.py``) against the JAX reference, on the CPU.

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

from repro_torch.core import join as join_core
from repro_torch.core import selection as sel_core
from repro_torch.core.channels import plan


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
