"""The port's engine layer (``columnar/engine.py``) against the JAX
reference's, on the CPU.

Eager selections and joins run on placed one-engine tables on both sides
(the reference on an Auto-axis mesh); index lists and pair columns must be
bit-identical, for row counts that no kernel block tiles too.  The
streaming operators (join build, morsel probe, bucket sums, masks and
carries) are compared the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.columnar import engine as r_engine
from repro.columnar.table import Table as RTable
from repro.core.channels import plan as r_plan

from repro_torch.columnar import engine
from repro_torch.columnar.table import Table
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


def _tables(s, l):
    rt_l = RTable.from_arrays("l", {"k": l}).place(_ref_plan())
    rt_s = RTable.from_arrays("s", {"k": s})
    pt_l = Table.from_arrays("l", {"k": l}, "cpu").place(plan())
    pt_s = Table.from_arrays("s", {"k": s}, "cpu")
    return rt_l, rt_s, pt_l, pt_s


@pytest.mark.parametrize("dist", DISTS[:4])
def test_engine_join_matches_reference(dist):
    """Unique, duplicate-heavy, Zipf and all-equal keys; the all-equal
    pairs overflow the default pair list, so the engine's retry with the
    measured capacity is exercised too."""
    r = np.random.default_rng(100 + len(dist))
    s, l = make_keys(dist, r, 64, 999)         # 999: no block tiles it
    rt_l, rt_s, pt_l, pt_s = _tables(s, l)
    unique_opts = (None, True) if dist in ("unique", "single_key") \
        else (None,)
    for unique in unique_opts:
        want = r_engine.join(rt_l, rt_s, "k", unique=unique)
        got = engine.join(pt_l, pt_s, "k", unique=unique)
        _eq(got.column("l_idx"), want.column("l_idx"))
        _eq(got.column("r_idx"), want.column("r_idx"))
    if dist == "all_equal":
        assert got.num_rows > 2 * l.size        # past the default list


def test_engine_join_rejects_keys_outside_the_domain():
    """Negative keys collide with the pass pads and are refused, on either
    side.  Unlike the reference, whose Pallas table pad reserves
    2**31 - 1, the port joins that key like any other."""
    for s, l in ((np.asarray([-3, 1], np.int32), np.asarray([1, 2], np.int32)),
                 (np.asarray([1, 2], np.int32), np.asarray([-1], np.int32))):
        _, _, pt_l, pt_s = _tables(s, l)
        with pytest.raises(ValueError, match="non-negative"):
            engine.join(pt_l, pt_s, "k")
    top = 2 ** 31 - 1
    s = np.asarray([top, 4, top], np.int32)
    l = np.asarray([top, 1, 4, top, top], np.int32)
    _, _, pt_l, pt_s = _tables(s, l)
    got = engine.join(pt_l, pt_s, "k")
    pairs = sorted(zip(got.column("l_idx").tolist(),
                       got.column("r_idx").tolist()))
    assert pairs == sorted((i, j) for i in range(l.size)
                           for j in range(s.size) if l[i] == s[j])


@pytest.mark.parametrize("n,lo,hi", [(4096, 10, 60), (4097, 0, 0),
                                     (1000, 50, 10), (1, -5, 500)])
def test_engine_select_range_matches_reference(n, lo, hi):
    x = np.random.default_rng(n).integers(0, 100, n).astype(np.int32)
    want = r_engine.select_range(
        RTable.from_arrays("t", {"x": x}).place(_ref_plan()), "x", lo, hi)
    got = engine.select_range(
        Table.from_arrays("t", {"x": x}, "cpu").place(plan()), "x", lo, hi)
    _eq(got.column("idx"), want.column("idx"))


def test_streaming_operators_match_reference():
    r = np.random.default_rng(6)
    s = r.integers(0, 40, 300).astype(np.int32)
    vals = r.integers(1, 100, 300).astype(np.int32)
    keys = r.integers(0, 60, 1000).astype(np.int32)
    rb = r_engine.join_build(RTable.from_arrays("b", {"k": s, "v": vals}),
                             "k", ["v"])
    pb = engine.join_build(Table.from_arrays("b", {"k": s, "v": vals},
                                             "cpu"), "k", ["v"])
    for g, w in zip(pb.flat(), rb.flat()):
        _eq(g, w)
    rs, rc = r_engine.join_probe_morsel(rb, jnp.asarray(keys))
    ps, pc = engine.join_probe_morsel(pb, _t(keys))
    _eq(ps, rs)
    _eq(pc, rc)
    _eq(engine.bucket_sums(pb.csums["v"], ps, pc),
        r_engine.bucket_sums(rb.csums["v"], rs, rc))
    mask = np.arange(1000) < 900
    rm = r_engine.select_range_morsel(jnp.asarray(keys), 10, 30,
                                      jnp.asarray(mask))
    pm = engine.select_range_morsel(_t(keys), 10, 30, torch.from_numpy(mask))
    _eq(pm, rm)
    want = r_engine.aggregate_sum_stream(jnp.int32(5), jnp.asarray(keys), rm,
                                         rc)
    got = engine.aggregate_sum_stream(torch.tensor(5, dtype=torch.int64),
                                      _t(keys), pm, pc)
    assert int(got) == int(want)
