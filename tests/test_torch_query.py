"""The port's query stack against the JAX reference, on the CPU.

The same numpy columns build the reference's catalog and the port's
(``repro_torch.convert.catalog_from_arrays``); every query runs through
the reference ``Executor`` on an Auto-axis mesh and through the port's
``Executor(device="cpu")``, in batch, stream and eager modes, and the
values must be identical.  Plans are compared too: the optimized logical
plan, its fingerprint, and the physical join choice (unique-key ``join``
or multi-match ``join_multi``).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import logical as RL

from repro_torch.convert import catalog_from_arrays
from repro_torch.query import CostModel, Executor, HyperParams, Q
from repro_torch.query import plan_physical
from repro_torch.query import logical as L

MODES = ("batch", "stream", "eager")


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _arrays(seed, n=4096, n_small=512):
    r = np.random.default_rng(seed)
    return {
        "big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                "v": r.integers(0, 100, size=n).astype(np.int32),
                "w": r.integers(1, 50, size=n).astype(np.int32)},
        "small": {"k": np.asarray(r.choice(1000, size=n_small,
                                           replace=False), np.int32),
                  "x": r.integers(0, 1000, size=n_small).astype(np.int32)},
        "dup": {"k": r.integers(0, 50, size=256).astype(np.int32)},
    }


def _systems(arrays):
    ref = RExecutor(
        RCatalog.from_tables(*(RTable.from_arrays(t, c)
                               for t, c in arrays.items())),
        mesh=_auto_mesh(), cost_model=RCostModel(1, calibration=None))
    port = Executor(catalog_from_arrays(arrays, "cpu"), device="cpu")
    return ref, port


def _queries(Qc):
    """The streaming differential suite's query shapes, plus filter chains
    before a unique-key join (the SSB Q1.1 shape) and a join after which
    the filter reads a build column."""
    return [
        Qc.scan("big").filter("v", 10, 60).sum("w"),
        Qc.scan("big").filter("v", 20, 39).count("w"),
        Qc.scan("big").filter("v", 20, 39).mean("w"),
        Qc.scan("big").join(Qc.scan("small"), on="k")
          .filter("v", 30, 49).sum("w"),
        Qc.scan("big").join(Qc.scan("small"), on="k")
          .filter("v", 0, 99).count("k"),
        Qc.scan("big").join(Qc.scan("dup"), on="k")
          .filter("v", 10, 60).sum("w"),
        Qc.scan("big").join(Qc.scan("dup"), on="k").count("k"),
        Qc.scan("big").filter("v", 5, 70).filter("w", 3, 30)
          .filter("k", 100, 900).join(Qc.scan("small"), on="k").sum("w"),
        Qc.scan("big").join(Qc.scan("small"), on="k")
          .filter("x", 200, 800).sum("x"),
        Qc.scan("big").filter("v", 50, 40).sum("w"),          # empty range
    ]


@pytest.mark.parametrize("seed", [0, 7])
def test_executor_matches_reference_in_every_mode(seed):
    """Every mode of the port, and its naive lowering, equal the
    reference's batch value (the reference pins its own modes equal)."""
    ref, port = _systems(_arrays(seed))
    for rq, pq in zip(_queries(RQ), _queries(Q)):
        want = ref.execute(rq).value
        for mode in MODES:
            got = port.execute(pq, mode=mode).value
            assert got == want, (pq.node, mode, got, want)
            assert type(got) is type(want), (pq.node, mode)
        assert port.execute(pq, optimized=False).value == want


def test_eager_joins_match_reference_eager():
    """The eager lowering of a unique-key join (open-addressing probe) and
    of a duplicate-keyed one (pair lists) against the reference's own
    eager lowering."""
    ref, port = _systems(_arrays(1))
    for rq, pq in zip(_queries(RQ)[3:6:2], _queries(Q)[3:6:2]):
        want = ref.execute(rq, mode="eager").value
        assert port.execute(pq, mode="eager").value == want


def test_stream_matches_reference_on_non_dividing_morsels():
    ref, port = _systems(_arrays(3))
    for rq, pq in zip(_queries(RQ), _queries(Q)):
        want = ref.execute(rq).value
        for morsel_rows in (256, 1000, 4096, 9999):
            got = port.execute(pq, mode="stream",
                               morsel_rows=morsel_rows).value
            assert got == want, (pq.node, morsel_rows, got, want)


@pytest.mark.parametrize("n", [1, 97, 4097])
def test_ragged_table_sizes_match_reference(n):
    """Row counts that tile no kernel block: the port takes its kernels'
    path for every size and still equals the reference."""
    arrays = _arrays(11, n=n, n_small=64)
    ref, port = _systems(arrays)
    rq = (RQ.scan("big").filter("v", 10, 80).join(RQ.scan("small"), on="k")
          .sum("w"))
    pq = (Q.scan("big").filter("v", 10, 80).join(Q.scan("small"), on="k")
          .sum("w"))
    want = ref.execute(rq).value
    for mode in MODES:
        assert port.execute(pq, mode=mode, morsel_rows=50
                            if mode == "stream" else None).value == want


@pytest.mark.parametrize("seed", [0, 5])
def test_optimized_plans_and_join_choice_match_reference(seed):
    ref, port = _systems(_arrays(seed))
    queries = _queries(RQ) + [
        RQ.scan("small").join(RQ.scan("big"), on="k").sum("x"),
        RQ.scan("dup").join(RQ.scan("big"), on="k").count("k")]
    pqueries = _queries(Q) + [
        Q.scan("small").join(Q.scan("big"), on="k").sum("x"),
        Q.scan("dup").join(Q.scan("big"), on="k").count("k")]
    for rq, pq in zip(queries, pqueries):
        r_opt, r_phys = ref.plan(rq.node)
        p_opt, p_phys = port.plan(pq.node)
        assert L.pformat(p_opt) == RL.pformat(r_opt)
        assert L.fingerprint(p_opt, port.catalog.versions()) == \
            RL.fingerprint(r_opt, ref.catalog.versions())
        r_ops = [(p.op, p.placement, p.n_passes, round(p.est_rows_out, 6))
                 for p in _walk(r_phys)]
        p_ops = [(p.op, p.placement, p.n_passes, round(p.est_rows_out, 6))
                 for p in _walk(p_phys)]
        assert p_ops == r_ops
        assert {p.impl for p in _walk(p_phys)} == {"torch"}


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def test_kernels_chosen_exactly_on_cuda():
    """The plan's impl label follows the device: a CUDA executor's cost
    model labels every operator ``cuda``, a CPU executor's ``torch``, and
    the label changes no placement or pass count."""
    _, port = _systems(_arrays(0))
    q = (Q.scan("big").filter("v", 1, 50).join(Q.scan("small"), on="k")
         .sum("w"))
    opt, cpu_phys = port.plan(q.node)
    phys = plan_physical(opt, port.catalog.stats, CostModel(1, impl="cuda"))
    by_op = {p.op: p.impl for p in _walk(phys)}
    assert by_op["join"] == "cuda" and by_op["filter"] == "cuda"
    assert set(by_op.values()) == {"cuda"}
    assert [(p.op, p.placement, p.n_passes) for p in _walk(phys)] == \
        [(p.op, p.placement, p.n_passes) for p in _walk(cpu_phys)]
    assert "impl=torch" in port.explain(q)
    assert "impl=cuda" not in port.explain(q)
    with pytest.raises(ValueError):
        CostModel(1, impl="pallas")


def test_executor_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = catalog_from_arrays(_arrays(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(cat)
    with pytest.raises(RuntimeError, match="CUDA"):
        catalog_from_arrays(_arrays(0))


def test_glm_roots_run_and_match_reference():
    """The TrainGLM plan the port once refused now runs in every mode and
    its weights match the reference's (rtol=1e-5, atol=1e-6).  Its label
    ``w`` is not binary, so the logistic loss saturates and its value
    hangs on how ``log(1 - p + eps)`` is associated; losses and scores are
    compared on the same shape of query with a binary label."""
    from repro.core.sgd_glm import HyperParams as RHyperParams
    ref, port = _systems(_arrays(0))
    q = Q.scan("big").train_glm(["v"], "w", [HyperParams(0.1, 0.0)])
    rq = RQ.scan("big").train_glm(["v"], "w", [RHyperParams(0.1, 0.0)])
    want = ref.execute(rq).value
    for mode in MODES:
        np.testing.assert_allclose(port.execute(q, mode=mode).value[0],
                                   np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-6)

    arrays = _arrays(0)
    arrays["big"]["v"] = (arrays["big"]["v"] % 2).astype(np.int32)
    ref, port = _systems(arrays)
    q = Q.scan("big").train_glm(["w"], "v", [HyperParams(0.001, 0.0)],
                                epochs=1)
    rq = RQ.scan("big").train_glm(["w"], "v", [RHyperParams(0.001, 0.0)],
                                  epochs=1)
    want = ref.execute(rq).value
    for mode in MODES:
        xs, losses = port.execute(q, mode=mode).value
        np.testing.assert_allclose(xs.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-6)
    got = port.execute(Q.scan("big").score_glm(q)).value.column("score")
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(ref.execute(RQ.scan("big").score_glm(rq)).value
                   .column("score")), rtol=1e-5, atol=1e-6)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.query, repro_torch.kernels._build, "
            "repro_torch.kernels.join.ops, repro_torch.core.selection, "
            "repro_torch.core.sgd_glm, repro_torch.kernels.sgd.ops\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_catalog_statistics_match_reference():
    ref, port = _systems(_arrays(2))
    for t, rs in ref.catalog.stats.items():
        ps = port.catalog.stats[t]
        assert ps.num_rows == rs.num_rows and ps.columns == rs.columns
        assert {c: (s.lo, s.hi, s.n_distinct) for c, s in ps.ranges.items()} \
            == {c: (s.lo, s.hi, s.n_distinct) for c, s in rs.ranges.items()}


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_stream_from_lower_tiers_matches_reference(tmp_path, tier):
    """Host and disk columns stream morsel by morsel (numpy slices staged
    onto the device per morsel) and give the reference's value."""
    arrays = _arrays(4)
    ref, port = _systems(arrays)
    for c in ("k", "v", "w"):
        port.catalog.tables["big"].demote_column(c, tier, str(tmp_path))
    rq, pq = _queries(RQ)[5], _queries(Q)[5]
    want = ref.execute(rq).value
    for mode in MODES:
        assert port.execute(pq, mode=mode, morsel_rows=1000
                            if mode == "stream" else None).value == want
