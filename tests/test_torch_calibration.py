"""The port's traffic generator (B6), its block planner and its cost-model
calibration against the JAX reference, on the CPU.

B6's plain version (``kernels/bandwidth/ref.py``) is held against the
reference's ``stream_copy_pallas`` in interpret mode, bit for bit: the
reference has no test of that kernel, so this is its first.  The
calibration invariants mirror ``tests/test_adaptive_replan.py``'s: an
overlay applies idempotently, an impl it does not mention re-baselines,
``Executor.recost`` bumps the epoch and re-plans without changing an
answer, and ``load_calibration`` reads the port's own file only.  The
port's imports are checked last: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.core.bandwidth import stream_copy_pallas
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ

from repro_torch import convert
from repro_torch.convert import catalog_from_arrays
from repro_torch.core import bandwidth, channels, shim
from repro_torch.kernels import _build
from repro_torch.kernels.bandwidth import ref as bw_ref
from repro_torch.kernels.bandwidth import stream
from repro_torch.query import (
    TIERS, CostModel, Executor, Q, load_calibration,
)
from repro_torch.query import cost as cost_mod
from repro_torch.query.calibrate import calibrate

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
I32_MAX, I32_MIN = 2 ** 31 - 1, -2 ** 31


def _auto_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


# ---- B6: the traffic generator -------------------------------------------- #

@pytest.mark.parametrize("n,block", [(1024, 0), (8192, 0), (3 * 1024, 1024),
                                     (4096, 512), (1 << 16, 0)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_stream_copy_plain_equals_stream_copy_pallas(n, block, dtype):
    r = np.random.default_rng(n + block)
    if dtype == np.int32:
        x = r.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
        x[:4] = (I32_MAX, I32_MIN, -1, 0)        # 2**31 - 1 wraps
    else:
        x = r.standard_normal(n).astype(np.float32) * 1e6
        x[:3] = (np.float32(3.4e38), np.float32(-0.0), np.float32(1e-40))
    want = np.asarray(stream_copy_pallas(jnp.asarray(x), block=block,
                                         interpret=True))
    before = dict(_build.LAUNCHES)
    got = stream.stream_copy(torch.from_numpy(x))
    assert _build.LAUNCHES == before           # CPU tensors: no launch
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bw_ref.stream_copy_ref(
        torch.from_numpy(x)).numpy(), want)


def test_stream_copy_wraps_at_the_top_of_int32():
    x = torch.tensor([I32_MAX, I32_MAX - 1, -1], dtype=torch.int32)
    want = np.asarray(stream_copy_pallas(jnp.asarray(x.numpy()),
                                         block=3, interpret=True))
    assert want.tolist() == [I32_MIN, I32_MAX, 0]
    assert stream.stream_copy(x).tolist() == want.tolist()


def test_stream_copy_on_cpu_writes_into_out_and_keeps_slices():
    x = torch.arange(1, 1 << 12, dtype=torch.int32)
    out = torch.empty_like(x)
    assert stream.stream_copy(x, out=out) is out
    np.testing.assert_array_equal(out.numpy(), x.numpy() + 1)
    np.testing.assert_array_equal(stream.stream_copy(x[1:]).numpy(),
                                  x.numpy()[1:] + 1)


@pytest.mark.parametrize("n_engines", [1, 4, 16])
@pytest.mark.parametrize("placement", ["partitioned", "congested"])
def test_stream_copy_distributed_equals_plain(n_engines, placement):
    x = torch.from_numpy(np.random.default_rng(n_engines).integers(
        -1000, 1000, 16 * 1024, dtype=np.int64).astype(np.int32))
    plan = channels.plan(placement, n_engines, "cpu")
    got = bandwidth.stream_copy_distributed(x, plan)
    np.testing.assert_array_equal(got.numpy(), x.numpy() + 1)


def test_stream_copy_distributed_needs_whole_shards():
    with pytest.raises(ValueError, match="engines"):
        bandwidth.stream_copy_distributed(
            torch.zeros(10, dtype=torch.int32), channels.plan(n_engines=4,
                                                              device="cpu"))


def test_measure_gbps_and_calibrate_refuse_the_cpu(tmp_path):
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA events"):
        bandwidth.measure_gbps(stream.stream_copy, x)
    out = tmp_path / "cal.json"
    with pytest.raises(RuntimeError, match="calibration"):
        calibrate(str(out), device="cpu", smoke=True)
    assert not out.exists()


def test_calibrate_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate(str(tmp_path / "cal.json"), smoke=True)


@pytest.mark.parametrize("n,dtype_bytes", [(1, 4), (1000, 4), (1 << 20, 4),
                                           (1 << 28, 4), (5000, 2)])
def test_stream_block_plan_fills_the_card_with_16_byte_vectors(n,
                                                               dtype_bytes):
    p = shim.plan_stream_block(n, dtype_bytes)
    assert p.vector * dtype_bytes == shim.VECTOR_BYTES
    assert p.threads == shim.THREADS
    assert 1 <= p.grid <= shim.H100_SMS * shim.BLOCKS_PER_SM
    # a grid that is not full covers every vector in one pass
    if p.grid < shim.H100_SMS * shim.BLOCKS_PER_SM:
        assert p.threads * p.vector * p.grid >= n
    # the blocks claim tiles of `unroll` vectors a thread, several loads in
    # flight a thread; a grid short of a wave has a vector for every
    # thread, and no block without one
    assert p.unroll in (2, 4, 8)
    assert p.tile == p.threads * p.unroll
    if p.grid < shim.H100_SMS * shim.BLOCKS_PER_SM:
        assert p.threads * p.vector * (p.grid - 1) < n
    with pytest.raises(ValueError):
        shim.plan_stream_block(10, 3)


# ---- the calibration overlay ---------------------------------------------- #

def _overlay(eff_cuda=0.5, overhead=5e-6, h2d=None):
    ov = {"backend": "test", "backends": {
        "cuda": {"stream_eff": eff_cuda, "call_overhead_s": overhead,
                 "achieved_gbps": 1.0}}}
    if h2d is not None:
        ov["h2d_gbps"] = h2d
    return ov


def _prices(model):
    return (dict(model.stream_eff), dict(model.call_overhead),
            model.h2d_gbps, model.disk_gbps,
            model.choose_morsel_rows(1 << 20, 3),
            model.choose_morsel_rows(1 << 20, 3, include_transfer=False))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_calibration_apply_is_idempotent(impl):
    m = CostModel(4, impl=impl)
    ov = _overlay(h2d=12.5)
    m.apply_calibration(ov)
    once = _prices(m)
    m.apply_calibration(ov)
    assert _prices(m) == once
    assert m.n_calibrations == 2
    assert m.stream_eff["cuda"] == 0.5 and m.h2d_gbps == 12.5
    assert m.calibrated_from == "test"


def test_partial_overlay_rebaselines_to_the_placeholders():
    m = CostModel(1, impl="cuda")
    m.apply_calibration(_overlay(eff_cuda=0.3, h2d=10.0))
    m.apply_calibration({"backend": "test", "backends": {
        "torch": {"stream_eff": 0.6, "call_overhead_s": 1e-5}}})
    assert m.stream_eff["cuda"] == cost_mod.STREAM_EFF
    assert m.call_overhead["cuda"] == cost_mod.CALL_OVERHEAD_S
    assert m.h2d_gbps == cost_mod.H2D_GBPS
    assert m.stream_eff["torch"] == 0.6
    # backends the port has no impl for are ignored, efficiency clamps to 1
    m.apply_calibration({"backends": {"xla": {"stream_eff": 0.1},
                                      "cuda": {"stream_eff": 7.0}}})
    assert set(m.stream_eff) == {"torch", "cuda"}
    assert m.stream_eff["cuda"] == 1.0
    assert m.stream_eff["torch"] == cost_mod.STREAM_EFF


def test_calibration_snapshot_round_trips():
    m = CostModel(1, impl="cuda", calibration=_overlay(h2d=20.0))
    snap = m.calibration_snapshot()
    m2 = CostModel(1, impl="cuda", calibration=snap)
    assert _prices(m2) == _prices(m)
    assert CostModel(1).calibration_snapshot()["backend"] == "placeholder"


def test_calibrated_efficiency_and_overhead_price_the_plan():
    base = CostModel(1, impl="cuda")
    slow = CostModel(1, impl="cuda", calibration=_overlay(eff_cuda=0.1,
                                                          overhead=1e-3))
    assert slow.stream_cost(1 << 30, placement="partitioned") \
        > base.stream_cost(1 << 30, placement="partitioned")
    # the torch label keeps its placeholders under a cuda-only overlay
    t = CostModel(1, impl="torch", calibration=_overlay(eff_cuda=0.1))
    assert t.stream_cost(1 << 30, placement="partitioned") \
        == CostModel(1, impl="torch").stream_cost(1 << 30,
                                                  placement="partitioned")


def _arrays(seed, n=4096):
    r = np.random.default_rng(seed)
    return {"big": {"k": r.integers(0, 1000, size=n).astype(np.int32),
                    "v": r.integers(0, 100, size=n).astype(np.int32),
                    "w": r.integers(1, 50, size=n).astype(np.int32)},
            "small": {"k": np.asarray(r.choice(1000, size=512,
                                               replace=False), np.int32)}}


def test_recost_bumps_epoch_and_replans():
    ex = Executor(catalog_from_arrays(_arrays(0), "cpu"), device="cpu",
                  cost_model=CostModel(1))
    q = Q.scan("big").filter("v", 10, 60).sum("w")
    _, phys0 = ex.plan(q.node)
    key0 = ex._cache_key(*ex.plan(q.node))
    assert ex.cost_epoch == 0
    assert ex.recost(_overlay(eff_cuda=1e-3, overhead=5e-3)) == 1
    key1 = ex._cache_key(*ex.plan(q.node))
    assert key0 != key1
    assert ex.plan(q.node)[1] is not phys0
    # even an empty overlay rolls the epoch
    ex.recost({})
    assert ex.cost_epoch == 2 and ex._cache_key(*ex.plan(q.node)) != key1


def test_recost_twice_with_one_overlay_changes_no_price():
    ex = Executor(catalog_from_arrays(_arrays(1), "cpu"), device="cpu",
                  cost_model=CostModel(1, impl="cuda"))
    q = (Q.scan("big").join(Q.scan("small"), on="k")
         .filter("v", 30, 49).sum("w"))
    ov = _overlay(eff_cuda=0.25, overhead=3e-5, h2d=20.0)
    ex.recost(ov)
    first = ex.explain(q)
    ex.recost(ov)
    assert ex.explain(q) == first
    assert ex.cost_epoch == 2


def test_recost_changes_no_answer_and_matches_reference():
    arrays = _arrays(2)
    ref = RExecutor(RCatalog.from_tables(*(RTable.from_arrays(t, c)
                                           for t, c in arrays.items())),
                    mesh=_auto_mesh(),
                    cost_model=RCostModel(1, calibration=None))
    ex = Executor(catalog_from_arrays(arrays, "cpu"), device="cpu",
                  cost_model=CostModel(1))
    qs = [lambda Qc: Qc.scan("big").filter("v", 10, 60).sum("w"),
          lambda Qc: Qc.scan("big").join(Qc.scan("small"), on="k")
          .filter("v", 30, 49).sum("w")]
    want = [ref.execute(q(RQ)).value for q in qs]
    ex.recost(_overlay(eff_cuda=0.01, h2d=1.0))
    for mode in ("batch", "stream", "eager"):
        assert [ex.execute(q(Q), mode=mode).value for q in qs] == want


def test_load_calibration_reads_the_ports_file_only(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(cost_mod.CALIBRATION_ENV, raising=False)
    ref_cal = {"backend": "tpu", "h2d_gbps": 1.0,
               "backends": {"xla": {"stream_eff": 0.1}}}
    (tmp_path / "BENCH_calibration.json").write_text(json.dumps(ref_cal))
    assert load_calibration() is None
    cal = {"backend": "cuda", "h2d_gbps": 25.0,
           "backends": {"cuda": {"stream_eff": 0.9,
                                 "call_overhead_s": 4e-6}}}
    (tmp_path / "BENCH_calibration_torch.json").write_text(json.dumps(cal))
    assert load_calibration() == cal
    m = Executor(catalog_from_arrays(_arrays(0), "cpu"),
                 device="cpu").cost_model
    assert m.h2d_gbps == 25.0 and m.calibrated_from == "cuda"
    # the port's env override: a path, or off
    other = tmp_path / "other.json"
    other.write_text(json.dumps({**cal, "h2d_gbps": 9.0}))
    monkeypatch.setenv(cost_mod.CALIBRATION_ENV, str(other))
    assert load_calibration()["h2d_gbps"] == 9.0
    monkeypatch.setenv(cost_mod.CALIBRATION_ENV, "off")
    assert load_calibration() is None
    # the reference's env name is not the port's
    monkeypatch.delenv(cost_mod.CALIBRATION_ENV)
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path /
                                                 "BENCH_calibration.json"))
    assert load_calibration() == cal
    (tmp_path / "BENCH_calibration_torch.json").write_text("{not json")
    assert load_calibration() is None


def test_reference_snapshot_becomes_the_ports_overlay():
    overlay = {"backend": "tpu", "h2d_gbps": 11.0, "d2h_gbps": 9.0,
               "host_gbps": 30.0, "disk_gbps": 1.5,
               "stage_overhead_s": 3e-4,
               "backends": {"xla": {"stream_eff": 0.4,
                                    "call_overhead_s": 7e-6},
                            "pallas": {"stream_eff": 0.8,
                                       "call_overhead_s": 2e-5}}}
    rm = RCostModel(1, calibration=overlay)
    got = convert.calibration_from_reference(rm.calibration_snapshot())
    pm = CostModel(1, impl="cuda", calibration=got)
    assert pm.stream_eff == {"torch": 0.4, "cuda": 0.8}
    assert pm.call_overhead == {"torch": 7e-6, "cuda": 2e-5}
    assert convert.calibration_from_reference(None) is None
    n = float(3 << 20)
    for tier in TIERS:
        assert pm.promotion_cost(n, tier) == rm.promotion_cost(n, tier)
        assert pm.demotion_cost(n, tier) == rm.demotion_cost(n, tier)
        assert pm.tier_score(1e-2, int(n), hits=2, tier=tier) \
            == rm.tier_score(1e-2, int(n), hits=2, tier=tier)
    assert pm.bandwidth_gbps("host") == rm.bandwidth_gbps("host")
    assert pm.bandwidth_gbps("disk") == rm.bandwidth_gbps("disk")
    assert pm.stage_overhead_s == rm.stage_overhead_s


# ---- imports ------------------------------------------------------------- #

def test_no_module_of_the_port_imports_jax_or_the_reference():
    code = ("import pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    __import__(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax_and_no_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "repro_torch" in {n.split(".")[0] for n in names}
    assert not {n for n in names if n.split(".")[0] in ("jax", "repro")}


def test_sgd_probe_imports_no_jax_and_no_reference():
    """The card-only timing script beside ``chip_smoke.py`` imports the
    port and ``chip_smoke``, never ``jax`` or the reference."""
    with open(os.path.join(ROOT, "sgd_probe.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert {"repro_torch", "chip_smoke"} <= {n.split(".")[0] for n in names}
    assert not {n for n in names if n.split(".")[0] in ("jax", "repro")}
