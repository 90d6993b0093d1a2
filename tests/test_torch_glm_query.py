"""The port's GLM path through the query stack (paper §VI, workload 3)
against the JAX reference, on the CPU.

The same numpy columns build the reference's catalog (on an Auto-axis
mesh) and the port's; TrainGLM and ScoreGLM plans run through the
reference ``Executor`` and the port's ``Executor(device="cpu")`` in batch,
stream and eager modes.  The two systems sum in different orders, so
weights agree within rtol=1e-5, atol=1e-6 and losses, which each mode
folds in its own order, within rtol=1e-4, atol=1e-6.

Inside the port the invariant the reference pins holds bit for bit: the
streamed trainer reproduces the whole-column minibatch sequence exactly
(pad rows give zero gradient and the final morsel pads only to the next
minibatch multiple), so streamed weights equal eager weights on any row
count and any morsel size.
"""
import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.core.sgd_glm import HyperParams as RHyperParams
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ
from repro.query import logical as RL

from repro_torch.convert import catalog_from_arrays
from repro_torch.query import Executor, HyperParams, Q
from repro_torch.query import logical as L

FEATS = ("f0", "f1", "f2")
GRID = (HyperParams(0.1, 0.0), HyperParams(0.05, 0.01))
R_GRID = tuple(RHyperParams(g.lr, g.l2) for g in GRID)
W_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _arrays(m, seed=0):
    r = np.random.default_rng(seed)
    a = r.normal(size=(m, len(FEATS))).astype(np.float32)
    w = np.array([1.0, -2.0, 0.5], np.float32)
    y = (1.0 / (1.0 + np.exp(-(a @ w))) > 0.5).astype(np.float32)
    cols = {f: a[:, i] for i, f in enumerate(FEATS)}
    cols["y"] = y
    cols["k"] = np.arange(m, dtype=np.int32)
    return {"train": cols}


def _port(m, seed=0):
    return Executor(catalog_from_arrays(_arrays(m, seed), "cpu"),
                    device="cpu")


def _ref(m, seed=0):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    return RExecutor(
        RCatalog.from_tables(*(RTable.from_arrays(t, c)
                               for t, c in _arrays(m, seed).items())),
        mesh=mesh, cost_model=RCostModel(1, calibration=None))


def train_q(Qc=Q, kind="logreg", epochs=3, grid=GRID, lo=None, hi=None):
    q = Qc.scan("train")
    if lo is not None:
        q = q.filter("k", lo, hi)
    return q.train_glm(list(FEATS), "y", list(grid), kind=kind,
                       epochs=epochs)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------- #
# the port against the reference


@pytest.mark.parametrize("kind", ["logreg", "ridge"])
@pytest.mark.parametrize("m", [512, 97])
def test_train_matches_reference_in_every_mode(kind, m):
    port, ref = _port(m), _ref(m)
    want = ref.execute(train_q(RQ, kind, grid=R_GRID)).value
    q = train_q(kind=kind)
    runs = [port.execute(q, mode=mode) for mode in ("batch", "stream",
                                                    "eager")]
    runs.append(port.execute(q, optimized=False))
    assert [r.mode for r in runs] == ["stream", "stream", "eager", "eager"]
    for r in runs:
        xs, losses = r.value
        assert xs.shape == (2, 3) and losses.shape == (2,)
        np.testing.assert_allclose(_np(xs), _np(want[0]), **W_TOL)
        np.testing.assert_allclose(_np(losses), _np(want[1]), **LOSS_TOL)


def test_filtered_train_matches_reference():
    port, ref = _port(512), _ref(512)
    want = ref.execute(train_q(RQ, grid=R_GRID, lo=0, hi=399)).value
    for mode in ("batch", "eager"):
        xs, losses = port.execute(train_q(lo=0, hi=399), mode=mode).value
        np.testing.assert_allclose(_np(xs), _np(want[0]), **W_TOL)
        np.testing.assert_allclose(_np(losses), _np(want[1]), **LOSS_TOL)


@pytest.mark.parametrize("select", [-1, 0])
def test_score_matches_reference(select):
    port, ref = _port(512), _ref(512)
    rq = RQ.scan("train").filter("k", 100, 400).score_glm(
        train_q(RQ, grid=R_GRID), select=select)
    pq = Q.scan("train").filter("k", 100, 400).score_glm(train_q(),
                                                         select=select)
    want = np.asarray(ref.execute(rq).value.column("score"))
    for mode in ("batch", "stream", "eager"):
        got = port.execute(pq, mode=mode).value
        assert got.num_rows == 301
        np.testing.assert_allclose(got.column("score").numpy(), want,
                                   **W_TOL)
    naive = port.execute(pq, optimized=False).value.column("score")
    np.testing.assert_allclose(naive.numpy(), want, **W_TOL)


def test_scores_are_the_best_model_applied_to_the_rows():
    port = _port(512)
    xs, losses = port.execute(train_q()).value
    x = xs[int(torch.argmin(losses))].numpy()
    feats = np.stack([_arrays(512)["train"][f] for f in FEATS], axis=1)
    got = port.execute(Q.scan("train").score_glm(train_q())).value
    np.testing.assert_allclose(got.column("score").numpy(),
                               1.0 / (1.0 + np.exp(-(feats @ x))),
                               rtol=1e-5, atol=1e-6)
    ridge = port.execute(Q.scan("train").score_glm(
        train_q(kind="ridge"), select=1)).value
    xr = port.execute(train_q(kind="ridge")).value[0][1].numpy()
    np.testing.assert_allclose(ridge.column("score").numpy(), feats @ xr,
                               rtol=1e-5, atol=1e-6)


def test_score_raw_fingerprint_raises():
    port = _port(512)
    with pytest.raises(KeyError):
        port.execute(Q.scan("train").score("deadbeef", list(FEATS)))


def test_glm_plans_and_fingerprints_match_reference():
    port, ref = _port(512), _ref(512)
    pairs = [(train_q(), train_q(RQ, grid=R_GRID)),
             (train_q(kind="ridge", epochs=4),
              train_q(RQ, kind="ridge", epochs=4, grid=R_GRID)),
             (train_q(lo=0, hi=255), train_q(RQ, grid=R_GRID, lo=0, hi=255)),
             (Q.scan("train").score_glm(train_q()),
              RQ.scan("train").score_glm(train_q(RQ, grid=R_GRID)))]
    for pq, rq in pairs:
        p_opt, p_phys = port.plan(pq.node)
        r_opt, r_phys = ref.plan(rq.node)
        assert L.pformat(p_opt) == RL.pformat(r_opt)
        assert L.fingerprint(p_opt, port.catalog.versions()) == \
            RL.fingerprint(r_opt, ref.catalog.versions())
        assert (p_phys.op, p_phys.placement) == (r_phys.op, r_phys.placement)


# --------------------------------------------------------------------------- #
# inside the port: streamed == eager, bit for bit


@pytest.mark.parametrize("m", [512, 500, 97, 10])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_streamed_train_matches_eager_bitwise(m, kind):
    """The morsel-streamed epoch loop reproduces the eager whole-column
    SGD weights exactly — including row counts that divide neither the
    morsel nor the minibatch."""
    ex = _port(m)
    q = train_q(kind=kind)
    streamed = ex.execute(q)
    assert streamed.mode == "stream"
    eager = ex.execute(q, optimized=False)
    assert torch.equal(streamed.value[0], eager.value[0])
    assert torch.equal(ex.execute(q, mode="eager").value[0], eager.value[0])
    np.testing.assert_allclose(streamed.value[1].numpy(),
                               eager.value[1].numpy(), **LOSS_TOL)


@pytest.mark.parametrize("morsel_rows", [64, 96, 130, 512])
def test_streamed_train_morsel_size_invariant(morsel_rows):
    """Weights are independent of the streaming granularity (the carry
    threads the same global minibatch sequence through any morsel cut,
    aligned down to a minibatch multiple)."""
    ex = _port(500)
    base = ex.execute(train_q(), morsel_rows=None)
    got = ex.execute(train_q(), mode="stream", morsel_rows=morsel_rows)
    assert torch.equal(base.value[0], got.value[0])


def test_filtered_train_matches_eager_bitwise():
    """A filter below the train root materializes once, then streams:
    same weights as the fully eager filtered train."""
    ex = _port(512)
    q = train_q(lo=0, hi=399)
    streamed = ex.execute(q)
    assert streamed.mode == "stream"
    eager = ex.execute(q, optimized=False)
    assert torch.equal(streamed.value[0], eager.value[0])


def test_eager_mode_follows_planned_placement():
    """Forced-eager training runs under the placement the cost model chose
    (explain() and execution agree), and the choice is the priced argmin
    over the alternatives."""
    ex = _port(512)
    r = ex.execute(train_q(), mode="eager")
    assert r.physical.op == "train_glm"
    assert r.physical.placement in ex.plans
    assert r.explain().startswith(
        f"train_glm: impl=torch placement={r.physical.placement}")
    alts = r.physical.alternatives
    assert set(alts) == {"torch/replicated", "torch/congested"}
    best = min(alts, key=alts.get)
    assert best.split("/")[1] == r.physical.placement


def test_mutation_retrains_on_the_new_labels():
    """A label update changes the training data and the next train sees
    it.  The test runs without a semantic cache, so no model is cached
    to invalidate; it pins that the update reaches the stream and eager
    paths alike."""
    ex = _port(256)
    before = ex.execute(train_q()).value[0]
    y = ex.catalog.tables["train"].column("y")
    ex.catalog.update_column("train", "y", (1.0 - y).numpy())
    after = ex.execute(train_q())
    assert not torch.equal(after.value[0], before)
    assert torch.equal(after.value[0],
                       ex.execute(train_q(), optimized=False).value[0])
