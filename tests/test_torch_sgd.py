"""The port's SGD modules (``kernels/sgd``, ``core/sgd_glm.py``) against
the JAX reference, on the CPU.

The reference runs ``sgd_pallas`` in interpret mode and its jnp oracle
``sgd_ref``, and ``hyperparam_search`` on an Auto-axis mesh; the port's
wrapper takes its plain version because the tensors lie on the CPU.
Inputs are made with numpy from a seed and handed to both.  The two sum
in different orders (XLA's dot against torch's), so weights and losses
agree within rtol=1e-5, atol=1e-6 (the reference's own streaming suite
uses the same bound); the differences measured at these shapes are below
2e-8.  Inside the port, a job's weights are bit-identical however the jobs
are grouped, and ``pad_to_minibatch`` is bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sgd_glm as r_sgd_glm
from repro.core.channels import plan as r_plan
from repro.kernels.sgd import ops as r_ops
from repro.kernels.sgd import ref as r_ref
from repro.kernels.sgd.sgd import sgd_pallas

from repro_torch.core import sgd_glm
from repro_torch.core.channels import plan
from repro_torch.kernels import _build
from repro_torch.kernels.sgd import ops, ref
from repro_torch.kernels.sgd import sgd as sgd_kernels

RTOL, ATOL = 1e-5, 1e-6
SGD_TOL = dict(rtol=1e-4, atol=1e-5)     # the card tests' kernel bound


def _close(port, reference):
    np.testing.assert_allclose(np.asarray(port), np.asarray(reference),
                               rtol=RTOL, atol=ATOL)


def _ref_plan(placement="partitioned"):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    return r_plan(mesh, "model", placement)


def _data(seed, m, n, kind="logreg"):
    r = np.random.default_rng(seed)
    a = r.uniform(-1, 1, size=(m, n)).astype(np.float32)
    if kind == "logreg":
        b = (a @ r.normal(size=n) > 0).astype(np.float32)
    else:
        b = r.uniform(0, 1, size=m).astype(np.float32)
    return a, b


GRID = [sgd_glm.HyperParams(0.1 / (i + 1), 0.001 * i) for i in range(3)]
R_GRID = [r_sgd_glm.HyperParams(g.lr, g.l2) for g in GRID]


@pytest.mark.parametrize("m,n,mb", [(128, 64, 8), (256, 128, 16),
                                    (512, 256, 32)])
@pytest.mark.parametrize("kind", ["ridge", "logreg"])
def test_plain_sgd_matches_sgd_pallas_and_sgd_ref(m, n, mb, kind):
    """The shapes of the reference's kernel test, three jobs at once:
    each job against ``sgd_pallas`` (interpret mode) and ``sgd_ref``."""
    a, b = _data(m + n, m, n, kind)
    lrs = np.asarray([0.05, 0.02, 0.1], np.float32)
    l2s = np.asarray([1e-4, 0.0, 1e-3], np.float32)
    before = dict(_build.LAUNCHES)
    xs = sgd_kernels.sgd(torch.from_numpy(a), torch.from_numpy(b),
                         torch.zeros(3, n), torch.from_numpy(lrs),
                         torch.from_numpy(l2s), minibatch=mb, epochs=3,
                         kind=kind)
    assert _build.LAUNCHES == before          # CPU tensors: no launch
    for k in range(3):
        kw = dict(lr=float(lrs[k]), l2=float(l2s[k]), minibatch=mb,
                  epochs=3, kind=kind)
        x0 = jnp.zeros(n, jnp.float32)
        _close(xs[k], sgd_pallas(jnp.asarray(a), jnp.asarray(b), x0,
                                 interpret=True, **kw))
        _close(xs[k], r_ref.sgd_ref(jnp.asarray(a), jnp.asarray(b), x0,
                                    **kw))


@pytest.mark.parametrize("kind", ["ridge", "logreg"])
def test_sgd_train_and_losses_match_reference(kind):
    a, b = _data(3, 256, 32, kind)
    x0 = np.random.default_rng(4).normal(size=32).astype(np.float32)
    kw = dict(lr=0.03, l2=1e-3, minibatch=16, epochs=4, kind=kind)
    x = ops.sgd_train(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(x0), **kw)
    want = r_ops.sgd_train(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x0),
                           impl="xla", **kw)
    _close(x, want)
    xs = torch.stack([x, torch.from_numpy(x0)])
    losses = ref.loss_ref(torch.from_numpy(a), torch.from_numpy(b), xs,
                          torch.tensor([1e-3, 0.0]), kind=kind)
    for k, l2 in enumerate((1e-3, 0.0)):
        _close(losses[k], r_ref.loss_ref(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(xs[k].numpy()),
                                         l2=l2, kind=kind))


def test_jobs_do_not_depend_on_their_grouping():
    """A job trained with others in one call equals the job alone, bit
    for bit (the kernel gives one block per job; the plain version trains
    each job on its own)."""
    a, b = _data(5, 160, 24)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    lrs = torch.tensor([0.1, 0.05, 0.2, 0.01])
    l2s = torch.tensor([0.0, 1e-3, 1e-2, 0.0])
    xs0 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 24)).astype(np.float32))
    together = sgd_kernels.sgd(at, bt, xs0, lrs, l2s, minibatch=16,
                               epochs=2, kind="logreg")
    for k in range(4):
        alone = sgd_kernels.sgd(at, bt, xs0[k:k + 1], lrs[k:k + 1],
                                l2s[k:k + 1], minibatch=16, epochs=2,
                                kind="logreg")
        assert torch.equal(alone[0], together[k])


@pytest.mark.parametrize("m", [512, 500])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_hyperparam_search_matches_reference(m, kind):
    a, b = _data(m, m, 8, kind)
    xs, losses = sgd_glm.hyperparam_search(
        torch.from_numpy(a), torch.from_numpy(b), GRID, plan(), epochs=3,
        kind=kind)
    r_xs, r_losses = r_sgd_glm.hyperparam_search(
        jnp.asarray(a), jnp.asarray(b), R_GRID, _ref_plan(), epochs=3,
        kind=kind)
    assert xs.shape == (3, 8) and losses.shape == (3,)
    _close(xs, r_xs)
    _close(losses, r_losses)
    # engines group the jobs differently; every job's weights stay put
    for n_eng in (2, 3):
        xs_n, losses_n = sgd_glm.hyperparam_search(
            torch.from_numpy(a), torch.from_numpy(b), GRID,
            plan(n_engines=n_eng), epochs=3, kind=kind)
        assert torch.equal(xs_n, xs) and torch.equal(losses_n, losses)


def test_hyperparam_search_past_one_blocks_shared_memory():
    """58,097 features, the narrowest width whose model no longer fits one
    block's shared memory beside a minibatch of 16 (the card used to
    refuse it; the reference trains it): the port's search on the CPU
    against the reference's, within the card tests' SGD tolerance."""
    a, b = _data(11, 32, 58_097)
    grid = GRID[:2]
    xs, losses = sgd_glm.hyperparam_search(
        torch.from_numpy(a), torch.from_numpy(b), grid, plan(), epochs=1,
        minibatch=16, kind="logreg")
    r_xs, r_losses = r_sgd_glm.hyperparam_search(
        jnp.asarray(a), jnp.asarray(b), R_GRID[:2], _ref_plan(), epochs=1,
        minibatch=16, kind="logreg")
    assert xs.shape == (2, 58_097) and sgd_kernels.route(58_097, 16) == \
        "split"
    np.testing.assert_allclose(xs.numpy(), np.asarray(r_xs), **SGD_TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(r_losses),
                               **SGD_TOL)


@pytest.mark.parametrize("m,mb", [(16, 16), (17, 16), (31, 8), (5, 16)])
def test_pad_to_minibatch_matches_reference(m, mb):
    a, b = _data(m, m, 3)
    got = sgd_glm.pad_to_minibatch(torch.from_numpy(a), torch.from_numpy(b),
                                   mb)
    want = r_sgd_glm.pad_to_minibatch(jnp.asarray(a), jnp.asarray(b), mb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sgd_dynamic_matches_reference():
    a, b = _data(8, 192, 16)
    x0 = np.zeros(16, np.float32)
    got = sgd_glm._sgd_dynamic(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(x0), torch.tensor(0.07),
                               torch.tensor(0.002), minibatch=16, epochs=3,
                               kind="logreg")
    want = r_sgd_glm._sgd_dynamic(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(x0), jnp.float32(0.07),
                                  jnp.float32(0.002), minibatch=16,
                                  epochs=3, kind="logreg")
    _close(got, want)


@pytest.mark.parametrize("kind", ["ridge", "logreg"])
def test_blockwise_train_matches_reference(kind):
    a, b = _data(9, 256, 12, kind)
    x0 = np.zeros(12, np.float32)
    kw = dict(lr=0.05, l2=1e-4, block_rows=64, epochs_per_block=2,
              passes=2, minibatch=16, kind=kind)
    got = sgd_glm.blockwise_train(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(x0), **kw)
    want = r_sgd_glm.blockwise_train(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(x0), **kw)
    _close(got, want)
    with pytest.raises(ValueError):
        sgd_glm.blockwise_train(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(x0), **{**kw,
                                                         "block_rows": 100})


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(20, 4)
    b, xs0 = torch.zeros(20), torch.zeros(1, 4)
    hp = torch.zeros(1)
    with pytest.raises(ValueError, match="minibatch"):
        sgd_kernels.sgd(a, b, xs0, hp, hp, minibatch=16)
    with pytest.raises(ValueError, match="kind"):
        sgd_kernels.sgd(a, b, xs0, hp, hp, minibatch=4, kind="svm")
    with pytest.raises(ValueError, match="shapes"):
        sgd_kernels.sgd(a, b[:10], xs0, hp, hp, minibatch=4)
    with pytest.raises(TypeError):
        sgd_kernels.sgd(a.double(), b, xs0, hp, hp, minibatch=4)
