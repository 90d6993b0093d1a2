"""B1's float32 route against the JAX reference, on the CPU.

``select_pallas`` compares a float32 column in its own type, its bounds
cast to float32 (``jnp.asarray([lo], x.dtype)``).  The port's kernel has a
float32 entry beside the int32 one; here its plain version (what a CPU
tensor takes) is held bit for bit against ``select_pallas`` in interpret
mode, with bounds whose float32 rounding decides a row, infinities, NaN
rows and a ragged tail, and the eager executor's float filter against the
reference's.  The kernel itself is held against the same plain version on
the card (``test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.columnar.table import Table as RTable
from repro.kernels.selection.selection import select_pallas
from repro.query import Catalog as RCatalog, CostModel as RCostModel
from repro.query import Executor as RExecutor, Q as RQ

from repro_torch.columnar import engine
from repro_torch.convert import catalog_from_arrays
from repro_torch.kernels import _build
from repro_torch.kernels.selection import ref as sel_ref
from repro_torch.kernels.selection import selection
from repro_torch.query import Executor, Q

# (lo, hi): bounds whose float32 rounding moves them (0.1, 0.3), integer
# bounds, an empty range, bounds past the float32 range, infinities
BOUNDS = [(0.1, 0.3), (-0.7, 0.7), (0, 1), (0.5, 0.25), (-1e39, 1e39),
          (float("-inf"), 0.0), (0.3, float("inf"))]


def _column(n, seed):
    """float32 values in [-1, 1) with the rounded bounds themselves, NaN
    and infinities mixed in."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1, 1, n).astype(np.float32)
    edges = np.asarray([0.1, 0.3, -0.7, 0.7, 0.25, 0.5], np.float32)
    k = min(n, 64)
    x[r.choice(n, k, replace=False)] = r.choice(edges, k)
    x[r.choice(n, min(n, 8), replace=False)] = np.nan
    if n > 16:
        x[:2] = (np.inf, -np.inf)
    return x


@pytest.mark.parametrize("n,block", [(8192, 1024), (4096, 512), (1024, 1024)])
@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_float32_plain_route_matches_select_pallas(n, block, lo, hi):
    x = _column(n, n + block)
    idx_r, cnt_r = select_pallas(jnp.asarray(x), lo, hi, block=block,
                                 interpret=True)
    before = dict(_build.LAUNCHES)
    idx, cnt = selection.select(torch.from_numpy(x), lo, hi, block=block)
    assert _build.LAUNCHES == before            # CPU tensors: no launch
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_r))


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_float32_plain_route_ragged_tail(n):
    """Lengths no block tiles, which the reference kernel refuses: the
    index line and per-block counts against numpy in float32."""
    x = _column(n, 3 * n)
    lo, hi = 0.1, 0.3
    idx, cnt = selection.select(torch.from_numpy(x), lo, hi, block=1024)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    want = np.where((x >= lo32) & (x <= hi32), np.arange(n), -1)
    np.testing.assert_array_equal(idx.numpy(), want)
    counts = [(want[b:b + 1024] >= 0).sum() for b in range(0, n, 1024)]
    np.testing.assert_array_equal(cnt.numpy(), counts)


def test_float32_bounds_round_like_the_reference():
    for lo, hi in BOUNDS:
        ref = (float(jnp.asarray([lo], jnp.float32)[0]),
               float(jnp.asarray([hi], jnp.float32)[0]))
        assert sel_ref.float32_bounds(lo, hi) == ref
    # integer columns keep their int32 normalization
    assert sel_ref.column_bounds(torch.int32, 0.5, 2.5) == (1, 2)
    mask = engine.in_range(torch.tensor([np.float32(0.3)]), 0.1, 0.3)
    assert bool(mask[0])                 # hi rounds up to the row's value


def test_eager_float_filter_matches_reference():
    """The C4 repro: an eager filter on a float32 column, then a project,
    and a sum over it, equal to the reference's eager lowering."""
    x = _column(4096, 11)
    x[np.isnan(x)] = 0.0                 # a sum over NaN is NaN either way
    v = np.arange(4096, dtype=np.int32)
    arrays = {"t": {"f": x, "v": v}}
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    ref = RExecutor(RCatalog.from_tables(RTable.from_arrays("t", arrays["t"])),
                    mesh=mesh, cost_model=RCostModel(1, calibration=None))
    port = Executor(catalog_from_arrays(arrays, "cpu"), device="cpu")
    for lo, hi in ((0, 1), (0.1, 0.3), (-0.7, 0.7)):
        want = ref.execute(RQ.scan("t").filter("f", lo, hi).project("f", "v"),
                           mode="eager").value
        got = port.execute(Q.scan("t").filter("f", lo, hi).project("f", "v"),
                           mode="eager").value
        for c in ("f", "v"):
            np.testing.assert_array_equal(got.column(c).numpy(),
                                          np.asarray(want.column(c)))
        assert port.execute(Q.scan("t").filter("f", lo, hi).sum("v"),
                            mode="eager").value \
            == ref.execute(RQ.scan("t").filter("f", lo, hi).sum("v"),
                           mode="eager").value


def test_other_column_types_still_raise_on_the_card_path():
    """Only int32 and float32 have a kernel entry: the wrapper refuses any
    other type off the CPU before it builds or launches anything (a meta
    tensor stands in for the card's here)."""
    for dtype in (torch.int64, torch.float64, torch.float16):
        with pytest.raises(TypeError, match="int32 or float32"):
            selection.select(torch.zeros(4, dtype=dtype, device="meta"),
                             0, 1)
