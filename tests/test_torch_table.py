"""The port's data layer (``columnar/table.py``, ``core/channels.py``,
``device.py``) against the JAX reference, on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro.columnar.table import MorselSpec as RMorselSpec
from repro.columnar.table import Table as RTable
from repro.core import channels as r_channels

from repro_torch import device as port_device
from repro_torch.columnar.table import MorselSpec, Table
from repro_torch.core import channels


def _ref_plan(n_engines=1):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))
    plan = r_channels.plan(mesh, "model", "partitioned")
    assert plan.n_engines == n_engines
    return plan


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("n,rows", [(4096, 1000), (4097, 4096), (1, 8),
                                    (1000, 1000), (0, 16)])
@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_morsels_match_reference_on_ragged_sizes(tmp_path, n, rows, tier):
    r = np.random.default_rng(n)
    cols = {"a": r.integers(-9, 9, n).astype(np.int32),
            "b": r.random(n).astype(np.float32)}
    ref = RTable.from_arrays("t", cols)
    port = Table.from_arrays("t", cols, "cpu")
    if tier != "device":
        for name in cols:
            ref.demote_column(name, tier, str(tmp_path / "r"))
            port.demote_column(name, tier, str(tmp_path / "p"))
            assert port.column_tier(name) == tier
    spec, rspec = MorselSpec(n, rows), RMorselSpec(n, rows)
    assert spec.n_morsels == rspec.n_morsels
    for i in range(spec.n_morsels):
        got, n_valid = port.morsel(spec, i)
        want, r_valid = ref.morsel(rspec, i)
        assert n_valid == r_valid
        for c in cols:
            assert got[c].shape[0] == rows
            np.testing.assert_array_equal(_host(got[c]), _host(want[c]))
    assert port.version == ref.version == 0


def test_tier_moves_keep_the_version_and_updates_bump_it(tmp_path):
    port = Table.from_arrays("t", {"a": np.arange(10, dtype=np.int32)},
                             "cpu")
    port.demote_column("a", "disk", str(tmp_path))
    assert isinstance(port.column("a"), np.memmap)
    port.promote_column("a", "cpu")
    assert port.column_tier("a") == "device" and port.version == 0
    port.update_column("a", np.arange(10, 20, dtype=np.int32))
    assert port.version == 1
    assert int(port.column("a").sum()) == sum(range(10, 20))
    with pytest.raises(ValueError):
        port.update_column("a", np.arange(3, dtype=np.int32))


@pytest.mark.parametrize("total,target", [(4096, 1000), (10, 4096),
                                          (0, 16), (4097, 1)])
def test_morsel_spec_for_plan_matches_reference(total, target):
    got = MorselSpec.for_plan(total, target, channels.plan())
    want = RMorselSpec.for_plan(total, target, _ref_plan())
    assert (got.total_rows, got.rows) == (want.total_rows, want.rows)


def test_engine_alignment_and_bandwidth_model_match_reference():
    for n_eng in (1, 3, 8):
        p = channels.plan(n_engines=n_eng)
        for rows in (1, 5, 1000, 4097):
            want = max(-(-rows // n_eng) * n_eng, n_eng)
            assert p.align_morsel_rows(rows) == want
    assert channels.plan().align_morsel_rows(1000) == \
        _ref_plan().align_morsel_rows(1000)
    for ports in (1, 8, 32):
        for sep in (0, 64, 256, 512):
            for clk in (200, 300):
                assert channels.fpga_bandwidth_model(ports, sep, clk) == \
                    r_channels.fpga_bandwidth_model(ports, sep, clk)


def test_device_resolution_never_falls_back_quietly(monkeypatch):
    assert port_device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError):
        Table.from_arrays("t", {"a": np.arange(3, dtype=np.int32)})


def test_columns_take_the_reference_32_bit_types():
    arrays = {"i": np.arange(5, dtype=np.int64),
              "f": np.linspace(0, 1, 5), "b": np.ones(5, bool)}
    ref = RTable.from_arrays("t", arrays)
    port = Table.from_arrays("t", arrays, "cpu")
    for c in arrays:
        assert str(port.column(c).dtype).split(".")[-1] == \
            str(ref.column(c).dtype)
        np.testing.assert_array_equal(port.column(c).numpy(),
                                      np.asarray(ref.column(c)))
    with pytest.raises(ValueError, match="int32"):
        Table.from_arrays("t", {"i": np.asarray([2 ** 40])}, "cpu")


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_update_of_a_lower_tier_column_goes_to_the_card(tmp_path,
                                                         monkeypatch, tier):
    """New data for a host or disk column lands on the card, as the
    reference puts it on its default device; never quietly on the CPU.
    Without a card that is an error unless the caller names a device."""
    from repro_torch.query.exec import Catalog
    cols = {"a": np.arange(10, dtype=np.int32)}
    ref = RTable.from_arrays("t", cols)
    ref.demote_column("a", tier, str(tmp_path / "r"))
    ref.update_column("a", np.arange(10, 20, dtype=np.int32))
    port = Table.from_arrays("t", cols, "cpu")
    port.demote_column("a", tier, str(tmp_path / "p"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.update_column("a", np.arange(10, 20, dtype=np.int32))
    assert port.version == 0 and port.column_tier("a") == tier
    port.update_column("a", np.arange(10, 20, dtype=np.int32), "cpu")
    assert port.column_tier("a") == ref.column_tier("a") == "device"
    assert isinstance(port.column("a"), torch.Tensor)
    np.testing.assert_array_equal(port.column("a").numpy(),
                                  np.asarray(ref.column("a")))
    assert port.version == ref.version == 1
    # the catalog updates onto its own device
    cat = Catalog("cpu").register(Table.from_arrays("t", cols, "cpu"))
    cat.tables["t"].demote_column("a", tier, str(tmp_path / "c"))
    cat.update_column("t", "a", np.arange(5, 15, dtype=np.int32))
    assert cat.tables["t"].column("a").device == torch.device("cpu")
    assert cat.stats["t"].ranges["a"].lo == 5


def test_plan_place_sends_numpy_to_the_card_and_keeps_tensors(monkeypatch):
    """``ChannelPlan.place`` without a device leaves a tensor where it is
    and puts a numpy column on the card — an error without one, never a
    quiet CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(6, dtype=np.int32)
    t = torch.arange(6, dtype=torch.int32)
    assert channels.plan().place(t) is t
    with pytest.raises(RuntimeError, match="device='cpu'"):
        channels.plan().place(x)
    got = channels.plan(device="cpu").place(x)
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), x)
