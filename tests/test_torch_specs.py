"""The dry run's inputs and analysis against the reference's, on the CPU,
with no devices: the batch and cache stand-ins, ``step_and_specs``' args,
``make_batch``, the roofline and its ``model_flops``, the collectives'
ring model, ``report``'s tables; and the models' forward with sharding
rules on plain tensors, which must be the forward without them, bit for
bit.

Specs are compared on the abstract production meshes, built for both
sides as ``tests/test_torch_sharding_rules.py`` builds them: a stand-in's
shape, type and layout (its placements read back as the reference's
``PartitionSpec``) equal the reference's ``ShapeDtypeStruct``'s.  The
port holds caches and params per layer: the reference's leaf stacked
over superblocks, at position j, is the port's layers j, j + P, ...
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.analysis import hlo as r_hlo
from repro.analysis import report as r_report
from repro.analysis import roofline as r_roofline
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_get_arch
from repro.configs import smoke_config as r_smoke_config
from repro.distributed import sharding as r_sharding
from repro.models import registry as r_registry
from repro.models.transformer import _period as r_period
from repro.train import train_loop as r_train_loop

from repro_torch.analysis import collectives, report, roofline
from repro_torch.configs import (
    SHAPES, ShapeConfig, all_archs, get_arch, smoke_config,
)
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.common import init_params
from repro_torch.models.mamba import SSMCache
from repro_torch.train import train_loop

ARCHS = sorted(all_archs())
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return (mesh_mod.AbstractMesh(sizes, names),
            jax.sharding.AbstractMesh(sizes, names))


def _rules(arch, shape_name, mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    cp = shape_name == "long_500k" and get_arch(arch).family == "hybrid"
    return (sharding.resolve(get_arch(arch), mesh, SHAPES[shape_name],
                             context_parallel_decode=cp),
            r_sharding.resolve(r_get_arch(arch), r_mesh,
                               R_SHAPES[shape_name],
                               context_parallel_decode=cp))


def _dtype(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return jnp.dtype(dt).name


def _norm(spec, ndim) -> tuple:
    out = []
    for a in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(a, tuple):
            a = (a[0] if len(a) == 1 else tuple(a)) if a else None
        out.append(a)
    return tuple(out)


def _port_spec(t) -> tuple:
    """A stand-in's placements as the reference's PartitionSpec tuple."""
    names = mesh_mod.axis_names(t.device_mesh)
    out = []
    for d in range(t.dim()):
        axes = tuple(n for n, p in zip(names, t.placements)
                     if isinstance(p, Shard) and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def _same(got, want, what):
    """A port stand-in against a reference ShapeDtypeStruct (or a
    LogicalArray against a reference LogicalArray)."""
    if isinstance(got, sharding.LogicalArray):
        assert (got.shape, got.logical, _dtype(got.dtype)) == \
            (tuple(want.shape), tuple(want.logical), _dtype(want.dtype)), \
            what
        return
    assert tuple(got.shape) == tuple(want.shape), what
    assert got.device.type == "meta", what
    assert _dtype(got.dtype) == _dtype(want.dtype), what
    spec = () if want.sharding is None else want.sharding.spec
    assert _port_spec(got) == _norm(spec, len(want.shape)), what


def _slice(v, sb):
    """Superblock ``sb`` of a stacked ShapeDtypeStruct or LogicalArray."""
    if isinstance(v, r_sharding.LogicalArray):
        return r_sharding.LogicalArray(v.shape[1:], v.logical[1:], v.dtype)
    spec = tuple(v.sharding.spec) if v.sharding is not None else ()
    sh = jax.sharding.NamedSharding(v.sharding.mesh, jax.sharding
                                    .PartitionSpec(*spec[1:]))
    return jax.ShapeDtypeStruct(v.shape[1:], v.dtype, sharding=sh)


def _check_caches(cfg, got, want):
    """The port's per-layer caches against the reference's stacked ones."""
    if cfg.is_enc_dec:
        for n in ("k", "v"):
            _same(got["cross"][n], want["cross"][n], f"cross.{n}")
        self_got, stacked = got["self"], want["self"]
        assert len(self_got) == cfg.num_layers
        for i, c in enumerate(self_got):
            for n in ("k", "v"):
                _same(c[n], _slice(stacked[n], i), f"self.{i}.{n}")
        return
    p = r_period(cfg)
    assert len(got) == cfg.num_layers
    for i, c in enumerate(got):
        leaf = want[i % p]
        assert sorted(c) == sorted(leaf), i
        for n in c:
            _same(c[n], _slice(leaf[n], i // p), f"layers.{i}.{n}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch, mesh_name):
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    for s in SHAPES:
        rules, r_rules = _rules(arch, s, mesh_name)
        got = registry.batch_specs(cfg, SHAPES[s], rules)
        want = r_registry.batch_specs(r_cfg, R_SHAPES[s], r_rules)
        assert sorted(got) == sorted(want), s
        for k in got:
            _same(got[k], want[k], (s, k))
        got_c = registry.cache_specs_sds(cfg, SHAPES[s], rules)
        want_c = r_registry.cache_specs_sds(r_cfg, R_SHAPES[s], r_rules)
        if want_c is None:
            assert got_c is None
            continue
        _check_caches(cfg, got_c, want_c)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_arrays_match_the_reference(arch):
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    from repro.models import encdec as r_encdec
    from repro.models import transformer as r_transformer
    for tp in (1, 16):
        if cfg.is_enc_dec:
            got = encdec.cache_logical(cfg, 4, 64, tp, enc_len=32)
            want = r_encdec.cache_specs(r_cfg, 4, 64, tp, enc_len=32)
        else:
            got = transformer.cache_logical(cfg, 4, 64, tp)
            want = r_transformer.cache_specs(r_cfg, 4, 64, tp)
        _check_caches(cfg, got, want)


def _unstacked_params(cfg, tree):
    """The reference's (stacked) param or state tree keyed by the port's
    names, per layer."""
    out = {}

    def walk(prefix, t, layer_of=None):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, layer_of)
            elif layer_of is None:
                out[f"{prefix}{k}"] = v
            else:
                for sb in range(v.shape[0]):
                    out[layer_of(sb) + f"{prefix}{k}"] = _slice(v, sb)

    for k, v in tree.items():
        if k == "layers":
            p = r_period(cfg)
            for j, pos in enumerate(v):
                walk("", pos, lambda sb, j=j: f"layers.{sb * p + j}.")
        elif k in ("encoder", "decoder"):
            walk("", v, lambda sb, k=k: f"{k}.{sb}.")
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_and_specs_args_match_the_reference(arch, mesh_name):
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    for s in SHAPES:
        if cfg.skip_reason(SHAPES[s]):
            continue
        rules, r_rules = _rules(arch, s, mesh_name)
        _, args = train_loop.step_and_specs(cfg, SHAPES[s], rules)
        _, r_args = r_train_loop.step_and_specs(r_cfg, R_SHAPES[s], r_rules)
        assert len(args) == len(r_args) == 3
        params, want = args[0], _unstacked_params(r_cfg, r_args[0])
        assert sorted(params) == sorted(want), s
        for n in params:
            _same(params[n], want[n], (s, n))
        if SHAPES[s].kind == "train":
            opt, r_opt = args[1], r_args[1]
            assert sorted(opt) == sorted(r_opt)
            _same(opt["count"], r_opt["count"], (s, "count"))
            for part in ("master", "m", "v"):
                r_part = _unstacked_params(r_cfg, r_opt[part])
                assert sorted(opt[part]) == sorted(r_part)
                for n in opt[part]:
                    _same(opt[part][n], r_part[n], (s, part, n))
            batch, r_batch = args[2], r_args[2]
        else:
            batch, r_batch = args[1], r_args[1]
            _check_caches(cfg, args[2], r_args[2])
        assert sorted(batch) == sorted(r_batch)
        for k in batch:
            _same(batch[k], r_batch[k], (s, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_init_specs_match_the_reference(arch):
    from repro.train.optimizer import AdamW as RAdamW, PaperSGD as RSGD
    from repro_torch.train.optimizer import AdamW, PaperSGD
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    specs = registry.bundle(cfg).init_specs(16)
    r_specs = r_registry.bundle(r_cfg).init_specs(16)
    got, want = AdamW().init_specs(specs), RAdamW().init_specs(r_specs)
    assert sorted(got) == sorted(want)
    _same(got["count"], want["count"], "count")
    for part in ("master", "m", "v"):
        w = _unstacked_params(r_cfg, want[part])
        assert sorted(got[part]) == sorted(w)
        for n, la in got[part].items():
            _same(la, w[n], (part, n))
    got, want = PaperSGD().init_specs(specs), RSGD().init_specs(r_specs)
    assert sorted(got) == sorted(want) == ["count"]
    _same(got["count"], want["count"], "count")


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_the_reference(arch):
    cfg, r_cfg = smoke_config(get_arch(arch)), r_smoke_config(r_get_arch(arch))
    mesh, r_mesh = (mesh_mod.AbstractMesh((1, 1), ("data", "model")),
                    jax.sharding.AbstractMesh((1, 1), ("data", "model")))
    gen = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"s_{kind}", 48, 2, kind)
        r_shape = type(R_SHAPES["train_4k"])(f"s_{kind}", 48, 2, kind)
        rules = sharding.resolve(cfg, mesh, shape)
        r_rules = r_sharding.resolve(r_cfg, r_mesh, r_shape)
        got = registry.make_batch(cfg, shape, rules, gen)
        want = r_registry.make_batch(r_cfg, r_shape, r_rules,
                                     jax.random.key(0))
        assert sorted(got) == sorted(want), kind
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, (kind, k)
            assert _dtype(got[k].dtype) == _dtype(want[k].dtype), (kind, k)
        for k in ("pos", "positions"):
            if k in want:
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        for k in ("tokens", "targets"):
            if k in got:
                t = got[k]
                assert t.min() >= 0 and t.max() < cfg.vocab_size


def test_make_cache_in_the_references_form():
    cfg = smoke_config(get_arch("jamba-v0.1-52b"))
    shape = ShapeConfig("s", 32, 2, "decode")
    rules = sharding.resolve(cfg, mesh_mod.AbstractMesh((1, 1),
                                                        ("data", "model")))
    caches = registry.make_cache(cfg, shape, rules, device="cpu")
    specs = registry.cache_specs_sds(cfg, shape, rules)
    assert len(caches) == len(specs) == cfg.num_layers
    for c, s in zip(caches, specs):
        assert sorted(c) == sorted(s)
        for n in c:
            assert c[n].shape == s[n].shape and c[n].dtype == s[n].dtype
            assert not c[n].any()
    assert registry.make_cache(cfg, SHAPES["train_4k"], rules,
                               device="cpu") is None
    old = registry.make_cache(cfg, 2, 32, device="cpu")
    assert isinstance(old[0], (KVCache, SSMCache))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_the_reference(arch):
    for s in SHAPES:
        assert roofline.model_flops(get_arch(arch), SHAPES[s]) == \
            r_roofline.model_flops(r_get_arch(arch), R_SHAPES[s])


def test_roofline_with_the_references_constants_is_the_references():
    consts = {"peak_flops": r_roofline.PEAK_FLOPS,
              "hbm_bw": r_roofline.HBM_BW, "net_bw": r_roofline.ICI_BW}
    for arch, s, f, b, co, cw in (
            ("llama3-8b", "train_4k", 3.9e14, 1.0e13, 2.1e11, 4.0e11),
            ("mamba2-780m", "long_500k", 1.2e9, 3.3e9, 0.0, 0.0),
            ("whisper-large-v3", "decode_32k", 5.0e11, 9.0e9, 1.0e9, 2e9)):
        got = roofline.from_measurements(
            get_arch(arch), SHAPES[s], "pod16x16", 256, f, b, co, cw,
            **consts).to_dict()
        want = r_roofline.from_measurements(
            r_get_arch(arch), R_SHAPES[s], "pod16x16", 256, f, b, co,
            cw).to_dict()
        assert got == want


def test_h100_constants_are_the_data_sheets():
    from repro_torch.core.channels import H100_HBM_GBPS
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == H100_HBM_GBPS * 1e9 == 3.35e12
    assert roofline.NET_BW == 50e9


def test_ring_model_matches_the_references_collective_stats():
    lines, records = [], []
    cases = [("all-gather", "bf16", (4096, 896), 16),
             ("all-reduce", "f32", (16, 4096), 16),
             ("reduce-scatter", "bf16", (256, 1024), 16),
             ("all-to-all", "bf16", (8, 128), 4),
             ("collective-permute", "f32", (64,), 2),
             ("all-reduce", "f32", (), 256)]
    size = {"bf16": 2, "f32": 4}
    for i, (kind, dt, shape, g) in enumerate(cases):
        dims = ",".join(str(n) for n in shape)
        lines.append(f"  %c{i} = {dt}[{dims}]{{0}} {kind}(%x{i}), "
                     f"replica_groups=[{256 // g},{g}]<=[256]")
        records.append(collectives.CollectiveRecord(
            kind, int(np.prod(shape)) * size[dt], g))
    want = r_hlo.collective_stats("\n".join(lines))
    got = collectives.collective_stats(records)
    assert got.counts == want.counts
    for k in want.operand_bytes:
        assert got.operand_bytes[k] == pytest.approx(want.operand_bytes[k],
                                                     rel=1e-12)
        assert got.wire_bytes[k] == pytest.approx(want.wire_bytes[k],
                                                  rel=1e-12)
    assert got.total_operand_bytes == pytest.approx(
        want.total_operand_bytes, rel=1e-12)


def test_op_histogram_counts_most_frequent_first():
    ops = ["aten.mm"] * 3 + ["aten.add"] * 5 + ["aten.view"]
    assert collectives.op_histogram(ops, top=2) == [("aten.add", 5),
                                                    ("aten.mm", 3)]


def _results():
    """One results dict in the dry run's cell format."""
    res = {}
    rng = np.random.default_rng(0)
    for a in ARCHS:
        for s in SHAPES:
            cfg = get_arch(a)
            key = f"{a}|{s}|pod16x16"
            if cfg.skip_reason(SHAPES[s]):
                res[key] = {"arch": a, "shape": s, "mesh": "pod16x16",
                            "status": "skipped",
                            "reason": cfg.skip_reason(SHAPES[s])}
                continue
            if a == "stablelm-3b" and s == "prefill_32k":
                res[key] = {"arch": a, "shape": s, "mesh": "pod16x16",
                            "status": "error", "error": "E"}
                continue
            f, b, co = (float(x) for x in rng.uniform(1e9, 1e14, 3))
            rl = roofline.from_measurements(cfg, SHAPES[s], "pod16x16", 256,
                                            f, b, co, 2 * co).to_dict()
            res[key] = {"arch": a, "shape": s, "mesh": "pod16x16",
                        "status": "ok", "compile_s": 1.5,
                        "flops_per_dev": f, "bytes_per_dev": b,
                        "collectives": {"all-gather": 3, "all-reduce": 2},
                        "coll_operand_bytes": co,
                        "memory": {"argument_bytes": 1e9,
                                   "temp_bytes": 2e9},
                        "roofline": rl}
    return res


def test_report_renders_the_references_tables(tmp_path, monkeypatch):
    import json
    res = _results()
    path = tmp_path / "results.json"
    path.write_text(json.dumps(res))
    monkeypatch.setattr(r_report, "RESULTS", path)
    # the hints name the card's remedies; the tables are otherwise the
    # reference's, character for character
    monkeypatch.setattr(report, "_BOTTLENECK_HINTS",
                        r_report._BOTTLENECK_HINTS)
    assert report.roofline_table(results=res) == r_report.roofline_table()
    assert report.dryrun_table("pod16x16", results=res) == \
        r_report.dryrun_table("pod16x16")
    assert report.pick_hillclimb_cells(results=res) == \
        r_report.pick_hillclimb_cells()
    monkeypatch.setattr(report, "RESULTS", path)
    assert report.roofline_table() == r_report.roofline_table()


def test_compact_table_holds_every_cell():
    res = _results()
    rows = report.compact_table(results=res).splitlines()
    assert rows[0] == ("| arch | train_4k | prefill_32k | decode_32k | "
                       "long_500k |")
    assert len(rows) == 2 + len(ARCHS)
    for row in rows[2:]:
        arch = row.split(" | ")[0].strip("| ")
        cells = row.strip("| ").split(" | ")[1:]
        for s, cell in zip(("train_4k", "prefill_32k", "decode_32k",
                            "long_500k"), cells):
            c = res[f"{arch}|{s}|pod16x16"]
            if c["status"] != "ok":
                assert cell == c["status"]
                continue
            r = c["roofline"]
            assert cell.startswith(f"{r['t_compute'] * 1e3:,.1f} / ")
            assert r["bottleneck"][:4] in cell


def test_report_hints_cover_the_references_cases():
    assert sorted(report._BOTTLENECK_HINTS) == \
        sorted(r_report._BOTTLENECK_HINTS)


# --------------------------------------------------------------------------- #
# rules on plain tensors change nothing
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "qwen2-vl-7b", "whisper-large-v3"])
def test_forward_with_rules_on_plain_tensors_is_bit_identical(arch):
    cfg = smoke_config(get_arch(arch))
    rules = sharding.resolve(cfg, mesh_mod.AbstractMesh((2, 2),
                                                        ("data", "model")))
    mb = registry.bundle(cfg)
    model = mb.build("cpu")
    init_params(model, torch.Generator().manual_seed(1))
    model.float()
    gen = torch.Generator().manual_seed(2)
    shape = ShapeConfig("s", 48, 2, "train")
    batch = registry.make_batch(cfg, shape, rules, gen)
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    with torch.no_grad():
        plain, m0 = mb.loss_fn(model, batch, remat=False)
        ruled, m1 = mb.loss_fn(model, batch, remat=False, rules=rules)
    assert torch.equal(plain, ruled)
    assert torch.equal(m0["aux"], m1["aux"])
    kw = {"frames": batch["frames"]} if cfg.is_enc_dec else {}
    if cfg.family == "vlm":
        kw = {"vision_embeds": batch["vision_embeds"],
              "positions": batch["positions"]}
    outs = []
    for r in (None, rules):
        caches = registry.make_cache(cfg, 2, 49, device="cpu",
                                     dtype=torch.float32, enc_len=48)
        extra = {} if r is None else {"rules": r}
        with torch.no_grad():
            lp, caches = mb.prefill_fn(model, batch["tokens"], caches,
                                       **kw, **extra)
            ld, _ = mb.decode_fn(model, batch["tokens"][:, -1:], 48, caches,
                                 **extra)
        outs.append((lp, ld))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
