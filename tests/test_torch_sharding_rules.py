"""The port's logical-axis sharding rules and parameter specs against the
reference's, on the CPU, with no devices: both resolve against abstract
meshes of the same axes and sizes (the production meshes of 256 and 512
chips, and (1, 1)).

Everything here is exact: every field of ``resolve``, every ``spec`` (the
reference's ``PartitionSpec`` as a tuple), every parameter spec (name,
shape, logical axes less the superblock dim, type) of every arch at tp 1
and 16, and ``validate_divisibility``'s problems, message for message.
At tp 1 the specs are also the model's own parameters, built on the
``meta`` device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_get_arch
from repro.distributed import sharding as r_sharding
from repro.models import registry as r_registry
from repro.models.transformer import _period as r_period

from repro_torch.configs import SHAPES, all_archs, get_arch
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry

ARCHS = sorted(all_archs())
LOGICAL_AXES = ("batch", "seq", "kv_seq", "heads", "kv_heads", "mlp",
                "vocab", "experts", "moe_mlp", "fsdp", "ssm_heads",
                "head_dim")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
          "one": ((1, 1), ("data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return (mesh_mod.AbstractMesh(sizes, names),
            jax.sharding.AbstractMesh(sizes, names))


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return jnp.dtype(dt).name


def _reference_unstacked(cfg, tp):
    """The reference's ``init_specs(tp)`` as ``{port name: LogicalArray}``:
    superblock ``sb`` at position ``j`` is layer ``sb * P + j``; an
    encoder-decoder's stacks layer by layer; the stacking dim dropped."""
    tree = r_registry.bundle(cfg).init_specs(tp)
    out = {}

    def put(name, la):
        out[name] = r_sharding.LogicalArray(la.shape, la.logical, la.dtype)

    def walk(prefix, t, layer_of=None):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, layer_of)
            elif layer_of is None:
                put(f"{prefix}{k}", v)
            else:
                for sb in range(v.shape[0]):
                    put(layer_of(sb) + f"{prefix}{k}",
                        r_sharding.LogicalArray(v.shape[1:], v.logical[1:],
                                                v.dtype))

    for k, v in tree.items():
        if k == "layers":
            p = r_period(cfg)
            for j, pos in enumerate(v):
                walk("", pos, lambda sb, j=j: f"layers.{sb * p + j}.")
        elif k in ("encoder", "decoder"):
            walk("", v, lambda sb, k=k: f"{k}.{sb}.")
        else:
            put(k, v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_matches_the_reference(arch):
    cfg, r_cfg = get_arch(arch), r_get_arch(arch)
    shapes = [(None, None)] + [(SHAPES[s], R_SHAPES[s]) for s in SHAPES]
    n = 0
    for mesh_name in MESHES:
        mesh, r_mesh = _meshes(mesh_name)
        for shape, r_shape in shapes:
            for cp in (False, True):
                for fsdp in (False, True):
                    got = sharding.resolve(cfg, mesh, shape,
                                           context_parallel_decode=cp,
                                           fsdp=fsdp)
                    want = r_sharding.resolve(r_cfg, r_mesh, r_shape,
                                              context_parallel_decode=cp,
                                              fsdp=fsdp)
                    for f in LOGICAL_AXES:
                        assert getattr(got, f) == getattr(want, f), \
                            (mesh_name, shape, cp, fsdp, f)
                    n += 1
    assert n == 3 * 5 * 4


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e",
                                  "whisper-large-v3", "qwen2-vl-7b"])
def test_spec_matches_the_reference_for_every_logical_axis(arch, mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    for s in (None, "decode_32k", "long_500k"):
        rules = sharding.resolve(get_arch(arch), mesh,
                                 SHAPES[s] if s else None,
                                 context_parallel_decode=True)
        r_rules = r_sharding.resolve(r_get_arch(arch), r_mesh,
                                     R_SHAPES[s] if s else None,
                                     context_parallel_decode=True)
        for ax in (None,) + LOGICAL_AXES:
            assert rules.spec(ax) == tuple(r_rules.spec(ax)), (s, ax)
        combo = ("batch", None, "vocab", "fsdp")
        assert rules.spec(*combo) == tuple(r_rules.spec(*combo))


def test_placements_shard_each_named_mesh_dim_major_first():
    mesh, _ = _meshes("multi_pod")
    rules = sharding.resolve(get_arch("llama3-8b"), mesh)
    assert rules.spec("batch", None, "vocab") == (("pod", "data"), None,
                                                  "model")
    assert rules.placements("batch", None, "vocab") == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements("fsdp", None) == (Replicate(), Shard(0),
                                              Replicate())
    assert rules.placements(None, None) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        rules.placements("fsdp", "fsdp")
    sds = sharding.tree_sds({"w": sharding.LogicalArray(
        (64, 32), ("vocab", "fsdp"), torch.bfloat16)}, rules)["w"]
    assert sds.device.type == "meta" and sds.shape == (64, 32)
    assert sds.dtype == torch.bfloat16
    assert sds.placements == (Replicate(), Shard(1), Shard(0))
    assert sds.device_mesh is mesh


def test_constrain_leaves_a_plain_tensor_unchanged():
    mesh, _ = _meshes("pod")
    rules = sharding.resolve(get_arch("llama3-8b"), mesh)
    x = torch.ones(4, 3)
    assert rules.constrain(x, "batch", None) is x


def test_production_meshes_are_abstract():
    for multi, sizes in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        m = mesh_mod.make_production_mesh(multi_pod=multi)
        assert m.shape == sizes and tuple(m.axis_names) == tuple(sizes)
        assert mesh_mod.mesh_axis(m, "model") == 16
        assert mesh_mod.mesh_axis(m, "stage") == 1
        assert mesh_mod.data_axes(m) == (("pod", "data") if multi
                                         else ("data",))


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_specs_match_the_reference_unstacked(arch, tp):
    got = registry.bundle(get_arch(arch)).init_specs(tp)
    want = _reference_unstacked(r_get_arch(arch), tp)
    assert sorted(got) == sorted(want)
    for name, la in got.items():
        w = want[name]
        assert (la.shape, la.logical, _dtype_name(la.dtype)) == \
            (tuple(w.shape), tuple(w.logical), _dtype_name(w.dtype)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_specs_are_the_models_parameters_at_tp_1(arch):
    mb = registry.bundle(get_arch(arch))
    model = mb.build("meta")
    got = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    specs = mb.init_specs(1)
    assert got == {k: (la.shape, la.dtype) for k, la in specs.items()}


@pytest.mark.parametrize("mesh_name", ["pod", "multi_pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_divisibility_problem_on_the_production_meshes(arch, mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    specs = registry.bundle(get_arch(arch)).init_specs(16)
    assert sharding.validate_divisibility(
        specs, sharding.resolve(get_arch(arch), mesh)) == []
    r_cfg = r_get_arch(arch)
    assert r_sharding.validate_divisibility(
        r_registry.bundle(r_cfg).init_specs(16),
        r_sharding.resolve(r_cfg, r_mesh)) == []


@pytest.mark.parametrize("arch", ["mamba2-780m", "qwen2-vl-7b", "stablelm-3b",
                                  "whisper-large-v3"])
def test_divisibility_problems_on_a_model_axis_of_7_match(arch):
    """tp-1 specs on a (2, 7) mesh: the port's problems are the
    reference's on its unstacked tree, message for message.  (The other
    archs' GQA head counts pad to no multiple of their kv heads at tp 7,
    which both configs refuse.)"""
    mesh = mesh_mod.AbstractMesh((2, 7), ("data", "model"))
    r_mesh = jax.sharding.AbstractMesh((2, 7), ("data", "model"))
    got = sharding.validate_divisibility(
        registry.bundle(get_arch(arch)).init_specs(1),
        sharding.resolve(get_arch(arch), mesh))
    r_cfg = r_get_arch(arch)
    want = r_sharding.validate_divisibility(
        _reference_unstacked(r_cfg, 1), r_sharding.resolve(r_cfg, r_mesh))
    assert sorted(got) == sorted(want)       # jax walks dicts in key order
    assert got, "a model axis of 7 divides no head count here"


def test_local_block_chunks_like_dtensor():
    """Blocks of a dim over two mesh dims, major first, in ``torch.chunk``
    sizes (a ragged last block)."""
    class FakeMesh:
        def __init__(self, coord, sizes):
            self.coord, self.sizes = coord, sizes

        def get_coordinate(self):
            return self.coord

        def size(self, m):
            return self.sizes[m]

    shape = (10, 6)
    pl = (Shard(0), Shard(0))
    blocks = [sharding.local_block(shape, FakeMesh((a, b), (2, 2)), pl)
              for a in range(2) for b in range(2)]
    chunks = [c for half in torch.arange(10).chunk(2)
              for c in half.chunk(2)]
    assert [tuple(range(10)[s[0]]) for s in blocks] == \
        [tuple(c.tolist()) for c in chunks]
    assert all(s[1] == slice(0, 6) for s in blocks)
