"""The port's distributed layer on the CPU, with gloo process groups of 1,
2 and 4 ranks, against the reference.

Each world size starts once for the file (``worlds``): its ranks are
spawned processes that rendezvous through a ``file://`` store in the
test's temporary directory (no TCP port, so concurrent test workers never
collide), import torch and the port only, and run every function of the
layer on the same seeded inputs: ``cp_decode_attention`` over their
slices of the sequence, ``pipeline_apply`` with a stage each,
``compressed_psum`` over two steps of error feedback, and
``checkpoint.restore(shardings=)`` onto ``(1, world)`` and, at 4 ranks,
``(2, 2)``.  The reference runs at 4 host devices in one subprocess
(``JAX_PLATFORMS=cpu``, ``PYTHONPATH=src``,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on an Auto-axis
mesh, and in-process at one device; it is imported inside the test
functions only.

Tolerances: ``cp_decode_attention`` within 2e-5 (the reference test's;
the LSE combine sums in another order), ``pipeline_apply`` within 1e-5
of the stages applied in turn (the reference test's); quantisation,
``compressed_psum`` and the restored blocks bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from _hyp import given, settings, st

from repro_torch.configs import get_arch, smoke_config
from repro_torch.distributed import compression, context_parallel, pipeline
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry
from repro_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
CP_TOL = 2e-5
PIPE_TOL = 1e-5
B, S, H, D = 2, 64, 4, 16
N_MICRO = 4
RESTORE_ARCHS = ("llama3-8b", "jamba-v0.1-52b")
TIES = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0]
WORLD_TIMEOUT_S = 180


# --------------------------------------------------------------------------- #
# seeded inputs, written once for the ranks and the reference subprocess

def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    a = {"q": rng.normal(size=(B, H, 1, D)).astype(f32),
         "k": rng.normal(size=(B, S, H, D)).astype(f32),
         "v": rng.normal(size=(B, S, H, D)).astype(f32),
         "valid": rng.uniform(size=(B, S)) > 0.3,
         "w": rng.normal(size=(4, 8, 8)).astype(f32),
         "x": rng.normal(size=(8, 8)).astype(f32)}
    empty = rng.uniform(size=(B, S)) > 0.3
    empty[0, :S // 2] = False           # ranks 0 (of 2) and 0, 1 (of 4)
    empty[1] = False                    # a row with no valid key at all
    a["valid_empty"] = empty
    for step in (1, 2):
        for r in range(4):
            a[f"g{step}/{r}/w"] = (rng.normal(size=(32, 16)) * (r + 1)
                                   ).astype(f32)
            a[f"g{step}/{r}/b"] = rng.normal(size=(16,)).astype(f32)
            a[f"g{step}/{r}/z"] = np.zeros(8, f32)
            a[f"g{step}/{r}/t"] = np.asarray(TIES, f32) * (step + r)
    np.savez(tmp / "inputs.npz", **a)
    for arch in RESTORE_ARCHS:
        specs = registry.bundle(smoke_config(get_arch(arch))).init_specs(1)
        params = {k: (0.02 * torch.from_numpy(
            rng.normal(size=la.shape).astype(f32))).to(la.dtype)
            for k, la in specs.items()}
        np.savez(tmp / f"params_{arch}.npz",
                 **{k: v.float().numpy() for k, v in params.items()})
        checkpoint.save(tmp / f"ckpt_{arch}", 1, params)
    return a


def _grads(a, step, r) -> dict:
    return {k: torch.from_numpy(a[f"g{step}/{r}/{k}"]) for k in "wbzt"}


def _stage(p, xb):
    return torch.tanh(xb @ p)


# --------------------------------------------------------------------------- #
# one rank of a world (a spawned process: torch and the port only)

def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    tmp = Path(tmp)
    if world > 1:          # a world of one: make_host_mesh starts its group
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp / f'store_{world}'}",
            rank=rank, world_size=world)
    mesh = mesh_mod.make_host_mesh("cpu")
    a = {k: v for k, v in np.load(tmp / "inputs.npz").items()}
    t = {k: torch.from_numpy(a[k]) for k in ("q", "k", "v", "w", "x")}
    sl = slice(rank * S // world, (rank + 1) * S // world)
    out = {"mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                    dist.get_backend(), dist.get_world_size())}
    for key in ("valid", "valid_empty"):
        out[f"cp/{key}"] = context_parallel.cp_decode_attention(
            mesh, "model", t["q"], t["k"][:, sl], t["v"][:, sl],
            torch.from_numpy(a[key])[:, sl])
    out["pipe"] = pipeline.pipeline_apply(mesh, "model", _stage,
                                          t["w"][rank], t["x"], N_MICRO)
    fn = compression.compressed_psum(mesh, "model")
    g1, g2 = _grads(a, 1, rank), _grads(a, 2, rank)
    m1, r1 = fn(g1, compression.zero_residual(g1))
    m2, r2 = fn(g2, r1)
    out["psum"] = {"m1": m1, "r1": r1, "m2": m2, "r2": r2}
    shapes = [(1, world)] + ([(2, 2)] if world == 4 else [])
    for shape in shapes:
        m = mesh if shape == (1, world) else mesh_mod.init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model"))
        for arch in RESTORE_ARCHS:
            cfg = smoke_config(get_arch(arch))
            specs = registry.bundle(cfg).init_specs(1)
            rules = sharding.resolve(cfg, m)
            shard = sharding.tree_shardings(specs, rules)
            got, _ = checkpoint.restore(tmp / f"ckpt_{arch}",
                                        sharding.tree_sds(specs, rules),
                                        shardings=shard)
            for k, x in got.items():
                assert x.placements == shard[k][1] and x.shape == \
                    specs[k].shape and x.dtype == specs[k].dtype, k
            out[f"restore/{arch}/{shape}"] = {
                k: x.to_local() for k, x in got.items()}
            # constrain redistributes: replicated, every rank the whole leaf
            out[f"constrain/{arch}/{shape}"] = rules.constrain(
                got["embed"], None, None).to_local()
            out[f"coord/{shape}"] = tuple(m.get_coordinate())
    torch.save(out, tmp / f"w{world}_r{rank}.pt")
    dist.destroy_process_group()


def _spawn(world: int, tmp: Path) -> list:
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"world {world} took over {WORLD_TIMEOUT_S} s")
    return [torch.load(tmp / f"w{world}_r{r}.pt", weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------- #
# the reference at 4 host devices, in a subprocess

_REFERENCE_SCRIPT = r'''
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_arch, smoke_config
from repro.distributed import compression, context_parallel, pipeline
from repro.distributed.sharding import LogicalArray, resolve, tree_shardings
from repro.models import registry
from repro.models.transformer import _period
from repro.train import checkpoint

tmp = sys.argv[1]
a = dict(np.load(tmp + "/inputs.npz"))
devs = np.array(jax.devices())
assert devs.size == 4, devs
def mesh(shape):
    return Mesh(devs.reshape(shape), ("data", "model"))
out, meta = {}, {}

m14 = mesh((1, 4))
for key in ("valid", "valid_empty"):
    with jax.set_mesh(m14):
        o = context_parallel.cp_decode_attention(
            m14, "model", jnp.asarray(a["q"]), jnp.asarray(a["k"]),
            jnp.asarray(a["v"]), jnp.asarray(a[key]))
    out["cp/" + key] = np.asarray(o)

inner = compression.compressed_psum(m14, "model")
def body(g, r):
    m, nr = inner(jax.tree.map(lambda x: x[0], g),
                  jax.tree.map(lambda x: x[0], r))
    return (jax.tree.map(lambda x: x[None], m),
            jax.tree.map(lambda x: x[None], nr))
fn = shard_map(body, mesh=m14, in_specs=(P("model"), P("model")),
               out_specs=(P("model"), P("model")), check_rep=False)
def grads(step):
    return {k: jnp.stack([jnp.asarray(a[f"g{step}/{r}/{k}"])
                          for r in range(4)]) for k in "wbzt"}
with jax.set_mesh(m14):
    g1 = grads(1)
    m1, r1 = fn(g1, jax.tree.map(jnp.zeros_like, g1))
    m2, r2 = fn(grads(2), r1)
for name, tree in (("m1", m1), ("r1", r1), ("m2", m2), ("r2", r2)):
    for k, x in tree.items():
        out[f"psum/{name}/{k}"] = np.asarray(x)

def port_names(cfg, path, n):
    """(port name, index into the stacked leaf) for a reference leaf."""
    keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
    if keys[0] == "layers":
        p, j, rest = _period(cfg), keys[1], ".".join(keys[2:])
        return [(f"layers.{sb * p + j}.{rest}", sb) for sb in range(n)]
    if keys[0] in ("encoder", "decoder"):
        rest = ".".join(keys[1:])
        return [(f"{keys[0]}.{sb}.{rest}", sb) for sb in range(n)]
    return [(".".join(keys), None)]

is_la = lambda x: isinstance(x, LogicalArray)
for arch in sys.argv[2].split(","):
    cfg = smoke_config(get_arch(arch))
    mb = registry.bundle(cfg)
    specs = mb.init_specs(1)
    flat = dict(np.load(f"{tmp}/params_{arch}.npz"))
    def assemble(path, la):
        names = port_names(cfg, path, la.shape[0])
        if names[0][1] is None:
            x = flat[names[0][0]]
        else:
            x = np.stack([flat[n] for n, _ in names])
        return jnp.asarray(x).astype(la.dtype)
    params = jax.tree_util.tree_map_with_path(assemble, specs, is_leaf=is_la)
    checkpoint.save(f"{tmp}/ref_ckpt_{arch}", 1, params)
    for shape in ((1, 4), (2, 2)):
        m = mesh(shape)
        with jax.set_mesh(m):
            got, _ = checkpoint.restore(
                f"{tmp}/ref_ckpt_{arch}", params,
                shardings=tree_shardings(specs, resolve(cfg, m)))
        leaves = jax.tree_util.tree_flatten_with_path(got)[0]
        for path, x in leaves:
            for s in x.addressable_shards:
                d = np.asarray(s.data.astype(jnp.float32))
                for name, sb in port_names(cfg, path, x.shape[0]):
                    out[f"restore/{arch}/{shape}/{s.device.id}/{name}"] = \
                        d if sb is None else d[sb]

try:
    with jax.set_mesh(m14):
        pipeline.pipeline_apply(
            m14, "model", lambda p, xb: jnp.tanh(xb @ p),
            jnp.asarray(a["w"]), jnp.asarray(a["x"]), n_micro=4)
    meta["pipeline_error"] = None
except Exception as e:
    meta["pipeline_error"] = [type(e).__name__, str(e)]
np.savez(tmp + "/ref4.npz", **out)
json.dump(meta, open(tmp + "/ref4.json", "w"))
'''


def _reference_4(tmp: Path) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("REPRO_HOST_DEVICES", None)
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp),
         ",".join(RESTORE_ARCHS)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@dataclasses.dataclass
class Runs:
    tmp: Path
    inputs: dict
    worlds: dict          # world size -> [rank results]
    ref4: dict            # the reference's outputs at 4 devices
    ref4_meta: dict


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> Runs:
    tmp = tmp_path_factory.mktemp("dist")
    inputs = _inputs(tmp)
    ref = _reference_4(tmp)
    try:
        worlds = {w: _spawn(w, tmp) for w in WORLDS}
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    ref4 = dict(np.load(tmp / "ref4.npz"))
    meta = json.loads((tmp / "ref4.json").read_text())
    return Runs(tmp, inputs, worlds, ref4, meta)


def _t(x) -> np.ndarray:
    return x.detach().float().numpy()


def _one_device_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


# --------------------------------------------------------------------------- #
# meshes

def test_make_host_mesh_starts_a_one_rank_gloo_group(runs):
    (r0,) = runs.worlds[1]
    assert r0["mesh"] == ((1, 1), ("data", "model"), "gloo", 1)


@pytest.mark.parametrize("world", [2, 4])
def test_make_host_mesh_lays_out_the_group(runs, world):
    for r in runs.worlds[world]:
        assert r["mesh"] == ((1, world), ("data", "model"), "gloo", world)


def test_make_host_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_host_mesh()
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- #
# context-parallel decode

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["valid", "valid_empty"])
def test_cp_decode_equals_the_unsharded_oracle(runs, world, key):
    a = runs.inputs
    want = context_parallel.cp_decode_reference(
        *(torch.from_numpy(a[k]) for k in ("q", "k", "v", key)))
    outs = [r[f"cp/{key}"] for r in runs.worlds[world]]
    for o in outs:
        assert o.shape == (B, H, 1, D) and o.dtype == torch.float32
        assert torch.equal(o, outs[0])           # the same on every rank
    np.testing.assert_allclose(_t(outs[0]), _t(want), rtol=CP_TOL,
                               atol=CP_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_cp_decode_row_with_no_valid_key_is_the_mean_of_v(runs, world):
    v = runs.inputs["v"]
    out = _t(runs.worlds[world][0]["cp/valid_empty"])
    np.testing.assert_allclose(out[1, :, 0], v[1].mean(0), rtol=CP_TOL,
                               atol=CP_TOL)


@pytest.mark.parametrize("key", ["valid", "valid_empty"])
def test_cp_decode_matches_the_reference_at_one_device(runs, key):
    import jax
    import jax.numpy as jnp
    from repro.distributed import context_parallel as r_cp
    a = runs.inputs
    mesh = _one_device_mesh()
    with jax.set_mesh(mesh):
        want = r_cp.cp_decode_attention(
            mesh, "model", *(jnp.asarray(a[k]) for k in ("q", "k", "v", key)))
    np.testing.assert_allclose(_t(runs.worlds[1][0][f"cp/{key}"]),
                               np.asarray(want), rtol=CP_TOL, atol=CP_TOL)


@pytest.mark.parametrize("key", ["valid", "valid_empty"])
def test_cp_decode_matches_the_reference_at_four_devices(runs, key):
    for r in runs.worlds[4]:
        np.testing.assert_allclose(_t(r[f"cp/{key}"]), runs.ref4[f"cp/{key}"],
                                   rtol=CP_TOL, atol=CP_TOL)


@pytest.mark.parametrize("slices", [1, 3, 4, 8])
def test_cp_local_slices_combine_to_the_oracle(slices):
    """The local part over slices and the stacked combine: the same
    arithmetic as the collective one (``chip_smoke.py``'s check on one
    card)."""
    rng = np.random.default_rng(slices)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, H, 1, D), (B, 48, H, D), (B, 48, H, D)))
    valid = torch.from_numpy(rng.uniform(size=(B, 48)) > 0.5)
    valid[:, :48 // slices] = False            # the first slice is empty
    parts = [context_parallel.cp_local(q, k[:, s], v[:, s], valid[:, s])
             for s in np.array_split(np.arange(48), slices)]
    got = context_parallel.combine_stacked(
        *(torch.stack(x) for x in zip(*parts)))
    want = context_parallel.cp_decode_reference(q, k, v, valid)
    np.testing.assert_allclose(_t(got), _t(want), rtol=CP_TOL, atol=CP_TOL)


# --------------------------------------------------------------------------- #
# pipeline

@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_equals_the_stages_in_turn(runs, world):
    a = runs.inputs
    want = torch.from_numpy(a["x"])
    for i in range(world):
        want = _stage(torch.from_numpy(a["w"][i]), want)
    outs = [r["pipe"] for r in runs.worlds[world]]
    for o in outs:
        assert torch.equal(o, outs[0])
    np.testing.assert_allclose(_t(outs[0]), _t(want), rtol=PIPE_TOL,
                               atol=PIPE_TOL)


def test_pipeline_matches_the_reference_at_one_stage(runs):
    import jax
    import jax.numpy as jnp
    from repro.distributed import pipeline as r_pipeline
    a = runs.inputs
    mesh = _one_device_mesh()
    with jax.set_mesh(mesh):
        want = r_pipeline.pipeline_apply(
            mesh, "model", lambda p, xb: jnp.tanh(xb @ p),
            jnp.asarray(a["w"][:1]), jnp.asarray(a["x"]), n_micro=N_MICRO)
    np.testing.assert_allclose(_t(runs.worlds[1][0]["pipe"]),
                               np.asarray(want), rtol=PIPE_TOL, atol=PIPE_TOL)


def test_the_reference_pipeline_raises_at_four_stages(runs):
    """The recorded reference fault: its closing broadcast is a
    ``ppermute`` from the last stage to every stage, which JAX refuses;
    the port broadcasts (``test_pipeline_equals_the_stages_in_turn``)."""
    name, msg = runs.ref4_meta["pipeline_error"]
    assert name == "ValueError"
    assert "ppermute sources and destinations must be unique" in msg


@pytest.mark.parametrize("m,p", [(1, 4), (32, 4), (8, 1), (4, 2), (3, 5)])
def test_bubble_fraction_equals_the_reference(m, p):
    from repro.distributed import pipeline as r_pipeline
    assert pipeline.bubble_fraction(m, p) == r_pipeline.bubble_fraction(m, p)


def test_pipeline_refuses_a_batch_not_in_whole_microbatches():
    with pytest.raises(ValueError, match="not a multiple of 4"):
        pipeline.pipeline_apply(None, "model", _stage, torch.eye(8),
                                torch.zeros(6, 8), 4)


# --------------------------------------------------------------------------- #
# compression

def _rescaled_oracle(a, world):
    """The shared-scale all-reduce computed on stacked ranks, two steps."""
    out, res = {}, [compression.zero_residual(_grads(a, 1, r))
                    for r in range(world)]
    for step in (1, 2):
        gs = [_grads(a, step, r) for r in range(world)]
        for k in "wbzt":
            g = [x[k].float() + rr[k] for x, rr in zip(gs, res)]
            qs = [compression.quantize_int8(x) for x in g]
            smax = torch.stack([s for _, s in qs]).amax()
            resc = [torch.round(compression.dequantize_int8(q, s) / smax)
                    .to(torch.int32) for q, s in qs]
            total = torch.stack(resc).sum(0)
            out[f"m{step}/{k}"] = total.float() * smax / world
            for r in range(world):
                res[r][k] = g[r] - compression.dequantize_int8(
                    torch.clamp(resc[r], -127, 127).to(torch.int8), smax)
                out[f"r{step}/{k}/{r}"] = res[r][k]
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_is_the_shared_scale_mean(runs, world):
    want = _rescaled_oracle(runs.inputs, world)
    for rank, r in enumerate(runs.worlds[world]):
        for step in (1, 2):
            for k in "wbzt":
                assert torch.equal(r["psum"][f"m{step}"][k],
                                   want[f"m{step}/{k}"])
                assert torch.equal(r["psum"][f"r{step}"][k],
                                   want[f"r{step}/{k}/{rank}"])


def test_compressed_psum_one_rank_is_dequantize_of_quantize(runs):
    a = runs.inputs
    g = _grads(a, 1, 0)
    r = runs.worlds[1][0]["psum"]
    for k in "wbzt":
        q, s = compression.quantize_int8(g[k].float())
        assert torch.equal(r["m1"][k], compression.dequantize_int8(q, s))


def test_compressed_psum_matches_the_reference_at_four_devices(runs):
    for rank, r in enumerate(runs.worlds[4]):
        for name in ("m1", "r1", "m2", "r2"):
            for k in "wbzt":
                np.testing.assert_array_equal(
                    r["psum"][name][k].numpy(),
                    runs.ref4[f"psum/{name}/{k}"][rank], err_msg=(name, k))


def _trees(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"w": rng.normal(size=(32, 16)).astype(f32),
            "n": {"b": (rng.normal(size=(7,)) * 1e-3).astype(f32),
                  "z": np.zeros((5,), f32)},
            "t": np.asarray(TIES, f32),
            "l": [rng.normal(size=(3, 3)).astype(f32)]}


def _map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_np(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_compress_tree_match_the_reference(seed):
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as r_comp
    g = _trees(seed)
    res = _map_np(lambda x: (x * 1e-2).astype(np.float32), _trees(seed + 9))
    tg = _map_np(torch.from_numpy, g)
    tr = _map_np(torch.from_numpy, res)
    jg = _map_np(jnp.asarray, g)
    jr = _map_np(jnp.asarray, res)
    q, s = compression.quantize_int8(tg["t"])
    rq, rs = r_comp.quantize_int8(jg["t"])
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, -127]     # half to even
    assert float(s) == float(rs)
    (qt, new_r) = compression.compress_tree(tg, tr)
    (rqt, r_new_r) = r_comp.compress_tree(jg, jr)
    deq = compression.decompress_tree(qt)
    r_deq = r_comp.decompress_tree(rqt)
    flat = checkpoint.flatten
    r_leaves = jax.tree_util.tree_flatten_with_path(
        rqt, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2)[0]
    r_by_path = {jax.tree_util.keystr(p): v for p, v in r_leaves}
    for path, (q, s) in flat(qt, is_leaf=lambda x: isinstance(x, tuple)):
        rq, rs = r_by_path[path]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), path)
        assert float(s) == float(rs), path
    for tree, r_tree in ((new_r, r_new_r), (deq, r_deq)):
        r_by = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(r_tree)[0]}
        for path, x in flat(tree):
            np.testing.assert_array_equal(x.numpy(), np.asarray(r_by[path]),
                                          path)
    zero = compression.zero_residual(tg)
    assert all(torch.equal(x, torch.zeros_like(x, dtype=torch.float32))
               for _, x in flat(zero))
    q0, s0 = compression.quantize_int8(tg["n"]["z"])
    assert not q0.any() and float(s0) == float(np.float32(1e-12) / 127)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_int8_compression_error_feedback_unbiased(seed):
    """The reference's property (``tests/test_distributed_train.py``) on
    the port: with error feedback the accumulated dequantised signal
    tracks the accumulated gradient (the residual stays bounded)."""
    r = np.random.default_rng(seed)
    g_total = np.zeros(64, np.float32)
    q_total = np.zeros(64, np.float32)
    res = torch.zeros(64)
    for _ in range(20):
        g = torch.from_numpy(r.normal(size=64).astype(np.float32))
        (q, scale), res = compression.compress_tree(g, res)
        q_total += compression.dequantize_int8(q, scale).numpy()
        g_total += g.numpy()
    assert float(res.abs().max()) < 0.2
    np.testing.assert_allclose(q_total, g_total, atol=0.2)


# --------------------------------------------------------------------------- #
# restore onto a mesh

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", RESTORE_ARCHS)
def test_restore_blocks_tile_the_saved_leaves(runs, world, arch):
    """Each rank's local tensor is its block of the saved leaf, and the
    blocks of the ranks cover it."""
    saved = np.load(runs.tmp / f"params_{arch}.npz")
    shape = (1, world)
    ranks = runs.worlds[world]
    for name in saved.files:
        full = saved[name]
        covered = np.zeros(full.shape, np.int32)
        for r in ranks:
            cfg = smoke_config(get_arch(arch))
            spec = registry.bundle(cfg).init_specs(1)[name]
            rules = sharding.resolve(cfg, mesh_mod.AbstractMesh(
                shape, ("data", "model")))

            class At:
                def get_coordinate(self, c=r[f"coord/{shape}"]):
                    return c

                def size(self, m):
                    return shape[m]
            idx = sharding.local_block(full.shape, At(),
                                       rules.placements(*spec.logical))
            local = r[f"restore/{arch}/{shape}"][name]
            assert local.dtype == spec.dtype
            np.testing.assert_array_equal(_t(local), full[idx], name)
            covered[idx] += 1
        assert (covered >= 1).all(), name


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", RESTORE_ARCHS)
def test_restore_matches_the_reference_shards(runs, arch, shape):
    """Rank r's block is the reference's addressable shard on device r,
    the device at the same mesh coordinate, bit for bit."""
    n = 0
    for rank, r in enumerate(runs.worlds[4]):
        assert r[f"coord/{shape}"] == tuple(np.unravel_index(rank, shape))
        for name, local in r[f"restore/{arch}/{shape}"].items():
            want = runs.ref4[f"restore/{arch}/{shape}/{rank}/{name}"]
            np.testing.assert_array_equal(_t(local), want, name)
            n += 1
    assert n == 4 * len(registry.bundle(
        smoke_config(get_arch(arch))).init_specs(1))


@pytest.mark.parametrize("world", WORLDS)
def test_constrain_redistributes_a_dtensor(runs, world):
    saved = np.load(runs.tmp / "params_llama3-8b.npz")["embed"]
    shapes = [(1, world)] + ([(2, 2)] if world == 4 else [])
    for r in runs.worlds[world]:
        for shape in shapes:
            np.testing.assert_array_equal(
                _t(r[f"constrain/llama3-8b/{shape}"]), saved)


def test_restore_without_shardings_is_unchanged(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4).to(torch.bfloat16),
            "opt": {"m": torch.ones(2), "count": torch.tensor(7)},
            "l": [torch.full((2,), 0.1)]}
    checkpoint.save(tmp_path, 1, tree)
    got, man = checkpoint.restore(tmp_path, tree)
    flat = checkpoint.flatten
    for (p, x), (q, y) in zip(flat(got), flat(tree)):
        assert p == q and type(x) is torch.Tensor
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)
    assert man["step"] == 1
