"""The dry run (``launch.dryrun``) on the CPU, on fake process groups, and
the models' forward under sharding rules on two gloo ranks.

No JAX here: the file runs wherever torch and the port do, so it also
pins ``torch.testing._internal.distributed.fake_pg`` (a private module)
on each torch the port meets.  The dry-run cases run in one child process
(``_CHILD``), so that no fake default group can reach another test in a
pytest worker: every arch's smoke config (at 2P layers where it is one
period P deep) and its one period (an encoder-decoder's one encoder and
one decoder layer) x {train, prefill, decode} on a fake (2, 2) mesh,
each cell ``ok``; the deeper count less the one-period count is mult x
the repeated unit's count (``count_units``, FLOPs exact); no default
group is left after a cell;
a cell refuses to start beside an existing group and is stored as an
error; the per-device FLOP rule on a 4,096 x 4,096 x 14,336 product on
a fake (16, 16) mesh is the product of the local shards.

The gloo ranks (spawned, as ``tests/test_torch_distributed.py`` spawns
them) hold the smoke llama3-8b's and mamba2-780m's f32 parameters as
DTensors laid out by the rules at tp 2, and their loss under the rules
is the one-rank loss within 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs import ShapeConfig, all_archs, get_arch, smoke_config
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_kernels
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import registry
from repro_torch.models.common import init_params, over_params
from repro_torch.train.train_loop import step_and_specs

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_archs())
KINDS = ("train", "prefill", "decode")
CHILD_TIMEOUT_S = 600
GLOO_ARCHS = ("llama3-8b", "mamba2-780m", "granite-moe-3b-a800m")
# (arch, step, kv heads in place of the smoke config's): one kv head at
# tp 2 keeps the kv heads whole, so the serve rules split the cache's
# sequence (kv_seq) over ``model``
SERVE_CASES = {"llama3-8b-1kv-prefill": ("llama3-8b", "prefill", 1),
               "llama3-8b-1kv-decode": ("llama3-8b", "decode", 1),
               "mamba2-780m-decode": ("mamba2-780m", "decode", None)}
GLOO_TOL = 1e-5
WORLD_TIMEOUT_S = 180
# the reference's cell fields (``repro/launch/dryrun.py``'s ``run_cell``)
OK_FIELDS = {"arch", "shape", "mesh", "status", "chips", "lower_s",
             "compile_s", "flops_per_dev", "bytes_per_dev", "count_units",
             "collectives", "coll_operand_bytes", "coll_operand_by_kind",
             "coll_wire_bytes", "memory", "roofline", "op_histogram"}
MEMORY_FIELDS = {"argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes"}

_CHILD = r'''
import dataclasses, json, math, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import ShapeConfig, all_archs, get_arch, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.transformer import _period

out = {"cells": {}, "left_group": []}
mesh = AbstractMesh((2, 2), ("data", "model"))
shapes = {k: ShapeConfig(f"smoke_{k}", 32, 2, k)
          for k in ("train", "prefill", "decode")}

def depths(cfg):
    """One period (one encoder and one decoder layer), then the smoke
    config itself, or two periods where the smoke config is one."""
    if cfg.is_enc_dec:
        return [dataclasses.replace(cfg, n_encoder_layers=1, num_layers=1),
                cfg]
    p = _period(cfg)
    deep = cfg if cfg.num_layers > p else \
        dataclasses.replace(cfg, num_layers=2 * p)
    return [dataclasses.replace(cfg, num_layers=p), deep]

for arch in sorted(all_archs()):
    base = smoke_config(get_arch(arch))
    for kind, shape in shapes.items():
        for i, cfg in enumerate(depths(base)):
            cell = dryrun.run_guarded(arch, shape.name, False, mesh=mesh,
                                      cfg=cfg, shape=shape)
            out["cells"][f"{arch}|{kind}|{i + 1}"] = cell
            out["left_group"].append(dist.is_initialized())

# the per-device rule against the product of the local shards
with dryrun.fake_group(AbstractMesh((16, 16), ("data", "model"))) as dm:
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(4096 // 16, 4096,
                                           dtype=torch.bfloat16), dm,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(4096, 14336 // 16,
                                           dtype=torch.bfloat16), dm,
                               [Replicate(), Shard(1)], run_check=False)
        counter = dryrun.StepCounter()
        with counter:
            c = a @ b
        local = list(c.to_local().shape)
        out["rule"] = {"counted": counter.flops, "local_shape": local,
                       "placements": [str(p) for p in c.placements]}
out["left_group"].append(dist.is_initialized())

# a default group that exists is refused, and the cell stored as an error
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=0, world_size=1)
try:
    dryrun.run_cell("stablelm-3b", "decode_32k", False)
    out["refused"] = None
except RuntimeError as e:
    out["refused"] = str(e)
out["refused_cell"] = dryrun.run_guarded("stablelm-3b", "decode_32k", False)
dist.destroy_process_group()

# the CLI on one cell of the production mesh, into a results file
dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k",
             "--results", sys.argv[3]])
out["left_group"].append(dist.is_initialized())
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp / "out.json"),
         str(tmp / "store"), str(tmp / "results.json")],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads((tmp / "out.json").read_text())
    out["results"] = json.loads((tmp / "results.json").read_text())
    return out


def test_the_fake_group_module_is_there():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert callable(FakeStore)
    assert "fake" in dist.Backend.backend_list


@pytest.mark.parametrize("arch", ARCHS)
def test_every_step_is_ok_on_a_fake_2x2_mesh(dry, arch):
    for kind in KINDS:
        for depth in (1, 2):
            cell = dry["cells"][f"{arch}|{kind}|{depth}"]
            assert cell["status"] == "ok", (kind, depth,
                                            cell.get("trace", ""))
            assert set(cell) == OK_FIELDS, (kind, set(cell) ^ OK_FIELDS)
            assert set(cell["memory"]) == MEMORY_FIELDS
            assert cell["chips"] == 4 and cell["mesh"] == "mesh2x2"
            assert cell["flops_per_dev"] > 0 and cell["bytes_per_dev"] > 0
            assert cell["memory"]["argument_bytes"] > 0
            rl = cell["roofline"]
            assert rl["t_compute"] == cell["flops_per_dev"] / 989e12


@pytest.mark.parametrize("arch", ARCHS)
def test_the_unit_is_the_step_at_2p_less_the_step_at_p(dry, arch):
    """The deeper step less the one-period step is mult x each unit: at
    2P layers one unit (the reference's ``test_scan_equals_unrolled``
    counterpart), at the smoke depth L, L / P - 1 of them."""
    cfg = smoke_config(get_arch(arch))
    for kind in KINDS:
        one = dry["cells"][f"{arch}|{kind}|1"]
        deep = dry["cells"][f"{arch}|{kind}|2"]
        units = deep["count_units"]
        assert units, kind
        if cfg.is_enc_dec:
            assert {u["name"]: u["mult"] for u in units} == (
                {"enc_layer_train": cfg.n_encoder_layers - 1,
                 "dec_layer_train": cfg.num_layers - 1} if kind == "train"
                else {"enc_layer": cfg.n_encoder_layers - 1,
                      "dec_layer": cfg.num_layers - 1} if kind == "prefill"
                else {"dec_layer": cfg.num_layers - 1})
        else:
            assert [u["name"] for u in units] == [f"superblock_{kind}"]
            assert units[0]["mult"] >= 1
        assert deep["flops_per_dev"] - one["flops_per_dev"] == \
            sum(u["mult"] * u["flops"] for u in units), kind


def test_train_updates_the_params_and_state_in_place(dry):
    cell = dry["cells"]["llama3-8b|train|2"]
    mem = cell["memory"]
    # every parameter, the master, m and v are written in place; the
    # rank's tokens and targets (1 row of 32 int32 each) and the count
    # (a new tensor each step) are not
    assert mem["argument_bytes"] - mem["alias_bytes"] == 2 * 32 * 4 + 4
    assert cell["collectives"]["all-reduce"] > 0
    decode = dry["cells"]["llama3-8b|decode|2"]["memory"]
    assert 0 < decode["alias_bytes"] < decode["argument_bytes"]


def test_no_default_group_remains(dry):
    assert not any(dry["left_group"])


def test_per_device_flops_is_the_product_of_the_local_shards(dry):
    rule = dry["rule"]
    assert rule["local_shape"] == [256, 896]
    assert rule["counted"] == 2 * 256 * 4096 * 896
    assert round(rule["counted"] / 1e9, 3) == 1.879
    assert rule["counted"] == 2 * 4096 * 4096 * 14336 / 256


def test_a_default_group_is_refused(dry):
    assert "already exists" in dry["refused"]
    cell = dry["refused_cell"]
    assert cell["status"] == "error" and "already exists" in cell["error"]
    assert cell["trace"] and "roofline" not in cell


def test_the_cli_writes_the_cell(dry):
    cell = dry["results"]["stablelm-3b|decode_32k|pod16x16"]
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert set(cell) == OK_FIELDS


# --------------------------------------------------------------------------- #
# B7 and B8 as one op each on stand-ins, counted at the kernels' cost

def _attn_inputs(kind, dtype=torch.float32, b=2, s=24, h=4, kvh=2, d=16):
    gen = torch.Generator().manual_seed(3)
    sk = 17 if kind == "cross" else s
    q = torch.randn(b, s, h, d, generator=gen).to(dtype)
    k = torch.randn(b, sk, kvh, d, generator=gen).to(dtype)
    v = torch.randn(b, sk, kvh, d, generator=gen).to(dtype)
    pos = None
    if kind == "positions":     # two rows whose positions repeat
        pos = torch.arange(s, dtype=torch.int32).repeat(b, 1) // 2
    return q, k, v, kind != "cross", pos, pos


def _ssd_inputs(s=40, bsz=2, nh=4, hd=8, ng=2, ds=8):
    gen = torch.Generator().manual_seed(4)
    return (torch.randn(bsz, s, nh, hd, generator=gen),
            0.001 + 0.099 * torch.rand(bsz, s, nh, generator=gen),
            torch.log(1 + 15 * torch.rand(nh, generator=gen)),
            torch.randn(bsz, s, ng, ds, generator=gen),
            torch.randn(bsz, s, ng, ds, generator=gen),
            torch.randn(nh, generator=gen))


@pytest.mark.parametrize("kind", ("causal", "positions", "cross"))
def test_the_attention_op_is_the_plain_version(kind):
    """On real tensors ``repro_torch::flash_attention`` is the plain
    version (o bit for bit, the rows' log-sum-exp of the kept scores) and
    its backward op gives the plain version's gradients bit for bit."""
    q, k, v, causal, qp, kp = _attn_inputs(kind)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.attention_op(*leaves, causal, qp, kp)
    want = fa_ref.attention_plain(q, k, v, causal=causal, q_pos=qp,
                                  k_pos=kp)
    assert torch.equal(o, want)
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(2, 2)) * d ** -0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril() \
            if qp is None else qp[:, None, :, None] >= kp[:, None, None, :]
        scores = torch.where(keep, scores, fa_ref.NEG_INF)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1),
                               rtol=1e-6, atol=1e-6)
    go = torch.randn(o.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(o, leaves, go)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa_ref.attention_plain(*plain, causal=causal, q_pos=qp, k_pos=kp),
        plain, go)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_ssd_op_is_the_plain_version():
    """On real tensors ``repro_torch::ssd_scan`` is ``ssd_plain`` bit for
    bit and its backward op gives the chunk-parallel plain form's
    gradients bit for bit, with the final state's gradient or without."""
    args = _ssd_inputs()
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = ssd_kernels.scan_op(*leaves, 32)
    want = ssd_ref.ssd_plain(*args, chunk=32)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    gen = torch.Generator().manual_seed(6)
    gy, gh = torch.randn(y.shape, generator=gen), torch.randn(h.shape,
                                                              generator=gen)
    for outs, grads in (((y, h), (gy, gh)), ((y,), (gy,))):
        got = torch.autograd.grad(outs, leaves, grads, retain_graph=True)
        plain = [t.clone().requires_grad_() for t in args]
        ref_outs = ssd_ref.ssd_chunked_plain(*plain, chunk=32)
        want = torch.autograd.grad(ref_outs[:len(outs)], plain, grads)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_cost_ops_pass_opcheck():
    """Schema, fake kernels, autograd registration and AOT dispatch."""
    q, k, v, causal, qp, kp = _attn_inputs("positions")
    torch.library.opcheck(fa.attention_op, (
        *(t.requires_grad_() for t in (q, k, v)), causal, qp, kp))
    torch.library.opcheck(ssd_kernels.scan_op, (
        *(t.requires_grad_() for t in _ssd_inputs()), 32))


def _counted(fn, *args):
    """``fn(*args)`` under FakeTensorMode and ``StepCounter``: (its result,
    the counter)."""
    counter = dryrun.StepCounter()
    with counter:
        out = fn(*args)
    return out, counter


def _kernel_ops(counter) -> list:
    """The ops a counter saw, less autograd's ``detach`` of what it saves
    (a view: no bytes, no operations)."""
    return [o for o in counter.ops if o != "aten.detach"]


def test_the_counter_sees_attention_at_the_kernels_cost():
    """On fake tensors ``flash_attention`` is one op, forward and
    backward: its operations are ``attention_flops`` (the causal half; a
    backward 2.5 times the forward) and its bytes the kernels' operands
    and results, so no S x S scores reach the count or the live peak."""
    b, s, h, kvh, d = 2, 4096, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, s, h, d, dtype=torch.bfloat16,
                        requires_grad=True)
        k, v = (torch.empty(b, s, kvh, d, dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))
        o, fwd = _counted(lambda: fa.flash_attention(q, k, v, causal=True))
        go = torch.empty_like(o)
        grads, bwd = _counted(lambda: torch.autograd.grad(o, (q, k, v), go))
    pairs = s * (s + 1) // 2
    assert _kernel_ops(fwd) == ["repro_torch.flash_attention"]
    assert fwd.flops == 4 * b * h * d * pairs == fa.attention_flops(
        q.shape, k.shape, True)
    qkv = 2 * (q.numel() + k.numel() + v.numel())
    o_lse = 2 * q.numel() + 4 * b * h * s
    assert fwd.bytes == qkv + o_lse
    assert fwd.peak == o_lse < b * h * s * s
    assert _kernel_ops(bwd) == ["repro_torch.flash_attention_backward"]
    assert bwd.flops == 10 * b * h * d * pairs
    # go, q, k, v, o and lse read; dq, dk, dv written
    assert bwd.bytes == 2 * q.numel() + qkv + o_lse + qkv
    assert [tuple(g.shape) for g in grads] == [tuple(q.shape),
                                               tuple(k.shape),
                                               tuple(v.shape)]


def test_the_counter_sees_the_ssd_scan_at_the_kernels_cost():
    """On fake tensors ``ssd_scan`` is one op, forward and backward: its
    operations ``ssd_flops`` (a backward twice the forward) and its bytes
    x, dt, a_log, B, C, d_skip read and y and the final state written."""
    bsz, s, nh, hd, ng, ds = 2, 4096, 24, 64, 1, 128
    with FakeTensorMode():
        x = torch.empty(bsz, s, nh, hd, dtype=torch.bfloat16,
                        requires_grad=True)
        dt = torch.empty(bsz, s, nh, requires_grad=True)
        a_log, d_skip = (torch.empty(nh, requires_grad=True)
                         for _ in range(2))
        b, c = (torch.empty(bsz, s, ng, ds, dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))
        args = (x, dt, a_log, b, c, d_skip)
        (y, h), fwd = _counted(lambda: ssd_kernels.ssd_scan(*args))
        gy = torch.empty_like(y)
        _, bwd = _counted(lambda: torch.autograd.grad(y, args, gy))
    per_head = 32 * ((ds + hd) * 128 * 129 + 4 * 128 * hd * ds)
    assert _kernel_ops(fwd) == ["repro_torch.ssd_scan"]
    assert fwd.flops == bsz * nh * per_head == ssd_kernels.ssd_flops(
        x.shape, b.shape, 128)
    ins = 2 * (x.numel() + b.numel() + c.numel()) + 4 * (dt.numel() + 2 * nh)
    outs = 2 * y.numel() + 4 * h.numel()
    assert fwd.bytes == ins + outs
    assert _kernel_ops(bwd) == ["repro_torch.ssd_scan_backward"]
    assert bwd.flops == 2 * fwd.flops


# --------------------------------------------------------------------------- #
# the steps under rules on two gloo ranks

def _blocks(tree, mesh):
    """Each tensor of ``tree`` (a real tensor carrying ``placements``, or
    a (tensor, placements) pair) as a DTensor of this rank's block."""
    def one(t, placements):
        blk = sharding.local_block(t.shape, mesh, placements)
        return DTensor.from_local(t[blk].contiguous(), mesh, placements,
                                  run_check=False)
    return {k: one(*v) for k, v in tree.items()}


def _random_like_sds(sds_tree, gen):
    """Real tensors of a stand-in tree's shapes and types, drawn from
    ``gen`` (the same on every rank), each beside its placements."""
    leaves, spec = tree_flatten(sds_tree)
    real = [((0.5 * torch.randn(t.shape, generator=gen)).to(t.dtype),
             t.placements) for t in leaves]
    return spec, real


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _cache_ratio(a, b) -> float:
    """The largest |a - b| over its tolerance: ``GLOO_TOL``, plus one
    bf16 ulp of b's value (at most 2**-7 |b|) where the cache holds bf16
    (k, v and the conv inputs are computed in f32 within ``GLOO_TOL`` and
    rounded to bf16, where a difference that small may flip the last
    bit)."""
    bf16 = b.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    tol = GLOO_TOL + (2.0 ** -7 * b.abs() if bf16 else 0.0)
    return float(((a - b).abs() / tol).max())


def _train_case(arch, mesh, world):
    """The smoke model's f32 loss (with the MoE aux) and the gradients of
    every parameter, under the rules at tp ``world`` and on one rank."""
    cfg = smoke_config(get_arch(arch))
    mb = registry.bundle(cfg)
    model = mb.build("cpu")
    init_params(model, torch.Generator().manual_seed(0))
    model.float()
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, 1)}
    rules = sharding.resolve(cfg, mesh)
    specs = mb.init_specs(world)
    params = _blocks({n: (p.detach(), rules.placements(*specs[n].logical))
                      for n, p in model.named_parameters()}, mesh)
    for p in params.values():
        p.requires_grad_(True)
    dbatch = _blocks({k: (v, rules.placements("batch", None))
                      for k, v in batch.items()}, mesh)
    loss, metrics = over_params(
        model, params, lambda m, b: mb.loss_fn(m, b, remat=False,
                                               rules=rules), dbatch)
    loss.backward()
    for p in model.parameters():
        p.requires_grad_(True)
    plain, plain_metrics = mb.loss_fn(model, batch, remat=False)
    plain.backward()
    grads = {n: (_max_diff(params[n].grad.full_tensor(), p.grad),
                 float(p.grad.abs().max()))
             for n, p in model.named_parameters()}
    return {"loss": (float(loss.full_tensor()), float(plain)),
            "aux": (float(metrics["aux"].full_tensor()),
                    float(plain_metrics["aux"])),
            "grads": grads}


def _serve_case(arch, kind, mesh, kv_heads=None):
    """One prefill (zero caches) or decode step (random caches, the batch
    at ``seq_len - 1``) through ``step_and_specs``' step, with the smoke
    model's f32 params as DTensors under the serve rules at tp 2, against
    the same step on plain tensors: (max |logits| difference, the caches'
    largest difference over its tolerance (``_cache_ratio``), the layout
    the rules gave the cache)."""
    cfg = smoke_config(get_arch(arch))
    if kv_heads is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads)
    shape = ShapeConfig(f"smoke_{kind}", 32, 2, kind)
    mb = registry.bundle(cfg)
    model = mb.build("cpu")
    init_params(model, torch.Generator().manual_seed(0))
    model.float()
    rules = sharding.resolve(cfg, mesh, shape)
    fn, (params_sds, batch_sds, cache_sds) = step_and_specs(cfg, shape,
                                                            rules)
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(2)
    batch = registry.make_batch(cfg, shape, rules, gen)
    spec, caches = _random_like_sds(cache_sds, gen)
    if kind == "prefill":
        caches = [(torch.zeros_like(t), p) for t, p in caches]
    d_params = _blocks({n: (t, params_sds[n].placements)
                        for n, t in params.items()}, mesh)
    d_batch = _blocks({k: (t, batch_sds[k].placements)
                       for k, t in batch.items()}, mesh)
    d_caches = list(_blocks(dict(enumerate(caches)), mesh).values())
    plain_caches = tree_unflatten([t.clone() for t, _ in caches], spec)
    out = fn(d_params, d_batch, tree_unflatten(d_caches, spec))
    ref = fn(params, batch, plain_caches)
    logits = (out[1], ref[1]) if kind == "decode" else (out[0], ref[0])
    cache_diff = max(_cache_ratio(a.full_tensor(), b) for a, b in
                     zip(tree_flatten(out[-1])[0], tree_flatten(ref[-1])[0]))
    res = {"logits": _max_diff(logits[0].full_tensor(), logits[1]),
           "cache": cache_diff, "kv_seq": rules.kv_seq,
           "kv_heads": rules.kv_heads, "heads": rules.heads}
    if kind == "decode":
        res["tokens_equal"] = bool(torch.equal(out[0].full_tensor(),
                                               ref[0]))
    return res


def _gloo_rank(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}",
                            rank=rank, world_size=world)
    mesh = mesh_mod.init_device_mesh("cpu", (1, world),
                                     mesh_dim_names=("data", "model"))
    out = {arch: _train_case(arch, mesh, world) for arch in GLOO_ARCHS}
    for name, (arch, kind, kv) in SERVE_CASES.items():
        out[name] = _serve_case(arch, kind, mesh, kv)
    torch.save(out, tmp / f"r{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.start_processes(_gloo_rank, args=(2, str(tmp)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"2 gloo ranks took over {WORLD_TIMEOUT_S} s")
    return [torch.load(tmp / f"r{r}.pt") for r in range(2)]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_tp2_loss_on_gloo_is_the_one_rank_loss(gloo, arch):
    for r in gloo:
        sharded, plain = r[arch]["loss"]
        assert abs(sharded - plain) <= GLOO_TOL, (arch, sharded, plain)
        sharded, plain = r[arch]["aux"]
        assert abs(sharded - plain) <= GLOO_TOL, (arch, sharded, plain)
    assert gloo[0][arch]["loss"][0] == gloo[1][arch]["loss"][0]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_tp2_gradients_on_gloo_are_the_one_rank_gradients(gloo, arch):
    """Every parameter's gradient through the rules (``on_shards``'
    partial sums, the MoE's expert blocks and aux means, the vocab-split
    embedding) is the one-rank gradient within 1e-5, and not zero."""
    for r in gloo:
        grads = r[arch]["grads"]
        bad = {n: d for n, (d, _) in grads.items() if not d <= GLOO_TOL}
        assert not bad, (arch, bad)
        assert all(m > 0 for _, m in grads.values()), arch


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_tp2_serve_step_on_gloo_is_the_one_rank_step(gloo, case):
    """A prefill whose q heads split over kv heads that stay whole, and
    decode steps over a cache split along its sequence (flash-decoding's
    three all-reduces) or over SSD states split by head: logits within
    1e-5 of the one-rank step, the caches within 1e-5 and one bf16 ulp
    (``_cache_ratio``), the same tokens."""
    arch, kind, kv = SERVE_CASES[case]
    for r in gloo:
        res = r[case]
        assert res["logits"] <= GLOO_TOL and res["cache"] <= 1, res
        if kind == "decode":
            assert res["tokens_equal"], res
    layout = gloo[0][case]
    if kv is not None:
        assert layout["heads"] == "model" and layout["kv_heads"] is None
        assert layout["kv_seq"] == ("model" if kind == "decode" else
                                    layout["kv_seq"])
