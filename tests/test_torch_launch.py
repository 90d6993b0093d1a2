"""The launchers (``launch.train.train``, ``launch.serve.serve``) on the
host mesh, on the CPU: at one rank, on gloo groups of 2 and 4 ranks, and
under torchrun; and the reference's sharded train step at two host
devices against the port's two ranks.

Each world starts once for the file (``runs``): its ranks are spawned
processes (torch and the port only) that rendezvous through a
``file://`` store in the test's temporary directory; the test starts the
group of 2 or 4 ranks and the launchers join it, while the world of one
leaves the launchers to start (and destroy) their own.  Every rank runs
the launchers on the smoke configs with their weights made f32 (the
drawn bf16 weights cast, as ``tests/test_torch_dryrun.py``'s
``_train_case`` does): ``train`` (3 AdamW steps of 2 x 64 tokens) of
llama3-8b, mamba2-780m and granite-moe-3b-a800m at 2 ranks and
llama3-8b at 4 (the three's specs divide at tp 4: see
``test_the_three_divide_at_tp4``); ``serve`` of llama3-8b with one kv
head (so that the serve rules split its cache along the sequence),
mamba2-780m (SSD states split by head) and whisper-large-v3 at 2 ranks;
a llama3-8b checkpoint saved every step by 2 ranks and resumed from its
first step at 1 and at 4 ranks.  The reference runs in one subprocess at
2 host devices (``JAX_PLATFORMS=cpu``, ``PYTHONPATH=src``,
``XLA_FLAGS=--xla_force_host_platform_device_count=2``) on an Auto-axis
``(1, 2)`` mesh; JAX is imported inside the test functions only.

Tolerances: the launchers at 2 and 4 ranks against one rank within
``TOL`` = 1e-5 (losses, every parameter after the steps, the resumed
losses and parameters), tokens equal; the reference's sharded step
against the port's two ranks within the bounds of
``tests/test_torch_train_models.py``'s whole-step parity: loss, ce, aux,
grad norm and the moments m (and v at twice it) within ``F32_REL`` =
1e-4 (``SSD_REL`` = 2e-2 for mamba2-780m, whose reference SSD keeps its
intra-chunk tensors in bf16) of their largest magnitude, the f32 master
within 4 f32 ulps plus 2 x lr x rel / clear where the reference's m
clears ``CLEAR`` (``SSD_CLEAR``) of its largest.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ShapeConfig, get_arch, smoke_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import registry
from repro_torch.models.common import distribute
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_loop import (
    greedy, make_decode_step, make_prefill_step, make_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARCHS = ("llama3-8b", "mamba2-780m", "granite-moe-3b-a800m")
TRAIN_RUNS = [(a, 2) for a in TRAIN_ARCHS] + [("llama3-8b", 4)]
SERVE_ARCHS = ("llama3-8b", "mamba2-780m", "whisper-large-v3")
PARITY_ARCHS = ("llama3-8b", "mamba2-780m")
CKPT_ARCH = "llama3-8b"
STEPS, SEQ, BATCH = 3, 64, 2
TOL = 1e-5
F32_REL, SSD_REL = 1e-4, 2e-2
CLEAR, SSD_CLEAR = 1e-2, 0.5
ULP = 2.0 ** -23
WORLD_TIMEOUT_S = 240
KW = dict(steps=STEPS, seq_len=SEQ, global_batch=BATCH, device="cpu",
          log_every=100)


# --------------------------------------------------------------------------- #
# one rank of a world (a spawned process: torch and the port only)

def _f32_weights() -> None:
    """The launchers' models with their drawn weights cast to f32 (in a
    spawned rank: nothing to restore)."""
    build = serve_mod.build_model

    def build_f32(*a, **kw):
        mb, model = build(*a, **kw)
        return mb, model.float()
    train_mod.build_model = serve_mod.build_model = build_f32


def _one_kv_head() -> None:
    """serve's llama3-8b with one kv head: at tp 2 its kv heads stay
    whole, so the serve rules split the cache's sequence (``kv_seq``)."""
    get = serve_mod.get_arch

    def get_arch_(name):
        cfg = get(name)
        return dataclasses.replace(cfg, n_kv_heads=1) \
            if name == "llama3-8b" else cfg
    serve_mod.get_arch = get_arch_


def _placements(x):
    return tuple(str(p) for p in x.placements) if isinstance(x, DTensor) \
        else None


def _record_updates(log: list) -> None:
    """AdamW.update recording, per call, each parameter's layout beside
    its gradient's and its state's, the count's, and the global norm's
    layout and local value."""
    update = optimizer.AdamW.update

    def recording(self, grads, state, params):
        out = update(self, grads, state, params)
        log.append({
            "params": {n: (_placements(p), _placements(grads[n]),
                           _placements(state["m"][n]),
                           _placements(state["v"][n]),
                           _placements(state["master"][n]))
                       for n, p in params.items()},
            "count": _placements(state["count"]),
            "gnorm": (_placements(out[2]), float(out[2].to_local())
                      if isinstance(out[2], DTensor) else float(out[2]))})
        return out
    optimizer.AdamW.update = recording


def _whole_params(model) -> dict:
    return {n: sharding.whole(p).detach().clone()
            for n, p in model.named_parameters()}


def _wait_for(path: Path, timeout: float = WORLD_TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _resume(tmp: Path, world: int) -> dict:
    """The 2-rank run's checkpoint of its first step (alone in a fresh
    directory) resumed for the rest of the 3 steps: the continued losses
    and the final parameters."""
    saved = tmp / f"ckpt_2_{CKPT_ARCH}" / "step_00000001"
    _wait_for(saved)
    mine = tmp / f"resume_{world}"
    if not dist.is_initialized() or dist.get_rank() == 0:
        shutil.copytree(saved, mine / saved.name)
    if dist.is_initialized():
        dist.barrier()
    model, losses = train_mod.train(CKPT_ARCH, ckpt_dir=str(mine),
                                    ckpt_every=100, **KW)
    return {"losses": losses, "params": _whole_params(model)}


def _parity(arch: str, tmp: Path) -> dict:
    """One AdamW step of the smoke ``arch`` under the rules at tp 2 from
    the reference's weights (``materialize(init_specs(2), key(0))`` in
    f32, carried across by ``convert.lm_params_from_arrays``): the
    metrics and the whole AdamW state."""
    cfg = smoke_config(get_arch(arch))
    mesh = mesh_mod.make_host_mesh("cpu")
    rules = sharding.resolve(cfg, mesh, ShapeConfig("train", SEQ, BATCH,
                                                    "train"))
    mb = registry.bundle(cfg)
    model = mb.build("cpu").float()
    model.load_state_dict(torch.load(tmp / f"parity_{arch}.pt"))
    distribute(model, mb.init_specs(2), rules)
    opt = AdamW()
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(mb, model, opt, rules)
    batch = {k: sharding.from_whole(v, *rules.named("batch", None))
             for k, v in synthetic_batch(DataConfig(
                 cfg.vocab_size, SEQ, BATCH, seed=0), 0).items()}
    state, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: {n: sharding.whole(t) for n, t in state[k].items()}
                      for k in ("master", "m", "v")},
            "count": int(sharding.whole(state["count"]))}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    tmp = Path(tmp)
    if world > 1:          # a world of one: the launchers start their own
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp / f'store_{world}'}",
            rank=rank, world_size=world)
    updates = []
    _f32_weights()
    _one_kv_head()
    _record_updates(updates)
    out = {"train": {}, "serve": {}}
    archs = TRAIN_ARCHS if world < 4 else (CKPT_ARCH,)
    for arch in archs:
        ckpt = str(tmp / f"ckpt_{world}_{arch}") if arch == CKPT_ARCH \
            and world < 4 else None
        updates.clear()
        model, losses = train_mod.train(arch, ckpt_dir=ckpt, ckpt_every=1,
                                        **KW)
        out["train"][arch] = {"losses": losses,
                              "params": _whole_params(model),
                              "updates": list(updates)}
    if world < 4:
        for arch in SERVE_ARCHS:
            out["serve"][arch] = serve_mod.serve(arch, device="cpu")
    if world == 2:
        out["parity"] = {a: _parity(a, tmp) for a in PARITY_ARCHS}
    if world != 2:
        out["resume"] = _resume(tmp, world)
    out["group_after"] = dist.is_initialized()
    torch.save(out, tmp / f"w{world}_r{rank}.pt")
    if world > 1:
        dist.destroy_process_group()


def _spawn(world: int, tmp: Path):
    return mp.start_processes(_rank_main, args=(world, str(tmp)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctxs: dict, deadline: float) -> None:
    for world, ctx in ctxs.items():
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for c in ctxs.values():
                    for p in c.processes:
                        p.kill()
                raise TimeoutError(f"world {world} took over "
                                   f"{WORLD_TIMEOUT_S} s")


# --------------------------------------------------------------------------- #
# the reference's sharded train step at 2 host devices, in a subprocess

_REFERENCE_SCRIPT = r'''
import sys
import jax, jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh
from repro.configs import ShapeConfig, get_arch, smoke_config
from repro.distributed.sharding import resolve, tree_shardings
from repro.models import registry
from repro.models.common import materialize
from repro.train import data
from repro.train.optimizer import AdamW
from repro.train.train_loop import make_train_step
from repro_torch.convert import lm_params_from_arrays

tmp, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
devs = np.array(jax.devices())
assert devs.size == 2, devs
mesh = Mesh(devs.reshape(1, 2), ("data", "model"))     # Auto axes
out = {}
for arch in sys.argv[4].split(","):
    cfg = smoke_config(get_arch(arch))
    shape = ShapeConfig("train", seq, batch, "train")
    rules = resolve(cfg, mesh, shape)
    mb = registry.bundle(cfg)
    specs = mb.init_specs(2)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          materialize(specs, jax.random.key(0)))
    b = data.synthetic_batch(data.DataConfig(cfg.vocab_size, seq, batch,
                                             seed=0), 0)
    with jax.set_mesh(mesh):
        params = jax.device_put(params, tree_shardings(specs, rules))
        sds = registry.batch_specs(cfg, shape, rules)
        b = {k: jax.device_put(v, sds[k].sharding) for k, v in b.items()}
        opt = AdamW()
        new_p, new_s, metrics = jax.jit(make_train_step(mb, rules, opt))(
            params, opt.init(params), b)
    split = sum(not x.sharding.is_fully_replicated
                for x in jax.tree.leaves(new_p))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    out[arch] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "state": {k: lm_params_from_arrays(cfg, to_np(new_s[k]))
                           for k in ("master", "m", "v")},
                 "count": int(new_s["count"]),
                 "split_leaves": split}
torch.save(out, tmp + "/ref2.pt")
'''


def _reference_2(tmp: Path) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("REPRO_HOST_DEVICES", None)
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(tmp), str(SEQ),
         str(BATCH), ",".join(PARITY_ARCHS)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _parity_weights(tmp: Path) -> None:
    """The reference's ``materialize(init_specs(2), key(0))`` in f32 as
    the port's state_dicts, for the ranks."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as r_get_arch
    from repro.configs import smoke_config as r_smoke
    from repro.models import registry as r_registry
    from repro.models.common import materialize

    from repro_torch.convert import lm_params_from_arrays
    for arch in PARITY_ARCHS:
        cfg = r_smoke(r_get_arch(arch))
        params = materialize(r_registry.bundle(cfg).init_specs(2),
                             jax.random.key(0))
        tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                            params)
        torch.save(lm_params_from_arrays(cfg, tree), tmp / f"parity_{arch}.pt")


@dataclasses.dataclass
class Runs:
    tmp: Path
    worlds: dict          # world size -> [rank results]
    ref2: dict            # the reference's sharded step at 2 devices


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> Runs:
    tmp = tmp_path_factory.mktemp("launch")
    _parity_weights(tmp)
    ref = _reference_2(tmp)
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        _join({w: _spawn(w, tmp) for w in (1, 2, 4)}, deadline)
        _, err = ref.communicate(timeout=max(deadline - time.monotonic(), 1))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    worlds = {w: [torch.load(tmp / f"w{w}_r{r}.pt", weights_only=False)
                  for r in range(w)] for w in (1, 2, 4)}
    return Runs(tmp, worlds, torch.load(tmp / "ref2.pt", weights_only=False))


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------- #
# train at 2 and 4 ranks against one rank

@pytest.mark.parametrize("arch,world", TRAIN_RUNS)
def test_train_on_n_ranks_is_the_one_rank_run(runs, arch, world):
    """Losses and every parameter after 3 steps within 1e-5 of the one-rank
    launcher's; every rank returns the same plain-float losses."""
    (one,) = runs.worlds[1]
    want = one["train"][arch]
    ranks = runs.worlds[world]
    for r in ranks:
        got = r["train"][arch]
        assert all(isinstance(x, float) for x in got["losses"])
        assert got["losses"] == ranks[0]["train"][arch]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=TOL)
        assert got["params"].keys() == want["params"].keys()
        bad = {n: d for n, p in got["params"].items()
               if not (d := _max_diff(p, want["params"][n])) <= TOL}
        assert not bad, bad
    assert want["losses"][0] != want["losses"][-1]


@pytest.mark.parametrize("arch,world", TRAIN_RUNS)
def test_train_state_keeps_the_parameters_layouts(runs, arch, world):
    """At every step each gradient, moment and master is laid out as its
    parameter (a DTensor at more than one rank, every placement of the
    rules), the count is replicated, and the global norm is one
    replicated scalar equal on every rank; at one rank all stay plain."""
    for r in runs.worlds[world]:
        updates = r["train"][arch]["updates"]
        assert len(updates) == STEPS
        for u in updates:
            for n, (p, *rest) in u["params"].items():
                assert p is not None and all(x == p for x in rest), (n, p,
                                                                     rest)
            assert u["count"] == ("R", "R")           # Replicate()
            assert u["gnorm"][0] == ("R", "R")
        embed = updates[0]["params"]["embed"][0]
        assert embed[1] == "S(0)", embed         # the vocab over model
    norms = [[u["gnorm"][1] for u in r["train"][arch]["updates"]]
             for r in runs.worlds[world]]
    assert all(n == norms[0] for n in norms)
    (one,) = runs.worlds[1]
    for u in one["train"][arch]["updates"]:
        assert all(all(x is None for x in v) for v in u["params"].values())
        assert u["count"] is None and u["gnorm"][0] is None


def test_the_three_divide_at_tp4():
    """The three trained archs' tp-4 specs divide the (1, 4) host mesh, so
    each could run at 4 ranks; llama3-8b does (``TRAIN_RUNS``)."""
    mesh = mesh_mod.AbstractMesh((1, 4), ("data", "model"))
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(get_arch(arch))
        rules = sharding.resolve(cfg, mesh, ShapeConfig("train", SEQ, BATCH,
                                                        "train"))
        assert sharding.validate_divisibility(
            registry.bundle(cfg).init_specs(4), rules) == [], arch


# --------------------------------------------------------------------------- #
# serve at 2 ranks against one rank

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_on_two_ranks_is_the_one_rank_run(runs, arch):
    (one,) = runs.worlds[1]
    want = one["serve"][arch]
    assert want.shape == (4, 12) and not isinstance(want, DTensor)
    for r in runs.worlds[2]:
        got = r["serve"][arch]
        assert not isinstance(got, DTensor)
        assert torch.equal(got, want), (arch, got, want)


def test_serve_rules_split_what_the_tests_mean_to_split():
    """The serve rules at tp 2 for the served shape: llama3-8b with one kv
    head splits its cache's sequence, mamba2-780m its states by head,
    whisper its kv heads."""
    mesh = mesh_mod.AbstractMesh((1, 2), ("data", "model"))
    shape = ShapeConfig("serve", 24 + 12, 4, "prefill")
    llama = dataclasses.replace(smoke_config(get_arch("llama3-8b")),
                                n_kv_heads=1)
    rules = sharding.resolve(llama, mesh, shape)
    assert (rules.kv_seq, rules.kv_heads, rules.heads) == ("model", None,
                                                           "model")
    rules = sharding.resolve(smoke_config(get_arch("mamba2-780m")), mesh,
                             shape)
    assert rules.ssm_heads == "model"
    rules = sharding.resolve(smoke_config(get_arch("whisper-large-v3")),
                             mesh, shape)
    assert (rules.kv_heads, rules.kv_seq) == ("model", None)


# --------------------------------------------------------------------------- #
# checkpoints: saved by 2 ranks, resumed at 1 and 4 (elastic restore)

@pytest.mark.parametrize("world", [1, 4])
def test_checkpoint_of_two_ranks_resumes_elsewhere(runs, world):
    """The 2-rank run's step-1 checkpoint, resumed for steps 1 and 2 at
    ``world`` ranks: the continued losses and the final parameters within
    1e-5 of an uninterrupted one-rank run's."""
    (one,) = runs.worlds[1]
    want = one["train"][CKPT_ARCH]
    for r in runs.worlds[world]:
        got = r["resume"]
        np.testing.assert_allclose(got["losses"], want["losses"][1:],
                                   rtol=0, atol=TOL)
        bad = {n: d for n, p in got["params"].items()
               if not (d := _max_diff(p, want["params"][n])) <= TOL}
        assert not bad, bad


def test_checkpoint_of_two_ranks_is_the_one_rank_layout(runs):
    """The checkpoints the 2-rank run wrote (rank 0 alone, gathered whole)
    hold the one-rank run's leaves: the same paths, shapes and logical
    types, values within 1e-5; the last 3 steps kept."""
    one = runs.tmp / f"ckpt_1_{CKPT_ARCH}"
    two = runs.tmp / f"ckpt_2_{CKPT_ARCH}"
    assert checkpoint.latest_step(two) == STEPS
    assert sorted(d.name for d in two.iterdir()) == [
        f"step_{s:08d}" for s in range(1, STEPS + 1)]
    for step in range(1, STEPS + 1):
        m1, m2 = checkpoint.manifest_of(one, step), \
            checkpoint.manifest_of(two, step)
        strip = [[{k: v for k, v in leaf.items() if k != "key"}
                  for leaf in m["leaves"]] for m in (m1, m2)]
        assert strip[0] == strip[1]
        assert m1["extra"] == m2["extra"]
        with np.load(one / f"step_{step:08d}" / "shards.npz") as a, \
                np.load(two / f"step_{step:08d}" / "shards.npz") as b:
            for leaf in m1["leaves"]:
                np.testing.assert_allclose(a[leaf["key"]], b[leaf["key"]],
                                           rtol=0, atol=TOL)


# --------------------------------------------------------------------------- #
# process groups

def test_launchers_destroy_their_own_group_and_keep_the_callers(runs):
    (one,) = runs.worlds[1]
    assert one["group_after"] is False
    for world in (2, 4):
        assert all(r["group_after"] is True for r in runs.worlds[world])


def test_no_default_group_remains_after_train_on_the_cpu():
    assert not dist.is_initialized()
    _, losses = train_mod.train("mamba2-780m", steps=1, seq_len=16,
                                global_batch=1, device="cpu")
    assert len(losses) == 1 and not dist.is_initialized()
    gen = serve_mod.serve("mamba2-780m", gen_len=2, device="cpu")
    assert gen.shape == (4, 2) and not dist.is_initialized()


def test_one_rank_launcher_is_the_plain_step():
    """At one rank the launcher's parameters stay plain tensors and its
    steps (rules resolved and passed) equal ``make_train_step`` without
    rules bit for bit, as PR 27's launcher ran them."""
    kw = dict(steps=2, seq_len=32, global_batch=2, device="cpu",
              overfit_batch=True)
    model, losses = train_mod.train("llama3-8b", **kw)
    assert not any(isinstance(p, DTensor) for p in model.parameters())
    cfg = smoke_config(get_arch("llama3-8b"))
    mb, plain = serve_mod.build_model(cfg, torch.device("cpu"), seed=0)
    opt = AdamW()
    state = opt.init(dict(plain.named_parameters()))
    step = make_train_step(mb, plain, opt)
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 32, 2, seed=0), 0)
    want = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
    assert losses == want
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), n
    toks = serve_mod.serve("llama3-8b", device="cpu")
    _, fresh = serve_mod.build_model(cfg, torch.device("cpu"), seed=0)
    prompts = serve_mod.draw_prompts(cfg, 4, 24, 0, torch.device("cpu"))
    assert torch.equal(toks, serve_mod.generate(mb, fresh, prompts, 12))


class _Ops(TorchDispatchMode):
    """The aten ops dispatched while entered, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_one_rank_rules_dispatch_the_same_ops():
    """At one rank the launchers' steps under the host mesh's rules
    dispatch the ops of the steps without rules, one for one: a train
    step, a prefill and a decode step (what the card runs is the same
    work; only Python checks differ)."""
    cfg = smoke_config(get_arch("llama3-8b"))
    cpu = torch.device("cpu")
    mb, model = serve_mod.build_model(cfg, cpu, seed=0)
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 32, 2, seed=0), 0)
    prompts = serve_mod.draw_prompts(cfg, 2, 24, 0, cpu)
    with mesh_mod.process_group(cpu):
        mesh = mesh_mod.make_host_mesh(cpu)
        train_rules = sharding.resolve(cfg, mesh, ShapeConfig(
            "train", 32, 2, "train"))
        serve_rules = sharding.resolve(cfg, mesh, ShapeConfig(
            "serve", 28, 2, "prefill"))
        ops = []
        for t_rules, s_rules in ((None, None), (train_rules, serve_rules)):
            opt = AdamW()
            state = opt.init(dict(model.named_parameters()))
            step = make_train_step(mb, model, opt, t_rules)
            prefill = make_prefill_step(mb, model, s_rules)
            decode = make_decode_step(mb, model, s_rules)
            caches = registry.make_cache(cfg, 2, 28, cpu)
            with _Ops() as t_ops:
                step(state, batch)
            with torch.inference_mode(), _Ops() as s_ops:
                logits, caches = prefill(prompts, caches)
                decode(greedy(cfg, logits, s_rules), 24, caches)
            ops.append((t_ops.ops, s_ops.ops))
    assert not dist.is_initialized()
    assert len(ops[0][0]) > 100 and ops[0][0] == ops[1][0]
    assert len(ops[0][1]) > 100 and ops[0][1] == ops[1][1]


def test_torchrun_runs_the_train_cli_on_two_ranks():
    """``python -m torch.distributed.run --standalone --nproc_per_node 2
    -m repro_torch.launch.train --arch mamba2-780m --device cpu --steps
    2`` exits 0; only rank 0 prints: one mesh line (a 2-rank gloo group
    started from the environment), two step lines, one losses line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "mamba2-780m", "--device", "cpu", "--steps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    mesh = [x for x in lines if x.startswith("[train] mesh")]
    assert len(mesh) == 1 and "(1, 2)" in mesh[0] and "2-rank gloo" in \
        mesh[0] and "env://" in mesh[0], mesh
    assert len([x for x in lines if x.startswith("[train] step=")]) == 2
    (loss_line,) = [x for x in lines if x.startswith("[train] losses")]
    assert len(json.loads(loss_line.split(" ", 2)[2])) == 2


# --------------------------------------------------------------------------- #
# the reference's sharded step at 2 host devices against the port's 2 ranks

def _close(got, want, rel, what):
    got, want = got.float().numpy(), want.float().numpy()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_reference_sharded_step_at_two_devices_is_the_ports(runs, arch):
    ref = runs.ref2[arch]
    assert ref["split_leaves"] > 0
    rel, clear = (SSD_REL, SSD_CLEAR) if arch == "mamba2-780m" \
        else (F32_REL, CLEAR)
    lr = float(AdamW()._schedule(torch.tensor(1)))
    for r in runs.worlds[2]:
        got = r["parity"][arch]
        for k in ("loss", "ce", "aux", "grad_norm"):
            want = ref["metrics"][k]
            assert abs(got["metrics"][k] - want) <= rel * max(abs(want),
                                                              1e-6), k
        assert got["count"] == ref["count"] == 1
        for name, master in got["state"]["master"].items():
            _close(got["state"]["m"][name], ref["state"]["m"][name], rel,
                   f"m {name}")
            _close(got["state"]["v"][name], ref["state"]["v"][name], 2 * rel,
                   f"v {name}")
            m_ref = ref["state"]["m"][name].numpy()
            sure = np.abs(m_ref) > clear * np.abs(m_ref).max()
            g, w = master.numpy(), ref["state"]["master"][name].numpy()
            tol = 4 * ULP * np.abs(w) + 2 * lr * rel / clear
            bad = (np.abs(g - w) > tol) & sure
            assert not bad.any(), (name, np.abs(g - w)[bad].max())
