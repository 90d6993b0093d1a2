"""The port's training pieces against the reference's, on the CPU: the
loss, the data pipeline, the optimizers, checkpoints and fault
tolerance, and the launcher; and, inside the port, the autograd
Functions around the flash-attention (B7) and SSD (B8) kernels and the
checkpointed layers.

Tolerances: ``cross_entropy`` within 1e-6 of the reference's (f32 sums
in another order); the synthetic batches bit-identical; ``global_norm``
within ``NORM_REL`` (a sum of some 10**5 squares in another order);
every AdamW / PaperSGD state tensor and f32 master within ``ULPS`` f32
ulps of its leaf's largest magnitude (the same f32 ops in the same
order, ``pow`` aside), plus, where the gradients are clipped, twice the
two global norms' relative difference (the clip factor carries it into
every gradient, and v squares it); the bf16 parameters equal to the
master rounded; checkpoints restored bit for
bit, across the two systems too.  The Functions' gradients equal plain
autograd's within 1e-6 (f32) or 1e-2 (bf16) of their largest magnitude:
the backward runs the plain version again, over slices (B8's in its
chunk-parallel form, whose a_log gradient is within ``SSD_ORDER_REL``
of the chunk-by-chunk form's in f32).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch, smoke_config as r_smoke
from repro.models import common as r_common
from repro.models import registry as r_registry
from repro.train import checkpoint as r_ckpt
from repro.train import data as r_data
from repro.train import fault_tolerance as r_ft
from repro.train import optimizer as r_opt

from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import adamw_state_from_arrays, lm_params_from_arrays
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import build_model
from repro_torch.models import common
from repro_torch.train import checkpoint, fault_tolerance, optimizer
from repro_torch.train.data import DataConfig, Pipeline, synthetic_batch
from repro_torch.train.train_loop import make_train_step

ULP = 2.0 ** -23
ULPS = 4
NORM_REL = 1e-5
SSD_ORDER_REL = 2e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ulps(got, want, what="", n=ULPS, rel=0.0):
    """Within ``n`` f32 ulps (plus ``rel``) of ``want``'s largest
    magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    bound = (n * ULP + rel) * np.abs(want).max(initial=0.0)
    assert err <= bound, f"{what}: max abs err {err} > {n} ulps + {rel} " \
        f"({bound})"


# --------------------------------------------------------------------------- #
# the loss


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference_with_padded_vocab(z_loss):
    r = np.random.default_rng(0)
    logits = (3 * r.normal(size=(2, 7, 80))).astype(np.float32)
    logits[..., 70:] = 50.0               # padded columns that would win
    targets = r.integers(0, 70, size=(2, 7)).astype(np.int32)
    want = float(r_common.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets), 70, z_loss))
    got = float(common.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(targets), 70, z_loss))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


# --------------------------------------------------------------------------- #
# data


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 17)])
def test_synthetic_batch_is_bit_identical_to_reference(seed, step):
    cfg = DataConfig(vocab_size=97, seq_len=33, global_batch=3, seed=seed)
    got = synthetic_batch(cfg, step)
    want = r_data.synthetic_batch(r_data.DataConfig(97, 33, 3, seed), step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                  got["targets"][:, :-1].numpy())


def test_pipeline_resumes_the_reference_stream():
    cfg = DataConfig(vocab_size=50, seq_len=9, global_batch=2, seed=4)
    r_cfg = r_data.DataConfig(50, 9, 2, 4)
    extras = lambda dc, step: {"frames": torch.full((1,), float(step))}  # noqa
    pipe = Pipeline(cfg, "cpu", extras_fn=extras)
    r_pipe = r_data.Pipeline(r_cfg)
    for _ in range(3):
        got, want = pipe.next(), r_pipe.next()
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    assert pipe.state() == r_pipe.state() == {"step": 3, "seed": 4}
    resumed = Pipeline.resume(cfg, pipe.state(), extras_fn=extras)
    r_resumed = r_data.Pipeline.resume(r_cfg, r_pipe.state())
    got, want, again = resumed.next(), r_resumed.next(), pipe.next()
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    assert torch.equal(got["tokens"], again["tokens"])
    assert float(got["frames"]) == 3.0
    with pytest.raises(ValueError):
        Pipeline.resume(dataclasses.replace(cfg, seed=5), pipe.state())


# --------------------------------------------------------------------------- #
# optimizers


def _reference_params(arch):
    """The reference's smoke params (numpy; its zero leaves drawn at scale
    0.1) and the port's names for them."""
    cfg = r_smoke(r_get_arch(arch))
    r = np.random.default_rng(2)

    def f(a):
        a = np.asarray(a)
        return (0.1 * r.normal(size=a.shape)).astype(a.dtype) \
            if not a.any() else a
    params = jax.tree.map(f, jax.tree.map(
        np.asarray, r_registry.bundle(cfg).materialize_params(
            jax.random.key(1), tp=1)))
    return cfg, params


def _grads(params, seed, scale):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * r.normal(size=a.shape)).astype(
        np.asarray(a).dtype), params)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
def test_decayed_set_is_the_references(arch):
    cfg, params = _reference_params(arch)
    marks = jax.tree.map(lambda a: np.full(np.shape(a), float(np.ndim(a) >= 2),
                                           np.float32), params)
    want = lm_params_from_arrays(cfg, marks)
    _, model = build_model(smoke_config(get_arch(arch)), torch.device("cpu"),
                           seed=0)
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        assert optimizer.decays(name, p) == bool(want[name].any()), name
    # every layer's 1-D leaves decay with the matrices; the global norms
    # (final_norm, enc_norm) do not
    layer_1d = [n for n, p in names.items() if p.dim() == 1
                and n.split(".", 1)[0] in optimizer.STACKED]
    assert layer_1d and all(optimizer.decays(n, names[n]) for n in layer_1d)
    assert not optimizer.decays("final_norm", names["final_norm"])


def _adamw_run(arch, opt_kw, steps, grad_scale):
    """``steps`` AdamW updates on both sides from the same params, state
    and f32-drawn grads (in each param's type); returns the reference's
    final (params, state, norms) as port trees and the port's."""
    cfg, params = _reference_params(arch)
    r_o = r_opt.AdamW(**opt_kw)
    o = optimizer.AdamW(**opt_kw)
    jp = jax.tree.map(jnp.asarray, params)
    r_state = r_o.init(jp)
    t_params = {n: t.clone() for n, t in lm_params_from_arrays(cfg, params).items()}
    state = adamw_state_from_arrays(cfg, jax.tree.map(np.asarray, r_state))
    r_norms, norms = [], []
    for i in range(steps):
        g = _grads(params, 10 + i, grad_scale)
        jp, r_state, r_gn = r_o.update(jax.tree.map(jnp.asarray, g),
                                       r_state, jp)
        _, state, gn = o.update(lm_params_from_arrays(cfg, g), state, t_params)
        r_norms.append(float(r_gn))
        norms.append(float(gn))
    r_state = jax.tree.map(np.asarray, r_state)
    want = adamw_state_from_arrays(cfg, r_state)
    return (cfg, lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp)), want,
            r_norms), (t_params, state, norms)


def _check_adamw(reference, port, clipped):
    (cfg, r_params, r_state, r_norms), (params, state, norms) = \
        reference, port
    np.testing.assert_allclose(norms, r_norms, rtol=NORM_REL)
    clip = 2 * max(abs(a / b - 1) for a, b in zip(norms, r_norms)) \
        if clipped else 0.0
    assert int(state["count"]) == int(r_state["count"])
    for name, p in params.items():
        for k in ("master", "m", "v"):
            _ulps(state[k][name], r_state[k][name], f"{k} {name}",
                  rel=clip)
        assert p.dtype == r_params[name].dtype, name
        assert torch.equal(p, state["master"][name].to(p.dtype)), name
        _ulps(p, r_params[name], f"param {name}", n=2 ** 16)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
@pytest.mark.parametrize("opt_kw,grad_scale", [
    (dict(warmup=2), 1.0),                       # clipped: norm >> 1
    (dict(warmup=1, clip_norm=None, lr=1e-2), 1e-3),
])
def test_adamw_updates_match_reference(arch, opt_kw, grad_scale):
    _check_adamw(*_adamw_run(arch, opt_kw, 3, grad_scale),
                 clipped=opt_kw.get("clip_norm", 1.0) is not None)


def test_adamw_decay_by_the_ports_own_rank_fails_the_reference(monkeypatch):
    """The mutation the decayed set guards against: decaying by the port's
    own unstacked rank leaves every layer's norms, a_log, dt_bias and
    d_skip undecayed, which the comparison must catch."""
    monkeypatch.setattr(optimizer, "decays", lambda name, p: p.dim() >= 2)
    with pytest.raises(AssertionError):
        _check_adamw(*_adamw_run("jamba-v0.1-52b", dict(lr=1e-2, warmup=1),
                                 2, 1.0), clipped=True)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_paper_sgd_matches_reference(clip_norm):
    cfg, params = _reference_params("mamba2-780m")
    r_o = r_opt.PaperSGD(lr=0.05, l2=0.01, clip_norm=clip_norm)
    o = optimizer.PaperSGD(lr=0.05, l2=0.01, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, params)
    r_state = r_o.init(jp)
    t_params = {n: t.clone() for n, t in lm_params_from_arrays(cfg, params).items()}
    state = o.init(t_params)
    for i in range(2):
        g = _grads(params, 20 + i, 0.1)
        jp, r_state, r_gn = r_o.update(jax.tree.map(jnp.asarray, g),
                                       r_state, jp)
        _, state, gn = o.update(lm_params_from_arrays(cfg, g), state, t_params)
        assert abs(float(gn) - float(r_gn)) <= NORM_REL * float(r_gn)
    assert int(state["count"]) == int(r_state["count"]) == 2
    want = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp))
    for name, p in t_params.items():
        assert p.dtype == want[name].dtype
        # one rounding to the param's type of values within 4 f32 ulps
        _ulps(p, want[name], name, n=2 ** 16 if p.dtype == torch.bfloat16
              else ULPS)


def test_global_norm_matches_reference():
    cfg, params = _reference_params("llama3-8b")
    g = _grads(params, 3, 0.5)
    want = float(r_opt.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(optimizer.global_norm(lm_params_from_arrays(cfg, g).values()))
    assert abs(got - want) <= NORM_REL * want


# --------------------------------------------------------------------------- #
# checkpoints


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn(5, 3, generator=g).bfloat16(),
                       "layers.0.norm1": torch.randn(3, generator=g)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32),
                    "m": [torch.randn(2, generator=g),
                          torch.randn(1, 4, generator=g)]}}


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy(), tree)


def test_checkpoint_layout_and_retention(tmp_path):
    tree = _tree()
    for step in (1, 2, 3):
        path = checkpoint.save(tmp_path, step, tree, extra={"data": step},
                               keep=2)
        assert path.name == f"step_{step:08d}"
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    assert checkpoint.latest_step(tmp_path) == 3
    assert checkpoint.latest_step(tmp_path / "none") is None
    man = checkpoint.manifest_of(tmp_path, 3)
    assert set(man) == {"step", "time", "extra", "leaves"}
    assert man["step"] == 3 and man["extra"] == {"data": 3}
    dtypes = {m["path"]: m["dtype"] for m in man["leaves"]}
    assert dtypes["['params']['embed']"] == "bfloat16"
    assert dtypes["['opt']['count']"] == "int32"
    assert dtypes["['opt']['m'][1]"] == "float32"
    with np.load(tmp_path / "step_00000003" / "shards.npz") as data:
        assert {data[m["key"]].dtype.name for m in man["leaves"]} == {
            "float32", "int32"}
    got, _ = checkpoint.restore(tmp_path, tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path / "none", tree)


def test_checkpoints_cross_between_the_two_systems(tmp_path):
    tree = _tree()
    checkpoint.save(tmp_path / "port", 4, tree)
    r_ckpt.save(tmp_path / "ref", 4, _np_tree(tree))
    ours = json.loads((tmp_path / "port" / "step_00000004" /
                       "manifest.json").read_text())["leaves"]
    theirs = r_ckpt.manifest_of(tmp_path / "ref", 4)["leaves"]
    key = lambda m: (m["path"], tuple(m["shape"]), m["dtype"])  # noqa
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    got, man = checkpoint.restore(tmp_path / "ref", tree)
    assert man["step"] == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert torch.equal(a, b)
    want, _ = r_ckpt.restore(tmp_path / "port", _np_tree(tree))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(_np_tree(tree))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------- #
# fault tolerance


def test_heartbeat_straggler_and_elastic_plan_match_reference():
    hb, r_hb = fault_tolerance.Heartbeat(10.0), r_ft.Heartbeat(10.0)
    for w, t in (("a", 0.0), ("b", 5.0), ("c", 12.0)):
        hb.beat(w, t)
        r_hb.beat(w, t)
    for now in (11.0, 16.0, 30.0):
        assert hb.dead(now) == r_hb.dead(now)
        assert hb.alive(now) == r_hb.alive(now)
    sd, r_sd = fault_tolerance.StragglerDetector(), r_ft.StragglerDetector()
    r = np.random.default_rng(0)
    for _ in range(12):
        for w in ("w0", "w1", "w2", "w3"):
            t = float(r.uniform(1.0, 1.02)) * (1.5 if w == "w2" else 1.0)
            sd.observe(w, t)
            r_sd.observe(w, t)
    assert sd.stragglers() == r_sd.stragglers() == ["w2"]
    for n in (1, 7, 16, 64):
        for div in ((), (12,), (40, 6)):
            got = fault_tolerance.plan_elastic_mesh(n, arch_divisors=div)
            want = r_ft.plan_elastic_mesh(n, arch_divisors=div)
            assert (got.data, got.model, got.chips) == \
                (want.data, want.model, want.chips)


def test_run_with_restarts_resumes_exactly_as_the_reference(tmp_path):
    def step_fn(step, state):
        return {"step": state["step"] + 1,
                "acc": state["acc"] * 0.5 + float(step)}

    def r_step_fn(step, state):
        return {"step": state["step"] + 1,
                "acc": state["acc"] * 0.5 + float(step)}

    state = {"step": torch.tensor(0, dtype=torch.int32),
             "acc": torch.zeros(3)}
    got, stats = fault_tolerance.run_with_restarts(
        step_fn, state, n_steps=9, ckpt_dir=str(tmp_path / "p"),
        ckpt_every=3, fail_at=[4, 7])
    want, r_stats = r_ft.run_with_restarts(
        r_step_fn, {"step": jnp.asarray(0, jnp.int32),
                    "acc": jnp.zeros(3, jnp.float32)},
        n_steps=9, ckpt_dir=str(tmp_path / "r"), ckpt_every=3,
        fail_at=[4, 7])
    assert dataclasses.asdict(stats) == dataclasses.asdict(r_stats)
    assert stats.restarts == 2 and stats.wasted_steps == 2
    assert int(got["step"]) == int(want["step"]) == 9
    np.testing.assert_array_equal(got["acc"].numpy(), np.asarray(want["acc"]))
    clean, _ = fault_tolerance.run_with_restarts(
        step_fn, state, n_steps=9, ckpt_dir=str(tmp_path / "c"),
        ckpt_every=3)
    assert torch.equal(clean["acc"], got["acc"])


# --------------------------------------------------------------------------- #
# the kernels' autograd Functions, with the plain version as the launcher


def _plain_attention_launch(q, k, v, causal, qp, kp, lse=None):
    """B7's forward seam on the CPU: the plain output, and the plain
    log-sum-exp where the Function asks for it."""
    if lse is not None:
        lse.copy_(fa._lse(q, k, causal, qp, kp))
    return fa_ref.attention_plain(q, k, v, causal=causal, q_pos=qp, k_pos=kp)


def _plain_attention_backward(go, q, k, v, o, lse, causal, q_pos, k_pos):
    """B7's backward seam on the CPU: the plain version's gradients."""
    return tuple(fa.plain_backward(q, k, v, go, causal=causal, q_pos=q_pos,
                                   k_pos=k_pos))


def _plain_launchers(monkeypatch):
    monkeypatch.setattr(fa, "_launch", _plain_attention_launch)
    monkeypatch.setattr(fa, "_launch_backward", _plain_attention_backward)
    monkeypatch.setattr(ssd_mod, "_scan", lambda x, dt, a, b, c, d, chunk:
                        ssd_ref.ssd_plain(x, dt, a, b, c, d, chunk=chunk))
    # B8's backward seam: autograd of the chunk-parallel plain version (the
    # explicit formulas, ref.ssd_backward_plain, round a_log's gradient
    # apart from it by more than this file's 1e-6; tests/test_torch_ssd_grad.py
    # holds them)
    monkeypatch.setattr(ssd_mod, "_scan_backward",
                        lambda x, dt, a, b, c, d, gy, gh, chunk:
                        ssd_mod.plain_backward(x, dt, a, b, c, d, gy, gh,
                                               chunk=chunk))


def _grad_close(got, want, rel):
    for g, w in zip(got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert g.dtype == w.dtype and err <= rel * scale, (err, scale)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", ["causal", "cross", "position", "gqa_d80"])
def test_flash_attention_function_gives_the_plain_gradients(
        case, dtype, rel, monkeypatch):
    _plain_launchers(monkeypatch)
    # slices of one kv head of one row: the backward's loop is exercised
    monkeypatch.setattr(fa, "BACKWARD_SCORE_BYTES", 1)
    b, sq, sk, h, kvh, d = {"causal": (2, 37, 37, 4, 4, 32),
                            "cross": (2, 19, 45, 4, 2, 16),
                            "position": (2, 40, 40, 6, 2, 64),
                            "gqa_d80": (1, 33, 33, 8, 2, 80)}[case]
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, n, d, generator=g).to(dtype)
               for s, n in ((sq, h), (sk, kvh), (sk, kvh)))
    kw = dict(causal=case != "cross")
    if case == "position":
        pos = torch.stack([torch.randperm(sq, generator=g) // 2
                           for _ in range(b)]).to(torch.int32)
        kw.update(q_pos=pos, k_pos=pos)
    go = torch.randn(b, sq, h, d, generator=g).to(dtype)
    ins = [t.requires_grad_() for t in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*ins, kw["causal"], kw.get("q_pos"),
                                    kw.get("k_pos"))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, go)
    want = torch.autograd.grad(fa_ref.attention_plain(*ins, **kw), ins, go)
    _grad_close(got, want, rel)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("decay", ["weak", "strong"])
def test_ssd_function_gives_the_plain_gradients(dtype, rel, decay,
                                               monkeypatch):
    """The Function's backward is autograd of the chunk-parallel plain
    version (``ssd_chunked_plain``): its gradients equal that within
    ``rel``, and the chunk-by-chunk ``ssd_plain``'s within ``rel`` in
    bf16 and ``SSD_ORDER_REL`` in f32, where a_log's gradient (a sum
    over every token's decay with cancellations) rounds differently in
    the two orders (4e-6 here, 9e-5 under strong decays at mamba2-780m's
    widths)."""
    _plain_launchers(monkeypatch)
    g = torch.Generator().manual_seed(4)
    bsz, s, nh, hd, ng, ds = 2, 170, 4, 16, 2, 16
    x = torch.randn(bsz, s, nh, hd, generator=g).to(dtype)
    dt = torch.rand(bsz, s, nh, generator=g) * (0.5 if decay == "weak"
                                                else 2.0)
    a_log, d_skip = torch.randn(nh, generator=g), torch.randn(nh, generator=g)
    if decay == "strong":
        a_log = torch.log(1 + 15 * torch.rand(nh, generator=g))
    b, c = (torch.randn(bsz, s, ng, ds, generator=g).to(dtype)
            for _ in range(2))
    ins = [t.requires_grad_() for t in (x, dt, a_log, b, c, d_skip)]
    gy = torch.randn(bsz, s, nh, hd, generator=g).to(dtype)
    gh = torch.randn(bsz, nh, hd, ds, generator=g)
    y, h = ssd_mod.SSDScanFn.apply(*ins, 32)
    assert y.grad_fn is not None
    order_rel = SSD_ORDER_REL if dtype == torch.float32 else rel
    for plain, tol in ((ssd_ref.ssd_chunked_plain, rel),
                       (ssd_ref.ssd_plain, order_rel)):
        yp, hp = plain(*ins, chunk=32)
        for outs, wants, grads in (((y, h), (yp, hp), (gy, gh)),
                                   # the model reads y only: the state's
                                   # gradient is absent
                                   ((y,), (yp,), (gy,))):
            got = torch.autograd.grad(outs, ins, grads, retain_graph=True)
            want = torch.autograd.grad(wants, ins, grads, retain_graph=True)
            assert all(bool(torch.isfinite(t).all()) for t in got)
            _grad_close(got, want, tol)


def test_ssd_plain_gradients_stay_finite_over_whole_chunks():
    """Strong decays over whole 128-token chunks overflow exp(cum_i -
    cum_j) above the diagonal; the plain version masks before the exp, so
    its gradients stay finite, and match the reference's ``ssd_chunked``
    under ``jax.grad`` within its bf16 intra-chunk rounding (2e-2 of the
    largest magnitude)."""
    from repro.models.mamba import ssd_chunked
    r = np.random.default_rng(6)
    bsz, s, nh, hd, ng, ds = 1, 256, 2, 8, 1, 8
    arrs = [r.normal(size=(bsz, s, nh, hd)), 2 * r.random((bsz, s, nh)),
            np.log(1 + 15 * r.random(nh)), r.normal(size=(bsz, s, ng, ds)),
            r.normal(size=(bsz, s, ng, ds)), r.normal(size=nh)]
    arrs = [a.astype(np.float32) for a in arrs]
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, _ = ssd_ref.ssd_plain(*ins, chunk=128)
    got = torch.autograd.grad(y.square().sum(), ins)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = jax.grad(lambda *a: jnp.sum(jnp.square(ssd_chunked(
        *a, chunk=128)[0].astype(jnp.float32))), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-2 * np.abs(w).max()


# --------------------------------------------------------------------------- #
# the model's training path inside the port


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "granite-moe-3b-a800m", "whisper-large-v3"])
def test_checkpointed_layers_give_the_plain_gradients(arch):
    cfg = smoke_config(get_arch(arch))
    mb, model = build_model(cfg, torch.device("cpu"), seed=1)
    model.float()
    params = [p.requires_grad_() for p in model.parameters()]
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 24, 2, seed=1), 0)
    extras = train_mod._extras_fn(cfg, torch.float32)
    if extras is not None:
        batch.update(extras(DataConfig(cfg.vocab_size, 24, 2), 0))
    grads = {}
    for remat in (True, False):
        loss, metrics = mb.loss_fn(model, batch, remat=remat)
        grads[remat] = torch.autograd.grad(loss, params)
        assert set(metrics) == {"ce", "aux"}
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_launches_each_kernel_twice_a_layer_under_remat(
        monkeypatch):
    """The forward and the checkpoint's recompute each reach the kernels'
    Functions once a mixer layer; counted through the CPU seam."""
    calls = {"attn": 0, "ssd": 0, "attn_backward": 0}

    def attn_launch(*args):
        calls["attn"] += 1
        return _plain_attention_launch(*args)

    def attn_backward(*args):
        calls["attn_backward"] += 1
        return _plain_attention_backward(*args)

    def ssd_launch(x, dt, a, b, c, d, chunk):
        calls["ssd"] += 1
        return ssd_ref.ssd_plain(x, dt, a, b, c, d, chunk=chunk)

    monkeypatch.setattr(fa, "_launch", attn_launch)
    monkeypatch.setattr(fa, "_launch_backward", attn_backward)
    monkeypatch.setattr(ssd_mod, "_scan", ssd_launch)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    monkeypatch.setattr(fa_ops, "flash_attention",
                        lambda q, k, v, **kw: fa.FlashAttentionFn.apply(
                            q, k, v, kw.get("causal", True), kw.get("q_pos"),
                            kw.get("k_pos")))
    monkeypatch.setattr(ssd_ops, "ssd_scan",
                        lambda *a, chunk=128: ssd_mod.SSDScanFn.apply(
                            *a, chunk))
    cfg = smoke_config(get_arch("jamba-v0.1-52b"))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    opt = optimizer.AdamW()
    step = make_train_step(mb, model, opt)
    state = opt.init(dict(model.named_parameters()))
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 24, 2), 0)
    state, metrics = step(state, batch)
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.num_layers))
    assert calls == {"attn": 2 * n_attn, "ssd": 2 * (cfg.num_layers - n_attn),
                     "attn_backward": n_attn}
    assert set(metrics) == {"loss", "ce", "aux", "grad_norm"}
    assert float(metrics["aux"]) > 0 and int(state["count"]) == 1
    assert all(p.grad is None for p in model.parameters())


# --------------------------------------------------------------------------- #
# the launcher


def test_train_resumes_exactly_from_its_checkpoint(tmp_path, capsys):
    kw = dict(smoke=True, seq_len=16, global_batch=2, ckpt_every=2,
              device="cpu", log_every=1)
    _, whole = train_mod.train("mamba2-780m", steps=4,
                               ckpt_dir=str(tmp_path / "a"), **kw)
    _, first = train_mod.train("mamba2-780m", steps=2,
                               ckpt_dir=str(tmp_path / "b"), **kw)
    stats = {}
    model, rest = train_mod.train("mamba2-780m", steps=4,
                                  ckpt_dir=str(tmp_path / "b"), stats=stats,
                                  **kw)
    assert first + rest == whole and len(whole) == 4
    assert [s["step"] for s in stats["steps"]] == [2, 3]
    assert all(np.isfinite(s["grad_norm"]) for s in stats["steps"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "[train] step=" in out
    a, _ = checkpoint.restore(tmp_path / "a", {"params": model.state_dict()})
    for k, t in model.state_dict().items():
        assert torch.equal(a["params"][k], t), k


def test_train_cli_passes_its_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_mod, "train",
                        lambda arch, **kw: seen.update(arch=arch, **kw))
    train_mod.main(["--arch", "llama3-8b", "--full", "--device", "cpu",
                    "--optimizer", "paper_sgd", "--steps", "3"])
    assert seen["smoke"] is False and seen["device"] == "cpu"
    assert seen["optimizer"] == "paper_sgd" and seen["steps"] == 3
    train_mod.main(["--arch", "llama3-8b"])
    assert seen["smoke"] is True and seen["device"] is None


def test_train_cli_runs_on_the_cpu(capsys):
    train_mod.main(["--arch", "qwen2-vl-7b", "--device", "cpu", "--steps",
                    "2", "--seq-len", "24", "--global-batch", "2",
                    "--optimizer", "paper_sgd", "--log-every", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] step=")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines)


def test_adamw_reduces_loss_on_a_repeated_batch():
    cfg = smoke_config(get_arch("llama3-8b"))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    opt = optimizer.AdamW(lr=1e-3, warmup=1)
    step = make_train_step(mb, model, opt)
    state = opt.init(dict(model.named_parameters()))
    batch = synthetic_batch(DataConfig(cfg.vocab_size, 32, 2), 0)
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
