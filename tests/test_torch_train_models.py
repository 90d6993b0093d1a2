"""One whole train step of the port (``make_train_step`` with AdamW) per
family at smoke size against the reference's jitted ``make_train_step``,
on the CPU.

The reference runs on an Auto-axis mesh; its params (its zero-initialised
leaves given random values of scale 0.1) and its ``AdamW.init`` state go
through ``convert.lm_params_from_arrays`` / ``adamw_state_from_arrays``
into the port, and the same numpy batch (``synthetic_batch`` of 2 x 64
tokens, with frames or patch embeddings where the family takes them)
goes to both.  Each family runs on an f32 copy of the weights, where
bf16 rounding would dominate the comparison: loss, ce, aux and the
global gradient norm within ``F32_REL``; the AdamW moments m and v (the
clipped gradient and its square, scaled) within ``F32_REL`` and twice
that (a square doubles a relative error) of each leaf's largest
magnitude; the f32 master within 4 f32 ulps of its
magnitude plus 2 x lr x ``rel`` / ``clear`` (the most a gradient that
far off moves a first Adam step, g / (|g| + eps)) wherever the
reference's m clears ``clear`` of its leaf's largest (where it does not,
the step's sign may fall either way); the count.  The reference's SSD
keeps its intra-chunk tensors in bf16 even in an f32 model
(``ssd_chunked``'s ``cdt``), so the ssm and hybrid families are held
within ``rel`` = ``SSD_REL`` instead, their masters where m clears
``SSD_CLEAR``.  llama3-8b also runs in bf16, the served
type: loss and norm within ``BF16_REL``, every bf16 parameter after the
step within ``BF16_REL`` of its leaf's largest magnitude.

Routing.  The MoE families route on both sides in f32; the reference's
expert ids, recorded from its unrolled forward on the same weights and
batch, are fed to the port's MoE layers (their probabilities and gates
stay the port's own, so the router's gradient is the port's), and the
port's own top-k must pick the same experts wherever the reference's
boundary gap exceeds ``ROUTE_MARGIN``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig
from repro.configs import get_arch as r_get_arch, smoke_config as r_smoke
from repro.distributed.sharding import resolve
from repro.models import registry as r_registry
from repro.models import transformer as r_transformer
from repro.train import data as r_data
from repro.train.optimizer import AdamW as RAdamW
from repro.train.train_loop import make_train_step as r_make_train_step

from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import adamw_state_from_arrays, lm_params_from_arrays
from repro_torch.launch.serve import build_model
from repro_torch.models.moe import MoE
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_loop import make_train_step

S, B = 64, 2
F32_REL = 1e-4
SSD_REL = 2e-2
BF16_REL = 2e-2
CLEAR = 1e-2
SSD_CLEAR = 0.5
ROUTE_MARGIN = 1e-5
ULP = 2.0 ** -23
FAMILIES = {"dense": "llama3-8b", "ssm": "mamba2-780m",
            "moe": "granite-moe-3b-a800m", "hybrid": "jamba-v0.1-52b",
            "vlm": "qwen2-vl-7b", "enc-dec": "whisper-large-v3"}


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max abs err {err} > {rel} x {scale}"


def _params(mb, dtype):
    """The reference's smoke params as numpy, every all-zero leaf (norm
    scales, the SSM's a_log, dt_bias, d_skip) drawn at scale 0.1, cast to
    ``dtype`` (the MoE router stays f32)."""
    r = np.random.default_rng(1)

    def f(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * r.normal(size=a.shape)).astype(a.dtype)
        return a if a.dtype == np.float32 else a.astype(dtype)
    return jax.tree.map(f, jax.tree.map(
        np.asarray, mb.materialize_params(jax.random.key(0), tp=1)))


def _extras(cfg, dtype):
    """The batch's frames or patch embeddings, as ``launch.train`` draws
    them, as numpy of ``dtype``."""
    rng = np.random.default_rng(0)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.normal(
            scale=0.02, size=(B, cfg.n_vision_patches, cfg.d_model)
        ).astype(dtype)}
    if cfg.is_enc_dec:
        return {"frames": rng.normal(
            scale=0.02, size=(B, S, cfg.d_model)).astype(dtype)}
    return {}


def _routes(cfg, rules, jp, batch):
    """The reference's routing of every MoE layer, in call order, from its
    unrolled forward (no remat, not jitted): (probs, ids) as numpy."""
    routes = []
    moe_apply = r_transformer.moe_apply

    def recording(cfg_, p, x, rules_, **kw):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
        routes.append((np.asarray(probs),
                       np.asarray(jax.lax.top_k(probs, cfg_.top_k)[1])))
        return moe_apply(cfg_, p, x, rules_, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(r_transformer, "moe_apply", recording)
    try:
        r_transformer.forward(cfg, jp, batch["tokens"], rules,
                              vision_embeds=batch.get("vision_embeds"),
                              remat=False, exact_counts=True)
    finally:
        mp.undo()
    return routes


class ForcedIds:
    """Routes each of a port model's MoE layers to the reference's experts
    (its ids, in its order) with the layer's own probabilities and gates,
    and keeps the layer's own top-k beside the reference's boundary gap.
    A layer routes alike on every call (the checkpoint's recompute runs
    it again)."""

    def __init__(self, routes):
        self.routes = routes
        self.own = []

    def install(self, model) -> None:
        layers = [m for m in model.modules() if isinstance(m, MoE)]
        assert len(layers) == len(self.routes) > 0
        for m, (r_probs, r_ids) in zip(layers, self.routes):
            m.route = self._route_of(m, r_probs, r_ids)

    def _route_of(self, m, r_probs, r_ids):
        k = r_ids.shape[-1]
        top = np.sort(r_probs, -1)[..., ::-1]
        gap = top[..., k - 1] - top[..., k]
        ids = torch.from_numpy(r_ids.astype(np.int64))

        def route(x):
            probs = torch.softmax(x.float() @ m.router, dim=-1)
            self.own.append((torch.topk(probs, k, -1)[1].numpy(), r_ids,
                             gap))
            gate = probs.gather(-1, ids)
            return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), \
                ids
        return route

    def check(self, label: str) -> None:
        under = total = 0
        for ids, r_ids, gap in self.own:
            clear = gap > ROUTE_MARGIN
            np.testing.assert_array_equal(np.sort(ids, -1)[clear],
                                          np.sort(r_ids, -1)[clear])
            under += int((~clear).sum())
            total += clear.size
        print(f"{label}: {under} of {total} routing decisions within "
              f"{ROUTE_MARGIN} of the boundary")
        assert under <= total / 4, "the routing margin leaves too little"


def _reference_step(arch, dtype):
    """The reference's jitted train step on its smoke params in ``dtype``:
    (params, the initial AdamW state, the batch, the new params, the new
    state, the metrics, the MoE routing or None), all numpy."""
    cfg = r_smoke(r_get_arch(arch))
    shape = ShapeConfig("train", S, B, "train")
    rules = resolve(cfg, _mesh(), shape)
    mb = r_registry.bundle(cfg)
    params = _params(mb, dtype)
    batch = {k: np.asarray(v) for k, v in r_data.synthetic_batch(
        r_data.DataConfig(cfg.vocab_size, S, B, seed=0), 0).items()}
    batch.update(_extras(cfg, dtype))
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = RAdamW()
    state0 = opt.init(jp)
    routes = _routes(cfg, rules, jp, jb) if cfg.n_experts else None
    new_p, new_s, metrics = jax.jit(r_make_train_step(mb, rules, opt))(
        jp, state0, jb)
    to_np = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
    return (params, to_np(state0), batch, to_np(new_p), to_np(new_s),
            {k: float(v) for k, v in metrics.items()}, routes)


def _port_step(arch, dtype, params, state0, batch, routes):
    cfg = smoke_config(get_arch(arch))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    if dtype == np.float32:
        model.float()
    model.load_state_dict(lm_params_from_arrays(cfg, params))
    forced = None
    if routes is not None:
        forced = ForcedIds(routes)
        forced.install(model)
    state = adamw_state_from_arrays(cfg, state0)
    tb = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
        if v.dtype.kind == "f" else torch.from_numpy(v.copy())
        for k, v in batch.items()}
    step = make_train_step(mb, model, AdamW())
    state, metrics = step(state, tb)
    if forced is not None:
        forced.check(arch)
    return cfg, model, state, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_matches_reference_f32(family):
    arch = FAMILIES[family]
    params, state0, batch, new_p, new_s, r_metrics, routes = \
        _reference_step(arch, np.float32)
    cfg, model, state, metrics = _port_step(arch, np.float32, params, state0,
                                            batch, routes)
    rel, clear = (SSD_REL, SSD_CLEAR) if family in ("ssm", "hybrid") \
        else (F32_REL, CLEAR)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert abs(metrics[k] - r_metrics[k]) <= rel * max(
            abs(r_metrics[k]), 1e-6), (k, metrics[k], r_metrics[k])
    assert int(state["count"]) == int(new_s["count"]) == 1
    want = {k: lm_params_from_arrays(cfg, new_s[k])
            for k in ("master", "m", "v")}
    lr = float(AdamW()._schedule(torch.tensor(1)))
    for name, p in model.named_parameters():
        _close(state["m"][name], want["m"][name], rel, f"m {name}")
        _close(state["v"][name], want["v"][name], 2 * rel, f"v {name}")
        m_ref = want["m"][name].numpy()
        sure = np.abs(m_ref) > clear * np.abs(m_ref).max()
        got, ref = state["master"][name].numpy(), want["master"][name].numpy()
        tol = 4 * ULP * np.abs(ref) + 2 * lr * rel / clear
        bad = (np.abs(got - ref) > tol) & sure
        assert not bad.any(), (name, np.abs(got - ref)[bad].max())
        assert torch.equal(p.detach(), state["master"][name])


def test_train_step_matches_reference_bf16():
    arch = FAMILIES["dense"]
    params, state0, batch, new_p, new_s, r_metrics, _ = _reference_step(
        arch, jnp.bfloat16)
    cfg, model, state, metrics = _port_step(arch, jnp.bfloat16, params,
                                            state0, batch, None)
    for k in ("loss", "ce", "grad_norm"):
        assert abs(metrics[k] - r_metrics[k]) <= BF16_REL * abs(
            r_metrics[k]), (k, metrics[k], r_metrics[k])
    want = lm_params_from_arrays(cfg, new_p)
    for name, p in model.named_parameters():
        assert p.dtype == want[name].dtype, name
        _close(p, want[name], BF16_REL, name)
        assert torch.equal(p.detach(), state["master"][name].to(p.dtype))


def test_synthetic_batch_feeds_both_sides_alike():
    cfg = r_smoke(r_get_arch("llama3-8b"))
    want = r_data.synthetic_batch(
        r_data.DataConfig(cfg.vocab_size, S, B, seed=0), 0)
    got = synthetic_batch(DataConfig(cfg.vocab_size, S, B, seed=0), 0)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_six_steps_track_the_reference():
    """Six AdamW steps of mamba2-780m at smoke size on one repeated batch,
    from the reference's own init (its stacked fan-in and non-zero 1-D
    leaves): the port's losses and gradient norms track the reference's
    jitted steps within ``SSD_REL`` (its bf16 intra-chunk SSD), and the
    loss falls on both."""
    cfg_r = r_smoke(r_get_arch("mamba2-780m"))
    rules = resolve(cfg_r, _mesh(), ShapeConfig("train", S, B, "train"))
    mb_r = r_registry.bundle(cfg_r)
    params = jax.tree.map(np.asarray, mb_r.materialize_params(
        jax.random.key(3), tp=1))
    batch = r_data.synthetic_batch(
        r_data.DataConfig(cfg_r.vocab_size, S, B, seed=2), 0)
    opt = RAdamW(lr=1e-3, warmup=2)
    jp = jax.tree.map(jnp.asarray, params)
    r_state = opt.init(jp)
    step = jax.jit(r_make_train_step(mb_r, rules, opt))
    want = []
    for _ in range(6):
        jp, r_state, m = step(jp, r_state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    cfg = smoke_config(get_arch("mamba2-780m"))
    mb, model = build_model(cfg, torch.device("cpu"),
                            state_dict=lm_params_from_arrays(cfg, params))
    o = AdamW(lr=1e-3, warmup=2)
    state = o.init(dict(model.named_parameters()))
    t_step = make_train_step(mb, model, o)
    tb = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    got = []
    for _ in range(6):
        state, m = t_step(state, tb)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=SSD_REL)
    assert got[-1][0] < got[0][0] and want[-1][0] < want[0][0]
