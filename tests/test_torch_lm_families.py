"""The port's serving path for the moe, hybrid and vlm families
(granite-moe-3b-a800m, llama4-scout-17b-a16e, jamba-v0.1-52b, qwen2-vl-7b
at smoke size) against the JAX reference, on the CPU.

As in ``test_torch_lm.py``: the reference runs on an Auto-axis mesh, its
params go through ``convert.lm_params_from_arrays`` into the port, the
same numpy prompts (and for qwen2-vl the same patch embeddings and
distinct (t, h, w) M-RoPE positions) go to both, logits agree within
``LOGIT_REL`` of their largest magnitude, and greedy tokens equal the
reference's wherever its top-2 logit gap exceeds twice that tolerance
(``_gap``; the smoke MoE models' logits are a tenth of the dense ones').

Routing.  Both models compute in bf16, so the hidden states that reach a
router differ by a bf16 rounding here and there, which moves a token
whose k-th and (k+1)-th expert probabilities lie close across the
boundary; at 150 tokens, 2-4 MoE layers and top-2 of 4 experts every row
has such tokens, so no row's routing is decided on both paths alike.
The reference's routing is therefore recorded (``moe_apply``'s own ops
on its input, layer by layer, from an unrolled reference run) and fed to
the port's MoE layers in place of their own; capacity, positions, drops,
dispatch and combine stay the port's.  The port's own routing, computed
beside it from its own hidden states, must pick the reference's experts
(as a set per token) wherever the reference's boundary gap exceeds
``ROUTE_MARGIN`` (5x the widest gap seen to flip, 1.1e-3 for jamba);
the number of decisions under it is printed, and at least three quarters
of them clear it, so the check is not vacuous.  Every row's logits are
compared, since every row is routed alike.  The MoE layer alone is held
to ``moe_apply`` row by row under the routing rule, with identical
inputs, in ``test_torch_moe.py``.

Inside the port, a teacher-forced prefill and one decode step equal the
full prefill within 1e-3: at capacity factor E / k for the MoE models (a
full prefill may drop the last token's assignments, a one-token decode
never does), and with the patch embeddings for qwen2-vl, as the
reference pins for itself.
"""
import dataclasses

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

from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import build_model, generate, serve
from repro_torch.models import registry, transformer
from repro_torch.models.moe import MoE

MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e",
             "jamba-v0.1-52b"]
ARCHS = MOE_ARCHS + ["qwen2-vl-7b"]
LOGIT_REL = 2e-2
ROUTE_MARGIN = 5e-3
S, B, GEN = 150, 2, 6                 # 150 = 128 + 22: a ragged SSD chunk


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=LOGIT_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _randomise(tree, seed):
    """The reference's init zeroes 1-D params and draws dt_bias, a_log and
    d_skip near zero; give every 1-D param a random value of scale 0.1 so
    the (1 + scale) norms and the SSD decay are exercised (the router, a
    2-D f32 param, keeps its init)."""
    r = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.ndim == 1:
            return (0.1 * r.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


def _vlm_inputs(cfg, b, s, seed):
    """qwen2-vl's extra prompt inputs: patch embeddings over the first
    ``n_vision_patches`` positions, and (t, h, w) positions whose three
    components all differ (t rises along the row, as the kernel's index
    mask needs)."""
    r = np.random.default_rng(seed)
    ve = (0.02 * r.normal(size=(b, cfg.n_vision_patches, cfg.d_model))
          ).astype(np.float32)
    t = np.broadcast_to(np.arange(s), (b, s))
    pos = np.stack([t, t // 4 + r.integers(0, 8, (b, s)),
                    r.integers(0, 4 * s, (b, s))], -1).astype(np.int32)
    return ve, pos


def _gap(logits) -> float:
    """A close call: a top-2 gap within twice the logit tolerance, the
    most the two paths' logits of one step may move it."""
    return 2 * LOGIT_REL * float(np.abs(logits).max())


def _routing(cfg, p, x):
    """``moe_apply``'s routing of x: f32 probs, the renormalised top-k
    gates and ids, as numpy."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      p["router"]), axis=-1)
    gate, ids = jax.lax.top_k(probs, cfg.top_k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    return np.asarray(probs), np.asarray(gate), np.asarray(ids)


_REF = {}


def _reference(arch):
    """The reference's serving loop at smoke size, unrolled (its
    ``exact_counts`` path, not jitted) so each MoE layer's routing can be
    recorded in call order: params (numpy), prompts, the vlm inputs or
    None, prefill logits, per decode step the fed token and its logits,
    and the routings."""
    if arch in _REF:
        return _REF[arch]
    cfg = r_smoke(r_get_arch(arch))
    shape = ShapeConfig("serve", S + GEN, B, "prefill")
    rules = resolve(cfg, _mesh(), shape)
    mb = r_registry.bundle(cfg)
    params = _randomise(jax.tree.map(
        np.asarray, mb.materialize_params(jax.random.key(0), tp=1)), 1)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompts)}
    vlm = None
    if cfg.family == "vlm":
        vlm = _vlm_inputs(cfg, B, S, 3)
        batch["vision_embeds"] = jnp.asarray(vlm[0], jnp.bfloat16)
        batch["positions"] = jnp.asarray(vlm[1])
    jp = jax.tree.map(jnp.asarray, params)
    caches = r_registry.make_cache(cfg, shape, rules)
    routes = []
    moe_apply = r_transformer.moe_apply

    def recording(cfg_, p, x, rules_, **kw):
        routes.append(_routing(cfg_, p, x))
        return moe_apply(cfg_, p, x, rules_, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(r_transformer, "moe_apply", recording)
    try:
        logits, caches = r_transformer.prefill_fn(cfg, jp, batch, caches,
                                                  rules, exact_counts=True)
        steps = [(None, np.asarray(logits))]
        tok = jnp.argmax(logits[..., :cfg.vocab_size], -1).astype(jnp.int32)
        for i in range(GEN - 1):
            fed = tok
            logits, caches = r_transformer.decode_fn(
                cfg, jp, {"tokens": fed, "pos": jnp.asarray(S + i, jnp.int32)},
                caches, rules, exact_counts=True)
            tok = jnp.argmax(logits[..., :cfg.vocab_size], -1).astype(
                jnp.int32)
            steps.append((np.asarray(fed), np.asarray(logits)))
    finally:
        mp.undo()
    _REF[arch] = (params, prompts, vlm, steps, routes)
    return _REF[arch]


class ForcedRouting:
    """Feeds the reference's recorded routings, in call order, to a port
    model's MoE layers, and keeps what each layer would have routed on its
    own beside the reference's boundary gap."""

    def __init__(self, routes):
        self.routes = list(routes)
        self.calls = 0
        self.own = []                    # (own ids, reference ids, gap)

    def install(self, model) -> None:
        for m in model.modules():
            if isinstance(m, MoE):
                m.route = self._route_of(m)

    def _route_of(self, m):
        own_route = MoE.route.__get__(m)

        def route(x):
            probs, _, ids = own_route(x)
            r_probs, r_gate, r_ids = self.routes[self.calls]
            self.calls += 1
            k = r_ids.shape[-1]
            top = np.sort(r_probs, -1)[..., ::-1]
            self.own.append((ids.numpy(), r_ids, top[..., k - 1] - top[..., k]))
            return probs, torch.from_numpy(r_gate.copy()), \
                torch.from_numpy(r_ids.astype(np.int64))
        return route

    def check(self, label: str) -> None:
        """Every routing was fed, and the port's own routing picked the
        reference's experts wherever the reference's gap clears the
        margin; prints the decisions under it."""
        assert self.calls == len(self.routes) > 0
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


def _port_model(arch, params, routes=None):
    cfg = smoke_config(get_arch(arch))
    mb, model = build_model(cfg, torch.device("cpu"),
                            state_dict=lm_params_from_arrays(cfg, params))
    forced = None
    if routes:
        forced = ForcedRouting(routes)
        forced.install(model)
    return mb, model, forced


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    params, prompts, vlm, steps, routes = _reference(arch)
    mb, model, forced = _port_model(arch, params, routes)
    assert bool(routes) == (arch in MOE_ARCHS)
    extra = {}
    if vlm is not None:
        extra = dict(vision_embeds=torch.from_numpy(vlm[0]).bfloat16(),
                     positions=torch.from_numpy(vlm[1]))
    caches = registry.make_cache(mb.cfg, B, S + GEN)
    with torch.inference_mode():
        logits, caches = mb.prefill_fn(model, torch.from_numpy(prompts).long(),
                                       caches, **extra)
        _close(logits, steps[0][1])
        for i, (fed, want) in enumerate(steps[1:]):
            logits, caches = mb.decode_fn(model, torch.tensor(fed).long(),
                                          S + i, caches)
            _close(logits, want)
    assert logits.shape == (B, 1, mb.cfg.padded_vocab(1))
    if forced is not None:
        forced.check(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_reference_greedy(arch, monkeypatch, capsys):
    params, prompts, vlm, steps, routes = _reference(arch)
    cfg = smoke_config(get_arch(arch))
    forced = ForcedRouting(routes) if routes else None
    if forced is not None:
        def building(cfg_, device, **kw):
            mb, model = build_model(cfg_, device, **kw)
            forced.install(model)
            return mb, model
        monkeypatch.setattr(serve_mod, "build_model", building)
    # the reference's serve is text-only; so is this comparison for qwen2-vl
    if vlm is not None:
        params, prompts, _, steps, _ = _text_only_reference(arch)
    got = serve(arch, smoke=True, gen_len=GEN, device="cpu",
                state_dict=lm_params_from_arrays(cfg, params),
                prompts=prompts).numpy()
    assert got.shape == (B, GEN)
    assert "[serve]" in capsys.readouterr().out
    want = np.stack([np.argmax(lg[:, 0, :cfg.vocab_size], -1)
                     for _, lg in steps], 1)
    checked = 0
    for row in range(B):
        for t in range(GEN):
            top2 = np.sort(steps[t][1][row, 0, :cfg.vocab_size])[-2:]
            if top2[1] - top2[0] <= _gap(steps[t][1]):
                break                     # a close call: the rest may part
            assert got[row, t] == want[row, t], (row, t)
            checked += 1
    assert checked >= 1                   # not vacuous
    if forced is not None:
        forced.check(arch)


def _text_only_reference(arch):
    """qwen2-vl served as ``serve`` serves it: text only, the default
    (t, t, t) positions, jitted as in ``test_torch_lm.py``."""
    from repro.train.train_loop import make_decode_step, make_prefill_step
    key = (arch, "text")
    if key in _REF:
        return _REF[key]
    cfg = r_smoke(r_get_arch(arch))
    shape = ShapeConfig("serve", S + GEN, B, "prefill")
    rules = resolve(cfg, _mesh(), shape)
    mb = r_registry.bundle(cfg)
    params, prompts = _reference(arch)[:2]
    jp = jax.tree.map(jnp.asarray, params)
    caches = r_registry.make_cache(cfg, shape, rules)
    prefill = jax.jit(make_prefill_step(mb, rules))
    decode = jax.jit(make_decode_step(mb, rules))
    logits, caches = prefill(jp, {"tokens": jnp.asarray(prompts)}, caches)
    steps = [(None, np.asarray(logits))]
    tok = jnp.argmax(logits[..., :cfg.vocab_size], -1).astype(jnp.int32)
    for i in range(GEN - 1):
        fed = tok
        tok, logits, caches = decode(
            jp, {"tokens": fed, "pos": jnp.asarray(S + i, jnp.int32)}, caches)
        steps.append((np.asarray(fed), np.asarray(logits)))
    _REF[key] = (params, prompts, None, steps, [])
    return _REF[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_equals_full_prefill(arch):
    cfg = smoke_config(get_arch(arch))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    kw, extra = {}, {}
    if cfg.n_experts:
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    if cfg.family == "vlm":
        ve, _ = _vlm_inputs(cfg, B, S, 4)
        extra["vision_embeds"] = torch.from_numpy(ve).bfloat16()
    with torch.inference_mode():
        full, _ = mb.prefill_fn(model, toks, registry.make_cache(cfg, B, S),
                                **extra, **kw)
        _, caches = mb.prefill_fn(model, toks[:, :-1],
                                  registry.make_cache(cfg, B, S), **extra,
                                  **kw)
        step, _ = mb.decode_fn(model, toks[:, -1:], S - 1, caches)
    assert float((full - step).abs().max()) < 1e-3


def test_generate_is_deterministic_for_the_hybrid_family():
    """``serve``'s loop, ``generate``, runs the MoE and hybrid models at
    smoke size and returns the same tokens for the same weights."""
    cfg = smoke_config(get_arch("jamba-v0.1-52b"))
    mb, model = build_model(cfg, torch.device("cpu"), seed=2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20),
                            generator=torch.Generator().manual_seed(3))
    a = generate(mb, model, prompts, 4)
    b = generate(mb, model, prompts, 4)
    assert a.shape == (2, 4) and torch.equal(a, b)


def _shared_t_positions(case):
    """M-RoPE (t, h, w) positions whose t does not rise strictly: the
    smallest input on which the port once refused what the reference
    computes, two patches at t = 0, and an 8-token row whose four patches
    of a 2 x 2 grid share t = 0 before the text resumes at the grid's
    side, as Qwen2-VL lays out an image."""
    if case == "two patches":
        return np.array([[[0, 0, 0], [0, 1, 1]]], np.int32)
    t = [0, 0, 0, 0, 2, 3, 4, 5]
    h = [0, 0, 1, 1, 2, 3, 4, 5]
    w = [0, 1, 0, 1, 2, 3, 4, 5]
    return np.stack([t, h, w], -1)[None].astype(np.int32)


@pytest.mark.parametrize("case", ["two patches", "four patches at t = 0"])
def test_positions_that_do_not_rise_match_reference(case):
    """A prefill whose t positions repeat masks attention by position,
    as the reference does (``q_pos >= k_pos``); the port's logits equal
    the reference's ``prefill_fn`` within ``LOGIT_REL`` (patch embeddings
    over the 8-token row's four patches)."""
    arch = "qwen2-vl-7b"
    params = _reference(arch)[0]
    pos = _shared_t_positions(case)
    b, s = pos.shape[:2]
    cfg_r = r_smoke(r_get_arch(arch))
    shape = ShapeConfig("serve", s, b, "prefill")
    rules = resolve(cfg_r, _mesh(), shape)
    r = np.random.default_rng(6)
    toks = r.integers(0, cfg_r.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    extra = {"positions": torch.from_numpy(pos)}
    if s == 8:
        ve = (0.02 * r.normal(size=(b, 4, cfg_r.d_model))).astype(np.float32)
        batch["vision_embeds"] = jnp.asarray(ve, jnp.bfloat16)
        extra["vision_embeds"] = torch.from_numpy(ve).bfloat16()
    want, _ = r_transformer.prefill_fn(
        cfg_r, jax.tree.map(jnp.asarray, params), batch,
        r_registry.make_cache(cfg_r, shape, rules), rules, exact_counts=True)
    mb, model, _ = _port_model(arch, params)
    with torch.inference_mode():
        got, _ = mb.prefill_fn(model, torch.from_numpy(toks).long(),
                               registry.make_cache(mb.cfg, b, s), **extra)
    assert np.isfinite(_np(got)).all()
    _close(got, want)


@pytest.mark.parametrize("rising", [True, False])
def test_only_positions_that_do_not_rise_mask_by_position(rising,
                                                          monkeypatch):
    """Positions that rise strictly along every row keep the index mask
    (every attention call gets no positions, so the card launches what it
    launched before); others reach every attention layer's call as int32
    (B, S) positions, their t component."""
    from repro_torch.models import attention as attention_mod
    cfg = smoke_config(get_arch("qwen2-vl-7b"))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    seen = []
    plain = attention_mod.attend

    def spy(q, k, v, **kw):
        seen.append(kw)
        return plain(q, k, v, **kw)
    monkeypatch.setattr(attention_mod, "attend", spy)
    ve, pos = _vlm_inputs(cfg, B, 40, 4)
    if not rising:
        patches = _shared_t_positions("four patches at t = 0")
        pos = np.concatenate([np.broadcast_to(patches, (B, 8, 3)),
                              pos[:, 8:]], 1)
    with torch.inference_mode():
        mb.prefill_fn(model, torch.zeros(B, 40, dtype=torch.long),
                      registry.make_cache(cfg, B, 40),
                      vision_embeds=torch.from_numpy(ve).bfloat16(),
                      positions=torch.from_numpy(pos))
    assert len(seen) == cfg.num_layers
    for kw in seen:
        assert kw["causal"] is True
        if rising:
            assert kw["q_pos"] is None and kw["k_pos"] is None
        else:
            assert kw["q_pos"].dtype == torch.int32
            np.testing.assert_array_equal(kw["q_pos"].numpy(), pos[..., 0])
            assert kw["k_pos"] is kw["q_pos"]


# --------------------------------------------------------------------------- #
# carrying the reference's params across


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_moe_and_jamba_trees(arch):
    cfg_r = r_smoke(r_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    tree = jax.tree.map(np.asarray, r_registry.bundle(
        cfg_r).materialize_params(jax.random.key(0), tp=1))
    tree = _randomise(tree, 5)
    sd = lm_params_from_arrays(cfg, tree)
    model = transformer.Transformer(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)              # strict: every key, every shape
    p = transformer._period(cfg)
    for i in range(cfg.num_layers):
        position = tree["layers"][i % p]
        layer = model.layers[i]
        assert hasattr(layer, "attn") == ("attn" in position)
        assert hasattr(layer, "moe") == ("moe" in position) \
            == cfg.layer_is_moe(i)
        if hasattr(layer, "moe"):
            assert layer.moe.router.dtype == torch.float32
            np.testing.assert_array_equal(
                layer.moe.router.numpy(), position["moe"]["router"][i // p])
            np.testing.assert_array_equal(
                layer.moe.w_down.float().numpy(),
                np.asarray(position["moe"]["w_down"][i // p], np.float32))
            if cfg.n_shared_experts:
                np.testing.assert_array_equal(
                    layer.moe.shared.w_in.float().numpy(), np.asarray(
                        position["moe"]["shared"]["w_in"][i // p],
                        np.float32))
        if hasattr(layer, "ssm"):
            np.testing.assert_array_equal(
                layer.ssm.a_log.numpy(), position["ssm"]["a_log"][i // p])
    if arch == "jamba-v0.1-52b":        # one period: attention at 4, MoE odd
        assert [hasattr(m, "attn") for m in model.layers] == \
            [i == 4 for i in range(8)]
        assert [hasattr(m, "moe") for m in model.layers] == \
            [i % 2 == 1 for i in range(8)]
