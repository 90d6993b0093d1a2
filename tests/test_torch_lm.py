"""The port's LM serving path (llama3-8b, stablelm-3b, mamba2-780m at
smoke size) against the JAX reference, on the CPU.

The reference runs on an Auto-axis mesh; its params, drawn with its own
init, go through ``convert.lm_params_from_arrays`` into the port, and
the same numpy prompts go to both.  Both compute in bf16 with f32
statistics, but round at different places (the port's attention rounds
the unnormalised p like the flash kernel, its SSD scan works in f32
where the reference's keeps bf16 intra-chunk tensors), so bf16 tensors
agree within ``REL`` (2%) of their largest magnitude and logits within
``LOGIT_REL`` of theirs.  Inside the port, a teacher-forced prefill and
one decode step equal the full prefill within 1e-3, as the reference
pins for itself.  Greedy tokens equal the reference's wherever the
reference's top-2 logit gap exceeds ``GAP`` (twice the logit tolerance
it could be moved by); past the first closer call the two may part.
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
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import mamba as r_mamba
from repro.models import registry as r_registry
from repro.models.common import materialize
from repro.train.train_loop import make_decode_step, make_prefill_step

from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import build_model, serve
from repro_torch.models import attention, common, mamba, registry

ARCHS = ["llama3-8b", "stablelm-3b", "mamba2-780m"]
REL = 2e-2
LOGIT_REL = 2e-2
GAP = 0.05
S, B, GEN = 150, 2, 6                 # 150 = 128 + 22: a ragged SSD chunk


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _randomise(tree, seed):
    """The reference's init zeroes 1-D params and draws dt_bias, a_log and
    d_skip (its only f32 params) near zero; give them all random values of
    scale 0.1 so the (1 + scale) norms and the SSD decay are exercised."""
    r = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.ndim == 1 or a.dtype == np.float32:
            return (0.1 * r.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


# --------------------------------------------------------------------------- #
# primitives


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_match_reference(dtype):
    r = np.random.default_rng(0)
    x = jnp.asarray(r.normal(size=(2, 5, 64)), dtype)
    scale = jnp.asarray(0.1 * r.normal(size=(64,)), dtype)
    bias = jnp.asarray(0.1 * r.normal(size=(64,)), dtype)
    xt, st, bt = _t(x), _t(scale), _t(bias)
    _close(common.rmsnorm(xt, st), r_common.rmsnorm(x, scale), 1e-2)
    _close(common.layernorm(xt, st, bt), r_common.layernorm(x, scale, bias),
           1e-2)
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(common.rmsnorm(xt, st)),
                                   _np(r_common.rmsnorm(x, scale)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_apply_rope_matches_reference(rotary_pct):
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) + 1000, (2, 40))
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0,
                               rotary_pct)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            500_000.0, rotary_pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    if rotary_pct < 1.0:                      # the tail passes unchanged
        np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])


def test_init_rule():
    cfg = smoke_config(get_arch("llama3-8b"))
    _, model = build_model(cfg, torch.device("cpu"), seed=0)
    for name, p in model.named_parameters():
        if p.dim() == 1:
            assert not p.any(), name
        else:
            fan_in = float(np.prod(p.shape[:-1]))
            want = min(0.02, 1.0 / np.sqrt(fan_in))
            assert abs(float(p.float().std()) / want - 1) < 0.1, name
    _, again = build_model(cfg, torch.device("cpu"), seed=0)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


# --------------------------------------------------------------------------- #
# the mixers, one layer


def test_attention_prefill_and_decode_match_reference():
    cfg_r = r_smoke(r_get_arch("llama3-8b"))
    cfg = smoke_config(get_arch("llama3-8b"))
    rules = resolve(cfg_r, _mesh())
    p = jax.tree.map(np.asarray, materialize(r_attn.attn_params(cfg_r, 1),
                                             jax.random.key(3)))
    mod = attention.Attention(cfg)
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    r = np.random.default_rng(4)
    x = jnp.asarray(r.normal(size=(B, S + 1, cfg.d_model)), jnp.bfloat16)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1))
    cache_r = r_attn.KVCache(jnp.zeros((B, S + 1, 2, 32), jnp.bfloat16),
                             jnp.zeros((B, S + 1, 2, 32), jnp.bfloat16),
                             jnp.asarray(0, jnp.int32))
    want, cache_r = r_attn.attention(cfg_r, p, x[:, :S], jnp.asarray(pos[:, :S]),
                                     rules, cache=cache_r)
    cache = registry.make_cache(cfg, B, S + 1)[0]
    got, cache = mod(_t(x[:, :S]), torch.from_numpy(pos[:, :S].copy()),
                     cache=cache)
    _close(got, want)
    _close(cache.k, cache_r.k, 1e-2)
    assert cache.pos == S
    want, _ = r_attn.attention(cfg_r, p, x[:, S:], jnp.asarray(pos[:, S:]),
                               rules, cache=cache_r)
    got, cache = mod(_t(x[:, S:]), torch.from_numpy(pos[:, S:].copy()),
                     cache=cache)
    _close(got, want)
    assert cache.pos == S + 1


def test_mamba_block_prefill_and_decode_match_reference():
    cfg_r = r_smoke(r_get_arch("mamba2-780m"))
    cfg = smoke_config(get_arch("mamba2-780m"))
    rules = resolve(cfg_r, _mesh())
    p = _randomise(jax.tree.map(np.asarray, materialize(
        r_mamba.ssm_params(cfg_r), jax.random.key(5))), 6)
    p["dt_bias"] = p["dt_bias"] - 2.0          # dt ~ softplus(-2), realistic
    mod = mamba.Mamba(cfg)
    mod.load_state_dict({k: _t(v) for k, v in p.items()})
    r = np.random.default_rng(7)
    x = jnp.asarray(r.normal(size=(B, S + 1, cfg.d_model)), jnp.bfloat16)
    spec = r_mamba.init_ssm_cache_spec(cfg_r, B)
    cache_r = r_mamba.SSMCache(jnp.zeros(spec["conv"].shape, jnp.bfloat16),
                               jnp.zeros(spec["state"].shape, jnp.float32))
    jp = jax.tree.map(jnp.asarray, p)
    want, cache_r = r_mamba.mamba_block(cfg_r, jp, x[:, :S], rules,
                                        cache=cache_r)
    cache = registry.make_cache(cfg, B, S + 1)[0]
    got, cache = mod(_t(x[:, :S]), cache=cache)
    _close(got, want)
    _close(cache.state, cache_r.state)
    _close(cache.conv, cache_r.conv, 1e-2)
    want, cache_r = r_mamba.mamba_block(cfg_r, jp, x[:, S:], rules,
                                        cache=cache_r)
    got, cache = mod(_t(x[:, S:]), cache=cache)
    _close(got, want)
    _close(cache.state, cache_r.state)


# --------------------------------------------------------------------------- #
# whole models: prefill, decode, greedy serving

_REF = {}


def _reference(arch):
    """The reference's serving loop at smoke size: params (numpy), prompts,
    prefill logits, and per decode step the fed token and its logits."""
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
    _REF[arch] = (params, prompts, steps)
    return _REF[arch]


def _port_model(arch, params):
    cfg = smoke_config(get_arch(arch))
    return build_model(cfg, torch.device("cpu"),
                       state_dict=lm_params_from_arrays(cfg, params))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    params, prompts, steps = _reference(arch)
    mb, model = _port_model(arch, params)
    caches = registry.make_cache(mb.cfg, B, S + GEN)
    with torch.inference_mode():
        logits, caches = mb.prefill_fn(model, torch.from_numpy(prompts).long(),
                                       caches)
        _close(logits, steps[0][1], LOGIT_REL)
        for i, (fed, want) in enumerate(steps[1:]):
            logits, caches = mb.decode_fn(model, torch.tensor(fed).long(),
                                          S + i, caches)
            _close(logits, want, LOGIT_REL)
    assert logits.shape == (B, 1, mb.cfg.padded_vocab(1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_reference_greedy(arch, capsys):
    params, prompts, steps = _reference(arch)
    cfg = smoke_config(get_arch(arch))
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
            if top2[1] - top2[0] <= GAP:
                break                     # a close call: the rest may part
            assert got[row, t] == want[row, t], (row, t)
            checked += 1
    assert checked >= B                   # not vacuous: every first token


@pytest.mark.parametrize("arch", ARCHS + ["granite-8b", "internlm2-20b"])
def test_teacher_forced_decode_equals_full_prefill(arch):
    cfg = smoke_config(get_arch(arch))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        full, _ = mb.prefill_fn(model, toks, registry.make_cache(cfg, B, S))
        _, caches = mb.prefill_fn(model, toks[:, :-1],
                                  registry.make_cache(cfg, B, S))
        step, _ = mb.decode_fn(model, toks[:, -1:], S - 1, caches)
    assert float((full - step).abs().max()) < 1e-3


def test_serve_draws_the_same_tokens_from_a_seed():
    a = serve("mamba2-780m", gen_len=3, batch=2, prompt_len=20, seed=4,
              device="cpu")
    b = serve("mamba2-780m", gen_len=3, batch=2, prompt_len=20, seed=4,
              device="cpu")
    assert a.shape == (2, 3) and torch.equal(a, b)


def test_serve_cli_turns_smoke_off(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve_mod, "serve",
                        lambda arch, **kw: seen.update(arch=arch, **kw))
    serve_mod.main(["--arch", "llama3-8b", "--no-smoke", "--device", "cpu"])
    assert seen["smoke"] is False and seen["device"] == "cpu"
    serve_mod.main(["--arch", "llama3-8b"])
    assert seen["smoke"] is True and seen["device"] is None


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-3b-a800m",
                                  "qwen2-vl-7b", "whisper-large-v3",
                                  "llama4-scout-17b-a16e"])
def test_families_outside_the_slice_raise(arch):
    cfg = smoke_config(get_arch(arch))
    with pytest.raises(NotImplementedError, match="A11"):
        registry.bundle(cfg)
    with pytest.raises(NotImplementedError, match="A11"):
        serve(arch, device="cpu")


def test_convert_unstacks_superblocks_in_layer_order():
    cfg = dataclasses.replace(smoke_config(get_arch("llama3-8b")),
                              num_layers=3)
    layers = ({"norm1": np.arange(3 * 4, dtype=np.float32).reshape(3, 4)},)
    sd = lm_params_from_arrays(cfg, {"embed": np.zeros((2, 2), np.float32),
                                     "layers": layers})
    for i in range(3):
        np.testing.assert_array_equal(sd[f"layers.{i}.norm1"].numpy(),
                                      layers[0]["norm1"][i])
