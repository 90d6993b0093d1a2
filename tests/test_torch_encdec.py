"""The port's encoder-decoder (whisper-large-v3 at smoke size: 2 encoder
and 4 decoder layers, d_model 128) against the JAX reference, on the CPU.

As in ``test_torch_lm.py``: the reference runs on an Auto-axis mesh,
unrolled (``exact_counts=True``), its params (1-D ones drawn at scale
0.1 so the LayerNorms' (1 + scale) is exercised) go through
``convert.lm_params_from_arrays`` into the port, and the same numpy
prompts and frame embeddings go to both, the frames longer than the
prompt.  Both compute in bf16 with f32 statistics but round at other
places (the port's attention rounds the unnormalised p like the flash
kernel), so bf16 tensors agree within ``REL`` (2%) of their largest
magnitude and logits within ``LOGIT_REL`` of theirs.  Greedy tokens
equal the reference's wherever its top-2 logit gap exceeds twice the
logit tolerance (``_gap``); past the first closer call the two may part.
Inside the port, a teacher-forced prefill and one decode step equal the
full prefill within 1e-3, as the reference pins for itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig
from repro.configs import get_arch as r_get_arch, smoke_config as r_smoke
from repro.distributed.sharding import resolve
from repro.models import encdec as r_encdec
from repro.models import registry as r_registry

from repro_torch.configs import get_arch, smoke_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import build_model, draw_frames, generate, serve
from repro_torch.models import attention, encdec, registry

ARCH = "whisper-large-v3"
REL = 2e-2
LOGIT_REL = 2e-2
S, B, GEN = 40, 2, 6
FRAMES = 100                          # not the prompt's length


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _gap(logits) -> float:
    return 2 * LOGIT_REL * float(np.abs(logits).max())


def _randomise(tree, seed):
    r = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.ndim == 1:
            return (0.1 * r.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


_REF = {}


def _reference():
    """The reference at smoke size, unrolled: its config, rules, params
    (numpy), prompts, frames (bf16 values as f32 numpy), the encoder
    output, prefill logits, and per decode step the fed token and its
    logits."""
    if _REF:
        return _REF["all"]
    cfg = r_smoke(r_get_arch(ARCH))
    shape = ShapeConfig("serve", S + GEN, B, "prefill")
    rules = resolve(cfg, _mesh(), shape)
    mb = r_registry.bundle(cfg)
    params = _randomise(jax.tree.map(
        np.asarray, mb.materialize_params(jax.random.key(0), tp=1)), 1)
    r = np.random.default_rng(2)
    prompts = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = np.asarray(jnp.asarray(
        r.normal(size=(B, FRAMES, cfg.d_model)), jnp.bfloat16), np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jframes = jnp.asarray(frames, jnp.bfloat16)
    enc = r_encdec.encode(cfg, jp, jframes, rules, remat=False,
                          exact_counts=True)
    caches = r_registry.make_cache(cfg, shape, rules)
    logits, caches = r_encdec.prefill_fn(
        cfg, jp, {"tokens": jnp.asarray(prompts), "frames": jframes}, caches,
        rules, exact_counts=True)
    steps = [(None, np.asarray(logits))]
    tok = jnp.argmax(logits[..., :cfg.vocab_size], -1).astype(jnp.int32)
    for i in range(GEN - 1):
        fed = tok
        logits, caches = r_encdec.decode_fn(
            cfg, jp, {"tokens": fed, "pos": jnp.asarray(S + i, jnp.int32)},
            caches, rules, exact_counts=True)
        tok = jnp.argmax(logits[..., :cfg.vocab_size], -1).astype(jnp.int32)
        steps.append((np.asarray(fed), np.asarray(logits)))
    _REF["all"] = (cfg, rules, params, prompts, frames,
                   np.asarray(enc, np.float32), steps)
    return _REF["all"]


def _port_model(params):
    cfg = smoke_config(get_arch(ARCH))
    return build_model(cfg, torch.device("cpu"),
                       state_dict=lm_params_from_arrays(cfg, params))


@pytest.mark.parametrize("s,d,offset", [(64, 128, 0), (7, 32, 37),
                                        (1500, 1280, 0), (1, 1280, 447)])
def test_sinusoid_matches_reference(s, d, offset):
    """Within two f32 ulps of the largest angle: XLA's and torch's exp give
    the frequencies an ulp apart, which an angle of position x frequency
    carries into its sine and cosine."""
    want = np.asarray(r_encdec._sinusoid(s, d, offset))
    np.testing.assert_allclose(encdec.sinusoid(s, d, offset).numpy(), want,
                               rtol=0, atol=2 * np.spacing(np.float32(
                                   s + offset)))


def test_encoder_matches_reference():
    _, _, params, _, frames, enc, _ = _reference()
    _, model = _port_model(params)
    with torch.inference_mode():
        got = encdec.encode(model, torch.from_numpy(frames).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, enc)


def test_cross_kv_matches_reference():
    cfg_r, rules, params, _, frames, enc, _ = _reference()
    _, model = _port_model(params)
    want = r_encdec._cross_kv(cfg_r, jax.tree.map(jnp.asarray, params),
                              jnp.asarray(enc, jnp.bfloat16), rules)
    with torch.inference_mode():
        got = encdec.cross_kv(model, torch.from_numpy(enc).bfloat16())
    for n in ("k", "v"):
        assert got[n].shape == want[n].shape
        assert got[n].dtype == torch.bfloat16
        _close(got[n], want[n])


def test_prefill_and_decode_logits_match_reference():
    _, _, params, prompts, frames, _, steps = _reference()
    mb, model = _port_model(params)
    caches = registry.make_cache(mb.cfg, B, S + GEN, enc_len=FRAMES)
    with torch.inference_mode():
        logits, caches = mb.prefill_fn(
            model, torch.from_numpy(prompts).long(), caches,
            frames=torch.from_numpy(frames).bfloat16())
        assert caches["cross"]["k"].shape == (mb.cfg.num_layers, B, FRAMES,
                                              4, 32)
        _close(logits, steps[0][1], LOGIT_REL)
        for i, (fed, want) in enumerate(steps[1:]):
            logits, caches = mb.decode_fn(model, torch.tensor(fed).long(),
                                          S + i, caches)
            _close(logits, want, LOGIT_REL)
    assert logits.shape == (B, 1, mb.cfg.padded_vocab(1))


def test_prefill_makes_a_cross_cache_of_the_frames_length():
    """As in the reference, the cross cache that prefill returns has the
    frames' length, whatever the cache it was given holds; one made for
    the frames is written in place."""
    _, _, params, prompts, frames, _, steps = _reference()
    mb, model = _port_model(params)
    toks = torch.from_numpy(prompts).long()
    fr = torch.from_numpy(frames).bfloat16()
    with torch.inference_mode():
        given = registry.make_cache(mb.cfg, B, S + GEN)      # 64 frames
        assert given["cross"]["k"].shape[2] == mb.cfg.n_audio_frames != FRAMES
        lg, out = mb.prefill_fn(model, toks, given, frames=fr)
        assert out["cross"]["k"].shape[2] == FRAMES
        fitted = registry.make_cache(mb.cfg, B, S + GEN, enc_len=FRAMES)
        lg2, out2 = mb.prefill_fn(model, toks, fitted, frames=fr)
    assert out2["cross"]["k"] is fitted["cross"]["k"]
    assert torch.equal(lg, lg2)
    _close(lg, steps[0][1], LOGIT_REL)


def test_serve_tokens_match_reference_greedy(capsys):
    _, _, params, prompts, frames, _, steps = _reference()
    cfg = smoke_config(get_arch(ARCH))
    got = serve(ARCH, smoke=True, gen_len=GEN, device="cpu",
                state_dict=lm_params_from_arrays(cfg, params),
                prompts=prompts, frames=torch.from_numpy(frames).bfloat16()
                ).numpy()
    assert got.shape == (B, GEN)
    assert f"{FRAMES} frames" in capsys.readouterr().out
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
    assert checked >= B                   # not vacuous: every first token


def test_teacher_forced_decode_equals_full_prefill():
    cfg = smoke_config(get_arch(ARCH))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    frames = draw_frames(cfg, B, 3, torch.device("cpu"))
    with torch.inference_mode():
        full, _ = mb.prefill_fn(model, toks, registry.make_cache(cfg, B, S),
                                frames=frames)
        _, caches = mb.prefill_fn(model, toks[:, :-1],
                                  registry.make_cache(cfg, B, S),
                                  frames=frames)
        step, _ = mb.decode_fn(model, toks[:, -1:], S - 1, caches)
    assert float((full - step).abs().max()) < 1e-3


def test_prefill_attends_once_per_layer_by_kind(monkeypatch):
    """A prefill calls the flash-attention entry once per encoder layer
    (non-causal, square), once per decoder layer causally over the prompt
    and once per decoder layer across to the frames; a decode step calls
    it no time."""
    cfg = smoke_config(get_arch(ARCH))
    mb, model = build_model(cfg, torch.device("cpu"), seed=0)
    seen = []
    plain = fa_ops.attend

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("causal", True),
                     kw.get("q_pos")))
        return plain(q, k, v, **kw)
    monkeypatch.setattr(attention, "attend", spy)
    frames = draw_frames(cfg, B, 0, torch.device("cpu"))
    toks = torch.zeros(B, S, dtype=torch.long)
    with torch.inference_mode():
        _, caches = mb.prefill_fn(model, toks, registry.make_cache(
            cfg, B, S + 1), frames=frames)
        n = len(seen)
        mb.decode_fn(model, toks[:, :1], S, caches)
    f = cfg.n_audio_frames
    assert sorted(seen[:n], key=str) == sorted(
        [(f, f, False, None)] * cfg.n_encoder_layers
        + [(S, S, True, None)] * cfg.num_layers
        + [(S, f, False, None)] * cfg.num_layers, key=str)
    assert len(seen) == n


def test_convert_carries_the_encdec_tree():
    cfg_r = r_smoke(r_get_arch(ARCH))
    cfg = smoke_config(get_arch(ARCH))
    tree = _randomise(jax.tree.map(np.asarray, r_registry.bundle(
        cfg_r).materialize_params(jax.random.key(0), tp=1)), 5)
    sd = lm_params_from_arrays(cfg, tree)
    model = encdec.EncoderDecoder(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)              # strict: every key, every shape
    assert len(model.encoder) == 2 and len(model.decoder) == 4
    for i in range(4):
        np.testing.assert_array_equal(
            model.decoder[i].cross_attn.wk.float().numpy(),
            np.asarray(tree["decoder"]["cross_attn"]["wk"][i], np.float32))
        np.testing.assert_array_equal(
            model.decoder[i].norm_x.float().numpy(),
            np.asarray(tree["decoder"]["norm_x"][i], np.float32))
    for i in range(2):
        np.testing.assert_array_equal(
            model.encoder[i].ffn.w_up.float().numpy(),
            np.asarray(tree["encoder"]["ffn"]["w_up"][i], np.float32))
    for name in ("embed", "unembed", "enc_norm", "final_norm"):
        assert sd[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(sd[name].float().numpy(),
                                      np.asarray(tree[name], np.float32))


def test_cache_specs_follow_the_reference():
    cfg_r = r_smoke(r_get_arch(ARCH))
    cfg = smoke_config(get_arch(ARCH))
    want = r_encdec.cache_specs(cfg_r, B, S, 1, enc_len=FRAMES)
    got = encdec.cache_specs(cfg, B, S, FRAMES)
    assert len(got["self"]) == cfg.num_layers
    for n in ("k", "v"):
        assert (cfg.num_layers,) + got["self"][0][n][0] == \
            tuple(want["self"][n].shape)
        assert got["cross"][n][0] == tuple(want["cross"][n].shape)


def test_generate_with_frames_is_deterministic_and_needs_them():
    cfg = smoke_config(get_arch(ARCH))
    mb, model = build_model(cfg, torch.device("cpu"), seed=2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20),
                            generator=torch.Generator().manual_seed(3))
    frames = draw_frames(cfg, 2, 2, torch.device("cpu"))
    assert frames.shape == (2, cfg.n_audio_frames, cfg.d_model)
    a = generate(mb, model, prompts, 4, frames=frames)
    b = generate(mb, model, prompts, 4, frames=frames)
    assert a.shape == (2, 4) and torch.equal(a, b)
    with pytest.raises(TypeError, match="frames"):
        generate(mb, model, prompts, 4)


def test_serve_cli_serves_whisper_on_the_cpu(capsys):
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "[serve] whisper-large-v3 on cpu: 4x24 prompt, 64 frames -> " \
           "4x3 tokens" in out
