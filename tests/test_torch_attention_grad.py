"""B7's gradients in the port against the JAX reference, on the CPU.

The reference has no backward kernel: its training attention is
``_dense_attn`` (``repro/models/attention.py``) with k and v widened to
the query heads by ``jnp.repeat`` (``_expand_kv``), differentiated by
``jax.vjp``.  The port's plain backward (``plain_backward``, which the
card's backward kernel is held against) and ``FlashAttentionFn`` with its
two launchers swapped for the plain versions (the CPU seam) must give
those gradients, and ``_lse`` (what the forward kernel writes for the
backward) must equal ``jax.nn.logsumexp`` of the reference's masked
scores.  The same inputs come from one numpy seed.

Tolerances, of each gradient's largest magnitude: f32 1e-5 (the
reference rounds the normalised p to the value type before p . v, the
port the unnormalised p; in f32 both roundings are exact, and the two
differ by the order of their f32 sums); bf16 2e-2 (each rounds p and the
products' operands at other places).  The log-sum-exp within 1e-5 in
both types: the scores are f32 sums of the same products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import NEG_INF, _dense_attn

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref

# (b, sq, sk, h, kv, d) and the mask of each case: causal by index, cross
# (non-causal, Sq != Sk, every k position valid), by position (repeated
# positions), GQA 4 at stablelm-3b's D 80, and positions that leave the
# first rows without a key (they average every key)
CASES = {"causal": (2, 37, 37, 4, 4, 32),
         "cross": (2, 19, 45, 4, 2, 16),
         "position": (2, 40, 40, 6, 2, 64),
         "gqa_d80": (1, 33, 33, 8, 2, 80),
         "no_key_rows": (2, 24, 24, 4, 2, 16)}
GRAD_REL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(case, seed=0):
    """numpy q, k, v, go (f32) and int32 positions (q_pos, k_pos) as the
    reference takes them, and the port's mask arguments."""
    b, sq, sk, h, kvh, d = CASES[case]
    r = np.random.default_rng(seed)
    q, go = (r.normal(size=(b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (r.normal(size=(b, sk, kvh, d)).astype(np.float32)
            for _ in range(2))
    if case == "position":
        qp = r.integers(0, sq // 2, (b, sq))
        kp = qp
    elif case == "no_key_rows":
        qp = np.broadcast_to(np.arange(sq), (b, sq))
        kp = qp + 5                  # rows 0-4 keep no key
    else:
        qp, kp = (np.broadcast_to(np.arange(n), (b, n)) for n in (sq, sk))
    qp, kp = (np.ascontiguousarray(p, np.int32) for p in (qp, kp))
    causal = case != "cross"
    by_pos = case in ("position", "no_key_rows")
    port = dict(causal=causal,
                q_pos=torch.from_numpy(qp) if by_pos else None,
                k_pos=torch.from_numpy(kp) if by_pos else None)
    return (q, k, v, go), (qp, kp), port


def _reference_grads(arrays, pos, causal, jdtype):
    q, k, v, go = (jnp.asarray(a, jdtype) for a in arrays)
    h = q.shape[2]
    qp, kp = (jnp.asarray(p) for p in pos)

    def attn(q, k, v):
        g = h // k.shape[2]
        return _dense_attn(q, jnp.repeat(k, g, axis=-2),
                           jnp.repeat(v, g, axis=-2), qp, kp, causal)
    _, vjp = jax.vjp(attn, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(go)]


def _close(got, want, rel):
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= rel * scale, (err, scale)


def _port_grads(how, arrays, port, tdtype, monkeypatch):
    q, k, v, go = (torch.from_numpy(a).to(tdtype) for a in arrays)
    if how == "plain_backward":
        # slices of one kv head of one row: the backward's loop runs
        monkeypatch.setattr(fa, "BACKWARD_SCORE_BYTES", 1)
        grads = fa.plain_backward(q, k, v, go, **port)
    else:
        # the Function with its launchers swapped for the plain versions
        def launch(q, k, v, causal, qp, kp, lse=None):
            if lse is not None:
                lse.copy_(fa._lse(q, k, causal, qp, kp))
            return fa_ref.attention_plain(q, k, v, causal=causal, q_pos=qp,
                                          k_pos=kp)

        def launch_backward(go, q, k, v, o, lse, causal, q_pos, k_pos):
            assert o.shape == q.shape and lse.shape == (q.shape[0],
                                                        q.shape[2],
                                                        q.shape[1])
            return fa.plain_backward(q, k, v, go, causal=causal,
                                     q_pos=q_pos, k_pos=k_pos)
        monkeypatch.setattr(fa, "_launch", launch)
        monkeypatch.setattr(fa, "_launch_backward", launch_backward)
        ins = [t.requires_grad_() for t in (q, k, v)]
        out = fa.FlashAttentionFn.apply(*ins, port["causal"], port["q_pos"],
                                        port["k_pos"])
        grads = torch.autograd.grad(out, ins, go)
    assert all(g.dtype == tdtype for g in grads)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("how", ["plain_backward", "function"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_attention_gradients_match_the_reference_vjp(case, dtype, how,
                                                     monkeypatch):
    """The port's plain backward, and the Function over the CPU seam, give
    ``jax.vjp`` of the reference's ``_dense_attn`` (k and v widened by
    ``jnp.repeat``) within ``GRAD_REL`` of each gradient's largest
    magnitude."""
    arrays, pos, port = _inputs(case, seed=len(case))
    tdtype, jdtype = DTYPES[dtype]
    want = _reference_grads(arrays, pos, port["causal"], jdtype)
    got = _port_grads(how, arrays, port, tdtype, monkeypatch)
    _close(got, want, GRAD_REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_lse_matches_the_reference_logsumexp(case, dtype):
    """``_lse`` (B, H, Sq) f32 equals ``jax.nn.logsumexp`` of the
    reference's scaled scores masked to ``NEG_INF``: also a row without a
    key, where both round to the mask."""
    (q, k, _, _), (qp, kp), port = _inputs(case, seed=7)
    tdtype, jdtype = DTYPES[dtype]
    g = q.shape[2] // k.shape[2]
    jq, jk = jnp.asarray(q, jdtype), jnp.repeat(jnp.asarray(k, jdtype), g,
                                                axis=-2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jq, jk,
                   preferred_element_type=jnp.float32) * q.shape[-1] ** -0.5
    if port["causal"]:
        s = jnp.where(jnp.asarray(qp)[:, None, :, None]
                      >= jnp.asarray(kp)[:, None, None, :], s, NEG_INF)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = fa._lse(torch.from_numpy(q).to(tdtype),
                  torch.from_numpy(k).to(tdtype), port["causal"],
                  port["q_pos"], port["k_pos"]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=LSE_TOL, atol=LSE_TOL)
    if case == "no_key_rows":
        assert (got[:, :, :5] == np.float32(NEG_INF)).all()
