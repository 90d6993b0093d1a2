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


# ---- the bf16 backward's tile lists under the position mask ---------------- #

def _vlm_t(s, patches=256, side=16):
    """Qwen2-VL's temporal positions: ``patches`` patches at t = 0, then
    the text rising from ``side``."""
    i = np.arange(s)
    return np.where(i < patches, 0, side + i - patches)


def _route_tiles(dtype, d):
    """The (q tile, kv tile) of the backward's dK / dV blocks on the route
    of (dtype, d): its q step past its kv tile."""
    rt = fa.route(dtype, d)
    return fa.backward_steps(dtype, d)[0], fa.BACKWARD_BLOCKS[rt][1]


# the f32 route's tiles: 64-row q steps up to D 64, 32-row ones above
F32_TILES = {"f32": 64, "f32_wide": 128}


def _tile_case(case):
    """numpy q, k, v, go (f32), int32 positions (q_pos, k_pos) and the tile
    sizes (q_tile, kv_tile) of a case: the ``CASES`` positions at small
    tiles, Qwen2-VL's layout at the kernel's tiles, and positions that leave
    the whole second 64-row q tile without a key while no kept pair reaches
    the last kv tile; a ``_f32`` or ``_f32_wide`` suffix takes the f32
    route's tiles (at D 64 and at D 128) for the bf16 route's."""
    base, _, route = case.partition("_f32")
    if route or case.endswith("_f32"):
        data, pos, _ = _tile_case(base)
        return data, pos, _route_tiles(torch.float32,
                                       F32_TILES["f32" + route])
    r = np.random.default_rng(len(case))
    if case in ("position", "no_key_rows"):
        (q, k, v, go), (qp, kp), _ = _inputs(case, seed=len(case))
        return (q, k, v, go), (qp, kp), (8, 16)
    b, s, h, kvh, d = 1, 640, 4, 2, 16
    qp = np.broadcast_to(_vlm_t(s, patches=128), (b, s)).copy()
    kp = qp.copy()
    if case == "dead_tile":
        qp[:, 64:128] = -1                  # below every k position
        kp[:, 512:] = 10 ** 6               # above every q position
    q, go = (r.normal(size=(b, s, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (r.normal(size=(b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    return (q, k, v, go), (qp.astype(np.int32), kp.astype(np.int32)), \
        _route_tiles(torch.bfloat16, d)


def _backward_over_tiles(q, k, v, go, q_pos, k_pos, visits, q_tile,
                         kv_tile):
    """(dq, dk, dv) f32 by the backward kernel's formulas (P from the
    masked softmax, a row with no key averaging every key; dS = P o (dP -
    Delta), 0 off the mask), dK and dV summed over the (q tile, kv tile)
    pairs ``visits`` lists only, dQ over every pair."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    qg = q.reshape(b, sq, kvh, g, d)
    dog = go.reshape(b, sq, kvh, g, d)
    keep = q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    p = torch.softmax(torch.where(keep, s, fa_ref.NEG_INF), -1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v)
    delta = (dog.permute(0, 2, 3, 1, 4) * o).sum(-1, keepdim=True)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v)
    ds = torch.where(keep, p * (dp - delta), 0.0)
    pair = visits[:, torch.arange(sk) // kv_tile][
        :, :, torch.arange(sq) // q_tile].transpose(1, 2)   # (B, Sq, Sk)
    pair = pair[:, None, None]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p * pair, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds * pair, qg) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k).reshape(b, sq, h, d) * scale
    return dq, dk, dv


@pytest.mark.parametrize("case", ["position", "no_key_rows", "qwen2_vl",
                                  "dead_tile", "qwen2_vl_f32",
                                  "dead_tile_f32", "qwen2_vl_f32_wide",
                                  "dead_tile_f32_wide"])
def test_kv_tile_visits_keep_the_whole_backward(case):
    """The backward restricted to the (q tile, kv tile) pairs that
    ``ref.kv_tile_visits`` lists equals ``plain_backward`` (autograd of the
    plain attention) within the f32 tolerance: no pair it leaves out adds
    to dK or dV, also where a row keeps no key (it adds 1 / Sk . dO to every
    kv row's dV) and under Qwen2-VL's patches, where it leaves out tiles
    (random repeated positions reach every tile); at the bf16 route's
    tiles and at the f32 route's (64-row kv tiles, 64- or 32-row q
    steps)."""
    (q, k, v, go), (qp, kp), (qt, kt) = _tile_case(case)
    q, k, v, go = (torch.from_numpy(a) for a in (q, k, v, go))
    qp, kp = torch.from_numpy(qp), torch.from_numpy(kp)
    visits = fa_ref.kv_tile_visits(qp, kp, q_tile=qt, kv_tile=kt)
    assert visits.shape == (q.shape[0], -(-k.shape[1] // kt),
                            -(-q.shape[1] // qt))
    if not case.startswith(("position", "no_key_rows")):
        assert not bool(visits.all())      # some pairs left out
    got = _backward_over_tiles(q, k, v, go, qp, kp, visits, qt, kt)
    want = fa.plain_backward(q, k, v, go, causal=True, q_pos=qp, k_pos=kp)
    _close([g.numpy() for g in got], [w.numpy() for w in want],
           GRAD_REL["float32"])


def _dead_tile_check(case):
    """Where a whole 64-row q block keeps no key and no kept pair reaches
    the last kv tile, that kv tile visits the dead rows' q tiles alone,
    every kv tile visits them, and leaving them out of the lists changes
    dV: the last kv tile's dV would be 0 where it is 1 / Sk of the dead
    rows' dO summed."""
    (q, k, v, go), (qp, kp), (qt, kt) = _tile_case(case)
    q, k, v, go = (torch.from_numpy(a) for a in (q, k, v, go))
    qp, kp = (torch.from_numpy(qp), torch.from_numpy(kp))
    visits = fa_ref.kv_tile_visits(qp, kp, q_tile=qt, kv_tile=kt)
    dead_tiles = list(range(64 // qt, 128 // qt))     # rows 64 .. 127
    assert visits[0, -1].nonzero().flatten().tolist() == dead_tiles
    assert bool(visits[0, :, dead_tiles].all())
    full = _backward_over_tiles(q, k, v, go, qp, kp, visits, qt, kt)
    short = visits.clone()
    short[:, :, dead_tiles] = False
    cut = _backward_over_tiles(q, k, v, go, qp, kp, short, qt, kt)
    dv, dv_cut = full[2], cut[2]
    assert float(dv_cut[:, 512:].abs().max()) == 0.0
    sk, g = k.shape[1], q.shape[2] // k.shape[2]
    dead_share = go[:, 64:128].reshape(1, 64, k.shape[2], g, -1).sum(
        (1, 3)) / sk
    torch.testing.assert_close(dv[:, 512:], dead_share[:, None].expand_as(
        dv[:, 512:]), rtol=1e-5, atol=1e-6)
    assert float((dv - dv_cut).abs().max()) > 1e-3 * float(dv.abs().max())


def test_a_kv_tile_no_pair_reaches_still_visits_a_dead_row_tile():
    """At the bf16 route's tiles (``_dead_tile_check``): the last 128-row
    kv tile visits the dead second 64-row q tile alone."""
    _dead_tile_check("dead_tile")


@pytest.mark.parametrize("case", ["dead_tile_f32", "dead_tile_f32_wide"])
def test_a_kv_tile_no_pair_reaches_still_visits_a_dead_row_tile_f32(case):
    """At the f32 route's tiles (``_dead_tile_check``): the last two 64-row
    kv tiles each visit the dead rows' q tiles alone (one 64-row q step at
    D 64, two 32-row steps at D 128)."""
    _dead_tile_check(case)


@pytest.mark.parametrize("d,want", [(16, (64, 128)), (64, (64, 128)),
                                    (80, (64, 128)), (96, (64, 64)),
                                    (128, (64, 64))])
def test_backward_steps_follow_the_head_dim(d, want):
    """The rows a step of the bf16 backward streams: 64 q rows past a dK /
    dV block's kv tile, and past a dQ block's q tile 128 kv rows up to D
    80, 64 above (what fits a consumer's registers); the f32 route's 64
    and 64 up to D 64, 32 and 32 above (two blocks an SM)."""
    assert fa.backward_steps(torch.bfloat16, d) == want
    assert fa.backward_steps(torch.float32, d) == \
        ((64, 64) if d <= 64 else (32, 32))
