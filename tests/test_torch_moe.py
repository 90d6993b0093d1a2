"""The port's MoE layer (``repro_torch.models.moe``) and M-RoPE against
the JAX reference (``moe_apply``, ``capacity``, ``apply_rope``), on the
CPU.

The same numpy params and inputs go through both.  The routing rule:
both paths compute the router logits in f32 from the same x but sum in
another order, so a token whose k-th and (k+1)-th probabilities lie
within ``MARGIN`` of each other may take another expert on the other
path, and a changed assignment moves the positions of every later
assignment to its experts in its row (dispatch is per batch row).  So
the expert ids (as a set per token) must equal the reference's wherever
its boundary gap exceeds ``MARGIN``, and on every row whose tokens all
clear it the keep mask and the positions in expert must be bit-identical
and y must agree: within ``F32_TOL`` of its largest magnitude in f32, and
``BF16_TOL`` in bf16 (the expert products and the combine round in bf16
on both paths, in another order).  At least one row qualifies in every
case; the number of rows that did not is printed.  The aux loss (f32 on
both paths) agrees within ``AUX_TOL`` relative, plus the most that one
changed assignment can move it for each token under the margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch, smoke_config as r_smoke
from repro.distributed.sharding import resolve
from repro.models import common as r_common
from repro.models import moe as r_moe
from repro.models.common import materialize

from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import common, moe

MARGIN = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
AUX_TOL = 1e-5
B, S = 4, 64

# smoke size (4 experts, top 2); granite's 40 experts and top 8 at the
# smoke widths; llama4's top 1 with a shared expert
SETTINGS = {
    "smoke": ("granite-moe-3b-a800m", {}),
    "granite-40e-top8": ("granite-moe-3b-a800m",
                         {"n_experts": 40, "top_k": 8}),
    "llama4-top1-shared": ("llama4-scout-17b-a16e", {}),
}


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(1, -1),
                             ("data", "model"))


def _cfgs(setting):
    arch, changes = SETTINGS[setting]
    return (dataclasses.replace(r_smoke(r_get_arch(arch)), **changes),
            dataclasses.replace(smoke_config(get_arch(arch)), **changes))


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def reference_routing(cfg_r, router, x):
    """The reference's routing of x, by ``moe_apply``'s own ops: f32
    probabilities, the top-k ids, and each token's boundary gap (its k-th
    less its (k+1)-th probability)."""
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      router), axis=-1)
    _, ids = jax.lax.top_k(probs, cfg_r.top_k)
    top = np.sort(np.asarray(probs), -1)[..., ::-1]
    return np.asarray(probs), np.asarray(ids), \
        top[..., cfg_r.top_k - 1] - top[..., cfg_r.top_k]


def reference_positions(ids: np.ndarray) -> np.ndarray:
    """Rank of each assignment among its row's assignments to the same
    expert, in flattened (s, k) order (numpy, a loop over the row)."""
    b, s, k = ids.shape
    pos = np.zeros((b, s * k), np.int64)
    for row in range(b):
        seen = {}
        for j, e in enumerate(ids[row].reshape(-1)):
            pos[row, j] = seen.get(e, 0)
            seen[e] = pos[row, j] + 1
    return pos.reshape(b, s, k)


def _by_id(ids, *others):
    """Sort each token's k ids ascending and carry the other (B, S, k)
    arrays along, so equal sets compare equal whatever their order."""
    order = np.argsort(ids, -1, kind="stable")
    return [np.take_along_axis(a, order, -1) for a in (ids, *others)]


def _layer(setting, dtype, seed=0):
    cfg_r, cfg = _cfgs(setting)
    p = jax.tree.map(np.asarray, materialize(r_moe.moe_params(cfg_r, 1),
                                             jax.random.key(seed)))
    mod = moe.MoE(cfg)
    mod.load_state_dict({k: _t(v) for k, v in _flat(p)})
    r = np.random.default_rng(seed + 1)
    x = jnp.asarray(r.normal(size=(B, S, cfg.d_model)), dtype)
    if dtype == jnp.float32:
        p = jax.tree.map(lambda a: a.astype(np.float32), p)
        mod.float()
    return cfg_r, cfg, p, mod, x


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_layer_matches_moe_apply(setting, dtype):
    cfg_r, cfg, p, mod, x = _layer(setting, dtype)
    rules = resolve(cfg_r, _mesh())
    jp = jax.tree.map(jnp.asarray, p)
    y_r, aux_r = r_moe.moe_apply(cfg_r, jp, x, rules)
    probs_r, ids_r, gap = reference_routing(cfg_r, jp["router"], x)
    c = r_moe.capacity(cfg_r, S)
    pos_r = reference_positions(ids_r)
    xt = _t(x)
    with torch.inference_mode():
        probs, gate, ids = mod.route(xt)
        pos = moe.positions_in_expert(ids)
        y = mod(xt)
        aux = moe.aux_loss(probs, ids)
    assert c == moe.capacity(cfg, S)
    ids, pos = ids.numpy(), pos.numpy()
    keep, keep_r = pos < c, pos_r < c
    # the smoke router spreads 2 x 64 assignments over 4 experts of 40
    # slots evenly enough to drop none; the other two settings drop
    assert setting == "smoke" or not keep_r.all()
    clear = gap > MARGIN
    ids_s, = _by_id(ids)
    ids_rs, = _by_id(ids_r)
    np.testing.assert_array_equal(ids_s[clear], ids_rs[clear])
    rows = [row for row in range(B) if clear[row].all()]
    print(f"{setting} {np.dtype(dtype).name}: {B - len(rows)} of {B} rows "
          f"have a token within {MARGIN} of its routing boundary")
    assert rows, "no row clears the routing margin"
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    y, y_r = y.float().numpy(), np.asarray(y_r, np.float32)
    for row in rows:
        ids_s, pos_s, keep_s = _by_id(ids[row], pos[row], keep[row])
        ids_rs, pos_rs, keep_rs = _by_id(ids_r[row], pos_r[row], keep_r[row])
        np.testing.assert_array_equal(ids_s, ids_rs)
        np.testing.assert_array_equal(pos_s, pos_rs)
        np.testing.assert_array_equal(keep_s, keep_rs)
        err = np.abs(y[row] - y_r[row]).max()
        assert err <= tol * np.abs(y_r[row]).max(), (row, err)
    n_under = int((~clear).sum())
    moved = 2 * cfg.n_experts * float(probs_r.mean((0, 1)).max()) / (B * S)
    assert abs(float(aux) - float(aux_r)) <= \
        AUX_TOL * abs(float(aux_r)) + n_under * moved
    np.testing.assert_allclose(probs.numpy(), probs_r, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_layer_without_drops_matches_moe_apply(setting):
    """At capacity factor E / k every assignment keeps its slot (c >= S)
    on both paths."""
    cfg_r, cfg, p, mod, x = _layer(setting, jnp.float32, seed=5)
    cf = cfg.n_experts / cfg.top_k
    assert moe.capacity(cfg, S, cf) >= S
    rules = resolve(cfg_r, _mesh())
    jp = jax.tree.map(jnp.asarray, p)
    y_r, aux_r = r_moe.moe_apply(cfg_r, jp, x, rules, capacity_factor=cf)
    _, ids_r, gap = reference_routing(cfg_r, jp["router"], x)
    with torch.inference_mode():
        y = mod(_t(x), capacity_factor=cf)
        probs, _, ids = mod.route(_t(x))
        aux = moe.aux_loss(probs, ids)
    rows = [row for row in range(B) if (gap[row] > MARGIN).all()]
    assert rows
    y, y_r = y.numpy(), np.asarray(y_r)
    for row in rows:
        err = np.abs(y[row] - y_r[row]).max()
        assert err <= F32_TOL * np.abs(y_r[row]).max(), (row, err)
    if len(rows) == B:
        assert abs(float(aux) - float(aux_r)) <= AUX_TOL * float(aux_r)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "jamba-v0.1-52b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_capacity_matches_reference(arch, smoke):
    cfg_r, cfg = r_get_arch(arch), get_arch(arch)
    if smoke:
        cfg_r, cfg = r_smoke(cfg_r), smoke_config(cfg)
    for seq in (1, 2, 7, 150, 512, 2000, 4096):
        for cf in (None, 0.5, 1.0, 2.0, cfg.n_experts / cfg.top_k):
            assert moe.capacity(cfg, seq, cf) == \
                r_moe.capacity(cfg_r, seq, cf), (seq, cf)
    assert moe.capacity(cfg, 1) == 1          # a decode step never drops


def test_positions_in_expert_is_the_rank_in_flattened_order():
    r = np.random.default_rng(3)
    ids = np.stack([np.stack([r.choice(6, 3, replace=False)
                              for _ in range(50)]) for _ in range(3)])
    got = moe.positions_in_expert(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, reference_positions(ids))


def test_moe_drops_the_highest_ranks_first():
    """A dropped assignment contributes nothing: with capacity 1 only each
    expert's first assignment in a row survives, so y equals the sum over
    the kept (token, expert) pairs computed one by one."""
    _, cfg, _, mod, x = _layer("smoke", jnp.float32, seed=9)
    xt = _t(x)[:1, :6]
    cf = cfg.n_experts / (6 * cfg.top_k)          # c = 1 at six tokens
    assert moe.capacity(cfg, 6, cf) == 1
    with torch.inference_mode():
        y = mod(xt, capacity_factor=cf)
        _, gate, ids = mod.route(xt)
        pos = moe.positions_in_expert(ids)
        want = torch.zeros_like(y)
        for t in range(6):
            for j in range(cfg.top_k):
                if pos[0, t, j] == 0:
                    e = int(ids[0, t, j])
                    gu = xt[0, t] @ mod.w_in[e].reshape(cfg.d_model, -1)
                    g, u = gu.view(2, -1)
                    want[0, t] += gate[0, t, j] * (
                        (torch.nn.functional.silu(g) * u) @ mod.w_down[e])
    assert bool((pos >= 1).any())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# M-RoPE


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_mrope_matches_reference_with_distinct_t_h_w(sections):
    r = np.random.default_rng(4)
    d = 2 * sum(sections)
    x = r.normal(size=(2, 40, 3, d)).astype(np.float32)
    t = np.arange(40) + 100
    pos = np.stack([np.broadcast_to(t, (2, 40)),
                    r.integers(0, 64, (2, 40)),
                    r.integers(0, 4096, (2, 40))], -1).astype(np.int32)
    assert len({tuple(pos[..., i].ravel()) for i in range(3)}) == 3
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, 1.0,
                               sections)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            1.0, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # each section reads its own component: another mapping differs
    swapped = common.apply_rope(torch.from_numpy(x),
                                torch.from_numpy(pos[..., [0, 2, 1]].copy()),
                                1e6, 1.0, sections)
    assert float((swapped - got).abs().max()) > 1e-2


def test_rope_takes_component_0_of_3d_positions_without_sections():
    r = np.random.default_rng(6)
    x = r.normal(size=(2, 16, 2, 32)).astype(np.float32)
    pos = r.integers(0, 500, (2, 16, 3)).astype(np.int32)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_mrope_refuses_2d_positions_and_wrong_sections():
    x = torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(x, torch.zeros(1, 4, dtype=torch.long), 1e4,
                          mrope_sections=(4, 6, 6))
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(x, torch.zeros(1, 4, 3, dtype=torch.long), 1e4,
                          mrope_sections=(4, 4, 4))
