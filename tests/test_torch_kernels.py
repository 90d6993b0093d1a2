"""The port's kernel modules against the reference's Pallas kernels, on
the CPU.

The reference side runs each Pallas kernel in interpret mode, as the
reference's own kernel tests do; the port's wrappers take their plain
PyTorch versions because the tensors lie on the CPU.  Inputs are made
with numpy from a seed and handed to both; every integer output must be
bit-identical.  The float kernels sum in other orders: flash attention
(B7) agrees within 2e-5 in float32 and 2e-2 in bfloat16 (the reference's
own sweep and tolerances), the SSD chunk scan (B8) within rtol=atol=1e-4
in float32, against both ``ssd_pallas`` and the sequential recurrence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as r_fa_ops
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.join import ref as r_join_ref
from repro.kernels.join.join import (
    probe_counts_pallas, probe_multi_pallas, probe_pallas,
)
from repro.kernels.join.ops import hash_join as r_hash_join
from repro.kernels.join.ops import materialize as r_materialize
from repro.kernels.selection import ops as r_sel_ops
from repro.kernels.selection.selection import select_pallas
from repro.kernels.ssd.ref import ssd_naive
from repro.kernels.ssd.ssd import ssd_pallas

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.join.ops import MAX_DROPPED, hash_join, materialize
from repro_torch.kernels.selection import ops as sel_ops
from repro_torch.kernels.selection import ref as sel_ref
from repro_torch.kernels.selection import selection
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd.ops import ssd


def _eq(port, reference):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(reference))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


# ---- B1: range selection --------------------------------------------------- #

@pytest.mark.parametrize("n,block,lo,hi", [(2048, 256, -100, 250),
                                           (8192, 1024, 0, 0),
                                           (8192, 8192, 500, -500),
                                           (4096, 512, -2000, 2000)])
def test_select_matches_select_pallas(n, block, lo, hi):
    x = np.random.default_rng(n + block).integers(-1000, 1000, n)
    idx_r, cnt_r = select_pallas(jnp.asarray(x, jnp.int32), lo, hi,
                                 block=block, interpret=True)
    before = dict(_build.LAUNCHES)
    idx, cnt = selection.select(_t(x), lo, hi, block=block)
    assert _build.LAUNCHES == before          # CPU tensors: no launch
    _eq(idx, idx_r)
    _eq(cnt, cnt_r)
    idx_o, cnt_o = sel_ops.select(_t(x), lo, hi, block=block)
    _eq(idx_o, idx_r)
    _eq(cnt_o, cnt_r)


@pytest.mark.parametrize("n", [0, 1, 1000, 4097])
def test_select_ragged_lengths_match_reference_oracle(n):
    """Lengths that no block tiles: the reference kernel refuses them, so
    the port is held to the reference's dense oracle and its compaction."""
    x = np.random.default_rng(n).integers(0, 100, n).astype(np.int32)
    idx, cnt = selection.select(_t(x), 20, 60, block=1024)
    idx_r, total_r = r_sel_ops.ref.select_indices(jnp.asarray(x), 20, 60)
    _eq(idx, idx_r)
    assert int(cnt.sum()) == int(total_r)
    assert cnt.shape[0] == -(-n // 1024)
    comp, total = sel_ops.compact(idx, cnt)
    comp_r, total_r2 = r_sel_ops.compact(idx_r, jnp.asarray([total_r]))
    _eq(comp, comp_r)
    assert int(total) == int(total_r2)
    assert int(sel_ops.select_count(_t(x), 20, 60, block=128)) == \
        int(total_r)


def test_select_bounds_past_int32_and_fractional():
    x = _t(np.arange(-50, 50))
    assert int(selection.select(x, -2 ** 40, 2 ** 40)[1].sum()) == 100
    assert int(selection.select(x, 2 ** 40, 2 ** 41)[1].sum()) == 0
    assert int(selection.select(x, 1.5, 3.5)[1].sum()) == 2
    assert sel_ref.int32_bounds(9, 3) == (1, 0)


# ---- B2: counts-only bucket probe ------------------------------------------ #

@pytest.mark.parametrize("n_s,n_l,block", [(1, 1024, 256), (100, 2048, 1024),
                                           (1000, 4096, 4096),
                                           (3000, 4096, 1024)])
def test_probe_counts_matches_probe_counts_pallas(n_s, n_l, block):
    r = np.random.default_rng(n_s)
    dom = max(n_s // 4, 1)
    s = r.integers(0, dom, n_s).astype(np.int32)
    l = r.integers(0, 2 * dom, n_l).astype(np.int32)
    rs_sorted, r_order = r_join_ref.bucket_build(jnp.asarray(s))
    start_r, cnt_r = probe_counts_pallas(rs_sorted, jnp.asarray(l),
                                         block=block, interpret=True)
    s_sorted, order = join_ref.bucket_build(_t(s))
    _eq(s_sorted, rs_sorted)
    _eq(order, r_order)
    for start, cnt in (join_kernels.probe_counts(s_sorted, _t(l)),
                       join_ref.bucket_probe(s_sorted, _t(l))):
        assert start.dtype == cnt.dtype == torch.int32
        _eq(start, start_r)
        _eq(cnt, cnt_r)


def test_probe_counts_matches_reference_bucket_probe_at_int32_limits():
    """Pass blocks padded with distinct negative sentinels (as
    ``join_distributed_multi`` builds them) and probe keys at both ends of
    int32, 2**31 - 1 included: the reference's Pallas kernel counts its
    own table pads for that key, its ``bucket_probe`` does not, and B2's
    plain version must equal ``bucket_probe`` for every int32 key."""
    from repro_torch.core.join import HT_CAPACITY, _pad_build
    r = np.random.default_rng(12)
    s = np.concatenate([r.integers(0, 500, 3000),
                        [2 ** 31 - 1] * 3]).astype(np.int32)
    l = np.concatenate([r.integers(0, 600, 4093),
                        [2 ** 31 - 1, -2 ** 31, -(2 ** 30)]]).astype(np.int32)
    padded = _pad_build(_t(s), 1)       # the reference's inline pass pads
    _eq(padded, np.concatenate([s, -(2 ** 30) - np.arange(
        HT_CAPACITY - s.size, dtype=np.int32)]))
    for block in (s, padded):
        s_sorted, _ = join_ref.bucket_build(torch.as_tensor(block))
        rs_sorted, _ = r_join_ref.bucket_build(jnp.asarray(np.asarray(block)))
        _eq(s_sorted, rs_sorted)
        start_r, cnt_r = r_join_ref.bucket_probe(rs_sorted, jnp.asarray(l))
        start, cnt = join_kernels.probe_counts(s_sorted, _t(l))
        _eq(start, start_r)
        _eq(cnt, cnt_r)
        # -(2**30) is the first pass pad: the reason negative keys are
        # refused above the kernel
        assert int(cnt[-3]) == 3 and int(cnt[-2]) == 0
        assert int(cnt[-1]) == (block is padded)


# ---- B3: multi-match probe with the capped egress matrix ------------------ #

@pytest.mark.parametrize("n_s,n_l,block,cap", [(1, 1024, 256, 8),
                                               (100, 2048, 1024, 8),
                                               (3000, 4096, 1024, 8),
                                               (40, 1024, 1024, 3)])
def test_probe_multi_matches_probe_multi_pallas(n_s, n_l, block, cap):
    """Every output of the multi-match probe, with chains shorter and
    longer than the cap (the reference pads ``order`` with -1; the port's
    clamp never reads past the table)."""
    r = np.random.default_rng(n_s + cap)
    dom = max(n_s // 6, 1)
    s = r.integers(0, dom, n_s).astype(np.int32)
    l = r.integers(-1, 2 * dom, n_l).astype(np.int32)
    rs_sorted, r_order = r_join_ref.bucket_build(jnp.asarray(s))
    want = probe_multi_pallas(rs_sorted, r_order, jnp.asarray(l), cap=cap,
                              block=block, interpret=True)
    s_sorted, order = join_ref.bucket_build(_t(s))
    before = dict(_build.LAUNCHES)
    for got in (join_kernels.probe_multi(s_sorted, order, _t(l), cap=cap),
                join_kernels.probe_multi_plain(s_sorted, order, _t(l),
                                               cap=cap)):
        assert got[0].shape == (n_l, cap)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            _eq(g, w)
    assert _build.LAUNCHES == before          # CPU tensors: no launch
    assert int(want[2].max()) > cap or n_s <= cap


def test_probe_multi_plain_on_an_empty_table():
    mat, start, cnt = join_kernels.probe_multi_plain(
        _t([]), _t([]), _t([1, 2, 3]))
    _eq(mat, -np.ones((3, 8), np.int32))
    _eq(start, [0, 0, 0])
    _eq(cnt, [0, 0, 0])


@pytest.mark.parametrize("out_base,l_base,s_base", [(0, 0, 0), (5, 100, 8192),
                                                   (300, 7, 3)])
def test_emit_pairs_into_matches_reference(out_base, l_base, s_base):
    r = np.random.default_rng(out_base)
    s = r.integers(0, 20, 64).astype(np.int32)
    l = r.integers(0, 40, 256).astype(np.int32)
    rs, ro = r_join_ref.bucket_build(jnp.asarray(s))
    rst, rcnt = r_join_ref.bucket_probe(rs, jnp.asarray(l))
    buf = -np.ones(512, np.int32)
    want = r_join_ref.emit_pairs_into(jnp.asarray(buf), jnp.asarray(buf), ro,
                                      rst, rcnt, out_base=out_base,
                                      l_base=l_base, s_base=s_base)
    ps, po = join_ref.bucket_build(_t(s))
    pst, pcnt = join_ref.bucket_probe(ps, _t(l))
    got = join_ref.emit_pairs_into(_t(buf), _t(buf), po, pst, pcnt,
                                   out_base=out_base, l_base=l_base,
                                   s_base=s_base)
    for g, w in zip(got, want):
        _eq(g, w)


# ---- B4: open-addressing probe --------------------------------------------- #

@pytest.mark.parametrize("n_s,ts,depth", [(100, 256, 8), (1000, 2048, 4),
                                          (4096, 8192, 8), (700, 1024, 1)])
def test_build_table_and_probe_match_reference(n_s, ts, depth):
    r = np.random.default_rng(n_s + ts)
    s = r.choice(10 ** 6, size=n_s, replace=False).astype(np.int32)
    l = np.concatenate([r.integers(0, 10 ** 6, 3000), s[:1000]])
    l = np.concatenate([l, -np.ones(4096 - l.size % 4096)]).astype(np.int32)
    rk, rv, rp = r_join_ref.build_table(jnp.asarray(s), ts, depth)
    k, v, p = join_ref.build_table(_t(s), ts, depth)
    _eq(k, rk)
    _eq(v, rv)
    _eq(p, rp)
    idx_r, cnt_r = probe_pallas(rk, rv, jnp.asarray(l), block=1024,
                                probe_depth=depth, interpret=True)
    idx, cnt = join_kernels.probe(k, v, _t(l), block=1024, probe_depth=depth)
    _eq(idx, idx_r)
    _eq(cnt, cnt_r)
    _eq(join_ref.probe_ref(k, v, _t(l), depth)[0], idx_r)


@pytest.mark.parametrize("case", ["unique", "dense", "overflow"])
def test_hash_join_matches_pallas_hash_join(case):
    """All four outputs, including the slow path for keys the bounded
    build dropped and the overflow flag past MAX_DROPPED."""
    r = np.random.default_rng(len(case))
    if case == "unique":
        s, ts, depth = r.choice(10 ** 5, 300, replace=False), 1024, 8
    elif case == "dense":                      # load factor 1: some drops
        s, ts, depth = r.choice(10 ** 5, 512, replace=False), 512, 2
    else:                                      # > MAX_DROPPED drops
        s, ts, depth = r.choice(10 ** 5, 2048, replace=False), 1024, 1
    s = s.astype(np.int32)
    l = np.concatenate([s, r.integers(0, 10 ** 5, 4096 - s.size)])
    l = r.permutation(l).astype(np.int32)
    want = r_hash_join(jnp.asarray(s), jnp.asarray(l), table_size=ts,
                       probe_depth=depth, block=1024, impl="pallas",
                       interpret=True)
    got = hash_join(_t(s), _t(l), table_size=ts, probe_depth=depth,
                    block=1024)
    for g, w in zip(got, want):
        _eq(g, w)
    assert bool(got.overflowed) == (case == "overflow")
    assert int(got.dropped) > MAX_DROPPED or case != "overflow"


def test_materialize_matches_reference():
    s = np.asarray([5, 7, 9], np.int32)
    l = np.asarray([7, 1, 9, 2], np.int32)
    want_idx = r_hash_join(jnp.asarray(s), jnp.asarray(l), table_size=16,
                           probe_depth=8).s_idx
    got_idx = hash_join(_t(s), _t(l), table_size=16, probe_depth=8).s_idx
    _eq(got_idx, want_idx)
    for g, w in zip(materialize(got_idx, _t(l), _t(s)),
                    r_materialize(want_idx, jnp.asarray(l), jnp.asarray(s))):
        _eq(g, w)


# ---- B7: flash attention --------------------------------------------------- #

@pytest.mark.parametrize("s,bq,bk", [(128, 64, 64), (256, 128, 128),
                                     (256, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_attention_matches_flash_attention_interpret(s, bq, bk, causal, d):
    r = np.random.default_rng(s + d)
    q, k, v = (r.normal(size=(2, s, 2, d)).astype(np.float32)
               for _ in range(3))
    want = r_fa_ops.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, impl="pallas", interpret=True,
                           block_q=bq, block_kv=bk)
    got = attend(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bf16_matches_flash_attention_interpret(causal):
    r = np.random.default_rng(9)
    q, k, v = (r.normal(size=(1, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    want = r_fa_ops.attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           causal=causal, impl="pallas", interpret=True,
                           block_q=64, block_kv=64)
    got = attend(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                 causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("s", [1, 77, 200])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 1), (3, 3)])
def test_attention_ragged_gqa_matches_attention_ref(s, heads, kv_heads):
    """Any length and kv heads read in place: against the reference's dense
    oracle on kv heads repeated to the q heads."""
    r = np.random.default_rng(s)
    q = r.normal(size=(2, s, heads, 32)).astype(np.float32)
    k, v = (r.normal(size=(2, s, kv_heads, 32)).astype(np.float32)
            for _ in range(2))

    def flat(a):
        a = np.repeat(a, heads // a.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, s, 32))
    want = np.asarray(attention_ref(flat(q), flat(k), flat(v), causal=True))
    want = want.reshape(2, heads, s, 32).transpose(0, 2, 1, 3)
    got = attend(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_attention_wrapper_checks_shapes_and_types():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)
    before = dict(_build.LAUNCHES)
    fa.flash_attention(q, q, q)                  # the CPU: no launch counted
    assert _build.LAUNCHES == before


# ---- B8: the SSD chunk scan ------------------------------------------------ #

def _ssd_inputs(s, nh, hd, ng, ds, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(2, s, nh, hd)).astype(np.float32),
            r.uniform(0.01, 0.2, size=(2, s, nh)).astype(np.float32),
            r.normal(size=(nh,)).astype(np.float32),
            r.normal(size=(2, s, ng, ds)).astype(np.float32),
            r.normal(size=(2, s, ng, ds)).astype(np.float32),
            r.normal(size=(nh,)).astype(np.float32))


def _ssd_pallas_model_layout(x, dt, a_log, b, c, d_skip, chunk):
    """ssd_pallas on model-layout inputs, padded with dt = 0 to a chunk
    multiple as the reference's mamba_block pads (one chunk of S when
    S < chunk, as it also does)."""
    bsz, s, nh, hd = x.shape
    ng, ds = b.shape[2:]
    chunk = min(chunk, s)
    pad = -s % chunk
    x, dt, b, c = (np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                   for a in (x, dt, b, c))
    sp = s + pad
    rep = nh // ng
    xf = x.transpose(0, 2, 1, 3).reshape(bsz * nh, sp, hd)
    dtf = dt.transpose(0, 2, 1).reshape(bsz * nh, sp)
    bf, cf = (np.repeat(a, rep, 2).transpose(0, 2, 1, 3).reshape(
        bsz * nh, sp, ds) for a in (b, c))
    y, h = ssd_pallas(*map(jnp.asarray, (xf, dtf, np.tile(a_log, bsz), bf, cf,
                                         np.tile(d_skip, bsz))),
                      chunk=chunk, interpret=True)
    y = np.asarray(y).reshape(bsz, nh, sp, hd).transpose(0, 2, 1, 3)[:, :s]
    return y, np.asarray(h).reshape(bsz, nh, hd, ds)


@pytest.mark.parametrize("s,chunk", [(128, 64), (256, 128), (512, 128),
                                     (200, 128), (77, 128), (1, 128)])
@pytest.mark.parametrize("nh,hd,ng,ds", [(4, 16, 1, 16), (2, 32, 1, 32),
                                         (4, 16, 2, 16)])
def test_ssd_matches_ssd_pallas_and_the_recurrence(s, chunk, nh, hd, ng, ds):
    args = _ssd_inputs(s, nh, hd, ng, ds, seed=s)
    y, h = ssd(*map(torch.from_numpy, args), chunk=chunk)
    y_p, h_p = _ssd_pallas_model_layout(*args, chunk)
    np.testing.assert_allclose(y.numpy(), y_p, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_p, rtol=1e-4, atol=1e-4)
    y_n, h_n = ssd_naive(*args)
    np.testing.assert_allclose(y.numpy(), y_n, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_n, rtol=1e-4, atol=1e-4)


def test_ssd_naive_copy_equals_the_reference():
    args = _ssd_inputs(40, 4, 8, 2, 8)
    for got, want in zip(ssd_ref.ssd_naive(*args), ssd_naive(*args)):
        np.testing.assert_array_equal(got, want)


def test_ssd_keeps_bf16_in_and_out_and_checks_types():
    args = [torch.from_numpy(a) for a in _ssd_inputs(130, 4, 16, 1, 16)]
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    y, h = ssd(*args)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, h32 = ssd(*(a.float() for a in args))
    np.testing.assert_allclose(h.numpy(), h32.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        ssd(*(a.half() if i == 0 else a for i, a in enumerate(args)))
    with pytest.raises(ValueError):
        ssd(args[0], args[1][:, :-1], *args[2:])
