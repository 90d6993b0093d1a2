"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and carries the ``requires_cuda``
marker; the ``cuda`` fixture decides at run time whether to skip, so the
set of collected tests is the same on every machine.  This file imports
neither ``jax`` nor ``repro`` (the card's machine has no JAX), so it runs
there on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Integer outputs must be bit-identical to the plain versions.  The SGD
kernel sums in another order than its plain version (and nvcc contracts
multiply-adds into FMAs), so its weights agree within rtol=1e-4,
atol=1e-5; the kernel is deterministic, so streamed training (one launch
per morsel) equals one launch over all rows bit for bit.  The traffic
generator (``o = x + 1``) is bit-identical to its plain version at any
length, on misaligned slices, at the top of int32 and in float32; a spill
plan streams host and disk columns back through pinned copies.

The flash-attention kernel (B7) sums in another order than its plain
version (a dense f32 softmax on cuBLAS), so outputs agree within 2e-5 in
float32 and 2e-2 in bfloat16 (the reference's own bf16 tolerance).  The
SSD kernel (B8) agrees with its plain version within rtol=atol=1e-4 in
float32 (its final state too in bfloat16; y rounded to bfloat16 within
one rounding, 1.6e-2).  A 2-layer smoke model's logits on the card equal
its CPU logits within 2e-2: every bf16 product rounds on its own path.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bandwidth
from repro_torch.core import channels
from repro_torch.core import join as join_core
from repro_torch.kernels import _build
from repro_torch.kernels.bandwidth import ref as bw_ref
from repro_torch.kernels.bandwidth import stream
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.join import join as join_kernels
from repro_torch.kernels.join import ops as join_ops
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.selection import selection
from repro_torch.kernels.sgd import ref as sgd_ref
from repro_torch.kernels.sgd import sgd as sgd_kernels
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_kernels

SGD_TOL = dict(rtol=1e-4, atol=1e-5)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
LM_TOL = 2e-2

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _same(a, b):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n,block", [(0, 1024), (1, 1024), (1024, 1024),
                                     (7 * 1024 + 3, 1024),
                                     ((1 << 20) + 5, 4096)])
def test_select_kernel_matches_plain(cuda, n, block):
    r = np.random.default_rng(n)
    x = _i32(r.integers(-50, 150, size=n), cuda)
    before = _build.LAUNCHES["select"]
    idx, counts = selection.select(x, 10, 60, block=block)
    idx_p, counts_p = selection.select_plain(x, 10, 60, block=block)
    _same(idx, idx_p)
    _same(counts, counts_p)
    assert _build.LAUNCHES["select"] == before + (n > 0)


def test_select_kernel_empty_and_inverted_ranges(cuda):
    x = _i32(np.arange(-5000, 5000), cuda)
    for lo, hi in ((7, 7), (9, 3), (-2 ** 40, 2 ** 40)):
        idx, counts = selection.select(x, lo, hi, block=1024)
        idx_p, counts_p = selection.select_plain(x, lo, hi, block=1024)
        _same(idx, idx_p)
        _same(counts, counts_p)


@pytest.mark.parametrize("n_s,n_l", [(0, 1000), (1, 1000), (2556, 100_003),
                                     ((1 << 20) + 17, 1 << 20)])
def test_probe_counts_kernel_matches_plain(cuda, n_s, n_l):
    r = np.random.default_rng(n_s)
    dom = max(n_s // 3, 1)
    s_sorted, _ = join_ref.bucket_build(_i32(r.integers(0, dom, n_s), cuda))
    keys = _i32(r.integers(0, 2 * dom, n_l), cuda)
    start, count = join_kernels.probe_counts(s_sorted, keys)
    start_p, count_p = join_ref.bucket_probe(s_sorted, keys)
    _same(start, start_p)
    _same(count, count_p)


@pytest.mark.parametrize("n_s", [5, join_core.HT_CAPACITY + 700])
def test_probe_counts_kernel_on_negative_padded_pass_blocks(cuda, n_s):
    """The pass blocks of ``join_distributed_multi`` (distinct negative
    pads, as in the eager duplicate-keyed join) and probe keys at both
    ends of int32, 2**31 - 1 included, which the table also holds."""
    r = np.random.default_rng(n_s)
    s = np.concatenate([r.integers(0, max(n_s // 3, 1), n_s),
                        [2 ** 31 - 1] * 2])
    keys = _i32(np.concatenate([r.integers(0, n_s, 50_000),
                                [2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -1,
                                 -(2 ** 30), -(2 ** 30) - 1]]), cuda)
    s_pad = join_core._pad_build(_i32(s, cuda),
                                 -(-s.size // join_core.HT_CAPACITY))
    for p in range(s_pad.shape[0] // join_core.HT_CAPACITY):
        blk = s_pad[p * join_core.HT_CAPACITY:(p + 1) * join_core.HT_CAPACITY]
        s_sorted, _ = join_ref.bucket_build(blk)
        start, count = join_kernels.probe_counts(s_sorted, keys)
        start_p, count_p = join_ref.bucket_probe(s_sorted, keys)
        _same(start, start_p)
        _same(count, count_p)


@pytest.mark.parametrize("n_s,n_l,depth", [(1, 5000, 8), (2556, 100_003, 8),
                                           (8192, 1 << 20, 8),
                                           (8192, 4096, 1)])
def test_hash_probe_kernel_matches_plain(cuda, n_s, n_l, depth):
    r = np.random.default_rng(n_s + depth)
    s = _i32(r.choice(10 * n_s + 10, size=n_s, replace=False), cuda)
    keys = _i32(r.integers(-1, 10 * n_s + 10, n_l), cuda)
    ht_k, ht_v, _ = join_ref.build_table(s, 32768, depth)
    s_idx, counts = join_kernels.probe(ht_k, ht_v, keys, probe_depth=depth)
    s_idx_p, counts_p = join_kernels.probe_plain(ht_k, ht_v, keys,
                                                 probe_depth=depth)
    _same(s_idx, s_idx_p)
    _same(counts, counts_p)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x64 = torch.arange(10, device=cuda)
    with pytest.raises(TypeError):
        selection.select(x64, 0, 5)
    strided = torch.arange(20, dtype=torch.int32, device=cuda)[::2]
    with pytest.raises(ValueError):
        selection.select(strided, 0, 5)
    table = torch.zeros(100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):          # not a power of two
        join_kernels.probe(table, table, table)


@pytest.mark.parametrize("n_s,n_l,cap", [(0, 1000, 8), (1, 1000, 8),
                                         (2556, 100_003, 8),
                                         (40_000, 1 << 16, 3),
                                         ((1 << 20) + 17, 1 << 20, 8)])
def test_probe_multi_kernel_matches_plain(cuda, n_s, n_l, cap):
    """Chains shorter and longer than the cap, probe keys outside the
    table, and keys at both ends of int32 (2**31 - 1 also in the table)."""
    r = np.random.default_rng(n_s + cap)
    dom = max(n_s // 5, 1)
    s = np.concatenate([r.integers(0, dom, n_s),
                        [2 ** 31 - 1, -2 ** 31] if n_s else []])
    keys = np.concatenate([r.integers(-2, 2 * dom, n_l - 4),
                           [2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -1]])
    s_sorted, order = join_ref.bucket_build(_i32(s, cuda))
    keys = _i32(keys, cuda)
    before = _build.LAUNCHES["probe_multi"]
    got = join_kernels.probe_multi(s_sorted, order, keys, cap=cap)
    want = join_kernels.probe_multi_plain(s_sorted, order, keys, cap=cap)
    for g, w in zip(got, want):
        _same(g, w)
    assert _build.LAUNCHES["probe_multi"] == before + 1
    if n_s > 100:
        assert int(want[2].max()) > cap


@pytest.mark.parametrize("max_out", [10, 1 << 20])
def test_hash_join_multi_on_the_card_equals_the_cpu(cuda, max_out):
    """The whole multi-match join, probe kernel and overflow pass, on the
    card against the same join on CPU tensors (the plain probe)."""
    r = np.random.default_rng(max_out)
    s = r.integers(0, 3000, 200_000).astype(np.int32)
    l = r.integers(0, 3500, 5000).astype(np.int32)
    got = join_ops.hash_join_multi(_i32(s, cuda), _i32(l, cuda),
                                   max_out=max_out)
    want = join_ops.hash_join_multi(torch.from_numpy(s), torch.from_numpy(l),
                                    max_out=max_out)
    for g, w in zip(got, want):
        _same(g, w.to(g.device))


def _sgd_inputs(device, m, n, k, kind, seed=0):
    r = np.random.default_rng(seed + n + k)
    a = r.uniform(0, 1, (m, n)).astype(np.float32)
    if kind == "logreg":
        b = (a @ r.normal(size=n) > 0.5 * r.normal(size=n).sum())
    else:
        b = a @ r.normal(size=n) / max(n, 1)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(a, **f32),
            torch.as_tensor(np.asarray(b, np.float32), **f32),
            torch.as_tensor(r.normal(0, 0.1, (k, n)), **f32),
            torch.as_tensor(0.5 / (1 + np.arange(k)) / max(n, 1), **f32),
            torch.as_tensor(1e-3 * (np.arange(k) % 3), **f32))


@pytest.mark.parametrize("n", [1, 3, 784, 2048])
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_kernel_matches_plain(cuda, n, k, kind):
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 256, n, k, kind)
    before = _build.LAUNCHES["sgd"]
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                          kind=kind)
    want = sgd_ref.sgd_ref(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                           kind=kind)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sgd"] == before + 1
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **SGD_TOL)


@pytest.mark.parametrize("kind", ["logreg", "ridge"])
def test_sgd_kernel_streamed_equals_one_launch_bitwise(cuda, kind):
    """Epochs over morsels (one launch each, weights carried) against one
    launch over all rows; and a job alone against the job in a group."""
    a, b, xs0, lrs, l2s = _sgd_inputs(cuda, 1600, 784, 8, kind)
    once = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=3,
                           kind=kind)
    xs = xs0
    for _ in range(3):
        for lo in range(0, 1600, 480):            # 480, 480, 480, 160 rows
            xs = sgd_kernels.sgd(a[lo:lo + 480], b[lo:lo + 480], xs, lrs,
                                 l2s, minibatch=16, epochs=1, kind=kind)
    _same(xs, once)
    alone = sgd_kernels.sgd(a, b, xs0[3:4].contiguous(), lrs[3:4], l2s[3:4],
                            minibatch=16, epochs=3, kind=kind)
    _same(alone[0], once[3])


def test_sgd_kernel_refuses_a_model_wider_than_shared_memory(cuda):
    n = 60_000                       # 240 KB of floats: over 227 KB
    a = torch.zeros((16, n), dtype=torch.float32, device=cuda)
    b = torch.zeros(16, dtype=torch.float32, device=cuda)
    hp = torch.zeros(1, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sgd_kernels.sgd(a, b, torch.zeros((1, n), dtype=torch.float32,
                                          device=cuda), hp, hp,
                        minibatch=16)
    wide = sgd_kernels.sgd(a[:, :50_000].contiguous(), b,
                           torch.ones((1, 50_000), dtype=torch.float32,
                                      device=cuda), hp + 0.1, hp,
                           minibatch=16)
    torch.cuda.synchronize()         # 200 KB: over 48 KB, opted in
    assert bool((wide == 1).all())


def test_executor_trains_through_the_kernel_stream_equals_eager(cuda):
    """The executor's GLM path on the card: every mode launches the SGD
    kernel, and streamed weights equal eager weights bit for bit."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, HyperParams, Q
    r = np.random.default_rng(2)
    a = r.uniform(0, 1, (1000, 20)).astype(np.float32)
    y = (a @ r.normal(size=20) > 0).astype(np.float32)
    cols = {f"f{j}": a[:, j] for j in range(20)}
    cols["y"] = y
    ex = Executor(catalog_from_arrays({"t": cols}, cuda), cuda)
    q = Q.scan("t").train_glm([f"f{j}" for j in range(20)], "y",
                              [HyperParams(0.1 / (i + 1), 0.001 * i)
                               for i in range(4)], epochs=3)
    out = {}
    for mode, kw in (("batch", {}), ("stream", {"morsel_rows": 160}),
                     ("eager", {})):
        before = _build.LAUNCHES["sgd"]
        out[mode] = ex.execute(q, mode=mode, **kw).value
        assert _build.LAUNCHES["sgd"] > before
    _same(out["stream"][0], out["eager"][0])
    _same(out["batch"][0], out["eager"][0])


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 4096 + 7, (1 << 20) + 3,
                               (1 << 22) + 1])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_copy_kernel_matches_plain(cuda, n, dtype):
    r = np.random.default_rng(n)
    if dtype == torch.int32:
        x = _i32(r.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64), cuda)
        if n:
            x[0] = 2 ** 31 - 1                  # wraps to -2**31
    else:
        x = torch.as_tensor(r.standard_normal(n).astype(np.float32) * 1e4,
                            device=cuda)
    before = _build.LAUNCHES["stream_copy"]
    got = stream.stream_copy(x)
    _same(got, bw_ref.stream_copy_ref(x))
    assert _build.LAUNCHES["stream_copy"] == before + (n > 0)


@pytest.mark.parametrize("start", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_stream_copy_kernel_on_misaligned_slices(cuda, start, dtype):
    base = torch.arange(-(1 << 16), (1 << 16) + 9, device=cuda).to(dtype)
    before = base.clone()
    for stop in (base.shape[0], base.shape[0] - 2, start + 3, start + 1):
        x = base[start:stop]
        got = stream.stream_copy(x)
        _same(got, bw_ref.stream_copy_ref(x))
        # the output shares x's offset within 16 bytes (the vector path)
        assert got.data_ptr() % 16 == x.data_ptr() % 16
        # an output at another offset takes the scalar path, same bits
        out = torch.empty(x.shape[0] + 1, dtype=dtype, device=cuda)[1:]
        _same(stream.stream_copy(x, out=out), bw_ref.stream_copy_ref(x))
    _same(base, before)                          # x is never written


def test_stream_copy_kernel_wraps_int32_and_refuses_other_types(cuda):
    x = torch.tensor([2 ** 31 - 1] * 9, dtype=torch.int32, device=cuda)
    assert stream.stream_copy(x).tolist() == [-2 ** 31] * 9
    for dtype in (torch.float16, torch.int64, torch.float64, torch.int16):
        with pytest.raises(TypeError):
            stream.stream_copy(torch.zeros(8, dtype=dtype, device=cuda))
    with pytest.raises(ValueError):
        stream.stream_copy(torch.zeros((4, 4), dtype=torch.int32,
                                       device=cuda))


@pytest.mark.parametrize("n_engines", [1, 4, 16])
@pytest.mark.parametrize("placement", ["partitioned", "congested"])
def test_stream_copy_distributed_matches_plain(cuda, n_engines, placement):
    n = n_engines * ((1 << 18) + 3)       # shards start off 16-byte marks
    x = _i32(np.random.default_rng(n_engines).integers(-9, 9, n), cuda)
    before = _build.LAUNCHES["stream_copy"]
    got = bandwidth.stream_copy_distributed(
        x, channels.plan(placement, n_engines, cuda))
    _same(got, bw_ref.stream_copy_ref(x))
    assert _build.LAUNCHES["stream_copy"] == before + n_engines
    assert bandwidth.measure_gbps(stream.stream_copy, x) > 0


def test_spilled_executor_on_the_card_equals_resident(cuda, tmp_path):
    """Host and disk columns staged through pinned copies and the
    prefetch thread give the resident run's value, in batch (routed to
    the spill stream) and in stream mode, with and without the thread."""
    from repro_torch.convert import catalog_from_arrays
    from repro_torch.query import Executor, Q, TierBudgets
    r = np.random.default_rng(3)
    n = 300_007
    arrays = {"big": {"k": r.integers(0, 1000, n).astype(np.int32),
                      "v": r.integers(0, 100, n).astype(np.int32),
                      "w": r.integers(1, 50, n).astype(np.int32)},
              "small": {"k": np.arange(0, 1000, 2, dtype=np.int32)}}
    q = (Q.scan("big").join(Q.scan("small"), on="k").filter("v", 10, 60)
         .sum("w"))
    want = Executor(catalog_from_arrays(arrays, cuda), cuda).execute(q).value
    col = n * 4
    for overlap in (True, False):
        ex = Executor(catalog_from_arrays(arrays, cuda), cuda,
                      tier_budgets=TierBudgets(device=col + 4096, host=col),
                      overlap_transfers=overlap)
        ex._spill_dir = str(tmp_path)
        before = _build.LAUNCHES["probe_counts"]
        res = ex.execute(q)
        assert res.value == want and res.mode == "stream"
        assert _build.LAUNCHES["probe_counts"] > before
        assert sorted(ex.last_spill.tiers.values()) == ["device", "disk",
                                                       "host"]
        assert ex.execute(q, mode="stream", morsel_rows=65_536).value == want


# ---- flash attention (B7) ------------------------------------------------- #

def _qkv(device, b, s, h, kvh, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=g).to(device, dtype)
                 for n in (h, kvh, kvh))


@pytest.mark.parametrize("s", [1, 77, 128, 2000])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, s, group, dtype, causal):
    q, k, v = _qkv(cuda, 2, s, 8, 8 // group, 128, dtype, seed=s)
    before = _build.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa_ref.attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_TOL[dtype], err
    assert _build.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_attention_kernel_every_head_dim(cuda, d):
    q, k, v = _qkv(cuda, 1, 77, 4, 2, d, torch.float32, seed=d)
    got = fa.flash_attention(q, k, v)
    want = fa_ref.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATTN_TOL[torch.float32]


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 48, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                           v)


# ---- SSD chunk scan (B8) --------------------------------------------------- #

def _ssd_inputs(device, bsz, s, nh, hd, ng, ds, dtype, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(                       # noqa: E731
        r.normal(size=shape).astype(np.float32))
    dt = torch.from_numpy(r.uniform(0.01, 0.2, size=(bsz, s, nh))
                          .astype(np.float32))
    x, b, c = f(bsz, s, nh, hd), f(bsz, s, ng, ds), f(bsz, s, ng, ds)
    return (x.to(device, dtype), dt.to(device), f(nh).to(device),
            b.to(device, dtype), c.to(device, dtype), f(nh).to(device))


@pytest.mark.parametrize("s", [1, 77, 128, 200, 2000])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("hd,ds", [(16, 16), (64, 128)])
def test_ssd_kernel_matches_plain(cuda, s, ng, hd, ds):
    args = _ssd_inputs(cuda, 2, s, 4, hd, ng, ds, torch.float32, seed=s)
    before = _build.LAUNCHES["ssd"]
    y, h = ssd_kernels.ssd_scan(*args)
    y_p, h_p = ssd_ref.ssd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, **SSD_TOL)
    torch.testing.assert_close(h, h_p, **SSD_TOL)
    assert _build.LAUNCHES["ssd"] == before + 1


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_kernel_bf16_and_chunk_lengths(cuda, chunk):
    args = _ssd_inputs(cuda, 2, 300, 8, 64, 2, 128, torch.bfloat16)
    y, h = ssd_kernels.ssd_scan(*args, chunk=chunk)
    y_p, h_p = ssd_ref.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_BF16_TOL)
    torch.testing.assert_close(h, h_p, **SSD_TOL)


def test_ssd_kernel_refuses_a_chunk_past_shared_memory(cuda):
    args = _ssd_inputs(cuda, 1, 64, 2, 128, 1, 256, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_kernels.ssd_scan(*args)
    args = _ssd_inputs(cuda, 1, 64, 2, 64, 1, 64, torch.float16)
    with pytest.raises(TypeError):
        ssd_kernels.ssd_scan(*args)


# ---- the LM path ----------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_smoke_model_on_the_card_equals_the_cpu(cuda, arch):
    import dataclasses
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.launch.serve import build_model
    from repro_torch.models import registry
    cfg = dataclasses.replace(smoke_config(get_arch(arch)), num_layers=2)
    mb, cpu_model = build_model(cfg, torch.device("cpu"), seed=3)
    _, card_model = build_model(cfg, cuda, state_dict=cpu_model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 200),
                         generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        caches = registry.make_cache(cfg, 2, 201, dev)
        _build.reset_launches()
        with torch.inference_mode():
            logits, caches = mb.prefill_fn(model, toks.to(dev), caches)
            step, _ = mb.decode_fn(model, toks[:, :1].to(dev), 200, caches)
        out[dev] = (logits.cpu(), step.cpu(), dict(_build.LAUNCHES))
    kernel = "ssd" if cfg.family == "ssm" else "flash_attention"
    assert out["cpu"][2][kernel] == 0 and out["cuda"][2][kernel] == 2
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        assert float((got - want).abs().max()) <= LM_TOL
