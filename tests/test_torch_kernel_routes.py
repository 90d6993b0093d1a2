"""The routes of the port's redesigned kernels, decided in Python before a
launch: B7's type -> bf16 tensor cores or split-TF32 tensor cores (the
split's arithmetic emulated against the f32 tolerance), B2's
table length -> shared memory or sample (B3's too: it searches with B2's
code), and B5's (features, minibatch)
-> a ring of minibatch tiles on a cluster of blocks, or the split
route (its plan checked over widths up to 2,000,000 features), and
B8's (dtype, hd, ds) -> tensor cores or CUDA cores, with the
tensor-core route's split-bf16 arithmetic emulated against the
tolerances.  All are plain functions, so they are checked here on the CPU;
the kernels behind them run only on the card
(``tests/test_torch_kernels_cuda.py``).  On CPU tensors the wrappers take
their plain versions and count no launch."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.join import join as jk
from repro_torch.kernels.join import ref as join_ref
from repro_torch.kernels.sgd import ref as sgd_ref
from repro_torch.kernels.sgd import sgd as sgd_kernels
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd as ssd_kernels

SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
ATTN_F32_TOL = 2e-5          # tests/test_torch_kernels_cuda.py, chip_smoke.py


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 32, "tc"),
    (torch.bfloat16, 80, "tc"), (torch.bfloat16, 96, "tc"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.float32, 16, "tf32x3"), (torch.float32, 80, "tf32x3")])
def test_flash_attention_route(dtype, d, want):
    assert fa.route(dtype, d) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 48, 256])
def test_flash_attention_route_refuses_an_unbuilt_head_dim(dtype, d):
    with pytest.raises(ValueError, match="head dim"):
        fa.route(dtype, d)


def test_every_tensor_core_head_dim_is_built():
    """Both types take the tensor cores at every head dim the source
    instantiates, each route with its own launcher and counter."""
    for dtype in fa.DTYPES:
        for d in fa.HEAD_DIMS:
            rt = fa.route(dtype, d)
            assert rt in ("tc", "tf32x3")
            assert fa.ENTRY[rt] in _build.SIGNATURES
            assert fa.COUNTER[rt] in _build.LAUNCHES


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, the low 13 of the 23 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_products(eq, x, y, split):
    """einsum ``eq`` of x and y as the f32 route multiplies: TF32 operands,
    products summed in f32; split, x . y = hi.hi + hi.lo + lo.hi with
    hi = tf32(x) and lo = tf32(x - hi), the small terms first."""
    xh, yh = _tf32(x), _tf32(y)
    if not split:
        return torch.einsum(eq, xh, yh)
    xl, yl = _tf32(x - xh), _tf32(y - yh)
    return (torch.einsum(eq, xl, yh) + torch.einsum(eq, xh, yl)
            + torch.einsum(eq, xh, yh))


def _attention_tf32(q, k, v, split):
    """``ref.attention_plain`` in f32 with its two products taken through
    TF32 (p is f32, so its rounding to the value type is the identity)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = _tf32_products("bqkgd,bskd->bkgqs", qg, k, split) * d ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    scores = torch.where(keep, scores, fa_ref.NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = _tf32_products("bkgqs,bskd->bkgqd", p, v, split) / den
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -12,
                      -(1 + 2 ** -11 + 2 ** -12), 1 + 2 ** -10 + 2 ** -11])
    assert _tf32(x).tolist() == [1.0, -1.0, 1 + 2 ** -10, 1.0,
                                 -(1 + 2 ** -10), 1 + 2 ** -9]


@pytest.mark.parametrize("d", [16, 32, 80])
def test_split_tf32_attention_meets_the_f32_tolerance(d):
    """The f32 route's arithmetic on the CPU at S 2,000, causal, 4 q heads
    over 2 kv heads: three TF32 products per product keep the output
    within the f32 tolerance of the plain version; one TF32 product, the
    single-pass form, leaves it outside."""
    r = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2_000, n, d))
                                .astype(np.float32)) for n in (4, 2, 2))
    want = fa_ref.attention_plain(q, k, v)
    split = float((_attention_tf32(q, k, v, True) - want).abs().max())
    once = float((_attention_tf32(q, k, v, False) - want).abs().max())
    assert split <= ATTN_F32_TOL, split
    assert once > ATTN_F32_TOL, once


@pytest.mark.parametrize("n_s,want", [
    (0, "shared"), (1, "shared"), (2_556, "shared"), (8_192, "shared"),
    (16_384, "sampled"),
    (jk.SHARED_TABLE_MAX - 1, "shared"), (jk.SHARED_TABLE_MAX, "shared"),
    (jk.SHARED_TABLE_MAX + 1, "sampled"), (119_384, "sampled"),
    (1_500_000, "sampled"), (2 ** 31 - 2, "sampled")])
def test_probe_counts_route(n_s, want):
    assert jk.probe_counts_route(n_s) == want


@pytest.mark.parametrize("n_s,want", [
    (0, "shared"), (4, "shared"), (2_556, "shared"),
    (jk.SHARED_TABLE_MAX, "shared"), (jk.SHARED_TABLE_MAX + 1, "sampled"),
    (1_500_000, "sampled"), (6_001_215, "sampled"), (2 ** 23, "sampled")])
def test_probe_multi_route(n_s, want):
    """B3 searches with B2's code, so it takes B2's route at every length:
    the shared route up to 8,192 keys, the sampled one past them (TPC-H SF
    1's 6,001,215 lineitem rows pad to 2**23)."""
    assert jk.probe_multi_route(n_s) == want == jk.probe_counts_route(n_s)


def test_sampled_route_tables_hold_at_least_two_keys_per_sample():
    """The sampled route searches every (ts / SAMPLE_KEYS)-th key in shared
    memory: the smallest table it takes pads to twice the shared budget,
    so each sampled key stands for 2 or more."""
    smallest = join_ref.next_pow2(jk.SHARED_TABLE_MAX + 1)
    assert smallest // jk.SAMPLE_KEYS >= 2


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_on_cpu_tensors_is_the_plain_version(d):
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, 70, n, d, generator=g).to(torch.bfloat16)
               for n in (4, 2, 2))
    before = dict(_build.LAUNCHES)
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa_ref.attention_plain(q, k, v))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("d", [16, 80])
def test_flash_attention_f32_on_cpu_tensors_is_the_plain_version(d):
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 33, n, d, generator=g) for n in (8, 2, 2))
    before = dict(_build.LAUNCHES)
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, fa_ref.attention_plain(q, k, v,
                                                       causal=causal))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("n_s", [2_556, jk.SHARED_TABLE_MAX + 1])
def test_probe_counts_on_cpu_tensors_is_the_plain_version(n_s):
    r = np.random.default_rng(n_s)
    s_sorted, _ = join_ref.bucket_build(torch.from_numpy(
        r.integers(-50, 5_000, n_s).astype(np.int32)))
    keys = torch.from_numpy(r.integers(-100, 5_100, 1_003).astype(np.int32))
    before = dict(_build.LAUNCHES)
    got = jk.probe_counts(s_sorted, keys)
    for g, w in zip(got, join_ref.bucket_probe(s_sorted, keys)):
        assert torch.equal(g, w)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("cap", [1, 3, 8])
@pytest.mark.parametrize("n_s", [2_556, jk.SHARED_TABLE_MAX + 1])
def test_probe_multi_on_cpu_tensors_is_the_plain_version(n_s, cap):
    r = np.random.default_rng(n_s + cap)
    s_sorted, order = join_ref.bucket_build(torch.from_numpy(
        r.integers(-50, 600, n_s).astype(np.int32)))
    keys = torch.from_numpy(r.integers(-100, 700, 1_003).astype(np.int32))
    before = dict(_build.LAUNCHES)
    got = jk.probe_multi(s_sorted, order, keys, cap=cap)
    for g, w in zip(got, jk.probe_multi_plain(s_sorted, order, keys,
                                              cap=cap)):
        assert torch.equal(g, w)
    assert torch.equal(got[1], jk.probe_counts(s_sorted, keys)[0])
    assert torch.equal(got[2], jk.probe_counts(s_sorted, keys)[1])
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("block", [1, 4095, 4096])
def test_probe_on_cpu_tensors_is_the_plain_version(block):
    r = np.random.default_rng(block)
    s = torch.from_numpy(r.choice(1 << 16, 3_000, replace=False)
                         .astype(np.int32))
    ht_k, ht_v, _ = join_ref.build_table(s, 4096, 8)
    keys = torch.from_numpy(np.concatenate(
        [r.integers(0, 1 << 16, 6_000), s.numpy()]).astype(np.int32))
    before = dict(_build.LAUNCHES)
    for depth in (1, 8):
        got = jk.probe(ht_k, ht_v, keys, block=block, probe_depth=depth)
        for g, w in zip(got, jk.probe_plain(ht_k, ht_v, keys, block=block,
                                            probe_depth=depth)):
            assert torch.equal(g, w)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("n,minibatch,want", [
    (4, 16, "ring"), (784, 16, "ring"), (1_028, 16, "ring"),
    (4_096, 16, "ring"), (8_192, 16, "ring"), (8_196, 16, "split"),
    (1, 16, "split"), (3, 16, "split"), (785, 16, "split"),
    (47_236, 16, "split"), (50_000, 16, "split"), (0, 16, "split"),
    (784, 4, "ring"), (784, 8, "ring"), (784, 1, "split"),
    (784, 2, "split"), (784, 12, "split"), (784, 32, "split"),
    (58_097, 16, "split"), (1_355_191, 16, "split")])
def test_sgd_route(n, minibatch, want):
    """The ring's bulk copies read whole 16-byte groups of features, so
    it takes n % 4 == 0 and minibatches of 4, 8 and 16, up to 8 blocks of
    256 consumer threads; every other width takes the split route, up to
    news20.binary's 1,355,191 features and past them."""
    assert sgd_kernels.route(n, minibatch) == want


@pytest.mark.parametrize("minibatch", [1, 2, 12, 16, 32])
@pytest.mark.parametrize("n", [1, 3, 785, 2_049, 9_000, 47_236, 58_097,
                               152_000, 760_001, 1_355_191, 2_000_000])
def test_sgd_split_plan_fits_and_covers_every_feature(n, minibatch):
    """The split route's plan is a function of (n, minibatch) alone; its
    blocks fit the opt-in shared memory; one cluster holds at most 16 of
    them and a grid-wide launch at most 128 (of the card's 132 SMs);
    their contiguous slices of a multiple of 4 features cover the n
    features exactly once with no empty block; and the model slices live
    on chip exactly where four sub-tile slots still fit beside them."""
    plan = sgd_kernels.split_plan(n, minibatch)
    assert plan == sgd_kernels.split_plan(n, minibatch)
    assert sgd_kernels.split_shared_bytes(minibatch, plan) <= \
        sgd_kernels.H100_SHARED_BYTES
    assert 1 <= plan.blocks <= (128 if plan.grid else 16)
    assert plan.width % 4 == 0 and plan.width > 0
    starts = [c * plan.width for c in range(plan.blocks)]
    ends = [min(s + plan.width, n) for s in starts]
    assert starts[0] == 0 and ends[-1] == n and starts[-1] < n
    assert all(e == s for e, s in zip(ends, starts[1:]))
    lo, hi = sgd_kernels.SPLIT_STAGES
    assert lo <= plan.stages <= hi
    beside = sgd_kernels.split_shared_bytes(minibatch, dataclasses.replace(
        plan, stages=sgd_kernels.SPLIT_STAGES_BESIDE_MODEL,
        model_on_chip=True))
    assert plan.model_on_chip == (beside <= sgd_kernels.H100_SHARED_BYTES)
    chunks = -(-minibatch // sgd_kernels.SPLIT_ROWS)
    sub_tiles = chunks * -(-plan.width // sgd_kernels.SPLIT_SUB)
    assert plan.resident == (sub_tiles < plan.stages)
    # a cluster is taken only where its rings hold a step's tile
    assert plan.grid or plan.resident


@pytest.mark.parametrize("features,terms", [(5_000, 74), (20_000, 455)])
def test_text_rows_are_unit_norm_tfidf_rows_with_balanced_labels(features,
                                                                 terms):
    """The wide GLM searches' rows: at most ``terms`` distinct terms a
    row, each holding its IDF before the row is scaled to unit L2 norm;
    half the labels set; the same rows from the same seed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    text_rows = chip_smoke.text_rows
    cpu = torch.device("cpu")
    a, b = text_rows(64, features, terms, torch.Generator().manual_seed(5),
                     cpu)
    again, _ = text_rows(64, features, terms,
                         torch.Generator().manual_seed(5), cpu)
    assert torch.equal(a, again)
    nnz = (a != 0).sum(dim=1)
    assert bool((nnz >= 1).all()) and bool((nnz <= terms).all())
    torch.testing.assert_close(a.norm(dim=1), torch.ones(64))
    assert float(b.sum()) == 32.0 and set(b.tolist()) <= {0.0, 1.0}
    # two terms that share rows keep one ratio of IDFs in all of them
    common = (a != 0).sum(dim=0).argsort(descending=True)[:2]
    both = (a[:, common] != 0).all(dim=1)
    ratio = a[both][:, common[0]] / a[both][:, common[1]]
    assert int(both.sum()) > 1
    torch.testing.assert_close(ratio, ratio[:1].expand_as(ratio))


def test_sgd_split_plan_at_the_wide_shapes():
    """785 features train on one block and 9,000 on a cluster of 5, each
    keeping a step's tile in its ring; RCV1's 47,236 features take a
    grid-wide launch of 127 blocks (372 features each, the tile resident);
    news20.binary's 1,355,191 one of 128 whose model slices live in device
    memory and which asks L2 for nothing (a minibatch is 86.7 MB)."""
    small = sgd_kernels.split_plan(785, 16)
    assert (small.blocks, small.grid, small.resident) == (1, False, True)
    mid = sgd_kernels.split_plan(9_000, 16)
    assert (mid.blocks, mid.grid, mid.resident) == (5, False, True)
    rcv1 = sgd_kernels.split_plan(47_236, 16)
    assert (rcv1.blocks, rcv1.grid, rcv1.width, rcv1.resident,
            rcv1.model_on_chip, rcv1.jobs, rcv1.prefetch) == \
        (127, True, 372, True, True, 4, True)
    news20 = sgd_kernels.split_plan(1_355_191, 16)
    assert (news20.blocks, news20.grid, news20.width, news20.model_on_chip,
            news20.prefetch) == (128, True, 10_588, False, False)
    assert sgd_kernels.split_plan(0, 16) is None


@pytest.mark.parametrize("n,cluster,threads", [
    (4, 1, 32), (784, 1, 224), (1_024, 1, 256), (1_028, 2, 160),
    (2_048, 2, 256), (4_096, 4, 256), (8_192, 8, 256)])
def test_sgd_ring_plan_at_minibatch_16(n, cluster, threads):
    """The MNIST shape (784 features) runs on one block of 7 consumer
    warps; wider models take the smallest cluster whose blocks hold at
    most 256 consumer threads of four features."""
    plan = sgd_kernels.ring_plan(n, 16)
    assert plan == sgd_kernels.RingPlan(cluster, threads)
    assert 4 * plan.cluster * plan.threads >= n
    assert sgd_kernels.ring_shared_bytes(n, 16, plan) <= \
        sgd_kernels.H100_SHARED_BYTES


@pytest.mark.parametrize("minibatch", sgd_kernels.RING_MINIBATCHES)
@pytest.mark.parametrize("n", [4, 100, 784, 1_000, 3_000, 8_192])
def test_sgd_ring_plans_fit_and_cover_every_feature(n, minibatch):
    """Every plan's blocks fit the opt-in shared memory, cover all n
    features, and hold whole warps of at most 256 threads; a forced
    cluster size keeps those properties where it fits at all."""
    for cluster in (None, *sgd_kernels.CLUSTER_SIZES):
        plan = sgd_kernels.ring_plan(n, minibatch, cluster=cluster)
        if plan is None:
            assert cluster is not None
            continue
        assert plan.threads % 32 == 0
        assert plan.threads <= sgd_kernels.RING_THREADS_MAX
        assert 4 * plan.cluster * plan.threads >= n
        # no block is all padding warps
        assert plan.threads - 32 < -(-(n // 4) // plan.cluster)
        assert sgd_kernels.ring_shared_bytes(n, minibatch, plan) <= \
            sgd_kernels.H100_SHARED_BYTES


def test_sgd_on_cpu_tensors_is_the_plain_version():
    r = np.random.default_rng(4)
    a = torch.from_numpy(r.uniform(0, 1, (64, 784)).astype(np.float32))
    b = torch.from_numpy((r.uniform(size=64) > 0.5).astype(np.float32))
    xs0 = torch.zeros(3, 784)
    lrs, l2s = torch.tensor([0.1, 0.01, 0.001]), torch.zeros(3)
    before = dict(_build.LAUNCHES)
    got = sgd_kernels.sgd(a, b, xs0, lrs, l2s, minibatch=16, epochs=2,
                          kind="logreg")
    assert torch.equal(got, sgd_ref.sgd_ref(a, b, xs0, lrs, l2s,
                                            minibatch=16, epochs=2,
                                            kind="logreg"))
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="card"):
        sgd_kernels.sgd_ring(a, b, xs0, lrs, l2s, minibatch=16, epochs=2,
                             kind="logreg",
                             plan=sgd_kernels.ring_plan(784, 16))


@pytest.mark.parametrize("dtype,hd,ds,want", [
    (torch.float32, 16, 16, "cuda_core"), (torch.float32, 64, 128, "cuda_core"),
    (torch.bfloat16, 16, 16, "tc"), (torch.bfloat16, 64, 128, "tc"),
    (torch.bfloat16, 64, 120, "cuda_core"),
    (torch.bfloat16, 24, 16, "cuda_core")])
def test_ssd_route(dtype, hd, ds, want):
    """Tensor cores take bf16 at widths that are multiples of 16 (mamba2's
    hd 64, ds 128 among them); f32 and the other widths take the CUDA
    cores, each route with its own counter."""
    assert ssd_kernels.route(dtype, hd, ds) == want
    assert ssd_kernels.COUNTER[want] in _build.LAUNCHES


def _ssd_mamba_inputs(s, nh, hd, ds, seed=0):
    """Inputs as chip_smoke.py draws them at mamba2's widths: bf16 x, b, c;
    dt in [0.001, 0.1] and A in [1, 16] (Mamba-2's init ranges)."""
    r = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(                    # noqa: E731
        r.normal(size=shape).astype(np.float32))
    dt = torch.from_numpy(r.uniform(0.001, 0.1, (1, s, nh)).astype(np.float32))
    a_log = torch.from_numpy(np.log(r.uniform(1, 16, nh)).astype(np.float32))
    x, b, c = f(1, s, nh, hd), f(1, s, 1, ds), f(1, s, 1, ds)
    return (x.bfloat16(), dt, a_log, b.bfloat16(), c.bfloat16(), f(nh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_on_cpu_tensors_is_the_plain_version(dtype):
    args = [a.to(dtype) if i in (0, 3, 4) else a
            for i, a in enumerate(_ssd_mamba_inputs(200, 4, 16, 16))]
    before = dict(_build.LAUNCHES)
    got = ssd_kernels.ssd_scan(*args, chunk=64)
    for g, w in zip(got, ssd_ref.ssd_plain(*args, chunk=64)):
        assert torch.equal(g, w)
    assert _build.LAUNCHES == before
    states, decay = ssd_kernels.scratch(args[0], 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernels.run_passes(*args, states=states, decay=decay, y=got[0],
                               h=got[1], chunk=64)


def test_ssd_tensor_core_arithmetic_meets_the_tolerances(monkeypatch):
    """The tensor-core route's arithmetic on the CPU at mamba2's widths
    (hd 64, ds 128) over 5 chunks: every f32 operand split into a bf16
    high part and a bf16 remainder, products in f32, keeps y within the
    bf16 tolerance and the state within the f32 one; rounding each such
    operand to bf16 once leaves the state outside it."""
    args = _ssd_mamba_inputs(640, 4, 64, 128, seed=17)
    y_p, h_p = ssd_ref.ssd_plain(*args)
    y, h = ssd_ref.ssd_chunked_plain(*args, split_bf16=True)
    torch.testing.assert_close(y.float(), y_p.float(), **SSD_BF16_TOL)
    torch.testing.assert_close(h, h_p, **SSD_TOL)
    monkeypatch.setattr(ssd_ref, "_split", lambda v, split: (
        v.to(torch.bfloat16).float(),) if split else (v,))
    _, h_once = ssd_ref.ssd_chunked_plain(*args, split_bf16=True)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(h_once, h_p, **SSD_TOL)
