"""B8's backward in explicit formulas (``ref.ssd_backward_plain`` and its
three passes), the plain version of the card's backward kernel, against
autograd of the port's plain scan and against ``jax.vjp`` of the
reference's ``ssd_chunked``, on the CPU.

Inputs are drawn with numpy from a seed; the cases cover a ragged last
chunk, one group and several (up to one a head), the final state's
gradient present and absent, and strong decays over whole 128-token
chunks (dt up to 2, A up to 16: a chunk's log-decays sum to thousands).

Tolerances, each of a gradient's largest magnitude:

* in f64 every pass and the composition equal autograd within 1e-10: the
  formulas are the gradient's, whatever order they sum in;
* in f32, under Mamba-2's decays, within ``F32_REL`` (1e-6), but a_log's
  within ``A_LOG_REL`` (2e-5): its gradient sums every token's log-decay
  over the whole sequence, and autograd's reverse cumsum rounds it
  differently (up to 2.0e-6 of it from the f64 value at these cases,
  where the plain backward's pairwise sum stays within 2e-7);
* against the chunk-by-chunk ``ssd_plain`` within ``SSD_ORDER_REL``
  (2e-4), the two forms' known distance in f32;
* against the reference within 2e-2: ``ssd_chunked`` rounds its
  intra-chunk tensors to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked

from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd import ssd as ssd_mod

F64_REL = 1e-10
F32_REL = 1e-6
A_LOG_REL = 2e-5
SSD_ORDER_REL = 2e-4
REF_REL = 2e-2
NAMES = ("x", "dt", "a_log", "b", "c", "d_skip")

# bsz, s, nh, hd, ng, ds, chunk, decay
CASES = {
    "ragged": (2, 170, 4, 16, 2, 16, 32, "mamba"),
    "one_group": (2, 96, 4, 8, 1, 16, 32, "mamba"),
    "group_a_head": (1, 70, 2, 8, 2, 8, 32, "mamba"),
    "short": (1, 5, 2, 8, 1, 4, 32, "mamba"),
    "whole_chunks_strong": (1, 256, 2, 8, 1, 8, 128, "strong"),
    "ragged_strong": (2, 170, 4, 16, 2, 16, 64, "strong"),
}
MAMBA = [k for k, v in CASES.items() if v[-1] == "mamba"]
WHOLE = [k for k, v in CASES.items() if v[1] % v[6] == 0]


def _arrays(case, seed=0):
    """(x, dt, a_log, b, c, d_skip), gy, gh as f32 numpy arrays: Mamba-2's
    init ranges (dt in [0.001, 0.1], A in [1, 16]) or strong decays (dt
    in [0, 2])."""
    bsz, s, nh, hd, ng, ds, _, decay = CASES[case]
    r = np.random.default_rng(seed)
    dt = r.uniform(0.001, 0.1, (bsz, s, nh)) if decay == "mamba" else \
        r.uniform(0.0, 2.0, (bsz, s, nh))
    ins = [r.normal(size=(bsz, s, nh, hd)), dt,
           np.log(r.uniform(1.0, 16.0, nh)), r.normal(size=(bsz, s, ng, ds)),
           r.normal(size=(bsz, s, ng, ds)), r.normal(size=nh)]
    gy, gh = r.normal(size=(bsz, s, nh, hd)), r.normal(size=(bsz, nh, hd, ds))
    return ([a.astype(np.float32) for a in ins], gy.astype(np.float32),
            gh.astype(np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, rel, names=NAMES):
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        r = rel[name] if isinstance(rel, dict) else rel
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= r * scale, (name, err, scale)


def _autograd(fn, ins, outs_grads):
    """Autograd of ``fn(*ins)``'s outputs against their gradients (None:
    the output has none) at ``ins``; an output that depends on no input
    (the state entering a lone chunk, zero) adds nothing."""
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    live = [(o, g) for o, g in zip(outs, outs_grads)
            if g is not None and o.grad_fn is not None]
    if not live:
        return [torch.zeros_like(t) for t in ins]
    grads = torch.autograd.grad([o for o, _ in live], ins,
                                [g for _, g in live], allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins)]


# ---- each pass against autograd of its forward pass ------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_scan_backward_equals_autograd_of_the_chunk_scan(case):
    chunk = CASES[case][6]
    (x, dt, a_log, b, c, d), gy, _ = (
        _torch(a, torch.float64) if isinstance(a, list) else
        torch.from_numpy(a).double() for a in _arrays(case))
    states, decay = ref.ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    h_in, _ = ref.ssd_state_pass_plain(states, decay)
    got = ref.ssd_chunk_scan_bwd_plain(x, dt, a_log, b, c, d, h_in, gy,
                                       chunk=chunk)
    want = _autograd(lambda *a: ref.ssd_chunk_scan_plain(*a, chunk=chunk),
                     [x, dt, a_log, b, c, d, h_in], [gy])
    _close(got, want, F64_REL, NAMES + ("h_in",))


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_state_pass_backward_equals_autograd_of_the_state_pass(case,
                                                                with_gh):
    chunk = CASES[case][6]
    (x, dt, a_log, b, _, _), _, gh = (
        _torch(a, torch.float64) if isinstance(a, list) else
        torch.from_numpy(a).double() for a in _arrays(case))
    states, decay = ref.ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    h_in, _ = ref.ssd_state_pass_plain(states, decay)
    dh_in = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(h_in.shape)))
    gh = gh if with_gh else None
    got = ref.ssd_state_pass_bwd_plain(h_in, decay, dh_in, gh)
    want = _autograd(ref.ssd_state_pass_plain, [states, decay], [dh_in, gh])
    _close(got, want, F64_REL, ("states", "decay"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_states_backward_equals_autograd_of_the_chunk_states(case):
    chunk = CASES[case][6]
    (x, dt, a_log, b, _, _), _, _ = (
        _torch(a, torch.float64) if isinstance(a, list) else
        torch.from_numpy(a).double() for a in _arrays(case))
    states, decay = ref.ssd_chunk_states_plain(x, dt, a_log, b, chunk=chunk)
    r = np.random.default_rng(2)
    dstates = torch.from_numpy(r.normal(size=tuple(states.shape)))
    ddecay = torch.from_numpy(r.normal(size=tuple(decay.shape)))
    got = ref.ssd_chunk_states_bwd_plain(x, dt, a_log, b, dstates, ddecay,
                                         chunk=chunk)
    want = _autograd(lambda *a: ref.ssd_chunk_states_plain(*a, chunk=chunk),
                     [x, dt, a_log, b], [dstates, ddecay])
    _close(got, want, F64_REL, NAMES[:4])


# ---- the composition ---------------------------------------------------------

@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_plain_equals_plain_backward_in_f64(case, with_gh):
    chunk = CASES[case][6]
    arrays, gy, gh = _arrays(case)
    ins = _torch(arrays, torch.float64)
    gy = torch.from_numpy(gy).double()
    gh = torch.from_numpy(gh).double() if with_gh else None
    got = ref.ssd_backward_plain(*ins, gy, gh, chunk=chunk)
    want = ssd_mod.plain_backward(*ins, gy, gh, chunk=chunk)
    _close(got, want, F64_REL)


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("case", MAMBA)
def test_backward_plain_equals_plain_backward_in_f32(case, with_gh):
    chunk = CASES[case][6]
    arrays, gy, gh = _arrays(case)
    ins = _torch(arrays, torch.float32)
    gy = torch.from_numpy(gy)
    gh = torch.from_numpy(gh) if with_gh else None
    got = ref.ssd_backward_plain(*ins, gy, gh, chunk=chunk)
    want = ssd_mod.plain_backward(*ins, gy, gh, chunk=chunk)
    _close(got, want, dict({n: F32_REL for n in NAMES}, a_log=A_LOG_REL))


@pytest.mark.parametrize("case", MAMBA)
def test_backward_plain_equals_the_chunk_by_chunk_scan(case):
    chunk = CASES[case][6]
    arrays, gy, gh = _arrays(case)
    ins = _torch(arrays, torch.float32)
    gy, gh = torch.from_numpy(gy), torch.from_numpy(gh)
    got = ref.ssd_backward_plain(*ins, gy, gh, chunk=chunk)
    want = _autograd(lambda *a: ref.ssd_plain(*a, chunk=chunk), ins,
                     [gy, gh])
    _close(got, want, SSD_ORDER_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_keeps_the_inputs_types(dtype):
    """bf16 x, b and c give bf16 gradients (f32 sums, rounded once, as
    autograd of the plain version rounds them), dt, a_log and d_skip f32
    ones."""
    arrays, gy, gh = _arrays("ragged")
    ins = _torch(arrays, torch.float32)
    for i in (0, 3, 4):
        ins[i] = ins[i].to(dtype)
    gy = torch.from_numpy(gy).to(dtype)
    got = ref.ssd_backward_plain(*ins, gy, torch.from_numpy(gh), chunk=32)
    want = ssd_mod.plain_backward(*ins, gy, torch.from_numpy(gh), chunk=32)
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    _close(got, want, dict({n: 1e-2 if dtype == torch.bfloat16 else F32_REL
                            for n in NAMES}, a_log=A_LOG_REL))


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("case", WHOLE)
def test_backward_plain_matches_the_reference_vjp(case, with_gh):
    """Against ``jax.vjp`` of the reference's ``ssd_chunked`` (S a whole
    number of chunks, as it asks) on the same numpy inputs."""
    chunk = CASES[case][6]
    arrays, gy, gh = _arrays(case)
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk),
                     *map(jnp.asarray, arrays))
    want = vjp((jnp.asarray(gy).astype(jnp.float32),
                jnp.asarray(gh if with_gh else np.zeros_like(gh))))
    got = ref.ssd_backward_plain(
        *_torch(arrays, torch.float32), torch.from_numpy(gy),
        torch.from_numpy(gh) if with_gh else None, chunk=chunk)
    for g, w, name in zip(got, want, NAMES):
        w = np.asarray(w, np.float32)
        assert bool(torch.isfinite(g).all()), name
        err = np.abs(g.numpy() - w).max()
        assert err <= REF_REL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("case", ["whole_chunks_strong", "ragged_strong"])
def test_backward_plain_stays_finite_under_strong_decays(case):
    """exp(cum_i - cum_j) above the diagonal overflows under strong decays;
    the plain backward masks it before the exp, so every gradient is
    finite, in f32 as in f64, and the two agree within 5e-4 (f32's own
    cumsum over such chunks rounds each log-decay difference by some 1e-4:
    4.3e-5 of a gradient here)."""
    chunk = CASES[case][6]
    arrays, gy, gh = _arrays(case)
    got = {}
    for dtype in (torch.float32, torch.float64):
        got[dtype] = ref.ssd_backward_plain(
            *_torch(arrays, dtype), torch.from_numpy(gy).to(dtype),
            torch.from_numpy(gh).to(dtype), chunk=chunk)
        assert all(bool(torch.isfinite(t).all()) for t in got[dtype])
    _close([g.double() for g in got[torch.float32]], got[torch.float64],
           5e-4)


# ---- through the autograd Function ----------------------------------------

@pytest.mark.parametrize("needs", ["all", "no_d_skip", "x_only"])
@pytest.mark.parametrize("with_gh", [True, False])
def test_function_takes_the_backward_seam(monkeypatch, with_gh, needs):
    """``SSDScanFn``'s backward calls ``_scan_backward`` once with the
    saved inputs, gy and gh (None where the final state has no gradient)
    and hands back the gradients of the inputs that need one; with the
    seam swapped for ``ref.ssd_backward_plain`` (and the forward's for the
    plain scan) the Function gives autograd's gradients."""
    calls = []

    def backward(x, dt, a, b, c, d, gy, gh, chunk):
        calls.append(gh is None)
        return ref.ssd_backward_plain(x, dt, a, b, c, d, gy, gh, chunk=chunk)
    monkeypatch.setattr(ssd_mod, "_scan", lambda x, dt, a, b, c, d, chunk:
                        ref.ssd_chunked_plain(x, dt, a, b, c, d, chunk=chunk))
    monkeypatch.setattr(ssd_mod, "_scan_backward", backward)
    arrays, gy, gh = _arrays("ragged")
    ins = _torch(arrays, torch.float32)
    want_grad = {"all": NAMES, "no_d_skip": NAMES[:5], "x_only": NAMES[:1]}
    for t, name in zip(ins, NAMES):
        t.requires_grad_(name in want_grad[needs])
    y, h = ssd_mod.SSDScanFn.apply(*ins, 32)
    outs, grads = ((y, h), (torch.from_numpy(gy), torch.from_numpy(gh))) \
        if with_gh else ((y,), (torch.from_numpy(gy),))
    live = [t for t in ins if t.requires_grad]
    got = torch.autograd.grad(outs, live, grads)
    assert calls == [not with_gh]
    yp, hp = ref.ssd_chunked_plain(*ins, chunk=32)
    want = torch.autograd.grad((yp, hp)[:len(outs)], live, grads)
    _close(got, want, dict({n: F32_REL for n in NAMES}, a_log=A_LOG_REL),
           [n for n in NAMES if n in want_grad[needs]])


def test_function_on_cpu_tensors_takes_plain_backward(monkeypatch):
    """On CPU tensors (a test's: ``ssd_scan`` itself takes the plain scan
    there) the backward seam runs ``plain_backward`` and launches
    nothing."""
    calls = []
    plain = ssd_mod.plain_backward

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(ssd_mod, "plain_backward", counted)
    monkeypatch.setattr(ssd_mod, "_scan", lambda x, dt, a, b, c, d, chunk:
                        ref.ssd_chunked_plain(x, dt, a, b, c, d, chunk=chunk))
    from repro_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    arrays, gy, _ = _arrays("one_group")
    ins = [t.requires_grad_() for t in _torch(arrays, torch.float32)]
    y, _ = ssd_mod.SSDScanFn.apply(*ins, 32)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    assert calls == [1] and _build.LAUNCHES == before
    want = torch.autograd.grad(ref.ssd_chunked_plain(*ins, chunk=32)[0], ins,
                               torch.from_numpy(gy))
    _close(got, want, F32_REL)


# ---- the chunk pass's cluster of heads (the card's backward) ------------- #

@pytest.mark.parametrize("rep,want", [(1, 1), (2, 2), (3, 3), (6, 6), (8, 8),
                                      (16, 8), (12, 6), (7, 7), (48, 8),
                                      (128, 8)])
def test_cluster_heads_is_the_largest_divisor_up_to_eight(rep, want):
    """The heads of a cluster of the backward's chunk pass: the largest
    divisor of a group's heads up to ``MAX_CLUSTER`` (8), so mamba2-780m's
    48 and jamba's 128 take 8 and a group of one head takes 1."""
    assert ssd_mod.cluster_heads(rep) == want
    assert rep % want == 0 and want <= ssd_mod.MAX_CLUSTER


@pytest.mark.parametrize("dtype,hd,ds,nh,ng,want", [
    (torch.bfloat16, 64, 128, 48, 1, 8), (torch.bfloat16, 64, 16, 128, 1, 8),
    (torch.bfloat16, 64, 128, 12, 2, 6), (torch.bfloat16, 128, 128, 3, 1, 3),
    (torch.float32, 64, 128, 48, 1, 8), (torch.bfloat16, 33, 97, 48, 1, 8),
    (torch.float32, 64, 16, 12, 2, 6), (torch.float32, 33, 97, 3, 1, 3)])
def test_backward_shares_one_a_cluster(dtype, hd, ds, nh, ng, want):
    """Both routes cluster ``cluster_heads(nh / ng)`` heads and write one
    share of db and dc a cluster, (B, S, nh / C, ds); a cluster the chunk
    pass does not take (not a divisor of a group's heads up to 8) is
    refused."""
    x = torch.zeros(2, 5, nh, hd, dtype=dtype)
    b = torch.zeros(2, 5, ng, ds, dtype=dtype)
    assert ssd_mod.backward_cluster(dtype, hd, ds, nh, ng) == want
    bufs = ssd_mod.backward_buffers(x, b, 32)
    for k in ("db_part", "dc_part"):
        assert tuple(bufs[k].shape) == (2, 5, nh // want, ds)
    assert tuple(bufs["states"].shape) == (2, nh, 1, hd, ds)
    assert tuple(ssd_mod.backward_buffers(x, b, 32, cluster=1)["db_part"]
                 .shape) == (2, 5, nh, ds)
    bad = [9, 0] + [c for c in range(2, 9) if (nh // ng) % c]
    for cluster in bad:
        with pytest.raises(ValueError, match="cluster"):
            ssd_mod.backward_buffers(x, b, 32, cluster=cluster)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
def test_cluster_share_sum_equals_the_head_order_sum(cluster):
    """The kernel's two-level sum of the heads' db / dc shares (each
    cluster's heads in rank order on the chip, then a group's clusters in
    order: ``cluster_share_sum``, its plain version) and the one-level sum
    of a group's heads (``ref._group_sum``) are the same sum in f32: each
    within n 2**-24 of the sum of the terms' magnitudes (n = 24 terms) of
    the f64 sum, as f32 rounding allows; at C = 1 the shares are the
    heads' own and the two levels are one head-order sum."""
    ng, rep = 2, 24
    rng = np.random.default_rng(cluster)
    part = torch.from_numpy(rng.normal(size=(2, 37, ng * rep, 16))
                            .astype(np.float32))
    got = ssd_mod.cluster_share_sum(part, ng, cluster)
    want = ref._group_sum(part, ng)
    exact = ref._group_sum(part.double(), ng)
    bound = rep * 2.0 ** -24 * ref._group_sum(part.double().abs(), ng)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((want.double() - exact).abs() <= bound).all())
    if cluster == 1:
        heads = part.reshape(2, 37, ng, rep, 16)
        seq = heads[:, :, :, 0]
        for h in range(1, rep):
            seq = seq + heads[:, :, :, h]
        assert torch.equal(got, seq)


# ---- the CUDA-core route's split TF32 (the card's f32 backward) ----------- #

def _tf32_read(x, rna):
    """x (f32) as the tensor cores read it: rounded as ``cvt.rna.tf32.f32``
    rounds (to nearest, ties away from zero) where ``rna``, else cut: the
    low 13 of the 23 mantissa bits dropped."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 if rna else bits) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, split=True):
    """a @ b as the route multiplies: f32 operands, each split, x = hi +
    lo, hi rounded as ``cvt.rna`` rounds and lo = x - hi kept whole, then
    read through TF32's 10 mantissa bits; lo.hi + hi.lo + hi.hi, each
    product summed in f64 and rounded to f32, the three summed in f32, the
    small terms first.  Without ``split``: hi.hi alone."""
    ah, bh = _tf32_read(a, True), _tf32_read(b, True)

    def prod(u, v):
        return (u.double() @ v.double()).float()
    if not split:
        return prod(ah, bh)
    al, bl = _tf32_read(a - ah, False), _tf32_read(b - bh, False)
    return (prod(al, bh) + prod(ah, bl)) + prod(ah, bh)


class _SplitProducts(torch.overrides.TorchFunctionMode):
    """Every matrix product taken as ``_split_mm`` takes it (its operands
    rounded to f32, the result returned in their type): the plain backward
    under this mode is the kernel's arithmetic for its products, and f64
    for the rest."""

    def __init__(self, split=True):
        super().__init__()
        self.split = split

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul,
                    torch.Tensor.__matmul__):
            a, b = args
            return _split_mm(a.float(), b.float(), self.split).to(a.dtype)
        return func(*args, **(kwargs or {}))


def test_tf32_read_rounds_hi_and_cuts_lo():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      1 + 2 ** -10 + 2 ** -11, 1 + 2 ** -11 + 2 ** -20])
    assert _tf32_read(x, True).tolist() == [1 + 2 ** -10, 1.0,
                                            -(1 + 2 ** -10), 1 + 2 ** -9,
                                            1 + 2 ** -10]
    assert _tf32_read(x, False).tolist() == [1.0, 1.0, -1.0, 1 + 2 ** -10,
                                             1.0]


@pytest.mark.parametrize("with_gh", [True, False])
@pytest.mark.parametrize("s", [256, 300])
def test_split_tf32_backward_meets_the_f32_tolerance(s, with_gh):
    """The CUDA-core backward's products (the chunk states S and R, C B^T,
    GY X^T, M^T gy, W c, W b, gy H, b dS^T, x dS) in split TF32 at
    mamba2-780m's widths (hd 64, ds 128, one group) under strong decays
    (dt up to 2: a chunk's log-decays sum to thousands), over whole
    128-token chunks and a ragged last one, keep every gradient within
    the f32 tolerance (1e-5 of its largest magnitude) of the plain
    backward in f64; one TF32 product without the split leaves some
    gradient outside it."""
    r = np.random.default_rng(s)
    nh, hd, ds = 2, 64, 128
    ins = [r.normal(size=(1, s, nh, hd)), r.uniform(0.0, 2.0, (1, s, nh)),
           np.log(r.uniform(1.0, 16.0, nh)), r.normal(size=(1, s, 1, ds)),
           r.normal(size=(1, s, 1, ds)), r.normal(size=nh)]
    ins = [torch.from_numpy(a) for a in ins]
    gy = torch.from_numpy(r.normal(size=(1, s, nh, hd)))
    gh = torch.from_numpy(r.normal(size=(1, nh, hd, ds))) if with_gh \
        else None
    # the inputs as the card holds them: f32
    ins = [t.float().double() for t in ins]
    gy = gy.float().double()
    gh = None if gh is None else gh.float().double()
    want = ref.ssd_backward_plain(*ins, gy, gh, chunk=128)
    worst = {}
    for split in (True, False):
        with _SplitProducts(split):
            got = ref.ssd_backward_plain(*ins, gy, gh, chunk=128)
        worst[split] = max(
            float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want))
    assert worst[True] <= 1e-5, worst
    assert worst[False] > 1e-5, worst
