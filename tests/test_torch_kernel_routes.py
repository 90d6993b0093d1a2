"""The routes of the port's redesigned kernels, decided in Python before a
launch: B7's (dtype, head dim) -> tensor cores or CUDA cores, and B2's
table length -> shared memory or sample.  Both are plain functions, so
they are checked here on the CPU; the kernels behind them run only on the
card (``tests/test_torch_kernels_cuda.py``).  On CPU tensors both wrappers
take their plain versions and count no launch."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.join import join as jk
from repro_torch.kernels.join import ref as join_ref


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 80, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core")])
def test_flash_attention_route(dtype, d, want):
    assert fa.route(dtype, d) == want


def test_every_tensor_core_head_dim_is_built():
    assert set(fa.TC_HEAD_DIMS) <= set(fa.HEAD_DIMS)


@pytest.mark.parametrize("n_s,want", [
    (0, "shared"), (1, "shared"), (2_556, "shared"), (8_192, "shared"),
    (16_384, "sampled"),
    (jk.SHARED_TABLE_MAX - 1, "shared"), (jk.SHARED_TABLE_MAX, "shared"),
    (jk.SHARED_TABLE_MAX + 1, "sampled"), (119_384, "sampled"),
    (1_500_000, "sampled"), (2 ** 31 - 2, "sampled")])
def test_probe_counts_route(n_s, want):
    assert jk.probe_counts_route(n_s) == want


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
