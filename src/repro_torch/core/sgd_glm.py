"""Scale-out GLM training with SGD (paper §VI) — hyper-parameter search.

The paper's killer use case (Fig. 10a): K models trained on the SAME
dataset with different hyper-parameters, one engine per job.  On one card
the engines are the plan's ``n_engines`` groups of jobs, each trained by
one launch of the SGD kernel (one CUDA block per job); a job's weights do
not depend on how the jobs are grouped, because the kernel and its plain
version train every job on its own in a fixed order.

Datasets larger than a channel use the paper's block-wise scan (CoCoA):
train multiple epochs per resident block, then rotate blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.channels import ChannelPlan
from repro_torch.kernels.sgd import ref as sgd_ref
from repro_torch.kernels.sgd.ops import sgd_train
from repro_torch.kernels.sgd.sgd import sgd


@dataclasses.dataclass(frozen=True)
class HyperParams:
    lr: float
    l2: float


def pad_to_minibatch(a: torch.Tensor, b: torch.Tensor, minibatch: int):
    """Zero-pad (a, b) to the next multiple of ``minibatch``.

    Zero feature rows contribute exactly zero to the minibatch gradient
    numerator ``aᵀ(link(a@x) - b)`` for both ridge and logreg (every
    product term carries a zero feature), while the divisor stays the
    nominal minibatch — i.e. the tail rows are folded into one final
    partial minibatch of zero-weight rows.  Losses must still be computed
    over the UNPADDED rows (a logreg pad row would add ``-log(0.5)``)."""
    pad = (-a.shape[0]) % minibatch
    if pad == 0:
        return a, b
    a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    b = torch.cat([b, b.new_zeros((pad,))])
    return a, b


def hyperparam_search(a: torch.Tensor, b: torch.Tensor,
                      grid: Sequence[HyperParams], plan: ChannelPlan, *,
                      minibatch: int = 16, epochs: int = 10,
                      kind: str = "logreg"):
    """Train len(grid) models; jobs are dealt to the plan's engines in
    contiguous groups, the last group topped up with copies of the first
    job, as in the reference.  a (m, n) f32, b (m,).  Returns xs (K, n)
    and final losses (K,) over the unpadded rows."""
    n_eng = plan.n_engines
    k = len(grid)
    jobs_per_eng = -(-k // n_eng)
    k_pad = jobs_per_eng * n_eng
    hp = torch.tensor([[g.lr, g.l2] for g in grid]
                      + [[grid[0].lr, grid[0].l2]] * (k_pad - k),
                      dtype=torch.float32, device=a.device)
    lrs = hp[:, 0].contiguous().reshape(n_eng, jobs_per_eng)
    l2s = hp[:, 1].contiguous().reshape(n_eng, jobs_per_eng)
    n = a.shape[1]
    # non-dividing row counts: train on the zero-padded dataset (the tail
    # folds into one partial minibatch of zero-weight rows), score the
    # loss on the original rows only
    a_t, b_t = pad_to_minibatch(a, b, minibatch)
    xs = torch.cat([
        sgd(a_t, b_t, a.new_zeros((jobs_per_eng, n)), lrs[e], l2s[e],
            minibatch=minibatch, epochs=epochs, kind=kind)
        for e in range(n_eng)])[:k]
    losses = sgd_ref.loss_ref(a, b, xs, l2s.reshape(-1)[:k], kind=kind)
    return xs, losses


def _sgd_dynamic(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, lr,
                 l2, *, minibatch: int, epochs: int,
                 kind: str) -> torch.Tensor:
    """One job's SGD with run-time lr / l2 (floats or 0-d tensors), over
    rows that are a multiple of ``minibatch``."""
    return sgd_train(a, b, x0, lr=float(lr), l2=float(l2),
                     minibatch=minibatch, epochs=epochs, kind=kind)


def blockwise_train(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, *,
                    lr: float, l2: float, block_rows: int,
                    epochs_per_block: int, passes: int = 1,
                    minibatch: int = 16, kind: str = "ridge"):
    """CoCoA-style block-wise scan for datasets larger than a channel
    (paper §VI): a block is resident for several epochs, then rotated."""
    m = a.shape[0]
    if m % block_rows:
        raise ValueError(f"{m} rows do not split into blocks of "
                         f"{block_rows}")
    x = x0
    for _ in range(passes):
        for i in range(m // block_rows):
            rows = slice(i * block_rows, (i + 1) * block_rows)
            x = _sgd_dynamic(a[rows], b[rows], x, lr, l2,
                             minibatch=minibatch, epochs=epochs_per_block,
                             kind=kind)
    return x
