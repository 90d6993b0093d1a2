"""Plain-torch oracle for range selection (paper Algorithm 1).

Given an int32 or float32 column and an inclusive [lo, hi] range, produce
the indexes of matching values and the match count.  The blocked variant mirrors the
kernel layout: index lines with -1 dummies plus a per-block match count.
Unlike the TPU oracle it accepts any length; a ragged last block counts
only its real rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def int32_bounds(lo, hi):
    """Bounds that select the same rows of an integer column as the
    inclusive [lo, hi], as int32 values: fractional bounds round inward,
    bounds past the int32 range clamp, and an empty range becomes (1, 0).
    A comparison of an int32 tensor with a Python int outside int32 does
    not compare the true values, so every integer path normalizes first."""
    lo, hi = math.ceil(lo), math.floor(hi)
    if lo > hi or lo > I32_MAX or hi < I32_MIN:
        return 1, 0
    return max(lo, I32_MIN), min(hi, I32_MAX)


def float32_bounds(lo, hi):
    """Bounds rounded to float32, as the TPU kernel casts them to the
    column's type (``jnp.asarray([lo], x.dtype)``): to nearest, and past
    the float32 range to an infinity.  A NaN row matches no bounds."""
    with np.errstate(over="ignore"):
        return float(np.float32(lo)), float(np.float32(hi))


def column_bounds(dtype: torch.dtype, lo, hi):
    """The bounds a column of ``dtype`` compares against: int32-normalized
    for an integer column, float32-rounded for a float32 one, as given
    for any other float type."""
    if not dtype.is_floating_point:
        return int32_bounds(lo, hi)
    if dtype == torch.float32:
        return float32_bounds(lo, hi)
    return lo, hi


def select_indices(x: torch.Tensor, lo, hi):
    """Dense oracle: (indices-with--1-at-non-matches, count)."""
    lo, hi = column_bounds(x.dtype, lo, hi)
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    mask = (x >= lo) & (x <= hi)
    return torch.where(mask, idx, -1), mask.sum(dtype=torch.int32)


def select_blocked(x: torch.Tensor, lo, hi, block: int):
    """Per block of ``block`` rows: index line with -1 dummies ((N,)) and
    the block's match count ((ceil(N/block),))."""
    n = x.shape[0]
    nb = -(-n // block)
    idx, _ = select_indices(x, lo, hi)
    mask = torch.zeros(nb * block, dtype=torch.int32, device=x.device)
    mask[:n] = idx >= 0
    return idx, mask.view(nb, block).sum(dim=1, dtype=torch.int32)
