"""Gradient compression with error feedback.

The counterpart of ``repro.distributed.compression``: int8 uniform
quantisation per tensor with an error-feedback residual (Seide et al. /
EF-SGD), so the quantisation error is carried to the next step and the
compression is unbiased in the limit.  ``compressed_psum`` is the
data-parallel all-reduce in that wire format: the scales' MAX, then an
int32 SUM of each rank's payload rescaled to the shared scale.  Rounding
is half to even (``torch.round``, as ``jnp.round``) and every quotient
is rounded once (``_divide``), so payloads and residuals equal the
reference's bit for bit, on the card as on the CPU.  Trees are nested dicts,
lists and tuples of tensors; a compressed leaf is the pair (q int8,
scale f32).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import tree_map


@dataclasses.dataclass
class _Pair:
    """Two results of one leaf (a leaf to ``tree_map``, unlike a tuple)."""
    first: object
    second: object


def _unzip(fn, *trees):
    """``fn`` -> (a, b) over the leaves -> (the tree of a, the tree of b)."""
    pairs = tree_map(lambda _, *leaves: _Pair(*fn(*leaves)), *trees)
    return (tree_map(lambda _, p: p.first, pairs),
            tree_map(lambda _, p: p.second, pairs))


def _is_quantized(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 \
        and isinstance(x[0], torch.Tensor)


def _divide(a: torch.Tensor, b) -> torch.Tensor:
    """a / b rounded once, on every device: a divisor that is a Python
    number (a CPU scalar) makes a CUDA kernel multiply by its reciprocal,
    which can land one ulp away from the quotient."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def quantize_int8(x: torch.Tensor):
    """(q int8, scale f32 0-dim) with symmetric per-tensor scaling."""
    amax = x.abs().amax()
    scale = _divide(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _feedback(g: torch.Tensor, r: torch.Tensor):
    g = g.float() + r
    q, scale = quantize_int8(g)
    return (q, scale), g - dequantize_int8(q, scale)


def compress_tree(grads, residual):
    """Error-feedback quantisation of a tree -> (the tree of (q, scale),
    the new residual tree)."""
    return _unzip(_feedback, grads, residual)


def decompress_tree(q_tree):
    """A tree of (q, scale) -> the tree of f32 tensors."""
    return tree_map(lambda _, qs: dequantize_int8(*qs), q_tree,
                    is_leaf=_is_quantized)


def zero_residual(params):
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def compressed_psum(mesh: DeviceMesh, axis: str) -> Callable:
    """fn(grads, residual) -> (mean grads, new residual): the data-parallel
    all-reduce over ``axis`` in the int8 wire format with error feedback
    (the shared-scale variant: each rank's payload rescaled to the
    scales' MAX, summed in int32; the residual against the clipped
    rescaled payload)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def allreduce_one(g, r):
        g = g.float() + r
        q, scale = quantize_int8(g)
        smax = scale.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        q_rescaled = torch.round(dequantize_int8(q, scale) / smax) \
            .to(torch.int32)
        total = q_rescaled.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = _divide(total.float() * smax, n)
        new_r = g - dequantize_int8(
            torch.clamp(q_rescaled, -127, 127).to(torch.int8), smax)
        return mean, new_r

    def inner(grads, residual):
        return _unzip(allreduce_one, grads, residual)

    return inner
