"""Optimizers over a model's named parameters: AdamW (the production
default: an f32 master copy, f32 moments and a step count) and the
paper's plain minibatch SGD with L2 (Algorithm 3), the counterparts of
``repro.train.optimizer``.

Both update in place: the optimizer state's tensors and the parameters
themselves (bf16 parameters are written from the f32 master after each
step), where the reference returns new trees; a full-width model's
state would not fit twice on one card.  The arithmetic is the
reference's, op for op, in f32.

Weight decay follows the reference's stacked layout on purpose.  The
reference decays a leaf of two or more dims, and stacks every per-layer
leaf over its superblocks (its encoder and decoder stacks over their
layers), so it decays every layer's norm scales, ``a_log``, ``dt_bias``,
``d_skip`` and router as well as its matrices, and of the global leaves
only those of two or more dims (the embeddings, not ``final_norm`` or
``enc_norm``).  The port holds each layer's leaves unstacked, so
``decays`` adds the stacking dim back before it counts.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

import torch

from repro_torch.distributed.sharding import LogicalArray, replicated_like

# the port's module lists whose leaves the reference stacks over layers
STACKED = ("layers", "encoder", "decoder")


def _like(specs: Mapping[str, LogicalArray], dtype) -> dict:
    return {n: LogicalArray(la.shape, la.logical, dtype)
            for n, la in specs.items()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The square root of the sum of every tensor's squared entries, in
    f32 (a 0-dim tensor)."""
    return torch.sqrt(torch.stack([t.float().square().sum()
                                   for t in tensors]).sum())


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays the leaf that parameter ``name`` is:
    one of two or more dims in its stacked layout."""
    stacked = name.split(".", 1)[0] in STACKED
    return p.dim() + stacked >= 2


def _clipped(grads: Mapping[str, torch.Tensor], clip_norm):
    """(the grads' global norm, the factor that clips them to
    ``clip_norm``, or None without clipping)."""
    gnorm = global_norm(grads.values())
    if clip_norm is None:
        return gnorm, None
    return gnorm, torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                              max=1.0)


def _count(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The step count, an int32 0-dim zero on the parameters' device;
    replicated over their mesh where they are DTensors (``init_specs``'
    layout, which ``checkpoint.restore`` gives it back in)."""
    p = next(iter(params.values()))
    return replicated_like(torch.zeros((), dtype=torch.int32,
                                       device=p.device), p)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup: int = 100

    def init_specs(self, param_specs: Mapping[str, LogicalArray]) -> dict:
        """The state of ``init`` as LogicalArrays: f32 copies of the
        parameter specs for the master and both moments, laid out as the
        parameters, and the int32 count."""
        return {"master": _like(param_specs, torch.float32),
                "m": _like(param_specs, torch.float32),
                "v": _like(param_specs, torch.float32),
                "count": LogicalArray((), (), torch.int32)}

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        """``{"master", "m", "v"}`` (name -> f32 tensor, each laid out as
        its parameter) and ``"count"`` (``_count``)."""
        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        return {"master": {n: p.detach().float().clone()
                           for n, p in params.items()},
                "m": zeros(), "v": zeros(), "count": _count(params)}

    def _schedule(self, count: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(count.float() / max(self.warmup, 1), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        """One step from ``grads`` (name -> gradient in the parameter's
        type): clip by the global norm, the moments, bias correction,
        decay where ``decays``, then the master and the parameters, all in
        place -> (params, state, the unclipped global norm)."""
        count = state["count"] + 1
        lr = self._schedule(count)
        gnorm, scale = _clipped(grads, self.clip_norm)
        b1c = 1.0 - torch.pow(self.b1, count.float())
        b2c = 1.0 - torch.pow(self.b2, count.float())
        for n, p in params.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale
            m, v, master = state["m"][n], state["v"][n], state["master"][n]
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g.square())
            step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay and decays(n, p):
                step = step + self.weight_decay * master
            master.sub_(lr * step)
            p.copy_(master)
        state["count"] = count
        return params, state, gnorm


@dataclasses.dataclass(frozen=True)
class PaperSGD:
    """Algorithm 3: x <- x - alpha * (g + 2*lambda*x)."""

    lr: float = 0.05
    l2: float = 0.0
    clip_norm: Optional[float] = None

    def init_specs(self, param_specs: Mapping[str, LogicalArray]) -> dict:
        return {"count": LogicalArray((), (), torch.int32)}

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": _count(params)}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        gnorm, scale = _clipped(grads, self.clip_norm)
        for n, p in params.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale
            pf = p.float()
            p.copy_(pf - self.lr * (g + 2.0 * self.l2 * pf))
        state["count"] = state["count"] + 1
        return params, state, gnorm
