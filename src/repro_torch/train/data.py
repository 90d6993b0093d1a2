"""Deterministic, resumable data pipeline (the datamover, paper §III), the
counterpart of ``repro.train.data``.

Batches are a pure function of (seed, step): a restart from a checkpoint
replays the exact stream with no persisted iterator state.  The tokens
are the reference's own numpy draw, so both systems train on identical
batches.  The pipeline works one step ahead, as the paper's datamovers
stage the next batch while the step runs; it places batches on an
explicit device and, given shardings, hands each rank its block.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import from_whole


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    """Markov-ish synthetic LM tokens, deterministic in (seed, step):
    ``tokens`` and ``targets``, (global_batch, seq_len) int32 host
    tensors, the targets the tokens shifted by one."""
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    base = rng.integers(0, cfg.vocab_size,
                        size=(cfg.global_batch, cfg.seq_len + 1),
                        dtype=np.int32)
    # make it learnable: every odd position repeats its predecessor, so a
    # model that learns the copy rule halves the uniform CE floor
    base[:, 1::2] = base[:, 0:-1:2]
    return {"tokens": torch.from_numpy(base[:, :-1].copy()),
            "targets": torch.from_numpy(base[:, 1:].copy())}


class Pipeline:
    """The batch stream of ``synthetic_batch`` (with ``extras_fn(cfg,
    step)``'s tensors added, such as frames or patch embeddings), each
    batch placed on ``device`` (left on the host when None), the next one
    staged while the caller works on the current one.  ``sharding`` (the
    reference's ``Pipeline(sharding=)``) maps a batch key to ``(mesh,
    placements)``: that tensor, drawn whole by every rank, is handed on
    as the DTensor of this rank's block."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None,
                 start_step: int = 0,
                 extras_fn: Optional[Callable[[DataConfig, int], dict]]
                 = None, sharding: Optional[dict] = None):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self.step = start_step
        self.extras_fn = extras_fn
        self.sharding = sharding or {}
        self._staged: Optional[dict] = None

    def _produce(self, step: int) -> dict:
        batch = synthetic_batch(self.cfg, step)
        if self.extras_fn is not None:
            batch.update(self.extras_fn(self.cfg, step))
        if self.device is not None:
            batch = {k: v.to(self.device) for k, v in batch.items()}
        return {k: from_whole(v, *self.sharding[k]) if k in self.sharding
                else v for k, v in batch.items()}

    def next(self) -> dict:
        batch = self._staged if self._staged is not None \
            else self._produce(self.step)
        self.step += 1
        # stage the next batch (the datamover working ahead)
        self._staged = self._produce(self.step)
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @staticmethod
    def resume(cfg: DataConfig, state: dict, **kw) -> "Pipeline":
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on resume: the state's "
                             f"{state['seed']}, the config's {cfg.seed}")
        return Pipeline(cfg, start_step=int(state["step"]), **kw)
