"""Fault tolerance & straggler mitigation for the training launcher, the
counterpart of ``repro.train.fault_tolerance`` (pure Python over the
port's checkpoints).

Building blocks with the same control flow a multi-host deployment
uses:

  * ``Heartbeat`` — per-worker liveness ledger; the coordinator declares a
    worker dead after ``timeout_s`` and triggers elastic restart (in a
    cluster it is fed by the health plane; here by the launcher).
  * ``StragglerDetector`` — per-step wall-time EWMA + z-score; persistent
    stragglers get flagged for replacement BEFORE they fail hard (a
    common accelerator failure mode is slowdown-then-death).
  * ``ElasticPlan`` — given survivors, choose the largest valid mesh
    (divisibility-checked against the arch) and the checkpoint to resume
    from; paired with checkpoint.restore's re-sharding this is
    shrink-to-survive.
  * ``run_with_restarts`` — supervision loop: run step fn, checkpoint every
    K steps, simulate/absorb failures, resume from the latest checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class Heartbeat:
    timeout_s: float = 60.0
    last_seen: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: str, t: Optional[float] = None) -> None:
        self.last_seen[worker] = time.time() if t is None else t

    def dead(self, now: Optional[float] = None) -> list[str]:
        now = time.time() if now is None else now
        return sorted(w for w, t in self.last_seen.items()
                      if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> list[str]:
        now = time.time() if now is None else now
        return sorted(w for w, t in self.last_seen.items()
                      if now - t <= self.timeout_s)


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1              # EWMA factor
    z_threshold: float = 3.0
    min_steps: int = 8
    _mean: dict = dataclasses.field(default_factory=dict)
    _var: dict = dataclasses.field(default_factory=dict)
    _count: dict = dataclasses.field(default_factory=dict)

    def observe(self, worker: str, step_time: float) -> None:
        m = self._mean.get(worker, step_time)
        v = self._var.get(worker, 0.0)
        delta = step_time - m
        m += self.alpha * delta
        v = (1 - self.alpha) * (v + self.alpha * delta * delta)
        self._mean[worker], self._var[worker] = m, v
        self._count[worker] = self._count.get(worker, 0) + 1

    def stragglers(self) -> list[str]:
        if not self._mean:
            return []
        means = sorted(self._mean.values())
        med = means[len(means) // 2]
        spread = max(1e-9, med * 0.05)
        return sorted(
            w for w, m in self._mean.items()
            if self._count.get(w, 0) >= self.min_steps
            and (m - med) / spread > self.z_threshold)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(n_chips: int, *, model_candidates: Sequence[int] =
                      (16, 8, 4, 2, 1), arch_divisors: Sequence[int] = ()
                      ) -> ElasticPlan:
    """Largest (data, model) grid fitting the surviving chips.  model must
    divide every entry of arch_divisors (heads/d_ff/vocab constraints)."""
    for model in model_candidates:
        if any(d % model for d in arch_divisors):
            continue
        data = n_chips // model
        if data >= 1:
            return ElasticPlan(data=data, model=model)
    return ElasticPlan(data=max(n_chips, 1), model=1)


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    completed_steps: int = 0
    wasted_steps: int = 0


def run_with_restarts(step_fn: Callable[[int, dict], dict], state: dict, *,
                      n_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                      fail_at: Optional[Sequence[int]] = None,
                      max_restarts: int = 10) -> tuple[dict, RestartStats]:
    """Supervision loop with checkpoint/restart.  ``state`` is a tree of
    tensors (``checkpoint``'s) with at least {"step": a 0-dim tensor}.
    ``fail_at``: steps at which to inject a simulated worker failure
    (tests).  step_fn returns the new state."""
    stats = RestartStats()
    fail_at = set(fail_at or ())
    start = ckpt_lib.latest_step(ckpt_dir)
    if start is not None:
        state, _ = ckpt_lib.restore(ckpt_dir, state)
        step = int(state["step"])
    else:
        step = 0

    while step < n_steps:
        try:
            if step in fail_at:
                fail_at.discard(step)
                raise RuntimeError(f"injected worker failure at step {step}")
            state = step_fn(step, state)
            step += 1
            stats.completed_steps += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt_lib.save(ckpt_dir, step, state)
        except RuntimeError:
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise
            last = ckpt_lib.latest_step(ckpt_dir)
            if last is None:
                step = 0
                stats.wasted_steps += stats.completed_steps
            else:
                state, _ = ckpt_lib.restore(ckpt_dir, state)
                stats.wasted_steps += step - int(state["step"])
                step = int(state["step"])
    return state, stats
