"""Standalone λ schedulers with resumable state (a copy of
``splade_tpu/losses/schedules.py``; nothing in it touches an array library).

Reference: src/train/schedulers/lambda_scheduler.py:45-140 (Quadratic /
Linear / Exponential schedulers with state_dict round-trip). The V33 trainer
uses the inline schedule in the loss (``losses/v33.py``), here as in the JAX
package; these classes exist for experiment-tooling parity and offline
analysis, and no training path calls them.
"""

from __future__ import annotations

import math
from typing import Any, Dict


class BaseLambdaScheduler:
    def __init__(self, target_lambda: float, warmup_steps: int):
        self.target_lambda = target_lambda
        self.warmup_steps = max(int(warmup_steps), 1)
        self.step_count = 0

    def _ratio(self, t: float) -> float:
        raise NotImplementedError

    def get_lambda(self, step: int | None = None) -> float:
        s = self.step_count if step is None else step
        t = min(s / self.warmup_steps, 1.0)
        return self.target_lambda * self._ratio(t)

    def step(self) -> float:
        self.step_count += 1
        return self.get_lambda()

    def state_dict(self) -> Dict[str, Any]:
        return {
            "target_lambda": self.target_lambda,
            "warmup_steps": self.warmup_steps,
            "step_count": self.step_count,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.target_lambda = state["target_lambda"]
        self.warmup_steps = state["warmup_steps"]
        self.step_count = state["step_count"]


class QuadraticLambdaScheduler(BaseLambdaScheduler):
    """λ(t) = target · (t/T)² (reference: lambda_scheduler.py:45-65)."""

    def _ratio(self, t: float) -> float:
        return t * t


class LinearLambdaScheduler(BaseLambdaScheduler):
    def _ratio(self, t: float) -> float:
        return t


class ExponentialLambdaScheduler(BaseLambdaScheduler):
    """λ(t) = target · (e^(k·t) − 1)/(e^k − 1), k controls curvature."""

    def __init__(self, target_lambda: float, warmup_steps: int, k: float = 5.0):
        super().__init__(target_lambda, warmup_steps)
        self.k = k

    def _ratio(self, t: float) -> float:
        return (math.exp(self.k * t) - 1.0) / (math.exp(self.k) - 1.0)

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d["k"] = self.k
        return d

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self.k = state.get("k", self.k)
