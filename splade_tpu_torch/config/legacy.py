"""Legacy (V22-era) training knobs with validation
(a copy of ``splade_tpu/config/legacy.py``).

Reference: src/train/config/base.py:12-213 — the pre-V33 configuration
surface (per-component loss weights, curriculum temperature, activation
floors) kept so historical experiment configs parse and their recipes can be
reproduced. V33+ recipes use `splade_tpu_torch.config.v33`; these knobs exist for
experiment-archaeology parity only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class LegacyLossConfig:
    lambda_infonce: float = 1.0
    lambda_self: float = 0.0
    lambda_positive: float = 0.0
    lambda_margin: float = 0.0
    lambda_flops: float = 1e-3
    lambda_min_act: float = 0.0
    margin: float = 0.2
    temperature: float = 0.05
    curriculum_temperature: float = 1.0
    use_idf_weighting: bool = False
    use_language_penalty: bool = False
    use_context_gate: bool = False

    def validate(self) -> List[str]:
        """Return a list of problems (empty = valid); mirrors the reference's
        validate() contract (config/base.py)."""
        problems = []
        for name in ("lambda_infonce", "lambda_self", "lambda_positive",
                     "lambda_margin", "lambda_flops", "lambda_min_act"):
            if getattr(self, name) < 0:
                problems.append(f"{name} must be >= 0")
        if self.temperature <= 0:
            problems.append("temperature must be > 0")
        if not 0 <= self.margin <= 2:
            problems.append("margin must be in [0, 2]")
        if self.curriculum_temperature <= 0:
            problems.append("curriculum_temperature must be > 0")
        if self.lambda_infonce == 0 and self.lambda_margin == 0:
            problems.append("at least one ranking loss must be enabled")
        return problems


@dataclass
class LegacyTrainConfig:
    model_name: str = "klue/bert-base"
    batch_size: int = 32
    learning_rate: float = 2e-5
    num_epochs: int = 10
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    loss: LegacyLossConfig = field(default_factory=LegacyLossConfig)

    def validate(self) -> List[str]:
        problems = []
        if self.batch_size <= 0:
            problems.append("batch_size must be > 0")
        if self.learning_rate <= 0:
            problems.append("learning_rate must be > 0")
        if self.num_epochs <= 0:
            problems.append("num_epochs must be > 0")
        problems.extend(self.loss.validate())
        return problems
