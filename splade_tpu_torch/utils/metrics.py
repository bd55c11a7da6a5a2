"""Training-metrics tracking: EMA, windowed averages, JSONL run log (a copy
of ``splade_tpu/utils/metrics.py``).

Reference behavior: src/train/utils/metrics.py:18-343 (TrainingMetrics record,
MovingAverage EMA, WindowedAverage, MetricsTracker with metrics.jsonl append
log + summary.json + best-metric tracking, throughput helper).
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Mapping, Optional


class MovingAverage:
    """Exponential moving average (reference: utils/metrics.py:127-160)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else self.decay * self.value + (1 - self.decay) * x
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


class WindowedAverage:
    """Mean over the last N updates (reference: utils/metrics.py:163-195)."""

    def __init__(self, window: int = 100):
        self.buf: deque = deque(maxlen=window)

    def update(self, x: float) -> float:
        self.buf.append(float(x))
        return self.get()

    def get(self, default: float = 0.0) -> float:
        return sum(self.buf) / len(self.buf) if self.buf else default


class MetricsTracker:
    """Append-only JSONL metrics log + best tracking + summary.json.

    Reference: src/train/utils/metrics.py:198-320.
    """

    def __init__(self, output_dir: str, best_metric: str = "loss",
                 best_mode: str = "min", enabled: bool = True):
        """enabled=False: track best values in memory but write nothing —
        used by non-zero processes of a multi-host run so a shared
        output_dir isn't appended to by every host (reference logs rank-0
        only, train_v33_ddp.py:377-442)."""
        self.enabled = enabled
        self.output_dir = Path(output_dir)
        if enabled:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.output_dir / "metrics.jsonl"
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.best_value: Optional[float] = None
        self.best_step: Optional[int] = None
        self.num_records = 0
        self._start = time.time()

    def log(self, step: int, metrics: Mapping[str, Any], **extra: Any) -> Dict[str, Any]:
        record: Dict[str, Any] = {"step": step, "time": time.time() - self._start}
        record.update({k: _to_float(v) for k, v in metrics.items()})
        record.update(extra)
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        self.num_records += 1
        val = record.get(self.best_metric)
        if isinstance(val, (int, float)):
            better = (
                self.best_value is None
                or (self.best_mode == "min" and val < self.best_value)
                or (self.best_mode == "max" and val > self.best_value)
            )
            if better:
                self.best_value, self.best_step = float(val), step
        return record

    def summary(self) -> Dict[str, Any]:
        s = {
            "num_records": self.num_records,
            "best_metric": self.best_metric,
            "best_value": self.best_value,
            "best_step": self.best_step,
            "elapsed_sec": time.time() - self._start,
        }
        if self.enabled:
            (self.output_dir / "summary.json").write_text(json.dumps(s, indent=2))
        return s


def _to_float(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def compute_throughput(num_samples: int, elapsed_sec: float) -> float:
    """Samples/sec (reference: utils/metrics.py:322-343)."""
    return num_samples / elapsed_sec if elapsed_sec > 0 else 0.0
