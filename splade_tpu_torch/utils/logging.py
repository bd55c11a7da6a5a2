"""Logging + scalar metric writing (console, file, TensorBoard-optional); a
copy of ``splade_tpu/utils/logging.py``.

Covers the reference observability channel set (reference:
src/train/utils/logging.py:38-319): colored console formatter, optional file
handler, and a scalar writer. TensorBoard is used when it imports (it need
not be installed); a JSONL event log is always written so runs are
inspectable without it.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Optional

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):
    """Colored level names on TTYs (reference: utils/logging.py:38-66)."""

    def __init__(self, use_color: bool = True):
        super().__init__("%(asctime)s | %(levelname)-7s | %(name)s | %(message)s",
                         datefmt="%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


def setup_logging(
    log_file: Optional[str] = None,
    level: int = logging.INFO,
    is_main_process: bool = True,
) -> logging.Logger:
    """Configure the root logger; non-main processes log warnings only.

    Reference: src/train/utils/logging.py:69-121 (rank-0-only file handler).
    """
    root = logging.getLogger()
    root.setLevel(level if is_main_process else logging.WARNING)
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(ColorFormatter(use_color=sys.stderr.isatty()))
    root.addHandler(console)
    if log_file and is_main_process:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(ColorFormatter(use_color=False))
        root.addHandler(fh)
    return root


class MetricWriter:
    """Scalar writer: TensorBoard when importable + always-on JSONL events.

    Replaces the reference TensorBoardLogger (reference:
    src/train/utils/logging.py:124-319) with a dual-sink design so headless
    runs stay inspectable.
    """

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = Path(log_dir)
        self._tb = None
        self._events = None
        if not enabled:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.log_dir / "events.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(str(self.log_dir))
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._events is not None:
            self._events.write(
                json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n"
            )

    def scalars(self, values: Mapping[str, Any], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            try:
                self.scalar(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                pass
        if self._events is not None:
            self._events.flush()

    def text(self, tag: str, text: str, step: int = 0) -> None:
        """Free-text event (reference: log_text, logging.py:224-240) —
        JSONL always, TB when available."""
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_text(tag, text, step)
        if self._events is not None:
            self._events.write(json.dumps(
                {"t": time.time(), "step": step, "text": {tag: text}}) + "\n")
            self._events.flush()

    def histogram(self, tag: str, values, step: int, bins: int = 32) -> None:
        """Distribution event (reference: log_histogram, logging.py:207-223).

        TB gets the raw histogram; the JSONL sink records summary stats +
        fixed-bin counts so headless runs keep the distribution shape."""
        if not self.enabled:
            return
        import numpy as np

        arr = np.asarray(values, np.float64).reshape(-1)
        if arr.size == 0:
            return
        if self._tb is not None:
            self._tb.add_histogram(tag, arr, step)
        if self._events is not None:
            counts, edges = np.histogram(arr, bins=bins)
            self._events.write(json.dumps({
                "t": time.time(), "step": step, "histogram": {tag: {
                    "count": int(arr.size),
                    "mean": float(arr.mean()), "std": float(arr.std()),
                    "min": float(arr.min()), "max": float(arr.max()),
                    "p50": float(np.percentile(arr, 50)),
                    "p95": float(np.percentile(arr, 95)),
                    "bin_edges": [round(float(e), 6) for e in edges],
                    "bin_counts": [int(c) for c in counts],
                }}}) + "\n")
            self._events.flush()

    def hparams(self, params: Mapping[str, Any],
                metrics: Optional[Mapping[str, float]] = None) -> None:
        """Run hyperparameters (+ optional final metrics) — reference:
        log_hparams, logging.py:241-254."""
        if not self.enabled:
            return
        clean = {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                 for k, v in params.items()}
        if self._tb is not None:
            try:
                self._tb.add_hparams(clean, dict(metrics or {}),
                                     run_name=".")
            except Exception:  # older TB without run_name etc.
                pass
        if self._events is not None:
            self._events.write(json.dumps(
                {"t": time.time(), "hparams": clean,
                 "hparam_metrics": dict(metrics or {})}) + "\n")
            self._events.flush()

    # Convenience wrappers matching the reference logger's step/epoch API
    # (reference: log_training_step :255-279, log_epoch :280-304).
    def log_training_step(self, step: int, loss: float, learning_rate: float,
                          loss_components: Optional[Mapping[str, float]] = None
                          ) -> None:
        self.scalar("train/loss", loss, step)
        self.scalar("train/learning_rate", learning_rate, step)
        for name, value in (loss_components or {}).items():
            self.scalar(f"train/loss_{name}", value, step)
        if self._events is not None:
            self._events.flush()

    def log_epoch(self, epoch: int, train_loss: float,
                  val_loss: Optional[float] = None,
                  metrics: Optional[Mapping[str, float]] = None) -> None:
        self.scalar("epoch/train_loss", train_loss, epoch)
        if val_loss is not None:
            self.scalar("epoch/val_loss", val_loss, epoch)
        for name, value in (metrics or {}).items():
            self.scalar(f"epoch/{name}", value, epoch)
        if self._events is not None:
            self._events.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._events is not None:
            self._events.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
