"""Training-triplet loading from JSONL shards (a copy of
``splade_tpu/data/loader.py``).

Implements the contract of the reference's missing ``load_training_data``
(inferred from call sites, SURVEY.md §0; reference:
src/train/cli/train_v33_ddp.py:43,511,517): expand glob patterns, parse JSONL
rows with fields ``query``, ``positive``, ``negative`` or ``negatives: [...]``,
optional ``teacher_pos_score`` / ``teacher_neg_score(s)``, ``pair_type``,
``difficulty``; return a map-style dataset of dicts consumed by the collator.
"""

from __future__ import annotations

import glob
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Sequence

logger = logging.getLogger(__name__)

_REQUIRED = ("query", "positive")


class TripletDataset:
    """Map-style in-memory dataset of triplet dicts."""

    def __init__(self, samples: List[Dict[str, Any]]):
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.samples[idx]

    def __iter__(self):
        return iter(self.samples)


def parse_jsonl_line(line: str) -> Dict[str, Any] | None:
    line = line.strip()
    if not line:
        return None
    try:
        row = json.loads(line)
    except json.JSONDecodeError:
        return None
    if not all(isinstance(row.get(k), str) and row[k] for k in _REQUIRED):
        return None
    return row


def load_training_data(
    patterns: Sequence[str] | str, max_samples: int = 0
) -> TripletDataset:
    """Expand glob patterns and load JSONL triplets.

    Args:
        patterns: one or more glob patterns (e.g. ``data/v29.0/train_*.jsonl``).
        max_samples: optional cap (0 = all), for debug/smoke runs.
    """
    if isinstance(patterns, str):
        patterns = [patterns]
    files: List[str] = []
    for pat in patterns:
        matched = sorted(glob.glob(pat))
        if not matched and Path(pat).exists():
            matched = [pat]
        files.extend(matched)
    if not files:
        raise FileNotFoundError(f"no training files match {list(patterns)}")
    samples: List[Dict[str, Any]] = []
    skipped = 0
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            for line in f:
                row = parse_jsonl_line(line)
                if row is None:
                    skipped += 1
                    continue
                samples.append(row)
                if max_samples and len(samples) >= max_samples:
                    break
        if max_samples and len(samples) >= max_samples:
            break
    logger.info("loaded %d triplets from %d files (%d skipped)",
                len(samples), len(files), skipped)
    return TripletDataset(samples)
