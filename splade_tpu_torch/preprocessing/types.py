"""Core data types of the preprocessing tier
(a copy of ``splade_tpu/preprocessing/types.py``).

Reference: src/preprocessing/downloaders/base.py (RawSample) and
src/preprocessing/converters/base.py:11-102 (Triplet dataclass).
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional


@dataclass
class RawSample:
    """One example from a source dataset, pre-conversion."""

    source: str
    task: str                      # nli | qa | sts | classification | dialog | pair
    fields: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Triplet:
    """One training triplet (the JSONL row schema consumed by training)."""

    query: str
    positive: str
    negative: Optional[str] = None
    negatives: Optional[List[str]] = None
    pair_type: str = ""
    difficulty: str = ""
    source: str = ""
    teacher_pos_score: Optional[float] = None
    teacher_neg_scores: Optional[List[float]] = None

    def to_json_dict(self) -> Dict[str, Any]:
        d = {"query": self.query, "positive": self.positive}
        if self.negatives:
            d["negatives"] = self.negatives
        elif self.negative:
            d["negative"] = self.negative
        for k in ("pair_type", "difficulty", "source"):
            v = getattr(self, k)
            if v:
                d[k] = v
        if self.teacher_pos_score is not None:
            d["teacher_pos_score"] = self.teacher_pos_score
        if self.teacher_neg_scores:
            d["teacher_neg_scores"] = self.teacher_neg_scores
        return d

    def is_valid(self) -> bool:
        return bool(self.query and self.positive and self.query != self.positive)
