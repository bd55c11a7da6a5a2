"""Preprocessing pipeline configuration
(a copy of ``splade_tpu/preprocessing/config.py``).

Implements the reference's missing ``PipelineConfig`` contract (SURVEY.md §0;
fields inferred from src/preprocessing/pipeline.py:108-130,196-217,386-392).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class PipelineConfig:
    output_dir: str = "data/processed"
    cache_dir: str = "data/cache"
    datasets: List[str] = field(default_factory=list)
    """Dataset registry keys to include (empty = all registered)."""

    # Cleaning
    min_hangul_ratio: float = 0.1
    max_special_char_ratio: float = 0.3
    min_length: int = 5
    max_seq_length: int = 512

    # Dedup
    dedup_threshold: float = 0.8
    minhash_permutations: int = 128

    # Mining
    use_bge_m3_mining: bool = False
    mining_batch_size: int = 64
    mining_min_score: float = 0.3
    mining_max_score: float = 0.85

    # Output
    shard_size: int = 100_000
    train_val_split: float = 0.98
    seed: int = 42
