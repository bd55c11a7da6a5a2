"""Offline data-construction tier
(a copy of ``splade_tpu/preprocessing/__init__.py``).

Reference: src/preprocessing/ (pipeline, downloaders, converters, cleaners,
miners) — builds training triplets from raw Korean datasets: download ->
convert -> clean -> dedup -> (mine negatives) -> shuffle -> split -> shard.
"""

from splade_tpu_torch.preprocessing.types import RawSample, Triplet
from splade_tpu_torch.preprocessing.config import PipelineConfig
from splade_tpu_torch.preprocessing.cleaners import KoreanTextCleaner
from splade_tpu_torch.preprocessing.dedup import ExactDeduplicator, MinHashDeduplicator
from splade_tpu_torch.preprocessing.pipeline import PreprocessingPipeline

__all__ = [
    "RawSample",
    "Triplet",
    "PipelineConfig",
    "KoreanTextCleaner",
    "ExactDeduplicator",
    "MinHashDeduplicator",
    "PreprocessingPipeline",
]
