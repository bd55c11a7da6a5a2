"""Benchmark harness (port of splade_tpu.benchmark): retrieval-quality
evaluation with BM25, dense, neural-sparse and hybrid searchers over exact
CPU indexes or the port's device indexes, and the encoders that feed them.
"""

from splade_tpu_torch.benchmark.metrics import (
    QueryResult,
    aggregate_metrics,
    bootstrap_ci,
    paired_t_test,
)
from splade_tpu_torch.benchmark.fusion import (
    LinearFusion,
    RRFFusion,
    WeightedRRFFusion,
    create_fusion,
)

__all__ = [
    "QueryResult",
    "aggregate_metrics",
    "bootstrap_ci",
    "paired_t_test",
    "RRFFusion",
    "LinearFusion",
    "WeightedRRFFusion",
    "create_fusion",
]
