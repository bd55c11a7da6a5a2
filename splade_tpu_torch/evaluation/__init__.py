from splade_tpu_torch.evaluation.ranking_metrics import (
    EvaluationDataset,
    GradedRelevance,
    ModelComparison,
    RankingMetrics,
    builtin_korean_eval_set,
)

__all__ = [
    "GradedRelevance",
    "EvaluationDataset",
    "RankingMetrics",
    "ModelComparison",
    "builtin_korean_eval_set",
]
