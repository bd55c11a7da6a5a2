"""Late-fusion score combination for hybrid retrieval.

Reference: benchmark/score_fusion.py:45-255 — RRF (1/(60+rank), missing docs
penalized at list length + 1), Linear (per-list min-max normalization +
alpha blend), Weighted RRF, and a string factory.

The port's own copy of ``splade_tpu/benchmark/fusion.py``, which
imports no framework.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Ranked = Sequence[Tuple[str, float]]  # (doc_id, score) best-first


class RRFFusion:
    """Reciprocal-rank fusion: sum_i 1/(k + rank_i(doc))."""

    def __init__(self, k: int = 60):
        self.k = k

    def fuse(self, result_lists: Sequence[Ranked], top_k: int = 10) -> List[Tuple[str, float]]:
        # Two passes over the union of docs so the missing-doc penalty is
        # symmetric: a doc first retrieved by a LATER list still pays every
        # earlier list's penalty (a single incremental pass skews fused
        # scores toward docs from earlier-listed searchers). Penalty rank =
        # max(list length + 1, 100) shared across lists (reference:
        # score_fusion.py:74-92).
        ranks = [
            {doc: rank for rank, (doc, _) in enumerate(results, start=1)}
            for results in result_lists
        ]
        penalty = max([len(r) + 1 for r in result_lists] + [100])
        union = set().union(*ranks) if ranks else set()
        scores: Dict[str, float] = {}
        for doc in union:
            scores[doc] = sum(1.0 / (self.k + r.get(doc, penalty))
                              for r in ranks)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:top_k]


class LinearFusion:
    """alpha * norm(first) + (1-alpha) * norm(second), min-max per list."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha

    @staticmethod
    def _normalize(results: Ranked) -> Dict[str, float]:
        if not results:
            return {}
        vals = [s for _, s in results]
        lo, hi = min(vals), max(vals)
        if hi - lo < 1e-12:
            return {d: 1.0 for d, _ in results}
        return {d: (s - lo) / (hi - lo) for d, s in results}

    def fuse(self, result_lists: Sequence[Ranked], top_k: int = 10) -> List[Tuple[str, float]]:
        assert len(result_lists) == 2, "LinearFusion blends exactly two lists"
        a = self._normalize(result_lists[0])
        b = self._normalize(result_lists[1])
        scores: Dict[str, float] = {}
        for doc in set(a) | set(b):
            scores[doc] = self.alpha * a.get(doc, 0.0) + (1 - self.alpha) * b.get(doc, 0.0)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:top_k]


class WeightedRRFFusion:
    """RRF with per-list weights (reference: score_fusion.py:175-229)."""

    def __init__(self, weights: Sequence[float], k: int = 60):
        self.weights = list(weights)
        self.k = k

    def fuse(self, result_lists: Sequence[Ranked], top_k: int = 10) -> List[Tuple[str, float]]:
        assert len(result_lists) == len(self.weights)
        ranks = [
            {doc: rank for rank, (doc, _) in enumerate(results, start=1)}
            for results in result_lists
        ]
        # same shared missing-doc penalty as RRF (reference :205-221)
        penalty = max([len(r) + 1 for r in result_lists] + [100])
        union = set().union(*ranks) if ranks else set()
        scores: Dict[str, float] = {}
        for doc in union:
            scores[doc] = sum(w / (self.k + r.get(doc, penalty))
                              for w, r in zip(self.weights, ranks))
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:top_k]


def create_fusion(method: str, **kwargs):
    """Factory (reference: score_fusion.py:232-255)."""
    method = method.lower()
    if method == "rrf":
        return RRFFusion(**kwargs)
    if method == "linear":
        return LinearFusion(**kwargs)
    if method in ("weighted_rrf", "weighted-rrf"):
        return WeightedRRFFusion(**kwargs)
    raise ValueError(f"unknown fusion method: {method}")
