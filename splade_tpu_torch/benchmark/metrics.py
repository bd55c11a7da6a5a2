"""Retrieval metrics: Recall@k, MRR, nDCG@10, latency percentiles,
significance tests.

Reference: benchmark/metrics.py:14-215 (QueryResult with auto hit_rank,
Recall@{1,5,10}, MRR, binary-relevance nDCG@10, latency p50/p95/p99/mean,
paired t-test on reciprocal ranks, bootstrap CI).

The port's own copy of ``splade_tpu/benchmark/metrics.py``, which
imports no framework.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


@dataclass
class QueryResult:
    """One query's retrieval outcome."""

    query_id: str
    retrieved_ids: List[str]
    relevant_ids: Set[str]
    latency_ms: float = 0.0
    hit_rank: Optional[int] = field(default=None)

    def __post_init__(self) -> None:
        if self.hit_rank is None:
            self.hit_rank = next(
                (i + 1 for i, d in enumerate(self.retrieved_ids)
                 if d in self.relevant_ids), None)

    @property
    def reciprocal_rank(self) -> float:
        return 1.0 / self.hit_rank if self.hit_rank else 0.0


def recall_at_k(results: Sequence[QueryResult], k: int) -> float:
    if not results:
        return 0.0
    hits = sum(1 for r in results if r.hit_rank is not None and r.hit_rank <= k)
    return hits / len(results)


def mrr(results: Sequence[QueryResult]) -> float:
    if not results:
        return 0.0
    return float(np.mean([r.reciprocal_rank for r in results]))


def ndcg_at_k(result: QueryResult, k: int = 10) -> float:
    """Binary-relevance nDCG@k (reference: benchmark/metrics.py:76-100)."""
    dcg = 0.0
    for i, doc in enumerate(result.retrieved_ids[:k]):
        if doc in result.relevant_ids:
            dcg += 1.0 / math.log2(i + 2)
    ideal = min(len(result.relevant_ids), k)
    idcg = sum(1.0 / math.log2(i + 2) for i in range(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def latency_stats(results: Sequence[QueryResult]) -> Dict[str, float]:
    lats = np.asarray([r.latency_ms for r in results]) if results else np.zeros(1)
    return {
        "latency_p50_ms": float(np.percentile(lats, 50)),
        "latency_p95_ms": float(np.percentile(lats, 95)),
        "latency_p99_ms": float(np.percentile(lats, 99)),
        "latency_mean_ms": float(np.mean(lats)),
    }


def aggregate_metrics(results: Sequence[QueryResult]) -> Dict[str, float]:
    out = {
        "num_queries": float(len(results)),
        "recall@1": recall_at_k(results, 1),
        "recall@5": recall_at_k(results, 5),
        "recall@10": recall_at_k(results, 10),
        "mrr": mrr(results),
        "ndcg@10": float(np.mean([ndcg_at_k(r, 10) for r in results])) if results else 0.0,
    }
    out.update(latency_stats(results))
    return out


def paired_t_test_values(
    a: Sequence[float], b: Sequence[float]
) -> Dict[str, float]:
    """Paired two-sided t-test over aligned per-item values — the ONE
    implementation (evaluation/ranking_metrics.py delegates here; two
    drifting copies once returned opposite verdicts for a constant nonzero
    difference). No scipy in the hot path: p-value via the regularized
    incomplete beta.

    Zero variance: a constant nonzero difference is infinitely significant
    (p -> 0); an identically-zero difference is no evidence (p = 1).
    """
    xa = np.asarray(a, dtype=np.float64)
    xb = np.asarray(b, dtype=np.float64)
    assert len(xa) == len(xb), "paired test needs aligned query sets"
    d = xa - xb
    n = len(d)
    if n < 2:
        return {"t_statistic": 0.0, "p_value": 1.0,
                "mean_diff": float(d.mean() if n else 0)}
    if np.allclose(d.std(ddof=1), 0):
        if np.allclose(d.mean(), 0):
            return {"t_statistic": 0.0, "p_value": 1.0, "mean_diff": 0.0}
        return {"t_statistic": float("inf"), "p_value": 0.0,
                "mean_diff": float(d.mean())}
    t = d.mean() / (d.std(ddof=1) / math.sqrt(n))
    df = n - 1
    # two-sided p-value via incomplete beta I_{df/(df+t^2)}(df/2, 1/2)
    x = df / (df + t * t)
    p = _betainc(df / 2.0, 0.5, x)
    return {"t_statistic": float(t), "p_value": float(p), "mean_diff": float(d.mean())}


def paired_t_test(
    a: Sequence[QueryResult], b: Sequence[QueryResult]
) -> Dict[str, float]:
    """Paired t-test on reciprocal ranks (reference: metrics.py:148-180)."""
    return paired_t_test_values([r.reciprocal_rank for r in a],
                                [r.reciprocal_rank for r in b])


def bootstrap_ci(
    results: Sequence[QueryResult],
    metric: str = "recall@1",
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 42,
) -> Dict[str, float]:
    """Percentile bootstrap CI (reference: metrics.py:183-215).

    Per-query values are computed ONCE and resampled vectorized — the naive
    form (full aggregate_metrics per resample) recomputes every metric and
    four percentile sorts n_boot times just to read one number."""
    rng = np.random.default_rng(seed)
    n = len(results)
    if n == 0:
        return {"lower": 0.0, "upper": 0.0, "mean": 0.0}
    if metric.startswith("recall@"):
        k = int(metric.split("@")[1])
        per_q = np.asarray([1.0 if (r.hit_rank and r.hit_rank <= k) else 0.0
                            for r in results])
    elif metric == "mrr":
        per_q = np.asarray([r.reciprocal_rank for r in results])
    elif metric.startswith("ndcg@"):
        k = int(metric.split("@")[1])
        per_q = np.asarray([ndcg_at_k(r, k) for r in results])
    elif metric.startswith("latency"):
        per_q = np.asarray([r.latency_ms for r in results])
    else:
        raise ValueError(f"bootstrap_ci: unsupported metric {metric!r}")
    idx = rng.integers(0, n, size=(n_boot, n))
    samples = per_q[idx]                                  # [n_boot, n]
    if metric.startswith("latency_p"):
        q = float(metric.split("_p")[1].split("_")[0])
        vals = np.percentile(samples, q, axis=1)
    else:
        vals = samples.mean(axis=1)
    return {
        "lower": float(np.percentile(vals, 100 * alpha / 2)),
        "upper": float(np.percentile(vals, 100 * (1 - alpha / 2))),
        "mean": float(vals.mean()),
    }


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a,b) via continued fraction
    (Numerical Recipes betacf form)."""
    if x <= 0:
        return 0.0
    if x >= 1:
        return 1.0
    ln_beta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    front = math.exp(a * math.log(x) + b * math.log(1 - x) - ln_beta)
    if x < (a + 1) / (a + b + 2):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1 - x) / b


def _betacf(a: float, b: float, x: float, max_iter: int = 200, eps: float = 3e-12) -> float:
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < 1e-30:
        d = 1e-30
    d = 1.0 / d
    h = d
    for m in range(1, max_iter + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h
