"""Searchers: timed retrieval methods over in-process indexes.

Reference: benchmark/searchers.py:36-276 (BaseSearcher timing + BM25 /
Semantic / NeuralSparse / Hybrid) and benchmark/hybrid_searcher.py:37-644
(late-fusion searchers and the 8 named hybrid methods).

The port's own copy of ``splade_tpu/benchmark/searchers.py``, which
imports no framework.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from splade_tpu_torch.benchmark.bm25 import BM25Index
from splade_tpu_torch.benchmark.fusion import LinearFusion, RRFFusion, WeightedRRFFusion
from splade_tpu_torch.benchmark.index import ExactDenseIndex, ExactSparseIndex

Ranked = List[Tuple[str, float]]


@dataclass
class SearchResult:
    doc_scores: Ranked
    latency_ms: float

    @property
    def doc_ids(self) -> List[str]:
        return [d for d, _ in self.doc_scores]


class BaseSearcher:
    """Timed search wrapper (reference: searchers.py:36-76)."""

    name = "base"

    def _search(self, query: str, k: int) -> Ranked:
        raise NotImplementedError

    def search(self, query: str, k: int = 10) -> SearchResult:
        t0 = time.perf_counter()
        ranked = self._search(query, k)
        return SearchResult(ranked, (time.perf_counter() - t0) * 1000.0)


class BM25Searcher(BaseSearcher):
    name = "bm25"

    def __init__(self, index: BM25Index):
        self.index = index

    def _search(self, query: str, k: int) -> Ranked:
        return self.index.search(query, k)


class NeuralSparseSearcher(BaseSearcher):
    """SPLADE query encode (top-64 tokens) -> exact or device sparse index.

    Reference: searchers.py:130-186.
    """

    name = "neural_sparse"

    def __init__(self, encoder, index):
        self.encoder = encoder
        self.index = index

    def _search(self, query: str, k: int) -> Ranked:
        idx, vals = self.encoder.encode_for_query(query)
        return self.index.search_vector(idx, vals, k)


class DenseSearcher(BaseSearcher):
    """Dense encoder -> exact inner-product index (reference SemanticSearcher)."""

    name = "semantic"

    def __init__(self, encoder, index: ExactDenseIndex, name: str = "semantic"):
        self.encoder = encoder
        self.index = index
        self.name = name

    def _search(self, query: str, k: int) -> Ranked:
        vec = self.encoder.encode([query])[0]
        return self.index.search(vec, k)


class FusionSearcher(BaseSearcher):
    """Late fusion over sub-searchers: retrieve retrieval_k from each, fuse,
    return top-k (reference: hybrid_searcher.py:104-149; retrieval_k=100)."""

    def __init__(self, name: str, searchers: Sequence[BaseSearcher], fusion,
                 retrieval_k: int = 100):
        self.name = name
        self.searchers = list(searchers)
        self.fusion = fusion
        self.retrieval_k = retrieval_k

    def _search(self, query: str, k: int) -> Ranked:
        lists = [s._search(query, self.retrieval_k) for s in self.searchers]
        return self.fusion.fuse(lists, top_k=k)


def create_searchers(
    bm25_index: Optional[BM25Index] = None,
    sparse_encoder=None,
    sparse_index=None,
    dense_encoder=None,
    dense_index: Optional[ExactDenseIndex] = None,
) -> Dict[str, BaseSearcher]:
    """Base searchers (reference: searchers.py:240-276)."""
    out: Dict[str, BaseSearcher] = {}
    if bm25_index is not None:
        out["bm25"] = BM25Searcher(bm25_index)
    if sparse_encoder is not None and sparse_index is not None:
        out["neural_sparse"] = NeuralSparseSearcher(sparse_encoder, sparse_index)
    if dense_encoder is not None and dense_index is not None:
        out["semantic"] = DenseSearcher(dense_encoder, dense_index)
    return out


def create_hybrid_searchers(
    base: Dict[str, BaseSearcher], retrieval_k: int = 100
) -> Dict[str, BaseSearcher]:
    """The 8 named hybrid methods (reference: hybrid_searcher.py:539-644).

    Built from whichever base searchers exist: bm25_semantic_rrf, hybrid_rrf
    (sparse+dense), hybrid_linear_{0.3,0.4,0.5} (alpha on sparse),
    hybrid_weighted_rrf, bm25_sparse_rrf, triple_rrf.
    """
    out: Dict[str, BaseSearcher] = {}
    bm25 = base.get("bm25")
    sparse = base.get("neural_sparse")
    dense = base.get("semantic")

    def add(name, searchers, fusion):
        out[name] = FusionSearcher(name, searchers, fusion, retrieval_k)

    if bm25 and dense:
        add("bm25_semantic_rrf", [bm25, dense], RRFFusion())
    if sparse and dense:
        add("hybrid_rrf", [sparse, dense], RRFFusion())
        for alpha in (0.3, 0.4, 0.5):
            add(f"hybrid_linear_{alpha}", [sparse, dense], LinearFusion(alpha))
        add("hybrid_weighted_rrf", [sparse, dense],
            WeightedRRFFusion(weights=[0.4, 0.6]))
    if bm25 and sparse:
        add("bm25_sparse_rrf", [bm25, sparse], RRFFusion())
    if bm25 and sparse and dense:
        add("triple_rrf", [bm25, sparse, dense], RRFFusion())

    # Cross-model hybrids with an external embedding model (reference:
    # scripts/run_comprehensive_benchmark.py — Bedrock Titan + cross-model
    # fusions). Present only when an ``external_dense`` searcher exists.
    ext = base.get("external_dense")
    if ext and sparse:
        add("sparse_external_rrf", [sparse, ext], RRFFusion())
    if ext and dense:
        add("dual_dense_rrf", [dense, ext], RRFFusion())
    if ext and bm25 and sparse and dense:
        add("quad_rrf", [bm25, sparse, dense, ext], RRFFusion())
    return out
