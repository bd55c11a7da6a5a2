"""In-memory exact index backends (CPU reference implementations).

These replace the reference's OpenSearch indices (reference:
benchmark/index_manager.py:81-147 dense HNSW and sparse rank_features DDLs)
with in-process exact search, giving a correctness oracle for the device impact
index and an air-gapped benchmark path.

- ExactSparseIndex: CSR-stored [N, V] impact vectors, exact dot-product
  top-k. (The reference's nonzero->python-dict conversion, encoders.py:160-182,
  is eliminated: vectors stay as arrays end to end.)
- ExactDenseIndex: normalized dense vectors, exact inner-product top-k.

The port's own copy of ``splade_tpu/benchmark/index.py``, which
imports no framework.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class ExactSparseIndex:
    """Exact sparse dot-product search over CSR impact vectors."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.doc_ids: List[str] = []
        self._indptr = [0]
        self._indices: List[np.ndarray] = []
        self._values: List[np.ndarray] = []
        self._csr = None

    def add(self, doc_id: str, indices: np.ndarray, values: np.ndarray) -> None:
        self.doc_ids.append(doc_id)
        self._indices.append(np.asarray(indices, np.int32))
        self._values.append(np.asarray(values, np.float32))
        self._csr = None

    def add_dense(self, doc_id: str, vec: np.ndarray, top_k: int = 0) -> None:
        """Add from a dense [V] vector, keeping nonzeros (optionally top-k)."""
        nz = np.flatnonzero(vec > 0)
        vals = vec[nz]
        if top_k and len(nz) > top_k:
            keep = np.argpartition(-vals, top_k - 1)[:top_k]
            nz, vals = nz[keep], vals[keep]
        self.add(doc_id, nz, vals)

    def _build(self):
        from scipy import sparse

        indptr = np.zeros(len(self._indices) + 1, np.int64)
        for i, idx in enumerate(self._indices):
            indptr[i + 1] = indptr[i] + len(idx)
        data = (np.concatenate(self._values) if self._values
                else np.zeros(0, np.float32))
        cols = (np.concatenate(self._indices) if self._indices
                else np.zeros(0, np.int32))
        self._csr = sparse.csr_matrix(
            (data, cols, indptr), shape=(len(self.doc_ids), self.vocab_size))

    def search_vector(
        self, indices: np.ndarray, values: np.ndarray, k: int = 10
    ) -> List[Tuple[str, float]]:
        if self._csr is None:
            self._build()
        q = np.zeros(self.vocab_size, np.float32)
        q[np.asarray(indices, np.int64)] = np.asarray(values, np.float32)
        scores = self._csr @ q  # [N]
        k = min(k, len(scores))
        if k == 0:
            return []
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.lexsort((top, -scores[top]))]
        # zero score = no term overlap = not a hit. Returning a fabricated
        # rank-1 doc here would credit recall/MRR by chance and hand RRF
        # fusion 1/(60+1) for an arbitrary doc.
        return [(self.doc_ids[i], float(scores[i])) for i in top
                if scores[i] > 0]

    def search_dense(self, vec: np.ndarray, k: int = 10, query_top_k: int = 0
                     ) -> List[Tuple[str, float]]:
        nz = np.flatnonzero(vec > 0)
        vals = vec[nz]
        if query_top_k and len(nz) > query_top_k:
            keep = np.argpartition(-vals, query_top_k - 1)[:query_top_k]
            nz, vals = nz[keep], vals[keep]
        return self.search_vector(nz, vals, k)

    def __len__(self) -> int:
        return len(self.doc_ids)

    @property
    def nnz(self) -> int:
        return int(sum(len(v) for v in self._values))


class ExactDenseIndex:
    """Exact inner-product search (reference dense path used normalized
    BGE-M3 embeddings with innerproduct HNSW; exact IP is its oracle)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.doc_ids: List[str] = []
        self._vecs: List[np.ndarray] = []
        self._mat: Optional[np.ndarray] = None

    def add(self, doc_id: str, vec: np.ndarray) -> None:
        self.doc_ids.append(doc_id)
        self._vecs.append(np.asarray(vec, np.float32))
        self._mat = None

    def search(self, query: np.ndarray, k: int = 10) -> List[Tuple[str, float]]:
        if self._mat is None:
            self._mat = np.stack(self._vecs) if self._vecs else np.zeros((0, self.dim), np.float32)
        scores = self._mat @ np.asarray(query, np.float32)
        k = min(k, len(scores))
        if k == 0:
            return []
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.lexsort((top, -scores[top]))]
        return [(self.doc_ids[i], float(scores[i])) for i in top]

    def __len__(self) -> int:
        return len(self.doc_ids)
