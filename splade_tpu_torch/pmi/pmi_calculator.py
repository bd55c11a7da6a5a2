"""PMI / PPMI / NPMI over co-occurrence statistics
(a copy of ``splade_tpu/pmi/pmi_calculator.py``).

Reference: src/pmi/pmi_calculator.py:46-406 — smoothed
PMI(a,b) = log p(a,b)/(p(a)p(b)), batch and full-matrix variants,
percentile thresholds, PPMICalculator, compute_npmi.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse

from splade_tpu_torch.pmi.cooccurrence import CooccurrenceMatrix


class PMICalculator:
    def __init__(self, cooc: CooccurrenceMatrix, smoothing: float = 1.0):
        """smoothing: add-k on pair counts (keeps unseen pairs finite)."""
        self.cooc = cooc
        self.smoothing = smoothing
        self.N = max(cooc.total_windows, 1)

    def _p_term(self, idx: int) -> float:
        return (self.cooc.term_freq[idx] + self.smoothing) / (
            self.N + self.smoothing * len(self.cooc.vocab))

    def _p_pair(self, ia: int, ib: int) -> float:
        # Laplace form (C+k)/(N + k*V^2), exactly the reference's formula
        # (pmi_calculator.py compute_pmi docstring). NOTE: with k=1 and a
        # large vocab the k*V^2 term dominates N and biases PMI strongly
        # negative — use a small smoothing (e.g. 1/V) or raise the
        # validator threshold accordingly; kept as-is for parity.
        c = self.cooc.matrix[ia, ib]
        return (c + self.smoothing) / (self.N + self.smoothing * len(self.cooc.vocab) ** 2)

    def pmi(self, a: str, b: str) -> Optional[float]:
        """None when either term is OOV (caller picks an OOV strategy)."""
        ia, ib = self.cooc.vocab.get(a), self.cooc.vocab.get(b)
        if ia is None or ib is None:
            return None
        return math.log(self._p_pair(ia, ib) / (self._p_term(ia) * self._p_term(ib)))

    def pmi_batch(self, pairs: Sequence[Tuple[str, str]]) -> List[Optional[float]]:
        return [self.pmi(a, b) for a, b in pairs]

    def pmi_matrix(self) -> sparse.csr_matrix:
        """PMI for observed pairs only (matrix sparsity pattern preserved)."""
        coo = self.cooc.matrix.tocoo()
        V = len(self.cooc.vocab)
        denom_pair = self.N + self.smoothing * V ** 2
        denom_term = self.N + self.smoothing * V
        p_pair = (coo.data + self.smoothing) / denom_pair
        p_a = (self.cooc.term_freq[coo.row] + self.smoothing) / denom_term
        p_b = (self.cooc.term_freq[coo.col] + self.smoothing) / denom_term
        vals = np.log(p_pair / (p_a * p_b))
        return sparse.csr_matrix((vals, (coo.row, coo.col)), shape=(V, V))

    def percentile_threshold(self, q: float) -> float:
        """PMI value at percentile q over observed pairs."""
        vals = self.pmi_matrix().data
        if len(vals) == 0:
            return 0.0
        return float(np.percentile(vals, q))


class PPMICalculator(PMICalculator):
    """Positive PMI: max(PMI, 0)."""

    def pmi(self, a: str, b: str) -> Optional[float]:
        v = super().pmi(a, b)
        return None if v is None else max(v, 0.0)

    def pmi_matrix(self) -> sparse.csr_matrix:
        m = super().pmi_matrix()
        m.data = np.maximum(m.data, 0.0)
        return m


def compute_npmi(pmi_value: float, p_pair: float) -> float:
    """Normalized PMI in [-1, 1]: PMI / -log p(a,b)."""
    if p_pair <= 0 or p_pair >= 1:
        return 0.0
    return pmi_value / (-math.log(p_pair))
