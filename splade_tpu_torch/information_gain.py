"""Information-gain filtering of synonym/expansion pairs in embedding space
(the port of ``splade_tpu/information_gain.py``).

Reference: src/information_gain.py:50-708 — Kozachenko-Leonenko KNN entropy
estimator over embeddings, IG(s->t) = H(t) - H(t|s), FAISS-accelerated
neighbor search, percentile/adaptive thresholds, and a filter that drops
trivial pairs (where the target adds no information over the source).

The estimator math is the JAX package's: H ≈ (d/n)·Σ log r_k(i) + log V_d(unit)
+ log(n-1) + γ - L(k-1) with the digamma-free Euler-form correction, in
float64. The exact KNN runs in torch on an explicit device (``cuda`` unless
the caller asks for the CPU): the ``[n, n]`` squared distances in the Gram
form with the fp cancellation clamped at 0, an infinite diagonal for "not
itself", ``torch.kthvalue`` for the k-th radius and ``torch.topk`` for the
neighbour sets. Inputs may be numpy arrays or tensors; results are Python
floats and ``IGResult``s. At the module's stated workload (n = 5,000,
d = 768) the ``[n, n]`` f64 matrix takes 200 MB.

One departure: ``kl_entropy`` takes log V_d as ``(d/2)·log π − lgamma(d/2 +
1)``. The reference takes ``log(unit_ball_volume(d))``, whose
``math.gamma(d/2 + 1)`` overflows for d ≥ 342, so the reference raises
``OverflowError`` at that workload's d = 768; below 342 the two agree to
the last bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

EULER_GAMMA = 0.5772156649015329


def unit_ball_volume(d: int) -> float:
    """Volume of the d-dimensional unit ball: pi^(d/2) / Gamma(d/2 + 1)."""
    return math.pi ** (d / 2) / math.gamma(d / 2 + 1)


def log_unit_ball_volume(d: int) -> float:
    """log of ``unit_ball_volume(d)``, finite at every d."""
    return d / 2 * math.log(math.pi) - math.lgamma(d / 2 + 1)


def _as_f64(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device, torch.float64)


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """[n, n] squared distances via ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a·b.

    O(n^2 + n*d) memory — the broadcast (x[:,None]-x[None])**2 form
    materializes an [n, n, d] tensor (153 GB at n=5000, d=768: the module's
    stated synonym-filtering workload).
    """
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return d2.clamp_min_(0.0)  # clamp the fp cancellation noise


def _without_self(d2: torch.Tensor) -> torch.Tensor:
    return d2.fill_diagonal_(torch.inf)


def _knn_radii(x: torch.Tensor, k: int) -> torch.Tensor:
    """Distance to the k-th nearest neighbor (excluding self) per point."""
    d2 = _without_self(_pairwise_sq_dists(x))
    kth = torch.kthvalue(d2, k, dim=1).values
    return torch.sqrt(kth.clamp_min(1e-30))


def kl_entropy(x, k: int = 3, device: DeviceLike = None) -> float:
    """Kozachenko-Leonenko differential entropy estimate (nats).

    H ≈ ψ(n) − ψ(k) + log V_d + (d/n) Σ log r_k(i)
    (reference: information_gain.py:50-180).
    """
    x = _as_f64(x, resolve_device(device))
    n, d = x.shape
    if n <= k:
        return 0.0
    radii = _knn_radii(x, k)
    return float(_digamma(n) - _digamma(k) + log_unit_ball_volume(d)
                 + d * float(torch.log(radii).mean()))


def _digamma(m: int) -> float:
    """Digamma at positive integers: ψ(m) = −γ + Σ_{i=1}^{m−1} 1/i."""
    return -EULER_GAMMA + sum(1.0 / i for i in range(1, m))


@dataclass
class IGResult:
    source: str
    target: str
    information_gain: float
    keep: bool


class InformationGainFilter:
    """Filter pairs by IG(s->t) = H(t-embeddings) − H(t|s) in embedding space.

    H(t|s) is estimated as the entropy of the residual t − proj_s(t): if the
    target embedding is predictable from the source, the residual collapses
    and IG ≈ H(t). Pairs *below* the threshold are trivial (target adds
    nothing beyond the source) — matching the reference's use of IG to drop
    uninformative synonym expansions.
    """

    def __init__(self, k: int = 3, threshold: Optional[float] = None,
                 percentile: float = 25.0, device: DeviceLike = None):
        self.k = k
        self.threshold = threshold
        self.percentile = percentile
        self.device = resolve_device(device)

    def information_gains(self, src_emb, tgt_emb) -> np.ndarray:
        """Per-pair information of the target beyond the source ([n] f64).

        H(t|s) is estimated locally: predict t_i from the targets of s_i's k
        nearest neighbor sources (leave-one-out KNN regression); the
        log-residual measures how much of t_i the source fails to explain,
        normalized by the target's local k-NN radius (density correction).

        IG_i ≈ d · (log ||t_i − t̂_i|| − log r_k^T(i)) + H(T):
        ≈ H(T) for unpredictable (novel) targets, strongly negative for
        trivial ones (t determined by s).
        """
        src = _as_f64(src_emb, self.device)
        tgt = _as_f64(tgt_emb, self.device)
        n, d = tgt.shape
        k = min(self.k, n - 1)
        if k < 1:
            # a single pair has no neighbors to regress from: its target is
            # unexplainable by construction -> neutral gain 0 (kept by any
            # percentile threshold), not NaN from an empty-axis mean
            return np.zeros(n, np.float64)
        d2 = _without_self(_pairwise_sq_dists(src))
        nbrs = torch.topk(d2, k, dim=1, largest=False).indices  # [n, k]
        del d2
        pred = tgt[nbrs].mean(dim=1)
        resid = torch.sqrt(((tgt - pred) ** 2).sum(-1).clamp_min(1e-30))
        r_t = _knn_radii(tgt, k)
        h_t = kl_entropy(tgt, k, device=self.device)
        gains = d * (torch.log(resid) - torch.log(r_t)) + h_t
        return gains.cpu().numpy()

    def filter_pairs(
        self,
        pairs: Sequence[Tuple[str, str]],
        src_emb,
        tgt_emb,
    ) -> List[IGResult]:
        if not (len(pairs) == len(src_emb) == len(tgt_emb)):
            # zip would silently truncate, dropping pairs from the result
            # and computing the percentile over the wrong population
            raise ValueError(
                f"length mismatch: {len(pairs)} pairs, {len(src_emb)} src "
                f"embeddings, {len(tgt_emb)} tgt embeddings")
        if not len(pairs):
            return []
        gains = self.information_gains(src_emb, tgt_emb)
        thr = (self.threshold if self.threshold is not None
               else float(np.percentile(gains, self.percentile)))
        return [IGResult(a, b, float(g), bool(g >= thr))
                for (a, b), g in zip(pairs, gains)]

    @staticmethod
    def stats(results: Sequence[IGResult]) -> Dict[str, float]:
        kept = sum(r.keep for r in results)
        gains = [r.information_gain for r in results]
        return {
            "total": len(results),
            "kept": kept,
            "kept_rate": kept / len(results) if results else 0.0,
            "mean_ig": float(np.mean(gains)) if gains else 0.0,
        }
