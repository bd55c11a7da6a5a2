"""Duplicate removal: exact and MinHash near-duplicate detection
(a copy of ``splade_tpu/preprocessing/dedup.py``).

Reference: src/preprocessing/cleaners/deduplicator.py — character-3-gram
MinHash with 128 permutations, Jaccard-estimate threshold 0.8, plus an exact
(hash) deduplicator.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Iterable, List, Set

import numpy as np

logger = logging.getLogger(__name__)



class ExactDeduplicator:
    def __init__(self):
        self._seen: Set[bytes] = set()

    def is_duplicate(self, text: str) -> bool:
        h = hashlib.md5(text.strip().lower().encode("utf-8")).digest()
        if h in self._seen:
            return True
        self._seen.add(h)
        return False


class MinHashDeduplicator:
    """Char-n-gram MinHash LSH-free near-dedup (pairwise against banded
    buckets) — matches the reference semantics at corpus scales it is used
    for (single-machine shards)."""

    def __init__(self, threshold: float = 0.8, num_perm: int = 128,
                 ngram: int = 3, seed: int = 1, bands: int = 16):
        if num_perm % bands:
            # config exposes minhash_permutations without a bands knob —
            # adjust to the largest divisor <= requested instead of
            # asserting mid-pipeline after hours of upstream work
            bands = next(b for b in range(min(bands, num_perm), 0, -1)
                         if num_perm % b == 0)
            logger.warning("bands adjusted to %d (must divide num_perm=%d)",
                           bands, num_perm)
        self.threshold = threshold
        self.num_perm = num_perm
        self.ngram = ngram
        self.bands = bands
        self.rows = num_perm // bands
        rng = np.random.default_rng(seed)
        # Multiply-shift universal hashing (Dietzfelbinger): odd 64-bit a,
        # arithmetic deliberately mod 2^64 via uint64 wraparound. A naive
        # "(a*h + b) % mersenne" in int64 silently overflows (products up
        # to ~2^122), destroying the universality it claims.
        self._a = (rng.integers(0, 1 << 62, size=num_perm, dtype=np.uint64)
                   << np.uint64(1)) | np.uint64(1)
        self._b = rng.integers(0, 1 << 63, size=num_perm, dtype=np.uint64)
        self._band_buckets: List[dict] = [dict() for _ in range(bands)]
        self._signatures: List[np.ndarray] = []

    def _shingles(self, text: str) -> np.ndarray:
        t = text.strip().lower()
        if len(t) < self.ngram:
            t = t + " " * (self.ngram - len(t))
        grams = {t[i:i + self.ngram] for i in range(len(t) - self.ngram + 1)}
        hashes = np.fromiter(
            (int.from_bytes(hashlib.blake2b(g.encode("utf-8"), digest_size=8).digest(),
                            "little")
             for g in grams), dtype=np.uint64, count=len(grams))
        return hashes

    def signature(self, text: str) -> np.ndarray:
        h = self._shingles(text)  # [G]
        # (a*h + b) mod 2^64 (uint64 wraparound is the intended modulus),
        # min over shingles, per permutation
        vals = self._a[:, None] * h[None, :] + self._b[:, None]
        return vals.min(axis=1)  # [num_perm]

    @staticmethod
    def jaccard_estimate(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
        return float(np.mean(sig_a == sig_b))

    def is_duplicate(self, text: str) -> bool:
        """Check against everything seen; registers the text if novel."""
        sig = self.signature(text)
        candidates: Set[int] = set()
        keys = []
        for b in range(self.bands):
            band = sig[b * self.rows:(b + 1) * self.rows]
            key = hashlib.blake2b(band.tobytes(), digest_size=8).digest()
            keys.append(key)
            candidates.update(self._band_buckets[b].get(key, ()))
        for idx in candidates:
            if self.jaccard_estimate(sig, self._signatures[idx]) >= self.threshold:
                return True
        new_idx = len(self._signatures)
        self._signatures.append(sig)
        for b, key in enumerate(keys):
            self._band_buckets[b].setdefault(key, []).append(new_idx)
        return False

    def __len__(self) -> int:
        return len(self._signatures)
