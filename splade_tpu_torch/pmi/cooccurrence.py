"""Co-occurrence statistics for PMI analysis
(a copy of ``splade_tpu/pmi/cooccurrence.py``).

Reference: src/pmi/cooccurrence.py:76-547 — sentence / paragraph / sliding
windowing, vocabulary construction with min_count/max_vocab, scipy CSR
co-occurrence matrix, term and document frequencies, save/load.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
from scipy import sparse


def default_tokenizer(text: str) -> List[str]:
    """Whitespace + Hangul/latin word tokenizer."""
    return re.findall(r"[가-힣]+|[A-Za-z0-9]+", text.lower())


def split_sentences(text: str) -> List[str]:
    return [s for s in re.split(r"[.!?\n。]+", text) if s.strip()]


class CooccurrenceMatrix:
    """Symmetric co-occurrence counts + marginals over a fixed vocab."""

    def __init__(self, vocab: Dict[str, int], matrix: sparse.csr_matrix,
                 term_freq: np.ndarray, doc_freq: np.ndarray,
                 total_windows: int, total_docs: int):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.matrix = matrix
        self.term_freq = term_freq
        self.doc_freq = doc_freq
        self.total_windows = total_windows
        self.total_docs = total_docs

    def count(self, a: str, b: str) -> int:
        ia, ib = self.vocab.get(a), self.vocab.get(b)
        if ia is None or ib is None:
            return 0
        return int(self.matrix[ia, ib])

    def save(self, directory: str) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        sparse.save_npz(d / "cooc.npz", self.matrix)
        np.save(d / "term_freq.npy", self.term_freq)
        np.save(d / "doc_freq.npy", self.doc_freq)
        (d / "meta.json").write_text(json.dumps({
            "vocab": self.vocab,
            "total_windows": self.total_windows,
            "total_docs": self.total_docs,
        }, ensure_ascii=False))

    @classmethod
    def load(cls, directory: str) -> "CooccurrenceMatrix":
        d = Path(directory)
        meta = json.loads((d / "meta.json").read_text())
        return cls(
            vocab=meta["vocab"],
            matrix=sparse.load_npz(d / "cooc.npz").tocsr(),
            term_freq=np.load(d / "term_freq.npy"),
            doc_freq=np.load(d / "doc_freq.npy"),
            total_windows=meta["total_windows"],
            total_docs=meta["total_docs"],
        )


class CooccurrenceBuilder:
    """Build co-occurrence matrices from a corpus.

    window: 'sentence' | 'paragraph' | int (sliding window size in tokens).
    """

    def __init__(
        self,
        window: str | int = "sentence",
        min_count: int = 2,
        max_vocab: int = 50000,
        tokenizer: Optional[Callable[[str], List[str]]] = None,
    ):
        self.window = window
        self.min_count = min_count
        self.max_vocab = max_vocab
        self.tokenizer = tokenizer or default_tokenizer

    def _windows(self, doc: str) -> Iterable[List[str]]:
        if self.window == "paragraph":
            parts = [p for p in doc.split("\n\n") if p.strip()]
            for p in parts:
                yield self.tokenizer(p)
        elif self.window == "sentence":
            for s in split_sentences(doc):
                yield self.tokenizer(s)
        else:
            toks = self.tokenizer(doc)
            w = int(self.window)
            if len(toks) <= w:
                yield toks
            else:
                for i in range(0, len(toks) - w + 1):
                    yield toks[i:i + w]

    def build(self, corpus: Sequence[str]) -> CooccurrenceMatrix:
        # Pass 1: vocabulary.
        counts: Counter = Counter()
        for doc in corpus:
            counts.update(self.tokenizer(doc))
        items = [(t, c) for t, c in counts.items() if c >= self.min_count]
        items.sort(key=lambda tc: (-tc[1], tc[0]))
        vocab = {t: i for i, (t, _) in enumerate(items[: self.max_vocab])}
        V = len(vocab)

        # Pass 2: windows -> pair counts (upper triangle, then symmetrize).
        rows: List[int] = []
        cols: List[int] = []
        term_freq = np.zeros(V, np.int64)
        doc_freq = np.zeros(V, np.int64)
        total_windows = 0
        for doc in corpus:
            doc_terms = set()
            for win in self._windows(doc):
                ids = sorted({vocab[t] for t in win if t in vocab})
                if not ids:
                    continue
                total_windows += 1
                for i in ids:
                    term_freq[i] += 1
                    doc_terms.add(i)
                for ai in range(len(ids)):
                    for bi in range(ai + 1, len(ids)):
                        rows.append(ids[ai])
                        cols.append(ids[bi])
            for i in doc_terms:
                doc_freq[i] += 1
        data = np.ones(len(rows), np.int64)
        upper = sparse.coo_matrix((data, (rows, cols)), shape=(V, V))
        mat = (upper + upper.T).tocsr()
        return CooccurrenceMatrix(vocab, mat, term_freq, doc_freq,
                                  total_windows, len(corpus))
