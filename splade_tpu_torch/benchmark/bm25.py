"""In-process BM25 inverted index.

Replaces the reference's OpenSearch BM25-with-nori baseline
(reference: benchmark/index_manager.py:47-79, searchers.py:79-107) with a
Lucene-formula BM25 over a pluggable analyzer. The default analyzer is the
50K Korean-heavy WordPiece tokenizer — the closest in-process stand-in for
the nori analyzer (documented deviation).

IDF: ln(1 + (N - df + 0.5)/(df + 0.5))   (Lucene/OpenSearch smoothing,
matching the reference's idf-compute "bm25" mode, tools/idf-compute
main.rs:124-235).
Score: idf * tf*(k1+1) / (tf + k1*(1 - b + b*len/avglen)).

The port's own copy of ``splade_tpu/benchmark/bm25.py``, which
imports no framework.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def whitespace_analyzer(text: str) -> List[str]:
    return text.lower().split()


def make_wordpiece_analyzer(tokenizer) -> Callable[[str], List[str]]:
    """Analyzer from an HF tokenizer: subword ids as terms, specials dropped."""
    special = set(tokenizer.all_special_ids)

    def analyze(text: str) -> List[str]:
        # no truncation: BM25 must index FULL documents (the encoder's 512
        # positional limit doesn't apply to a bag-of-terms index; silently
        # dropping long-doc tails deflated the baseline side of every
        # bm25_* comparison)
        ids = tokenizer(text, add_special_tokens=False,
                        truncation=False, verbose=False)["input_ids"]
        return [str(i) for i in ids if i not in special]

    return analyze


# Common Korean postpositions (josa) and a few high-frequency verbal/copula
# endings, longest-first so the greedy strip takes the most specific match.
# This is the offline stand-in for the nori morphological analyzer the
# reference BM25 index uses (reference: index_manager.py:47-79) — nori
# decompounds and drops particles; stripping trailing josa from each eojeol
# captures the retrieval-relevant part of that normalization.
_KOREAN_SUFFIXES = tuple(sorted((
    "은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게", "에게서",
    "께", "께서", "와", "과", "도", "만", "로", "으로", "로서", "으로서",
    "로써", "으로써", "부터", "까지", "처럼", "보다", "한테", "한테서",
    "이나", "나", "이란", "란", "이든지", "든지", "이라도", "라도", "마저",
    "조차", "밖에", "뿐", "요", "이요", "입니다", "합니다", "했다", "하다",
    "하는", "하고", "하며", "되다", "된다", "됩니다", "이다", "였다", "았다",
    "었다", "들",
), key=len, reverse=True))


def _is_hangul(ch: str) -> bool:
    # analyzer wants the wide set: precomposed syllables AND conjoining
    # Jamo (stems of decomposed forms)
    from splade_tpu_torch.utils.text import is_hangul_char

    return is_hangul_char(ch, include_jamo=True)


def korean_heuristic_analyzer(text: str) -> List[str]:
    """Offline Korean analyzer: per-eojeol punctuation strip + greedy josa/
    ending suffix strip (stem must keep >=1 hangul syllable). Falls through
    to plain lowercase for non-Korean tokens. A documented approximation of
    the nori analyzer for hosts without mecab-ko/kiwi."""
    out: List[str] = []
    for raw in text.split():
        tok = raw.strip(".,!?;:\"'()[]{}<>~·…“”‘’").lower()
        if not tok:
            continue
        if any(_is_hangul(c) for c in tok):
            for suf in _KOREAN_SUFFIXES:
                if tok.endswith(suf) and len(tok) - len(suf) >= 1:
                    stem = tok[: len(tok) - len(suf)]
                    if any(_is_hangul(c) for c in stem):
                        tok = stem
                    break
        out.append(tok)
    return out


def make_morphological_analyzer(backend: str = "auto") -> Callable[[str], List[str]]:
    """True morphological analyzer via kiwipiepy or MeCab-ko when installed.

    Reference parity hook for the nori analyzer (index_manager.py:47-79).
    Raises ImportError with guidance when no backend is available — callers
    should fall back to :func:`korean_heuristic_analyzer` (documented
    deviation; see scripts/analyzer_sensitivity.py for the measured impact).
    """
    if backend in ("auto", "kiwi"):
        try:
            from kiwipiepy import Kiwi  # type: ignore

            kiwi = Kiwi()
            # Content morphemes only: nouns/verbs/adjectives/foreign/number —
            # mirrors nori's default stoptags dropping josa/endings/symbols.
            keep = ("NN", "NR", "NP", "VV", "VA", "XR", "SL", "SH", "SN")

            def analyze(text: str) -> List[str]:
                return [t.form.lower() for t in kiwi.tokenize(text)
                        if t.tag.startswith(keep)]

            return analyze
        except ImportError:
            if backend == "kiwi":
                raise ImportError(
                    "kiwipiepy is not installed; pip install kiwipiepy or "
                    "use korean_heuristic_analyzer")
    if backend in ("auto", "mecab"):
        try:
            import MeCab  # type: ignore

            tagger = MeCab.Tagger()
            keep = ("NN", "NR", "NP", "VV", "VA", "XR", "SL", "SH", "SN")

            def analyze(text: str) -> List[str]:
                out = []
                for line in tagger.parse(text).splitlines():
                    if "\t" not in line:
                        continue
                    surface, feats = line.split("\t", 1)
                    if feats.split(",")[0].startswith(keep):
                        out.append(surface.lower())
                return out

            return analyze
        except ImportError:
            if backend == "mecab":
                raise ImportError(
                    "MeCab (mecab-ko) is not installed; install mecab-python3 "
                    "+ mecab-ko-dic or use korean_heuristic_analyzer")
    raise ImportError(
        "no Korean morphological backend available (tried kiwipiepy, MeCab); "
        "use korean_heuristic_analyzer as the offline fallback")


def resolve_analyzer(name: str, tokenizer=None) -> Callable[[str], List[str]]:
    """Named analyzer lookup for CLIs: wordpiece | whitespace |
    korean-heuristic | morphological (kiwi/mecab, optional)."""
    if name == "wordpiece":
        if tokenizer is None:
            raise ValueError("wordpiece analyzer needs a tokenizer")
        return make_wordpiece_analyzer(tokenizer)
    if name == "whitespace":
        return whitespace_analyzer
    if name in ("korean-heuristic", "korean_heuristic"):
        return korean_heuristic_analyzer
    if name == "morphological":
        return make_morphological_analyzer()
    raise ValueError(f"unknown analyzer {name!r}")


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75,
                 analyzer: Optional[Callable[[str], List[str]]] = None):
        self.k1 = k1
        self.b = b
        self.analyzer = analyzer or whitespace_analyzer
        self.postings: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.doc_ids: List[str] = []
        self.doc_lens: List[int] = []
        self._idf: Dict[str, float] = {}
        self._avg_len = 0.0

    def add_documents(self, docs: Sequence[Tuple[str, str]]) -> None:
        """docs: (doc_id, text) pairs. IDF/avg-len stats are invalidated by
        every add and lazily recomputed at the next search, so adds after a
        finalize() cannot serve stale statistics."""
        for doc_id, text in docs:
            terms = self.analyzer(text)
            idx = len(self.doc_ids)
            self.doc_ids.append(doc_id)
            self.doc_lens.append(len(terms))
            for term, tf in Counter(terms).items():
                self.postings[term].append((idx, tf))
        self._idf = {}

    def finalize(self) -> None:
        n = max(len(self.doc_ids), 1)
        self._avg_len = float(np.mean(self.doc_lens)) if self.doc_lens else 1.0
        self._idf = {
            t: math.log(1.0 + (n - len(pl) + 0.5) / (len(pl) + 0.5))
            for t, pl in self.postings.items()
        }

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        if not self._idf:
            self.finalize()
        scores: Dict[int, float] = defaultdict(float)
        k1, b, avg = self.k1, self.b, max(self._avg_len, 1e-9)
        for term in self.analyzer(query):
            idf = self._idf.get(term)
            if idf is None:
                continue
            for doc_idx, tf in self.postings[term]:
                norm = tf + k1 * (1.0 - b + b * self.doc_lens[doc_idx] / avg)
                scores[doc_idx] += idf * tf * (k1 + 1.0) / norm
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        return [(self.doc_ids[i], s) for i, s in ranked]

    def __len__(self) -> int:
        return len(self.doc_ids)
