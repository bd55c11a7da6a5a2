"""Synthetic SPLADE-like corpora shared by the benchmarks
(a copy of ``splade_tpu/utils/synth.py``).

One definition so every bench (postings QPS, serving load, index
experiments) measures the SAME distribution — Zipf(1.3) term popularity,
|N(0,1)|+0.1 impacts, ~54 nnz/doc like the published model card.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def zipf_corpus_csr(rng: np.random.Generator, n_docs: int, vocab: int,
                    nnz: int = 54) -> Tuple[np.ndarray, np.ndarray]:
    """Rectangular CSR blocks ([n, nnz] term ids, [n, nnz] f32 weights)."""
    terms = (rng.zipf(1.3, size=n_docs * nnz) % vocab).astype(
        np.int32).reshape(n_docs, nnz)
    vals = (np.abs(rng.normal(size=(n_docs, nnz))) + 0.1).astype(np.float32)
    return terms, vals


def uniform_vectors(rng: np.random.Generator, n: int, vocab: int,
                    nnz: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-vector (indices, values) pairs with unique uniform terms."""
    out = []
    for _ in range(n):
        idx = rng.choice(vocab, size=nnz, replace=False).astype(np.int32)
        vals = (np.abs(rng.normal(size=nnz)) + 0.05).astype(np.float32)
        out.append((idx, vals))
    return out


_JOSA = ("은", "는", "이", "가", "을", "를", "에", "에서", "으로", "로",
         "와", "과", "도", "만", "의", "까지", "부터", "처럼")
_ENDINGS = ("한다", "했다", "합니다", "하는", "된다", "되었다", "입니다")


def random_hangul_stems(rng: np.random.Generator, n: int,
                        seed_words: tuple = ()) -> list:
    """``n`` unique random 2-3-syllable precomposed-Hangul stems, appended
    after ``seed_words`` (which count toward dedup but not toward n). The
    single owner of the stem generator — the analyzer fixture and the
    synthetic triplet corpus must draw from the same distribution."""
    out = list(seed_words)
    seen = set(out)
    syllable = lambda: chr(0xAC00 + int(rng.integers(11172)))  # noqa: E731
    while len(out) < len(seed_words) + n:
        s = "".join(syllable() for _ in range(int(rng.integers(2, 4))))
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def korean_morph_benchmark(rng: np.random.Generator, n_docs: int = 1200,
                           n_queries: int = 240, n_stems: int = 900,
                           stems_per_doc: int = 12, query_stems: int = 3):
    """Synthetic Korean retrieval fixture with MORPHOLOGICAL structure,
    sized for the analyzer-sensitivity experiment (VERDICT r2 #5).

    Stems are random precomposed-Hangul noun roots; documents render each
    sampled stem with a random josa particle (or bare) plus verb-ending
    filler, queries use the BARE stems of one target document — the regime
    where whitespace matching loses to suffix-stripping analyzers and a
    morphological analyzer is the reference behavior (nori,
    reference benchmark/index_manager.py:47-79).

    Returns (corpus {id: text}, queries {qid: text}, qrels {qid: {ids}});
    qrels contain every document whose stem set covers the query's stems.
    """
    stems = random_hangul_stems(rng, n_stems)
    doc_stems = []
    corpus = {}
    for d in range(n_docs):
        chosen = rng.choice(n_stems, size=stems_per_doc, replace=False)
        doc_stems.append(set(int(c) for c in chosen))
        words = []
        for c in chosen:
            stem = stems[int(c)]
            r = rng.random()
            if r < 0.75:
                words.append(stem + _JOSA[int(rng.integers(len(_JOSA)))])
            else:
                words.append(stem)
            if rng.random() < 0.25:
                words.append(_ENDINGS[int(rng.integers(len(_ENDINGS)))])
        rng.shuffle(words)
        corpus[f"d{d}"] = " ".join(words)
    queries, qrels = {}, {}
    for q in range(n_queries):
        target = int(rng.integers(n_docs))
        picked = rng.choice(sorted(doc_stems[target]), size=query_stems,
                            replace=False)
        queries[f"q{q}"] = " ".join(stems[int(c)] for c in picked)
        want = set(picked.tolist())
        qrels[f"q{q}"] = {f"d{d}" for d in range(n_docs)
                          if want <= doc_stems[d]}
    return corpus, queries, qrels
