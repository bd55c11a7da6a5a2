"""Inputs the benchmark makes from a seed: Hangul texts, the stand-in
tokenizer, synthetic SPLADE corpora and V33 triplets.

The generators follow ``chip_smoke.py`` (``hangul_texts``,
``synth_triplets``, ``zipf_corpus_csr``, ``CharTokenizer``), vectorised
where that file draws text by text. Every seed draws the same multiset of
sizes (word counts, k, gaps), so seeds change the content and the order of
the work and not its amount: the sizes come from ``FIXED_SIZES`` and the
seed only permutes them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

#: the generator of sizes that every seed shares (permuted by the seed)
FIXED_SIZES = 0x5EED5


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """The seed's generator for one purpose (``tags``): any whole seed,
    negative or past 64 bits included, maps into numpy's seed space."""
    return np.random.default_rng([seed % (1 << 64), *tags])


def shared_sizes(lo: int, hi: int, n: int, tag: int) -> np.ndarray:
    """``n`` integers in [lo, hi) drawn by the seed-independent generator."""
    return np.random.default_rng([FIXED_SIZES, tag]).integers(lo, hi, n)


class CharTokenizer:
    """A deterministic character-level stand-in for the A.X-Encoder
    tokenizer (which is not in the repository), as ``chip_smoke.py``
    defines it: one id per non-space character, ``4 + ord(c) % (V - 4)``,
    ids 0-3 special, [PAD] = 0. Hangul syllables map to distinct ids for V
    above 11,176. With ``add_special_tokens=False`` it returns unpadded id
    lists, as ``pack_corpus`` asks."""

    pad_token_id = 0
    cls_token_id = 1
    sep_token_id = 2
    mask_token_id = 3
    all_special_ids = [0, 1, 2, 3]

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __len__(self) -> int:
        return self.vocab_size

    def get_vocab(self) -> dict:
        return {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[MASK]": 3}

    def codes(self, text: str) -> List[int]:
        return [4 + ord(c) % (self.vocab_size - 4) for c in text
                if not c.isspace()]

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=64, return_tensors="np", add_special_tokens=True,
                 verbose=True):
        one = isinstance(texts, str)
        all_codes = [self.codes(t) for t in ([texts] if one else texts)]
        if not add_special_tokens:
            return {"input_ids": all_codes[0] if one else all_codes}
        ids = np.zeros((len(all_codes), max_length), np.int64)
        mask = np.zeros((len(all_codes), max_length), np.int64)
        for i, codes in enumerate(all_codes):
            codes = codes[:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def stems(rng: np.random.Generator, n: int = 400) -> List[str]:
    """``n`` two-syllable Hangul words."""
    syl = rng.integers(0, 11172, (n, 2)) + 0xAC00
    return ["".join(map(chr, row)) for row in syl]


def hangul_texts(rng: np.random.Generator, words: Sequence[int],
                 vocab: Sequence[str]) -> List[str]:
    """One text a word count in ``words``, each word drawn from ``vocab``."""
    words = np.asarray(words, np.int64)
    picks = rng.integers(0, len(vocab), int(words.sum()))
    ends = np.cumsum(words)
    flat = [vocab[i] for i in picks]
    return [" ".join(flat[e - w:e]) for w, e in zip(words, ends)]


def triplets(seed: int, n: int, query_words=(4, 17), doc_words=(100, 129)
             ) -> List[dict]:
    """``n`` (query, positive, negative) triplets as ``chip_smoke.py``'s
    ``synth_triplets``: queries of 4-16 words, documents of 100-128."""
    rng = rng_for(seed, 1)
    vocab = stems(rng)
    sizes = {name: rng.permutation(shared_sizes(*span, n, tag))
             for tag, (name, span) in enumerate(
                 (("query", query_words), ("positive", doc_words),
                  ("negative", doc_words)))}
    texts = {name: hangul_texts(rng, w, vocab) for name, w in sizes.items()}
    return [{k: texts[k][i] for k in texts} for i in range(n)]


def lines(seed: int, n: int, words=(8, 65)) -> List[str]:
    """``n`` Hangul lines (sentences) of ``words`` words for MLM packing."""
    rng = rng_for(seed, 2)
    vocab = stems(rng)
    return hangul_texts(rng, rng.permutation(shared_sizes(*words, n, 7)),
                        vocab)


def queries(seed: int, n: int, words=(4, 17)) -> List[str]:
    rng = rng_for(seed, 3)
    vocab = stems(rng)
    return hangul_texts(rng, rng.permutation(shared_sizes(*words, n, 8)),
                        vocab)


def zipf_corpus_csr(seed: int, n_docs: int, vocab_size: int, nnz: int = 54,
                    exponent: float = 1.3):
    """A synthetic SPLADE corpus as ``chip_smoke.py``'s ``zipf_corpus_csr``:
    Zipf(1.3) term ids mod the vocabulary, a term drawn twice in a row
    redrawn uniformly until the row's ``nnz`` ids are distinct (rows sorted),
    |N(0,1)| + 0.1 impacts. Returns (terms [N, nnz] int32, vals f32)."""
    rng = rng_for(seed, 4)
    terms = (rng.zipf(exponent, size=(n_docs, nnz)) % vocab_size
             ).astype(np.int32)
    while True:
        terms.sort(axis=1)
        dup = np.zeros(terms.shape, bool)
        dup[:, 1:] = terms[:, 1:] == terms[:, :-1]
        n_dup = int(dup.sum())
        if not n_dup:
            break
        terms[dup] = rng.integers(0, vocab_size, n_dup)
    vals = (np.abs(rng.standard_normal((n_docs, nnz), np.float32)) + 0.1)
    return terms, vals.astype(np.float32)
