"""The traffic generators are deterministic for a seed, differ across
seeds, and give every seed one multiset of sizes in its own order."""

import numpy as np
import pytest

from perfbench.core import texts
from perfbench.drivers.search import arrivals

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("make", [
    lambda s: texts.triplets(s, 40),
    lambda s: texts.lines(s, 40),
    lambda s: texts.queries(s, 40),
    lambda s: [r.tolist() for r in texts.zipf_corpus_csr(s, 50, 600)],
    lambda s: [a.tolist() for a in arrivals(s, 50.0, 2.0, {"10": 0.9,
                                                          "100": 0.1})],
], ids=["triplets", "lines", "queries", "corpus", "arrivals"])
def test_same_seed_same_inputs_other_seed_other_inputs(make):
    assert make(BIG) == make(BIG)
    assert make(BIG) != make(BIG + 1)
    assert make(-3) == make(-3)


def test_seeds_share_the_multiset_of_sizes():
    a, b = texts.triplets(BIG, 60), texts.triplets(7, 60)
    for key in ("query", "positive", "negative"):
        assert sorted(len(r[key].split()) for r in a) == \
            sorted(len(r[key].split()) for r in b)
    (due_a, k_a), (due_b, k_b) = (arrivals(s, 100.0, 3.0,
                                           {"10": 0.9, "100": 0.1})
                                  for s in (BIG, 7))
    assert sorted(k_a) == sorted(k_b) and (k_a == 100).sum() == 30
    assert np.allclose(sorted(np.diff(due_a, prepend=0.0)),
                       sorted(np.diff(due_b, prepend=0.0)))
    assert len(due_a) == 300 and 0 <= due_a.min() and due_a.max() < 3.0


def test_corpus_rows_hold_distinct_sorted_terms():
    terms, vals = texts.zipf_corpus_csr(BIG, 200, 1000, nnz=54)
    assert terms.shape == vals.shape == (200, 54)
    assert (np.diff(terms, axis=1) > 0).all()
    assert (vals >= 0.1).all() and terms.max() < 1000


def test_stand_in_tokenizer_pads_and_truncates():
    tok = texts.CharTokenizer(50000)
    enc = tok(["가나 다", "라" * 10], max_length=4)
    assert enc["input_ids"].shape == (2, 4)
    assert enc["attention_mask"].tolist() == [[1, 1, 1, 0], [1, 1, 1, 1]]
    assert tok("가나", add_special_tokens=False)["input_ids"] == \
        tok.codes("가나")
    # Hangul syllables map to distinct ids at the published vocabulary
    ids = {tok.codes(chr(0xAC00 + i))[0] for i in range(11172)}
    assert len(ids) == 11172
