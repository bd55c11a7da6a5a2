"""The port's PMI tier against splade_tpu's, on the same corpora.

Each case of tests/test_pmi.py (co-occurrence counts, vocabulary cut-offs,
sliding windows, the smoothing math, the PMI matrix against the pointwise
PMI, PPMI, NPMI, the synonym validator and its report, save/load) runs
through both packages with the reference test's own assertions, and the
results must be bitwise equal: the port's modules are copies on scipy CSR.
A seeded Hangul corpus (the port's ``random_hangul_stems``) adds the
matrices, marginals, PMI / PPMI matrices and percentile thresholds of
every window kind, bitwise."""

import dataclasses
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

CORPUS = [
    "인공지능 검색 모델. 검색 모델 학습.",
    "인공지능 모델 학습. 데이터 수집.",
    "검색 엔진 최적화. 검색 결과 개선.",
    "요리 레시피 모음. 김치 요리 방법.",
]


def _ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(name=pkg, pmi=importlib.import_module(f"{pkg}.pmi"))


PORT, JAX = _ns("splade_tpu_torch"), _ns("splade_tpu")
BOTH = pytest.mark.parametrize("m", [PORT, JAX], ids=["port", "jax"])


def both(fn, *args):
    return [fn(m, *args) for m in (PORT, JAX)]


def csr_equal(a, b) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        np.testing.assert_array_equal(x, y)


def cooc_state(c) -> tuple:
    return (c.vocab, c.matrix, c.term_freq, c.doc_freq, c.total_windows,
            c.total_docs)


def assert_cooc_equal(a, b) -> None:
    sa, sb = cooc_state(a), cooc_state(b)
    assert sa[0] == sb[0] and sa[4:] == sb[4:]
    csr_equal(sa[1], sb[1])
    for x, y in zip(sa[2:4], sb[2:4]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def seeded_corpus(n_docs: int = 120, seed: int = 0) -> list:
    """Hangul documents of several sentences and paragraphs, with some
    Latin tokens, from the port's stem generator."""
    from splade_tpu_torch.utils.synth import random_hangul_stems

    rng = np.random.default_rng(seed)
    stems = random_hangul_stems(rng, 80) + ["ai", "gpu", "seoul2024"]
    docs = []
    for _ in range(n_docs):
        paras = []
        for _ in range(int(rng.integers(1, 3))):
            sents = [" ".join(stems[j] for j in rng.integers(
                0, len(stems), int(rng.integers(2, 9))))
                for _ in range(int(rng.integers(1, 4)))]
            paras.append(". ".join(sents) + "!")
        docs.append("\n\n".join(paras))
    return docs


WINDOWS = ["sentence", "paragraph", 2, 5]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("min_count,max_vocab", [(1, 50000), (3, 40)])
def test_cooccurrence_and_pmi_are_bitwise(window, min_count, max_vocab):
    docs = seeded_corpus()

    def run(m):
        c = m.pmi.CooccurrenceBuilder(window=window, min_count=min_count,
                                      max_vocab=max_vocab).build(docs)
        calc, ppmi = m.pmi.PMICalculator(c), m.pmi.PPMICalculator(c, 0.25)
        words = sorted(c.vocab)[:12] + ["없는말"]
        pairs = [(a, b) for a in words for b in words]
        return (c, calc.pmi_matrix(), ppmi.pmi_matrix(),
                calc.pmi_batch(pairs), ppmi.pmi_batch(pairs),
                [calc.percentile_threshold(q) for q in (10.0, 50.0, 90.0)])

    port, ref = both(run)
    assert_cooc_equal(port[0], ref[0])
    csr_equal(port[1], ref[1])
    csr_equal(port[2], ref[2])
    assert port[3:] == ref[3:]
    assert len(port[0].vocab) <= max_vocab and port[0].total_windows > 0


def test_reference_corpus_matches():
    def run(m):
        c = m.pmi.CooccurrenceBuilder(window="sentence",
                                      min_count=1).build(CORPUS)
        return c, m.pmi.PMICalculator(c).pmi("검색", "모델")

    port, ref = both(run)
    assert_cooc_equal(port[0], ref[0])
    assert port[1] == ref[1]


@BOTH
def test_reference_assertions(m, tmp_path):
    cooc = m.pmi.CooccurrenceBuilder(window="sentence",
                                     min_count=1).build(CORPUS)
    assert cooc.count("검색", "모델") == cooc.count("모델", "검색") == 2
    assert cooc.count("검색", "요리") == 0 and cooc.total_docs == 4
    assert cooc.term_freq[cooc.vocab["검색"]] == 4
    built = m.pmi.CooccurrenceBuilder(window="sentence",
                                      min_count=3).build(CORPUS)
    assert "검색" in built.vocab and "김치" not in built.vocab
    capped = m.pmi.CooccurrenceBuilder(window="sentence", min_count=1,
                                       max_vocab=3).build(CORPUS)
    assert len(capped.vocab) == 3
    slid = m.pmi.CooccurrenceBuilder(window=2, min_count=1).build(["a b c d"])
    assert slid.count("a", "b") == slid.count("b", "c") == 1
    assert slid.count("a", "c") == 0

    calc = m.pmi.PMICalculator(cooc, smoothing=1.0)
    V, N = len(cooc.vocab), cooc.total_windows
    ia, ib = cooc.vocab["검색"], cooc.vocab["모델"]
    p_pair = (cooc.matrix[ia, ib] + 1.0) / (N + V ** 2)
    p_a = (cooc.term_freq[ia] + 1.0) / (N + V)
    p_b = (cooc.term_freq[ib] + 1.0) / (N + V)
    assert calc.pmi("검색", "모델") == pytest.approx(
        math.log(p_pair / (p_a * p_b)))
    assert calc.pmi("검색", "없는말") is None
    assert calc.pmi_matrix()[ia, ib] == pytest.approx(calc.pmi("검색", "모델"))
    assert np.isfinite(calc.percentile_threshold(50.0))
    assert (m.pmi.PPMICalculator(cooc).pmi_matrix().data >= 0).all()
    assert m.pmi.compute_npmi(0.0, 0.5) == 0.0
    assert m.pmi.compute_npmi(-math.log(0.1), 0.1) == pytest.approx(1.0)


@pytest.mark.parametrize("args", [(0.0, 0.5), (-math.log(0.1), 0.1),
                                  (1.5, 0.0), (1.5, 1.0), (-2.0, 0.3)])
def test_npmi_matches(args):
    port, ref = both(lambda m: m.pmi.compute_npmi(*args))
    assert port == ref


@pytest.mark.parametrize("strategy", ["reject", "accept", "smooth"])
@pytest.mark.parametrize("threshold", [None, 0.0, 1.0])
def test_synonym_validator_matches(tmp_path, strategy, threshold):
    """Results, stats, the markdown report and its JSON beside it (a .json
    path is written as .md plus .json) equal the reference's."""
    def run(m):
        cooc = m.pmi.CooccurrenceBuilder(window="sentence",
                                         min_count=1).build(CORPUS)
        calc = m.pmi.PMICalculator(cooc)
        thr = (calc.pmi("검색", "모델") - 0.1 if threshold is None
               else threshold)
        val = m.pmi.SynonymValidator(calc, threshold=thr,
                                     oov_strategy=strategy)
        res = val.validate([("검색", "모델"), ("검색", "요리"),
                            ("검색", "없는말"), ("없는", "말")])
        d = tmp_path / m.name
        report = val.report(res, str(d / "report.json"))
        return ([dataclasses.asdict(r) for r in res], val.stats(res), report,
                (d / "report.md").read_text(),
                (d / "report.json").read_text())

    port, ref = both(run)
    assert port == ref
    res, stats = port[0], port[1]
    assert res[0]["valid"] == (threshold is None
                               or res[0]["pmi"] >= threshold)
    assert stats["oov"] == 2 and stats["total"] == 4
    assert "Synonym validation" in port[2]


def test_validator_refuses_an_unknown_strategy():
    for m in (PORT, JAX):
        cooc = m.pmi.CooccurrenceBuilder(min_count=1).build(CORPUS)
        with pytest.raises(AssertionError):
            m.pmi.SynonymValidator(m.pmi.PMICalculator(cooc),
                                   oov_strategy="drop")


def test_save_load_round_trip_across_packages(tmp_path):
    """A matrix the port saves loads in the reference and back, bitwise."""
    docs = seeded_corpus(40, seed=2)
    port = PORT.pmi.CooccurrenceBuilder(window=3).build(docs)
    port.save(str(tmp_path / "port"))
    ref = JAX.pmi.CooccurrenceMatrix.load(str(tmp_path / "port"))
    assert_cooc_equal(port, ref)
    ref.save(str(tmp_path / "ref"))
    back = PORT.pmi.CooccurrenceMatrix.load(str(tmp_path / "ref"))
    assert_cooc_equal(back, port)
    assert back.inv_vocab == port.inv_vocab
