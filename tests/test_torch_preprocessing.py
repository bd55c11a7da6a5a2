"""The port's offline data tier against splade_tpu's, on the same inputs.

Each case of tests/test_preprocessing.py (cleaner, dedup, converters, the
TF-IDF and encoder miners, the pipeline, term pairs, the newer converters,
the registry) runs through the port's modules and the JAX package's, keeps
the reference test's own assertions on both, and the two results must be
equal. The framework-free modules are copies, so the tolerance is none:
MinHash signatures and duplicate decisions, converted triplets, TF-IDF
features and mined ids, and the pipeline's shards and ``val.jsonl`` are
bitwise the reference's (``metadata.json`` too, but for ``created`` and
``elapsed_sec``). The encoder miner is the one rewrite: one chunked f32
product and ``torch.topk`` on an explicit device; on a seeded stub encoder
without tied similarities it mines the reference's ids in both modes, and
without a card it raises unless asked for the CPU. Nothing downloads: the
HF ``datasets`` path and the urllib fetch are left untested or
monkeypatched, as the reference tests leave them."""

import dataclasses
import hashlib
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

MODULES = ("types", "config", "cleaners", "dedup", "converters",
           "downloaders", "miners", "pipeline", "term_pairs")


def _ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(name=pkg, pkg=importlib.import_module(
        f"{pkg}.preprocessing"), **{
        m: importlib.import_module(f"{pkg}.preprocessing.{m}")
        for m in MODULES})


JAX = _ns("splade_tpu")
PORT = _ns("splade_tpu_torch")
BOTH = pytest.mark.parametrize("m", [PORT, JAX], ids=["port", "jax"])


def both(fn, *args, **kw):
    """fn(package, *args, **kw) for the port, then the JAX package."""
    return [fn(m, *args, **kw) for m in (PORT, JAX)]


def as_dicts(triplets) -> list:
    return [dataclasses.asdict(t) for t in triplets]


def hangul(rng, n: int, words=(3, 9)) -> list:
    """Seeded Hangul sentences from the port's stem generator."""
    from splade_tpu_torch.utils.synth import random_hangul_stems

    stems = random_hangul_stems(rng, 300)
    return [" ".join(stems[j] for j in rng.integers(0, 300, int(
        rng.integers(*words)))) for _ in range(n)]


def test_the_package_exports_the_references_names():
    assert PORT.pkg.__all__ == JAX.pkg.__all__
    for name in JAX.pkg.__all__:
        assert getattr(PORT.pkg, name).__name__ == name


# ------------------------------------------------------------ cleaner
CLEANER_CASES = [
    ({}, "한국어  텍스트 https://x.co/a <b>tag</b> a@b.com 끝"),
    ({"min_hangul_ratio": 0.5}, "this is english only text"),
    ({"min_hangul_ratio": 0.5}, "한국어 비율이 높은 문장입니다"),
    ({"max_special_char_ratio": 0.2, "min_length": 5}, "@@@###!!! 한국"),
    ({"max_special_char_ratio": 0.2, "min_length": 5}, "짧다"),
    ({"max_length": 12}, "아주 긴 한국어 문장이 여기에 있습니다"),
    ({}, "Ｆｕｌｌｗｉｄｔｈ 한국어 ＮＦＣ 문장"),
]


@pytest.mark.parametrize("kw,text", CLEANER_CASES)
def test_cleaner_matches(kw, text):
    def run(m):
        c = m.cleaners.KoreanTextCleaner(**kw)
        return (c.normalize(text), c.hangul_ratio(text),
                c.special_char_ratio(text), c.clean(text),
                dataclasses.asdict(c.stats))

    port, ref = both(run)
    assert port == ref


@BOTH
def test_cleaner_reference_assertions(m):
    c = m.cleaners.KoreanTextCleaner()
    out = c.normalize("한국어  텍스트 https://x.co/a <b>tag</b> a@b.com 끝")
    assert "http" not in out and "<b>" not in out and "@" not in out
    c = m.cleaners.KoreanTextCleaner(max_special_char_ratio=0.2, min_length=5)
    assert c.clean("@@@###!!! 한국") is None and c.clean("짧다") is None
    assert c.stats.seen == 2 and c.stats.kept == 0


# ------------------------------------------------------------ dedup
def test_exact_dedup_matches():
    texts = ["같은 문장", "같은 문장", " 같은 문장 ", "다른 문장", "다른 문장"]
    port, ref = both(lambda m: [m.dedup.ExactDeduplicator().is_duplicate(t)
                                for t in texts])
    assert port == ref
    d = PORT.dedup.ExactDeduplicator()
    assert [d.is_duplicate(t) for t in texts] == [False, True, True, False,
                                                  True]


@pytest.mark.parametrize("kw", [{}, {"num_perm": 64, "bands": 8, "seed": 3},
                                {"num_perm": 100, "bands": 16, "ngram": 2}],
                         ids=["default", "64x8", "bands_adjusted"])
def test_minhash_signatures_and_decisions_are_bitwise(kw):
    """Seeded Hangul texts with planted exact and near duplicates: the
    signatures (uint64 wraparound hashing) and every is_duplicate decision
    equal the reference's bit for bit."""
    rng = np.random.default_rng(11)
    texts = hangul(rng, 120)
    texts += [texts[i] for i in range(0, 120, 7)]              # exact
    texts += [texts[i] + "!" for i in range(3, 120, 9)]        # near
    texts += ["ab", "", "가"]                                  # short
    order = rng.permutation(len(texts))
    texts = [texts[i] for i in order]

    def run(m):
        d = m.dedup.MinHashDeduplicator(threshold=0.7, **kw)
        sigs = np.stack([d.signature(t) for t in texts])
        return sigs, [d.is_duplicate(t) for t in texts], len(d), d.bands

    (sp, dp, np_, bp), (sr, dr, nr, br) = both(run)
    assert sp.dtype == sr.dtype == np.uint64
    np.testing.assert_array_equal(sp, sr)
    assert dp == dr and np_ == nr and bp == br
    assert 0 < sum(dp) < len(texts)


@BOTH
def test_minhash_reference_assertions(m):
    d = m.dedup.MinHashDeduplicator(threshold=0.7)
    base = "한국어 신경 희소 검색 모델을 위한 학습 데이터 구축 파이프라인"
    assert not d.is_duplicate(base)
    assert d.is_duplicate(base + "!")
    assert not d.is_duplicate("완전히 다른 주제의 요리 레시피 모음집입니다")
    s1 = d.signature("가나다라마바사아자차")
    assert d.jaccard_estimate(s1, d.signature("가나다라마바사아자차")) == 1.0
    assert d.jaccard_estimate(s1, d.signature("zzzz completely different")) < 0.3


# ------------------------------------------------------------ converters
def _sts(scores):
    return [("t", "sts", {"sentence1": f"A{i}", "sentence2": f"B{i}",
                          "score": s}) for i, s in enumerate(scores)]


CONVERTER_CASES = {
    "nli": [("t", "nli", {"premise": "P1", "hypothesis": "E1",
                          "label": "entailment"}),
            ("t", "nli", {"premise": "P1", "hypothesis": "C1",
                          "label": "contradiction"}),
            ("t", "nli", {"premise": "P1", "hypothesis": "N1",
                          "label": "neutral"}),
            ("t", "nli", {"premise": "P2", "hypothesis": "E2", "label": "0"}),
            ("t", "nli", {"premise": "P2", "hypothesis": "E3", "label": "0"}),
            ("t", "nli", {"premise": "P2", "hypothesis": "C2", "label": "2"})],
    "sts": _sts([4.5, 1.0, 3.0, 5.0, 0.5]),
    "sts_small_low": _sts([1.0, 0.0, 1.0]),
    "sts_int_low": _sts([1.0, 0.0] * 15),
    "sts_normalized": _sts([0.95, 0.1, 0.9] * 10),
    "classification": [("t", "classification", {"text": f"t{lab}{i}",
                                                 "label": lab})
                       for lab in ("x", "y", "z") for i in range(4)],
    "qa": [("t", "qa", {"question": "Q?", "context": "CTX"}),
           ("t", "qa", {"question": "Q2", "answer": "ANS"}),
           ("t", "qa", {"question": "same", "context": "same"})],
    "dialog": [("t", "dialog", {"instruction": "I", "output": "O"}),
               ("t", "dialog", {"utterance": "U", "response": "R"})],
    "pair": [("t", "pair", {"query": "q", "positive": "p", "negative": "n"}),
             ("t", "pair", {"text_a": "a", "text_b": "b",
                            "pair_type": "para"})],
    "triplet": [("k", "triplet", {"query": "질문", "document": "문서 본문",
                                  "hard_negative": "다른 문서"}),
                ("k", "triplet", {"query": "", "document": "x"})],
    "web_passage": [
        ("mc4", "web_passage",
         {"text": ("한국어 문장입니다 " * 10) + "\n\n"
          + ("한국어 문장입니다 " * 10) + " 두번째 문단"}),
        ("mc4", "web_passage", {"text": ("한국어 문장입니다 " * 30) + "\n\n"
                                + ("한국어 문장입니다 " * 10)}),
        ("mc4", "web_passage", {"text": "english only\n\nmore"}),
        ("mc4", "web_passage", {"text": "한국어 문장입니다 " * 10})],
    "translation": [
        ("opus", "translation", {"translation": {"ko": "서버가 죽었다",
                                                 "en": "the server died"}}),
        ("opus", "translation", {"translation": {"ko": "", "en": "empty"}}),
        ("opus", "translation", {"ko": "평문", "en": "flat"})],
}


@pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
def test_converters_match(case):
    task = case.split("_")[0] if case.startswith("sts") else case

    def run(m):
        samples = [m.types.RawSample(*s) for s in CONVERTER_CASES[case]]
        return as_dicts(m.converters.get_converter(task).convert(samples))

    port, ref = both(run)
    assert port == ref


@pytest.mark.parametrize("normalized", [True, False])
def test_sts_explicit_scale_matches(normalized):
    def run(m):
        conv = m.converters.STSConverter(normalized=normalized)
        return [as_dicts(conv.convert([m.types.RawSample(*s) for s in
                                       CONVERTER_CASES[case]]))
                for case in ("sts_small_low", "sts_normalized")]

    port, ref = both(run)
    assert port == ref
    assert all((got != []) == normalized for got in port)


@BOTH
def test_converter_reference_assertions(m):
    conv = m.converters.get_converter
    mk = lambda case: [m.types.RawSample(*s) for s in CONVERTER_CASES[case]]
    nli = conv("nli").convert(mk("nli")[:3])
    assert (nli[0].query, nli[0].positive, nli[0].negative) == ("P1", "E1",
                                                                 "C1")
    sts = conv("sts").convert(mk("sts")[:3])
    assert [(t.query, t.positive, t.negative) for t in sts] == [
        ("A0", "B0", "B1")]
    assert conv("sts").convert(mk("sts_small_low")) == []
    assert len(conv("sts").convert(mk("sts_normalized"))) == 20
    tr = conv("triplet").convert(mk("triplet"))
    assert len(tr) == 1 and tr[0].difficulty == "hard"
    assert len(conv("web_passage").convert(mk("web_passage"))) == 1
    with pytest.raises(KeyError):
        conv("nope")


# ------------------------------------------------------------ registry
def test_registry_matches():
    port, ref = both(lambda m: {k: dataclasses.asdict(v)
                                for k, v in m.downloaders.REGISTRY.items()})
    assert port == ref
    assert {"korquad2", "openorca-ko", "ko-alpaca", "ko-wikidata-qa",
            "ko-triplet-v1", "opus-100-en-ko", "mc4-ko",
            "wikipedia-ko"} <= set(port) and len(port) >= 13


@pytest.mark.parametrize("limit", [0, 3])
def test_local_drops_load_as_the_references(tmp_path, monkeypatch, limit):
    """$SPLADE_RAW_DATA/<key>.jsonl drops: the same RawSamples (NLI's
    integer labels mapped, unknown fields dropped, the limit kept)."""
    rows = {"kornli": [{"sentence1": "전제", "sentence2": "가설",
                        "gold_label": "entailment"},
                       {"premise": "전제2", "hypothesis": "가설2", "label": 2},
                       {"premise": "p", "hypothesis": "h", "label": 7,
                        "extra": 1}] * 2,
            "korsts": [{"sentence1": "가", "sentence2": "나", "score": 4.2}],
            "nsmc": [{"document": "영화 좋다", "label": 1, "id": 5}]}
    for key, rs in rows.items():
        (tmp_path / f"{key}.jsonl").write_text(
            "\n".join(json.dumps(r, ensure_ascii=False) for r in rs) + "\n\n")
    monkeypatch.setenv("SPLADE_RAW_DATA", str(tmp_path))

    def run(m):
        return {k: [dataclasses.asdict(s) for s in
                    m.downloaders.load_dataset_samples(k, limit=limit)]
                for k in rows}

    port, ref = both(run)
    assert port == ref
    assert len(port["kornli"]) == (limit or 6)


# ------------------------------------------------------------ TF-IDF miner
TRAVEL = ["서울 여행 맛집 추천 가이드", "부산 여행 숙소 추천 정보",
          "파이썬 프로그래밍 입문 강의", "머신러닝 모델 학습 방법"]


@pytest.mark.parametrize("kw", [{}, {"num_features": 512,
                                     "ngram_range": (1, 2)}],
                         ids=["default", "narrow"])
def test_tfidf_features_are_bitwise(kw):
    rng = np.random.default_rng(3)
    texts = hangul(rng, 200) + ["", "ABC def", "  공백  "]

    def run(m):
        mat = m.miners.TfidfHardNegativeMiner(**kw).fit_transform(texts)
        return mat.indptr, mat.indices, mat.data, mat.shape

    (pi, px, pd, ps), (ri, rx, rd, rs) = both(run)
    assert ps == rs and pd.dtype == rd.dtype
    for a, b in ((pi, ri), (px, rx), (pd, rd)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("chunk_size", [2048, 7])
def test_tfidf_mined_ids_are_the_references(exclude_self, chunk_size):
    rng = np.random.default_rng(4)
    corpus = hangul(rng, 300)
    queries = hangul(rng, 40) + corpus[:10]  # some queries drawn from it

    def run(m):
        miner = m.miners.TfidfHardNegativeMiner(
            top_k=5, chunk_size=chunk_size, exclude_self=exclude_self)
        return miner.mine(queries, corpus), miner.mine(queries, corpus, k=1)

    port, ref = both(run)
    assert port == ref
    assert all(len(row) == 5 for row in port[0])


@BOTH
def test_tfidf_reference_assertions(m, tmp_path):
    miner = m.miners.TfidfHardNegativeMiner(top_k=2)
    assert set(miner.mine(["서울 여행 일정 추천"], TRAVEL)[0][:2]) <= {0, 1}
    rows = [{"query": "서울 여행 추천", "positive": "서울 여행 맛집 가이드"},
            {"query": "파이썬 학습", "positive": "파이썬 프로그래밍 강의",
             "negative": "이미 있음"}]
    p = tmp_path / "shard.jsonl"
    p.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in rows))
    corpus = [r["positive"] for r in rows] + ["부산 여행 숙소 정보"]
    n = m.miners.TfidfHardNegativeMiner(top_k=3).fill_missing_negatives(
        str(p), corpus)
    back = [json.loads(line) for line in p.read_text().splitlines()]
    assert n == 1 and back[0]["negative"] != back[0]["positive"]
    assert back[1]["negative"] == "이미 있음"


def test_fill_missing_negatives_writes_the_references_bytes(tmp_path):
    rng = np.random.default_rng(5)
    qs, ps = hangul(rng, 60), hangul(rng, 60)
    rows = [{"query": q, "positive": p} for q, p in zip(qs, ps)]
    for i in range(0, 60, 5):
        rows[i]["negative"] = "이미 있는 부정 예시"
    rows[7]["negatives"] = ["여럿", "있음"]

    def run(m):
        d = tmp_path / m.name
        d.mkdir()
        shard = d / "shard.jsonl"
        shard.write_text("\n".join(json.dumps(r, ensure_ascii=False)
                                   for r in rows) + "\n")
        n = m.miners.TfidfHardNegativeMiner(top_k=2).fill_missing_negatives(
            str(shard))
        return n, shard.read_bytes()

    port, ref = both(run)
    assert port == ref and port[0] == 47


# ------------------------------------------------------------ encoder miner
class SeededEmb:
    """A stub encoder without tied similarities: each distinct text gets a
    seeded Gaussian row (from the text's bytes, so both packages see the
    same rows), plus a shared direction so similarities spread over the
    band. ``kind`` picks what ``encode`` returns."""

    def __init__(self, dim: int = 24, kind: str = "numpy"):
        self.dim, self.kind = dim, kind

    def _row(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.blake2b(
            text.encode("utf-8"), digest_size=8).digest(), "little")
        v = np.random.default_rng(seed).normal(size=self.dim)
        v[0] += 4.0
        return v.astype(np.float32)

    def encode(self, texts):
        out = np.stack([self._row(t) for t in texts]) if texts else np.zeros(
            (0, self.dim), np.float32)
        if self.kind == "tensor":
            return torch.from_numpy(out)
        if self.kind == "float64":
            return out.astype(np.float64)
        return out


def _encoder_case(seed: int = 6):
    rng = np.random.default_rng(seed)
    corpus = hangul(rng, 400)
    queries = hangul(rng, 50)
    positives = [corpus[int(i)] for i in rng.integers(0, 400, 50)]
    return queries, corpus, positives


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("batch_size", [256, 7])
def test_encoder_miner_mines_the_references_ids(kind, batch_size,
                                                monkeypatch):
    """Both modes on the stub without ties: equal ids (rank window with a
    positive inside it, band with a band some queries fill and some do
    not, and a wide band). Deep in a long list two f32 similarities come
    within an ulp and may swap (the f32 products sum in another order), so
    the lists stay at 40. The port's product runs in chunks: shrink them to
    cross one."""
    monkeypatch.setattr(PORT.miners, "QUERY_CHUNK", 16)
    queries, corpus, positives = _encoder_case()

    def run(m):
        kw = {"device": "cpu"} if m is PORT else {}
        miner = m.miners.EncoderHardNegativeMiner(
            SeededEmb(kind=kind if m is PORT else "numpy"),
            batch_size=batch_size, **kw)
        return (miner.mine_rank_window(queries, corpus, positives,
                                       rank_lo=2, rank_hi=20, k=7,
                                       search_k=30),
                miner.mine_band(queries, corpus, min_score=0.6,
                                max_score=0.7, k=4),
                miner.mine_band(queries, corpus, k=40))

    port, ref = both(run)
    assert port == ref
    window, band, wide = port
    assert all(len(row) == 7 for row in window)
    assert {len(row) for row in band} > {4}  # some short of k
    assert all(len(row) == 40 for row in wide)


def test_encoder_miner_skips_the_positive_inside_the_window():
    queries, corpus, _ = _encoder_case()
    emb = SeededEmb()
    q, c = emb.encode(queries), emb.encode(corpus)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    c = c / np.linalg.norm(c, axis=1, keepdims=True)
    # each query's positive: its 4th-ranked document
    positives = [corpus[int(np.argsort(-(c @ qi))[3])] for qi in q]
    miner = PORT.miners.EncoderHardNegativeMiner(emb, device="cpu")
    got = miner.mine_rank_window(queries, corpus, positives, rank_lo=0,
                                 rank_hi=6, k=6)
    for row, pos, qi in zip(got, positives, q):
        assert len(row) == 5 and pos not in [corpus[j] for j in row]
        assert row == [int(j) for j in np.argsort(-(c @ qi))[:6]
                       if corpus[j] != pos]


@BOTH
def test_encoder_miner_reference_assertions(m):
    class ToyEmb:
        def encode(self, texts):
            out = np.zeros((len(texts), 16), np.float32)
            for i, t in enumerate(texts):
                for w in t.split():
                    out[i, sum(w.encode()) % 16] += 1.0
            return out

    kw = {"device": "cpu"} if m is PORT else {}
    miner = m.miners.EncoderHardNegativeMiner(ToyEmb(), **kw)
    corpus = ["a b c", "a b d", "x y z", "a c e", "p q r"]
    assert miner.mine_band(["a b q"], corpus, min_score=0.1, max_score=0.95,
                           k=3)[0]
    window = miner.mine_rank_window(["a b q"], corpus, positives=["a b c"],
                                    rank_lo=1, rank_hi=4, k=2)
    assert "a b c" not in [corpus[j] for j in window[0]]


def test_encoder_miner_keeps_zero_rows_and_float64_encoders():
    """A zero embedding stays zero (its norm taken as 1) and an encoder
    that returns float64 is searched in f32, as the tolerance says."""
    class WithZero(SeededEmb):
        def encode(self, texts):
            out = super().encode(texts)
            out[[i for i, t in enumerate(texts) if t == "영"]] = 0.0
            return out

    corpus = ["영", "하나 둘", "셋 넷", "다섯"]
    port = PORT.miners.EncoderHardNegativeMiner(WithZero(), device="cpu")
    ref = JAX.miners.EncoderHardNegativeMiner(WithZero())
    for miner in (port, ref):
        assert miner.mine_band(["하나"], corpus, min_score=-0.5,
                               max_score=0.5, k=4)[0].count(0) == 1
    emb = PORT.miners.EncoderHardNegativeMiner(
        SeededEmb(kind="float64"), device="cpu")._encode(corpus)
    assert emb.dtype == torch.float32
    torch.testing.assert_close(emb.norm(dim=1), torch.ones(4))


def test_encoder_miner_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.miners.EncoderHardNegativeMiner(SeededEmb())
    assert PORT.miners.EncoderHardNegativeMiner(
        SeededEmb(), device="cpu").device.type == "cpu"


# ------------------------------------------------------------ pipeline
def _raw(m, rng, n: int = 60) -> list:
    """Raw samples over every registry task type, seeded Hangul text,
    planted exact and near duplicates and non-Korean junk."""
    texts = hangul(rng, 6 * n, words=(4, 12))
    it = iter(texts)
    S = m.types.RawSample
    out = []
    for i in range(n):
        out.append(S("synth-qa", "qa", {"question": next(it),
                                        "context": next(it)}))
        out.append(S("synth-dialog", "dialog", {"instruction": next(it),
                                                "output": next(it)}))
        out.append(S("synth-pair", "pair", {"query": next(it),
                                            "positive": next(it)}))
    for j, i in enumerate(range(0, n, 3)):
        out.append(S("synth-nli", "nli", {"premise": texts[i],
                                          "hypothesis": texts[i + 1],
                                          "label": "entailment"}))
        out.append(S("synth-nli", "nli", {"premise": texts[i],
                                          "hypothesis": texts[i + 2],
                                          "label": "contradiction"}))
        out.append(S("synth-sts", "sts", {"sentence1": texts[i + 3],
                                          "sentence2": texts[i + 4],
                                          "score": float(j % 6)}))
        out.append(S("synth-cls", "classification",
                     {"text": texts[i + 5], "label": j % 3}))
    out += [S(s.source, s.task, dict(s.fields)) for s in out[:12:2]]
    out += [S("synth-qa", "qa", {"question": texts[0] + "!",
                                 "context": texts[1]})]
    out += [S("synth-qa", "qa", {"question": "english only question",
                                 "context": "english only context"})]
    return out


def _run_pipeline(m, root, miner_of, seed=0, **cfg):
    cfg = m.config.PipelineConfig(output_dir=str(root / m.name / "out"),
                                  min_length=4, **cfg)
    miner = miner_of(m)
    pipe = m.pipeline.PreprocessingPipeline(cfg, miner=miner)
    meta = pipe.run(samples=_raw(m, np.random.default_rng(seed)))
    out = root / m.name / "out"
    files = {p.name: p.read_bytes() for p in sorted(out.iterdir())
             if p.name != "metadata.json"}
    written = json.loads((out / "metadata.json").read_text())
    for d in (meta, written):
        d.pop("created"), d.pop("elapsed_sec")
    return meta, written, files


MINERS = {
    "none": lambda m: None,
    "tfidf": lambda m: m.miners.TfidfHardNegativeMiner(top_k=1),
    "encoder": lambda m: m.miners.EncoderHardNegativeMiner(
        SeededEmb(), **({"device": "cpu"} if m is PORT else {})),
}


@pytest.mark.parametrize("miner", sorted(MINERS))
@pytest.mark.parametrize("shard_size,split", [(50, 0.8), (1000, 1.0)])
def test_pipeline_writes_the_references_bytes(tmp_path, miner, shard_size,
                                              split):
    """Same raw samples, same seed: the shards and val.jsonl byte for
    byte, the metadata equal but for created and elapsed_sec; the encoder
    miner's band search (the stub has no ties) fills the same negatives."""
    kw = dict(shard_size=shard_size, train_val_split=split,
              mining_min_score=0.5, mining_max_score=0.75)
    port, ref = both(_run_pipeline, tmp_path, MINERS[miner], 0, **kw)
    assert port == ref
    meta, written, files = port
    assert meta == written
    # 180 qa/dialog/pair + 20 NLI premises + 6 similar STS pairs + 17
    # same-label classification pairs + 8 planted rows
    assert (meta["raw_samples"], meta["converted"]) == (268, 231)
    assert meta["after_clean"] == 230  # the english row
    assert meta["after_dedup"] <= 230 - 7  # 6 exact, 1 near duplicate
    assert set(files) == {*meta["shards"], "val.jsonl"}
    assert (meta["with_negative"] > 100) == (miner != "none")


@pytest.mark.parametrize("use_bge_m3_mining", [True, False])
def test_pipeline_default_miner_rule(tmp_path, use_bge_m3_mining):
    """use_bge_m3_mining with no miner passed runs the default TF-IDF
    miner, whose negatives are the reference's."""
    port, ref = both(_run_pipeline, tmp_path, MINERS["none"], 1,
                     use_bge_m3_mining=use_bge_m3_mining)
    assert port == ref
    with_tfidf = _run_pipeline(PORT, tmp_path / "explicit", MINERS["tfidf"],
                               1)
    assert (port[2] == with_tfidf[2]) == use_bge_m3_mining


def test_pipeline_collect_reads_the_local_drops(tmp_path, monkeypatch):
    """collect(): the configured registry keys from $SPLADE_RAW_DATA, a
    key without a drop skipped (the HF path is not reached: datasets is
    absent here, as on the card machine)."""
    rng = np.random.default_rng(8)
    texts = hangul(rng, 40)
    (tmp_path / "korquad.jsonl").write_text("\n".join(json.dumps(
        {"question": texts[i], "context": texts[i + 1]}, ensure_ascii=False)
        for i in range(0, 40, 2)))
    monkeypatch.setenv("SPLADE_RAW_DATA", str(tmp_path))
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)

    def run(m):
        cfg = m.config.PipelineConfig(datasets=["korquad", "klue-mrc"])
        return [dataclasses.asdict(s) for s in
                m.pipeline.PreprocessingPipeline(cfg).collect()]

    port, ref = both(run)
    assert port == ref and len(port) == 20


# ------------------------------------------------------------ term pairs
def test_term_pair_parsers_match():
    muse = ["서버 server", "검색 search", "bad", "x y", "데이터 DATA",
            "가 a", "서버 (컴퓨터) serverx"]
    wikidata = {"results": {"bindings": [
        {"koLabel": {"value": "데이터베이스"}, "enLabel": {"value": "Database"}},
        {"koLabel": {"value": "서버 (컴퓨터)"},
         "enLabel": {"value": "Server (computing)"}},
        {"koLabel": {"value": "no korean"}, "enLabel": {"value": "nothing"}},
        {"koLabel": {"value": "약어"}, "enLabel": {"value": "ABCDEFGH"}}]}}
    wiki = {"query": {"pages": {
        "1": {"title": "알고리즘", "langlinks": [
            {"lang": "en", "*": "Algorithm"}, {"lang": "ja", "*": "ア"}]},
        "2": {"title": "English title", "langlinks": [
            {"lang": "en", "*": "Ignored"}]},
        "3": {"title": "링크없음"},
        "4": {"title": "신경망", "langlinks": [
            {"lang": "en", "title": "Neural network"}]}}}}

    def run(m):
        tp = m.term_pairs
        return (tp.parse_muse_lines(muse, "ko"), tp.parse_muse_lines(
            ["server 서버", "Search 검색엔진"], "en"),
            tp.parse_wikidata_bindings(wikidata),
            tp.parse_wikipedia_langlinks(wiki),
            [tp.clean_term(t) for t in ("서버 (server)", "(x)", " 공백 ")],
            [tp.is_valid_english(t) for t in ("", "ABCDEFG", "AB", "1", "é")],
            [tp.is_korean(t) for t in ("한", "abc", "ᄀ")])

    port, ref = both(run)
    assert port == ref
    assert {(p["ko"], p["en"]) for p in port[0]} == {("서버", "server"),
                                                    ("검색", "search"),
                                                    ("데이터", "data")}


def test_filter_dedup_and_triplets_match():
    pairs = [
        {"ko": "서버", "en": "server", "source": "a"},
        {"ko": "서버", "en": "Server", "source": "b"},
        {"ko": "짧", "en": "server", "source": "a"},
        {"ko": "서버", "en": "s", "source": "a"},
        {"ko": "서버" * 20, "en": "server", "source": "a"},
        {"ko": "서버", "en": "x" * 60, "source": "a"},
        {"ko": "abcd", "en": "server", "source": "a"},
        {"ko": "서버", "en": "ABCDEFGH", "source": "a"},
        {"ko": "서버", "en": "a-", "source": "a"},
        {"ko": "검색", "en": "search", "source": "muse"},
    ]

    def run(m):
        unique, rejected = m.term_pairs.filter_and_deduplicate(pairs)
        return unique, rejected, m.term_pairs.pairs_to_triplets(unique)

    port, ref = both(run)
    assert port == ref
    unique, rejected, rows = port
    for reason in ("ko_too_short", "en_too_short", "ko_too_long",
                   "en_too_long", "no_korean", "invalid_english",
                   "en_no_letters", "duplicates"):
        assert rejected[reason] == 1, reason
    assert rows[0] == {"query": "서버", "positive": "서버 (server)",
                       "pair_type": "term", "source": "term_a"}


def _term_cache(root):
    (root / "muse").mkdir(parents=True)
    (root / "muse" / "ko-en.txt").write_text("서버 server\n검색 search\n")
    (root / "muse" / "en-ko.txt").write_text("index 색인\n")
    (root / "ko-en-root.txt").write_text("모델 model\n")
    (root / "wikidata.json").write_text(json.dumps(
        {"results": {"bindings": [{"koLabel": {"value": "암호화"},
                                   "enLabel": {"value": "Encryption"}}]}}))
    (root / "wikipedia_langlinks.jsonl").write_text(json.dumps(
        {"query": {"pages": {"1": {"title": "신경망", "langlinks": [
            {"lang": "en", "*": "Neural network"}]}}}}))


def test_collectors_read_the_local_cache(tmp_path, monkeypatch):
    _term_cache(tmp_path / "terms")
    monkeypatch.setenv("SPLADE_TERM_DATA", str(tmp_path / "terms"))

    def no_fetch(*a, **k):
        raise AssertionError("must not hit the network with a cache")

    def run(m):
        tp = m.term_pairs
        return (tp.collect_muse(no_fetch), tp.collect_wikidata(no_fetch),
                tp.collect_wikipedia(no_fetch))

    port, ref = both(run)
    assert port == ref
    assert len(port[0]) == 4 and port[1][0]["ko"] == "암호화"
    assert port[2][0]["en"] == "neural network"


@pytest.mark.parametrize("hook", ["dead", "default_patched"])
def test_collectors_degrade_offline(monkeypatch, hook):
    """With no cache every collector returns [] when the fetch fails: a
    dead hook, or the default urllib fetch with urlopen monkeypatched to
    fail (no request leaves the host)."""
    import urllib.request

    monkeypatch.delenv("SPLADE_TERM_DATA", raising=False)
    calls = []

    def dead(*a, **k):
        calls.append(a[0])
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", dead)
    fetch = dead if hook == "dead" else None

    def run(m):
        tp = m.term_pairs
        return (tp.collect_muse(fetch), tp.collect_wikidata(fetch),
                tp.collect_wikipedia(fetch, batches=2))

    port, ref = both(run)
    assert port == ref == ([], [], [])
    assert len(calls) == 2 * 4  # 2 MUSE, 1 Wikidata, 1 Wikipedia, each
