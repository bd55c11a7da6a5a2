"""The port's benchmark harness against splade_tpu's, on the same inputs.

Each case of tests/test_benchmark.py (metrics, fusion, BM25 and its
analyzers with the kiwi and mecab stubs, the exact indexes,
BenchmarkConfig, RRF symmetry, the bootstrap variants, the triplet
benchmark, the encoding cache's round trip and its refusals) runs through
the port's functions and the JAX package's, keeps the reference test's
own assertions on both, and the two results must be equal: the port's
modules are copies, so nothing but identical numbers passes. The runner
end to end: on the reference tests' ToySparse and ToyDense (every method,
the postings row on the CPU, the external dense model, graceful
degradation) the port's metrics.json equals the JAX runner's in
everything but the latency fields; with the port's SparseEncoderV33 on a
tiny random ModernBERT (the JAX weights through params_from_jax, both in
f32) the rankings are equal and the scores within 1e-5 of the largest;
``--cluster-index`` raises."""

import importlib
import json
import sys
import types
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = ("bm25", "config", "data", "encoders", "fusion", "index",
           "metrics", "record", "report", "runner", "searchers")


def _ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(name=pkg, **{
        m: importlib.import_module(f"{pkg}.benchmark.{m}") for m in MODULES})


JAX = _ns("splade_tpu")
PORT = _ns("splade_tpu_torch")


def both(fn, tmp_path, *args) -> list:
    """fn(package, its own tmp dir, *args) for the port, then the JAX
    package."""
    out = []
    for m in (PORT, JAX):
        (tmp_path / m.name).mkdir()
        out.append(fn(m, tmp_path / m.name, *args))
    return out


def runner_kw(m) -> dict:
    """The port's runner runs on an explicit device: the CPU here."""
    return {"device": "cpu"} if m is PORT else {}


def qr(m, retrieved, relevant, qid="q", lat=1.0):
    return m.metrics.QueryResult(qid, list(retrieved), set(relevant), lat)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ------------------------------------------------------------------ metrics
@case
def hit_rank_and_recall(m, tmp, mp):
    r = qr(m, ["a", "b", "c"], {"b"})
    assert r.hit_rank == 2
    results = [qr(m, ["a"], {"a"}), qr(m, ["x", "a"], {"a"}),
               qr(m, ["x"], {"a"})]
    out = m.metrics.aggregate_metrics(results)
    assert out["recall@1"] == pytest.approx(1 / 3)
    assert out["recall@5"] == pytest.approx(2 / 3)
    assert out["mrr"] == pytest.approx((1 + 0.5 + 0) / 3)
    return out


@case
def ndcg_golden(m, tmp, mp):
    got = m.metrics.ndcg_at_k(qr(m, ["x", "a"], {"a"}), 10)
    assert got == pytest.approx(1 / np.log2(3))
    return got


@case
def paired_t_matches_scipy(m, tmp, mp):
    from scipy import stats

    rng = np.random.default_rng(0)
    a = [qr(m, ["a"], {"a"} if rng.random() < 0.7 else {"z"}, qid=str(i))
         for i in range(60)]
    b = [qr(m, ["a"], {"a"} if rng.random() < 0.4 else {"z"}, qid=str(i))
         for i in range(60)]
    got = m.metrics.paired_t_test(a, b)
    want = stats.ttest_rel([r.reciprocal_rank for r in a],
                           [r.reciprocal_rank for r in b])
    assert got["t_statistic"] == pytest.approx(want.statistic, rel=1e-6)
    assert got["p_value"] == pytest.approx(want.pvalue, rel=1e-4)
    return got


@case
def paired_t_zero_variance(m, tmp, mp):
    out = (m.metrics.paired_t_test_values([1.0, 1.0, 1.0], [0.5] * 3),
           m.metrics.paired_t_test_values([0.5] * 3, [0.5] * 3),
           m.metrics.paired_t_test_values([1.0], [0.0]))
    assert out[0]["p_value"] == 0.0 and out[1]["p_value"] == 1.0
    return out


@case
def bootstrap_ci_brackets_mean(m, tmp, mp):
    results = [qr(m, ["a"], {"a"}, qid=str(i)) for i in range(30)] + [
        qr(m, ["x"], {"a"}, qid=str(i + 30)) for i in range(10)]
    ci = m.metrics.bootstrap_ci(results, "recall@1", n_boot=200)
    assert ci["lower"] <= 0.75 <= ci["upper"]
    return ci


@case
def bootstrap_ci_metric_variants(m, tmp, mp):
    rng = __import__("random").Random(0)
    results = [
        m.metrics.QueryResult(f"q{i}", [f"d{i}" if rng.random() < 0.6
                                        else "x"], {f"d{i}"},
                              latency_ms=rng.random() * 10)
        for i in range(100)]
    out = {}
    for metric in ("recall@1", "mrr", "ndcg@10", "latency_p50_ms"):
        ci = m.metrics.bootstrap_ci(results, metric, n_boot=100)
        assert ci["lower"] <= ci["mean"] <= ci["upper"]
        out[metric] = ci
    with pytest.raises(ValueError):
        m.metrics.bootstrap_ci(results, "nope")
    return out


@case
def betainc_values(m, tmp, mp):
    return [m.metrics._betainc(a, b, x) for a, b, x in
            ((2.5, 0.5, 0.3), (10.0, 0.5, 0.95), (0.5, 0.5, 0.0),
             (3.0, 0.5, 1.0), (29.5, 0.5, 0.5))]


# ------------------------------------------------------------------- fusion
@case
def rrf_prefers_consensus(m, tmp, mp):
    l1 = [("a", 9.0), ("b", 8.0), ("c", 7.0)]
    l2 = [("b", 5.0), ("a", 4.0), ("d", 3.0)]
    fused = m.fusion.RRFFusion(k=60).fuse([l1, l2], top_k=4)
    assert {d for d, _ in fused[:2]} == {"a", "b"}
    assert fused[0][1] == pytest.approx(1 / 61 + 1 / 62)
    return fused


@case
def linear_alpha_golden(m, tmp, mp):
    fused = dict(m.fusion.LinearFusion(0.3).fuse(
        [[("a", 2.0), ("b", 1.0)], [("b", 4.0), ("a", 0.0)]], top_k=2))
    assert fused["a"] == pytest.approx(0.3)
    assert fused["b"] == pytest.approx(0.7)
    flat = m.fusion.LinearFusion(0.5).fuse([[("a", 1.0), ("b", 1.0)], []])
    return fused, flat


@case
def weighted_rrf_and_factory(m, tmp, mp):
    fused = dict(m.fusion.WeightedRRFFusion([0.9, 0.1]).fuse(
        [[("a", 1.0)], [("b", 1.0)]], top_k=2))
    assert fused["a"] > fused["b"]
    kinds = [type(m.fusion.create_fusion(name, **kw)).__name__
             for name, kw in (("rrf", {}), ("linear", {"alpha": 0.4}),
                              ("weighted-rrf", {"weights": [1, 2]}))]
    assert kinds == ["RRFFusion", "LinearFusion", "WeightedRRFFusion"]
    with pytest.raises(ValueError):
        m.fusion.create_fusion("nope")
    return fused, kinds


@case
def rrf_missing_doc_penalty_is_order_symmetric(m, tmp, mp):
    l1, l2 = [("A", 1.0)], [("B", 1.0)]
    f = m.fusion.RRFFusion(k=60)
    ab = dict(f.fuse([l1, l2], top_k=4))
    assert ab == dict(f.fuse([l2, l1], top_k=4))
    assert ab["A"] == pytest.approx(1 / 61 + 1 / 160)
    w = dict(m.fusion.WeightedRRFFusion([0.5, 0.5]).fuse([l1, l2], top_k=4))
    assert w["A"] == pytest.approx(0.5 / 61 + 0.5 / 160)
    return ab, w


# --------------------------------------------------------------------- BM25
@case
def bm25_scores_and_ranking(m, tmp, mp):
    idx = m.bm25.BM25Index(analyzer=m.bm25.whitespace_analyzer)
    idx.add_documents([
        ("d1", "neural sparse retrieval korean"),
        ("d2", "dense vector retrieval"),
        ("d3", "korean cuisine recipes kimchi")])
    idx.finalize()
    res = idx.search("korean retrieval", k=3)
    assert res[0][0] == "d1" and all(s > 0 for _, s in res)
    return res, len(idx)


@case
def bm25_idf_golden_and_lazy_refresh(m, tmp, mp):
    idx = m.bm25.BM25Index(analyzer=m.bm25.whitespace_analyzer)
    idx.add_documents([("d1", "x y"), ("d2", "x"), ("d3", "z")])
    idx.finalize()
    assert idx._idf["x"] == pytest.approx(np.log(1 + (3 - 2 + 0.5) / 2.5))
    assert idx._idf["z"] == pytest.approx(np.log(1 + (3 - 1 + 0.5) / 1.5))
    idf = dict(idx._idf)
    idx.add_documents([("d4", "x z z")])  # stats recomputed at search
    return idf, idx.search("x z", 4)


@case
def heuristic_strips_josa(m, tmp, mp):
    an = m.bm25.korean_heuristic_analyzer
    out = [an(t) for t in ("한국어는 어렵다", "검색엔진이 문서를 찾는다",
                           "JAX, rocks!", "은 는", "ᄀᄂ은 학교에서")]
    assert out[:4] == [["한국어", "어렵다"], ["검색엔진", "문서", "찾는다"],
                       ["jax", "rocks"], ["은", "는"]]
    return out


@case
def heuristic_improves_bm25_on_inflected_docs(m, tmp, mp):
    docs = [("pos", "검색엔진은 문서를 색인한다"), ("neg", "김치는 발효 음식이다")]
    out = []
    for analyzer in (m.bm25.whitespace_analyzer,
                     m.bm25.korean_heuristic_analyzer):
        idx = m.bm25.BM25Index(analyzer=analyzer)
        idx.add_documents(docs)
        idx.finalize()
        out.append(idx.search("검색엔진 문서", 2))
    assert out[0] == [] and out[1][0][0] == "pos"
    return out


@case
def morphological_backend_gating(m, tmp, mp):
    mp.setitem(sys.modules, "kiwipiepy", None)
    mp.setitem(sys.modules, "MeCab", None)
    msgs = []
    for backend in ("auto", "kiwi", "mecab"):
        with pytest.raises(ImportError) as e:
            m.bm25.make_morphological_analyzer(backend)
        msgs.append(str(e.value))
    assert all("korean_heuristic_analyzer" in s or "install" in s
               for s in msgs)
    return msgs


@case
def kiwi_backend_path_with_stub(m, tmp, mp):
    class Tok:
        def __init__(self, form, tag):
            self.form, self.tag = form, tag

    class FakeKiwi:
        def tokenize(self, text):
            return [Tok("검색", "NNG"), Tok("은", "JX"), Tok("Engine", "SL"),
                    Tok("하", "VV"), Tok("ㅂ니다", "EF"), Tok("3", "SN")]

    mod = types.ModuleType("kiwipiepy")
    mod.Kiwi = FakeKiwi
    mp.setitem(sys.modules, "kiwipiepy", mod)
    got = m.bm25.make_morphological_analyzer("kiwi")("검색은 Engine 합니다 3")
    assert got == ["검색", "engine", "하", "3"]
    return got


@case
def mecab_backend_path_with_stub(m, tmp, mp):
    class FakeTagger:
        def __init__(self, *a):
            pass

        def parse(self, text):
            return ("검색\tNNG,*\n은\tJX,*\nengine\tSL,*\n"
                    "했\tVV+EP,*\n다\tEF,*\nEOS\n")

    mod = types.ModuleType("MeCab")
    mod.Tagger = FakeTagger
    mp.setitem(sys.modules, "MeCab", mod)
    mp.setitem(sys.modules, "kiwipiepy", None)
    out = m.bm25.make_morphological_analyzer("mecab")("검색은 engine 했다")
    assert "검색" in out and "engine" in out and "은" not in out
    auto = m.bm25.make_morphological_analyzer("auto")("x")
    return out, auto


class WordTokenizer:
    """HF call signature; ids from a fixed word list, specials 0 and 1."""

    all_special_ids = [0, 1]
    words = ["[PAD]", "[CLS]", "alpha", "beta", "gamma"]

    def __call__(self, text, add_special_tokens=True, truncation=False,
                 verbose=False):
        ids = [self.words.index(w) if w in self.words else 1
               for w in text.split()]
        return {"input_ids": ([1] if add_special_tokens else []) + ids}


@case
def resolve_analyzer(m, tmp, mp):
    assert m.bm25.resolve_analyzer("whitespace") is m.bm25.whitespace_analyzer
    assert (m.bm25.resolve_analyzer("korean-heuristic")
            is m.bm25.korean_heuristic_analyzer)
    for bad in ("wordpiece", "nope"):
        with pytest.raises(ValueError):
            m.bm25.resolve_analyzer(bad)
    wp = m.bm25.resolve_analyzer("wordpiece", WordTokenizer())
    return wp("alpha gamma zeta beta")


# ----------------------------------------------------------- exact indexes
@case
def sparse_exact_dot(m, tmp, mp):
    idx = m.index.ExactSparseIndex(vocab_size=10)
    idx.add("d1", np.array([1, 3]), np.array([2.0, 1.0]))
    idx.add("d2", np.array([3, 5]), np.array([3.0, 4.0]))
    res = idx.search_vector(np.array([3]), np.array([1.0]), k=2)
    assert res == [("d2", pytest.approx(3.0)), ("d1", pytest.approx(1.0))]
    # a query with no overlapping term is no hit
    assert idx.search_vector(np.array([7]), np.array([1.0]), k=2) == []
    return res, idx.nnz, len(idx)


@case
def sparse_dense_roundtrip_topk(m, tmp, mp):
    idx = m.index.ExactSparseIndex(vocab_size=8)
    vec = np.array([0, 5.0, 0, 1.0, 3.0, 0, 0, 2.0])
    idx.add_dense("d", vec, top_k=2)
    assert idx.nnz == 2
    res = idx.search_dense(vec, k=1)
    assert res[0] == ("d", pytest.approx(34.0))
    return res, idx.search_dense(vec, k=1, query_top_k=1)


@case
def dense_exact(m, tmp, mp):
    idx = m.index.ExactDenseIndex(3)
    idx.add("a", np.array([1.0, 0, 0]))
    idx.add("b", np.array([0.6, 0.8, 0]))
    res = idx.search(np.array([1.0, 0.0, 0.0]), k=2)
    assert res[0][0] == "a"
    return res, m.index.ExactDenseIndex(3).search(np.ones(3), 2)


# ------------------------------------------------------------------ config
@case
def benchmark_config_from_env(m, tmp, mp):
    mp.setenv("BENCH_SAMPLE_SIZE", "500")
    mp.setenv("BENCH_INCLUDE_HYBRID", "false")
    mp.setenv("BENCH_DATASET", "miracl-ko")
    cfg = m.config.BenchmarkConfig.from_env(top_k=5, checkpoint=None)
    assert (cfg.sample_size, cfg.include_hybrid, cfg.top_k) == (500, False, 5)
    mp.delenv("BENCH_SAMPLE_SIZE")
    return [vars(cfg), vars(m.config.BenchmarkConfig.from_env())]


# -------------------------------------------------------------------- data
@case
def triplet_benchmark_construction(m, tmp, mp):
    rows = [{"query": f"q{i}", "positive": f"pos text {i}",
             "negative": f"neg text {i}",
             "difficulty": "hard" if i % 2 else "easy"} for i in range(10)]
    f = tmp / "val.jsonl"
    f.write_text("\n".join(json.dumps(r) for r in rows))
    data = m.data.load_triplet_benchmark(str(f), sample_size=6, seed=42)
    assert len(data.queries) == 6
    for rel in data.qrels.values():
        assert len(rel) == 1 and next(iter(rel)).endswith("_pos")
    assert len(data.corpus) == 12  # pos + neg per sampled triplet
    more = [{"query": "qs", "positive": "ps", "negatives": "one neg"},
            {"query": "ql", "positive": "pl", "negatives": ["n a", "n b"]}]
    (tmp / "val2.jsonl").write_text("\n".join(json.dumps(r) for r in more))
    full = m.data.load_triplet_benchmark(str(tmp / "val*.jsonl"),
                                         sample_size=0)
    assert len(full.corpus) == 10 * 2 + 2 + 3  # a string negative: one doc
    return [(d.name, d.corpus, d.queries, d.qrels) for d in (data, full)]


@case
def local_jsonl_benchmark(m, tmp, mp):
    root = tmp / "bench" / "mine"
    root.mkdir(parents=True)
    (root / "corpus.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"_id": 1, "title": "T", "text": "first"}, {"_id": "d2", "text": "x"},
        {"_id": "d3", "text": "y"})))
    (root / "queries.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"_id": "q1", "text": "one"}, {"_id": "q2", "text": "two"},
        {"_id": "q3", "text": "no relevant doc"})))
    (root / "qrels.tsv").write_text(
        "query-id\tcorpus-id\tscore\nq1\t1\t1\nq2\td3\t2\nq3\td2\t0\n"
        "q2\tmissing\t1\n")
    mp.setenv("SPLADE_BENCH_DATA", str(tmp / "bench"))
    data = m.data.load_benchmark("mine")
    assert data.qrels == {"q1": {"1"}, "q2": {"d3"}}
    with pytest.raises(FileNotFoundError):
        m.data.load_benchmark("absent")
    return data.name, data.corpus, data.queries, data.qrels


@case
def hf_loaders_without_data_say_so(m, tmp, mp):
    mp.delenv("SPLADE_BENCH_DATA", raising=False)
    mp.setenv("HF_DATASETS_OFFLINE", "1")
    mp.setenv("HF_HUB_OFFLINE", "1")
    mp.setitem(sys.modules, "datasets", None)
    msgs = []
    for name in ("ko-strategyqa", "miracl-ko", "mrtydi-ko"):
        with pytest.raises(FileNotFoundError) as e:
            m.data.load_benchmark(name)
        msgs.append(str(e.value).split(":")[0])
    return msgs


# ------------------------------------------------------------ report/record
@case
def report_markdown(m, tmp, mp):
    metrics = {"bm25": {"recall@1": 0.5, "mrr": 0.6, "latency_p50_ms": 2.0},
               "neural_sparse": {"recall@1": 0.75, "ndcg@10": 0.7}}
    tests = {"neural_sparse vs bm25": {"t_statistic": 2.5,
                                       "p_value": 0.0004,
                                       "mean_diff": 0.25}}
    text = m.report.generate_report("toy", metrics, tests, {"docs": 4})
    assert "| neural_sparse | 75.0%" in text and "***" in text
    return [ln for ln in text.splitlines() if not ln.startswith("Generated")]


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_the_reference(name, tmp_path, monkeypatch):
    """The reference test's assertions hold on both packages, and their
    results are equal."""
    got, want = both(CASES[name], tmp_path, monkeypatch)
    assert got == want


# ------------------------------------------------------------------ runner
class ToyDense:
    """Deterministic dense encoder: hashed bag of chars, normalized."""

    dim = 16

    def encode(self, texts):
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for c in t:
                out[i, ord(c) % self.dim] += 1.0
        return out / (np.linalg.norm(out, axis=1, keepdims=True) + 1e-9)


class ToySparse:
    """Word-hash sparse encoder with the SparseEncoderV33 interface."""

    def __init__(self, vocab_size=64):
        self.V = vocab_size

    def _vec(self, text):
        v = np.zeros(self.V, np.float32)
        for w in text.split():
            v[zlib.crc32(w.encode()) % self.V] += 1.0
        nz = np.flatnonzero(v)
        return nz.astype(np.int32), v[nz]

    def encode_documents(self, texts):
        return [self._vec(t) for t in texts]

    def encode_for_query(self, text):
        return self._vec(text)


class Bomb(ToySparse):
    def encode_for_query(self, text):
        raise RuntimeError("encoder down")


def synthetic_benchmark(m, n=24):
    rng = np.random.default_rng(3)
    topics = ["alpha beta", "gamma delta", "epsilon zeta", "eta theta"]
    corpus, queries, qrels = {}, {}, {}
    for i in range(n):
        corpus[f"d{i}"] = f"{topics[i % 4]} doc{i} " + " ".join(
            rng.choice(["filler", "text", "word"], size=3))
    for i in range(8):
        queries[f"q{i}"] = topics[i % 4]
        qrels[f"q{i}"] = {f"d{j}" for j in range(n) if j % 4 == i % 4}
    return m.data.BenchmarkData("synthetic", corpus, queries, qrels)


def _without_latency(metrics: dict) -> dict:
    out = json.loads(json.dumps(metrics))
    for row in out["methods"].values():
        for k in [k for k in row if k.startswith("latency")]:
            del row[k]
    return out


def _external(m, tmp, data):
    texts = list(data.corpus.values()) + list(data.queries.values())
    path = tmp / "titan.npz"
    m.encoders.PrecomputedDenseEncoder.save_embeddings(
        str(path), texts, ToyDense().encode(texts) + 0.01)
    ext = m.encoders.PrecomputedDenseEncoder(str(path))
    np.testing.assert_allclose(np.linalg.norm(ext.encode(texts[:3]), axis=1),
                               1.0, rtol=1e-5)
    with pytest.raises(KeyError):
        ext.encode(["never embedded"])
    return ext


RUNS = {
    "all_methods": lambda m, tmp: dict(sparse_encoder=ToySparse(),
                                       dense_encoder=ToyDense()),
    "postings_row": lambda m, tmp: dict(sparse_encoder=ToySparse(),
                                        postings_index=True),
    "external_dense": lambda m, tmp: dict(
        sparse_encoder=ToySparse(), dense_encoder=ToyDense(),
        external_dense_encoder=_external(m, tmp, synthetic_benchmark(m))),
    "query_failure": lambda m, tmp: dict(sparse_encoder=Bomb(),
                                         include_hybrid=False),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_runner_metrics_match_the_reference(run, tmp_path):
    """The whole runner on the toy encoders: metrics.json equal to the JAX
    runner's but for the latency fields, the report written."""
    def metrics(m, tmp):
        runner = m.runner.BenchmarkRunner(
            synthetic_benchmark(m), output_dir=str(tmp / "out"),
            **RUNS[run](m, tmp), **runner_kw(m))
        summary = runner.run()
        runner.save(summary, runner.statistical_tests())
        assert (tmp / "out" / "report.md").exists()
        return json.loads((tmp / "out" / "metrics.json").read_text())

    got, want = both(metrics, tmp_path)
    assert _without_latency(got) == _without_latency(want)
    methods = got["methods"]
    if run == "all_methods":
        assert set(methods) == {
            "bm25", "neural_sparse", "semantic", "bm25_semantic_rrf",
            "hybrid_rrf", "hybrid_linear_0.3", "hybrid_linear_0.4",
            "hybrid_linear_0.5", "hybrid_weighted_rrf", "bm25_sparse_rrf",
            "triple_rrf"}
        assert methods["bm25"]["recall@1"] == 1.0
        assert methods["neural_sparse"]["recall@1"] == 1.0
        assert "neural_sparse vs bm25" in got["statistical_tests"]
    elif run == "postings_row":
        assert (methods["neural_sparse_postings"]["recall@1"]
                == methods["neural_sparse"]["recall@1"] == 1.0)
    elif run == "external_dense":
        assert {"external_dense", "sparse_external_rrf", "dual_dense_rrf",
                "quad_rrf"} <= set(methods)
        assert methods["external_dense"]["recall@1"] > 0
    else:
        assert methods["neural_sparse"]["recall@1"] == 0.0
        assert methods["bm25"]["recall@1"] > 0


def test_runner_postings_row_uses_the_ports_postings_index(tmp_path):
    from splade_tpu_torch.ops.postings_index import PostingsIndex

    runner = PORT.runner.BenchmarkRunner(
        synthetic_benchmark(PORT), sparse_encoder=ToySparse(),
        postings_index=True, include_hybrid=False,
        output_dir=str(tmp_path), device="cpu")
    runner.setup()
    index = runner.searchers["neural_sparse_postings"].index
    assert isinstance(index, PostingsIndex) and index.device.type == "cpu"
    assert (index.n_postings, index.query_top_t, index.rescore_candidates,
            index.scoring) == (256, 32, 24, "sort")


def _cache_case(m, tmp, tamper):
    """Save a runner's encodings, tamper with the file, load it into a
    runner whose encoder must not be asked again when the cache is
    usable. -> (loaded?, the second run's neural_sparse metrics)."""
    data = synthetic_benchmark(m)
    first = m.runner.BenchmarkRunner(data, sparse_encoder=ToySparse(),
                                     include_hybrid=False,
                                     output_dir=str(tmp), **runner_kw(m))
    with pytest.raises(RuntimeError):
        first.save_encodings(str(tmp / "unused.npz"))
    first.setup()
    path = str(tmp / "enc.npz")
    first.save_encodings(path)
    z = dict(np.load(path, allow_pickle=False))
    assert z["indices"].dtype != object
    if tamper == "fingerprint":
        z["fingerprint"] = np.asarray("another checkpoint")
    elif tamper == "legacy_pickle":
        z["doc_ids"] = np.asarray([[1], "x"], dtype=object)
    elif tamper == "no_lens":
        del z["lens"]
    if tamper != "none":
        np.savez(path, **z)

    class CountingBomb(ToySparse):
        calls = 0

        def encode_documents(self, texts):
            CountingBomb.calls += 1
            if tamper == "none":
                raise AssertionError("should reuse cached encodings")
            return super().encode_documents(texts)

    second = m.runner.BenchmarkRunner(data, sparse_encoder=CountingBomb(),
                                      include_hybrid=False,
                                      output_dir=str(tmp), **runner_kw(m))
    loaded = second.load_encodings(path)
    assert loaded == (tamper == "none")
    out = second.run()["neural_sparse"]
    assert out["recall@1"] == 1.0
    assert CountingBomb.calls == (0 if loaded else 1)
    return loaded, {k: v for k, v in out.items() if "latency" not in k}


@pytest.mark.parametrize("tamper", ["none", "fingerprint", "legacy_pickle",
                                    "no_lens"])
def test_encoding_cache_roundtrip_and_refusals(tamper, tmp_path):
    got, want = both(_cache_case, tmp_path, tamper)
    assert got == want


def test_cluster_index_raises(tmp_path):
    data = synthetic_benchmark(PORT)
    with pytest.raises(NotImplementedError, match="Cluster index"):
        PORT.runner.BenchmarkRunner(data, sparse_encoder=ToySparse(),
                                    cluster_index=True, device="cpu")
    f = tmp_path / "val.jsonl"
    f.write_text(json.dumps({"query": "q", "positive": "p"}))
    with pytest.raises(NotImplementedError, match="Cluster index"):
        PORT.runner.main(["--dataset", "triplet-val", "--val-files", str(f),
                          "--cluster-index", "--device", "cpu"])


def test_index_backend_gpu_is_the_ports_impact_index(tmp_path):
    """--index gpu: ImpactIndex on the runner's device; on the CPU its
    neural_sparse row equals the exact one's."""
    from splade_tpu_torch.ops.impact_index import ImpactIndex

    rows = {}
    for backend in ("exact", "gpu"):
        runner = PORT.runner.BenchmarkRunner(
            synthetic_benchmark(PORT), sparse_encoder=ToySparse(),
            include_hybrid=False, output_dir=str(tmp_path), device="cpu",
            index_backend=backend)
        rows[backend] = {k: v for k, v in
                         runner.run()["neural_sparse"].items()
                         if "latency" not in k}
    assert isinstance(runner.searchers["neural_sparse"].index, ImpactIndex)
    assert rows["gpu"] == rows["exact"]
    with pytest.raises(ValueError, match="index_backend"):
        PORT.runner.BenchmarkRunner(synthetic_benchmark(PORT),
                                    index_backend="tpu", device="cpu")


# ------------------------------------------- the port's SparseEncoderV33
VOCAB = 512


class FakeTok:
    """Char-code tokenizer with the HF call signature, 512 ids, specials
    0 and 511."""

    pad_token_id = 0
    all_special_ids = [0, 511]

    def __len__(self):
        return VOCAB

    def get_vocab(self):
        return {}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [ord(c) % 97 + 3 for c in t][:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def sparse_encoders():
    import jax
    import jax.numpy as jnp
    import torch

    from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
    from splade_tpu.models.splade import SpladeEncoder as JaxSplade
    from splade_tpu_torch.models.hf_port import params_from_jax
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder

    torch.set_num_threads(1)
    jmodel = JaxSplade(JaxConfig.tiny(num_hidden_layers=2),
                       pool_impl="streamed", pool_tile=128)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jmodel.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))["params"])
    tmodel = SpladeEncoder(ModernBertConfig.tiny(num_hidden_layers=2),
                           pool_impl="kernel", device="cpu")
    tmodel.mlm.load_state_dict(params_from_jax(params))
    kw = dict(query_max_length=12, doc_max_length=16, batch_size=8,
              query_top_k=32, filter_special=False)
    return (JAX.encoders.SparseEncoderV33(jmodel, params, FakeTok(), **kw),
            PORT.encoders.SparseEncoderV33(tmodel, FakeTok(), device="cpu",
                                           **kw))


def test_runner_with_the_ports_encoder_matches_jax(sparse_encoders, tmp_path):
    """Both runners on their package's SparseEncoderV33 over the same f32
    weights: each query's ranking equal, scores within 1e-5 of the
    query's largest."""
    topics = [f"topic{t} kw{t}a kw{t}b" for t in range(4)]
    corpus = {f"d{t}{j}": topics[t] + f" doc {j}" for t in range(4)
              for j in range(3)}
    queries = {f"q{t}": topics[t] for t in range(4)}
    qrels = {f"q{t}": {f"d{t}0"} for t in range(4)}
    lists = {}
    for m, enc in zip((JAX, PORT), sparse_encoders):
        runner = m.runner.BenchmarkRunner(
            m.data.BenchmarkData("tiny", corpus, queries, qrels),
            sparse_encoder=enc, include_hybrid=False,
            output_dir=str(tmp_path / m.name), **runner_kw(m))
        runner.run()
        lists[m.name] = {q: runner.searchers["neural_sparse"]._search(q, 10)
                         for q in queries.values()}
        lists[m.name + " ids"] = {r.query_id: r.retrieved_ids
                                  for r in runner.results["neural_sparse"]}
    assert lists["splade_tpu_torch ids"] == lists["splade_tpu ids"]
    for q, want in lists["splade_tpu"].items():
        got = lists["splade_tpu_torch"][q]
        assert [d for d, _ in got] == [d for d, _ in want], q
        top = max(s for _, s in want)
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=0, atol=1e-5 * top)


def test_runner_needs_a_device_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.runner.BenchmarkRunner(synthetic_benchmark(PORT))
