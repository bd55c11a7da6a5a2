"""The port's serving engine and server over the DF-tiered and the
cluster-union indexes, against splade_tpu's, on the CPU.

The tiered and cluster engine cases of tests/test_serving.py (select
scoring threaded into postings and tiered, each backend against the dense
engine, the cluster knobs threaded with per-backend defaults, the fused
cluster path run in the index's phase-1b mode) plus the port's engines
against the JAX engines built from the same weights and documents: search,
the LSM delta, deletes and compaction through the engine, within 1e-3
relative (both models run in f32; ids equal where scores are apart by
more). The server CLI with --device cpu: --index tiered and cluster, their
shape flags, --index-cache written, then served by the class of the kind
the archive records with the cold run's results, a conflicting --index
refused, --posting-scoring honoured by the cluster backend at build and
at load. And the HTTP server over a cluster engine."""

import json
import threading

import numpy as np
import pytest
import torch

from splade_tpu_torch.ops.cluster_index import ClusterIndex
from splade_tpu_torch.ops.tiered_postings import TieredPostingsIndex
from splade_tpu_torch.serving import engine as engine_mod
from splade_tpu_torch.serving import server as server_mod
from splade_tpu_torch.serving.engine import (ServingEngine,
                                             build_engine_from_docs)
from test_torch_serving import (DOCS, ENGINE_KW, QUERIES, VOCAB,
                                FakeTokenizer, _engines, _req,
                                assert_same_results, models)  # noqa: F401

TIERED = dict(index_type="tiered", n_postings=4, hot_terms=VOCAB,
              hot_postings=64, rescore_candidates=40,
              posting_scoring="sort")
CLUSTER = dict(index_type="cluster", cluster_size=8, n_probes=8,
               n_postings=8, rescore_candidates=16)


@pytest.mark.parametrize("kind", [TIERED, CLUSTER], ids=["tiered", "cluster"])
def test_engines_search_and_crud_match_jax(models, kind):
    j, t = _engines(models, **kind)
    cls = TieredPostingsIndex if kind is TIERED else ClusterIndex
    assert isinstance(t.index, cls) and t._postings_two_phase
    assert t.index.config_summary().startswith(
        j.index.config_summary().split(" posting_scoring")[0])
    for k in (3, 10):
        assert_same_results(j.search_batch(QUERIES, k=k),
                            t.search_batch(QUERIES, k=k))
    # live add served from the LSM delta, then deletes, then compaction
    for engine in (j, t):
        engine.add_documents([("fresh", QUERIES[0])])
    assert t.index.delta_count == j.index.delta_count == 1
    jr, tr = j.search_batch(QUERIES, k=5), t.search_batch(QUERIES, k=5)
    assert_same_results(jr, tr)
    assert tr[0][0][0] == "fresh"
    for engine in (j, t):
        assert engine.delete_documents(["fresh", "doc3"]) == 2
    assert_same_results(j.search_batch(QUERIES, k=10),
                        t.search_batch(QUERIES, k=10))
    assert all(d not in ("fresh", "doc3")
               for r in t.search_batch(QUERIES, k=10) for d, _ in r)
    for engine in (j, t):
        engine.index.compact()
    assert t.index.delta_count == 0 and len(t.index) == 39
    assert_same_results(j.search_batch(QUERIES, k=10),
                        t.search_batch(QUERIES, k=10))


def test_select_scoring_threaded_into_postings_and_tiered(models):
    _, _, tmodel = models
    for index_type in ("postings", "tiered"):
        eng = build_engine_from_docs(
            tmodel, FakeTokenizer(), DOCS, int8=False, device="cpu",
            index_type=index_type, n_postings=64, rescore_candidates=64,
            posting_scoring="select", **ENGINE_KW)
        assert eng.index.scoring == "select", index_type
        hits = eng.search_batch(["문서 7"], k=3)[0]
        assert hits and all(isinstance(d, str) for d, _ in hits)
    with pytest.raises(ValueError, match="rescore"):
        build_engine_from_docs(
            tmodel, FakeTokenizer(), DOCS, int8=False, device="cpu",
            index_type="tiered", n_postings=64, rescore_candidates=0,
            posting_scoring="select", **ENGINE_KW)


@pytest.mark.parametrize("kind", [TIERED, CLUSTER], ids=["tiered", "cluster"])
def test_backend_matches_the_dense_engine(models, kind):
    """tests/test_serving.py's tiered and cluster engines against the
    dense engine on the same corpus: the same top documents, scores within
    5e-2 (the dense index is int8-free here, the others rescore the int8
    doc-major block)."""
    _, _, tmodel = models
    dense = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS, int8=False,
                                   device="cpu", **ENGINE_KW)
    other = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS,
                                   device="cpu", **kind, **ENGINE_KW)
    if kind is TIERED:
        assert other.index.truncated_postings == 0  # 4 + 64 covers 40 docs
    for d, p in zip(dense.search_batch(QUERIES[:2], k=5),
                    other.search_batch(QUERIES[:2], k=5)):
        assert [x for x, _ in d] == [x for x, _ in p]
        np.testing.assert_allclose([s for _, s in d], [s for _, s in p],
                                   rtol=5e-2)
    # membership at full k through the engine's CRUD
    other.add_documents([("newdoc", "가나다 가나다 가나다")])
    assert other.index.delta_count == 1
    assert "newdoc" in [x for x, _ in other.search_batch(["가나다 검색"],
                                                         k=41)[0]]
    other.delete_documents(["newdoc"])
    assert "newdoc" not in [x for x, _ in other.search_batch(["가나다 검색"],
                                                             k=41)[0]]


def test_build_engine_cluster_and_tiered_knobs_threaded(models):
    _, _, tmodel = models
    docs = DOCS[:20]
    kw = dict(int8=False, device="cpu", **ENGINE_KW)
    e = build_engine_from_docs(tmodel, FakeTokenizer(), docs,
                               index_type="cluster", n_postings=16,
                               rescore_candidates=48, cluster_size=8,
                               n_probes=4, posting_scoring="scatter", **kw)
    ix = e.index
    assert (ix.posting_cap, ix.posting_candidates, ix.cluster_size,
            ix.n_probes, ix.posting_scoring) == (16, 48, 8, 4, "scatter")
    e2 = build_engine_from_docs(tmodel, FakeTokenizer(), docs,
                                index_type="cluster", **kw)
    assert (e2.index.posting_cap, e2.index.posting_candidates) == (64, 128)
    e3 = build_engine_from_docs(tmodel, FakeTokenizer(), docs,
                                index_type="tiered", hot_terms=5,
                                hot_postings=32, **kw)
    assert (e3.index.n_postings, e3.index.hot_terms,
            e3.index.hot_postings, e3.index.rescore_candidates) == (
        256, 5, 32, 0)
    e4 = build_engine_from_docs(tmodel, FakeTokenizer(), docs,
                                index_type="postings", **kw)
    assert e4.index.n_postings == 2048
    # a mesh reaches the dense index only, as in the reference
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.parallel import make_mesh

    e5 = build_engine_from_docs(tmodel, FakeTokenizer(), docs,
                                mesh=make_mesh(devices=["cpu"] * 2),
                                index_type="postings", **kw)
    assert type(e5.index) is PostingsIndex and e5.index.n_postings == 2048


def test_fused_cluster_path_uses_index_scoring_mode(models, monkeypatch):
    _, _, tmodel = models
    eng = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS[:30],
                                 device="cpu", index_type="cluster",
                                 cluster_size=8, n_probes=4, n_postings=8,
                                 rescore_candidates=16,
                                 posting_scoring="scatter", **ENGINE_KW)
    seen = []
    orig = engine_mod.cluster_search_topk

    def spy(*args, **kw):
        seen.append(kw.get("posting_scoring", "sort"))
        return orig(*args, **kw)

    monkeypatch.setattr(engine_mod, "cluster_search_topk", spy)
    eng._build_postings_fused()
    got = eng.search_batch(["가나다 문서"], k=5)
    assert got and got[0]
    assert seen and all(m == "scatter" for m in seen), seen


# ------------------------------------------------------------- server CLI
class Tok(FakeTokenizer):
    def save_pretrained(self, d):
        pass


@pytest.fixture(scope="module")
def export_dir(models, tmp_path_factory):
    """The tiny port model's final_model exported as an HF dir."""
    from splade_tpu_torch.export import export_checkpoint_to_hf
    from splade_tpu_torch.train.checkpoint import save_final_model

    _, _, tmodel = models
    root = tmp_path_factory.mktemp("served")
    final = save_final_model(str(root / "run"), tmodel.mlm, prefix="mlm.")
    return export_checkpoint_to_hf(final, str(root / "hf"),
                                   num_attention_heads=4, tokenizer=Tok())


@pytest.fixture()
def cli(monkeypatch, tmp_path, export_dir):
    """server.main with the fake tokenizer and no HTTP loop: -> run(args)
    -> the engine main built."""
    from splade_tpu_torch.utils import tokenizer as tokmod

    monkeypatch.setattr(tokmod, "create_tokenizer", lambda *a, **k: Tok())
    built = []

    class Service:
        def __init__(self, engine, **kw):
            built.append(engine)

        def close(self):
            pass

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(server_mod, "SearchService", Service)
    monkeypatch.setattr(server_mod, "create_server", lambda *a, **k: Server())
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"id": d, "text": t})
                              for d, t in DOCS))

    def run(*args):
        assert server_mod.main(["--checkpoint", export_dir, "--device", "cpu",
                                "--docs", str(docs), "--query-top-k", "16",
                                *args]) == 0
        return built[-1]

    return run


def test_server_cli_tiered_cache_roundtrip(cli, tmp_path, caplog):
    cache = str(tmp_path / "tiered.npz")
    cold = cli("--index", "tiered", "--n-postings", "8", "--hot-terms", "6",
               "--hot-postings", "32", "--rescore", "20", "--index-cache",
               cache)
    assert isinstance(cold.index, TieredPostingsIndex)
    assert (cold.index.n_postings, cold.index.hot_terms,
            cold.index.hot_postings, cold.index.rescore_candidates) == (
        8, 6, 32, 20)
    want = cold.search_batch(QUERIES, k=5)
    with caplog.at_level("INFO"):
        warm = cli("--index-cache", cache, "--hot-terms", "99")
    assert type(warm.index) is TieredPostingsIndex
    assert "loading persisted tiered index" in caplog.text
    assert "--hot-terms 99 (cache: 6)" in caplog.text
    assert warm.search_batch(QUERIES, k=5) == want
    with pytest.raises(SystemExit):
        cli("--index", "cluster", "--index-cache", cache)


def test_server_cli_cluster_honours_posting_scoring(cli, tmp_path, caplog):
    cache = str(tmp_path / "cluster.npz")
    cold = cli("--index", "cluster", "--cluster-size", "8", "--probes", "5",
               "--n-postings", "8", "--rescore", "24", "--posting-scoring",
               "scatter", "--index-cache", cache)
    ix = cold.index
    assert isinstance(ix, ClusterIndex)
    assert (ix.cluster_size, ix.n_probes, ix.posting_cap,
            ix.posting_candidates, ix.posting_scoring) == (8, 5, 8, 24,
                                                           "scatter")
    want = cold.search_batch(QUERIES, k=5)
    warm = cli("--index-cache", cache)  # the persisted mode
    assert type(warm.index) is ClusterIndex
    assert warm.index.posting_scoring == "scatter"
    assert warm.search_batch(QUERIES, k=5) == want
    with caplog.at_level("WARNING"):
        sort = cli("--index", "cluster", "--index-cache", cache,
                   "--posting-scoring", "sort")  # a load-time override
    assert sort.index.posting_scoring == "sort"
    assert "persisted index config wins" in caplog.text
    assert_same_results(sort.search_batch(QUERIES, k=5), want)
    for args in (("--index", "cluster", "--posting-scoring", "select"),
                 ("--index-cache", cache, "--posting-scoring", "select"),
                 ("--index", "postings", "--index-cache", cache)):
        with pytest.raises(SystemExit):
            cli(*args)


def test_server_cli_kind_dispatch_of_every_archive(cli, tmp_path):
    """Each kind the server writes is read back by its own class; an
    archive without the kind field is taken as postings."""
    for kind in ("postings", "tiered", "cluster"):
        cache = str(tmp_path / f"{kind}.npz")
        cli("--index", kind, "--rescore", "20", "--index-cache", cache)
        assert server_mod.sniff_cache_kind(cache) == kind
        assert type(cli("--index-cache", cache).index) is \
            server_mod.index_class(kind)
    z = dict(np.load(str(tmp_path / "postings.npz")))
    del z["kind"]
    np.savez(str(tmp_path / "old.npz"), **z)
    assert server_mod.sniff_cache_kind(str(tmp_path / "old.npz")) == \
        "postings"


def test_http_server_over_a_cluster_engine(models):
    j, t = _engines(models, **CLUSTER)
    service = server_mod.SearchService(t, max_batch_size=8, max_wait_ms=2.0)
    server = server_mod.create_server(service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    try:
        code, out = _req(addr, "POST", "/search", {"queries": QUERIES,
                                                   "k": 5})
        assert code == 200
        assert_same_results(j.search_batch(QUERIES, k=5),
                            [[(r["doc_id"], r["score"]) for r in rs]
                             for rs in out["results"]])
        assert _req(addr, "POST", "/index", {"docs": [
            {"id": "new", "text": "가나다 검색"}]}) == (
            200, {"added": 1, "docs": 41})
        code, out = _req(addr, "POST", "/search",
                         {"query": "가나다 검색", "k": 3})
        assert out["results"][0][0]["doc_id"] == "new"
        assert _req(addr, "POST", "/delete", {"ids": ["new"]}) == (
            200, {"deleted": 1})
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
