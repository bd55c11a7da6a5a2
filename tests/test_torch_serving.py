"""The port's serving slice as a whole against splade_tpu's, on the CPU.

A tiny JAX SpladeEncoder and its port (same weights through
``params_from_jax``) build dense and two-phase postings engines on the same
40 documents with the same fake tokenizer. search_batch, encode, the
LSM-delta add and delete must agree, and the port's HTTP server must
answer. Scores agree within 1e-3 relative: both models run in f32 and
differ only in the order of f32 sums."""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu.serving.engine import build_engine_from_docs as jax_build
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.serving.engine import build_engine_from_docs
from splade_tpu_torch.serving.server import SearchService, create_server

VOCAB = 128
DOCS = [(f"doc{i}", f"문서 {i} 텍스트 {'가나다라마바사'[i % 7]}")
        for i in range(40)]
QUERIES = ["가나다 검색", "문서 7", "마바사", "텍스트 3 라"]
ENGINE_KW = dict(query_top_k=16, query_max_length=16)


class FakeTokenizer:
    pad_token_id = 0
    all_special_ids = [0, 1]

    def __len__(self):
        return VOCAB

    def get_vocab(self):
        return {"[PAD]": 0, "[CLS]": 1}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [ord(c) % (VOCAB - 4) + 3 for c in t if c != " "][:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_hidden_layers=4, vocab_size=VOCAB)
    jmodel = JaxSplade(jcfg, pool_impl="streamed")
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids,
                                  jnp.ones_like(ids))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params["params"])
    tmodel = SpladeEncoder(
        ModernBertConfig.tiny(num_hidden_layers=4, vocab_size=VOCAB),
        pool_impl="kernel", device="cpu")
    tmodel.mlm.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


def _engines(models, **kw):
    jmodel, params, tmodel = models
    j = jax_build(jmodel, params, FakeTokenizer(), DOCS, **ENGINE_KW, **kw)
    t = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS, device="cpu",
                               **ENGINE_KW, **kw)
    return j, t


def assert_same_results(j_out, t_out, rtol=1e-3):
    assert len(j_out) == len(t_out)
    for jr, tr in zip(j_out, t_out):
        assert len(jr) == len(tr)
        js = np.array([s for _, s in jr])
        ts = np.array([s for _, s in tr])
        np.testing.assert_allclose(ts, js, rtol=rtol, atol=1e-5)
        # ids where scores are separated; tied groups as sets
        tol = rtol * max(float(np.abs(js).max(initial=0)), 1e-6)
        start = 0
        while start < len(jr):
            end = start + 1
            while end < len(jr) and abs(js[end] - js[end - 1]) <= tol:
                end += 1
            if end < len(jr):
                assert ({d for d, _ in jr[start:end]}
                        == {d for d, _ in tr[start:end]})
            start = end


DENSE = dict(index_type="dense", int8=True)
POSTINGS = dict(index_type="postings", n_postings=8, rescore_candidates=20)


@pytest.mark.parametrize("kind", [DENSE, POSTINGS], ids=["dense", "postings"])
def test_engines_search_encode_and_crud_match_jax(models, kind):
    j, t = _engines(models, **kind)
    for k in (3, 10):
        assert_same_results(j.search_batch(QUERIES, k=k),
                            t.search_batch(QUERIES, k=k))
    for queries in (True, False):
        jv = j.encode(QUERIES, queries=queries)
        tv = t.encode(QUERIES, queries=queries)
        for (ji, jval), (ti, tval) in zip(jv, tv):
            order_j, order_t = np.argsort(ji), np.argsort(ti)
            np.testing.assert_array_equal(np.asarray(ti)[order_t],
                                          np.asarray(ji)[order_j])
            np.testing.assert_allclose(np.asarray(tval)[order_t],
                                       np.asarray(jval)[order_j],
                                       rtol=1e-3, atol=1e-5)
    # live add (postings: served from the LSM delta), then a delete
    for engine in (j, t):
        engine.add_documents([("fresh", QUERIES[0])])
    if kind is POSTINGS:
        assert t.index.delta_count == 1
    jr, tr = j.search_batch(QUERIES, k=5), t.search_batch(QUERIES, k=5)
    assert_same_results(jr, tr)
    assert tr[0][0][0] == "fresh"
    for engine in (j, t):
        assert engine.delete_documents(["fresh", "doc3"]) == 2
    assert_same_results(j.search_batch(QUERIES, k=10),
                        t.search_batch(QUERIES, k=10))
    assert all(d not in ("fresh", "doc3")
               for r in t.search_batch(QUERIES, k=10) for d, _ in r)


def test_warmup_and_unported_backends(models):
    _, _, tmodel = models
    _, t = _engines(models, **POSTINGS)
    assert t.warmup(max_batch_size=16) == 2 * len(t.k_tiers)
    for kind in ("tiered", "cluster"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_engine_from_docs(tmodel, FakeTokenizer(), DOCS,
                                   index_type=kind, device="cpu")


def test_index_cache_load_overrides_and_log(tmp_path):
    """--index-cache: the persisted shape wins over the CLI's shape flags,
    which the log names; --posting-scoring still applies at load time."""
    import argparse

    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.serving.server import _cache_overrides

    index = PostingsIndex(VOCAB, n_postings=8, query_top_t=16,
                          rescore_candidates=20, device="cpu")
    rng = np.random.default_rng(0)
    index.add_batch([f"d{i}" for i in range(30)],
                    [(rng.choice(VOCAB, 6, replace=False).astype(np.int32),
                      rng.uniform(0.1, 2, 6).astype(np.float32))
                     for _ in range(30)])
    path = tmp_path / "cache.npz"
    index.save(str(path))
    loaded = PostingsIndex.load(str(path), device="cpu", scoring="select")
    assert loaded.resolved_scoring() == "select"
    assert (loaded.n_postings, loaded.rescore_candidates) == (8, 20)
    args = argparse.Namespace(n_postings=64, rescore=20, query_top_k=16)
    assert _cache_overrides(args, loaded) == ["--n-postings 64 (cache: 8)"]
    args = argparse.Namespace(n_postings=None, rescore=0, query_top_k=16)
    assert _cache_overrides(args, loaded) == []


def _req(addr, method, path, payload=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    body = json.dumps(payload).encode() if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_http_server_answers_on_cpu(models):
    j, t = _engines(models, **POSTINGS)
    service = SearchService(t, max_batch_size=8, max_wait_ms=2.0)
    server = create_server(service)
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    try:
        assert _req(addr, "GET", "/healthz") == (200, {"status": "ok",
                                                       "docs": 40})
        code, out = _req(addr, "POST", "/search",
                         {"queries": QUERIES, "k": 5})
        assert code == 200
        want = j.search_batch(QUERIES, k=5)
        got = [[(r["doc_id"], r["score"]) for r in rs]
               for rs in out["results"]]
        assert_same_results(want, got)
        code, out = _req(addr, "POST", "/encode", {"texts": ["마바사"]})
        assert code == 200 and len(out["vectors"][0]) > 0
        code, out = _req(addr, "POST", "/index",
                         {"docs": [{"id": "new", "text": "가나다 검색"}]})
        assert (code, out) == (200, {"added": 1, "docs": 41})
        code, out = _req(addr, "POST", "/search",
                         {"query": "가나다 검색", "k": 3})
        assert out["results"][0][0]["doc_id"] == "new"
        assert _req(addr, "POST", "/delete", {"ids": ["new"]}) == (
            200, {"deleted": 1})
        assert _req(addr, "POST", "/search", {"k": 3})[0] == 400
        code, out = _req(addr, "GET", "/stats")
        assert code == 200 and out["items"] >= len(QUERIES)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
