"""The port's serving engine over the doc-sharded indexes, against
splade_tpu's, on the CPU.

The mesh cases of tests/test_serving.py (:464 the mesh postings engine
against the single-device one, :805 the mesh engine under concurrent
searches and mutations, :1010 the mesh cluster engine serving and
mutating) plus the port's mesh engines against the JAX mesh engines: a tiny
JAX SpladeEncoder and its port (same weights through ``params_from_jax``),
the same document vectors (the JAX encoder's) in both packages' indexes,
JAX on its 8 virtual CPU devices and the port on ``make_mesh(devices=
["cpu"] * 8)``. Scores within 1e-3 relative (both models run in f32 and
differ only in the order of f32 sums); ids equal where scores are further
apart. The dense engine of ``build_engine_from_docs(mesh=...)`` is held
against JAX's and the single-device port's."""

import threading

import pytest

from splade_tpu.benchmark.encoders import SparseEncoderV33 as JaxEncoder
from splade_tpu.ops import cluster_index as JC
from splade_tpu.ops import postings_index as JP
from splade_tpu.ops import tiered_postings as JT
from splade_tpu.parallel.mesh import make_mesh as jax_mesh
from splade_tpu.serving.engine import ServingEngine as JaxEngine
from splade_tpu.serving.engine import build_engine_from_docs as jax_build
from splade_tpu_torch.ops import cluster_index as TC
from splade_tpu_torch.ops import impact_index as TI
from splade_tpu_torch.ops import postings_index as TP
from splade_tpu_torch.ops import tiered_postings as TT
from splade_tpu_torch.parallel import make_mesh
from splade_tpu_torch.serving import engine as engine_mod
from splade_tpu_torch.serving.engine import (ServingEngine,
                                             build_engine_from_docs)
from test_torch_serving import (DOCS, ENGINE_KW, QUERIES, VOCAB,
                                FakeTokenizer, assert_same_results,
                                models)  # noqa: F401

CPU8 = ["cpu"] * 8
#: kind -> (JAX class, port class, config): the configurations of
#: tests/test_serving.py's mesh cases
MESH_KINDS = {
    "postings": (JP.MeshShardedPostingsIndex, TP.MeshShardedPostingsIndex,
                 dict(n_postings=64, query_top_t=16, approx=False,
                      rescore_candidates=32)),
    "tiered": (JT.MeshShardedTieredPostingsIndex,
               TT.MeshShardedTieredPostingsIndex,
               dict(n_postings=4, hot_terms=16, hot_postings=32,
                    query_top_t=16, approx=False, rescore_candidates=32,
                    scoring="sort")),
    "cluster": (JC.MeshShardedClusterIndex, TC.MeshShardedClusterIndex,
                dict(cluster_size=8, n_probes=8, query_top_t=16,
                     posting_cap=8, posting_candidates=16)),
}


@pytest.fixture(scope="module")
def doc_vecs(models):
    jmodel, params, _ = models
    enc = JaxEncoder(jmodel, params, FakeTokenizer())
    return enc.encode_documents([t for _, t in DOCS])


def _mesh_engines(models, doc_vecs, kind, docs=DOCS):
    jmodel, params, tmodel = models
    jcls, tcls, kw = MESH_KINDS[kind]
    j_index = jcls(VOCAB, jax_mesh(), **kw)
    t_index = tcls(VOCAB, make_mesh(devices=CPU8), **kw)
    for index in (j_index, t_index):
        index.add_batch([d for d, _ in docs], doc_vecs[:len(docs)])
        index.build()
    j = JaxEngine(jmodel, params, FakeTokenizer(), j_index, **ENGINE_KW)
    t = ServingEngine(tmodel, FakeTokenizer(), t_index, **ENGINE_KW)
    return j, t


@pytest.mark.parametrize("kind", list(MESH_KINDS))
def test_mesh_engines_search_and_crud_match_jax(models, doc_vecs, kind):
    """Search at k = 3 and 10, a live add served from the host delta (the
    query vectors the fused route returned scoring it), deletes, then
    compaction re-sharding: the port's mesh engine answers as JAX's
    (tests/test_serving.py:1010 for the cluster kind)."""
    j, t = _mesh_engines(models, doc_vecs, kind)
    assert t._postings and t._postings_two_phase and t._mesh_route
    assert t.device == t.index.mesh.devices[0]
    assert t._postings_C == j._postings_C == t.index.max_results()
    for k in (3, 10):
        assert_same_results(j.search_batch(QUERIES, k=k),
                            t.search_batch(QUERIES, k=k))
    built = t.index._built
    for engine in (j, t):
        engine.add_documents([("fresh", QUERIES[0])])
    assert t.index.delta_count == j.index.delta_count == 1
    assert t.index._built is built  # served from the delta, no rebuild
    jr, tr = j.search_batch(QUERIES, k=5), t.search_batch(QUERIES, k=5)
    assert_same_results(jr, tr)
    assert tr[0][0][0] == "fresh"
    for engine in (j, t):
        assert engine.delete_documents(["fresh", "doc3"]) == 2
    assert_same_results(j.search_batch(QUERIES, k=10),
                        t.search_batch(QUERIES, k=10))
    assert all(d not in ("fresh", "doc3")
               for r in t.search_batch(QUERIES, k=41) for d, _ in r)
    for engine in (j, t):
        engine.index.compact()
    assert t.index.delta_count == 0 and len(t.index) == 39
    assert_same_results(j.search_batch(QUERIES, k=10),
                        t.search_batch(QUERIES, k=10))


def test_mesh_postings_engine_matches_single_device(models, doc_vecs):
    """tests/test_serving.py:464: the two-phase mesh postings engine
    returns the single-device two-phase engine's documents (every shard
    rescores all of its 5 documents, so both are exact), within 1e-4."""
    _, _, tmodel = models
    kw = MESH_KINDS["postings"][2]
    single = TP.PostingsIndex(VOCAB, device="cpu", **kw)
    meshed = TP.MeshShardedPostingsIndex(VOCAB, make_mesh(devices=CPU8), **kw)
    for index in (single, meshed):
        index.add_batch([d for d, _ in DOCS], doc_vecs)
        index.build()
    e1 = ServingEngine(tmodel, FakeTokenizer(), single, device="cpu",
                       **ENGINE_KW)
    e2 = ServingEngine(tmodel, FakeTokenizer(), meshed, **ENGINE_KW)
    for k in (5, 30):
        assert_same_results(e1.search_batch(QUERIES, k=k),
                            e2.search_batch(QUERIES, k=k), rtol=1e-4)
    # the mesh pool holds D x min(C, per) = 40 exact scores, one device's 32
    assert (e1._postings_C, e2._postings_C) == (32, 40)
    assert len(e2.search_batch(QUERIES[:1], k=40)[0]) == 40


def test_mesh_serving_under_concurrent_load(models, doc_vecs):
    """tests/test_serving.py:805: four searcher threads on a mesh postings
    engine while a mutator adds and deletes documents: every result
    resolves to a live document, new documents become searchable, deleted
    ones vanish."""
    _, _, tmodel = models
    enc = engine_mod.SparseEncoderV33(tmodel, FakeTokenizer(), device="cpu")
    docs = [(f"doc{i}", f"문서 {i} 가나다 {'가나다라마바사'[i % 7]}")
            for i in range(64)]
    index = TP.MeshShardedPostingsIndex(VOCAB, make_mesh(devices=CPU8),
                                        **MESH_KINDS["postings"][2])
    index.add_batch([d for d, _ in docs],
                    enc.encode_documents([t for _, t in docs]))
    index.build()
    e = ServingEngine(tmodel, FakeTokenizer(), index, **ENGINE_KW)
    errors, counts = [], [0] * 4
    live = {d for d, _ in docs}
    lock = threading.Lock()

    def searcher(tid):
        try:
            for i in range(12):
                rows = e.search_batch([f"문서 {i % 9} 가나다", "가나다 검색"],
                                      k=5)
                for row in rows:
                    assert row, "mesh search returned nothing under load"
                    for d, s in row:
                        with lock:
                            assert d in live, f"unresolvable id {d}"
                        assert s > 0
                counts[tid] += len(rows)
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    def mutator():
        try:
            for i in range(6):
                doc = (f"new{i}", f"가나다 새 문서 {i}")
                with lock:
                    live.add(doc[0])
                e.add_documents([doc])
                if i % 2:
                    e.delete_documents([f"doc{i}"])
                    # a search already under way may still hold it; a
                    # deleted id is not resolvable afterwards only
        except Exception as exc:  # noqa: BLE001
            errors.append(repr(exc))

    threads = [threading.Thread(target=searcher, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=mutator))
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert all(c == 24 for c in counts)
    assert index.delta_count == 6 and index.deleted_count == 3
    hits = [d for d, _ in e.search("가나다 새 문서 5", k=10)]
    assert "new5" in hits
    gone = [d for r in e.search_batch(["문서 1 가나다", "문서 3 가나다"], k=64)
            for d, _ in r]
    assert "doc1" not in gone and "doc3" not in gone


def test_dense_engine_on_a_mesh_matches_jax_and_one_device(models):
    """``build_engine_from_docs(mesh=...)`` hands the mesh to the dense
    index only, as the reference does: its rows shard over the 8 devices,
    the engine lives on ``mesh.devices[0]``, and it answers as JAX's mesh
    engine and as the single-device port engine (the exact top-k)."""
    jmodel, params, tmodel = models
    mesh = make_mesh(devices=CPU8)
    t = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS, int8=True,
                               mesh=mesh, **ENGINE_KW)
    one = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS, int8=True,
                                 device="cpu", **ENGINE_KW)
    j = jax_build(jmodel, params, FakeTokenizer(), DOCS, int8=True,
                  mesh=jax_mesh(), **ENGINE_KW)
    assert isinstance(t.index, TI.ImpactIndex) and t.index.mesh is mesh
    assert len(t.index._mat) == 8 and t.device == mesh.devices[0]
    for k in (3, 10, 40):
        got = t.search_batch(QUERIES, k=k)
        assert_same_results(j.search_batch(QUERIES, k=k), got)
        assert_same_results(one.search_batch(QUERIES, k=k), got, rtol=1e-6)
    # the mesh reaches the dense index only
    post = build_engine_from_docs(tmodel, FakeTokenizer(), DOCS, mesh=mesh,
                                  index_type="postings", n_postings=8,
                                  rescore_candidates=20, **ENGINE_KW)
    assert type(post.index) is TP.PostingsIndex and not post._mesh_route
