"""The port's DF-tiered postings index (splade_tpu_torch.ops.tiered_postings)
against splade_tpu's, on the same numpy corpora and queries.

The non-mesh cases of tests/test_tiered_postings.py run through the port
(hot-term selection, the tier build, exactness when the combined depth
covers every list, the hot-term regime where the uniform index fails, the
scoring modes, save/load, the degenerate config, delta adds), and each is
held against the JAX package: ``select_hot_terms`` and ``build_tiered``
bitwise, ``tiered_score_topk`` / ``tiered_two_phase_topk`` and the
index's searches within the stated tolerance (ids equal where scores are
apart by more than it, as sets within ties), archives loadable across the
packages in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.ops import tiered_postings as J
from splade_tpu.ops.postings_index import TpuPostingsIndex
from splade_tpu_torch.benchmark.index import ExactSparseIndex
from splade_tpu_torch.ops import tiered_postings as P
from splade_tpu_torch.ops.postings_index import PostingsIndex
from test_torch_postings import assert_topk_equivalent

V = 500


def hot_corpus(n=400, seed=0, hot=(3, 5, 7), n_cold_terms=6):
    """tests/test_tiered_postings.py's corpus: every doc fires 2 hot terms
    (df == n) carrying most of the score, plus distinct cold terms."""
    rng = np.random.default_rng(seed)
    vecs = []
    for _ in range(n):
        h = rng.choice(hot, size=2, replace=False).astype(np.int32)
        hv = (np.abs(rng.normal(size=2)) + 0.5).astype(np.float32)
        c = rng.choice(np.arange(50, V), size=n_cold_terms,
                       replace=False).astype(np.int32)
        cv = (np.abs(rng.normal(size=n_cold_terms)) * 0.05
              + 0.01).astype(np.float32)
        vecs.append((np.concatenate([h, c]), np.concatenate([hv, cv])))
    return vecs


def mixed_queries(seed, B=8):
    rng = np.random.default_rng(seed)
    qi = np.stack([np.concatenate([
        rng.choice([3, 5, 7], size=1),
        rng.choice(np.arange(50, V), size=3, replace=False)])
        for _ in range(B)]).astype(np.int32)
    qv = (np.abs(rng.normal(size=(B, 4))) + 0.1).astype(np.float32)
    return qi, qv


def build_pair(corpus, p_cold, hot_terms, p_hot, **kw):
    exact = ExactSparseIndex(vocab_size=V)
    tiered = P.TieredPostingsIndex(V, n_postings=p_cold, hot_terms=hot_terms,
                                   hot_postings=p_hot, query_top_t=8,
                                   device="cpu", **kw)
    for i, (idx, val) in enumerate(corpus):
        exact.add(f"d{i}", idx, val)
        tiered.add(f"d{i}", idx, val)
    tiered.build()
    return exact, tiered


def jax_index(corpus, p_cold, hot_terms, p_hot, **kw):
    j = J.TieredPostingsIndex(V, n_postings=p_cold, hot_terms=hot_terms,
                              hot_postings=p_hot, query_top_t=8, **kw)
    j.add_batch([f"d{i}" for i in range(len(corpus))], corpus)
    j.build()
    return j


def same_results(j_out, t_out, tol):
    for jr, tr in zip(j_out, t_out):
        assert len(jr) == len(tr)
        assert_topk_equivalent(
            np.array([[s for _, s in tr]]),
            np.array([[hash(d) for d, _ in tr]]),
            np.array([[s for _, s in jr]]),
            np.array([[hash(d) for d, _ in jr]]), tol)


def test_select_hot_terms_by_df():
    df = np.array([0, 100, 3, 50, 7, 7])
    for fn in (P.select_hot_terms, J.select_hot_terms):
        assert fn(df, p_cold=5, hot_terms=2).tolist() == [1, 3]
        assert fn(df, p_cold=60, hot_terms=4).tolist() == [1]
        assert fn(df, p_cold=200, hot_terms=4).size == 0
    df = np.random.default_rng(3).integers(0, 50, 400)
    np.testing.assert_array_equal(P.select_hot_terms(df, 20, 16),
                                  J.select_hot_terms(df, 20, 16))


@pytest.mark.parametrize("p_cold,hot_terms,p_hot", [(8, 16, 128),
                                                    (8, 64, 512),
                                                    (512, 8, 64)])
def test_build_tiered_is_bitwise_the_references(p_cold, hot_terms, p_hot):
    corpus = hot_corpus(n=150)
    doc_idx = [c[0] for c in corpus]
    doc_val = [c[1] for c in corpus]
    got = P.build_tiered(doc_idx, doc_val, V, p_cold, hot_terms, p_hot)
    want = J.build_tiered(doc_idx, doc_val, V, p_cold, hot_terms, p_hot)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5]
    cold_docs, cold_w, hot_slot, hot_docs, hot_w, trunc = got
    H = hot_docs.shape[0]
    assert (hot_slot < H).sum() == H
    # continuation: the weakest cold impact of a hot term >= its strongest
    # hot one
    for t in np.flatnonzero(hot_slot < H):
        if hot_w[hot_slot[t]].max() > 0:
            assert cold_w[t].min() >= hot_w[hot_slot[t]].max() - 1e-5
    if H:
        from splade_tpu_torch.ops.postings_index import invert_to_postings
        _, _, trunc_uniform = invert_to_postings(doc_idx, doc_val, V, p_cold)
        assert 0 <= trunc < trunc_uniform


@pytest.mark.parametrize("scoring,C,tol", [
    ("sort", 0, 1e-5), ("scatter", 0, 3e-2), ("select_sum", 60, 1e-4),
    ("sort", 60, 1e-4), ("select", 60, 1e-4), ("scatter", 60, 1e-4)])
def test_search_functions_match_jax(scoring, C, tol):
    """tiered_score_topk (C = 0) and tiered_two_phase_topk against JAX's on
    one built index's arrays. Single-phase scatter sums bf16 products into
    f32, which jitted XLA fuses differently: bf16 resolution there; exact
    rescores to 1e-4."""
    corpus = hot_corpus(n=200)
    t = P.TieredPostingsIndex(V, n_postings=8, hot_terms=8, hot_postings=64,
                              query_top_t=8, rescore_candidates=max(C, 1),
                              device="cpu")
    t.add_batch([f"d{i}" for i in range(len(corpus))], corpus)
    t.build()
    qi, qv = mixed_queries(6)
    arrays = [a.numpy() for a in t._built]
    acc_t = torch.float32 if scoring == "scatter" and not C else None
    acc_j = jnp.float32 if scoring == "scatter" and not C else None
    if C:
        dm = [a.numpy() for a in t._doc_major]
        tv, ti = P.tiered_two_phase_topk(
            *(torch.from_numpy(a) for a in arrays + dm),
            torch.from_numpy(qi), torch.from_numpy(qv), 10, len(corpus), V,
            C, False, scoring=scoring)
        jv, ji = J.tiered_two_phase_topk(
            *(jnp.asarray(a) for a in arrays + dm), jnp.asarray(qi),
            jnp.asarray(qv), 10, len(corpus), V, C, False,
            scoring=scoring, rescore="gather")
    else:
        tv, ti = P.tiered_score_topk(
            *(torch.from_numpy(a) for a in arrays), torch.from_numpy(qi),
            torch.from_numpy(qv), 10, len(corpus), False, acc_dtype=acc_t,
            scoring=scoring)
        jv, ji = jax.jit(J.tiered_score_topk, static_argnums=(9, 10, 11),
                         static_argnames=("acc_dtype", "scoring"))(
            *(jnp.asarray(a) for a in arrays), jnp.asarray(qi),
            jnp.asarray(qv), 10, len(corpus), False, acc_dtype=acc_j,
            scoring=scoring)
    assert_topk_equivalent(tv.numpy(), ti.numpy(), np.asarray(jv),
                           np.asarray(ji), tol)


def test_exact_when_combined_depth_covers():
    """p_cold + p_hot >= max df: two-phase tiered equals the exact oracle,
    and the JAX index's results."""
    corpus = hot_corpus(n=300)
    kw = dict(rescore_candidates=64, approx=False, scoring="sort")
    exact, tiered = build_pair(corpus, p_cold=8, hot_terms=64, p_hot=512,
                               **kw)
    assert tiered.truncated_postings == 0
    qi, qv = mixed_queries(2)
    got = tiered.search_topk(qi, qv, k=5)
    for b in range(8):
        want = exact.search_vector(qi[b], qv[b], k=5)
        assert [d for d, _ in got[b]] == [d for d, _ in want]
        for (_, gs), (_, ws) in zip(got[b], want):
            assert gs == pytest.approx(ws, rel=0.05, abs=0.05)
    j = jax_index(corpus, 8, 64, 512, **kw)
    assert (j.n_hot, j.truncated_postings) == (tiered.n_hot, 0)
    same_results(j.search_topk(qi, qv, k=5), got, 1e-4)


def test_tiered_recovers_hot_regime_where_uniform_fails():
    """Equal cold depth, hot-term queries: uniform recall collapses, the
    tiered index recovers it."""
    corpus = hot_corpus(n=400)
    exact, tiered = build_pair(corpus, p_cold=8, hot_terms=8, p_hot=512,
                               rescore_candidates=64, approx=False,
                               scoring="sort")
    uniform = PostingsIndex(V, n_postings=8, query_top_t=8,
                            rescore_candidates=64, approx=False,
                            scoring="sort", device="cpu")
    uniform.add_batch([f"d{i}" for i in range(len(corpus))], corpus)
    uniform.build()
    rng = np.random.default_rng(3)
    qi = np.stack([rng.choice([3, 5, 7], size=2, replace=False)
                   for _ in range(16)]).astype(np.int32)
    qv = (np.abs(rng.normal(size=(16, 2))) + 0.5).astype(np.float32)

    def recall(index):
        got = index.search_topk(qi, qv, k=10)
        hits = sum(len({d for d, _ in exact.search_vector(qi[b], qv[b], k=10)}
                       & {d for d, _ in got[b]}) for b in range(len(qi)))
        return hits / (len(qi) * 10)

    assert recall(tiered) == pytest.approx(1.0, abs=1e-6)
    assert recall(uniform) < 0.8


def test_scoring_modes_agree_and_match_jax():
    corpus = hot_corpus(n=200)
    qi, qv = mixed_queries(4)
    results = {}
    for scoring in ("sort", "select", "scatter"):
        kw = dict(rescore_candidates=200, approx=False, scoring=scoring)
        _, tiered = build_pair(corpus, p_cold=8, hot_terms=8, p_hot=256, **kw)
        assert tiered.resolved_scoring() == scoring
        results[scoring] = tiered.search_topk(qi, qv, k=5)
        same_results(jax_index(corpus, 8, 8, 256, **kw).search_topk(
            qi, qv, k=5), results[scoring], 1e-4)
    for b in range(8):
        ids_sort = [d for d, _ in results["sort"][b]]
        assert ids_sort == [d for d, _ in results["select"][b]]
        assert ids_sort == [d for d, _ in results["scatter"][b]]


def test_resolved_scoring_on_the_tiered_pool():
    t = P.TieredPostingsIndex(V, n_postings=16, hot_postings=48,
                              query_top_t=64, device="cpu")
    assert t.resolved_scoring() == "sort"       # 64 * 64 = 4096
    t = P.TieredPostingsIndex(V, n_postings=16, hot_postings=49,
                              query_top_t=64, device="cpu")
    assert t.resolved_scoring() == "scatter"
    assert P.TieredPostingsIndex(V, device="cpu").resolved_scoring() == \
        "scatter"  # the defaults: 32 * (256 + 8192)


def test_save_load_roundtrip_and_across_packages(tmp_path):
    corpus = hot_corpus(n=100)
    kw = dict(rescore_candidates=32, approx=False, scoring="sort")
    _, tiered = build_pair(corpus, p_cold=8, hot_terms=8, p_hot=256, **kw)
    path = str(tmp_path / "tiered.npz")
    tiered.save(path)
    loaded = P.TieredPostingsIndex.load(path, device="cpu")
    assert loaded.hot_terms == 8 and loaded.hot_postings == 256
    assert loaded.n_hot == tiered.n_hot
    qi, qv = (np.array([[3, 60, 70, 80]], np.int32),
              np.array([[1.0, 0.2, 0.2, 0.2]], np.float32))
    assert tiered.search_topk(qi, qv, k=5) == loaded.search_topk(qi, qv, k=5)
    with pytest.raises(ValueError, match="tiered"):
        PostingsIndex.load(path, device="cpu")
    # the port's archive in the JAX class, and the JAX class's in the port
    j = J.TieredPostingsIndex.load(path)
    assert (j.n_postings, j.hot_terms, j.hot_postings, j.rescore_candidates,
            j.n_hot, j.doc_ids) == (8, 8, 256, 32, tiered.n_hot,
                                    tiered.doc_ids)
    same_results(j.search_topk(qi, qv, k=5), tiered.search_topk(qi, qv, k=5),
                 1e-4)
    with pytest.raises(ValueError, match="tiered"):
        TpuPostingsIndex.load(path)
    j.delete(["d4"])
    j.save(str(tmp_path / "jax.npz"))
    back = P.TieredPostingsIndex.load(str(tmp_path / "jax.npz"),
                                      device="cpu")
    assert back.doc_ids == j.doc_ids and "d4" not in back.doc_ids
    assert back.config_summary() == j.config_summary()
    same_results(j.search_topk(qi, qv, k=5), back.search_topk(qi, qv, k=5),
                 1e-4)


def test_no_hot_terms_degenerates_to_uniform():
    corpus = hot_corpus(n=100)
    _, tiered = build_pair(corpus, p_cold=512, hot_terms=8, p_hot=64,
                           approx=False, scoring="sort")
    assert tiered.n_hot == 0
    uniform = PostingsIndex(V, n_postings=512, query_top_t=8, approx=False,
                            scoring="sort", device="cpu")
    uniform.add_batch([f"d{i}" for i in range(len(corpus))], corpus)
    uniform.build()
    qi, qv = (np.array([[3, 60, 70, 80]], np.int32),
              np.array([[1.0, 0.2, 0.2, 0.2]], np.float32))
    assert tiered.search_topk(qi, qv, k=5) == uniform.search_topk(qi, qv, k=5)


def test_delta_adds_after_build():
    corpus = hot_corpus(n=100)
    _, tiered = build_pair(corpus, p_cold=8, hot_terms=8, p_hot=256,
                           rescore_candidates=32, approx=False,
                           scoring="sort")
    built = tiered._built
    tiered.add("new_doc", np.array([3, 5], np.int32),
               np.array([50.0, 50.0], np.float32))
    got = tiered.search_topk(np.array([[3, 5]], np.int32),
                             np.array([[1.0, 1.0]], np.float32), k=3)[0]
    assert got[0][0] == "new_doc" and tiered._built is built
