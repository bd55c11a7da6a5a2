"""The port's cluster-summary index (splade_tpu_torch.ops.cluster_index)
against splade_tpu's, on the same numpy corpora and queries.

The non-mesh cases of tests/test_cluster_index.py run through the port
(clustering, the summary's upper bound, recall and exact scores, the
hot-term regime, the posting-scoring modes, set_probes, padded cluster
slots, CRUD, save/load) and the cluster cases of
tests/test_postings_crud_fuzz.py (3 seeds, against a brute force). Held
against the JAX package: ``project_docs``, ``assign_clusters`` and
``build_cluster_arrays`` bitwise; the summary product's f32 scores within
1e-6 of a query's top score, and its top-L clusters equal where the L-th
and the next are further apart; ``cluster_search_topk`` and the index's
searches within 1e-4, ids equal where scores are further apart, with every
cluster probed and with part of them; archives loadable across the
packages in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.ops import cluster_index as J
from splade_tpu_torch.ops import cluster_index as P
from splade_tpu_torch.ops.postings_index import PostingsIndex
from test_torch_postings import assert_topk_equivalent

VOCAB = 512


def hot_concentrated_corpus(n_docs=3000, nnz=16, n_hot=6, seed=0):
    """tests/test_cluster_index.py's corpus: most of each doc's mass on a
    tiny shared hot-term pool, plus a random discriminative tail."""
    rng = np.random.default_rng(seed)
    idx = np.empty((n_docs, nnz), np.int32)
    val = np.empty((n_docs, nnz), np.float32)
    for i in range(n_docs):
        hot = rng.choice(n_hot, size=4, replace=False)
        tail = rng.choice(VOCAB - n_hot, size=nnz - 4, replace=False) + n_hot
        idx[i] = np.concatenate([hot, tail])
        val[i] = np.concatenate([rng.uniform(2.0, 6.0, 4),
                                 rng.uniform(0.1, 1.5, nnz - 4)]).astype(
                                     np.float32)
    return idx, val


def exact_topk(d_idx, d_val, q_idx, q_val, k):
    n = len(d_idx)
    dense = np.zeros((n, VOCAB), np.float32)
    dense[np.repeat(np.arange(n), d_idx.shape[1]), d_idx.reshape(-1)] = \
        d_val.reshape(-1)
    out = []
    for qi, qv in zip(q_idx, q_val):
        q = np.zeros(VOCAB, np.float32)
        q[qi] = qv
        s = dense @ q
        out.append((np.argsort(-s)[:k], s))
    return out


def queries(n=32, t=8, n_hot=6, seed=1, d_idx=None, d_val=None):
    """Doc-anchored queries (2 hot and t-2 tail terms of a target doc), or
    independent random ones without a corpus."""
    rng = np.random.default_rng(seed)
    qi = np.empty((n, t), np.int32)
    qv = np.empty((n, t), np.float32)
    for i in range(n):
        if d_idx is not None:
            target = rng.integers(len(d_idx))
            ti = d_idx[target]
            hot_m = ti < n_hot
            hot = rng.permutation(ti[hot_m])[:2]
            tail = rng.permutation(ti[~hot_m])[:t - 2]
        else:
            hot = rng.choice(n_hot, size=2, replace=False)
            tail = rng.choice(VOCAB - n_hot, size=t - 2, replace=False) + n_hot
        qi[i] = np.concatenate([hot, tail])
        qv[i] = np.concatenate([rng.uniform(1.0, 3.0, 2),
                                rng.uniform(0.5, 1.5, t - 2)]).astype(
                                    np.float32)
    return qi, qv


def same_results(j_out, t_out, tol=1e-4):
    for jr, tr in zip(j_out, t_out):
        assert len(jr) == len(tr)
        assert_topk_equivalent(
            np.array([[s for _, s in tr]]),
            np.array([[hash(d) for d, _ in tr]]),
            np.array([[s for _, s in jr]]),
            np.array([[hash(d) for d, _ in jr]]), tol)


def pair(n, **kw):
    d_idx, d_val = hot_concentrated_corpus(n_docs=n)
    ids = [f"d{i}" for i in range(n)]
    t = P.ClusterIndex(VOCAB, device="cpu", **kw)
    j = J.TpuClusterIndex(VOCAB, **kw)
    for index in (t, j):
        index.add_csr(ids, d_idx, d_val)
        index.build()
    return t, j, d_idx, d_val


# --------------------------------------------------------------- clustering
@pytest.mark.parametrize("n,G,ragged", [(500, 16, False), (200, 8, True),
                                        (10, 16, False), (257, 64, False)])
def test_clustering_is_bitwise_the_references(n, G, ragged):
    d_idx, d_val = hot_concentrated_corpus(n_docs=n)
    di, dv = list(d_idx), list(d_val)
    if ragged:
        di[0] = np.concatenate([di[0], [VOCAB - 1]]).astype(np.int32)
        dv[0] = np.concatenate([dv[0], [0.01]]).astype(np.float32)
    np.testing.assert_array_equal(P.project_docs(di, dv, VOCAB, 16),
                                  J.project_docs(di, dv, VOCAB, 16))
    cluster_of, K = P.assign_clusters(di, dv, cluster_size=G)
    j_of, j_K = J.assign_clusters(di, dv, cluster_size=G)
    assert K == j_K and cluster_of.dtype == j_of.dtype
    np.testing.assert_array_equal(cluster_of, j_of)
    counts = np.bincount(cluster_of, minlength=K)
    assert counts.max() <= G and counts.min() >= 1
    got = P.build_cluster_arrays(di, dv, cluster_of, K, G, VOCAB, pad_doc=n)
    want = J.build_cluster_arrays(di, dv, cluster_of, K, G, VOCAB, pad_doc=n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_uniform_and_ragged_paths_agree():
    d_idx, d_val = hot_concentrated_corpus(n_docs=200)
    a, ka = P.assign_clusters(list(d_idx), list(d_val), cluster_size=8)
    ragged_i = [r.copy() for r in d_idx]
    ragged_i[0] = np.concatenate([ragged_i[0], [VOCAB - 1]])
    ragged_v = [r.copy() for r in d_val]
    ragged_v[0] = np.concatenate([ragged_v[0], [0.01]])
    b, kb = P.assign_clusters(ragged_i, ragged_v, cluster_size=8)
    assert ka == kb
    np.testing.assert_array_equal(a, b)


def test_summary_upper_bounds_members():
    d_idx, d_val = hot_concentrated_corpus(n_docs=400)
    cluster_of, K = P.assign_clusters(list(d_idx), list(d_val), 16)
    summary, cluster_docs = P.build_cluster_arrays(
        list(d_idx), list(d_val), cluster_of, K, 16, VOCAB, pad_doc=400)
    members = cluster_docs[cluster_docs < 400]
    assert sorted(members.tolist()) == list(range(400))
    qi, qv = queries(n=8)
    for b in range(8):
        q = np.zeros(VOCAB, np.float32)
        q[qi[b]] = qv[b]
        s_sum = summary.T @ q
        for d in range(400):
            assert s_sum[cluster_of[d]] >= float(
                np.dot(q[d_idx[d]], d_val[d])) - 1e-4


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("posting_cap,scoring", [(8, "sort"), (8, "scatter"),
                                                 (0, "sort")])
def test_cluster_search_topk_matches_jax(posting_cap, scoring):
    """On one built index's arrays, with every cluster probed: the same
    union, exact rescores, the dedup; scores within 1e-4."""
    t, _, d_idx, d_val = pair(300, cluster_size=16, n_probes=32,
                              query_top_t=8, posting_cap=posting_cap,
                              posting_candidates=32, posting_scoring=scoring)
    qi, qv = queries(n=6, d_idx=d_idx, d_val=d_val)
    summary, cdocs, *post = t._built
    jpost = (tuple(jnp.asarray(a.numpy()) for a in post) if post else None)
    dm = [a.numpy() for a in t._doc_major]
    tv, ti = P.cluster_search_topk(
        summary, cdocs, tuple(post) if post else None, *t._doc_major,
        torch.from_numpy(qi), torch.from_numpy(qv), 10, VOCAB, 32, 300, 32,
        posting_scoring=scoring)
    jv, ji = J.cluster_search_topk(
        jnp.asarray(summary.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(cdocs.numpy()), jpost, *(jnp.asarray(a) for a in dm),
        jnp.asarray(qi), jnp.asarray(qv), 10, VOCAB, 32, 300, 32,
        posting_scoring=scoring, rescore="gather")
    assert_topk_equivalent(tv.numpy(), ti.numpy(), np.asarray(jv),
                           np.asarray(ji), 1e-4)


def test_dedup_keeps_one_copy_of_each_candidate():
    cand = torch.tensor([[5, 3, 5, 9, 3, 7], [2, 2, 2, 2, 2, 2]])
    scores = torch.tensor([[1.0, 4.0, 1.0, 2.0, 4.0, 0.0],
                           [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]])
    vals, ids = P.dedup_topk(cand, scores, 5)
    assert vals[0].tolist() == [4.0, 2.0, 1.0, 0.0, 0.0]
    assert ids[0].tolist()[:3] == [3, 9, 5]
    assert vals[1].tolist() == [3.0, 0.0, 0.0, 0.0, 0.0]
    assert ids[1].tolist() == [2, 0, 0, 0, 0]


def test_recall_and_exact_scores_match_jax():
    t, j, d_idx, d_val = pair(3000, cluster_size=16, n_probes=48,
                              query_top_t=8)
    assert t.truncated_postings == 0 and t.n_clusters == j.n_clusters
    qi, qv = queries(d_idx=d_idx, d_val=d_val)
    got = t.search_topk(qi, qv, k=10)
    recalls = []
    for b, (top, s) in enumerate(exact_topk(d_idx, d_val, qi, qv, 10)):
        have = {d for d, _ in got[b]}
        recalls.append(len(have & {f"d{x}" for x in top}) / 10)
        for doc, score in got[b]:
            assert abs(score - s[int(doc[1:])]) < 0.02 * abs(score) + 1e-2
    assert np.mean(recalls) >= 0.95, np.mean(recalls)
    # 48 of the clusters probed: JAX's results, ids equal where apart
    same_results(j.search_topk(qi, qv, k=10), got)


def test_summary_scores_are_f32_as_the_references():
    """Phase 1a's [B, V] x [V, K] product: bf16 operands, f32 scores, as
    JAX's ``jnp.dot(..., preferred_element_type=f32)``; within 1e-6 of a
    query's top score, and the same top-48 clusters wherever the 48th and
    49th of JAX's scores are further apart than that."""
    t, _, d_idx, d_val = pair(3000, cluster_size=16, n_probes=48,
                              query_top_t=8)
    qi, qv = queries(d_idx=d_idx, d_val=d_val)
    summary = t._built[0]
    qd = P.sparse_query_dense(torch.from_numpy(qi), torch.from_numpy(qv),
                              VOCAB)[:, :VOCAB].to(torch.bfloat16)
    got = P.summary_scores(qd, summary)
    want = np.asarray(jnp.dot(
        jnp.asarray(qd.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(summary.float().numpy()).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    tol = 1e-6 * np.abs(want).max(1)
    assert (np.abs(got - want).max(1) <= tol).all()
    L = 48
    for b in range(len(qi)):
        order = np.argsort(-want[b], kind="stable")
        if want[b, order[L - 1]] - want[b, order[L]] > 2 * tol[b]:
            assert (set(np.argsort(-got[b], kind="stable")[:L].tolist())
                    == set(order[:L].tolist())), b


def test_beats_truncated_postings_on_hot_terms():
    d_idx, d_val = hot_concentrated_corpus()
    qi, qv = queries(d_idx=d_idx, d_val=d_val)
    exact = exact_topk(d_idx, d_val, qi, qv, 10)

    def recall(index):
        got = index.search_topk(qi, qv, k=10)
        return float(np.mean([len({d for d, _ in got[b]}
                                  & {f"d{x}" for x in top}) / 10
                              for b, (top, _) in enumerate(exact)]))

    ids = [f"d{i}" for i in range(len(d_idx))]
    post = PostingsIndex(VOCAB, n_postings=8, query_top_t=8,
                         rescore_candidates=100, device="cpu")
    clus = P.ClusterIndex(VOCAB, cluster_size=16, n_probes=48,
                          query_top_t=8, device="cpu")
    for index in (post, clus):
        index.add_csr(ids, d_idx, d_val)
        index.build()
    r_post, r_clus = recall(post), recall(clus)
    assert r_clus >= 0.95
    assert r_clus > r_post + 0.1, (r_clus, r_post)


def test_posting_scoring_modes_agree_and_match_jax():
    d_idx, d_val = hot_concentrated_corpus(n_docs=400)
    qi, qv = queries(n=5, d_idx=d_idx, d_val=d_val)
    res = {}
    for mode in ("sort", "scatter"):
        t, j, _, _ = pair(400, cluster_size=16, n_probes=32, query_top_t=8,
                          posting_cap=8, posting_candidates=32,
                          posting_scoring=mode)
        res[mode] = t.search_topk(qi, qv, k=10)
        same_results(j.search_topk(qi, qv, k=10), res[mode])
    for a, b in zip(res["sort"], res["scatter"]):
        assert [d for d, _ in a] == [d for d, _ in b]
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b],
                                   rtol=1e-5)
    assert P.ClusterIndex(VOCAB, query_top_t=8, posting_cap=8,
                          device="cpu").posting_scoring == "sort"
    assert P.ClusterIndex(VOCAB, query_top_t=33, posting_cap=512,
                          device="cpu").posting_scoring == "scatter"
    with pytest.raises(ValueError, match="posting_scoring"):
        P.ClusterIndex(VOCAB, posting_scoring="select", device="cpu")


def test_set_probes_reuses_build():
    d_idx, d_val = hot_concentrated_corpus(n_docs=600)
    qi, qv = queries(n=8, d_idx=d_idx, d_val=d_val)
    ids = [f"d{i}" for i in range(len(d_idx))]
    ix = P.ClusterIndex(VOCAB, cluster_size=16, n_probes=2, query_top_t=8,
                        device="cpu")
    ix.add_csr(ids, d_idx, d_val)
    ix.build()
    built = ix._built
    ix.set_probes(24)
    assert ix.rescore_candidates == 24 * 16 + 128 and ix._built is built
    fresh = P.ClusterIndex(VOCAB, cluster_size=16, n_probes=24,
                           query_top_t=8, device="cpu")
    fresh.add_csr(ids, d_idx, d_val)
    fresh.build()
    for a, b in zip(ix.search_topk(qi, qv, k=10),
                    fresh.search_topk(qi, qv, k=10)):
        assert [d for d, _ in a] == [d for d, _ in b]


def test_padded_cluster_slots_never_returned():
    """10 docs in G=16 clusters: most candidates are the pad row (doc id
    n), which the rescore reads as a row of score 0."""
    t, j, d_idx, d_val = pair(10, cluster_size=16, n_probes=4, query_top_t=8)
    assert t._doc_major[0].shape[0] == 11  # the pad row
    assert int((t._built[1] == 10).sum()) == 6
    qi, qv = queries(n=4)
    got = t.search_topk(qi, qv, k=10)
    for res in got:
        ids = [d for d, _ in res]
        assert len(ids) == len(set(ids))
        assert all(d in {f"d{i}" for i in range(10)} for d in ids)
    same_results(j.search_topk(qi, qv, k=10), got)


# -------------------------------------------------------------------- CRUD
def _crud_index(n=300):
    d_idx, d_val = hot_concentrated_corpus(n_docs=n)
    index = P.ClusterIndex(VOCAB, cluster_size=16, n_probes=16,
                           query_top_t=8, device="cpu")
    index.add_csr([f"d{i}" for i in range(n)], d_idx, d_val)
    index.build()
    return index


def test_delta_add_served_without_rebuild():
    index = _crud_index()
    base_built = index._built
    strong = np.array([7, 8, 9, 10], np.int32)
    index.add("new", strong, np.full(4, 50.0, np.float32))
    assert index.delta_count == 1 and index._built is base_built
    assert index.search_vector(strong, np.ones(4, np.float32),
                               k=3)[0][0] == "new"


def test_delete_and_update():
    index = _crud_index()
    qi, qv = queries(n=1)
    victim = index.search_topk(qi, qv, k=5)[0][0][0]
    assert index.delete([victim]) == 1
    after = index.search_topk(qi, qv, k=5)[0]
    assert victim not in [d for d, _ in after]
    index.update(after[0][0], np.array([3], np.int32),
                 np.array([99.0], np.float32))
    res = index.search_vector(np.array([3], np.int32),
                              np.array([1.0], np.float32), k=1)
    assert res[0][0] == after[0][0] and abs(res[0][1] - 99.0) < 1.0


def test_compact_folds_delta_and_tombstones():
    index = _crud_index(n=100)
    index.add("x1", np.array([5], np.int32), np.array([40.0], np.float32))
    index.delete(["d0", "d1"])
    index.compact()
    assert index.delta_count == 0 and index.deleted_count == 0
    assert len(index) == 99
    assert index.search_vector(np.array([5], np.int32),
                               np.array([1.0], np.float32), k=1)[0][0] == "x1"


def test_save_load_roundtrips_posting_scoring_and_across_packages(tmp_path):
    t, j, _, _ = pair(100, cluster_size=16, n_probes=4, query_top_t=8,
                      posting_cap=8, posting_candidates=32,
                      posting_scoring="scatter")  # auto would pick sort
    p = str(tmp_path / "port.npz")
    t.save(p)
    assert P.ClusterIndex.load(p, device="cpu").posting_scoring == "scatter"
    assert J.TpuClusterIndex.load(p).posting_scoring == "scatter"
    j.save(str(tmp_path / "jax.npz"))
    back = P.ClusterIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    assert (back.posting_scoring, back.cluster_size, back.n_probes,
            back.posting_cap, back.posting_candidates) == (
        "scatter", 16, 4, 8, 32)
    with pytest.raises(ValueError, match="cluster"):
        PostingsIndex.load(p, device="cpu")


def test_save_load_roundtrip(tmp_path):
    t, j, _, _ = pair(200, cluster_size=16, n_probes=16, query_top_t=8)
    p = str(tmp_path / "cluster.npz")
    t.save(p)
    loaded = P.ClusterIndex.load(p, device="cpu")
    assert isinstance(loaded, P.ClusterIndex)
    assert loaded.cluster_size == 16 and loaded.n_probes == 16
    qi, qv = queries(n=4)
    for ra, rb in zip(t.search_topk(qi, qv, k=5),
                      loaded.search_topk(qi, qv, k=5)):
        assert [d for d, _ in ra] == [d for d, _ in rb]
    same_results(j.search_topk(qi, qv, k=5), t.search_topk(qi, qv, k=5))


# ------------------------------------------- tests/test_postings_crud_fuzz.py
FUZZ_VOCAB = 64


def _rand_vec(rng):
    n_terms = int(rng.integers(2, 9))
    idx = rng.choice(FUZZ_VOCAB, size=n_terms, replace=False).astype(np.int32)
    return idx, rng.uniform(0.1, 3.0, size=n_terms).astype(np.float32)


def _brute_topk(live: dict, q_idx, q_val, k: int):
    qd = np.zeros(FUZZ_VOCAB, np.float32)
    qd[q_idx] = q_val
    scored = [(d, float((qd[idx] * val).sum())) for d, (idx, val)
              in live.items()]
    scored = sorted((x for x in scored if x[1] > 0),
                    key=lambda t: (-t[1], t[0]))
    return scored[:k]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crud_matches_brute_force(seed):
    """The cluster cases of tests/test_postings_crud_fuzz.py: a lossless
    config (probes above any cluster count the corpus reaches), random
    add / delete / update / compact / search, each search against a brute
    force over the live documents within the per-doc int8 rounding
    (QTOL 0.06, the reference test's)."""
    rng = np.random.default_rng(seed)
    index = P.ClusterIndex(FUZZ_VOCAB, cluster_size=8, n_probes=32,
                           query_top_t=16, batch_pad=1, approx=False,
                           posting_cap=16, posting_candidates=64,
                           device="cpu")
    live, next_id = {}, 0
    ids, vecs = [], []
    for _ in range(20):
        idx, val = _rand_vec(rng)
        live[f"d{next_id}"] = (idx, val)
        ids.append(f"d{next_id}")
        vecs.append((idx, val))
        next_id += 1
    index.add_batch(ids, vecs)
    index.build()
    searches = 0
    QTOL = 0.06
    for op_i in range(60):
        op = rng.choice(["add", "delete", "update", "search", "compact"],
                        p=[0.3, 0.15, 0.15, 0.3, 0.1])
        if op == "add":
            idx, val = _rand_vec(rng)
            live[f"d{next_id}"] = (idx, val)
            index.add(f"d{next_id}", idx, val)
            next_id += 1
        elif op == "delete" and live:
            doc_id = str(rng.choice(sorted(live)))
            del live[doc_id]
            assert index.delete([doc_id]) == 1
        elif op == "update" and live:
            doc_id = str(rng.choice(sorted(live)))
            idx, val = _rand_vec(rng)
            live[doc_id] = (idx, val)
            index.update(doc_id, idx, val)
        elif op == "compact":
            index.compact()
        else:
            q_idx, q_val = _rand_vec(rng)
            k = int(rng.integers(1, 8))
            got = index.search_vector(q_idx, q_val, k=k)
            want = _brute_topk(live, q_idx, q_val, k)
            assert len(got) == len(want), (op_i, got, want)
            brute_all = dict(_brute_topk(live, q_idx, q_val, len(live)))
            for gid, gs in got:
                assert gid in brute_all, (op_i, gid, got, want)
                assert gs == pytest.approx(brute_all[gid], rel=QTOL)
            if want:
                boundary = want[-1][1]
                got_ids = {d for d, _ in got}
                for gid, _ in got:
                    assert brute_all[gid] >= boundary * (1 - QTOL)
                for wid, ws in want:
                    if ws > boundary * (1 + QTOL):
                        assert wid in got_ids, (op_i, got, want)
            searches += 1
    assert searches >= 10
