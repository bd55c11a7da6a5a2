"""The port's postings index (splade_tpu_torch.ops.postings_index) against
splade_tpu's on the same numpy corpus and queries: the build, the four
phase-1 aggregations, two-phase search, the filler contract, the index's
search/CRUD, and an archive written by splade_tpu's save() loaded by the
port's load().

Top-k orders of tied scores may differ (``lax.top_k`` breaks ties by lower
index, ``torch.topk`` promises no order), so ids are compared where scores
are separated by more than the tolerance and as sets within ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.ops import postings_index as J
from splade_tpu_torch.ops import postings_index as P

V, N, NNZ, PCAP = 200, 300, 12, 16

# the JAX reference functions, jitted once per static configuration
jax_score_topk = jax.jit(J.postings_score_topk, static_argnums=(5, 6, 7),
                         static_argnames=("acc_dtype", "scoring"))
jax_two_phase = jax.jit(J.postings_two_phase_topk,
                        static_argnums=(8, 9, 10, 11, 12),
                        static_argnames=("scoring", "rescore"))


def corpus(seed=0, n=N):
    rng = np.random.default_rng(seed)
    idx = [np.sort(rng.choice(V, NNZ, replace=False)).astype(np.int32)
           for _ in range(n)]
    val = [rng.uniform(0.05, 3.0, NNZ).astype(np.float32) for _ in range(n)]
    return idx, val


def queries(seed=1, B=5, T=8):
    rng = np.random.default_rng(seed)
    q_idx = np.zeros((B, T), np.int32)
    q_val = np.zeros((B, T), np.float32)
    for b in range(B):
        t = int(rng.integers(3, T + 1))
        q_idx[b, :t] = rng.choice(V, t, replace=False)
        q_val[b, :t] = rng.uniform(0.1, 2.0, t)
    q_idx[0, 1] = q_idx[0, 0]  # duplicate query term
    return q_idx, q_val


def assert_topk_equivalent(t_vals, t_ids, j_vals, j_ids, tol):
    t_vals, j_vals = np.asarray(t_vals, np.float64), np.asarray(j_vals, np.float64)
    t_ids, j_ids = np.asarray(t_ids), np.asarray(j_ids)
    assert t_vals.shape == j_vals.shape
    fin = np.isfinite(j_vals)
    np.testing.assert_array_equal(np.isfinite(t_vals), fin)
    np.testing.assert_allclose(t_vals[fin], j_vals[fin], rtol=0, atol=tol)
    np.testing.assert_array_equal(t_ids[~fin], 0)  # fillers: id 0
    for b in range(j_vals.shape[0]):
        k = int(fin[b].sum())
        start = 0
        while start < k:
            end = start + 1
            while end < k and abs(j_vals[b, end] - j_vals[b, end - 1]) <= tol:
                end += 1
            if end < k:  # a tie group cut by the k boundary may differ
                assert (set(t_ids[b, start:end].tolist())
                        == set(j_ids[b, start:end].tolist())), (b, start)
            start = end


@pytest.fixture(scope="module")
def built():
    idx, val = corpus()
    j_docs, j_w, j_tr = J.invert_to_postings(idx, val, V, PCAP)
    t_docs, t_w, t_tr = P.invert_to_postings(idx, val, V, PCAP)
    assert j_tr == t_tr
    np.testing.assert_array_equal(t_docs, j_docs)
    np.testing.assert_array_equal(t_w, j_w)
    q, scale = P.quantize_postings(t_w)
    jq, jscale = J.quantize_postings(j_w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    return t_docs, q, scale


@pytest.mark.parametrize("scoring,acc,k,tol", [
    ("scatter", "f32", 10, 1e-5),
    ("scatter", "bf16", 10, 2e-2),
    ("sort", "f32", 10, 1e-5),
    ("sort", "f32", 200, 1e-5),        # k beyond the pool: fillers
    ("select", "f32", 20, 1e-5),
    ("select_sum", "f32", 10, 1e-5),
])
def test_phase1_matches_jax(built, scoring, acc, k, tol):
    docs, q, scale = built
    q_idx, q_val = queries()
    jdt = jnp.float32 if acc == "f32" else jnp.bfloat16
    tdt = torch.float32 if acc == "f32" else torch.bfloat16
    # eager, for scatter: jitted XLA fuses away the bf16 rounding of each
    # product, which eager JAX and the port keep
    score_topk = J.postings_score_topk if scoring == "scatter" else jax_score_topk
    jv, ji = score_topk(
        jnp.asarray(docs), jnp.asarray(q), jnp.asarray(scale),
        jnp.asarray(q_idx), jnp.asarray(q_val), k, N, False,
        acc_dtype=jdt, scoring=scoring)
    tv, ti = P.postings_score_topk(
        *(torch.from_numpy(x) for x in (docs, q, scale, q_idx, q_val)),
        k, N, False, acc_dtype=tdt, scoring=scoring)
    jv = np.asarray(jv.astype(jnp.float32))
    assert_topk_equivalent(tv.float().numpy(), ti.numpy(), jv,
                           np.asarray(ji), tol)


@pytest.mark.parametrize("scoring", ["scatter", "sort", "select",
                                     "select_sum"])
def test_filler_contract(built, scoring):
    """Fillers carry val -inf and id 0; two-phase never rescores them."""
    docs, q, scale = built
    q_idx = np.zeros((2, 4), np.int32)
    q_val = np.zeros((2, 4), np.float32)
    q_idx[0, 0], q_val[0, 0] = 7, 1.0  # one term: a pool of <= PCAP docs
    tv, ti = P.postings_score_topk(
        *(torch.from_numpy(x) for x in (docs, q, scale, q_idx, q_val)),
        64, N, False, scoring=scoring)
    jv, _ = jax_score_topk(
        *(jnp.asarray(x) for x in (docs, q, scale, q_idx, q_val)),
        64, N, False, scoring=scoring)
    filler = tv == float("-inf")
    np.testing.assert_array_equal(filler.sum(1).numpy(),
                                  np.isneginf(np.asarray(jv)).sum(1))
    assert (ti[filler] == 0).all()
    if scoring == "scatter":  # finite scores over every doc
        assert not filler.any()
    else:  # one term's pool is smaller than k
        assert filler[0].any()
    if scoring in ("select", "select_sum"):
        assert filler[1].all()  # an all-pad query selects nothing


def _doc_major(idx, val):
    index = P.PostingsIndex(V, n_postings=PCAP, rescore_candidates=1,
                            device="cpu")
    return index._doc_major_arrays(idx, val, len(idx))


@pytest.mark.parametrize("scoring,C", [("scatter", 40), ("sort", 40),
                                       ("select", 60), ("select_sum", 30),
                                       ("sort", 500)])
def test_two_phase_matches_jax(built, scoring, C):
    docs, q, scale = built
    idx, val = corpus()
    terms, dv, ds = _doc_major(idx, val)
    q_idx, q_val = queries(3)
    k = 10
    jv, ji = jax_two_phase(
        *(jnp.asarray(x) for x in (docs, q, scale, terms.astype(np.int32),
                                   dv, ds, q_idx, q_val)),
        k, N, V, C, False, scoring=scoring, rescore="gather")
    tv, ti = P.postings_two_phase_topk(
        *(torch.from_numpy(x) for x in (docs, q, scale,
                                        terms.astype(np.int32), dv, ds,
                                        q_idx, q_val)),
        k, N, V, C, False, scoring=scoring, rescore="auto")
    assert_topk_equivalent(tv.numpy(), ti.numpy(), np.asarray(jv),
                           np.asarray(ji), 1e-4)


def _pair(rescore, scoring="auto"):
    idx, val = corpus(5)
    kw = dict(n_postings=PCAP, query_top_t=8, rescore_candidates=rescore,
              scoring=scoring)
    j = J.TpuPostingsIndex(V, **kw)
    t = P.PostingsIndex(V, device="cpu", **kw)
    ids = [f"d{i}" for i in range(N)]
    for index in (j, t):
        index.add_batch(ids, list(zip(idx, val)))
        index.build()
    return j, t


def _same_results(j_out, t_out, tol=1e-4):
    for jr, tr in zip(j_out, t_out):
        assert len(jr) == len(tr)
        jv = np.array([[s for _, s in jr]])
        tv = np.array([[s for _, s in tr]])
        assert_topk_equivalent(tv, np.array([[hash(d) for d, _ in tr]]),
                               jv, np.array([[hash(d) for d, _ in jr]]), tol)


@pytest.mark.parametrize("rescore,scoring", [(0, "scatter"), (0, "sort"),
                                             (50, "auto"), (50, "select")])
def test_index_search_and_crud_match_jax(rescore, scoring):
    j, t = _pair(rescore, scoring)
    assert t.resolved_scoring() == j.resolved_scoring()
    # single-phase scatter scores are sums of bf16 products: jitted XLA
    # fuses away the bf16 rounding of each product that eager torch keeps,
    # so they agree to bf16 resolution only; exact rescores agree to 1e-4
    tol = 3e-2 if scoring == "scatter" else 1e-4
    q_idx, q_val = queries(4)
    _same_results(j.search_topk(q_idx, q_val, k=10),
                  t.search_topk(q_idx, q_val, k=10), tol)
    # LSM delta, tombstones, then compaction
    rng = np.random.default_rng(9)
    new_idx = q_idx[2][q_val[2] > 0]
    for index in (j, t):
        index.add("fresh", new_idx, np.full(len(new_idx), 5.0, np.float32))
        index.delete(["d1", "d2", "d3"])
    assert t.delta_count == j.delta_count == 1
    assert t.deleted_count == j.deleted_count == 3
    _same_results(j.search_topk(q_idx, q_val, k=10),
                  t.search_topk(q_idx, q_val, k=10), tol)
    assert t.search_topk(q_idx[2:3], q_val[2:3], k=3)[0][0][0] == "fresh"
    for index in (j, t):
        index.update("d10", rng.choice(V, 5, replace=False),
                     np.ones(5, np.float32))
        index.compact()
    assert len(t) == len(j) and t.delta_count == 0
    _same_results(j.search_topk(q_idx, q_val, k=10),
                  t.search_topk(q_idx, q_val, k=10), tol)


def test_jax_archive_loads_in_port(tmp_path):
    j, _ = _pair(40)
    j.delete(["d7"])
    path = tmp_path / "idx.npz"
    j.save(str(path))
    t = P.PostingsIndex.load(str(path), device="cpu")
    assert (t.n_postings, t.query_top_t, t.rescore_candidates) == (
        j.n_postings, j.query_top_t, j.rescore_candidates)
    assert t.doc_ids == j.doc_ids and "d7" not in t.doc_ids
    q_idx, q_val = queries(6)
    _same_results(j.search_topk(q_idx, q_val, k=10),
                  t.search_topk(q_idx, q_val, k=10))
    # and back: the port's archive loads in splade_tpu
    t.save(str(tmp_path / "back.npz"))
    j2 = J.TpuPostingsIndex.load(str(tmp_path / "back.npz"))
    assert j2.doc_ids == t.doc_ids


def test_empty_and_invalid_configs():
    with pytest.raises(ValueError):
        P.PostingsIndex(V, scoring="select", device="cpu")
    with pytest.raises(ValueError):
        P.PostingsIndex(V, device="cpu").build()
    t = P.PostingsIndex(V, device="cpu")
    t.add("a", np.array([1, 2]), np.array([1.0, 2.0], np.float32))
    t.delete(["a"])
    t.compact()
    assert t.search_topk(np.array([[1]]), np.array([[1.0]]), k=3) == [[]]
