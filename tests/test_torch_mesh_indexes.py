"""The port's doc-sharded indexes (splade_tpu_torch's MeshSharded*
classes, the mesh layout of ImpactIndex, merge_sharded_topk and make_mesh)
against splade_tpu's, on the same numpy corpora and queries.

JAX runs on its 8 virtual CPU devices (tests/conftest.py) and the port on
``make_mesh(devices=["cpu"] * 8)``. The mesh cases of
tests/test_postings_index.py (:125, 162, 461, 486, 514, 557, 670),
tests/test_tiered_postings.py (:201), tests/test_cluster_index.py (:304,
328, 351) and tests/test_impact_index.py (:117) run through both packages.
Held: each shard's arrays bitwise the reference's stacked ones; searches
within 1e-4 (scores) and ids equal where scores are further apart than
that, except the single-phase scatter accumulator, 3e-2 (XLA on the CPU
keeps the bf16 contributions in f32, as tests/test_torch_postings.py
allows); ``merge_sharded_topk`` exactly JAX's on sort-capped widths, ids
past n, ``require_positive`` and k above D·k_local; save -> load(mesh=) of
each mesh kind; and every shard searched on its own device."""

import contextlib

import numpy as np
import pytest
import torch

from splade_tpu.benchmark.index import ExactSparseIndex
from splade_tpu.ops import cluster_index as JC
from splade_tpu.ops import impact_index as JI
from splade_tpu.ops import postings_index as JP
from splade_tpu.ops import tiered_postings as JT
from splade_tpu.parallel.mesh import make_mesh as jax_mesh
from splade_tpu_torch.ops import cluster_index as TC
from splade_tpu_torch.ops import impact_index as TI
from splade_tpu_torch.ops import postings_index as TP
from splade_tpu_torch.ops import tiered_postings as TT
from splade_tpu_torch.parallel import DeviceMesh, make_mesh
from test_torch_cluster import hot_concentrated_corpus
from test_torch_cluster import queries as cluster_queries
from test_torch_postings import assert_topk_equivalent

V = 500
CPU8 = ["cpu"] * 8


def mesh8():
    return make_mesh(devices=CPU8)


def synth_corpus(n=300, nnz=12, seed=0):
    """tests/test_postings_index.py's corpus."""
    rng = np.random.default_rng(seed)
    return [(rng.choice(V, size=nnz, replace=False).astype(np.int32),
             (np.abs(rng.normal(size=nnz)) + 0.05).astype(np.float32))
            for _ in range(n)]


def synth_queries(b=16, t=6, seed=1):
    rng = np.random.default_rng(seed)
    qi = np.stack([rng.choice(V, size=t, replace=False) for _ in range(b)])
    qv = np.abs(rng.normal(size=(b, t))).astype(np.float32) + 0.05
    return qi.astype(np.int32), qv


def same_results(j_out, t_out, tol=1e-4):
    """Scores within ``tol``, ids equal where scores are further apart."""
    assert len(j_out) == len(t_out)
    for jr, tr in zip(j_out, t_out):
        assert len(jr) == len(tr), (jr, tr)
        if not jr:
            continue
        assert_topk_equivalent(
            np.array([[s for _, s in tr]]), np.array([[hash(d) for d, _ in tr]]),
            np.array([[s for _, s in jr]]), np.array([[hash(d) for d, _ in jr]]),
            tol)


def fill(indexes, docs):
    for index in indexes:
        for i, (idx, val) in enumerate(docs):
            index.add(f"d{i}", idx, val)
        index.build()


def assert_shards_are_the_references(t_shards, j_stacked):
    """Shard d's tensors == the reference's [D, ...] arrays at d (term ids
    compared as values: the port keeps int32 where JAX keeps uint16)."""
    assert len(t_shards) == np.asarray(j_stacked[0]).shape[0]
    for a, j_arr in enumerate(j_stacked):
        got = np.stack([shard[a].float().numpy() if shard[a].dtype
                        == torch.bfloat16 else shard[a].numpy()
                        for shard in t_shards])
        want = np.asarray(j_arr)
        np.testing.assert_array_equal(got, want.astype(got.dtype))


# ------------------------------------------------------------- make_mesh
def test_make_mesh_takes_explicit_devices_with_repeats():
    mesh = make_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(3, devices=CPU8).size == 3
    assert make_mesh(0, devices=CPU8).size == 8  # 0 and -1: every device
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(Exception):  # frozen
        mesh.devices = ()


def test_make_mesh_takes_every_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert make_mesh(2).devices == mesh.devices[:2]
    with pytest.raises(ValueError):
        make_mesh(4)


# ----------------------------------------------------- merge_sharded_topk
def _merge_case(case):
    """[D, B, k_local] partials as the shards hand them: distinct scores,
    local ids; some cases with ragged-tail ids past n, zero scores, -inf
    fillers."""
    rng = np.random.default_rng(3)
    D, B, kl, per = 8, 4, 6, 10
    vals = rng.permutation(D * B * kl).reshape(D, B, kl).astype(np.float32)
    vals = -np.sort(-(vals / 7.0 + 0.5), axis=2)
    ids = np.stack([np.stack([rng.permutation(per)[:kl] for _ in range(B)])
                    for _ in range(D)]).astype(np.int32)
    n, k, require_positive = D * per, 20, False
    if case == "sort_capped":       # sort scoring returned fewer than k_local
        vals, ids, k = vals[:, :, :3], ids[:, :, :3], 20
    elif case == "ragged_tail":     # the last shards' pad documents
        n = 6 * per + 4
    elif case == "require_positive":
        vals[:, :, 3:] = 0.0        # pad documents score exactly 0
        require_positive = True
    elif case == "k_above_pool":
        vals[:, :, 4:] = -np.inf    # sort fillers
        k = 100
    return vals, ids, k, per, n, require_positive


@pytest.mark.parametrize("case", ["plain", "sort_capped", "ragged_tail",
                                  "require_positive", "k_above_pool"])
def test_merge_sharded_topk_is_the_references(case):
    vals, ids, k, per, n, req = _merge_case(case)
    jv, ji = JP.merge_sharded_topk(vals, ids, k, per, n,
                                   require_positive=req)
    tv, ti = TP.merge_sharded_topk(torch.from_numpy(vals),
                                   torch.from_numpy(ids), k, per, n,
                                   require_positive=req)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape == (vals.shape[1],
                                    min(k, vals.shape[0] * vals.shape[2]))
    # distinct scores: equal element for element; the masked slots are
    # the (0.0, 0) pairs and -inf fillers, compared as sorted pairs
    for b in range(jv.shape[0]):
        assert sorted(zip(tv[b].tolist(), ti[b].tolist())) == sorted(
            zip(jv[b].tolist(), ji[b].tolist()))
    assert bool((ti < n).all())
    if case == "ragged_tail":
        assert int((ti == 0).sum()) > 0  # some pads were masked
    if req:
        assert bool(((tv > 0) | ((tv == 0) & (ti == 0))).all())


# ------------------------------------------------------- postings (mesh)
#: JAX test_postings_index.py case -> (documents, index config, k, tol)
POSTINGS_CASES = {
    "lossless_single_phase": (300, dict(n_postings=512), 5, 3e-2),   # :125
    "ragged_tail": (43, dict(n_postings=512), 10, 3e-2),             # :162
    "sort_scoring": (300, dict(n_postings=512, scoring="sort"), 5, 1e-4),
    "two_phase_cover": (300, dict(n_postings=4,                      # :486
                                  rescore_candidates=10_000), 5, 1e-4),
    "two_phase_ragged_tail": (43, dict(n_postings=8,                 # :514
                                       rescore_candidates=16), 10, 1e-4),
    "max_results_past_rescore": (300, dict(n_postings=64,            # :557
                                           rescore_candidates=5), 30, 1e-4),
    # 3 documents over 8 shards of 1: five empty tail shards
    "empty_tail_shards": (3, dict(n_postings=8, rescore_candidates=16), 10,
                          1e-4),
}


@pytest.mark.parametrize("case", list(POSTINGS_CASES))
def test_mesh_postings_index_is_the_references(case):
    n, kw, k, tol = POSTINGS_CASES[case]
    docs = synth_corpus()[:n]
    j = JP.MeshShardedPostingsIndex(V, jax_mesh(), query_top_t=8,
                                    approx=False, **kw)
    t = TP.MeshShardedPostingsIndex(V, mesh8(), query_top_t=8, approx=False,
                                    **kw)
    fill((j, t), docs)
    assert isinstance(t, TP.PostingsIndex) and t.n_shards == 8
    assert t._shard_size == j._shard_size == -(-n // 8)
    assert t.truncated_postings == j.truncated_postings
    assert t.max_results() == j.max_results()
    assert_shards_are_the_references(t._built, j._built)
    if kw.get("rescore_candidates"):
        assert_shards_are_the_references(t._doc_major, j._doc_major)
    assert t.memory_bytes() > 0
    qi, qv = synth_queries(b=16 if n == 300 else 8)
    got = t.search_topk(qi, qv, k=k)
    same_results(j.search_topk(qi, qv, k=k), got, tol)
    live = {f"d{i}" for i in range(n)}
    assert all(d in live and s > 0 for r in got for d, s in r)
    if case == "max_results_past_rescore":
        assert t.max_results() == 40  # 8 shards x 5
        assert max(len(r) for r in got) > 5
    if case == "two_phase_cover":
        assert t.truncated_postings > 0  # phase 1 alone would be lossy
        exact = ExactSparseIndex(vocab_size=V)
        for i, (idx, val) in enumerate(docs):
            exact.add(f"d{i}", idx, val)
        for b in range(len(qi)):
            ref = dict(exact.search_vector(qi[b], qv[b], k=n))
            for doc, score in got[b]:
                assert score == pytest.approx(ref[doc], rel=0.05, abs=0.02)


def test_mesh_postings_delta_crud_is_the_references():
    """tests/test_postings_index.py:670 through both packages: a post-build
    add served from the host delta without a rebuild, a tombstoned base
    document, compact() re-sharding."""
    rng = np.random.default_rng(7)
    Vs = 256
    docs = [(rng.choice(Vs, size=6, replace=False).astype(np.int32),
             rng.uniform(0.5, 2.0, 6).astype(np.float32)) for _ in range(48)]
    kw = dict(n_postings=32, query_top_t=8, approx=False,
              rescore_candidates=16)
    j = JP.MeshShardedPostingsIndex(Vs, jax_mesh(), **kw)
    t = TP.MeshShardedPostingsIndex(Vs, mesh8(), **kw)
    fill((j, t), docs)
    built = t._built
    probe = (np.array([9, 10], np.int32), np.array([1.0, 1.0], np.float32))
    for index in (j, t):
        index.add("late", np.array([9, 10], np.int32),
                  np.array([50.0, 50.0], np.float32))
    assert t.delta_count == 1 and t._built is built
    res = t.search_vector(*probe, k=3)
    same_results([j.search_vector(*probe, k=3)], [res])
    assert res[0][0] == "late" and abs(res[0][1] - 100.0) < 1.0
    victim = res[1][0] if len(res) > 1 else "d0"
    for index in (j, t):
        assert index.delete([victim]) == 1
    res = t.search_vector(*probe, k=10)
    same_results([j.search_vector(*probe, k=10)], [res])
    assert victim not in [d for d, _ in res] and t._built is built
    for index in (j, t):
        index.compact()
    assert t.delta_count == 0 and t.deleted_count == 0 and len(t) == 48
    assert_shards_are_the_references(t._built, j._built)
    res = t.search_vector(*probe, k=3)
    same_results([j.search_vector(*probe, k=3)], [res])
    assert res[0][0] == "late"


# --------------------------------------------------------- tiered (mesh)
def hot_corpus(n, seed=0):
    """tests/test_tiered_postings.py's hot-term corpus: terms 3, 5 and 7 in
    most documents, plus a random tail."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        tail = rng.choice(np.arange(50, V), size=6, replace=False)
        hot = rng.choice([3, 5, 7], size=2, replace=False)
        idx = np.concatenate([hot, tail]).astype(np.int32)
        docs.append((idx, (np.abs(rng.normal(size=8)) + 0.05).astype(
            np.float32)))
    return docs


@pytest.mark.parametrize("n", [330, 17], ids=["ragged_tail", "empty_tail"])
def test_mesh_tiered_index_is_the_references(n):
    """tests/test_tiered_postings.py:201 (330 = 8·42 - 6: a short tail
    shard) and 17 documents (shards of 3: the last two empty)."""
    kw = dict(n_postings=8, hot_terms=64, hot_postings=512, query_top_t=8,
              rescore_candidates=64, approx=False, scoring="sort")
    docs = hot_corpus(n)
    j = JT.MeshShardedTieredPostingsIndex(V, jax_mesh(), **kw)
    t = TT.MeshShardedTieredPostingsIndex(V, mesh8(), **kw)
    single = TT.TieredPostingsIndex(V, device="cpu", **kw)
    fill((j, t, single), docs)
    assert isinstance(t, TT.TieredPostingsIndex)
    assert (t.n_hot, t.truncated_postings) == (j.n_hot, j.truncated_postings)
    assert t.truncated_postings <= single.truncated_postings
    assert_shards_are_the_references(t._built, j._built)
    assert_shards_are_the_references(t._doc_major, j._doc_major)
    for shard in t._built:  # every shard: Hmax hot rows + the pad row
        assert shard[4].shape == (65, 512) and int(shard[3].max()) <= 64
    rng = np.random.default_rng(5)
    qi = np.stack([np.concatenate([
        rng.choice([3, 5, 7], size=1),
        rng.choice(np.arange(50, V), size=3, replace=False)])
        for _ in range(8)]).astype(np.int32)
    qv = (np.abs(rng.normal(size=(8, 4))) + 0.1).astype(np.float32)
    got = t.search_topk(qi, qv, k=5)
    same_results(j.search_topk(qi, qv, k=5), got)
    # two-phase scores are exact: the single-device index's, up to ties
    same_results(single.search_topk(qi, qv, k=5), got)


# -------------------------------------------------------- cluster (mesh)
def _cluster_pair(n, **kw):
    d_idx, d_val = hot_concentrated_corpus(n_docs=n)
    ids = [f"d{i}" for i in range(n)]
    j = JC.MeshShardedClusterIndex(TC_VOCAB, jax_mesh(), **kw)
    t = TC.MeshShardedClusterIndex(TC_VOCAB, mesh8(), **kw)
    for index in (j, t):
        index.add_csr(ids, d_idx, d_val)
        index.build()
    return j, t, d_idx, d_val


TC_VOCAB = 512


@pytest.mark.parametrize("n,kw,k_shards", [
    # tests/test_cluster_index.py:304: every shard's clusters all probed
    (1000, dict(cluster_size=16, n_probes=16, query_top_t=8, posting_cap=16,
                posting_candidates=32), [8] * 8),
    # :351: per = 130 at G = 64 bisects into 4 clusters (not ceil = 3),
    # the 124-document tail into 2; every shard padded to 4
    (1034, dict(cluster_size=64, n_probes=8, query_top_t=8), [4] * 7 + [2]),
    # 29 documents: shards of 4, a 1-document tail; clusters only
    (29, dict(cluster_size=8, n_probes=4, query_top_t=8, posting_cap=0),
     [1] * 8),
], ids=["exact_and_single", "bisection_k_above_ceil", "short_tail"])
def test_mesh_cluster_index_is_the_references(n, kw, k_shards):
    j, t, d_idx, d_val = _cluster_pair(n, **kw)
    assert isinstance(t, TC.ClusterIndex)
    assert t.n_clusters == j.n_clusters == sum(k_shards)
    assert t.max_results() == j.max_results()
    assert_shards_are_the_references(t._built, j._built)
    assert_shards_are_the_references(t._doc_major, j._doc_major)
    per = t._shard_size
    for shard, K in zip(t._built, k_shards):
        assert shard[0].dtype == torch.bfloat16
        assert shard[0].shape == (TC_VOCAB, max(k_shards))
        assert bool((shard[0][:, K:] == 0).all())      # pad clusters
        assert bool((shard[1][K:] == per).all())       # all pad document
    qi, qv = cluster_queries(n=16, d_idx=d_idx, d_val=d_val)
    got = t.search_topk(qi, qv, k=10)
    same_results(j.search_topk(qi, qv, k=10), got)
    dense = np.zeros((n, TC_VOCAB), np.float32)
    np.put_along_axis(dense, d_idx.astype(np.int64), d_val, axis=1)
    for b, res in enumerate(got):
        ids = [int(d[1:]) for d, _ in res]
        assert len(ids) == len(set(ids)) and all(i < n for i in ids)
        q = np.zeros(TC_VOCAB, np.float32)
        q[qi[b]] = qv[b]
        for i, (_, score) in zip(ids, res):  # exact, up to int8 rounding
            assert abs(score - dense[i] @ q) < 0.02 * abs(score) + 1e-2


@pytest.mark.parametrize("n", [3, 17])
def test_mesh_cluster_with_empty_tail_shards(n):
    """More than one empty tail shard (3 documents in shards of 1, 17 in
    shards of 3): every shard a cluster of its own documents or of pads,
    and with every cluster probed the mesh index returns the single-device
    index's exact results (within 1e-4, ids equal where scores are further
    apart). The reference's mesh class cannot build these: its doc-major
    padding takes ``hi - lo`` rows, negative past the second empty shard."""
    d_idx, d_val = hot_concentrated_corpus(n_docs=n)
    ids = [f"d{i}" for i in range(n)]
    kw = dict(cluster_size=8, n_probes=4, query_top_t=8)
    t = TC.MeshShardedClusterIndex(TC_VOCAB, mesh8(), **kw)
    single = TC.ClusterIndex(TC_VOCAB, device="cpu", **kw)
    for index in (t, single):
        index.add_csr(ids, d_idx, d_val)
        index.build()
    assert t.n_clusters == 8 and t._shard_size == -(-n // 8)
    qi, qv = cluster_queries(n=8, d_idx=d_idx, d_val=d_val)
    got = t.search_topk(qi, qv, k=10)
    same_results(single.search_topk(qi, qv, k=10), got)
    assert all(int(d[1:]) < n for r in got for d, _ in r)


def test_mesh_cluster_crud_delta_is_the_references():
    """tests/test_cluster_index.py:328 through both packages."""
    j, t, _, _ = _cluster_pair(300, cluster_size=16, n_probes=8,
                               query_top_t=8)
    built = t._built
    probe = (np.array([5, 6], np.int32), np.array([1.0, 1.0], np.float32))
    for index in (j, t):
        index.add("late", np.array([5, 6], np.int32),
                  np.array([60.0, 60.0], np.float32))
    assert t.delta_count == 1 and t._built is built
    res = t.search_vector(*probe, k=3)
    same_results([j.search_vector(*probe, k=3)], [res])
    assert res[0][0] == "late"
    for index in (j, t):
        assert index.delete(["d0"]) == 1
        index.compact()
    assert len(t) == 300 and t.delta_count == 0
    res = t.search_vector(*probe, k=3)
    same_results([j.search_vector(*probe, k=3)], [res])
    assert res[0][0] == "late"


# ---------------------------------------------------------- dense (mesh)
def test_mesh_impact_index_is_the_single_device_one_and_the_references():
    """tests/test_impact_index.py:117: the row-sharded corpus ranks as the
    single-device index (the exact top-k; ids equal up to ties, scores
    within 1e-4) and as JAX's sharded index; rows padded to 128·8; the
    single-query and two-phase API on the mesh index too."""
    rng = np.random.default_rng(42)
    Vd = 256
    docs = [(rng.choice(Vd, size=12, replace=False).astype(np.int32),
             (np.abs(rng.normal(size=12)) + 0.05).astype(np.float32))
            for _ in range(300)]
    ids = [f"d{i}" for i in range(300)]
    sharded = TI.ImpactIndex(Vd, quantize_int8=True, mesh=mesh8())
    plain = TI.ImpactIndex(Vd, quantize_int8=True, device="cpu")
    j = JI.TpuImpactIndex(Vd, quantize_int8=True, mesh=jax_mesh())
    for index in (sharded, plain, j):
        index.add_batch(ids, docs)
        index.build()
    assert sharded._n_pad == j._n_pad and sharded._n_pad % (128 * 8) == 0
    assert len(sharded._mat) == 8 and sharded.max_docs == 8 * 100_000
    assert sharded.memory_bytes == sharded._n_pad * Vd  # int8 rows
    np.testing.assert_array_equal(
        torch.cat(sharded._mat)[:300].numpy(), plain._mat[:300].numpy())
    for _ in range(3):
        qi = rng.choice(Vd, size=8, replace=False).astype(np.int32)
        qv = np.abs(rng.normal(size=8)).astype(np.float32)
        got = sharded.search_vector(qi, qv, k=5)
        same_results([plain.search_vector(qi, qv, k=5)], [got])
        same_results([j.search_vector(qi, qv, k=5)], [got], tol=2e-2)
        vec = np.zeros(Vd, np.float32)
        vec[qi] = qv
        same_results([plain.search_dense(vec, k=5, query_top_k=4)],
                     [sharded.search_dense(vec, k=5, query_top_k=4)])
        same_results([plain.search_two_phase(qi, qv, k=5)],
                     [sharded.search_two_phase(qi, qv, k=5)])
    # more than there are documents: every document once, no pad row
    full = sharded.search_vector(qi, qv, k=400)
    assert len(full) == len({d for d, _ in full}) <= 300
    # a mesh of one device is no mesh
    one = TI.ImpactIndex(Vd, mesh=make_mesh(devices=["cpu"]))
    assert one.mesh is None and one.device == torch.device("cpu")


# ------------------------------------------------------------- save/load
@pytest.mark.parametrize("kind", ["postings", "tiered", "cluster"])
def test_save_then_load_onto_a_mesh(tmp_path, kind):
    """A mesh index saved and loaded with ``mesh=`` is the same mesh index;
    a single-device archive of the reference loads onto the port's mesh
    and answers as the reference's mesh index."""
    if kind == "cluster":
        d_idx, d_val = hot_concentrated_corpus(n_docs=200)
        docs = list(zip(d_idx, d_val))
        vocab = TC_VOCAB
        kw = dict(cluster_size=16, n_probes=4, query_top_t=8,
                  posting_cap=8, posting_candidates=16)
        j_single, t_mesh_cls, j_mesh_cls = (
            JC.TpuClusterIndex(vocab, **kw), TC.MeshShardedClusterIndex,
            JC.MeshShardedClusterIndex)
        qi, qv = cluster_queries(n=8, d_idx=d_idx, d_val=d_val)
    else:
        docs, vocab = synth_corpus()[:90], V
        kw = dict(n_postings=16, query_top_t=8, approx=False,
                  rescore_candidates=24)
        if kind == "tiered":
            kw.update(hot_terms=8, hot_postings=32, scoring="sort")
            j_single, t_mesh_cls, j_mesh_cls = (
                JT.TieredPostingsIndex(vocab, **kw),
                TT.MeshShardedTieredPostingsIndex,
                JT.MeshShardedTieredPostingsIndex)
        else:
            j_single, t_mesh_cls, j_mesh_cls = (
                JP.TpuPostingsIndex(vocab, **kw), TP.MeshShardedPostingsIndex,
                JP.MeshShardedPostingsIndex)
        qi, qv = synth_queries(b=8)
    t = t_mesh_cls(vocab, mesh8(), **kw)
    j = j_mesh_cls(vocab, jax_mesh(), **{
        a: b for a, b in kw.items() if a != "posting_scoring"})
    fill((t, j, j_single), docs)
    path = tmp_path / f"{kind}.npz"
    t.save(str(path))
    loaded = t_mesh_cls.load(str(path), mesh=mesh8())
    assert type(loaded) is t_mesh_cls and loaded.mesh.size == 8
    assert loaded.config_summary() == t.config_summary()
    for a, b in zip(TP._tensors(loaded.shard_arrays()),
                    TP._tensors(t.shard_arrays())):
        assert torch.equal(a, b)
    same_results(t.search_topk(qi, qv, k=10), loaded.search_topk(qi, qv, k=10))
    ref_path = tmp_path / f"{kind}_ref.npz"
    j_single.save(str(ref_path))
    from_ref = t_mesh_cls.load(str(ref_path), mesh=make_mesh(devices=CPU8))
    same_results(j.search_topk(qi, qv, k=10),
                 from_ref.search_topk(qi, qv, k=10))


# ------------------------------------------------------ each shard's card
class _DeviceRecorder:
    """A stand-in for ``torch.cuda.device``: records each device entered
    and keeps the current one."""

    current = None

    def __init__(self, entered):
        self.entered = entered

    def __call__(self, device):
        recorder = self

        @contextlib.contextmanager
        def ctx():
            before = _DeviceRecorder.current
            recorder.entered.append(torch.device(device))
            _DeviceRecorder.current = torch.device(device)
            try:
                yield
            finally:
                _DeviceRecorder.current = before
        return ctx()


def _claim_cuda(monkeypatch):
    """CPU tensors that claim to live on CUDA devices: a moves to a CUDA
    device keeps the tensor where it is."""
    to = torch.Tensor.to

    def to_cpu(self, *args, **kw):
        dev = kw.pop("device", None)
        if args and isinstance(args[0], (torch.device, str)):
            dev, args = args[0], args[1:]
        if dev is not None and torch.device(dev).type != "cuda":
            return to(self, dev, *args, **kw)
        return to(self, *args, **kw) if args or kw else self

    monkeypatch.setattr(torch.Tensor, "to", to_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


@pytest.mark.parametrize("kind", ["postings", "tiered", "cluster", "dense"])
def test_each_shard_searches_on_its_own_card(monkeypatch, kind):
    """Under a mesh of cuda:0 and cuda:1, every shard's search runs with
    its card current (``torch.cuda.device``), in shard order, and the
    phase-2 rescore of shard d while cuda:d is current."""
    entered, rescored = [], []
    mesh = DeviceMesh((torch.device("cuda:0"), torch.device("cuda:1")))
    _claim_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device", _DeviceRecorder(entered))
    dispatch = TP.dispatch_rescore

    def recording(*args, **kw):
        rescored.append(_DeviceRecorder.current)
        return dispatch(*args, **kw)

    for mod in (TP, TT, TC):
        monkeypatch.setattr(mod, "dispatch_rescore", recording)
    docs = synth_corpus()[:40]
    if kind == "dense":
        index = TI.ImpactIndex(V, quantize_int8=True, mesh=mesh)
    elif kind == "cluster":
        index = TC.MeshShardedClusterIndex(V, mesh, cluster_size=8,
                                           n_probes=2, query_top_t=8)
    elif kind == "tiered":
        index = TT.MeshShardedTieredPostingsIndex(
            V, mesh, n_postings=4, hot_terms=8, hot_postings=32,
            query_top_t=8, rescore_candidates=8)
    else:
        index = TP.MeshShardedPostingsIndex(V, mesh, n_postings=16,
                                            query_top_t=8,
                                            rescore_candidates=8)
    fill((index,), docs)
    entered.clear()
    qi, qv = synth_queries(b=4)
    res = (index.search_batch_dense(np.stack([np.bincount(
        q, weights=w, minlength=V) for q, w in zip(qi, qv)]).astype(
            np.float32), k=5) if kind == "dense"
        else index.search_topk(qi, qv, k=5))
    assert all(r for r in res)
    assert entered == list(mesh.devices)
    if kind != "dense":
        assert rescored == list(mesh.devices)
