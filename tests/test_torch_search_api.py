"""The port's single-query and standalone search API against splade_tpu's on
the same numpy corpus and queries, on the CPU: ``ImpactIndex``'s
``search_batch_dense``, ``search_vector``, ``search_dense`` (with and
without ``query_top_k``) and ``search_two_phase`` against
``TpuImpactIndex``; ``PostingsIndex.search_vector`` against
``TpuPostingsIndex``; ``SparseEncoderV33.encode_for_query`` against the JAX
encoder on the same tiny random weights.

Scores agree within 1e-4 of the largest score: both sides multiply the same
bf16- or int8-valued operands exactly and differ only in the order of f32
sums. Ids are compared exactly where scores are separated by more than that
and as sets within ties, except for the last tied group of a list, which a
top-k may cut anywhere (``lax.top_k`` and ``torch.topk`` order ties
differently: ROADMAP.md §3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.benchmark.encoders import SparseEncoderV33 as JaxEncoder
from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu.ops.impact_index import TpuImpactIndex
from splade_tpu.ops.postings_index import TpuPostingsIndex
from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.ops.impact_index import ImpactIndex
from splade_tpu_torch.ops.postings_index import PostingsIndex

torch.set_num_threads(1)

# a dense corpus over a small vocabulary: a 20-term query overlaps almost
# every document, so scores are distinct and the top lists have no ties
V, N, NNZ = 64, 300, 12
RTOL = 1e-4


def corpus(seed=0, n=N):
    rng = np.random.default_rng(seed)
    idx = [np.sort(rng.choice(V, NNZ, replace=False)).astype(np.int32)
           for _ in range(n)]
    val = [rng.uniform(0.05, 3.0, NNZ).astype(np.float32) for _ in range(n)]
    return [f"d{i}" for i in range(n)], list(zip(idx, val))


def sparse_query(rng, terms=20):
    idx = rng.choice(V, terms, replace=False).astype(np.int32)
    return idx, rng.uniform(0.1, 2.0, terms).astype(np.float32)


def dense(idx, val):
    vec = np.zeros(V, np.float32)
    vec[idx] = val
    return vec


def assert_same_results(want, got, rtol=RTOL):
    """Scores within rtol of the list's largest; ids exact where scores are
    separated, as sets within a tied group; the last group only by count."""
    assert len(got) == len(want)
    ws = np.array([s for _, s in want])
    gs = np.array([s for _, s in got])
    tol = rtol * max(float(np.abs(ws).max(initial=0)), 1e-6)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    start = 0
    while start < len(want):
        end = start + 1
        while end < len(want) and abs(ws[end] - ws[end - 1]) <= tol:
            end += 1
        if end < len(want):
            assert ({d for d, _ in want[start:end]}
                    == {d for d, _ in got[start:end]}), (start, end)
        start = end


def _indexes(dtype, n=N):
    ids, vecs = corpus(n=n)
    int8 = dtype == "int8"
    kw = dict(dtype="float32" if int8 else dtype, quantize_int8=int8)
    ref, port = TpuImpactIndex(V, **kw), ImpactIndex(V, device="cpu", **kw)
    for index in (ref, port):
        index.add_batch(ids, vecs)
        index.build()
    return ref, port


DTYPES = ["int8", "float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [10, 350])  # 350: past the docs, in the padding
def test_search_batch_dense_matches_jax(dtype, k):
    ref, port = _indexes(dtype)
    rng = np.random.default_rng(1)
    queries = np.stack([dense(*sparse_query(rng)) for _ in range(5)])
    queries[3] = 0.0  # a query that matches nothing: every score 0
    want = ref.search_batch_dense(queries, k=k)
    got = port.search_batch_dense(queries, k=k)
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        # padded corpus rows are -inf and dropped: at most N results
        assert len(g) == min(k, N)
        assert_same_results(w, g)
    assert all(s == 0.0 for _, s in got[3])


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_search_vector_matches_jax(dtype):
    ref, port = _indexes(dtype)
    rng = np.random.default_rng(2)
    for _ in range(4):
        idx, val = sparse_query(rng, int(rng.integers(3, 25)))
        want = ref.search_vector(idx, val, k=10)
        got = port.search_vector(idx, val, k=10)
        assert len(got) == 10
        assert_same_results(want, got)
        # the same query as a batch of one dense row
        assert got == port.search_batch_dense(dense(idx, val)[None], 10)[0]


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("query_top_k", [0, 5, 40])  # 40: more than nonzero
def test_search_dense_matches_jax(dtype, query_top_k):
    ref, port = _indexes(dtype)
    rng = np.random.default_rng(3)
    vec = dense(*sparse_query(rng, 30))
    vec[rng.choice(V, 5, replace=False)] *= -1.0  # negatives are never kept
    want = ref.search_dense(vec, k=10, query_top_k=query_top_k)
    got = port.search_dense(vec, k=10, query_top_k=query_top_k)
    assert_same_results(want, got)
    before = vec.copy()
    if query_top_k:
        # the trim keeps the strongest positive weights, on a copy
        top = np.argsort(-vec)[:query_top_k]
        kept = np.where(np.isin(np.arange(V), top) & (vec > 0), vec, 0.0)
        if (vec > 0).sum() > query_top_k:
            assert got == port.search_dense(kept, k=10)
        np.testing.assert_array_equal(vec, before)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("prune_ratio,expansion", [(0.4, 5.0), (0.8, 2.0),
                                                   (0.0, 1.0)])
def test_search_two_phase_matches_jax(dtype, prune_ratio, expansion):
    ref, port = _indexes(dtype)
    rng = np.random.default_rng(4)
    for _ in range(3):
        idx, val = sparse_query(rng)
        want = ref.search_two_phase(idx, val, k=5, prune_ratio=prune_ratio,
                                    expansion=expansion)
        got = port.search_two_phase(idx, val, k=5, prune_ratio=prune_ratio,
                                    expansion=expansion)
        assert len(got) == 5
        assert_same_results(want, got)
        # every result is a full-query score, in full-search order
        full = dict(port.search_vector(idx, val, k=N))
        assert all(abs(full[d] - s) <= 1e-6 * abs(s) for d, s in got)
        assert [s for _, s in got] == sorted((s for _, s in got),
                                             reverse=True)


def test_search_two_phase_edges_match_jax():
    """An empty query gives []; on a corpus smaller than k * expansion the
    candidate count is clamped to it."""
    ref, port = _indexes("int8", n=20)
    empty = np.zeros(0, np.int32), np.zeros(0, np.float32)
    assert port.search_two_phase(*empty) == ref.search_two_phase(*empty) == []
    idx, val = sparse_query(np.random.default_rng(5), 8)
    want = ref.search_two_phase(idx, val, k=10)
    got = port.search_two_phase(idx, val, k=10)
    assert len(got) == len(want) == 10
    assert_same_results(want, got)


@pytest.mark.parametrize("rescore,scoring", [(0, "sort"), (50, "auto")])
def test_postings_search_vector_matches_jax(rescore, scoring):
    ids, vecs = corpus(seed=6)
    kw = dict(n_postings=64, query_top_t=16, rescore_candidates=rescore,
              scoring=scoring)
    ref, port = TpuPostingsIndex(V, **kw), PostingsIndex(V, device="cpu", **kw)
    for index in (ref, port):
        index.add_batch(ids, vecs)
        index.build()
    rng = np.random.default_rng(7)
    for terms in (3, 12, 20):  # 20: more than query_top_t, the strongest kept
        idx, val = sparse_query(rng, terms)
        want = ref.search_vector(idx, val, k=10)
        got = port.search_vector(idx, val, k=10)
        assert len(got) == 10
        assert_same_results(want, got)
        assert got == port.search_topk(idx[None], val[None], k=10)[0]


# ---- the encoder --------------------------------------------------------
VOCAB = 128


class FakeTokenizer:
    pad_token_id = 0
    all_special_ids = [0, 1]

    def __len__(self):
        return VOCAB

    def get_vocab(self):
        return {"[PAD]": 0, "[CLS]": 1, "<mark>": 2}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [ord(c) % (VOCAB - 4) + 3 for c in t if c != " "]
            codes = codes[:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def encoders():
    jcfg = JaxConfig.tiny(num_hidden_layers=2, vocab_size=VOCAB)
    jmodel = JaxSplade(jcfg, pool_impl="streamed")
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), ids,
                                  jnp.ones_like(ids))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params["params"])
    tmodel = SpladeEncoder(
        ModernBertConfig.tiny(num_hidden_layers=2, vocab_size=VOCAB),
        pool_impl="kernel", device="cpu")
    tmodel.mlm.load_state_dict(params_from_jax(params))

    def make(query_top_k):
        kw = dict(query_max_length=16, query_top_k=query_top_k)
        return (JaxEncoder(jmodel, params, FakeTokenizer(), **kw),
                SparseEncoderV33(tmodel, FakeTokenizer(), device="cpu", **kw))

    return make


@pytest.mark.parametrize("query_top_k", [8, 0])  # 0: the whole vector
@pytest.mark.parametrize("text", ["가나다 검색", "문서 7 텍스트", ""])
def test_encode_for_query_matches_jax(encoders, query_top_k, text):
    ref, port = encoders(query_top_k)
    want_idx, want_val = ref.encode_for_query(text)
    got_idx, got_val = port.encode_for_query(text)
    assert got_idx.dtype == np.int32 and got_val.dtype == np.float32
    # an empty text has no valid position: nothing is pooled
    assert len(got_idx) == len(want_idx)
    assert (len(got_idx) > 0) == bool(text)
    if query_top_k:
        assert len(got_idx) <= query_top_k
    # both f32 models: weights agree to the order of f32 sums
    want = dict(zip(want_idx.tolist(), want_val.tolist()))
    got = dict(zip(got_idx.tolist(), got_val.tolist()))
    assert set(got) == set(want)
    np.testing.assert_allclose([got[t] for t in want], list(want.values()),
                               rtol=1e-3, atol=1e-5)
    # the banned tokens (specials and "<"-prefixed markers) never appear
    assert not set(got) & {0, 1, 2}
    # the same vector as a batch of one through encode_queries
    batch_idx, batch_val = port.encode_queries([text])[0]
    np.testing.assert_array_equal(batch_idx, got_idx)
    np.testing.assert_array_equal(batch_val, got_val)
