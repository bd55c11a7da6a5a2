"""chip_smoke.py's own comparisons, on the CPU at a tiny size.

Its served-vs-plain check must pass the port's plain path and fail a
phase-2 rescore with one wrong term (a dropped document slot, a dropped
query term), and its document-encode check must run through the encoder.
On the CPU both sides are plain versions, so the sound reading is the
order difference of f32 sums (about 1e-7 relative)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.ops import postings_index
from splade_tpu_torch.ops.rescore_kernel import rescore_match_plain
from splade_tpu_torch.serving.engine import ServingEngine

ROOT = Path(__file__).resolve().parent.parent
VOCAB = 512


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.V = VOCAB
    return mod


@pytest.fixture(scope="module")
def setup():
    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB)
    model = SpladeEncoder(cfg, pool_impl="kernel",
                          device="cpu").init_weights(0).eval()
    tok = cs.CharTokenizer()
    rng = np.random.default_rng(0)
    terms, vals = cs.zipf_corpus_csr(rng, 3000, nnz=54)
    index = postings_index.PostingsIndex(
        VOCAB, n_postings=128, query_top_t=64, rescore_candidates=200,
        device="cpu")
    index.add_csr([f"syn{i}" for i in range(len(terms))], terms, vals)
    index.build()
    engine = ServingEngine(model, tok, index, query_top_k=64, device="cpu")
    queries = cs.hangul_texts(rng, 8, 6)
    plain = engine.search_batch(queries, k=50)
    return cs, model, tok, engine, queries, plain


def _drop_doc_slot(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    return rescore_match_plain(d_terms[:, :-1], d_vals[:, :-1], d_scale,
                               q_idx, q_val, cand)


def _drop_query_term(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    weakest = (q_val > 0).sum(1) - 1
    q_val = q_val.clone()
    q_val[torch.arange(len(q_val)), weakest] = 0.0
    return rescore_match_plain(d_terms, d_vals, d_scale, q_idx, q_val, cand)


@pytest.mark.parametrize("fault", [None, _drop_doc_slot, _drop_query_term],
                         ids=["sound", "drop_doc_slot", "drop_query_term"])
def test_served_check_catches_a_wrong_rescore(setup, monkeypatch, fault):
    cs, _, _, engine, queries, plain = setup
    monkeypatch.setenv("SPLADE_RESCORE", "match")
    monkeypatch.setattr(postings_index, "rescore_match",
                        fault or rescore_match_plain)
    served = engine.search_batch(queries, k=50)
    if fault is None:
        cs.compare_served("sound", served, plain)
    else:
        with pytest.raises(SystemExit, match="served scores differ"):
            cs.compare_served("faulty", served, plain)


def test_doc_encode_check_runs_through_the_encoder(setup):
    cs, model, tok, _, _, _ = setup
    enc = SparseEncoderV33(model, tok, doc_top_k=32, doc_max_length=64,
                           device="cpu")
    texts = cs.hangul_texts(np.random.default_rng(1), 10, 20)
    assert cs.compare_doc_encode(torch, enc, model, texts) <= cs.SERVE_RTOL
    assert model.pool_impl == "kernel"
