"""chip_smoke.py's own comparisons, on the CPU at a tiny size.

Its served-vs-plain check must pass the port's plain path and fail a
phase-2 rescore with one wrong term (a dropped document slot, a dropped
query term) or one that counts a duplicated query term once, its search_vector check must hold each index's single-query
search against the engine and fail one that loses a query term, and its
document-encode check must run through the encoder.
Its phase-4 kernel-vs-plain training comparison must pass the sound
backward and fail one that drops dbias and one whose recompute misses the
forward's maxima by one ulp, so that no position ties with m and none gets
gradient. On the CPU both sides are plain versions, so the sound reading is
the order difference of f32 sums (about 1e-7 relative). Check (c) of the
backward kernels must count exact ties and fail a recompute that loses or
adds a column's match. Phase 4 as a whole
runs here too, at a tiny size, and its recipe must be
configs/train_v33.yaml's. So does phase 5 (MLM pre-training with its
SIGTERM, resume, from_checkpoint, served engine and the row-blocked pool's
path), whose recipe must be configs/pretrain_mlm.yaml's, and phase 2's
comparisons of both pool families (on the CPU every family runs its plain
versions, so they must pass, and a faulty backward must fail: among them a
row-blocked match pass that drops the last batch row of each row block and
a split dh gather that loses one vocab range's partial). The splash
attention's phase-2 check must pass the plain versions and fail a forward
whose window is off by one, a dq kernel whose delta is lost and a dk/dv
kernel fed a zero or stale delta; phase 6 (both
training paths with attention_impl="splash") runs at a tiny size, its route
comparison must fail a backward that loses dv, and the launch counts it
expects must be the ones the code implies. Phase 8 (the benchmark CLI, the
teacher check, precompute and mining) runs at a tiny size, and fails a run
in which one query failed or the postings row is off by one document, a
teacher that ignores the mask or the RoBERTa position offset, a launch
count short by one and a ranking that differs beyond the index's
rounding. Phase 9 (train -> HF export -> serve through the tiered and
cluster indexes, the server CLI from the export dir) runs at a tiny size
on a 5-layer model (layer 0, one group, one tail layer), and fails an
export that drops the tail layer, a cluster search whose dedup keeps a
duplicate, a rescore launched without the pad row (the block's N one
short, so pad candidates clamp onto the last document) and a cached server
run that serves another kind than its archive's. Phase 10 (the
mesh-sharded postings, tiered, cluster and dense indexes on eight CPU
shards) runs at a tiny size, and fails a merge that forgets the shard
offset, a cluster merge without ``require_positive`` (a pad document comes
back) and a shard search that does not enter its shard's card (on CPU
tensors that claim to be CUDA ones, with a stand-in for
``torch.cuda.device``). Phase 11 (the offline data tier from raw drops
through the pipeline, the miners, IDF, PMI and information gain to a V33
CLI step on the pipeline's shards) runs at a tiny size, and fails a miner
whose rank window is off by one, an information-gain filter that keeps the
planted trivial pairs and an IDF that counts a document twice; at its
committed size the pipeline keeps the rows phase 11's miner needs."""

import dataclasses
import json
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.ops import postings_index
from splade_tpu_torch.ops.rescore_kernel import rescore_match_plain
from splade_tpu_torch.serving.engine import ServingEngine

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

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


def _count_duplicates_once(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    """A rescore that keeps only the first slot of a repeated query term."""
    first = torch.ones_like(q_val, dtype=torch.bool)
    for t in range(1, q_idx.shape[1]):
        first[:, t] = (q_idx[:, :t] != q_idx[:, t:t + 1]).all(1)
    return rescore_match_plain(d_terms, d_vals, d_scale, q_idx,
                               torch.where(first, q_val, 0.0), cand)


def _as_duplicates(rescore):
    """``rescore`` handed the same query with every term in two slots of
    half its weight: served queries hold each term once, so this is how a
    duplicated term reaches phase 2 here."""
    def run(d_terms, d_vals, d_scale, q_idx, q_val, cand):
        return rescore(d_terms, d_vals, d_scale, torch.cat([q_idx, q_idx], 1),
                       torch.cat([q_val / 2, q_val / 2], 1), cand)
    return run


@pytest.mark.parametrize("rescore,sound", [
    (rescore_match_plain, True),
    (_drop_doc_slot, False),
    (_drop_query_term, False),
    (_as_duplicates(rescore_match_plain), True),
    (_as_duplicates(_count_duplicates_once), False),
], ids=["sound", "drop_doc_slot", "drop_query_term",
        "sound_duplicated_terms", "count_duplicated_term_once"])
def test_served_check_catches_a_wrong_rescore(setup, monkeypatch, rescore,
                                              sound):
    """Phase 3's served-vs-plain check passes the plain rescore, also on a
    query whose terms each come twice, and fails a rescore that drops a doc
    slot or a query term, or counts a duplicated query term once."""
    cs, _, _, engine, queries, plain = setup
    monkeypatch.setenv("SPLADE_RESCORE", "match")
    monkeypatch.setattr(postings_index, "rescore_match", rescore)
    served = engine.search_batch(queries, k=50)
    if sound:
        cs.compare_served("sound", served, plain)
    else:
        with pytest.raises(SystemExit, match="served scores differ"):
            cs.compare_served("faulty", served, plain)


def _dense_engine(cs, model, tok):
    from splade_tpu_torch.serving.engine import build_engine_from_docs

    docs = cs.hangul_texts(np.random.default_rng(2), 40, 12)
    return build_engine_from_docs(
        model, tok, [(f"dense{i}", t) for i, t in enumerate(docs)],
        int8=True, doc_top_k=64, index_type="dense", query_top_k=64,
        device="cpu")


@pytest.mark.parametrize("kind", ["postings", "dense"])
@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "drop_strongest_term"])
def test_search_vector_check_holds_the_index_against_the_engine(
        setup, monkeypatch, kind, fault):
    """Phase 3 holds each served index's search_vector, on the vector the
    engine's encoder gives a query, against the engine's search of the text;
    an index search that loses the query's strongest term must fail it."""
    cs, model, tok, engine, queries, _ = setup
    if kind == "dense":
        engine = _dense_engine(cs, model, tok)
    if fault:
        real = engine.index.search_vector
        monkeypatch.setattr(engine.index, "search_vector",
                            lambda idx, val, k=10: real(idx[1:], val[1:], k))
        with pytest.raises(SystemExit, match="differ from the plain path"):
            cs.compare_search_vector("faulty", engine, queries[0])
    else:
        cs.compare_search_vector("sound", engine, queries[0])


def _skip_a_group(monkeypatch):
    """A pool forward that skips a 16-row group holding valid rows: the
    positions 16..31 of every row are dropped before the maxima."""
    from splade_tpu_torch.ops import fused_splade

    def skipping(real):
        def run(h, w, bias, mask):
            mask = mask.clone()
            mask[:, 16:32] = 0
            return real(h, w, bias, mask)
        return run

    for name in ("fused_splade_pool", "fused_splade_maxima"):
        monkeypatch.setattr(fused_splade, name,
                            skipping(getattr(fused_splade, name)))


@pytest.mark.parametrize("fault", [None, _skip_a_group],
                         ids=["sound", "skip_a_group"])
@pytest.mark.parametrize("B,S", [(8, 40), (8, 64)])
def test_pool_check_catches_a_forward_that_skips_a_group(setup, monkeypatch,
                                                         fault, B, S):
    """Phase 2's check_pool on the CPU at a tiny size (S = 40 is ragged for
    the forward's 16-row groups): the wrapper runs the plain version, so
    the sound reading is 0, and the row-blocked family on the same inputs
    agrees bit for bit; a forward that skips a group holding valid rows
    must stop the run."""
    cs, model, tok, _, _, _ = setup
    args = (torch, model, tok, np.random.default_rng(S), B, S)
    kw = dict(device="cpu", timed=False)
    if fault is None:
        out = cs.check_pool(*args, **kw)
        assert out["max_abs_err"] == 0.0
        assert set(out["v2"]) == set(cs.V2_ROW_BLOCKS)
        assert all(x["bitwise_equal_v1"] for x in out["v2"].values())
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="fused pool kernel disagrees"):
        cs.check_pool(*args, v2=False, **kw)


def _collated(cs, tok, rng, n: int, doc_words=(10, 21)):
    """A V33-style batch from the trainer's collator at a tiny size:
    documents of 20-40 positions padded to 40, queries to 16."""
    from splade_tpu_torch.data import TripletCollator

    got = TripletCollator(tok, query_max_length=16, doc_max_length=40)(
        cs.synth_triplets(rng, n, doc_words))
    names = ("input_ids", "attention_mask")
    docs = {k: np.concatenate([got[f"positive_{k}"], got[f"negative_{k}"]])
            for k in names}
    return docs, {k: got[f"query_{k}"] for k in names}


@pytest.mark.parametrize("fault", [None, _skip_a_group],
                         ids=["sound", "skip_a_group"])
def test_pool_check_on_a_collated_batch(setup, monkeypatch, fault):
    """check_pool on a batch the trainer's collator made, taken as it is
    (no random cut, no padded row forced): the sound reading is 0 with the
    batch's valid and live-group shares reported; a forward that skips a
    group holding valid rows still stops the run."""
    cs, model, tok, _, _, _ = setup
    docs, _ = _collated(cs, tok, np.random.default_rng(3), 4)
    kw = dict(v2=False, device="cpu", timed=False, enc=docs)
    args = (torch, model, tok, None, 8, 40)
    if fault is None:
        out = cs.check_pool(*args, **kw)
        mask = torch.from_numpy(docs["attention_mask"]).float()
        assert out["max_abs_err"] == 0.0
        assert out["valid_share"] == float(mask.mean())
        assert out["live_group_share"] == cs.live_group_share(torch, mask)
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="fused pool kernel disagrees"):
        cs.check_pool(*args, **kw)


def test_pool_check_refuses_a_batch_of_another_shape(setup):
    cs, model, tok, _, _, _ = setup
    docs, _ = _collated(cs, tok, np.random.default_rng(3), 4)
    with pytest.raises(SystemExit, match="a batch of"):
        cs.check_pool(torch, model, tok, None, 8, 64, v2=False,
                      device="cpu", timed=False, enc=docs)


@pytest.mark.parametrize("case", ["prefix", "holes", "padded_row", "ragged",
                                  "empty"])
def test_live_group_share_counts_groups_holding_a_valid_position(case):
    """The share of 16-position groups of a mask that hold a valid position,
    against a count by hand: right-padded rows, holes, an all-padded row, S
    not a multiple of 16 (the last group is short) and an empty batch."""
    cs = _load_chip_smoke()
    if case == "empty":
        assert cs.live_group_share(torch, torch.zeros(0, 40)) == 0.0
        return
    S = 40 if case == "ragged" else 64
    mask = torch.zeros(4, S)
    mask[0, :17] = 1          # groups 0 and 1
    mask[1, :S] = 1           # every group
    if case == "holes":
        mask[2, 5] = mask[2, 50] = 1    # groups 0 and 3
    if case == "padded_row":
        mask[3] = 0
    if case == "ragged":
        mask[2, 39] = 1       # the short last group (positions 32..39)
    groups = -(-S // 16)
    live = {"prefix": 2 + groups, "holes": 2 + groups + 2,
            "padded_row": 2 + groups, "ragged": 2 + groups + 1}[case]
    assert cs.live_group_share(torch, mask) == live / (4 * groups)


def test_tokenizer_counts_the_valid_share_of_its_padded_batches():
    """CharTokenizer.fill tallies, by max_length, the valid positions of
    the padded batches it makes (what the encoders and the collator hand
    the pool forward); unpadded calls count nothing; clearing starts over."""
    cs = _load_chip_smoke()
    tok = cs.CharTokenizer()
    a = tok(["ab c", "", "abcdefgh"], max_length=4)
    b = tok(["abc"], max_length=8)
    tok(["abc"], add_special_tokens=False)
    assert tok.fill == {4: [int(a["attention_mask"].sum()), 12],
                        8: [int(b["attention_mask"].sum()), 8]}
    assert tok.valid_share() == {4: 7 / 12, 8: 3 / 8}
    tok.fill.clear()
    assert tok.valid_share() == {}


def test_v33_pool_batches_are_the_collators_micro_batch():
    """Phase 2's training-shape pool check runs on what the V33 trainer's
    collator builds from phase 4's kind of triplets: documents (positives,
    then negatives) at TRAIN_POOL_SHAPES[0], queries at [1]."""
    from splade_tpu_torch.data import TripletCollator

    cs = _load_chip_smoke()
    tok = cs.CharTokenizer()
    got = cs.v33_pool_batches(tok, np.random.default_rng(7))
    assert set(got) == set(cs.TRAIN_POOL_SHAPES)
    data = cs.v33_recipe()["data"]
    ref = TripletCollator(tok, query_max_length=data["query_max_length"],
                          doc_max_length=data["doc_max_length"])(
        cs.synth_triplets(np.random.default_rng(7), data["batch_size"]))
    docs, queries = (got[shape] for shape in cs.TRAIN_POOL_SHAPES)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(
            docs[k], np.concatenate([ref[f"positive_{k}"],
                                     ref[f"negative_{k}"]]))
        np.testing.assert_array_equal(queries[k], ref[f"query_{k}"])
    # documents of 100-128 two-syllable words fill most of 256 positions
    assert 0.75 < docs["attention_mask"].mean() < 1.0


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_forward_kernels", ROOT / "scripts" / "bench_forward_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("where,ok", [("build/parent", True),
                                      ("build/a/b", True),
                                      ("build", False), ("..", False),
                                      ("splade_tpu_torch", False)])
def test_bench_takes_a_parent_only_under_build(where, ok):
    """scripts/bench_forward_kernels.py builds the parent checkout's kernels
    inside it, so it takes only a directory under this checkout's build/."""
    bench = _load_bench()
    if ok:
        assert bench.parent_checkout(ROOT / where) == (ROOT / where).resolve()
    else:
        with pytest.raises(SystemExit, match="is not under"):
            bench.parent_checkout(ROOT / where)


def test_every_c_entry_has_a_signature_and_every_signature_an_entry():
    """The C entries of csrc/*.cu (the measurement entry that numbers the
    pool forward's blocks batch range first among them) are exactly the
    names _cuda.SIGNATURES gives argument types."""
    import re

    from splade_tpu_torch.ops import _cuda

    found = set()
    for src in _cuda.sources():
        found |= set(re.findall(r'extern "C" int\s+(\w+)\(',
                                src.read_text()))
    assert "splade_fused_pool_fwd_batch_first" in found
    assert found == set(_cuda.SIGNATURES)


PTXAS_SAMPLE = """== fused_splade_fwd.cu
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__873ffd15_19_fused_splade_fwd_cu_9202b51223fused_splade_fwd_kernelEPK13__nv_bfloat16S2_PKfS4_PfPiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__873ffd15_19_fused_splade_fwd_cu_9202b51223fused_splade_fwd_kernelEPK13__nv_bfloat16S2_PKfS4_PfPiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 220 registers, used 1 barriers, 128 bytes smem
== fused_splade_v2_bwd.cu
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__2a80c9ae_22_fused_splade_v2_bwd_cu_c49c2fea32fused_splade_v2_bwd_match_kernelEPK13__nv_bfloat16S2_PKfS4_S4_S4_Ptiiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 210 registers, used 1 barriers, 128 bytes smem
== rescore.cu
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5d1e2a9b_10_rescore_cu_0c7f3e2114rescore_kernelILb0EEEvPKiPKaPKfS2_S6_S2_Pfiiiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 14336 bytes smem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5d1e2a9b_10_rescore_cu_0c7f3e2114rescore_kernelILb1EEEvPKiPKaPKfS2_S6_S2_Pfiiiiii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 14336 bytes smem
== splash_attention_bwd.cu
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__e2_23_splash_attention_bwd_cu_3c20splash_bwd_dq_kernelIfEEvPK13__nv_bfloat16' for 'sm_90a'
    8 bytes stack frame, 68 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__e2_23_splash_attention_bwd_cu_3c20splash_bwd_dq_kernelI13__nv_bfloat16EEvPK' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers
== splash_attention_fwd.cu
ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__efbc3fac_23_splash_attention_fwd_cu_aad4cf4b17splash_fwd_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_PfN6splash7StridesES8_S8_iiif' for 'sm_90a'
    56 bytes stack frame, 64 bytes spill stores, 104 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 56 bytes cumulative stack size
"""


def test_ptxas_summary_reads_each_kernels_report():
    """Phase 1 spells out the redesigned kernels' registers, static shared
    memory and spills from the build log, one entry per compiled instance
    (a template's instances under one name)."""
    cs = _load_chip_smoke()
    got = cs.ptxas_summary(PTXAS_SAMPLE)
    assert set(got) == {"fused_splade_fwd_kernel", "splash_bwd_dq_kernel",
                        "splash_fwd_kernel", "fused_splade_v2_bwd_match_kernel",
                        "rescore_kernel"}
    assert [(r["registers"], r["static_smem_bytes"])
            for r in got["rescore_kernel"]] == [(38, 14336), (72, 14336)]
    assert got["fused_splade_v2_bwd_match_kernel"] == [dict(
        stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
        registers=210, static_smem_bytes=128)]
    assert got["fused_splade_fwd_kernel"] == [dict(
        stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
        registers=220, static_smem_bytes=128)]
    assert [r["registers"] for r in got["splash_bwd_dq_kernel"]] == [168, 166]
    assert got["splash_bwd_dq_kernel"][0]["spill_store_bytes"] == 68
    fwd = got["splash_fwd_kernel"][0]
    assert (fwd["registers"], fwd["spill_store_bytes"],
            fwd["spill_load_bytes"], fwd["static_smem_bytes"]) == (
                128, 64, 104, 0)
    assert set(cs.REDESIGNED) <= set(got)


def test_doc_encode_check_runs_through_the_encoder(setup):
    cs, model, tok, _, _, _ = setup
    enc = SparseEncoderV33(model, tok, doc_top_k=32, doc_max_length=64,
                           device="cpu")
    texts = cs.hangul_texts(np.random.default_rng(1), 10, 20)
    assert cs.compare_doc_encode(torch, enc, model, texts) <= cs.SERVE_RTOL
    assert model.pool_impl == "kernel"


def _recompute_case(B=4):
    """Model-like bf16 values; in row 0 position 3 repeats position 1, so
    every column whose maximum is at position 1 has an exact tie and sends
    its W row there twice. Row 2 is fully padded."""
    g = torch.Generator().manual_seed(0)
    S, H, V = 24, 768, 3000
    h = torch.randn(B, S, H, generator=g).to(torch.bfloat16)
    h[0, 3] = h[0, 1]
    w = (torch.randn(V, H, generator=g) * 0.05).to(torch.bfloat16)
    bias = torch.randn(V, generator=g) * 0.1
    mask = torch.ones(B, S, dtype=torch.int64)
    mask[1, 17:] = 0
    mask[2] = 0
    return h, w, bias, mask


def _lose_columns(m):
    """a recompute that misses the maxima of every 97th column of row 1"""
    m = m.clone()
    m[1, ::97] = torch.nextafter(m[1, ::97], torch.tensor(np.inf))
    return m


def _add_a_row(dh, w):
    dh[1, 0] += w[5].float()  # a match where no score reaches m


@pytest.mark.parametrize("fault", [None, _lose_columns, _add_a_row],
                         ids=["sound", "lose_columns", "add_a_row"])
def test_recompute_check_counts_ties_and_catches_a_miss(fault):
    """Check (c) of the backward kernels passes the plain backward, with
    row 0's exact ties counted, and fails a recompute that loses a few
    columns' maxima or adds a W row no tie explains."""
    from splade_tpu_torch.ops.fused_splade import (fused_splade_bwd_dh,
                                                   fused_splade_maxima)

    cs = _load_chip_smoke()
    h, w, bias, mask = _recompute_case()
    m, _ = fused_splade_maxima(h, w, bias, mask)
    m_bwd = _lose_columns(m) if fault is _lose_columns else m
    ones = (mask.sum(1, keepdim=True) > 0).float().expand_as(m)
    dh = fused_splade_bwd_dh(h, w, bias, mask, m_bwd, ones)
    if fault is _add_a_row:
        _add_a_row(dh, w)
    out = cs.recompute_check(torch, h, w, bias, mask, m, dh)
    if fault is not None:
        assert not out["ok"], out
        return
    assert out["ok"], out
    assert out["rows"] == 3 and out["tied_rows"] == 1
    best = (h[0].float() @ w.float().T + bias).argmax(0)  # first of a tie
    assert out["ties"] == int((best == 1).sum()) > 10
    assert out["worst"] <= 1e-5 < out["worst_before_ties"]


def _drop_columns(match):
    """a match pass that loses the maxima of row 1's first 50 columns"""
    match = match.clone()
    match[1, :, :50] = 0
    return match


def _stray_bit(match):
    """a match pass that sets a bit on a padded position (row 2, the last)"""
    match = match.clone()
    match[2, 0, 5] |= 1
    return match


@pytest.mark.parametrize("fault", [None, _drop_columns, _stray_bit],
                         ids=["sound", "drop_columns", "stray_bit"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "model"])
def test_match_check_holds_the_bitmask(monkeypatch, fault, exact):
    """Phase 2's check of the match pass alone passes the plain bitmask
    (every maximum found, no stray bit, bitwise the plain one on exact
    inputs, bitwise the row-blocked wrapper's at row_block 1 and at B) and
    fails one that loses a column's maximum or sets a bit on a padded
    position."""
    from splade_tpu_torch.ops import fused_splade

    cs = _load_chip_smoke()
    h, w, bias, mask = _recompute_case()
    if exact:  # small integers: every score exact in f32 in any order
        h, w = h.float().round(), (w.float() * 40).round()
    m, _ = fused_splade.fused_splade_maxima(h, w, bias, mask)
    g_pre = fused_splade.fold_cotangent(torch.ones_like(m), m)
    if fault is not None:
        real = fused_splade.fused_splade_bwd_match
        monkeypatch.setattr(fused_splade, "fused_splade_bwd_match",
                            lambda *a: fault(real(*a)))
    out = cs.match_check(torch, h, w, bias, mask, m, g_pre, exact)
    assert out["ok"] == (fault is None), out
    assert out["columns"] == int(((g_pre != 0)
                                  & (mask.sum(1, keepdim=True) > 0)).sum())
    # B = 4: 8 does not divide it, so the whole batch is the larger block
    assert set(out["bits_differing_from"]) == {"rb=1", "rb=4"}
    if fault is None:
        assert out["stray"] == 0 and out["found"]
        assert out.get("bits_differing", 0) == 0
        assert not any(out["bits_differing_from"].values())
        assert out["ties"] > 0  # row 0's repeated position: every tie kept
    else:
        assert all(out["bits_differing_from"].values())


def test_recipe_is_configs_train_v33_yaml():
    from splade_tpu_torch.config import V33Config, load_config

    cs = _load_chip_smoke()
    recipe = cs.v33_recipe()
    assert recipe == yaml.safe_load((ROOT / "configs" /
                                     "train_v33.yaml").read_text())
    assert (V33Config.from_dict(recipe).to_dict()
            == load_config(str(ROOT / "configs" / "train_v33.yaml")).to_dict())


def _tiny_recipe(cs):
    recipe = cs.v33_recipe()
    recipe["model"]["dtype"] = "float32"
    recipe["data"].update(batch_size=4, query_max_length=8,
                          doc_max_length=32)
    recipe["training"]["gradient_accumulation_steps"] = 2
    return recipe


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Phase 4 end to end on the CPU: tiny model, 4 triplets x accum 2."""
    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB,
                              remat=True)
    out = cs.train_phase(torch, cs.CharTokenizer(), np.random.default_rng(0),
                         tmp_path_factory.mktemp("train") / "w", 0,
                         _tiny_recipe(cs), cfg, steps=3, device="cpu",
                         doc_words=(6, 17))
    return cs, cfg, out


def test_train_phase_runs_on_the_cpu(trained):
    _, _, out = trained
    assert [r["step"] for r in out["steps"]] == [1, 2, 3, 4]  # 1: warm-up
    assert all(np.isfinite(r["loss"]) for r in out["steps"])
    assert out["resume"]["bitwise"] and out["resume"]["step"] == 5
    # the schedule spans the recipe's 25 epochs of 6 steps, warm-up 9: the
    # resumed step (the fifth update) runs at 4/9 of the peak rate and
    # moves the parameters, so a lost AdamW moment would show
    assert out["resume"]["total_steps"] == 150
    assert out["resume"]["lr"] == pytest.approx(5e-5 * 4 / 9, rel=1e-12)
    assert out["resume"]["step_moved_params"] > 0
    assert out["plain_route"]["loss_rel_err"] <= 1e-5
    assert out["launches"] == dict.fromkeys(
        ("fused_splade_pool", "fused_splade_bwd_match", "fused_splade_bwd_dh",
         "fused_splade_bwd_dw", "splash_attention", "splash_attention_bwd_dq",
         "splash_attention_bwd_dkv", "rope_qkv_fwd", "rope_qkv_bwd",
         "add_layernorm_fwd", "add_layernorm_bwd", "rescore_match"),
        0)  # plain versions
    assert out["triplets"] == 4 * 2 * 6


def _micro_and_model(cs, cfg):
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator
    from splade_tpu_torch.train.trainer import stack_microbatches

    recipe = _tiny_recipe(cs)
    vcfg = V33Config.from_dict(recipe)
    col = TripletCollator(cs.CharTokenizer(), query_max_length=8,
                          doc_max_length=32)
    rows = cs.synth_triplets(np.random.default_rng(5), 4, (6, 17))
    micro = {k: torch.from_numpy(v[0]) for k, v in
             stack_microbatches([col(rows)]).items()}
    model = SpladeEncoder(cfg, pool_impl="kernel", with_token_weights=False,
                          device="cpu").init_weights(3)
    with torch.no_grad():  # a decoder bias whose gradient path shows
        model.mlm.decoder.bias.normal_(0, 0.3,
                                       generator=torch.Generator().manual_seed(1))
    return vcfg, micro, model


def _drop_dbias(monkeypatch):
    from splade_tpu_torch.models import splade

    real = splade.fused_splade_pool
    monkeypatch.setattr(splade, "fused_splade_pool",
                        lambda h, w, b, m: real(h, w, b.detach(), m))


def _miss_the_maxima(monkeypatch):
    from splade_tpu_torch.ops import fused_splade

    real = fused_splade.fused_splade_bwd_plain
    monkeypatch.setattr(
        fused_splade, "fused_splade_bwd_plain",
        lambda h, w, b, mask, m, g: real(
            h, w, b, mask, torch.nextafter(m, torch.full_like(m, np.inf)), g))


@pytest.mark.parametrize("fault", [None, _drop_dbias, _miss_the_maxima],
                         ids=["sound", "drop_dbias", "no_grad_at_ties"])
def test_training_check_catches_a_wrong_backward(trained, monkeypatch, fault):
    cs, cfg, _ = trained
    vcfg, micro, model = _micro_and_model(cs, cfg)
    if fault is None:
        out = cs.compare_train_routes(torch, model, vcfg, micro, 7)
        assert out["worst_tensor_rel_err"] <= 1e-4
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="differ from the plain route"):
        cs.compare_train_routes(torch, model, vcfg, micro, 7)


# ---- phase 2's row-blocked checks and phase 5, on the CPU ------------------
def _family_case():
    g = torch.Generator().manual_seed(2)
    B, S, H, V = 8, 12, 64, 300
    ints = lambda *shape: torch.randint(-2, 3, shape, generator=g).float()
    mask = (torch.arange(S)[None] < torch.tensor(
        [12, 3, 7, 12, 1, 9, 5, 0])[:, None]).long()
    return (ints(B, S, H), ints(V, H), ints(V), mask,
            torch.randn(B, V, generator=g))


@pytest.mark.parametrize("family", ["v1", "v2 rb=8", "v2 rb=2"])
def test_pool_family_checks_run_on_the_cpu(family):
    """Checks (a) and (c) of phase 2 for each kernel family chip_smoke.py
    holds (the per-row one and the row-blocked one at both row_block
    values): exact inputs agree with the plain route within BWD_EXACT_RTOL,
    and the family's dh, fed to recompute_check, reaches the forward's
    maxima in every valid row."""
    from splade_tpu_torch.ops.fused_splade import fused_splade_maxima

    cs = _load_chip_smoke()
    fam = cs.pool_families(8)[family]
    assert set(cs.pool_families(8)) == {"v1"} | {
        f"v2 rb={rb}" for rb in cs.V2_ROW_BLOCKS}
    h, w, bias, mask, gout = _family_case()
    got = cs._kernel_route(torch, fam["pool"], h, w, bias, mask, gout)
    want = cs._plain_route(torch, h, w, bias, mask, gout)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= cs.BWD_EXACT_RTOL * float(
            r.abs().max())
    assert float(got[0][-1].abs().max()) == 0.0  # the fully padded row
    again = cs._kernel_route(torch, fam["pool"], h, w, bias, mask, gout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    hb, wb, bb, mb = _recompute_case(B=8)
    m, _ = fused_splade_maxima(hb, wb, bb, mb)
    ones = (mb.sum(1, keepdim=True) > 0).float().expand_as(m)
    out = cs.recompute_check(torch, hb, wb, bb, mb, m,
                             fam["dh"](hb, wb, bb, mb, m, ones))
    assert out["ok"] and out["tied_rows"] == 1, out
    lost = cs.recompute_check(torch, hb, wb, bb, mb, m,
                              fam["dh"](hb, wb, bb, mb, _lose_columns(m),
                                        ones))
    assert not lost["ok"]


def _odd_batch_case(S=40, H=64, V=300):
    """chip_smoke.BWD_ODD's batch at a small width: small integers (exact
    scores, many ties), a ragged last bitmask word, holes in row 0 and a
    fully padded last row."""
    g = torch.Generator().manual_seed(4)
    B = 3
    ints = lambda *shape: torch.randint(-2, 3, shape, generator=g).float()
    mask = (torch.arange(S)[None] < torch.tensor([S, 23, 0])[:, None]).long()
    mask[0, 1::5] = 0
    return (ints(B, S, H), ints(V, H), ints(V), mask,
            torch.randn(B, V, generator=g))


def _drop_row_zero(match):
    """a match pass that loses every bit of batch row 0"""
    match = match.clone()
    match[0] = 0
    return match


@pytest.mark.parametrize("fault", [None, "drop_row_zero"])
def test_pool_family_checks_at_the_odd_batch(monkeypatch, fault):
    """Phase 2's B=3 S=40 shape (BWD_ODD) on the CPU: only the per-row
    family runs there (8 and 2 do not divide 3) and its match pass routes
    to row_block 1. Checks (a) and (c) pass, and the match pass alone
    equals the plain bitmask and the row-blocked wrapper's at row_block 1
    and 3; a match pass that loses a batch row fails it."""
    from splade_tpu_torch.ops import fused_splade

    cs = _load_chip_smoke()
    B, S = cs.BWD_ODD
    assert set(cs.pool_families(B)) == {"v1"}
    h, w, bias, mask, gout = _odd_batch_case(S)
    assert h.shape[:2] == (B, S)
    assert fused_splade.routed_row_block(h) == 1
    fam = cs.pool_families(B)["v1"]
    got = cs._kernel_route(torch, fam["pool"], h, w, bias, mask, gout)
    want = cs._plain_route(torch, h, w, bias, mask, gout)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= cs.BWD_EXACT_RTOL * float(
            r.abs().max())
    assert float(got[0][-1].abs().max()) == 0.0  # the fully padded row
    m, _ = fused_splade.fused_splade_maxima(h, w, bias, mask)
    ones = (mask.sum(1, keepdim=True) > 0).float().expand_as(m)
    rc = cs.recompute_check(torch, h, w, bias, mask, m,
                            fam["dh"](h, w, bias, mask, m, ones))
    assert rc["ok"] and rc["ties"] > 0, rc
    if fault:
        real = fused_splade.fused_splade_bwd_match
        monkeypatch.setattr(fused_splade, "fused_splade_bwd_match",
                            lambda *a: _drop_row_zero(real(*a)))
    g_pre = fused_splade.fold_cotangent(gout, m)
    out = cs.match_check(torch, h, w, bias, mask, m, g_pre, True)
    assert set(out["bits_differing_from"]) == {"rb=1", "rb=3"}
    assert out["ok"] == (fault is None), out
    if fault:
        assert out["bits_differing"] > 0 and not out["found"]


def _drop_each_blocks_last_row(match, rb):
    """a row-blocked match pass that loses the last batch row of each row
    block"""
    match = match.clone()
    match[rb - 1::rb] = 0
    return match


def _split_backward(lose_a_partial):
    """The row-blocked backward as its kernels compose it, in plain PyTorch:
    the match pass, then the dh gather over its vocab ranges (all of them,
    or all but the last) and the dW gather."""
    from splade_tpu_torch.ops import fused_splade as fs
    from splade_tpu_torch.ops import fused_splade_v2 as v2

    def backward(h, w, bias, mask, m, g_pre, row_block=0):
        match = v2.fused_splade_bwd_match_v2_plain(h, w, bias, mask, m, g_pre,
                                                   row_block)
        S, V = h.shape[1], w.shape[0]
        splits = fs.dh_vocab_splits_v2(h.shape[0], S, V)
        parts = [fs.fused_splade_gather_dh_plain(
            match[:, :, vb:ve], w[vb:ve], g_pre[:, vb:ve], S)
            for vb, ve in fs.vocab_ranges(V, splits)]
        assert len(parts) > 1  # a split to lose
        dh = sum(parts[:-1] if lose_a_partial else parts)
        return dh, fs.fused_splade_gather_dw_plain(match, h, g_pre)
    return backward


@pytest.mark.parametrize("fault", [None, "drop_rows", "lose_a_partial"])
@pytest.mark.parametrize("rb", [8, 2])
def test_pool_family_checks_catch_a_faulty_row_blocked_backward(
        monkeypatch, fault, rb):
    """Phase 2's checks of the row-blocked backward pass its match pass and
    its split dh composed as the kernels compose them, and fail a match
    pass that drops the last batch row of each row block (its bitmask
    against the per-row one and every maximum found) and a dh that loses
    one vocab range's partial (checks (a) and (c))."""
    from splade_tpu_torch.ops import fused_splade, fused_splade_v2

    cs = _load_chip_smoke()
    assert rb in cs.V2_ROW_BLOCKS
    fam = cs.pool_families(8)[f"v2 rb={rb}"]
    monkeypatch.setattr(fused_splade_v2, "fused_splade_bwd_v2_plain",
                        _split_backward(fault == "lose_a_partial"))
    if fault == "drop_rows":
        real = fused_splade_v2.fused_splade_bwd_match_v2
        monkeypatch.setattr(
            fused_splade_v2, "fused_splade_bwd_match_v2",
            lambda *a: _drop_each_blocks_last_row(real(*a), a[-1]))
    h, w, bias, mask = _recompute_case(B=8)
    hx, wx = h.float().round(), (w.float() * 40).round()  # exact scores
    for inputs, exact in (((hx, wx, bias), True), ((h, w, bias), False)):
        m, _ = fused_splade.fused_splade_maxima(*inputs, mask)
        g_pre = fused_splade.fold_cotangent(torch.ones_like(m), m)
        out = cs.match_check(torch, *inputs, mask, m, g_pre, exact, rb)
        assert out["ok"] == (fault != "drop_rows"), out
        if fault == "drop_rows":
            assert (out["bits_differing_from"]["per_row"] > 0
                    and not out["found"])
    h, w, bias, mask, gout = _family_case()
    got = cs._kernel_route(torch, fam["pool"], h, w, bias, mask, gout)
    want = cs._plain_route(torch, h, w, bias, mask, gout)
    err = float((got[0] - want[0]).abs().max()) / float(want[0].abs().max())
    assert (err <= cs.BWD_EXACT_RTOL) == (fault != "lose_a_partial"), err
    hb, wb, bb, mb = _recompute_case(B=8)
    m, _ = fused_splade.fused_splade_maxima(hb, wb, bb, mb)
    ones = (mb.sum(1, keepdim=True) > 0).float().expand_as(m)
    rc = cs.recompute_check(torch, hb, wb, bb, mb, m,
                            fam["dh"](hb, wb, bb, mb, m, ones))
    assert rc["ok"] == (fault != "lose_a_partial"), rc


def test_mlm_recipe_is_configs_pretrain_mlm_yaml():
    from splade_tpu_torch.train.mlm import MLMConfig

    cs = _load_chip_smoke()
    path = ROOT / "configs" / "pretrain_mlm.yaml"
    assert cs.mlm_recipe() == yaml.safe_load(path.read_text())
    assert (MLMConfig(**cs.mlm_recipe()).to_dict()
            == MLMConfig.load(str(path)).to_dict())


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Phase 5 end to end on the CPU: a tiny model, rows of 32 tokens,
    2 rows x accum 2 a step, f32."""
    import signal

    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB)
    recipe = dict(cs.mlm_recipe(), max_length=32, batch_size=2, grad_accum=2,
                  dtype="float32")
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    out = cs.mlm_phase(torch, cs.CharTokenizer(), np.random.default_rng(0),
                       tmp_path_factory.mktemp("mlm") / "w", 0, recipe, cfg,
                       steps=3, device="cpu", n_sentences=400,
                       sentence_words=(6, 12), v2_shapes=((4, 16), (2, 8)),
                       checkpoint_config=cfg)
    after = {s: signal.getsignal(s) for s in before}
    return out, before == after


def test_mlm_phase_runs_on_the_cpu(pretrained):
    out, handlers_back = pretrained
    assert handlers_back and out["preemption"]["handlers_restored"]
    pre = out["preemption"]
    assert pre["preempted"] and pre["stopped_at_step"] >= 4
    assert pre["checkpoint"] == f"checkpoint_epoch1_step{pre['stopped_at_step']}"
    assert not pre["watchdog_tripped"] and pre["watchdog_beats"] >= 4
    assert [r["step"] for r in out["steps"]] == list(
        range(1, pre["stopped_at_step"] + 1))
    assert all(np.isfinite(r["loss"]) for r in out["steps"])
    assert out["tokens_per_step"] == 2 * 2 * 32
    # P = round(0.15 * 30) = 4 or 5 picks a row, all rows full
    assert out["steps"][0]["masked_per_row"] == pytest.approx(4.0, abs=1e-3)
    assert out["resume"]["bitwise"] and out["resume"]["lr"] > 0
    assert out["resume"]["step"] == pre["stopped_at_step"] + 1
    assert set(out["evaluation"]) == {"mlm_loss", "mlm_acc", "perplexity"}
    assert out["from_checkpoint_max_rel_diff"] == 0.0
    assert out["served"]["requests"] == 16


def test_v2_path_runs_on_the_cpu_and_counts_no_launch(pretrained):
    out, _ = pretrained
    v2 = out["v2_path"]
    assert v2["launches"] == {"fused_splade_pool_v2": 0,
                              "fused_splade_bwd_match_v2": 0,
                              "fused_splade_bwd_dh_v2": 0,
                              "fused_splade_bwd_dw_v2": 0}  # plain on the CPU
    assert v2["backward_on_its_batches"] == []  # timed on the card only
    assert v2["loss"] > 0 and v2["grad_norm"] > 0
    assert v2["loss_rel_err"] <= 1e-5 and v2["worst_tensor_rel_err"] <= 1e-4


def test_v2_path_catches_a_backward_that_drops_dbias(monkeypatch):
    """The row-blocked route is held against the per-row family's: a
    backward that loses the bias gradient must stop the run."""
    import contextlib

    from splade_tpu_torch.ops import fused_splade_v2

    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB)
    model = SpladeEncoder(cfg, device="cpu").init_weights(1).mlm
    with torch.no_grad():
        model.decoder.bias.normal_(0, 0.3,
                                   generator=torch.Generator().manual_seed(1))
    args = (torch, model, cs.CharTokenizer(), np.random.default_rng(0),
            contextlib.nullcontext, ((4, 16),))
    assert cs.v2_path(*args)["worst_tensor_rel_err"] <= 1e-4
    real = fused_splade_v2.fused_splade_pool_v2
    monkeypatch.setattr(fused_splade_v2, "fused_splade_pool_v2",
                        lambda h, w, b, m, rb=0: real(h, w, b.detach(), m, rb))
    with pytest.raises(SystemExit, match="differs from the per-row"):
        cs.v2_path(*args)


def test_port_kernel_times_are_summed_by_function_name():
    """The profile keeps the port's own kernels whatever their rank: spans
    are summed by kernel function, library kernels are left out."""
    cs = _load_chip_smoke()
    spans = [(0, 1500, "(anonymous namespace)::fused_splade_bwd_dh_kernel("
                       "unsigned int const*, int)"),
             (2000, 2500, "(anonymous namespace)::fused_splade_bwd_dh_kernel("
                          "unsigned int const*, int)"),
             (3000, 3100, "void at::native::elementwise_kernel<128, 4>()"),
             (4000, 4250, "(anonymous namespace)::splash_fwd_kernel(bf16)")]
    assert cs.port_kernels_ms(spans) == {"fused_splade_bwd_dh_kernel": 2.0,
                                         "splash_fwd_kernel": 0.25}
    assert set(cs.POOL_BACKWARD) <= {
        "fused_splade_v2_bwd_match_kernel", "fused_splade_bwd_dh_kernel",
        "fused_splade_bwd_dw_kernel"}


def test_profile_summary_adds_kernels_that_share_a_cut_name():
    """Device busy time is the union of the spans, and two kernels whose
    names agree in their first 60 characters are added together (an
    earlier version kept only the last of them and listed the top kernels
    out of order)."""
    from splade_tpu_torch.utils.profiling import summarize_spans

    long_a = "void at::native::vectorized_elementwise_kernel<4, " + "x" * 40
    long_b = long_a[:60] + "_another_instance"
    spans = [(0.0, 10.0, "gemm"), (5.0, 12.0, long_a), (20.0, 50.0, long_b),
             (50.0, 51.0, "tiny")]
    busy, top = summarize_spans(spans, n_top=2)
    assert busy == 12.0 + 31.0
    assert list(top.items()) == [(long_a[:60], 0.037), ("gemm", 0.010)]


# ---- the splash attention: phase 2's check and phase 6, on the CPU ----------
def _window_off_by_one(monkeypatch):
    from splade_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_forward
    monkeypatch.setattr(
        sa, "splash_attention_forward",
        lambda q, k, v, seg, hw: real(q, k, v, seg, hw + 1))


def _drop_delta(monkeypatch):
    """A dq kernel whose delta route is lost: it reads zeros for out, so the
    delta it uses and hands on is 0."""
    from splade_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_bwd_dq
    monkeypatch.setattr(
        sa, "splash_attention_bwd_dq",
        lambda q, k, v, seg, hw, d_out, out, *a: real(
            q, k, v, seg, hw, d_out, torch.zeros_like(out), *a))


def _stale_delta_to_dkv(monkeypatch, stale=lambda d: torch.zeros_like(d)):
    """A dk/dv kernel fed a zero delta instead of the dq kernel's."""
    from splade_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_bwd_dkv
    monkeypatch.setattr(
        sa, "splash_attention_bwd_dkv",
        lambda q, k, v, seg, hw, d_out, lse, delta, *a: real(
            q, k, v, seg, hw, d_out, lse, stale(delta), *a))


def _other_rows_delta_to_dkv(monkeypatch):
    """... or the delta of the wrong rows (a stale buffer of another step)."""
    _stale_delta_to_dkv(monkeypatch, lambda d: d.roll(1, dims=-1))


def _forward_without_alpha(monkeypatch):
    """A forward that drops the online softmax's rescale: the running sum
    and output keep the scale of the tiles before a new maximum."""
    from splade_tpu_torch.ops import splash_attention as sa

    def forward(q, k, v, seg, hw):
        B, N, S, D = q.shape
        scale = 1.0 / math.sqrt(D)
        qf, kf, vf = (t.float() for t in (q, k, v))
        out = torch.empty((B, N, S, D))
        lse = torch.empty((B, N, S))
        for q0 in range(0, S, sa.TILE):
            qt = qf[:, :, q0:q0 + sa.TILE]
            m = torch.full(qt.shape[:3], sa.NEG)
            l = torch.zeros_like(m)
            o = torch.zeros_like(qt)
            for t in sa.tile_range(q0, S, hw):
                k0 = t * sa.TILE
                ok = sa._allowed(seg, q0, k0, hw)
                s = (qt @ kf[:, :, k0:k0 + sa.TILE].transpose(-1, -2)) * scale
                s = torch.where(ok, s, torch.full_like(s, sa.NEG))
                m = torch.maximum(m, s.amax(-1))
                p = torch.where(ok, torch.exp(s - m[..., None]),
                                torch.zeros_like(s))
                l = l + p.sum(-1)                   # no * alpha
                o = o + p @ vf[:, :, k0:k0 + sa.TILE]  # no * alpha
            out[:, :, q0:q0 + sa.TILE] = o / l[..., None]
            lse[:, :, q0:q0 + sa.TILE] = m + torch.log(l)
        return out.transpose(1, 2), lse

    monkeypatch.setattr(sa, "splash_attention_forward", forward)


def _lse_in_log2_units(monkeypatch):
    """A forward whose lse is left in the log2 units the kernel keeps its
    running maximum in."""
    from splade_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_forward

    def forward(*a):
        out, lse = real(*a)
        return out, lse / math.log(2.0)

    monkeypatch.setattr(sa, "splash_attention_forward", forward)


def _lse_shifted(monkeypatch):
    """... or shifted by 1e-3 (ten times the tolerance)."""
    from splade_tpu_torch.ops import splash_attention as sa

    real = sa.splash_attention_forward

    def forward(*a):
        out, lse = real(*a)
        return out, lse + 1e-3

    monkeypatch.setattr(sa, "splash_attention_forward", forward)


@pytest.mark.parametrize("fault", [None, _window_off_by_one, _drop_delta,
                                   _stale_delta_to_dkv,
                                   _other_rows_delta_to_dkv,
                                   _forward_without_alpha,
                                   _lse_in_log2_units, _lse_shifted],
                         ids=["sound", "window_off_by_one", "drop_delta",
                              "zero_delta_to_dkv", "stale_delta_to_dkv",
                              "forward_without_alpha", "lse_in_log2_units",
                              "lse_shifted"])
@pytest.mark.parametrize("B,S,packed", [(9, 128, True), (3, 100, False)])
def test_splash_check_catches_a_wrong_window_and_a_dropped_delta(
        monkeypatch, fault, B, S, packed):
    """check_splash at a tiny size (2 heads of 16, half window 4; S = 100 is
    ragged for the 64-row tile): on the CPU the wrappers run the plain
    versions, so the sound reading is 0; a faulty forward or backward in
    the wrappers' place must stop the run."""
    cs = _load_chip_smoke()
    args = (torch, np.random.default_rng(S), B, S, 4, packed)
    kw = dict(N=2, D=16, device="cpu", timed=False)
    if fault is None:
        out = cs.check_splash(*args, **kw)
        assert set(out) == {"fwd", "dq", "dkv"}
        assert all(v["max_abs_err"] == 0.0 for v in out.values())
        assert out["fwd"]["lse_max_abs_err"] == 0.0
        assert out["dq"]["delta_max_rel_err"] == 0.0
        assert 0 < out["fwd"]["allowed_pairs"] < B * S * 9
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="splash attention kernels disagree"):
        cs.check_splash(*args, **kw)


def test_splash_case_has_padding_packing_and_a_padded_row():
    cs = _load_chip_smoke()
    q, k, v, seg, d_out = cs.splash_case(torch, np.random.default_rng(0), 18,
                                         64, 2, 16, True, device="cpu")
    assert q.shape == k.shape == v.shape == (18, 2, 64, 16)
    assert d_out.shape == (18, 64, 2, 16)
    assert not v.is_contiguous() and v.stride(2) == 3 * 2 * 16  # fused QKV
    assert bool((seg[0] == 1_000_000).all())          # row 0: all padding
    real = seg[seg < 1_000_000]
    assert set(real[real > 0].tolist()) == {1, 2, 3}  # packed segments
    assert set(seg[:16][seg[:16] < 1_000_000].tolist()) == {0}
    # half window 0 allows whole segments, a window only the band
    full = cs.splash_allowed(torch, seg, 0)
    band = cs.splash_allowed(torch, seg, 4)
    assert bool((band <= full).all()) and int(band.sum()) < int(full.sum())
    assert bool(full.diagonal(dim1=1, dim2=2).all())  # every token sees itself


def _rope_fwd_bf16_tables(monkeypatch):
    """A forward that reads the tables rounded to bf16."""
    from splade_tpu_torch.ops import rope

    monkeypatch.setattr(rope, "rope_qkv_fwd", lambda qkv, c, s: (
        rope.rope_qkv_fwd_plain(qkv, c.bfloat16(), s.bfloat16())))


def _rope_fwd_turned_back(monkeypatch):
    """A forward that turns by -theta (the backward's rotation)."""
    from splade_tpu_torch.ops import rope

    monkeypatch.setattr(rope, "rope_qkv_fwd", lambda qkv, c, s: (
        rope.rope_qkv_fwd_plain(qkv, c, -s)))


def _rope_bwd_turned_forward(monkeypatch):
    """A backward that applies the forward's rotation, not its transpose."""
    from splade_tpu_torch.ops import rope

    real = rope.rope_qkv_bwd_plain
    monkeypatch.setattr(rope, "rope_qkv_bwd", lambda dq, dk, dv, c, s, dt: (
        real(dq, dk, dv, c, -s, dt)))


def _rope_bwd_drops_dv(monkeypatch):
    """A backward that leaves dv's slot zero."""
    from splade_tpu_torch.ops import rope

    real = rope.rope_qkv_bwd_plain

    def bwd(dq, dk, dv, c, s, dt):
        out = real(dq, dk, dv, c, s, dt)
        out[:, :, 2] = 0
        return out

    monkeypatch.setattr(rope, "rope_qkv_bwd", bwd)


@pytest.mark.parametrize("fault", [None, _rope_fwd_bf16_tables,
                                   _rope_fwd_turned_back,
                                   _rope_bwd_turned_forward,
                                   _rope_bwd_drops_dv],
                         ids=["sound", "fwd_bf16_tables", "fwd_turned_back",
                              "bwd_turned_forward", "bwd_drops_dv"])
@pytest.mark.parametrize("B,S,tables", [(18, 32, "packed"), (3, 40, "shared")])
def test_rope_check_catches_a_faulty_rotation(monkeypatch, fault, B, S,
                                              tables):
    """check_rope at a tiny size (2 heads of 16): on the CPU the wrappers
    run the plain versions, so the sound reading is 0 against them and
    within one bf16 rounding of f64; a faulty forward or backward in the
    wrappers' place must stop the run."""
    cs = _load_chip_smoke()
    args = (torch, np.random.default_rng(S), B, S, tables)
    kw = dict(N=2, D=16, device="cpu", timed=False)
    if fault is None:
        out = cs.check_rope(*args, **kw)
        assert set(out) == {"fwd", "bwd"}
        assert out["fwd"]["max_abs_err"] == out["fwd"]["chain_max_abs_err"] \
            == out["bwd"]["max_abs_err"] == 0.0
        assert 0.0 < out["bwd"]["f64_share_of_one_rounding"] <= 1.0
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="RoPE kernels disagree"):
        cs.check_rope(*args, **kw)


def _add_norm_fwd_rounds_the_residual(monkeypatch):
    """A forward that keeps r' in bf16, as the chain never did."""
    from splade_tpu_torch.ops import add_norm as an

    real = an.add_layernorm_fwd_plain

    def fwd(r, b, w, eps, dt):
        r_out, n, stats = real(r, b, w, eps, dt)
        return r_out.bfloat16().float(), n, stats

    monkeypatch.setattr(an, "add_layernorm_fwd", fwd)


def _add_norm_fwd_drops_gamma(monkeypatch):
    """A forward that writes the normalised row without the weight."""
    from splade_tpu_torch.ops import add_norm as an

    real = an.add_layernorm_fwd_plain
    monkeypatch.setattr(an, "add_layernorm_fwd", lambda r, b, w, eps, dt: (
        real(r, b, torch.ones_like(w), eps, dt)))


def _add_norm_bwd_drops_the_residual_gradient(monkeypatch):
    """A backward that forgets the gradient of r' from above."""
    from splade_tpu_torch.ops import add_norm as an

    real = an.add_layernorm_bwd_plain
    monkeypatch.setattr(an, "add_layernorm_bwd", lambda dn, x, st, w, da, bd: (
        real(dn, x, st, w, None, bd)))


def _add_norm_bwd_drops_a_projection(monkeypatch):
    """A backward without the mean(g * xh) term of LayerNorm's gradient."""
    from splade_tpu_torch.ops import add_norm as an

    real = an.add_layernorm_bwd_plain

    def bwd(dn, x, st, w, da, bd):
        dr, db, dw = real(dn, x, st, w, da, bd)
        mean, rstd = (t.to(x.dtype)[..., None] for t in st)
        xh = (x - mean) * rstd
        g = dn.to(x.dtype) * w
        dr = dr + rstd * xh * (g * xh).mean(-1, keepdim=True)
        return dr, None if db is None else dr.to(db.dtype), dw

    monkeypatch.setattr(an, "add_layernorm_bwd", bwd)


def _add_norm_bwd_sums_dn_for_gamma(monkeypatch):
    """A backward whose weight gradient sums dn, not dn * xh."""
    from splade_tpu_torch.ops import add_norm as an

    real = an.add_layernorm_bwd_plain

    def bwd(dn, x, st, w, da, bd):
        dr, db, _ = real(dn, x, st, w, da, bd)
        return dr, db, dn.float().reshape(-1, x.shape[-1]).sum(0)

    monkeypatch.setattr(an, "add_layernorm_bwd", bwd)


@pytest.mark.parametrize("fault", [
    None, _add_norm_fwd_rounds_the_residual, _add_norm_fwd_drops_gamma,
    _add_norm_bwd_drops_the_residual_gradient,
    _add_norm_bwd_drops_a_projection, _add_norm_bwd_sums_dn_for_gamma],
    ids=["sound", "fwd_rounds_residual", "fwd_drops_gamma",
         "bwd_drops_residual_gradient", "bwd_drops_projection",
         "bwd_sums_dn_for_gamma"])
@pytest.mark.parametrize("B,S,H", [(3, 37, 768), (2, 9, 256)])
def test_add_norm_check_catches_a_faulty_pair(monkeypatch, fault, B, S, H):
    """check_add_norm at a small size: on the CPU the wrappers run the
    plain versions, so the sound reading holds r' bitwise, n within one
    bf16 rounding of f64 and the backward within ADD_NORM_RTOL; a faulty
    forward or backward in the wrappers' place must stop the run."""
    cs = _load_chip_smoke()
    args = (torch, np.random.default_rng(S), B, S, H)
    kw = dict(device="cpu", timed=False)
    if fault is None:
        out = cs.check_add_norm(*args, **kw)
        assert set(out) == {"fwd", "bwd"}
        for form in ("layer", "final", "embedding"):
            e = out["fwd"][form]
            assert e["residual_bitwise"] and e["repeat_bitwise"]
            assert 0.0 < e["n_share_of_tol"] <= 1.0
            assert e["dr_rel"] <= cs.ADD_NORM_RTOL
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="add \\+ LayerNorm kernels disagree"):
        cs.check_add_norm(*args, **kw)


def test_add_norm_bytes_count_each_tensor_once():
    cs = _load_chip_smoke()
    from splade_tpu_torch.ops.add_norm import BWD_ROWS_PER_BLOCK

    rows, H = 144 * 256, 768
    fwd, bwd = cs.add_norm_bytes(144, 256, H)
    assert fwd == 12 * rows * H + 8 * rows + 4 * H
    assert bwd == (16 * rows * H + 8 * rows + 8 * H
                   + 2 * 4 * H * (rows // BWD_ROWS_PER_BLOCK))


def test_rope_case_gathers_packed_positions_and_a_padded_row():
    """The packed tables are the shared ones gathered by positions that
    restart in the packed rows and stay 0 in the last row; the gradients
    are strided as the attention's [B, N, S, D] views."""
    from splade_tpu_torch.models.modernbert import rope_cos_sin

    cs = _load_chip_smoke()
    qkv, cos, sin, dq, dk, dv = cs.rope_case(
        torch, np.random.default_rng(0), 18, 32, "packed", 2, 16, "cpu")
    assert qkv.shape == (18, 32, 3, 2, 16) and qkv.dtype == torch.bfloat16
    assert cos.shape == sin.shape == (18, 32, 16)
    table_cos, _ = rope_cos_sin(32, 16, 10000.0)
    assert torch.equal(cos[0], table_cos)                   # a document row
    assert torch.equal(cos[16, 8:16], table_cos[:8])        # a packed row
    assert bool((cos[17] == table_cos[0]).all())            # the padded row
    assert dq.shape == (18, 32, 2, 16) and dq.stride(1) == 16
    assert not dv.is_contiguous() and dv.dtype == torch.bfloat16
    fwd, bwd = cs.rope_bytes(144, 256, 12, 64, "packed")
    t = 144 * 256 * 12 * 64 * 2
    assert (fwd, bwd) == (4 * t + 2 * 144 * 256 * 64 * 4,
                          6 * t + 2 * 144 * 256 * 64 * 4)
    assert cs.rope_bytes(32, 512, 12, 64, "shared")[0] == (
        4 * 32 * 512 * 12 * 64 * 2 + 2 * 512 * 64 * 4)


def test_expected_launches_follow_the_code():
    cs = _load_chip_smoke()
    names = ("fused_splade_pool", "fused_splade_bwd_match",
             "fused_splade_bwd_dh", "fused_splade_bwd_dw", "splash_attention",
             "splash_attention_bwd_dq", "splash_attention_bwd_dkv",
             "rope_qkv_fwd", "rope_qkv_bwd", "add_layernorm_fwd",
             "add_layernorm_bwd", "rescore_match")
    # the add + LayerNorm sites of an encode: the embedding's norm and the
    # 2 L residual adds; under recompute the 2 L - 1 inside the layers again
    sites, inner = 2 * 22 + 1, 2 * 22 - 1
    v33 = ModernBertConfig(remat=True, attention_impl="splash")
    assert cs.expected_launches(v33, 4, 3, 2) == dict(zip(
        names, (24, 24, 24, 24, 22 * 2 * 12, 22 * 12, 22 * 12, 22 * 2 * 12,
                22 * 12, (sites + inner) * 12, sites * 12, 0)))
    mlm = ModernBertConfig(attention_impl="splash")
    assert cs.expected_launches(mlm, 4, 5, 0) == dict(zip(
        names, (0, 0, 0, 0, 22 * 20, 22 * 20, 22 * 20, 22 * 20, 22 * 20,
                sites * 20, sites * 20, 0)))
    assert cs.expected_launches(ModernBertConfig(remat=True), 4, 3, 2) == dict(
        zip(names, (24, 24, 24, 24, 0, 0, 0, 0, 0, (sites + inner) * 12,
                    sites * 12, 0)))
    # a width the add + LayerNorm kernels are not built for keeps the chain
    assert cs.expected_launches(ModernBertConfig.tiny(remat=True), 4, 3,
                                2) == dict(zip(names, (24,) * 4 + (0,) * 8))
    assert set(cs._launch_counts()) == set(names)
    cs.hold_launches("sound", dict.fromkeys(names, 0),
                     dict.fromkeys(names, 0))
    with pytest.raises(SystemExit, match="kernel launches"):
        cs.hold_launches("one short", dict.fromkeys(names, 0),
                         dict(dict.fromkeys(names, 0), splash_attention=1))


@pytest.fixture(scope="module")
def trained_splash(tmp_path_factory):
    """Phase 6's V33 half on the CPU: phase 4's tiny run with
    attention_impl="splash" (the plain versions of the attention)."""
    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB,
                              remat=True, attention_impl="splash")
    out = cs.train_phase(torch, cs.CharTokenizer(), np.random.default_rng(0),
                         tmp_path_factory.mktemp("train_splash") / "w", 0,
                         _tiny_recipe(cs), cfg, steps=3, device="cpu",
                         doc_words=(6, 17))
    return cs, cfg, out


def test_splash_train_phase_runs_on_the_cpu(trained_splash, trained):
    _, _, out = trained_splash
    assert [r["step"] for r in out["steps"]] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in out["steps"])
    assert out["resume"]["bitwise"] and out["resume"]["step"] == 5
    assert set(out["launches"].values()) == {0}  # plain versions on the CPU
    route = out["attention_route"]
    assert route["finite"] and route["tensors"] > 10
    # f32 on the CPU: the two routes differ by the order of sums only
    assert route["loss_rel_err"] <= 1e-5
    assert route["worst_tensor_rel_err"] <= 1e-3
    # and the sdpa run of phase 4 took no attention route comparison
    assert trained[2]["attention_route"] is None
    # same data, same weights: the two attention routes train alike
    for a, b in zip(out["steps"], trained[2]["steps"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)


def test_attention_route_check_catches_a_backward_that_loses_dv(
        trained_splash, monkeypatch):
    """Phase 6 holds the splash route against the sdpa route: a backward
    whose dv never arrives must stop the run. (With seeded random weights
    attention is close to uniform and dq and dk are small beside dv, so a
    dropped delta moves the worst tensor by about 1e-2 only: that fault is
    check_splash's to catch, on the kernels themselves.)"""
    from splade_tpu_torch.ops import splash_attention as sa
    from splade_tpu_torch.train.trainer import make_loss_fn

    cs, cfg, _ = trained_splash
    vcfg, micro, model = _micro_and_model(cs, cfg)
    loss_fn = make_loss_fn(model, vcfg.loss, 1, packed_query=True)
    run = lambda: loss_fn(micro, 7)[0]
    sound = cs.compare_attention_routes(torch, model.mlm, run, "training")
    assert sound["worst_tensor_rel_err"] <= 1e-3
    assert model.mlm.config.attention_impl == "splash"  # left as it was
    real = sa.splash_attention_bwd_plain

    def lose_dv(*args):
        dq, dk, dv = real(*args)
        return dq, dk, torch.zeros_like(dv)

    monkeypatch.setattr(sa, "splash_attention_bwd_plain", lose_dv)
    with pytest.raises(SystemExit, match="differ from the sdpa route"):
        cs.compare_attention_routes(torch, model.mlm, run, "training")


def test_noise_floor_forward_is_the_models_sdpa_forward_in_f32(trained_splash):
    """chip_smoke's measuring instrument repeats the model's sdpa attention
    with the scores kept in f32 under autocast; without autocast it must be
    the model's own forward to the bit, and the route comparison must leave
    the model's forward in place."""
    from splade_tpu_torch.models.modernbert import (ModernBertAttention,
                                                    rope_cos_sin)

    cs, cfg, out = trained_splash
    own = ModernBertAttention.forward
    attn = ModernBertAttention(cfg, 1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, cfg.hidden_size, generator=g)
    bias = torch.zeros(2, 1, 1, 12)
    bias[0, ..., 9:] = -1e30
    cos, sin = rope_cos_sin(12, cfg.head_dim, 10000.0)
    with torch.no_grad():
        want = attn(x, bias, cos, sin)
        got = cs.sdpa_forward_with_f32_scores(attn, x, bias, cos, sin)
    assert torch.equal(got, want)
    assert ModernBertAttention.forward is own
    floor = out["attention_route"]["noise_floor"]
    assert floor["worst_tensor_rel_err"] == 0.0  # f32 here: no rounding to find


def test_splash_mlm_phase_runs_on_the_cpu(tmp_path):
    """Phase 6's MLM half on the CPU: phase 5's tiny run with
    attention_impl="splash", the checkpoint loaded on the same route."""
    import signal

    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB,
                              attention_impl="splash")
    recipe = dict(cs.mlm_recipe(), max_length=32, batch_size=2, grad_accum=2,
                  dtype="float32")
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    out = cs.mlm_phase(torch, cs.CharTokenizer(), np.random.default_rng(0),
                       tmp_path / "w", 0, recipe, cfg, steps=3, device="cpu",
                       n_sentences=400, sentence_words=(6, 12),
                       v2_shapes=((4, 16),), checkpoint_config=cfg)
    assert {s: signal.getsignal(s) for s in before} == before
    assert out["resume"]["bitwise"]
    assert out["steps_run"] == out["preemption"]["stopped_at_step"] >= 4
    assert set(out["launches"].values()) == {0}  # plain versions on the CPU
    assert out["from_checkpoint_max_rel_diff"] == 0.0
    route = out["attention_route"]
    assert route["loss_rel_err"] <= 1e-5
    assert route["worst_tensor_rel_err"] <= 1e-3


# ------------------------------------------------------------ phase 7
#: the faults phase 7 (b)'s comparisons must catch, each a change made in
#: both rank processes (``_faulty_worker``)
DP_FAULTS = ("sum_without_dividing", "reduce_before_accum", "rank1_checkpoint",
             "stop_alone", "mlm_local_count")


def _faulty_worker(fault: str, spec_path: str) -> int:
    """``python tests/test_torch_chip_smoke.py dp-worker FAULT SPEC``: one
    rank of phase 7 (b) with ``fault`` put into the port ("none": as it
    is)."""
    import json
    import sys

    from splade_tpu_torch.parallel.mesh import GradReducer
    from splade_tpu_torch.train import checkpoint, mlm, trainer

    sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import time
    reduce = GradReducer.__call__
    accum = json.loads(Path(spec_path).read_text())["v33"]["training"][
        "gradient_accumulation_steps"]
    if fault == "sum_without_dividing":
        def summed(self, grads):
            self.mesh = dataclasses.replace(self.mesh, world=1)
            reduce(self, grads)
        GradReducer.__call__ = summed
    elif fault == "reduce_before_accum":
        def reduced_first(self, grads):  # (g0·a + g1·a) / W / a
            for g in grads:
                g.mul_(accum)
            reduce(self, grads)
            for g in grads:
                g.div_(accum)
        GradReducer.__call__ = reduced_first
    elif fault == "rank1_checkpoint":  # every rank writes as rank 0
        save = checkpoint.save_checkpoint
        checkpoint.save_checkpoint = lambda *a, mesh, **k: save(
            *a, mesh=dataclasses.replace(mesh, rank=0), **k)
    elif fault == "stop_alone":
        trainer.stop_agreed = lambda tr: tr._preempted
    elif fault == "mlm_local_count":
        mlm.all_reduce_sum = lambda t, mesh: t
    cs = _load_chip_smoke()
    return cs.dp_worker(spec_path)


def _dp_phase(cs, root: Path, fault: str) -> dict:
    """Phase 7 (b) on the CPU, tiny (2 layers, accumulation 3 so that the
    order of the divisions shows), ranks from ``_faulty_worker``; a faulty
    run's ranks get 60 s (a rank that stops alone leaves the other waiting
    until then). -> its result, or the message it failed with."""
    import sys

    recipe = _tiny_recipe(cs)
    recipe["training"]["gradient_accumulation_steps"] = 3
    v33 = dataclasses.replace(ModernBertConfig.tiny(num_hidden_layers=2),
                              vocab_size=VOCAB, remat=True)
    mlm = dataclasses.replace(ModernBertConfig.tiny(num_hidden_layers=2),
                              vocab_size=VOCAB)
    mlm_recipe = dict(cs.mlm_recipe(), max_length=32, batch_size=4,
                      grad_accum=3, dtype="float32")
    try:
        return cs.data_parallel_phase(
            torch, cs.CharTokenizer(), np.random.default_rng(8), root / fault,
            0, recipe, v33, mlm_recipe, mlm, device="cpu", n_sentences=400,
            sentence_words=(6, 12), timeout_s=150 if fault == "none" else 60,
            worker=[sys.executable, str(Path(__file__).resolve()),
                    "dp-worker", fault])
    except SystemExit as e:
        return {"failed": str(e)}


@pytest.fixture(scope="module")
def dp_phases(tmp_path_factory):
    """Phase 7 (b) as it is and with each of DP_FAULTS, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    cs = _load_chip_smoke()
    root = tmp_path_factory.mktemp("dp")
    # tiny ranks, a dozen at once: one thread each, and one here for the
    # emulation, so the ranks and it compute alike
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, \
                ThreadPoolExecutor(len(DP_FAULTS) + 1) as pool:
            mp.setenv("OMP_NUM_THREADS", "1")
            runs = {f: pool.submit(_dp_phase, cs, root, f)
                    for f in ("none",) + DP_FAULTS}
            return {f: run.result() for f, run in runs.items()}
    finally:
        torch.set_num_threads(threads)


def test_data_parallel_phase_runs_on_the_cpu(dp_phases):
    out = dp_phases["none"]
    assert "failed" not in out, out.get("failed")
    assert out["world"] == 2 and out["backend"] == "gloo"
    assert len(out["v33"]["records"]) == out["steps"] == 2
    assert all(len(ms) == 2 and min(ms) > 0
               for ms in out["v33"]["allreduce_ms"])
    assert out["vs_global_batch"]["worst_tensor_rel_err"] <= 1e-5
    assert out["global_negatives"]["loss_rel_err"] <= 1e-5
    assert out["v33"]["launches"][0] == dict.fromkeys(
        out["v33"]["launches"][0], 0)  # plain versions on the CPU


@pytest.mark.parametrize("fault, check", [
    ("sum_without_dividing", "ranks == emulation (parameters, bitwise)"),
    ("reduce_before_accum", "V33 ranks == emulation (parameters, bitwise)"),
    ("rank1_checkpoint", "checkpoints: rank 0's only"),
    ("stop_alone", "data-parallel ranks"),
    ("mlm_local_count", "MLM ranks == emulation"),
])
def test_data_parallel_phase_catches_a_fault(dp_phases, fault, check):
    """Each fault fails the phase, at the check that names it (a rank
    stopping alone leaves the other waiting in a collective: the ranks'
    processes fail, or are killed at the phase's deadline)."""
    got = dp_phases[fault]
    assert "failed" in got, fault
    assert check in got["failed"], got["failed"][-2000:]


@pytest.mark.parametrize("num_blocks, sound", [(2, True), (1, False)])
def test_global_batch_ceiling_catches_a_wrong_block_mask(num_blocks, sound):
    """Phase 7 (b)'s comparison of the two halves with one process at the
    global batch, at the most it tolerates (the ceiling of DP_RTOL, as a
    floor that large would give): the global batch with its two blocks
    passes; with one block (every row a candidate of every other: a wrong
    mask) it fails."""
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator
    from splade_tpu_torch.models.splade import SpladeEncoder

    cs = _load_chip_smoke()
    cfg = V33Config.from_dict(_tiny_recipe(cs))
    collator = TripletCollator(cs.CharTokenizer(), query_max_length=8,
                               doc_max_length=32)
    macros = cs.rank_macro_batches(
        torch, cs.synth_triplets(np.random.default_rng(3), 16, (6, 12)),
        collator, 4, 1, 2, 1, 2, "cpu")[0]
    model = SpladeEncoder(dataclasses.replace(
        ModernBertConfig.tiny(num_hidden_layers=2), vocab_size=VOCAB),
        pool_impl="kernel", with_token_weights=False,
        device="cpu").init_weights(0)
    joined = {k: torch.cat([m[k] for m in macros], dim=1) for k in macros[0]}
    at_global = cs.accumulated_gradients(torch, model, cs.v33_runs(
        torch, model, cfg, joined, 0, num_blocks=num_blocks))
    halves = cs.combined_gradients(torch, model, [
        cs.v33_runs(torch, model, cfg, m, 0) for m in macros])
    ceiling = dict.fromkeys(("loss_rel_err", "grad_norm_rel_err",
                             "worst_tensor_rel_err"), cs.DP_RTOL[1])
    if sound:
        out = cs.gradients_against(torch, halves, at_global, "halves",
                                   cs.DP_RTOL, ceiling)
        assert out["worst_tensor_rel_err"] <= 1e-5
    else:
        with pytest.raises(SystemExit, match="global batch"):
            cs.gradients_against(torch, halves, at_global, "halves",
                                 cs.DP_RTOL, ceiling)


def test_cli_phases_run_on_the_cpu(tmp_path, monkeypatch):
    """Phase 7 (a) and (c) on the CPU, tiny: each CLI as one process and as
    a world of 1 under torch.distributed.run (gloo), bitwise equal."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # tiny processes
    cs = _load_chip_smoke()
    over = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                num_hidden_layers=1, num_attention_heads=4,
                local_attention=8)
    with ThreadPoolExecutor(2) as pool:
        v33 = pool.submit(
            cs.v33_cli_phase, torch, np.random.default_rng(7),
            tmp_path / "v33", _tiny_recipe(cs), ModernBertConfig(**over),
            device="cpu", model_over=over, timeout_s=150)
        mlm = pool.submit(
            cs.mlm_cli_phase, torch, np.random.default_rng(9),
            tmp_path / "mlm", cs.mlm_recipe(), device="cpu", n_sentences=400,
            sentence_words=(6, 12),
            env_over={"MLM_MAX_LENGTH": "32", "MLM_BATCH_SIZE": "4",
                      "MLM_GRAD_ACCUM": "2", "MLM_DTYPE": "float32"},
            model_over=over, timeout_s=150)
        v33, mlm = v33.result(), mlm.result()
    assert len(v33["world1"]["records"]) == 3
    assert v33["world1"]["digest"] == v33["single"]["digest"]
    assert all(ms is not None for ms in v33["allreduce_ms"])
    assert len(mlm["world1"]["records"]) == 2
    assert mlm["world1"]["digest"] == mlm["single"]["digest"]


def test_mlm_recipe_is_the_cli_defaults():
    """Phase 7 (c) runs the MLM CLI without a config: the recipe must be
    the configuration's defaults."""
    from splade_tpu_torch.train.mlm import MLMConfig

    cs = _load_chip_smoke()
    defaults = MLMConfig().to_dict()
    assert {k: defaults[k] for k in cs.mlm_recipe()} == cs.mlm_recipe()


def test_concurrent_builds_link_one_library(tmp_path, monkeypatch):
    """Two build() calls at once (the ranks of a run starting together)
    against a stub nvcc: one compile of each source and one link, one
    library, no temporary left."""
    from concurrent.futures import ThreadPoolExecutor

    from splade_tpu_torch.ops import _cuda

    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo \"$*\" >> {calls}\n"
        "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "sleep 0.3\n"
        "echo object > \"$out\"\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(stub))
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda _: _cuda.build(), range(2)))
    assert built[0][0] == built[1][0] and built[0][0].exists()
    assert len(list((tmp_path / "build").glob("*.so"))) == 1
    assert not list((tmp_path / "build").glob("*.tmp"))
    assert len(calls.read_text().splitlines()) == len(_cuda.sources()) + 1


# ------------------------------------------------------------ phase 8
#: phase 8's models on the CPU: a one-layer ModernBERT and a two-layer
#: XLM-R, both at tiny widths
BENCH_SPARSE = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                    num_hidden_layers=1, num_attention_heads=4,
                    local_attention=8)
BENCH_DENSE = dict(vocab_size=300, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=80, type_vocab_size=1,
                   layer_norm_eps=1e-5, pad_token_id=1)
#: faults phase 8's checks must catch, each put into the benchmark CLI's
#: process (``_faulty_bench``)
BENCH_FAULTS = ("query_raises", "postings_off_by_one")


def _faulty_bench(fault: str, argv) -> int:
    """``python tests/test_torch_chip_smoke.py bench-worker FAULT ARGS``:
    ``cli_entry(ARGS)`` with ``fault`` put into the port ("none": as it
    is): the neural_sparse searcher raising on one query (the runner logs
    it and exits 0), or the postings index answering with its ranking off
    by one document."""
    from splade_tpu_torch.benchmark import searchers
    from splade_tpu_torch.ops.postings_index import PostingsIndex

    if fault == "query_raises":
        search, first = searchers.NeuralSparseSearcher._search, []

        def failing(self, query, k):
            first[:] = first or [query]
            if query == first[0]:
                raise RuntimeError("index shard down")
            return search(self, query, k)
        searchers.NeuralSparseSearcher._search = failing
    elif fault == "postings_off_by_one":
        search_vector = PostingsIndex.search_vector
        PostingsIndex.search_vector = (
            lambda self, idx, val, k=10: search_vector(self, idx, val,
                                                       k + 1)[1:])
    return _load_chip_smoke().cli_entry(argv)


def _bench_phase(cs, root: Path, fault: str) -> dict:
    """Phase 8 on the CPU, tiny: 40 triplets, 12 queries over 48
    documents, 48-token dense encodes, the CLI through ``_faulty_bench``.
    -> its result, or the message it failed with."""
    import sys

    try:
        return cs.bench_phase(
            torch, np.random.default_rng(10), root / fault, 0, "cpu",
            device="cpu", n_triplets=40, sample_size=12, doc_words=(20, 30),
            sparse_over=BENCH_SPARSE, dense_shape=BENCH_DENSE,
            dense_max_length=48, doc_nnz=24, query_nnz=8, teacher_texts=8,
            timeout_s=150, cli=[sys.executable, str(Path(__file__).resolve()),
                                "bench-worker", fault])
    except SystemExit as e:
        return {"failed": str(e)}


@pytest.fixture(scope="module")
def bench_phases(tmp_path_factory):
    """Phase 8 as it is and with each of BENCH_FAULTS, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    cs = _load_chip_smoke()
    root = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp, \
            ThreadPoolExecutor(len(BENCH_FAULTS) + 1) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        runs = {f: pool.submit(_bench_phase, cs, root, f)
                for f in ("none",) + BENCH_FAULTS}
        return {f: run.result() for f, run in runs.items()}


def test_bench_phase_runs_on_the_cpu(bench_phases):
    out = bench_phases["none"]
    assert "failed" not in out, out.get("failed")
    assert (out["queries"], out["documents"]) == (12, 48)
    assert {k.split(" ", 1)[1] for k in out["latency_p50_p99_ms"]} == (
        _load_chip_smoke().BENCH_METHODS)
    for name, got in out["rankings"].items():
        assert got["queries"] == 12, name
        assert got["identical"] + got["within_rounding"] == 12, name
    assert 0 <= out["rankings"]["neural_sparse_cluster"]["recall"] <= 1
    assert out["rankings"]["neural_sparse (exact)"]["identical"] == 12
    assert all(set(v.values()) == {0} for v in out["launches"].values())
    assert out["launches"]["a"].keys() >= {"fused_splade_pool",
                                           "rescore_match"}
    assert out["mined"]["mined"] == 40 and out["teacher_texts"] == 200
    assert out["teacher"]["f32_vs_plain_rel_err"] <= 1e-4
    assert 0 < out["teacher"]["bf16_vs_f32_one_minus_cos"] <= (
        out["teacher"]["tol"])
    assert out["doc_encode_max_rel_diff"] <= 1e-4
    assert out["query_encode_max_rel_diff"] <= 1e-4
    rescore = out["postings_rescore"]
    assert rescore["queries"] == 12 and rescore["max_rel_err"] == 0.0
    assert rescore["shapes"] == [f"B=8 C=48 N=48 M={rescore['M']} T=32"]
    assert rescore["scalar_path"] == (rescore["M"] % 8 != 0)
    assert 8 <= out["doc_nnz_mean"] and 1 <= out["query_nnz_mean"]


@pytest.mark.parametrize("fault, check", [
    ("query_raises", "queries failed"),
    ("postings_off_by_one", "neural_sparse_postings"),
])
def test_bench_phase_catches_a_fault(bench_phases, fault, check):
    """The run exits 0 with a query failed, or with the postings row off by
    one document; the phase must not."""
    got = bench_phases[fault]
    assert "failed" in got, fault
    assert check in got["failed"], got["failed"][-2000:]


def _postings_case(cs, seed=3):
    """40 documents of 5-30 terms over a 512-term vocab, and 6 queries of
    4 terms taken from them, in the postings row's index. Weights lie on
    the int8 grid of the doc-major block (each document's largest is 2.0,
    the others multiples of 2/127), so it stores them exactly."""
    from scipy import sparse

    from splade_tpu_torch.benchmark.runner import serving_postings_index

    rng = np.random.default_rng(seed)
    ids, vecs = [f"d{i}" for i in range(40)], []
    for _ in ids:
        terms = np.sort(rng.choice(512, int(rng.integers(5, 31)), False))
        steps = rng.integers(6, 128, len(terms))
        steps[0] = 127
        vecs.append((terms.astype(np.int32),
                     (steps * (2.0 / 127)).astype(np.float32)))
    queries = {f"q{j}": (rng.choice(vecs[3 * j][0], 4, False).tolist(),
                         rng.uniform(0.2, 1.5, 4).tolist()) for j in range(6)}
    csr = sparse.csr_matrix(
        (np.concatenate([v for _, v in vecs]).astype(np.float64),
         np.concatenate([t for t, _ in vecs]),
         np.concatenate([[0], np.cumsum([len(t) for t, _ in vecs])])),
        shape=(len(vecs), cs.V))
    return serving_postings_index(512, ids, vecs, "cpu"), ids, csr, queries


def test_postings_rescore_check_catches_a_shift_within_int8_rounding(
        monkeypatch):
    """Check 2b holds the rescore at the postings row's own shapes (B = the
    index's batch pad, C = the corpus, M = the longest document) and fails
    a rescore whose scores are all 5e-4 high: the ranking check, whose
    tolerance is the int8 rounding of the doc-major block, passes that
    one."""
    from splade_tpu_torch.ops import rescore_kernel

    cs = _load_chip_smoke()
    index, ids, csr, queries = _postings_case(cs)
    dispatch = postings_index.dispatch_rescore
    out = cs.check_postings_rescore(torch, index, queries)
    assert postings_index.dispatch_rescore is dispatch
    M = max(len(t) for t in index._doc_idx)
    assert out["shapes"] == [f"B=8 C=40 N=40 M={M} T=32"]
    assert (out["queries"], out["M"], out["max_rel_err"]) == (6, M, 0.0)
    assert out["scalar_path"] == (M % 8 != 0)
    def served():
        return {q: index.search_vector(np.asarray(i, np.int32),
                                       np.asarray(v, np.float32))
                for q, (i, v) in queries.items()}
    before = served()
    sound = rescore_kernel.rescore_match
    monkeypatch.setattr(rescore_kernel, "rescore_match",
                        lambda *a: sound(*a) + 5e-4)
    # the postings row served through the shifted rescore
    monkeypatch.setattr(postings_index, "dispatch_rescore",
                        lambda *a, **k: rescore_kernel.rescore_match(*a[:6]))
    lists = served()
    for q, got in lists.items():  # documents scoring 0 now score 5e-4
        n = len(before[q])
        assert [d for d, _ in got[:n]] == [d for d, _ in before[q]]
        assert np.allclose([s for _, s in got],
                           [s + 5e-4 for _, s in before[q]]
                           + [5e-4] * (len(got) - n), atol=1e-6)
    cs.check_rankings("shifted", lists, queries, ids, csr, "postings",
                      top_t=cs.POSTINGS_QUERY_TOP_T)
    with pytest.raises(SystemExit, match="at the postings row's shapes"):
        cs.check_postings_rescore(torch, index, queries)


@pytest.mark.parametrize("faulty_rows", [(), (1,), (32,)])
def test_query_encode_check_holds_the_pool_at_one_row(monkeypatch,
                                                      faulty_rows):
    """Check 3 encodes queries alone (B=1, S=64) as the runner does: a pool
    forward 1e-3 off at one row fails it, though the document check at
    B=32 passes it; a pool off at B=32 fails the document check."""
    from splade_tpu_torch.models import splade

    cs = _load_chip_smoke()
    tok = cs.CharTokenizer()
    rows = cs.bench_triplets(np.random.default_rng(4), 8, (20, 30))
    docs = [r["positive"] for r in rows] + [r["negatives"][0] for r in rows]
    queries = [r["query"] for r in rows]
    model = cs.sparse_bench_model(torch, tok, docs, queries, 0, "cpu",
                                  BENCH_SPARSE, 24, 8)[0]
    pool = splade.fused_splade_pool

    def faulty(h, *rest):
        m, pos = pool(h, *rest)
        return (m * (1 + 1e-3) if h.shape[0] in faulty_rows else m), pos
    monkeypatch.setattr(splade, "fused_splade_pool", faulty)
    enc = SparseEncoderV33(model, tok, device="cpu")
    docs = (docs * 2)[:32]

    def check(what):
        if what == "query":
            return cs.compare_doc_encode(torch, enc, model, queries,
                                         enc.query_max_length, 1, "query")
        return cs.compare_doc_encode(torch, enc, model, docs)
    for what, rows_of in (("query", 1), ("document", 32)):
        if rows_of in faulty_rows:
            with pytest.raises(SystemExit, match=f"{what} vectors differ"):
                check(what)
        else:
            assert check(what) <= cs.SERVE_RTOL


def _tiny_teacher(cs, seed=0):
    from splade_tpu_torch.models.teachers import BGEM3Teacher
    from splade_tpu_torch.models.xlmr import XlmRobertaConfig

    cfg = XlmRobertaConfig(**BENCH_DENSE, dtype=torch.bfloat16)
    return BGEM3Teacher(cs.xlmr_init(torch, cfg, seed, "cpu"),
                        cs.DenseCharTokenizer(BENCH_DENSE["vocab_size"]),
                        max_length=40, device="cpu")


def _ignore_the_mask(monkeypatch):
    from splade_tpu_torch.models import xlmr

    forward = xlmr.XlmRobertaEncoder.forward
    monkeypatch.setattr(xlmr.XlmRobertaEncoder, "forward",
                        lambda self, ids, mask: forward(
                            self, ids, torch.ones_like(mask)))


def _drop_the_position_offset(monkeypatch):
    from splade_tpu_torch.models import xlmr

    monkeypatch.setattr(xlmr, "roberta_position_ids",
                        lambda ids, pad: torch.cumsum(
                            (ids != pad).long(), 1) * (ids != pad).long())


@pytest.mark.parametrize("fault", [None, _ignore_the_mask,
                                   _drop_the_position_offset])
def test_teacher_check_catches_a_faulty_teacher(monkeypatch, fault):
    """Check 4 passes the port's teacher, and fails one that ignores the
    attention mask or numbers positions without RoBERTa's offset (both
    seen by the plain f32 forward of chip_smoke.py)."""
    cs = _load_chip_smoke()
    teacher = _tiny_teacher(cs)
    texts = ["가나다 라마", "문서 검색 모델 학습 평가 데이터", "짧은", "한국어 질의 벡터"]
    if fault is None:
        out = cs.check_teacher(torch, teacher, BENCH_DENSE, texts, 0, "cpu")
        assert out["f32_vs_plain_rel_err"] <= cs.TEACHER_F32_RTOL
        assert out["norm_err"] <= cs.TEACHER_NORM_ATOL
        assert len(set(out["valid_tokens"])) == 4  # padded rows of each length
        return
    fault(monkeypatch)
    with pytest.raises(SystemExit, match="plain XLM-R forward"):
        cs.check_teacher(torch, teacher, BENCH_DENSE, texts, 0, "cpu")


def test_dense_stand_in_pads_with_the_configs_pad_id(tmp_path):
    from splade_tpu_torch.models.xlmr import roberta_position_ids

    cs = _load_chip_smoke()
    (tmp_path / "config.json").write_text(json.dumps(BENCH_DENSE))
    tok = cs.DenseCharTokenizer.from_dir(tmp_path)
    enc = tok(["가 나다", ""], max_length=6)
    codes = [4 + ord(c) % (BENCH_DENSE["vocab_size"] - 4) for c in "가나다"]
    assert enc["input_ids"].tolist() == [[0, *codes, 2, 1], [0, 2, 1, 1, 1, 1]]
    assert (enc["input_ids"][enc["attention_mask"] == 0] == 1).all()
    assert enc["input_ids"][enc["attention_mask"] == 1].min() != 1
    pos = roberta_position_ids(torch.from_numpy(enc["input_ids"]), 1)
    assert pos[0].tolist() == [2, 3, 4, 5, 6, 1]  # <s> 가 나 다 </s> pad
    assert pos[1].tolist() == [2, 3, 1, 1, 1, 1]


def test_bench_launches_follow_the_code_and_a_short_count_fails():
    """Run (a): one pool launch a batch of 32 documents and a distinct
    query, one rescore a postings query; run (b) the queries only; a count
    short by one fails."""
    cs = _load_chip_smoke()
    a = cs.bench_launches(2000, 500, 500)
    b = cs.bench_launches(0, 500, 0)
    assert (a["fused_splade_pool"], a["rescore_match"]) == (63 + 500, 500)
    assert (b["fused_splade_pool"], b["rescore_match"]) == (500, 0)
    assert a.keys() == b.keys() == set(cs._counted_kernels())
    assert not any(v for k, v in a.items()
                   if k not in ("fused_splade_pool", "rescore_match"))
    cs.hold_launches("run (a)", dict(a), a)
    for name in ("fused_splade_pool", "rescore_match"):
        short = dict(a, **{name: a[name] - 1})
        with pytest.raises(SystemExit, match="kernel launches"):
            cs.hold_launches("run (a)", short, a)


def _ranking_case(cs):
    """Three documents, one query of two terms: d1 and d2 tie exactly."""
    from scipy import sparse

    dense = np.zeros((3, cs.V))
    dense[0, [1, 2]] = [1.0, 0.50]
    dense[1, [1, 3]] = [1.0, 0.25]    # 1.0: a near tie with doc 2 at q·d
    dense[2, [1, 2, 4]] = [0.999, 0.002, 9.0]
    q = ([1, 2], [1.0, 0.5])
    return ["d0", "d1", "d2"], sparse.csr_matrix(dense), {"q": q}


def test_ranking_check_tolerates_rounding_and_catches_a_wrong_document():
    cs = _load_chip_smoke()
    ids, csr, qv = _ranking_case(cs)
    exact = [["d0", 1.25], ["d1", 1.0], ["d2", 1.0]]
    out = cs.check_rankings("t", {"q": exact}, qv, ids, csr, "impact", k=3)
    assert (out["identical"], out["within_rounding"]) == (1, 0)
    # d1 (1.0) and d2 (1.000) swapped: within bf16 rounding of each other
    swapped = [["d0", 1.25], ["d2", 1.0], ["d1", 1.0]]
    out = cs.check_rankings("t", {"q": swapped}, qv, ids, csr, "impact", k=3)
    assert out["within_rounding"] == 1 and out["largest_gap_of_tol"] <= 1
    # off by one document: d0 dropped, a doc scoring 0 appended
    for wrong in ([["d1", 1.0], ["d2", 1.0]],
                  [["d1", 1.0], ["d0", 1.25], ["d2", 1.0]],
                  [["d0", 1.3], ["d1", 1.0], ["d2", 1.0]]):
        with pytest.raises(SystemExit):
            cs.check_rankings("t", {"q": wrong}, qv, ids, csr, "impact", k=3)


def test_ranking_check_within_an_approximate_index_candidates():
    """An index that rescored only some documents: a list missing a
    document outside its candidates passes (and counts against recall),
    one missing a candidate does not."""
    cs = _load_chip_smoke()
    ids, csr, qv = _ranking_case(cs)
    without_d0 = [["d1", 1.0], ["d2", 1.0]]
    out = cs.check_rankings("t", {"q": without_d0}, qv, ids, csr, "impact",
                            k=3, allowed={"q": {1, 2}})
    assert out["identical"] == 1 and out["recall"] == pytest.approx(2 / 3)
    with pytest.raises(SystemExit):
        cs.check_rankings("t", {"q": without_d0}, qv, ids, csr, "impact",
                          k=3, allowed={"q": {0, 1, 2}})


def test_check_mined_refuses_malformed_rows(tmp_path):
    cs = _load_chip_smoke()
    scored = {"query": "q", "positive": "p", "negatives": ["a", "b"],
              "teacher_pos_score": 0.5, "teacher_neg_scores": [0.1, 0.2]}
    (tmp_path / "s.jsonl").write_text(json.dumps(scored))
    good = dict(scored, negatives=["x", "y"])
    for row, ok in ((good, True), (dict(good, negatives=["p", "y"]), False),
                    (dict(good, teacher_neg_scores=[0.1]), False)):
        (tmp_path / "m.jsonl").write_text(json.dumps(row))
        if ok:
            cs.check_mined(tmp_path / "s.jsonl", tmp_path / "m.jsonl", 1, 2)
        else:
            with pytest.raises(SystemExit):
                cs.check_mined(tmp_path / "s.jsonl", tmp_path / "m.jsonl", 1,
                               2)
    (tmp_path / "s.jsonl").write_text(json.dumps(
        dict(scored, teacher_pos_score=1.2)))
    with pytest.raises(SystemExit, match="out of"):
        cs.check_mined(tmp_path / "s.jsonl", tmp_path / "m.jsonl", 1, 2)


# ------------------------------------------------------------ phase 9
#: the export writes the architecture's window (128), which the saved
#: model must have for the exported one to encode as it does
SERVE_CONFIG = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB,
                                   num_hidden_layers=5, local_attention=128)
SERVE_TIERED = dict(n_postings=8, hot_terms=16, hot_postings=64,
                    query_top_t=16, rescore_candidates=50)
SERVE_CLUSTER = dict(cluster_size=8, n_probes=4, posting_cap=8,
                     posting_candidates=16, query_top_t=16)
#: faults phase 9's checks must catch in its subprocesses (_faulty_serve)
SERVE_FAULTS = ("export_drops_tail", "cache_kind")


def _faulty_serve(fault: str, argv) -> int:
    """``python tests/test_torch_chip_smoke.py serve-worker FAULT ARGS``:
    ``cli_entry(ARGS)`` with ``fault`` put into the port ("none": as it
    is): an export that leaves out the last (tail) layer, or a server
    that takes every --index-cache for a postings archive and serves it
    as one."""
    if fault == "export_drops_tail":
        from splade_tpu_torch.export import hf_export

        read = hf_export.read_checkpoint

        def dropping(ckpt_dir):
            state, groups, tails = read(ckpt_dir)
            last = f"model.layers.{3 * groups + tails}."
            return ({k: v for k, v in state.items()
                     if not k.startswith(last)}, groups, tails - 1)
        hf_export.read_checkpoint = dropping
    elif fault == "cache_kind":
        from splade_tpu_torch.ops.postings_index import PostingsIndex
        from splade_tpu_torch.serving import server

        server.sniff_cache_kind = lambda path: "postings"
        PostingsIndex.sniff_kind = staticmethod(lambda z: "postings")
        kwargs = PostingsIndex._config_kwargs.__func__
        PostingsIndex._config_kwargs = classmethod(
            lambda cls, cfg: kwargs(cls, cfg[:4]))
    return _load_chip_smoke().cli_entry(argv)


def _serve_cli(fault: str) -> list:
    import sys

    return [sys.executable, str(Path(__file__).resolve()), "serve-worker",
            fault]


def _serve_corpus(cs, seed=11):
    return cs.zipf_corpus_csr(np.random.default_rng(seed), 400, nnz=20)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Phase 9 at a tiny size as it is, the export with its fault, and the
    server CLI with its fault (on a sound export), all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from splade_tpu_torch.train.checkpoint import save_final_model

    cs = _load_chip_smoke()
    root = tmp_path_factory.mktemp("serve")
    model = SpladeEncoder(SERVE_CONFIG, device="cpu").init_weights(3)
    final = Path(save_final_model(str(root / "run"), model.mlm,
                                  cs.CharTokenizer(), prefix="mlm."))
    terms, vals = _serve_corpus(cs)
    tok = cs.CharTokenizer()
    texts = cs.hangul_texts(np.random.default_rng(2), 32, 30)
    cli = lambda fault: _serve_cli(fault) + [
        "--model-config", json.dumps({"vocab_size": VOCAB})]

    def whole():
        return cs.serve_phase(
            torch, tok, np.random.default_rng(11), root / "none", final,
            terms, vals, "cpu", device="cpu", model_config=SERVE_CONFIG,
            tiered=SERVE_TIERED, cluster=SERVE_CLUSTER, n_text_docs=24,
            n_queries=8, cli_docs=40, cli=_serve_cli("none"), timeout_s=150)

    def export_fault():
        (root / "tail").mkdir()
        cs.export_check(torch, tok, final, root / "tail" / "hf", texts[:8],
                        "cpu", cli("export_drops_tail"), SERVE_CONFIG, 150)

    def cache_fault():
        (root / "kind").mkdir()
        cs.export_check(torch, tok, final, root / "kind" / "hf", texts[:8],
                        "cpu", cli("none"), SERVE_CONFIG, 150)
        cs.server_cli_check(root / "kind", root / "kind" / "hf", texts,
                            texts[:4], "cpu", cli("cache_kind"), 150)

    def run(fn):
        try:
            return fn()
        except SystemExit as e:
            return {"failed": str(e)}

    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as pool:
        mp.setenv("OMP_NUM_THREADS", "1")
        runs = {"none": pool.submit(run, whole),
                "export_drops_tail": pool.submit(run, export_fault),
                "cache_kind": pool.submit(run, cache_fault)}
        return {k: f.result() for k, f in runs.items()}


def test_serve_phase_runs_on_the_cpu(serve_runs):
    cs = _load_chip_smoke()
    out = serve_runs["none"]
    assert "failed" not in out, out.get("failed")
    exported = out["export"]
    assert exported["bitwise"] and exported["layers"] == 5
    assert {"config.json", "model.safetensors",
            "tokenizer_config.json"} <= set(exported["files"])
    assert exported["doc_encode_max_rel_diff"] <= 1e-4
    for name in ("tiered", "cluster"):
        got = out[name]
        assert got["docs"] == 424 and 0 <= got["recall_at_10"] <= 1
        assert got["served"]["requests"] == 16
        assert set(got["launches"].values()) == {0}  # plain versions here
        assert got["profile"]["steps"] == 1
        assert got["profile"]["device_busy_ms"] is None
    assert out["tiered"]["n_hot"] > 0
    rescore = out["cluster"]["rescore"]
    assert rescore["shape"] == "B=8 C=48 M=64 T=16 N=425"
    assert rescore["pad_candidates"] > 0 and rescore["duplicate_candidates"]
    assert rescore["max_abs_err"] == 0.0 and rescore["ms"] is None
    probes = rescore["probes"]
    assert (probes["probes"], probes["queries"]) == (4, 8)
    assert probes["clusters"] > 4 and probes["max_gap"] <= cs.PROBE_RTOL
    cli = out["server_cli"]
    assert (cli["tiered"]["sniffed"], cli["cluster"]["sniffed"]) == (
        "tiered", "cluster")
    assert len(cli["launches"]) == 4 and all(
        run["rescore_match"] == 0 for run in cli["launches"])


@pytest.mark.parametrize("fault, check", [
    ("export_drops_tail", "the reloaded model is not the saved one"),
    ("cache_kind", "loaded ['postings']"),
])
def test_serve_phase_catches_a_fault_in_its_processes(serve_runs, fault,
                                                      check):
    got = serve_runs[fault]
    assert got and "failed" in got, fault
    assert check in got["failed"], got["failed"][-2000:]


@pytest.fixture(scope="module")
def cluster_engine():
    """A ClusterIndex whose 4 probes reach every cluster of its 30
    documents (so every postings candidate is also a cluster one: the
    union holds duplicates, and pad slots), served by the tiny model. Its
    last document is the first query's own vector, which every pad slot
    would score as if it were that document."""
    from scipy import sparse

    from splade_tpu_torch.ops.cluster_index import ClusterIndex

    cs = _load_chip_smoke()
    terms, vals = _serve_corpus(cs, seed=5)
    model = SpladeEncoder(SERVE_CONFIG, device="cpu").init_weights(3).eval()
    tok = cs.CharTokenizer()
    queries = cs.hangul_texts(np.random.default_rng(4), 8, 6)
    enc = SparseEncoderV33(model, tok, device="cpu")
    index = ClusterIndex(VOCAB, cluster_size=8, n_probes=4, query_top_t=16,
                         posting_cap=8, posting_candidates=16, device="cpu")
    index.add_csr([f"d{i}" for i in range(29)], terms[:29], vals[:29])
    index.add("q0", *enc.encode_queries(queries[:1])[0])
    index.build()
    engine = ServingEngine(model, tok, index, query_top_k=64, device="cpu")
    lens = [len(x) for x in index._doc_idx]
    csr = sparse.csr_matrix(
        (np.concatenate(index._doc_val), np.concatenate(index._doc_idx),
         np.concatenate([[0], np.cumsum(lens)])), shape=(30, VOCAB))
    return cs, engine, queries, (csr, list(index.doc_ids))


def test_cluster_rescore_check_passes_and_catches_a_missing_pad_row(
        cluster_engine, monkeypatch):
    from splade_tpu_torch.ops import rescore_kernel

    cs, engine, queries, exact = cluster_engine
    out = cs.cluster_rescore_check(torch, engine, queries, exact[0])
    assert out["shape"] == "B=8 C=48 M=64 T=16 N=31"
    assert out["pad_candidates"] > 0 and out["duplicate_candidates"] > 0

    def without_pad_row(d_terms, d_vals, d_scale, q_idx, q_val, cand):
        """A launch whose N leaves out the block's last row: candidates
        clamp into [0, N - 2], as the kernel clamps out-of-range ids."""
        n = d_terms.shape[0] - 1
        return rescore_match_plain(d_terms[:n], d_vals[:n], d_scale[:n],
                                   q_idx, q_val, cand.clamp(max=n - 1))

    monkeypatch.setattr(rescore_kernel, "rescore_match", without_pad_row)
    with pytest.raises(SystemExit, match="pad or duplicate"):
        cs.cluster_rescore_check(torch, engine, queries, exact[0])


@pytest.fixture(scope="module")
def probed_engine():
    """A ClusterIndex of 400 documents in 64 clusters, 4 of them probed a
    query, served by the tiny model, and its documents as a CSR."""
    from scipy import sparse

    from splade_tpu_torch.ops.cluster_index import ClusterIndex

    cs = _load_chip_smoke()
    terms, vals = _serve_corpus(cs, seed=6)
    model = SpladeEncoder(SERVE_CONFIG, device="cpu").init_weights(3).eval()
    tok = cs.CharTokenizer()
    index = ClusterIndex(VOCAB, device="cpu", **SERVE_CLUSTER)
    index.add_csr([f"d{i}" for i in range(len(terms))], terms, vals)
    index.build()
    engine = ServingEngine(model, tok, index, query_top_k=64, device="cpu")
    csr = sparse.csr_matrix(
        (vals.ravel(), terms.ravel(),
         np.arange(len(terms) + 1) * terms.shape[1]),
        shape=(len(terms), VOCAB))
    return cs, engine, cs.hangul_texts(np.random.default_rng(7), 8, 6), csr


def _misses_the_best_cluster(summary_scores):
    def faulty(q, summary):
        s = summary_scores(q, summary)
        return s.scatter(1, s.argmax(1, keepdim=True), float("-inf"))
    return faulty


def _mixes_member_rows(union_candidates, G):
    def faulty(*args, **kw):
        qd, cand = union_candidates(*args, **kw)
        return qd, torch.cat([cand[:, G - 1:G], cand[:, :G - 1],
                              cand[:, G:]], dim=1)
    return faulty


@pytest.mark.parametrize("fault, check", [
    (None, None),
    ("misses_best", "a cluster left out scores"),
    ("mixed_rows", "cluster probes: a probed row"),
])
def test_cluster_probe_check_holds_the_probed_clusters(probed_engine,
                                                       monkeypatch, fault,
                                                       check):
    """Phase 9 (c) holds the probed clusters against a plain reading of
    the summaries, and fails a summary product whose best cluster is lost
    before the top-L and a gather that hands the rescore a row mixed from
    two clusters."""
    from splade_tpu_torch.ops import cluster_index

    cs, engine, queries, csr = probed_engine
    if fault is None:
        probes = cs.cluster_rescore_check(torch, engine, queries,
                                          csr)["probes"]
        assert (probes["clusters"], probes["probes"]) == (64, 4)
        assert probes["max_gap"] <= cs.PROBE_RTOL
        return
    if fault == "misses_best":
        monkeypatch.setattr(cluster_index, "summary_scores",
                            _misses_the_best_cluster(
                                cluster_index.summary_scores))
    else:
        monkeypatch.setattr(cluster_index, "union_candidates",
                            _mixes_member_rows(
                                cluster_index.union_candidates,
                                engine.index.cluster_size))
    with pytest.raises(SystemExit, match=check):
        cs.cluster_rescore_check(torch, engine, queries, csr)


def test_serve_index_catches_a_dedup_that_keeps_duplicates(
        cluster_engine, monkeypatch, tmp_path):
    from splade_tpu_torch.ops import cluster_index

    cs, engine, queries, exact = cluster_engine

    def keeps_duplicates(cand, scores, k):
        vals, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        return vals, cand.gather(1, pos)

    monkeypatch.setattr(cluster_index, "dedup_topk", keeps_duplicates)
    enc = SparseEncoderV33(engine.encoder.model, engine.tokenizer,
                           device="cpu")
    with pytest.raises(SystemExit, match="twice"):
        cs.serve_index(torch, "cluster", engine.index, enc, engine.tokenizer,
                       queries, queries[0], exact, tmp_path, "cpu")


# ------------------------------------------------------------ phase 10
MESH_POSTINGS = dict(n_postings=8, query_top_t=16, rescore_candidates=50)


def _mesh_phase(root: Path):
    """Phase 10 at a tiny size on eight CPU shards: 400 synthetic and 25
    text documents (shards of 54, a 47-document tail), 48 dense ones, 8
    queries, the tiny model."""
    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB)
    model = SpladeEncoder(cfg, pool_impl="kernel",
                          device="cpu").init_weights(0).eval()
    rng = np.random.default_rng(12)
    terms, vals = cs.zipf_corpus_csr(rng, 400, nnz=20)
    texts = cs.hangul_texts(rng, 25, 30)
    dense = cs.hangul_texts(rng, 48, 30)
    queries = cs.hangul_texts(rng, 8, 6)
    return cs.mesh_phase(torch, model, cs.CharTokenizer(), terms, vals, texts,
                         dense, queries, root, "cpu", ["cpu"] * 8,
                         postings=MESH_POSTINGS, tiered=SERVE_TIERED,
                         cluster=SERVE_CLUSTER)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    return _mesh_phase(tmp_path_factory.mktemp("mesh"))


def test_mesh_phase_runs_on_the_cpu(mesh_run):
    out = mesh_run
    assert out["shards"] == 8 and out["devices"] == ["cpu"] * 8
    for name in ("postings", "tiered", "cluster"):
        got = out[name]
        assert got["docs"] == 425 and got["shard_size"] == 54
        assert got["served"]["requests"] == 16
        assert set(got["launches"].values()) == {0}  # plain versions here
        assert got["profile"]["device_busy_ms"] is None
        assert got["peak_device_gb"] is None and got["memory_bytes"] > 0
        merged = got["merged"]
        assert merged["slots"] > 0 and merged["max_rel_err"] <= 1e-6
        rescore = got["rescore"]
        assert rescore["shards"] == 8 and rescore["max_abs_err"] == 0.0
        assert rescore["ms"] is None
        assert got["devices"] == {"shards": 8, "entered": [], "rescores": 8}
    assert out["tiered"]["n_hot"] > 0 and out["cluster"]["n_clusters"] >= 8
    # the cluster's whole pool holds zero slots, each the (0, 0) filler
    merged = out["cluster"]["merged"]
    assert merged["pool_other_slots"] > 0 and merged["stray_slots"] == 0
    rescore = out["cluster"]["rescore"]
    assert rescore["pad_candidates"] > 0 and rescore["duplicate_candidates"]
    dense = out["dense"]
    assert dense["docs"] == 48 and dense["launches"]["rescore_match"] == 0
    assert dense["against_one_device"]["n_pad"] == 1024
    assert dense["devices"] == {"shards": 8, "entered": [], "rescores": 0}


def _merge_forgets_the_offset(monkeypatch):
    from splade_tpu_torch.ops import (cluster_index, postings_index,
                                      tiered_postings)

    merge = postings_index.merge_sharded_topk

    def faulty(vals, idxs, k, shard_size, n_docs, require_positive=False):
        return merge(vals, idxs, k, 0, n_docs, require_positive)

    for mod in (postings_index, tiered_postings, cluster_index):
        monkeypatch.setattr(mod, "merge_sharded_topk", faulty)


def _cluster_merge_keeps_zero_scores(monkeypatch):
    from splade_tpu_torch.ops import cluster_index, postings_index

    merge = postings_index.merge_sharded_topk
    monkeypatch.setattr(cluster_index, "merge_sharded_topk",
                        lambda *a, require_positive=False: merge(*a))


@pytest.mark.parametrize("fault, check", [
    (_merge_forgets_the_offset, "twice|not its document's exact score"),
    (_cluster_merge_keeps_zero_scores, "a pad document came back"),
], ids=["merge_forgets_offset", "cluster_merge_without_require_positive"])
def test_mesh_phase_catches_a_faulty_merge(tmp_path, monkeypatch, fault,
                                           check):
    fault(monkeypatch)
    with pytest.raises(SystemExit, match=check):
        _mesh_phase(tmp_path)


class _CudaDeviceStandIn:
    """``torch.cuda.device`` where there is no card: enters nothing."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("fault", [False, True],
                         ids=["sound", "search_outside_its_card"])
@pytest.mark.parametrize("kind", ["postings", "tiered", "cluster", "dense"])
def test_shard_device_check_catches_a_search_outside_its_card(
        monkeypatch, kind, fault):
    """Phase 10's device check on CPU tensors that claim to be on cuda:0
    and cuda:1 (a stand-in for torch.cuda.device): each shard's search
    must enter its card, in shard order, and its rescore run there; a
    shard search that does not enter its card fails."""
    import contextlib

    from splade_tpu_torch.ops import cluster_index, impact_index
    from splade_tpu_torch.ops import tiered_postings
    from splade_tpu_torch.parallel import DeviceMesh
    from test_torch_mesh_indexes import _claim_cuda, synth_corpus, synth_queries

    cs = _load_chip_smoke()
    _claim_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device", _CudaDeviceStandIn)
    mesh = DeviceMesh((torch.device("cuda:0"), torch.device("cuda:1")))
    V = 500
    if kind == "dense":
        index = impact_index.ImpactIndex(V, quantize_int8=True, mesh=mesh)
    elif kind == "cluster":
        index = cluster_index.MeshShardedClusterIndex(
            V, mesh, cluster_size=8, n_probes=2, query_top_t=8)
    elif kind == "tiered":
        index = tiered_postings.MeshShardedTieredPostingsIndex(
            V, mesh, n_postings=4, hot_terms=8, hot_postings=32,
            query_top_t=8, rescore_candidates=8)
    else:
        index = postings_index.MeshShardedPostingsIndex(
            V, mesh, n_postings=16, query_top_t=8, rescore_candidates=8)
    for i, (idx, val) in enumerate(synth_corpus()[:40]):
        index.add(f"d{i}", idx, val)
    index.build()
    qi, qv = synth_queries(b=4)
    if fault:
        for mod in (postings_index, impact_index):
            monkeypatch.setattr(mod, "on_shard_device",
                                lambda device: contextlib.nullcontext())
        with pytest.raises(SystemExit, match="the search entered"):
            cs.shard_device_check(torch, index, torch.from_numpy(qi),
                                  torch.from_numpy(qv))
        return
    out = cs.shard_device_check(torch, index, torch.from_numpy(qi),
                                torch.from_numpy(qv))
    assert out["entered"] == ["cuda:0", "cuda:1"]
    assert out["rescores"] == (0 if kind == "dense" else 2)


# ------------------------------------------------------------ phase 11
DATA_MINE = dict(queries=32, corpus=256, check=16, rank_lo=2, rank_hi=20,
                 k=5, search_k=30, max_length=64)
DATA_TERMS = dict(planted=6, apart=4, oov=4, contexts=5)
DATA_OVER = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=1, num_attention_heads=4,
                 local_attention=8)


def _data_phase(root: Path):
    """Phase 11 at a tiny size on the CPU: 400 raw samples, 32 queries
    against 256 positives, the tiny model (the CLI's one layer), 400
    information-gain pairs at d = 768, one train step."""
    cs = _load_chip_smoke()
    cfg = dataclasses.replace(ModernBertConfig.tiny(), vocab_size=VOCAB)
    model = SpladeEncoder(cfg, pool_impl="kernel",
                          device="cpu").init_weights(0).eval()
    return cs.data_phase(
        torch, model, cs.CharTokenizer(), np.random.default_rng(0), root,
        "cpu", device="cpu", n_raw=400, mine=DATA_MINE,
        ig=dict(n=400, d=768), terms=DATA_TERMS, sparse_nnz=(64, 8),
        recipe=_tiny_recipe(cs),
        model_config=ModernBertConfig(**DATA_OVER, remat=True),
        model_over=DATA_OVER, train_steps=1, timeout_s=150)


@pytest.fixture(scope="module")
def data_run(tmp_path_factory):
    return _data_phase(tmp_path_factory.mktemp("data") / "w")


def test_data_phase_runs_on_the_cpu(data_run):
    out = data_run
    pipe = out["pipeline"]
    assert pipe["raw_samples"] == 400 and pipe["converted"] < 400
    assert pipe["after_clean"] == pipe["converted"] - 8  # English-only rows
    # the 20 planted exact and 20 near duplicates go
    assert pipe["after_clean"] - pipe["after_dedup"] == 40
    assert pipe["with_negative"] == pipe["after_dedup"]
    assert set(pipe["stage_s"]) == {"collect", "convert", "clean", "dedup",
                                    "mine", "shard"}
    held = pipe["held"]
    assert held["planted_exact"] == 20 and held["rows"] == pipe["after_dedup"]
    mining = out["mining"]
    assert mining["texts"] == 4 * (32 + 256) and mining["launches"] == 0
    # the pool forward held against its plain version at mining's shape
    assert 0 <= mining["encode_diff"] <= _load_chip_smoke().SERVE_RTOL
    for kind in ("sparse", "dense"):
        run = mining[kind]
        assert run["window"]["ids"] == 16 * 5 and run["band"]["ids"] > 0
        assert run["window"]["max_sim_diff"] <= run["tol"]
        assert 0 < run["nonzeros"]["positives"] <= VOCAB
    assert mining["sparse"]["window"]["max_sim_diff"] <= 1e-6
    assert mining["sparse"]["tol"] == 1e-5
    # the dense pass's hold is twice the larger measured f32 error
    dense = mining["dense"]
    assert dense["tol"] == 2 * max(dense["f32_err"].values()) > 0
    assert (mining["sparse"]["nonzeros"]["positives"]
            < dense["nonzeros"]["positives"])
    assert set(out["idf"]) == {"bm25", "standard", "seconds"}
    pmi = out["pmi"]
    assert pmi["unique"] == 14 and pmi["stats"]["valid"] == 6
    assert pmi["stats"]["oov"] >= 4  # an apart stem may be rare here
    ig = out["information_gain"]
    assert ig["trivial_kept"] == 0 and ig["independent_dropped"] == 0
    assert ig["pairwise_ms"] is None  # not timed off the card
    train = out["train"]
    assert train["rows"] == pipe["train"] and len(train["losses"]) == 1
    assert set(train["launches"].values()) == {0}  # plain versions here


def test_the_full_drop_leaves_the_miners_corpus(tmp_path, monkeypatch):
    """At phase 11's committed size the pipeline (a host path, the same on
    the card) keeps more rows than (c)'s 8,192 positives, drops every
    planted duplicate and fills every missing negative."""
    from splade_tpu_torch.preprocessing import (PipelineConfig,
                                                PreprocessingPipeline)
    from splade_tpu_torch.preprocessing.miners import TfidfHardNegativeMiner

    cs = _load_chip_smoke()
    drop = cs.write_raw_drop(np.random.default_rng([0, 12]),
                             tmp_path / "raw", cs.DATA_RAW, cs.DATA_TERMS)
    assert sum(drop["written"].values()) == cs.DATA_RAW == 10_000
    monkeypatch.setenv("SPLADE_RAW_DATA", str(tmp_path / "raw"))
    meta = PreprocessingPipeline(
        PipelineConfig(output_dir=str(tmp_path / "out"),
                       datasets=sorted(cs.DATA_SOURCES),
                       shard_size=cs.DATA_SHARD_SIZE),
        miner=TfidfHardNegativeMiner(top_k=1)).run()
    assert meta["after_dedup"] >= cs.DATA_MINE["corpus"] + 100
    assert meta["after_clean"] - meta["after_dedup"] == 1000
    assert meta["with_negative"] == meta["after_dedup"]
    assert len(meta["shards"]) == 5


def _window_off_by_one(monkeypatch):
    from splade_tpu_torch.preprocessing.miners import EncoderHardNegativeMiner

    mine = EncoderHardNegativeMiner.mine_rank_window
    monkeypatch.setattr(
        EncoderHardNegativeMiner, "mine_rank_window",
        lambda self, q, c, p, rank_lo=10, rank_hi=50, **kw: mine(
            self, q, c, p, rank_lo=rank_lo + 1, rank_hi=rank_hi + 1, **kw))


def _ig_keeps_the_trivial_pairs(monkeypatch):
    from splade_tpu_torch.information_gain import InformationGainFilter

    filter_pairs = InformationGainFilter.filter_pairs

    def keep_all(self, *a, **kw):
        out = filter_pairs(self, *a, **kw)
        for r in out:
            r.keep = True
        return out

    monkeypatch.setattr(InformationGainFilter, "filter_pairs", keep_all)


def _idf_counts_a_document_twice(monkeypatch):
    from splade_tpu_torch.utils import idf

    compute = idf.compute_idf
    monkeypatch.setattr(idf, "compute_idf", lambda texts, *a, **kw: compute(
        list(texts) + list(texts)[:1], *a, **kw))


@pytest.mark.parametrize("fault, check", [
    (_window_off_by_one, "differs from the host's at its rank"),
    (_ig_keeps_the_trivial_pairs, "information gain"),
    (_idf_counts_a_document_twice, "differ from the independent count"),
], ids=["rank_window_off_by_one", "ig_keeps_trivial", "idf_doc_twice"])
def test_data_phase_catches_a_fault(tmp_path, monkeypatch, fault, check):
    """Phase 11's holds fail a miner whose rank window is off by one, an
    information-gain filter that keeps the planted trivial pairs and an
    IDF that counts a document twice (each fails before (f) trains)."""
    fault(monkeypatch)
    with pytest.raises(SystemExit, match=check):
        _data_phase(tmp_path / "w")


@pytest.mark.parametrize("fault", [None, "outside", "unsorted", "short",
                                   "narrow", "narrow_drops_last",
                                   "narrow_empty", "narrow_edge"])
def test_band_check_holds_the_band(fault):
    """The band hold: ids in the band, in order, and min(in band, k) of
    them, where only an id within tol of an edge may be left out."""
    cs = _load_chip_smoke()
    sims = np.linspace(1.0, 0.0, 101)[None, :]
    lo, hi, k = 0.3, 0.8, 4
    got = [[20, 21, 22, 23]]  # 0.8 .. 0.77
    if fault == "outside":
        got = [[10, 21, 22, 23]]
    elif fault == "unsorted":
        got = [[21, 20, 22, 23]]
    elif fault == "short":
        got = [[20, 21]]
    elif fault is not None:
        # four ids in the band, fewer than k
        lo, hi, k = 0.765, 0.805, 6
        got = {"narrow": [[20, 21, 22, 23]],
               "narrow_drops_last": [[20, 21, 22]],
               "narrow_empty": [[]],
               "narrow_edge": [[20, 21, 22]]}[fault]
        if fault == "narrow_edge":  # 0.77 within tol of lo: may go
            lo = 0.77 - 5e-6
    if fault in (None, "narrow", "narrow_edge"):
        assert cs.check_band(got, sims, lo, hi, k)["ids"] == len(got[0])
        return
    with pytest.raises(SystemExit, match="band ids"):
        cs.check_band(got, sims, lo, hi, k)


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "bench-worker":
        sys.exit(_faulty_bench(sys.argv[2], sys.argv[3:]))
    if sys.argv[1] == "serve-worker":
        sys.exit(_faulty_serve(sys.argv[2], sys.argv[3:]))
    sys.exit(_faulty_worker(sys.argv[2], sys.argv[3]))
