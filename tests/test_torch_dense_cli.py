"""The port's benchmark CLI with the dense (BGE-M3) baseline, end to end on
the CPU, against the JAX package's CLI on the same artifacts.

The fixture of tests/test_dense_cli.py: a tiny WordPiece tokenizer, a tiny
ModernBERT exported to an HF dir by the JAX package, and a random XLM-R
saved by HF. ``python -m splade_tpu_torch.benchmark.runner --checkpoint
... --dense-checkpoint ... --device cpu`` must give the 11 methods, and
their metrics must equal the JAX runner's, latency aside. Both packages
read the two models in bf16, so a base searcher's list may differ from
JAX's only where its scores agree within bf16 noise: each query's score
sequence (top 100, as the hybrids fetch them) within ``SPARSE_RTOL`` of its
top score for neural_sparse, and for the semantic cosines within
``DENSE_RTOL`` of the largest distance ``|q - d|`` in the list (an error of
2^-8 in each embedding's values moves a cosine by about that much of the
distance; the tiny random XLM-R puts every text near one direction, so the
distances are small); BM25 is the same Python on the same tokenizer, so its
lists must be identical. A method's metrics must equal JAX's where its base
lists rank the same documents in the same order (and, for the linear
fusions, which blend scores, give them the same scores too)."""

import json

import numpy as np
import pytest

#: bf16 noise of a score, relative to the query's top score: the sparse
#: vectors of two bf16 encoders differ by a few bf16 ulps (2^-8 each)
SPARSE_RTOL = 2.0 ** -6
#: bf16 noise of a cosine of two unit bf16 embeddings, relative to the
#: largest distance |q - d| = sqrt(2 - 2 cos) among the query's list
DENSE_RTOL = 2.0 ** -6

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "doc", "body", "filler", "text"]
METHODS = {"bm25", "neural_sparse", "semantic", "bm25_semantic_rrf",
           "hybrid_rrf", "hybrid_linear_0.3", "hybrid_linear_0.4",
           "hybrid_linear_0.5", "hybrid_weighted_rrf", "bm25_sparse_rrf",
           "triple_rrf"}
#: each method's base searchers
BASES = {"bm25": ["bm25"], "neural_sparse": ["neural_sparse"],
         "semantic": ["semantic"], "bm25_semantic_rrf": ["bm25", "semantic"],
         "bm25_sparse_rrf": ["bm25", "neural_sparse"],
         "triple_rrf": ["bm25", "neural_sparse", "semantic"],
         **{m: ["neural_sparse", "semantic"] for m in (
             "hybrid_rrf", "hybrid_linear_0.3", "hybrid_linear_0.4",
             "hybrid_linear_0.5", "hybrid_weighted_rrf")}}


@pytest.fixture(scope="module")
def artifact_dirs(tmp_path_factory):
    """A tiny shared tokenizer + sparse HF dir + dense HF dir, as
    tests/test_dense_cli.py builds them."""
    import jax
    import jax.numpy as jnp
    import torch
    from safetensors.numpy import save_file
    from transformers import BertTokenizerFast
    from transformers import XLMRobertaConfig as HFXlmrConfig, XLMRobertaModel

    from splade_tpu.export.hf_export import _hf_config_dict
    from splade_tpu.models.hf_port import export_to_hf_state_dict
    from splade_tpu.models.modernbert import ModernBertConfig
    from splade_tpu.models.splade import SpladeEncoder

    root = tmp_path_factory.mktemp("artifacts")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [
        "##" + c for c in "abcdefghijklmnopqrstuvwxyz"] + list(
        "abcdefghijklmnopqrstuvwxyz")
    (root / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(root / "vocab.txt"),
                            do_lower_case=True)
    tok.save_pretrained(str(root / "tokenizer"))

    cfg = ModernBertConfig.tiny(vocab_size=len(tok), num_hidden_layers=2,
                                pad_token_id=tok.pad_token_id)
    model = SpladeEncoder(cfg, pool_impl="streamed")
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(3), ids,
                        jnp.ones_like(ids))["params"]
    sparse_dir = root / "sparse_hf"
    sparse_dir.mkdir()
    state = export_to_hf_state_dict(params["mlm"], cfg)
    state.pop("decoder.weight", None)  # tied; the loaders re-tie
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              str(sparse_dir / "model.safetensors"), metadata={"format": "pt"})
    (sparse_dir / "config.json").write_text(
        json.dumps(_hf_config_dict(cfg), indent=2))

    hf_cfg = HFXlmrConfig(
        vocab_size=len(tok), hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=80, type_vocab_size=1,
        pad_token_id=tok.pad_token_id, hidden_act="gelu",
        layer_norm_eps=1e-5, attention_probs_dropout_prob=0.0,
        hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    dense_dir = root / "dense_hf"
    XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval().save_pretrained(
        str(dense_dir), safe_serialization=True)
    tok.save_pretrained(str(dense_dir))  # the teacher loads its own
    return root / "tokenizer", sparse_dir, dense_dir


def _val_jsonl(tmp_path):
    rng = np.random.default_rng(5)
    topics = [WORDS[i:i + 2] for i in range(0, 8, 2)]
    rows = []
    for i in range(12):
        t, o = topics[i % 4], topics[(i + 1) % 4]
        rows.append({
            "query": " ".join(t),
            "positive": " ".join(t) + " doc body " + rng.choice(WORDS),
            "negative": " ".join(o) + " filler text",
            "difficulty": "easy" if i % 2 else "hard"})
    f = tmp_path / "val.jsonl"
    f.write_text("\n".join(json.dumps(r) for r in rows))
    return str(f)


@pytest.fixture(scope="module")
def cli_runs(artifact_dirs, tmp_path_factory):
    """Both CLIs on the same artifacts, each runner object kept."""
    from splade_tpu.benchmark import runner as jax_runner
    from splade_tpu_torch.benchmark import runner as port_runner

    tok_dir, sparse_dir, dense_dir = artifact_dirs
    tmp = tmp_path_factory.mktemp("cli")
    val = _val_jsonl(tmp)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPLADE_TOKENIZER_PATH", str(tok_dir))
        for name, mod, extra in (("port", port_runner, ["--device", "cpu"]),
                                 ("jax", jax_runner, [])):
            kept = []
            run = mod.BenchmarkRunner.run
            mp.setattr(mod.BenchmarkRunner, "run",
                       lambda self, _run=run, _kept=kept: (
                           _kept.append(self), _run(self))[1])
            rc = mod.main([
                "--dataset", "triplet-val", "--val-files", val,
                "--checkpoint", str(sparse_dir),
                "--dense-checkpoint", str(dense_dir),
                "--dense-max-length", "24", "--dense-batch-size", "4",
                "--sample-size", "8", "--output-dir", str(tmp / name)]
                + extra)
            assert rc == 0
            out[name] = (json.loads((tmp / name / "metrics.json").read_text()),
                         kept[0])
    return out


def test_cli_dense_checkpoint_all_methods(cli_runs):
    metrics, runner = cli_runs["port"]
    assert set(metrics["methods"]) == METHODS
    for name, m in metrics["methods"].items():
        assert 0.0 <= m["recall@1"] <= 1.0, name
    assert runner.device.type == "cpu"
    assert runner.sparse_encoder.device.type == "cpu"
    assert runner.dense_encoder.teacher.device.type == "cpu"


def _lists(runner, name):
    s = runner.searchers[name]
    return {q: s._search(q, 100) for q in runner.data.queries.values()}


def test_cli_metrics_match_the_jax_runner(cli_runs):
    (got, port), (want, ref) = cli_runs["port"], cli_runs["jax"]
    assert got["num_queries"] == want["num_queries"]
    same_ids, same_scores = {}, {}
    for base in ("bm25", "neural_sparse", "semantic"):
        mine, theirs = _lists(port, base), _lists(ref, base)
        same_scores[base] = mine == theirs
        same_ids[base] = all([d for d, _ in mine[q]] == [d for d, _ in w]
                             for q, w in theirs.items())
        for q, want_list in theirs.items():
            got_list = mine[q]
            if got_list == want_list:
                continue
            assert base != "bm25", q  # same Python, same tokenizer
            assert len(got_list) == len(want_list), q
            scores = [s for _, s in want_list]
            tol = (SPARSE_RTOL * max(scores) if base == "neural_sparse"
                   else DENSE_RTOL * np.sqrt(2 - 2 * min(scores)))
            np.testing.assert_allclose([s for _, s in got_list],
                                       [s for _, s in want_list],
                                       rtol=0, atol=tol, err_msg=q)
    assert same_scores["bm25"]
    strip = lambda m: {k: v for k, v in m.items()
                       if not k.startswith("latency")}
    held = []
    for method in sorted(METHODS):
        same = same_scores if "linear" in method else same_ids
        if all(same[b] for b in BASES[method]):
            assert (strip(got["methods"][method])
                    == strip(want["methods"][method])), method
            held.append(method)
    assert "bm25" in held


def test_teacher_dense_encoder_from_hf_dir(artifact_dirs):
    """As tests/test_dense_cli.py holds JAX's: normalized [N, dim] from the
    dir's own tokenizer, identical texts identical, different ones not."""
    from splade_tpu_torch.benchmark.encoders import TeacherDenseEncoder

    enc = TeacherDenseEncoder.from_hf_dir(str(artifact_dirs[2]),
                                          max_length=16, batch_size=2,
                                          device="cpu")
    assert enc.dim == 32
    mat = enc.encode(["alpha beta doc", "gamma delta", "epsilon"])
    assert mat.shape == (3, 32)
    np.testing.assert_allclose(np.linalg.norm(mat, axis=1), 1.0, rtol=1e-3)
    np.testing.assert_allclose(mat[0], enc.encode(["alpha beta doc"])[0],
                               rtol=1e-5)
    assert not np.allclose(mat[0], mat[1])
