"""Benchmark runner: index -> search -> metrics -> significance -> report.

Counterpart of ``splade_tpu/benchmark/runner.py``, with the same flags,
defaults and output files (``metrics.json``, ``report.md``, the
``--encodings`` npz with no pickle in it). The OpenSearch cluster is
replaced by in-process indexes; hit-rank handles multi-relevant qrels.
The encoders and the device indexes run on ``--device`` (``cuda`` unless
the caller asks for the CPU): ``--index gpu`` is the port's
``ImpactIndex`` and ``--postings-index`` its ``PostingsIndex`` at the
serving configuration, whose exact rescore is the hand-written kernel on
the card. The cluster index is not ported yet: ``--cluster-index``
raises.

CLI:
    python -m splade_tpu_torch.benchmark.runner --dataset ko-strategyqa \
        --checkpoint outputs/train_v33/final_model [--sample-size N]
        [--no-hybrid] [--output-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

from splade_tpu_torch.benchmark.bm25 import BM25Index, make_wordpiece_analyzer
from splade_tpu_torch.benchmark.data import BenchmarkData, load_benchmark, load_triplet_benchmark
from splade_tpu_torch.benchmark.index import ExactDenseIndex, ExactSparseIndex
from splade_tpu_torch.benchmark.metrics import QueryResult, aggregate_metrics, paired_t_test
from splade_tpu_torch.benchmark.report import generate_report
from splade_tpu_torch.benchmark.searchers import (
    BaseSearcher,
    DenseSearcher,
    NeuralSparseSearcher,
    create_hybrid_searchers,
    create_searchers,
)
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def refuse_cluster_index() -> None:
    raise NotImplementedError(
        "the cluster index is not ported to splade_tpu_torch yet "
        "(ROADMAP.md §1, 'Cluster index'): run without --cluster-index")


def split_encodings(z):
    """A loaded ``--encodings`` npz (lens + concatenated indices and
    values) -> (doc ids, [(indices, values)] one pair a document). Reading
    an array of a file made with pickle raises ValueError (the archive is
    loaded with allow_pickle=False), a file without ``lens`` KeyError."""
    import numpy as np

    bounds = np.cumsum(z["lens"])[:-1]
    return ([str(d) for d in z["doc_ids"]],
            list(zip(np.split(z["indices"], bounds),
                     np.split(z["values"], bounds))))


def serving_postings_index(vocab_size: int, doc_ids, vecs, device):
    """The ``--postings-index`` row's index: the serving configuration
    (P=256 postings a term, the query's 32 strongest terms, C=1000
    candidates clamped to the corpus, sort phase 1, the exact rescore),
    built over ``vecs`` on ``device``."""
    from splade_tpu_torch.ops.postings_index import PostingsIndex

    index = PostingsIndex(
        vocab_size=vocab_size, n_postings=256, query_top_t=32,
        rescore_candidates=min(1000, len(doc_ids)), scoring="sort",
        device=device)
    for did, (idx, vals) in zip(doc_ids, vecs):
        index.add(did, idx, vals)
    index.build()
    return index


class BenchmarkRunner:
    def __init__(
        self,
        data: BenchmarkData,
        sparse_encoder=None,
        dense_encoder=None,
        tokenizer=None,
        top_k: int = 10,
        include_hybrid: bool = True,
        output_dir: str = "outputs/benchmark",
        index_backend: str = "exact",
        external_dense_encoder=None,
        bm25_analyzer=None,
        cluster_index: bool = False,
        postings_index: bool = False,
        device: DeviceLike = None,
    ):
        if cluster_index:
            refuse_cluster_index()
        if index_backend not in ("exact", "gpu"):
            raise ValueError(f"index_backend {index_backend!r}: 'exact' or "
                             "'gpu'")
        self.device = resolve_device(device)
        self.data = data
        self.sparse_encoder = sparse_encoder
        self.dense_encoder = dense_encoder
        self.external_dense_encoder = external_dense_encoder
        self.bm25_analyzer = bm25_analyzer
        self.tokenizer = tokenizer
        self.top_k = top_k
        self.include_hybrid = include_hybrid
        self.index_backend = index_backend
        self.postings_index = postings_index
        self.output_dir = Path(output_dir)
        self.searchers: Dict[str, BaseSearcher] = {}
        self.results: Dict[str, List[QueryResult]] = {}
        self._encoded = None  # (doc_ids, sparse vecs) cache

    def _encoder_fingerprint(self) -> str:
        """Identifies the sparse encoder the cache was produced with —
        vectors from checkpoint A must never be served for checkpoint B."""
        enc = self.sparse_encoder
        if enc is None:
            return ""
        return "|".join(str(x) for x in (
            getattr(enc, "source_path", ""),
            getattr(enc, "doc_top_k", 0), getattr(enc, "query_top_k", 0)))

    def save_encodings(self, path: str) -> None:
        """Persist encoded sparse vectors so reruns skip re-encoding
        (reference: --skip-setup via saved benchmark_data.json)."""
        import numpy as np

        if not self._encoded:
            raise RuntimeError("run setup() before save_encodings()")
        doc_ids, vecs = self._encoded
        # lens + concat with fixed dtypes (same layout as postings save()):
        # the archive must load with allow_pickle=False — an object array
        # would make --encodings-cache files a pickle-execution vector
        lens = np.fromiter((len(i) for i, _ in vecs), np.int64,
                           count=len(vecs))
        np.savez_compressed(
            path,
            doc_ids=np.asarray(doc_ids, dtype=np.str_),
            lens=lens,
            indices=(np.concatenate([np.asarray(i) for i, _ in vecs])
                     if len(vecs) else np.zeros(0, np.int32)),
            values=(np.concatenate([np.asarray(v) for _, v in vecs])
                    if len(vecs) else np.zeros(0, np.float32)),
            fingerprint=np.asarray(self._encoder_fingerprint()))
        logger.info("saved encodings -> %s", path)

    def load_encodings(self, path: str) -> bool:
        """Returns True iff the cache was usable (caller re-saves on
        False so a legacy/stale file is overwritten, not kept forever)."""
        import numpy as np

        # np.load(allow_pickle=False) on an npz does NOT raise eagerly —
        # pickle enforcement happens lazily per-array access — so every
        # z[...] access below stays inside the try. A legacy object-array
        # cache (or one with a different schema) must degrade to a
        # re-encode, never abort the benchmark.
        try:
            z = np.load(path, allow_pickle=False)
            fp = str(z["fingerprint"]) if "fingerprint" in z.files else ""
            want = self._encoder_fingerprint()
            if fp != want:
                logger.warning(
                    "ignoring encodings cache %s: built by %r but this run "
                    "uses %r — pass the matching --checkpoint to reuse it "
                    "(the corpus will re-encode and overwrite)",
                    path, fp or "<unfingerprinted legacy cache>", want)
                return False
            self._encoded = split_encodings(z)
        except (ValueError, KeyError) as e:
            # ValueError: object array hit with allow_pickle=False (a
            # legacy pickled cache — loading it would be an arbitrary-
            # code-execution vector, it is only a cache so re-encode);
            # KeyError: pre-lens schema. Either way: rebuild.
            logger.warning(
                "ignoring unusable encodings cache %s (%s) — the corpus "
                "will re-encode and overwrite it with the pickle-free "
                "format", path, e)
            return False
        logger.info("loaded %d encoded docs from %s",
                    len(self._encoded[0]), path)
        return True

    @staticmethod
    def _memoize_query_encodes(encoder, method_name: str) -> None:
        """Cache per-query encodings on the encoder instance: the runner
        executes 11+ methods per query, and every sparse/dense hybrid
        re-encoded the SAME query through the full model — multiplying
        benchmark wall-clock several-fold for identical vectors. Latency
        percentiles still reflect real work: the first (non-hybrid) method
        that uses an encoder pays the encode; hybrids reuse it, which
        mirrors how a production fusion service would share one encode.

        The cache lives on the encoder as ``_query_cache`` and setup()
        CLEARS it every call: an encoder reused after its params change
        (in-process re-benchmark after training) must never serve stale
        vectors."""
        fn = getattr(encoder, method_name)
        cache: Dict[str, object] = {}
        encoder._query_cache = cache

        def wrapped(query):
            if query not in cache:
                cache[query] = fn(query)
            return cache[query]

        setattr(encoder, method_name, wrapped)

    def setup(self) -> None:
        """Build all indexes from the corpus (reference: runner setup +
        _index_documents)."""
        if self.sparse_encoder is not None:
            if getattr(self.sparse_encoder, "_query_memoized", False):
                self.sparse_encoder._query_cache.clear()
            else:
                self._memoize_query_encodes(self.sparse_encoder,
                                            "encode_for_query")
                self.sparse_encoder._query_memoized = True
        import numpy as np

        for enc in (self.dense_encoder, self.external_dense_encoder):
            if enc is None:
                continue
            if getattr(enc, "_query_memoized", False):
                enc._query_cache.clear()
                continue
            fn = enc.encode
            cache: Dict[str, object] = {}
            enc._query_cache = cache

            def one(q, _fn=fn, _c=cache):
                if q not in _c:
                    _c[q] = _fn([q])[0]
                return _c[q]

            enc.encode = (lambda texts, _fn=fn, _one=one:
                          np.asarray([_one(t) for t in texts])
                          if len(texts) == 1 else _fn(texts))
            enc._query_memoized = True
        doc_ids = list(self.data.corpus.keys())
        texts = [self.data.corpus[d] for d in doc_ids]
        t0 = time.time()

        if self.bm25_analyzer is not None:
            bm25 = BM25Index(analyzer=self.bm25_analyzer)
        elif self.tokenizer is not None:
            bm25 = BM25Index(analyzer=make_wordpiece_analyzer(self.tokenizer))
        else:
            bm25 = BM25Index()
        bm25.add_documents(list(zip(doc_ids, texts)))
        bm25.finalize()
        logger.info("BM25 indexed %d docs in %.1fs", len(doc_ids), time.time() - t0)

        sparse_index = None
        if self.sparse_encoder is not None:
            t0 = time.time()
            if self._encoded and list(self._encoded[0]) == doc_ids:
                vecs = self._encoded[1]
                logger.info("reusing %d cached encodings", len(vecs))
            else:
                vecs = self.sparse_encoder.encode_documents(texts)
                self._encoded = (doc_ids, vecs)
            vocab = len(self.tokenizer) if self.tokenizer else 50000
            if self.index_backend == "gpu":
                from splade_tpu_torch.ops.impact_index import ImpactIndex

                sparse_index = ImpactIndex(vocab_size=vocab,
                                           device=self.device)
            else:
                sparse_index = ExactSparseIndex(vocab_size=vocab)
            for did, (idx, vals) in zip(doc_ids, vecs):
                sparse_index.add(did, idx, vals)
            if self.index_backend == "gpu":
                sparse_index.build()
            avg_nnz = sparse_index.nnz / max(len(doc_ids), 1)
            logger.info("sparse-encoded %d docs in %.1fs (avg %.1f nnz/doc)",
                        len(doc_ids), time.time() - t0, avg_nnz)

        postings_idx = None
        if self.postings_index and self.sparse_encoder is not None:
            # the index config that would serve, not only the exact
            # backends
            t0 = time.time()
            postings_idx = serving_postings_index(vocab, doc_ids, vecs,
                                                  self.device)
            logger.info("postings (serving config) indexed %d docs in "
                        "%.1fs", len(doc_ids), time.time() - t0)

        dense_index = None
        if self.dense_encoder is not None:
            t0 = time.time()
            mat = self.dense_encoder.encode(texts)
            dense_index = ExactDenseIndex(mat.shape[1])
            for did, vec in zip(doc_ids, mat):
                dense_index.add(did, vec)
            logger.info("dense-encoded %d docs in %.1fs", len(doc_ids), time.time() - t0)

        self.searchers = create_searchers(
            bm25_index=bm25,
            sparse_encoder=self.sparse_encoder, sparse_index=sparse_index,
            dense_encoder=self.dense_encoder, dense_index=dense_index)
        if postings_idx is not None:
            s = NeuralSparseSearcher(self.sparse_encoder, postings_idx)
            s.name = "neural_sparse_postings"
            self.searchers["neural_sparse_postings"] = s
        if self.external_dense_encoder is not None:
            # a 4th model: embeddings precomputed offline, exact index here
            t0 = time.time()
            mat = self.external_dense_encoder.encode(texts)
            ext_index = ExactDenseIndex(mat.shape[1])
            for did, vec in zip(doc_ids, mat):
                ext_index.add(did, vec)
            self.searchers["external_dense"] = DenseSearcher(
                self.external_dense_encoder, ext_index, name="external_dense")
            logger.info("external-dense indexed %d docs in %.1fs",
                        len(doc_ids), time.time() - t0)
        if self.include_hybrid:
            self.searchers.update(create_hybrid_searchers(self.searchers))

    def run(self) -> Dict[str, Dict[str, float]]:
        """Query loop per method (reference: runner.py:155-238)."""
        if not self.searchers:
            self.setup()
        summary: Dict[str, Dict[str, float]] = {}
        for name, searcher in self.searchers.items():
            t0 = time.time()
            results: List[QueryResult] = []
            for qid, qtext in self.data.queries.items():
                try:
                    res = searcher.search(qtext, self.top_k)
                except Exception as e:  # degrade like the reference (:186-196)
                    logger.warning("query %s failed on %s: %s", qid, name, e)
                    res = None
                results.append(QueryResult(
                    query_id=qid,
                    retrieved_ids=res.doc_ids if res else [],
                    relevant_ids=self.data.qrels.get(qid, set()),
                    latency_ms=res.latency_ms if res else 0.0))
            self.results[name] = results
            summary[name] = aggregate_metrics(results)
            logger.info("%s: R@1=%.3f MRR=%.3f (%.1fs)", name,
                        summary[name]["recall@1"], summary[name]["mrr"],
                        time.time() - t0)
        return summary

    def statistical_tests(self, baseline: str = "bm25") -> Dict[str, Dict[str, float]]:
        out = {}
        base = self.results.get(baseline)
        if not base:
            return out
        for name, res in self.results.items():
            if name != baseline and len(res) == len(base):
                out[f"{name} vs {baseline}"] = paired_t_test(res, base)
        return out

    def save(self, summary, stat_tests) -> None:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "metrics.json").write_text(json.dumps({
            "dataset": self.data.name,
            "num_queries": len(self.data.queries),
            "num_docs": len(self.data.corpus),
            "methods": summary,
            "statistical_tests": stat_tests,
        }, indent=2))
        report = generate_report(
            self.data.name, summary, stat_tests,
            metadata={"queries": len(self.data.queries),
                      "docs": len(self.data.corpus)})
        (self.output_dir / "report.md").write_text(report)
        logger.info("wrote %s", self.output_dir / "report.md")


def main(argv: Optional[list] = None) -> int:
    from splade_tpu_torch.utils.logging import setup_logging

    # argparse defaults come from BenchmarkConfig.from_env so the
    # documented BENCH_<FIELD> env convention actually takes effect
    # (explicit CLI flags still win).
    from splade_tpu_torch.benchmark.config import BenchmarkConfig

    env_cfg = BenchmarkConfig.from_env()
    p = argparse.ArgumentParser("splade-tpu benchmark")
    p.add_argument("--dataset", default=env_cfg.dataset,
                   help="ko-strategyqa | miracl-ko | mrtydi-ko | triplet-val | local name")
    p.add_argument("--checkpoint", default=env_cfg.checkpoint,
                   help="training checkpoint dir or exported HF dir")
    p.add_argument("--val-files", default=None,
                   help="for --dataset triplet-val: glob of val jsonl")
    p.add_argument("--sample-size", type=int, default=env_cfg.sample_size)
    p.add_argument("--top-k", type=int, default=env_cfg.top_k)
    p.add_argument("--no-hybrid", action="store_true",
                   default=not env_cfg.include_hybrid)
    p.add_argument("--no-sparse", action="store_true")
    p.add_argument("--index", default=env_cfg.index_backend,
                   choices=["exact", "gpu"],
                   help="sparse index backend: exact CPU CSR or the "
                        "device-resident ImpactIndex")
    p.add_argument("--cluster-index", action="store_true",
                   help="the cluster-union ANN index row: not ported yet, "
                        "refused")
    p.add_argument("--postings-index", action="store_true",
                   help="also run neural_sparse through the PRODUCTION "
                        "postings serving config (P=256/C=1000, sort "
                        "phase-1 + match rescore — adds a "
                        "neural_sparse_postings method row)")
    p.add_argument("--bm25-analyzer", default="wordpiece",
                   choices=["wordpiece", "whitespace", "korean-heuristic",
                            "morphological"],
                   help="BM25 term analyzer; 'morphological' needs "
                        "kiwipiepy/mecab-ko (nori parity), "
                        "'korean-heuristic' is the offline josa-stripping "
                        "stand-in (see scripts/analyzer_sensitivity.py)")
    p.add_argument("--query-top-k", type=int, default=env_cfg.query_top_k,
                   help="strongest query terms kept (reference: "
                        "searchers.py:161-170 builds top-64 rank_feature "
                        "clauses); 0 = full query vector")
    p.add_argument("--encodings", default=None,
                   help="npz path: reuse if it exists, else save after encoding")
    p.add_argument("--dense-checkpoint", default=None,
                   help="local HF dir of the dense (BGE-M3 / XLM-R) model — "
                        "enables the semantic baseline and all sparse+dense "
                        "hybrids (reference: encoders.py:405-422 "
                        "create_encoders_v33)")
    p.add_argument("--dense-max-length", type=int, default=512,
                   help="dense encoder truncation length")
    p.add_argument("--dense-batch-size", type=int, default=16)
    p.add_argument("--external-dense", default=None,
                   help="npz of precomputed external-model embeddings "
                        "(hashes+embeddings) — joins as a 4th model with "
                        "cross-model hybrids (reference comprehensive bench)")
    p.add_argument("--output-dir",
                   default=None if env_cfg.output_dir == "outputs/benchmark"
                   else env_cfg.output_dir)
    p.add_argument("--device", default="cuda",
                   help="device of the encoders and the device indexes "
                        "(cpu for a run without a card)")
    args = p.parse_args(argv)
    setup_logging()
    if args.cluster_index:  # refused before a tokenizer or model loads
        refuse_cluster_index()
    device = resolve_device(args.device)

    from splade_tpu_torch.utils import tokenizer as tokenizers

    tokenizer = tokenizers.create_tokenizer()
    if args.dataset == "triplet-val":
        if not args.val_files:
            raise SystemExit("--dataset triplet-val requires --val-files")
        data = load_triplet_benchmark(args.val_files, args.sample_size)
    else:
        data = load_benchmark(args.dataset)
        if args.sample_size and len(data.queries) > args.sample_size:
            # Stratification-free deterministic query sample (reference:
            # BenchmarkConfig.sample_size, seed 42) — without this the flag
            # was silently ignored for HF/local datasets.
            import numpy as _np

            keep = set(_np.random.default_rng(42).choice(
                sorted(data.queries), size=args.sample_size, replace=False))
            data.queries = {q: t for q, t in data.queries.items() if q in keep}
            data.qrels = {q: r for q, r in data.qrels.items() if q in keep}
            logger.info("sampled %d queries (--sample-size)", len(keep))

    sparse_encoder = None
    if args.encodings and (args.no_sparse or not args.checkpoint):
        raise SystemExit("--encodings needs a sparse encoder "
                         "(--checkpoint without --no-sparse)")
    if args.checkpoint and not args.no_sparse:
        from splade_tpu_torch.benchmark.encoders import SparseEncoderV33

        sparse_encoder = SparseEncoderV33.from_any(
            args.checkpoint, tokenizer, query_top_k=args.query_top_k,
            device=device)

    dense_encoder = None
    if args.dense_checkpoint:
        from splade_tpu_torch.benchmark.encoders import TeacherDenseEncoder

        dense_encoder = TeacherDenseEncoder.from_hf_dir(
            args.dense_checkpoint, max_length=args.dense_max_length,
            batch_size=args.dense_batch_size, device=device)
        logger.info("dense encoder loaded from %s (dim=%d)",
                    args.dense_checkpoint, dense_encoder.dim)

    external = None
    if args.external_dense:
        from splade_tpu_torch.benchmark.encoders import PrecomputedDenseEncoder

        external = PrecomputedDenseEncoder(args.external_dense)

    bm25_analyzer = None
    if args.bm25_analyzer != "wordpiece":
        from splade_tpu_torch.benchmark.bm25 import resolve_analyzer

        bm25_analyzer = resolve_analyzer(args.bm25_analyzer, tokenizer)

    runner = BenchmarkRunner(
        data, sparse_encoder=sparse_encoder, dense_encoder=dense_encoder,
        tokenizer=tokenizer,
        top_k=args.top_k, include_hybrid=not args.no_hybrid,
        output_dir=args.output_dir or f"outputs/benchmark/{args.dataset}",
        index_backend=args.index, external_dense_encoder=external,
        bm25_analyzer=bm25_analyzer, postings_index=args.postings_index,
        device=device)
    if args.encodings and not args.encodings.endswith(".npz"):
        # np.savez_compressed appends .npz; normalize up front so the
        # exists() checks and the save agree on one path
        args.encodings += ".npz"
    cache_loaded = (Path(args.encodings).exists()
                    and runner.load_encodings(args.encodings)
                    if args.encodings else False)
    summary = runner.run()
    if args.encodings and not cache_loaded:
        # also overwrites a legacy/stale cache load_encodings rejected
        runner.save_encodings(args.encodings)
    tests = runner.statistical_tests()
    runner.save(summary, tests)
    for name, m in sorted(summary.items(), key=lambda kv: -kv[1]["recall@1"]):
        print(f"{name:24s} R@1={m['recall@1']:.3f} R@5={m['recall@5']:.3f} "
              f"MRR={m['mrr']:.3f} p50={m['latency_p50_ms']:.1f}ms")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
