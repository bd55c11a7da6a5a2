"""Benchmark dataset loading.

Reference: benchmark/data_loader.py:40-200 (triplet-val benchmark with
stratified difficulty sampling and a synthetic doc_{i}_{pos,neg} corpus) and
benchmark/hf_data_loader.py:53-459 (MTEB loaders: Ko-StrategyQA dev
corpus/queries/qrels; MIRACL-ko dev queries with qrel passages + random
distractors to 10K docs, seed 42; Mr.TyDi-ko test split; local ecom-ko).

Air-gapped behavior: the HF loaders pull from the local datasets cache or a
local directory tree only (``SPLADE_BENCH_DATA``); they never hit the
network. The distractor-sampling methodology (seed 42, fill to 10K) is
reproduced exactly so numbers are comparable when data is present.

The port's own copy of ``splade_tpu/benchmark/data.py``, which
imports no framework.
"""

from __future__ import annotations

import json
import logging
import os
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

logger = logging.getLogger(__name__)


@dataclass
class BenchmarkData:
    name: str
    corpus: Dict[str, str]                 # doc_id -> text
    queries: Dict[str, str]                # query_id -> text
    qrels: Dict[str, Set[str]]             # query_id -> relevant doc_ids
    metadata: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        # Drop queries with no relevant docs in the corpus.
        keep = {q for q, rel in self.qrels.items()
                if any(d in self.corpus for d in rel)}
        self.queries = {q: t for q, t in self.queries.items() if q in keep}
        self.qrels = {q: {d for d in rel if d in self.corpus}
                      for q, rel in self.qrels.items() if q in keep}


def load_triplet_benchmark(
    val_files: Sequence[str] | str,
    sample_size: int = 2000,
    seed: int = 42,
) -> BenchmarkData:
    """Val-triplet benchmark: synthetic corpus doc_{i}_{pos,neg}, stratified
    sampling by difficulty (reference: data_loader.py:40-200)."""
    from splade_tpu_torch.data.loader import load_training_data

    samples = list(load_training_data(val_files))
    rng = random.Random(seed)
    by_diff: Dict[str, List[dict]] = {}
    for s in samples:
        by_diff.setdefault(s.get("difficulty", ""), []).append(s)
    chosen: List[dict] = []
    if sample_size and len(samples) > sample_size:
        for diff, group in sorted(by_diff.items()):
            take = max(1, round(sample_size * len(group) / len(samples)))
            chosen.extend(rng.sample(group, min(take, len(group))))
        chosen = chosen[:sample_size]
    else:
        chosen = samples
    corpus, queries, qrels = {}, {}, {}
    for i, s in enumerate(chosen):
        qid = f"q_{i}"
        corpus[f"doc_{i}_pos"] = s["positive"]
        negs = s.get("negatives") or ([s["negative"]] if s.get("negative") else [])
        if not isinstance(negs, list):
            # a string here would iterate per CHARACTER, flooding the
            # corpus with one-char junk docs (collator.py guards the same)
            negs = [negs]
        for j, n in enumerate(negs):
            corpus[f"doc_{i}_neg{j}"] = n
        queries[qid] = s["query"]
        qrels[qid] = {f"doc_{i}_pos"}
    return BenchmarkData("triplet-val", corpus, queries, qrels)


def load_local_jsonl_benchmark(data_dir: str, name: str = "local") -> BenchmarkData:
    """BEIR-style local layout: corpus.jsonl (_id, text), queries.jsonl
    (_id, text), qrels.tsv (qid \\t docid \\t rel)."""
    d = Path(data_dir)
    corpus, queries, qrels = {}, {}, {}
    with open(d / "corpus.jsonl", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            text = row.get("text", "")
            if row.get("title"):
                text = f"{row['title']} {text}"
            corpus[str(row["_id"])] = text
    with open(d / "queries.jsonl", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            queries[str(row["_id"])] = row["text"]
    with open(d / "qrels.tsv", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3 or parts[0] in ("query-id", "qid"):
                continue
            qid, did, rel = parts[0], parts[1], float(parts[2])
            if rel > 0:
                qrels.setdefault(qid, set()).add(did)
    return BenchmarkData(name, corpus, queries, qrels)


def _bench_data_root() -> Optional[Path]:
    root = os.environ.get("SPLADE_BENCH_DATA")
    return Path(root) if root else None


def load_ko_strategyqa() -> BenchmarkData:
    """Ko-StrategyQA dev (reference: hf_data_loader.py:53-118): full corpus,
    dev queries, qrels. 592 queries / 9,251 docs in the published run."""
    return _load_mteb_style("ko-strategyqa", "taeminlee/Ko-StrategyQA", "dev")


def load_miracl_ko(num_docs: int = 10_000, seed: int = 42) -> BenchmarkData:
    """MIRACL-ko dev (reference: hf_data_loader.py:121-249): qrel passages
    plus random distractors filled to ``num_docs`` docs with ``seed``."""
    return _load_mteb_style("miracl-ko", "miracl/miracl", "dev",
                            distractor_fill=num_docs, seed=seed)


def load_mrtydi_ko(num_docs: int = 10_000, seed: int = 42) -> BenchmarkData:
    """Mr.TyDi-ko test (reference: hf_data_loader.py:252-398)."""
    return _load_mteb_style("mrtydi-ko", "castorini/mr-tydi", "test",
                            distractor_fill=num_docs, seed=seed)


def _load_mteb_style(
    name: str,
    hf_name: str,
    split: str,
    distractor_fill: int = 0,
    seed: int = 42,
) -> BenchmarkData:
    """Load an MTEB-style dataset from the local data root or HF cache.

    Local layout (``$SPLADE_BENCH_DATA/<name>/``) takes precedence:
    corpus.jsonl / queries.jsonl / qrels.tsv (BEIR-style). Otherwise try the
    HF datasets cache in offline mode. Distractor methodology: keep all qrel
    docs, then add corpus docs sampled with ``random.Random(seed)`` until
    ``distractor_fill`` total (reference: hf_data_loader.py:181-214).
    """
    root = _bench_data_root()
    if root and (root / name).exists():
        data = load_local_jsonl_benchmark(str(root / name), name)
    else:
        data = _load_from_hf_cache(name, hf_name, split)
    if distractor_fill and len(data.corpus) > distractor_fill:
        rng = random.Random(seed)
        qrel_docs = set().union(*data.qrels.values()) if data.qrels else set()
        pool = sorted(d for d in data.corpus if d not in qrel_docs)
        n_extra = max(distractor_fill - len(qrel_docs), 0)
        keep = qrel_docs | set(rng.sample(pool, min(n_extra, len(pool))))
        data = BenchmarkData(
            data.name, {d: data.corpus[d] for d in keep}, data.queries,
            data.qrels, data.metadata)
    return data


def _load_from_hf_cache(name: str, hf_name: str, split: str) -> BenchmarkData:
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    try:
        import datasets  # noqa: F401
    except ImportError as e:
        raise FileNotFoundError(
            f"benchmark dataset '{name}' unavailable: datasets lib missing ({e})")
    try:
        if name == "ko-strategyqa":
            import datasets

            corpus_ds = datasets.load_dataset(hf_name, "corpus", split="corpus")
            queries_ds = datasets.load_dataset(hf_name, "queries", split="queries")
            qrels_ds = datasets.load_dataset(hf_name, "default", split=split)
            corpus = {str(r["_id"]): f"{r.get('title','')} {r['text']}".strip()
                      for r in corpus_ds}
            queries = {str(r["_id"]): r["text"] for r in queries_ds}
            qrels: Dict[str, Set[str]] = {}
            for r in qrels_ds:
                if float(r.get("score", 1)) > 0:
                    qrels.setdefault(str(r["query-id"]), set()).add(str(r["corpus-id"]))
            return BenchmarkData(name, corpus, queries, qrels)
        if name == "miracl-ko":
            import datasets

            ds = datasets.load_dataset(hf_name, "ko", split=split)
            corpus, queries, qrels = {}, {}, {}
            for r in ds:
                qid = str(r["query_id"])
                queries[qid] = r["query"]
                for p in r.get("positive_passages", []):
                    did = str(p["docid"])
                    corpus[did] = f"{p.get('title','')} {p['text']}".strip()
                    qrels.setdefault(qid, set()).add(did)
                for p in r.get("negative_passages", []):
                    did = str(p["docid"])
                    corpus[did] = f"{p.get('title','')} {p['text']}".strip()
            return BenchmarkData(name, corpus, queries, qrels)
        if name == "mrtydi-ko":
            import datasets

            ds = datasets.load_dataset(hf_name, "korean", split=split)
            corpus, queries, qrels = {}, {}, {}
            for r in ds:
                qid = str(r["query_id"])
                queries[qid] = r["query"]
                for p in r.get("positive_passages", []):
                    did = str(p["docid"])
                    corpus[did] = f"{p.get('title','')} {p['text']}".strip()
                    qrels.setdefault(qid, set()).add(did)
                for p in r.get("negative_passages", []):
                    did = str(p["docid"])
                    corpus[did] = f"{p.get('title','')} {p['text']}".strip()
            return BenchmarkData(name, corpus, queries, qrels)
    except Exception as e:
        raise FileNotFoundError(
            f"benchmark dataset '{name}' not in local HF cache and no "
            f"$SPLADE_BENCH_DATA/{name}/ directory: {e}") from e
    raise FileNotFoundError(f"unknown benchmark dataset: {name}")


LOADERS = {
    "ko-strategyqa": load_ko_strategyqa,
    "miracl-ko": load_miracl_ko,
    "mrtydi-ko": load_mrtydi_ko,
}


def load_benchmark(name: str, **kwargs) -> BenchmarkData:
    if name in LOADERS:
        return LOADERS[name](**kwargs)
    root = _bench_data_root()
    if root and (root / name).exists():
        return load_local_jsonl_benchmark(str(root / name), name)
    raise FileNotFoundError(f"unknown benchmark: {name}")
