"""Preprocessing pipeline orchestrator
(a copy of ``splade_tpu/preprocessing/pipeline.py``).

Reference: src/preprocessing/pipeline.py:33-420 — registry of source
datasets -> download -> convert to triplets -> clean -> dedup -> optional
similarity-band mining -> shuffle -> train/val split -> JSONL shards
(``train_shard_%03d.jsonl``, ``val.jsonl``) + ``metadata.json`` stats.
"""

from __future__ import annotations

import json
import logging
import random
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from splade_tpu_torch.preprocessing.cleaners import KoreanTextCleaner
from splade_tpu_torch.preprocessing.config import PipelineConfig
from splade_tpu_torch.preprocessing.converters import get_converter
from splade_tpu_torch.preprocessing.dedup import ExactDeduplicator, MinHashDeduplicator
from splade_tpu_torch.preprocessing.downloaders import REGISTRY, load_dataset_samples
from splade_tpu_torch.preprocessing.types import RawSample, Triplet

logger = logging.getLogger(__name__)


class PreprocessingPipeline:
    def __init__(self, config: Optional[PipelineConfig] = None, miner=None):
        self.config = config or PipelineConfig()
        self.miner = miner
        self.cleaner = KoreanTextCleaner(
            min_hangul_ratio=self.config.min_hangul_ratio,
            max_special_char_ratio=self.config.max_special_char_ratio,
            min_length=self.config.min_length,
            max_length=self.config.max_seq_length * 8,
        )
        self.stats: Dict[str, object] = {}

    # ------------------------------------------------------------ stages
    def collect(self, limit_per_dataset: int = 0) -> List[RawSample]:
        keys = self.config.datasets or list(REGISTRY)
        samples: List[RawSample] = []
        for key in keys:
            try:
                samples.extend(load_dataset_samples(key, limit=limit_per_dataset))
            except Exception as e:
                logger.warning("dataset %s unavailable: %s", key, e)
        return samples

    def convert(self, samples: Sequence[RawSample]) -> List[Triplet]:
        by_task: Dict[str, List[RawSample]] = {}
        for s in samples:
            by_task.setdefault(s.task, []).append(s)
        triplets: List[Triplet] = []
        for task, group in sorted(by_task.items()):
            converted = get_converter(task).convert(group)
            logger.info("converted %s: %d samples -> %d triplets",
                        task, len(group), len(converted))
            triplets.extend(converted)
        return triplets

    def clean(self, triplets: Sequence[Triplet]) -> List[Triplet]:
        out = []
        for t in triplets:
            q = self.cleaner.clean(t.query)
            p = self.cleaner.clean(t.positive)
            if q is None or p is None:
                continue
            n = self.cleaner.clean(t.negative) if t.negative else None
            t.query, t.positive, t.negative = q, p, n
            if t.is_valid():
                out.append(t)
        return out

    def dedup(self, triplets: Sequence[Triplet]) -> List[Triplet]:
        exact = ExactDeduplicator()
        near = MinHashDeduplicator(
            threshold=self.config.dedup_threshold,
            num_perm=self.config.minhash_permutations)
        out = []
        for t in triplets:
            key = f"{t.query}\t{t.positive}"
            if exact.is_duplicate(key):
                continue
            if near.is_duplicate(key):
                continue
            out.append(t)
        return out

    def mine(self, triplets: Sequence[Triplet]) -> List[Triplet]:
        """Fill missing negatives via the configured miner (similarity band;
        reference: pipeline.py mining stage with min/max score).

        An explicitly passed miner always runs. config.use_bge_m3_mining
        (the reference's stage toggle) additionally enables mining with a
        default TF-IDF miner when none was passed; mining_batch_size is
        applied to encoder miners. Dispatch is on the miner's interface:
        band search (mining_{min,max}_score) or plain
        ``mine(queries, corpus)``."""
        if self.miner is None and self.config.use_bge_m3_mining:
            from splade_tpu_torch.preprocessing.miners import TfidfHardNegativeMiner

            self.miner = TfidfHardNegativeMiner(top_k=1)
        if self.miner is None:
            return list(triplets)
        need = [i for i, t in enumerate(triplets)
                if not t.negative and not t.negatives]
        if not need:
            return list(triplets)
        corpus = [t.positive for t in triplets]
        if hasattr(self.miner, "batch_size"):
            self.miner.batch_size = self.config.mining_batch_size
        if hasattr(self.miner, "mine_band"):
            mined = self.miner.mine_band(
                [triplets[i].query for i in need], corpus,
                min_score=self.config.mining_min_score,
                max_score=self.config.mining_max_score, k=1)
        else:
            mined = self.miner.mine(
                [triplets[i].query for i in need], corpus, k=2)
        triplets = list(triplets)
        for i, cand in zip(need, mined):
            picks = [corpus[c] for c in cand if corpus[c] != triplets[i].positive]
            if picks:
                triplets[i].negative = picks[0]
        return triplets

    def shard(self, triplets: List[Triplet]) -> Dict[str, object]:
        cfg = self.config
        rng = random.Random(cfg.seed)
        rng.shuffle(triplets)
        n_train = int(len(triplets) * cfg.train_val_split)
        train, val = triplets[:n_train], triplets[n_train:]
        out_dir = Path(cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        shard_files = []
        for si in range(0, max(len(train), 1), cfg.shard_size):
            chunk = train[si:si + cfg.shard_size]
            if not chunk and si > 0:
                break
            name = f"train_shard_{si // cfg.shard_size:03d}.jsonl"
            with open(out_dir / name, "w", encoding="utf-8") as f:
                for t in chunk:
                    f.write(json.dumps(t.to_json_dict(), ensure_ascii=False) + "\n")
            shard_files.append(name)
        with open(out_dir / "val.jsonl", "w", encoding="utf-8") as f:
            for t in val:
                f.write(json.dumps(t.to_json_dict(), ensure_ascii=False) + "\n")
        meta = {
            "total": len(triplets),
            "train": len(train),
            "val": len(val),
            "shards": shard_files,
            "with_negative": sum(1 for t in triplets if t.negative or t.negatives),
            "sources": sorted({t.source for t in triplets if t.source}),
            "pair_types": sorted({t.pair_type for t in triplets if t.pair_type}),
            "created": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        (out_dir / "metadata.json").write_text(json.dumps(meta, indent=2))
        return meta

    # ------------------------------------------------------------ run
    def run(self, limit_per_dataset: int = 0,
            samples: Optional[List[RawSample]] = None) -> Dict[str, object]:
        """Full pipeline; ``samples`` injects data directly (tests/offline)."""
        t0 = time.time()
        raw = samples if samples is not None else self.collect(limit_per_dataset)
        triplets = self.convert(raw)
        n_converted = len(triplets)
        triplets = self.clean(triplets)
        n_cleaned = len(triplets)
        triplets = self.dedup(triplets)
        n_deduped = len(triplets)
        triplets = self.mine(triplets)
        meta = self.shard(triplets)
        meta.update({
            "raw_samples": len(raw),
            "converted": n_converted,
            "after_clean": n_cleaned,
            "after_dedup": n_deduped,
            "elapsed_sec": round(time.time() - t0, 2),
        })
        (Path(self.config.output_dir) / "metadata.json").write_text(
            json.dumps(meta, indent=2))
        self.stats = meta
        logger.info("pipeline done: %s", meta)
        return meta
