"""Teacher-score precompute for MarginMSE KD.

Reference: scripts/precompute_teacher_scores.py:44-351 — md5-dedup unique
texts, encode once with the dense teacher, attach per-triplet
``teacher_pos_score`` / ``teacher_neg_score`` (cosine via normalized dot),
write augmented JSONL, and cache ``teacher_embeddings.npy`` +
``text_to_idx.json`` for reuse by the multi-negative miner.

The port's own copy of ``splade_tpu/mining/teacher_scores.py``, which
imports no framework.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _text_key(text: str) -> str:
    return hashlib.md5(text.encode("utf-8")).hexdigest()


def _encode_batched(teacher, texts: Sequence[str],
                    batch_size: int = 256) -> np.ndarray:
    """Chunked teacher encode: one call on a million-text corpus would
    materialize the whole tokenized batch at once (same pattern as
    preprocessing/miners.py EncoderHardNegativeMiner._encode)."""
    if not texts:
        return np.zeros((0, 0), np.float32)
    parts = [np.asarray(teacher.encode(list(texts[i:i + batch_size])),
                        np.float32)
             for i in range(0, len(texts), batch_size)]
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def collect_unique_texts(rows: Sequence[dict]) -> tuple[List[str], Dict[str, int]]:
    """All distinct query/positive/negative texts, keyed by md5."""
    texts: List[str] = []
    key_to_idx: Dict[str, int] = {}
    for row in rows:
        cands = [row.get("query"), row.get("positive"), row.get("negative")]
        cands.extend(row.get("negatives") or [])
        for t in cands:
            if not t:
                continue
            k = _text_key(t)
            if k not in key_to_idx:
                key_to_idx[k] = len(texts)
                texts.append(t)
    return texts, key_to_idx


def precompute_teacher_scores(
    input_paths: Sequence[str] | str,
    output_path: str,
    teacher,
    cache_dir: Optional[str] = None,
) -> dict:
    """Augment triplet shards with teacher scores.

    ``teacher`` needs ``encode(texts) -> [N, D]`` (normalized). The embedding
    cache is reused if present (idempotent pipelines; reference
    run_v34_pipeline.sh skip-if-cached behavior).
    """
    import glob as _glob

    if isinstance(input_paths, str):
        input_paths = [input_paths]
    files: List[str] = []
    for p in input_paths:
        files.extend(sorted(_glob.glob(p)) or ([p] if Path(p).exists() else []))
    rows: List[dict] = []
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            rows.extend(json.loads(l) for l in f if l.strip())

    texts, key_to_idx = collect_unique_texts(rows)
    cache = Path(cache_dir) if cache_dir else Path(output_path).parent / "teacher_cache"
    cache.mkdir(parents=True, exist_ok=True)
    emb_path = cache / "teacher_embeddings.npy"
    idx_path = cache / "text_to_idx.json"
    if emb_path.exists() and idx_path.exists():
        emb = np.load(emb_path)
        cached_idx = json.loads(idx_path.read_text())
        # coverage check: inputs may have grown since the cache was built
        # (a later mining pass adds negatives, a new shard lands) — encode
        # ONLY the missing texts and extend the cache instead of silently
        # leaving new rows unscored
        missing = [t for t in texts if _text_key(t) not in cached_idx]
        if missing:
            logger.info("cache misses %d of %d texts: encoding the delta",
                        len(missing), len(texts))
            new_emb = _encode_batched(teacher, missing)
            for t in missing:
                cached_idx[_text_key(t)] = len(cached_idx)
            emb = np.concatenate([emb, new_emb])
            np.save(emb_path, emb)
            idx_path.write_text(json.dumps(cached_idx))
        key_to_idx = cached_idx
        logger.info("reusing cached embeddings: %s (%d texts)", emb_path, len(emb))
    else:
        logger.info("encoding %d unique texts with teacher", len(texts))
        emb = _encode_batched(teacher, texts)
        np.save(emb_path, emb)
        idx_path.write_text(json.dumps(key_to_idx))

    def score(a: str, b: str) -> float:
        return float(emb[key_to_idx[_text_key(a)]] @ emb[key_to_idx[_text_key(b)]])

    n_scored = 0
    out_path = Path(output_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        for row in rows:
            # score the row ATOMICALLY: a partial row (pos score written,
            # negative missing) would make the collator fabricate a 0.0
            # neg score and train MarginMSE on a fake margin
            try:
                pos = score(row["query"], row["positive"])
                if row.get("negatives"):
                    negs = {"teacher_neg_scores": [
                        score(row["query"], n) for n in row["negatives"]]}
                elif row.get("negative"):
                    negs = {"teacher_neg_score":
                            score(row["query"], row["negative"])}
                else:
                    negs = {}
                row["teacher_pos_score"] = pos
                row.update(negs)
                n_scored += 1
            except KeyError:
                pass  # row left entirely unscored -> collator skips its KD
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    meta = {"rows": len(rows), "scored": n_scored, "unique_texts": len(key_to_idx),
            "cache": str(cache)}
    logger.info("teacher precompute: %s", meta)
    return meta
