"""Multi-hard-negative mining from cached teacher embeddings.

Reference: scripts/mine_multi_negatives.py:45-481 — reuse the cached teacher
embeddings, batched inner-product search (GPU torch.mm -> jitted/numpy
matmul here) over the positive-document pool with search_k=100, select k=7
negatives from retrieval ranks 10-50 excluding the positive, attach
``negatives: [...]`` + ``teacher_neg_scores: [...]``.

The port's own copy of ``splade_tpu/mining/multi_negatives.py``, which
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


def _key(t: str) -> str:
    return hashlib.md5(t.encode("utf-8")).hexdigest()


def mine_multi_negatives(
    input_path: str,
    output_path: str,
    cache_dir: str,
    num_negatives: int = 7,
    rank_lo: int = 10,
    rank_hi: int = 50,
    search_k: int = 100,
    batch_size: int = 4096,
) -> dict:
    """Attach k mined negatives per row using the cached embedding matrix."""
    cache = Path(cache_dir)
    emb = np.load(cache / "teacher_embeddings.npy")
    key_to_idx: Dict[str, int] = json.loads((cache / "text_to_idx.json").read_text())

    rows: List[dict] = []
    with open(input_path, encoding="utf-8") as f:
        rows = [json.loads(l) for l in f if l.strip()]

    # Document pool = distinct positives.
    pool_texts: List[str] = []
    seen = set()
    for r in rows:
        p = r["positive"]
        k = _key(p)
        if k not in seen and k in key_to_idx:
            seen.add(k)
            pool_texts.append(p)
    if not pool_texts:
        raise ValueError(
            "empty mining pool: none of the input rows' positive texts are "
            "in the teacher cache's text_to_idx — wrong --cache-dir, or the "
            "cache was built from different shards (re-run "
            "precompute_teacher_scores over THESE inputs first)")
    pool_idx = np.asarray([key_to_idx[_key(t)] for t in pool_texts],
                          np.int64)
    pool = emb[pool_idx]  # [P, D]
    logger.info("mining pool: %d docs", len(pool_texts))

    q_embs = []
    valid_rows = []
    for r in rows:
        k = _key(r["query"])
        if k in key_to_idx:
            q_embs.append(key_to_idx[k])
            valid_rows.append(r)
    Q = emb[np.asarray(q_embs)]  # [N, D]

    mined = 0
    kk = min(search_k, len(pool_texts))
    for start in range(0, len(valid_rows), batch_size):
        block = Q[start:start + batch_size]
        scores = block @ pool.T  # [b, P]
        top = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        for bi in range(block.shape[0]):
            row = valid_rows[start + bi]
            order = top[bi][np.argsort(-scores[bi, top[bi]])]
            window = [int(j) for j in order[rank_lo:rank_hi]
                      if pool_texts[j] != row["positive"]][:num_negatives]
            if len(window) < num_negatives:
                # Fill ONLY from beyond the window (rank >= rank_hi): ranks
                # 0..rank_lo-1 are excluded by design as likely false
                # negatives (near-duplicates of the positive) — the whole
                # point of the 10-50 window.
                extra = [int(j) for j in order[rank_hi:]
                         if int(j) not in window
                         and pool_texts[j] != row["positive"]]
                window.extend(extra[: num_negatives - len(window)])
            if not window:
                continue
            row["negatives"] = [pool_texts[j] for j in window]
            row["teacher_neg_scores"] = [float(scores[bi, j]) for j in window]
            row.pop("negative", None)
            row.pop("teacher_neg_score", None)
            mined += 1

    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    meta = {"rows": len(rows), "mined": mined, "pool": len(pool_texts),
            "k": num_negatives}
    logger.info("multi-neg mining: %s", meta)
    return meta
