"""Corpus IDF: loader for the C++ tool's output + pure-python reference
(a copy of ``splade_tpu/utils/idf.py``).

Reference: tools/idf-compute/load_idf.py (bin -> tensor loader) and
main.rs:124-235 (the counting/smoothing semantics). ``compute_idf`` is the
slow exact reference used for tests and small corpora; the C++ tool
(tools/idf_compute/) is the production path (~20x faster than python).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import numpy as np


def load_idf(prefix: str) -> tuple[np.ndarray, dict]:
    """Load <prefix>.bin (little-endian f32) + <prefix>.json metadata."""
    meta = json.loads(Path(prefix + ".json").read_text())
    idf = np.fromfile(prefix + ".bin", dtype="<f4")
    assert len(idf) == meta["vocab_size"], (len(idf), meta)
    return idf, meta


def compute_idf(
    texts: Iterable[str],
    tokenizer,
    vocab_size: int,
    mode: str = "bm25",
) -> tuple[np.ndarray, dict]:
    """Exact python reference of the C++ tool (HF tokenizer, same smoothing)."""
    df = np.zeros(vocab_size, np.int64)
    n_docs = 0
    for text in texts:
        ids = tokenizer(text, add_special_tokens=False,
                        truncation=False)["input_ids"]
        for tid in set(ids):
            if 0 <= tid < vocab_size:
                df[tid] += 1
        n_docs += 1
    if mode == "bm25":
        idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    else:
        idf = np.log(n_docs / (df + 1.0))
    meta = {"num_docs": n_docs, "vocab_size": vocab_size, "mode": mode,
            "df_nonzero": int((df > 0).sum())}
    return idf.astype(np.float32), meta


def triplet_texts(jsonl_paths: Sequence[str]) -> List[str]:
    """Every query/positive/negative(s) text of the shards, one doc each
    (matches the C++ tool's counting unit)."""
    out: List[str] = []
    for p in jsonl_paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                for key in ("query", "positive", "negative"):
                    v = row.get(key)
                    if isinstance(v, str) and v:
                        out.append(v)
                for v in row.get("negatives") or []:
                    if isinstance(v, str) and v:
                        out.append(v)
    return out
