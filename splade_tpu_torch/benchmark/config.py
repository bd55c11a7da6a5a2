"""Benchmark configuration with env-var conventions.

Reference: benchmark/config.py:9-64 — host/port/region, 4 index names, model
paths, sample_size 2000, top_k 10, qlen 64 / dlen 256, documented in
.env_sample. The OpenSearch endpoint fields are replaced by backend/output
knobs (no external cluster exists in this architecture).

Env convention: ``BENCH_<FIELD>`` (e.g. BENCH_SAMPLE_SIZE=500).

The port's own copy of ``splade_tpu/benchmark/config.py``, which
imports no framework.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class BenchmarkConfig:
    dataset: str = "ko-strategyqa"
    checkpoint: Optional[str] = None
    index_backend: str = "exact"          # 'exact' | 'gpu'
    sample_size: int = 2000
    top_k: int = 10
    retrieval_k: int = 100
    query_max_length: int = 64
    doc_max_length: int = 256
    query_top_k: int = 64                 # top rank_feature clauses (reference)
    include_hybrid: bool = True
    output_dir: str = "outputs/benchmark"

    @classmethod
    def from_env(cls, **overrides) -> "BenchmarkConfig":
        kwargs = {}
        for f in dataclasses.fields(cls):
            raw = os.environ.get(f"BENCH_{f.name.upper()}")
            if raw is None:
                continue
            if f.type in ("int", int):
                kwargs[f.name] = int(raw)
            elif f.type in ("bool", bool):
                kwargs[f.name] = raw.lower() in ("1", "true", "yes")
            else:
                kwargs[f.name] = raw
        kwargs.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**kwargs)
