"""Keyed benchmark-row recorder with same-key overwrite protection.

Two bench stages that pass the same ``--key`` must not let the second
silently overwrite the first's row. This module is the one place bench
rows are persisted: a write to an existing key whose *settings* differ
from the stored row is refused (the caller picked a stale key for a new
configuration), while re-measuring the same configuration updates in
place (measurement fields — recall/QPS/timing/device — are expected to
vary run to run). Sweeps key every point by its full parameter tuple for
the same reason.

The port's own copy of ``splade_tpu/benchmark/record.py``, which
imports no framework.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

#: Fields that describe the *outcome* of a run (or its environment),
#: not its configuration. Two rows under one key may differ in these;
#: any other differing field means the key is being reused for a
#: different experiment and the write is refused.
MEASUREMENT_FIELDS = frozenset({
    "recall", "build_s", "search_s", "qps", "total_s", "ms_per_query",
    "device", "weights", "device_mb", "memory_mb", "mean_doc_nnz",
    "truncated_pct", "n_clusters", "candidate_pool", "note",
    "encode_s", "exact_s", "p50_ms", "p99_ms",
})


class KeyCollisionError(ValueError):
    """A bench key is being rewritten with different settings."""


def settings_of(entry: Dict) -> Dict:
    return {k: v for k, v in entry.items() if k not in MEASUREMENT_FIELDS}


def record_row(out_path, key: str, entry: Dict, force: bool = False) -> None:
    """Insert/update ``entry`` under ``key`` in the JSON dict at
    ``out_path`` (created if absent). Refuses to overwrite an existing
    key whose settings differ unless ``force``."""
    out = Path(out_path)
    data = json.loads(out.read_text()) if out.exists() else {}
    old = data.get(key)
    if old is not None and not force and isinstance(old, dict):
        old_s, new_s = settings_of(old), settings_of(entry)
        if old_s != new_s:
            diff = sorted(set(old_s.items()) ^ set(new_s.items()))
            raise KeyCollisionError(
                f"bench key {key!r} in {out} already holds a row with "
                f"different settings (differing: {diff}). Use a distinct "
                "key per configuration, or force=True to overwrite.")
    data[key] = entry
    tmp = out.with_suffix(out.suffix + ".tmp")
    tmp.write_text(json.dumps(data, indent=2))
    tmp.replace(out)
