"""Markdown benchmark report generation (reference: benchmark/report.py).

The port's own copy of ``splade_tpu/benchmark/report.py``, which
imports no framework.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, Optional


def generate_report(
    dataset_name: str,
    method_metrics: Mapping[str, Mapping[str, float]],
    stat_tests: Optional[Mapping[str, Mapping[str, float]]] = None,
    metadata: Optional[Mapping[str, Any]] = None,
) -> str:
    lines = [
        f"# Benchmark Report — {dataset_name}",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
    ]
    if metadata:
        for k, v in metadata.items():
            lines.append(f"- **{k}**: {v}")
        lines.append("")
    cols = ["recall@1", "recall@5", "recall@10", "mrr", "ndcg@10",
            "latency_p50_ms", "latency_p95_ms"]
    lines.append("| method | " + " | ".join(cols) + " |")
    lines.append("|---" * (len(cols) + 1) + "|")
    ordered = sorted(method_metrics.items(),
                     key=lambda kv: -kv[1].get("recall@1", 0.0))
    for method, m in ordered:
        row = [method] + [
            f"{m.get(c, 0.0)*100:.1f}%" if c.startswith(("recall",))
            else f"{m.get(c, 0.0):.3f}" if c in ("mrr", "ndcg@10")
            else f"{m.get(c, 0.0):.1f}"
            for c in cols
        ]
        lines.append("| " + " | ".join(row) + " |")
    lines.append("")
    if stat_tests:
        lines.append("## Statistical significance (paired t-test on reciprocal ranks)")
        lines.append("")
        lines.append("| comparison | t | p-value | mean RR diff |")
        lines.append("|---|---|---|---|")
        for name, t in stat_tests.items():
            sig = " ***" if t["p_value"] < 0.001 else (
                " *" if t["p_value"] < 0.05 else "")
            lines.append(
                f"| {name} | {t['t_statistic']:.3f} | {t['p_value']:.2e}{sig} "
                f"| {t['mean_diff']:+.4f} |")
        lines.append("")
    return "\n".join(lines)
