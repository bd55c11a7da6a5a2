"""Helpers the per-layer metric readers share (``perfbench/metrics/``).
Each reader takes the run's context: the driver's records, spans and
windows, and ``trace`` (``core/trace.py``'s Trace, or None). A reader that
finds nothing to read returns None and its metric is left out."""

from __future__ import annotations

from typing import List

from perfbench.rooflines.peaks import BF16_FLOPS


def scalar(x) -> float:
    return float(x.item()) if hasattr(x, "item") else float(x)


def roofline_pct(ctx: dict, ops: List[tuple]):
    """100 x (least time of the recorded calls) / (device time of their
    scopes). ``ops``: (scope, least(rec) -> s, records)."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    least = busy = 0.0
    for scope, fn, records in ops:
        if not records or not trace.scope_s.get(scope):
            return None
        least += sum(fn(**{k: scalar(v) for k, v in r.items()})
                     for r in records)
        busy += trace.scope_s[scope]
    return 100.0 * least / busy


def idle_pct(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def traced_calls(ctx: dict):
    """The engine calls that started and ended inside the traced window."""
    t0, t1 = ctx["traced"]
    return [c for c in ctx.get("spans", []) if c[0] >= t0 and c[1] <= t1]


def mfu_pct(flops: float, seconds: float):
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * BF16_FLOPS)
