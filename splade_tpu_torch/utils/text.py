"""The k -> tier quantizer shared by the serving engine and the postings
index (counterpart of ``splade_tpu/utils/text.py::quantize_to_tier``)."""

from __future__ import annotations

from typing import Optional, Sequence


def quantize_to_tier(k: int, tiers: Sequence[int],
                     cap: Optional[int] = None,
                     round_to: int = 1000) -> int:
    """Round k up to a fixed tier, so the set of top-k widths stays small.
    Beyond the tier table, round up to a multiple of ``round_to``; clamp to
    ``cap`` when given."""
    out = k
    for tier in tiers:
        if k <= tier:
            out = tier
            break
    else:
        out = -(-k // round_to) * round_to
    return min(out, cap) if cap is not None else out
